"""Fused bonded energies + forces: the CUDA bonded kernel, its plain
PyTorch version, and the wrapper that picks between them by device.

Counterpart of `torchmd_tpu/ops/pallas_bonded.py`. The plan carries over
`build_pallas_bonded_plan`: multi-term maps expanded per assignment (no
segment sum at run time), rows sorted by their lowest atom index, 1-4
rows baked as [A/scnb, B/scnb, ELEC_FACTOR*qi*qj/scee], and each block of
rows its atom window, the span of atoms its rows touch (the TPU plan's
tile `starts`/`klens`, here in atoms): the kernel sums a block's force
contributions over its window in shared memory and adds the window to the
forces once. Energy keys follow `pallas_bonded_energy_forces`: 1-4
energies add into "lj" and "electrostatics".

Bond, angle and torsion rows whose force constant is exactly 0 add 0
energy and 0 force, so the plan leaves them out (the SETTLE triangles of
a rigid-water topology carry such bonds: 46,875 of them on a 15,625-water
box). A term left with no rows still reports its 0 energy, without a
launch.

`bonded_energy_forces(plan, pos, box)` runs the plain version for a CPU
tensor and launches the kernel for a CUDA tensor; on a CUDA tensor it
launches or raises. With `out=` it adds the forces into the caller's
buffer instead of a zeroed one of its own. `pos` (R, N, 3) is a replica
ladder of one topology, with a box per replica ((R, 3)) or none: one
launch of the kernel for all R replicas (the plain version loops over
them).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..units import ELEC_FACTOR

from ..potentials import add_energy, wrap_displacement
from . import _build

# Kernel launches made by `bonded_energy_forces` (one per call on CUDA).
LAUNCHES = 0

ROWS = 128    # rows per CUDA block, a thread each (csrc/bonded.cu takes 32..256)
WCAP = 2048   # atoms a block's shared window holds at most (12 bytes each)
MAXFAM = 8    # csrc/bonded.cu MAXFAM
MAX_REPLICAS = 1024  # replicas of one launch at most (the plan's tickets)
# the kernel's counters (`stats=`)
STATS = ("global_atomics", "window_rows", "direct_rows", "window_blocks",
         "direct_blocks")
KINDS = {"bond": 0, "angle": 1, "torsion": 2, "nb14": 3}
ARITY = {"bond": 2, "angle": 3, "torsion": 4, "nb14": 2}


class KernelFamily(NamedTuple):
    kind: str            # bond | angle | torsion | nb14
    name: str            # energy key ("bonds", "urey-bradley", "dihedrals", ...)
    count: int           # real rows
    row0: int            # first row in the plan's idx/par arrays (whole blocks)
    nblocks: int
    flags: int           # bond: cutoff on; torsion: AMBER; nb14: 1 lj | 2 elec
    cutoff: float


class BondedKernelPlan(NamedTuple):
    natoms: int
    families: tuple          # KernelFamily per family, in row order
    idx: Optional[torch.Tensor]   # (R, 4) int32, -1 in unused slots / padding
    par: Optional[torch.Tensor]   # (R, 3) per-row parameters
    zero_terms: tuple = ()   # terms whose every row has a zero force constant
    rows: int = ROWS         # rows per block
    windows: Optional[torch.Tensor] = None  # (R / rows, 2) int32 first atom, atoms
    wcap: int = 0            # atoms of the kernel's shared window: the widest
                             # window up to WCAP; wider blocks add straight
    ticket: Optional[torch.Tensor] = None   # (MAX_REPLICAS,) int32 of the kernel, one
                                            # per replica, 0 between calls


def block_windows(idx, rows):
    """(first atom, atoms) of the span of the atoms each block of `rows`
    rows of `idx` (R, 4), -1 unused, touches."""
    blk = idx.reshape(-1, rows * idx.shape[1])
    lo = np.where(blk < 0, np.iinfo(np.int32).max, blk).min(1)
    hi = blk.max(1)
    return np.stack([lo, hi - lo + 1], 1).astype(np.int32)


def window_stats(plan) -> dict:
    """The kernel's row and block counters (STATS but the atomics) as the
    plan sets them: rows and blocks summed in a shared window (span at most
    plan.wcap atoms) and added straight to the forces."""
    win = plan.windows.cpu().numpy()
    real = (plan.idx[:, 0] >= 0).cpu().numpy().reshape(len(win), plan.rows).sum(1)
    shared = win[:, 1] <= plan.wcap
    return {"window_rows": int(real[shared].sum()), "direct_rows": int(real[~shared].sum()),
            "window_blocks": int(shared.sum()), "direct_blocks": int((~shared).sum())}


def build_bonded_kernel_plan(ffp, cfg, dtype=None, wcap=WCAP) -> Optional[BondedKernelPlan]:
    """Row plan on ffp's device at `dtype` (default ffp's), in blocks of
    ROWS rows; blocks whose window spans more than `wcap` atoms add
    straight to the forces. None when no bonded term is active; a plan
    with no families when every active row has a zero force constant."""
    dtype = ffp.charges.dtype if dtype is None else dtype
    natoms = int(ffp.charges.shape[0])
    fams, idx_rows, par_rows, zero_terms = [], [], [], []
    row = 0

    def per_assignment(table):
        params = table.params.double().cpu().numpy()[table.map_param.cpu().numpy()]
        idx = table.idx.cpu().numpy()[table.map_term.cpu().numpy()]
        return idx, params

    def add(kind, name, idx, par, flags=0, cutoff=0.0):
        nonlocal row
        if kind != "nb14":
            live = par[:, 0] != 0
            if idx.shape[0] and not live.any():
                zero_terms.append(name)
            idx, par = idx[live], par[live]
        count = idx.shape[0]
        if count == 0:
            return
        # locality sort: a block's rows then touch nearby atoms
        order = np.argsort(idx.min(axis=1), kind="stable")
        nblocks = -(-count // ROWS)
        i4 = np.full((nblocks * ROWS, 4), -1, np.int32)
        i4[:count, :idx.shape[1]] = idx[order]
        p3 = np.zeros((nblocks * ROWS, 3), np.float64)
        p3[:count, :par.shape[1]] = par[order]
        fams.append(KernelFamily(kind, name, count, row, nblocks, int(flags),
                                 float(cutoff)))
        idx_rows.append(i4)
        par_rows.append(p3)
        row += nblocks * ROWS

    if "bonds" in cfg.terms and ffp.bonds is not None:
        idx, par = per_assignment(ffp.bonds)
        add("bond", "bonds", idx, par[:, :2], flags=cfg.cutoff is not None,
            cutoff=cfg.cutoff or 0.0)
    if "urey-bradley" in cfg.terms and ffp.urey_bradley is not None:
        idx, par = per_assignment(ffp.urey_bradley)
        add("bond", "urey-bradley", idx, par[:, :2])
    if "angles" in cfg.terms and ffp.angles is not None:
        idx, par = per_assignment(ffp.angles)
        add("angle", "angles", idx, par[:, :2])
    for name, amber in (("dihedrals", cfg.dihedrals_amber),
                        ("impropers", cfg.impropers_amber)):
        tbl = getattr(ffp, name)
        if name in cfg.terms and tbl is not None:
            idx, par = per_assignment(tbl)
            add("torsion", name, idx, par[:, :3], flags=bool(amber))
    if "1-4" in cfg.terms and ffp.nb14 is not None:
        idx, par = per_assignment(ffp.nb14)
        q = ffp.charges.double().cpu().numpy()
        nbpar = np.stack([
            par[:, 0] / par[:, 2],
            par[:, 1] / par[:, 2],
            ELEC_FACTOR * q[idx[:, 0]] * q[idx[:, 1]] / par[:, 3],
        ], axis=1)
        add("nb14", "1-4", idx, nbpar,
            flags=("lj" in cfg.terms) | (2 * ("electrostatics" in cfg.terms)))
    if not fams:
        if not zero_terms:
            return None
        return BondedKernelPlan(natoms=natoms, families=(), idx=None, par=None,
                                zero_terms=tuple(zero_terms))
    if len(fams) > MAXFAM:
        raise ValueError(f"at most {MAXFAM} bonded families, got {len(fams)}")
    dev = ffp.charges.device
    idx = np.concatenate(idx_rows)
    windows = block_windows(idx, ROWS)
    if not 0 <= wcap <= WCAP:
        raise ValueError(f"wcap={wcap}: the shared window holds 0..{WCAP} atoms")
    fit = windows[:, 1][windows[:, 1] <= wcap]
    return BondedKernelPlan(
        natoms=natoms, families=tuple(fams),
        idx=torch.as_tensor(idx, device=dev),
        par=torch.as_tensor(np.concatenate(par_rows), dtype=dtype, device=dev),
        zero_terms=tuple(zero_terms), rows=ROWS,
        windows=torch.as_tensor(windows, device=dev),
        wcap=int(fit.max(initial=0)),
        ticket=torch.zeros(MAX_REPLICAS, dtype=torch.int32, device=dev),
    )


def _energy_dict(plan, energies, zero):
    """{term: energy} from per-family (main, aux) energies; 1-4 LJ and
    electrostatics add into "lj" and "electrostatics"; `zero()` for the
    terms with no rows (made only for them: on the card it is a launch)."""
    pot: dict = {name: zero() for name in plan.zero_terms}
    for f, fam in enumerate(plan.families):
        if fam.kind == "nb14":
            if fam.flags & 1:
                add_energy(pot, "lj", energies[f][0])
            if fam.flags & 2:
                add_energy(pot, "electrostatics", energies[f][1])
        else:
            add_energy(pot, fam.name, energies[f][0])
    return pot


# ----------------------------------------------------------------------
# Plain PyTorch version
# ----------------------------------------------------------------------

def _delta(pos, a, b, box):
    return wrap_displacement(pos[a] - pos[b], box)


def _dot(a, b):
    return (a * b).sum(-1)


def _inv_norm(v):
    return torch.rsqrt(torch.clamp(_dot(v, v), min=1e-32))


def _family_physics(fam, pos, idx, p, box):
    """(e_main, e_aux, [force per atom slot]) of one family's real rows:
    the function of pallas_bonded._physics."""
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    if fam.kind == "bond":
        d = _delta(pos, idx[:, 0], idx[:, 1], box)
        d2 = _dot(d, d)
        rinv = torch.rsqrt(torch.clamp(d2, min=1e-32))
        r = d2 * rinv
        x = r - p[:, 1]
        e = p[:, 0] * x * x
        coeff = 2.0 * p[:, 0] * x
        if fam.flags:
            keep = (r <= fam.cutoff).to(pos.dtype)
            e, coeff = e * keep, coeff * keep
        f = (coeff * rinv)[:, None] * d
        return e.sum(), zero, [-f, f]
    if fam.kind == "angle":
        r21 = _delta(pos, idx[:, 0], idx[:, 1], box)
        r23 = _delta(pos, idx[:, 2], idx[:, 1], box)
        n21, n23 = _inv_norm(r21), _inv_norm(r23)
        cos_t = torch.clamp(_dot(r21, r23) * n21 * n23, -1.0, 1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        theta = torch.atan2(torch.clamp(sin_t, min=1e-12), cos_t)
        dt_ = theta - p[:, 1]
        coeff = torch.where(sin_t != 0,
                            -2.0 * p[:, 0] * dt_ / torch.clamp(sin_t, min=1e-30),
                            torch.zeros_like(sin_t))
        a21 = (coeff * n21 * n21 * cos_t)[:, None]
        a23 = (coeff * n23 * n23 * cos_t)[:, None]
        ab = (coeff * n21 * n23)[:, None]
        f0 = a21 * r21 - ab * r23
        f2 = a23 * r23 - ab * r21
        return (p[:, 0] * dt_ * dt_).sum(), zero, [f0, -(f0 + f2), f2]
    if fam.kind == "torsion":
        r12 = _delta(pos, idx[:, 0], idx[:, 1], box)
        r23 = _delta(pos, idx[:, 1], idx[:, 2], box)
        r34 = _delta(pos, idx[:, 2], idx[:, 3], box)
        A = torch.linalg.cross(r12, r23, dim=-1)
        B = torch.linalg.cross(r23, r34, dim=-1)
        C = torch.linalg.cross(r23, A, dim=-1)
        inA, inB, inC = _inv_norm(A), _inv_norm(B), _inv_norm(C)
        phi = -torch.atan2(_dot(C, B) * inC * inB, _dot(A, B) * inA * inB)
        k0, phi0, per = p[:, 0], p[:, 1], p[:, 2]
        if fam.flags:
            diff = per * phi - phi0
            e = k0 * (1.0 + torch.cos(diff))
            coeff = -per * k0 * torch.sin(diff)
        else:
            diff = phi - phi0
            diff = diff - 2.0 * math.pi * torch.round(diff / (2.0 * math.pi))
            e = k0 * diff * diff
            coeff = 2.0 * k0 * diff
        inD = _inv_norm(r23)
        normD = _dot(r23, r23) * inD
        in2D = inD * inD
        f0 = (-coeff * normD * inA * inA)[:, None] * A
        f3 = (coeff * normD * inB * inB)[:, None] * B
        s = (_dot(r12, r23) * in2D)[:, None] * f0 - (_dot(r34, r23) * in2D)[:, None] * f3
        return e.sum(), zero, [-f0, f0 + s, f3 - s, -f3]
    # nb14
    d = _delta(pos, idx[:, 0], idx[:, 1], box)
    rinv = _inv_norm(d)
    rinv2 = rinv * rinv
    coeff = torch.zeros_like(rinv)
    e_lj = e_el = zero
    if fam.flags & 1:
        rinv6 = rinv2 * rinv2 * rinv2
        rinv12 = rinv6 * rinv6
        e_lj = (p[:, 0] * rinv12 - p[:, 1] * rinv6).sum()
        coeff = coeff + (-12.0 * p[:, 0] * rinv12 + 6.0 * p[:, 1] * rinv6) * rinv2
    if fam.flags & 2:
        p_e = p[:, 2] * rinv
        e_el = p_e.sum()
        coeff = coeff - p_e * rinv2
    f = coeff[:, None] * d
    return e_lj, e_el, [-f, f]


def bonded_reference(plan: BondedKernelPlan, pos, box=None, out=None):
    """Plain PyTorch version of the bonded kernel, at the dtype and on the
    device of `pos`. Returns ({term: energy}, forces (N, 3)); with `out`,
    the forces are added into it and it is returned."""
    forces = (torch.zeros((plan.natoms, 3), dtype=pos.dtype, device=pos.device)
              if out is None else out)
    energies = []
    for fam in plan.families:
        rows = slice(fam.row0, fam.row0 + fam.count)
        idx = plan.idx[rows, :ARITY[fam.kind]].long()
        e_main, e_aux, contribs = _family_physics(
            fam, pos, idx, plan.par[rows].to(pos.dtype), box)
        for slot, f in enumerate(contribs):
            forces.index_add_(0, idx[:, slot], f)
        energies.append((e_main, e_aux))
    return _energy_dict(plan, energies, lambda: pos.new_zeros(())), forces


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------

class BondedCfg(ctypes.Structure):
    """Mirror of `struct BondedCfg` in csrc/bonded.cu."""

    _fields_ = [
        ("natoms", ctypes.c_int),
        ("nfam", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("wcap", ctypes.c_int),
        ("nrep", ctypes.c_int),
        ("block_start", ctypes.c_int * (MAXFAM + 1)),
        ("kind", ctypes.c_int * MAXFAM),
        ("flags", ctypes.c_int * MAXFAM),
        ("cutoff", ctypes.c_float * MAXFAM),
    ]


_P = ctypes.c_void_p
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("bonded")
        lib.tmd_bonded_energy_forces.argtypes = ([_P] * 5 + [BondedCfg] + [_P] * 3
                                                 + [ctypes.c_int] + [_P] * 3)
        lib.tmd_bonded_energy_forces.restype = ctypes.c_int
        lib.tmd_error_string.argtypes = [ctypes.c_int]
        lib.tmd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build():
    """Compile and load the kernel library (done at first launch anyway)."""
    _library()


def _kernel_cfg(plan: BondedKernelPlan, nrep=1) -> BondedCfg:
    c = BondedCfg(natoms=plan.natoms, nfam=len(plan.families), rows=plan.rows,
                  wcap=plan.wcap, nrep=nrep)
    for f, fam in enumerate(plan.families):
        c.block_start[f] = fam.row0 // plan.rows
        c.kind[f] = KINDS[fam.kind]
        c.flags[f] = fam.flags
        c.cutoff[f] = fam.cutoff
    last = plan.families[-1]
    c.block_start[len(plan.families)] = last.row0 // plan.rows + last.nblocks
    return c


def _launch(plan: BondedKernelPlan, pos, box, out, stats):
    global LAUNCHES
    n, dev, f32 = plan.natoms, pos.device, torch.float32
    lead = tuple(pos.shape[:-2])       # () or (R,)
    nrep = pos.shape[0] if lead else 1
    if len(lead) > 1 or not 1 <= nrep <= MAX_REPLICAS:
        raise ValueError(f"pos must be (N, 3) or (R, N, 3) with 1 <= R <= "
                         f"{MAX_REPLICAS}, got {tuple(pos.shape)}")
    nrows = plan.idx.shape[0]
    nblocks = nrows // plan.rows
    _build.check_tensor(pos, "pos", f32, lead + (n, 3), dev)
    _build.check_tensor(plan.idx, "idx", torch.int32, (nrows, 4), dev)
    _build.check_tensor(plan.par, "par", f32, (nrows, 3), dev)
    _build.check_tensor(plan.windows, "windows", torch.int32, (nblocks, 2), dev)
    _build.check_tensor(plan.ticket, "ticket", torch.int32, (MAX_REPLICAS,), dev)
    if plan.idx.data_ptr() % 16:
        raise ValueError("idx must be 16-byte aligned (read as int4 rows)")
    if box is not None:
        _build.check_tensor(box, "box", f32, lead + (3,), dev)
    if stats is not None:
        _build.check_tensor(stats, "stats", torch.int64, (len(STATS),), dev)
    forces = out if out is not None else torch.empty(lead + (n, 3), dtype=f32, device=dev)
    _build.check_tensor(forces, "out", f32, lead + (n, 3), dev)
    if forces.data_ptr() % 16:
        raise ValueError("the forces must be 16-byte aligned (flushed by 16-byte atomics)")
    lib = _library()
    epart = torch.empty((nrep, nblocks, 2), dtype=torch.float64, device=dev)
    energies = torch.empty(lead + (len(plan.families), 2), dtype=f32, device=dev)
    err = lib.tmd_bonded_energy_forces(
        pos.data_ptr(), plan.idx.data_ptr(), plan.par.data_ptr(),
        None if box is None else box.data_ptr(), plan.windows.data_ptr(),
        _kernel_cfg(plan, nrep),
        epart.data_ptr(), plan.ticket.data_ptr(), forces.data_ptr(), int(out is not None),
        energies.data_ptr(), None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"bonded kernel launch failed: {lib.tmd_error_string(err).decode()}")
    LAUNCHES += 1
    fam_e = [(energies[..., f, 0], energies[..., f, 1]) for f in range(len(plan.families))]
    return _energy_dict(plan, fam_e, lambda: energies.new_zeros(lead)), forces


def bonded_reference_batch(plan: BondedKernelPlan, pos, box=None, out=None):
    """The plain version over a replica ladder: `bonded_reference` for
    each replica of pos (R, N, 3) with its box (R, 3) or None, stacked:
    ({term: (R,)}, forces (R, N, 3), added into `out` when given)."""
    outs = [bonded_reference(plan, p, None if box is None else box[r],
                             None if out is None else out[r])
            for r, p in enumerate(pos)]
    frc = out if out is not None else torch.stack([o[1] for o in outs])
    return {k: torch.stack([o[0][k] for o in outs]) for k in outs[0][0]}, frc


def bonded_energy_forces(plan: BondedKernelPlan, pos, box=None, out=None, stats=None):
    """pos: (N, 3), or (R, N, 3) for R replicas of the topology; box:
    (3,) (or (R, 3)) diagonal tensor or None (no PBC). Returns ({term:
    energy tensor, 0-dim (or (R,))}, forces of pos's shape). A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel (f32 only),
    once for all the replicas, or raises. A plan with no rows launches
    nothing. `out`, a tensor of pos's shape, dtype and device: the forces
    are added into it, and it is returned. `stats`, an int64 (5,) card
    tensor, gains the kernel's counters (STATS)."""
    if not plan.families:
        return ({name: pos.new_zeros(pos.shape[:-2]) for name in plan.zero_terms},
                torch.zeros_like(pos) if out is None else out)
    if pos.device.type == "cuda":
        return _launch(plan, pos, box, out, stats)
    if pos.device.type == "cpu":
        if pos.dim() == 3:
            return bonded_reference_batch(plan, pos, box, out)
        return bonded_reference(plan, pos, box, out)
    raise ValueError(f"no bonded kernel for device {pos.device}")
