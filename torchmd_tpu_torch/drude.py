"""Drude-oscillator polarizable force fields, the port of `torchmd_tpu.drude`.

Each polarizable atom gets an auxiliary "Drude" particle tied to its core
by a harmonic spring; the displaced charge pair is a classical induced
dipole with

    alpha = ELEC_FACTOR * q_D^2 / (2 k0)          (q_D < 0 by convention)

(energies kcal/mol, distances A, charges e, spring E = k0 d^2, the bonds
term's convention). `make_drude_ffparams` extends an existing `FFParams`
rather than building a new topology, array for array as the JAX package
does: cores keep rows 0..N-1, the Drudes take rows N..N+npol-1, the core
charge becomes q_i - q_D, the Drude mass is taken from its parent, a
fresh zero-epsilon LJ type is appended, the Drude rows of the nonbonded
mask inherit their parents' exclusions (and the core-Drude pair of one
oscillator is excluded), the springs are rows appended to the bonds table
(k0, r0 = 0), bonded-neighbour polarizable pairs get Thole screening and
CHARMM NBTHOLE pairs their pair-specific damping.

Forces (`drude_energy_forces`, the evaluator the SCF solve and the
integrator call) take the route `Forces` takes (`forces.select_path`): on
CUDA f32 the pair kernel (#1, its exclusion words made from the extended
mask, where every core-Drude pair starts at r = 0) and the bonded kernel
(#3, the springs among its bond rows); on the CPU the kernels' plain
versions; at f64 on the card the torch-op path. It is `Forces`' own
composition of the force field (`forces.build_evaluators`), with Thole
and NBTHOLE (small index-pair sums) riding on its bonded stage by
`torch.autograd` beside CMAP and the GROMOS-96 forms; the reciprocal
term from `make_drude_ewald`'s engine (PME with the exact gather, whose
forces are the gradient of its energy, as `jax.grad` gives them in the
JAX package: the spread kernel #6 runs on the card, the ik gather #7
does not).

Dynamics: `DrudeIntegrator` runs velocity Verlet with the dual-Langevin
scheme (Lamoureux & Roux, J. Chem. Phys. 119, 3025 (2003)): each
core-Drude pair's centre of mass couples to the physical bath (T, gamma),
its relative coordinate to a cold bath (T_drude, gamma_drude). `scf_drude`
relaxes the Drude coordinates at fixed cores with the JAX package's
stopping rule (max |dE/dx_Drude| > tol, checked every iteration: one host
read an iteration on the card).

CHARMM Drude-2013 ingestion: RTF ALPHA/THOLE attributes
(`charmm_drude_tables`), LONEPAIR virtual sites (`LonePairSpec`,
`lonepair_positions`, `constrain_lonepairs`: positions are torch functions
of the hosts, so autograd carries site forces to them) and NBTHOLE type
pairs (`charmm_nbthole_pairs`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import potentials as _potentials
from .forces import PME_AUTO_N, build_evaluators, select_path
from .integrator import kinetic_to_temp
from .potentials import TermTable, wrap_displacement
from .systems import resolve_device, to_numpy
from .units import BOLTZMANN, ELEC_FACTOR, PICOSEC2TIMEU, TIMEFACTOR

__all__ = ["DrudeSpec", "make_drude_ffparams", "make_drude", "init_drude_positions",
           "thole_energy", "nbthole_energy", "make_drude_ewald", "drude_energy",
           "drude_energy_forces", "scf_drude", "DrudeIntegrator", "LP_BISECTOR",
           "LP_COLINEAR", "LP_RELATIVE", "LonePairSpec", "lonepair_positions",
           "charmm_drude_tables", "charmm_nbthole_pairs", "make_lonepair_spec",
           "constrain_lonepairs"]


class DrudeSpec(NamedTuple):
    core_idx: torch.Tensor    # (npol,) int64 -- parent atom rows
    drude_idx: torch.Tensor   # (npol,) int64 -- appended particle rows
    q_drude: torch.Tensor     # (npol,) Drude charges (negative)
    alpha: torch.Tensor       # (npol,) polarizabilities (A^3)
    m_core: torch.Tensor      # (npol,) reduced core masses
    m_drude: float
    k_drude: float
    # Thole screening pairs: indices INTO THE POLARIZABLE LIST (not atom
    # rows) of bonded-neighbour dipole pairs + a / (alpha_i alpha_j)^(1/6)
    thole_i: Optional[torch.Tensor]   # (npairs,) int64
    thole_j: Optional[torch.Tensor]
    thole_coeff: Optional[torch.Tensor]
    # NBTHOLE: pair-specific screening of NONBONDED oscillator pairs (the
    # damping correction on top of the bare Coulomb the pair path counts)
    nbthole_i: Optional[torch.Tensor] = None
    nbthole_j: Optional[torch.Tensor] = None
    nbthole_coeff: Optional[torch.Tensor] = None


def make_drude_ffparams(ffp, alpha, k_drude=500.0, m_drude=0.4, thole=2.6,
                        thole_atom=None, nbthole_pairs=None):
    """Extend `ffp` with Drude particles for every atom with alpha > 0
    (torchmd_tpu/drude.py:79). alpha: (natoms,) polarizabilities in A^3
    (0 = not polarizable); thole: the default pair damping factor;
    `thole_atom` optionally per-atom factors a_i (NaN = thole / 2),
    combined as u = (a_i + a_j) r / (alpha_i alpha_j)^(1/6);
    nbthole_pairs: optional (m, 3) rows (atom_i, atom_j, a) whose a replaces
    a_i + a_j for a NONBONDED oscillator pair. Returns (ffp_ext, spec) on
    ffp's device, floats at ffp's dtype."""
    dev, dt = ffp.charges.device, ffp.charges.dtype
    n = int(ffp.charges.shape[0])
    alpha = np.asarray(to_numpy(alpha), np.float64).reshape(n)
    if np.any(alpha < 0):
        raise ValueError("polarizabilities must be >= 0")
    pol = np.flatnonzero(alpha > 0)
    npol = len(pol)
    if npol == 0:
        raise ValueError("no polarizable atoms (all alpha == 0)")
    if ffp.nb_mask is None:
        raise ValueError("Drude construction needs the dense nonbonded mask")

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    def floats(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dt, device=dev)

    q = to_numpy(ffp.charges).astype(np.float64)
    masses = to_numpy(ffp.masses).astype(np.float64).reshape(n)
    if np.any(masses[pol] <= m_drude):
        raise ValueError("parent masses must exceed the Drude mass")
    # alpha = ELEC_FACTOR q_D^2 / (2 k0)  ->  q_D = -sqrt(2 k0 alpha / EF)
    q_d = -np.sqrt(2.0 * k_drude * alpha[pol] / ELEC_FACTOR)

    drude_rows = n + np.arange(npol)
    charges_ext = np.concatenate([q, q_d])
    charges_ext[pol] = q[pol] - q_d
    masses_ext = np.concatenate([masses, np.full(npol, m_drude)])
    masses_ext[pol] = masses[pol] - m_drude

    # LJ: Drude particles are pure charges -- a fresh zero-epsilon type
    ti = to_numpy(ffp.mapped_atom_types).astype(np.int64)
    ntypes = int(ti.max()) + 1 if len(ti) else 0
    types_ext = np.concatenate([ti, np.full(npol, ntypes)])
    lj_ext = None
    if ffp.lj_params is not None:
        lj_ext = torch.cat([ffp.lj_params, floats([[1.0, 0.0]])])
    lj_ab_ext = None
    if ffp.lj_ab is not None:
        lj_ab_ext = tuple(torch.nn.functional.pad(t, (0, 1, 0, 1)) for t in ffp.lj_ab)

    # nonbonded mask: Drude rows inherit the parent's pattern
    mask = to_numpy(ffp.nb_mask).astype(bool)
    mask_ext = np.zeros((n + npol, n + npol), bool)
    mask_ext[:n, :n] = mask
    mask_ext[n:, :n] = mask[pol, :]
    mask_ext[:n, n:] = mask[:, pol]
    mask_ext[n:, n:] = mask[np.ix_(pol, pol)]
    # core-Drude of the SAME oscillator never interacts nonbonded
    mask_ext[pol, drude_rows] = False
    mask_ext[drude_rows, pol] = False
    np.fill_diagonal(mask_ext, False)

    # spring rows appended to the bonds table (E = k0 d^2, r0 = 0)
    spring_idx = ints(np.stack([pol, drude_rows], axis=1))
    spring_param = floats([[k_drude, 0.0]])
    b = ffp.bonds
    if b is not None:
        nb_inst, nrows = int(b.idx.shape[0]), int(b.params.shape[0])
        bonds_ext = TermTable(
            idx=torch.cat([b.idx, spring_idx]),
            map_term=torch.cat([b.map_term, ints(np.arange(nb_inst, nb_inst + npol))]),
            map_param=torch.cat([b.map_param, ints(np.full(npol, nrows))]),
            params=torch.cat([b.params, spring_param]))
    else:
        bonds_ext = TermTable(idx=spring_idx, map_term=ints(np.arange(npol)),
                              map_param=ints(np.zeros(npol)), params=spring_param)

    # Thole pairs: bonded-neighbour (excluded) polarizable pairs
    tp = np.argwhere(np.triu(~mask[np.ix_(pol, pol)], 1))
    a_at = np.full(n, thole / 2.0)
    if thole_atom is not None:
        ta = np.asarray(to_numpy(thole_atom), np.float64).reshape(n)
        a_at = np.where(np.isnan(ta), a_at, ta)
    pair_a = a_at[pol[tp[:, 0]]] + a_at[pol[tp[:, 1]]]
    tc = pair_a / (alpha[pol[tp[:, 0]]] * alpha[pol[tp[:, 1]]]) ** (1.0 / 6.0)

    # NBTHOLE: nonbonded pair-specific screening (skip non-polarizable
    # atoms and bonded-excluded pairs -- those carry the standard Thole)
    pol_of_atom = np.full(n, -1)
    pol_of_atom[pol] = np.arange(npol)
    excl_set = set(zip(tp[:, 0].tolist(), tp[:, 1].tolist()))
    nbi, nbj, nbc = [], [], []
    for ai, aj, a_pair in ([] if nbthole_pairs is None else to_numpy(nbthole_pairs)):
        pi, pj = pol_of_atom[int(ai)], pol_of_atom[int(aj)]
        if pi < 0 or pj < 0 or pi == pj:
            continue
        lo, hi = (pi, pj) if pi < pj else (pj, pi)
        if (lo, hi) in excl_set:
            continue
        nbi.append(lo)
        nbj.append(hi)
        nbc.append(float(a_pair) / (alpha[pol[lo]] * alpha[pol[hi]]) ** (1.0 / 6.0))

    spec = DrudeSpec(
        core_idx=ints(pol), drude_idx=ints(drude_rows), q_drude=floats(q_d),
        alpha=floats(alpha[pol]), m_core=floats(masses_ext[pol]),
        m_drude=float(m_drude), k_drude=float(k_drude),
        thole_i=ints(tp[:, 0]) if len(tp) else None,
        thole_j=ints(tp[:, 1]) if len(tp) else None,
        thole_coeff=floats(tc) if len(tp) else None,
        nbthole_i=ints(nbi) if nbi else None,
        nbthole_j=ints(nbj) if nbi else None,
        nbthole_coeff=floats(nbc) if nbi else None)
    ffp_ext = ffp._replace(
        charges=floats(charges_ext), masses=floats(masses_ext.reshape(-1, 1)),
        mapped_atom_types=ints(types_ext), lj_params=lj_ext, lj_ab=lj_ab_ext,
        bonds=bonds_ext, nb_mask=torch.as_tensor(mask_ext, device=dev))
    return ffp_ext, spec


def make_drude(forces, alpha=None, k_drude=500.0, m_drude=0.4, thole=2.6,
               nbthole_pairs=None):
    """Extend a built `Forces` object's FFParams with Drude oscillators.
    With `alpha=None` the polarizabilities come from the force field (the
    YAML schema's `polarizabilities:` section, on `Parameters.alpha` and
    `.thole`). A mask the Forces deferred for the cell path is built here:
    the Drude path is dense-masked."""
    thole_atom = None
    if alpha is None:
        alpha = getattr(forces.par, "alpha", None)
        thole_atom = getattr(forces.par, "thole", None)
        if alpha is None:
            raise ValueError(
                "no polarizabilities: pass alpha=... or use a force field "
                "with a `polarizabilities:` section")
    return make_drude_ffparams(
        forces.require_nb_mask(), alpha, k_drude=k_drude, m_drude=m_drude,
        thole=thole, thole_atom=thole_atom, nbthole_pairs=nbthole_pairs)


def init_drude_positions(pos, spec: DrudeSpec):
    """(natoms, 3) -> (natoms + npol, 3) with Drudes on their cores."""
    pos = torch.as_tensor(pos, device=spec.core_idx.device)
    return torch.cat([pos, pos[spec.core_idx]])


def _dipole_pairs(spec: DrudeSpec, sel_i, sel_j, coeff, pos_ext, box, damp):
    """sum over oscillator pairs (sel_i, sel_j) of the four charge pairs
    (+-q_D at core and Drude of each), each ELEC_FACTOR qq / r scaled by
    damp(u), u = coeff r."""
    ci, di = spec.core_idx[sel_i], spec.drude_idx[sel_i]
    cj, dj = spec.core_idx[sel_j], spec.drude_idx[sel_j]
    qq = spec.q_drude[sel_i].to(pos_ext.dtype) * spec.q_drude[sel_j].to(pos_ext.dtype)
    a = coeff.to(pos_ext.dtype)

    def pair(idx_a, idx_b, sign):
        dv = wrap_displacement(pos_ext[idx_a] - pos_ext[idx_b], box)
        r = torch.sqrt((dv * dv).sum(-1))
        return (damp(a * r) * ELEC_FACTOR * sign * qq / r).sum()

    # charges: Drude q_D, core counter-charge -q_D (the dipole pair)
    return pair(di, dj, 1.0) + pair(di, cj, -1.0) + pair(ci, dj, -1.0) + pair(ci, cj, 1.0)


def thole_energy(spec: DrudeSpec, pos_ext, box):
    """Screened dipole-dipole interaction of bonded-neighbour oscillators:
    the four charge pairs, each scaled by S(u) = 1 - (1 + u/2) e^-u."""
    if spec.thole_i is None:
        return pos_ext.new_zeros(())
    return _dipole_pairs(spec, spec.thole_i, spec.thole_j, spec.thole_coeff, pos_ext, box,
                         lambda u: 1.0 - (1.0 + 0.5 * u) * torch.exp(-u))


def nbthole_energy(spec: DrudeSpec, pos_ext, box):
    """Pair-specific Thole damping of NONBONDED oscillator pairs (CHARMM
    NBTHOLE): the pair path counts their bare Coulomb, so the correction
    per charge pair is qq/r (S(u) - 1) = -qq/r (1 + u/2) e^-u."""
    if spec.nbthole_i is None:
        return pos_ext.new_zeros(())
    return _dipole_pairs(spec, spec.nbthole_i, spec.nbthole_j, spec.nbthole_coeff, pos_ext,
                         box, lambda u: -(1.0 + 0.5 * u) * torch.exp(-u))


def make_drude_ewald(ffp_ext, box, cutoff, tol=1e-5, pme="auto", dtype=None):
    """Reciprocal-space engine of the EXTENDED (cores + Drudes) topology:
    returns (recip, alpha). Set cfg._replace(ewald_alpha=alpha) so the pair
    path evaluates erfc real space and pass `recip` to `drude_energy`,
    `drude_energy_forces`, `scf_drude` or `DrudeIntegrator`. Every excluded
    pair of the extended mask, the coincident core-Drude pairs included,
    takes the -erf(alpha r)/r correction (finite at r = 0,
    `ewald.erf_over_r_sum`). pme: True / False forces PME / the exact
    Ewald sum; "auto" takes PME from `forces.PME_AUTO_N` extended
    particles, as `Forces.ensure_ewald` does. PME runs the exact gather
    (its forces the gradient of its energy, as the JAX package's
    `jax.grad`); on CUDA f32 its spread is kernel #6 (at f64 on the card
    its plain version). dtype: default the charges' (the engine lives on
    their device)."""
    from .ewald import EwaldRecip, PmeRecip

    mask = to_numpy(ffp_ext.nb_mask).astype(bool)
    n_ext = mask.shape[0]
    excl = np.argwhere(np.triu(~mask, 1))
    use_pme = pme if isinstance(pme, bool) else n_ext >= PME_AUTO_N
    b = np.asarray(to_numpy(box), np.float64).reshape(-1)[:3]
    dtype = ffp_ext.charges.dtype if dtype is None else dtype
    if use_pme:
        # the spread kernel is f32: f64 on the card spreads with its plain
        # version, as Forces does
        plain = select_path("auto", False, ffp_ext.charges.device, dtype) != "kernels"
        recip = PmeRecip(ffp_ext.charges, b, cutoff, excl_pairs=excl, tol=tol, dtype=dtype,
                         gather="exact", plain=plain)
    else:
        recip = EwaldRecip(ffp_ext.charges, b, cutoff, excl_pairs=excl, tol=tol, dtype=dtype)
    return recip, float(recip.cfg.alpha)


def _check_cfg(cfg, recip):
    """The JAX package's two refusals (torchmd_tpu/drude.py:372-382)."""
    if "bonds" not in cfg.terms:
        raise ValueError(
            "Drude systems need 'bonds' in the force terms (the core-Drude "
            "springs live in the bonds table)")
    if cfg.ewald_alpha is not None and recip is None:
        raise ValueError(
            "cfg.ewald_alpha is set but no reciprocal engine was given: "
            "erfc real space alone is not valid electrostatics. Build one "
            "with make_drude_ewald(ffp_ext, box, cutoff) and pass recip=.")


def drude_energy(ffp_ext, spec: DrudeSpec, cfg, pos_ext, box, recip=None):
    """Total potential (a 0-dim tensor, differentiable by autograd on the
    torch-op terms) of the extended system: `compute_potentials` plus
    Thole, NBTHOLE and the reciprocal term."""
    _check_cfg(cfg, recip)
    box = _box_tensor(box, pos_ext)
    pot = _potentials.compute_potentials(ffp_ext, pos_ext, box, cfg)
    e = sum(pot.values(), pos_ext.new_zeros(()))
    e = e + thole_energy(spec, pos_ext, box) + nbthole_energy(spec, pos_ext, box)
    if recip is not None:
        e = e + recip.energy(pos_ext, box)
    return e


def drude_energy_forces(ffp_ext, spec: DrudeSpec, cfg, recip=None):
    """The evaluator of an extended system: ef(pos (N_ext, 3), box (3,) or
    None) -> ({term: energy}, forces). It is `Forces`' own composition
    (`forces.build_evaluators`) of ffp_ext on the route `forces.select_path`
    takes for ffp_ext's device and dtype: the kernel wrappers (CUDA kernels
    #1 and #3 at f32 on the card, their plain versions on the CPU) or, at
    f64 on the card, the torch-op path; the reciprocal term `recip` adds
    into "electrostatics". Thole ("thole") and NBTHOLE ("nbthole") ride on
    its bonded stage by autograd, beside CMAP and the GROMOS-96 forms. The
    kernels' inputs (the pair kernel's exclusion words of the extended
    mask, the bonded row plan) are made once here."""
    _check_cfg(cfg, recip)
    use_kernels = select_path("auto", False, ffp_ext.charges.device,
                              ffp_ext.charges.dtype) == "kernels"
    extra = None
    if spec.thole_i is not None or spec.nbthole_i is not None:
        def extra(pos, box):
            out = {}
            if spec.thole_i is not None:
                out["thole"] = thole_energy(spec, pos, box)
            if spec.nbthole_i is not None:
                out["nbthole"] = nbthole_energy(spec, pos, box)
            return out
    ef_one = build_evaluators(ffp_ext, cfg, use_kernels, recip=recip,
                              extra_autograd=extra).ef_one

    def ef(pos, box):
        return ef_one(pos, _box_tensor(box, pos))

    return ef


def _box_tensor(box, like):
    """A (3,) box diagonal on `like`'s device and dtype, or None."""
    if box is None:
        return None
    if isinstance(box, torch.Tensor):
        return box.to(like.device, like.dtype).reshape(-1)[:3]
    return torch.as_tensor(np.asarray(box, np.float64).reshape(-1)[:3], dtype=like.dtype,
                           device=like.device)


def scf_drude(ffp_ext, spec: DrudeSpec, cfg, pos_ext, box, iters=200, tol=1e-10,
              recip=None, ef=None, return_info=False, damping=1.0):
    """Relax the Drude coordinates at fixed cores (the adiabatic limit) by
    steps -damping g / (2 k0), with the JAX package's rule: iterate while
    i < iters and the last gradient's max |g_Drude| > tol
    (torchmd_tpu/drude.py:394). The check reads gmax on the host every
    iteration. damping 1 is the JAX package's step, a Newton step in the
    springs' curvature 2 k0; it oscillates and grows on modes whose
    curvature exceeds 4 k0, where Coulomb and Thole terms stiffen it (a
    ring of polarizable atoms 1.4 A apart, as in thrombin's Trp side
    chains at 1 A^3): damping 0.5 converges there. `ef`: an evaluator
    from `drude_energy_forces` (made here when None). With
    return_info=True returns (pos, {"iterations", "host_reads", "gmax"})."""
    box = _box_tensor(box, pos_ext)
    if ef is None:
        ef = drude_energy_forces(ffp_ext, spec, cfg, recip=recip)
    didx = spec.drude_idx
    step = damping / (2.0 * spec.k_drude)
    p = pos_ext.clone()
    i, reads, gmax = 0, 0, float("inf")
    while i < iters and gmax > tol:
        gd = -ef(p, box)[1][didx]
        p[didx] = p[didx] - step * gd
        i += 1
        gmax = float(gd.abs().max())
        reads += 1
    if return_info:
        return p, {"iterations": i, "host_reads": reads, "gmax": gmax}
    return p


class DrudeIntegrator:
    """Velocity Verlet + dual Langevin (Lamoureux-Roux) for one replica of
    an extended Drude system (torchmd_tpu/drude.py:425).

    pos/vel live on this object. T/gamma act on the pairs' centres of mass
    and the non-polarizable atoms; T_drude/gamma_drude on the relative
    core-Drude coordinates. The three normal draws of a step come in the
    JAX package's order (per atom, centre of mass, relative) from one
    `torch.Generator` seeded from `seed`. device: default the CUDA card;
    ffp_ext, spec and recip live there already, at `dtype`."""

    def __init__(self, ffp_ext, spec: DrudeSpec, cfg, pos_ext, box=None,
                 timestep=1.0, T=300.0, gamma=1.0, T_drude=1.0,
                 gamma_drude=20.0, seed=1, dtype=torch.float64,
                 recip=None, device=None, generator=None):
        self.device = resolve_device(device)
        if dtype != ffp_ext.charges.dtype:
            raise ValueError(
                f"dtype={dtype} but ffp_ext is {ffp_ext.charges.dtype}: the "
                "integrator runs at the extended force field's precision "
                "(the card's kernels take f32 throughout)")
        self.dtype = dtype
        self.ffp, self.spec, self.cfg, self.recip = ffp_ext, spec, cfg, recip
        self.dt = timestep / TIMEFACTOR
        self.pos = (pos_ext.detach().to(self.device, dtype).clone()
                    if isinstance(pos_ext, torch.Tensor)
                    else torch.as_tensor(np.asarray(pos_ext), dtype=dtype, device=self.device))
        self.box = _box_tensor(box, self.pos)
        self.n_ext = int(self.pos.shape[0])
        self.masses = ffp_ext.masses.to(self.device, dtype).reshape(-1, 1)
        self.generator = (generator if generator is not None
                          else torch.Generator(device=self.device).manual_seed(seed))
        self.vel = torch.zeros_like(self.pos)
        self._last_frc = None
        self._last_pos = None
        self.T = float(T)
        self.T_drude = float(T_drude)
        self.gamma = float(gamma) / PICOSEC2TIMEU
        self.gamma_d = float(gamma_drude) / PICOSEC2TIMEU
        self._ef = drude_energy_forces(ffp_ext, spec, cfg, recip=recip)
        ci = spec.core_idx
        self._m_c = spec.m_core[:, None].to(self.device, dtype)
        self._M = self._m_c + spec.m_drude
        self._mu = self._m_c * spec.m_drude / self._M   # the relative coordinate's mass
        kT, kTd, dt = BOLTZMANN * self.T, BOLTZMANN * self.T_drude, self.dt
        self._vc_atom = torch.sqrt(2.0 * self.gamma * kT * dt / self.masses)
        self._vc_com = torch.sqrt(2.0 * self.gamma * kT * dt / self._M)
        self._vc_rel = torch.sqrt(2.0 * self.gamma_d * kTd * dt / self._mu)
        pair_rows = np.concatenate([to_numpy(ci), to_numpy(spec.drude_idx)])
        self._others = torch.as_tensor(np.setdiff1d(np.arange(self.n_ext), pair_rows),
                                       device=self.device)

    def set_velocities_boltzmann(self, seed=1):
        """Maxwell-Boltzmann cores at T; Drudes start with their core's
        velocity (a cold relative coordinate)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        std = torch.sqrt(self.T * BOLTZMANN / self.masses)
        v = std * torch.randn(self.pos.shape, generator=gen, dtype=self.dtype,
                              device=self.device)
        v[self.spec.drude_idx] = v[self.spec.core_idx]
        self.vel = v

    def _kick(self, vel):
        """Dual Langevin: the per-atom kick everywhere, then the
        oscillators' rows overwritten by the centre-of-mass kick at (T,
        gamma) and the relative one at (T_drude, gamma_drude)."""
        ci, di = self.spec.core_idx, self.spec.drude_idx
        g, gd, dt, m_c, m_d, M = (self.gamma, self.gamma_d, self.dt, self._m_c,
                                  self.spec.m_drude, self._M)
        noise = torch.randn(vel.shape, generator=self.generator, dtype=vel.dtype,
                            device=vel.device)
        vel_all = vel - g * vel * dt + noise * self._vc_atom
        v_c, v_d = vel[ci], vel[di]
        v_com = (m_c * v_c + m_d * v_d) / M
        v_rel = v_d - v_c
        n2 = torch.randn(v_com.shape, generator=self.generator, dtype=vel.dtype,
                         device=vel.device)
        n3 = torch.randn(v_rel.shape, generator=self.generator, dtype=vel.dtype,
                         device=vel.device)
        v_com = v_com - g * v_com * dt + n2 * self._vc_com
        v_rel = v_rel - gd * v_rel * dt + n3 * self._vc_rel
        vel_all[ci] = v_com - (m_d / M) * v_rel
        vel_all[di] = v_com + (m_c / M) * v_rel
        return vel_all

    def step(self, niter=1):
        """Run `niter` steps; returns (Ekin_physical, Epot, T_physical,
        T_drude_rel): the physical numbers use the centres of mass and the
        non-polarizable atoms, the last is the relative coordinates'
        temperature (near T_drude). One host read at the end."""
        # the forces carried out of the previous call stay valid while pos
        # is this object's own; a first call or a replaced pos evaluates
        if self._last_frc is None or self._last_pos is not self.pos:
            self._last_frc = self._ef(self.pos, self.box)[1]
        pos, vel, frc, m, dt = self.pos, self.vel, self._last_frc, self.masses, self.dt
        thermo = self.T > 0 and self.gamma > 0
        pot = {}
        for _ in range(int(niter)):
            acc = frc / m
            pos = pos + vel * dt + 0.5 * acc * dt * dt
            vel = vel + 0.5 * dt * acc
            pot, frc = self._ef(pos, self.box)
            if thermo:
                vel = self._kick(vel)
            vel = vel + 0.5 * dt * (frc / m)
        self.pos, self.vel, self._last_frc = pos, vel, frc
        self._last_pos = self.pos
        return self._report(sum(pot.values(), pos.new_zeros(())))

    def _report(self, epot):
        ci, di = self.spec.core_idx, self.spec.drude_idx
        v = self.vel
        v_com = (self._m_c * v[ci] + self.spec.m_drude * v[di]) / self._M
        v_rel = v[di] - v[ci]
        o = self._others
        ke_phys = 0.5 * ((self._M[:, 0] * (v_com ** 2).sum(1)).sum()
                         + (self.masses[o, 0] * (v[o] ** 2).sum(1)).sum())
        ke_rel = 0.5 * (self._mu[:, 0] * (v_rel ** 2).sum(1)).sum()
        ke_phys, ke_rel, epot = (float(x) for x in torch.stack([ke_phys, ke_rel, epot]).cpu())
        npol = int(ci.shape[0])
        T_phys = float(kinetic_to_temp(ke_phys, self.n_ext - npol))
        T_rel = float(kinetic_to_temp(ke_rel, npol))
        return ke_phys, epot, T_phys, T_rel


# ----------------------------------------------------------------------
# CHARMM Drude-2013 file ingestion: RTF ALPHA/THOLE attributes and
# LONEPAIR virtual sites
# ----------------------------------------------------------------------

LP_BISECTOR = 0
LP_COLINEAR = 1
LP_RELATIVE = 2


class LonePairSpec(NamedTuple):
    """Massless virtual charge sites reconstructed from host geometry.

    `hosts` rows are (A, B, C) core-atom indices; the site sits at
    distance `dist` from A with direction cos(angle) along A->ref +
    sin(angle) in the (cos(dihe), sin(dihe)) transverse frame, where ref
    is B (relative/colinear) or the (B, C) bisector (bisector kind) --
    CHARMM's LONEPAIR internal-coordinate semantics. Positions are torch
    functions of the hosts, so autograd carries the site force to them."""

    kind: torch.Tensor     # (nlp,) int64 LP_* code
    hosts: torch.Tensor    # (nlp, 3) int64 (A, B, C); C=B for colinear
    dist: torch.Tensor     # (nlp,)
    angle: torch.Tensor    # (nlp,) radians
    dihe: torch.Tensor     # (nlp,) radians
    charge: torch.Tensor   # (nlp,) site charges


def _unit(v, eps=1e-12):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True) + eps)


def lonepair_positions(spec: LonePairSpec, pos, box=None):
    """(nlp, 3) virtual-site positions from core positions."""
    A = pos[spec.hosts[:, 0]]
    vb = wrap_displacement(pos[spec.hosts[:, 1]] - A, box)
    vc = wrap_displacement(pos[spec.hosts[:, 2]] - A, box)
    ub, uc = _unit(vb), _unit(vc)
    ref = torch.where((spec.kind == LP_BISECTOR)[:, None], _unit(ub + uc), ub)
    # transverse frame: n1 in the (ref, C) plane, n2 the plane normal
    n2 = _unit(torch.linalg.cross(ref, uc, dim=-1))
    # degenerate colinear frames (C == B): any transverse works; the angle
    # is 0 for colinear sites so the frame never contributes
    tilt = torch.tensor([0.13, 0.71, 0.37], dtype=pos.dtype, device=pos.device)
    n2 = torch.where((n2 * n2).sum(-1, keepdim=True) > 1e-12, n2,
                     _unit(torch.linalg.cross(ref, ref + tilt, dim=-1)))
    n1 = torch.linalg.cross(n2, ref, dim=-1)
    angle, dihe = spec.angle.to(pos.dtype)[:, None], spec.dihe.to(pos.dtype)[:, None]
    direction = torch.cos(angle) * ref + torch.sin(angle) * (
        torch.cos(dihe) * n1 + torch.sin(dihe) * n2)
    return A + spec.dist.to(pos.dtype)[:, None] * direction


def charmm_drude_tables(prm, mol):
    """Map a CHARMM Drude-2013 parameter set's RTF attributes onto a
    Molecule: returns (alpha (n,), thole (n,), charges (n,), lonepairs).
    `prm` is a `forcefields.ff_charmm.CharmmParameterSet` whose RTF carried
    ALPHA/THOLE atom attributes and LONEPAIR records; atoms match by
    (resname, atom name). Lone-pair SITES are atoms of the topology (the
    CHARMM convention); their records come back with host indices
    resolved per residue occurrence."""
    n = int(mol.numAtoms)
    resnames = np.asarray(mol.resname).reshape(-1)
    names = np.asarray(mol.name).reshape(-1)
    resids = np.asarray(getattr(mol, "resid", np.zeros(n, int))).reshape(-1)
    alpha = np.zeros(n)
    thole = np.full(n, np.nan)
    charges = np.zeros(n)
    for a in range(n):
        rec = prm.rtf_atoms.get((str(resnames[a]), str(names[a])))
        if rec is None:
            raise KeyError(f"atom {a} ({resnames[a]}:{names[a]}): no RTF ATOM record")
        alpha[a] = rec["alpha"]
        charges[a] = rec["charge"]
        if rec["thole"] is not None:
            thole[a] = rec["thole"]
    lps = []
    kinds = {"bisector": LP_BISECTOR, "colinear": LP_COLINEAR,
             "relative": LP_RELATIVE, "bisec": LP_BISECTOR}
    for rn, rid in np.unique(np.stack([resnames.astype(str), resids.astype(str)], 1),
                             axis=0):
        rows = np.where((resnames.astype(str) == rn) & (resids.astype(str) == rid))[0]
        by_name = {str(names[a]): int(a) for a in rows}
        for rec in prm.rtf_lonepairs.get(rn, []):
            kname = rec["kind"][:8]
            kind = kinds.get(kname, kinds.get(kname[:5]))
            if kind is None:
                raise NotImplementedError(f"LONEPAIR kind '{rec['kind']}' not supported")
            site = by_name[rec["site"]]
            hosts = [by_name[h] for h in rec["hosts"]]
            while len(hosts) < 3:
                hosts.append(hosts[-1])
            lps.append({"site": site, "kind": kind, "hosts": hosts[:3],
                        "dist": rec["distance"], "angle": np.deg2rad(rec["angle"]),
                        "dihe": np.deg2rad(rec["dihe"]), "charge": charges[site]})
    return alpha, thole, charges, lps


def charmm_nbthole_pairs(prm, mol):
    """Resolve a parameter set's NBTHOLE type-pair table onto atom pairs:
    (m, 3) rows (atom_i, atom_j, a) for every unordered pair of atoms
    whose types (the RTF ATOM records' where present, else mol.atomtype)
    match an entry; None without one. Feed it to
    `make_drude_ffparams(..., nbthole_pairs=...)`."""
    tab = getattr(prm, "nbthole_types", None)
    if not tab:
        return None
    n = int(mol.numAtoms)
    types = np.empty(n, dtype=object)
    resnames = np.asarray(mol.resname).reshape(-1)
    names = np.asarray(mol.name).reshape(-1)
    for a in range(n):
        rec = prm.rtf_atoms.get((str(resnames[a]), str(names[a])))
        types[a] = (rec["type"] if rec is not None
                    else str(np.asarray(mol.atomtype).reshape(-1)[a]))
    rows = []
    for ta, tb in {tuple(sorted(k)) for k in tab}:
        a_val = tab[(ta, tb)]
        for i in np.flatnonzero(types == ta):
            for j in np.flatnonzero(types == tb):
                if i < j:
                    rows.append((int(i), int(j), float(a_val)))
                elif j < i and ta != tb:
                    rows.append((int(j), int(i), float(a_val)))
    if not rows:
        return None
    return np.asarray(sorted(set(rows)), dtype=np.float64)


def make_lonepair_spec(lps, device=None, dtype=torch.float64) -> Optional[LonePairSpec]:
    """A `LonePairSpec` from `charmm_drude_tables`' records (None for
    none) on `device` (default the CUDA card)."""
    if not lps:
        return None
    device = resolve_device(device)

    def t(key, dt=dtype):
        return torch.as_tensor(np.asarray([lp[key] for lp in lps]), dtype=dt, device=device)

    return LonePairSpec(kind=t("kind", torch.int64), hosts=t("hosts", torch.int64),
                        dist=t("dist"), angle=t("angle"), dihe=t("dihe"),
                        charge=t("charge"))


def constrain_lonepairs(spec: LonePairSpec, sites, pos):
    """`pos` with the lone-pair SITE rows (sites: (nlp,) atom rows) set to
    their reconstructed positions: energies on the result are functions of
    the hosts alone, so autograd carries the site forces to the hosts."""
    sites = torch.as_tensor(to_numpy(sites), dtype=torch.int64, device=pos.device)
    return pos.index_put((sites,), lonepair_positions(spec, pos))
