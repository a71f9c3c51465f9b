"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's three main paths through the entry points a user calls
(Molecule -> ForceField -> Parameters -> Forces -> System ->
Integrator.step), f32, imports nothing of JAX or of the JAX package:

  - thrombin-ligand (4,676 atoms, 7 terms, cutoff 7.3 A, reaction field, no
    box, velocity Verlet + Langevin at 300 K / gamma 0.1 ps^-1) at a 2 fs
    timestep (see TIMESTEP): the dense pair kernel and the bonded kernel;
  - the TIP4P/2005 water box of scripts/bench_waterbox.py (25^3 = 15,625
    waters, 62,500 sites, box 77.6 A, cutoff 8.5 A, skin 2 A, PME order 4
    on an 80^3 mesh, SETTLE, virtual sites, Nose-Hoover chain at 300 K,
    tau 200 fs, 2 fs), NVT phase with `column=False`: the cell-list pair
    kernel and the PME spread and ik gather kernels (its bonded plan has
    no rows: the water bonds' force constants are 0);
  - the same box's NPT phase (MTKBarostat(1 bar, 300 K, tau_p 2000 fs),
    iso, seed 3, the defaults of Forces): the column pair kernel with its
    per-axis virial and the PME spread kernel (PME forces by the exact
    gather on the NPT path);
  - the staged probe of the dense pair kernel (python -m
    torchmd_tpu_torch.roofline, 4,676 atoms, tiles of 512): seven stage
    kernels and the elemental-throughput chains.
The dense pair, cell and column kernels walk 32-atom tiles
(csrc/tile_pairs.cuh): bounding-box culling of tile pairs and a per-lane
queue that runs the pair math on full warps; their timings print the
walk's counters (candidate and surviving tile pairs, visited slot pairs,
the share of active lanes in the pair math) beside the times of the
kernels they replaced (EARLIER_MS). The cell kernel reads NBFIX A/B
tables by type pair, and the pair kernels take a term set with several
LJ-family terms in one launch per such term. The PME spread sums chunks
of nearby atoms (the NVT path's cell-list order, the NPT path's column
order) in shared-memory bricks before its global atomics; its checks
print its counters (global atomics, chunks summed in a brick and straight
to the mesh) in every order. The ik gather takes a thread an atom and
skips zero charges (its counters: charged and zero-charge atoms). The
bonded kernel sums each block's rows over its atom window in shared
memory and flushes it with 16-byte atomics; its check prints its
counters.

Phases (each prints lines; any failure raises and exits non-zero):
  1. device: require CUDA, print the card's name and power limit;
  2. build: compile every CUDA kernel from torchmd_tpu_torch/csrc/ with
     nvcc (one process per source, all at once), and print ptxas's
     registers, spills and shared memory for each kernel;
  3. kernels: each kernel (f32) against its plain PyTorch version (f64) on
     the card at the Pallas bars, on several cases (the dense pair kernel
     also with a random mask, in a random atom order, without a cutoff,
     with lj + repulsion (two launches), and twice for bitwise-equal
     forces; the bonded kernel also with every block added straight to the
     forces, its counters against the plan's;
     the cell kernel also through Forces(nbfix=True) with an NBFIX row
     (its NBFIX instance) and with lj + repulsion (two launches); the
     spread in the cell, column, input and a random order, and in the cell
     and a random order on a mesh whose Kz % 4 != 0, ODD_MESH; the gather
     twice for bitwise-equal forces, zero rows for zero charges; the dense-PME
     path, DENSE_PME_N^3 waters on Forces defaults, its spread in the
     input order against plain and timed beside the pair kernel and a
     whole evaluation); then each kernel and
     its plain version timed at f32 at the main paths' shapes (CUDA events
     around each of 30 calls queued behind a sleep kernel, median: device
     time), and each kernel's bound (the least time the card could take
     for the work these inputs need);
  4. parity: thrombin's Forces on the kernel path against autograd of the
     port's compute_potentials at f32;
  5. dynamics: thrombin, a warm-up chunk, then 1,000 timed Langevin steps
     with the launch counters reset just before and read just after, a
     profiler breakdown (device busy share, the pair and bonded kernels'
     shares of a step's device time); 10 NVE steps on the kernel path
     against the dense f64 torch-op path;
  6. waterbox: the water box, a warm-up chunk, then WATER_STEPS timed NVT
     steps with the counters reset just before and read just after;
     SETTLE error, snapped sites, the extended-energy change; NVE_STEPS
     NVE steps of the kernel path against the plain f64 path from one
     state (energy change); then 10 NVT steps from one state of the kernel
     path against the plain path at f32 and f64, with the deviation after
     steps 1, 2, 5 and 10 beside the rounding floor (the kernel path from
     a start moved by one f32 ulp per coordinate; also at coordinates
     shifted by 2 box edges, where the ulp doubles) and two fault controls
     (the kernel path with every charge scaled by 1 + 1e-3 and 1 + 1e-2);
  7. column kernels: the column kernel and the cell kernel's virial
     variant (f32) against their plain versions (f64) on the full box, the
     216-water box and a 1,500-atom charged LJ gas; both timed at the same
     full-box state, with visited slot pairs and bounds;
  8. npt: the full box's NPT phase, NPT_WARMUP then NPT_STEPS timed steps
     with the counters reset just before and read just after (steps/s,
     launches per step, volume, density, T, the extended-energy change,
     SETTLE and site errors, no cell launch), a profiler breakdown, and a
     10-step kernel (f32) against plain (f64) check of positions and box
     beside the one-ulp floor and a 1 % charge control;
  9. roofline: every probe stage (f32) against its plain version (f64) at
     the probe's full size, on its inputs and on the same rows without
     pairs nearer than 2 A, each row's force held to the size of its terms
     (force_scale); four planted faults (the plain version with k_rf
     doubled or the switch moved) that the checks must catch; the chain kernels against their plain
     versions at the probe's shape; then the probe's own run with its
     counters reset just before and read just after: stage times, deltas,
     the mxred-vs-forces error (within 1e-5 of each row's scale, without
     the close pairs) and the chain throughputs.
The last two lines are a JSON summary of the kernels and the JSON status
line. Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")
TERMS = ["bonds", "angles", "dihedrals", "impropers", "1-4",
         "electrostatics", "lj"]
CUTOFF, RFA, TEMP, GAMMA = 7.3, True, 300.0, 0.1
# bench.py's 4 fs diverges to NaN within 50 steps here: no constraints and
# 1.008-amu hydrogens put the X-H stretch past velocity Verlet's stability
# limit (the JAX package integrates the same numbers). 2 fs stays stable;
# the work per step, and so steps/s, does not depend on the timestep.
TIMESTEP = 2.0
TIMED_STEPS = 1000
WARMUP_STEPS = 100
E_TOL, F_TOL = 2e-5, 5e-5     # tests/test_pallas.py:51-57 bars
MESH_TOL = 1e-5               # spread: max |d mesh| <= MESH_TOL * max |mesh|
DEVICE = "cuda"
MAIN_SYSTEM = ("thrombin-ligand-amber", "structure.pdb")

# The water box of scripts/bench_waterbox.py: n^3 waters on a 3.104 A
# lattice (0.997 g/cm^3) with seed-0 jitter; and the 216-water box of
# tests/test_gromacs.py (6^3 on 3.25 A, 19.5 A box, cutoff 4 A, PME order 6).
WATER_N, WATER_SPACING, WATER_CUTOFF = 25, 3.104, 8.5
SMALL_WATER = (6, 3.25, 4.0)
# the spread's check on a mesh whose Kz % 4 != 0 (the brick's flush by
# scalar atomics): 45^3 for the 216-water box, 75^3 for the full box
ODD_MESH = {"water216": 45, "water-full": 75}
# the dense-PME path (PME from 4,096 atoms, the dense pair kernel below
# 12,000: forces.PME_AUTO_N, CELL_AUTO_N): the bench's lattice at 14^3
# waters, 10,976 sites in a 43.5 A box
DENSE_PME_N = 14
WATER_TERMS = ["bonds", "lj", "electrostatics"]
WATER_WARMUP, WATER_STEPS, WATER_CHUNK = 100, 500, 100
# 10 steps from one state at ~440 K, kernel path f32 against the plain
# path at f32 and f64: SETTLE's velocity correction (pos_c - pos) / dt
# turns f32 rounding of the absolute coordinates (an ulp is 7.6e-6 A
# between 64 and 128 A) into velocity every step, so any difference in
# the low bits grows to the same deviation as a start moved by one ulp
# (the floor). The kernel path stays within WATER_FLOOR_FACTOR x the floor
# of the plain paths after 10 steps; the larger charge-scale control must
# land beyond that limit.
WATER_FLOOR_FACTOR = 3.0
WATER_WITNESS_STEPS = (1, 2, 5, 10)
WATER_CONTROL_Q = (1e-3, 1e-2)   # relative charge errors of the fault controls
WATER_TAU = 200.0             # fs, the Nose-Hoover chain's time constant
# NVE from one state, kernel path f32 against the plain path f64: the two
# trajectories part at the rounding floor above, so their energy changes
# (each +12 to +26 kcal/mol over 100 steps, run to run) differ by that
# spread; they agree within NVE_DH_TOL kcal/mol
NVE_STEPS, NVE_DH_TOL = 100, 20.0
KERNEL_SOURCES = ("nonbonded", "bonded", "cell", "pme", "column", "roofline")
# Device ms per call of the lane-per-pair cell and column kernels that the
# tile walk replaced, at the full box's state (lowest and highest of three
# runs on an H100 80GB HBM3 at 700 W; PERF.md)
EARLIER_MS = {"cell": (1.2551, 1.2651), "cell_virial": (1.3489, 1.3594),
              "column": (1.4640, 1.4764),
              # the thread-per-row dense pair kernel on thrombin and the
              # thread-per-atom spread at the full box
              "pair": (0.1413, 0.1417), "pme_spread": (0.0433, 0.0464),
              # the thread-per-row bonded kernel with global atomics and a
              # finishing launch on thrombin, the thread-per-atom ik gather
              # at the full box (PR 4's and PR 5's calls)
              "bonded": (0.0217, 0.0233), "pme_gather": (0.0136, 0.0139)}
# the NBFIX row of the water box's cell-kernel check, for the oxygens' LJ
# type: eps 0.2 kcal/mol and Rmin 3.6 A (Lorentz-Berthelot gives 0.185
# and 3.546)
WATER_NBFIX = (0.2, 3.6)
# the dense pair kernel's extra cases: thrombin with a seeded random mask
# (the topology's exclusions and RANDOM_MASK_ZEROS of the other pairs,
# symmetric) and in
# a seeded random atom order (nothing left to cull), thrombin without a
# cutoff (plain Coulomb and LJ over the whole square)
RANDOM_MASK_ZEROS = 0.1
# the staged probe of the dense pair kernel (scripts/bench_roofline.py)
PROBE_N, PROBE_TILE = 4676, 512
# mxred's forces within 1e-5 of the forces stage's, row by row over each
# row's force_scale, on the probe's rows without pairs nearer than 2 A
MXRED_TOL = 1e-5
# NPT phase: scripts/bench_waterbox.py's second phase, 1 bar, tau_p 2000 fs
NPT_PRESSURE, NPT_TAU_P = 1.0, 2000.0
NPT_WARMUP, NPT_STEPS, NPT_CHUNK = 100, 500, 100
NPT_VOLUME_RANGE = (0.7, 1.4)     # final volume over the lattice's
# the kernel's per-axis virial: 3 multiplies and 3 adds per pair
VIRIAL_FLOPS = 6
# the LJ gas of tests/test_columns.py: 1,500 atoms in 60 A, cutoff 9 A,
# reaction field, charges 0.05 e x N(0, 1)
GAS_N, GAS_L, GAS_CUTOFF = 1500, 60.0, 9.0
GAS_TOP = """
[ defaults ]
  1 2 yes 0.5 0.8333

[ atomtypes ]
  AR 18 39.948 0.0 A 0.3405 0.995792

[ moleculetype ]
  AR 1

[ atoms ]
  1 AR 1 AR AR 1 0.0 39.948

[ system ]
gas

[ molecules ]
AR {n}
"""

# Bounds. Published H100 SXM peaks (NVIDIA datasheet, at 700 W):
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# FP32 operations per pair inside the cutoff, counted in pair_terms.cuh
# and the kernels' loops (an FMA counts 2; rsqrtf, erfcf and expf as
# 1, 20 and 8): distance 8, cutoff test 1, Lorentz-Berthelot mixing 8,
# rsqrt and r 2, LJ 16, charge product 2, force accumulation 6, plus the
# electrostatics: reaction field 10, Ewald erfc 45. The function needs
# each unordered pair once, Newton's third law giving the partner's force
# for NEWTON_J_FLOPS more.
PAIR_FLOPS = {"rfa": 8 + 1 + 8 + 2 + 16 + 2 + 6 + 10,
              "ewald": 8 + 1 + 8 + 2 + 16 + 2 + 6 + 45}
NEWTON_J_FLOPS = 6
# per bonded row, counted in bonded.cu (gathers not counted)
BONDED_ROW_FLOPS = {"bond": 20, "angle": 60, "torsion": 110, "nb14": 40}

TIP4P2005_TOP = """
[ defaults ]
  1 2 yes 0.5 0.8333

[ atomtypes ]
  OW  8 15.99940  0.0     A  0.31589  0.7749
  HW  1  1.00800  0.5564  A  0.0      0.0
  MW  0  0.00000 -1.1128  D  0.0      0.0

[ moleculetype ]
  SOL 2

[ atoms ]
  1 OW 1 SOL OW  1  0.0000 15.9994
  2 HW 1 SOL HW1 1  0.5564  1.008
  3 HW 1 SOL HW2 1  0.5564  1.008
  4 MW 1 SOL MW  1 -1.1128  0.000

[ settles ]
  1 1 0.09572 0.15139

[ virtual_sites3 ]
; site i j k funct a b
  4 1 2 3 1 0.13193828 0.13193828

[ exclusions ]
1 2 3 4
2 1 3 4
3 1 2 4
4 1 2 3

[ system ]
tip4p/2005

[ molecules ]
SOL {nw}
"""


def require(cond, what):
    """Fail the run (also under python -O, unlike assert)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def load_amber(folder, coords, extra=None, terms=TERMS, precision="single"):
    from torchmd_tpu_torch.forcefields.ff_amber import AmberForcefield
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.parameters import Parameters

    d = os.path.join(DATA, folder)
    mol = Molecule(os.path.join(d, "structure.prmtop"))
    mol.read(os.path.join(d, coords))
    if extra:
        mol.read(os.path.join(d, extra))
    ff = AmberForcefield(mol, os.path.join(d, "structure.prmtop"))
    return mol, Parameters(ff, mol, terms, precision=precision)


def tip4p_water(origin):
    """One TIP4P geometry: O, H1, H2, and the M row at O (snapped later)."""
    doh, theta = 0.9572, np.radians(104.52)
    o = np.asarray(origin, dtype=np.float64)
    h1 = o + doh * np.array([np.cos(theta / 2), np.sin(theta / 2), 0.0])
    h2 = o + doh * np.array([np.cos(theta / 2), -np.sin(theta / 2), 0.0])
    return np.stack([o, h1, h2, o])


def build_water(n, spacing, jitter, precision="single"):
    """(mol, par, box edge) of an n^3 TIP4P/2005 lattice: origins at
    g * spacing + 0.8 plus seed-0 normal jitter of 0.05 A (the bench), or
    g * spacing + 0.9 without jitter (the 216-water test box)."""
    from torchmd_tpu_torch.forcefields import ForceField
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.parameters import Parameters

    with tempfile.TemporaryDirectory() as td:
        top = os.path.join(td, "tip4p.top")
        with open(top, "w") as fh:
            fh.write(TIP4P2005_TOP.format(nw=n**3))
        mol = Molecule(top)
        ff = ForceField.create(mol, top)
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    rs = np.random.RandomState(0)
    origins = [g * spacing + (0.8 + rs.randn(3) * 0.05 if jitter else 0.9)
               for g in grid]
    mol.coords = np.concatenate([tip4p_water(o) for o in origins])[:, :, None]
    L = n * spacing
    mol.box = np.full((3, 1), L)
    return mol, Parameters(ff, mol, WATER_TERMS, precision=precision), L


def cuda_events_ms(fn, calls=30, warmup=3):
    """Median device milliseconds of `fn()` (torchmd_tpu_torch.roofline's
    device_ms: CUDA events around each call, queued behind a sleep
    kernel)."""
    from torchmd_tpu_torch.roofline import device_ms

    return device_ms(fn, calls, warmup)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    FP32 operations over the FP32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def pair_flops(pairs, elec):
    """FP32 operations of the pair function over `pairs` unordered pairs
    inside the cutoff."""
    return pairs * (PAIR_FLOPS[elec] + NEWTON_J_FLOPS)


def tile_walk(kernel, call):
    """Run `call(stats)` once with a fresh counter tensor and log the tile
    walk's counters; returns them as a dict."""
    import torch

    from torchmd_tpu_torch.ops import cell as kc

    stats = torch.zeros(kc.NSTATS, dtype=torch.int64, device=DEVICE)
    call(stats)
    torch.cuda.synchronize()
    walk = dict(zip(kc.STATS, (int(v) for v in stats.tolist())))
    walk["active_lane_share"] = walk["lane_rounds"] / max(1, 32 * walk["rounds"])
    walk["surviving_share"] = walk["tile_pairs"] / max(1, walk["candidate_tile_pairs"])
    log("tile_walk", kernel=kernel, **walk)
    return walk


def log_earlier(kernel, ms):
    lo, hi = EARLIER_MS[kernel]
    log("vs_earlier", kernel=kernel, ms=f"{ms:.4f}", earlier_ms=f"{lo:.4f}-{hi:.4f}",
        speedup_vs_lowest=f"{lo / ms:.2f}")


# ----------------------------------------------------------------------
def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    log("device", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    return smi


def phase_build():
    from torchmd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(_build.build, KERNEL_SOURCES))
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        sources=",".join(f"{s}.cu" for s in KERNEL_SOURCES))
    for lib in KERNEL_SOURCES:
        usage = _build.resource_usage(lib)
        require(usage, f"no ptxas report for {lib}.cu")
        for kernel, fields in usage.items():
            log("ptxas", source=f"{lib}.cu", kernel=kernel, **fields)


def _kernel_cases():
    """(name, Parameters, positions, box or None, Forces kwargs, cfg edit,
    lj_ab override) for the kernel-versus-plain comparison."""
    thr_mol, thr_par = load_amber(*MAIN_SYSTEM)
    ala_mol, ala_par = load_amber("prod_alanine_dipeptide_amber", "input.coor",
                                  "input.xsc")
    rep_terms = ["bonds", "angles", "dihedrals", "impropers", "electrostatics",
                 "repulsion"]
    _, rep_par = load_amber("prod_alanine_dipeptide_amber", "input.coor",
                            terms=rep_terms)
    _, ljrep_par = load_amber("prod_alanine_dipeptide_amber", "input.coor",
                              terms=TERMS + ["repulsion"])
    ala_pos = ala_mol.coords[:, :, 0]
    ala_box = ala_mol.box[:, 0]
    # NBFIX: Lorentz-Berthelot tables with one pair perturbed
    prm = np.asarray(ala_par.nonbonded_params["params"], np.float64)
    sig_ij = 0.5 * (prm[:, 0][:, None] + prm[:, 0][None, :])
    B = 4.0 * np.sqrt(np.abs(prm[:, 1][:, None] * prm[:, 1][None, :])) * sig_ij**6
    A = B * sig_ij**6
    A[0, 1] = A[1, 0] = A[0, 1] * 1.35 + 10.0
    B[0, 1] = B[1, 0] = B[0, 1] * 0.8 + 1.0
    return [
        ("thrombin", thr_par, thr_mol.coords[:, :, 0], None,
         dict(cutoff=CUTOFF, rfa=RFA), None, None),
        ("alanine-pbc", ala_par, ala_pos, ala_box,
         dict(cutoff=9.0, switch_dist=7.5, rfa=True), None, None),
        ("alanine-ewald", ala_par, ala_pos, ala_box,
         dict(cutoff=9.0), dict(ewald_alpha=0.35), None),
        ("alanine-repulsion", rep_par, ala_pos, None,
         dict(cutoff=9.0, terms=rep_terms), None, None),
        ("alanine-nbfix", ala_par, ala_pos, ala_box,
         dict(cutoff=9.0, switch_dist=7.5, rfa=True), None, (A, B)),
        # two LJ-family terms: two launches of the pair kernel
        ("alanine-lj-repulsion", ljrep_par, ala_pos, ala_box,
         dict(cutoff=9.0, switch_dist=7.5, rfa=True, terms=TERMS + ["repulsion"]), None,
         None),
    ]


def _compare(tag, pot_k, f_k, pot_p, f_p):
    """Kernel result against the plain one at the Pallas bars; returns the
    max abs force error."""
    require(set(pot_k) == set(pot_p), (tag, sorted(pot_k), sorted(pot_p)))
    for k in pot_p:
        ek, ep = float(pot_k[k]), float(pot_p[k])
        require(abs(ek - ep) <= E_TOL * max(1.0, abs(ep)), (tag, k, ek, ep))
    f_p = f_p.double()
    err = float((f_k.double() - f_p).abs().max())
    require(err <= F_TOL * max(1.0, float(f_p.abs().max())), (tag, err))
    return err


def _thrombin_pair_count(d32, cutoff, pos):
    """Unordered non-excluded pairs inside the cutoff."""
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    return int(((d32.mask != 0) & (d2 <= cutoff * cutoff)).sum()) // 2


def _with_mask(data, mask, perm=None):
    """NBData with another mask (and, with `perm`, its atoms reordered),
    its tile exclusions made anew."""
    from torchmd_tpu_torch.ops import nonbonded as kn

    if perm is not None:
        data = data._replace(q=data.q[perm], sig=data.sig[perm], eps=data.eps[perm],
                             types=data.types[perm])
        mask = mask[perm][:, perm]
    mask = mask.contiguous()
    start, tile, bits = kn.tile_exclusions(mask)
    return data._replace(mask=mask, excl_start=start, excl_tile=tile, excl_bits=bits)


def _pair_extra_cases(par, pos):
    """(name, cfg edit, NBData edit (d -> d), position permutation or None)
    for the dense pair kernel on thrombin beyond _kernel_cases."""
    import torch

    n = par.natoms
    rs = np.random.RandomState(5)
    zeros = np.triu(rs.rand(n, n) < RANDOM_MASK_ZEROS, 1)
    kept = torch.as_tensor(~(zeros | zeros.T), device=DEVICE)
    perm = torch.as_tensor(rs.permutation(n), device=DEVICE)
    return [
        # the topology's exclusions and random ones
        ("thrombin-random-mask", None,
         lambda d: _with_mask(d, (d.mask != 0) & kept), None),
        ("thrombin-permuted", None, lambda d: _with_mask(d, d.mask, perm), perm),
        ("thrombin-nocutoff", dict(cutoff=None, switch_dist=None, rfa=False),
         lambda d: d, None),
    ]


def dense_pair_cases():
    """Yield (name, inputs) of the dense pair kernel's checks on DEVICE:
    _kernel_cases, then _pair_extra_cases made from thrombin's. inputs:
    dict of par, ffp32, ffp64 (None for the extras), cfg, d32, d64
    (NBData), p32, p64, b32, b64 (None without a box)."""
    import torch

    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.potentials import make_ffparams

    dev = torch.device(DEVICE)
    thrombin = None
    for name, par, pos, box, kw, cfg_edit, lj_ab in _kernel_cases():
        kw = dict(kw)
        terms = kw.pop("terms", TERMS)
        forces = Forces(par, terms=terms, precision="single", device=dev, **kw)
        ffp32 = forces.ffparams
        ffp64 = make_ffparams(par, dtype=torch.float64, device=dev)
        if lj_ab is not None:
            ffp32 = ffp32._replace(lj_ab=tuple(
                torch.as_tensor(t, dtype=torch.float32, device=dev) for t in lj_ab))
            ffp64 = ffp64._replace(lj_ab=tuple(
                torch.as_tensor(t, dtype=torch.float64, device=dev) for t in lj_ab))
        inp = dict(par=par, ffp32=ffp32, ffp64=ffp64,
                   cfg=forces.config._replace(**(cfg_edit or {})),
                   d32=kn.prepare_nb_data(ffp32), d64=kn.prepare_nb_data(ffp64),
                   p32=torch.as_tensor(pos, dtype=torch.float32, device=dev),
                   p64=torch.as_tensor(pos, dtype=torch.float64, device=dev),
                   b32=None if box is None else torch.as_tensor(box, dtype=torch.float32,
                                                                device=dev),
                   b64=None if box is None else torch.as_tensor(box, dtype=torch.float64,
                                                                device=dev))
        if name == "thrombin":
            thrombin = inp
        yield name, inp
    t = thrombin
    for name, cfg_edit, edit, perm in _pair_extra_cases(t["par"], t["p32"]):
        yield name, dict(
            t, ffp32=None, ffp64=None, cfg=t["cfg"]._replace(**(cfg_edit or {})),
            d32=edit(t["d32"]), d64=edit(t["d64"]),
            p32=t["p32"] if perm is None else t["p32"][perm],
            p64=t["p64"] if perm is None else t["p64"][perm])


def phase_kernels():
    """The dense pair and bonded kernels on thrombin and alanine; the pair
    kernel also with a random mask, a random atom order and no cutoff, and
    its forces twice, bit for bit."""
    import torch

    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn

    errs = {"pair": 0.0, "bonded": 0.0}
    timing_inputs = None
    for name, c in dense_pair_cases():
        n0 = kn.LAUNCHES
        pot_k, f_k = kn.nonbonded_energy_forces(c["d32"], c["cfg"], c["p32"], c["b32"])
        launches = kn.LAUNCHES - n0
        pot_p, f_p = kn.pair_terms_reference(c["d64"], c["cfg"], c["p64"], c["b64"])
        torch.cuda.synchronize()
        e_pair = _compare(f"{name}/pair", pot_k, f_k, pot_p, f_p)
        require(launches == len(kn.launch_cfgs(c["cfg"])), (name, "pair launches", launches))
        errs["pair"] = max(errs["pair"], e_pair)
        fields = dict(pair_launches=launches,
                      excluded_tile_pairs=int(c["d32"].excl_tile.shape[0]))
        if c["ffp32"] is not None:
            plan64 = kb.build_bonded_kernel_plan(c["ffp64"], c["cfg"])
            pot_p, f_p = kb.bonded_reference(plan64, c["p64"], c["b64"])
            torch.cuda.synchronize()
            # the shipped plan, and no window: every block straight to the forces
            for wcap in (kb.WCAP, 0):
                plan32 = kb.build_bonded_kernel_plan(c["ffp32"], c["cfg"], wcap=wcap)
                pot_k, f_k = bonded_walk(name, plan32, c["p32"], c["b32"])
                err = _compare(f"{name}/bonded/wcap={wcap}", pot_k, f_k, pot_p, f_p)
                errs["bonded"] = max(errs["bonded"], err)
                if wcap == kb.WCAP:
                    fields["bonded_max_abs_err"] = err
                    if name == "thrombin":
                        timing_inputs = (c["d32"], c["cfg"], c["p32"], plan32)
        log("kernels", case=name, natoms=c["par"].natoms, pair_max_abs_err=e_pair, **fields)
    d32, cfg, p32, plan32 = timing_inputs
    runs = [kn.nonbonded_energy_forces(d32, cfg, p32) for _ in range(2)]
    torch.cuda.synchronize()
    require(torch.equal(runs[0][1], runs[1][1]) and all(
        torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0]),
        "the pair kernel's forces or energies differ between two runs")
    log("kernels", case="thrombin", pair_bitwise_repeat=True)

    rows = sum(f.count for f in plan32.families)
    npairs = _thrombin_pair_count(d32, CUTOFF, p32)
    walk = tile_walk("pair", lambda stats: kn.nonbonded_energy_forces(
        d32, cfg, p32, stats=stats))
    flops = pair_flops(npairs, "rfa")
    # the earlier kernel's bound: it read the (N, N) int8 mask
    mask_bound = bound(tensor_bytes(p32, d32.q, d32.sig, d32.eps, d32.types, d32.mask, p32),
                       flops)[0]
    out = {
        "pair": dict(
            ms=cuda_events_ms(lambda: kn.nonbonded_energy_forces(d32, cfg, p32)),
            plain_ms=cuda_events_ms(lambda: kn.pair_terms_reference(d32, cfg, p32)),
            # what the kernel reads: rows and the tile exclusions
            bound=bound(tensor_bytes(p32, d32.q, d32.sig, d32.eps, d32.types,
                                     d32.excl_start, d32.excl_tile, d32.excl_bits, p32),
                        flops),
            work=(f"pairs_in_cutoff={npairs} visited_slot_pairs={walk['slot_pairs']} "
                  f"tile_pairs={walk['tile_pairs']} "
                  f"active_lane_share={walk['active_lane_share']:.4f} "
                  f"mask_bound_ms={mask_bound:.5f}")),
        "bonded": dict(
            ms=cuda_events_ms(lambda: kb.bonded_energy_forces(plan32, p32)),
            plain_ms=cuda_events_ms(lambda: kb.bonded_reference(plan32, p32)),
            bound=bound(rows * (16 + 12) + tensor_bytes(p32, p32),
                        sum(f.count * BONDED_ROW_FLOPS[f.kind] for f in plan32.families)),
            work=(f"rows={rows} rows_per_block={plan32.rows} blocks={len(plan32.windows)} "
                  f"window_cap_atoms={plan32.wcap}")),
    }
    for k, v in out.items():
        v["max_abs_err"] = errs[k]
        log("timing", kernel=k, shapes="thrombin", ms=f"{v['ms']:.4f}",
            plain_ms=f"{v['plain_ms']:.4f}", speedup=f"{v['plain_ms'] / v['ms']:.2f}",
            bound_ms=f"{v['bound'][0]:.5f}", bound_by=v["bound"][1], work=v["work"])
    log_earlier("pair", out["pair"]["ms"])
    log_earlier("bonded", out["bonded"]["ms"])
    return out


def bonded_walk(case, plan, p32, b32):
    """The bonded kernel once with a fresh counter tensor: logs its
    counters (`[bonded_walk]`) and holds the rows and blocks to the plan's
    windows (`ops.bonded.window_stats`); returns (energies, forces)."""
    import torch

    from torchmd_tpu_torch.ops import bonded as kb

    stats = torch.zeros(len(kb.STATS), dtype=torch.int64, device=DEVICE)
    n0 = kb.LAUNCHES
    pot, frc = kb.bonded_energy_forces(plan, p32, b32, stats=stats)
    torch.cuda.synchronize()
    got = dict(zip(kb.STATS, (int(v) for v in stats.tolist())))
    want = kb.window_stats(plan)
    log("bonded_walk", case=case, rows_per_block=plan.rows, window_cap_atoms=plan.wcap,
        widest_window=int(plan.windows[:, 1].max()), **got)
    require(kb.LAUNCHES == n0 + 1, (case, "bonded launches"))
    require(all(got[k] == v for k, v in want.items()), (case, "bonded counters", got, want))
    # a windowed block flushes each touched 16-byte group once at most;
    # a direct row makes 3 atomics per atom
    require(got["global_atomics"] <= 3 * 4 * got["window_rows"] + 12 * got["direct_rows"],
            (case, "bonded atomics", got))
    return pot, frc


def _water_forces(par, cutoff, precision="single", plain=False, gather=None,
                  column=False):
    """The water box's Forces; the NVT phase keeps the cell kernel
    (column=False), the NPT phase takes the defaults (column=None)."""
    from torchmd_tpu_torch.forces import Forces

    return Forces(par, terms=WATER_TERMS, precision=precision, cutoff=cutoff,
                  elec="ewald" if par.natoms >= 4096 else "pme", kernel="cell",
                  device=DEVICE, plain=plain, gather=gather, column=column)


def _water_pair_count(data, pos, box, cutoff, rows=2048):
    """Unordered pairs inside the cutoff: minimum-image pairs within the
    cutoff, less self and excluded pairs, halved."""
    import torch

    n = pos.shape[0]
    total = 0
    for r0 in range(0, n, rows):
        dv = pos[r0:r0 + rows, None, :] - pos[None, :, :]
        dv = dv - box * torch.round(dv / box)
        total += int(((dv * dv).sum(-1) <= cutoff * cutoff).sum())
    excl = data.excl.long()
    partner = torch.where(excl < n, excl, torch.arange(n, device=pos.device)[:, None])
    dv = pos[:, None, :] - pos[partner]
    dv = dv - box * torch.round(dv / box)
    near = ((dv * dv).sum(-1) <= cutoff * cutoff) & (excl < n)
    return (total - n - int(near.sum())) // 2


def water_cases():
    """(name, n, spacing, cutoff, jitter) of the kernel checks' water
    boxes: the 216-water box and the full box."""
    return (("water216",) + SMALL_WATER + (False,),
            ("water-full", WATER_N, WATER_SPACING, WATER_CUTOFF, True))


def water_case(n, spacing, cutoff, jitter):
    """A water box's kernel inputs on DEVICE: dict of par, f32 and f64
    Forces (the kernel path, the plain f64 path), raw positions, box_np,
    b32, b64, p32 (sites snapped, f32) and p64 (the same, upcast), the f32
    cell list cl."""
    import torch

    from torchmd_tpu_torch.vsites import apply_vsites

    mol, par, L = build_water(n, spacing, jitter)
    f32 = _water_forces(par, cutoff)
    f64 = _water_forces(par, cutoff, "double", plain=True)
    box_np = np.full((1, 3), L)
    raw = torch.as_tensor(mol.coords[:, :, 0], dtype=torch.float64, device=DEVICE)
    f32.prepare(raw.float()[None], box_np)
    f64.prepare(raw[None], box_np)
    b32 = torch.as_tensor(box_np[0], dtype=torch.float32, device=DEVICE)
    b64 = b32.double()
    # one set of inputs: the f32 positions, upcast for the plain version
    p32 = apply_vsites(f64.vsites, raw, b64).float()
    return dict(par=par, cutoff=cutoff, f32=f32, f64=f64, raw=raw, box_np=box_np, b32=b32,
                b64=b64, p32=p32, p64=p32.double(), cl=f32._cell_kernel.build(p32, b32))


def water_spread_orders(c):
    """The spread's orders on a water_case: the NVT path's (the cell
    list's slots), the NPT path's (the columns' i slots), the input order
    and a random one, which leaves no chunk a brick can hold."""
    import torch

    cols = _water_forces(c["par"], c["cutoff"], column=True)
    cols.prepare(c["raw"].float()[None], c["box_np"])
    return {"cell": c["cl"].slots,
            "column": cols._cell_kernel.build(c["p32"], c["b32"]).islot,
            "none": None,
            "random": torch.as_tensor(np.random.RandomState(6).permutation(c["par"].natoms),
                                      dtype=torch.int32, device=DEVICE)}


def spread_checks(name, c, orders, kmesh):
    """The spread kernel on a water_case at `kmesh` against plain f64 in
    each of `orders` (from water_spread_orders): max |d mesh| within
    MESH_TOL of the mesh's maximum, every atom once in the order, every
    charged atom spread, the cell order summed in bricks, the random and
    the input order straight to the mesh. Logs a [spread_walk] line per
    order; returns the largest error."""
    import torch

    from torchmd_tpu_torch.ops import pme as kp

    rec32, rec64 = c["f32"]._ewald, c["f64"]._ewald
    order, q32, natoms = rec32.ORDER, rec32.charges, c["par"].natoms
    mesh_p = kp.spread_reference(c["p64"], rec64.charges, c["b64"], kmesh, order)
    worst = 0.0
    for oname, oidx in orders.items():
        if oidx is not None:
            ids = oidx.reshape(-1)
            ids = ids[ids < natoms].long()
            require(torch.equal(torch.sort(ids).values, torch.arange(natoms, device=ids.device)),
                    (name, oname, "the order does not hold every atom once"))
        stats = torch.zeros(len(kp.SPREAD_STATS), dtype=torch.int64, device=DEVICE)
        mesh_k = kp.pme_spread(c["p32"], q32, c["b32"], kmesh, order, oidx, stats=stats)
        torch.cuda.synchronize()
        err = float((mesh_k.double() - mesh_p).abs().max())
        require(err <= MESH_TOL * float(mesh_p.abs().max()), (name, kmesh, "spread", oname, err))
        stats = dict(zip(kp.SPREAD_STATS, (int(v) for v in stats.tolist())))
        log("spread_walk", case=name, mesh=kmesh[0], order_idx=oname, max_abs_err=err,
            taps=natoms * order**3, **stats)
        require(stats["charged_atoms"] == int((q32 != 0).sum()),
                (name, kmesh, oname, "charged atoms spread", stats))
        require(oname not in ("random", "none")
                or (stats["direct_chunks"] > 0 and stats["brick_chunks"] == 0),
                (name, kmesh, oname, "not straight to the mesh", stats))
        require(oname != "cell" or stats["brick_chunks"] > 0,
                (name, kmesh, "the cell order reached no brick", stats))
        worst = max(worst, err)
    return worst


def gather_checks(name, c, grids32, grids64):
    """The ik gather kernel on a water_case against plain f64 at the
    Pallas force bar, its forces bitwise equal over two runs, every charged
    atom gathered and every zero-charge atom given its zero row. Logs a
    [gather_walk] line; returns the force error."""
    import torch

    from torchmd_tpu_torch.ops import pme as kp

    rec32, rec64 = c["f32"]._ewald, c["f64"]._ewald
    order, q32, natoms = rec32.ORDER, rec32.charges, c["par"].natoms
    f_p = kp.gather_ik_reference(c["p64"], rec64.charges, c["b64"], grids64, order)
    stats = torch.zeros(len(kp.GATHER_STATS), dtype=torch.int64, device=DEVICE)
    f_k = kp.pme_gather_ik(c["p32"], q32, c["b32"], grids32, order, stats=stats)
    again = kp.pme_gather_ik(c["p32"], q32, c["b32"], grids32, order)
    torch.cuda.synchronize()
    err = _compare(f"{name}/pme_gather", {}, f_k, {}, f_p)
    require(torch.equal(f_k, again), (name, "gather forces differ between two runs"))
    stats = dict(zip(kp.GATHER_STATS, (int(v) for v in stats.tolist())))
    charged = int((q32 != 0).sum())
    log("gather_walk", case=name, mesh=grids32[0].shape[0], order=order, max_abs_err=err,
        bitwise_repeat=True, **stats)
    require(stats == {"charged_atoms": charged, "zero_charge_atoms": natoms - charged},
            (name, "gather atoms", stats))
    require(not bool(f_k[q32 == 0].any()), (name, "a zero-charge atom has a gather force"))
    return err


def pair_variants(name, c):
    """The cell kernel through Forces defaults on a water_case's box: with
    an NBFIX row (WATER_NBFIX, Forces(nbfix=True, kernel="cell"): the
    kernel's NBFIX instance) and with lj + repulsion (one launch per
    LJ-family term), each against the plain f64 path at the Pallas bars.
    Logs a [pair_variants] line each; returns the largest force error."""
    import copy

    import torch

    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.neighbors import CellKernel
    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import nonbonded as kn

    nbfix_par = copy.copy(c["par"])
    ow = int(c["f64"].ffparams.mapped_atom_types[0])  # site 0 is an oxygen
    nbfix_par.nbfix = np.array([(ow, ow) + WATER_NBFIX], np.float64)
    worst = 0.0
    for vname, par, kw in (("nbfix", nbfix_par, dict(nbfix=True, terms=WATER_TERMS)),
                           ("lj+repulsion", c["par"], dict(terms=WATER_TERMS + ["repulsion"]))):
        kw = dict(kw, cutoff=c["cutoff"], kernel="cell", device=DEVICE,
                  elec="ewald" if par.natoms >= 4096 else "pme")
        f32 = Forces(par, precision="single", **kw)
        f64 = Forces(par, precision="double", plain=True, **kw)
        f32.prepare(c["raw"].float()[None], c["box_np"])
        f64.prepare(c["raw"][None], c["box_np"])
        kern = f32._cell_kernel
        require(type(kern) is CellKernel, (name, vname, type(kern).__name__))
        require((kern.data.lj_a is not None) == (vname == "nbfix"), (name, vname, "tables"))
        cl = kern.build(c["p32"], c["b32"])
        n0 = kc.LAUNCHES
        pot_k, f_k = kc.cell_energy_forces(kern.data, kern.cfg, kern.clcfg, cl, c["p32"], c["b32"])
        launches = kc.LAUNCHES - n0
        pot_p, f_p = kc.cell_reference(f64._cell_kernel.data, kern.cfg, kern.clcfg,
                                       cl._replace(ref_pos=cl.ref_pos.double()), c["p64"],
                                       c["b64"])
        torch.cuda.synchronize()
        err = _compare(f"{name}/cell/{vname}", pot_k, f_k, pot_p, f_p)
        require(launches == len(kn.launch_cfgs(kern.cfg)), (name, vname, "launches", launches))
        log("pair_variants", case=name, variant=vname, cell_launches=launches,
            terms=",".join(sorted(pot_k)), max_abs_err=err,
            **{f"E_{k}": float(v) for k, v in pot_k.items()})
        worst = max(worst, err)
        del f32, f64
    return worst


def phase_water_kernels():
    """The cell, PME spread and PME ik-gather kernels against their plain
    f64 versions on the 216-water box (order 6) and the full box (order
    4), the cell kernel also with NBFIX tables and with lj + repulsion, the
    spread in several orders; the timings and bounds at the full box."""
    import torch

    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import pme as kp

    errs = {"cell": 0.0, "pme_spread": 0.0, "pme_gather": 0.0}
    out = {}
    for name, n, spacing, cutoff, jitter in water_cases():
        c = water_case(n, spacing, cutoff, jitter)
        par, p32, p64, b32, b64, cl = (c[k] for k in ("par", "p32", "p64", "b32", "b64", "cl"))
        kern, rec32, rec64 = c["f32"]._cell_kernel, c["f32"]._ewald, c["f64"]._ewald
        cl64 = cl._replace(ref_pos=cl.ref_pos.double())
        d32, cfg, clcfg = kern.data, kern.cfg, kern.clcfg
        d64 = c["f64"]._cell_kernel.data

        pot_k, f_k = kc.cell_energy_forces(d32, cfg, clcfg, cl, p32, b32)
        pot_p, f_p = kc.cell_reference(d64, cfg, clcfg, cl64, p64, b64)
        torch.cuda.synchronize()
        e_cell = _compare(f"{name}/cell", pot_k, f_k, pot_p, f_p)

        kmesh, order = rec32.cfg.kmax, rec32.ORDER
        q32 = rec32.charges
        spread_orders = water_spread_orders(c)
        e_spread = spread_checks(name, c, spread_orders, kmesh)
        e_spread = max(e_spread, spread_checks(
            name, c, {k: spread_orders[k] for k in ("cell", "random")}, (ODD_MESH[name],) * 3))

        grids64 = rec64.ik_grids(p64, b64)
        grids32 = [g.float().contiguous() for g in grids64]
        e_gather = gather_checks(name, c, grids32, grids64)
        e_cell = max(e_cell, pair_variants(name, c))
        for k, e in (("cell", e_cell), ("pme_spread", e_spread), ("pme_gather", e_gather)):
            errs[k] = max(errs[k], e)
        log("water_kernels", case=name, natoms=par.natoms, ncells=clcfg.ncells,
            capacity=clcfg.capacity, mesh=kmesh, order=order,
            cell_max_abs_err=e_cell, spread_max_abs_err=e_spread, gather_max_abs_err=e_gather)
        if name != "water-full":
            continue

        ncells = int(np.prod(clcfg.ncells))
        npairs = _water_pair_count(d32, p32, b32, cutoff)
        slots_total = 27 * ncells * clcfg.capacity ** 2
        c3 = cl.counts.double().reshape(clcfg.ncells)
        visited = int(sum((c3 * torch.roll(c3, shifts=o, dims=(0, 1, 2))).sum()
                          for o in kc.STENCIL))
        walk = tile_walk("cell", lambda stats: kc.cell_energy_forces(
            d32, cfg, clcfg, cl, p32, b32, stats=stats))
        out["cell"] = dict(
            ms=cuda_events_ms(lambda: kc.cell_energy_forces(d32, cfg, clcfg, cl, p32, b32)),
            plain_ms=cuda_events_ms(lambda: kc.cell_reference(d32, cfg, clcfg, cl, p32, b32),
                                    calls=5, warmup=1),
            bound=bound(tensor_bytes(p32, d32.q, d32.sig, d32.eps, cl.slots,
                                     cl.counts, d32.excl, p32),
                        pair_flops(npairs, "ewald")),
            work=(f"pairs_in_cutoff={npairs} cell_slot_pairs={visited} "
                  f"padded_slot_pairs={slots_total} visited_slot_pairs={walk['slot_pairs']} "
                  f"tile_pairs={walk['tile_pairs']} "
                  f"active_lane_share={walk['active_lane_share']:.4f}"))
        log_earlier("cell", out["cell"]["ms"])
        taps = 3 * (4 * order + 5 * order * (order - 2)) + order**2
        mesh_bytes = 4 * int(np.prod(kmesh))
        # the main paths' spread: in the NVT path's order
        slots = spread_orders["cell"]
        unordered_ms = cuda_events_ms(lambda: kp.pme_spread(p32, q32, b32, kmesh, order))
        out["pme_spread"] = dict(
            ms=cuda_events_ms(lambda: kp.pme_spread(p32, q32, b32, kmesh, order, slots)),
            plain_ms=cuda_events_ms(lambda: kp.spread_reference(p32, q32, b32, kmesh, order)),
            # the function reads positions and charges and writes the mesh;
            # the order only schedules it
            bound=bound(tensor_bytes(p32, q32) + mesh_bytes,
                        par.natoms * (taps + 2 * order**3)),
            work=(f"taps={par.natoms * order**3} order_idx=cell_slots "
                  f"order_bytes={tensor_bytes(slots)} input_order_ms={unordered_ms:.4f}"))
        log_earlier("pme_spread", out["pme_spread"]["ms"])
        charged = int((q32 != 0).sum())
        out["pme_gather"] = dict(
            ms=cuda_events_ms(lambda: kp.pme_gather_ik(p32, q32, b32, grids32, order)),
            plain_ms=cuda_events_ms(
                lambda: kp.gather_ik_reference(p32, q32, b32, grids32, order)),
            # the work of the charged atoms: a zero-charge atom's row is 0
            bound=bound(tensor_bytes(p32, q32, p32) + 3 * mesh_bytes,
                        charged * (taps + 7 * order**3)),
            work=f"taps={charged * order**3} charged_atoms={charged}")
        log_earlier("pme_gather", out["pme_gather"]["ms"])
    for k, v in out.items():
        v["max_abs_err"] = errs[k]
        log("timing", kernel=k, shapes="water-full", ms=f"{v['ms']:.4f}",
            plain_ms=f"{v['plain_ms']:.4f}", speedup=f"{v['plain_ms'] / v['ms']:.2f}",
            bound_ms=f"{v['bound'][0]:.5f}", bound_by=v["bound"][1], work=v["work"])
    return out


def phase_dense_pme():
    """The dense-PME path on `Forces` defaults (the dense pair kernel and
    PME with the spread in the input order): the bench's lattice at
    DENSE_PME_N^3 waters. The spread against plain f64, then device ms of
    the spread, the pair kernel and one whole force evaluation."""
    import torch

    from torchmd_tpu_torch.forces import CELL_AUTO_N, PME_AUTO_N, Forces
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.ops import pme as kp
    from torchmd_tpu_torch.vsites import apply_vsites

    mol, par, L = build_water(DENSE_PME_N, WATER_SPACING, True)
    require(PME_AUTO_N <= par.natoms < CELL_AUTO_N, ("not the dense-PME range", par.natoms))
    f = Forces(par, terms=WATER_TERMS, precision="single", cutoff=WATER_CUTOFF,
               elec="ewald", device=DEVICE)
    box_np = np.full((1, 3), L)
    raw = torch.as_tensor(mol.coords[:, :, 0], dtype=torch.float32, device=DEVICE)
    f.prepare(raw[None], box_np)
    rec = f._ewald
    require(f._cell_kernel is None and rec is not None, "Forces did not take the dense-PME path")
    b32 = torch.as_tensor(box_np[0], dtype=torch.float32, device=DEVICE)
    p32 = apply_vsites(f.vsites, raw.double(), b32.double()).float()
    kmesh, order, q32 = rec.cfg.kmax, rec.ORDER, rec.charges
    mesh_p = kp.spread_reference(p32.double(), q32.double(), b32.double(), kmesh, order)
    stats = torch.zeros(len(kp.SPREAD_STATS), dtype=torch.int64, device=DEVICE)
    mesh_k = kp.pme_spread(p32, q32, b32, kmesh, order, stats=stats)
    torch.cuda.synchronize()
    err = float((mesh_k.double() - mesh_p).abs().max())
    require(err <= MESH_TOL * float(mesh_p.abs().max()), ("dense-PME spread", err))
    stats = dict(zip(kp.SPREAD_STATS, (int(v) for v in stats.tolist())))
    require(stats["charged_atoms"] == int((q32 != 0).sum()) and stats["brick_chunks"] == 0,
            ("dense-PME spread counters", stats))
    pot, frc = f.ef_one(raw, b32)
    require(bool(torch.isfinite(frc).all()) and all(bool(torch.isfinite(v)) for v in pot.values()),
            "dense-PME forces or energies not finite")
    nb_data = kn.prepare_nb_data(f.ffparams)
    log("dense_pme", natoms=par.natoms, box=f"{L:.3f}", mesh=kmesh, order=order,
        spread_max_abs_err=err, **stats,
        spread_ms=f"{cuda_events_ms(lambda: kp.pme_spread(p32, q32, b32, kmesh, order)):.4f}",
        pair_ms=f"{cuda_events_ms(lambda: kn.nonbonded_energy_forces(nb_data, f.config, p32, b32)):.4f}",
        ef_one_ms=f"{cuda_events_ms(lambda: f.ef_one(raw, b32)):.4f}")


def _thrombin_forces(device, precision="single", kernel="auto"):
    from torchmd_tpu_torch.forces import Forces

    mol, par = load_amber(*MAIN_SYSTEM)
    forces = Forces(par, terms=TERMS, precision=precision, cutoff=CUTOFF,
                    rfa=RFA, device=device, kernel=kernel)
    return mol, par, forces


def phase_parity():
    """bench.py:41-74 in the port: kernels against autograd at f32."""
    import torch

    from torchmd_tpu_torch.potentials import energy_and_forces

    mol, _, forces = _thrombin_forces(DEVICE)
    pos = torch.as_tensor(mol.coords[:, :, 0], dtype=torch.float32,
                          device=DEVICE)
    pot_ad, f_ad = energy_and_forces(forces.ffparams, pos, None, forces.config)
    pot_k, f_k = forces.ef_one(pos, None)
    e_ad = float(sum(pot_ad.values()))
    e_k = float(sum(pot_k.values()))
    e_err = abs(e_ad - e_k) / max(1.0, abs(e_ad))
    g_err = float((f_ad - f_k).abs().max()) / float(f_ad.abs().max())
    log("parity", epot_autograd=e_ad, epot_kernels=e_k, e_rel_err=e_err,
        g_rel_err=g_err)
    require(e_err < 1e-5, f"kernel energy parity {e_err}")
    require(g_err < 1e-3, f"kernel force parity {g_err}")


def phase_dynamics():
    import torch

    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.systems import System

    mol, par, forces = _thrombin_forces(DEVICE)
    system = System(mol.numAtoms, 1, "single")
    system.set_positions(mol.coords)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    vel0 = maxwell_boltzmann(par.masses, TEMP, 1, generator=gen,
                             dtype=torch.float32)
    system.set_velocities(vel0)
    integ = Integrator(system, forces, TIMESTEP, gamma=GAMMA, T=TEMP,
                       generator=torch.Generator(device=DEVICE).manual_seed(2))
    integ.step(niter=WARMUP_STEPS)

    torch.cuda.synchronize()
    kn.LAUNCHES = kb.LAUNCHES = 0
    t0 = time.perf_counter()
    Ekin, Epot, T = integ.step(niter=TIMED_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}
    steps_per_s = TIMED_STEPS / dt
    log("dynamics", steps=TIMED_STEPS, seconds=f"{dt:.4f}",
        steps_per_s=f"{steps_per_s:.2f}",
        ns_per_day=f"{steps_per_s * TIMESTEP * 1e-6 * 86400:.3f}",
        T=f"{T[0]:.3f}", Epot=f"{Epot[0]:.4f}", Ekin=f"{Ekin[0]:.4f}",
        pair_launches=launches["pair"], bonded_launches=launches["bonded"])
    for k, n in launches.items():
        require(n >= TIMED_STEPS, f"{k} kernel launched {n} < {TIMED_STEPS} times")
    require(np.all(np.isfinite(system.pos)), "non-finite positions")
    require(np.isfinite(Epot).all() and np.isfinite(T).all(), (Epot, T))
    profile_water_step(integ, 1.0 / steps_per_s, steps=200, label="thrombin_profile",
                       shares=("pair_", "bonded"))

    # NVE from one state: kernel path (f32) against the dense torch-op
    # path (f64), 10 steps
    start_pos, start_vel = system.pos.copy(), system.vel.copy()
    final = {}
    for label, precision, kernel in (("kernels", "single", "auto"),
                                     ("dense", "double", "dense")):
        _, _, f = _thrombin_forces(DEVICE, precision, kernel)
        s = System(mol.numAtoms, 1, precision)
        s.set_positions(start_pos[0])
        s.set_velocities(start_vel)
        Integrator(s, f, TIMESTEP).step(niter=10)
        final[label] = s.pos.astype(np.float64)
        del f
    dev = float(np.abs(final["kernels"] - final["dense"]).max())
    log("nve", steps=10, max_pos_dev_A=dev)
    require(dev <= 1e-3, f"NVE kernel vs dense positions differ by {dev} A")
    return launches


def _water_integrator(par, mol_pos, vel, L, precision="single", plain=False,
                      gather=None, thermostat=True):
    from torchmd_tpu_torch.integrator import Integrator
    from torchmd_tpu_torch.systems import System

    forces = _water_forces(par, WATER_CUTOFF, precision, plain, gather)
    system = System(par.natoms, 1, precision)
    system.set_positions(mol_pos)
    system.set_box(np.full(3, L))
    system.set_velocities(vel)
    forces.compute(system.pos, system.box, system.forces)  # the first half-kick's
    kw = dict(T=TEMP, thermostat="nhc", tau=WATER_TAU) if thermostat else {}
    integ = Integrator(system, forces, TIMESTEP, constraints="settle", **kw)
    return system, forces, integ


def phase_waterbox():
    """The water box's NVT phase at full size through the entry points."""
    import torch

    from torchmd_tpu_torch.constraints import max_settle_error
    from torchmd_tpu_torch.integrator import maxwell_boltzmann
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import pme as kp
    from torchmd_tpu_torch.vsites import apply_vsites

    t0 = time.perf_counter()
    mol, par, L = build_water(WATER_N, WATER_SPACING, True)
    vel = maxwell_boltzmann(par.masses, TEMP, 1, seed=3, device=DEVICE,
                            dtype=torch.float32)
    system, forces, integ = _water_integrator(par, mol.coords, vel, L)
    log("waterbox_setup", natoms=par.natoms, box=L, seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    integ.step(niter=WATER_WARMUP)
    torch.cuda.synchronize()
    kern, rec = forces._cell_kernel, forces._ewald
    log("waterbox_warmup", steps=WATER_WARMUP, seconds=f"{time.perf_counter() - t0:.2f}",
        ncells=kern.clcfg.ncells, capacity=kern.clcfg.capacity, mesh=rec.cfg.kmax,
        order=rec.ORDER, alpha=rec.cfg.alpha, gather=rec.gather)

    ek, ep, _ = integ.step(niter=1)
    h0 = float(ek[0] + ep[0] + integ.thermostat_energy()[0])
    # the state S the timed run starts from; the NVE check restarts from it
    s_pos, s_vel = system.pos[0].copy(), system.vel.copy()
    torch.cuda.synchronize()
    kc.LAUNCHES = kp.SPREAD_LAUNCHES = kp.GATHER_LAUNCHES = kb.LAUNCHES = 0
    retries0 = integ.overflow_retries
    t0 = time.perf_counter()
    done = 0
    while done < WATER_STEPS:
        Ekin, Epot, T = integ.step(niter=WATER_CHUNK)
        done += WATER_CHUNK
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"cell": kc.LAUNCHES, "pme_spread": kp.SPREAD_LAUNCHES,
                "pme_gather": kp.GATHER_LAUNCHES, "bonded": kb.LAUNCHES}
    h1 = float(Ekin[0] + Epot[0] + integ.thermostat_energy()[0])
    sps = done / dt

    pos = torch.as_tensor(system.pos[0], dtype=torch.float64, device=DEVICE)
    box = torch.full((3,), L, dtype=torch.float64, device=DEVICE)
    settle_err = float(max_settle_error(integ.constraints.settle, pos))
    sites = forces.vsites[0].sites
    snapped = apply_vsites(forces.vsites, pos, box)
    site_err = float((pos[sites] - snapped[sites]).abs().max())
    log("waterbox", steps=done, seconds=f"{dt:.4f}", steps_per_s=f"{sps:.2f}",
        ns_per_day=f"{sps * TIMESTEP * 1e-6 * 86400:.3f}", T=f"{T[0]:.3f}",
        Epot=f"{Epot[0]:.4f}", Ekin=f"{Ekin[0]:.4f}", H0=h0, H1=h1, dH=h1 - h0,
        settle_max_err_A=settle_err, site_max_err_A=site_err,
        overflow_retries=integ.overflow_retries - retries0,
        **{f"{k}_launches": v for k, v in launches.items()})
    for k in ("cell", "pme_spread", "pme_gather"):
        require(launches[k] >= done, f"{k} kernel launched {launches[k]} < {done} times")
    require(launches["bonded"] == 0, "the water box's bonded plan should have no rows")
    require(np.all(np.isfinite(system.pos)) and np.all(np.isfinite(system.vel)),
            "non-finite water-box state")
    require(np.isfinite([T[0], Epot[0], h0, h1]).all(), (T, Epot, h0, h1))
    require(settle_err < 1e-3, f"SETTLE error {settle_err} A")
    require(site_err < 1e-4, f"virtual sites off by {site_err} A")

    profile_water_step(integ, 1.0 / sps)
    par64 = build_water(WATER_N, WATER_SPACING, True, "double")[1]
    water_nve_check(par, par64, s_pos, s_vel, L)
    water_trajectory_check(par, par64, system.pos[0].copy(), system.vel.copy(), L)
    return launches, sps


def water_nve_check(par, par64, s_pos, s_vel, L):
    """NVE_STEPS NVE steps from state S on the kernel path (f32) and the
    plain path (f64): the total energies change alike."""
    import torch

    m = np.asarray(par64.masses, np.float64).reshape(1, -1, 1)
    ek_s = float(0.5 * (m * s_vel.astype(np.float64) ** 2).sum())
    dh = {}
    for label, p, precision, plain in (("kernels", par, "single", False),
                                       ("plain64", par64, "double", True)):
        _, f, it = _water_integrator(p, s_pos, s_vel, L, precision, plain,
                                     thermostat=False)
        h_s = ek_s + f.compute(s_pos[None], np.full((1, 3), L))[0]
        ek, ep, _ = it.step(niter=NVE_STEPS)
        dh[label] = float(ek[0] + ep[0]) - h_s
        del f, it
        torch.cuda.empty_cache()
    gap = abs(dh["kernels"] - dh["plain64"])
    log("waterbox_nve", steps=NVE_STEPS, kernels_dH=dh["kernels"],
        plain64_dH=dh["plain64"], gap=gap)
    require(np.isfinite(gap) and gap <= NVE_DH_TOL,
            f"NVE energy change: kernels {dh['kernels']}, plain f64 {dh['plain64']}")


def water_trajectory_check(par, par64, start_pos, start_vel, L):
    """10 NVT steps from one state: the kernel path against the plain path
    at f32 and f64, beside the rounding floor (the kernel path from a start
    moved by one ulp per coordinate, in the box frame and shifted by two
    box edges) and fault controls (every charge scaled by 1 + q)."""
    import copy

    import torch

    one_ulp = np.random.RandomState(4).rand(*start_pos.shape) < 0.5
    p32 = start_pos.astype(np.float32)

    def moved(p):
        return np.where(one_ulp, np.nextafter(p, np.float32(np.inf)),
                        np.nextafter(p, np.float32(-np.inf)))

    def scaled(q):
        wrong = copy.copy(par)
        wrong.charges = par.charges * (1.0 + q)
        return wrong

    shifted = (start_pos.astype(np.float64) + 2 * L).astype(np.float32)
    runs = {"kernels": (par, p32, "single", False),
            "kernels_ulp": (par, moved(p32), "single", False),
            "shift": (par, shifted, "single", False),
            "shift_ulp": (par, moved(shifted), "single", False),
            "plain32": (par, p32, "single", True),
            "plain64": (par64, p32, "double", True),
            **{f"charges_x(1+{q:g})": (scaled(q), p32, "single", False)
               for q in WATER_CONTROL_Q}}
    traj = {}
    for label, (p, pos0, precision, plain) in runs.items():
        s, f, it = _water_integrator(p, pos0, start_vel, L, precision, plain, "ik")
        traj[label] = {}
        for k in range(1, WATER_WITNESS_STEPS[-1] + 1):
            it.step(niter=1)
            if k in WATER_WITNESS_STEPS:
                traj[label][k] = s.pos[0].astype(np.float64)
        del f, it
        torch.cuda.empty_cache()

    def dev(a, b, k):
        return float(np.abs(traj[a][k] - traj[b][k]).max())

    pairs = {"kernels_vs_plain32": ("kernels", "plain32"),
             "kernels_vs_plain64": ("kernels", "plain64"),
             "plain32_vs_plain64": ("plain32", "plain64"),
             "floor_ulp": ("kernels", "kernels_ulp"),
             "floor_ulp_shift2L": ("shift", "shift_ulp"),
             **{f"control_q{q:g}": ("kernels", f"charges_x(1+{q:g})")
                for q in WATER_CONTROL_Q}}
    for k in WATER_WITNESS_STEPS:
        d = np.abs(traj["kernels"][k] - traj["plain64"][k])
        atom, axis = np.unravel_index(int(d.argmax()), d.shape)
        log("waterbox_vs_plain", step=k,
            **{name: dev(a, b, k) for name, (a, b) in pairs.items()},
            worst_atom=int(atom), worst_site=("O", "H1", "H2", "M")[atom % 4],
            worst_coord_A=float(traj["kernels"][k][atom, axis]))
    k = WATER_WITNESS_STEPS[-1]
    limit = WATER_FLOOR_FACTOR * dev("kernels", "kernels_ulp", k)
    d32, d64 = dev("kernels", "plain32", k), dev("kernels", "plain64", k)
    q = WATER_CONTROL_Q[-1]
    d_ctl = dev("kernels", f"charges_x(1+{q:g})", k)
    log("waterbox_vs_plain_limit", step=k, limit_A=limit, kernels_vs_plain32=d32,
        kernels_vs_plain64=d64, control=d_ctl)
    require(np.isfinite(d64) and d32 <= limit and d64 <= limit,
            f"water box kernel path vs plain: {d32} A (f32), {d64} A (f64), "
            f"limit {limit} A")
    require(d_ctl > limit, f"the charge-scale control moved only {d_ctl} A")


def profile_water_step(integ, step_s, steps=20, top=14, label="water_profile",
                       shares=()):
    """torch.profiler over `steps` steps of `integ`: device time per step
    by kernel, the device's busy share against the unprofiled step time
    `step_s` of the timed run, and the share of the step's device time of
    the kernels whose names hold each of `shares`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    integ.step(niter=steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        integ.step(niter=steps)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    kernels = [e for e in prof.key_averages()
               if dev_us(e) > 0 and e.cpu_time_total == 0]
    total_us = sum(dev_us(e) for e in kernels) / steps
    launches = sum(e.count for e in kernels) / steps
    log(label, steps=steps, device_ms_per_step=f"{total_us / 1e3:.4f}",
        device_events_per_step=f"{launches:.1f}",
        unprofiled_step_ms=f"{step_s * 1e3:.4f}",
        device_busy_share=f"{total_us / 1e6 / step_s:.3f}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:top]:
        log(f"{label}_kernel", us_per_step=f"{dev_us(e) / steps:.2f}",
            calls_per_step=f"{e.count / steps:.1f}", name=repr(e.key[:90]))
    for part in shares:
        us = sum(dev_us(e) for e in kernels if part in e.key) / steps
        log(f"{label}_share", kernels=part, us_per_step=f"{us:.2f}",
            share_of_device_time=f"{us / max(total_us, 1e-9):.3f}")

def build_gas(precision="single"):
    """(par, positions, box edge) of the charged LJ gas of
    tests/test_columns.py (argon-like atoms on a jittered grid, seed 0)."""
    from torchmd_tpu_torch.forcefields import ForceField
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.parameters import Parameters

    with tempfile.TemporaryDirectory() as td:
        top = os.path.join(td, "gas.top")
        with open(top, "w") as fh:
            fh.write(GAS_TOP.format(n=GAS_N))
        mol = Molecule(top)
        ff = ForceField.create(mol, top)
    rs = np.random.RandomState(0)
    charges = rs.randn(GAS_N) * 0.05
    m = int(np.ceil(GAS_N ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)[:GAS_N]
    coords = (grid + 0.5) * (GAS_L / m) + rs.randn(GAS_N, 3) * 0.3
    par = Parameters(ff, mol, ["lj", "electrostatics"], precision=precision)
    par.charges = charges
    return par, coords, GAS_L


def _compare_virial(tag, vir_k, vir_p):
    """Kernel virial against the plain one: |dW_a| <= E_TOL max(1, |W_a|)."""
    vk, vp = vir_k.double().cpu(), vir_p.double().cpu()
    err = (vk - vp).abs()
    require(bool((err <= E_TOL * vp.abs().clamp(min=1.0)).all()), (tag, vk.tolist(), vp.tolist()))
    return float(err.max())


def phase_column_kernels():
    """The column kernel (with its virial) and the cell kernel's virial
    variant, f32, against their plain f64 versions on the full water box,
    the 216-water box and the LJ gas; their times at the full box."""
    import torch

    from torchmd_tpu_torch import columns as tcol
    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import column as kcol
    from torchmd_tpu_torch.vsites import apply_vsites

    errs = {"column": 0.0, "cell_virial": 0.0}
    out = {}
    cases = (("water216",) + SMALL_WATER + (False,),
             ("water-full", WATER_N, WATER_SPACING, WATER_CUTOFF, True),
             ("lj-gas", None, None, GAS_CUTOFF, None))
    for name, n, spacing, cutoff, jitter in cases:
        if name == "lj-gas":
            par, raw_np, L = build_gas()
            mk = dict(terms=["lj", "electrostatics"], cutoff=cutoff, rfa=True)
        else:
            mol, par, L = build_water(n, spacing, jitter)
            raw_np = mol.coords[:, :, 0]
            mk = dict(terms=WATER_TERMS, cutoff=cutoff,
                      elec="ewald" if par.natoms >= 4096 else "pme")
        box_np = np.full((1, 3), L)
        b32 = torch.as_tensor(box_np[0], dtype=torch.float32, device=DEVICE)
        b64 = b32.double()
        raw = torch.as_tensor(raw_np, dtype=torch.float64, device=DEVICE)
        kerns = {}
        for column in (True, False):
            f = Forces(par, precision="single", kernel="cell", device=DEVICE,
                       column=column, **mk)
            f.prepare(raw.float()[None], box_np)
            kerns[column] = f
        fcol, fcell = kerns[True], kerns[False]
        require(isinstance(fcol._cell_kernel, tcol.ColumnKernel), "no column kernel")
        p32 = (apply_vsites(fcol.vsites, raw, b64) if fcol.vsites else raw).float()
        p64 = p32.double()
        cfg = fcol._cell_kernel.cfg
        # the column kernel on its own state; the plain f64 version on the same
        ck = fcol._cell_kernel
        st = ck.build(p32, b32)
        require(not bool(st.overflow), f"{name}: column structure overflow")
        st64 = st._replace(jzshift=st.jzshift.double(), ref_pos=st.ref_pos.double())
        d64 = kc.CellData(**{k: (v.double() if torch.is_tensor(v) and v.is_floating_point()
                                 else v) for k, v in ck.data._asdict().items()})
        pot_k, f_k, vir_k = kcol.column_energy_forces(ck.data, cfg, ck.ccfg, st, p32, b32,
                                                      with_virial=True)
        pot_p, f_p, vir_p = kcol.column_reference(d64, cfg, ck.ccfg, st64, p64, b64,
                                                  with_virial=True)
        torch.cuda.synchronize()
        e_col = _compare(f"{name}/column", pot_k, f_k, pot_p, f_p)
        v_col = _compare_virial(f"{name}/column", vir_k, vir_p)
        # the cell kernel's virial variant
        kk = fcell._cell_kernel
        cl = kk.build(p32, b32)
        cl64 = cl._replace(ref_pos=cl.ref_pos.double())
        pot_k, f_k, cvir_k = kc.cell_energy_forces(kk.data, cfg, kk.clcfg, cl, p32, b32,
                                                   with_virial=True)
        pot_p, f_p, cvir_p = kc.cell_reference(d64, cfg, kk.clcfg, cl64, p64, b64,
                                               with_virial=True)
        torch.cuda.synchronize()
        e_cell = _compare(f"{name}/cell_virial", pot_k, f_k, pot_p, f_p)
        v_cell = _compare_virial(f"{name}/cell_virial", cvir_k, cvir_p)
        require(bool((vir_p - cvir_p).abs().max() <= 1e-9 * cvir_p.abs().max()),
                (name, "column and cell virials differ at f64", vir_p.tolist(), cvir_p.tolist()))
        errs["column"] = max(errs["column"], e_col)
        errs["cell_virial"] = max(errs["cell_virial"], e_cell)
        log("column_kernels", case=name, natoms=par.natoms, ncols=ck.ccfg.ncols,
            C=ck.ccfg.C, CE=ck.ccfg.CE, W=ck.ccfg.W, NB=ck.ccfg.NB,
            column_max_abs_err=e_col, column_virial_max_abs_err=v_col,
            cell_virial_max_abs_err=e_cell, cell_virial_virial_max_abs_err=v_cell,
            virial=[round(float(v), 4) for v in vir_p])
        if name != "water-full":
            continue

        data = ck.data
        npairs = _water_pair_count(data, p32, b32, cutoff)
        windows = kcol.window_slot_pairs(ck.ccfg, st)
        walk_col = tile_walk("column", lambda stats: kcol.column_energy_forces(
            data, cfg, ck.ccfg, st, p32, b32, with_virial=True, stats=stats))
        walk_cell = tile_walk("cell_virial", lambda stats: kc.cell_energy_forces(
            kk.data, cfg, kk.clcfg, cl, p32, b32, with_virial=True, stats=stats))
        c3 = cl.counts.double().reshape(kk.clcfg.ncells)
        cell_visited = int(sum((c3 * torch.roll(c3, shifts=o, dims=(0, 1, 2))).sum()
                               for o in kc.STENCIL))
        flops = npairs * (PAIR_FLOPS["ewald"] + NEWTON_J_FLOPS + VIRIAL_FLOPS)
        out["column"] = dict(
            ms=cuda_events_ms(lambda: kcol.column_energy_forces(
                data, cfg, ck.ccfg, st, p32, b32, with_virial=True)),
            plain_ms=cuda_events_ms(lambda: kcol.column_reference(
                data, cfg, ck.ccfg, st, p32, b32, with_virial=True), calls=5, warmup=1),
            bound=bound(tensor_bytes(p32, data.q, data.sig, data.eps, data.excl, st.islot,
                                     st.jslot, st.jzshift, st.wstart, p32), flops),
            work=(f"pairs_in_cutoff={npairs} window_slot_pairs={windows} "
                  f"visited_slot_pairs={walk_col['slot_pairs']} "
                  f"tile_pairs={walk_col['tile_pairs']} "
                  f"active_lane_share={walk_col['active_lane_share']:.4f}"))
        out["cell_virial"] = dict(
            ms=cuda_events_ms(lambda: kc.cell_energy_forces(
                kk.data, cfg, kk.clcfg, cl, p32, b32, with_virial=True)),
            plain_ms=cuda_events_ms(lambda: kc.cell_reference(
                kk.data, cfg, kk.clcfg, cl, p32, b32, with_virial=True), calls=5, warmup=1),
            bound=bound(tensor_bytes(p32, data.q, data.sig, data.eps, cl.slots, cl.counts,
                                     data.excl, p32), flops),
            work=(f"pairs_in_cutoff={npairs} cell_slot_pairs={cell_visited} "
                  f"visited_slot_pairs={walk_cell['slot_pairs']} "
                  f"tile_pairs={walk_cell['tile_pairs']} "
                  f"active_lane_share={walk_cell['active_lane_share']:.4f}"))
        out["cell_same_state"] = dict(ms=cuda_events_ms(lambda: kc.cell_energy_forces(
            kk.data, cfg, kk.clcfg, cl, p32, b32)))
        log("column_vs_cell", state="water-full", column_ms=f"{out['column']['ms']:.4f}",
            cell_virial_ms=f"{out['cell_virial']['ms']:.4f}",
            cell_ms=f"{out['cell_same_state']['ms']:.4f}",
            column_visited=walk_col["slot_pairs"], cell_visited=walk_cell["slot_pairs"],
            pairs_in_cutoff=npairs)
        log_earlier("column", out["column"]["ms"])
        log_earlier("cell_virial", out["cell_virial"]["ms"])
    for k in ("column", "cell_virial"):
        v = out[k]
        v["max_abs_err"] = errs[k]
        log("timing", kernel=k, shapes="water-full", ms=f"{v['ms']:.4f}",
            plain_ms=f"{v['plain_ms']:.4f}", speedup=f"{v['plain_ms'] / v['ms']:.2f}",
            bound_ms=f"{v['bound'][0]:.5f}", bound_by=v["bound"][1], work=v["work"])
    return out


def _npt_integrator(par, pos, vel, box, precision="single", plain=False, column=None,
                    state=None):
    """A full-box NPT integrator (bench_waterbox.py's second phase) from
    positions, velocities and a box; `state` = (particle chain state,
    (v_eps, barostat chain state)) carries an extended state over."""
    from torchmd_tpu_torch.barostat import MTKBarostat
    from torchmd_tpu_torch.integrator import Integrator
    from torchmd_tpu_torch.systems import System

    forces = _water_forces(par, WATER_CUTOFF, precision, plain, column=column)
    system = System(par.natoms, 1, precision)
    system.set_positions(pos)
    system.set_box(np.asarray(box, np.float64))
    system.set_velocities(vel)
    forces.compute(system.pos, system.box, system.forces)
    integ = Integrator(system, forces, TIMESTEP, constraints="settle", seed=3,
                       thermostat="nhc", T=TEMP,
                       barostat=MTKBarostat(NPT_PRESSURE, TEMP, tau_fs=NPT_TAU_P))
    if state is not None:
        dt = integ.dtype
        aux_p, (v_eps, aux_b) = state
        integ._thermo_aux = {k: v.to(DEVICE, dt) for k, v in aux_p.items()}
        integ.npt_state = (v_eps.to(DEVICE, dt),
                           {k: v.to(DEVICE, dt) for k, v in aux_b.items()})
    return system, forces, integ


def _extended_energy(ek, ep, integ):
    return float(ek[0] + ep[0] + integ.thermostat_energy()[0] + integ.npt_energy()[0])


def phase_npt():
    """The water box's NPT phase at full size through the entry points,
    on the defaults of Forces (the column kernel on the card)."""
    import torch

    from torchmd_tpu_torch import columns as tcol
    from torchmd_tpu_torch.constraints import max_settle_error
    from torchmd_tpu_torch.integrator import maxwell_boltzmann
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import column as kcol
    from torchmd_tpu_torch.ops import pme as kp
    from torchmd_tpu_torch.vsites import apply_vsites

    t0 = time.perf_counter()
    mol, par, L = build_water(WATER_N, WATER_SPACING, True)
    vel = maxwell_boltzmann(par.masses, TEMP, 1, seed=3, device=DEVICE,
                            dtype=torch.float32)
    system, forces, integ = _npt_integrator(par, mol.coords, vel, np.full(3, L))
    log("npt_setup", natoms=par.natoms, box=L, seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    integ.step(niter=NPT_WARMUP)
    torch.cuda.synchronize()
    kern, rec = forces._cell_kernel, forces._ewald
    require(isinstance(kern, tcol.ColumnKernel), f"NPT runs on {type(kern).__name__}")
    log("npt_warmup", steps=NPT_WARMUP, seconds=f"{time.perf_counter() - t0:.2f}",
        kernel=type(kern).__name__, ncols=kern.ccfg.ncols, C=kern.ccfg.C,
        CE=kern.ccfg.CE, W=kern.ccfg.W, mesh=rec.cfg.kmax, order=rec.ORDER,
        gather=integ._npt_gather(), box=system.box_diag[0].tolist())

    ek, ep, _ = integ.step(niter=1)
    h0 = _extended_energy(ek, ep, integ)
    # the state S the timed run starts from; the trajectory check restarts from it
    s_pos, s_vel, s_box = system.pos[0].copy(), system.vel.copy(), system.box_diag[0].copy()
    v_eps, aux_b, _ = integ.npt_state
    s_ext = ({k: v.clone() for k, v in integ._thermo_aux.items()},
             (v_eps.clone(), {k: v.clone() for k, v in aux_b.items()}))
    torch.cuda.synchronize()
    kc.LAUNCHES = kcol.LAUNCHES = kp.SPREAD_LAUNCHES = kp.GATHER_LAUNCHES = kb.LAUNCHES = 0
    retries0 = integ.overflow_retries
    t0 = time.perf_counter()
    done = 0
    while done < NPT_STEPS:
        Ekin, Epot, T = integ.step(niter=NPT_CHUNK)
        done += NPT_CHUNK
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"column": kcol.LAUNCHES, "cell": kc.LAUNCHES,
                "pme_spread": kp.SPREAD_LAUNCHES, "pme_gather": kp.GATHER_LAUNCHES,
                "bonded": kb.LAUNCHES}
    h1 = _extended_energy(Ekin, Epot, integ)
    sps = done / dt

    box_now = system.box_diag[0].astype(np.float64)
    V0, V = L ** 3, float(np.prod(box_now))
    mass = float(np.sum(par.masses))
    density = mass * 1.66053906660 / V      # g/cm^3 from amu / A^3
    pos = torch.as_tensor(system.pos[0], dtype=torch.float64, device=DEVICE)
    box = torch.as_tensor(box_now, dtype=torch.float64, device=DEVICE)
    settle_err = float(max_settle_error(integ.constraints.settle, pos))
    sites = forces.vsites[0].sites
    snapped = apply_vsites(forces.vsites, pos, box)
    site_err = float((pos[sites] - snapped[sites]).abs().max())
    log("npt", steps=done, seconds=f"{dt:.4f}", steps_per_s=f"{sps:.2f}",
        ns_per_day=f"{sps * TIMESTEP * 1e-6 * 86400:.3f}", T=f"{T[0]:.3f}",
        Epot=f"{Epot[0]:.4f}", Ekin=f"{Ekin[0]:.4f}", volume_A3=V,
        volume_ratio=V / V0, density_g_cm3=density, box=box_now.tolist(),
        H0=h0, H1=h1, dH=h1 - h0, settle_max_err_A=settle_err, site_max_err_A=site_err,
        overflow_retries=integ.overflow_retries - retries0,
        launches_per_step=f"{sum(launches.values()) / done:.2f}",
        **{f"{k}_launches": v for k, v in launches.items()})
    require(launches["column"] >= done,
            f"column kernel launched {launches['column']} < {done} times")
    require(launches["pme_spread"] >= done,
            f"spread kernel launched {launches['pme_spread']} < {done} times")
    require(launches["cell"] == 0, "the NPT path launched the cell kernel")
    require(np.all(np.isfinite(system.pos)) and np.all(np.isfinite(system.vel))
            and np.all(np.isfinite(box_now)), "non-finite NPT state")
    require(np.isfinite([T[0], Epot[0], h0, h1]).all(), (T, Epot, h0, h1))
    require(settle_err < 1e-3, f"SETTLE error {settle_err} A")
    require(site_err < 1e-4, f"virtual sites off by {site_err} A")
    require(NPT_VOLUME_RANGE[0] <= V / V0 <= NPT_VOLUME_RANGE[1],
            f"volume ratio {V / V0}")

    profile_water_step(integ, 1.0 / sps, label="npt_profile")
    par64 = build_water(WATER_N, WATER_SPACING, True, "double")[1]
    npt_trajectory_check(par, par64, s_pos, s_vel, s_box, s_ext)
    return launches, sps


def npt_trajectory_check(par, par64, start_pos, start_vel, start_box, ext, steps=10):
    """`steps` NPT steps from state S: the kernel path (f32) against the
    plain path (f64), positions and box, beside the floor (the kernel path
    from a start moved by one f32 ulp per coordinate) and a fault control
    (every charge scaled by 1 + 1e-2)."""
    import copy

    import torch

    one_ulp = np.random.RandomState(4).rand(*start_pos.shape) < 0.5
    p32 = start_pos.astype(np.float32)
    moved = np.where(one_ulp, np.nextafter(p32, np.float32(np.inf)),
                     np.nextafter(p32, np.float32(-np.inf)))
    q = WATER_CONTROL_Q[-1]
    wrong = copy.copy(par)
    wrong.charges = par.charges * (1.0 + q)
    runs = {"kernels": (par, p32, "single", False),
            "kernels_ulp": (par, moved, "single", False),
            "plain32": (par, p32, "single", True),
            "plain64": (par64, p32, "double", True),
            f"charges_x(1+{q:g})": (wrong, p32, "single", False)}
    final = {}
    for label, (p, pos0, precision, plain) in runs.items():
        s, f, it = _npt_integrator(p, pos0, start_vel, start_box, precision, plain,
                                   column=True, state=ext)
        it.step(niter=steps)
        final[label] = (s.pos[0].astype(np.float64), s.box_diag[0].astype(np.float64))
        del f, it
        torch.cuda.empty_cache()

    def dev(a, b):
        return (float(np.abs(final[a][0] - final[b][0]).max()),
                float(np.abs(final[a][1] / final[b][1] - 1.0).max()))

    floor_pos, floor_box = dev("kernels", "kernels_ulp")
    lim_pos = WATER_FLOOR_FACTOR * floor_pos
    # the box floor is at least one f32 rounding of the box
    lim_box = WATER_FLOOR_FACTOR * max(floor_box, float(np.finfo(np.float32).eps))
    d_pos, d_box = dev("kernels", "plain64")
    d32_pos, d32_box = dev("kernels", "plain32")
    p_pos, p_box = dev("plain32", "plain64")
    c_pos, c_box = dev("kernels", f"charges_x(1+{q:g})")
    log("npt_vs_plain", steps=steps, kernels_vs_plain64_pos_A=d_pos,
        kernels_vs_plain64_box_rel=d_box, kernels_vs_plain32_pos_A=d32_pos,
        kernels_vs_plain32_box_rel=d32_box, plain32_vs_plain64_pos_A=p_pos,
        plain32_vs_plain64_box_rel=p_box, floor_pos_A=floor_pos, floor_box_rel=floor_box,
        limit_pos_A=lim_pos, limit_box_rel=lim_box, control_pos_A=c_pos,
        control_box_rel=c_box)
    for tag, dp, db in (("f64", d_pos, d_box), ("f32", d32_pos, d32_box)):
        require(np.isfinite(dp) and dp <= lim_pos and db <= lim_box,
                f"NPT kernel path vs plain {tag}: {dp} A, box {db} (limits {lim_pos}, "
                f"{lim_box})")
    require(c_pos > lim_pos, f"the charge-scale control moved only {c_pos} A")


def _probe_ratios(got, want, scale):
    """One probe stage's kernel result against the plain f64 one: (energy
    error over its bar E_TOL max(1, |E|), the largest row's force error
    over its bar F_TOL max(1, force_scale), max abs force error)."""
    import torch

    from torchmd_tpu_torch.ops import roofline as rl

    ep = float(want[3])
    e_ratio = abs(float(got[3]) - ep) / (E_TOL * max(1.0, abs(ep)))
    f_ratio = rl.row_error(got[:3], want[:3], scale) / F_TOL
    err = float((torch.stack(got[:3]).double() - torch.stack(want[:3])).abs().max())
    return e_ratio, f_ratio, err


def phase_roofline():
    """The staged probe (scripts/bench_roofline.py's port): every stage
    kernel against its plain f64 version on the probe's inputs and on the
    same rows without pairs nearer than 2 A (forces held row by row), four
    planted faults that the checks must catch, the chain kernels against
    their plain versions at the probe's shape, then the probe's run
    through its entry point with the counters reset just before and read
    just after."""
    import torch

    from torchmd_tpu_torch import roofline as probe
    from torchmd_tpu_torch.ops import roofline as rl

    inp = rl.make_inputs(PROBE_N, PROBE_TILE, DEVICE)
    sets = {"probe": inp, "no_close_pairs": rl.without_close_pairs(inp)}
    errs, scales = {}, {}
    for tag, data in sets.items():
        d64 = rl.in_f64(data)
        scales[tag] = rl.force_scale(d64)
        ratios = {}
        for st in rl.STAGES:
            got, want = rl.stage_call(st, data), rl.stage_reference(st, d64)
            e_r, f_r, err = _probe_ratios(got, want, scales[tag])
            require(e_r <= 1.0 and f_r <= 1.0, (f"roofline/{tag}/{st}", e_r, f_r))
            ratios[st] = f"{e_r:.3g}/{f_r:.3g}"
            if tag == "probe":
                errs[st] = err
        log("roofline_check", inputs=tag, n=PROBE_N, tile=PROBE_TILE,
            pairs_masked_in=int((data.mask != 0).sum()) // 2,
            energy_over_bar_force_rows_over_bar=ratios)
    log("roofline_check", **{f"{st}_max_abs_err": e for st, e in errs.items()})
    # planted faults: the kernel against a plain version with one wrong
    # constant must fail the checks (they compare |kernel - plain|, so a
    # fault on either side shows alike)
    c = rl.CONSTANTS
    for tag, st, name, wrong in (("probe", "forces", "krf_x2", c._replace(krf=2 * c.krf)),
                                 ("probe", "forces", "switch_6.1", c._replace(switch=6.1)),
                                 ("no_close_pairs", "math", "krf_x2",
                                  c._replace(krf=2 * c.krf)),
                                 ("no_close_pairs", "g", "krf_x2", c._replace(krf=2 * c.krf))):
        got = rl.stage_call(st, sets[tag])
        want = rl.stage_reference(st, rl.in_f64(sets[tag]), wrong)
        e_r, f_r, _ = _probe_ratios(got, want, scales[tag])
        log("roofline_control", inputs=tag, stage=st, fault=name,
            energy_over_bar=f"{e_r:.3g}", force_rows_over_bar=f"{f_r:.3g}")
        require(max(e_r, f_r) > 1.0, f"planted fault {name} in {st} on {tag} passed")
    x = torch.full(probe.CHAIN_SHAPE, 0.4999, dtype=torch.float32, device=DEVICE)
    for op in rl.CHAIN_OPS:
        want = rl.chain_reference(op, x, probe.CHAIN_ITERS)
        got = rl.chain_call(op, x.clone(), probe.CHAIN_ITERS)
        err = float(((got - want).abs() / want.abs()).max())
        log("roofline_chain_check", op=op, shape=tuple(probe.CHAIN_SHAPE),
            steps=rl.UNROLL * probe.CHAIN_ITERS, max_rel_err=f"{err:.3g}")
        require(bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6)), ("chain", op, err))

    rl.LAUNCHES = rl.CHAIN_LAUNCHES = 0
    res = probe.run(PROBE_N, PROBE_TILE, echo=lambda line: print(f"[roofline] {line}",
                                                                  flush=True))
    launches = {"stages": rl.LAUNCHES, "chains": rl.CHAIN_LAUNCHES}
    log("roofline_launches", **launches)
    require(launches["stages"] >= len(rl.STAGES) and launches["chains"] >= len(rl.CHAIN_OPS),
            f"probe launches {launches}")
    require(res["mxred_vs_forces_row_err"] <= MXRED_TOL,
            f"mxred vs forces {res['mxred_vs_forces_row_err']} of a row's force scale")
    for st, (fx, fy, fz, e) in res["outputs"].items():
        require(bool(torch.isfinite(torch.stack([fx, fy, fz])).all())
                and bool(torch.isfinite(e)), f"probe stage {st} not finite")

    # the forces stage is the production kernel's work: its bound is that
    # of the dense pair function on these inputs (bytes of the rows and the
    # mask in, forces and energy out; operations of the pairs in the cutoff)
    pos = torch.stack([inp.x, inp.y, inp.z], 1)[:PROBE_N]
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    npairs = (int((d2 <= rl.CONSTANTS.cutoff ** 2).sum()) - PROBE_N) // 2
    out = dict(
        ms=res["ms"]["forces"],
        plain_ms=cuda_events_ms(lambda: rl.stage_reference("forces", inp), calls=5, warmup=1),
        bound=bound(tensor_bytes(*inp[:7]) + 4 * (3 * inp.x.numel() + 1),
                    pair_flops(npairs, "rfa")),
        max_abs_err=errs["forces"],
        work=f"pairs_in_cutoff={npairs} npad={inp.x.numel()}")
    log("timing", kernel="roofline_forces", shapes=f"probe n={PROBE_N} tile={PROBE_TILE}",
        ms=f"{out['ms']:.4f}", plain_ms=f"{out['plain_ms']:.4f}",
        speedup=f"{out['plain_ms'] / out['ms']:.2f}", bound_ms=f"{out['bound'][0]:.5f}",
        bound_by=out["bound"][1], work=out["work"])
    return out, launches["stages"]


def _kernel_entry(name, source, replaces, launches, t):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": None}


def main():
    phase_device()
    phase_build()
    times = phase_kernels()
    times.update(phase_water_kernels())
    phase_dense_pme()
    times.update(phase_column_kernels())
    phase_parity()
    thr_launches = phase_dynamics()
    water_launches, _ = phase_waterbox()
    npt_launches, _ = phase_npt()
    times["roofline"], probe_launches = phase_roofline()

    import torch

    src = "torchmd_tpu_torch/csrc/"
    kernels = [
        _kernel_entry("pair", src + "nonbonded.cu",
                      "torchmd_tpu/ops/pallas_nonbonded.py:545",
                      thr_launches["pair"], times["pair"]),
        # the full-square Pallas kernel: the one CUDA pair kernel computes
        # both (a thread a whole row)
        _kernel_entry("pair_full_square", src + "nonbonded.cu",
                      "torchmd_tpu/ops/pallas_nonbonded.py:620",
                      thr_launches["pair"], times["pair"]),
        _kernel_entry("bonded", src + "bonded.cu",
                      "torchmd_tpu/ops/pallas_bonded.py:575",
                      thr_launches["bonded"], times["bonded"]),
        _kernel_entry("cell", src + "cell.cu", "torchmd_tpu/ops/pallas_cell.py:238",
                      water_launches["cell"], times["cell"]),
        _kernel_entry("pme_spread", src + "pme.cu", "torchmd_tpu/ops/pallas_pme.py:235",
                      water_launches["pme_spread"], times["pme_spread"]),
        _kernel_entry("pme_gather", src + "pme.cu", "torchmd_tpu/ops/pallas_pme.py:168",
                      water_launches["pme_gather"], times["pme_gather"]),
        _kernel_entry("column", src + "column.cu", "torchmd_tpu/ops/pallas_column.py:266",
                      npt_launches["column"], times["column"]),
        _kernel_entry("roofline", src + "roofline.cu", "scripts/bench_roofline.py:213",
                      probe_launches, times["roofline"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
