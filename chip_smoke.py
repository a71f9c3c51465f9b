"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main paths through the entry points a user calls
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
  - thrombin through the CLI (`torchmd_tpu_torch.run.main`, the flags of
    `python -m torchmd_tpu_torch.run`, in-process): the dense pair and
    bonded kernels, with monitor rows, trajectory and checkpoints, and
    with an external torch potential (`--external`, an nn.Module);
  - thrombin's production protocol through the CLI: bench.py's 4 fs with
    the X-H bonds constrained (SHAKE/RATTLE), hydrogen masses x3 and CSVR
    at 300 K, on the dense pair and bonded kernels, and with its C-alpha
    atoms restrained;
  - the water box's NVT phase with a Monte Carlo barostat (1 bar, an
    attempt every 25 steps): the cell, spread and gather kernels under
    volume moves;
  - thrombin's production protocol with r-RESPA (`--mts 2`): the bonded
    kernel twice an outer step in its own buffer, the dense pair kernel
    once;
  - scripts/bench_mts.py's box in the port (8,000 flexible SPC/Fw
    waters, 24,000 atoms, cutoff 8.5 A, reaction field, NVE on the
    defaults of Forces: the column kernel's no-virial reaction-field
    instance): mts 1 at 0.5 fs, mts 4 at 2 fs, plain VV at 2 fs, and the
    drift at other outer and inner steps;
  - the water box's NVT phase with the reciprocal tier (`mts_recip=2`):
    the cell kernel every step, the PME spread and gather every other;
  - the solvated alanine dipeptide of the repo's ACEMD input under MTK
    with SHAKE through the CLI: the dense MTK scan on the exact Ewald sum
    (torch ops, no CUDA kernel);
  - thrombin on Verlet lists (`Forces(kernel="verlet")`, torch ops);
  - the automatic Verlet choice (`forces.VERLET_AUTO_N`): the alanine
    box tiled 5 x 5 x 6 (103,200 atoms) with its box dropped, through
    Forces(kernel="auto"): Verlet lists built by cells (torch ops) and
    the bonded kernel, hbonds and Langevin at 2 fs;
  - thrombin in GB/OBC implicit solvent (`--gbsa` through the CLI; GB is
    torch ops, as the JAX package has no kernel for it); an 8-replica
    temperature ladder in GB (`ReplicaExchange`), whose every evaluation
    launches the pair and bonded kernels once for all replicas (their
    replica axis); well-tempered metadynamics on the ligand-pocket
    distance in GB; the ligand decoupled (`make_alchemical`) and as a
    lambda-dynamics site;
  - the AMOEBA polarizable force field (make_amoeba_potential with
    valence, multipole PME and Ewald-split mutual polarization, torch ops
    and CUDA graphs, no CUDA kernel) on 216 water03 waters in an 18.643 A
    box, Langevin at 0.5 fs through Forces(terms=[], external=pot);
  - thrombin with Drude oscillators (make_drude, scf_drude,
    DrudeIntegrator: dual Langevin at 1 fs): the dense pair and bonded
    kernels on the extended topology; the SWM4-NDP polarizable water box
    (CHARMM Drude-2013 ingestion, lone pairs, make_drude_ewald's PME):
    the pair kernel in Ewald real space, the bonded kernel and the PME
    spread; the NNP trained and run as an external, and force matching of
    the CG chain's parameters (torch ops, no CUDA kernel);
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
  5. dynamics: thrombin, a warm-up chunk, then TIMED_STEPS timed Langevin steps
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
  9. cli: thrombin through `torchmd_tpu_torch.run.main` as the dynamics
     phase runs it (2 fs, Langevin 300 K, f32), CLI_STEPS steps with a
     monitor row every CLI_PERIOD steps and the trajectory and a
     checkpoint every CLI_SAVE, the counters reset just before and read
     just after (each kernel launched at least once a step); the monitor
     rows finite, the trajectory's shape, the xyz and checkpoint files;
     the run resumed from its step-CLI_SAVE checkpoint within
     CLI_RESUME_TOL of the continuous run after CLI_PERIOD steps, and at
     the end within 10x the largest deviation between CLI_RESUMES resumed
     runs; a `[cli]` line of the CLI's
     steps/s beside the dynamics phase's (the API's) and their ratio;
 10. external: thrombin's Forces with `TorchExternal` over an nn.Module
     (a restraint plus a two-layer MLP, seed EXTERNAL_SEED) against
     Forces() plus the module's energy and -autograd forces at the Pallas
     bars, one evaluation's device time with and without it, then
     EXTERNAL_STEPS CLI steps with an `--external` config (finite, each
     kernel launched at least once a step);
 11. production: thrombin through `run.main` at 4 fs (`--constraints
     hbonds --hmr 3 --thermostat csvr`), PROD_STEPS steps with the
     counters reset just before and read just after (each of #1 and #3
     launched at least once a step), the 2,319 constraints, the mean T of
     the last half within PROD_T_TOL K of 300 K, SHAKE's residual at the
     end (the plain f64 one of the card's positions within
     PROD_SHAKE_ULPS f32 ulps, the card's reading within 2 ulps of it);
     the same system through the API, a timed chunk and a profile beside
     the 2 fs run's (`[production_vs_2fs]`: steps/s, ns/day, device
     events per step), 10 NVE steps against the plain f64 path (1e-3 A);
     a C-alpha HarmonicPositionalRestraint on the card against f64 on the
     CPU at the Pallas bars, then RESTRAINT_STEPS steps with it;
 12. mc_barostat: the NVT water box with MonteCarloBarostat, an attempt
     after each MC_CHUNK steps for MC_STEPS steps, counters reset just
     before and read just after; the first attempt's two states' per-term
     energies against the plain f64 path at the Pallas bar, the attempt's
     energies their sums; SETTLE after the moves, the volume within
     MC_VOLUME_RANGE, the attempt's ms and steps/s with attempts; aniso
     (x, z) and membrane moves on the 216-water box, each moving only
     the axes its mode names;
 13. cmap: a 5-atom chain with a CMAP cross-term, Forces on the card (f32)
     against the CPU (f64) at the Pallas bars;
 14. mts_thrombin: the production protocol with `--mts MTS_N` through the
     CLI, MTS_STEPS outer steps with the counters reset just before and
     read just after, held to the schedule's launches exactly (pair once
     an outer step, bonded MTS_N times, each once more at every chunk's
     entry and at the start), mean T and SHAKE's residual as the
     production phase gates them; MTS_TIMED steps through the API and a
     profile (`[mts_vs_production]`: steps/s, device events per step);
 15. mts_water: the SPC/Fw box, a CSVR warm-up; the column kernel's
     no-virial reaction-field instance on its end state against the plain
     f64 version (`column_rf` in the kernels line); then NVE runs over
     MTS_WATER_FS fs from that state (MTS_WATER_RUNS: the bench's mts 1
     at 0.5 fs, mts 4 at 2 fs, VV at 2 fs, and mts 2 at 1 fs, mts 8 at
     2 fs, VV at 1 fs), each run's ns/day, drift (a line fitted through
     the energy every MTS_WATER_SAMPLE_FS fs), rms about it and launches;
     mts 4 finite, launched as its schedule says, faster in ns/day than
     mts 1, and mts 1's and mts 4's drifts and rms within
     MTS_WATER_DRIFT_MAX and MTS_WATER_RMS_MAX;
 16. recip_tier: the 62.5k-site box's NVT phase with mts_recip=RECIP_R,
     RECIP_STEPS steps, launches held to the schedule (cell kernel every
     step; spread and gather every RECIP_R steps plus once a chunk),
     steps/s beside the NVT phase's, a profile; NVE legs with and without
     the tier;
 17. alanine_mtk: the alanine box under MTK (1 bar, NHC 300 K) with X-H
     SHAKE, HMR x3 and 4 fs through the CLI, ALA_STEPS steps (volume
     within NPT_VOLUME_RANGE); through the API ALA_CHECK_STEPS steps at
     f32 against the f64 torch-op path on the card (ALA_POS_TOL A), no
     kernel counter moved; the SHAKE virial at f32 against f64 (relative
     positions, ALA_VIRIAL_TOL of its magnitude; the absolute form's
     error beside it);
 18. verlet: thrombin on Verlet lists, per-term energies and forces
     against the dense pair kernel's at the Pallas bars, VERLET_STEPS
     timed Langevin steps, rebuilds and capacity, steps/s beside the
     dynamics phase's;
 18b. verlet_auto: the 103,200-atom vacuum system through
     Forces(kernel="auto") at f32: the path is Verlet lists built by
     cells, with no dense mask and no Parameters.get_exclusions(
     fullarray=True) call; VA_ROWS seeded rows of the f64 list against a
     brute-force scan; per-term energies and forces against the f64
     Verlet path at the Pallas bars; VA_STEPS timed steps (mean T within
     VA_T_TOL, the bonded kernel every step, the pair kernel never);
     capacity, build and evaluation ms, steps/s, rebuilds, peak memory;
 19. replica_kernels: the pair and bonded kernels' replica axis on
     REPLICAS thrombin conformations, one launch each against one launch
     per replica (the pair kernel bit for bit, the bonded kernel's
     energies equal, its forces at the Pallas bars) and against the f64
     plain versions; one R-replica launch timed against R single
     launches, with the bound at R;
 20. gbsa: GB/OBC at f32 against f64 on the card and its analytic forces
     against autograd of its energy (f64); device ms per evaluation
     (events and a profile); GB_STEPS CLI steps with `--gbsa`, the
     counters reset just before and read just after (#1 and #3 once a
     step and once at the start), mean T over the last half;
 21. remd: REPLICAS slots, 300-400 K geometric, GB, REMD_WARMUP steps at
     each slot's T, then REMD_STEPS steps with an exchange attempt every
     REMD_PERIOD: #1 and #3 once per evaluation of the ladder (steps + 1,
     not R times that), each slot's mean T over the last half (read every
     REMD_SAMPLE steps) within REMD_T_REL, acceptance per pair (not
     gated);
 22. metad: METAD_STEPS steps of well-tempered metadynamics on the
     ligand-pocket COM distance in GB: exactly METAD_STEPS / METAD_STRIDE
     hills, the grid against the hills replayed at f64 from the CV series
     and its integral against the tempered heights, a finite CV series,
     #1 launched once a step and once at the start, and the host syncs of
     the run (CUDA sync-debug mode) no more than a METAD_SHORT-step run's;
 23. alchemy: the ligand decoupled by `make_alchemical` on the dense pair
     kernel: at lambda 1 the unmodified system's energy and forces at the
     Pallas bars (stale exclusion words would count the crossing pairs
     twice), dU/dlambda at 0.5 f32 against f64, ALCH_STEPS Langevin steps
     at 0.5 with the launches counted; LambdaDynamics with the ligand as
     one site, LD_STEPS steps (lambda in [0, 1], finite), and
     LD_CHECK_STEPS steps at f32 within LD_POS_TOL A of f64;
 24. amoeba: the AMOEBA water box (AMOEBA_N^3 waters, make_amoeba_potential
     with valence=True, ewald=True, pme="auto": MultipolePme, the
     Ewald-split mutual polarization with a fixed-count CG, 14-7 vdW
     switched from AMOEBA_SWITCH A): one frame at f32 against f64 on the
     card (each part's energy within AMOEBA_E_TOL of its scale, forces
     within AMOEBA_F_TOL of max |F|, induced dipoles within AMOEBA_MU_TOL
     of max |mu|) and the polarizabilities x AMOEBA_FAULT beyond all
     three; the f64 CG within cg_tol in fewer than cg_iters iterations;
     host syncs of a CG solve (sync-debug mode) no more than a quarter
     solve's, eager and as the CUDA graph; the split of an evaluation
     (permanent-field pass, one CG iteration, energy and backward pass;
     the graphed solve against the eager one) by CUDA events; the whole
     evaluation's CUDA graph against the eager forces; AMOEBA_STEPS
     Langevin steps (steps/s, ns/day, T, the energy change; no kernel of
     #1-#8 launched) and a profile;
 25. drude: thrombin with Drude oscillators on its heavy atoms
     (DRUDE_ALPHA A^3, make_drude: 2,357 oscillators, 7,033 particles;
     DRUDE_TERMS, without the scaled 1-4 term): #1 and #3 on the
     extended system against plain at the Pallas bars with every
     core-Drude pair at r = 0 and at the SCF state (#3's window_stats
     for the springs' rows), scf_drude at f32 (damping, iterations, host
     reads, launches) and the SCF witnesses (the JAX step's growth, the
     damped step's stall), DRUDE_WINDOWS timed windows of DRUDE_WINDOW
     dual-Langevin steps, each from the SCF state, with the counters
     reset just before and read just after (steps/s, ns/day) and a
     profile, the collapse witness (the first step where a Drude leaves
     its core by 0.5 A, and the pair), DRUDE_NVE_STEPS NVE steps at f32 against f64 on the card
     (1e-3 A, or 3x the one-ulp floor with the 1 % charge control
     beyond it), #1 and #3 timed at 7,033 particles; then the polarizable
     argon liquid (ARGON_N^3 atoms): DRUDE_WARMUP and DRUDE_STEPS
     dual-Langevin steps, T_phys within DRUDE_T_TOL of 300 K and T_rel
     below DRUDE_TREL_MAX over the last half;
 26. drude_swm4: SWM4_N^3 SWM4-NDP waters from
     tests/data/swm4-ndp/swm4ndp.str (lone pairs, Thole, PME through
     make_drude_ewald with the exact gather): #1 (Ewald real space), #3
     and the spread #6 against plain at the start and relaxed; the f64
     SCF to SCF_TOL_F64, the f32 SCF on the kernels (launches one each
     an iteration, no ik gather); dipoles (all below SWM4_MU_RANGE[1],
     f32 within SWM4_MU_REL of f64), the induced dipoles against the JAX
     package's reading SWM4_WITNESS (the f64 solve of its 6^3 box, and
     the full box's mean within SWM4_WITNESS_SE standard errors), and
     the unrotated lattice's dipoles, all in SWM4_MU_RANGE;
 27. nnp: the NNP trained on the argon dimer's LJ curve (NNP_STEPS Adam
     steps, f32: loss and the well), the dimer's MD through
     Forces(external=NNPExternal), the default NNPConfig at thrombin's
     width (ms, peak memory);
 28. train: examples/train_cg.py's force matching, TRAIN_CHECK_STEPS
     steps at f32 against f64, then TRAIN_STEPS steps (steps/s, loss,
     recovered bond lengths, held-out force RMSE);
 29. mesh: the device mesh (`torchmd_tpu_torch.parallel`), one process
     per rank spawned by `parallel.launch` after the build (the ranks load
     the built libraries); a rank's failure fails the phase. The script
     needs one card and NCCL takes one rank per card, so: mesh_nccl,
     thrombin (the main path's configuration) under shard="spatial" on
     one NCCL rank, 10 steps within MESH_NCCL_TOL of the unsharded kernel
     run and steps/s beside it (the sharded path's overhead at W = 1);
     spatial_thrombin on W = 2 and 4 gloo ranks sharing cuda:0, each
     rank's row range of #1 against its plain f64 version at the Pallas
     bars and bit for bit against the full launch's rows, timed one rank
     at a time beside the bound of its share, 10 steps within
     MESH_TRAJ_TOL of the unsharded run, MESH_CFG's t_steps Langevin
     steps at MESH_T_GAMMA with the counters reset just before and read
     just after (the last half's mean T within MESH_T_TOL of 300 K, #1
     only through its row range) and
     steps/s ("W ranks sharing one card (gloo)": the decomposition, not
     scaling); spatial_water on W = 2: the 62,500-site box (PME, SETTLE,
     sites, NHC) WATER_WARMUP sharded steps, then 10 steps from there
     against the unsharded run within
     WATER_FLOOR_FACTOR x its one-ulp floor (the 1 % charge control
     beyond it; whether within MESH_TRAJ_TOL is logged), SETTLE and sites,
     each rank's slab of #4 against plain f64 and the slabs' sum against
     the full launch, timed; spatial_mtk: the argon NPT of
     tests/test_mtk.py at f32, box and positions against the unsharded
     dense MTK run, the volume in NPT_VOLUME_RANGE; replica_mesh: the
     REPLICAS-replica thrombin ladder over dp = 2, each replica within
     MESH_TRAJ_TOL of the one-process run, #1 and #3 once per evaluation
     on each rank; train_mesh: the force matching of phase 28 at f64 on
     a 1 x 2 mesh against the unsharded trainer (MESH_TRAIN_REL); a
     `[mesh_collectives]` line per phase counts the ranks' collectives
     (none goes through host memory: torch 2.11's gloo runs all four on
     CUDA tensors, `parallel/mesh.py`);
 30. roofline: every probe stage (f32) against its plain version (f64) at
     the probe's full size, on its inputs and on the same rows without
     pairs nearer than 2 A, each row's force held to the size of its terms
     (force_scale); four planted faults (the plain version with k_rf
     doubled or the switch moved) that the checks must catch; the chain kernels against their plain
     versions at the probe's shape; then the probe's own run with its
     counters reset just before and read just after: stage times, deltas,
     the mxred-vs-forces error (within 1e-5 of each row's scale, without
     the close pairs) and the chain throughputs.
 31. halo: halo-exchange MD (`parallel.HaloMD`) on solvated alanine
     dipeptide tiled 4 x 4 x 4 (44,032 atoms; cutoff 9 A, switch 7.5 A,
     classic Ewald, hbonds, 2 fs) on one NCCL rank, 2 and 4 gloo slabs and
     2 x 2 gloo pencils: every rank's halo kernel against its plain f64
     version (the Pallas bars) and timed, a zero-velocity step against the
     unsharded port with the same exact Ewald sum (HALO_E_REL, HALO_F_REL),
     10 NVE steps without constraints at 1 fs and 10 with hbonds at 2 fs,
     each against the unsharded Integrator at f64 within
     WATER_FLOOR_FACTOR x the unsharded f32 run's distance from it (charge
     controls of 0.1 % and 1 % beyond; the first also within MESH_TRAJ_TOL
     of the unsharded f32 run, the second's reading of it logged), and
     200 timed Langevin steps (steps/s, mean T within MESH_T_TOL, one halo
     kernel and one bonded launch a step a rank, migrations, capacity
     growths, comm bytes, collectives, peak memory).
The last two lines are a JSON summary of the kernels and the JSON status
line. Usage: python3 chip_smoke.py

`python3 chip_smoke.py --amoeba` runs the device and amoeba phases alone
(they build no kernel); `python3 chip_smoke.py --drude` the device and
build phases, then drude and drude_swm4; `python3 chip_smoke.py --mesh`
the device and build phases, then mesh; `python3 chip_smoke.py --halo`
the device and build phases, then halo; `python3 chip_smoke.py
--verlet-auto` the device and build phases, then verlet_auto.

`python3 chip_smoke.py --remd-seeds N` is a measurement, not the smoke
test: it builds the kernels and runs the remd phase, ungated, for seeds
0..N-1, and reports the spread of each slot's mean-T deviation (from
which REMD_T_REL is set).
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
TIMED_STEPS = 200
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
WATER_WARMUP, WATER_STEPS, WATER_CHUNK = 50, 100, 100
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
# over 100 steps (+12 to +26 kcal/mol run to run from the state after 400
# NVT steps; +43.7 plain and +49.1 kernels in one run after WATER_WARMUP
# + WATER_STEPS = 150) differ by that spread; they agree within
# NVE_DH_TOL kcal/mol
NVE_STEPS, NVE_DH_TOL = 100, 20.0
# calls (after one warm-up) when the ~0.2 s plain cell and column
# references are timed
PLAIN_CALLS = 3
KERNEL_SOURCES = ("nonbonded", "bonded", "cell", "pme", "column", "roofline", "halo")
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
NPT_WARMUP, NPT_STEPS, NPT_CHUNK = 100, 200, 100
NPT_VOLUME_RANGE = (0.7, 1.4)     # final volume over the lattice's
# the kernel's per-axis virial: 3 multiplies and 3 adds per pair
VIRIAL_FLOPS = 6
# the CLI phase: thrombin through `python -m torchmd_tpu_torch.run`'s main,
# CLI_STEPS steps with a monitor row every CLI_PERIOD and the trajectory
# and a checkpoint every CLI_SAVE; the run resumed from its CLI_SAVE
# checkpoint ends within CLI_RESUME_TOL A of the continuous run (the
# bonded kernel's float atomics make runs differ in the last bits); the
# noise at the end is that of CLI_RESUMES resumed runs, their largest
# pairwise deviation (one pair's is heavy-tailed: over the last 100 of
# 500 chaotic steps on an H100 one pair grew 11x, another 110x)
CLI_STEPS, CLI_PERIOD, CLI_SAVE, CLI_RESUME_TOL = 1000, 100, 500, 1e-3
CLI_RESUMES = 4
# the external phase: a restraint to the start plus a two-layer MLP of
# EXTERNAL_WIDTH over each atom's distance to the centroid, f32, weights
# from EXTERNAL_SEED; EXTERNAL_STEPS CLI steps with it
EXTERNAL_WIDTH, EXTERNAL_SEED, EXTERNAL_K, EXTERNAL_STEPS = 32, 7, 0.05, 200
EXTERNAL_POTENTIAL = """
import numpy as np
import torch


class Potential(torch.nn.Module):
    \"\"\"k |pos - ref|^2 plus a two-layer MLP over each atom's distance
    to the centroid.\"\"\"

    def __init__(self, ref, k, width, seed):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.register_buffer("ref", torch.as_tensor(ref, dtype=torch.float32))
        self.k = k
        self.l1 = torch.nn.Linear(1, width)
        self.l2 = torch.nn.Linear(width, 1)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))

    def forward(self, pos, box):
        d = (pos - pos.mean(0)).norm(dim=1, keepdim=True)
        mlp = self.l2(torch.tanh(self.l1(d))).sum()
        return self.k * ((pos - self.ref) ** 2).sum() + mlp


def make_potential(embeddings, ref=None, k=0.05, width=32, seed=7):
    return Potential(np.load(ref), float(k), int(width), int(seed))
"""
# the production phase: thrombin through the CLI at bench.py's 4 fs with
# its X-H bonds constrained (SHAKE/RATTLE), hydrogen masses x PROD_HMR on
# the System and CSVR at TEMP (tau 100 steps); PROD_STEPS steps, a monitor
# row every PROD_PERIOD. Gates: PROD_XH constraints; the mean T of the
# rows after PROD_STEPS / 2 within PROD_T_TOL K of TEMP; SHAKE's residual
# at the end, taken at f64 from the card's f32 positions, within
# PROD_SHAKE_ULPS f32 ulps of the largest coordinate (50 Jacobi sweeps
# converge below f32 rounding: on the CPU the alanine box's residual after
# 100 4 fs steps is 1.7e-13 A at f64 and 0.93 ulp at f32), and the card's
# f32 reading of it within 2 ulps of that
PROD_TIMESTEP, PROD_STEPS, PROD_PERIOD, PROD_HMR = 4.0, 1000, 50, 3.0
PROD_XH, PROD_T_TOL, PROD_SHAKE_ULPS = 2319, 15.0, 10.0
# the restrained leg: C-alpha atoms held to the start by k RESTRAINT_K
# kcal/mol/A^2, RESTRAINT_STEPS steps of the production protocol
RESTRAINT_K, RESTRAINT_STEPS = 1.0, 100
# the Monte Carlo phase: the NVT water box plus MonteCarloBarostat(MC_PRESSURE
# bar, TEMP, groups = waters, seed MC_SEED), an attempt after each MC_CHUNK
# steps for MC_STEPS steps; then aniso (scale_axes x, z) and membrane moves
# on the 216-water box, MC_SMALL_ATTEMPTS each with dV_max MC_SMALL_DV of V
MC_PRESSURE, MC_SEED, MC_STEPS, MC_CHUNK = 1.0, 5, 250, 25
MC_VOLUME_RANGE = (0.7, 1.4)
MC_SMALL_ATTEMPTS, MC_SMALL_CHUNK, MC_SMALL_DV = 30, 10, 0.002
# the CMAP check: a 5-atom chain with one cross-term on a CMAP_N x CMAP_N
# grid of a smooth periodic surface (the system tests/test_cmap.py writes)
CMAP_N = 24
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

# r-RESPA on thrombin through the CLI: the production flags plus --mts
# MTS_N (bonded terms on MTS_N substeps of each 4 fs step), MTS_STEPS outer
# steps in chunks of PROD_PERIOD, then MTS_TIMED steps through the API
# and a profile beside the production phase's (MTS_STEPS 1,000 before the
# device mesh's phases joined; 500 keep the whole script within 1,200 s
# on a slow host, where it took 1,015 s; MTS_TIMED 200 before the halo
# phase grew, with the timing depth of other phases: TIMED_STEPS,
# WATER_WARMUP, WATER_STEPS, NPT_STEPS, RESTRAINT_STEPS, MC_STEPS,
# RECIP_STEPS, RECIP_NVE_STEPS, ALA_STEPS and METAD_STEPS were 1,000, 100,
# 300, 300, 200, 500, 300, 200, 500 and 1,000, and the plain versions'
# timings of the ~0.2 s cell and column references 5 calls; no gate or
# tolerance changed, and no count a tolerance was set on)
MTS_N, MTS_STEPS, MTS_TIMED = 2, 500, 50
# scripts/bench_mts.py's water in the port: MTS_WATER_N^3 flexible SPC/Fw
# waters on the 3.104 A lattice, cutoff 8.5 A, reaction field, NVE on the
# defaults of Forces; after MTS_WATER_WARM steps of CSVR at 0.5 fs from
# the lattice at MTS_WATER_T K, the runs (label, mts, outer step fs; mts
# None is plain VV) each over MTS_WATER_FS fs from that state, the total
# energy sampled every MTS_WATER_SAMPLE_FS fs
MTS_WATER_N, MTS_WATER_CUTOFF, MTS_WATER_FS, MTS_WATER_T = 20, 8.5, 200.0, 300.0
MTS_WATER_WARM, MTS_WATER_SAMPLE_FS = 1000, 10.0
MTS_WATER_RUNS = (("mts1_0.5fs", 1, 0.5), ("mts4_2fs", 4, 2.0), ("vv_2fs", None, 2.0),
                  ("mts2_1fs", 2, 1.0), ("mts8_2fs", 8, 2.0), ("vv_1fs", None, 1.0))
# bounds on |drift| (the slope of the fitted line, kcal/mol/atom/ns) and
# on the rms of the energy about that line (kcal/mol), ~3x what the phase
# read on an H100 80GB HBM3 at 700 W (mts 1: -0.61 and 1.81; mts 4: 3.78
# and 204.7, where 200 fs of that rms leave the slope ~30 of fit noise)
MTS_WATER_DRIFT_MAX = {"mts1_0.5fs": 3.0, "mts4_2fs": 100.0}
MTS_WATER_RMS_MAX = {"mts1_0.5fs": 6.0, "mts4_2fs": 600.0}
SPCFW_TOP = """
[ defaults ]
  1      2         yes       0.5     0.8333

[ atomtypes ]
  OW   8     15.99940 -0.82   A     3.16557e-01  6.50629e-01
  HW   1     1.00800   0.41   A     0.0          0.0

[ moleculetype ]
  SOL  2

[ atoms ]
  1  OW   1     SOL     OW   1    -0.82  15.9994
  2  HW   1     SOL     HW1  1     0.41   1.008
  3  HW   1     SOL     HW2  1     0.41   1.008

[ bonds ]
  1 2 1 0.1012 443153.38
  1 3 1 0.1012 443153.38

[ angles ]
  2 1 3 1 113.24 317.5656

[ system ]
SPC/Fw water

[ molecules ]
SOL {nw}
"""
# the 62.5k-site box's NVT phase with the reciprocal tier (PME every
# RECIP_R outer steps), RECIP_STEPS steps in WATER_CHUNK chunks; NVE legs
# of RECIP_NVE_STEPS steps with and without the tier from one state
RECIP_R, RECIP_STEPS, RECIP_NVE_STEPS = 2, 100, 100
# the alanine dipeptide box under MTK with SHAKE through the CLI (its
# ACEMD input: 688 atoms, cutoff 9 A, switching from 7.5 A), the exact
# Ewald sum, X-H bonds constrained, hydrogens x3, 4 fs, NHC at 300 K, 1 bar
ALA_SYSTEM = "prod_alanine_dipeptide_amber"
# (ALA_STEPS 1,000 before the device mesh's phases joined, then 500; see
# MTS_STEPS)
ALA_STEPS, ALA_PERIOD, ALA_CUTOFF, ALA_SWITCH = 250, 50, 9.0, 7.5
ALA_CHECK_STEPS, ALA_POS_TOL, ALA_VIRIAL_TOL = 10, 1e-3, 1e-5
# Verlet lists on thrombin: VERLET_STEPS Langevin steps at 2 fs, timed
VERLET_WARMUP, VERLET_STEPS = 20, 200
# the automatic Verlet choice (forces.VERLET_AUTO_N): the alanine box
# tiled VA_TILE (103,200 atoms, ~99.3 x 98.1 x 117.8 A) with its box
# dropped, ALA_CUTOFF / ALA_SWITCH, reaction field, Forces(kernel="auto")
# at f32; VA_ROWS seeded rows of the f64 list held to a brute-force scan;
# VA_WARMUP + VA_STEPS Langevin steps at 2 fs (hbonds, VA_GAMMA ps^-1),
# the timed ones in chunks of VA_CHUNK, their mean T within VA_T_TOL
VA_TILE, VA_ROWS, VA_SCAN_ROWS = (5, 5, 6), 2048, 128
VA_WARMUP, VA_STEPS, VA_CHUNK, VA_GAMMA, VA_T_TOL = 50, 200, 25, 10.0, 15.0
# slice 7: implicit solvent and enhanced sampling on thrombin. The replica
# axis of the pair and bonded kernels: REPLICAS conformations (the start
# plus a Maxwell-Boltzmann half-step each, seeds 0..R-1) in one launch,
# against R one-replica launches (the pair kernel bit for bit, the bonded
# kernel's energies equal and its forces at the Pallas bars)
REPLICAS = 8
# GB/OBC (`--gbsa`, cutoff 7.3 A as the CLI gives it): f32 against f64 on
# the card, energy relative and forces over max |F| (f32 sums over 21.9 M
# pair terms); the analytic forces against autograd of the energy at f64
GB_E_TOL, GB_F_TOL, GB_AD_TOL = 1e-4, 1e-4, 1e-9
# the CLI run: the CLI phase's flags and --gbsa, with Langevin friction
# GB_GAMMA ps^-1 (at the CLI phase's 0.1 ps^-1 the first ps stays near
# 220 K: the start shares its kinetic energy with the potential, and the
# thermostat's 10 ps relaxation has not brought it back)
GB_STEPS, GB_PERIOD, GB_T_TOL, GB_GAMMA = 500, 50, 15.0, 10.0
# replica exchange: the 8-replica geometric ladder 300-400 K in GB,
# Langevin 1 ps^-1, an attempt every REMD_PERIOD steps; each slot's mean T
# over the last half, read every REMD_SAMPLE steps, within REMD_T_REL of
# its ladder T, after REMD_WARMUP steps of each slot at its T with
# GB_GAMMA ps^-1 (from the start at 1 ps^-1 the slots ran 11-16 % below
# their T over 1 ps). REMD_T_REL is the mean plus 4 standard deviations
# of the 48 slot deviations of `--remd-seeds 6` on an H100 (+1.48 % and
# 1.61 %; the worst 5.03 %), rounded up: the slots run warm while the
# structure relaxes, and a swapped-in configuration from a hotter rung
# runs hot in its new slot. The gate is for a grossly wrong ladder (one T
# for every slot, or reversed); 1 ps cannot tell a slot from its
# neighbour rung (4 % apart), and the CPU tests hold the T vector's noise
# to the JAX package's
REMD_LADDER, REMD_GAMMA, REMD_STEPS, REMD_PERIOD, REMD_T_REL = (300.0, 400.0), 1.0, 500, 100, 0.08
REMD_WARMUP, REMD_SAMPLE = 200, 10
# well-tempered metadynamics on the ligand (residue MOL) - pocket (protein
# heavy atoms within METAD_POCKET A of it at the start) COM distance in GB
METAD_POCKET, METAD_BIASF, METAD_HEIGHT, METAD_SIGMA = 6.0, 10.0, 0.3, 0.2
METAD_STRIDE, METAD_STEPS, METAD_SHORT, METAD_DX = 50, 500, 100, 0.01
LIGAND = "MOL"
# alchemy and lambda-dynamics on the ligand: ALCH_STEPS Langevin steps at
# lam = 0.5; LD_STEPS steps of lambda-dynamics; LD_CHECK_STEPS steps at f32
# within LD_POS_TOL A of f64 (no thermostat); dU/dlambda f32 within
# DUDL_TOL (relative) of f64
ALCH_STEPS, LD_STEPS, LD_CHECK_STEPS, LD_POS_TOL, DUDL_TOL = 200, 200, 10, 1e-3, 1e-4

# the AMOEBA water box: AMOEBA_N^3 water03 waters on a lattice (random
# orientations from AMOEBA_SEED) in a cubic AMOEBA_L A box (0.997 g/cm^3,
# Ren & Ponder 2003), make_amoeba_potential(valence=True, ewald=True,
# pme="auto") with mutual polarization (AMOEBA_CG: cg_iters, cg_tol), the
# vdW switched from AMOEBA_SWITCH to AMOEBA_CUTOFF; Langevin at 300 K,
# AMOEBA_DT fs, f32, AMOEBA_WARMUP then AMOEBA_STEPS timed steps in
# chunks of AMOEBA_CHUNK. One frame at f32 against f64 on the card: each
# part's energy within AMOEBA_E_TOL of the part's scale (its magnitude;
# the permanent part's is its Ewald self energy, the sum the f32 rounding
# follows), forces within AMOEBA_F_TOL of max |F|, induced dipoles within
# AMOEBA_MU_TOL of max |mu|; the polarizabilities scaled by
# AMOEBA_FAULT must miss those bars.
AMOEBA_N, AMOEBA_L, AMOEBA_SEED = 6, 18.643, 5
AMOEBA_CUTOFF, AMOEBA_SWITCH, AMOEBA_CG = 9.0, 8.1, (40, 1e-6)
AMOEBA_DT, AMOEBA_WARMUP, AMOEBA_STEPS, AMOEBA_CHUNK = 0.5, 2, 20, 5
AMOEBA_E_TOL, AMOEBA_F_TOL, AMOEBA_MU_TOL = 2e-5, 3e-4, 2e-5
AMOEBA_FAULT = 1.01
# the published water03 parameters of tests/test_amoeba.py (WATER03_FULL)
AMOEBA_PRM = """
atom          1    1    O     "AMOEBA Water O"               8    15.995    2
atom          2    2    H     "AMOEBA Water H"               1     1.008    1

multipole     1   -2   -2              -0.51966
                                        0.00000    0.00000    0.14279
                                        0.37928
                                        0.00000   -0.41809
                                        0.00000    0.00000    0.03881
multipole     2    1    2               0.25983
                                       -0.03859    0.00000   -0.05818
                                       -0.03673
                                        0.00000   -0.10739
                                       -0.00203    0.00000    0.14412

polarize      1           0.8370     0.3900       2
polarize      2           0.4960     0.3900       1

vdw           1               3.4050     0.1100
vdw           2               2.6550     0.0135      0.910

bond-cubic              -2.55
bond-quartic            3.793125
angle-cubic             -0.014
angle-quartic           0.000056
angle-pentic            -0.0000007
angle-sextic            0.000000022

bond          1    2          529.60     0.9572
angle         2    1    2      34.05     108.50
ureybrad      2    1    2      38.25     1.5537
"""

# Drude oscillators on thrombin (the main path's system): DRUDE_ALPHA A^3
# on every heavy atom and 0 on hydrogens -- a load-bearing setting of the
# dynamics path, not a published force field -- and the JAX defaults (k
# 500, m_D 0.4, Thole 2.6); scf_drude (at most SCF_ITERS iterations; the
# SWM4 box's f32 tolerance SCF_TOL_F32 kcal/mol/A: f32 forces cannot reach
# the f64 1e-10; thrombin's below),
# then DrudeIntegrator at DRUDE_DT fs, 300 K, 1 ps^-1, T_drude 1 K, 20
# ps^-1 for DRUDE_STEPS steps in chunks of DRUDE_CHUNK: the mean T_phys of
# the last half's chunks within DRUDE_T_TOL of 300 K, the mean T_rel below
# DRUDE_TREL_MAX (tests/test_drude.py:117-145); DRUDE_NVE_STEPS NVE steps
# at f32 (kernels) against f64 (torch ops) on the card, within 1e-3 A or 3x
# the one-ulp floor with the 1 % charge control beyond it.
# Thrombin's terms without the scaled "1-4" term, its 1-2, 1-3 and 1-4
# pairs excluded from the pair term and Thole-screened between
# oscillators. With "1-4" the extended topology's 1-4 table carries the
# shifted core charges q - q_D and no Drude counterpart (the JAX
# construction, which the port keeps; ROADMAP section 3): q_D^2 k_e /
# (scee r), ~280 kcal/mol a heavy-atom 1-4 pair at q_D = -1.735 e (1 A^3),
# scee 1.2 and r 3 A. With 1-4 pairs in the pair term instead, a Drude
# (no LJ) falls onto a 1-4 hydroxyl hydrogen (no LJ either) within 30 fs.
DRUDE_TERMS = [t for t in TERMS if t != "1-4"]
DRUDE_ALPHA, DRUDE_DT, DRUDE_STEPS, DRUDE_CHUNK = 1.0, 1.0, 1000, 20
# steps at the same settings before the gated run: from Maxwell-Boltzmann
# velocities T_phys falls to ~210 K within 20 fs and gamma 1 ps^-1 brings
# it back over ~1 ps
DRUDE_WARMUP = 1000
# Drude thrombin leaves the model within tens of femtoseconds: a polar
# hydrogen (no LJ) and a neighbour's Drude (no LJ either) fall onto each
# other across an H-bond (the collapse witness logs the first step and the
# pair, stepping at most DRUDE_COLLAPSE_STEPS;
# tests/test_torch_drude_thrombin.py shows the JAX package and the port
# collapse at the same step on a piece of this system; ROADMAP section
# 3). Its dynamics are therefore timed over DRUDE_WINDOWS windows of
# DRUDE_WINDOW steps, each from the SCF state with fresh velocities, the
# clock and the counters around the stepping alone. The gated 1,000-step
# run is the polarizable argon liquid: ARGON_N^3 atoms in an ARGON_L A
# box (1.29 g/cm^3), argon's ARGON_ALPHA A^3, cutoff ARGON_CUTOFF A,
# reaction field. The SCF witnesses: the JAX step (damping 1) for
# SCF_WITNESS_ITERS iterations, and the damped one to SCF_TOL_F32.
DRUDE_WINDOW, DRUDE_WINDOWS, DRUDE_COLLAPSE_STEPS, SCF_WITNESS_ITERS = 10, 50, 400, 60
ARGON_N, ARGON_L, ARGON_ALPHA, ARGON_CUTOFF = 12, 44.6, 1.64, 10.0
DRUDE_T_TOL, DRUDE_TREL_MAX, DRUDE_NVE_STEPS = 15.0, 60.0, 10
SCF_ITERS, SCF_TOL_F32, SCF_TOL_F64 = 200, 1e-2, 1e-10
# the SCF on thrombin: the JAX package's full step g / (2 k) grows on the
# Trp rings' stiff dipole modes (curvature beyond 4 k, 1.4 A pairs
# Thole-screened only to 0.93); half of it converges. Its tolerance
# DRUDE_SCF_TOL kcal/mol/A: the reaction field's force at the cutoff,
# k_e q_i q_j (2 k_rf r_c - 1/r_c^2), is not 0, so a Drude pair (1.735 e
# each) crossing 7.3 A moves a Drude's force by ~0.4 kcal/mol/A, which no
# step size settles below
DRUDE_SCF_DAMPING, DRUDE_SCF_TOL = 0.5, 1.0
# SWM4-NDP (Lamoureux et al. 2006; tests/data/swm4-ndp/swm4ndp.str):
# SWM4_N^3 waters on a lattice in a SWM4_L A box (0.997 g/cm^3), each
# turned by a random rotation about its O (SWM4_SEED), M sites from the
# lone-pair frame, PME (make_drude_ewald, tol SWM4_TOL, cutoff SWM4_CUTOFF,
# terms electrostatics + bonds: the RTF has no LJ). Randomly oriented
# neighbours' fields are random with respect to a molecule's own dipole,
# so the SCF lowers some dipoles below the gas value (the phase logs the
# least), and every dipole is held below SWM4_MU_RANGE[1]. The induced
# dipoles |q_D d| are held to a reading of the JAX package:
# SWM4_WITNESS = (n, mean, spread) of the same construction cut to n^3
# waters, set by tests/test_torch_drude_charmm.py (where the port equals
# the JAX package on it within 1e-8 D). The card's f64 solve of that n^3
# box meets the mean and spread within SWM4_WITNESS_TOL D, and the full
# box's mean lies within SWM4_WITNESS_SE standard errors of the witness
# mean (both boxes' spreads over their water counts). The same lattice
# with every water unrotated (tests/test_drude_charmm.py's arrangement)
# meets SWM4_MU_RANGE for every dipole; f32 dipoles within SWM4_MU_REL
# (relative) of f64.
SWM4_N, SWM4_L, SWM4_SEED, SWM4_CUTOFF, SWM4_TOL = 12, 37.28, 5, 9.0, 1e-5
SWM4_MU_RANGE, SWM4_MU_REL = (1.86, 3.2), 1e-3
SWM4_WITNESS = (6, 0.25514654329238945, 0.11004410626184047)
SWM4_WITNESS_TOL, SWM4_WITNESS_SE = 1e-6, 4.0
DEBYE = 4.80320425            # D per e A
# the NNP on the argon-dimer LJ curve (tests/test_nnp.py): NNP_DISTS
# distances, NNP_STEPS Adam steps at NNP_LR, f32; the final loss below
# NNP_LOSS_DROP x the first and E within NNP_E_TOL kcal/mol of LJ at
# NNP_CHECK_R; then NNP_MD_STEPS steps of the dimer at 5 fs with the NNP as
# the only term; the default NNPConfig at thrombin's width (species by
# element) timed for one energy + forces evaluation
NNP_DISTS, NNP_STEPS, NNP_LR, NNP_LOSS_DROP, NNP_E_TOL = 48, 800, 3e-3, 1e-2, 0.05
NNP_CHECK_R, NNP_MD_STEPS = (3.6, 3.8, 4.5, 6.0), 400
# force matching on examples/train_cg.py's recipe: TRAIN_B jittered
# conformations of the 20-bead CG chain, bonds/angles/LJ perturbed, Adam
# at TRAIN_LR, energy weight TRAIN_EW, TRAIN_STEPS steps (f32); the final
# loss at most TRAIN_LOSS_DROP x the first; TRAIN_CHECK_STEPS steps at f32
# against f64 on the card, every parameter within TRAIN_REL (relative)
TRAIN_B, TRAIN_LR, TRAIN_EW, TRAIN_STEPS, TRAIN_LOSS_DROP = 64, 2.5e-2, 1e-4, 1500, 1e-2
TRAIN_CHECK_STEPS, TRAIN_REL = 20, 1e-4

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


_WATER = {}


def build_water(n, spacing, jitter, precision="single"):
    """(mol, par, box edge) of an n^3 TIP4P/2005 lattice: origins at
    g * spacing + 0.8 plus seed-0 normal jitter of 0.05 A (the bench), or
    g * spacing + 0.9 without jitter (the 216-water test box). Built once
    for each set of arguments; every call gets its own copy."""
    import copy

    key = (n, spacing, jitter, precision)
    if key not in _WATER:
        _WATER[key] = _build_water(*key)
    return copy.deepcopy(_WATER[key])


def _build_water(n, spacing, jitter, precision):
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


def _pairs_within(pos, ids, nrows, excl, box, wrap, cutoff, rows=2048):
    """(i, j) pairs inside the cutoff with i one of the first `nrows` rows
    and j any row, less pairs of one id (self) and of excluded ids: the
    ordered count over the columns [0, nrows) and the count over the
    rest. `ids` are global ids into the (N, nexcl) exclusion table `excl`
    (ids and entries >= N: padding, never paired); `wrap` says which axes
    take the minimum image."""
    import torch

    n = int(excl.shape[0])
    wrap = torch.as_tensor(wrap, device=pos.device)
    ex = excl.long()
    keys = torch.arange(n, device=pos.device)[:, None] * (n + 1) + ex
    keys = torch.sort(keys[ex < n]).values
    inner = outer = 0
    for r0 in range(0, nrows, rows):
        r1 = min(nrows, r0 + rows)
        dv = pos[r0:r1, None, :] - pos[None, :, :]
        dv = torch.where(wrap, dv - box * torch.round(dv / box), dv)
        i, j = torch.nonzero((dv * dv).sum(-1) <= cutoff * cutoff, as_tuple=True)
        gi, gj = ids[r0 + i], ids[j]
        key = gi * (n + 1) + gj
        hit = torch.searchsorted(keys, key).clamp(max=max(0, len(keys) - 1))
        kept = (gi != gj) & (gi < n) & (gj < n)
        if len(keys):
            kept &= keys[hit] != key
        inner += int((kept & (j < nrows)).sum())
        outer += int((kept & (j >= nrows)).sum())
    return inner, outer


def _water_pair_count(data, pos, box, cutoff):
    """Unordered non-excluded pairs inside the cutoff (minimum image)."""
    import torch

    n = pos.shape[0]
    inner, _ = _pairs_within(pos, torch.arange(n, device=pos.device), n, data.excl, box,
                             (True, True, True), cutoff)
    return inner // 2


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
                                    calls=PLAIN_CALLS, warmup=1),
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
    profile = profile_water_step(integ, 1.0 / steps_per_s, steps=200,
                                 label="thrombin_profile", shares=("pair_", "bonded"))

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
    return launches, steps_per_s, profile


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
    the kernels whose names hold each of `shares`. Returns (device ms per
    step, device events per step)."""
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
    return total_us / 1e3, launches

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
                data, cfg, ck.ccfg, st, p32, b32, with_virial=True),
                calls=PLAIN_CALLS, warmup=1),
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
                kk.data, cfg, kk.clcfg, cl, p32, b32, with_virial=True),
                calls=PLAIN_CALLS, warmup=1),
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
    # each stage beside its dense floor (the pair loop's instructions over
    # npad^2 pairs, from the built kernels' SASS) and the forces stage's
    # function bound; mxred's tensor-core instructions
    loops, floors = res["loops"], res["dense_floor_ms"]
    for st in rl.STAGES:
        c = (loops or {}).get(st, {})
        log("roofline_stage", stage=st, ms=f"{res['ms'][st]:.4f}",
            dense_floor_ms=f"{floors[st]:.5f}" if st in floors else "not taken",
            issued_per_pair=c.get("issued"), mufu_per_pair=c.get("mufu"),
            forces_bound_ms=f"{out['bound'][0]:.5f}")
    if loops is None:
        log("roofline_mma", hmma_in_mxred="not taken: the toolkit has no cuobjdump")
    else:
        log("roofline_mma", hmma_in_mxred=loops["mxred"]["hmma_in_kernel"],
            hmma_per_pair=loops["mxred"]["hmma"])
    return out, launches["stages"]


def _cli_argv(log_dir, steps, extra=()):
    """The CLI's arguments for thrombin at the dynamics phase's settings."""
    d = os.path.join(DATA, MAIN_SYSTEM[0])
    return ["--topology", os.path.join(d, "structure.prmtop"),
            "--forcefield", os.path.join(d, "structure.prmtop"),
            "--coordinates", os.path.join(d, MAIN_SYSTEM[1]),
            "--forceterms", *TERMS, "--cutoff", str(CUTOFF), "--rfa",
            "--timestep", str(TIMESTEP), "--temperature", str(TEMP),
            "--langevin-temperature", str(TEMP), "--langevin-gamma", str(GAMMA),
            "--precision", "single", "--steps", str(steps),
            "--output-period", str(CLI_PERIOD), "--seed", "1",
            "--device", DEVICE, "--log-dir", log_dir, *extra]


def _api_chunked_steps_per_s(log_dir):
    """Steps/s of the system the CLI's setup builds, stepped as the CLI
    steps it (CLI_STEPS // CLI_PERIOD calls of Integrator.step(CLI_PERIOD),
    timed from the first) with no output, no wrap and no writer thread."""
    from torchmd_tpu_torch import run as cli
    from torchmd_tpu_torch.integrator import Integrator
    from torchmd_tpu_torch.profiling import StepTimer

    mol, system, forces = cli.setup(cli.get_args(_cli_argv(log_dir, CLI_STEPS)))
    integ = Integrator(system, forces, TIMESTEP, gamma=GAMMA, T=TEMP, seed=1)
    forces.compute(system.pos, system.box, system.forces)
    timer = StepTimer(TIMESTEP, device=DEVICE)
    with timer.measure(CLI_STEPS):
        for _ in range(CLI_STEPS // CLI_PERIOD):
            integ.step(niter=CLI_PERIOD)
    return timer.steps_per_sec


def phase_cli(api_steps_per_s):
    """Thrombin through `torchmd_tpu_torch.run.main` (the CLI), in-process:
    CLI_STEPS steps with monitor rows, trajectory, xyz and checkpoints,
    the counters reset just before and read just after, timed between two
    runs of the same steps through the API in the CLI's chunks; then the
    run resumed from its CLI_SAVE-step checkpoint, twice, against the
    continuous one."""
    import csv
    import shutil

    from torchmd_tpu_torch import checkpoint
    from torchmd_tpu_torch import run as cli
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn

    nframes = CLI_STEPS // CLI_PERIOD
    with tempfile.TemporaryDirectory() as td:
        full = os.path.join(td, "full")
        mid = os.path.join(td, f"step{CLI_SAVE}.chk")
        save = checkpoint.save_checkpoint

        def keep_mid(path, system, integrator, iteration):
            # the CLI overwrites output.chk at every checkpoint: keep the
            # step-CLI_SAVE one for the resume
            save(path, system, integrator, iteration)
            if iteration * CLI_PERIOD == CLI_SAVE:
                shutil.copy(path, mid)

        chunked = [_api_chunked_steps_per_s(os.path.join(td, "api0"))]
        checkpoint.save_checkpoint = keep_mid
        try:
            argv = _cli_argv(full, CLI_STEPS, ["--save-period", str(CLI_SAVE),
                                               "--checkpoint-period", str(CLI_SAVE)])
            kn.LAUNCHES = kb.LAUNCHES = 0
            summary = cli.main(argv)
            launches = {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}
        finally:
            checkpoint.save_checkpoint = save
        chunked.append(_api_chunked_steps_per_s(os.path.join(td, "api1")))
        sync = cli.main(_cli_argv(os.path.join(td, "sync"), CLI_STEPS,
                                  ["--async-output", "0"]))["steps_per_sec"]
        sps = summary["steps_per_sec"]
        api_chunked = sum(chunked) / len(chunked)
        log("cli", steps=summary["steps"], seconds=f"{summary['elapsed_s']:.4f}",
            cli_steps_per_s=f"{sps:.2f}", ns_per_day=f"{summary['ns_per_day']:.3f}",
            api_steps_per_s=f"{api_steps_per_s:.2f}",
            cli_over_api=f"{sps / api_steps_per_s:.3f}",
            api_chunked_steps_per_s="/".join(f"{c:.2f}" for c in chunked),
            cli_over_api_chunked=f"{sps / api_chunked:.3f}",
            cli_sync_output_steps_per_s=f"{sync:.2f}",
            pair_launches=launches["pair"], bonded_launches=launches["bonded"])
        for k, n in launches.items():
            require(n >= CLI_STEPS, f"CLI: {k} kernel launched {n} < {CLI_STEPS} times")
        with open(os.path.join(full, "monitor_0.csv")) as fh:
            rows = list(csv.DictReader(fh))
        require(len(rows) == nframes, f"CLI monitor rows {len(rows)} != {nframes}")
        require(all(np.isfinite(float(r[k])) for r in rows
                    for k in ("epot", "ekin", "etot", "T")), "CLI monitor not finite")
        traj = np.load(os.path.join(full, "output_0.npy"))
        natoms = traj.shape[0]
        require(traj.shape[1:] == (3, nframes) and np.all(np.isfinite(traj)),
                f"CLI trajectory {traj.shape}")
        for name in ("output_0.xyz", "output.chk", "input.yaml"):
            require(os.path.exists(os.path.join(full, name)), f"CLI wrote no {name}")
        require(os.path.exists(mid), f"no step-{CLI_SAVE} checkpoint")

        ends = []
        for k in range(CLI_RESUMES):
            out = os.path.join(td, f"resumed{k}")
            cli.main(_cli_argv(out, CLI_STEPS, ["--save-period", str(CLI_SAVE),
                                                "--resume", mid]))
            ends.append(np.load(os.path.join(out, "output_0.npy")))
        later = nframes - CLI_SAVE // CLI_PERIOD
        require(all(e.shape[2] == later for e in ends), "resumed trajectory frames")
        dev = np.abs(ends[0] - traj[:, :, -later:]).max(axis=(0, 1))
        floor = np.max([np.abs(a - b).max(axis=(0, 1))
                        for i, a in enumerate(ends) for b in ends[i + 1:]], axis=0)
        log("cli_resume", from_step=CLI_SAVE,
            steps="/".join(str(CLI_SAVE + CLI_PERIOD * (f + 1)) for f in range(later)),
            resumed_vs_continuous_A="/".join(f"{d:.3e}" for d in dev),
            resumed_vs_resumed_A="/".join(f"{d:.3e}" for d in floor),
            tol_A=CLI_RESUME_TOL)
        # the first frame after the resume: a wrong state or noise stream
        # moves atoms by ~0.1 A within CLI_PERIOD steps; the last bits of
        # the bonded kernel's sums have not grown to CLI_RESUME_TOL yet
        require(dev[0] <= CLI_RESUME_TOL,
                f"resumed CLI run differs by {dev[0]} A after {CLI_PERIOD} steps")
        # at the end: as close as the resumed runs are to each other
        require(dev[-1] <= max(CLI_RESUME_TOL, 10.0 * floor[-1]),
                f"resumed CLI run differs by {dev[-1]} A at the end ({CLI_RESUMES} "
                f"resumed runs: {floor[-1]} A apart)")
    return launches, natoms


def phase_external():
    """Thrombin's Forces with an external torch potential on the card
    (`TorchExternal` over an nn.Module: a restraint plus a two-layer MLP):
    per-term energies and forces against Forces() plus the module's own
    energy and -autograd forces, the device time per evaluation with and
    without it, then EXTERNAL_STEPS CLI steps with an --external config."""
    import torch
    import yaml

    from torchmd_tpu_torch.external import External
    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn

    mol, par, plain = _thrombin_forces(DEVICE)
    with tempfile.TemporaryDirectory() as td:
        potential, ref = os.path.join(td, "potential.py"), os.path.join(td, "ref.npy")
        with open(potential, "w") as fh:
            fh.write(EXTERNAL_POTENTIAL)
        np.save(ref, mol.coords[:, :, 0])
        spec = {"ref": ref, "k": EXTERNAL_K, "width": EXTERNAL_WIDTH,
                "seed": EXTERNAL_SEED}
        ext = External(potential, np.zeros((1, mol.numAtoms), int), device=DEVICE, **spec)
        withext = Forces(par, terms=TERMS, precision="single", cutoff=CUTOFF, rfa=RFA,
                         device=DEVICE, external=ext)
        rs = np.random.RandomState(EXTERNAL_SEED)
        pos = (mol.coords[:, :, 0] + 0.05 * rs.randn(mol.numAtoms, 3))[None]
        d0 = plain.compute(pos, None, returnDetails=True)[0]
        f0 = plain.last_forces[0]
        d1 = withext.compute(pos, None, returnDetails=True)[0]
        f1 = withext.last_forces[0]
        p = torch.as_tensor(pos[0], dtype=torch.float32, device=DEVICE).requires_grad_(True)
        zero_box = torch.zeros(3, dtype=torch.float32, device=DEVICE)
        e_ext = ext.energy_fn(p, zero_box)
        (g,) = torch.autograd.grad(e_ext, p)
        want = dict(d0, external=float(e_ext.detach()))
        e_err = max(abs(d1[k] - want[k]) / max(1.0, abs(want[k])) for k in want)
        f_want = f0 - g
        f_err = float((f1 - f_want).abs().max()) / max(1.0, float(f_want.abs().max()))
        log("external", terms=len(want), e_ext=f"{want['external']:.4f}",
            e_rel_err=f"{e_err:.3e}", f_rel_err=f"{f_err:.3e}")
        require(set(d1) == set(want), (sorted(d1), sorted(want)))
        require(e_err <= E_TOL, f"external: per-term energies off by {e_err}")
        require(f_err <= F_TOL, f"external: forces off by {f_err}")

        x = torch.as_tensor(pos[0], dtype=torch.float32, device=DEVICE)
        ms_plain = cuda_events_ms(lambda: plain.ef_one(x, None))
        ms_ext = cuda_events_ms(lambda: withext.ef_one(x, None))
        ms_fn = cuda_events_ms(lambda: ext.calculate(x[None], None))
        log("external_time", ef_one_ms=f"{ms_plain:.4f}", ef_one_external_ms=f"{ms_ext:.4f}",
            external_alone_ms=f"{ms_fn:.4f}", added_ms=f"{ms_ext - ms_plain:.4f}")

        emb = os.path.join(td, "emb.npy")
        np.save(emb, np.zeros(mol.numAtoms, int))
        conf = os.path.join(td, "external.yaml")
        with open(conf, "w") as fh:
            yaml.dump({"external": {"module": "torchmd_tpu_torch.external",
                                    "file": potential, "embeddings": emb, **spec}}, fh)
        from torchmd_tpu_torch import run as cli

        out = os.path.join(td, "cli")
        kn.LAUNCHES = kb.LAUNCHES = 0
        summary = cli.main(["--conf", conf] + _cli_argv(
            out, EXTERNAL_STEPS, ["--save-period", str(EXTERNAL_STEPS)]))
        launches = {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}
        traj = np.load(os.path.join(out, "output_0.npy"))
        log("external_cli", steps=summary["steps"],
            steps_per_s=f"{summary['steps_per_sec']:.2f}",
            pair_launches=launches["pair"], bonded_launches=launches["bonded"],
            max_abs_pos=f"{float(np.abs(traj).max()):.3f}")
        require(np.all(np.isfinite(traj)), "external CLI run not finite")
        for k, n in launches.items():
            require(n >= EXTERNAL_STEPS, f"external CLI: {k} launched {n} times")
    return {"ms": ms_plain, "ms_external": ms_ext}


def _production_argv(log_dir, steps, extra=(), precision="single"):
    """The CLI's arguments for thrombin's production protocol: 4 fs, X-H
    bonds by SHAKE/RATTLE, hydrogen masses x PROD_HMR, CSVR at TEMP."""
    d = os.path.join(DATA, MAIN_SYSTEM[0])
    return ["--topology", os.path.join(d, "structure.prmtop"),
            "--forcefield", os.path.join(d, "structure.prmtop"),
            "--coordinates", os.path.join(d, MAIN_SYSTEM[1]),
            "--forceterms", *TERMS, "--cutoff", str(CUTOFF), "--rfa",
            "--timestep", str(PROD_TIMESTEP), "--constraints", "hbonds",
            "--hmr", str(PROD_HMR), "--thermostat", "csvr",
            "--temperature", str(TEMP), "--langevin-temperature", str(TEMP),
            "--precision", precision, "--steps", str(steps),
            "--output-period", str(PROD_PERIOD), "--seed", "1",
            "--device", DEVICE, "--log-dir", log_dir, *extra]


def _production_api(log_dir, precision="single", external=None, thermostat=True):
    """(mol, system, forces, integrator) of the production protocol built
    as the CLI builds it (`run.setup`), stepped through the API."""
    from torchmd_tpu_torch import run as cli
    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.integrator import Integrator

    mol, system, forces = cli.setup(cli.get_args(_production_argv(log_dir, PROD_STEPS,
                                                                  precision=precision)))
    if external is not None:
        forces = Forces(forces.par, terms=TERMS, precision=precision, cutoff=CUTOFF,
                        rfa=RFA, device=DEVICE, external=external)
    forces.compute(system.pos, system.box, system.forces)
    kw = dict(T=TEMP, thermostat="csvr", seed=1) if thermostat else {}
    integ = Integrator(system, forces, PROD_TIMESTEP, constraints="hbonds", **kw)
    return mol, system, forces, integ


def phase_production(api_steps_per_s, thr_profile):
    """Thrombin's production protocol: PROD_STEPS steps through the CLI
    with the counters reset just before and read just after; the same
    system through the API (the constraint count, a timed chunk, a profile
    beside the 2 fs path's, 10 NVE steps against the plain f64 path); the
    SHAKE residual and T of the CLI run; then a C-alpha restraint on the
    card against the f64 CPU version and RESTRAINT_STEPS steps with it."""
    import csv

    import torch

    from torchmd_tpu_torch import run as cli
    from torchmd_tpu_torch.constraints import build_constraint_spec, max_constraint_error
    from torchmd_tpu_torch.external import external_ef
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.restraints import HarmonicPositionalRestraint

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "cli")
        kn.LAUNCHES = kb.LAUNCHES = 0
        summary = cli.main(_production_argv(out, PROD_STEPS,
                                            ["--save-period", str(PROD_STEPS)]))
        launches = {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}
        with open(os.path.join(out, "monitor_0.csv")) as fh:
            rows = list(csv.DictReader(fh))
        traj = np.load(os.path.join(out, "output_0.npy"))

        mol, system, forces, integ = _production_api(os.path.join(td, "api"))
    cs = integ.constraints
    require(cs is not None and cs.settle is None and cs.ncon == PROD_XH,
            f"production constraints: {None if cs is None else cs.ncon} != {PROD_XH}")
    require(len(rows) == PROD_STEPS // PROD_PERIOD, f"production monitor rows {len(rows)}")
    energies = np.array([[float(r[k]) for k in ("epot", "ekin", "etot", "T")] for r in rows])
    require(np.all(np.isfinite(energies)) and np.all(np.isfinite(traj)),
            "production run not finite")
    late = [float(r["T"]) for r in rows if int(r["iter"]) > PROD_STEPS // 2]
    t_late = float(np.mean(late))
    require(abs(t_late - TEMP) <= PROD_T_TOL,
            f"production: mean T {t_late} K over the last half, not {TEMP} +- {PROD_T_TOL}")
    for k, n in launches.items():
        require(n >= PROD_STEPS, f"production: {k} kernel launched {n} < {PROD_STEPS} times")

    # SHAKE's residual at the end: the card's f32 reading and the plain f64
    # one of the same positions
    last = traj[:, :, -1]
    ulp = float(np.spacing(np.float32(np.abs(last).max())))
    err32 = float(max_constraint_error(cs.shake, torch.as_tensor(last, device=DEVICE)))
    cs64 = build_constraint_spec(forces.par, system.masses, "hbonds").shake
    err64 = float(max_constraint_error(cs64, torch.as_tensor(last, dtype=torch.float64)))
    log("production_cli", steps=summary["steps"], seconds=f"{summary['elapsed_s']:.4f}",
        steps_per_s=f"{summary['steps_per_sec']:.2f}",
        ns_per_day=f"{summary['ns_per_day']:.3f}", timestep_fs=PROD_TIMESTEP,
        constraints=cs.ncon, T_last_half=f"{t_late:.3f}",
        shake_residual_f64_A=f"{err64:.3e}", shake_residual_card_f32_A=f"{err32:.3e}",
        f32_ulp_A=f"{ulp:.3e}", pair_launches=launches["pair"],
        bonded_launches=launches["bonded"])
    require(err64 <= PROD_SHAKE_ULPS * ulp,
            f"SHAKE residual {err64} A > {PROD_SHAKE_ULPS} ulps ({ulp} A)")
    require(abs(err32 - err64) <= 2.0 * ulp, f"card SHAKE reading {err32} vs f64 {err64}")

    # the API: a timed chunk at 4 fs beside the 2 fs run, and a profile
    integ.step(niter=WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    integ.step(niter=TIMED_STEPS)
    torch.cuda.synchronize()
    sps4 = TIMED_STEPS / (time.perf_counter() - t0)
    prof4 = profile_water_step(integ, 1.0 / sps4, steps=20, label="production_profile",
                               shares=("pair_", "bonded", "index_add"))
    log("production_vs_2fs", api_4fs_steps_per_s=f"{sps4:.2f}",
        api_4fs_ns_per_day=f"{sps4 * PROD_TIMESTEP * 1e-6 * 86400:.3f}",
        api_2fs_steps_per_s=f"{api_steps_per_s:.2f}",
        api_2fs_ns_per_day=f"{api_steps_per_s * TIMESTEP * 1e-6 * 86400:.3f}",
        cli_4fs_steps_per_s=f"{summary['steps_per_sec']:.2f}",
        device_events_per_step_4fs=f"{prof4[1]:.1f}",
        device_events_per_step_2fs=f"{thr_profile[1]:.1f}",
        device_ms_per_step_4fs=f"{prof4[0]:.4f}", device_ms_per_step_2fs=f"{thr_profile[0]:.4f}")

    # NVE from one state, CSVR off: kernel path (f32) against the plain
    # f64 torch-op path (f64 on the card takes it), 10 steps
    start_pos, start_vel = system.pos[0].copy(), system.vel.copy()
    final = {}
    with tempfile.TemporaryDirectory() as td:
        for precision in ("single", "double"):
            _, s, f, nve = _production_api(td, precision, thermostat=False)
            s.set_positions(start_pos)
            s.set_velocities(start_vel)
            f.compute(s.pos, s.box, s.forces)
            nve.step(niter=10)
            final[precision] = s.pos.astype(np.float64)
            require(precision == "single" or f.path == "torch-ops", f"f64 path {f.path}")
            del f, nve
    dev = float(np.abs(final["single"] - final["double"]).max())
    log("production_nve", steps=10, max_pos_dev_A=dev)
    require(dev <= 1e-3, f"4 fs NVE kernel vs plain f64 positions differ by {dev} A")

    # the restrained leg: C-alpha atoms at k RESTRAINT_K to the start
    ca = np.flatnonzero(np.asarray(mol.name) == "CA")
    ref = mol.coords[ca, :, 0]
    restraint = HarmonicPositionalRestraint(ref, RESTRAINT_K, atom_idx=ca)
    rs = np.random.RandomState(8)
    pos = mol.coords[:, :, 0] + 0.1 * rs.randn(mol.numAtoms, 3)
    ef = external_ef(restraint)
    e32, f32 = ef(torch.as_tensor(pos, dtype=torch.float32, device=DEVICE),
                  torch.zeros(3, dtype=torch.float32, device=DEVICE))
    e64, f64 = ef(torch.as_tensor(pos, dtype=torch.float64), None)
    e_err = abs(float(e32) - float(e64)) / max(1.0, abs(float(e64)))
    f_err = float((f32.cpu().double() - f64).abs().max()) / max(1.0, float(f64.abs().max()))
    with tempfile.TemporaryDirectory() as td:
        _, rsys, rforces, rinteg = _production_api(td, external=restraint)
    d = rforces.compute(pos[None], None, returnDetails=True)[0]
    ext_err = abs(d["external"] - float(e64)) / max(1.0, abs(float(e64)))
    kn.LAUNCHES = kb.LAUNCHES = 0
    ek, ep, T = rinteg.step(niter=RESTRAINT_STEPS)
    torch.cuda.synchronize()
    drift = float(np.abs(rsys.pos[0, ca] - ref).max())
    log("production_restraint", atoms=len(ca), k=RESTRAINT_K, energy=f"{float(e64):.4f}",
        e_rel_err=f"{e_err:.3e}", f_rel_err=f"{f_err:.3e}",
        forces_external_rel_err=f"{ext_err:.3e}", steps=RESTRAINT_STEPS,
        T=f"{T[0]:.3f}", Epot=f"{ep[0]:.4f}", max_ca_displacement_A=f"{drift:.3f}",
        pair_launches=kn.LAUNCHES, bonded_launches=kb.LAUNCHES)
    require(len(ca) > 0, "no C-alpha atoms")
    require(e_err <= E_TOL and ext_err <= E_TOL, f"restraint energy off by {e_err}, {ext_err}")
    require(f_err <= F_TOL, f"restraint forces off by {f_err}")
    require(np.all(np.isfinite(rsys.pos)) and np.isfinite([ek[0], ep[0], T[0]]).all(),
            "restrained run not finite")
    require(min(kn.LAUNCHES, kb.LAUNCHES) >= RESTRAINT_STEPS, "restrained run launches")
    log("production_phase", seconds=f"{time.perf_counter() - t_phase:.2f}")
    return launches, sps4, prof4


def _mc_attempts(integ, baro, system, forces, chunk, count):
    """`count` rounds of `chunk` steps and an attempt: (accepted count, the
    ms of each attempt on the host clock, the first attempt's (positions,
    box, baro.last) before it ran, the boxes before and after each)."""
    import torch

    accepted, ms, first, boxes = 0, [], None, []
    for _ in range(count):
        integ.step(niter=chunk)
        before = (system.pos.copy(), system.box_diag.copy())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = baro.attempt(system, forces)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        accepted += int(acc.sum())
        boxes.append((before[1][0], system.box_diag[0].copy(), bool(acc[0])))
        if first is None:
            first = before + (dict(baro.last),)
    return accepted, ms, first, boxes


def phase_mc_barostat():
    """The Monte Carlo barostat on the NVT water box (the cell kernel, the
    PME spread and gather): an attempt after every MC_CHUNK steps, the
    counters reset just before and read just after; the first attempt's
    two energies against the plain f64 path; SETTLE and the volume after
    the accepted moves; then aniso and membrane moves on the 216 box."""
    import torch

    from torchmd_tpu_torch.barostat import (MonteCarloAnisotropicBarostat,
                                            MonteCarloBarostat,
                                            MonteCarloMembraneBarostat)
    from torchmd_tpu_torch.constraints import max_settle_error
    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import pme as kp
    from torchmd_tpu_torch.systems import System

    t_phase = time.perf_counter()
    mol, par, L = build_water(WATER_N, WATER_SPACING, True)
    vel = maxwell_boltzmann(par.masses, TEMP, 1, seed=3, device=DEVICE, dtype=torch.float32)
    system, forces, integ = _water_integrator(par, mol.coords, vel, L)
    group = np.repeat(np.arange(par.natoms // 4), 4)
    baro = MonteCarloBarostat(MC_PRESSURE, TEMP, group_id=group, seed=MC_SEED)
    integ.step(niter=MC_CHUNK)  # builds the kernels and the cell list
    torch.cuda.synchronize()
    kc.LAUNCHES = kp.SPREAD_LAUNCHES = kp.GATHER_LAUNCHES = 0
    t0 = time.perf_counter()
    accepted, ms, first, _ = _mc_attempts(integ, baro, system, forces, MC_CHUNK,
                                          MC_STEPS // MC_CHUNK)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"cell": kc.LAUNCHES, "pme_spread": kp.SPREAD_LAUNCHES,
                "pme_gather": kp.GATHER_LAUNCHES}
    V = float(np.prod(system.box_diag[0]))
    pos = torch.as_tensor(system.pos[0], dtype=torch.float64, device=DEVICE)
    settle_err = float(max_settle_error(integ.constraints.settle, pos))

    # the first attempt's two states: the kernel path's per-term energies
    # against the plain f64 path's at the Pallas bar, and the attempt's
    # energies equal to the kernel path's sum of them
    par64 = build_water(WATER_N, WATER_SPACING, True, "double")[1]
    f64 = _water_forces(par64, WATER_CUTOFF, "double", plain=True)
    pos0, box0, last = first
    p_new = baro._scale_positions(torch.as_tensor(pos0, dtype=torch.float64, device=DEVICE),
                                  torch.as_tensor(last["scale"], device=DEVICE)[:, None, :])
    errs, sums = [], []
    for key, p, b in (("e_old", pos0, box0), ("e_new", p_new, box0 * last["scale"])):
        dk = forces.compute(p, b, returnDetails=True)[0]
        dp = f64.compute(p, b, returnDetails=True)[0]
        errs += [abs(dk[k] - dp[k]) / max(1.0, abs(dp[k])) for k in dp]
        sums.append(abs(float(last[key][0]) - sum(dk.values()))
                    / max(1.0, max(abs(v) for v in dk.values())))
    e_old, e_new = (float(last[k][0]) for k in ("e_old", "e_new"))
    del f64
    log("mc_barostat", natoms=par.natoms, steps=MC_STEPS, attempts=len(ms),
        accepted=accepted, dv_max_A3=f"{baro.dv_max:.3f}",
        steps_per_s_with_attempts=f"{MC_STEPS / dt:.2f}",
        attempt_ms_median=f"{float(np.median(ms)):.3f}",
        attempt_ms_min_max=f"{min(ms):.3f}/{max(ms):.3f}",
        volume_ratio=f"{V / L**3:.5f}", settle_max_err_A=f"{settle_err:.3e}",
        first_e_old=f"{e_old:.4f}", first_e_new=f"{e_new:.4f}",
        term_rel_err_vs_plain_f64=f"{max(errs):.3e}", attempt_vs_terms=f"{max(sums):.3e}",
        **{f"{k}_launches": v for k, v in launches.items()})
    require(max(errs) <= E_TOL, f"MC states' energies off the plain f64 path by {max(errs)}")
    require(max(sums) <= E_TOL, f"MC attempt's energies off its terms by {max(sums)}")
    require(settle_err <= 1e-3, f"SETTLE error {settle_err} A after the MC moves")
    require(MC_VOLUME_RANGE[0] <= V / L**3 <= MC_VOLUME_RANGE[1], f"volume ratio {V / L**3}")
    require(np.all(np.isfinite(system.pos)), "MC run not finite")
    for k, n in launches.items():
        require(n >= MC_STEPS, f"MC: {k} kernel launched {n} < {MC_STEPS} times")
    del system, forces, integ

    # aniso (x and z) and membrane moves on the 216-water box
    n, spacing, cutoff = SMALL_WATER
    mol, par, L = build_water(n, spacing, False)
    group = np.repeat(np.arange(par.natoms // 4), 4)
    for mode, Baro, kw in (("aniso", MonteCarloAnisotropicBarostat,
                            dict(scale_axes=(True, False, True))),
                           ("membrane", MonteCarloMembraneBarostat, {})):
        forces = _water_forces(par, cutoff)
        s = System(par.natoms, 1, "single")
        s.set_positions(mol.coords)
        s.set_box(np.full(3, L))
        s.set_velocities(maxwell_boltzmann(par.masses, TEMP, 1, seed=4, device=DEVICE,
                                           dtype=torch.float32))
        forces.compute(s.pos, s.box, s.forces)
        small = Integrator(s, forces, TIMESTEP, T=TEMP, thermostat="nhc", tau=WATER_TAU,
                           constraints="settle")
        b = Baro(MC_PRESSURE, TEMP, group_id=group, seed=MC_SEED,
                 dv_max=MC_SMALL_DV * L**3, **kw)
        acc, ms_small, _, boxes = _mc_attempts(small, b, s, forces, MC_SMALL_CHUNK,
                                               MC_SMALL_ATTEMPTS)
        moved = [np.flatnonzero(after != before) for before, after, ok in boxes if ok]
        if mode == "aniso":
            ok = all(len(m) == 1 and m[0] in (0, 2) for m in moved)
        else:
            ok = all(after[0] == after[1] for _, after, _ in boxes) and all(
                list(m) in ([0, 1], [2]) for m in moved)
        log("mc_mode", mode=mode, attempts=MC_SMALL_ATTEMPTS, accepted=acc,
            axes_moved="/".join("".join("xyz"[i] for i in m) for m in moved),
            box=s.box_diag[0].tolist(), attempt_ms_median=f"{float(np.median(ms_small)):.3f}")
        require(acc > 0, f"MC {mode}: no move accepted")
        require(ok, f"MC {mode}: a move changed axes its mode does not name")
        require(np.all(np.isfinite(s.pos)), f"MC {mode} run not finite")
    log("mc_phase", seconds=f"{time.perf_counter() - t_phase:.2f}")
    return launches


CMAP_PRM = """* a CMAP test parameter set
*

ATOMS
MASS 1 A1 12.011

BONDS
A1 A1 300.0 1.5

ANGLES
A1 A1 A1 50.0 109.5

DIHEDRALS
A1 A1 A1 A1 0.20 3 0.0

NONBONDED
A1 0.0 -0.10 1.95

CMAP
A1 A1 A1 A1 A1 A1 A1 A1 {n}

{grid}
END
"""


def phase_cmap():
    """CMAP on the card: a 5-atom chain with one cross-term (a CHARMM .prm
    with a CMAP section on a smooth periodic surface), Forces on the card
    at f32 (the bonded kernel, CMAP by autograd) against the CPU at f64:
    per-term energies and forces at the Pallas bars."""
    from torchmd_tpu_torch.forcefields.ff_charmm import CharmmForcefield
    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.parameters import Parameters

    ang = -np.pi + 2.0 * np.pi * np.arange(CMAP_N) / CMAP_N
    phi, psi = ang[:, None], ang[None, :]
    grid = (np.cos(phi) + 0.7 * np.sin(psi) + 0.3 * np.cos(phi + psi)
            + 0.2 * np.sin(2.0 * psi - phi))
    text = CMAP_PRM.format(n=CMAP_N, grid="\n".join(
        "\n".join(" ".join(f"{v:.10f}" for v in row[k:k + 5]) for k in range(0, CMAP_N, 5))
        for row in grid))
    terms = ["bonds", "angles", "dihedrals", "cmap"]
    mol = Molecule()
    mol.numAtoms = 5
    mol.atomtype = np.array(["A1"] * 5, dtype=object)
    mol.charge = np.zeros(5)
    mol.masses = np.full(5, 12.011)
    mol.bonds = np.array([[i, i + 1] for i in range(4)])
    mol.angles = np.array([[i, i + 1, i + 2] for i in range(3)])
    mol.dihedrals = np.array([[i, i + 1, i + 2, i + 3] for i in range(2)])
    mol.crossterms = np.array([[0, 1, 2, 3, 1, 2, 3, 4]])
    base = np.array([[0.0, 0.0, 0.0], [1.5, 0.0, 0.0], [2.2, 1.3, 0.0],
                     [3.6, 1.5, 1.0], [4.0, 2.6, 1.8]])
    with tempfile.TemporaryDirectory() as td:
        prm = os.path.join(td, "cmap.prm")
        with open(prm, "w") as fh:
            fh.write(text)
        out = {}
        for label, precision, device in (("card", "single", DEVICE),
                                         ("cpu", "double", "cpu")):
            par = Parameters(CharmmForcefield(mol, prm), mol, terms, precision=precision)
            out[label] = Forces(par, terms=terms, precision=precision, device=device)
    rs = np.random.RandomState(11)
    worst_e = worst_f = 0.0
    for _ in range(4):
        pos = (base + 0.15 * rs.randn(5, 3))[None]
        dk = out["card"].compute(pos, None, returnDetails=True)[0]
        fk = out["card"].last_forces[0].double().cpu()
        dp = out["cpu"].compute(pos, None, returnDetails=True)[0]
        fp = out["cpu"].last_forces[0]
        require(set(dk) == set(dp) and dp["cmap"] != 0.0, (sorted(dk), sorted(dp)))
        worst_e = max(worst_e, max(abs(dk[k] - dp[k]) / max(1.0, abs(dp[k])) for k in dp))
        worst_f = max(worst_f, float((fk - fp).abs().max()) / max(1.0, float(fp.abs().max())))
    log("cmap", grid=CMAP_N, path=out["card"].path, cmap_energy=f"{dp['cmap']:.6f}",
        e_rel_err=f"{worst_e:.3e}", f_rel_err=f"{worst_f:.3e}")
    require(out["card"].path == "kernels", f"CMAP card path {out['card'].path}")
    require(worst_e <= E_TOL, f"CMAP energies on the card off by {worst_e}")
    require(worst_f <= F_TOL, f"CMAP forces on the card off by {worst_f}")


def phase_mts_thrombin(prod_sps, prod_profile):
    """Thrombin's production protocol with r-RESPA (`--mts MTS_N`) through
    the CLI: MTS_STEPS outer steps with the counters reset just before and
    read just after (the bonded kernel MTS_N times an outer step in its
    own buffer plus once a chunk and once at the start, the pair kernel
    once an outer step plus once at the start), the mean T of the last
    half and SHAKE's residual; then the same system through the API, a
    timed chunk and a profile beside the production phase's."""
    import csv

    import torch

    from torchmd_tpu_torch import run as cli
    from torchmd_tpu_torch.constraints import build_constraint_spec, max_constraint_error
    from torchmd_tpu_torch.integrator import Integrator
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn

    t_phase = time.perf_counter()
    extra = ["--mts", str(MTS_N), "--save-period", str(MTS_STEPS)]
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "cli")
        kn.LAUNCHES = kb.LAUNCHES = 0
        summary = cli.main(_production_argv(out, MTS_STEPS, extra))
        launches = {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}
        with open(os.path.join(out, "monitor_0.csv")) as fh:
            rows = list(csv.DictReader(fh))
        traj = np.load(os.path.join(out, "output_0.npy"))
        mol, system, forces, _ = _production_api(os.path.join(td, "api"))
    chunks = MTS_STEPS // PROD_PERIOD
    want = {"pair": MTS_STEPS + 1, "bonded": MTS_N * MTS_STEPS + chunks + 1}
    energies = np.array([[float(r[k]) for k in ("epot", "ekin", "T")] for r in rows])
    t_late = float(np.mean([float(r["T"]) for r in rows if int(r["iter"]) > MTS_STEPS // 2]))
    last = traj[:, :, -1]
    ulp = float(np.spacing(np.float32(np.abs(last).max())))
    cs64 = build_constraint_spec(forces.par, system.masses, "hbonds").shake
    err64 = float(max_constraint_error(cs64, torch.as_tensor(last, dtype=torch.float64)))
    log("mts_thrombin_cli", mts=MTS_N, steps=summary["steps"],
        seconds=f"{summary['elapsed_s']:.4f}", steps_per_s=f"{summary['steps_per_sec']:.2f}",
        ns_per_day=f"{summary['ns_per_day']:.3f}", T_last_half=f"{t_late:.3f}",
        shake_residual_f64_A=f"{err64:.3e}", f32_ulp_A=f"{ulp:.3e}",
        pair_launches=launches["pair"], bonded_launches=launches["bonded"],
        pair_expected=want["pair"], bonded_expected=want["bonded"])
    require(len(rows) == chunks and np.all(np.isfinite(energies)) and np.all(np.isfinite(traj)),
            "r-RESPA thrombin run not finite")
    require(launches == want, f"r-RESPA launches {launches}, want {want} (a tier evaluated "
            "twice or skipped)")
    require(abs(t_late - TEMP) <= PROD_T_TOL,
            f"r-RESPA: mean T {t_late} K over the last half, not {TEMP} +- {PROD_T_TOL}")
    require(err64 <= PROD_SHAKE_ULPS * ulp, f"r-RESPA SHAKE residual {err64} A > "
            f"{PROD_SHAKE_ULPS} ulps ({ulp} A)")

    # the API beside the production phase's 4 fs numbers (same call)
    forces.compute(system.pos, system.box, system.forces)
    integ = Integrator(system, forces, PROD_TIMESTEP, constraints="hbonds", T=TEMP,
                       thermostat="csvr", seed=1, mts=MTS_N)
    integ.step(niter=WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    integ.step(niter=MTS_TIMED)
    torch.cuda.synchronize()
    sps = MTS_TIMED / (time.perf_counter() - t0)
    prof = profile_water_step(integ, 1.0 / sps, steps=20, label="mts_thrombin_profile",
                              shares=("pair_", "bonded", "index_add"))
    log("mts_vs_production", api_mts_steps_per_s=f"{sps:.2f}",
        api_mts_ns_per_day=f"{sps * PROD_TIMESTEP * 1e-6 * 86400:.3f}",
        api_production_steps_per_s=f"{prod_sps:.2f}",
        device_events_per_step_mts=f"{prof[1]:.1f}",
        device_events_per_step_production=f"{prod_profile[1]:.1f}",
        device_ms_per_step_mts=f"{prof[0]:.4f}",
        device_ms_per_step_production=f"{prod_profile[0]:.4f}",
        seconds=f"{time.perf_counter() - t_phase:.2f}")
    return launches


def build_spcfw(n, precision="single"):
    """(mol, par, box edge) of scripts/bench_mts.py's box: n^3 flexible
    SPC/Fw waters on the 3.104 A lattice, seed-0 jitter, GROMACS topology
    through the port's reader."""
    from torchmd_tpu_torch.forcefields import ForceField
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.parameters import Parameters

    with tempfile.TemporaryDirectory() as td:
        top = os.path.join(td, "spcfw.top")
        with open(top, "w") as fh:
            fh.write(SPCFW_TOP.format(nw=n**3))
        mol = Molecule(top)
        ff = ForceField.create(mol, top)
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)
    rs = np.random.RandomState(0)
    w = np.array([[0.000, 0.000, 0.000], [1.012, 0.000, 0.000], [-0.399, 0.930, 0.000]])
    mol.coords = np.concatenate([w + g * WATER_SPACING + 0.8 + rs.randn(3) * 0.05
                                 for g in grid])[:, :, None]
    L = n * WATER_SPACING
    mol.box = np.full((3, 1), L)
    terms = ["bonds", "angles", "lj", "electrostatics"]
    return mol, Parameters(ff, mol, terms, precision=precision), L


def spcfw_column_check(forces, pos_np, box_np):
    """The column kernel's instance on the SPC/Fw path (no virial,
    reaction field) on the box's own state: f32 on the card against its
    plain version at f64 on the same inputs at the Pallas bars; its time,
    the plain version's (f32) and the bound at these shapes."""
    import torch

    from torchmd_tpu_torch.columns import ColumnKernel
    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import column as kcol

    ck = forces._cell_kernel
    require(isinstance(ck, ColumnKernel), f"SPC/Fw on {type(ck).__name__}, not the column "
            "kernel the defaults of Forces pick on the card")
    p32 = torch.as_tensor(pos_np, dtype=torch.float32, device=DEVICE)
    b32 = torch.as_tensor(box_np, dtype=torch.float32, device=DEVICE)
    p64, b64 = p32.double(), b32.double()
    data, cfg, ccfg = ck.data, ck.cfg, ck.ccfg
    st = ck.build(p32, b32)
    require(not bool(st.overflow), "SPC/Fw column structure overflow")
    st64 = st._replace(jzshift=st.jzshift.double(), ref_pos=st.ref_pos.double())
    d64 = kc.CellData(**{k: (v.double() if torch.is_tensor(v) and v.is_floating_point()
                             else v) for k, v in data._asdict().items()})
    pot_k, f_k = kcol.column_energy_forces(data, cfg, ccfg, st, p32, b32)
    pot_p, f_p = kcol.column_reference(d64, cfg, ccfg, st64, p64, b64)
    torch.cuda.synchronize()
    err = _compare("spcfw/column_rf", pot_k, f_k, pot_p, f_p)
    npairs = _water_pair_count(data, p32, b32, MTS_WATER_CUTOFF)
    t = dict(
        max_abs_err=err,
        ms=cuda_events_ms(lambda: kcol.column_energy_forces(data, cfg, ccfg, st, p32, b32)),
        plain_ms=cuda_events_ms(lambda: kcol.column_reference(data, cfg, ccfg, st, p32, b32),
                                calls=PLAIN_CALLS, warmup=1),
        bound=bound(tensor_bytes(p32, data.q, data.sig, data.eps, data.excl, st.islot,
                                 st.jslot, st.jzshift, st.wstart, p32),
                    pair_flops(npairs, "rfa")))
    log("mts_water_kernel", kernel="column_rf", natoms=p32.shape[0], with_virial=False,
        elec="reaction-field", ncols=ccfg.ncols, pairs_in_cutoff=npairs,
        max_abs_err=err, ms=f"{t['ms']:.4f}", plain_ms=f"{t['plain_ms']:.4f}",
        bound_ms=f"{t['bound'][0]:.5f}", bound_by=t["bound"][1])
    return t


def _drift_fit(t_fs, h, natoms):
    """(slope of a least-squares line through H(t), kcal/mol/atom/ns;
    rms of H about that line, kcal/mol)."""
    t_fs, h = np.asarray(t_fs, np.float64), np.asarray(h, np.float64)
    a, b = np.polyfit(t_fs, h, 1)
    return a / natoms * 1e6, float(np.sqrt(np.mean((h - (a * t_fs + b)) ** 2)))


def phase_mts_water():
    """scripts/bench_mts.py's comparison in the port: the SPC/Fw box on
    the defaults of Forces (the column kernel's no-virial reaction-field
    instance, checked against its plain f64 version on the box's state),
    MTS_WATER_WARM steps of CSVR at 0.5 fs from the lattice (the bench's
    warm-up), then from that one state NVE runs over MTS_WATER_FS fs
    (MTS_WATER_RUNS): mts 1 at 0.5 fs, mts 4 at 2 fs and plain VV at
    2 fs, the bench's three, and as witnesses of where the energy error
    comes from mts 2 at a 1 fs outer step, mts 8 at 2 fs (a 0.25 fs inner
    step) and VV at 1 fs. The mts runs enter with the slow tier's forces,
    so without the one-time dt/2 F_bonded kick of entering with totals.
    Each run's ns/day, its drift (the slope of a line through the total
    energy sampled every MTS_WATER_SAMPLE_FS fs) and the rms about it,
    and launches. mts 4 must stay finite, launch the pair kernel once
    and the bonded kernel 4 times an outer step (once more a chunk), give
    more ns/day than mts 1; mts 1 and mts 4 must keep their drifts within
    MTS_WATER_DRIFT_MAX and their rms within MTS_WATER_RMS_MAX."""
    import torch

    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import column as kcol
    from torchmd_tpu_torch.systems import System

    mol, par, L = build_spcfw(MTS_WATER_N)
    terms = ["bonds", "angles", "lj", "electrostatics"]
    m = np.asarray(par.masses, np.float64).reshape(1, -1, 1)
    natoms = mol.numAtoms

    def setup(pos, vel):
        forces = Forces(par, terms=terms, precision="single", cutoff=MTS_WATER_CUTOFF,
                        rfa=True, device=DEVICE)
        system = System(natoms, 1, "single")
        system.set_positions(pos)
        system.set_box(mol.box)
        system.set_velocities(vel)
        epot = forces.compute(system.pos, system.box, system.forces)[0]
        return forces, system, epot

    forces, system, _ = setup(mol.coords, maxwell_boltzmann(
        par.masses, MTS_WATER_T, 1, seed=1, device=DEVICE, dtype=torch.float32))
    warm = Integrator(system, forces, 0.5, T=MTS_WATER_T, thermostat="csvr", tau=20.0)
    t0 = time.perf_counter()
    _, _, T = warm.step(niter=MTS_WATER_WARM)
    log("mts_water_warmup", steps=MTS_WATER_WARM, timestep_fs=0.5, T=f"{T[0]:.3f}",
        seconds=f"{time.perf_counter() - t0:.2f}")
    start = (system.pos[0].copy(), system.vel.copy())
    kernel_t = spcfw_column_check(forces, start[0], mol.box.reshape(-1))
    del forces, warm
    out = {}
    for label, mts, dt in MTS_WATER_RUNS:
        forces, system, e0 = setup(*start)
        h = [e0 + float(0.5 * (m * system.vel.astype(np.float64) ** 2).sum())]
        kern = forces._cell_kernel
        if mts:
            # enter with the slow tier's forces, as a running r-RESPA chunk does
            pos = torch.as_tensor(system.pos[0], device=DEVICE)
            box = torch.as_tensor(system.box_diag[0], dtype=torch.float32, device=DEVICE)
            slow = forces.mts_tiers()[1]
            system.set_forces(slow(pos, box, kern.build(pos, box))[1].cpu().numpy()[None])
        integ = Integrator(system, forces, dt, mts=mts)
        steps = int(round(MTS_WATER_FS / dt))
        chunk = int(round(MTS_WATER_SAMPLE_FS / dt))
        torch.cuda.synchronize()
        kc.LAUNCHES = kcol.LAUNCHES = kb.LAUNCHES = 0
        t0 = time.perf_counter()
        for _ in range(steps // chunk):
            ek, ep, _ = integ.step(niter=chunk)
            h.append(float(ek[0] + ep[0]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nsday = MTS_WATER_FS * 1e-6 / wall * 86400
        finite = bool(np.isfinite(h).all() and np.isfinite(system.pos).all())
        slope, rms = _drift_fit(np.arange(len(h)) * MTS_WATER_SAMPLE_FS, h, natoms) \
            if finite else (float("nan"), float("nan"))
        out[label] = dict(nsday=nsday, finite=finite, slope=slope, rms=rms, pair=kcol.LAUNCHES,
                          bonded=kb.LAUNCHES, steps=steps, chunks=steps // chunk)
        log("mts_water", run=label, natoms=natoms, kernel=type(kern).__name__,
            mts=mts, timestep_fs=dt, inner_fs=dt / (mts or 1), steps=steps,
            seconds=f"{wall:.4f}", ns_per_day=f"{nsday:.3f}",
            energy_change_kcal=f"{h[-1] - h[0]:.3f}",
            drift_kcal_per_atom_ns=f"{slope:.3f}", rms_about_fit_kcal=f"{rms:.3f}",
            finite=finite, column_launches=kcol.LAUNCHES, cell_launches=kc.LAUNCHES,
            bonded_launches=kb.LAUNCHES)
        del forces, integ
        torch.cuda.empty_cache()
    m1, m4 = out["mts1_0.5fs"], out["mts4_2fs"]
    require(m4["finite"], "mts 4 at 2 fs did not stay finite")
    require(m4["pair"] == m4["steps"] and m4["bonded"] == 4 * m4["steps"] + m4["chunks"],
            f"mts 4 launches: pair {m4['pair']}, bonded {m4['bonded']}")
    require(m4["nsday"] > m1["nsday"], f"mts 4 gave {m4['nsday']} ns/day, mts 1 "
            f"{m1['nsday']}: no payoff")
    for label, limit in MTS_WATER_DRIFT_MAX.items():
        require(abs(out[label]["slope"]) <= limit,
                f"{label}: drift {out[label]['slope']} kcal/mol/atom/ns beyond {limit}")
    for label, limit in MTS_WATER_RMS_MAX.items():
        require(out[label]["rms"] <= limit,
                f"{label}: energy rms {out[label]['rms']} kcal/mol about its fit beyond {limit}")
    log("mts_water_drift", **{k: f"{v['slope']:.3f}" for k, v in out.items()})
    log("mts_water_rms", **{k: f"{v['rms']:.3f}" for k, v in out.items()})
    return {"column_rf": m4["pair"]}, kernel_t


def phase_recip_tier(water_sps):
    """The 62.5k-site box's NVT phase with the reciprocal tier
    (`mts_recip=RECIP_R`): RECIP_STEPS steps with the counters reset just
    before and read just after (the cell kernel once a step, the PME
    spread and gather once every RECIP_R steps plus once a chunk), steps/s
    beside the NVT phase's; then NVE legs with and without the tier from
    one state (bench_waterbox.py --phases nve --mts-recip 2's drift)."""
    import torch

    from torchmd_tpu_torch.constraints import max_settle_error
    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import pme as kp
    from torchmd_tpu_torch.systems import System

    mol, par, L = build_water(WATER_N, WATER_SPACING, True)
    vel = maxwell_boltzmann(par.masses, TEMP, 1, seed=3, device=DEVICE, dtype=torch.float32)

    def integrator(pos, v, recip, thermostat=True):
        forces = _water_forces(par, WATER_CUTOFF)
        system = System(par.natoms, 1, "single")
        system.set_positions(pos)
        system.set_box(np.full(3, L))
        system.set_velocities(v)
        forces.compute(system.pos, system.box, system.forces)
        kw = dict(T=TEMP, thermostat="nhc", tau=WATER_TAU) if thermostat else {}
        return system, forces, Integrator(system, forces, TIMESTEP, constraints="settle",
                                          mts_recip=recip, **kw)

    system, forces, integ = integrator(mol.coords, vel, RECIP_R)
    integ.step(niter=WATER_WARMUP)
    torch.cuda.synchronize()
    kc.LAUNCHES = kp.SPREAD_LAUNCHES = kp.GATHER_LAUNCHES = 0
    t0 = time.perf_counter()
    done = 0
    while done < RECIP_STEPS:
        Ekin, Epot, T = integ.step(niter=WATER_CHUNK)
        done += WATER_CHUNK
    torch.cuda.synchronize()
    sps = done / (time.perf_counter() - t0)
    launches = {"cell": kc.LAUNCHES, "pme_spread": kp.SPREAD_LAUNCHES,
                "pme_gather": kp.GATHER_LAUNCHES}
    chunks = done // WATER_CHUNK
    want = {"cell": done, "pme_spread": done // RECIP_R + chunks,
            "pme_gather": done // RECIP_R + chunks}
    pos = torch.as_tensor(system.pos[0], dtype=torch.float64, device=DEVICE)
    settle_err = float(max_settle_error(integ.constraints.settle, pos))
    log("recip_tier", mts_recip=RECIP_R, steps=done, steps_per_s=f"{sps:.2f}",
        nvt_steps_per_s=f"{water_sps:.2f}", speedup=f"{sps / water_sps:.3f}",
        T=f"{T[0]:.3f}", Epot=f"{Epot[0]:.4f}", settle_max_err_A=settle_err,
        **{f"{k}_launches": v for k, v in launches.items()},
        **{f"{k}_expected": v for k, v in want.items()})
    require(launches == want, f"reciprocal-tier launches {launches}, want {want}")
    require(np.all(np.isfinite(system.pos)) and np.isfinite([T[0], Epot[0]]).all(),
            "reciprocal-tier run not finite")
    require(settle_err < 1e-3, f"SETTLE error {settle_err} A")
    s_pos, s_vel = system.pos[0].copy(), system.vel.copy()
    profile_water_step(integ, 1.0 / sps, label="recip_profile")
    del forces, integ
    drift = {}
    for label, recip in (("plain", None), ("recip2", RECIP_R)):
        s, f, it = integrator(s_pos, s_vel, recip, thermostat=False)
        ek, ep, _ = it.step(niter=RECIP_R)
        e0 = float(ek[0] + ep[0])
        ek, ep, _ = it.step(niter=RECIP_NVE_STEPS)
        drift[label] = (float(ek[0] + ep[0]) - e0) / par.natoms / (
            RECIP_NVE_STEPS * TIMESTEP * 1e-6)
        del s, f, it
        torch.cuda.empty_cache()
    log("recip_tier_nve", steps=RECIP_NVE_STEPS,
        drift_kcal_per_atom_ns_plain=f"{drift['plain']:.4f}",
        drift_kcal_per_atom_ns_recip=f"{drift['recip2']:.4f}")
    require(np.isfinite(list(drift.values())).all(), f"NVE drifts {drift}")
    return launches


def _alanine_argv(log_dir, steps, precision="single"):
    d = os.path.join(DATA, ALA_SYSTEM)
    return ["--topology", os.path.join(d, "structure.prmtop"),
            "--forcefield", os.path.join(d, "structure.prmtop"),
            "--coordinates", os.path.join(d, "input.coor"),
            "--extended_system", os.path.join(d, "input.xsc"),
            "--forceterms", *TERMS, "--cutoff", str(ALA_CUTOFF),
            "--switch_dist", str(ALA_SWITCH), "--elec", "ewald",
            "--timestep", str(PROD_TIMESTEP), "--constraints", "hbonds",
            "--hmr", str(PROD_HMR), "--thermostat", "nhc", "--temperature", str(TEMP),
            "--langevin-temperature", str(TEMP), "--pressure", "1",
            "--barostat-mode", "mtk", "--precision", precision, "--steps", str(steps),
            "--output-period", str(min(ALA_PERIOD, steps)), "--save-period", str(steps),
            "--seed", "1",
            "--device", DEVICE, "--log-dir", log_dir]


def phase_alanine_mtk():
    """The alanine dipeptide box under MTK with SHAKE through the CLI: the
    dense MTK scan on the exact Ewald sum (688 < 4,096 atoms), ALA_STEPS
    steps at 4 fs; the volume within NPT_VOLUME_RANGE. Through the API
    from the CLI's set-up: ALA_CHECK_STEPS steps at f32 against the f64
    torch-op path on the card (positions within ALA_POS_TOL A), with every
    kernel counter still 0 after the f32 steps (the path launches no CUDA
    kernel); the SHAKE virial's f32 value (relative positions) against
    f64 within ALA_VIRIAL_TOL of its magnitude, the absolute-position
    form's f32 error beside it."""
    import csv

    import torch

    from torchmd_tpu_torch import run as cli
    from torchmd_tpu_torch.barostat import MTKBarostat
    from torchmd_tpu_torch.constraints import (apply_position_constraints,
                                               build_constraint_spec, constraint_virial)
    from torchmd_tpu_torch.ewald import EwaldRecip
    from torchmd_tpu_torch.integrator import Integrator
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import column as kcol
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.ops import pme as kp

    def counters():
        return (kn.LAUNCHES, kb.LAUNCHES, kc.LAUNCHES, kcol.LAUNCHES,
                kp.SPREAD_LAUNCHES, kp.GATHER_LAUNCHES)

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "cli")
        summary = cli.main(_alanine_argv(out, ALA_STEPS)
                           + ["--checkpoint-period", str(ALA_STEPS)])
        with open(os.path.join(out, "monitor_0.csv")) as fh:
            rows = list(csv.DictReader(fh))
        box_end = np.load(os.path.join(out, "output.chk"))["box"][0].diagonal()
        final = {}
        for precision in ("single", "double"):
            args = cli.get_args(_alanine_argv(os.path.join(td, precision), ALA_CHECK_STEPS,
                                              precision))
            _, system, forces = cli.setup(args)
            forces.compute(system.pos, system.box, system.forces)
            v0 = float(np.prod(system.box_diag[0]))
            integ = Integrator(system, forces, PROD_TIMESTEP, T=TEMP, thermostat="nhc",
                               constraints="hbonds", seed=1,
                               barostat=MTKBarostat(1.0, TEMP))
            n0 = counters()
            integ.step(niter=ALA_CHECK_STEPS)
            torch.cuda.synchronize()
            final[precision] = (system, forces, integ, counters() != n0)
    T = np.array([float(r["T"]) for r in rows])
    sys32, forces32, integ32, launched = final["single"]
    ratio = float(np.prod(box_end)) / v0
    dev = float(np.abs(sys32.pos.astype(np.float64) - final["double"][0].pos).max())
    log("alanine_mtk_cli", natoms=sys32.natoms, steps=summary["steps"],
        seconds=f"{summary['elapsed_s']:.4f}", steps_per_s=f"{summary['steps_per_sec']:.2f}",
        ns_per_day=f"{summary['ns_per_day']:.3f}", T_mean=f"{T.mean():.3f}",
        volume_ratio=f"{ratio:.4f}", recip=type(forces32._ewald).__name__,
        ewald_kvectors=forces32._ewald.nkvec(), dense_path=not integ32._use_cell,
        constraints=integ32.constraints.ncon)
    require(isinstance(forces32._ewald, EwaldRecip) and not integ32._use_cell,
            "the alanine box should take the dense MTK scan with the exact Ewald sum")
    require(np.all(np.isfinite(T)), "alanine MTK run not finite")
    require(NPT_VOLUME_RANGE[0] < ratio < NPT_VOLUME_RANGE[1],
            f"alanine MTK volume ratio {ratio}")
    log("alanine_mtk_check", steps=ALA_CHECK_STEPS, max_pos_dev_A=dev,
        f32_launched_a_kernel=launched)
    require(dev <= ALA_POS_TOL, f"dense MTK f32 vs f64 positions differ by {dev} A")
    require(not launched, "the dense MTK path launched a CUDA kernel")

    # the SHAKE virial: one projection of a box-scaled drift, f32 and f64
    m64 = torch.as_tensor(sys32.masses, dtype=torch.float64, device=DEVICE).reshape(-1, 1)
    cs64 = build_constraint_spec(forces32.par, m64.cpu().numpy(), "hbonds", device=DEVICE)
    pos = torch.as_tensor(final["double"][0].pos, device=DEVICE)
    vel = torch.as_tensor(final["double"][0].vel, dtype=torch.float64, device=DEVICE)
    drift = torch.full((1, 1, 3), PROD_TIMESTEP / 48.88821, dtype=torch.float64, device=DEVICE)
    ref = pos * 1.0001
    pos_c = apply_position_constraints(cs64, ref + vel * drift, ref)
    delta = pos_c - (ref + vel * drift)
    vir64 = constraint_virial(cs64, m64, delta, drift, pos_c)
    vir32 = constraint_virial(integ32.constraints, m64.float(), delta.float(), drift.float(),
                              pos_c.float()).double()
    f32 = 2.0 * m64.float() * delta.float() / drift.float() ** 2
    abs32 = (f32 * pos_c.float()).sum(-2).double()
    scale = float(vir64.abs().max())
    rel = float((vir32 - vir64).abs().max()) / scale
    rel_abs = float((abs32 - vir64).abs().max()) / scale
    log("alanine_shake_virial", vir64=vir64.cpu().numpy().round(4).tolist(),
        f32_relative_form_err=f"{rel:.3e}", f32_absolute_form_err=f"{rel_abs:.3e}",
        seconds=f"{time.perf_counter() - t_phase:.2f}")
    require(rel <= ALA_VIRIAL_TOL, f"SHAKE virial f32 off by {rel} of its magnitude")


def phase_verlet(api_steps_per_s):
    """Thrombin on Verlet lists (Forces(kernel="verlet"), no box, cutoff
    7.3 A): per-term energies and forces against the dense pair kernel's
    at the Pallas bars, then VERLET_STEPS timed Langevin steps at 2 fs,
    the list's rebuilds and capacity."""
    import torch

    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.neighbors import VerletKernel
    from torchmd_tpu_torch.systems import System

    mol, par, dense = _thrombin_forces(DEVICE)
    _, _, verlet = _thrombin_forces(DEVICE, kernel="verlet")
    pos = mol.coords[:, :, 0][None]
    fd, fv = np.zeros((1, mol.numAtoms, 3)), np.zeros((1, mol.numAtoms, 3))
    ed = dense.compute(pos, None, fd, returnDetails=True)[0]
    ev = verlet.compute(pos, None, fv, returnDetails=True)[0]
    kern = verlet._cell_kernel
    require(isinstance(kern, VerletKernel), f"kernel='verlet' built {type(kern).__name__}")
    worst_e = max(abs(ev[k] - w) / max(1.0, abs(w)) for k, w in ed.items())
    f_err = float(np.abs(fv - fd).max()) / max(1.0, float(np.abs(fd).max()))
    system = System(mol.numAtoms, 1, "single")
    system.set_positions(mol.coords)
    system.set_velocities(maxwell_boltzmann(par.masses, TEMP, 1, seed=1, device=DEVICE,
                                            dtype=torch.float32))
    verlet.compute(system.pos, None, system.forces)
    integ = Integrator(system, verlet, TIMESTEP, gamma=GAMMA, T=TEMP, seed=2)
    integ.step(niter=VERLET_WARMUP)
    torch.cuda.synchronize()
    r0 = verlet._cell_kernel.rebuilds
    t0 = time.perf_counter()
    Ekin, Epot, T = integ.step(niter=VERLET_STEPS)
    torch.cuda.synchronize()
    sps = VERLET_STEPS / (time.perf_counter() - t0)
    log("verlet", natoms=mol.numAtoms, capacity=verlet._cell_kernel.capacity,
        e_rel_err=f"{worst_e:.3e}", f_rel_err=f"{f_err:.3e}", steps=VERLET_STEPS,
        steps_per_s=f"{sps:.2f}", rebuilds=verlet._cell_kernel.rebuilds - r0,
        overflow_retries=integ.overflow_retries, T=f"{T[0]:.3f}", Epot=f"{Epot[0]:.4f}",
        dense_kernel_steps_per_s=f"{api_steps_per_s:.2f}")
    require(worst_e <= E_TOL, f"Verlet energies off the dense kernel's by {worst_e}")
    require(f_err <= F_TOL, f"Verlet forces off the dense kernel's by {f_err}")
    require(np.all(np.isfinite(system.pos)) and np.isfinite([T[0], Epot[0]]).all(),
            "Verlet run not finite")


def _brute_rows(pos, excl, rows, rc, chunk=VA_SCAN_ROWS):
    """Each row's neighbours within rc, exclusions removed, in ascending
    index order (numpy lists), by a scan of the rows against every atom
    in chunks, no box; |d|^2 summed over x, y, z in that order."""
    import torch

    n, rc2, out = pos.shape[0], rc * rc, []
    allj = torch.arange(n, device=pos.device)
    for c0 in range(0, len(rows), chunk):
        r = torch.as_tensor(rows[c0:c0 + chunk], device=pos.device)
        d = pos[r, None, :] - pos[None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        ok = (d2 <= rc2) & (allj[None, :] != r[:, None])
        ex = excl[r]
        ok[torch.arange(len(r), device=pos.device)[:, None].expand_as(ex)[ex < n],
           ex[ex < n]] = False
        out += [np.flatnonzero(m) for m in ok.cpu().numpy()]
    return out


def phase_verlet_auto(smi):
    """The automatic Verlet choice at forces.VERLET_AUTO_N: the alanine
    box tiled VA_TILE (103,200 atoms) with its box dropped, through
    Forces(kernel="auto") on the card at f32 (Verlet lists built by
    cells, torch ops; the bonded kernel) and the Integrator at 2 fs with
    hbonds and Langevin at VA_GAMMA ps^-1. Gates: the path is "verlet",
    the dense mask never built and Parameters.get_exclusions(fullarray=
    True) never called from Parameters on; VA_ROWS seeded rows of the f64
    list equal a brute-force scan, no overflow; the f32 per-term energies
    and forces against the f64 Verlet path on the card at the same
    (f32) positions at the Pallas bars; the timed steps finite with a mean T within VA_T_TOL of TEMP,
    the bonded kernel launched every step and the pair kernel never.
    Returns the timed run's launches."""
    import torch

    from torchmd_tpu_torch import forces as tforces
    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.neighbors import VerletKernel
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.parameters import Parameters
    from torchmd_tpu_torch.systems import System

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dense_calls = []
    get = Parameters.get_exclusions

    def counted(self, types=("bonds", "angles", "1-4"), fullarray=False):
        if fullarray:
            dense_calls.append(types)
        return get(self, types=types, fullarray=fullarray)

    Parameters.get_exclusions = counted
    try:
        mol, par = halo_system(VA_TILE)
        n = mol.numAtoms
        require(n >= tforces.VERLET_AUTO_N, (n, tforces.VERLET_AUTO_N))
        pos0 = mol.coords[:, :, 0]
        # the positions as the f32 path holds them: the f64 path at the
        # same inputs (rounding 118 A coordinates to f32 alone moves the
        # bonded forces by ~1e-4 of max |F|)
        pos_in = pos0.astype(np.float32).astype(np.float64)
        kw = dict(terms=TERMS, cutoff=ALA_CUTOFF, switch_dist=ALA_SWITCH, rfa=True,
                  device=DEVICE)
        forces = Forces(par, precision="single", **kw)
        frc32 = np.zeros((1, n, 3))
        e32 = forces.compute(pos_in[None], None, frc32, returnDetails=True)[0]
        kern = forces._cell_kernel
        require(forces.nb_path == "verlet" and isinstance(kern, VerletKernel)
                and kern.binned, ("verlet_auto path", forces.nb_path, type(kern).__name__))
        # the f64 Verlet path on the card (torch ops), the same positions
        f64 = Forces(par, precision="double", **kw)
        frc64 = np.zeros((1, n, 3))
        e64 = f64.compute(pos_in[None], None, frc64, returnDetails=True)[0]
        k64 = f64._cell_kernel
        require(f64.nb_path == "verlet" and k64.binned, "f64 verlet_auto path")
        worst_e = max(abs(e32[k] - w) / max(1.0, abs(w)) for k, w in e64.items())
        f_err = float(np.abs(frc32 - frc64).max()) / max(1.0, float(np.abs(frc64).max()))
        # VA_ROWS seeded rows of the f64 list against a brute-force scan
        p64 = torch.as_tensor(pos0, dtype=torch.float64, device=DEVICE)
        nl64 = k64.build(p64)
        rows = np.sort(np.random.RandomState(0).choice(n, VA_ROWS, replace=False))
        want = _brute_rows(p64, k64.excl, rows, k64.vcfg.rc)
        got = nl64.nbr[torch.as_tensor(rows, device=DEVICE)].cpu().numpy()
        bad = [int(r) for r, g, w in zip(rows, got, want) if not np.array_equal(g[g < n], w)]
        nbrs = int(sum(len(w) for w in want))
        overflow64 = bool(nl64.overflow)
        del f64, k64, nl64, p64
        torch.cuda.empty_cache()
        # one build and one evaluation at f32, device ms by CUDA events
        p32 = torch.as_tensor(pos0, dtype=torch.float32, device=DEVICE)
        build_ms = cuda_events_ms(lambda: kern.build(p32), calls=5, warmup=1)
        nl = kern.build(p32)
        eval_ms = cuda_events_ms(lambda: forces.ef_one(p32, None, nl), calls=5, warmup=1)
        del nl
        # the dynamics
        system = System(n, 1, "single")
        system.set_positions(mol.coords)
        system.set_velocities(maxwell_boltzmann(par.masses, TEMP, 1, seed=1, device=DEVICE,
                                                dtype=torch.float32))
        integ = Integrator(system, forces, TIMESTEP, gamma=VA_GAMMA, T=TEMP, seed=2,
                           constraints="hbonds")
        require(integ._use_verlet, "the Integrator did not take the Verlet path")
        integ.step(niter=VA_WARMUP)
        torch.cuda.synchronize()
        r0 = forces._cell_kernel.rebuilds
        kn.LAUNCHES = kb.LAUNCHES = 0
        t0 = time.perf_counter()
        temps = []
        for _ in range(VA_STEPS // VA_CHUNK):
            Ekin, Epot, T = integ.step(niter=VA_CHUNK)
            temps.append(float(T[0]))
        torch.cuda.synchronize()
        sps = VA_STEPS / (time.perf_counter() - t0)
        launches = {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}
        kern_rebuilds = forces._cell_kernel.rebuilds - r0
    finally:
        Parameters.get_exclusions = get
    t_mean = float(np.mean(temps))
    log("verlet_auto", natoms=n, path=forces.nb_path, capacity=forces._cell_kernel.capacity,
        grid_bound=forces._cell_kernel.grid.ncells, build_ms=f"{build_ms:.3f}",
        eval_ms=f"{eval_ms:.3f}", steps=VA_STEPS, steps_per_s=f"{sps:.2f}",
        rebuilds=kern_rebuilds, overflow_retries=integ.overflow_retries,
        T_mean=f"{t_mean:.2f}", T_last=f"{temps[-1]:.2f}", Epot=f"{Epot[0]:.2f}",
        e_rel_err=f"{worst_e:.3e}", f_rel_err=f"{f_err:.3e}", scan_rows=VA_ROWS,
        scan_neighbours=nbrs, scan_mismatches=len(bad), f64_overflow=overflow64,
        pair_launches=launches["pair"], bonded_launches=launches["bonded"],
        fullarray_calls=len(dense_calls), nb_mask_built=forces.ffparams.nb_mask is not None,
        max_memory_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        card=repr(smi), seconds=f"{time.perf_counter() - t_phase:.1f}")
    require(not dense_calls, f"get_exclusions(fullarray=True) called {len(dense_calls)} times")
    require(forces.ffparams.nb_mask is None, "the dense mask was built on the Verlet path")
    require(not bad, f"list rows differ from the brute-force scan: {bad[:8]}")
    require(not overflow64, "the f64 list overflowed")
    require(worst_e <= E_TOL, f"f32 energies off the f64 Verlet path's by {worst_e}")
    require(f_err <= F_TOL, f"f32 forces off the f64 Verlet path's by {f_err}")
    require(np.all(np.isfinite(system.pos)) and np.isfinite(temps).all(),
            "verlet_auto run not finite")
    require(abs(t_mean - TEMP) <= VA_T_TOL, f"verlet_auto mean T {t_mean:.2f} K")
    require(launches["bonded"] >= VA_STEPS and launches["pair"] == 0,
            ("verlet_auto launches", launches))
    return launches
    return sps


def _ladder_positions(par, pos0, nrep, device, dtype):
    """(nrep, N, 3): the start plus half a 2 fs step of Maxwell-Boltzmann
    velocities at 300 K, seed r for replica r."""
    import torch

    from torchmd_tpu_torch.integrator import maxwell_boltzmann
    from torchmd_tpu_torch.units import TIMEFACTOR

    vel = torch.cat([maxwell_boltzmann(par.masses, TEMP, 1, seed=r, device=device,
                                       dtype=torch.float64) for r in range(nrep)])
    p0 = torch.as_tensor(pos0, dtype=torch.float64, device=device)
    return (p0[None] + 0.5 * TIMESTEP / TIMEFACTOR * vel).to(dtype).contiguous()


def phase_replica_kernels():
    """The replica axis of the pair (#1) and bonded (#3) kernels on
    thrombin: REPLICAS conformations in one launch each, against one launch
    per replica (#1 bit for bit, #3's energies equal and its forces at the
    Pallas bars) and against the f64 plain versions; then one R-replica
    launch timed against R one-replica launches, with the bound at R."""
    import torch

    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.potentials import make_ffparams

    mol, par, forces = _thrombin_forces(DEVICE)
    cfg, R = forces.config, REPLICAS
    d32 = kn.prepare_nb_data(forces.ffparams)
    plan32 = forces._bonded_plan
    ffp64 = make_ffparams(par, dtype=torch.float64, device=DEVICE)
    d64 = kn.prepare_nb_data(ffp64)
    plan64 = kb.build_bonded_kernel_plan(ffp64, cfg)
    # the plain f64 versions at the kernels' own (f32) positions
    p32 = _ladder_positions(par, mol.coords[:, :, 0], R, DEVICE, torch.float32)
    p64 = p32.double()
    n0 = (kn.LAUNCHES, kb.LAUNCHES)
    pot_k, f_k = kn.nonbonded_energy_forces(d32, cfg, p32)
    bpot_k, bf_k = kb.bonded_energy_forces(plan32, p32)
    launches = (kn.LAUNCHES - n0[0], kb.LAUNCHES - n0[1])
    require(launches == (1, 1), f"one launch each for {R} replicas, got {launches}")
    require(f_k.shape == (R, par.natoms, 3) and all(v.shape == (R,) for v in pot_k.values()),
            "replica-axis shapes")
    errs = {"pair": 0.0, "bonded": 0.0}
    for r in range(R):
        pot_1, f_1 = kn.nonbonded_energy_forces(d32, cfg, p32[r].contiguous())
        require(torch.equal(f_k[r], f_1) and all(torch.equal(pot_k[k][r], pot_1[k])
                                                 for k in pot_1),
                f"replica {r}: the pair kernel's R-axis result differs from one launch")
        bpot_1, bf_1 = kb.bonded_energy_forces(plan32, p32[r].contiguous())
        require(all(torch.equal(bpot_k[k][r], bpot_1[k]) for k in bpot_1),
                f"replica {r}: the bonded kernel's R-axis energies differ from one launch")
        _compare(f"replica{r}/bonded-vs-one", {k: v[r] for k, v in bpot_k.items()}, bf_k[r],
                 bpot_1, bf_1)
        pot_p, f_p = kn.pair_terms_reference(d64, cfg, p64[r])
        errs["pair"] = max(errs["pair"], _compare(
            f"replica{r}/pair", {k: v[r] for k, v in pot_k.items()}, f_k[r], pot_p, f_p))
        pot_p, f_p = kb.bonded_reference(plan64, p64[r])
        errs["bonded"] = max(errs["bonded"], _compare(
            f"replica{r}/bonded", {k: v[r] for k, v in bpot_k.items()}, bf_k[r], pot_p, f_p))
    torch.cuda.synchronize()
    log("replica_kernels", replicas=R, natoms=par.natoms, pair_bitwise_per_replica=True,
        bonded_energies_equal=True, pair_max_abs_err=errs["pair"],
        bonded_max_abs_err=errs["bonded"])

    npairs = sum(_thrombin_pair_count(d32, CUTOFF, p32[r]) for r in range(R))
    rows = sum(f.count for f in plan32.families)
    singles = [p32[r].contiguous() for r in range(R)]
    out = {
        "pair_replicas": dict(
            ms=cuda_events_ms(lambda: kn.nonbonded_energy_forces(d32, cfg, p32)),
            singles_ms=cuda_events_ms(lambda: [kn.nonbonded_energy_forces(d32, cfg, p)
                                               for p in singles]),
            plain_ms=cuda_events_ms(lambda: kn.pair_terms_reference_batch(d32, cfg, p32),
                                    calls=5, warmup=1),
            bound=bound(tensor_bytes(p32, d32.q, d32.sig, d32.eps, d32.types,
                                     d32.excl_start, d32.excl_tile, d32.excl_bits, p32),
                        pair_flops(npairs, "rfa")),
            work=f"replicas={R} pairs_in_cutoff={npairs}"),
        "bonded_replicas": dict(
            ms=cuda_events_ms(lambda: kb.bonded_energy_forces(plan32, p32)),
            singles_ms=cuda_events_ms(lambda: [kb.bonded_energy_forces(plan32, p)
                                               for p in singles]),
            plain_ms=cuda_events_ms(lambda: kb.bonded_reference_batch(plan32, p32),
                                    calls=5, warmup=1),
            # the index and parameter rows are the topology's, read once
            # for all the replicas; positions in and forces out per replica
            bound=bound(rows * (16 + 12) + tensor_bytes(p32, p32),
                        R * sum(f.count * BONDED_ROW_FLOPS[f.kind] for f in plan32.families)),
            work=f"replicas={R} rows={R * rows}"),
    }
    for k, v in out.items():
        v["max_abs_err"] = errs[k.split("_")[0]]
        log("timing", kernel=k, shapes=f"thrombin x {R}", ms=f"{v['ms']:.4f}",
            singles_ms=f"{v['singles_ms']:.4f}",
            one_launch_over_singles=f"{v['ms'] / v['singles_ms']:.3f}",
            plain_ms=f"{v['plain_ms']:.4f}", bound_ms=f"{v['bound'][0]:.5f}",
            bound_by=v["bound"][1], work=v["work"])
    return out


def _gb_forces(mol, par, precision="single", external=None):
    """Thrombin's Forces with GB/OBC as the external (the CLI's --gbsa)."""
    from torchmd_tpu_torch.external import combine_externals
    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.gb import make_gbsa

    gb = make_gbsa(par, mol, cutoff=CUTOFF, device=DEVICE)
    ext = gb if external is None else combine_externals([gb, external])
    return gb, Forces(par, terms=TERMS, precision=precision, cutoff=CUTOFF, rfa=RFA,
                      device=DEVICE, external=ext)


class _Calls:
    """`step(niter)` calls `fn` niter times: profile_water_step over a
    function."""

    def __init__(self, fn):
        self.fn = fn

    def step(self, niter):
        for _ in range(niter):
            self.fn()


def _monitor(path):
    import csv

    with open(path) as fh:
        return list(csv.DictReader(fh))


def phase_gbsa():
    """GB/OBC on thrombin: the analytic three passes at f32 against f64 on
    the card and against autograd of the energy; its device time per
    evaluation (CUDA events and a profile); then GB_STEPS steps through
    the CLI with `--gbsa` (the CLI phase's flags), the counters reset just
    before and read just after (#1 and #3 once a step and once at the
    start), the mean T over the last half."""
    import torch

    from torchmd_tpu_torch import run as cli
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn

    t_phase = time.perf_counter()
    mol, par = load_amber(*MAIN_SYSTEM)
    gb, _ = _gb_forces(mol, par)
    pos = mol.coords[:, :, 0]
    p32 = torch.as_tensor(pos, dtype=torch.float32, device=DEVICE)
    p64 = torch.as_tensor(pos, dtype=torch.float64, device=DEVICE)
    e32, f32 = gb.energy_forces_fn(p32)
    e64, f64 = gb.energy_forces_fn(p64)
    with torch.enable_grad():
        p = p64.clone().requires_grad_(True)
        (g64,) = torch.autograd.grad(gb.energy_fn(p), p)
    fmax = float(f64.abs().max())
    e_rel = abs(float(e32) - float(e64)) / max(1.0, abs(float(e64)))
    f_rel = float((f32.double() - f64).abs().max()) / fmax
    ad_rel = float((f64 + g64).abs().max()) / fmax
    ms = cuda_events_ms(lambda: gb.energy_forces_fn(p32), calls=10, warmup=2)
    prof_ms, events = profile_water_step(_Calls(lambda: gb.energy_forces_fn(p32)), ms / 1e3,
                                         steps=5, top=6, label="gb_profile")
    log("gb_check", natoms=par.natoms, e32=float(e32), e64=float(e64), e_rel_err=e_rel,
        f_rel_err=f_rel, analytic_vs_autograd_f64=ad_rel, device_ms=f"{ms:.4f}",
        profiled_device_ms=f"{prof_ms:.4f}", device_events=f"{events:.1f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    require(e_rel <= GB_E_TOL, f"GB energy f32 off f64 by {e_rel}")
    require(f_rel <= GB_F_TOL, f"GB forces f32 off f64 by {f_rel} of max |F|")
    require(ad_rel <= GB_AD_TOL, f"GB analytic forces off autograd by {ad_rel} of max |F|")
    del g64, p

    with tempfile.TemporaryDirectory() as td:
        argv = _cli_argv(os.path.join(td, "gb"), GB_STEPS,
                         ["--gbsa", "--output-period", str(GB_PERIOD),
                          "--langevin-gamma", str(GB_GAMMA)])
        kn.LAUNCHES = kb.LAUNCHES = 0
        summary = cli.main(argv)
        launches = {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}
        rows = _monitor(os.path.join(td, "gb", "monitor_0.csv"))
        Ts = np.asarray([float(r["T"]) for r in rows])
        mean_T = float(Ts[len(Ts) // 2:].mean())
        # a profiled chunk through the API, built as the CLI builds it
        from torchmd_tpu_torch.integrator import Integrator

        _, system, forces = cli.setup(cli.get_args(argv))
        forces.compute(system.pos, system.box, system.forces)
        integ = Integrator(system, forces, TIMESTEP, gamma=GB_GAMMA, T=TEMP, seed=1)
        step_ms, step_events = profile_water_step(
            integ, 1.0 / summary["steps_per_sec"], steps=20, label="gbsa_profile",
            shares=("pair_", "bonded"))
    log("gbsa", steps=summary["steps"], steps_per_s=f"{summary['steps_per_sec']:.2f}",
        ns_per_day=f"{summary['ns_per_day']:.3f}", pair_launches=launches["pair"],
        bonded_launches=launches["bonded"], T_series="/".join(f"{t:.1f}" for t in Ts),
        mean_T_last_half=f"{mean_T:.3f}", gb_device_ms_per_eval=f"{prof_ms:.4f}",
        step_device_ms=f"{step_ms:.4f}", seconds=f"{time.perf_counter() - t_phase:.2f}")
    for k, n in launches.items():
        require(n == GB_STEPS + 1, f"--gbsa: {k} kernel launched {n} != {GB_STEPS + 1}")
    require(np.all(np.isfinite(Ts)) and abs(mean_T - TEMP) <= GB_T_TOL,
            f"--gbsa: mean T {mean_T} over the last half")
    return launches, summary["steps_per_sec"]


def phase_remd(seed=0, gate=True):
    """ReplicaExchange on thrombin in GB/OBC: REPLICAS slots on a geometric
    ladder, REMD_STEPS steps with an attempt every REMD_PERIOD, the
    counters reset just before the start's evaluation and read after the
    last step (#1 and #3 once per evaluation for the whole ladder); each
    slot's mean T over the last half, read every REMD_SAMPLE steps;
    acceptance per pair (not gated). `seed` varies the velocities, the
    Langevin draws and the exchange draws; `gate=False` only reports."""
    import torch

    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.remd import ReplicaExchange
    from torchmd_tpu_torch.systems import System

    mol, par = load_amber(*MAIN_SYSTEM)
    _, forces = _gb_forces(mol, par)
    temps = np.geomspace(*REMD_LADDER, REPLICAS)
    system = System(mol.numAtoms, REPLICAS, "single")
    system.set_positions(mol.coords)
    system.set_velocities(torch.cat([
        maxwell_boltzmann(par.masses, t, 1, seed=seed * REPLICAS + r, device=DEVICE,
                          dtype=torch.float32) for r, t in enumerate(temps)]))
    forces.compute(system.pos, system.box, system.forces)
    t_warm = time.perf_counter()
    Integrator(system, forces, TIMESTEP, gamma=GB_GAMMA, T=temps, seed=3 + seed).step(
        niter=REMD_WARMUP)
    t_warm = time.perf_counter() - t_warm
    torch.cuda.synchronize()
    kn.LAUNCHES = kb.LAUNCHES = 0
    t0 = time.perf_counter()
    forces.compute(system.pos, system.box, system.forces)
    remd = ReplicaExchange(system, forces, TIMESTEP, temps, gamma=REMD_GAMMA, seed=1 + seed)
    Ts = []
    for done in range(REMD_SAMPLE, REMD_STEPS + 1, REMD_SAMPLE):
        _, epot, T = remd.integrator.step(niter=REMD_SAMPLE)
        if done > REMD_STEPS // 2:
            Ts.append(T)
        if done % REMD_PERIOD == 0 and done < REMD_STEPS:
            remd.attempt_exchanges(epot)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}
    mean_T = np.mean(Ts, axis=0)
    dev = mean_T / temps - 1.0
    rel = np.abs(dev)
    log("remd", replicas=REPLICAS, steps=REMD_STEPS, seed=seed, seconds=f"{dt:.3f}",
        warmup_steps=REMD_WARMUP, warmup_seconds=f"{t_warm:.3f}",
        steps_per_s=f"{REMD_STEPS / dt:.3f}",
        replica_steps_per_s=f"{REPLICAS * REMD_STEPS / dt:.2f}",
        pair_launches=launches["pair"], bonded_launches=launches["bonded"],
        ladder="/".join(f"{t:.1f}" for t in temps), T_samples_last_half=len(Ts),
        mean_T_last_half="/".join(f"{t:.1f}" for t in mean_T),
        T_rel_dev="/".join(f"{d:+.4f}" for d in dev),
        worst_T_rel=f"{rel.max():.4f}",
        acceptance="/".join(f"{a:.2f}" for a in remd.acceptance_rates),
        walkers="/".join(str(w) for w in remd.walker_id))
    if gate:
        for k, n in launches.items():
            require(n == REMD_STEPS + 1,
                    f"REMD: {k} kernel launched {n} times, want {REMD_STEPS + 1} (one per "
                    f"evaluation of the ladder, not {REPLICAS * (REMD_STEPS + 1)})")
        require(np.all(np.isfinite(system.pos)) and rel.max() <= REMD_T_REL,
                f"REMD: slot mean T {mean_T} off the ladder {temps}")
    return launches, REMD_STEPS / dt, dev


def remd_spread(nseeds):
    """`phase_remd` over seeds 0..nseeds-1 without its gate: each slot's
    relative deviation of the last half's mean T from its ladder T, and
    their spread over the seeds (what REMD_T_REL is set from)."""
    devs = np.array([phase_remd(seed=s, gate=False)[2] for s in range(nseeds)])
    log("remd_spread", seeds=nseeds, slots=devs.size,
        mean_dev=f"{devs.mean():+.4f}", std_dev=f"{devs.std():.4f}",
        worst_abs=f"{np.abs(devs).max():.4f}",
        worst_abs_per_seed="/".join(f"{d:.4f}" for d in np.abs(devs).max(1)))


def _ligand_and_pocket(mol):
    """(the ligand's atoms: residue LIGAND of the system's structure.pdb,
    the protein heavy atoms within METAD_POCKET A of it at the start)."""
    from torchmd_tpu_torch.io import Molecule

    pdb = Molecule(os.path.join(DATA, MAIN_SYSTEM[0], "structure.pdb"))
    lig = np.flatnonzero(pdb.resname == LIGAND)
    pos = mol.coords[:, :, 0]
    heavy = np.asarray([str(e) != "H" for e in pdb.element])
    protein = np.setdiff1d(np.flatnonzero(heavy), lig)
    d = np.sqrt(((pos[protein][:, None, :] - pos[lig][None, :, :]) ** 2).sum(-1)).min(1)
    return lig, protein[d <= METAD_POCKET]


def _count_syncs(fn):
    """(fn(), host syncs the CUDA sync-debug mode reported during it)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_metad():
    """Well-tempered metadynamics on thrombin in GB: the ligand-pocket COM
    distance, METAD_STEPS steps with a hill every METAD_STRIDE, the pair
    kernel's counter reset before the start's evaluation. The hills
    replayed in f64 on the host from the CV series give the grid the
    device built and its integral; the host syncs of a run do not grow
    with its hills (a METAD_SHORT-step run against the long one)."""
    import torch

    from torchmd_tpu_torch.cv import com_distance_cv
    from torchmd_tpu_torch.integrator import maxwell_boltzmann
    from torchmd_tpu_torch.metadynamics import MetaDynamics
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.systems import System
    from torchmd_tpu_torch.units import BOLTZMANN

    mol, par = load_amber(*MAIN_SYSTEM)
    lig, pocket = _ligand_and_pocket(mol)
    cv = com_distance_cv(lig, pocket, masses=par.masses)
    s0 = float(cv(torch.as_tensor(mol.coords[:, :, 0], dtype=torch.float64)))
    # +-5 A about the start: room for every hill's +-5 sigma (the part
    # below 0 A only holds the tails of hills near 0)
    grid = (s0 - 5.0, s0 + 5.0, int(round(10.0 / METAD_DX)) + 1)

    def make():
        _, forces = _gb_forces(mol, par)
        system = System(mol.numAtoms, 1, "single")
        system.set_positions(mol.coords)
        system.set_velocities(maxwell_boltzmann(par.masses, TEMP, 1, seed=1, device=DEVICE,
                                                dtype=torch.float32))
        forces.compute(system.pos, system.box, system.forces)
        return MetaDynamics(system, forces, cv, TIMESTEP, T=TEMP, gamma=GAMMA, grid=grid,
                            sigma=METAD_SIGMA, height=METAD_HEIGHT, stride=METAD_STRIDE,
                            bias_factor=METAD_BIASF, seed=2)

    short = make()
    _, short_syncs = _count_syncs(lambda: short.run(METAD_SHORT))
    torch.cuda.synchronize()
    kn.LAUNCHES = kb.LAUNCHES = 0
    metad = make()
    t0 = time.perf_counter()
    cvs, syncs = _count_syncs(lambda: metad.run(METAD_STEPS))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}
    # the hills replayed at f64 from the CV at each deposition step
    xs = metad.lo + metad.dx * np.arange(metad.nbins)
    kT_dT = BOLTZMANN * (METAD_BIASF - 1.0) * TEMP
    bias, heights = np.zeros(metad.nbins), []
    for k in range(METAD_STRIDE - 1, METAD_STEPS, METAD_STRIDE):
        w = METAD_HEIGHT * np.exp(-np.interp(cvs[k], xs, bias) / kT_dT)
        heights.append(w)
        bias = bias + w * np.exp(-0.5 * ((xs - cvs[k]) / METAD_SIGMA) ** 2)
    dev_bias = metad.bias.double().cpu().numpy()
    integral = float(dev_bias.sum() * metad.dx)
    want = float(np.sum(heights) * METAD_SIGMA * np.sqrt(2.0 * np.pi))
    replay_err = float(np.abs(dev_bias - bias).max())
    log("metad", steps=METAD_STEPS, seconds=f"{dt:.3f}", steps_per_s=f"{METAD_STEPS / dt:.2f}",
        ligand_atoms=len(lig), pocket_atoms=len(pocket), cv0=f"{s0:.4f}",
        cv_range=f"{cvs.min():.4f}-{cvs.max():.4f}", grid=f"{grid[0]:.3f}-{grid[1]:.3f}x{grid[2]}",
        hills=metad.nhills, heights="/".join(f"{h:.4f}" for h in heights),
        grid_integral=f"{integral:.6f}", hills_integral=f"{want:.6f}",
        replay_max_abs_err=f"{replay_err:.3e}", pair_launches=launches["pair"],
        bonded_launches=launches["bonded"], host_syncs=syncs,
        host_syncs_short_run=short_syncs)
    require(metad.nhills == METAD_STEPS // METAD_STRIDE == len(heights), "hill count")
    require(np.all(np.isfinite(cvs)) and cvs.shape == (METAD_STEPS,), "CV series")
    require(cvs.min() - 5 * METAD_SIGMA >= grid[0] and cvs.max() + 5 * METAD_SIGMA <= grid[1],
            "a hill's +-5 sigma left the grid")
    require(abs(integral - want) <= 1e-3 * want, f"bias integral {integral} != {want}")
    require(replay_err <= 1e-4 * max(1.0, float(np.abs(bias).max())),
            f"device bias off the replayed hills by {replay_err}")
    require(all(n == METAD_STEPS + 1 for n in launches.values()),
            f"metadynamics: launches {launches}")
    require(syncs <= short_syncs, f"host syncs grow with the hills: {syncs} against "
                                  f"{short_syncs} in {METAD_SHORT} steps")
    return launches, METAD_STEPS / dt


def phase_alchemy():
    """make_alchemical on thrombin (the ligand decoupled from the protein,
    the dense pair kernel with the edited exclusion words): at lam = 1
    the total energy and forces equal the unmodified system's at the
    Pallas bars; dU/dlambda at 0.5 at f32 against f64; ALCH_STEPS Langevin
    steps at lam = 0.5 with the counters read; LambdaDynamics with the
    ligand as one site, LD_STEPS steps, and LD_CHECK_STEPS steps at f32
    against f64 on the card."""
    import torch

    from torchmd_tpu_torch.alchemy import make_alchemical
    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.lambda_dynamics import LambdaDynamics, make_lambda_sites
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.systems import System

    mol, par, base = _thrombin_forces(DEVICE)
    lig, _ = _ligand_and_pocket(mol)
    pos = mol.coords[:, :, 0][None]
    f0, f1 = np.zeros((1, mol.numAtoms, 3)), np.zeros((1, mol.numAtoms, 3))
    e0 = base.compute(pos, None, f0)[0]
    _, _, alch = _thrombin_forces(DEVICE)
    coupling = make_alchemical(alch, lig, lam=1.0)
    e1 = alch.compute(pos, None, f1)[0]
    p32 = torch.as_tensor(pos[0], dtype=torch.float32, device=DEVICE)
    crossing = float(coupling.energy_fn(p32, None))
    e_rel = abs(e1 - e0) / max(1.0, abs(e0))
    f_rel = float(np.abs(f1 - f0).max()) / max(1.0, float(np.abs(f0).max()))
    p64 = torch.as_tensor(pos[0], dtype=torch.float64, device=DEVICE)
    d32 = float(coupling.dudl(p32, None, 0.5))
    d64 = float(coupling.dudl(p64, None, 0.5))
    dudl_rel = abs(d32 - d64) / max(1.0, abs(d64))
    log("alchemy", ligand_atoms=len(lig), epot_base=e0, epot_lam1=e1, e_rel_err=e_rel,
        f_rel_err=f_rel, crossing_energy=crossing, dudl32=d32, dudl64=d64,
        dudl_rel_err=dudl_rel)
    require(e_rel <= E_TOL, f"alchemy at lam=1: energy off the base system's by {e_rel}")
    require(f_rel <= F_TOL, f"alchemy at lam=1: forces off the base system's by {f_rel}")
    require(dudl_rel <= DUDL_TOL, f"dU/dlambda f32 off f64 by {dudl_rel}")

    coupling.lam = 0.5
    system = System(mol.numAtoms, 1, "single")
    system.set_positions(mol.coords)
    system.set_velocities(maxwell_boltzmann(par.masses, TEMP, 1, seed=1, device=DEVICE,
                                            dtype=torch.float32))
    torch.cuda.synchronize()
    kn.LAUNCHES = kb.LAUNCHES = 0
    alch.compute(system.pos, system.box, system.forces)
    integ = Integrator(system, alch, TIMESTEP, gamma=GAMMA, T=TEMP, seed=2)
    t0 = time.perf_counter()
    _, epot, T = integ.step(niter=ALCH_STEPS)
    torch.cuda.synchronize()
    sps = ALCH_STEPS / (time.perf_counter() - t0)
    launches = {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}
    require(all(n == ALCH_STEPS + 1 for n in launches.values()),
            f"alchemy lam=0.5 run launches {launches}")
    require(np.all(np.isfinite(system.pos)) and np.isfinite(epot).all(), "alchemy run")

    def ld_run(precision, steps, gamma):
        _, _, f = _thrombin_forces(DEVICE, precision)
        couplings = make_lambda_sites(f, [lig])
        s = System(mol.numAtoms, 1, precision)
        s.set_positions(mol.coords)
        s.set_velocities(maxwell_boltzmann(par.masses, TEMP, 1, seed=1, device=DEVICE,
                                           dtype=torch.float64))
        ld = LambdaDynamics(s, f, couplings, timestep=TIMESTEP, T=TEMP, gamma=gamma,
                            lam0=0.5, seed=3)
        return s, ld.step(niter=steps)

    n0 = kn.LAUNCHES
    t0 = time.perf_counter()
    s, (ek, ep, T_ld, lams) = ld_run("single", LD_STEPS, GAMMA)
    torch.cuda.synchronize()
    ld_sps = LD_STEPS / (time.perf_counter() - t0)
    ld_launches = kn.LAUNCHES - n0
    s32, _ = ld_run("single", LD_CHECK_STEPS, 0.0)
    s64, _ = ld_run("double", LD_CHECK_STEPS, 0.0)
    dev = float(np.abs(s32.pos.astype(np.float64) - s64.pos).max())
    log("lambda_dynamics", steps=LD_STEPS, steps_per_s=f"{ld_sps:.2f}",
        lam_range=f"{lams.min():.4f}-{lams.max():.4f}", lam_end=f"{lams[-1, 0]:.4f}",
        epot=f"{ep[0]:.4f}", T=f"{T_ld[0]:.3f}", pair_launches=ld_launches,
        f32_vs_f64_A=f"{dev:.3e}", alchemy_steps_per_s=f"{sps:.2f}",
        alchemy_launches=launches["pair"])
    require(np.all((lams >= 0) & (lams <= 1)) and np.isfinite(ep).all()
            and np.all(np.isfinite(s.pos)), "lambda-dynamics run")
    require(ld_launches == LD_STEPS + 1, f"lambda-dynamics pair launches {ld_launches}")
    require(dev <= LD_POS_TOL, f"lambda-dynamics f32 off f64 by {dev} A")
    return {k: launches[k] + ld_launches for k in launches}


def build_amoeba_box(precision="single"):
    """(par, types, bonds, coords (N, 3), box edge) of the AMOEBA water box:
    AMOEBA_N^3 water03 waters (r 0.9572 A, 108.5 deg) at the centres of an
    AMOEBA_N^3 lattice in the AMOEBA_L box, each turned by a random
    rotation (AMOEBA_SEED), as scripts/bench_waterbox.py builds its box."""
    from torchmd_tpu_torch.forcefields.ff_yaml import YamlForcefield
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.parameters import Parameters

    n, L = AMOEBA_N, AMOEBA_L
    th, r = np.radians(108.5), 0.9572
    mono = np.array([[0.0, 0.0, 0.0], [r * np.sin(th / 2), 0.0, r * np.cos(th / 2)],
                     [-r * np.sin(th / 2), 0.0, r * np.cos(th / 2)]])
    mono -= mono.mean(0)
    rs = np.random.RandomState(AMOEBA_SEED)
    coords = []
    for g in np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1).reshape(-1, 3):
        q, rr = np.linalg.qr(rs.randn(3, 3))
        q = q * np.sign(np.diag(rr))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        coords.append((g + 0.5) * (L / n) + mono @ q.T)
    coords = np.concatenate(coords)
    nw = n ** 3
    types = np.tile([1, 2, 2], nw)
    bonds = np.concatenate([[[m, m + 1], [m, m + 2]] for m in range(0, 3 * nw, 3)])
    mol = Molecule()
    mol.numAtoms = 3 * nw
    mol.atomtype = np.array(["OW", "HW", "HW"] * nw, dtype=object)
    mol.charge = np.zeros(3 * nw)
    mol.masses = np.array([15.995, 1.008, 1.008] * nw)
    mol.bonds = bonds
    mol.angles = np.asarray([[m + 1, m, m + 2] for m in range(0, 3 * nw, 3)])
    mol.coords = coords[:, :, None]
    mol.box = np.full((3, 1), L)
    ff = YamlForcefield(mol, {"atomtypes": ["OW", "HW"],
                              "masses": {"OW": 15.995, "HW": 1.008}})
    return Parameters(ff, mol, [], precision=precision), types, bonds, coords, L


def _amoeba_eval(pot, pos, box):
    """(parts {name: float}, forces (N, 3) f64 numpy, induced dipoles f64
    numpy) of one frame."""
    import torch

    x = pos.detach().clone().requires_grad_(True)
    parts = pot.energy_parts(x, box)
    (g,) = torch.autograd.grad(sum(parts.values()), x)
    mu = pot.parts[0].polarization.induced_dipoles(pos, box)
    return ({k: float(v.detach()) for k, v in parts.items()}, -g.double().cpu().numpy(),
            mu.double().cpu().numpy())


def _amoeba_errors(got, ref, scales):
    """(worst part's |dE| / scale, |dF| / max |F|, |dmu| / max |mu|)."""
    e = max(abs(got[0][k] - v) / scales[k] for k, v in ref[0].items())
    f = float(np.abs(got[1] - ref[1]).max() / np.abs(ref[1]).max())
    mu = float(np.abs(got[2] - ref[2]).max() / np.abs(ref[2]).max())
    return e, f, mu


def phase_amoeba():
    """The AMOEBA water box through make_amoeba_potential + Forces(terms=[],
    external=pot) + Integrator: one frame at f32 against f64 on the card
    (parts, forces, induced dipoles) and the planted polarizability fault;
    the f64 CG's convergence; the host syncs of a CG solve against one of a
    quarter of its iterations (sync-debug mode); the step's split (the
    permanent-field pass, one CG iteration, the energy and its backward
    pass) by CUDA events and a profile; AMOEBA_STEPS timed Langevin steps.
    Launches none of the kernels #1-#8 (AMOEBA is torch ops, as it is
    XLA ops in the JAX package)."""
    import copy

    import torch

    from torchmd_tpu_torch.amoeba import make_amoeba_potential, parse_tinker_prm
    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.multipole_ewald import self_energy
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.ops import pme as kp
    from torchmd_tpu_torch.systems import System

    t_phase = time.perf_counter()
    par, types, bonds, coords, L = build_amoeba_box()
    n = coords.shape[0]
    # the exclusions: every intramolecular pair (the AMOEBA factories read
    # only nb_mask of an FFParams)
    nb_mask = ~np.eye(n, dtype=bool)
    for m in range(0, n, 3):
        nb_mask[m:m + 3, m:m + 3] = False
    prm = parse_tinker_prm(AMOEBA_PRM)
    kw = dict(cutoff=AMOEBA_CUTOFF, switch_dist=AMOEBA_SWITCH, ewald=True,
              box=np.full(3, L), pme="auto", valence=True, cg_iters=AMOEBA_CG[0],
              cg_tol=AMOEBA_CG[1], device=DEVICE)

    class _Ffp:
        pass

    ffp = _Ffp()
    ffp.nb_mask = torch.as_tensor(nb_mask, device=DEVICE)
    pot, charges = make_amoeba_potential(ffp, types, bonds, prm, **kw)
    pol = pot.parts[0].polarization
    eng = pot.parts[0].multipoles
    require(type(eng).__name__ == "MultipolePme"
            and type(pol).__name__ == "AmoebaPolarizationEwald", "AMOEBA engines")
    for t in prm["polarize"].values():
        t["alpha"] *= AMOEBA_FAULT
    fault, _ = make_amoeba_potential(ffp, types, bonds, prm, **kw)

    frame = {}
    for dt in (torch.float64, torch.float32):
        pos = torch.as_tensor(coords, dtype=dt, device=DEVICE)
        box = torch.full((3,), L, dtype=dt, device=DEVICE)
        frame[dt] = _amoeba_eval(pot, pos, box)
        frame[dt, "cg"] = (int(pol.last_cg_iters), float(pol.last_cg_rs) ** 0.5)
    p32 = torch.as_tensor(coords, dtype=torch.float32, device=DEVICE)
    b32 = torch.full((3,), L, dtype=torch.float32, device=DEVICE)
    faulty = _amoeba_eval(fault, p32, b32)
    ref = frame[torch.float64]
    # the permanent part is a small sum of large Ewald tiers: its scale is
    # the self energy's magnitude
    q, mu_p, Q = eng._moments(torch.as_tensor(coords, device=DEVICE),
                              torch.full((3,), L, dtype=torch.float64, device=DEVICE))
    e_self = abs(332.0637133 * float(self_energy(eng.cfg.alpha, q, mu_p, Q).sum()))
    scales = {k: max(1.0, abs(v)) for k, v in ref[0].items()}
    scales["permanent"] = max(scales["permanent"], e_self)
    err = _amoeba_errors(frame[torch.float32], ref, scales)
    err_fault = _amoeba_errors(faulty, ref, scales)
    iters64, res64 = frame[torch.float64, "cg"]
    iters32, res32 = frame[torch.float32, "cg"]
    log("amoeba_frame", natoms=n, box=L, kmesh="x".join(map(str, eng.kmesh)),
        order=eng.order, alpha=f"{eng.cfg.alpha:.6f}",
        **{f"e64_{k}": f"{v:.6f}" for k, v in ref[0].items()},
        **{f"e32_{k}": f"{v:.6f}" for k, v in frame[torch.float32][0].items()},
        permanent_scale=f"{scales['permanent']:.3f}", e_rel_err=f"{err[0]:.3e}",
        f_rel_err=f"{err[1]:.3e}", mu_rel_err=f"{err[2]:.3e}",
        fault_e_rel_err=f"{err_fault[0]:.3e}", fault_f_rel_err=f"{err_fault[1]:.3e}",
        fault_mu_rel_err=f"{err_fault[2]:.3e}", cg_iters_f64=iters64,
        cg_residual_f64=f"{res64:.3e}", cg_iters_f32=iters32, cg_residual_f32=f"{res32:.3e}",
        max_mu=f"{np.abs(ref[2]).max():.5f}", max_f=f"{np.abs(ref[1]).max():.4f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    require(all(np.isfinite(v) for v in frame[torch.float32][0].values()), "AMOEBA f32 parts")
    require(err[0] <= AMOEBA_E_TOL, f"AMOEBA parts f32 off f64 by {err[0]} of their scale")
    require(err[1] <= AMOEBA_F_TOL, f"AMOEBA forces f32 off f64 by {err[1]} of max |F|")
    require(err[2] <= AMOEBA_MU_TOL, f"AMOEBA dipoles f32 off f64 by {err[2]} of max |mu|")
    require(err_fault[0] > AMOEBA_E_TOL and err_fault[1] > AMOEBA_F_TOL
            and err_fault[2] > AMOEBA_MU_TOL,
            f"the planted polarizability fault passed the bars: {err_fault}")
    require(iters64 < AMOEBA_CG[0] and res64 <= AMOEBA_CG[1],
            f"f64 CG: {iters64} iterations, residual {res64}")

    # host syncs of a solve do not grow with its iterations, eager or as
    # the CUDA graph (captured before the count); all iterations run
    # (cg_tol 0)
    def variant(iters, graph):
        v = copy.copy(pol)
        v.pspec = pol.pspec._replace(cg_iters=iters, cg_tol=0.0)
        v.cuda_graph = graph
        v.induced_dipoles(p32, b32)
        return v

    syncs = {}
    for iters in (AMOEBA_CG[0] // 4, AMOEBA_CG[0]):
        for graph in (False, True):
            v = variant(iters, graph)
            syncs[iters, graph] = _count_syncs(lambda: v.induced_dipoles(p32, b32))[1]

    # the split of one evaluation by CUDA events: the solve with no
    # iteration (geometry, permanent field, one operator application), the
    # full solve (graphed and eager), and the whole force evaluation
    zero, full, eager = (variant(0, True), variant(AMOEBA_CG[0], True),
                         variant(AMOEBA_CG[0], False))
    ms_field = cuda_events_ms(lambda: zero.induced_dipoles(p32, b32), calls=5, warmup=1)
    ms_solve = cuda_events_ms(lambda: full.induced_dipoles(p32, b32), calls=5, warmup=1)
    ms_eager = cuda_events_ms(lambda: eager.induced_dipoles(p32, b32), calls=3, warmup=1)
    t0 = time.perf_counter()
    for _ in range(3):
        eager.induced_dipoles(p32, b32)
    torch.cuda.synchronize()
    host_eager = (time.perf_counter() - t0) / 3 * 1e3

    def evaluate():
        x = p32.detach().clone().requires_grad_(True)
        torch.autograd.grad(pot.energy_fn(x, b32), x)

    # the whole evaluation as one graph (what Forces calls) against the
    # eager energy and backward pass around the graphed solve
    e_graph, f_graph = pot.energy_forces_fn(p32, b32)
    graph_f_err = float(np.abs(f_graph.double().cpu().numpy() - frame[torch.float32][1]).max()
                        / np.abs(ref[1]).max())
    ms_eval_eager = cuda_events_ms(evaluate, calls=5, warmup=1)
    ms_eval = cuda_events_ms(lambda: pot.energy_forces_fn(p32, b32), calls=10, warmup=2)
    ms_iter = (ms_solve - ms_field) / AMOEBA_CG[0]
    log("amoeba_split", field_pass_ms=f"{ms_field:.3f}", cg_iteration_ms=f"{ms_iter:.4f}",
        solve_ms=f"{ms_solve:.3f}", solve_eager_device_ms=f"{ms_eager:.3f}",
        solve_eager_host_ms=f"{host_eager:.3f}", evaluation_ms=f"{ms_eval:.3f}",
        evaluation_eager_ms=f"{ms_eval_eager:.3f}",
        energy_and_backward_ms=f"{ms_eval - ms_solve:.3f}",
        energy_and_backward_eager_ms=f"{ms_eval_eager - ms_solve:.3f}",
        graph_vs_eager_f_err=f"{graph_f_err:.3e}",
        **{f"host_syncs_{it}it_{'graph' if g else 'eager'}": n
           for (it, g), n in syncs.items()})
    require(graph_f_err <= 0.1 * AMOEBA_F_TOL, f"graphed forces off eager by {graph_f_err}")
    for graph in (False, True):
        lo, hi = syncs[AMOEBA_CG[0] // 4, graph], syncs[AMOEBA_CG[0], graph]
        require(hi <= lo, f"CG host syncs grow with the iterations: {hi} against {lo}")

    # the dynamics: Forces(terms=[], external=pot) + Integrator
    forces = Forces(par, terms=[], external=pot, precision="single", device=DEVICE)
    system = System(n, 1, "single")
    system.set_positions(coords[:, :, None])
    system.set_box(np.full(3, L))
    system.set_velocities(maxwell_boltzmann(par.masses, TEMP, 1, seed=AMOEBA_SEED,
                                            device=DEVICE, dtype=torch.float32))
    integ = Integrator(system, forces, AMOEBA_DT, gamma=GAMMA, T=TEMP, seed=1)
    integ.step(niter=AMOEBA_WARMUP)
    torch.cuda.synchronize()
    counters = (kn, kb, kc, kp)
    for mod in counters:
        for name in ("LAUNCHES", "SPREAD_LAUNCHES", "GATHER_LAUNCHES"):
            if hasattr(mod, name):
                setattr(mod, name, 0)
    Ts, Es = [], []
    t0 = time.perf_counter()
    for _ in range(AMOEBA_STEPS // AMOEBA_CHUNK):
        ek, ep, T = integ.step(niter=AMOEBA_CHUNK)
        Ts.append(float(np.asarray(T).reshape(-1)[0]))
        Es.append(float(np.asarray(ek).reshape(-1)[0] + np.asarray(ep).reshape(-1)[0]))
    torch.cuda.synchronize()
    dt_run = time.perf_counter() - t0
    launched = sum(getattr(mod, name, 0) for mod in counters
                   for name in ("LAUNCHES", "SPREAD_LAUNCHES", "GATHER_LAUNCHES"))
    sps = AMOEBA_STEPS / dt_run
    pos_end = np.asarray(system.pos)
    prof_ms, events = profile_water_step(integ, dt_run / AMOEBA_STEPS, steps=2, top=10,
                                         label="amoeba_profile")
    log("amoeba", natoms=n, steps=AMOEBA_STEPS, dt_fs=AMOEBA_DT, seconds=f"{dt_run:.3f}",
        steps_per_s=f"{sps:.3f}", ns_per_day=f"{sps * AMOEBA_DT * 86400e-6:.4f}",
        T_series="/".join(f"{t:.1f}" for t in Ts), mean_T=f"{np.mean(Ts):.2f}",
        E_series="/".join(f"{e:.3f}" for e in Es), energy_change=f"{Es[-1] - Es[0]:.4f}",
        step_device_ms=f"{prof_ms:.3f}", device_events_per_step=f"{events:.1f}",
        kernel_launches=launched, seconds_phase=f"{time.perf_counter() - t_phase:.2f}")
    require(np.all(np.isfinite(pos_end)) and np.all(np.isfinite(Ts + Es)), "AMOEBA dynamics")
    require(launched == 0, f"the AMOEBA path launched {launched} kernels of #1-#8")
    return sps


# ----------------------------------------------------------------------
# Drude oscillators, the NNP and force matching
# ----------------------------------------------------------------------

def _drude_kernel_check(tag, ext32, ext64, cfg, p32, box=None, recip32=None):
    """Kernels #1 and #3 (and, with `recip32`, the PME spread #6) on an
    extended Drude system against their plain versions at f64 at the
    Pallas bars; returns {kernel: max abs force (mesh) error}."""
    import torch

    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.ops import pme as kp

    p64 = p32.double()
    b32 = None if box is None else torch.as_tensor(box, dtype=torch.float32, device=DEVICE)
    b64 = None if box is None else b32.double()
    pot_k, f_k = kn.nonbonded_energy_forces(kn.prepare_nb_data(ext32), cfg, p32, b32)
    pot_p, f_p = kn.pair_terms_reference(kn.prepare_nb_data(ext64), cfg, p64, b64)
    errs = {"pair": _compare(f"{tag}/pair", pot_k, f_k, pot_p, f_p)}
    plan32 = kb.build_bonded_kernel_plan(ext32, cfg)
    pot_k, f_k = kb.bonded_energy_forces(plan32, p32, b32)
    pot_p, f_p = kb.bonded_reference(kb.build_bonded_kernel_plan(ext64, cfg), p64, b64)
    errs["bonded"] = _compare(f"{tag}/bonded", pot_k, f_k, pot_p, f_p)
    if recip32 is not None:
        kmesh, order = tuple(recip32.cfg.kmax), recip32.ORDER
        mesh_k = kp.pme_spread(p32, ext32.charges, b32, kmesh, order)
        mesh_p = kp.spread_reference(p64, ext64.charges, b64, kmesh, order)
        errs["pme_spread"] = float((mesh_k.double() - mesh_p).abs().max())
        require(errs["pme_spread"] <= MESH_TOL * float(mesh_p.abs().max()),
                (tag, "spread", errs["pme_spread"]))
    torch.cuda.synchronize()
    log("drude_kernels", case=tag, natoms=int(p32.shape[0]),
        **{f"{k}_max_abs_err": v for k, v in errs.items()})
    return errs


def _drude_thrombin(precision):
    """(mol, forces, ffp_ext, spec) of thrombin with Drudes on its heavy
    atoms at `precision` on the card (f64 takes the torch-op path):
    DRUDE_TERMS, 1-2, 1-3 and 1-4 pairs excluded (see DRUDE_TERMS)."""
    from torchmd_tpu_torch.drude import make_drude
    from torchmd_tpu_torch.forces import Forces

    mol, par = load_amber(*MAIN_SYSTEM)
    forces = Forces(par, terms=DRUDE_TERMS, precision=precision, cutoff=CUTOFF, rfa=RFA,
                    device=DEVICE)
    alpha = np.where(np.asarray(par.masses).reshape(-1) < 1.5, 0.0, DRUDE_ALPHA)
    ext, spec = make_drude(forces, alpha=alpha)
    return mol, forces, ext, spec


def _drude_nve(ext, spec, cfg, pos, vel, dtype, steps=DRUDE_NVE_STEPS):
    """Positions (f64 numpy) after `steps` NVE steps of DrudeIntegrator."""
    import torch

    from torchmd_tpu_torch.drude import DrudeIntegrator

    integ = DrudeIntegrator(ext, spec, cfg, pos, timestep=DRUDE_DT, gamma=0.0,
                            gamma_drude=0.0, dtype=dtype, device=DEVICE)
    integ.vel = torch.as_tensor(vel, dtype=dtype, device=DEVICE)
    integ.step(niter=steps)
    return integ.pos.double().cpu().numpy()


def _drude_langevin(ext, spec, cfg, pos, box=None, seed=1):
    """DrudeIntegrator at DRUDE_DT fs, 300 K, 1 ps^-1, T_drude 1 K, 20 ps^-1
    from `pos`, Maxwell-Boltzmann velocities (`seed`), f32 on the card."""
    import torch

    from torchmd_tpu_torch.drude import DrudeIntegrator

    integ = DrudeIntegrator(ext, spec, cfg, pos, box=box, timestep=DRUDE_DT, T=TEMP,
                            gamma=1.0, T_drude=1.0, gamma_drude=20.0, seed=seed,
                            dtype=torch.float32, device=DEVICE)
    integ.set_velocities_boltzmann(seed=seed)
    return integ


def phase_drude():
    """Thrombin with Drude oscillators on its heavy atoms: #1 and #3 on
    the extended system against plain at the start (every core-Drude pair
    at r = 0) and at the SCF state; scf_drude (iterations, host reads,
    launches); DRUDE_WINDOWS windows of DRUDE_WINDOW timed dual-Langevin
    steps, each from the SCF state (steps/s, ns/day, launches), a profile
    and the collapse witness, each from a fresh start; DRUDE_NVE_STEPS
    NVE steps at f32 against f64 on the card; then
    the gated dual-Langevin run on the polarizable argon liquid
    (`phase_drude_argon`). Returns the launches of the runs."""
    import torch

    from torchmd_tpu_torch.drude import drude_energy_forces, init_drude_positions, scf_drude
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn

    t_phase = time.perf_counter()
    mol, forces, ext, spec = _drude_thrombin("single")
    _, forces64, ext64, spec64 = _drude_thrombin("double")
    cfg = forces.config
    npol, n_ext = int(spec.core_idx.shape[0]), int(ext.charges.shape[0])
    plan = kb.build_bonded_kernel_plan(ext, cfg)
    log("drude_setup", natoms=mol.numAtoms, oscillators=npol, particles=n_ext,
        thole_pairs=int(spec.thole_i.shape[0]), q_drude=f"{float(spec.q_drude[0]):.4f}",
        **kb.window_stats(plan), widest_window=int(plan.windows[:, 1].max()))
    require(n_ext == mol.numAtoms + npol and ext64.charges.shape[0] == n_ext, "extended sizes")
    pos0 = init_drude_positions(torch.as_tensor(mol.coords[:, :, 0], dtype=torch.float32,
                                                device=DEVICE), spec)
    _drude_kernel_check("drude-thrombin-start", ext, ext64, cfg, pos0)

    ef = drude_energy_forces(ext, spec, cfg)
    torch.cuda.synchronize()
    kn.LAUNCHES = kb.LAUNCHES = 0
    t0 = time.perf_counter()
    pos, info = scf_drude(ext, spec, cfg, pos0, None, iters=SCF_ITERS, tol=DRUDE_SCF_TOL,
                          ef=ef, return_info=True, damping=DRUDE_SCF_DAMPING)
    torch.cuda.synchronize()
    scf_s = time.perf_counter() - t0
    scf_launches = {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}
    log("drude_scf", case="thrombin", precision="f32", damping=DRUDE_SCF_DAMPING,
        seconds=f"{scf_s:.4f}", ms_per_iteration=f"{1e3 * scf_s / info['iterations']:.4f}",
        pair_launches=kn.LAUNCHES, bonded_launches=kb.LAUNCHES, **info)
    require(kn.LAUNCHES == kb.LAUNCHES == info["iterations"], "SCF launches")
    require(info["gmax"] <= DRUDE_SCF_TOL, f"thrombin SCF stopped at gmax {info['gmax']}")
    _drude_kernel_check("drude-thrombin-scf", ext, ext64, cfg, pos)
    # the witnesses: the JAX step's growth on the stiff modes, and the
    # damped step's stall at the reaction field's cutoff jumps
    for damping, iters, tol in ((1.0, SCF_WITNESS_ITERS, SCF_TOL_F32),
                                (DRUDE_SCF_DAMPING, SCF_ITERS, SCF_TOL_F32)):
        trace = []

        def traced(p, b):
            out = ef(p, b)
            trace.append(float(out[1][spec.drude_idx].abs().max()))
            return out

        scf_drude(ext, spec, cfg, pos0, None, iters=iters, tol=tol, damping=damping, ef=traced)
        log("drude_scf_witness", damping=damping, iterations=len(trace), tol=tol,
            gmax_trace=",".join(f"{g:.4g}" for g in trace[::max(1, iters // 6)] + trace[-1:]))

    integ = _drude_langevin(ext, spec, cfg, pos)
    f0 = ef(pos, None)[1]
    steps = DRUDE_WINDOWS * DRUDE_WINDOW
    rows, dt = [], 0.0
    torch.cuda.synchronize()
    kn.LAUNCHES = kb.LAUNCHES = 0
    for w in range(DRUDE_WINDOWS):
        integ.set_velocities_boltzmann(seed=w + 1)
        integ.pos, integ._last_frc = pos.clone(), f0
        integ._last_pos = integ.pos
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows.append(integ.step(niter=DRUDE_WINDOW))
        torch.cuda.synchronize()
        dt += time.perf_counter() - t0
    launches = {"pair": kn.LAUNCHES + scf_launches["pair"],
                "bonded": kb.LAUNCHES + scf_launches["bonded"]}
    sps = steps / dt
    rows = np.asarray(rows)
    log("drude_dynamics", case="thrombin", windows=DRUDE_WINDOWS, window_steps=DRUDE_WINDOW,
        steps=steps, seconds=f"{dt:.4f}", steps_per_s=f"{sps:.2f}",
        ns_per_day=f"{sps * DRUDE_DT * 1e-6 * 86400:.4f}",
        T_window_ends=f"{rows[:, 2].min():.1f}-{rows[:, 2].max():.1f}",
        T_rel_window_ends=f"{rows[:, 3].min():.2f}-{rows[:, 3].max():.2f}",
        pair_launches=kn.LAUNCHES, bonded_launches=kb.LAUNCHES)
    require(np.all(np.isfinite(rows)), "Drude thrombin run not finite")
    require(kn.LAUNCHES == kb.LAUNCHES == steps, f"Drude launches {launches}")
    profile_water_step(_drude_langevin(ext, spec, cfg, pos), 1.0 / sps,
                       steps=DRUDE_WINDOW, label="drude_profile", shares=("pair_", "bonded"))
    _drude_collapse_witness(mol, ext, spec, cfg, pos)

    # NVE from the SCF state: f32 kernels against f64 torch ops on the
    # card, with the one-ulp floor and the 1 % charge control
    p, v = pos.clone(), _drude_langevin(ext, spec, cfg, pos).vel
    ulp = torch.abs(torch.nextafter(p, torch.full_like(p, np.inf)) - p)
    ref = _drude_nve(ext64, spec64, forces64.config, p.double(), v, torch.float64)
    dev = float(np.abs(_drude_nve(ext, spec, cfg, p, v, torch.float32) - ref).max())
    floor = float(np.abs(_drude_nve(ext, spec, cfg, p + ulp, v, torch.float32) - ref).max())
    ctl = float(np.abs(_drude_nve(ext._replace(charges=ext.charges * 1.01), spec, cfg, p, v,
                                  torch.float32) - ref).max())
    log("drude_nve", steps=DRUDE_NVE_STEPS, max_pos_dev_A=dev, ulp_floor_A=floor,
        charge_control_A=ctl)
    require(dev <= 1e-3 or (dev <= 3.0 * floor < ctl),
            f"Drude NVE f32 vs f64 {dev} A (floor {floor}, control {ctl})")

    d32 = kn.prepare_nb_data(ext)
    log("drude_timing", natoms=n_ext,
        pair_ms=f"{cuda_events_ms(lambda: kn.nonbonded_energy_forces(d32, cfg, pos)):.4f}",
        bonded_ms=f"{cuda_events_ms(lambda: kb.bonded_energy_forces(plan, pos)):.4f}",
        evaluation_ms=f"{cuda_events_ms(lambda: ef(pos, None)):.4f}",
        seconds=f"{time.perf_counter() - t_phase:.2f}")
    argon = phase_drude_argon()
    return {k: launches[k] + argon[k] for k in launches}, sps


def _drude_collapse_witness(mol, ext, spec, cfg, pos):
    """Run Drude thrombin from its SCF state step by step, at most
    DRUDE_COLLAPSE_STEPS, until a Drude is 0.5 A from its core or the
    energy is not finite; log that step, that Drude's atom and its nearest
    particles (name, atom type, distance, charge) at that step, and the
    largest displacement and T_rel five steps later. No gate: the reason
    the dynamics are timed in short windows."""
    import torch

    integ = _drude_langevin(ext, spec, cfg, pos)
    names, types = np.asarray(mol.name), np.asarray(mol.atomtype)
    n = mol.numAtoms

    def label(j):
        if j < n:
            return f"{names[j]}/{types[j]}"
        return "D:" + str(names[int(spec.core_idx[j - n])])

    def displacement():
        return (integ.pos[spec.drude_idx] - integ.pos[spec.core_idx]).norm(dim=1)

    step = 0
    while step < DRUDE_COLLAPSE_STEPS:
        out = integ.step(niter=1)
        step += 1
        d = displacement()
        if not np.isfinite(out[1]) or float(d.max()) > 0.5:
            break
    k = int(d.argmax())
    x = integ.pos
    dist = (x - x[spec.drude_idx[k]]).norm(dim=1)
    near = [(label(j), f"{float(dist[j]):.3f}", f"{float(ext.charges[j]):+.3f}")
            for j in torch.argsort(dist)[1:4].tolist()]
    at = (float(d.max()), out[3])
    later = integ.step(niter=5)
    log("drude_collapse", step=step, finite=bool(np.isfinite(out[1])),
        max_drude_displacement_A=f"{at[0]:.3f}", T_rel=f"{at[1]:.1f}",
        atom=label(int(spec.core_idx[k])), nearest=near,
        max_displacement_5_later_A=f"{float(displacement().max()):.3f}",
        T_rel_5_later=f"{later[3]:.1f}")


def phase_drude_argon():
    """The dual-Langevin dynamics gates on a polarizable argon liquid
    (ARGON_N^3 atoms, LJ of tests/systems/argon, alpha ARGON_ALPHA A^3,
    Drudes on every atom, cutoff ARGON_CUTOFF in a box of ARGON_L A, RFA):
    DRUDE_WARMUP then DRUDE_STEPS steps (counters reset just before and
    read just after), mean T_phys of the last half within DRUDE_T_TOL of
    300 K, mean T_rel below DRUDE_TREL_MAX. Returns the launches."""
    import torch

    from torchmd_tpu_torch.drude import init_drude_positions, make_drude_ffparams
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.potentials import FFParams, ForceTermConfig

    n = ARGON_N ** 3
    g = np.stack(np.meshgrid(*[np.arange(ARGON_N)] * 3, indexing="ij"), -1).reshape(-1, 3)
    coords = (g + 0.5) * (ARGON_L / ARGON_N)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=DEVICE)

    ffp = FFParams(charges=t(np.zeros(n)), masses=t(np.full((n, 1), 39.95)),
                   mapped_atom_types=t(np.zeros(n), torch.int64),
                   lj_params=t([[3.345, 0.238]]), bonds=None, angles=None, dihedrals=None,
                   impropers=None, nb14=None, nb_mask=~torch.eye(n, dtype=torch.bool,
                                                                device=DEVICE))
    ext, spec = make_drude_ffparams(ffp, np.full(n, ARGON_ALPHA))
    cfg = ForceTermConfig(terms=("lj", "electrostatics", "bonds"), cutoff=ARGON_CUTOFF,
                          rfa=True)
    box = np.full(3, ARGON_L)
    integ = _drude_langevin(ext, spec, cfg, init_drude_positions(t(coords), spec), box=box)
    warm = [integ.step(niter=DRUDE_CHUNK) for _ in range(DRUDE_WARMUP // DRUDE_CHUNK)]
    torch.cuda.synchronize()
    kn.LAUNCHES = kb.LAUNCHES = 0
    t0 = time.perf_counter()
    rows = np.asarray([integ.step(niter=DRUDE_CHUNK) for _ in range(DRUDE_STEPS // DRUDE_CHUNK)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}
    half = rows[len(rows) // 2:]
    T_mean, Trel_mean = float(half[:, 2].mean()), float(half[:, 3].mean())
    sps = DRUDE_STEPS / dt
    log("drude_dynamics", case="argon", natoms=n, particles=2 * n, warmup=DRUDE_WARMUP,
        T_warmup_end=f"{warm[-1][2]:.2f}", steps=DRUDE_STEPS, seconds=f"{dt:.4f}",
        steps_per_s=f"{sps:.2f}", ns_per_day=f"{sps * DRUDE_DT * 1e-6 * 86400:.4f}",
        T_last_half=f"{T_mean:.3f}", T_rel_last_half=f"{Trel_mean:.3f}",
        Epot=f"{rows[-1, 1]:.4f}", host_reads=len(rows), pair_launches=launches["pair"],
        bonded_launches=launches["bonded"])
    require(np.all(np.isfinite(rows)), "Drude argon run not finite")
    for k, v in launches.items():
        require(v == DRUDE_STEPS, f"argon {k} kernel launched {v} != {DRUDE_STEPS} times")
    require(abs(T_mean - TEMP) <= DRUDE_T_TOL, f"Drude T_phys {T_mean} off {TEMP}")
    require(Trel_mean < DRUDE_TREL_MAX, f"Drude T_rel {Trel_mean} >= {DRUDE_TREL_MAX}")
    return launches


def swm4_coords(n=None, parallel=False):
    """(4 n^3, 3) coordinates of n^3 SWM4-NDP waters (n: default SWM4_N;
    O, M, H1, H2; O-H 0.9572 A, 104.52 deg) at the centres of an n^3
    lattice of SWM4_L / SWM4_N A cells, each turned about its O by a
    random rotation (SWM4_SEED) unless `parallel`; M rows at O until the
    lone pairs are constrained."""
    n = SWM4_N if n is None else n
    r, th = 0.9572, np.radians(104.52)
    mono = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                     [r * np.sin(th / 2), 0.0, r * np.cos(th / 2)],
                     [-r * np.sin(th / 2), 0.0, r * np.cos(th / 2)]])
    rs = np.random.RandomState(SWM4_SEED)
    coords = []
    for g in np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1).reshape(-1, 3):
        q, rr = np.linalg.qr(rs.randn(3, 3))
        q = q * np.sign(np.diag(rr))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        coords.append((g + 0.5) * (SWM4_L / SWM4_N) + mono @ (np.eye(3) if parallel else q.T))
    return np.concatenate(coords)


def build_swm4(n=None, parallel=False):
    """(charges, alpha, thole, lone pairs, coordinates) of the SWM4-NDP
    box of `swm4_coords(n, parallel)`, edge n SWM4_L / SWM4_N."""
    n = SWM4_N if n is None else n
    from torchmd_tpu_torch.drude import charmm_drude_tables
    from torchmd_tpu_torch.forcefields.ff_charmm import CharmmParameterSet
    from torchmd_tpu_torch.io import Molecule

    nw = n ** 3
    mol = Molecule()
    mol.numAtoms = 4 * nw
    mol.name = np.array(["OH2", "OM", "H1", "H2"] * nw, dtype=object)
    mol.resname = np.array(["SWM4"] * 4 * nw, dtype=object)
    mol.resid = np.repeat(np.arange(nw), 4)
    prm = CharmmParameterSet(os.path.join(DATA, "swm4-ndp", "swm4ndp.str"))
    alpha, thole, charges, lps = charmm_drude_tables(prm, mol)
    return charges, alpha, thole, lps, swm4_coords(n, parallel)


def _swm4_system(charges, alpha, thole, lps, coords, dtype):
    """(ffp_ext, spec, start positions (Drudes on their cores), recip, cfg)
    of an SWM4-NDP box (its edge from the water count, at SWM4_L / SWM4_N
    A a water) at `dtype` on the card."""
    import torch

    from torchmd_tpu_torch.drude import (constrain_lonepairs, init_drude_positions,
                                         make_drude_ewald, make_drude_ffparams,
                                         make_lonepair_spec)
    from torchmd_tpu_torch.potentials import FFParams, ForceTermConfig

    n = len(charges)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=DEVICE)

    mol_of = torch.arange(n, device=DEVICE) // 4
    ffp = FFParams(charges=t(charges),
                   masses=t(np.tile([15.999, 1e-9, 1.008, 1.008], n // 4).reshape(-1, 1)),
                   mapped_atom_types=t(np.zeros(n), torch.int64),
                   lj_params=t(np.zeros((1, 2))), bonds=None, angles=None, dihedrals=None,
                   impropers=None, nb14=None, nb_mask=mol_of[:, None] != mol_of[None, :])
    ext, spec = make_drude_ffparams(ffp, alpha, thole_atom=np.where(alpha > 0, thole, np.nan))
    pos = constrain_lonepairs(make_lonepair_spec(lps, device=DEVICE, dtype=dtype),
                              [lp["site"] for lp in lps], t(coords))
    edge = round((n // 4) ** (1 / 3)) * SWM4_L / SWM4_N
    recip, aew = make_drude_ewald(ext, np.full(3, edge), SWM4_CUTOFF, tol=SWM4_TOL)
    cfg = ForceTermConfig(terms=("electrostatics", "bonds"), cutoff=SWM4_CUTOFF,
                          ewald_alpha=aew)
    return ext, spec, init_drude_positions(pos, spec), recip, cfg


def swm4_dipoles(ext, pos):
    """Each molecule's dipole (D, f64 numpy): its four sites and its Drude
    row about its O."""
    import torch

    nw = int(pos.shape[0]) // 5
    m = torch.arange(nw, device=pos.device)
    rows = torch.stack([4 * m, 4 * m + 1, 4 * m + 2, 4 * m + 3, 4 * nw + m], 1)
    p, q = pos.double(), ext.charges.double()
    d = p[rows] - p[4 * m][:, None, :]
    return ((q[rows][..., None] * d).sum(1).norm(dim=-1) * DEBYE).cpu().numpy()


def swm4_induced(spec, pos):
    """Each molecule's induced dipole |q_D (r_D - r_O)| (D, f64 numpy)."""
    p = pos.double()
    d = p[spec.drude_idx] - p[spec.core_idx]
    return (spec.q_drude.double().abs() * d.norm(dim=1) * DEBYE).cpu().numpy()


def phase_drude_swm4():
    """The SWM4-NDP box (CHARMM Drude-2013 ingestion, lone pairs, PME on
    the extended topology): #1 (Ewald real space), #3 and the PME spread
    #6 against plain at the start and at the relaxed geometry; scf_drude
    at f64 (plain, to SCF_TOL_F64) and at f32 (the kernels, the counters
    reset just before and read just after); the dipoles' gates; the same
    lattice unrotated. Returns the f32 solve's launches."""
    import torch

    from torchmd_tpu_torch.drude import scf_drude
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.ops import pme as kp

    t_phase = time.perf_counter()
    box = np.full(3, SWM4_L)
    parts = build_swm4()
    ext64, spec64, p0_64, rec64, cfg64 = _swm4_system(*parts, torch.float64)
    ext, spec, p0, rec, cfg = _swm4_system(*parts, torch.float32)
    require(type(rec).__name__ == "PmeRecip" and rec.gather == "exact", "SWM4 reciprocal term")
    log("swm4_setup", waters=SWM4_N ** 3, particles=int(ext.charges.shape[0]), box=SWM4_L,
        mesh="x".join(map(str, rec.cfg.kmax)), order=rec.ORDER,
        ewald_alpha=f"{cfg.ewald_alpha:.6f}", excluded_pairs=int(rec.excl.shape[0]),
        seconds=f"{time.perf_counter() - t_phase:.2f}")
    _drude_kernel_check("swm4-start", ext, ext64, cfg, p0, box, rec)

    t0 = time.perf_counter()
    p64, info64 = scf_drude(ext64, spec64, cfg64, p0_64, box, iters=SCF_ITERS,
                            tol=SCF_TOL_F64, recip=rec64, return_info=True)
    torch.cuda.synchronize()
    log("drude_scf", case="swm4", precision="f64", seconds=f"{time.perf_counter() - t0:.4f}",
        **info64)
    require(info64["gmax"] <= SCF_TOL_F64, f"f64 SCF stopped at gmax {info64['gmax']}")

    torch.cuda.synchronize()
    kn.LAUNCHES = kb.LAUNCHES = kp.SPREAD_LAUNCHES = kp.GATHER_LAUNCHES = 0
    t0 = time.perf_counter()
    p32, info = scf_drude(ext, spec, cfg, p0, box, iters=SCF_ITERS, tol=SCF_TOL_F32,
                          recip=rec, return_info=True)
    torch.cuda.synchronize()
    scf_s = time.perf_counter() - t0
    launches = {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES, "pme_spread": kp.SPREAD_LAUNCHES,
                "pme_gather": kp.GATHER_LAUNCHES}
    log("drude_scf", case="swm4", precision="f32", seconds=f"{scf_s:.4f}",
        ms_per_iteration=f"{1e3 * scf_s / info['iterations']:.4f}",
        **{f"{k}_launches": v for k, v in launches.items()}, **info)
    require(launches["pme_gather"] == 0, "the exact-gather path launched the ik gather")
    require(launches["pair"] == launches["bonded"] == launches["pme_spread"]
            == info["iterations"], f"SWM4 SCF launches {launches}")
    _drude_kernel_check("swm4-relaxed", ext, ext64, cfg, p64.float(), box, rec)

    mu64, mu32 = swm4_dipoles(ext64, p64), swm4_dipoles(ext, p32)
    ind64 = swm4_induced(spec64, p64)
    rel = float(np.abs(mu32 / mu64 - 1.0).max())
    # the witness box: the same construction at SWM4_WITNESS's n^3 waters
    n_w, mean_w, std_w = SWM4_WITNESS
    ext_w, spec_w, p0_w, rec_w, cfg_w = _swm4_system(*build_swm4(n_w), torch.float64)
    p_w, info_w = scf_drude(ext_w, spec_w, cfg_w, p0_w, np.full(3, n_w * SWM4_L / SWM4_N),
                            iters=SCF_ITERS, tol=SCF_TOL_F64, recip=rec_w, return_info=True)
    ind_w = swm4_induced(spec_w, p_w)
    se = np.sqrt(std_w ** 2 / n_w ** 3 + ind64.std() ** 2 / SWM4_N ** 3)
    log("swm4_dipoles", mean_D=f"{mu64.mean():.4f}", min_D=f"{mu64.min():.4f}",
        max_D=f"{mu64.max():.4f}", p5_D=f"{np.percentile(mu64, 5):.4f}",
        p95_D=f"{np.percentile(mu64, 95):.4f}", induced_mean_D=f"{ind64.mean():.6f}",
        induced_std_D=f"{ind64.std():.6f}", f32_vs_f64_rel=rel)
    log("swm4_witness", waters=n_w ** 3, recip=type(rec_w).__name__,
        iterations=info_w["iterations"], induced_mean_D=repr(float(ind_w.mean())),
        induced_std_D=repr(float(ind_w.std())), jax_mean_D=mean_w, jax_std_D=std_w,
        full_box_off_by_se=f"{abs(ind64.mean() - mean_w) / se:.3f}")
    require(abs(ind_w.mean() - mean_w) <= SWM4_WITNESS_TOL
            and abs(ind_w.std() - std_w) <= SWM4_WITNESS_TOL,
            f"SWM4 witness box: induced {ind_w.mean()} +- {ind_w.std()} D, "
            f"the JAX package's {mean_w} +- {std_w}")
    require(abs(ind64.mean() - mean_w) <= SWM4_WITNESS_SE * se,
            f"SWM4 induced dipoles: mean {ind64.mean()} D, the witness {mean_w} "
            f"(standard error {se})")
    require(mu64.max() < SWM4_MU_RANGE[1], f"SWM4 dipoles: max {mu64.max()}")
    require(rel <= SWM4_MU_REL, f"SWM4 f32 dipoles off f64 by {rel}")

    # the unrotated lattice: every molecule's dipole enhanced alike
    ext_l, spec_l, p0_l, rec_l, cfg_l = _swm4_system(*build_swm4(parallel=True), torch.float64)
    p_l, info_l = scf_drude(ext_l, spec_l, cfg_l, p0_l, box, iters=SCF_ITERS, tol=SCF_TOL_F64,
                            recip=rec_l, return_info=True)
    mu_l = swm4_dipoles(ext_l, p_l)
    log("swm4_lattice", min_D=f"{mu_l.min():.6f}", max_D=f"{mu_l.max():.6f}", **info_l,
        seconds=f"{time.perf_counter() - t_phase:.2f}")
    require(SWM4_MU_RANGE[0] < mu_l.min() and mu_l.max() < SWM4_MU_RANGE[1],
            f"SWM4 lattice dipoles {mu_l.min()}-{mu_l.max()} D")

    d32 = kn.prepare_nb_data(ext)
    b32 = torch.as_tensor(box, dtype=torch.float32, device=DEVICE)
    kmesh = tuple(rec.cfg.kmax)
    log("swm4_timing", pair_ms=f"{cuda_events_ms(lambda: kn.nonbonded_energy_forces(d32, cfg, p32, b32)):.4f}",
        spread_ms=f"{cuda_events_ms(lambda: kp.pme_spread(p32, ext.charges, b32, kmesh, rec.ORDER)):.4f}",
        recip_ms=f"{cuda_events_ms(lambda: rec.energy_forces(p32, b32)):.4f}")
    return launches


def _lj_dimer(d, sigma=3.4, eps=0.24):
    s6 = (sigma / d) ** 6
    return 4 * eps * (s6 * s6 - s6)


def phase_nnp():
    """The NNP trained on the argon dimer's LJ curve at f32 on the card
    (losses, the well), then driving the dimer's MD through
    Forces(external=NNPExternal) and the Integrator; the default
    NNPConfig's energy + forces at thrombin's width (device ms, peak
    memory). Launches none of the kernels #1-#8."""
    import torch

    from torchmd_tpu_torch.forcefields.forcefield import NullForcefield
    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.integrator import Integrator
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.nnp import NNPConfig, NNPExternal, init_params, nnp_energy, train_nnp
    from torchmd_tpu_torch.parameters import Parameters
    from torchmd_tpu_torch.systems import System

    cfg = NNPConfig(n_species=1, cutoff=8.0, n_rbf=24, features=24, hidden=48)
    model = init_params(cfg, seed=0, dtype=torch.float32, device=DEVICE)
    dists = np.linspace(3.2, 7.5, NNP_DISTS)
    pos = np.zeros((NNP_DISTS, 2, 3))
    pos[:, 1, 0] = dists
    h = 1e-4
    dEdr = (_lj_dimer(dists + h) - _lj_dimer(dists - h)) / (2 * h)
    f_ref = np.zeros_like(pos)
    f_ref[:, 1, 0], f_ref[:, 0, 0] = -dEdr, dEdr
    species = torch.zeros(2, dtype=torch.int64, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, hist = train_nnp(model, cfg, species, pos, _lj_dimer(dists), f_ref,
                            steps=NNP_STEPS, learning_rate=NNP_LR)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    errs = {}
    with torch.no_grad():
        for r in NNP_CHECK_R:
            x = torch.tensor([[0.0, 0, 0], [r, 0, 0]], dtype=torch.float32, device=DEVICE)
            errs[r] = abs(float(nnp_energy(model, cfg, species, x)) - _lj_dimer(r))
    log("nnp_train", steps=NNP_STEPS, seconds=f"{train_s:.3f}",
        steps_per_s=f"{NNP_STEPS / train_s:.2f}", loss_first=hist[0], loss_last=hist[-1],
        **{f"E_err_{r}A": f"{e:.5f}" for r, e in errs.items()})
    require(hist[-1] < NNP_LOSS_DROP * hist[0], f"NNP loss {hist[0]} -> {hist[-1]}")
    require(max(errs.values()) < NNP_E_TOL, f"NNP well off LJ by {errs}")

    mol = Molecule()
    mol.numAtoms = 2
    mol.atomtype = np.array(["Ar", "Ar"], dtype=object)
    mol.charge = np.zeros(2)
    mol.masses = np.array([39.95, 39.95])
    mol.coords = np.asarray([[0.0, 0, 0], [4.4, 0, 0]])[:, :, None]
    par = Parameters(NullForcefield(mol), mol, [], precision="single")
    forces = Forces(par, terms=[], external=NNPExternal(model, cfg, species),
                    precision="single", device=DEVICE)
    system = System(2, 1, "single")
    system.set_positions(mol.coords)
    integ = Integrator(system, forces, timestep=5.0, device=DEVICE)
    seps = []
    for _ in range(NNP_MD_STEPS // 10):
        integ.step(niter=10)
        seps.append(float(np.linalg.norm(system.pos[0, 1] - system.pos[0, 0])))
    seps = np.asarray(seps)
    log("nnp_md", steps=NNP_MD_STEPS, sep_min=f"{seps.min():.4f}", sep_max=f"{seps.max():.4f}",
        sep_std=f"{seps.std():.4f}")
    require(seps.min() > 3.0 and seps.max() < 6.5 and seps.std() > 0.01, "NNP dimer MD")

    # the default width at thrombin's size
    mol_t, par_t = load_amber(*MAIN_SYSTEM)
    _, species_t = np.unique(np.asarray(par_t.masses).reshape(-1).round(1), return_inverse=True)
    big_cfg = NNPConfig(n_species=int(species_t.max()) + 1)
    big = init_params(big_cfg, seed=0, dtype=torch.float32, device=DEVICE)
    x = torch.as_tensor(mol_t.coords[:, :, 0], dtype=torch.float32, device=DEVICE)
    spec_t = torch.as_tensor(species_t, device=DEVICE)

    def energy_forces():
        p = x.detach().requires_grad_(True)
        e = nnp_energy(big, big_cfg, spec_t, p)
        return e, torch.autograd.grad(e, p)[0]

    e, f = energy_forces()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    energy_forces()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = cuda_events_ms(energy_forces, calls=5, warmup=1)
    log("nnp_thrombin", natoms=mol_t.numAtoms, species=big_cfg.n_species,
        features=big_cfg.features, ms=f"{ms:.3f}", peak_gib=f"{peak / 2**30:.3f}",
        energy=f"{float(e.detach()):.4f}", finite=bool(torch.isfinite(f).all()))
    require(bool(torch.isfinite(f).all()), "NNP forces at thrombin's width not finite")
    del big, e, f
    torch.cuda.empty_cache()


def _cg_training(dtype, n_conf=TRAIN_B, seed=0, mesh=None, device=None):
    """(trainer, state, pos, box, f_ref, e_ref, ffp_true, cfg) of
    examples/train_cg.py's recipe on the card at `dtype` (the trainer on
    `mesh` when given)."""
    import functools

    import torch

    from torchmd_tpu_torch.forcefields import ForceField
    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.parameters import Parameters
    from torchmd_tpu_torch.potentials import total_energy
    from torchmd_tpu_torch.train import ForceMatchingTrainer

    terms = ["bonds", "angles", "repulsioncg"]
    cgdir = os.path.join(REPO, "tests", "systems", "cg")
    mol = Molecule(os.path.join(cgdir, "cg_structure.psf"))
    mol.read(os.path.join(cgdir, "cg_structure.xtc"))
    ff = ForceField.create(mol, os.path.join(cgdir, "forcefield.yaml"))
    device = device or DEVICE
    prec = "double" if dtype == torch.float64 else "single"
    par = Parameters(ff, mol, terms, precision=prec)
    forces = Forces(par, terms=terms, precision=prec, cutoff=9.0, exclusions=("bonds",),
                    device=device)
    ffp, cfg = forces.ffparams, forces.config
    base = mol.coords[:, :, 0].astype(np.float64)
    rs = np.random.RandomState(seed)
    pos = torch.as_tensor(base[None] + 0.25 * rs.randn(n_conf, *base.shape), dtype=dtype,
                          device=device)
    box = torch.zeros((n_conf, 3), dtype=dtype, device=device)
    x = pos.clone().requires_grad_(True)
    e_ref = torch.func.vmap(lambda p, b: total_energy(ffp, p, b, cfg))(x, box)
    (g,) = torch.autograd.grad(e_ref.sum(), x)
    start = ffp._replace(
        bonds=ffp.bonds._replace(params=ffp.bonds.params * torch.tensor(
            [[1.4, 1.05]], dtype=dtype, device=device)),
        angles=ffp.angles._replace(params=ffp.angles.params * torch.tensor(
            [[0.7, 0.95]], dtype=dtype, device=device)),
        lj_params=ffp.lj_params * 1.2)
    trainer = ForceMatchingTrainer(start, cfg, trainable=("bonds", "angles", "lj"),
                                   optimizer=functools.partial(torch.optim.Adam, lr=TRAIN_LR),
                                   energy_weight=TRAIN_EW, mesh=mesh)
    return trainer, trainer.init(), pos, box, -g.detach(), e_ref.detach(), ffp, cfg


def phase_train():
    """examples/train_cg.py's recipe on the card: TRAIN_STEPS force-matching
    steps at f32 (steps/s, the loss, the recovered bond lengths, a held-out
    force RMSE); TRAIN_CHECK_STEPS steps at f32 against f64. Launches none
    of the kernels #1-#8 (the loss's double backward runs torch ops)."""
    import torch

    from torchmd_tpu_torch.potentials import total_energy

    trainer, state, pos, box, f_ref, e_ref, ffp_true, cfg = _cg_training(torch.float32)
    params = {}
    for dt in (torch.float32, torch.float64):
        tr, st, *data = _cg_training(dt)
        for _ in range(TRAIN_CHECK_STEPS):
            st, _ = tr.step(st, *data[:4])
        params[dt] = {k: v.detach().double().cpu().numpy() for k, v in st.params.items()}
    rel = max(float(np.abs(params[torch.float32][k] - v).max() / np.abs(v).max())
              for k, v in params[torch.float64].items())
    log("train_check", steps=TRAIN_CHECK_STEPS, f32_vs_f64_rel=rel)
    require(rel <= TRAIN_REL, f"force matching f32 off f64 by {rel}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(TRAIN_STEPS):
        state, loss = trainer.step(state, pos, box, f_ref, e_ref)
        if i % 250 == 0 or i == TRAIN_STEPS - 1:
            losses.append(float(loss))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    learned = trainer.ffparams(state)
    bond_err = float((learned.bonds.params[:, 1] - ffp_true.bonds.params[:, 1]).abs().max())
    rs = np.random.RandomState(1)
    test = pos[:8].detach() + 0.25 * torch.as_tensor(rs.randn(*pos[:8].shape),
                                                       dtype=pos.dtype, device=DEVICE)

    def forces_of(ffp):
        x = test.clone().requires_grad_(True)
        e = torch.func.vmap(lambda p, b: total_energy(ffp, p, b, cfg))(x, box[:8])
        return -torch.autograd.grad(e.sum(), x)[0]

    rmse = float(((forces_of(learned) - forces_of(ffp_true)) ** 2).mean().sqrt())
    log("train", steps=TRAIN_STEPS, seconds=f"{dt:.3f}", steps_per_s=f"{TRAIN_STEPS / dt:.2f}",
        loss_first=losses[0], loss_last=losses[-1], bond_length_err_A=f"{bond_err:.5f}",
        heldout_force_rmse=f"{rmse:.4f}", conformations=TRAIN_B)
    require(losses[-1] <= TRAIN_LOSS_DROP * losses[0], f"training loss {losses}")
    return TRAIN_STEPS / dt


# ----------------------------------------------------------------------
# The device mesh (parallel/): one process per rank, spawned by
# parallel.launch after phase_build has built every kernel (the ranks load
# the built libraries). The script needs one card, and NCCL takes one
# rank per card, so the mesh runs one NCCL rank, or 2 and 4 gloo ranks
# sharing cuda:0 (gloo runs the mesh's collectives on CUDA tensors, torch
# 2.11). Times of W ranks on one card check the decomposition; they say
# nothing of scaling across cards.
# ----------------------------------------------------------------------
MESH_CFG = dict(
    device="cuda:0", w1_backend="nccl", main_system=MAIN_SYSTEM, water=(WATER_N, WATER_SPACING, WATER_CUTOFF),
    steps=10,                   # the trajectory checks
    water_warmup=WATER_WARMUP,  # sharded steps to the water check's start
    t_steps=200, t_chunk=10,    # spatial thrombin's Langevin T gate
    timed=100, timed_chunk=50,  # steps/s
    mtk_chunks=2, mtk_steps=20,
    replicas=REPLICAS, train_b=TRAIN_B, train_steps=3,
)
MESH_NCCL_TOL = 1e-5            # A: one NCCL rank against the unsharded run
# A: W gloo ranks against the unsharded run (thrombin, the replicas); the
# water box is held to WATER_FLOOR_FACTOR x its one-ulp floor instead,
# which reads ~2e-3 A after 10 steps (its unsharded runs differ by ~2e-4
# A between ranks: the PME spread's atomics), and this bound is logged
MESH_TRAJ_TOL = 1e-3
# K: the spatial Langevin run's mean T over its last half, at friction
# MESH_T_GAMMA ps^-1 (as the GB phase's gate: at the main path's 0.1 ps^-1
# the minimised start's 300 K shares its kinetic energy with the potential
# and the 10 ps relaxation has not brought it back in 0.4 ps; 207 K on the
# card)
MESH_T_TOL, MESH_T_GAMMA = 15.0, 10.0
MESH_MTK_BOX_REL, MESH_MTK_POS_TOL = 1e-5, 1e-3   # spatial MTK against dense MTK, f32
MESH_TRAIN_REL = 1e-10          # the sharded trainer against the unsharded, f64


def _mesh_ms(fn, device, calls=30, warmup=3):
    """Device ms of fn() on this rank (CUDA events); None off the card."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    return cuda_events_ms(fn, calls, warmup)


def _mesh_sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _one_at_a_time(fn):
    """fn() on each rank in turn (the others wait at a barrier): timings
    of one rank's kernel with the card otherwise idle."""
    import torch.distributed as dist

    out = None
    for r in range(dist.get_world_size()):
        if dist.get_rank() == r:
            out = fn()
        dist.barrier()
    return out


def _rank_thrombin(rank, cfg, world):
    """One rank of spatial thrombin (the main-path configuration: 7 terms,
    cutoff 7.3 A, reaction field, no box, Langevin 300 K, 2 fs, f32): the
    row range of #1 against its plain f64 version and bit for bit against
    the full launch's rows, timed one rank at a time; 10 steps against
    the unsharded kernel run from one start; t_steps Langevin steps at
    MESH_T_GAMMA with the counters reset just before and read just after
    (mean T of the last half); steps/s of the sharded run (and of the
    unsharded one on this rank)."""
    import torch

    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.parallel import make_mesh
    from torchmd_tpu_torch.parallel.spatial import padded_rows
    from torchmd_tpu_torch.systems import System

    dev = torch.device(cfg["device"])
    mesh = make_mesh(axes=("sp",), device=dev)
    mol, par = load_amber(*cfg["main_system"])
    forces = Forces(par, terms=TERMS, precision="single", cutoff=CUTOFF, rfa=RFA, device=dev)
    n = mol.numAtoms
    vel0 = maxwell_boltzmann(par.masses, TEMP, 1, seed=1, device=dev, dtype=torch.float32)

    def run(m, steps, chunk, gamma=GAMMA):
        system = System(n, 1, "single")
        system.set_positions(mol.coords)
        system.set_velocities(vel0)
        kw = {} if m is None else dict(mesh=m, mesh_axis="sp", shard="spatial")
        integ = Integrator(system, forces, TIMESTEP, gamma=gamma, T=TEMP, seed=2, **kw)
        temps = [integ.step(niter=chunk)[2][0] for _ in range(steps // chunk)]
        return system, integ, temps

    ref, _, _ = run(None, cfg["steps"], cfg["steps"])
    got, _, _ = run(mesh, cfg["steps"], cfg["steps"])
    dev_a = float(np.abs(got.pos - ref.pos).max())

    # the row range of #1 on the start: plain f64, the full launch's rows
    d32 = kn.prepare_nb_data(forces.ffparams)
    f64 = Forces(par, terms=TERMS, precision="double", cutoff=CUTOFF, rfa=RFA, device=dev)
    d64 = kn.prepare_nb_data(f64.ffparams)
    ncfg = forces.config
    p64 = torch.as_tensor(mol.coords[:, :, 0], dtype=torch.float64, device=dev)
    p32 = p64.float().contiguous()
    rows = padded_rows(n, world) // world
    nt = -(-n // 32)
    tiles = (min(rank * rows // 32, nt), min(nt, (rank + 1) * rows // 32))
    lo, hi = kn.row_span(n, tiles)
    pot_k, f_k = kn.nonbonded_energy_forces(d32, ncfg, p32, rows=tiles)
    pot_p, f_p = kn.pair_terms_reference(d64, ncfg, p64, rows=tiles)
    _, f_full = kn.nonbonded_energy_forces(d32, ncfg, p32)
    _mesh_sync(dev)
    # a rank past the last atom has no rows (small systems only)
    err = _compare(f"rank{rank}/pair_rows", pot_k, f_k, pot_p, f_p) if hi > lo else 0.0
    bitwise = bool(torch.equal(f_k, f_full[lo:hi]))
    require(bitwise, f"rank {rank}: the row range's forces differ from the full launch's rows")
    share = (hi - lo) / n
    npairs = _thrombin_pair_count(d32, CUTOFF, p32)
    b_ms, b_by = bound(tensor_bytes(p32, d32.q, d32.sig, d32.eps, d32.types, d32.excl_start,
                                    d32.excl_tile, d32.excl_bits, p32),
                       pair_flops(npairs, "rfa"))
    times = _one_at_a_time(lambda: dict(
        ms=_mesh_ms(lambda: kn.nonbonded_energy_forces(d32, ncfg, p32, rows=tiles), dev),
        plain_ms=_mesh_ms(lambda: kn.pair_terms_reference(d32, ncfg, p32, rows=tiles), dev)))
    del f64, d64

    # the Langevin T gate, the counters reset just before and read just after
    _mesh_sync(dev)
    kn.LAUNCHES = kn.ROW_LAUNCHES = kb.LAUNCHES = 0
    mesh.calls.clear()
    _, _, temps = run(mesh, cfg["t_steps"], cfg["t_chunk"], MESH_T_GAMMA)
    _mesh_sync(dev)
    launches = {"pair_rows": kn.ROW_LAUNCHES, "pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}
    collectives = dict(mesh.calls)

    def steps_per_s(m):
        system, integ, _ = run(m, cfg["timed_chunk"], cfg["timed_chunk"])
        _mesh_sync(dev)
        t0 = time.perf_counter()
        for _ in range(cfg["timed"] // cfg["timed_chunk"]):
            integ.step(niter=cfg["timed_chunk"])
        _mesh_sync(dev)
        return cfg["timed"] / (time.perf_counter() - t0)

    sps = steps_per_s(mesh)
    sps_unsharded = steps_per_s(None) if world == 1 else None
    return dict(dev_A=dev_a, err=err, bitwise=bitwise, tiles=tiles, rows=hi - lo,
                ms=times["ms"], plain_ms=times["plain_ms"],
                bound=(b_ms * share, b_by), mean_T=float(np.mean(temps[len(temps) // 2:])),
                launches=launches, collectives=collectives, sps=sps, sps_unsharded=sps_unsharded,
                finite=bool(np.all(np.isfinite(got.pos))))


def _rank_water(rank, cfg):
    """One rank of the spatial water box (62,500 TIP4P/2005 sites, PME
    order 4 on 80^3, SETTLE, sites, NHC, 2 fs; the cell kernel's slabs,
    column=False): water_warmup sharded steps from the lattice, then from
    that state 10 steps against the unsharded run, beside its f32 rounding
    floor (from a start moved by one ulp) and a 1 % charge control
    (SETTLE and sites on the sharded result); the slab of #4 against its
    plain f64 version, the ranks' slabs summed against the full launch,
    timed one rank at a time (rank 0 also checks and times the slabs of
    1 and 4 ranks); launches and collectives of the sharded run."""
    import copy

    import torch

    from torchmd_tpu_torch.constraints import max_settle_error
    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import pme as kp
    from torchmd_tpu_torch.parallel import make_mesh
    from torchmd_tpu_torch.parallel.spatial import slab
    from torchmd_tpu_torch.systems import System
    from torchmd_tpu_torch.vsites import apply_vsites

    dev = torch.device(cfg["device"])
    mesh = make_mesh(axes=("sp",), device=dev)
    n_w, spacing, cutoff = cfg["water"]
    mol, par, L = build_water(n_w, spacing, True)
    vel = maxwell_boltzmann(par.masses, TEMP, 1, seed=3, device=dev, dtype=torch.float32)

    from torchmd_tpu_torch.forces import Forces

    def run(m, p=par, coords=mol.coords[:, :, 0].astype(np.float32), vel=vel):
        forces = Forces(p, terms=WATER_TERMS, precision="single", cutoff=cutoff,
                        elec="ewald" if p.natoms >= 4096 else "pme", kernel="cell",
                        device=dev, column=False)
        system = System(p.natoms, 1, "single")
        system.set_positions(coords)
        system.set_box(np.full(3, L))
        system.set_velocities(vel)
        forces.compute(system.pos, system.box, system.forces)
        kw = {} if m is None else dict(mesh=m, mesh_axis="sp", shard="spatial")
        integ = Integrator(system, forces, TIMESTEP, constraints="settle", T=TEMP,
                           thermostat="nhc", tau=WATER_TAU, **kw)
        return system, forces, integ

    # the start: water_warmup sharded steps from the lattice (whose first
    # steps melt it), the same state on every rank (a sharded run's end is
    # gathered); then from it the unsharded run, its f32 rounding floor (the
    # start moved by one ulp per coordinate) and a fault control (every
    # charge x 1.01), as water_trajectory_check holds the kernel path
    warm, _, warm_integ = run(mesh)
    warm_integ.step(niter=cfg["water_warmup"])
    p32 = warm.pos[0].astype(np.float32)
    vel = torch.as_tensor(warm.vel, device=dev)
    del warm_integ
    one_ulp = np.random.RandomState(4).rand(*p32.shape) < 0.5
    moved = np.where(one_ulp, np.nextafter(p32, np.float32(np.inf)),
                     np.nextafter(p32, np.float32(-np.inf)))
    wrong = copy.copy(par)
    wrong.charges = par.charges * (1.0 + WATER_CONTROL_Q[-1])
    ends = {}
    for label, kw in (("ref", {}), ("ulp", dict(coords=moved)), ("control", dict(p=wrong))):
        s_, _, integ_ = run(None, coords=kw.get("coords", p32), p=kw.get("p", par), vel=vel)
        integ_.step(niter=cfg["steps"])
        ends[label] = s_.pos.copy()
        del integ_
    ref = ends["ref"]
    floor = float(np.abs(ends["ulp"] - ref).max())
    control = float(np.abs(ends["control"] - ref).max())
    system, forces, integ = run(mesh, coords=p32, vel=vel)
    _mesh_sync(dev)
    kc.LAUNCHES = kc.SLAB_LAUNCHES = kp.SPREAD_LAUNCHES = kp.GATHER_LAUNCHES = kb.LAUNCHES = 0
    mesh.calls.clear()
    integ.step(niter=cfg["steps"])
    _mesh_sync(dev)
    launches = {"cell_slab": kc.SLAB_LAUNCHES, "cell": kc.LAUNCHES,
                "pme_spread": kp.SPREAD_LAUNCHES, "pme_gather": kp.GATHER_LAUNCHES,
                "bonded": kb.LAUNCHES}
    collectives = dict(mesh.calls)
    dev_a = float(np.abs(system.pos - ref).max())
    pos = torch.as_tensor(system.pos[0], dtype=torch.float64, device=dev)
    box64 = torch.full((3,), L, dtype=torch.float64, device=dev)
    settle_err = float(max_settle_error(integ.constraints.settle, pos))
    sites = forces.vsites[0].sites
    site_err = float((pos[sites] - apply_vsites(forces.vsites, pos, box64)[sites]).abs().max())

    # the slab of #4 on the end state
    kern = forces._cell_kernel
    d32, ncfg, clcfg = kern.data, kern.cfg, kern.clcfg
    p32 = pos.float().contiguous()
    b32 = box64.float()
    cl = kern.build(p32, b32)
    f64 = Forces(par, terms=WATER_TERMS, precision="double", cutoff=cutoff, elec="ewald",
                 kernel="cell", device=dev, column=False, plain=True)
    f64.ensure_cell_kernel(np.full(3, L), pos0=system.pos[0], allow_column=False)
    d64 = f64._cell_kernel.data
    cl64 = cl._replace(ref_pos=cl.ref_pos.double())
    sl = slab(clcfg.ncells[0], mesh.shape["sp"], mesh.index("sp"))
    pot_k, f_k = kc.cell_energy_forces(d32, ncfg, clcfg, cl, p32, b32, slab=sl)
    pot_p, f_p = kc.cell_reference(d64, ncfg, clcfg, cl64, pos, box64, slab=sl)
    pot_full, f_full = kc.cell_energy_forces(d32, ncfg, clcfg, cl, p32, b32)
    _mesh_sync(dev)
    err = _compare(f"rank{rank}/cell_slab", pot_k, f_k, pot_p, f_p)
    f_sum = mesh.all_reduce(f_k, "sp")
    e_sum = {k: float(mesh.all_reduce(v.reshape(1), "sp")[0]) for k, v in pot_k.items()}
    sum_err = _compare(f"rank{rank}/slab_sum", {k: torch.tensor(v) for k, v in e_sum.items()},
                       f_sum, pot_full, f_full)
    ncells = int(np.prod(clcfg.ncells))
    npairs = _water_pair_count(d32, p32, b32, cutoff)
    b_ms, b_by = bound(tensor_bytes(p32, d32.q, d32.sig, d32.eps, cl.slots, cl.counts,
                                    d32.excl, p32), pair_flops(npairs, "ewald"))

    def timed(s_k):
        """ms, plain ms and the bound of the slab s_k's share of cells."""
        a, b = kc.slab_cells(clcfg, s_k)
        return dict(cells=b - a, bound=(b_ms * (b - a) / ncells, b_by),
                    ms=_mesh_ms(lambda: kc.cell_energy_forces(d32, ncfg, clcfg, cl, p32, b32,
                                                              slab=s_k), dev),
                    plain_ms=_mesh_ms(lambda: kc.cell_reference(d32, ncfg, clcfg, cl, p32, b32,
                                                                slab=s_k),
                                      dev, calls=PLAIN_CALLS, warmup=1))

    def other_layouts():
        """Rank 0 checks and times the slabs of 1 and 4 ranks too."""
        out = []
        for world in (1, 4):
            for k in range(world):
                s_k = slab(clcfg.ncells[0], world, k)
                pk, fk = kc.cell_energy_forces(d32, ncfg, clcfg, cl, p32, b32, slab=s_k)
                pp, fp = kc.cell_reference(d64, ncfg, clcfg, cl64, pos, box64, slab=s_k)
                e = _compare(f"W={world}/slab{k}", pk, fk, pp, fp)
                out.append(dict(world=world, rank=k, err=e, **timed(s_k)))
        return out

    times = _one_at_a_time(lambda: timed(sl))
    others = _one_at_a_time(lambda: other_layouts() if rank == 0 else [])
    del f64, d64, cl64
    return dict(dev_A=dev_a, floor_A=floor, control_A=control, settle_err=settle_err,
                site_err=site_err, err=err,
                sum_err=sum_err, slab=sl, cells=times["cells"], ms=times["ms"],
                plain_ms=times["plain_ms"], bound=times["bound"], others=others,
                launches=launches, collectives=collectives,
                finite=bool(np.all(np.isfinite(system.pos))))


def _rank_mtk(rank, cfg):
    """One rank of spatial MTK on tests/test_mtk.py's argon gas (1,000
    atoms, lj, cutoff 9 A, NHC at 120 K, 4x the ideal-gas pressure, tau_p
    2000 fs, 2 fs, f32): the box and positions against the unsharded
    dense MTK run from one start."""
    import torch

    from torchmd_tpu_torch.barostat import MTKBarostat
    from torchmd_tpu_torch.forcefields import ForceField
    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.observables import ideal_gas_pressure
    from torchmd_tpu_torch.parallel import make_mesh
    from torchmd_tpu_torch.parameters import Parameters
    from torchmd_tpu_torch.systems import System

    dev = torch.device(cfg["device"])
    mesh = make_mesh(axes=("sp",), device=dev)
    d = os.path.join(REPO, "tests", "systems", "argon")
    mol = Molecule(os.path.join(d, "argon_start.pdb"))
    ff = ForceField.create(mol, os.path.join(d, "argon_forcefield.yaml"))
    par = Parameters(ff, mol, ["lj"], precision="single")
    L = 77.395
    P = ideal_gas_pressure(mol.numAtoms, 120.0, L**3)
    vel = maxwell_boltzmann(par.masses, 120.0, 1, seed=6, device=dev, dtype=torch.float32)

    def run(m):
        forces = Forces(par, terms=["lj"], precision="single", cutoff=9.0, device=dev)
        system = System(mol.numAtoms, 1, "single")
        system.set_positions(mol.coords)
        system.set_box(np.full(3, L))
        system.set_velocities(vel)
        forces.compute(system.pos, system.box, system.forces)
        kw = {} if m is None else dict(mesh=m, mesh_axis="sp", shard="spatial")
        integ = Integrator(system, forces, TIMESTEP, T=120.0, thermostat="nhc",
                           barostat=MTKBarostat(4.0 * P, 120.0, tau_fs=2000.0), seed=7, **kw)
        for _ in range(cfg["mtk_chunks"]):
            integ.step(niter=cfg["mtk_steps"])
        return system

    ref = run(None)
    mesh.calls.clear()
    got = run(mesh)
    box_rel = float(np.abs(got.box_diag / ref.box_diag - 1.0).max())
    return dict(box=got.box_diag[0].tolist(), box_rel=box_rel,
                dev_A=float(np.abs(got.pos - ref.pos).max()),
                volume_ratio=float(np.prod(got.box_diag[0]) / L**3),
                collectives=dict(mesh.calls), finite=bool(np.all(np.isfinite(got.pos))))


def _rank_replicas(rank, cfg):
    """One rank of the replica-sharded thrombin ladder (replicas at 300 K,
    Langevin, each from its own Maxwell-Boltzmann draw): each replica's
    10 steps against the single-process run of all replicas, and the
    launches of #1 and #3 of the sharded run (one each per evaluation of
    the rank's replicas)."""
    import torch

    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.parallel import make_mesh
    from torchmd_tpu_torch.systems import System

    dev = torch.device(cfg["device"])
    mesh = make_mesh(axes=("dp",), device=dev)
    mol, par = load_amber(*cfg["main_system"])
    nrep = cfg["replicas"]
    forces = Forces(par, terms=TERMS, precision="single", cutoff=CUTOFF, rfa=RFA, device=dev)
    vel = torch.cat([maxwell_boltzmann(par.masses, TEMP, 1, seed=r, device=dev,
                                       dtype=torch.float32) for r in range(nrep)])

    def run(m):
        system = System(mol.numAtoms, nrep, "single")
        system.set_positions(mol.coords)
        system.set_velocities(vel)
        kw = {} if m is None else dict(mesh=m, mesh_axis="dp")
        integ = Integrator(system, forces, TIMESTEP, gamma=GAMMA, T=TEMP, seed=5, **kw)
        _mesh_sync(dev)
        kn.LAUNCHES = kb.LAUNCHES = 0
        integ.step(niter=cfg["steps"])
        _mesh_sync(dev)
        return system, {"pair": kn.LAUNCHES, "bonded": kb.LAUNCHES}

    ref, _ = run(None)
    mesh.calls.clear()
    got, launches = run(mesh)
    dev_a = np.abs(got.pos - ref.pos).reshape(nrep, -1).max(1)
    return dict(dev_A=dev_a.tolist(), launches=launches, collectives=dict(mesh.calls),
                finite=bool(np.all(np.isfinite(got.pos))))


def _rank_train(rank, cfg):
    """One rank of the sharded force matching (examples/train_cg.py's
    recipe, TRAIN_B conformations, f64, Adam): dp x sp = 1 x W, every
    conformation's rows over the ranks; losses and parameters against
    the unsharded trainer on this rank."""
    import torch
    import torch.distributed as dist

    from torchmd_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axes=("dp", "sp"), shape=(1, dist.get_world_size()),
                     device=cfg["device"])
    out = {}
    for label, m in (("unsharded", None), ("sharded", mesh)):
        trainer, state, *data = _cg_training(torch.float64, n_conf=cfg["train_b"], mesh=m,
                                             device=cfg["device"])
        losses = []
        for _ in range(cfg["train_steps"]):
            state, loss = trainer.step(state, *data[:4])
            losses.append(float(loss))
        out[label] = (np.asarray(losses),
                      {k: v.detach().cpu().numpy() for k, v in state.params.items()})
    (l0, p0), (l1, p1) = out["unsharded"], out["sharded"]
    rel = max([float(np.abs(l1 / l0 - 1.0).max())]
              + [float(np.abs(p1[k] - v).max() / np.abs(v).max()) for k, v in p0.items()])
    return dict(losses=l1.tolist(), rel=rel, collectives=dict(mesh.calls))


def _collectives_total(outs):
    total = {}
    for o in outs:
        for k, v in o["collectives"].items():
            total[k] = total.get(k, 0) + v
    return total


def _thrombin_launches(cfg, o):
    """The launches of spatial thrombin's T-gate run on one rank: one row
    range of #1 (none for a rank with no rows) and one #3 a step."""
    steps = cfg["t_steps"]
    return {"pair_rows": steps if o["rows"] else 0, "pair": 0, "bonded": steps}


def phase_mesh(cfg=None):
    """The device mesh on the card (the module docstring's phase 29):
    mesh_nccl, spatial_thrombin at W = 2 and 4, spatial_water,
    spatial_mtk, replica_mesh and train_mesh. Returns the kernel entries
    of the row range (#1) and the slab (#4) and their launches."""
    from torchmd_tpu_torch.parallel.launch import Ranks

    cfg = dict(MESH_CFG, **(cfg or {}))
    dev = cfg["device"]
    cores = len(os.sched_getaffinity(0))
    collectives = {}
    t0 = time.perf_counter()
    with Ranks(1, backend=cfg["w1_backend"], device=dev, threads=cores,
               timeout=600) as ranks:
        (nccl,) = ranks.run(_rank_thrombin, cfg, 1)
    log("mesh_nccl", world=1, backend=cfg["w1_backend"], max_pos_dev_A=nccl["dev_A"],
        steps=cfg["steps"], sharded_steps_per_s=f"{nccl['sps']:.2f}",
        unsharded_steps_per_s=f"{nccl['sps_unsharded']:.2f}",
        overhead=f"{nccl['sps_unsharded'] / nccl['sps']:.3f}", pair_rows_launches=
        nccl["launches"]["pair_rows"], mean_T=f"{nccl['mean_T']:.2f}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    require(nccl["dev_A"] <= MESH_NCCL_TOL, f"one NCCL rank off the unsharded run by "
            f"{nccl['dev_A']} A")
    require(nccl["finite"], "non-finite positions on the NCCL rank")
    require(nccl["launches"] == _thrombin_launches(cfg, nccl),
            f"NCCL rank: launches {nccl['launches']} (one row range and one bonded "
            "launch a step)")
    collectives["mesh_nccl"] = nccl["collectives"]

    rows = {1: [nccl]}
    with Ranks(2, backend="gloo", device=dev, threads=max(1, cores // 2),
               timeout=900) as ranks:
        t0 = time.perf_counter()
        rows[2] = ranks.run(_rank_thrombin, cfg, 2)
        log("spatial_thrombin_wall", world=2, seconds=f"{time.perf_counter() - t0:.1f}")
        t0 = time.perf_counter()
        water = ranks.run(_rank_water, cfg)
        log("spatial_water_wall", world=2, seconds=f"{time.perf_counter() - t0:.1f}")
        t0 = time.perf_counter()
        mtk = ranks.run(_rank_mtk, cfg)
        replicas = ranks.run(_rank_replicas, cfg)
        train = ranks.run(_rank_train, cfg)
        log("mesh_rest_wall", world=2, seconds=f"{time.perf_counter() - t0:.1f}")
    with Ranks(4, backend="gloo", device=dev, threads=max(1, cores // 4),
               timeout=900) as ranks:
        rows[4] = ranks.run(_rank_thrombin, cfg, 4)

    for world in (2, 4):
        outs = rows[world]
        for r, o in enumerate(outs):
            log("spatial_thrombin", world=world, rank=r, tiles=o["tiles"], rows=o["rows"],
                pair_rows_max_abs_err=o["err"], bitwise_vs_full=o["bitwise"],
                max_pos_dev_A=o["dev_A"], mean_T=f"{o['mean_T']:.2f}",
                steps_per_s=f"{o['sps']:.2f}", label="W ranks sharing one card (gloo)",
                **{f"{k}_launches": v for k, v in o["launches"].items()})
            require(o["dev_A"] <= MESH_TRAJ_TOL, f"W={world} rank {r}: {o['dev_A']} A off "
                    "the unsharded run")
            require(abs(o["mean_T"] - TEMP) <= MESH_T_TOL, f"W={world}: mean T {o['mean_T']}")
            require(o["finite"], f"W={world}: non-finite positions")
            require(o["launches"] == _thrombin_launches(cfg, o),
                    f"W={world} rank {r}: launches {o['launches']} (one row range and one "
                    "bonded launch a step)")
        collectives[f"spatial_thrombin_w{world}"] = _collectives_total(outs)
    for world, outs in rows.items():
        for r, o in enumerate(outs):
            log("mesh_kernels", kernel="pair_rows", world=world, rank=r, rows=o["rows"],
                ms=o["ms"], plain_ms=o["plain_ms"], bound_ms=f"{o['bound'][0]:.5f}",
                bound_by=o["bound"][1], max_abs_err=o["err"])

    for r, o in enumerate(water):
        limit = WATER_FLOOR_FACTOR * o["floor_A"]
        log("spatial_water", world=2, rank=r, slab=o["slab"], cells=o["cells"],
            max_pos_dev_A=o["dev_A"], within_mesh_traj_tol=o["dev_A"] <= MESH_TRAJ_TOL,
            ulp_floor_A=o["floor_A"], limit_A=limit, charge_control_A=o["control_A"],
            settle_max_err_A=o["settle_err"],
            site_max_err_A=o["site_err"], cell_slab_max_abs_err=o["err"],
            slab_sum_max_abs_err=o["sum_err"],
            **{f"{k}_launches": v for k, v in o["launches"].items()})
        log("mesh_kernels", kernel="cell_slab", world=2, rank=r, cells=o["cells"],
            ms=o["ms"], plain_ms=o["plain_ms"], bound_ms=f"{o['bound'][0]:.5f}",
            bound_by=o["bound"][1], max_abs_err=o["err"])
        require(o["dev_A"] <= limit, f"water rank {r}: {o['dev_A']} A off the unsharded "
                f"run, beyond {WATER_FLOOR_FACTOR} x its one-ulp floor {o['floor_A']} A")
        require(o["control_A"] > limit, f"the water charge control moved only "
                f"{o['control_A']} A")
        require(o["settle_err"] < 1e-3 and o["site_err"] < 1e-4,
                f"water rank {r}: SETTLE {o['settle_err']}, sites {o['site_err']}")
        require(o["finite"], "non-finite water positions")
        # one slab (none for a rank past the grid), one spread and one gather
        # a step; the TIP4P/2005 topology has no bonded table (its waters are
        # [ settles ])
        steps = cfg["steps"]
        require(o["launches"] == {"cell_slab": steps if o["cells"] else 0, "cell": 0,
                                  "pme_spread": steps, "pme_gather": steps, "bonded": 0},
                f"water rank {r}: launches {o['launches']}")
        for t in o["others"]:
            log("mesh_kernels", kernel="cell_slab", world=t["world"], rank=t["rank"],
                cells=t["cells"], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=f"{t['bound'][0]:.5f}", bound_by=t["bound"][1], max_abs_err=t["err"])
    collectives["spatial_water"] = _collectives_total(water)

    for r, o in enumerate(mtk):
        log("spatial_mtk", world=2, rank=r, box=o["box"], box_rel_dev=o["box_rel"],
            max_pos_dev_A=o["dev_A"], volume_ratio=f"{o['volume_ratio']:.5f}")
        require(o["box_rel"] <= MESH_MTK_BOX_REL and o["dev_A"] <= MESH_MTK_POS_TOL,
                f"spatial MTK rank {r}: box {o['box_rel']}, positions {o['dev_A']} A")
        require(NPT_VOLUME_RANGE[0] <= o["volume_ratio"] <= NPT_VOLUME_RANGE[1],
                f"spatial MTK volume ratio {o['volume_ratio']}")
        require(o["finite"], "non-finite spatial MTK positions")
    collectives["spatial_mtk"] = _collectives_total(mtk)

    for r, o in enumerate(replicas):
        log("replica_mesh", world=2, rank=r, replicas=cfg["replicas"],
            max_pos_dev_A=max(o["dev_A"]), pair_launches=o["launches"]["pair"],
            bonded_launches=o["launches"]["bonded"])
        require(max(o["dev_A"]) <= MESH_TRAJ_TOL, f"replica rank {r}: {o['dev_A']}")
        require(o["launches"] == {"pair": cfg["steps"], "bonded": cfg["steps"]},
                f"replica rank {r}: launches {o['launches']} (one each an evaluation)")
        require(o["finite"], "non-finite replica positions")
    collectives["replica_mesh"] = _collectives_total(replicas)

    for r, o in enumerate(train):
        log("train_mesh", world=2, rank=r, mesh="1x2", steps=cfg["train_steps"],
            losses=o["losses"], rel_vs_unsharded=o["rel"])
        require(o["rel"] <= MESH_TRAIN_REL, f"sharded trainer off by {o['rel']}")
    collectives["train_mesh"] = _collectives_total(train)
    # what the ranks' collectives were, summed over the ranks of each run;
    # gloo takes them on the card's tensors, so none went through the host
    for phase, counts in collectives.items():
        log("mesh_collectives", of=phase, host_staged="none", **counts)

    def entry(kernel, outs, launches):
        worst = max(outs, key=lambda o: o["ms"] or 0.0)
        return dict(ms=worst["ms"], plain_ms=worst["plain_ms"], bound=worst["bound"],
                    max_abs_err=max(o["err"] for o in outs)), launches

    return {"pair_rows": entry("pair_rows", rows[2], sum(
                o["launches"]["pair_rows"] for o in rows[2])),
            "cell_slab": entry("cell_slab", water, sum(
                o["launches"]["cell_slab"] for o in water))}


# ----------------------------------------------------------------------
# Halo-exchange MD (phase 31; `python3 chip_smoke.py --halo` runs it
# alone): solvated alanine dipeptide (tests/data/prod_alanine_dipeptide_
# amber: 688 atoms, box 19.84 x 19.62 x 19.63 A) tiled HALO_TILE into
# 44,032 atoms in 79.4 x 78.5 x 78.5 A, at its input's settings (cutoff
# 9 A, switch 7.5 A, all AMBER terms) under the halo's classic Ewald
# (kmax 32 an axis), hbonds SHAKE groups owned whole, 2 fs. Layouts: one
# NCCL rank (W = 1), 2 and 4 gloo slabs and 2 x 2 gloo pencils sharing
# cuda:0. Each rank: its halo kernel against the plain f64 version at the
# Pallas bars and timed one rank at a time; a zero-velocity step (no
# constraints) whose summed energy and half-kick forces are held to the
# unsharded port with the same exact Ewald sum (`EwaldRecip`); two runs of
# 10 NVE steps, each held to the unsharded Integrator at f64 within
# WATER_FLOOR_FACTOR x the unsharded f32 run's own distance from it: one
# without constraints at HALO_FREE_DT (the sharp check: within
# MESH_TRAJ_TOL of the unsharded f32 run too, and a HALO_FREE_CONTROL_Q
# charge control beyond the limit), one with hbonds at 2 fs (a 1 % charge
# control beyond; whether within MESH_TRAJ_TOL of the unsharded f32 run is
# logged). f32 SHAKE sets the second's floor: its fixed point carries
# ~10 position ulps of noise each step (scripts/halo_floor.py), 3.7e-3 A
# after 10 steps here, far above the unconstrained floor; HALO_CFG
# ["t_steps"] timed Langevin steps at MESH_T_GAMMA, the counters reset
# just before and read just after.
# ----------------------------------------------------------------------
HALO_CFG = dict(device="cuda:0", w1_backend="nccl", tile=(4, 4, 4), steps=10, t_steps=200,
                t_chunk=20, plain_calls=1, layouts=("w1", "w2", "w4", "p2x2"))
# layout: (ranks, mesh axes, mesh shape, the halo's axis or axes)
HALO_LAYOUTS = {"w1": (1, ("sp",), None, "sp"), "w2": (2, ("sp",), None, "sp"),
                "w4": (4, ("sp",), None, "sp"),
                "p2x2": (4, ("spx", "spy"), (2, 2), ("spx", "spy"))}
HALO_E_REL = 2e-5        # summed energy against the unsharded port, both f32
HALO_F_REL = 1e-4        # half-kick forces against the unsharded port, of max |F|
# the halo kernel against its plain f64 version: tests/test_pallas.py:51-57
HALO_KERNEL_E_REL, HALO_KERNEL_F_REL = 2e-5, 5e-5
HALO_FREE_DT = 1.0           # fs: the NVE check without constraints
HALO_FREE_CONTROL_Q = 1e-3   # its fault control: every charge 0.1 % larger


def halo_system(tile, precision="single"):
    """(mol, par) of the alanine dipeptide box tiled tile[0] x tile[1] x
    tile[2] (every topology table shifted by the copy's atom offset)."""
    import copy

    from torchmd_tpu_torch.forcefields.ff_amber import AmberForcefield
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.parameters import Parameters

    d = os.path.join(DATA, ALA_SYSTEM)
    mol = Molecule(os.path.join(d, "structure.prmtop"))
    mol.read(os.path.join(d, "input.coor"))
    mol.read(os.path.join(d, "input.xsc"))
    ff = AmberForcefield(mol, os.path.join(d, "structure.prmtop"))
    n, L = mol.numAtoms, mol.box[:, 0]
    shifts = [np.array([i, j, k]) * L for i in range(tile[0]) for j in range(tile[1])
              for k in range(tile[2])]
    big = copy.copy(mol)
    big.numAtoms = n * len(shifts)
    big.coords = np.concatenate([mol.coords[:, :, 0] + s for s in shifts])[:, :, None]
    big.box = (L * np.asarray(tile))[:, None]
    for a in ("name", "element", "atomtype", "charge", "masses"):
        setattr(big, a, np.concatenate([getattr(mol, a)] * len(shifts)))
    for a in ("bonds", "angles", "dihedrals", "impropers", "crossterms"):
        v = getattr(mol, a)
        if len(v):
            setattr(big, a, np.concatenate([v + t * n for t in range(len(shifts))]))
    return big, Parameters(ff, big, TERMS, precision=precision)


def _halo_forces(par, box, dev, precision="single"):
    """Forces at the input's settings with the exact Ewald sum at any size
    (the halo's reciprocal term)."""
    from torchmd_tpu_torch.forces import Forces

    f = Forces(par, terms=TERMS, precision=precision, cutoff=ALA_CUTOFF,
               switch_dist=ALA_SWITCH, elec="ewald", device=dev)
    f.ensure_ewald(box, exact=True)
    return f


def _halo_pairs(rows, nown, excl, geom, cutoff):
    """(owned-owned pairs, counted once; owned-ghost pairs) inside the
    cutoff that the halo function needs, exclusions removed."""
    import torch

    box = torch.tensor(geom.box, dtype=rows.dtype, device=rows.device)
    inner, outer = _pairs_within(rows[:, 1:4], rows[:, 0].long(), nown, excl, box,
                                 geom.wrap, cutoff, rows=1024)
    return inner // 2, outer


HALO_MAX_DEVICE_OPS = 6   # device operations of one halo call (memset + 5 kernels)


def halo_kernel_class(name):
    """The part of a halo call a device operation belongs to: `walk`
    (halo_kernel), `finish` (finish_parts), `prep` (csrc/halo.cu's other
    kernels, halo_*, and memsets) or `other` (torch ops)."""
    import re

    if "halo_kernel" in name:
        return "walk"
    if "finish_parts" in name:
        return "finish"
    if re.search(r"\bhalo_", name) or "emset" in name:
        return "prep"
    return "other"


def _device_ops(fn, calls=10):
    """torch.profiler over `calls` calls of fn(): (device operations a
    call, {kernel name: (device us, count) a call})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    kernels = [e for e in prof.key_averages() if dev_us(e) > 0 and e.cpu_time_total == 0]
    return (sum(e.count for e in kernels) / calls,
            {e.key: (dev_us(e) / calls, e.count / calls) for e in kernels})


def _halo_prep_checks(h, cfg_nb, rows, nown, geom, dev, split=False):
    """The halo kernel's device prep against its plain version on the
    CPU, bit for bit; two calls alike, bit for bit; the prep's overflow
    flag; the walk's counters; with `split` (on the card) the device
    operations of a call and their microseconds by part."""
    import torch

    from torchmd_tpu_torch.ops import halo as kh

    out = {}
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    cpu = h.data._replace(**{k: v.cpu() for k, v in h.data._asdict().items()
                             if torch.is_tensor(v)})
    want = kh.halo_tiles_reference(cpu, cfg_nb, rows.cpu(), nown, geom)
    if dev.type == "cuda":
        got = kh.halo_tiles(h.data, cfg_nb, rows, nown, geom, overflow=flag)
    else:
        got = kh.halo_tiles_reference(h.data, cfg_nb, rows, nown, geom)
    out["prep_bitwise"] = all(
        a.shape == b.shape and torch.equal(a.contiguous().cpu().view(torch.int32),
                                           b.contiguous().view(torch.int32))
        for a, b in zip(got, want))
    out["tiles"] = int(want.tile_cell.shape[0])
    stats = torch.zeros(len(kh.STATS), dtype=torch.int64, device=dev)
    (pot_a, f_a), (pot_b, f_b) = [
        kh.halo_energy_forces(h.data, cfg_nb, rows, nown, geom, overflow=flag,
                              stats=stats if k == 0 and dev.type == "cuda" else None)
        for k in range(2)]
    out["deterministic"] = bool(torch.equal(f_a, f_b) and all(
        torch.equal(pot_a[k], pot_b[k]) for k in pot_a))
    out["overflow"] = int(flag[0])
    walk = dict(zip(kh.STATS, (int(v) for v in stats.tolist())))
    walk["active_lane_share"] = walk["lane_rounds"] / max(1, 32 * walk["rounds"])
    out["walk"] = walk
    if split and dev.type == "cuda":
        ops, us = _device_ops(lambda: kh.halo_energy_forces(h.data, cfg_nb, rows, nown, geom))
        part = {"prep": 0.0, "walk": 0.0, "finish": 0.0, "other": 0.0}
        for k, (v, _) in us.items():
            part[halo_kernel_class(k)] += v
        out["split"] = dict(device_ops=ops, **{f"{k}_us": round(v, 3)
                                               for k, v in part.items()})
    return out


def _rank_halo(rank, cfg, name, want_refs):
    """One rank of a halo layout (see the block comment above); with
    `want_refs` (the one-rank layout) also the unsharded port's references:
    the zero-velocity energy and forces and the 10-step NVE positions."""
    import copy

    import torch

    from torchmd_tpu_torch.constraints import build_constraint_spec
    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.neighbors import build_exclusion_table
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import halo as kh
    from torchmd_tpu_torch.ops.cell import prepare_cell_data
    from torchmd_tpu_torch.parallel import HaloMD, make_mesh
    from torchmd_tpu_torch.potentials import make_ffparams
    from torchmd_tpu_torch.systems import System
    from torchmd_tpu_torch.units import TIMEFACTOR

    world, axes, shape, axis = HALO_LAYOUTS[name]
    dev = torch.device(cfg["device"])
    t0 = time.perf_counter()
    mol, par = halo_system(cfg["tile"])
    n, box = mol.numAtoms, mol.box[:, 0]
    forces = _halo_forces(par, box, dev)
    excl = build_exclusion_table(par, n)
    masses = np.asarray(par.masses, np.float64).reshape(-1, 1)
    cs = build_constraint_spec(par, masses, mode="hbonds", device=dev, dtype=torch.float32)
    mesh = make_mesh(axes=axes, shape=shape, device=dev)
    pos0 = mol.coords[:, :, 0]
    vel0 = maxwell_boltzmann(par.masses, TEMP, 1, seed=1, device="cpu",
                             dtype=torch.float64)[0].numpy()
    out = dict(setup_s=time.perf_counter() - t0, transport=mesh.transport)

    def halo(timestep=TIMESTEP, **kw):
        return HaloMD(forces.ffparams, forces.config, mesh, box, excl_table=excl,
                      timestep=timestep, axis=axis, **kw)

    # the kernel against plain f64 on this rank's rows at the start
    h = halo()
    h.init(pos0, np.zeros_like(pos0))
    out["spec"] = h.spec
    rows, nown, geom = h.pair_inputs()
    cfg_nb = forces.config
    pot_k, f_k = kh.halo_energy_forces(h.data, cfg_nb, rows, nown, geom)
    d64 = prepare_cell_data(make_ffparams(par, dtype=torch.float64, device=dev,
                                          dense_mask=False), excl)
    pot_p, f_p = kh.halo_reference(d64, cfg_nb, rows.double(), nown, geom)
    _mesh_sync(dev)
    e_k, e_p = float(sum(pot_k.values())), float(sum(pot_p.values()))
    fscale = max(1.0, float(f_p.abs().max()))
    out.update(rows=int(rows.shape[0]), nown=nown, e_err=abs(e_k - e_p) / max(1.0, abs(e_p)),
               f_err=float((f_k.double() - f_p).abs().max()) / fscale,
               max_abs_err=float((f_k.double() - f_p).abs().max()))
    # owned-owned pairs give forces on both rows (Newton's third law);
    # owned-ghost pairs on the owned row only
    d = h.data
    n_oo, n_og = _halo_pairs(rows, nown, d.excl, geom, ALA_CUTOFF)
    out["bound"] = bound(tensor_bytes(rows, d.q, d.sig, d.eps, d.types, d.excl) + 12 * nown,
                         pair_flops(n_oo, "ewald") + n_og * PAIR_FLOPS["ewald"])
    out["pairs"] = n_oo + n_og
    out.update(_halo_prep_checks(h, cfg_nb, rows, nown, geom, dev, split=want_refs))
    times = _one_at_a_time(lambda: dict(
        ms=_mesh_ms(lambda: kh.halo_energy_forces(h.data, cfg_nb, rows, nown, geom), dev),
        # the plain version at f32 (seconds a call): the kernel entry's layout only
        plain_ms=_mesh_ms(lambda: kh.halo_reference(h.data, cfg_nb, rows, nown, geom), dev,
                          calls=cfg["plain_calls"], warmup=1) if want_refs else None))
    out.update(times)
    del d64, pot_p, f_p

    # a zero-velocity step: the summed energy and the half-kick forces
    _, out["e0"], _ = h.step(1)
    _, v = h.gather()
    out["f0"] = 2.0 * masses * v / (TIMESTEP / TIMEFACTOR)
    del h

    def unsharded(f, precision="single", free=False):
        system = System(n, 1, precision)
        system.set_positions(pos0[:, :, None])
        system.set_box(box)
        system.set_velocities(vel0[None])
        Integrator(system, f, HALO_FREE_DT if free else TIMESTEP,
                   constraints=None if free else "hbonds").step(niter=cfg["steps"])
        return np.array(system.pos[0], np.float64)

    for key, hh in (("nve_pos", halo(constraints=cs)), ("free_pos", halo(HALO_FREE_DT))):
        hh.init(pos0, vel0)
        hh.step(cfg["steps"])
        out[key] = hh.gather()[0]
        del hh
    if want_refs:
        e_ref = forces.compute(pos0[None], box[None])[0]
        f_ref = forces.last_forces[0].double().cpu().numpy()
        # the references: the unsharded runs at f64 (the torch-op path);
        # the f32 floors: the unsharded f32 runs' distances from them; the
        # fault controls: the unsharded f32 runs with every charge larger
        f64 = _halo_forces(par, box, dev, "double")

        def charged(e):
            par_c = copy.copy(par)
            par_c.charges = np.asarray(par.charges) * (1.0 + e)
            return _halo_forces(par_c, box, dev)

        def far(a, b):
            d = a - b
            return float(np.abs(d - box * np.round(d / box)).max())

        refs = dict(e0=e_ref, f0=f_ref)
        for key, free, e in (("nve", False, WATER_CONTROL_Q[1]),
                             ("free", True, HALO_FREE_CONTROL_Q)):
            ref, ref32 = unsharded(f64, "double", free), unsharded(forces, free=free)
            refs.update({f"{key}_pos": ref, f"{key}_pos32": ref32,
                         f"{key}_floor": far(ref32, ref),
                         f"{key}_control": far(unsharded(charged(e), free=free), ref)})
        out["refs"] = refs

    # timed Langevin, the counters reset just before and read just after
    h = halo(constraints=cs, T=TEMP, gamma=MESH_T_GAMMA, seed=2)
    h.init(pos0, vel0)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    _mesh_sync(dev)
    kh.LAUNCHES = kb.LAUNCHES = 0
    mesh.calls.clear()
    mesh.bytes.clear()
    t1 = time.perf_counter()
    temps = [h.step(cfg["t_chunk"])[2] for _ in range(cfg["t_steps"] // cfg["t_chunk"])]
    _mesh_sync(dev)
    out.update(sps=cfg["t_steps"] / (time.perf_counter() - t1),
               mean_T=float(np.mean(temps[len(temps) // 2:])),
               launches={"halo": kh.LAUNCHES, "bonded": kb.LAUNCHES},
               collectives=dict(mesh.calls), moved=dict(mesh.bytes),
               migrations=h.migrations, growths=len(h.overflow_log),
               overflow_log=h.overflow_log, comm_bytes_per_step=h.spec.comm_bytes_per_step(),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30 if on_card else 0.0,
               finite=bool(np.all(np.isfinite(h.gather()[0]))))
    return out


def phase_halo(cfg=None):
    """Halo-exchange MD on the card (phase 31): every layout of
    HALO_CFG["layouts"]; returns the halo kernel's entry (the one-rank
    layout's times and bound, the largest error of every rank) and its
    launches summed over the timed runs."""
    from torchmd_tpu_torch.parallel.launch import Ranks

    cfg = dict(HALO_CFG, **(cfg or {}))
    dev = cfg["device"]
    cores = len(os.sched_getaffinity(0))
    refs, results, pool, key = None, {}, None, None
    try:
        for name in cfg["layouts"]:
            world = HALO_LAYOUTS[name][0]
            backend = cfg["w1_backend"] if world == 1 else "gloo"
            t0 = time.perf_counter()
            if (world, backend) != key:
                # consecutive layouts of one world size share its ranks
                if pool is not None:
                    pool.close()
                key = (world, backend)
                pool = Ranks(world, backend=backend, device=dev,
                             threads=max(1, cores // world), timeout=900)
            results[name] = pool.run(_rank_halo, cfg, name, refs is None)
            refs = refs or results[name][0]["refs"]
            _check_halo_layout(cfg, name, backend, results[name], refs)
            log("halo_wall", layout=name, seconds=f"{time.perf_counter() - t0:.1f}")
    finally:
        if pool is not None:
            pool.close()
    every = [o for outs in results.values() for o in outs]
    one = results[cfg["layouts"][0]][0]
    return (dict(ms=one["ms"], plain_ms=one["plain_ms"], bound=one["bound"],
                 max_abs_err=max(o["max_abs_err"] for o in every)),
            sum(o["launches"]["halo"] for o in every))


def _check_halo_layout(cfg, name, backend, outs, refs):
    """The lines and gates of one layout of phase_halo (its ranks' results
    `outs`, the unsharded references `refs`)."""
    world = HALO_LAYOUTS[name][0]
    L = np.asarray(outs[0]["spec"].box)
    fscale = float(np.abs(refs["f0"]).max())
    for r, o in enumerate(outs):
        e_rel = abs(o["e0"] - refs["e0"]) / abs(refs["e0"])
        f_rel = float(np.abs(o["f0"] - refs["f0"]).max()) / fscale

        def dev_from(pos, ref):
            d = pos - ref
            return float(np.abs(d - L * np.round(d / L)).max())

        # per NVE run: its distance from the unsharded f64 run and from the
        # unsharded f32 run, the limit (WATER_FLOOR_FACTOR x the f32 floor)
        nve = {k: (dev_from(o[f"{k}_pos"], refs[f"{k}_pos"]),
                   dev_from(o[f"{k}_pos"], refs[f"{k}_pos32"]),
                   WATER_FLOOR_FACTOR * refs[f"{k}_floor"]) for k in ("free", "nve")}
        steps = cfg["t_steps"] + cfg["t_chunk"] * o["growths"]
        log("halo", layout=name, world=world, backend=backend, rank=r,
            transport=o["transport"], rows=o["rows"], owned_cap=o["nown"],
            pairs=o["pairs"], kernel_e_rel=f"{o['e_err']:.3e}",
            kernel_f_rel=f"{o['f_err']:.3e}", ms=o["ms"],
            plain_f32_ms=o["plain_ms"], bound_ms=f"{o['bound'][0]:.5f}",
            bound_by=o["bound"][1], e0_rel_vs_unsharded=f"{e_rel:.3e}",
            f0_rel_vs_unsharded=f"{f_rel:.3e}",
            steps_per_s=f"{o['sps']:.2f}", mean_T=f"{o['mean_T']:.2f}",
            migrations=o["migrations"], growths=o["growths"],
            halo_launches=o["launches"]["halo"], bonded_launches=o["launches"]["bonded"],
            comm_bytes_per_step=o["comm_bytes_per_step"], moved_bytes=o["moved"],
            peak_gib=f"{o['peak_gib']:.2f}", setup_s=f"{o['setup_s']:.1f}")
        for k, (d64, d32, limit) in nve.items():
            log("halo_nve", layout=name, rank=r, run=k,
                dt_fs=HALO_FREE_DT if k == "free" else TIMESTEP,
                constraints="none" if k == "free" else "hbonds",
                dev_vs_f64_A=f"{d64:.3e}", f32_floor_A=f"{refs[k + '_floor']:.3e}",
                limit_A=f"{limit:.3e}", charge_control_A=f"{refs[k + '_control']:.3e}",
                control_q=HALO_FREE_CONTROL_Q if k == "free" else WATER_CONTROL_Q[1],
                dev_vs_f32_A=f"{d32:.3e}", within_mesh_traj_tol=d32 <= MESH_TRAJ_TOL)
            require(d64 <= limit, f"halo {name} rank {r}: NVE ({k}) {d64} A off the "
                    f"unsharded f64 run, beyond {WATER_FLOOR_FACTOR} x the f32 floor "
                    f"{refs[k + '_floor']} A")
            require(refs[k + "_control"] > limit, f"the halo charge control ({k}) moved "
                    f"only {refs[k + '_control']} A")
        require(nve["free"][1] <= MESH_TRAJ_TOL, f"halo {name} rank {r}: NVE without "
                f"constraints {nve['free'][1]} A off the unsharded f32 run")
        log("halo_collectives", layout=name, rank=r, steps=cfg["t_steps"],
            **o["collectives"])
        require(o["e_err"] <= HALO_KERNEL_E_REL and o["f_err"] <= HALO_KERNEL_F_REL,
                f"halo {name} rank {r}: kernel vs plain f64 {o['e_err']}, {o['f_err']}")
        require(e_rel <= HALO_E_REL and f_rel <= HALO_F_REL,
                f"halo {name} rank {r}: zero-velocity step vs unsharded {e_rel}, {f_rel}")
        require(abs(o["mean_T"] - TEMP) <= MESH_T_TOL, f"halo {name}: mean T {o['mean_T']}")
        require(o["launches"] == {"halo": steps, "bonded": steps},
                f"halo {name} rank {r}: launches {o['launches']} (one halo kernel and one "
                "bonded launch a step)")
        require(o["finite"], f"halo {name}: non-finite positions")
        log("halo_prep", layout=name, rank=r, tiles=o["tiles"],
            prep_bitwise_vs_plain=o["prep_bitwise"], deterministic=o["deterministic"],
            overflow_flag=o["overflow"], **o["walk"])
        require(o["prep_bitwise"], f"halo {name} rank {r}: the device prep differs from "
                "its plain version")
        require(o["deterministic"], f"halo {name} rank {r}: two calls differ")
        require(o["overflow"] == 0, f"halo {name} rank {r}: a cell of {o['overflow']} rows "
                f"beyond the prep's cap")
        if "split" in o:
            log("halo_split", layout=name, rank=r, ms=o["ms"], **o["split"])
            require(o["split"]["device_ops"] <= HALO_MAX_DEVICE_OPS,
                    f"halo {name}: {o['split']['device_ops']} device operations a call")


def _kernel_entry(name, source, replaces, launches, t):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": None}


def walled(phase, *args):
    """phase(*args), its wall time logged as a `[phase_wall]` line."""
    t0 = time.perf_counter()
    out = phase(*args)
    log("phase_wall", of=phase.__name__[len("phase_"):],
        seconds=f"{time.perf_counter() - t0:.1f}")
    return out


def main():
    smi = walled(phase_device)
    walled(phase_build)
    times = walled(phase_kernels)
    times.update(walled(phase_water_kernels))
    walled(phase_dense_pme)
    times.update(walled(phase_column_kernels))
    walled(phase_parity)
    thr_launches, api_steps_per_s, thr_profile = walled(phase_dynamics)
    water_launches, water_sps = walled(phase_waterbox)
    npt_launches, _ = walled(phase_npt)
    cli_launches, _ = walled(phase_cli, api_steps_per_s)
    walled(phase_external)
    prod_launches, prod_sps, prod_profile = walled(phase_production, api_steps_per_s, thr_profile)
    mc_launches = walled(phase_mc_barostat)
    walled(phase_cmap)
    mts_launches = walled(phase_mts_thrombin, prod_sps, prod_profile)
    mts_water_launches, times["column_rf"] = walled(phase_mts_water)
    recip_launches = walled(phase_recip_tier, water_sps)
    walled(phase_alanine_mtk)
    walled(phase_verlet, api_steps_per_s)
    va_launches = walled(phase_verlet_auto, smi)
    times.update(walled(phase_replica_kernels))
    gb_launches, _ = walled(phase_gbsa)
    remd_launches, _, _ = walled(phase_remd)
    metad_launches, _ = walled(phase_metad)
    alch_launches = walled(phase_alchemy)
    walled(phase_amoeba)
    drude_launches, _ = walled(phase_drude)
    swm4_launches = walled(phase_drude_swm4)
    walled(phase_nnp)
    walled(phase_train)
    mesh_times = walled(phase_mesh)
    halo_time, halo_launches = walled(phase_halo)
    times["roofline"], probe_launches = walled(phase_roofline)
    # the dense pair and bonded kernels' main paths: the API's dynamics,
    # the CLI's run, the production protocol's and its r-RESPA run, the
    # GB/OBC run, metadynamics, alchemy and lambda-dynamics, the Drude
    # thrombin run and the SWM4-NDP box's f32 SCF solve, and the bonded
    # kernel's also the 103,200-atom run on Verlet lists (their
    # replica-axis instances: the REMD ladder's run); the
    # cell, spread and gather kernels': the NVT water box's, the Monte
    # Carlo phase's and the reciprocal tier's, and the spread's also the
    # SWM4-NDP solve's; the column kernel's: the
    # NPT phase's (with its virial), and its no-virial reaction-field
    # instance's (column_rf) the r-RESPA SPC/Fw water's mts 4 run
    thr_launches = {k: thr_launches[k] + cli_launches[k] + prod_launches[k] + mts_launches[k]
                    + gb_launches[k] + metad_launches[k] + alch_launches[k]
                    + drude_launches[k] + swm4_launches[k] + va_launches[k]
                    for k in thr_launches}
    water_launches = {k: water_launches[k] + mc_launches.get(k, 0) + recip_launches.get(k, 0)
                      + (swm4_launches["pme_spread"] if k == "pme_spread" else 0)
                      for k in water_launches}

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
        # the replica axis of #1 and #3 (the vmapped Pallas calls of a
        # ladder, torchmd_tpu/integrator.py:547): one launch for 8 replicas
        _kernel_entry("pair_replicas", src + "nonbonded.cu",
                      "torchmd_tpu/ops/pallas_nonbonded.py:545",
                      remd_launches["pair"], times["pair_replicas"]),
        _kernel_entry("bonded_replicas", src + "bonded.cu",
                      "torchmd_tpu/ops/pallas_bonded.py:575",
                      remd_launches["bonded"], times["bonded_replicas"]),
        _kernel_entry("cell", src + "cell.cu", "torchmd_tpu/ops/pallas_cell.py:238",
                      water_launches["cell"], times["cell"]),
        _kernel_entry("pme_spread", src + "pme.cu", "torchmd_tpu/ops/pallas_pme.py:235",
                      water_launches["pme_spread"], times["pme_spread"]),
        _kernel_entry("pme_gather", src + "pme.cu", "torchmd_tpu/ops/pallas_pme.py:168",
                      water_launches["pme_gather"], times["pme_gather"]),
        _kernel_entry("column", src + "column.cu", "torchmd_tpu/ops/pallas_column.py:266",
                      npt_launches["column"], times["column"]),
        # the same kernel's no-virial reaction-field instance, on the SPC/Fw
        # r-RESPA path, checked and timed at that path's shapes
        _kernel_entry("column_rf", src + "column.cu", "torchmd_tpu/ops/pallas_column.py:266",
                      mts_water_launches["column_rf"], times["column_rf"]),
        _kernel_entry("roofline", src + "roofline.cu", "scripts/bench_roofline.py:213",
                      probe_launches, times["roofline"]),
        # the row range of #1 and the slab of #4 (the spatially sharded
        # paths), at W = 2 gloo ranks sharing the card: launches summed
        # over the ranks, the slowest rank's times, the bound of its share
        _kernel_entry("pair_rows", src + "nonbonded.cu",
                      "torchmd_tpu/ops/pallas_nonbonded.py:545",
                      mesh_times["pair_rows"][1], mesh_times["pair_rows"][0]),
        _kernel_entry("cell_slab", src + "cell.cu", "torchmd_tpu/ops/pallas_cell.py:238",
                      mesh_times["cell_slab"][1], mesh_times["cell_slab"][0]),
        # the halo form of #4's tile walk (the JAX halo's pair stage is
        # plain arrays, torchmd_tpu/parallel/halo.py:620-688): the one-rank
        # layout's times and bound, launches summed over every layout's
        # timed run
        _kernel_entry("halo", src + "halo.cu", "torchmd_tpu/ops/pallas_cell.py:238",
                      halo_launches, halo_time),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--amoeba"]:
        # the AMOEBA phase alone (it launches none of the kernels)
        phase_device()
        phase_amoeba()
    elif sys.argv[1:2] == ["--drude"]:
        # the Drude phases alone (thrombin and the SWM4-NDP box)
        phase_device()
        phase_build()
        phase_drude()
        phase_drude_swm4()
    elif sys.argv[1:2] == ["--mesh"]:
        # the device mesh's phases alone
        phase_device()
        phase_build()
        phase_mesh()
    elif sys.argv[1:2] == ["--verlet-auto"]:
        # the automatic Verlet choice's phase alone
        smi = phase_device()
        phase_build()
        phase_verlet_auto(smi)
    elif sys.argv[1:2] == ["--roofline"]:
        # the staged probe's phase alone
        phase_device()
        phase_build()
        phase_roofline()
    elif sys.argv[1:2] == ["--halo"]:
        # the halo-exchange MD phase alone
        phase_device()
        phase_build()
        phase_halo()
    elif sys.argv[1:2] == ["--remd-seeds"]:
        # a measurement, not the smoke test: the REMD phase's T spread
        phase_device()
        phase_build()
        remd_spread(int(sys.argv[2]))
    else:
        main()
