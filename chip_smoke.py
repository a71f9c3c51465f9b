"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main path, the bench configuration of the JAX package
(thrombin-ligand, 4,676 atoms, 7 terms, cutoff 7.3 A, reaction field, no
box, velocity Verlet + Langevin at 300 K / gamma 0.1 ps^-1, f32) at a 2 fs
timestep (see TIMESTEP),
through the entry points a user calls: Parameters -> Forces -> System ->
Integrator.step. Imports nothing of JAX.

Phases (each prints one line; any failure raises and exits non-zero):
  1. device: require CUDA, print the card's name and power limit;
  2. build: compile both CUDA kernels from csrc/ with nvcc, and print
     ptxas's registers, spills and shared memory for each kernel;
  3. kernels: each kernel (f32) against its plain PyTorch version (f64) on
     the card, on several cases; then each kernel and its plain version
     timed at f32 on thrombin's shapes (CUDA events around each of 30
     calls queued behind a sleep kernel, median: device time);
  4. parity: Forces on the kernel path against autograd of the port's
     compute_potentials at f32 on thrombin;
  5. dynamics: a warm-up chunk, then 1,000 timed Langevin steps with the
     kernels' launch counters reset just before and read just after; and
     10 NVE steps on the kernel path against the dense f64 torch-op path.
The last two lines are a JSON summary of the kernels and the JSON status
line. Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

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
DEVICE = "cuda"
SLEEP_CYCLES = 40_000_000     # ~20 ms of device sleep before each timed call
MAIN_SYSTEM = ("thrombin-ligand-amber", "structure.pdb")


def require(cond, what):
    """Fail the run (also under python -O, unlike assert)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def load_amber(folder, coords, extra=None, terms=TERMS):
    from torchmd_tpu.forcefields.ff_amber import AmberForcefield
    from torchmd_tpu.io import Molecule
    from torchmd_tpu.parameters import Parameters

    d = os.path.join(DATA, folder)
    mol = Molecule(os.path.join(d, "structure.prmtop"))
    mol.read(os.path.join(d, coords))
    if extra:
        mol.read(os.path.join(d, extra))
    ff = AmberForcefield(mol, os.path.join(d, "structure.prmtop"))
    return mol, Parameters(ff, mol, terms, precision="single")


def cuda_events_ms(fn, calls=30, warmup=3):
    """Median device milliseconds of `fn()` over `calls` calls, each
    bracketed by CUDA events. A sleep kernel before each call lets the
    host queue the whole call while the device waits, so the events time
    the device work and not the Python between launches (one call at a
    time: the launch queue is too short to hold 30 calls of the plain
    versions' hundreds of kernels)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    from torchmd_tpu_torch.ops import _build, bonded, nonbonded

    t0 = time.perf_counter()
    nonbonded.build()
    bonded.build()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}")
    for lib in ("nonbonded", "bonded"):
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


def phase_kernels():
    import torch

    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn
    from torchmd_tpu_torch.potentials import make_ffparams

    dev = torch.device(DEVICE)
    errs = {"pair": 0.0, "bonded": 0.0}
    timing_inputs = None
    for name, par, pos, box, kw, cfg_edit, lj_ab in _kernel_cases():
        kw = dict(kw)
        terms = kw.pop("terms", TERMS)
        forces = Forces(par, terms=terms, precision="single", device=dev, **kw)
        cfg = forces.config._replace(**(cfg_edit or {}))
        ffp32 = forces.ffparams
        ffp64 = make_ffparams(par, dtype=torch.float64, device=dev)
        if lj_ab is not None:
            ffp32 = ffp32._replace(lj_ab=tuple(
                torch.as_tensor(t, dtype=torch.float32, device=dev) for t in lj_ab))
            ffp64 = ffp64._replace(lj_ab=tuple(
                torch.as_tensor(t, dtype=torch.float64, device=dev) for t in lj_ab))
        p32 = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        p64 = torch.as_tensor(pos, dtype=torch.float64, device=dev)
        b32 = b64 = None
        if box is not None:
            b32 = torch.as_tensor(box, dtype=torch.float32, device=dev)
            b64 = torch.as_tensor(box, dtype=torch.float64, device=dev)

        d32, d64 = kn.prepare_nb_data(ffp32), kn.prepare_nb_data(ffp64)
        pot_k, f_k = kn.nonbonded_energy_forces(d32, cfg, p32, b32)
        pot_p, f_p = kn.pair_terms_reference(d64, cfg, p64, b64)
        torch.cuda.synchronize()
        e_pair = _compare(f"{name}/pair", pot_k, f_k, pot_p, f_p)

        plan32 = kb.build_bonded_kernel_plan(ffp32, cfg)
        plan64 = kb.build_bonded_kernel_plan(ffp64, cfg)
        pot_k, f_k = kb.bonded_energy_forces(plan32, p32, b32)
        pot_p, f_p = kb.bonded_reference(plan64, p64, b64)
        torch.cuda.synchronize()
        e_bond = _compare(f"{name}/bonded", pot_k, f_k, pot_p, f_p)
        errs["pair"] = max(errs["pair"], e_pair)
        errs["bonded"] = max(errs["bonded"], e_bond)
        log("kernels", case=name, natoms=par.natoms, pair_max_abs_err=e_pair,
            bonded_max_abs_err=e_bond)
        if name == "thrombin":
            timing_inputs = (d32, cfg, p32, plan32)

    d32, cfg, p32, plan32 = timing_inputs
    times = {
        "pair": (cuda_events_ms(lambda: kn.nonbonded_energy_forces(d32, cfg, p32)),
                 cuda_events_ms(lambda: kn.pair_terms_reference(d32, cfg, p32))),
        "bonded": (cuda_events_ms(lambda: kb.bonded_energy_forces(plan32, p32)),
                   cuda_events_ms(lambda: kb.bonded_reference(plan32, p32))),
    }
    for k, (ms, plain_ms) in times.items():
        log("timing", kernel=k, shapes="thrombin", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", speedup=f"{plain_ms / ms:.2f}")
    return errs, times


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
    return launches, steps_per_s


def main():
    phase_device()
    phase_build()
    errs, times = phase_kernels()
    phase_parity()
    launches, _ = phase_dynamics()

    import torch

    kernels = [
        {"name": "pair", "route": "cuda",
         "source": "torchmd_tpu_torch/csrc/nonbonded.cu",
         "replaces": "torchmd_tpu/ops/pallas_nonbonded.py:545",
         "launches": launches["pair"], "max_abs_err": errs["pair"],
         "ms": times["pair"][0], "plain_ms": times["pair"][1]},
        {"name": "bonded", "route": "cuda",
         "source": "torchmd_tpu_torch/csrc/bonded.cu",
         "replaces": "torchmd_tpu/ops/pallas_bonded.py:575",
         "launches": launches["bonded"], "max_abs_err": errs["bonded"],
         "ms": times["bonded"][0], "plain_ms": times["bonded"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
