"""What sets the single-precision floor of the halo phase's NVE check.

`chip_smoke.py`'s halo phase holds 10 NVE steps of `HaloMD` (f32) on the
tiled alanine dipeptide box against the port's unsharded `Integrator`.
This script runs only the unsharded Integrator (cutoff 9 A, switch
7.5 A, the exact Ewald sum, hbonds SHAKE/RATTLE, 2 fs, NVE) and prints
the distance between pairs of runs after each step (minimum image): the
largest coordinate difference, as the halo phase's check reads it, and
the RMS over the atoms of the displacement; one JSON line per pair:

  - `f32` vs `f64`: the floor the check first stood on;
  - `f32 + 1 ulp` vs `f32`: a start moved by one ulp, the start's share;
  - `f32 recip f64` vs `f64`: the f32 run with the exact Ewald sum
    evaluated at f64 (its positions upcast, its forces rounded back);
  - `f32 SHAKE 200` vs `f64 SHAKE 200`: both with 200 Jacobi sweeps of
    SHAKE/RATTLE instead of 50, and `f64 SHAKE 200` vs `f64`;
  - `f32 q x (1 + e)` vs `f32`: every charge scaled, the fault controls
    (e = 1e-2, 3e-3, 1e-3);
  - at 1 fs: `f32 1 fs` vs `f64 1 fs` (hbonds), and without constraints
    (`free`): f32 vs f64, a start one ulp up, and charge faults e = 1e-3,
    3e-4, 1e-4;
  - `shake_call`: one SHAKE projection of the same drifted positions at
    f32 and at f64, after 50 and 1,000 Jacobi sweeps.

Usage: python scripts/halo_floor.py [--tile 4 4 4] [--device cuda:0]
       [--steps 10]
(On the CPU, `--device cpu --tile 1 1 1` takes under a minute.)
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class Recip64:
    """An f32 run's reciprocal term evaluated at f64: positions upcast,
    energy and forces rounded back to the run's dtype."""

    differentiable = True

    def __init__(self, recip):
        self.recip, self.cfg = recip, recip.cfg

    def energy_forces(self, pos, box, gather=None, order_idx=None):
        import torch

        e, f = self.recip.energy_forces(pos.double(), torch.as_tensor(box).double())
        return e.to(pos.dtype), f.to(pos.dtype)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tile", type=int, nargs=3, default=(4, 4, 4))
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from torchmd_tpu_torch.constraints import build_constraint_spec, shake_positions
    from torchmd_tpu_torch.ewald import EwaldRecip
    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.systems import System
    from torchmd_tpu_torch.units import TIMEFACTOR

    dev = torch.device(args.device)
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(json.dumps({"card": card.stdout.strip()}), flush=True)
    else:
        torch.set_num_threads(4)
    mol, par = cs.halo_system(args.tile)
    _, par64 = cs.halo_system(args.tile, precision="double")
    n, box = mol.numAtoms, mol.box[:, 0]
    pos0 = mol.coords[:, :, 0]
    vel0 = maxwell_boltzmann(par.masses, cs.TEMP, 1, seed=1, device="cpu",
                             dtype=torch.float64)[0].numpy()
    ulp = np.nextafter(pos0.astype(np.float32), np.float32(np.inf)).astype(np.float64)

    def run(p, precision, start=pos0, constraints="hbonds", recip64=False, sweeps=None,
            dt=cs.TIMESTEP):
        """Positions after each of the steps, (steps, n, 3) float64;
        `sweeps`: SHAKE/RATTLE's Jacobi sweeps instead of the default."""
        f = cs._halo_forces(p, box, dev, precision)
        if recip64:
            # the private swap is this diagnostic's only way in: the f32
            # Forces keeps its pair terms and takes an f64 Ewald sum
            f._ewald = Recip64(EwaldRecip(torch.as_tensor(np.asarray(p.charges), device=dev,
                                                          dtype=torch.float64),
                                          box, cs.ALA_CUTOFF,
                                          excl_pairs=p.get_exclusions(types=f.exclusions)))
            f._build_evaluators()
        system = System(n, 1, precision)
        system.set_positions(start[:, :, None])
        system.set_box(box)
        system.set_velocities(vel0[None])
        integ = Integrator(system, f, dt, constraints=constraints, device=dev)
        if sweeps is not None:
            c = integ.constraints
            integ.constraints = c._replace(shake=c.shake._replace(iterations=sweeps))
        out = []
        for _ in range(args.steps):
            integ.step(niter=1)
            out.append(np.array(system.pos[0], np.float64))    # a copy
        return np.stack(out)

    def charged(p, e):
        q = copy.copy(p)
        q.charges = np.asarray(p.charges) * (1.0 + e)
        return q

    t0 = time.perf_counter()
    drifted = pos0 + vel0 * (cs.TIMESTEP / TIMEFACTOR)
    masses = np.asarray(par.masses, np.float64).reshape(-1, 1)
    for sweeps in (50, 1000):
        out = {}
        for dtype in (torch.float32, torch.float64):
            c = build_constraint_spec(par, masses, mode="hbonds", device=dev, dtype=dtype)
            shake = c.shake._replace(iterations=sweeps)
            out[dtype] = shake_positions(shake, torch.as_tensor(drifted, dtype=dtype, device=dev),
                                         torch.as_tensor(pos0, dtype=dtype, device=dev))
        d = (out[torch.float32].double() - out[torch.float64]).abs().max()
        print(json.dumps({"tile": list(args.tile), "natoms": n, "shake_call": sweeps,
                          "max_f32_vs_f64_A": float(d)}), flush=True)
    runs = {"f64": run(par64, "double"), "f32": run(par, "single")}
    runs["f32 + 1 ulp"] = run(par, "single", start=ulp)
    runs["f32 recip f64"] = run(par, "single", recip64=True)
    runs["f64 SHAKE 200"] = run(par64, "double", sweeps=200)
    runs["f32 SHAKE 200"] = run(par, "single", sweeps=200)
    for e in (1e-2, 3e-3, 1e-3):
        runs[f"f32 q x (1 + {e:g})"] = run(charged(par, e), "single")
    # 1 fs, with and without constraints
    runs["f64 1 fs"] = run(par64, "double", dt=1.0)
    runs["f32 1 fs"] = run(par, "single", dt=1.0)
    runs["f64 free 1 fs"] = run(par64, "double", constraints=None, dt=1.0)
    runs["f32 free 1 fs"] = run(par, "single", constraints=None, dt=1.0)
    runs["f32 free 1 fs + 1 ulp"] = run(par, "single", constraints=None, dt=1.0, start=ulp)
    for e in (1e-3, 3e-4, 1e-4):
        runs[f"f32 free 1 fs q x (1 + {e:g})"] = run(charged(par, e), "single",
                                                     constraints=None, dt=1.0)
    pairs = [("f32", "f64"), ("f32 + 1 ulp", "f32"), ("f32 recip f64", "f64"),
             ("f32 SHAKE 200", "f64 SHAKE 200"), ("f64 SHAKE 200", "f64")]
    pairs += [(f"f32 q x (1 + {e:g})", "f32") for e in (1e-2, 3e-3, 1e-3)]
    pairs += [("f32 1 fs", "f64 1 fs"), ("f32 free 1 fs", "f64 free 1 fs"),
              ("f32 free 1 fs + 1 ulp", "f32 free 1 fs")]
    pairs += [(f"f32 free 1 fs q x (1 + {e:g})", "f32 free 1 fs") for e in (1e-3, 3e-4, 1e-4)]
    for a, b in pairs:
        d = runs[a] - runs[b]
        d = d - box * np.round(d / box)                             # (steps, n, 3)
        print(json.dumps({"tile": list(args.tile), "natoms": n, "run": a, "against": b,
                          "max_A": [float(x) for x in np.abs(d).max((1, 2))],
                          "rms_A": [float(x) for x in np.sqrt((d * d).sum(2).mean(1))]}),
              flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
