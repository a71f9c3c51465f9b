"""Witnesses for the halo-exchange MD port, on the CPU.

Prints one JSON line per reading:

  - `jax_excluded_erf`: the JAX package's HaloMD (f32) one step from rest
    on 60 charged 4-atom chains under classic Ewald in a 24 A box, at R =
    1 and R = 2 slabs, against the dense f64 energy: its correction of
    excluded pairs also counts a partner's ghost images;
  - `jax_one_rank_migration`: the JAX HaloMD on one rank, a hot 300-atom
    gas (1500 K, 5 fs): whether its first rebuild overflows for good;
  - `port_f64_vs_integrator`: the port's HaloMD on one rank against the
    port's unsharded Integrator at f64 on the ACEMD alanine dipeptide box
    (688 atoms, cutoff 9 A, switch 7.5 A, classic Ewald, hbonds SHAKE, 2
    fs, 10 steps), and the unsharded f32 run's distance from a start
    moved by one ulp (the f32 floor of that run).

Usage: JAX_PLATFORMS=cpu python scripts/halo_witness.py
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def jax_witnesses():
    import conftest  # noqa: F401  (the JAX CPU mesh of 8 devices, f64)
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import test_torch_halo as T
    from torchmd_tpu.parallel.halo import HaloMD

    forces, pos, excl = T._jax_system("chains-ewald")
    e_ref, _ = T._dense_reference(forces, pos)
    for r in (1, 2):
        h = HaloMD(forces.ffparams, forces.config, Mesh(np.array(jax.devices()[:r]), ("sp",)),
                   np.full(3, T.L_GAS), excl_table=excl, timestep=1.0)
        h.init(jnp.asarray(pos, jnp.float32), jnp.zeros((len(pos), 3), jnp.float32))
        _, epot, _ = h.step(1)
        print(json.dumps({"jax_excluded_erf": {"R": r, "halo_epot": epot, "dense_epot": e_ref,
                                               "rel": epot / e_ref - 1.0}}), flush=True)
    forces, pos, _ = T._jax_system("gas", precision="single", seed=3)
    vel = T._velocities(forces.ffparams.masses, 1500.0, seed=2)
    h = HaloMD(forces.ffparams, forces.config, Mesh(np.array(jax.devices()[:1]), ("sp",)),
               np.full(3, T.L_GAS), timestep=5.0)
    h.init(jnp.asarray(pos, jnp.float32), jnp.asarray(vel, jnp.float32))
    try:
        for _ in range(3):
            h.step(niter=8)
        out = "ran"
    except RuntimeError as exc:
        out = str(exc)
    print(json.dumps({"jax_one_rank_migration": out}), flush=True)


def port_witness():
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from torchmd_tpu_torch.constraints import build_constraint_spec
    from torchmd_tpu_torch.integrator import Integrator, maxwell_boltzmann
    from torchmd_tpu_torch.neighbors import build_exclusion_table
    from torchmd_tpu_torch.parallel import HaloMD, make_mesh
    from torchmd_tpu_torch.parallel.launch import free_port
    from torchmd_tpu_torch.systems import System

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    mesh = make_mesh(axes=("sp",), device="cpu")
    out = {}
    for precision in ("double", "single"):
        dtype = torch.float64 if precision == "double" else torch.float32
        mol, par = cs.halo_system((1, 1, 1), precision=precision)
        n, box = mol.numAtoms, mol.box[:, 0]
        forces = cs._halo_forces(par, box, "cpu", precision)
        vel = maxwell_boltzmann(par.masses, 300.0, 1, seed=1, device="cpu",
                                dtype=torch.float64)[0].numpy()

        def unsharded(start):
            system = System(n, 1, precision)
            system.set_positions(start[:, :, None])
            system.set_box(box)
            system.set_velocities(vel[None])
            Integrator(system, forces, 2.0, constraints="hbonds", device="cpu").step(niter=10)
            return np.asarray(system.pos[0], np.float64)

        pos0 = mol.coords[:, :, 0]
        ref = unsharded(pos0)
        if precision == "single":
            ulp = np.nextafter(pos0.astype(np.float32), np.float32(np.inf)).astype(np.float64)
            out["f32_one_ulp_floor_A"] = float(np.abs(unsharded(ulp) - ref).max())
            continue
        masses = np.asarray(par.masses, np.float64).reshape(-1, 1)
        h = HaloMD(forces.ffparams, forces.config, mesh, box,
                   excl_table=build_exclusion_table(par, n), timestep=2.0,
                   constraints=build_constraint_spec(par, masses, mode="hbonds",
                                                     device="cpu", dtype=dtype))
        h.init(pos0, vel)
        h.step(10)
        d = h.gather()[0] - ref
        out["f64_max_dev_A"] = float(np.abs(d - box * np.round(d / box)).max())
    print(json.dumps({"port_f64_vs_integrator": out}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    jax_witnesses()
    port_witness()
