"""Checkpoint / resume for simulations (the port's counterpart of
`torchmd_tpu.checkpoint`).

The full restartable state is (pos, vel, box, forces, the Langevin noise
generator's state, iteration counter) plus the extended-system state the
integrator carries: the Nose-Hoover chain and the MTK barostat (v_eps and
its chain, and the carried virial, which holds the last step's
constraint virial). The generator's state (`torch.Generator.get_state()`,
a CPU byte tensor for CPU and CUDA generators alike) stands where the
JAX package saves its key. Written atomically as .npz (`os.replace`);
resume at f64 on the CPU is exact.

r-RESPA (`mts`, `mts_recip`) needs nothing more: the System's forces
hold the slow tier's carried forces, and every chunk (a multiple of the
reciprocal period) evaluates the bonded and reciprocal tiers afresh at
its entry, as the JAX package's does, so the reciprocal forces carried
between impulses never cross a chunk. The MTK state (dense, kernel or
r-RESPA path) keeps its carried virial.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_checkpoint(path, system, integrator, iteration: int):
    arrays = dict(
        pos=np.asarray(system.pos),
        vel=np.asarray(system.vel),
        forces=np.asarray(system.forces),
        box=np.asarray(system.box),
        rng_state=integrator.generator.get_state().numpy(),
        iteration=np.asarray(iteration, dtype=np.int64),
    )
    for k, v in (getattr(integrator, "_thermo_aux", None) or {}).items():
        arrays[f"thermo_{k}"] = _host(v)
    if getattr(integrator, "_npt", None) is not None:
        v_eps, aux_b, vir = integrator.npt_state
        arrays["npt_veps"] = _host(v_eps)
        if vir is not None:
            arrays["npt_virial"] = _host(vir)
        for k, v in aux_b.items():
            arrays[f"npt_{k}"] = _host(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path, system, integrator) -> int:
    """Restore `system` and `integrator` from `path`; returns the saved
    iteration."""
    data = np.load(path)
    system.pos[:] = data["pos"].astype(system.pos.dtype)
    system.vel[:] = data["vel"].astype(system.vel.dtype)
    system.forces[:] = data["forces"].astype(system.forces.dtype)
    system.box[:] = data["box"].astype(system.box.dtype)
    integrator.generator.set_state(torch.as_tensor(data["rng_state"], dtype=torch.uint8))

    def restore(aux, prefix):
        return {k: (torch.as_tensor(data[f"{prefix}{k}"], dtype=v.dtype, device=v.device)
                    if f"{prefix}{k}" in data else v)
                for k, v in aux.items()}

    aux = getattr(integrator, "_thermo_aux", None)
    if aux:
        integrator._thermo_aux = restore(aux, "thermo_")
    if getattr(integrator, "_npt", None) is not None and "npt_veps" in data:
        v_eps, aux_b, _ = integrator.npt_state

        def dev(a):
            return torch.as_tensor(a, dtype=v_eps.dtype, device=v_eps.device)

        # the carried virial holds the last step's constraint virial, which
        # (pos, box) alone do not give; without it the next chunk
        # recomputes the virial from (pos, box)
        vir = (dev(data["npt_virial"]),) if "npt_virial" in data else ()
        integrator.npt_state = (dev(data["npt_veps"]), restore(aux_b, "npt_"), *vir)
    return int(data["iteration"])
