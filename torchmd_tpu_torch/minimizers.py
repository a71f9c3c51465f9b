"""Energy minimizers (the port's counterpart of `torchmd_tpu.minimizers`).

  - `minimize_bfgs`: scipy L-BFGS-B on host copies, driving `Forces`'
    energy and forces on its device (same contract as the reference's
    minimizers.py:8-51).
  - `minimize_lbfgs`: L-BFGS on the device through
    `torch.optim.LBFGS(line_search_fn="strong_wolfe")` (the JAX package
    uses optax; the two take different paths to the same minimum).
    Also exported under the reference name `minimize_pytorch_bfgs`.
  - `minimize_fire`: FIRE on the device, its branches as `torch.where`
    so the loop never waits for the host.
  - `minimize_cg`: conjugate gradient with bracket + golden-section line
    search (the semantics of the reference's minimizers.py:108-308).

Energies and forces come from `Forces.ef_one` per replica, the external
potential included.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _energy_forces_fn(forces, system):
    """(pos (R, N, 3) tensor) -> (Epot (R,), forces (R, N, 3)) on the
    forces' device, at the System's box (all zero: no PBC)."""
    box_np = np.asarray(system.box_diag, dtype=np.float64)
    pos0 = torch.as_tensor(np.asarray(system.pos), dtype=forces.dtype, device=forces.device)
    if np.any(box_np != 0):
        forces.prepare(pos0, box_np)
    boxes = [torch.as_tensor(b, dtype=forces.dtype, device=forces.device)
             if np.any(b != 0) else None for b in box_np]

    def efn(pos):
        es, fs = [], []
        with torch.no_grad():
            for p, b in zip(pos, boxes):
                pot, frc = forces.ef_one(p, b)
                es.append(sum(pot.values()) if pot
                          else torch.zeros((), dtype=p.dtype, device=p.device))
                fs.append(frc)
        return torch.stack(es), torch.stack(fs)

    return efn


def _device_pos(forces, system):
    return torch.as_tensor(np.asarray(system.pos), dtype=forces.dtype, device=forces.device)


def minimize_bfgs(system, forces, fmax=0.5, steps=1000, verbose=True):
    from scipy.optimize import minimize

    if steps == 0:
        return
    if system.pos.shape[0] != 1:
        raise RuntimeError("System minimization currently doesn't support replicas.")

    efn = _energy_forces_fn(forces, system)
    info = {"Nfeval": 0}

    def evalfunc(coords):
        pos = torch.as_tensor(coords.reshape(1, -1, 3), dtype=forces.dtype,
                              device=forces.device)
        e, f = efn(pos)
        epot = float(e[0])
        grad = -f[0].cpu().numpy().astype(np.float64)
        if verbose:
            fmax_now = np.max(np.linalg.norm(grad, axis=1))
            print(f"{info['Nfeval']:>4d}  E={epot:12.6f}  fmax={fmax_now:10.6f}")
        info["Nfeval"] += 1
        return epot, grad.reshape(-1)

    if verbose:
        print(f"{'iter':>4s}  {'Epot':>14s}  {'fmax':>15s}")
    x0 = np.asarray(system.pos, dtype=np.float64)[0].flatten()
    res = minimize(
        evalfunc, x0, method="L-BFGS-B", jac=True,
        options={"gtol": fmax, "maxiter": steps},
    )
    system.pos[:] = res.x.reshape(1, -1, 3).astype(system.pos.dtype)
    return res


def minimize_lbfgs(system, forces, steps=10, max_iter=20, verbose=True):
    """L-BFGS on the device: `steps` calls of `torch.optim.LBFGS.step`
    of up to `max_iter` iterations each, with a strong-Wolfe line search.
    Returns the energy (summed over replicas) before each call and at
    the end."""
    if steps == 0:
        return
    efn = _energy_forces_fn(forces, system)
    x = _device_pos(forces, system).clone().requires_grad_(True)
    opt = torch.optim.LBFGS([x], max_iter=max_iter, line_search_fn="strong_wolfe",
                            tolerance_grad=1e-12, tolerance_change=1e-15)

    def closure():
        e, f = efn(x.detach())
        x.grad = -f
        return e.sum()

    energies = []
    if verbose:
        print(f"{'iter':>4s}  {'Epot':>14s}")
    for i in range(steps):
        energies.append(float(opt.step(closure)))
        if verbose:
            print(f"{i:>4d}  E={energies[-1]:12.6f}")
    energies.append(float(efn(x.detach())[0].sum()))
    system.pos[:] = x.detach().cpu().numpy().astype(system.pos.dtype)
    return np.asarray(energies)


# Reference-compatible alias (same role as minimize_pytorch_bfgs)
minimize_pytorch_bfgs = minimize_lbfgs


def minimize_fire(system, forces, steps=500, dt_fs=0.5, dt_max_factor=10.0,
                  alpha0=0.1, f_inc=1.1, f_dec=0.5, f_alpha=0.99, n_min=5):
    """FIRE (Fast Inertial Relaxation Engine) minimization on the device
    (torchmd_tpu/minimizers.py:125-185): power, mixing and the time-step
    rules over all replicas at once, each branch a `torch.where`.

    Returns the per-step energy history (nreplicas-summed)."""
    from .units import TIMEFACTOR

    efn = _energy_forces_fn(forces, system)
    dt_, dev = forces.dtype, forces.device
    pos = _device_pos(forces, system)
    masses = torch.as_tensor(np.asarray(forces.par.masses).reshape(1, -1, 1),
                             dtype=dt_, device=dev)
    dt0 = dt_fs / TIMEFACTOR
    dt_max = torch.tensor(dt0 * dt_max_factor, dtype=dt_, device=dev)
    vel = torch.zeros_like(pos)
    dt = torch.tensor(dt0, dtype=dt_, device=dev)
    alpha = torch.tensor(alpha0, dtype=dt_, device=dev)
    n_up = torch.zeros((), dtype=torch.int64, device=dev)
    energies = []
    for _ in range(steps):
        e, f = efn(pos)
        power = (f * vel).sum()
        fnorm = torch.sqrt((f * f).sum())
        vnorm = torch.sqrt((vel * vel).sum())
        vel_mixed = (1.0 - alpha) * vel + alpha * vnorm * f / torch.clamp(fnorm, min=1e-20)
        uphill = power <= 0
        vel = torch.where(uphill, torch.zeros_like(vel), vel_mixed)
        grow = (power > 0) & (n_up >= n_min)
        dt = torch.where(uphill, dt * f_dec,
                         torch.where(grow, torch.minimum(dt * f_inc, dt_max), dt))
        alpha = torch.where(uphill, torch.full_like(alpha, alpha0),
                            torch.where(grow, alpha * f_alpha, alpha))
        n_up = torch.where(uphill, torch.zeros_like(n_up), n_up + 1)
        vel = vel + dt * f / masses
        pos = pos + dt * vel
        energies.append(e.sum())
    system.pos[:] = pos.cpu().numpy().astype(system.pos.dtype)
    return torch.stack(energies).cpu().numpy() if energies else np.zeros(0)


def _get_energy_forces_2d(efn, pos, getForces=True):
    """efn takes (natoms, 3) positions; returns (E, forces (natoms, 3))."""
    e, f = efn(pos)
    if getForces:
        return float(e), f
    return float(e)


def _bracket_and_golden_section_search(efn, initpos, search_dir, u):
    """Bracketing + golden-section line search along `search_dir`
    (same algorithm as the reference's minimizers.py:108-261)."""
    tau = 0.618033988749895
    dis = 1.0
    tol = 1.0e-2
    u_amin = u

    smax = float(torch.sqrt(torch.max(torch.sum(search_dir**2, dim=1))))
    amax = dis / smax
    amin = 0.0
    delta = amax - amin
    a1 = amin + (1 - tau) * delta
    a2 = amin + tau * delta
    is_bracket = (delta * smax) <= tol

    u_amax = _get_energy_forces_2d(efn, initpos + amax * search_dir, False)
    u_a1 = _get_energy_forces_2d(efn, initpos + a1 * search_dir, False)
    pos = initpos + a2 * search_dir
    u_a2, frc = _get_energy_forces_2d(efn, pos, True)
    u = u_a2

    while not is_bracket:
        if u_a1 >= u_amin:
            amax, u_amax = a1, u_a1
            delta = amax - amin
            a1 = amin + (1 - tau) * delta
            a2 = amin + tau * delta
            u_a1 = _get_energy_forces_2d(efn, initpos + a1 * search_dir, False)
            pos = initpos + a2 * search_dir
            u_a2, frc = _get_energy_forces_2d(efn, pos, True)
            is_bracket = delta * smax <= tol
            u = u_a2
        elif u_a2 >= u_amin:
            amax, u_amax = a2, u_a2
            a2, u_a2 = a1, u_a1
            delta = amax - amin
            a1 = amin + (1 - tau) * delta
            pos = initpos + a1 * search_dir
            u_a1, frc = _get_energy_forces_2d(efn, pos, True)
            is_bracket = delta * smax <= tol
            u = u_a1
        elif u_amax < u_a1 and u_amax < u_a2:
            amin, u_amin = a2, u_a2
            a1, u_a1 = amax, u_amax
            amax = amin + delta
            a2 = amin + tau * delta
            u_amax = _get_energy_forces_2d(efn, initpos + amax * search_dir, False)
            pos = initpos + a2 * search_dir
            u_a2, frc = _get_energy_forces_2d(efn, pos, True)
        else:
            is_bracket = True

    while delta * smax > tol:
        if u_a1 > u_a2:
            amin, u_amin = a1, u_a1
            delta = amax - amin
            a1, u_a1 = a2, u_a2
            a2 = amin + tau * delta
            pos = initpos + a2 * search_dir
            u_a2, frc = _get_energy_forces_2d(efn, pos, True)
            u = u_a2
        else:
            amax, u_amax = a2, u_a2
            delta = amax - amin
            a2, u_a2 = a1, u_a1
            a1 = amin + (1 - tau) * delta
            pos = initpos + a1 * search_dir
            u_a1, frc = _get_energy_forces_2d(efn, pos, True)
            u = u_a1

    return pos, frc, u


def minimize_cg(system, forces, steps=1000, start_step: int = 0, threshold=None):
    if system.pos.shape[0] != 1:
        raise RuntimeError("minimize_cg supports a single replica")
    efn_batched = _energy_forces_fn(forces, system)

    def efn(pos2d):
        e, f = efn_batched(pos2d[None])
        return e[0], f[0]

    pos = _device_pos(forces, system)[0]
    u, frc = _get_energy_forces_2d(efn, pos, getForces=True)
    search_dir = frc
    fdf = float(torch.sum(frc**2))

    final = steps - 1
    for step in range(start_step, steps):
        pos, frc, u = _bracket_and_golden_section_search(efn, pos, search_dir, u)
        old_fdf = fdf
        fdf = float(torch.sum(frc**2))
        beta = fdf / old_fdf
        search_dir = frc + beta * search_dir
        energy, frc = _get_energy_forces_2d(efn, pos, True)
        maxforce = float(torch.max(torch.abs(frc)))
        logger.info(f"{step:12d} {energy:14.4f} {maxforce:16.4f}")
        if threshold is not None and maxforce < threshold:
            final = step
            break

    system.pos[:] = pos.cpu().numpy()[None].astype(system.pos.dtype)
    return final
