"""Velocity-Verlet + Langevin dynamics on a torch device.

Numerics follow the reference integrator (torchmd/integrator.py:61-125)
and the JAX package's scan body (torchmd_tpu/integrator.py:565-600):
per step
    first half-kick + drift -> forces -> Langevin kick -> second half-kick
with dt = timestep_fs / TIMEFACTOR, gamma in ps^-1 converted by
PICOSEC2TIMEU, and the noise coefficient sqrt(2 gamma kB T dt / m).

`Integrator.step(niter)` runs its `niter` steps as a Python loop on the
device and synchronises with the host once per call: positions,
velocities, forces, kinetic and potential energy come back in one packed
copy. Thermostat noise comes from an explicit `torch.Generator`.
"""

from __future__ import annotations

import numpy as np
import torch

from torchmd_tpu.units import BOLTZMANN, PICOSEC2TIMEU, TIMEFACTOR

from .systems import SimState, to_numpy

__all__ = [
    "TIMEFACTOR", "BOLTZMAN", "PICOSEC2TIMEU",
    "kinetic_energy", "kinetic_to_temp", "maxwell_boltzmann",
    "langevin_kick", "Integrator",
]

BOLTZMAN = BOLTZMANN  # reference-compatible alias


def kinetic_energy(masses, vel):
    """Kinetic energy per replica, (nreplicas, 1)."""
    if vel.ndim != 3:
        raise ValueError(f"vel must be 3D (nreplicas, natoms, 3), got {vel.ndim}D")
    m = masses.reshape(1, -1)
    return (0.5 * m * (vel * vel).sum(2)).sum(1, keepdim=True)


def kinetic_to_temp(Ekin, natoms):
    return 2.0 / (3.0 * np.asarray(natoms) * BOLTZMANN) * Ekin


def maxwell_boltzmann(masses, T, replicas=1, generator=None, seed=1,
                      device=None, dtype=None):
    """Initial velocities ~ N(0, sqrt(kB T / m)) per component, as a
    (replicas, natoms, 3) tensor (reference torchmd/integrator.py:46-54).
    Massless rows get zero velocity. Noise comes from `generator`, or from
    a new one seeded with `seed` on `device`."""
    if generator is not None:
        device = generator.device
    device = torch.device(device or "cpu")
    masses = torch.as_tensor(to_numpy(masses), device=device).reshape(-1, 1)
    dtype = dtype or (masses.dtype if masses.is_floating_point()
                      else torch.float64)
    masses = masses.to(dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    safe = torch.where(masses > 0, masses, torch.ones_like(masses))
    std = torch.where(masses > 0, torch.sqrt(T * BOLTZMANN / safe),
                      torch.zeros_like(masses))
    noise = torch.randn((replicas, masses.shape[0], 3), generator=generator,
                        device=device, dtype=dtype)
    return std * noise


def _safe_accel(force, mass):
    """force/mass with massless rows pinned to zero."""
    safe = torch.where(mass > 0, mass, torch.ones_like(mass))
    return torch.where(mass > 0, force / safe, torch.zeros_like(force))


def _first_vv(pos, vel, force, mass, dt):
    accel = _safe_accel(force, mass)
    pos = pos + vel * dt + 0.5 * accel * dt * dt
    vel = vel + 0.5 * dt * accel
    return pos, vel


def _second_vv(vel, force, mass, dt):
    return vel + 0.5 * dt * _safe_accel(force, mass)


def langevin_kick(vel, noise, gamma, dt, vcoeff):
    """Friction + noise: vel - gamma vel dt + noise vcoeff
    (torchmd_tpu/integrator.py:584). `noise` is standard normal."""
    return vel - gamma * vel * dt + noise * vcoeff


class Integrator:
    """Reference-compatible integrator (torchmd/integrator.py:80-125):
    same constructor, same `step(niter) -> (Ekin, Epot, T)` contract with
    numpy outputs. The state lives on the device of `forces`."""

    def __init__(self, systems, forces, timestep, device=None, gamma=None,
                 T=None, batch=None, seed=1, generator=None, mesh=None,
                 constraints=None, thermostat=None, barostat=None, mts=None,
                 **unported):
        for name, value in (("batch", batch), ("mesh", mesh),
                            ("constraints", constraints),
                            ("barostat", barostat), ("mts", mts),
                            *unported.items()):
            if value is not None and not (isinstance(value, (bool, int))
                                          and not value):
                raise NotImplementedError(
                    f"Integrator({name}=...) is not ported yet; a later slice "
                    "of the port brings it")
        if thermostat not in (None, "langevin", "none"):
            raise NotImplementedError(
                f"thermostat={thermostat!r} is not ported yet (thermostats.py "
                "comes with slice 3 of the port); Langevin is")
        if T is not None and np.ndim(T) > 0:
            raise NotImplementedError("per-replica T vectors are not ported yet")

        self.dt = timestep / TIMEFACTOR
        self.systems = systems
        self.forces = forces
        self.device = forces.device
        if device is not None and torch.device(device) != self.device:
            raise ValueError(
                f"device {device} differs from the forces' device {self.device}")
        self.dtype = forces.dtype
        self.gamma = None if gamma is None else gamma / PICOSEC2TIMEU
        self.T = T

        if np.any(np.asarray(systems.masses) != 0):
            masses = np.asarray(systems.masses, dtype=np.float64)
        else:
            masses = np.asarray(forces.par.masses, dtype=np.float64).reshape(-1, 1)
        self.natoms = int(np.sum(masses.reshape(-1) > 0))
        if self.natoms < len(masses):
            raise NotImplementedError(
                "massless atoms (virtual sites) are not ported yet")
        self.masses = torch.as_tensor(masses, dtype=self.dtype, device=self.device)

        self._langevin = T is not None and T > 0 and self.gamma is not None
        if T is not None and T > 0 and self.gamma is None:
            raise ValueError(
                "T (thermostat temperature) set but no coupling: pass gamma "
                "(Langevin friction, ps^-1)")
        self.vcoeff = None
        if self._langevin:
            m = self.masses
            safe = torch.where(m > 0, m, torch.ones_like(m))
            base = torch.where(
                m > 0, torch.sqrt(2.0 * self.gamma / safe * BOLTZMANN * self.dt),
                torch.zeros_like(m))
            self.vcoeff = base * torch.tensor(float(np.sqrt(float(T))),
                                              dtype=self.dtype, device=self.device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator

        self._dev_state = None
        self._host_snap = None

    # ------------------------------------------------------------------
    def _state_from_system(self) -> SimState:
        """Device state; reused when the System's arrays are unchanged since
        the last sync, else one packed host->device copy."""
        s = self.systems
        snap = (s.pos, s.vel, s.forces)
        if self._dev_state is not None and all(
                np.array_equal(a, b) for a, b in zip(self._host_snap, snap)):
            return self._dev_state
        packed = torch.as_tensor(np.stack(snap), dtype=self.dtype,
                                 device=self.device)
        self._dev_state = SimState(packed[0], packed[1], packed[2])
        self._host_snap = tuple(a.copy() for a in snap)
        return self._dev_state

    def _pack(self, state: SimState, epot):
        """pos, vel, forces and an (Ekin, Epot) row, stacked for one copy."""
        r, n = state.pos.shape[0], state.pos.shape[1]
        aux = torch.zeros((r, 3 * n), dtype=self.dtype, device=self.device)
        aux[:, 0] = kinetic_energy(self.masses, state.vel)[:, 0]
        aux[:, 1] = epot
        return torch.stack([state.pos, state.vel, state.forces,
                            aux.reshape(r, n, 3)])

    def _sync_to_host(self, state: SimState, epot):
        """One packed device->host copy; returns (Ekin, Epot) per replica."""
        s = self.systems
        packed = self._pack(state, epot).cpu().numpy()
        s.pos[:] = packed[0]
        s.vel[:] = packed[1]
        s.forces[:] = packed[2]
        self._dev_state = state
        self._host_snap = (s.pos.copy(), s.vel.copy(), s.forces.copy())
        aux = packed[3].reshape(packed.shape[1], -1)
        return aux[:, 0].astype(np.float64), aux[:, 1].astype(np.float64)

    def _energy_forces(self, pos, boxes):
        """(Epot (R,), forces (R, N, 3)) through the forces' evaluator."""
        epots, frcs = [], []
        for r in range(pos.shape[0]):
            pot, frc = self.forces.ef_one(pos[r], boxes[r])
            epots.append(sum(pot.values()))
            frcs.append(frc)
        return torch.stack(epots), torch.stack(frcs)

    def step(self, niter=1):
        if niter < 1:
            raise ValueError(f"niter must be >= 1, got {niter}")
        box_np = np.asarray(self.systems.box_diag, dtype=np.float64)
        # static no-PBC specialisation: an all-zero box leaves the wrap out
        use_pbc = bool(np.any(box_np != 0))
        boxes = [torch.as_tensor(b, dtype=self.dtype, device=self.device)
                 if use_pbc else None for b in box_np]
        state = self._state_from_system()
        pos, vel, frc = state
        m, dt = self.masses, self.dt
        with torch.no_grad():
            for _ in range(niter):
                pos, vel = _first_vv(pos, vel, frc, m, dt)
                epot, frc = self._energy_forces(pos, boxes)
                if self._langevin:
                    noise = torch.randn(vel.shape, generator=self.generator,
                                        device=self.device, dtype=self.dtype)
                    vel = langevin_kick(vel, noise, self.gamma, dt, self.vcoeff)
                vel = _second_vv(vel, frc, m, dt)
            Ekin, Epot = self._sync_to_host(SimState(pos, vel, frc), epot)
        T = kinetic_to_temp(Ekin, self.natoms)
        return Ekin, Epot, T
