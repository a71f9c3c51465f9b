"""Velocity-Verlet dynamics on a torch device: Langevin or Nose-Hoover
chain, SETTLE rigid waters, virtual sites, and the cell-list path.

Numerics follow the reference integrator (torchmd/integrator.py:61-125)
and the JAX package's scan bodies (torchmd_tpu/integrator.py:565-600 and,
for the cell-list path, :871-899). Per step

    NHC half -> first half-kick + drift -> SETTLE positions (and the
    velocity correction) -> virtual sites snapped -> cell list rebuilt ->
    forces (with PME) -> Langevin kick -> second half-kick -> SETTLE
    velocities -> NHC half

with dt = timestep_fs / TIMEFACTOR, gamma in ps^-1 converted by
PICOSEC2TIMEU, and the noise coefficient sqrt(2 gamma kB T dt / m).

`Integrator.step(niter)` runs its `niter` steps as a Python loop on the
device and synchronises with the host once per call: positions,
velocities, forces, kinetic and potential energy and the cell list's
overflow flag come back in one packed copy. The cell list is rebuilt on
the device at every step (no host decision); a cell that overflows its
capacity sets a sticky flag, and the chunk is redone from its starting
state with a grown capacity. Thermostat noise comes from an explicit
`torch.Generator`.
"""

from __future__ import annotations

import numpy as np
import torch

from .systems import SimState, resolve_device, to_numpy
from .units import BOLTZMANN, PICOSEC2TIMEU, TIMEFACTOR

__all__ = [
    "TIMEFACTOR", "BOLTZMAN", "PICOSEC2TIMEU",
    "kinetic_energy", "kinetic_to_temp", "maxwell_boltzmann",
    "langevin_kick", "Integrator",
]

BOLTZMAN = BOLTZMANN  # reference-compatible alias
MAX_OVERFLOW_RETRIES = 4


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
    a new one seeded with `seed` on `device` (default: the CUDA card)."""
    device = generator.device if generator is not None else resolve_device(device)
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
    numpy outputs. The state lives on the device of `forces`.

    `constraints="settle"` holds rigid waters (T then counts 3N_real - n_con
    degrees of freedom); `thermostat="nhc"` couples a Nose-Hoover chain
    (`tau` fs, default 100 timesteps; `thermostat_energy()` is its part of
    the conserved energy). Massless atoms must be virtual sites of the
    force field."""

    def __init__(self, systems, forces, timestep, device=None, gamma=None,
                 T=None, batch=None, seed=1, generator=None, mesh=None,
                 constraints=None, thermostat=None, tau=None, nchain=3,
                 barostat=None, mts=None, **unported):
        for name, value in (("batch", batch), ("mesh", mesh),
                            ("barostat", barostat), ("mts", mts),
                            *unported.items()):
            if value is not None and not (isinstance(value, (bool, int))
                                          and not value):
                raise NotImplementedError(
                    f"Integrator({name}=...) is not ported yet; a later slice "
                    "of the port brings it")
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
        n_real = int(np.sum(masses.reshape(-1) > 0))
        self.natoms = n_real
        self.vsites = getattr(forces, "vsites", None)
        if n_real < len(masses) and not self.vsites:
            raise ValueError(
                "massless atoms present but no virtual-site spec on the "
                "parameters (forces.par.vsites)")
        self.masses = torch.as_tensor(masses, dtype=self.dtype, device=self.device)

        self.constraints = None
        self._dof_scale = 1.0
        if constraints:
            from .constraints import build_constraint_spec

            self.constraints = build_constraint_spec(
                forces.par, masses, mode=constraints, device=self.device,
                dtype=self.dtype)
            if self.constraints is not None:
                self._dof_scale = (3 * n_real) / max(
                    3 * n_real - self.constraints.ncon, 1)

        self._thermostat = None
        self._thermo_aux = {}
        if thermostat not in (None, "langevin", "none"):
            from .thermostats import make_thermostat

            if not T:
                raise ValueError(f"thermostat='{thermostat}' requires T")
            ncon = self.constraints.ncon if self.constraints is not None else 0
            tau_fs = float(tau) if tau is not None else 100.0 * float(timestep)
            self._thermostat = make_thermostat(
                thermostat, T, tau_fs, 3 * n_real - ncon, nchain=nchain)
            self.gamma = None  # the chain replaces the Langevin kick
            self._thermo_aux = self._thermostat.init(
                systems.nreplicas, self.dtype, self.device)

        self._langevin = T is not None and T > 0 and self.gamma is not None
        if T is not None and T > 0 and self.gamma is None and self._thermostat is None:
            raise ValueError(
                "T (thermostat temperature) set but no coupling: pass gamma "
                "(Langevin friction, ps^-1) or thermostat='nhc'")
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

        self.overflow_retries = 0
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

    def _pack(self, state: SimState, epot, overflow):
        """pos, vel, forces and an (Ekin, Epot, overflow) row, stacked for
        one copy."""
        r, n = state.pos.shape[0], state.pos.shape[1]
        aux = torch.zeros((r, 3 * n), dtype=self.dtype, device=self.device)
        aux[:, 0] = kinetic_energy(self.masses, state.vel)[:, 0]
        aux[:, 1] = epot
        aux[:, 2] = overflow.to(self.dtype)
        return torch.stack([state.pos, state.vel, state.forces,
                            aux.reshape(r, n, 3)])

    def _sync_to_host(self, state: SimState, epot, overflow):
        """One packed device->host copy; returns (Ekin, Epot, overflowed)
        and, unless the chunk overflowed, writes the state to the System."""
        packed = self._pack(state, epot, overflow).cpu().numpy()
        aux = packed[3].reshape(packed.shape[1], -1)
        if aux[0, 2] != 0:
            return None, None, True
        s = self.systems
        s.pos[:] = packed[0]
        s.vel[:] = packed[1]
        s.forces[:] = packed[2]
        self._dev_state = state
        self._host_snap = (s.pos.copy(), s.vel.copy(), s.forces.copy())
        return aux[:, 0].astype(np.float64), aux[:, 1].astype(np.float64), False

    def _energy_forces(self, pos, boxes, kern):
        """(Epot (R,), forces (R, N, 3), overflow flag) through the forces'
        evaluator; on the cell path the list is rebuilt from `pos`."""
        epots, frcs = [], []
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        for r in range(pos.shape[0]):
            if kern is None:
                pot, frc = self.forces.ef_one(pos[r], boxes[r])
            else:
                cl = kern.build(pos[r], boxes[r])
                overflow = overflow | cl.overflow
                pot, frc = self.forces.ef_one(pos[r], boxes[r], cl)
            epots.append(sum(pot.values()))
            frcs.append(frc)
        return torch.stack(epots), torch.stack(frcs), overflow

    def _run(self, state: SimState, aux, boxes, niter):
        """`niter` steps from `state` on the device: (state, Epot, thermostat
        state, overflow flag)."""
        from .constraints import (apply_position_constraints,
                                  apply_velocity_constraints)
        from .vsites import apply_vsites

        m, dt = self.masses, self.dt
        thermo, cs, vsites = self._thermostat, self.constraints, self.vsites
        kern = getattr(self.forces, "_cell_kernel", None)
        pos, vel, frc = state
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        for _ in range(niter):
            if thermo is not None:
                vel, aux = thermo.pre(vel, aux, m, dt)
            pos_new, vel = _first_vv(pos, vel, frc, m, dt)
            if cs is not None:
                pos_c = apply_position_constraints(cs, pos_new, pos)
                vel = vel + (pos_c - pos_new) / dt
                pos_new = pos_c
            pos = pos_new
            if vsites:
                pos = torch.stack([apply_vsites(vsites, p, b)
                                   for p, b in zip(pos, boxes)])
            epot, frc, ov = self._energy_forces(pos, boxes, kern)
            overflow = overflow | ov
            if self._langevin:
                noise = torch.randn(vel.shape, generator=self.generator,
                                    device=self.device, dtype=self.dtype)
                vel = langevin_kick(vel, noise, self.gamma, dt, self.vcoeff)
            vel = _second_vv(vel, frc, m, dt)
            if cs is not None:
                vel = apply_velocity_constraints(cs, pos, vel)
            if thermo is not None:
                vel, aux = thermo.post(vel, aux, m, dt)
        return SimState(pos, vel, frc), epot, aux, overflow

    def step(self, niter=1):
        if niter < 1:
            raise ValueError(f"niter must be >= 1, got {niter}")
        box_np = np.asarray(self.systems.box_diag, dtype=np.float64)
        # static no-PBC specialisation: an all-zero box leaves the wrap out
        use_pbc = bool(np.any(box_np != 0))
        boxes = [torch.as_tensor(b, dtype=self.dtype, device=self.device)
                 if use_pbc else None for b in box_np]
        state0 = self._state_from_system()
        if use_pbc and hasattr(self.forces, "prepare"):
            self.forces.prepare(state0.pos, box_np)
        with torch.no_grad():
            for _ in range(MAX_OVERFLOW_RETRIES):
                state, epot, aux, overflow = self._run(
                    state0, self._thermo_aux, boxes, niter)
                Ekin, Epot, overflowed = self._sync_to_host(state, epot, overflow)
                if not overflowed:
                    self._thermo_aux = aux
                    break
                # a cell outgrew its capacity: grow and redo the chunk
                self.overflow_retries += 1
                self.forces.set_cell_kernel(self.forces._cell_kernel.grow())
            else:
                raise RuntimeError("cell list capacity kept overflowing")
        T = kinetic_to_temp(Ekin, self.natoms) * self._dof_scale
        return Ekin, Epot, T

    def thermostat_energy(self):
        """Thermostat contribution to the conserved (extended) energy per
        replica: add to Ekin + Epot to monitor NHC drift (zero for
        Langevin or no thermostat)."""
        if self._thermostat is None:
            return np.zeros(self.systems.nreplicas)
        return self._thermostat.conserved(self._thermo_aux).cpu().numpy().astype(np.float64)
