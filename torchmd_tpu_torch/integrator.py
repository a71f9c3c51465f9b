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

`barostat=MTKBarostat(...)` runs NPT: the explicit reversible MTK
splitting of the JAX package's kernel NPT scan
(torchmd_tpu/integrator.py:1357-1613), on the cell or column kernel path.
Per step

    barostat chain half -> particle chain half -> v_eps kick -> scaled
    half-kick -> scaled drift, box * exp(v_eps dt) -> SETTLE against the
    box-scaled old positions (and the constraint virial) -> sites snapped
    -> neighbour structure rebuilt by the current box -> forces and the
    per-axis virial -> half-kick -> v_eps kick -> particle chain half ->
    barostat chain half -> SETTLE velocities

The virial is the pair kernel's (`energy_forces_virial`), PME's
(`PmeRecip.energy_forces_virial`, exact gather unless `Forces(gather=)`
says otherwise, because the JAX package takes NPT forces as the exact
gradient), the cheap terms' by autograd over (pos, s), and the site
correction -sum F (r - dr/ds). It is carried between chunks and
recomputed when the host changed the state. Two f32 details differ from
the JAX package's formulas and equal them in exact arithmetic: positions
and box scale as r + r expm1(u), not r exp(u), and the constraint virial
takes each water's hydrogens relative to its oxygen, not absolute
positions (`constraints.constraint_virial`); on the 62,500-site box in f32
the absolute form's cancellation moved the box as much as a 1 % charge
error. The dense, r-RESPA and spatial NPT scans and the Monte Carlo
barostats are not ported yet.
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
        for name, value in (("batch", batch), ("mesh", mesh), ("mts", mts),
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

        self._npt = None
        self._npt_vir_given = False
        if barostat is not None:
            self._setup_npt(barostat, timestep, tau, nchain, T)

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
        self._state_was_cached = False

    def _setup_npt(self, barostat, timestep, tau, nchain, T):
        """MTK set-up (torchmd_tpu/integrator.py:209-280): the barostat
        mass W, the particle chain (made at the barostat's temperature when
        none was given; Langevin is refused) and the barostat's own chain
        of 1 (iso), 2 (membrane) or the scaled axes' degrees of freedom."""
        from .thermostats import NoseHooverChain, make_thermostat

        if not getattr(barostat, "is_dynamic", False):
            raise NotImplementedError(
                "Monte Carlo barostats are not ported yet; use MTKBarostat")
        systems, forces = self.systems, self.forces
        box0 = np.asarray(systems.box_diag, np.float64)
        if np.any(box0 <= 0):
            raise ValueError("MTK barostat requires a periodic box")
        ncon = self.constraints.ncon if self.constraints is not None else 0
        ndof = 3 * self.natoms - ncon
        if self._thermostat is None:
            if T is not None and T > 0 and self.gamma is not None:
                raise ValueError(
                    "MTK barostat requires thermostat='nhc' (Langevin piston "
                    "is not implemented)")
            self._thermostat = make_thermostat(
                "nhc", barostat.T,
                float(tau) if tau is not None else 100.0 * float(timestep),
                ndof, nchain=nchain)
            self._thermo_aux = self._thermostat.init(
                systems.nreplicas, self.dtype, self.device)
            self.gamma = None
        if not (hasattr(forces, "wants_cell") and forces.wants_cell(box0[0])):
            raise NotImplementedError(
                "NPT runs on the cell or column kernel path only; the dense, "
                "r-RESPA and spatial NPT scans are not ported yet")
        kT = BOLTZMANN * barostat.T
        taup_fs = barostat.tau_fs or 1000.0 * float(timestep)
        taup = taup_fs / TIMEFACTOR
        mode = barostat.mode
        scale_axes = np.asarray(barostat.scale_axes, bool)
        nbdof = {"iso": 1, "membrane": 2}.get(mode, int(scale_axes.sum()))
        chain_b = NoseHooverChain(barostat.T, taup_fs, ndof=nbdof,
                                  nchain=barostat.nchain)
        self._npt = {
            # per-axis barostat mass: over tied axes the scalar MTK W
            "W": (ndof + 3) * kT * taup**2 / 3.0,
            "ndof": ndof,
            "P": barostat.pressure,
            "chain_b": chain_b,
            "mode": mode,
            "gamma_st": barostat.gamma_st,
            "axes": torch.as_tensor(scale_axes, dtype=self.dtype, device=self.device),
        }
        nrep = systems.nreplicas
        self._npt_extra = (
            torch.zeros((nrep, 3), dtype=self.dtype, device=self.device),
            chain_b.init(nrep, self.dtype, self.device),
            None,  # the virial, computed at the first chunk
        )

    # ------------------------------------------------------------------
    def _state_from_system(self) -> SimState:
        """Device state; reused when the System's arrays are unchanged since
        the last sync, else one packed host->device copy."""
        s = self.systems
        snap = (s.pos, s.vel, s.forces)
        if self._dev_state is not None and all(
                np.array_equal(a, b) for a, b in zip(self._host_snap, snap)):
            self._state_was_cached = True
            return self._dev_state
        self._state_was_cached = False
        packed = torch.as_tensor(np.stack(snap), dtype=self.dtype,
                                 device=self.device)
        self._dev_state = SimState(packed[0], packed[1], packed[2])
        self._host_snap = tuple(a.copy() for a in snap)
        return self._dev_state

    def _pack(self, state: SimState, epot, overflow, box=None):
        """pos, vel, forces and an (Ekin, Epot, overflow[, box]) row,
        stacked for one copy."""
        r, n = state.pos.shape[0], state.pos.shape[1]
        aux = torch.zeros((r, 3 * n), dtype=self.dtype, device=self.device)
        aux[:, 0] = kinetic_energy(self.masses, state.vel)[:, 0]
        aux[:, 1] = epot
        aux[:, 2] = overflow.to(self.dtype)
        if box is not None:
            aux[:, 3:6] = box
        return torch.stack([state.pos, state.vel, state.forces,
                            aux.reshape(r, n, 3)])

    def _sync_to_host(self, state: SimState, epot, overflow, box=None):
        """One packed device->host copy; returns (Ekin, Epot, overflowed)
        and, unless the chunk overflowed, writes the state (and the box,
        when given) to the System."""
        packed = self._pack(state, epot, overflow, box).cpu().numpy()
        aux = packed[3].reshape(packed.shape[1], -1)
        if aux[0, 2] != 0:
            return None, None, True
        s = self.systems
        s.pos[:] = packed[0]
        s.vel[:] = packed[1]
        s.forces[:] = packed[2]
        if box is not None:
            for r in range(s.nreplicas):
                np.fill_diagonal(s.box[r], aux[r, 3:6])
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
        if self._npt is not None:
            return self._step_npt(niter)
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

    # ------------------------------------------------------------------
    # MTK NPT on the cell or column kernel path
    # ------------------------------------------------------------------
    @property
    def npt_state(self):
        """(v_eps (R, 3), barostat chain state {"xi", "vxi"}, carried
        virial (R, 3) or None) on the device. Assigned without a virial
        (or with None), the virial is recomputed at the next chunk's entry
        state; the carried one also holds the last step's constraint
        virial."""
        return self._npt_extra

    @npt_state.setter
    def npt_state(self, value):
        v_eps, aux_b, *vir = value
        self._npt_extra = (v_eps, aux_b, vir[0] if vir else None)
        # a virial handed over with the state belongs to the System's
        # current state: the next chunk uses it as carried
        self._npt_vir_given = self._npt_extra[2] is not None

    def _npt_gather(self):
        return self.forces.pme_gather or "exact"

    def _cheap_terms(self):
        """True when the bonded terms have work: the kernel path's plan
        drops rows with a zero force constant (the water box's SETTLE
        bonds), and an empty plan leaves nothing to differentiate."""
        plan = self.forces._bonded_plan
        return plan is not None and bool(getattr(plan, "families", True))

    def _npt_ef_vir(self, pos, box, cl):
        """(Epot, forces, per-axis virial -dU(s pos, s box)/ds) of one
        replica (torchmd_tpu/integrator.py:1410-1460): the neighbour
        kernel's pair terms and PME analytically at the snapped geometry,
        with the site correction -sum F (r - dr/ds) before the site forces
        move onto the hosts; the cheap terms by autograd over (pos, s)."""
        from .potentials import compute_potentials
        from .vsites import apply_vsites, apply_vsites_scaling, spread_vsite_forces

        forces, vsg = self.forces, self.vsites
        kern, rec = forces._cell_kernel, forces._ewald
        p2 = pos
        if vsg:
            p2, tangent = apply_vsites_scaling(vsg, pos, box)
        pot, frc, vir = kern.energy_forces_virial(p2, box, cl)
        epot = sum(pot.values())
        if rec is not None:
            e_r, f_r, v_r = rec.energy_forces_virial(p2, box, self._npt_gather(),
                                                     order_idx=kern.spread_order(cl))
            epot, frc, vir = epot + e_r, frc + f_r, vir + v_r
        if vsg:
            vir = vir - (frc * (p2 - tangent)).sum(0)
            frc = spread_vsite_forces(vsg, pos, frc, box)
        if self._cheap_terms():
            with torch.enable_grad():
                p = pos.detach().requires_grad_(True)
                s = torch.ones(3, dtype=pos.dtype, device=pos.device, requires_grad=True)
                ps, bs = p * s, box * s
                if vsg:
                    ps = apply_vsites(vsg, ps, bs)
                terms = compute_potentials(forces.ffparams, ps, bs, forces.config,
                                           nonbonded=False)
                if terms:
                    e_ch = sum(terms.values())
                    gp, gs = torch.autograd.grad(e_ch, (p, s), allow_unused=True)
                    epot = epot + e_ch.detach()
                    if gp is not None:
                        frc = frc - gp
                    if gs is not None:
                        vir = vir - gs
        return epot, frc, vir

    def _npt_evaluate(self, pos, boxes, kern):
        """(Epot (R,), forces (R, N, 3), virial (R, 3), overflow): the
        neighbour structure is built from `pos` by each replica's box."""
        out, overflow = [], torch.zeros((), dtype=torch.bool, device=self.device)
        for r in range(pos.shape[0]):
            cl = kern.build(pos[r], boxes[r])
            overflow = overflow | cl.overflow
            out.append(self._npt_ef_vir(pos[r], boxes[r], cl))
        epot, frc, vir = (torch.stack(t) for t in zip(*out))
        return epot, frc, vir, overflow

    def _run_npt(self, state: SimState, boxes, v_eps, aux_p, aux_b, vir, niter):
        """`niter` MTK steps on the device (torchmd_tpu/integrator.py:
        1480-1590); returns (state, box, v_eps, aux_p, aux_b, virial,
        Epot, overflow)."""
        from .constraints import (apply_position_constraints, apply_velocity_constraints,
                                  constraint_virial)
        from .vsites import apply_vsites

        m, dt = self.masses, self.dt
        dt2 = 0.5 * dt
        npt = self._npt
        W, ndof, P, chain_b, mode = (npt["W"], npt["ndof"], npt["P"],
                                     npt["chain_b"], npt["mode"])
        thermo, cs, vsg = self._thermostat, self.constraints, self.vsites
        kern = self.forces._cell_kernel
        mb = torch.full((1, 1), W, dtype=self.dtype, device=self.device)
        xy = torch.tensor([1.0, 1.0, 0.0], dtype=self.dtype, device=self.device)

        def project(g):
            if mode == "iso":
                return g.mean(-1, keepdim=True).expand_as(g)
            if mode == "membrane":
                gxy = 0.5 * (g[:, :1] + g[:, 1:2])
                return torch.cat([gxy, gxy, g[:, 2:]], -1)
            return g * npt["axes"]

        def baro_half(v_eps, aux_b):
            vb, xi, vxi = chain_b._chain_half(v_eps[:, None, :], aux_b["xi"],
                                              aux_b["vxi"], mb, 0.5 * dt)
            return vb[:, 0, :], {"xi": xi, "vxi": vxi}

        def eps_kick(v_eps, vel, vir, box):
            k2 = (m * vel * vel).sum(1)
            G = k2 + k2.sum(-1, keepdim=True) / ndof + vir - box.prod(-1, keepdim=True) * P
            if mode == "membrane" and npt["gamma_st"] != 0.0:
                G = G + npt["gamma_st"] * (box[:, :1] * box[:, 1:2]) * xy
            return project(v_eps + dt2 * project(G) / W)

        def kick(vel, frc, x):
            return (vel * torch.exp(-x)
                    + dt2 * _safe_accel(frc, m) * torch.exp(-0.5 * x) * _phi(0.5 * x))

        pos, vel, frc = state
        box = boxes
        epot = None
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        for _ in range(niter):
            v_eps, aux_b = baro_half(v_eps, aux_b)
            vel, aux_p = thermo.pre(vel, aux_p, m, dt)
            v_eps = eps_kick(v_eps, vel, vir, box)
            x = ((v_eps + v_eps.sum(-1, keepdim=True) / ndof) * dt2)[:, None, :]
            vel = kick(vel, frc, x)
            u = v_eps * dt
            drift = (dt * torch.exp(0.5 * u) * _phi(0.5 * u))[:, None, :]
            # r exp(u) as r + r expm1(u): in f32 the small increment keeps
            # its digits (exp(u) would round it to 6e-8 of the box per step)
            grow = torch.expm1(u)
            pos_prev = pos
            pos = pos + pos * grow[:, None, :] + vel * drift
            box = box + box * grow
            if cs is not None:
                ref = pos_prev + pos_prev * grow[:, None, :]
                pos_c = apply_position_constraints(cs, pos, ref)
                delta = pos_c - pos
                vel = vel + delta / drift
                pos = pos_c
            if vsg:
                pos = torch.stack([apply_vsites(vsg, p, b) for p, b in zip(pos, box)])
            epot, frc, vir, ov = self._npt_evaluate(pos, box, kern)
            overflow = overflow | ov
            if cs is not None:
                vir = vir + constraint_virial(cs, m, delta, drift, pos)
            vel = kick(vel, frc, x)
            v_eps = eps_kick(v_eps, vel, vir, box)
            vel, aux_p = thermo.post(vel, aux_p, m, dt)
            v_eps, aux_b = baro_half(v_eps, aux_b)
            if cs is not None:
                vel = apply_velocity_constraints(cs, pos, vel)
        return SimState(pos, vel, frc), box, v_eps, aux_p, aux_b, vir, epot, overflow

    def _step_npt(self, niter):
        """The chunk loop (torchmd_tpu/integrator.py:2880-2925): the box
        comes from the System, the kernel is re-boxed when the box left
        its grid, the virial is carried unless the host changed the state,
        and a sticky overflow grows the kernel and redoes the chunk."""
        forces = self.forces
        box_np = np.asarray(self.systems.box_diag, dtype=np.float64)
        state0 = self._state_from_system()
        cached = self._state_was_cached or self._npt_vir_given
        self._npt_vir_given = False
        forces.prepare(state0.pos, box_np)  # PME, kernel, covers/with_box, capacity
        boxes = torch.as_tensor(box_np, dtype=self.dtype, device=self.device)
        v_eps0, aux_b0, vir0 = self._npt_extra
        with torch.no_grad():
            for _ in range(MAX_OVERFLOW_RETRIES):
                vir = vir0
                if vir is None or not cached:
                    vir = self._npt_evaluate(state0.pos, boxes, forces._cell_kernel)[2]
                state, box, v_eps, aux_p, aux_b, vir, epot, overflow = self._run_npt(
                    state0, boxes, v_eps0, self._thermo_aux, aux_b0, vir, niter)
                Ekin, Epot, overflowed = self._sync_to_host(state, epot, overflow, box)
                if not overflowed:
                    break
                self.overflow_retries += 1
                forces.set_cell_kernel(forces._cell_kernel.grow())
            else:
                raise RuntimeError("neighbour structure capacity kept overflowing")
        self._thermo_aux = aux_p
        self._npt_extra = (v_eps, aux_b, vir)
        T = kinetic_to_temp(Ekin, self.natoms) * self._dof_scale
        return Ekin, Epot, T

    def npt_energy(self):
        """Barostat part of the NPT conserved quantity per replica:
        P V + sum_k W v_eps_k^2 / 2 + the barostat chain's terms
        [- gamma A for membranes]. Add to Ekin + Epot + thermostat_energy()
        to monitor MTK drift (zero without a barostat)."""
        nrep = self.systems.nreplicas
        if self._npt is None:
            return np.zeros(nrep)
        v_eps, aux_b, _ = self._npt_extra
        npt = self._npt
        boxd = np.asarray(self.systems.box_diag, np.float64)
        v = v_eps.detach().cpu().numpy().astype(np.float64)
        e = (npt["P"] * np.prod(boxd, axis=1) + 0.5 * npt["W"] * (v * v).sum(-1)
             + npt["chain_b"].conserved(aux_b).cpu().numpy().astype(np.float64))
        if npt["mode"] == "membrane":
            e = e - npt["gamma_st"] * boxd[:, 0] * boxd[:, 1]
        return e


def _phi(x):
    """sinh(x) / x, with its series below |x| = 1e-3."""
    small = x.abs() < 1e-3
    safe = torch.where(small, torch.ones_like(x), x)
    x2 = x * x
    return torch.where(small, 1.0 + x2 / 6.0 + x2 * x2 / 120.0, torch.sinh(safe) / safe)
