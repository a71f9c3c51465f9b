"""Velocity-Verlet dynamics on a torch device: Langevin, Nose-Hoover chain
or CSVR, SHAKE/RATTLE bonds and SETTLE rigid waters, virtual sites, the
neighbour-list paths (cell, column, Verlet), r-RESPA and the MTK barostat.

Numerics follow the reference integrator (torchmd/integrator.py:61-125)
and the JAX package's scan bodies (torchmd_tpu/integrator.py:565-600 and,
for the neighbour-list paths, :871-899). Per step

    NHC half -> first half-kick + drift -> SHAKE and SETTLE positions (and
    the velocity correction) -> virtual sites snapped -> neighbour
    structure refreshed -> forces (with PME) -> Langevin kick -> second
    half-kick -> RATTLE and SETTLE velocities -> NHC half (or the CSVR
    rescale)

with dt = timestep_fs / TIMEFACTOR, gamma in ps^-1 converted by
PICOSEC2TIMEU, and the noise coefficient sqrt(2 gamma kB T dt / m).

`Integrator.step(niter)` runs its `niter` steps as a Python loop on the
device and synchronises with the host once per call: positions,
velocities, forces, kinetic and potential energy and the neighbour
structure's overflow flag come back in one packed copy. The cell and
column structures are rebuilt on the device at every step (no host
decision); Verlet lists are rebuilt when the displacement since their
build asks for it (one host read of that flag a step). A structure that
outgrows its capacity sets a sticky flag, and the chunk is redone from
its starting state with a grown capacity (`overflow_log` names it).
Thermostat noise (Langevin's and CSVR's draws) comes from an explicit
`torch.Generator`. The masses are the System's when it has any (hydrogen
mass repartitioning sets them there) and the force field's otherwise;
which atoms are hydrogens for the constraints is always read from the
force field's (`constraints.build_constraint_spec`).

`mts=n` runs r-RESPA (impulse splitting, the JAX package's
`_build_scan_mts` and `_build_scan_mts_cell`, torchmd_tpu/integrator.py:
602-1154): `timestep` is the outer step, at which the slow tier (the
real-space pairs, the reciprocal term and the external; `Forces.
mts_tiers`) kicks, and the bonded tier integrates on n inner substeps of
timestep / n. Langevin friction and noise act on the substeps (the noise
coefficient over sqrt(n)), NHC and CSVR couple at the outer step's
boundary, SHAKE/RATTLE project every substep and the outer kicks, the
sites are re-snapped once per outer step, and the neighbour structure is
refreshed once per outer step, before the slow evaluation. The carried
`forces` (System.forces) hold the slow tier's, with the JAX package's
convention: a chunk entered from total forces (a fresh System) takes a
one-time dt/2 F_bonded error at its first kick. `mts_recip=R` (on the
neighbour paths, with Ewald or PME) takes the reciprocal term out of the
slow tier: it fires every R outer steps as an R dt impulse (half-kicks
opening and closing each cycle) and its forces are carried in between;
`step(niter)` then needs niter % R == 0, and each chunk evaluates the
bonded and reciprocal tiers once more at its entry. mts=1 gives the
standard step's trajectory up to rounding.

`barostat=MTKBarostat(...)` runs NPT: the explicit reversible MTK
splitting of the JAX package's NPT scans (torchmd_tpu/integrator.py:
1161-1613), on the cell or column kernel path when the forces choose it
(`Forces.choose_nb_path`), else on the dense path. Per step

    barostat chain half -> particle chain half -> v_eps kick -> scaled
    half-kick -> scaled drift, box * exp(v_eps dt) -> SHAKE and SETTLE
    against the box-scaled old positions (and the constraint virial) ->
    sites snapped -> neighbour structure rebuilt by the current box ->
    forces and the per-axis virial -> half-kick -> v_eps kick -> particle
    chain half -> barostat chain half -> RATTLE and SETTLE velocities

On the kernel path the virial is the pair kernel's
(`energy_forces_virial`), PME's (`PmeRecip.energy_forces_virial`, exact
gather unless `Forces(gather=)` says otherwise, because the JAX package
takes NPT forces as the exact gradient), the cheap terms' by autograd
over (pos, s), and the site correction -sum F (r - dr/ds). On the dense
path (`_build_scan_npt`) one autograd pass over (pos, s) of E(s pos,
s box) through the torch-op path (`potentials.compute_potentials`, the
exact Ewald sum, the sites, the external's energy_fn) gives the forces
and the virial; with PME the reciprocal part is PmeRecip's analytic one.
The JAX package runs that path in XLA, outside Pallas, so on the card
it runs torch ops and launches no kernel but PME's spread. The virial is
carried between steps and chunks and recomputed when the host changed
the state. Two f32 details differ from the JAX package's formulas and
equal them in exact arithmetic: positions and box scale as
r + r expm1(u), not r exp(u), and the constraint virial takes each
water's hydrogens relative to its oxygen and each SHAKE cluster's atoms
relative to its heaviest atom, not absolute positions
(`constraints.constraint_virial`); on the 62,500-site box in f32 the
absolute form's cancellation moved the box as much as a 1 % charge
error. With `mts=n` the MTK run is r-RESPA NPT (`_build_scan_npt_mts`):
the fast tier (bonded terms, by autograd) on the n substeps inside the
box-coupled propagator, its dU/ds from the last substep, and the slow
tier's analytic (kernel path) or autograd (dense path) virial at the
outer step. Spatial NPT runs on a mesh and is not ported yet (ROADMAP
item 21). The Monte Carlo barostats (`barostat.MonteCarloBarostat` and
its variants) are not integrator options: they attach to the run loop,
`barostat.attempt(system, forces)` between chunks, and
`Integrator(barostat=<MC>)` raises ValueError, as in the JAX package.
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


def kinetic_energy(masses, vel, batch=None, nbatch=None):
    """Kinetic energy per replica, (nreplicas, 1), or per replica and
    atom group, (nreplicas, nbatch), when `batch` (a (natoms,) int64
    tensor on vel's device) gives each atom's group (reference
    torchmd/integrator.py:8-43); `nbatch` defaults to batch.max() + 1,
    which reads the device."""
    if vel.ndim != 3:
        raise ValueError(f"vel must be 3D (nreplicas, natoms, 3), got {vel.ndim}D")
    m = masses.reshape(1, -1)
    e_atom = 0.5 * m * (vel * vel).sum(2)
    if batch is None:
        return e_atom.sum(1, keepdim=True)
    nbatch = int(batch.max()) + 1 if nbatch is None else int(nbatch)
    out = e_atom.new_zeros((e_atom.shape[0], nbatch))
    return out.index_add_(1, batch, e_atom)


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

    `constraints="hbonds"|"allbonds"` holds bonds by SHAKE/RATTLE and
    `"settle"` rigid waters by SETTLE and the other hydrogen bonds by
    SHAKE (T then counts 3N_real - n_con degrees of freedom);
    `thermostat="nhc"` couples a Nose-Hoover chain, `"csvr"` the Bussi
    rescale (`tau` fs, default 100 timesteps; `thermostat_energy()` is the
    chain's part of the conserved energy, 0 for CSVR); `mts` and
    `mts_recip` run r-RESPA (module docstring). Massless atoms must be
    virtual sites of the force field.

    `T` is a scalar or, for a replica ladder (`remd.ReplicaExchange`), a
    (nreplicas,) vector: the Langevin noise coefficient is then (R, 1, 1)
    x (natoms, 1) (torchmd_tpu/integrator.py:133-156); NHC and CSVR take a
    scalar only. `batch` ((natoms,) ints) groups the atoms into
    sub-systems: `step` then reports the kinetic energy and T per
    replica and group, (R, nbatch), with each group's atom count as its
    degrees of freedom (counted on the host, numpy)."""

    def __init__(self, systems, forces, timestep, device=None, gamma=None,
                 T=None, batch=None, seed=1, generator=None, mesh=None,
                 constraints=None, thermostat=None, tau=None, nchain=3,
                 barostat=None, mts=None, mts_recip=None, **unported):
        # r-RESPA: the JAX package's argument checks (torchmd_tpu/
        # integrator.py:321-341)
        self.mts = None if mts in (None, 0, False) else int(mts)
        if self.mts is not None:
            if self.mts < 1:
                raise ValueError(f"mts must be >= 1, got {mts}")
            if batch is not None:
                raise NotImplementedError("mts + atom batching")
        self.mts_recip = None if mts_recip in (None, 0, False, 1) else int(mts_recip)
        if self.mts_recip is not None:
            if self.mts_recip < 1:
                raise ValueError(f"mts_recip must be >= 1, got {mts_recip}")
            if batch is not None:
                raise NotImplementedError("mts_recip + atom batching")
        for name, value, item in (("mesh", mesh, "21"),
                                  *((k, v, None) for k, v in unported.items())):
            if value is not None and not (isinstance(value, (bool, int))
                                          and not value):
                where = f" (ROADMAP item {item})" if item else ""
                raise NotImplementedError(
                    f"Integrator({name}=...) is not ported yet{where}; a later "
                    "slice of the port brings it")
        if T is not None and np.ndim(T) > 0:
            t_arr = np.asarray(T, dtype=np.float64)
            if t_arr.shape != (systems.nreplicas,):
                raise ValueError(f"T vector shape {t_arr.shape} != (nreplicas,)")
        t_on = T is not None and bool(np.any(np.asarray(T) > 0))

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
        self.natoms = self._n_real = n_real
        self.batch = None
        self._batch_t = None
        if batch is not None:
            # groups counted on the host: torch.bincount on CUDA syncs
            self.batch = np.asarray(batch, dtype=np.int64).reshape(-1)
            if self.batch.shape != (len(masses),) or self.batch.min() < 0:
                raise ValueError(f"batch must give each of the {len(masses)} atoms a "
                                 "group index >= 0")
            self.natoms = np.bincount(self.batch)
            self._batch_t = torch.as_tensor(self.batch, device=self.device)
        self.vsites = getattr(forces, "vsites", None)
        if n_real < len(masses) and not self.vsites:
            raise ValueError(
                "massless atoms present but no virtual-site spec on the "
                "parameters (forces.par.vsites)")
        self.masses = torch.as_tensor(masses, dtype=self.dtype, device=self.device)

        # the path: a neighbour kernel (cell/column or Verlet) or dense, as
        # the forces choose it (torchmd_tpu/integrator.py:362-380)
        path = "dense"
        if hasattr(forces, "choose_nb_path"):
            path = forces.choose_nb_path(systems.box_diag)
        self._use_cell, self._use_verlet = path == "cell", path == "verlet"

        self.constraints = None
        self._dof_scale = 1.0
        if constraints:
            from .constraints import build_constraint_spec

            self.constraints = build_constraint_spec(
                forces.par, masses, mode=constraints, device=self.device,
                dtype=self.dtype)
            if self.constraints is not None and batch is None:
                self._dof_scale = (3 * n_real) / max(
                    3 * n_real - self.constraints.ncon, 1)

        self._thermostat = None
        self._thermo_aux = {}
        if thermostat not in (None, "langevin", "none"):
            from .thermostats import make_thermostat

            if not (T is not None and np.ndim(T) == 0 and T):
                raise ValueError(f"thermostat='{thermostat}' requires a scalar T")
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

        # the checks of torchmd_tpu/integrator.py:389-409
        if self.mts_recip is not None:
            if not (self._use_cell or self._use_verlet):
                raise NotImplementedError(
                    "mts_recip (reciprocal-outer r-RESPA) rides the "
                    "neighbor-kernel (cell/column/verlet) scan, where the "
                    "real-space/reciprocal split exists; the dense path "
                    "folds the reciprocal term into the nonbonded evaluator")
            if self._npt is not None:
                raise NotImplementedError(
                    "mts_recip + MTK barostat (the reciprocal impulse has no "
                    "virial form in the NPT splitting yet)")
            if getattr(forces, "_ewald", None) is None:
                raise ValueError(
                    "mts_recip needs Ewald/PME electrostatics (elec='ewald'): "
                    "there is no reciprocal tier to defer otherwise")
        if (self.mts or self.mts_recip) and not hasattr(forces, "mts_tiers"):
            raise NotImplementedError(
                "mts (r-RESPA) needs a force provider with split evaluators "
                "(Forces.mts_tiers)")

        self._langevin = t_on and self.gamma is not None
        if t_on and self.gamma is None and self._thermostat is None:
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
            if np.ndim(T) > 0:
                self.vcoeff = torch.as_tensor(
                    np.sqrt(np.asarray(T, np.float64)), dtype=self.dtype,
                    device=self.device)[:, None, None] * base[None]
            else:
                self.vcoeff = base * torch.tensor(float(np.sqrt(float(T))),
                                                  dtype=self.dtype, device=self.device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator

        self.overflow_retries = 0
        self.overflow_log = []
        self._dev_state = None
        self._host_snap = None
        self._state_was_cached = False

    def _setup_npt(self, barostat, timestep, tau, nchain, T):
        """MTK set-up (torchmd_tpu/integrator.py:209-280): the barostat
        mass W, the particle chain (made at the barostat's temperature when
        none was given; Langevin is refused) and the barostat's own chain
        of 1 (iso), 2 (membrane) or the scaled axes' degrees of freedom.
        The cell or column kernel path when the forces choose it, else the
        dense path."""
        from .thermostats import NoseHooverChain, make_thermostat

        if not getattr(barostat, "is_dynamic", False):
            raise ValueError(
                "Monte Carlo barostats attach at the run-loop level "
                "(call barostat.attempt(system, forces) between chunks, "
                "as run.py does); only dynamic barostats (MTKBarostat) "
                "integrate inside the step loop")
        systems, forces = self.systems, self.forces
        ext = getattr(forces, "external", None)
        if ext is not None and getattr(ext, "energy_fn", None) is None:
            raise NotImplementedError(
                "an external potential with only `calculate` gives no virial: "
                "the MTK barostat needs its energy_fn")
        box0 = np.asarray(systems.box_diag, np.float64)
        if np.any(box0 <= 0):
            raise ValueError("MTK barostat requires a periodic box")
        if not hasattr(forces, "ffparams"):
            raise ValueError("MTK barostat needs a Forces with its parameters")
        ncon = self.constraints.ncon if self.constraints is not None else 0
        ndof = 3 * self._n_real - ncon
        if self._thermostat is None:
            if T is not None and np.any(np.asarray(T) > 0) and self.gamma is not None:
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

    def _nbatch(self):
        return 1 if self.batch is None else len(self.natoms)

    def _pack(self, state: SimState, epot, overflow, box=None):
        """pos, vel, forces and an (Ekin per group, Epot, overflow[, box])
        row, concatenated along the atoms for one copy."""
        r = state.pos.shape[0]
        nb = self._nbatch()
        width = 3 * (-(-(nb + 5) // 3))
        aux = torch.zeros((r, width), dtype=self.dtype, device=self.device)
        aux[:, :nb] = kinetic_energy(self.masses, state.vel, self._batch_t, nb)
        aux[:, nb] = epot
        aux[:, nb + 1] = overflow.to(self.dtype)
        if box is not None:
            aux[:, nb + 2:nb + 5] = box
        return torch.cat([state.pos, state.vel, state.forces,
                          aux.reshape(r, width // 3, 3)], dim=1)

    def _sync_to_host(self, state: SimState, epot, overflow, box=None):
        """One packed device->host copy; returns (Ekin, Epot, overflowed)
        and, unless the chunk overflowed, writes the state (and the box,
        when given) to the System. Ekin is (R,), or (R, nbatch) with
        `batch`."""
        packed = self._pack(state, epot, overflow, box).cpu().numpy()
        n, nb = state.pos.shape[1], self._nbatch()
        aux = packed[:, 3 * n:].reshape(packed.shape[0], -1)
        if aux[0, nb + 1] != 0:
            return None, None, True
        s = self.systems
        s.pos[:] = packed[:, :n]
        s.vel[:] = packed[:, n:2 * n]
        s.forces[:] = packed[:, 2 * n:3 * n]
        if box is not None:
            for r in range(s.nreplicas):
                np.fill_diagonal(s.box[r], aux[r, nb + 2:nb + 5])
        self._dev_state = state
        self._host_snap = (s.pos.copy(), s.vel.copy(), s.forces.copy())
        ekin = aux[:, :nb] if self.batch is not None else aux[:, 0]
        return ekin.astype(np.float64), aux[:, nb].astype(np.float64), False

    def _kernel(self):
        """The neighbour kernel of this path (cell, column or Verlet, as
        `Forces.prepare` built it), or None on the dense path."""
        return getattr(self.forces, "_cell_kernel", None)

    def _energy_forces(self, pos, boxes, kern, cls):
        """(Epot (R,), forces (R, N, 3), overflow flag, neighbour
        structures) through the forces' evaluator: on the dense path the
        ladder evaluator (`Forces.ef_batch`, one launch of each kernel for
        all replicas); on the neighbour paths each replica's structure is
        refreshed for `pos` first and evaluated on its own."""
        epots, frcs, new = [], [], []
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        if kern is None and hasattr(self.forces, "ef_batch"):
            pot, frc = self.forces.ef_batch(pos, boxes)
            return _total(pot, pos, pos.shape[:1]), frc, overflow, cls
        for r in range(pos.shape[0]):
            if kern is None:
                pot, frc = self.forces.ef_one(pos[r], boxes[r])
            else:
                cl = kern.refresh(cls[r], pos[r], boxes[r])
                overflow = overflow | cl.overflow
                new.append(cl)
                pot, frc = self.forces.ef_one(pos[r], boxes[r], cl)
            epots.append(_total(pot, pos))
            frcs.append(frc)
        return torch.stack(epots), torch.stack(frcs), overflow, new or cls

    def _run(self, state: SimState, aux, boxes, niter):
        """`niter` steps from `state` on the device: (state, Epot, thermostat
        state, overflow flag)."""
        from .constraints import (apply_position_constraints,
                                  apply_velocity_constraints)
        from .vsites import apply_vsites

        m, dt = self.masses, self.dt
        thermo, cs, vsites = self._thermostat, self.constraints, self.vsites
        kern = self._kernel()
        cls = [None] * state.pos.shape[0]
        pos, vel, frc = state
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        for _ in range(niter):
            if thermo is not None:
                vel, aux = thermo.pre(vel, aux, m, dt, generator=self.generator)
            pos_new, vel = _first_vv(pos, vel, frc, m, dt)
            if cs is not None:
                pos_c = apply_position_constraints(cs, pos_new, pos)
                vel = vel + (pos_c - pos_new) / dt
                pos_new = pos_c
            pos = pos_new
            if vsites:
                pos = torch.stack([apply_vsites(vsites, p, b)
                                   for p, b in zip(pos, boxes)])
            epot, frc, ov, cls = self._energy_forces(pos, boxes, kern, cls)
            overflow = overflow | ov
            if self._langevin:
                noise = torch.randn(vel.shape, generator=self.generator,
                                    device=self.device, dtype=self.dtype)
                vel = langevin_kick(vel, noise, self.gamma, dt, self.vcoeff)
            vel = _second_vv(vel, frc, m, dt)
            if cs is not None:
                vel = apply_velocity_constraints(cs, pos, vel)
            if thermo is not None:
                vel, aux = thermo.post(vel, aux, m, dt, generator=self.generator)
        return SimState(pos, vel, frc), epot, aux, overflow

    def _tier(self, fn, pos, boxes, cls=None):
        """One r-RESPA tier over the replicas: (energy (R,), forces)."""
        out = [fn(pos[r], boxes[r]) if cls is None else fn(pos[r], boxes[r], cls[r])
               for r in range(pos.shape[0])]
        return (torch.stack([_total(p, pos) for p, _ in out]),
                torch.stack([f for _, f in out]))

    def _run_mts(self, state: SimState, aux, boxes, niter):
        """`niter` r-RESPA outer steps (torchmd_tpu/integrator.py:709-767
        on the dense path, :1050-1151 on the neighbour paths): (state with
        the slow forces, Epot, thermostat state, overflow flag)."""
        from .constraints import (apply_position_constraints,
                                  apply_velocity_constraints)
        from .vsites import apply_vsites

        m, dt = self.masses, self.dt
        n, R = self.mts or 1, self.mts_recip or 1
        ddt = dt / n
        thermo, cs, vsites = self._thermostat, self.constraints, self.vsites
        kern = self._kernel()
        fast, slow, recip = self.forces.mts_tiers(recip_tier=R > 1)
        # the noise coefficient was built for the outer dt; a substep's
        # scales as sqrt(ddt / dt)
        vcoeff = self.vcoeff / float(np.sqrt(n)) if self._langevin else None
        pos, vel, sfrc = state
        nrep = pos.shape[0]
        cls = [None] * nrep
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)

        def rattle(vel):
            return vel if cs is None else apply_velocity_constraints(cs, pos, vel)

        # the chunk's prologue: the bonded forces, and the reciprocal ones
        # that open the first cycle, at the entry positions
        e_fast, ffrc = self._tier(fast, pos, boxes)
        if R > 1:
            e_rec, rfrc = self._tier(recip, pos, boxes, cls)
        for it in range(niter):
            cnt = it % R
            if thermo is not None:
                vel, aux = thermo.pre(vel, aux, m, dt, generator=self.generator)
            if R > 1 and cnt == 0:
                vel = vel + 0.5 * R * dt * _safe_accel(rfrc, m)
            vel = vel + 0.5 * dt * _safe_accel(sfrc, m)
            for _ in range(n):
                pos_new, vel = _first_vv(pos, vel, ffrc, m, ddt)
                if cs is not None:
                    pos_c = apply_position_constraints(cs, pos_new, pos)
                    vel = vel + (pos_c - pos_new) / ddt
                    pos_new = pos_c
                pos = pos_new
                e_fast, ffrc = self._tier(fast, pos, boxes)
                if self._langevin:
                    noise = torch.randn(vel.shape, generator=self.generator,
                                        device=self.device, dtype=self.dtype)
                    vel = langevin_kick(vel, noise, self.gamma, ddt, vcoeff)
                vel = rattle(_second_vv(vel, ffrc, m, ddt))
            if vsites:
                pos = torch.stack([apply_vsites(vsites, p, b) for p, b in zip(pos, boxes)])
            if kern is not None:
                cls = [kern.refresh(cls[r], pos[r], boxes[r]) for r in range(nrep)]
                for cl in cls:
                    overflow = overflow | cl.overflow
            e_slow, sfrc = self._tier(slow, pos, boxes, cls)
            vel = vel + 0.5 * dt * _safe_accel(sfrc, m)
            if R > 1 and cnt == R - 1:
                # the cycle's closing half-impulse, from a fresh evaluation
                e_rec, rfrc = self._tier(recip, pos, boxes, cls)
                vel = vel + 0.5 * R * dt * _safe_accel(rfrc, m)
            vel = rattle(vel)
            if thermo is not None:
                vel, aux = thermo.post(vel, aux, m, dt, generator=self.generator)
                vel = rattle(vel)
        epot = e_fast + e_slow + (e_rec if R > 1 else 0.0)
        return SimState(pos, vel, sfrc), epot, aux, overflow

    def _grow(self):
        """Grow the neighbour kernel after an overflow and record which
        capacity overflowed."""
        kern = self.forces._cell_kernel
        new = kern.grow()
        self.overflow_retries += 1
        self.overflow_log.append(
            f"{kern.capacity_name}: {_capacity(kern)} -> {_capacity(new)}")
        self.forces.set_cell_kernel(new)

    def step(self, niter=1):
        if niter < 1:
            raise ValueError(f"niter must be >= 1, got {niter}")
        R = self.mts_recip
        if R and niter % R:
            raise ValueError(
                f"mts_recip={R}: step()/chunk length must close full "
                f"reciprocal cycles (niter % {R} == 0), got {niter}")
        if self._npt is not None:
            return self._step_npt(niter)
        box_np = np.asarray(self.systems.box_diag, dtype=np.float64)
        # static no-PBC specialisation: an all-zero box leaves the wrap out
        use_pbc = bool(np.any(box_np != 0))
        boxes = [torch.as_tensor(b, dtype=self.dtype, device=self.device)
                 if use_pbc else None for b in box_np]
        state0 = self._state_from_system()
        if hasattr(self.forces, "prepare"):
            self.forces.prepare(state0.pos, box_np)
        run = self._run_mts if (self.mts or self.mts_recip) else self._run
        with torch.no_grad():
            for _ in range(MAX_OVERFLOW_RETRIES):
                state, epot, aux, overflow = run(state0, self._thermo_aux, boxes, niter)
                Ekin, Epot, overflowed = self._sync_to_host(state, epot, overflow)
                if not overflowed:
                    self._thermo_aux = aux
                    break
                # a structure outgrew its capacity: grow and redo the chunk
                self._grow()
            else:
                raise RuntimeError(
                    f"{self.forces._cell_kernel.capacity_name} kept overflowing")
        T = kinetic_to_temp(Ekin, self.natoms) * self._dof_scale
        return Ekin, Epot, T

    def thermostat_energy(self):
        """Thermostat contribution to the conserved (extended) energy per
        replica: add to Ekin + Epot to monitor NHC drift (zero for
        Langevin or no thermostat)."""
        e = np.zeros(self.systems.nreplicas)
        if self._thermostat is None:
            return e
        return e + to_numpy(self._thermostat.conserved(self._thermo_aux)).astype(np.float64)

    # ------------------------------------------------------------------
    # MTK NPT: the dense path and the cell or column kernel path
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
        bonds), and an empty plan and no CMAP or GROMOS-96 term leave
        nothing to differentiate."""
        plan = self.forces._bonded_plan
        return ((plan is not None and bool(getattr(plan, "families", True)))
                or self.forces.has_autograd_terms())

    def _npt_ef_vir(self, pos, box, cl=None, fast=True, slow=True):
        """(Epot, forces, per-axis virial -dU(s pos, s box)/ds) of one
        replica, for the fast (bonded) tier, the slow tier (pairs,
        reciprocal term, external) or both. On the kernel path
        (torchmd_tpu/integrator.py:1410-1460) the pair kernel and PME are
        analytic at the snapped geometry, with the site correction
        -sum F (r - dr/ds) before the site forces move onto the hosts; on
        the dense path (:1203-1220) the pairs ride the autograd pass. The
        rest (bonded terms, the exact Ewald sum, an external's energy_fn)
        comes from one autograd pass over (pos, s)."""
        from .potentials import compute_potentials, nonbonded_energies
        from .vsites import apply_vsites, apply_vsites_scaling, spread_vsite_forces

        forces, vsg = self.forces, self.vsites
        kern = forces._cell_kernel if (slow and self._use_cell) else None
        rec = forces._ewald if slow else None
        rec_analytic = rec is not None and not rec.differentiable
        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
        epot, frc, vir = zero, torch.zeros_like(pos), torch.zeros_like(box)
        if kern is not None or rec_analytic:
            p2 = pos
            if vsg:
                p2, tangent = apply_vsites_scaling(vsg, pos, box)
            if kern is not None:
                pot, frc, vir = kern.energy_forces_virial(p2, box, cl)
                epot = _total(pot, pos)
            if rec_analytic:
                order = None if kern is None else kern.spread_order(cl)
                e_r, f_r, v_r = rec.energy_forces_virial(p2, box, self._npt_gather(),
                                                         order_idx=order)
                epot, frc, vir = epot + e_r, frc + f_r, vir + v_r
            if vsg:
                vir = vir - (frc * (p2 - tangent)).sum(0)
                frc = spread_vsite_forces(vsg, pos, frc, box)
        ext = getattr(forces.external, "energy_fn", None) if slow else None
        cheap = fast and self._cheap_terms()
        dense_nb = (slow and not self._use_cell and forces.has_nb
                    and forces.ffparams.nb_mask is not None)
        rec_ad = rec is not None and rec.differentiable
        if not (cheap or dense_nb or rec_ad or ext is not None):
            return epot, frc, vir
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            s = torch.ones(3, dtype=pos.dtype, device=pos.device, requires_grad=True)
            ps, bs = p * s, box * s
            if vsg:
                ps = apply_vsites(vsg, ps, bs)
            terms = {}
            if cheap:
                terms = compute_potentials(forces.ffparams, ps, bs, forces.config,
                                           nonbonded=False)
            if dense_nb:
                terms.update({f"nb_{k}": v for k, v in nonbonded_energies(
                    forces.ffparams, ps, bs, forces.config).items()})
            if rec_ad:
                terms["recip"] = rec.energy(ps, bs)
            if ext is not None:
                terms["external"] = ext(ps, bs).reshape(())
            if terms:
                e_ad = sum(terms.values())
                gp, gs = torch.autograd.grad(e_ad, (p, s), allow_unused=True)
                epot = epot + e_ad.detach()
                if gp is not None:
                    frc = frc - gp
                if gs is not None:
                    vir = vir - gs
        return epot, frc, vir

    def _npt_evaluate(self, pos, boxes, fast=True, slow=True):
        """(Epot (R,), forces (R, N, 3), virial (R, 3), overflow): on the
        kernel path each replica's structure is built from `pos` by its
        box (when the slow tier is asked for)."""
        kern = self.forces._cell_kernel if (slow and self._use_cell) else None
        out = []
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        for r in range(pos.shape[0]):
            cl = None
            if kern is not None:
                cl = kern.build(pos[r], boxes[r])
                overflow = overflow | cl.overflow
            out.append(self._npt_ef_vir(pos[r], boxes[r], cl, fast=fast, slow=slow))
        epot, frc, vir = (torch.stack(t) for t in zip(*out))
        return epot, frc, vir, overflow

    def _mtk_ops(self):
        """The MTK building blocks shared by the NPT loops: (project,
        baro_half, eps_kick, kick)."""
        m, dt = self.masses, self.dt
        npt = self._npt
        W, ndof, P, chain_b, mode = (npt["W"], npt["ndof"], npt["P"],
                                     npt["chain_b"], npt["mode"])
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
            return project(v_eps + 0.5 * dt * project(G) / W)

        def kick(vel, frc, x, h):
            """The box-coupled half-kick over h = dt/2 (or ddt/2) with
            x = (v_eps + tr(v_eps)/ndof) h."""
            return vel * torch.exp(-x) + h * _safe_accel(frc, m) * torch.exp(-0.5 * x) * _phi(0.5 * x)

        return project, baro_half, eps_kick, kick

    def _npt_drift(self, pos, vel, box, v_eps, h):
        """The box-scaled drift over h and the constraints' projection:
        (pos, vel, box, delta, drift)."""
        from .constraints import apply_position_constraints

        u = v_eps * h
        drift = (h * torch.exp(0.5 * u) * _phi(0.5 * u))[:, None, :]
        # r exp(u) as r + r expm1(u): in f32 the small increment keeps its
        # digits (exp(u) would round it to 6e-8 of the box per step)
        grow = torch.expm1(u)
        pos_prev = pos
        pos = pos + pos * grow[:, None, :] + vel * drift
        box = box + box * grow
        delta = None
        if self.constraints is not None:
            ref = pos_prev + pos_prev * grow[:, None, :]
            pos_c = apply_position_constraints(self.constraints, pos, ref)
            delta = pos_c - pos
            vel = vel + delta / drift
            pos = pos_c
        if self.vsites:
            from .vsites import apply_vsites

            pos = torch.stack([apply_vsites(self.vsites, p, b) for p, b in zip(pos, box)])
        return pos, vel, box, delta, drift

    def _run_npt(self, state: SimState, boxes, v_eps, aux_p, aux_b, vir, niter):
        """`niter` MTK steps on the device (torchmd_tpu/integrator.py:
        1267-1327 dense, 1480-1590 kernel path); returns (state, box,
        v_eps, aux_p, aux_b, virial, Epot, overflow)."""
        from .constraints import apply_velocity_constraints, constraint_virial

        m, dt = self.masses, self.dt
        ndof = self._npt["ndof"]
        thermo, cs = self._thermostat, self.constraints
        _, baro_half, eps_kick, kick = self._mtk_ops()
        pos, vel, frc = state
        box = boxes
        epot = None
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        for _ in range(niter):
            v_eps, aux_b = baro_half(v_eps, aux_b)
            vel, aux_p = thermo.pre(vel, aux_p, m, dt, generator=self.generator)
            v_eps = eps_kick(v_eps, vel, vir, box)
            x = ((v_eps + v_eps.sum(-1, keepdim=True) / ndof) * 0.5 * dt)[:, None, :]
            vel = kick(vel, frc, x, 0.5 * dt)
            pos, vel, box, delta, drift = self._npt_drift(pos, vel, box, v_eps, dt)
            epot, frc, vir, ov = self._npt_evaluate(pos, box)
            overflow = overflow | ov
            if cs is not None:
                vir = vir + constraint_virial(cs, m, delta, drift, pos)
            vel = kick(vel, frc, x, 0.5 * dt)
            v_eps = eps_kick(v_eps, vel, vir, box)
            vel, aux_p = thermo.post(vel, aux_p, m, dt, generator=self.generator)
            v_eps, aux_b = baro_half(v_eps, aux_b)
            if cs is not None:
                vel = apply_velocity_constraints(cs, pos, vel)
        return SimState(pos, vel, frc), box, v_eps, aux_p, aux_b, vir, epot, overflow

    def _run_npt_mts(self, state: SimState, boxes, v_eps, aux_p, aux_b, vir, niter):
        """`niter` r-RESPA MTK outer steps (torchmd_tpu/integrator.py:
        1800-1965): the slow impulse dt/2 around n box-coupled substeps of
        the fast tier, whose dU/ds comes from the last substep; the slow
        tier and its virial at the new phase point. The carried forces are
        the slow tier's. Returns what `_run_npt` returns."""
        from .constraints import apply_velocity_constraints, constraint_virial

        m, dt = self.masses, self.dt
        n = self.mts
        ddt = dt / n
        ndof = self._npt["ndof"]
        thermo, cs = self._thermostat, self.constraints
        _, baro_half, eps_kick, kick = self._mtk_ops()
        pos, vel, sfrc = state
        box = boxes
        epot = None
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)

        def rattle(vel):
            return vel if cs is None else apply_velocity_constraints(cs, pos, vel)

        # the fast forces at the chunk's entry (the carried ones are slow)
        ffrc = self._npt_evaluate(pos, box, slow=False)[1]
        for _ in range(niter):
            v_eps, aux_b = baro_half(v_eps, aux_b)
            vel, aux_p = thermo.pre(vel, aux_p, m, dt, generator=self.generator)
            v_eps = eps_kick(v_eps, vel, vir, box)
            vel = vel + 0.5 * dt * _safe_accel(sfrc, m)
            x = ((v_eps + v_eps.sum(-1, keepdim=True) / ndof) * 0.5 * ddt)[:, None, :]
            for _ in range(n):
                vel = kick(vel, ffrc, x, 0.5 * ddt)
                pos, vel, box, delta, drift = self._npt_drift(pos, vel, box, v_eps, ddt)
                e_fast, ffrc, vir_f, _ = self._npt_evaluate(pos, box, slow=False)
                vel = rattle(kick(vel, ffrc, x, 0.5 * ddt))
            e_slow, sfrc, vir_s, ov = self._npt_evaluate(pos, box, fast=False)
            overflow = overflow | ov
            vir = vir_f + vir_s
            if cs is not None:
                vir = vir + constraint_virial(cs, m, delta, drift, pos)
            vel = rattle(vel + 0.5 * dt * _safe_accel(sfrc, m))
            v_eps = eps_kick(v_eps, vel, vir, box)
            vel, aux_p = thermo.post(vel, aux_p, m, dt, generator=self.generator)
            v_eps, aux_b = baro_half(v_eps, aux_b)
            vel = rattle(vel)
            epot = e_fast + e_slow
        return SimState(pos, vel, sfrc), box, v_eps, aux_p, aux_b, vir, epot, overflow

    def _step_npt(self, niter):
        """The chunk loop (torchmd_tpu/integrator.py:2870-2935): the box
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
        run = self._run_npt_mts if self.mts else self._run_npt
        with torch.no_grad():
            for _ in range(MAX_OVERFLOW_RETRIES):
                vir = vir0
                if vir is None or not cached:
                    vir = self._npt_evaluate(state0.pos, boxes)[2]
                state, box, v_eps, aux_p, aux_b, vir, epot, overflow = run(
                    state0, boxes, v_eps0, self._thermo_aux, aux_b0, vir, niter)
                Ekin, Epot, overflowed = self._sync_to_host(state, epot, overflow, box)
                if not overflowed:
                    break
                self._grow()
            else:
                raise RuntimeError(
                    f"{forces._cell_kernel.capacity_name} kept overflowing")
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


def _total(pot, like, shape=()):
    """The sum of a per-term energy dict (zeros of `shape` for an empty
    one)."""
    vals = list(pot.values())
    return sum(vals) if vals else torch.zeros(shape, dtype=like.dtype, device=like.device)


def _capacity(kern):
    """A neighbour kernel's capacity, for the overflow log: the Verlet
    list's or the cell list's width, the columns' (C, CE)."""
    cfg = getattr(kern, "vcfg", None) or kern.clcfg
    return cfg.capacity if hasattr(cfg, "capacity") else (cfg.C, cfg.CE)


def _phi(x):
    """sinh(x) / x, with its series below |x| = 1e-3."""
    small = x.abs() < 1e-3
    safe = torch.where(small, torch.ones_like(x), x)
    x2 = x * x
    return torch.where(small, 1.0 + x2 / 6.0 + x2 * x2 / 120.0, torch.sinh(safe) / safe)
