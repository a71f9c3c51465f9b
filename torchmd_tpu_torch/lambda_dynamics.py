"""Lambda-dynamics and constant-pH MD on the alchemical coupling, the
port of `torchmd_tpu.lambda_dynamics`.

The coupling parameter of each titratable or alchemical site becomes a
dynamical degree of freedom (Kong & Brooks, J. Chem. Phys. 105, 2414
(1996)): lambda_s = sin^2(theta_s) with an unconstrained theta carrying a
fictitious mass, so lambda stays in [0, 1] without walls. The forces on
the atoms and on theta come from one autograd pass over the extra energy
(the soft-core couplings, `alchemy.AlchemicalCoupling.energy_lambda`,
and the biases on lambda).

Constant-pH MD (Lee, Salsbury & Brooks 2004) is a bias on lambda:

    U_pH(lam) = [ln(10) kT (pH - pKa_model) + dG_model] lam
                + 4 h lam (1 - lam)

The atoms and the thetas integrate together (velocity Verlet and
Langevin on both) on the device, with the base force field through
`Forces.ef_one` (the dense pair and bonded kernels on the card); the
per-step lambda trace comes back once per `step` call.
"""

from __future__ import annotations

import numpy as np
import torch

from .alchemy import AlchemicalCoupling, _cut_crossing, _require_masked_nonbonded
from .integrator import TIMEFACTOR, kinetic_to_temp
from .units import BOLTZMANN, PICOSEC2TIMEU

__all__ = ["make_lambda_sites", "ph_bias", "LambdaDynamics", "protonation_fraction"]


def make_lambda_sites(forces, site_atoms_list, alpha=0.5, softcore_power=1):
    """Prepare a built `Forces` for multi-site lambda-dynamics: for every
    site its (site x environment) crossing pairs leave the base mask, and
    an `AlchemicalCoupling` whose environment excludes all other sites'
    atoms (site-site interactions stay in the base force field, the
    disjoint-sites approximation). Returns the couplings; the external
    slot of `forces` is left as it is."""
    _require_masked_nonbonded(forces)
    natoms = int(forces.ffparams.charges.shape[0])
    in_any = np.zeros(natoms, dtype=bool)
    for atoms in site_atoms_list:
        atoms = np.asarray(atoms, dtype=np.int64)
        if np.any(in_any[atoms]):
            raise ValueError("lambda sites must be disjoint")
        in_any[atoms] = True
    env_all = np.flatnonzero(~in_any)
    couplings = [AlchemicalCoupling(forces.ffparams, forces.config, atoms, alpha=alpha,
                                    softcore_power=softcore_power, env_atoms=env_all)
                 for atoms in site_atoms_list]
    for atoms in site_atoms_list:
        _cut_crossing(forces, atoms, env_all)
    forces._build_evaluators()
    return couplings


def ph_bias(pKa_model, pH, T, dG_model=0.0, barrier=0.0):
    """Constant-pH bias U(lam) of one titratable site (kcal/mol)."""
    slope = np.log(10.0) * BOLTZMANN * float(T) * (float(pH) - float(pKa_model))
    slope = slope + float(dG_model)

    def bias(lam):
        return slope * lam + 4.0 * float(barrier) * lam * (1.0 - lam)

    return bias


class LambdaDynamics:
    """Joint (atoms, thetas) dynamics of one replica.

    system/forces: the usual pair (forces prepared by make_lambda_sites);
    couplings: the AlchemicalCouplings; biases: optional callables U_s(lam)
    (e.g. `ph_bias(...)`); lam0: the first lambdas; theta_mass: the
    fictitious masses (amu A^2). Noise comes from a generator seeded with
    `seed` on the forces' device: per step the atoms' draw, then the
    thetas'.
    """

    def __init__(self, system, forces, couplings, biases=None, timestep=1.0, T=300.0,
                 gamma=1.0, theta_mass=12.0, lam0=None, seed=1):
        if system.nreplicas != 1:
            raise ValueError("LambdaDynamics drives one replica")
        self.system = system
        self.forces = forces
        self.couplings = list(couplings)
        ns = len(self.couplings)
        self.nsites = ns
        biases = list(biases) if biases is not None else [None] * ns
        if len(biases) != ns:
            raise ValueError("one bias per site (or None)")
        self.biases = biases
        self.device, self.dtype = forces.device, forces.dtype
        self.dt = timestep / TIMEFACTOR
        self.T = float(T)
        self.gamma = float(gamma) / PICOSEC2TIMEU

        def dev(a):
            return torch.as_tensor(np.array(a, np.float64), dtype=self.dtype,
                                   device=self.device)

        self.masses = dev(np.asarray(forces.par.masses, np.float64).reshape(-1, 1))
        self.theta_mass = dev(np.broadcast_to(np.asarray(theta_mass, np.float64), (ns,)))
        lam0 = np.broadcast_to(np.asarray(0.5 if lam0 is None else lam0, np.float64), (ns,))
        if np.any((lam0 < 0) | (lam0 > 1)):
            raise ValueError("lam0 must be in [0, 1]")
        self.theta = dev(np.arcsin(np.sqrt(lam0)))
        self.vtheta = torch.zeros(ns, dtype=self.dtype, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _ef(self, pos, box, box_ef, theta):
        """(Epot, forces on the atoms, forces on theta): the base force
        field (`ef_one`, its external included) and one autograd pass over
        the couplings and biases at lam = sin^2 theta."""
        pot, frc = self.forces.ef_one(pos, box_ef)
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            th = theta.detach().requires_grad_(True)
            lam = torch.sin(th) ** 2
            e = torch.zeros((), dtype=pos.dtype, device=pos.device)
            for s, c in enumerate(self.couplings):
                e = e + c.energy_lambda(p, box, lam[s])
                if self.biases[s] is not None:
                    e = e + self.biases[s](lam[s])
            g_pos, g_th = torch.autograd.grad(e, (p, th), allow_unused=True)
        g_pos = torch.zeros_like(pos) if g_pos is None else g_pos
        g_th = torch.zeros_like(theta) if g_th is None else g_th
        return sum(pot.values()) + e.detach(), frc - g_pos, -g_th

    def step(self, niter=1):
        """Advance atoms and lambdas `niter` steps. Returns (Ekin, Epot, T,
        lam_trace) with lam_trace of shape (niter, nsites)."""
        s = self.system
        box_np = np.asarray(s.box_diag, np.float64)[0]
        box = torch.as_tensor(box_np, dtype=self.dtype, device=self.device)
        box_ef = box if np.any(box_np != 0) else None
        pos, vel = (torch.as_tensor(a[0], dtype=self.dtype, device=self.device)
                    for a in (s.pos, s.vel))
        m, m_th, dt, gamma = self.masses, self.theta_mass, self.dt, self.gamma
        kT = BOLTZMANN * self.T
        use_thermo = self.T > 0 and gamma > 0
        vc_atoms = torch.sqrt(2.0 * gamma * kT * dt / m)
        vc_theta = torch.sqrt(2.0 * gamma * kT * dt / m_th)
        theta, vtheta = self.theta, self.vtheta
        lams = []
        with torch.no_grad():
            # the entry forces always with the couplings (a System seeded
            # by forces.compute() lacks the crossing pairs)
            epot, frc, fth = self._ef(pos, box, box_ef, theta)
            for _ in range(int(niter)):
                acc = frc / m
                pos = pos + vel * dt + 0.5 * acc * dt * dt
                vel = vel + 0.5 * dt * acc
                acc_t = fth / m_th
                theta = theta + vtheta * dt + 0.5 * acc_t * dt * dt
                vtheta = vtheta + 0.5 * dt * acc_t
                epot, frc, fth = self._ef(pos, box, box_ef, theta)
                if use_thermo:
                    noise = torch.randn(vel.shape, generator=self.generator,
                                        device=self.device, dtype=self.dtype)
                    vel = vel - gamma * vel * dt + noise * vc_atoms
                    nth = torch.randn(vtheta.shape, generator=self.generator,
                                      device=self.device, dtype=self.dtype)
                    vtheta = vtheta - gamma * vtheta * dt + nth * vc_theta
                vel = vel + 0.5 * dt * (frc / m)
                vtheta = vtheta + 0.5 * dt * (fth / m_th)
                lams.append(torch.sin(theta) ** 2)
        self.theta, self.vtheta = theta, vtheta
        s.pos[0] = pos.cpu().numpy()
        s.vel[0] = vel.cpu().numpy()
        s.forces[0] = frc.cpu().numpy()
        ekin = float(0.5 * (m[:, 0] * (vel * vel).sum(1)).sum())
        T = kinetic_to_temp(np.asarray([ekin]), pos.shape[0])[0]
        return (np.asarray([ekin]), np.asarray([float(epot)]), np.asarray([T]),
                torch.stack(lams).cpu().numpy())

    @property
    def lambdas(self):
        """Current per-site lambdas (numpy, in [0, 1])."""
        return (torch.sin(self.theta) ** 2).cpu().numpy()

    def theta_kinetic_energy(self):
        return float(0.5 * (self.theta_mass * self.vtheta ** 2).sum())


def protonation_fraction(lam_trace, threshold=0.8):
    """Fraction of frames each site spends coupled (lam > threshold): the
    raw titration-curve observable. lam_trace: (nframes, nsites)."""
    lam_trace = np.asarray(lam_trace)
    return (lam_trace > threshold).mean(axis=0)
