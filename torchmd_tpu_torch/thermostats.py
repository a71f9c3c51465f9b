"""Nose-Hoover chain and CSVR thermostats on torch tensors.

Counterparts of `torchmd_tpu.thermostats`:

  - `NoseHooverChain` (Martyna, Klein, Tuckerman 1992; reversible update
    of Martyna et al. 1996): a global chain coupled to all degrees of
    freedom, propagated for dt/2 before the first velocity half-kick and
    dt/2 after the second. The state of each replica is (xi, v_xi), each
    of length nchain, as tensors of shape (nreplicas, nchain);
  - `CSVR` (Bussi, Donadio, Parrinello 2007): one global stochastic
    rescale of each replica's velocities after the second half-kick. Its
    draws come from the caller's `torch.Generator` (the Integrator's):
    a standard normal and a chi-square with nf - 1 degrees of freedom,
    drawn as 2 Gamma((nf - 1) / 2) by `torch._standard_gamma` (which,
    unlike `torch.distributions.Gamma`, takes a generator).

`pre`/`post` take velocities of shape (nreplicas, natoms, 3), all on one
device, with no host synchronisation. On a mesh (`parallel`) they take a
rank's piece: `reduce` sums a rank's kinetic energy over the ranks that
hold the system's rows (the JAX package's `axis_name=`,
torchmd_tpu/thermostats.py:61-78), so every rank propagates the same
chain; `replicas=(r0, nrep_total)` makes CSVR draw for all nrep_total
replicas and keep this rank's from r0 on, so that its draws do not
depend on how the replicas are spread over ranks. Units follow the rest of the
package: internal time units (dt = timestep_fs / TIMEFACTOR), energies
kcal/mol, BOLTZMANN in kcal/mol/K.
"""

from __future__ import annotations

import numpy as np
import torch

from .units import BOLTZMANN, TIMEFACTOR

__all__ = ["NoseHooverChain", "CSVR", "make_thermostat"]


class NoseHooverChain:
    stochastic = False

    def __init__(self, T, tau_fs, ndof, nchain=3):
        if nchain < 1:
            raise ValueError("nchain must be >= 1")
        self.T = float(T)
        self.kT = BOLTZMANN * float(T)
        self.tau = float(tau_fs) / TIMEFACTOR  # internal time units
        self.ndof = int(ndof)
        self.nchain = int(nchain)
        q1 = self.ndof * self.kT * self.tau**2
        qk = self.kT * self.tau**2
        self.Q = np.array([q1] + [qk] * (self.nchain - 1))

    def init(self, nreplicas, dtype, device):
        return {"xi": torch.zeros((nreplicas, self.nchain), dtype=dtype, device=device),
                "vxi": torch.zeros((nreplicas, self.nchain), dtype=dtype, device=device)}

    def _chain_half(self, vel, xi, vxi, masses, dth, reduce=None):
        """Propagate the chain for dth and rescale velocities; the nchain
        loop is unrolled in Python."""
        M, kT, Q = self.nchain, self.kT, [float(q) for q in self.Q]
        nf_kT = self.ndof * kT
        dt4, dt8 = 0.5 * dth, 0.25 * dth

        K2 = (masses[:, 0] * (vel * vel).sum(-1)).sum(-1)  # 2*KE, (R,)
        if reduce is not None:
            K2 = reduce(K2)
        v = [vxi[:, k] for k in range(M)]

        def G(k, K2_now):
            if k == 0:
                return (K2_now - nf_kT) / Q[0]
            return (Q[k - 1] * v[k - 1] ** 2 - kT) / Q[k]

        # backward sweep: update the tail first
        v[M - 1] = v[M - 1] + G(M - 1, K2) * dt4
        for k in range(M - 2, -1, -1):
            e = torch.exp(-dt8 * v[k + 1])
            v[k] = (v[k] * e + G(k, K2) * dt4) * e
        # scale particle velocities + advance chain positions
        s = torch.exp(-dth * v[0])
        K2 = K2 * s * s
        xi = xi + dth * torch.stack(v, dim=1)
        # forward sweep with the updated kinetic energy
        for k in range(M - 1):
            e = torch.exp(-dt8 * v[k + 1])
            v[k] = (v[k] * e + G(k, K2) * dt4) * e
        v[M - 1] = v[M - 1] + G(M - 1, K2) * dt4
        return vel * s[:, None, None], xi, torch.stack(v, dim=1)

    def pre(self, vel, aux, masses, dt, generator=None, reduce=None, replicas=None):
        vel, xi, vxi = self._chain_half(vel, aux["xi"], aux["vxi"], masses,
                                        0.5 * dt, reduce)
        return vel, {"xi": xi, "vxi": vxi}

    post = pre  # same half-propagator after the second VV half-kick

    def conserved(self, aux):
        """Thermostat contribution to the conserved (extended) energy per
        replica: sum_k Q_k v_k^2 / 2 + Nf kT xi_1 + kT sum_{k>1} xi_k."""
        xi, vxi = aux["xi"], aux["vxi"]
        Q = torch.as_tensor(self.Q, dtype=vxi.dtype, device=vxi.device)
        e = 0.5 * (Q * vxi * vxi).sum(-1) + self.ndof * self.kT * xi[..., 0]
        if self.nchain > 1:
            e = e + self.kT * xi[..., 1:].sum(-1)
        return e


class CSVR:
    """Canonical sampling through velocity rescaling (Bussi 2007).

    One global stochastic rescale per replica and step after the force
    update; no state of its own. Samples the canonical kinetic-energy
    distribution for any tau; tau -> inf recovers NVE."""

    stochastic = True

    def __init__(self, T, tau_fs, ndof):
        self.T = float(T)
        self.kT = BOLTZMANN * float(T)
        self.tau = float(tau_fs) / TIMEFACTOR
        self.ndof = int(ndof)

    def init(self, nreplicas, dtype, device):
        return {}

    def pre(self, vel, aux, masses, dt, generator=None, reduce=None, replicas=None):
        return vel, aux

    def rescale(self, vel, masses, dt, r1, r2, reduce=None):
        """`vel` times alpha for a standard normal r1 and a chi-square
        (nf - 1) draw r2 ((R,) each), with K each replica's kinetic energy,
        c = exp(-dt / tau) and kbar = nf kT / 2:
        alpha^2 = c + (1 - c) kbar / (nf K) (r1^2 + r2)
                  + 2 r1 sqrt(c (1 - c) kbar / (nf K))."""
        nf, kbar = self.ndof, 0.5 * self.ndof * self.kT
        c = float(np.exp(-dt / self.tau))
        K = 0.5 * (masses[:, 0] * (vel * vel).sum(-1)).sum(-1)
        if reduce is not None:
            K = reduce(K)
        K = torch.clamp(K, min=1e-12)
        a2 = (c + (1.0 - c) * (kbar / (nf * K)) * (r1 * r1 + r2)
              + 2.0 * r1 * torch.sqrt(c * (1.0 - c) * kbar / (nf * K)))
        return vel * torch.sqrt(torch.clamp(a2, min=0.0))[:, None, None]

    def post(self, vel, aux, masses, dt, generator=None, reduce=None, replicas=None):
        nrep = vel.shape[0]
        r0, ndraw = (0, nrep) if replicas is None else replicas
        r1 = torch.randn(ndraw, generator=generator, dtype=vel.dtype,
                         device=vel.device)
        shape = torch.full((ndraw,), 0.5 * (self.ndof - 1), dtype=vel.dtype,
                           device=vel.device)
        r2 = 2.0 * torch._standard_gamma(shape, generator=generator)
        return self.rescale(vel, masses, dt, r1[r0:r0 + nrep], r2[r0:r0 + nrep],
                            reduce), aux

    def conserved(self, aux):
        return 0.0


def make_thermostat(name, T, tau_fs, ndof, nchain=3):
    """'nhc' | 'nosehoover' -> NoseHooverChain; 'csvr' | 'bussi' -> CSVR;
    'langevin' | 'none' -> None (the integrator's inline Langevin kick)."""
    name = (name or "langevin").lower()
    if name in ("langevin", "none"):
        return None
    if name in ("nhc", "nosehoover", "nose-hoover"):
        return NoseHooverChain(T, tau_fs, ndof, nchain=nchain)
    if name in ("csvr", "bussi"):
        return CSVR(T, tau_fs, ndof)
    raise ValueError(f"Unknown thermostat: {name}")
