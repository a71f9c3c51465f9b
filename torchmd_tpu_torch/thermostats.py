"""Nose-Hoover chain thermostat on torch tensors.

Counterpart of `torchmd_tpu.thermostats.NoseHooverChain` (Martyna, Klein,
Tuckerman 1992; reversible update of Martyna et al. 1996): a global chain
coupled to all degrees of freedom, propagated for dt/2 before the first
velocity half-kick and dt/2 after the second. The state of each replica is
(xi, v_xi), each of length nchain; `pre`/`post` take velocities of shape
(nreplicas, natoms, 3) and the state as tensors of shape
(nreplicas, nchain), all on one device, with no host synchronisation.

Units follow the rest of the package: internal time units (dt =
timestep_fs / TIMEFACTOR), energies kcal/mol, BOLTZMANN in kcal/mol/K.
CSVR (Bussi) comes with a later slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .units import BOLTZMANN, TIMEFACTOR

__all__ = ["NoseHooverChain", "make_thermostat"]


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

    def _chain_half(self, vel, xi, vxi, masses, dth):
        """Propagate the chain for dth and rescale velocities; the nchain
        loop is unrolled in Python."""
        M, kT, Q = self.nchain, self.kT, [float(q) for q in self.Q]
        nf_kT = self.ndof * kT
        dt4, dt8 = 0.5 * dth, 0.25 * dth

        K2 = (masses[:, 0] * (vel * vel).sum(-1)).sum(-1)  # 2*KE, (R,)
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

    def pre(self, vel, aux, masses, dt):
        vel, xi, vxi = self._chain_half(vel, aux["xi"], aux["vxi"], masses,
                                        0.5 * dt)
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


def make_thermostat(name, T, tau_fs, ndof, nchain=3):
    """'nhc' | 'nosehoover' -> NoseHooverChain; 'langevin' | 'none' ->
    None (the integrator's inline Langevin kick). CSVR raises
    NotImplementedError."""
    name = (name or "langevin").lower()
    if name in ("langevin", "none"):
        return None
    if name in ("nhc", "nosehoover", "nose-hoover"):
        return NoseHooverChain(T, tau_fs, ndof, nchain=nchain)
    if name in ("csvr", "bussi"):
        raise NotImplementedError(
            f"thermostat={name!r} (CSVR) is not ported yet; a later slice of "
            "the port brings it")
    raise ValueError(f"Unknown thermostat: {name}")
