"""Temperature replica-exchange MD (parallel tempering), the port of
`torchmd_tpu.remd`.

Every replica of the ladder integrates in one `Integrator` with a
per-replica T vector (Langevin noise (R, 1, 1) x (natoms, 1)). On the
dense path each force evaluation launches the pair kernel and the bonded
kernel once for the whole ladder (`Forces.ef_batch`), as the vmapped
Pallas calls of the JAX package do on the TPU; the O(R) exchange
bookkeeping runs on the host between chunks.

Convention: temperatures stay pinned to replica slots; on an accepted
swap the configurations (positions, forces) exchange and velocities are
rescaled by sqrt(T_new / T_old), so slot r always samples the canonical
ensemble at `temperatures[r]`. `walker_id` tracks which initial walker
lives in each slot. The swap edits the System's host arrays; the
Integrator sees them differ from its last sync and uploads them again
before the next chunk.

Acceptance (Metropolis on the joint ensemble):
    P = min(1, exp[(beta_i - beta_j)(E_i - E_j)])
for neighbour slots (i, j); even and odd pairs alternate per attempt;
the draws come from `np.random.RandomState(seed)`, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from .integrator import Integrator
from .units import BOLTZMANN

__all__ = ["ReplicaExchange"]


class ReplicaExchange:
    """Drive an `Integrator` over a temperature ladder with periodic
    neighbour-swap attempts.

    systems.nreplicas must equal len(temperatures); velocities should be
    drawn per slot (e.g. maxwell_boltzmann at each ladder T).
    """

    def __init__(self, systems, forces, timestep, temperatures, gamma=1.0,
                 seed=1, **integrator_kwargs):
        self.temps = np.asarray(temperatures, dtype=np.float64)
        if systems.nreplicas != len(self.temps):
            raise ValueError(
                f"nreplicas={systems.nreplicas} != ladder size {len(self.temps)}")
        if np.any(np.diff(self.temps) <= 0):
            raise ValueError("temperatures must be strictly increasing")
        self.systems = systems
        self.integrator = Integrator(systems, forces, timestep, gamma=gamma, T=self.temps,
                                     seed=seed, **integrator_kwargs)
        self.beta = 1.0 / (BOLTZMANN * self.temps)
        self.rng = np.random.RandomState(seed)
        self.phase = 0
        self.walker_id = np.arange(len(self.temps))
        self.n_attempted = np.zeros(len(self.temps) - 1, dtype=np.int64)
        self.n_accepted = np.zeros(len(self.temps) - 1, dtype=np.int64)

    def attempt_exchanges(self, epot):
        """One sweep of neighbour-swap attempts (even pairs, then odd pairs
        on the next call). `epot` is the per-slot potential energy of the
        current configurations. Returns the boolean accept mask per pair."""
        epot = np.array(epot, dtype=np.float64).reshape(-1)  # owned copy
        R = len(self.temps)
        start = self.phase % 2
        self.phase += 1
        s = self.systems
        accepted = np.zeros(R - 1, dtype=bool)
        for i in range(start, R - 1, 2):
            j = i + 1
            self.n_attempted[i] += 1
            log_p = (self.beta[i] - self.beta[j]) * (epot[i] - epot[j])
            if np.log(max(self.rng.rand(), 1e-300)) < min(log_p, 0.0):
                accepted[i] = True
                self.n_accepted[i] += 1
                # swap configurations; rescale velocities to the slot T
                s.pos[[i, j]] = s.pos[[j, i]]
                s.forces[[i, j]] = s.forces[[j, i]]
                vi, vj = s.vel[i].copy(), s.vel[j].copy()
                s.vel[i] = vj * np.sqrt(self.temps[i] / self.temps[j])
                s.vel[j] = vi * np.sqrt(self.temps[j] / self.temps[i])
                epot[i], epot[j] = epot[j], epot[i]
                self.walker_id[[i, j]] = self.walker_id[[j, i]]
        return accepted

    def run(self, nsteps, exchange_period=100):
        """Integrate `nsteps` in all with an exchange sweep every
        `exchange_period` steps. Returns (Ekin, Epot, T) of the last chunk,
        as Integrator.step does."""
        out = None
        done = 0
        while done < nsteps:
            n = min(exchange_period, nsteps - done)
            out = self.integrator.step(niter=n)
            done += n
            if done < nsteps:
                self.attempt_exchanges(out[1])
        return out

    @property
    def acceptance_rates(self):
        """Per-neighbour-pair acceptance fractions (nan where untried)."""
        with np.errstate(invalid="ignore"):
            return self.n_accepted / np.where(self.n_attempted > 0, self.n_attempted, np.nan)
