"""The port's integrator against the JAX package.

  - NVE (T = None, gamma = None) trajectory parity with
    `torchmd_tpu.integrator.Integrator` at f64 over 20 steps on alanine
    dipeptide from the same numpy velocities: positions within 1e-8 A;
  - the Langevin kick fed numpy noise against the JAX formula
    (torchmd_tpu/integrator.py:584), and the noise coefficient;
  - kinetic_to_temp, and the mean and variance of maxwell_boltzmann.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import ALL_TERMS, load_system
from conftest import DATA_DIR

from torchmd_tpu import integrator as jint
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.parameters import Parameters
from torchmd_tpu.systems import System as JaxSystem
from torchmd_tpu.units import BOLTZMANN
from torchmd_tpu_torch import integrator as tint
from torchmd_tpu_torch.forces import Forces
from torchmd_tpu_torch.systems import System

# one intra-op thread per test process: the suite runs under xdist, and
# a pool of one thread per core in every worker oversubscribes the CPU
torch.set_num_threads(1)

NB = dict(cutoff=9.0, switch_dist=7.5, rfa=True)


def _alanine():
    mol, ff, _ = load_system(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    rs = np.random.RandomState(0)
    vel = rs.randn(1, mol.numAtoms, 3) * np.sqrt(
        BOLTZMANN * 300.0 / par.masses.reshape(1, -1, 1))
    return mol, par, vel


def _run(system_cls, forces, integrator_cls, mol, vel, **kw):
    s = system_cls(mol.numAtoms, 1, "double")
    s.set_positions(mol.coords)
    s.set_box(mol.box)
    s.set_velocities(vel)
    integ = integrator_cls(s, forces, 1.0, **kw)
    out = [integ.step(niter=10) for _ in range(2)]
    return s, out


@pytest.mark.parametrize("kernel", ["auto", "dense"])
def test_nve_trajectory_matches_jax(kernel):
    mol, par, vel = _alanine()
    js, jout = _run(JaxSystem, JaxForces(par, terms=ALL_TERMS,
                                         precision="double", **NB),
                    jint.Integrator, mol, vel)
    ts, tout = _run(System, Forces(par, terms=ALL_TERMS, precision="double",
                                   kernel=kernel, device="cpu", **NB),
                    tint.Integrator, mol, vel)
    assert np.abs(ts.pos - js.pos).max() <= 1e-8
    assert np.abs(ts.vel - js.vel).max() <= 1e-8
    for (ek_j, ep_j, t_j), (ek_t, ep_t, t_t) in zip(jout, tout):
        np.testing.assert_allclose(ek_t, ek_j, rtol=1e-9)
        np.testing.assert_allclose(ep_t, ep_j, rtol=1e-9)
        np.testing.assert_allclose(t_t, t_j, rtol=1e-9)


def test_langevin_kick_and_noise_coefficient_match_jax():
    mol, par, vel = _alanine()
    kw = dict(gamma=0.1, T=300.0)
    jf = JaxForces(par, terms=ALL_TERMS, precision="double", **NB)
    js = JaxSystem(mol.numAtoms, 1, "double")
    ji = jint.Integrator(js, jf, 2.0, **kw)
    ts = System(mol.numAtoms, 1, "double")
    ti = tint.Integrator(ts, Forces(par, terms=ALL_TERMS, precision="double",
                                    device="cpu", **NB), 2.0, **kw)
    np.testing.assert_allclose(ti.vcoeff.numpy(), np.asarray(ji.vcoeff),
                               rtol=1e-14)
    assert ti.gamma == ji.gamma and ti.dt == ji.dt
    noise = np.random.RandomState(1).randn(*vel.shape)
    want = (jnp.asarray(vel) - ji.gamma * jnp.asarray(vel) * ji.dt
            + jnp.asarray(noise) * ji.vcoeff)
    got = tint.langevin_kick(torch.as_tensor(vel), torch.as_tensor(noise),
                             ti.gamma, ti.dt, ti.vcoeff)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=1e-14)


def test_kinetic_energy_and_temperature():
    rs = np.random.RandomState(2)
    masses = rs.uniform(1, 16, (50, 1))
    vel = rs.randn(2, 50, 3)
    got = tint.kinetic_energy(torch.as_tensor(masses), torch.as_tensor(vel))
    want = np.asarray(jint.kinetic_energy(masses, vel))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)
    ekin = rs.uniform(10, 100, 4)
    np.testing.assert_allclose(tint.kinetic_to_temp(ekin, 50),
                               jint.kinetic_to_temp(ekin, 50), rtol=1e-15)


def test_maxwell_boltzmann_statistics():
    n, T = 20000, 300.0
    masses = np.full((n, 1), 12.0)
    masses[:5] = 0.0  # massless rows get no velocity
    gen = torch.Generator().manual_seed(42)
    vel = tint.maxwell_boltzmann(masses, T, replicas=1, generator=gen)
    assert vel.shape == (1, n, 3) and vel.dtype == torch.float64
    v = vel[0, 5:].numpy()
    assert np.all(vel[0, :5].numpy() == 0.0)
    assert abs(v.mean()) < 5 * np.sqrt(BOLTZMANN * T / 12.0 / v.size)
    np.testing.assert_allclose(v.var(), BOLTZMANN * T / 12.0, rtol=0.03)
    # same seed, same draw; a new generator from `seed` is deterministic
    again = tint.maxwell_boltzmann(masses, T, generator=torch.Generator().manual_seed(42))
    assert torch.equal(vel, again)
    assert torch.equal(tint.maxwell_boltzmann(masses, T, seed=3, device="cpu"),
                       tint.maxwell_boltzmann(masses, T, seed=3, device="cpu"))


class _ZeroForces:
    """A force provider of the port's shape with no forces: a free gas."""

    def __init__(self, masses):
        self.device = torch.device("cpu")
        self.dtype = torch.float64
        self.par = type("P", (), {"masses": masses, "bond_params": None})()

    def ef_one(self, pos, box):
        return {"zero": pos.new_zeros(())}, torch.zeros_like(pos)


def test_langevin_thermostats_free_gas_to_target_temperature():
    natoms, T_target = 500, 350.0
    system = System(natoms, 1, "double")
    system.set_positions(np.random.RandomState(0).randn(natoms, 3) * 10)
    system.set_masses(np.full(natoms, 12.0))
    integ = tint.Integrator(system, _ZeroForces(np.full((natoms, 1), 12.0)),
                            2.0, gamma=2.0, T=T_target, seed=3)
    temps = [integ.step(niter=20)[2][0] for _ in range(60)]
    assert abs(np.mean(temps[20:]) - T_target) / T_target < 0.1


def test_step_reuses_device_state_and_sees_host_edits():
    natoms = 4
    system = System(natoms, 1, "double")
    system.set_positions(np.arange(12.0).reshape(4, 3))
    system.set_masses(np.full(natoms, 2.0))
    integ = tint.Integrator(system, _ZeroForces(np.full((natoms, 1), 2.0)), 1.0)
    system.vel[:] = 1.0
    ekin, epot, temp = integ.step(niter=3)
    assert ekin.shape == epot.shape == temp.shape == (1,)
    np.testing.assert_allclose(ekin, [0.5 * 2.0 * 3 * natoms])
    dt = integ.dt
    np.testing.assert_allclose(system.pos[0], np.arange(12.0).reshape(4, 3) + 3 * dt)
    state = integ._dev_state
    integ.step(niter=1)
    assert integ._dev_state is not state  # moved on from the cached state
    system.set_positions(np.zeros((4, 3)))  # a host edit is picked up
    integ.step(niter=1)
    np.testing.assert_allclose(system.pos[0], np.full((4, 3), dt))


def test_unported_options_raise():
    """The device mesh still raises, naming its ROADMAP item; atom
    batching and per-replica T are ported, and NHC and CSVR refuse a T
    vector as the JAX package does; CSVR, SHAKE/RATTLE and r-RESPA are
    ported (a free gas has no bonds to constrain; r-RESPA needs the split
    evaluators of Forces, tests/test_torch_mts.py)."""
    natoms = 2
    system = System(natoms, 1, "double")
    f = _ZeroForces(np.full((natoms, 1), 1.0))
    with pytest.raises(NotImplementedError, match="item 21"):
        tint.Integrator(system, f, 1.0, mesh=object())
    assert tint.Integrator(system, f, 1.0, batch=np.zeros(natoms, int)).natoms.tolist() == [2]
    assert tint.Integrator(system, f, 1.0, T=np.array([300.0]), gamma=1.0).vcoeff.shape == (
        1, natoms, 1)
    for thermostat in ("nhc", "csvr"):
        with pytest.raises(ValueError, match="scalar T"):
            tint.Integrator(system, f, 1.0, T=np.array([300.0]), thermostat=thermostat)
    with pytest.raises(ValueError, match="nreplicas"):
        tint.Integrator(system, f, 1.0, T=np.array([300.0, 310.0]), gamma=1.0)
    from torchmd_tpu_torch.thermostats import CSVR

    assert isinstance(tint.Integrator(system, f, 1.0, thermostat="csvr",
                                      T=300.0)._thermostat, CSVR)
    assert tint.Integrator(system, f, 1.0, constraints="hbonds").constraints is None
    with pytest.raises(ValueError, match="no coupling"):
        tint.Integrator(system, f, 1.0, T=300.0)
