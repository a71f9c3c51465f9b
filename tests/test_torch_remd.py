"""The port's replica features against the JAX package at f64 on the CPU:
per-replica T ladders, atom batching, the dense path's ladder evaluator
(`Forces.ef_batch`) and replica exchange (`torchmd_tpu_torch.remd`).

  - the small water cluster of tests/test_remd.py (293 atoms, no box):
    the (R, 1, 1) x (N, 1) Langevin noise coefficient equals the JAX
    package's; `ReplicaExchange.run` over three slots, 20 steps with an
    attempt every 5, both packages' Gaussian draws patched to the same
    values and the exchange draws from the same `RandomState`: positions
    within 1e-8 A, equal walkers and acceptance counts. A planted fault,
    an Integrator that does not see the swap on the host (it keeps its
    device state), must fail that comparison;
  - the Metropolis rule's deterministic cases and the constructor checks;
  - `ef_batch` on the kernel path (the kernels' plain versions on the CPU)
    and on the torch-op path equals the stacked `ef_one` (1e-12), with a
    box and an external; on TIP4P waters with virtual sites; and for
    replicas that mix a box and none;
  - atom batching: kinetic energy and T per replica and group, (R,
    nbatch), against the JAX package's `kinetic_energy(batch=)`;
  - on the card (gpu marker): the replica axis of the pair and bonded
    kernels on the water cluster, one launch each for three replicas,
    against one launch per replica (the pair kernel bit for bit, the
    bonded kernel's energies equal and its forces at the Pallas bars)
    and against the plain f64 versions.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import ALL_TERMS, load_system
from conftest import DATA_DIR

from torchmd_tpu import integrator as jint
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.parameters import Parameters
from torchmd_tpu.remd import ReplicaExchange as JaxReplicaExchange
from torchmd_tpu.systems import System as JaxSystem
from torchmd_tpu_torch import Forces, Integrator, System
from torchmd_tpu_torch import integrator as tint
from torchmd_tpu_torch.external import TorchExternal
from torchmd_tpu_torch.remd import ReplicaExchange

torch.set_num_threads(1)

TEMPS = (300.0, 310.0, 320.0)


def _cluster():
    mol, ff, _ = load_system(os.path.join(DATA_DIR, "waterbox"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    return mol, par


def _velocities(par, temps, seed=7):
    m = np.asarray(par.masses, np.float64).reshape(1, -1, 1)
    rs = np.random.RandomState(seed)
    T = np.asarray(temps).reshape(-1, 1, 1)
    return rs.randn(len(temps), m.shape[1], 3) * np.sqrt(0.001987191 * T / m)


def _fixed_normal(shape):
    """The Gaussian draw both packages get for a shape: fixed values from
    a seed (a traced draw is fixed for the whole scan in the JAX package)."""
    shape = tuple(int(s) for s in shape)
    return np.random.RandomState(sum(shape) + len(shape)).randn(*shape)


def patch_draws(monkeypatch):
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=float: jnp.asarray(
        _fixed_normal(shape), dtype))
    real = torch.randn

    def randn(*size, generator=None, device=None, dtype=None, **kw):
        shape = size[0] if len(size) == 1 and not isinstance(size[0], int) else size
        return torch.as_tensor(_fixed_normal(shape), dtype=dtype or torch.get_default_dtype(),
                               device=device)

    monkeypatch.setattr(torch, "randn", randn)
    return real


def _remd(pkg, steps=20, period=5, temps=TEMPS):
    mol, par = _cluster()
    n = mol.numAtoms
    if pkg == "jax":
        forces = JaxForces(par, terms=ALL_TERMS, precision="double")
        system = JaxSystem(n, len(temps), "double", "cpu")
    else:
        forces = Forces(par, terms=ALL_TERMS, precision="double", device="cpu")
        system = System(n, len(temps), "double")
    system.set_positions(mol.coords)
    system.set_box(mol.box)
    system.set_velocities(_velocities(par, temps))
    forces.compute(system.pos, system.box, system.forces)
    cls = JaxReplicaExchange if pkg == "jax" else ReplicaExchange
    remd = cls(system, forces, 1.0, np.asarray(temps), gamma=50.0, seed=4)
    out = remd.run(steps, exchange_period=period)
    return system, remd, out


def test_vector_T_noise_coefficient_matches_jax():
    mol, par = _cluster()
    temps = np.asarray(TEMPS)
    js = JaxSystem(mol.numAtoms, 3, "double", "cpu")
    ts = System(mol.numAtoms, 3, "double")
    ji = jint.Integrator(js, JaxForces(par, terms=ALL_TERMS, precision="double"), 1.0,
                         gamma=5.0, T=temps)
    ti = Integrator(ts, Forces(par, terms=ALL_TERMS, precision="double", device="cpu"), 1.0,
                    gamma=5.0, T=temps)
    assert ti.vcoeff.shape == (3, mol.numAtoms, 1)
    np.testing.assert_allclose(ti.vcoeff.numpy(), np.asarray(ji.vcoeff), rtol=1e-14)


def _remd_deviation(monkeypatch):
    """(max position deviation, the same exchange history, the port's and
    the JAX package's last (Ekin, Epot, T)); the JAX run swaps at least
    once."""
    patch_draws(monkeypatch)
    js, jr, jout = _remd("jax")
    ts, tr, tout = _remd("port")
    assert jr.n_accepted.sum() > 0, "the check needs an accepted swap"
    same = (np.array_equal(tr.walker_id, jr.walker_id)
            and np.array_equal(tr.n_attempted, jr.n_attempted)
            and np.array_equal(tr.n_accepted, jr.n_accepted))
    return float(np.abs(ts.pos - np.asarray(js.pos)).max()), same, tout, jout


def test_remd_matches_jax(monkeypatch):
    dev, same, tout, jout = _remd_deviation(monkeypatch)
    assert same and dev <= 1e-8, (same, dev)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-9)


def test_unseen_swap_fails(monkeypatch):
    """An Integrator that keeps its device state across the host's swap
    puts each configuration at the wrong slot: the comparison must fail."""
    cached = Integrator._state_from_system

    def stale(self):
        if self._dev_state is not None:
            return self._dev_state
        return cached(self)

    monkeypatch.setattr(Integrator, "_state_from_system", stale)
    dev, same, _, _ = _remd_deviation(monkeypatch)
    assert not same or dev > 1e-4, dev


def test_exchange_rule_and_checks():
    mol, par = _cluster()
    forces = Forces(par, terms=ALL_TERMS, precision="double", device="cpu")
    system = System(mol.numAtoms, 2, "double")
    system.set_positions(mol.coords)
    system.set_velocities(_velocities(par, (300.0, 400.0)))
    remd = ReplicaExchange(system, forces, 1.0, [300.0, 400.0], seed=0)
    pos0, vel0 = system.pos.copy(), system.vel.copy()
    # the hotter slot holds the lower energy: always swaps down
    assert remd.attempt_exchanges([0.0, -1000.0])[0]
    np.testing.assert_array_equal(system.pos[0], pos0[1])
    np.testing.assert_allclose(system.vel[0], vel0[1] * np.sqrt(300.0 / 400.0))
    assert list(remd.walker_id) == [1, 0]
    remd.attempt_exchanges([0.0, 0.0])      # odd phase: no pair with R = 2
    assert not remd.attempt_exchanges([-1e5, 1e5])[0]   # never uphill by that much
    assert remd.acceptance_rates[0] == pytest.approx(0.5)
    with pytest.raises(ValueError, match="ladder size"):
        ReplicaExchange(system, forces, 1.0, [300.0, 350.0, 400.0])
    with pytest.raises(ValueError, match="increasing"):
        ReplicaExchange(system, forces, 1.0, [400.0, 300.0])


@pytest.mark.parametrize("kernel", ["auto", "dense"])
def test_ef_batch_equals_stacked_ef_one(kernel):
    """The ladder evaluator of the CPU (the kernels' plain versions on the
    kernel path) against ef_one per replica, with a box and an external."""
    mol, ff, nb = load_system(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    ref = torch.as_tensor(mol.coords[:, :, 0])
    ext = TorchExternal(lambda p, b: 0.01 * ((p - ref) ** 2).sum())
    forces = Forces(par, terms=ALL_TERMS, precision="double", kernel=kernel, device="cpu",
                    cutoff=9.0, switch_dist=7.5, rfa=True, external=ext)
    rs = np.random.RandomState(1)
    pos = torch.as_tensor(mol.coords[:, :, 0][None] + 0.02 * rs.randn(3, mol.numAtoms, 3))
    boxes = [torch.as_tensor(mol.box[:, 0], dtype=torch.float64)] * 3
    pot, frc = forces.ef_batch(pos, boxes)
    for r in range(3):
        p1, f1 = forces.ef_one(pos[r], boxes[r])
        assert set(p1) == set(pot)
        for k in p1:
            assert abs(float(pot[k][r]) - float(p1[k])) <= 1e-12 * max(1.0, abs(float(p1[k])))
        assert float((frc[r] - f1).abs().max()) <= 1e-12 * max(1.0, float(f1.abs().max()))


@pytest.mark.parametrize("case", ["vsites", "mixed_boxes"])
def test_ef_batch_vsites_and_mixed_boxes(case):
    """The ladder evaluator on the kernel path against ef_one per replica
    (1e-12): TIP4P/2005 waters, whose M sites are snapped and spread per
    replica inside the one-launch ladder, and replicas that mix a box
    and none (evaluated one by one)."""
    from test_torch_water import TERMS as WTERMS, jittered, water_box

    _, tpar, coords, edge = water_box(n=3)
    forces = Forces(tpar, terms=WTERMS, precision="double", device="cpu", cutoff=4.0)
    pos = torch.as_tensor(np.stack([jittered(coords, s, 0.02) for s in range(3)]))
    box = torch.full((3,), edge, dtype=torch.float64)
    boxes = [box, None, box] if case == "mixed_boxes" else [box] * 3
    pot, frc = forces.ef_batch(pos, boxes)
    for r in range(3):
        p1, f1 = forces.ef_one(pos[r], boxes[r])
        assert set(p1) == set(pot)
        for k in p1:
            assert abs(float(pot[k][r]) - float(p1[k])) <= 1e-12 * max(1.0, abs(float(p1[k])))
        assert float((frc[r] - f1).abs().max()) <= 1e-12 * max(1.0, float(f1.abs().max()))


def test_atom_batching_matches_jax():
    rs = np.random.RandomState(3)
    masses = rs.uniform(1.0, 16.0, (12, 1))
    vel = rs.randn(2, 12, 3)
    batch = np.array([0, 0, 1, 1, 1, 2, 2, 0, 1, 2, 2, 2])
    want = np.asarray(jint.kinetic_energy(jnp.asarray(masses), jnp.asarray(vel), batch))
    got = tint.kinetic_energy(torch.as_tensor(masses), torch.as_tensor(vel),
                              torch.as_tensor(batch), 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)

    class _Zero:
        device, dtype = torch.device("cpu"), torch.float64

        def ef_one(self, pos, box, cl=None):
            return {}, torch.zeros_like(pos)

    zero = _Zero()
    zero.par = type("Par", (), {"masses": masses})

    system = System(12, 2, "double")
    system.set_velocities(vel)
    integ = Integrator(system, zero, 1.0, batch=batch)
    ekin, epot, T = integ.step(niter=1)
    assert ekin.shape == T.shape == (2, 3)
    np.testing.assert_allclose(ekin, want, rtol=1e-12)
    np.testing.assert_allclose(T, jint.kinetic_to_temp(want, np.bincount(batch)), rtol=1e-12)
    with pytest.raises(NotImplementedError, match="batching"):
        Integrator(system, zero, 1.0, batch=batch, mts=2)


@pytest.mark.gpu
def test_replica_axis_kernels_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn

    mol, ff, _ = load_system(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    kw = dict(cutoff=9.0, switch_dist=7.5, rfa=True)
    f32 = Forces(par, terms=ALL_TERMS, precision="single", device="cuda", **kw)
    f64 = Forces(par, terms=ALL_TERMS, precision="double", device="cuda", plain=True, **kw)
    rs = np.random.RandomState(2)
    p64 = torch.as_tensor(mol.coords[:, :, 0][None] + 0.02 * rs.randn(3, mol.numAtoms, 3),
                          device="cuda")
    p32 = p64.float().contiguous()
    box32 = torch.as_tensor(np.repeat(mol.box[:, 0][None], 3, 0), dtype=torch.float32,
                            device="cuda")
    d32 = kn.prepare_nb_data(f32.ffparams)
    n0 = (kn.LAUNCHES, kb.LAUNCHES)
    pot, frc = kn.nonbonded_energy_forces(d32, f32.config, p32, box32)
    bpot, bfrc = kb.bonded_energy_forces(f32._bonded_plan, p32, box32)
    assert (kn.LAUNCHES - n0[0], kb.LAUNCHES - n0[1]) == (1, 1)
    d64 = kn.prepare_nb_data(f64.ffparams)
    plan64 = kb.build_bonded_kernel_plan(f64.ffparams, f64.config)
    for r in range(3):
        p1, f1 = kn.nonbonded_energy_forces(d32, f32.config, p32[r].contiguous(), box32[r])
        assert torch.equal(frc[r], f1) and all(torch.equal(pot[k][r], p1[k]) for k in p1)
        b1, bf1 = kb.bonded_energy_forces(f32._bonded_plan, p32[r].contiguous(), box32[r])
        assert all(torch.equal(bpot[k][r], b1[k]) for k in b1)
        assert float((bfrc[r] - bf1).abs().max()) <= 5e-5 * max(1.0, float(bf1.abs().max()))
        for (pk, fk), (pp, fp) in (
                (({k: v[r] for k, v in pot.items()}, frc[r]),
                 kn.pair_terms_reference(d64, f64.config, p64[r], box32[r].double())),
                (({k: v[r] for k, v in bpot.items()}, bfrc[r]),
                 kb.bonded_reference(plan64, p64[r], box32[r].double()))):
            for k in pp:
                assert abs(float(pk[k]) - float(pp[k])) <= 2e-5 * max(1.0, abs(float(pp[k])))
            assert float((fk.double() - fp).abs().max()) <= 5e-5 * max(1.0, float(fp.abs().max()))
