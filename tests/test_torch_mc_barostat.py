"""The port's CSVR thermostat and Monte Carlo barostats against the JAX
package, at f64 on the CPU.

  - CSVR's rescale fed fixed draws against the JAX formula (its normal
    and gamma draws patched to the same numbers) at 1e-12, and a
    statistical check: rescales of a free gas sample the canonical
    kinetic energy (mean nf kT / 2, variance nf (kT)^2 / 2) within 5 %;
  - CSVR in the MTK step (the JAX package's test_mtk.py:88 pairing) with
    fixed draws in both packages: 5 steps on the 216-water box;
  - one MC `attempt` with an injected proposal and uniform on the 216-water
    TIP4P/2005 box (PME, cell path, groups = waters) for iso, aniso and
    membrane: the proposal from the same raw draws, the scaled positions
    and box, both energies, the work and the accept decision, for an
    accepting and a rejecting uniform;
  - the ideal-gas volume law <V> = (N + 1) kT / P of
    tests/test_barostat.py and tests/test_barostat_variants.py under each
    barostat, the axis mask, the membrane's zmodes and the centroid
    scaling that keeps molecules rigid;
  - `Integrator(barostat=MC)` raises ValueError with the JAX message.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_water import CUTOFF, TERMS, shared_velocities, water_box

from torchmd_tpu import barostat as jbaro
from torchmd_tpu import thermostats as jthermo
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.integrator import Integrator as JaxIntegrator
from torchmd_tpu.systems import System as JaxSystem
from torchmd_tpu_torch import barostat as tbaro
from torchmd_tpu_torch import thermostats as tthermo
from torchmd_tpu_torch.forcefields.forcefield import NullForcefield
from torchmd_tpu_torch.forces import Forces
from torchmd_tpu_torch.integrator import Integrator
from torchmd_tpu_torch.io import Molecule
from torchmd_tpu_torch.parameters import Parameters
from torchmd_tpu_torch.systems import System
from torchmd_tpu_torch.units import BOLTZMANN

torch.set_num_threads(1)

R1, GAMMA = 0.37, 41.5   # the fixed draws: a normal, a Gamma((nf - 1) / 2)


def _patch_jax_draws(monkeypatch):
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=float: jnp.full(shape, R1, dtype))
    monkeypatch.setattr(jax.random, "gamma",
                        lambda key, a, shape=None, dtype=float: jnp.full(
                            () if shape is None else shape, GAMMA, dtype))


def _patch_port_draws(monkeypatch):
    def post(self, vel, aux, masses, dt, generator=None):
        fixed = torch.full((vel.shape[0],), R1, dtype=vel.dtype)
        return self.rescale(vel, masses, dt, fixed, 2.0 * fixed.new_full(fixed.shape, GAMMA)), aux

    monkeypatch.setattr(tthermo.CSVR, "post", post)


def test_csvr_rescale_matches_jax_formula(monkeypatch):
    rs = np.random.RandomState(3)
    masses = rs.uniform(1.0, 16.0, (30, 1))
    vel = rs.randn(2, 30, 3) * 0.02
    ndof, dt = 87, 2.0 / 48.88821
    jc = jthermo.make_thermostat("csvr", 300.0, 50.0, ndof)
    tc = tthermo.make_thermostat("csvr", 300.0, 50.0, ndof)
    assert isinstance(tc, tthermo.CSVR) and tthermo.make_thermostat(
        "bussi", 300.0, 50.0, ndof).ndof == ndof
    _patch_jax_draws(monkeypatch)
    want = np.stack([np.asarray(jc.post(jnp.asarray(v), {}, jnp.asarray(masses), dt,
                                        key=jax.random.PRNGKey(0))[0]) for v in vel])
    r1 = torch.full((2,), R1, dtype=torch.float64)
    got = tc.rescale(torch.as_tensor(vel), torch.as_tensor(masses), dt, r1,
                     torch.full((2,), 2.0 * GAMMA, dtype=torch.float64)).numpy()
    assert np.abs(got - vel).max() > 1e-4  # the rescale moved the velocities
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    assert tc.conserved({}) == 0.0


def test_csvr_samples_the_canonical_kinetic_energy():
    """Many rescales of free-gas replicas (no forces, tau = dt): K's mean
    and variance land within 5 % of nf kT / 2 and nf (kT)^2 / 2."""
    nrep, natoms, T = 8000, 10, 300.0
    nf, kT = 3 * natoms, BOLTZMANN * T
    tc = tthermo.CSVR(T, 2.0, nf)
    dt = 2.0 / 48.88821
    gen = torch.Generator().manual_seed(5)
    masses = torch.full((natoms, 1), 12.0, dtype=torch.float64)
    # a start at twice the target temperature
    vel = torch.randn((nrep, natoms, 3), generator=gen, dtype=torch.float64) * np.sqrt(
        2.0 * kT / 12.0)
    samples = []
    for step in range(60):
        vel, _ = tc.post(vel, {}, masses, dt, generator=gen)
        if step >= 40 and step % 5 == 0:
            samples.append(0.5 * 12.0 * (vel * vel).sum((1, 2)))
    K = torch.cat(samples).numpy()
    assert abs(K.mean() / (0.5 * nf * kT) - 1.0) < 0.05, K.mean()
    assert abs(K.var() / (0.5 * nf * kT * kT) - 1.0) < 0.05, K.var()


def _npt_csvr(Fc, Sc, Ic, Bc, par, coords, L, vel, **kw):
    forces = Fc(par, terms=TERMS, precision="double", cutoff=CUTOFF, kernel="cell",
                elec="pme", **kw)
    s = Sc(coords.shape[0], 1, "double")
    s.set_positions(coords)
    s.set_box(np.full((3, 1), L))
    s.set_velocities(vel)
    integ = Ic(s, forces, 2.0, T=300.0, thermostat="csvr", tau=100.0,
               constraints="settle", barostat=Bc(1.0, 300.0, tau_fs=200.0))
    out = integ.step(niter=5)
    return s, out


def test_csvr_composes_with_mtk(monkeypatch):
    _patch_jax_draws(monkeypatch)
    _patch_port_draws(monkeypatch)
    jpar, tpar, coords, L = water_box()
    js, jout = _npt_csvr(JaxForces, JaxSystem, JaxIntegrator, jbaro.MTKBarostat, jpar,
                         coords, L, shared_velocities(jpar))
    ts, tout = _npt_csvr(Forces, System, Integrator, tbaro.MTKBarostat, tpar, coords, L,
                         shared_velocities(tpar), device="cpu", column=False)
    np.testing.assert_allclose(ts.box_diag, js.box_diag, rtol=1e-10)
    assert np.abs(ts.pos - js.pos).max() <= 1e-6
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b, a, rtol=1e-9)


# ----------------------------------------------------------------------
# Monte Carlo attempts on the 216-water box
# ----------------------------------------------------------------------

def _box_systems():
    jpar, tpar, coords, L = water_box()
    rs = np.random.RandomState(2)
    pos = coords + 0.02 * rs.randn(*coords.shape)
    out = []
    for Fc, Sc, par, kw in ((JaxForces, JaxSystem, jpar, {}),
                            (Forces, System, tpar, dict(device="cpu", column=False))):
        f = Fc(par, terms=TERMS, precision="double", cutoff=CUTOFF, kernel="cell",
               elec="pme", **kw)
        s = Sc(coords.shape[0], 1, "double")
        s.set_positions(pos)
        s.set_box(np.full((3, 1), L))
        out.append((f, s))
    group = np.repeat(np.arange(coords.shape[0] // 4), 4)
    return out[0], out[1], group


BAROS = {
    "iso": (jbaro.MonteCarloBarostat, tbaro.MonteCarloBarostat, {}),
    "aniso": (jbaro.MonteCarloAnisotropicBarostat, tbaro.MonteCarloAnisotropicBarostat,
              dict(scale_axes=(True, False, True))),
    "membrane": (jbaro.MonteCarloMembraneBarostat, tbaro.MonteCarloMembraneBarostat,
                 dict(surface_tension=30.0)),
}


@pytest.mark.parametrize("mode", sorted(BAROS))
def test_mc_attempt_matches_jax(mode, monkeypatch):
    (jf, js), (tf, ts), group = _box_systems()
    Jc, Tc, kw = BAROS[mode]
    jb = Jc(1.0, 300.0, group_id=group, seed=0, dv_max=40.0, **kw)
    tb = Tc(1.0, 300.0, group_id=group, seed=0, dv_max=40.0, **kw)
    # the proposal from the same raw draws, in the JAX package's order:
    # aniso an axis index then U(0, 1) for dV; membrane dV then its xy/z pick
    u_dv, u_pick = 0.9, 0.2
    jax_u = iter([u_dv, u_pick])
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.full(shape, next(jax_u)))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.full(shape, 1, jnp.int32))
    port_u = iter({"iso": [u_dv], "membrane": [u_dv, u_pick],
                   # enabled axes (0, 2): U = 0.75 picks index 1, the z axis
                   "aniso": [0.75, u_dv]}[mode])
    want = jb._propose(js, jax.random.PRNGKey(0))
    monkeypatch.setattr(tb, "uniform", lambda n: np.full(n, next(port_u)))
    got = tb._propose(ts.box_diag)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-14, atol=1e-14)
    if mode == "aniso":
        assert got[0][0, 2] != 1.0 and got[0][0, 0] == got[0][0, 1] == 1.0

    # one attempt with that proposal: energies, work, decision, new state
    box0 = ts.box_diag.copy()
    scale, dv, extra = got
    e_old = np.asarray(jf.compute(js.pos, js.box))
    pos_j = jb._scale_positions(np.asarray(js.pos, np.float64), scale[:, None, :])
    box_new = box0 * scale
    e_new = np.asarray(jf.compute(pos_j, np.stack([np.diag(b) for b in box_new])))
    kT = BOLTZMANN * 300.0
    w = (e_new - e_old) + jb.pressure * dv + extra - jb._n_units(js.natoms) * kT * np.log(
        np.prod(box_new, 1) / np.prod(box0, 1))
    p_acc = float(np.exp(min(-w[0] / kT, 0.0)))
    for u in (0.0, 1.0):
        ts2 = System(ts.natoms, 1, "double")
        ts2.pos[:] = ts.pos
        ts2.box[:] = ts.box
        acc = tb.attempt(ts2, tf, proposal=got, uniform=np.array([u]))
        assert bool(acc[0]) == (u < p_acc)
        np.testing.assert_allclose(tb.last["e_old"], e_old, rtol=1e-10)
        np.testing.assert_allclose(tb.last["e_new"], e_new, rtol=1e-10)
        np.testing.assert_allclose(tb.last["work"], w, rtol=1e-9, atol=1e-9)
        if acc[0]:
            np.testing.assert_allclose(ts2.pos[0], pos_j[0], rtol=0, atol=1e-12)
            np.testing.assert_allclose(ts2.box_diag, box_new, rtol=1e-15)
        else:
            np.testing.assert_array_equal(ts2.pos, ts.pos)
            np.testing.assert_array_equal(ts2.box_diag, box0)
    # the JAX attempt takes the same decision with the same uniform
    monkeypatch.setattr(jb, "_propose", lambda system, key: got)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.full(shape, 0.0))
    assert bool(jb.attempt(js, jf)[0])
    np.testing.assert_allclose(np.asarray(js.pos)[0], pos_j[0], rtol=0, atol=1e-12)


def test_integrator_refuses_mc_barostat():
    _, (tf, ts), group = _box_systems()
    with pytest.raises(ValueError, match="run-loop level"):
        Integrator(ts, tf, 2.0, T=300.0, thermostat="nhc", constraints="settle",
                   barostat=tbaro.MonteCarloBarostat(1.0, 300.0, group_id=group))


# ----------------------------------------------------------------------
# The ideal-gas volume law (tests/test_barostat*.py)
# ----------------------------------------------------------------------

def _ideal_gas(N=64, T=300.0, P_bar=400.0, seed=0):
    P = P_bar * tbaro.BAR_A3_TO_KCALMOL
    target_V = (N + 1) * BOLTZMANN * T / P
    rs = np.random.RandomState(seed)
    mol = Molecule()
    mol.numAtoms = N
    mol.atomtype = np.array(["X"] * N, dtype=object)
    mol.charge = np.zeros(N)
    mol.masses = np.full(N, 40.0)
    L0 = target_V ** (1 / 3)
    mol.coords = (rs.rand(N, 3) * L0)[:, :, None]
    par = Parameters(NullForcefield(mol), mol, [], precision="double")
    forces = Forces(par, terms=[], precision="double", device="cpu")
    system = System(N, 1, "double")
    system.set_positions(mol.coords)
    system.set_box(np.array([L0, L0, L0]))
    return system, forces, target_V


def _volumes(baro, system, forces, n, burn):
    vols = []
    for i in range(n):
        baro.attempt(system, forces)
        if i >= burn:
            vols.append(float(np.prod(system.box_diag[0])))
    return np.asarray(vols)


@pytest.mark.parametrize("mode, n, burn, tol", [
    ("iso", 3000, 500, 0.1), ("aniso", 4000, 800, 0.12), ("membrane", 4000, 800, 0.12)])
def test_ideal_gas_volume_law(mode, n, burn, tol):
    system, forces, target_V = _ideal_gas()
    seed = {"iso": 1, "aniso": 1, "membrane": 3}[mode]
    baro = BAROS[mode][1](400.0, 300.0, seed=seed)
    vols = _volumes(baro, system, forces, n, burn)
    assert abs(vols.mean() - target_V) / target_V < tol, (vols.mean(), target_V)
    assert vols.std() > 0
    box = system.box_diag[0]
    if mode == "aniso":
        assert len(np.unique(np.round(box, 6))) > 1
    if mode == "membrane":
        assert np.isclose(box[0], box[1])


def test_aniso_axis_mask_and_membrane_zmodes():
    system, forces, _ = _ideal_gas()
    L0 = system.box_diag[0].copy()
    baro = tbaro.MonteCarloAnisotropicBarostat(400.0, 300.0, seed=2,
                                               scale_axes=(True, False, False))
    _volumes(baro, system, forces, 200, 0)
    box = system.box_diag[0]
    assert box[1] == L0[1] and box[2] == L0[2] and box[0] != box[1]

    system, forces, _ = _ideal_gas()
    baro = tbaro.MonteCarloMembraneBarostat(400.0, 300.0, seed=4, zmode="fixed")
    _volumes(baro, system, forces, 300, 0)
    assert system.box_diag[0][2] == L0[2] and system.box_diag[0][0] != L0[2]

    system, forces, _ = _ideal_gas()
    V0 = float(np.prod(L0))
    baro = tbaro.MonteCarloMembraneBarostat(400.0, 300.0, surface_tension=20.0, seed=5,
                                            zmode="volume")
    areas = []
    for _ in range(400):
        baro.attempt(system, forces)
        areas.append(system.box_diag[0][0] * system.box_diag[0][1])
    assert abs(np.prod(system.box_diag[0]) - V0) / V0 < 1e-9
    assert np.std(areas) > 0
    with pytest.raises(ValueError, match="zmode"):
        tbaro.MonteCarloMembraneBarostat(1.0, 300.0, zmode="bad")


def test_centroid_scaling_keeps_molecules_rigid():
    """Groups scale by their centroid (the plain mean, as in the JAX
    package), so distances inside a group do not change."""
    pos = np.array([[1.0, 1.0, 1.0], [2.0, 1.0, 1.0], [5.0, 5.0, 5.0],
                    [6.0, 5.0, 5.0], [8.0, 2.0, 3.0], [8.0, 3.0, 3.0]])
    group_id = np.array([0, 0, 1, 1, 2, 2])
    baro = tbaro.MonteCarloBarostat(1.0, 300.0, group_id=group_id, seed=0)
    got = baro._scale_positions(torch.as_tensor(pos[None]),
                                torch.full((1, 1, 3), 1.25, dtype=torch.float64))[0].numpy()
    want = jbaro.MonteCarloBarostat(1.0, 300.0, group_id=group_id)._scale_positions(
        pos[None], np.array([[[1.25]]]))[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    for g in range(3):
        a, b = np.flatnonzero(group_id == g)
        assert abs(np.linalg.norm(got[a] - got[b]) - np.linalg.norm(pos[a] - pos[b])) < 1e-12


@pytest.mark.gpu
def test_csvr_and_mc_attempt_on_the_card():
    """CSVR draws from a CUDA generator (`torch._standard_gamma` with a
    generator on the card), reproducibly; an MC attempt on the 216-water
    box on the card (f32, the cell kernel) with an injected proposal moves
    the waters as the CPU's f64 attempt does, its energies those of the
    card's Forces."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tc = tthermo.CSVR(300.0, 50.0, 90)
    masses = torch.full((30, 1), 12.0, device="cuda")
    vel = torch.randn((2, 30, 3), device="cuda") * 0.02
    outs = [tc.post(vel, {}, masses, 0.04, generator=torch.Generator(device="cuda")
                    .manual_seed(7))[0] for _ in range(2)]
    assert torch.isfinite(outs[0]).all() and torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], vel)

    _, (tf, ts), group = _box_systems()
    _, tpar, coords, L = water_box()
    fc = Forces(tpar, terms=TERMS, precision="single", cutoff=CUTOFF, kernel="cell",
                elec="pme", device="cuda")
    sc = System(ts.natoms, 1, "single")
    sc.pos[:] = ts.pos
    sc.box[:] = ts.box
    proposal = (np.full((1, 3), 1.002), np.array([(1.002**3 - 1.0) * L**3]), np.zeros(1))
    bc = tbaro.MonteCarloBarostat(1.0, 300.0, group_id=group)
    bh = tbaro.MonteCarloBarostat(1.0, 300.0, group_id=group)
    assert bool(bc.attempt(sc, fc, proposal=proposal, uniform=np.zeros(1))[0])
    assert bool(bh.attempt(ts, tf, proposal=proposal, uniform=np.zeros(1))[0])
    np.testing.assert_allclose(sc.pos, ts.pos, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sc.box_diag, ts.box_diag, rtol=1e-6)
    e_new = fc.compute(sc.pos, sc.box)[0]
    assert abs(float(bc.last["e_new"][0]) - e_new) <= 1e-5 * max(1.0, abs(e_new))
