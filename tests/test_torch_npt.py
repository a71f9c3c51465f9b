"""The port's NPT slice (MTK barostat on the kernel path) against the JAX
package at f64.

Small size: the 216-water TIP4P/2005 box of test_torch_water (864 sites,
19.5 A, cutoff 4 A, PME order 6 on 40^3), SETTLE, TIP4P sites, a
Nose-Hoover chain at 300 K and MTKBarostat(1 bar, 300 K, tau_p 2000 fs,
iso), 2 fs, from shared numpy velocities.

  - the JAX `Integrator` on its cell kernel path at f64 against the port
    at f64 on the column path and on the cell path, two chunks of 10
    steps: per-term energies at step 0 within 1e-7 relative, positions
    within 1e-6 A, the box within 1e-10 relative, the chunks' Ekin, Epot
    and T and the thermostat and barostat energies within 1e-9 relative,
    the SETTLE bonds held and the sites snapped. (The JAX package's own
    column-kernel NPT test, test_mtk.py::test_mtk_column_matches_cell,
    fails on this tree; the port's column path is held to the JAX f64
    cell path, where both compute the same pairs.)
  - a JAX run handed to the port mid-run (positions, velocities, forces,
    box, both chains, v_eps and the carried virial through `interop`)
    continues as the JAX run does for 10 steps;
  - the anisotropic and membrane couplings follow the JAX package for 5
    steps on the cell path (tau_p 200 fs, so the box moves);
  - the MTK constants and the validation errors match the JAX package's.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from test_torch_water import CUTOFF, TERMS, shared_velocities, water_box

from torchmd_tpu import barostat as jbaro
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.integrator import Integrator as JaxIntegrator
from torchmd_tpu.systems import System as JaxSystem
from torchmd_tpu_torch import Forces, Integrator, MTKBarostat, System, interop
from torchmd_tpu_torch import barostat as tbaro
from torchmd_tpu_torch import constraints as tcon
from torchmd_tpu_torch import vsites as tvs
from torchmd_tpu_torch.columns import ColumnKernel
from torchmd_tpu_torch.neighbors import CellKernel

# one intra-op thread per test process: the suite runs under xdist, and
# a pool of one thread per core in every worker oversubscribes the CPU
torch.set_num_threads(1)

BARO = (1.0, 300.0)
TAU_P = 2000.0


def _setup(Fc, Sc, Ic, Bc, par, coords, L, vel, **kw):
    forces = Fc(par, terms=TERMS, precision="double", cutoff=CUTOFF, kernel="cell",
                elec="pme", **kw)
    s = Sc(coords.shape[0], 1, "double")
    s.set_positions(coords)
    s.set_box(np.full((3, 1), L))
    s.set_velocities(vel)
    e0 = forces.compute(s.pos, s.box, s.forces, returnDetails=True)[0]
    integ = Ic(s, forces, 2.0, T=300.0, thermostat="nhc", constraints="settle",
               barostat=Bc(*BARO, tau_fs=TAU_P))
    return forces, s, integ, e0


def _finish(s, integ, chunks, e0):
    return dict(e0=e0, pos=s.pos[0].copy(), box=s.box_diag[0].copy(), chunks=chunks,
                thermo=integ.thermostat_energy(), npt=integ.npt_energy())


@functools.lru_cache(maxsize=None)
def _jax_run():
    jpar, _, coords, L = water_box()
    _, s, integ, e0 = _setup(JaxForces, JaxSystem, JaxIntegrator, jbaro.MTKBarostat,
                             jpar, coords, L, shared_velocities(jpar))
    return _finish(s, integ, [integ.step(niter=10) for _ in range(2)], e0)


@pytest.mark.parametrize("column", [True, False], ids=["column", "cell"])
def test_npt_slice_matches_jax(column):
    want = _jax_run()
    _, tpar, coords, L = water_box()
    forces, s, integ, e0 = _setup(Forces, System, Integrator, MTKBarostat, tpar,
                                  coords, L, shared_velocities(tpar), device="cpu",
                                  column=column)
    got = _finish(s, integ, [integ.step(niter=10) for _ in range(2)], e0)
    assert isinstance(forces._cell_kernel, ColumnKernel if column else CellKernel)
    assert set(got["e0"]) == set(want["e0"])
    for k, w in want["e0"].items():
        assert abs(got["e0"][k] - w) <= 1e-7 * max(1.0, abs(w)), (k, got["e0"][k], w)
    np.testing.assert_allclose(got["box"], want["box"], rtol=1e-10)
    assert abs(got["box"][0] - L) > 1e-4           # the box moved
    assert np.abs(got["pos"] - want["pos"]).max() <= 1e-6
    for w, g in zip(want["chunks"], got["chunks"]):
        for a, b in zip(w, g):
            np.testing.assert_allclose(b, a, rtol=1e-9)
    np.testing.assert_allclose(got["thermo"], want["thermo"], rtol=1e-9)
    np.testing.assert_allclose(got["npt"], want["npt"], rtol=1e-9)
    pos = torch.as_tensor(got["pos"])
    ss = tcon.build_settle(tpar, np.asarray(tpar.masses))
    assert float(tcon.max_settle_error(ss, pos)) < 1e-9
    groups = tvs.vsite_groups_to(tpar.vsites, "cpu", torch.float64)
    snapped = tvs.apply_vsites(groups, pos, torch.as_tensor(got["box"]))
    assert float((snapped[groups[0].sites] - pos[groups[0].sites]).abs().max()) < 1e-12


def test_npt_continues_a_jax_run():
    """A JAX NPT run handed to the port after 10 steps: both continue
    alike for 10 more (the port's particle chain, v_eps, the barostat chain
    and the carried virial from `interop`)."""
    jpar, tpar, coords, L = water_box()
    vel = shared_velocities(jpar)
    _, js, jinteg, _ = _setup(JaxForces, JaxSystem, JaxIntegrator, jbaro.MTKBarostat,
                              jpar, coords, L, vel)
    jinteg.step(niter=10)
    _, ts, tinteg, _ = _setup(Forces, System, Integrator, MTKBarostat, tpar,
                              coords, L, vel, device="cpu")
    ts.set_positions(js.pos[0])
    ts.set_velocities(js.vel)
    ts.set_forces(js.forces)
    ts.set_box(js.box_diag[0])
    tinteg._thermo_aux = interop.nhc_state_from_numpy(
        {k: np.asarray(v) for k, v in jinteg._thermo_aux.items()})
    v_eps, aux_b, vir = jinteg._npt_extra
    tinteg.npt_state = interop.mtk_state_from_numpy(
        np.asarray(v_eps), np.asarray(aux_b["xi"]), np.asarray(aux_b["vxi"]),
        np.asarray(vir))
    want, got = jinteg.step(niter=10), tinteg.step(niter=10)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-9)
    np.testing.assert_allclose(ts.box_diag, js.box_diag, rtol=1e-10)
    assert np.abs(ts.pos - js.pos).max() <= 1e-6
    np.testing.assert_allclose(tinteg.npt_energy(), jinteg.npt_energy(), rtol=1e-9)
    np.testing.assert_allclose(tinteg.thermostat_energy(), jinteg.thermostat_energy(),
                               rtol=1e-9)


@pytest.mark.parametrize("mode", ["aniso", "membrane"])
def test_npt_modes_match_jax(mode):
    """The anisotropic (z frozen) and membrane (surface tension) couplings
    against the JAX package on the cell path, 5 steps at f64."""
    kw = (dict(mode="aniso", scale_axes=(True, True, False)) if mode == "aniso"
          else dict(mode="membrane", surface_tension=50.0))
    jpar, tpar, coords, L = water_box()
    vel = shared_velocities(jpar)
    out = []
    for Fc, Sc, Ic, Bc, par, dev in (
            (JaxForces, JaxSystem, JaxIntegrator, jbaro.MTKBarostat, jpar, {}),
            (Forces, System, Integrator, MTKBarostat, tpar, dict(device="cpu"))):
        forces = Fc(par, terms=TERMS, precision="double", cutoff=CUTOFF, kernel="cell",
                    elec="pme", **dev)
        s = Sc(coords.shape[0], 1, "double")
        s.set_positions(coords)
        s.set_box(np.full((3, 1), L))
        s.set_velocities(vel)
        forces.compute(s.pos, s.box, s.forces)
        integ = Ic(s, forces, 2.0, T=300.0, thermostat="nhc", constraints="settle",
                   barostat=Bc(*BARO, tau_fs=200.0, **kw))
        chunk = integ.step(niter=5)
        out.append((chunk, s.pos[0].copy(), s.box_diag[0].copy(), integ.npt_energy()))
    (jc, jp, jb, je), (tc, tp, tb, te) = out
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b, a, rtol=1e-9)
    np.testing.assert_allclose(tb, jb, rtol=1e-10)
    assert np.abs(tp - jp).max() <= 1e-6
    np.testing.assert_allclose(te, je, rtol=1e-9)
    if mode == "aniso":
        assert tb[2] == L and tb[0] != L        # z frozen, x free
    else:
        assert tb[0] == tb[1] != tb[2]          # x and y tied


def test_mtk_constants_and_validation_match_jax():
    assert tbaro.BAR_A3_TO_KCALMOL == jbaro.BAR_A3_TO_KCALMOL
    for kw in (dict(), dict(mode="aniso", scale_axes=(True, False, True)),
               dict(mode="membrane", surface_tension=12.0)):
        t, j = tbaro.MTKBarostat(1.0, 300.0, **kw), jbaro.MTKBarostat(1.0, 300.0, **kw)
        assert vars(t) == vars(j)
    for Bc in (tbaro.MTKBarostat, jbaro.MTKBarostat):
        with pytest.raises(ValueError, match="Unknown MTK mode"):
            Bc(1.0, 300.0, mode="tri")
        with pytest.raises(ValueError, match="scalable"):
            Bc(1.0, 300.0, mode="aniso", scale_axes=(False, False, False))

    _, tpar, coords, L = water_box()

    def integrator(box=True, **kw):
        forces = Forces(tpar, terms=TERMS, precision="double", cutoff=CUTOFF,
                        kernel=kw.pop("kernel", "cell"), elec="pme", device="cpu")
        s = System(coords.shape[0], 1, "double")
        s.set_positions(coords)
        if box:
            s.set_box(np.full((3, 1), L))
        return Integrator(s, forces, 2.0, constraints="settle", **kw)

    # the messages of tests/test_mtk.py:103-113
    with pytest.raises(ValueError, match="thermostat"):
        integrator(T=300.0, gamma=1.0, barostat=MTKBarostat(*BARO))
    with pytest.raises(ValueError, match="periodic box"):
        integrator(box=False, T=300.0, thermostat="nhc", barostat=MTKBarostat(*BARO))
    # no thermostat and no Langevin: a chain at the barostat's temperature
    integ = integrator(barostat=MTKBarostat(*BARO))
    assert integ._thermostat is not None and integ._thermostat.T == 300.0

    class MonteCarlo:
        is_dynamic = False

    with pytest.raises(NotImplementedError, match="Monte Carlo"):
        integrator(T=300.0, thermostat="nhc", barostat=MonteCarlo())
    with pytest.raises(NotImplementedError, match="dense"):
        integrator(T=300.0, thermostat="nhc", barostat=MTKBarostat(*BARO), kernel="dense")


@pytest.mark.gpu
def test_npt_on_cuda_matches_cpu_plain_path():
    """10 NPT steps on the card (column kernel, f32) against the plain path
    (f64, CPU): the box and the positions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import column as kcol

    _, tpar, coords, L = water_box()
    vel = shared_velocities(tpar)
    out = {}
    for dev, prec in (("cpu", "double"), ("cuda", "single")):
        forces = Forces(tpar, terms=TERMS, precision=prec, cutoff=CUTOFF, kernel="cell",
                        elec="pme", device=dev)
        s = System(coords.shape[0], 1, prec)
        s.set_positions(coords)
        s.set_box(np.full((3, 1), L))
        s.set_velocities(vel)
        forces.compute(s.pos, s.box, s.forces)
        n0 = (kcol.LAUNCHES, kc.LAUNCHES)
        Integrator(s, forces, 2.0, T=300.0, thermostat="nhc", constraints="settle",
                   barostat=MTKBarostat(*BARO, tau_fs=TAU_P)).step(niter=10)
        if dev == "cuda":
            assert isinstance(forces._cell_kernel, ColumnKernel)
            assert kcol.LAUNCHES - n0[0] >= 10 and kc.LAUNCHES == n0[1]
        out[dev] = (s.pos.astype(np.float64), s.box_diag.astype(np.float64))
    dpos = np.abs(out["cuda"][0] - out["cpu"][0]).max()
    dbox = np.abs(out["cuda"][1] / out["cpu"][1] - 1.0).max()
    print(f"after 10 NPT steps: max |d pos| {dpos:.3e} A, box rel {dbox:.3e}")
    assert dpos <= 2e-3 and dbox <= 1e-5
