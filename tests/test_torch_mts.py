"""The port's r-RESPA (Integrator(mts=, mts_recip=)) against the JAX
package at f64 on the CPU.

  - the stiff dimer gas of tests/test_mts.py (copied here, built for both
    packages from the same YAML force field): mts=1 against the port's
    standard step (NVE and Langevin, 40 steps, 1e-12 A), and mts 4-5
    under NVE, a Nose-Hoover chain and CSVR (both packages' draws patched
    to the same values) against the JAX package over 40 steps (1e-8 A);
  - the 216-water TIP4P/2005 box of test_torch_water (SETTLE, sites,
    NHC): mts 2 on the dense path, on the cell path, and mts 2 with
    mts_recip=2 and PME on the cell path (`_build_scan_mts_cell`), 10
    steps in two chunks (1e-8 A);
  - scripts/bench_mts.py's flexible SPC/Fw water at 6^3 waters (cutoff
    4 A, reaction field, NVE): mts 2 and mts 4 at a 2 fs outer step on
    the port's column path (`column=True`, its plain version) against the
    JAX package's `_build_scan_mts_cell` on its cell path, 2 x 4 outer
    steps (1e-8 A, energies 1e-9 relative);
  - the rejections of tests/test_mts.py:374 with the JAX package's
    exception types;
  - on the card (gpu marker): each tier on the water box's cell path in
    f32 against the CPU's plain f64 tier.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from test_torch_mc_barostat import _patch_jax_draws, _patch_port_draws
from test_torch_water import CUTOFF, TERMS, shared_velocities, water_box

from chip_smoke import SPCFW_TOP, WATER_SPACING

from torchmd_tpu import barostat as jbaro
from torchmd_tpu.forcefields import ForceField as JaxForceField
from torchmd_tpu.forcefields.ff_yaml import YamlForcefield as JaxYamlForcefield
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.integrator import Integrator as JaxIntegrator
from torchmd_tpu.io import Molecule as JaxMolecule
from torchmd_tpu.parameters import Parameters as JaxParameters
from torchmd_tpu.systems import System as JaxSystem
from torchmd_tpu_torch import Forces, Integrator, MTKBarostat, System
from torchmd_tpu_torch.forcefields import ForceField
from torchmd_tpu_torch.forcefields.ff_yaml import YamlForcefield
from torchmd_tpu_torch.io import Molecule
from torchmd_tpu_torch.parameters import Parameters

# one intra-op thread per test process: the suite runs under xdist, and
# a pool of one thread per core in every worker oversubscribes the CPU
torch.set_num_threads(1)

DIMER_FF = {
    "atomtypes": ["X", "HX"],
    "bonds": {"(X, HX)": {"k0": 450.0, "req": 0.97}},
    "lj": {"X": {"sigma": 3.2, "epsilon": 0.15}, "HX": {"sigma": 1.0, "epsilon": 0.0}},
    "electrostatics": {"X": {"charge": 0.0}, "HX": {"charge": 0.0}},
    "masses": {"X": 16.0, "HX": 1.008},
}


def stiff_dimer_gas(M, FF, P, ndimers=4, spacing=6.0):
    """Stiff heteronuclear dimers (an H-like light atom on a k=450 bond)
    in an LJ gas (tests/test_mts.py:21-49), for either package."""
    n = 2 * ndimers
    mol = M()
    mol.numAtoms = n
    mol.atomtype = np.array(["X", "HX"] * ndimers, dtype=object)
    mol.charge = np.zeros(n)
    mol.masses = np.array([16.0, 1.008] * ndimers)
    mol.bonds = np.array([[2 * i, 2 * i + 1] for i in range(ndimers)])
    coords = []
    for i in range(ndimers):
        base = np.array([spacing * i, 0.4 * i, 0.2 * i])
        coords.append(base)
        coords.append(base + np.array([0.97, 0.0, 0.0]))
    mol.coords = np.asarray(coords)[:, :, None]
    return mol, P(FF(mol, DIMER_FF), mol, ["bonds", "lj"], precision="double")


PORT = (Forces, System, Integrator, dict(device="cpu"))
JAX = (JaxForces, JaxSystem, JaxIntegrator, {})


def _dimer_run(pkg, chunks=4, chunk=10, **kw):
    Fc, Sc, Ic, dev = pkg
    mol, par = (stiff_dimer_gas(Molecule, YamlForcefield, Parameters) if pkg is PORT
                else stiff_dimer_gas(JaxMolecule, JaxYamlForcefield, JaxParameters))
    forces = Fc(par, terms=["bonds", "lj"], precision="double", **dev)
    s = Sc(mol.numAtoms, 1, "double")
    s.set_positions(mol.coords)
    s.set_velocities(shared_velocities(par, seed=5, T=200.0))
    forces.compute(s.pos, s.box, s.forces)
    integ = Ic(s, forces, kw.pop("timestep", 1.0), **kw)
    out = [integ.step(niter=chunk) for _ in range(chunks)]
    return s.pos[0].copy(), out, integ


@pytest.mark.parametrize("coupling", ["nve", "langevin"])
def test_mts1_is_the_standard_step(coupling):
    kw = dict(gamma=5.0, T=300.0, seed=4) if coupling == "langevin" else {}
    std, std_out, _ = _dimer_run(PORT, **kw)
    one, one_out, _ = _dimer_run(PORT, mts=1, **kw)
    assert np.abs(one - std).max() <= 1e-12
    for a, b in zip(std_out, one_out):
        np.testing.assert_allclose(b, a, rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("coupling, n", [("nve", 4), ("nhc", 5), ("csvr", 4)])
def test_mts_matches_jax(coupling, n, monkeypatch):
    if coupling == "csvr":
        _patch_jax_draws(monkeypatch)
        _patch_port_draws(monkeypatch)
    kw = dict(mts=n, timestep=2.0)
    if coupling != "nve":
        kw.update(T=300.0, thermostat=coupling, tau=20.0)
    want, want_out, jinteg = _dimer_run(JAX, **kw)
    got, got_out, integ = _dimer_run(PORT, **kw)
    assert np.abs(got - want).max() <= 1e-8
    for a, b in zip(want_out, got_out):
        np.testing.assert_allclose(b, a, rtol=1e-9)
    # the carried forces are the slow tier's (the LJ pairs), as the JAX
    # package's: not the total, which holds the stiff bonds
    s, js = integ.systems, jinteg.systems
    np.testing.assert_allclose(s.forces, np.asarray(js.forces), rtol=1e-7, atol=1e-9)
    total = np.zeros_like(s.forces)
    integ.forces.compute(s.pos, s.box, total)
    assert np.abs(total - s.forces).max() > 1.0


def _water(pkg, kernel, elec=None, chunks=2, chunk=5, **kw):
    Fc, Sc, Ic, dev = pkg
    jpar, tpar, coords, L = water_box()
    par = tpar if pkg is PORT else jpar
    extra = dict(elec=elec) if elec else {}
    forces = Fc(par, terms=TERMS, precision="double", cutoff=CUTOFF, kernel=kernel,
                **extra, **dev)
    s = Sc(coords.shape[0], 1, "double")
    s.set_positions(coords)
    s.set_box(np.full((3, 1), L))
    s.set_velocities(shared_velocities(par))
    forces.compute(s.pos, s.box, s.forces)
    integ = Ic(s, forces, 2.0, T=300.0, thermostat="nhc", constraints="settle", **kw)
    out = [integ.step(niter=chunk) for _ in range(chunks)]
    return s.pos[0].copy(), out, integ, s


@functools.lru_cache(maxsize=None)
def _jax_water(kernel, elec, mts, mts_recip):
    pos, out, integ, _ = _water(JAX, kernel, elec, mts=mts, mts_recip=mts_recip,
                                chunk=4 if mts_recip else 5)
    return pos, out, integ.thermostat_energy()


@pytest.mark.parametrize("kernel, elec, mts, mts_recip", [
    ("dense", None, 2, None), ("cell", None, 2, None), ("cell", "pme", 2, 2)],
    ids=["dense-settle-sites", "cell", "cell-recip-pme"])
def test_mts_water_matches_jax(kernel, elec, mts, mts_recip):
    """SETTLE water with TIP4P sites under r-RESPA, on the dense path and
    through `_build_scan_mts_cell` (with the reciprocal tier)."""
    want, want_out, want_thermo = _jax_water(kernel, elec, mts, mts_recip)
    got, got_out, integ, s = _water(PORT, kernel, elec, mts=mts, mts_recip=mts_recip,
                                    chunk=4 if mts_recip else 5)
    assert (integ.forces._cell_kernel is None) == (kernel == "dense")
    assert np.abs(got - want).max() <= 1e-8
    for a, b in zip(want_out, got_out):
        np.testing.assert_allclose(b, a, rtol=1e-9)
    np.testing.assert_allclose(integ.thermostat_energy(), want_thermo, rtol=1e-9)


SPCFW_N, SPCFW_CUTOFF = 6, 4.0   # an 18.6 A box: a 3x3 column grid at 4 + 2 A


def _spcfw(pkg, mts, tmp_path, chunks=2, chunk=4):
    """scripts/bench_mts.py's SPC/Fw box (chip_smoke.SPCFW_TOP, the
    3.104 A lattice with seed-0 jitter) at SPCFW_N^3 waters, NVE under
    r-RESPA at a 2 fs outer step; the port on its column path."""
    Fc, Sc, Ic, dev = pkg
    M, FF, P = ((Molecule, ForceField, Parameters) if pkg is PORT
                else (JaxMolecule, JaxForceField, JaxParameters))
    top = tmp_path / "spcfw.top"
    top.write_text(SPCFW_TOP.format(nw=SPCFW_N**3))
    mol = M(str(top))
    grid = np.stack(np.meshgrid(*[np.arange(SPCFW_N)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    rs = np.random.RandomState(0)
    w = np.array([[0.000, 0.000, 0.000], [1.012, 0.000, 0.000], [-0.399, 0.930, 0.000]])
    coords = np.concatenate([w + g * WATER_SPACING + 0.8 + rs.randn(3) * 0.05
                             for g in grid])
    terms = ["bonds", "angles", "lj", "electrostatics"]
    par = P(FF.create(mol, str(top)), mol, terms, precision="double")
    extra = dict(column=True) if pkg is PORT else {}
    forces = Fc(par, terms=terms, precision="double", cutoff=SPCFW_CUTOFF, rfa=True,
                kernel="cell", **extra, **dev)
    s = Sc(coords.shape[0], 1, "double")
    s.set_positions(coords[:, :, None])
    s.set_box(np.full((3, 1), SPCFW_N * WATER_SPACING))
    s.set_velocities(shared_velocities(par, seed=3, T=300.0))
    forces.compute(s.pos, s.box, s.forces)
    integ = Ic(s, forces, 2.0, mts=mts)
    out = [integ.step(niter=chunk) for _ in range(chunks)]
    return s.pos[0].copy(), out, integ


@pytest.mark.parametrize("mts", [2, 4])
def test_mts_spcfw_column_matches_jax(mts, tmp_path):
    """r-RESPA on the column path, the path of chip_smoke's SPC/Fw phase,
    against the JAX package's neighbour-path scan on the same box."""
    from torchmd_tpu_torch.columns import ColumnKernel

    want, want_out, _ = _spcfw(JAX, mts, tmp_path)
    got, got_out, integ = _spcfw(PORT, mts, tmp_path)
    assert isinstance(integ.forces._cell_kernel, ColumnKernel) and integ._use_cell
    assert np.abs(got - want).max() <= 1e-8
    for a, b in zip(want_out, got_out):
        np.testing.assert_allclose(b, a, rtol=1e-9)


def _gas_integrator(mod, **kw):
    """The water box's Integrator with the given kwargs, for the argument
    checks (either package)."""
    Fc, Sc, Ic, dev = mod
    jpar, tpar, coords, L = water_box()
    par = tpar if mod is PORT else jpar
    forces = Fc(par, terms=TERMS, precision="double", cutoff=CUTOFF,
                kernel=kw.pop("kernel", "cell"), elec=kw.pop("elec", "pme"), **dev)
    s = Sc(coords.shape[0], 1, "double")
    s.set_positions(coords)
    s.set_box(np.full((3, 1), L))
    return Ic(s, forces, 2.0, **kw)


@pytest.mark.parametrize("case", ["dense", "mtk", "no-ewald", "batch", "batch-recip",
                                  "mts0", "niter"])
def test_mts_rejections_match_jax(case):
    """tests/test_mts.py:374's rejections, with the JAX exception types."""
    cases = {
        "dense": (NotImplementedError, dict(kernel="dense", mts=2, mts_recip=2)),
        "mtk": (NotImplementedError, dict(mts=2, mts_recip=2, T=300.0, thermostat="nhc")),
        "no-ewald": (ValueError, dict(elec="auto", mts=2, mts_recip=2)),
        "batch": (NotImplementedError, dict(mts=2, batch=np.zeros(864, int))),
        "batch-recip": (NotImplementedError, dict(mts_recip=2, batch=np.zeros(864, int))),
        "mts0": (ValueError, dict(mts=-1)),
    }
    for mod, Baro in ((JAX, jbaro.MTKBarostat), (PORT, MTKBarostat)):
        if case == "niter":
            integ = _gas_integrator(mod, mts=2, mts_recip=2, T=300.0, thermostat="nhc")
            with pytest.raises(ValueError, match="niter % 2"):
                integ.step(niter=3)
            continue
        exc, kw = cases[case]
        kw = dict(kw)
        if case == "mtk":
            kw["barostat"] = Baro(1.0, 300.0)
        with pytest.raises(exc):
            _gas_integrator(mod, **kw)


@pytest.mark.gpu
def test_mts_tiers_on_the_card():
    """Each r-RESPA tier of the water box's cell path with PME on the
    card (f32 kernels) against the CPU's plain f64 tier, both with the
    ik gather (the exact gather differs from it by the spline's
    truncation error)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    _, tpar, coords, L = water_box()
    out = {}
    for dev, prec in (("cpu", "double"), ("cuda", "single")):
        forces = Forces(tpar, terms=TERMS, precision=prec, cutoff=CUTOFF, kernel="cell",
                        elec="pme", device=dev, column=False, gather="ik")
        pos = torch.as_tensor(coords, dtype=forces.dtype, device=dev)
        forces.prepare(pos[None], np.full((1, 3), L))
        box = torch.full((3,), L, dtype=forces.dtype, device=dev)
        cl = forces._cell_kernel.build(pos, box)
        fast, slow, recip = forces.mts_tiers(recip_tier=True)
        out[dev] = [f.double().cpu() for f in (fast(pos, box)[1], slow(pos, box, cl)[1],
                                               recip(pos, box, cl)[1])]
    for name, a, b in zip(("fast", "slow", "recip"), out["cuda"], out["cpu"]):
        err = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        assert err <= 5e-4, (name, err)
