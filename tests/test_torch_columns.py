"""The port's column path (`columns`, `ops.column`) against the JAX package.

Systems: the charged LJ gas of tests/test_columns.py (1,500 atoms, 60 A,
5x5 columns, cutoff 9 A, reaction field), argon with two bonds excluded
(100 atoms, 77.4 A, 7x7 columns) and the gas with Ewald erfc real space;
and the 216-water TIP4P/2005 box of test_torch_water (19.5 A, cutoff 4 A,
3x3 columns, 3 exclusions per site).

  - `make_column_config` and `build_columns` equal the JAX functions at
    f64: the configuration, and islot, jslot, jzshift, wstart and the
    overflow flag element for element;
  - at f32 the plain column version matches the JAX column kernel
    (`ColumnKernel(..., interpret=True)`) at the bars of
    tests/test_pallas.py:51-57: energies 2e-5 relative, forces 5e-5 of
    the largest force, the per-axis virial 2e-5 relative;
  - at f64 it matches the JAX cell kernel's `energy_forces_virial` on the
    water box (the same pairs) within 1e-9 relative, and its virial the
    scaling derivative -dE/ds_a of the JAX dense energy E(s pos, s box);
  - `Forces(column=...)` picks the kernel; a capacity forced small grows
    in `Forces.compute` and inside an `Integrator` chunk, which is redone,
    to the same result; a box that leaves the grid takes `with_box`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_columns import _argon, _lj_gas
from test_torch_water import CUTOFF, TERMS, jittered, shared_velocities, water_box

from torchmd_tpu import neighbors as jnb
from torchmd_tpu.columns import ColumnKernel as JaxColumnKernel
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.potentials import nonbonded_energies
from torchmd_tpu_torch import Forces, Integrator, System, interop
from torchmd_tpu_torch import columns as tcol
from torchmd_tpu_torch.neighbors import CellKernel
from torchmd_tpu_torch.ops import column as kcol
from torchmd_tpu_torch.potentials import ForceTermConfig, make_ffparams

# one intra-op thread per test process: the suite runs under xdist, and
# a pool of one thread per core in every worker oversubscribes the CPU
torch.set_num_threads(1)


def _gas_system(erfc=False):
    mol, par, forces, L = _lj_gas(natoms=1500, L=60.0, charges=True)
    cfg = forces.config._replace(ewald_alpha=0.37, rfa=False) if erfc else forces.config
    return par, forces.ffparams, cfg, mol.coords[:, :, 0], np.full(3, L)


def _argon_system():
    mol, par, forces = _argon(terms=("lj", "electrostatics", "bonds"),
                              bonds=[[0, 1], [5, 9]])
    return par, forces.ffparams, forces.config, mol.coords[:, :, 0], np.full(3, 77.395)


SYSTEMS = {"gas": _gas_system, "argon-excl": _argon_system,
           "gas-erfc": lambda: _gas_system(erfc=True)}


def _port_kernel(jffp, jcfg, par, box, pos, dtype):
    ffp = interop.ffparams_from_numpy(jax.tree_util.tree_map(np.asarray, jffp),
                                      dtype=dtype)
    return tcol.ColumnKernel(ffp, ForceTermConfig(**jcfg._asdict()), par, box, pos0=pos)


def _water_f64(seed=7):
    jpar, tpar, coords, L = water_box()
    pos = jittered(coords, seed, 0.1)
    box = np.full(3, L)
    jf = JaxForces(jpar, terms=TERMS, precision="double", cutoff=CUTOFF)
    cfg = jf.config._replace(ewald_alpha=0.82)
    return jpar, tpar, jf, cfg, pos, box


@pytest.mark.parametrize("name", ["gas", "water216"])
def test_build_columns_matches_jax(name):
    if name == "gas":
        par, jffp, jcfg, pos, box = _gas_system()
    else:
        par, _, jf, jcfg, pos, box = _water_f64()
        jffp = jf.ffparams
    jk = JaxColumnKernel(jffp, jcfg, par, box, pos0=pos, interpret=True)
    tk = _port_kernel(jffp, jcfg, par, box, pos, torch.float64)
    assert tk.ccfg == interop.column_config_from_numpy(jk.ccfg)
    assert np.array_equal(tk.excl_table, np.asarray(jk.excl_table))
    jst = jax.jit(jk.build)(jnp.asarray(pos), jnp.asarray(box))
    tst = tk.build(torch.as_tensor(pos), torch.as_tensor(box))
    for f in ("islot", "jslot", "jzshift", "wstart", "overflow"):
        assert np.array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f))), f
    assert not tk.check_overflow(tst)
    # the skin trigger and the column tables
    moved = torch.as_tensor(pos + np.random.RandomState(1).randn(*pos.shape) * 0.6)
    assert bool(tk.needs_rebuild(tst, moved, torch.as_tensor(box))) == bool(
        jk.needs_rebuild(jst, jnp.asarray(moved.numpy()), jnp.asarray(box)))


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_plain_column_f32_matches_pallas_interpret(name):
    par, jffp, jcfg, pos, box = SYSTEMS[name]()
    jk = JaxColumnKernel(jffp, jcfg, par, box, pos0=pos, interpret=True)
    p32, b32 = jnp.asarray(pos, jnp.float32), jnp.asarray(box, jnp.float32)
    pot_j, f_j, vir_j = jax.jit(jk.energy_forces_virial)(p32, b32, jk.build(p32, b32))
    tk = _port_kernel(jffp, jcfg, par, box, pos, torch.float32)
    tp, tb = torch.as_tensor(pos, dtype=torch.float32), torch.as_tensor(box, dtype=torch.float32)
    pot_t, f_t, vir_t = tk.energy_forces_virial(tp, tb, tk.build(tp, tb))
    assert f_t.dtype == torch.float32 and set(pot_t) == set(pot_j)
    for k in pot_j:
        w = float(pot_j[k])
        assert abs(float(pot_t[k]) - w) <= 2e-5 * max(1.0, abs(w)), (k, float(pot_t[k]), w)
    f_j = np.asarray(f_j, np.float64)
    assert np.abs(f_t.double().numpy() - f_j).max() <= 5e-5 * max(1.0, np.abs(f_j).max())
    vir_j = np.asarray(vir_j, np.float64)
    assert np.all(np.abs(vir_t.double().numpy() - vir_j) <= 2e-5 * np.maximum(1.0, np.abs(vir_j)))


def test_plain_column_f64_matches_jax_cell_and_scaling_grad():
    jpar, tpar, jf, cfg, pos, box = _water_f64()
    jcell = jnb.CellKernel(jf.ffparams, cfg, jpar, box, pos0=pos)
    jp, jb = jnp.asarray(pos), jnp.asarray(box)
    pot_j, f_j, vir_j = jcell.energy_forces_virial(jp, jb, jcell.build(jp, jb))
    ffp = make_ffparams(tpar, dtype=torch.float64, device="cpu", dense_mask=False)
    tk = tcol.ColumnKernel(ffp, ForceTermConfig(**cfg._asdict()), tpar, box, pos0=pos)
    tp, tb = torch.as_tensor(pos), torch.as_tensor(box)
    st = tk.build(tp, tb)
    pot_t, f_t, vir_t = tk.energy_forces_virial(tp, tb, st)
    assert set(pot_t) == set(pot_j)
    for k in pot_j:
        assert abs(float(pot_t[k]) - float(pot_j[k])) <= 1e-9 * abs(float(pot_j[k])), k
    f_j, vir_j = np.asarray(f_j), np.asarray(vir_j)
    assert np.abs(f_t.numpy() - f_j).max() <= 1e-9 * np.abs(f_j).max()
    assert np.abs(vir_t.numpy() - vir_j).max() <= 1e-9 * np.abs(vir_j).max()
    pot_0, f_0 = tk.energy_forces(tp, tb, st)
    assert torch.equal(f_0, f_t)

    def e_scaled(s):
        return sum(jax.tree_util.tree_leaves(
            nonbonded_energies(jf.ffparams, jp * s, jb * s, cfg)))

    want = -np.asarray(jax.jit(jax.grad(e_scaled))(jnp.ones(3)))
    assert np.abs(vir_t.numpy() - want).max() <= 1e-9 * np.abs(want).max()


def _water_forces(tpar, **kw):
    return Forces(tpar, terms=TERMS, precision="double", cutoff=CUTOFF,
                  kernel="cell", elec="pme", device="cpu", **kw)


def test_column_choice_follows_the_forces_argument():
    _, tpar, coords, L = water_box()
    box = np.full((1, 3), L)
    kinds = {}
    for column in (None, True, False):
        f = _water_forces(tpar, column=column)
        kinds[column] = (f.compute(coords[None], box)[0], type(f._cell_kernel))
    # on the CPU at f64 the default is the cell kernel, as in the JAX package
    assert kinds[None][1] is CellKernel and kinds[False][1] is CellKernel
    assert kinds[True][1] is tcol.ColumnKernel
    assert kinds[True][0] == pytest.approx(kinds[False][0], rel=1e-12)
    with pytest.raises(ValueError, match="column"):
        _water_forces(tpar, column="yes")
    narrow = _water_forces(tpar, column=True)
    with pytest.raises(ValueError, match="column grid"):
        narrow.compute(coords[None], np.full((1, 3), 16.0))


def test_column_overflow_grows_in_compute_and_integrator(monkeypatch):
    _, tpar, coords, L = water_box()
    box = np.full((1, 3), L)
    forces = _water_forces(tpar, column=True)
    want = forces.compute(coords[None], box)
    small = forces._cell_kernel.ccfg._replace(C=48, CE=128, W=128)

    def shrunk(kern):
        import copy

        new = copy.copy(kern)
        new.ccfg = small
        return new

    forces.set_cell_kernel(shrunk(forces._cell_kernel))
    assert forces.compute(coords[None], box) == pytest.approx(want, rel=1e-12)
    assert forces._cell_kernel.ccfg.C > 48

    def run(f, shrink):
        s = System(coords.shape[0], 1, "double")
        s.set_positions(coords)
        s.set_box(np.full((3, 1), L))
        s.set_velocities(shared_velocities(tpar))
        integ = Integrator(s, f, 2.0, T=300.0, thermostat="nhc", constraints="settle")
        f.prepare(torch.as_tensor(s.pos), s.box_diag)
        if shrink:
            f.set_cell_kernel(shrunk(f._cell_kernel))
        return integ, integ.step(niter=3), s

    ref = run(_water_forces(tpar, column=True), False)
    # the chunk itself must find the overflow: skip the per-chunk pre-grow
    monkeypatch.setattr(Forces, "prepare", lambda self, pos, box: None)
    integ, out, s = run(forces, True)
    assert integ.overflow_retries >= 1
    np.testing.assert_allclose(out, ref[1], rtol=1e-12)
    np.testing.assert_allclose(s.pos, ref[2].pos, rtol=0, atol=1e-12)


def test_box_leaving_the_grid_takes_with_box():
    _, tpar, coords, L = water_box()
    wide = np.array([L, 25.0, L])   # 4 columns of 6.25 A along y
    forces = _water_forces(tpar, column=True)
    forces.compute(coords[None], wide[None])
    kern = forces._cell_kernel
    assert kern.covers(wide) and kern.ccfg.ncols == (3, 4)
    # 4 columns no longer fit 23 A at rc = 6 A: the kernel is re-boxed
    narrow = np.array([L, 23.0, L])
    assert not kern.covers(narrow)
    e = forces.compute(coords[None], narrow[None])[0]
    assert forces._cell_kernel is not kern
    assert forces._cell_kernel.ccfg.ncols == (3, 3) and forces._cell_kernel.covers(narrow)
    # the cell path re-boxed the same way (and PME kept its first mesh)
    ref = _water_forces(tpar, column=False)
    ref.compute(coords[None], wide[None])
    assert e == pytest.approx(ref.compute(coords[None], narrow[None])[0], rel=1e-12)


@pytest.mark.gpu
def test_column_kernel_on_cuda_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    jpar, tpar, jf, cfg, pos, box = _water_f64()
    dev = torch.device("cuda")
    tcfg = ForceTermConfig(**cfg._asdict())
    k64 = tcol.ColumnKernel(make_ffparams(tpar, dtype=torch.float64, device="cpu",
                                          dense_mask=False), tcfg, tpar, box, pos0=pos)
    k32 = tcol.ColumnKernel(make_ffparams(tpar, dtype=torch.float32, device=dev,
                                          dense_mask=False), tcfg, tpar, box, pos0=pos)
    p32 = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    b32 = torch.as_tensor(box, dtype=torch.float32, device=dev)
    st = k32.build(p32, b32)
    n0 = kcol.LAUNCHES
    pot_k, f_k, vir_k = k32.energy_forces_virial(p32, b32, st)
    st64 = tcol.ColumnState(*(t.cpu() for t in st))
    st64 = st64._replace(jzshift=st64.jzshift.double(), ref_pos=st64.ref_pos.double())
    pot_p, f_p, vir_p = k64.energy_forces_virial(p32.cpu().double(), b32.cpu().double(), st64)
    assert kcol.LAUNCHES == n0 + 1
    for k in pot_p:
        assert abs(float(pot_k[k]) - float(pot_p[k])) <= 2e-5 * max(1.0, abs(float(pot_p[k])))
    assert float((f_k.cpu().double() - f_p).abs().max()) <= 5e-5 * max(1.0, float(f_p.abs().max()))
    err = (vir_k.cpu().double() - vir_p).abs()
    assert bool((err <= 2e-5 * torch.clamp(vir_p.abs(), min=1.0)).all()), (vir_k, vir_p)
