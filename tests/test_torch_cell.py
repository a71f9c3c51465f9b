"""The port's cell-list path (`neighbors`, `ops.cell`) against the JAX
package.

Small size: the 216-water TIP4P/2005 box (864 sites, 19.5 A box, cutoff
4 A, skin 2 A: a 3x3x3 grid), positions jittered from a seed.

  - the exclusion table, the occupancy-sized capacity, the cell list
    (same atoms in the same cells), the anchored positions and the top-2
    rebuild trigger equal the JAX functions;
  - the plain cell version equals `neighbors.cell_nonbonded_energy_forces`
    at f64 on the JAX package's own cell list, per term within 1e-7
    relative and forces within 1e-7 of the largest (Ewald erfc, and LJ
    switch + reaction field);
  - at f32 it matches `pallas_cell_energy_forces(..., interpret=True)`
    at the relative bars of tests/test_pallas.py:51-57 (energies 2e-5,
    forces 1e-4 of the largest: water's energies are too large for an
    absolute 1e-6);
  - an overflowing capacity grows in `Forces.compute` and, inside a chunk,
    in `Integrator.step`, which redoes the chunk;
  - the per-axis pair virial (the MTK barostat's) of the plain version
    equals `neighbors.cell_nonbonded_energy_forces(..., with_virial=True)`
    at f64 within 1e-9 relative, energies and forces unchanged by it;
  - with NBFIX A/B tables (Lorentz-Berthelot with one type pair
    perturbed, as `test_torch_nonbonded._perturbed_tables` makes them) the
    plain version equals the JAX f64 cell path per term within 1e-7;
  - `Forces` with lj + repulsion on the cell route (one launch per
    LJ-family term; plain versions here) equals the JAX `Forces` at f64
    per term within 1e-7 (`gpu`: the cell kernel's NBFIX instance and two
    launches for lj + repulsion against plain, through Forces).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nonbonded import _perturbed_tables
from test_torch_water import CUTOFF, TERMS, jittered, shared_velocities, water_box

from torchmd_tpu import neighbors as jnb
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.ops.pallas_cell import pallas_cell_energy_forces
from torchmd_tpu_torch import Forces, Integrator, System, interop
from torchmd_tpu_torch import neighbors as tnb
from torchmd_tpu_torch.ops import cell as tcell
from torchmd_tpu_torch.potentials import ForceTermConfig, make_ffparams

# one intra-op thread per test process: the suite runs under xdist, and
# a pool of one thread per core in every worker oversubscribes the CPU
torch.set_num_threads(1)

CONFIGS = {
    "ewald": (dict(cutoff=CUTOFF), dict(ewald_alpha=0.82)),
    "switch-rfa": (dict(cutoff=CUTOFF, switch_dist=3.2, rfa=True), {}),
}


def _setup(name, precision="double", nbfix=False):
    """The 216-water box's JAX and port cell inputs; with `nbfix`, both
    FFParams carry `_perturbed_tables` of the LJ rows."""
    jpar, tpar, coords, L = water_box()
    pos = jittered(coords, 7, 0.1)
    box = np.full(3, L)
    kw, edit = CONFIGS[name]
    jf = JaxForces(jpar, terms=TERMS, precision=precision, kernel="cell", **kw)
    cfg = jf.config._replace(**edit)
    jdt = jnp.float64 if precision == "double" else jnp.float32
    tdt = torch.float64 if precision == "double" else torch.float32
    ffp = make_ffparams(tpar, dtype=tdt, device="cpu", dense_mask=False)
    if nbfix:
        A, B = _perturbed_tables(np.asarray(jf.ffparams.lj_params))
        jf.ffparams = jf.ffparams._replace(lj_ab=(jnp.asarray(A, jdt), jnp.asarray(B, jdt)))
        ffp = ffp._replace(lj_ab=(torch.as_tensor(A, dtype=tdt), torch.as_tensor(B, dtype=tdt)))
    jk = jnb.CellKernel(jf.ffparams, cfg, jpar, box, pos0=pos)
    jpos, jbox = jnp.asarray(pos, jdt), jnp.asarray(box, jdt)
    jcl = jk.build(jpos, jbox)
    data = tcell.prepare_cell_data(ffp, interop.exclusion_table_from_numpy(jk.excl_table))
    port = (data, ForceTermConfig(**cfg._asdict()), interop.cell_config_from_numpy(jk.clcfg),
            interop.cell_list_from_numpy(jcl, dtype=tdt), torch.as_tensor(pos, dtype=tdt),
            torch.as_tensor(box, dtype=tdt))
    return jf, cfg, jk, jcl, jpos, jbox, port, tpar


def _assert_close(pot_t, f_t, pot_j, f_j, e_rel, f_rel):
    assert set(pot_t) == set(pot_j)
    for k in pot_j:
        w = float(pot_j[k])
        assert abs(float(pot_t[k]) - w) <= e_rel * max(1.0, abs(w)), (k, float(pot_t[k]), w)
    f_j = np.asarray(f_j, np.float64)
    assert np.abs(f_t.double().numpy() - f_j).max() <= f_rel * max(1.0, np.abs(f_j).max())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_cell_matches_jax_f64(name):
    jf, cfg, jk, jcl, jpos, jbox, port, _ = _setup(name)
    pot_j, f_j = jnb.cell_nonbonded_energy_forces(
        jf.ffparams, cfg, jk.clcfg, jcl, jk.excl_table, jpos, jbox)
    pot_t, f_t = tcell.cell_reference(*port)
    _assert_close(pot_t, f_t, pot_j, f_j, 1e-7, 1e-7)
    # the JAX-signature wrapper runs the same plain version
    data, tcfg, clcfg, cl, pos, box = port
    ffp = make_ffparams(water_box()[1], dtype=torch.float64, device="cpu",
                        dense_mask=False)
    pot_w, f_w = tnb.cell_nonbonded_energy_forces(
        ffp, tcfg, clcfg, cl, interop.exclusion_table_from_numpy(jk.excl_table), pos, box)
    assert torch.equal(f_w, f_t)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_cell_virial_matches_jax_f64(name):
    jf, cfg, jk, jcl, jpos, jbox, port, _ = _setup(name)
    pot_j, f_j, vir_j = jnb.cell_nonbonded_energy_forces(
        jf.ffparams, cfg, jk.clcfg, jcl, jk.excl_table, jpos, jbox, with_virial=True)
    pot_t, f_t, vir_t = tcell.cell_reference(*port, with_virial=True)
    _assert_close(pot_t, f_t, pot_j, f_j, 1e-9, 1e-9)
    vir_j = np.asarray(vir_j)
    assert np.abs(vir_t.numpy() - vir_j).max() <= 1e-9 * np.abs(vir_j).max()
    pot_0, f_0 = tcell.cell_reference(*port)
    assert torch.equal(f_0, f_t) and all(torch.equal(pot_0[k], pot_t[k]) for k in pot_t)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_cell_nbfix_matches_jax_f64(name):
    """NBFIX tables on the cell path: the plain version (and the wrapper,
    which runs it on CPU tensors) against the JAX f64 cell path, which
    applies the A/B tables by type pair."""
    jf, cfg, jk, jcl, jpos, jbox, port, _ = _setup(name, nbfix=True)
    assert port[0].lj_a is not None and port[0].lj_a.shape == (3, 3)
    pot_j, f_j = jnb.cell_nonbonded_energy_forces(
        jf.ffparams, cfg, jk.clcfg, jcl, jk.excl_table, jpos, jbox)
    pot_t, f_t = tcell.cell_energy_forces(*port)
    _assert_close(pot_t, f_t, pot_j, f_j, 1e-7, 1e-7)
    # the tables change the answer: LJ differs from Lorentz-Berthelot's
    pot_lb = tcell.cell_reference(*_setup(name)[6])[0]
    assert abs(float(pot_lb["lj"]) - float(pot_t["lj"])) > 1e-3 * abs(float(pot_t["lj"]))


def test_forces_lj_and_repulsion_on_the_cell_route_match_jax_f64():
    """lj + repulsion through `Forces(kernel="cell")` on the kernel route
    (two launches of the cell kernel's plain version, each term keyed by
    itself) against the JAX `Forces` at f64, per term and forces."""
    jpar, tpar, coords, L = water_box()
    pos = jittered(coords, 7, 0.1)[None]
    box = np.full((1, 3), L)
    terms = TERMS + ["repulsion"]
    kw = dict(terms=terms, precision="double", cutoff=CUTOFF, switch_dist=3.2, rfa=True,
              kernel="cell")
    jforces, tforces = np.zeros_like(pos), np.zeros_like(pos)
    want = JaxForces(jpar, **kw).compute(pos, box, jforces, returnDetails=True)[0]
    tf = Forces(tpar, device="cpu", **kw)
    got = tf.compute(pos, box, tforces, returnDetails=True)[0]
    assert isinstance(tf._cell_kernel, tnb.CellKernel) and tf.use_kernels
    assert set(got) == set(want) and {"lj", "repulsion", "electrostatics"} <= set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-7, abs=1e-7), k
    assert np.abs(tforces - jforces).max() <= 1e-7 * max(1.0, np.abs(jforces).max())


def test_plain_cell_f32_matches_pallas_interpret():
    jf, cfg, jk, jcl, jpos, jbox, port, _ = _setup("ewald", precision="single")
    pot_j, f_j = pallas_cell_energy_forces(
        jf.ffparams, cfg, jk.clcfg, jcl, jk.excl_table, jpos, jbox, interpret=True)
    pot_t, f_t = tcell.cell_energy_forces(*port)   # CPU tensors: the plain version
    assert f_t.dtype == torch.float32
    _assert_close(pot_t, f_t, pot_j, f_j, 2e-5, 1e-4)


def test_cell_structures_match_jax():
    jf, cfg, jk, jcl, jpos, jbox, port, tpar = _setup("ewald")
    data, tcfg, clcfg, cl, pos, box = port
    n = pos.shape[0]
    assert np.array_equal(tnb.build_exclusion_table(tpar, n), np.asarray(jk.excl_table))
    kern = tnb.CellKernel(make_ffparams(tpar, dtype=torch.float64, device="cpu",
                                        dense_mask=False),
                          tcfg, tpar, box.numpy(), pos0=pos.numpy())
    assert kern.clcfg == clcfg
    mine = kern.build(pos, box)
    assert torch.equal(mine.counts.long(), torch.as_tensor(np.array(jcl.counts)).long())
    for c in range(mine.slots.shape[0]):
        k = int(mine.counts[c])
        assert sorted(mine.slots[c, :k].tolist()) == sorted(np.asarray(jcl.slots)[c, :k].tolist())
    assert bool(mine.overflow) == bool(jcl.overflow) is False
    # anchored positions and the rebuild trigger after a drift across a face
    rs = np.random.RandomState(3)
    moved = pos.numpy() + rs.randn(n, 3) * 0.4
    moved[0] = [-0.05, 10.0, 19.49]
    want = np.asarray(jnb.anchored_positions(jnp.asarray(moved), jcl.ref_pos, jbox))
    got = tnb.anchored_positions(torch.as_tensor(moved), mine.ref_pos, box).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for d2 in (rs.rand(50) * 2.0, np.array([1.1, 1.1, 0.2]), np.array([3.9, 0.01])):
        assert bool(tnb.displacement_trigger(torch.as_tensor(d2), 2.0)) == bool(
            jnb.displacement_trigger(jnp.asarray(d2), 2.0))
    assert bool(kern.needs_rebuild(mine, torch.as_tensor(moved), box)) == bool(
        jk.needs_rebuild(jcl, jnp.asarray(moved), jbox))


def test_overflow_grows_in_compute_and_integrator(monkeypatch):
    _, tpar, coords, L = water_box()
    forces = Forces(tpar, terms=TERMS, precision="double", cutoff=CUTOFF,
                    kernel="cell", elec="pme", device="cpu")
    box = np.full((1, 3), L)
    want = forces.compute(coords[None], box)
    kern = forces._cell_kernel
    forces.set_cell_kernel(_with_capacity(kern, 16))
    assert forces.compute(coords[None], box) == pytest.approx(want, rel=1e-12)
    assert forces._cell_kernel.clcfg.capacity > 16

    system = System(coords.shape[0], 1, "double")
    system.set_positions(coords)
    system.set_box(np.full((3, 1), L))
    system.set_velocities(shared_velocities(tpar))
    integ = Integrator(system, forces, 2.0, T=300.0, thermostat="nhc",
                       constraints="settle")
    ref_sys = System(coords.shape[0], 1, "double")
    ref_sys.set_positions(coords)
    ref_sys.set_box(np.full((3, 1), L))
    ref_sys.set_velocities(shared_velocities(tpar))
    ref = Integrator(ref_sys, Forces(tpar, terms=TERMS, precision="double",
                                     cutoff=CUTOFF, kernel="cell", elec="pme",
                                     device="cpu"),
                     2.0, T=300.0, thermostat="nhc", constraints="settle")
    # the chunk itself must find the overflow: skip the per-chunk pre-grow
    monkeypatch.setattr(Forces, "prepare", lambda self, pos, box: None)
    forces.set_cell_kernel(_with_capacity(forces._cell_kernel, 16))
    ref.forces.ensure_ewald(box[0])
    ref.forces.ensure_cell_kernel(box[0], pos0=coords)
    out = integ.step(niter=3)
    assert integ.overflow_retries >= 1
    np.testing.assert_allclose(out, ref.step(niter=3), rtol=1e-12)
    np.testing.assert_allclose(system.pos, ref_sys.pos, rtol=0, atol=1e-12)


def _with_capacity(kern, capacity):
    import copy

    new = copy.copy(kern)
    new.clcfg = kern.clcfg.with_capacity(capacity)
    return new


@pytest.mark.gpu
def test_cell_kernel_on_cuda_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, _, _, _, _, _, port, _ = _setup("ewald")
    data, cfg, clcfg, cl, pos, box = port
    dev = torch.device("cuda")
    data32 = tcell.CellData(**{k: (v.to(dev, torch.float32) if torch.is_tensor(v)
                                   and v.is_floating_point() else
                                   v.to(dev) if torch.is_tensor(v) else v)
                               for k, v in data._asdict().items()})
    cl32 = cl._replace(slots=cl.slots.to(dev), counts=cl.counts.to(dev),
                       ref_pos=cl.ref_pos.to(dev, torch.float32),
                       overflow=cl.overflow.to(dev))
    n0 = tcell.LAUNCHES
    pot_k, f_k = tcell.cell_energy_forces(data32, cfg, clcfg, cl32,
                                          pos.to(dev, torch.float32),
                                          box.to(dev, torch.float32))
    pot_p, f_p = tcell.cell_reference(data, cfg, clcfg, cl, pos, box)
    assert tcell.LAUNCHES == n0 + 1
    _assert_close(pot_k, f_k.cpu(), pot_p, f_p.numpy(), 2e-5, 5e-5)


@pytest.mark.gpu
def test_cell_virial_kernel_on_cuda_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, _, _, _, _, _, port, _ = _setup("ewald")
    data, cfg, clcfg, cl, pos, box = port
    dev = torch.device("cuda")
    data32 = tcell.CellData(**{k: (v.to(dev, torch.float32) if torch.is_tensor(v)
                                   and v.is_floating_point() else
                                   v.to(dev) if torch.is_tensor(v) else v)
                               for k, v in data._asdict().items()})
    cl32 = cl._replace(slots=cl.slots.to(dev), counts=cl.counts.to(dev),
                       ref_pos=cl.ref_pos.to(dev, torch.float32),
                       overflow=cl.overflow.to(dev))
    pot_k, f_k, vir_k = tcell.cell_energy_forces(
        data32, cfg, clcfg, cl32, pos.to(dev, torch.float32),
        box.to(dev, torch.float32), with_virial=True)
    pot_p, f_p, vir_p = tcell.cell_reference(data, cfg, clcfg, cl, pos, box,
                                             with_virial=True)
    _assert_close(pot_k, f_k.cpu(), pot_p, f_p.numpy(), 2e-5, 5e-5)
    err = (vir_k.cpu().double() - vir_p).abs()
    assert bool((err <= 2e-5 * torch.clamp(vir_p.abs(), min=1.0)).all()), (vir_k, vir_p)


@pytest.mark.gpu
def test_cell_kernel_nbfix_on_cuda_matches_plain():
    """The cell kernel's NBFIX instance (tables by type pair) against the
    plain f64 version on the 216-water box at the Pallas bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, _, _, _, _, _, port, _ = _setup("ewald", nbfix=True)
    data, cfg, clcfg, cl, pos, box = port
    dev = torch.device("cuda")
    data32 = tcell.CellData(**{k: (v.to(dev, torch.float32) if torch.is_tensor(v)
                                   and v.is_floating_point() else
                                   v.to(dev) if torch.is_tensor(v) else v)
                               for k, v in data._asdict().items()})
    cl32 = cl._replace(slots=cl.slots.to(dev), counts=cl.counts.to(dev),
                       ref_pos=cl.ref_pos.to(dev, torch.float32),
                       overflow=cl.overflow.to(dev))
    n0 = tcell.LAUNCHES
    pot_k, f_k = tcell.cell_energy_forces(data32, cfg, clcfg, cl32,
                                          pos.to(dev, torch.float32),
                                          box.to(dev, torch.float32))
    pot_p, f_p = tcell.cell_reference(data, cfg, clcfg, cl, pos, box)
    assert tcell.LAUNCHES == n0 + 1
    _assert_close(pot_k, f_k.cpu(), pot_p, f_p.numpy(), 2e-5, 5e-5)


@pytest.mark.gpu
def test_forces_nbfix_and_lj_repulsion_on_cuda_match_plain():
    """`Forces(nbfix=True, kernel="cell")` with an NBFIX row and `Forces`
    with lj + repulsion build on the card (neither raises), take the cell
    kernel, and match the plain f64 path at the Pallas bars
    (`chip_smoke.pair_variants` on its 216-water box)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke

    name, n, spacing, cutoff, jitter = chip_smoke.water_cases()[0]
    c = chip_smoke.water_case(n, spacing, cutoff, jitter)
    n0 = tcell.LAUNCHES
    chip_smoke.pair_variants(name, c)
    assert tcell.LAUNCHES == n0 + 3
