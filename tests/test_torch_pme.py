"""The port's PME (`ewald.PmeRecip`, `ops.pme`) against the JAX package.

Small size: the 216-water TIP4P/2005 box (864 sites, 19.5 A, cutoff 4 A;
PME order 6 on a 40^3 mesh) with seeded jitter.

  - parameter choice, B-spline weights (and their knot-safe derivative)
    and the Euler factors equal the JAX functions (1e-14);
  - `PmeRecip` energy and exact-gather forces equal the JAX `PmeRecip` at
    f64 on its XLA path (TMD_PME_GATHER=xla), within 1e-7 relative;
  - the plain spread equals the JAX scalar-row spread `_spread_segsum` at
    f64 (1e-12 of the mesh maximum), and the plain spread and ik gather at
    f32 match `pme_spread` / `pme_gather_ik` run in interpret mode within
    3e-5 of the largest value (the JAX side's bf16-split dots, as in
    tests/test_pallas_pme.py);
  - the ik path at f32 matches the JAX package's ik path (interpret
    mode) within 1e-4 of the largest force; ik forces agree with the
    exact gradient to the spline truncation order (2.5e-2 of the largest
    force at order 4, 1.6e-3 at order 6, on this small box) and the
    reciprocal ik forces sum to ~0;
  - the per-axis scaling virial of `energy_forces_virial` (the MTK
    barostat's -dE/ds_a, analytic) equals `jax.grad` over s of the JAX
    `PmeRecip.energy(s pos, s box)` at f64 within 1e-9 relative, orders 4
    and 6, with a net charge (the 1/V term) and the exclusion pairs;
  - the orders the water box's steps hand the spread (the cell list's
    slots on the NVT path, the columns' i slots on the NPT path) hold
    every atom once, and `PmeRecip` gives the same energy and forces with
    and without an order (`gpu`: the spread kernel against plain f64 in
    every order, chip_smoke.py's water boxes; the gather kernel against
    plain f64, its forces bitwise equal over two runs, zero rows for the
    zero-charge oxygens, orders 4 and 6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_water import CUTOFF, TERMS, jittered, shared_velocities, water_box

from torchmd_tpu import ewald as jew
from torchmd_tpu.ops import pallas_pme as ppme
from torchmd_tpu_torch import ewald as tew
from torchmd_tpu_torch import interop
from torchmd_tpu_torch.ops import pme as tpme

# one intra-op thread per test process: the suite runs under xdist, and
# a pool of one thread per core in every worker oversubscribes the CPU
torch.set_num_threads(1)


def _system(seed=11, scale=0.05):
    jpar, tpar, coords, L = water_box()
    pos = jittered(coords, seed, scale)
    pos[3::4] = pos[::4] + 0.15  # sites near, not on, their oxygens
    q = np.asarray(jpar.charges, np.float64)
    excl = jpar.get_exclusions(types=("bonds", "angles", "1-4"))
    return pos, q, np.full(3, L), excl


def _pair(order=None, dtype=jnp.float64, gather=None):
    pos, q, box, excl = _system()
    jrec = jew.PmeRecip(q, box, CUTOFF, excl_pairs=excl, dtype=dtype, order=order)
    trec = interop.pme_recip_from_numpy(
        q, box, CUTOFF, jrec.cfg.kmax, jrec.cfg.alpha, jrec.ORDER, excl,
        dtype=torch.float64 if dtype == jnp.float64 else torch.float32,
        gather=gather)
    return pos, box, jrec, trec


def test_parameters_and_splines_match_jax():
    box = np.array([19.5, 21.0, 77.6])
    for cutoff in (4.0, 8.5):
        cfg = tew.choose_parameters(box, cutoff)
        assert cfg == jew.choose_parameters(box, cutoff)
        assert tew.pme_mesh_shape(cfg.kmax, box) == jew.pme_mesh_shape(cfg.kmax, box)
    for n in (17, 49, 81, 97):
        assert tew.pme_fast_len(n) == jew.pme_fast_len(n)
    frac = np.concatenate([[0.0, 1e-9, 0.5, 1.0 - 1e-12],
                           np.random.RandomState(0).rand(20)])
    for n in (4, 6):
        np.testing.assert_allclose(tew.bspline_b2(40, n), jew.bspline_b2(40, n),
                                   rtol=1e-14)
        w = tew.bspline_weights(torch.as_tensor(frac), n).numpy()
        dw = tew.bspline_dweights(torch.as_tensor(frac), n).numpy()
        jw, jdw = jax.jvp(lambda f: jew.bspline_weights(f, n),
                          (jnp.asarray(frac),), (jnp.ones_like(frac),))
        np.testing.assert_allclose(w, np.asarray(jw), rtol=0, atol=1e-15)
        np.testing.assert_allclose(dw, np.asarray(jdw), rtol=0, atol=1e-14)
        # knot-safe: the taps' derivatives sum to zero at frac = 0 too
        np.testing.assert_allclose(dw.sum(-1), 0.0, atol=1e-14)


def test_erf_corrections_match_jax_including_coincident_pairs():
    rs = np.random.RandomState(2)
    dv = rs.randn(50, 3)
    dv[:5] *= 1e-3          # the series branch
    dv[5] = 0.0             # a coincident pair
    qq = rs.randn(50)
    alpha = 0.82
    e, grad = tew.erf_over_r_sum(alpha, torch.as_tensor(dv), torch.as_tensor(qq))
    je, jg = jax.value_and_grad(
        lambda d: jew.erf_over_r_sum(alpha, d, jnp.asarray(qq)))(jnp.asarray(dv))
    np.testing.assert_allclose(float(e), float(je), rtol=1e-13)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-12)


def test_pme_energy_and_exact_forces_match_jax(monkeypatch):
    monkeypatch.setenv("TMD_PME_GATHER", "xla")
    pos, box, jrec, trec = _pair()
    assert trec.gather == "exact" and trec.ORDER == 6 and trec.cfg.kmax == (40, 40, 40)
    je, jf = jax.jit(jrec.energy_forces)(jnp.asarray(pos), jnp.asarray(box))
    te, tf = trec.energy_forces(torch.as_tensor(pos), torch.as_tensor(box))
    assert abs(float(te) - float(je)) <= 1e-7 * abs(float(je))
    scale = np.abs(np.asarray(jf)).max()
    assert np.abs(tf.numpy() - np.asarray(jf)).max() <= 1e-7 * scale
    e_only = trec.energy(torch.as_tensor(pos), torch.as_tensor(box))
    assert abs(float(e_only) - float(jrec.energy(jnp.asarray(pos), jnp.asarray(box)))) \
        <= 1e-7 * abs(float(je))


@pytest.mark.parametrize("order", [4, 6])
def test_plain_spread_matches_jax_segsum_f64(order):
    pos, box, jrec, trec = _pair(order=order)
    q = jnp.asarray(np.asarray(jrec.charges))
    want = np.asarray(jrec._spread_segsum(jnp.asarray(pos), jnp.asarray(box), q))
    got = tpme.spread_reference(torch.as_tensor(pos), trec.charges,
                                torch.as_tensor(box), trec.cfg.kmax, order).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("order", [4, 6])
def test_plain_spread_and_ik_gather_match_pallas_interpret(order):
    pos, box, jrec, _ = _pair(order=order, dtype=jnp.float32)
    pos32 = pos.astype(np.float32)
    box32 = box.astype(np.float32)
    kmesh = jrec.cfg.kmax
    (Rx, Ry, Rz), _ = jrec._tap_rows_d(jnp.asarray(pos32), jnp.asarray(box32))
    Rzq = Rz * jrec.charges[:, None]
    q32 = torch.as_tensor(np.array(jrec.charges))
    p32, b32 = torch.as_tensor(pos32), torch.as_tensor(box32)

    mesh_j = np.asarray(ppme.pme_spread(Rx, Ry, Rzq, kmesh, interpret=True))
    mesh_t = tpme.pme_spread(p32, q32, b32, kmesh, order).numpy()
    assert mesh_t.dtype == np.float32
    assert np.abs(mesh_t - mesh_j).max() <= 3e-5 * np.abs(mesh_j).max()

    rng = np.random.default_rng(order)
    grids = [(rng.random(kmesh) - 0.5).astype(np.float32) for _ in range(3)]
    f_j = np.asarray(ppme.pme_gather_ik(Rx, Ry, Rzq, tuple(jnp.asarray(g) for g in grids),
                                        interpret=True))
    f_t = tpme.pme_gather_ik(p32, q32, b32, [torch.as_tensor(g) for g in grids],
                             order).numpy()
    assert np.abs(f_t - f_j).max() <= 3e-5 * np.abs(f_j).max()


@pytest.mark.parametrize("order,bar", [(4, 3e-2), (6, 3e-3)])
def test_ik_forces_match_exact_gradient(order, bar):
    """ik and exact differentiation are two PME force discretisations that
    agree to the spline truncation order: on this small box (alpha 0.82,
    0.49 A mesh) they differ by 2.5e-2 (order 4) and 1.6e-3 (order 6) of
    the largest force; the energy is the same contraction."""
    pos, box, _, exact = _pair(order=order, gather="exact")
    ik = tew.PmeRecip(exact.charges, box, CUTOFF, excl_pairs=_system()[3],
                      order=order, gather="ik")
    p, b = torch.as_tensor(pos), torch.as_tensor(box)
    e_x, f_x = exact.energy_forces(p, b)
    e_k, f_k = ik.energy_forces(p, b)
    assert float(e_k) == pytest.approx(float(e_x), rel=1e-12)
    scale = float(f_x.abs().max())
    assert float((f_k - f_x).abs().max()) <= bar * scale
    recip_k = f_k - ik._corrections(p, b, ik.charges)[1]
    assert float(recip_k.sum(0).abs().max()) <= 1e-3 * scale


@pytest.mark.parametrize("order", [4, 6])
def test_ik_energy_forces_match_jax_ik_interpret(order, monkeypatch):
    """The port's ik path at f32 against the JAX package's (Pallas spread
    and ik gather in interpret mode): within 1e-4 of the largest force
    (measured 3.7e-5: f32 FFTs and the JAX side's bf16-split dots)."""
    monkeypatch.setenv("TMD_PME_GATHER", "interpret")
    pos, box, jrec, trec = _pair(order=order, dtype=jnp.float32, gather="ik")
    pos32, box32 = pos.astype(np.float32), box.astype(np.float32)
    je, jf = jrec.energy_forces(jnp.asarray(pos32), jnp.asarray(box32))
    te, tf = trec.energy_forces(torch.as_tensor(pos32), torch.as_tensor(box32))
    assert abs(float(te) - float(je)) <= 2e-5 * abs(float(je))
    scale = np.abs(np.asarray(jf)).max()
    assert np.abs(tf.numpy() - np.asarray(jf)).max() <= 1e-4 * scale


@pytest.mark.parametrize("order", [4, 6])
def test_pme_virial_matches_jax_scaling_grad(order):
    pos, q, box, excl = _system()
    q = q + 0.013   # a net charge: the 1/V term has a virial of its own
    jrec = jew.PmeRecip(q, box, CUTOFF, excl_pairs=excl, dtype=jnp.float64, order=order)
    trec = interop.pme_recip_from_numpy(q, box, CUTOFF, jrec.cfg.kmax, jrec.cfg.alpha,
                                        jrec.ORDER, excl)
    want = -np.asarray(jax.jit(jax.grad(
        lambda s: jrec.energy(jnp.asarray(pos) * s, jnp.asarray(box) * s)))(jnp.ones(3)))
    p, b = torch.as_tensor(pos), torch.as_tensor(box)
    for gather in ("exact", "ik"):
        e, f, vir = trec.energy_forces_virial(p, b, gather=gather)
        assert np.abs(vir.numpy() - want).max() <= 1e-9 * np.abs(want).max(), gather
        e0, f0 = trec.energy_forces(p, b, gather=gather)
        assert torch.equal(e, e0) and torch.equal(f, f0)


def test_gather_choice_is_explicit():
    pos, q, box, excl = _system()
    rec = tew.PmeRecip(torch.as_tensor(q, dtype=torch.float32), box, CUTOFF)
    assert rec.gather == "exact"  # CPU: the exact gradient by default
    with pytest.raises(ValueError, match="gather"):
        tew.PmeRecip(torch.as_tensor(q), box, CUTOFF, gather="analytic")


@pytest.mark.gpu
def test_pme_kernels_on_cuda_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    pos, box, _, trec = _pair(order=4)
    dev = torch.device("cuda")
    p32 = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    b32 = torch.as_tensor(box, dtype=torch.float32, device=dev)
    q32 = trec.charges.float().to(dev)
    kmesh = trec.cfg.kmax
    n0 = (tpme.SPREAD_LAUNCHES, tpme.GATHER_LAUNCHES)
    mesh_k = tpme.pme_spread(p32, q32, b32, kmesh, 4)
    mesh_p = tpme.spread_reference(p32.double(), q32.double(), b32.double(), kmesh, 4)
    assert float((mesh_k.double() - mesh_p).abs().max()) <= 1e-5 * float(mesh_p.abs().max())
    grids = [torch.randn(kmesh, device=dev) for _ in range(3)]
    f_k = tpme.pme_gather_ik(p32, q32, b32, grids, 4)
    f_p = tpme.gather_ik_reference(p32.double(), q32.double(), b32.double(),
                                   [g.double() for g in grids], 4)
    assert float((f_k.double() - f_p).abs().max()) <= 5e-5 * float(f_p.abs().max())
    assert (tpme.SPREAD_LAUNCHES, tpme.GATHER_LAUNCHES) == (n0[0] + 1, n0[1] + 1)


def _assert_every_atom_once(order, natoms):
    ids = order.reshape(-1)
    ids = ids[ids < natoms].long()
    assert torch.equal(torch.sort(ids).values, torch.arange(natoms))


@pytest.mark.parametrize("column", [False, True], ids=["cell", "column"])
def test_steps_hand_the_spread_every_atom_once(column, monkeypatch):
    """One NVT step (cell path) and one NPT step (column path) of the
    216-water box on the CPU: the order each hands the spread holds every
    atom once (ids >= N are padding), and is the cell list's slots or the
    columns' i slots."""
    from test_torch_npt import _setup

    from torchmd_tpu_torch import Forces, Integrator, MTKBarostat, System
    from torchmd_tpu_torch.columns import ColumnKernel
    from torchmd_tpu_torch.neighbors import CellKernel

    _, tpar, coords, L = water_box()
    seen = []
    plain = tpme.spread_reference

    def spy(pos, q, box, kmesh, order, order_idx=None):
        seen.append(order_idx)
        return plain(pos, q, box, kmesh, order, order_idx)

    monkeypatch.setattr(tpme, "spread_reference", spy)
    if column:
        forces, _, integ, _ = _setup(Forces, System, Integrator, MTKBarostat, tpar, coords,
                                     L, shared_velocities(tpar), device="cpu", column=True)
    else:
        forces = Forces(tpar, terms=TERMS, precision="double", cutoff=CUTOFF, kernel="cell",
                        elec="pme", device="cpu", column=False)
        s = System(coords.shape[0], 1, "double")
        s.set_positions(coords)
        s.set_box(np.full((3, 1), L))
        s.set_velocities(shared_velocities(tpar))
        forces.compute(s.pos, s.box, s.forces)
        integ = Integrator(s, forces, 2.0, T=300.0, thermostat="nhc", constraints="settle")
    assert isinstance(forces._cell_kernel, ColumnKernel if column else CellKernel)
    seen.clear()
    integ.step(niter=1)
    orders = [o for o in seen if o is not None]
    assert orders and len(orders) == len(seen)
    width = forces._cell_kernel.ccfg.C if column else forces._cell_kernel.clcfg.capacity
    for o in orders:
        assert o.dtype == torch.int32 and o.shape[1] == width
        _assert_every_atom_once(o, tpar.natoms)


def test_pme_recip_is_the_same_with_and_without_an_order():
    """The order changes only the spread kernel's schedule: on the plain
    path PmeRecip's energy, forces and virial are the same bits."""
    pos, box, _, trec = _pair(order=6)
    p, b = torch.as_tensor(pos), torch.as_tensor(box)
    order = torch.as_tensor(np.random.RandomState(1).permutation(pos.shape[0]),
                            dtype=torch.int32)
    for gather in ("exact", "ik"):
        e0, f0, v0 = trec.energy_forces_virial(p, b, gather=gather)
        e1, f1, v1 = trec.energy_forces_virial(p, b, gather=gather, order_idx=order)
        assert torch.equal(e0, e1) and torch.equal(f0, f1) and torch.equal(v0, v1)
    e2, f2 = trec.energy_forces(p, b, order_idx=order[None])
    assert torch.equal(e2, e0) and torch.equal(f2, trec.energy_forces(p, b)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("which", [0, 1], ids=["water216-order6", "water-full-order4"])
def test_cuda_gather_matches_plain_and_repeats(which):
    """The ik gather kernel against plain f64 at the Pallas force bar on
    chip_smoke.py's water boxes (`chip_smoke.gather_checks`): twice with
    the same bits, every charged atom gathered, the zero-charge oxygens
    given zero rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke

    name, n, spacing, cutoff, jitter = chip_smoke.water_cases()[which]
    c = chip_smoke.water_case(n, spacing, cutoff, jitter)
    grids64 = c["f64"]._ewald.ik_grids(c["p64"], c["b64"])
    grids32 = [g.float().contiguous() for g in grids64]
    n0 = tpme.GATHER_LAUNCHES
    chip_smoke.gather_checks(name, c, grids32, grids64)
    assert tpme.GATHER_LAUNCHES == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("odd_mesh", [False, True], ids=["mesh", "odd-mesh"])
@pytest.mark.parametrize("which", [0, 1], ids=["water216-order6", "water-full-order4"])
def test_cuda_spread_matches_plain_in_every_order(which, odd_mesh):
    """The spread kernel against plain f64 within 1e-5 of the mesh maximum
    on chip_smoke.py's water boxes (`chip_smoke.spread_checks`): in the
    cell list's order (bricks), the columns', the input order and a random
    one (straight to the mesh); with `odd_mesh`, in the cell and the
    random order on a mesh whose Kz % 4 != 0 (45^3, 75^3: the brick's
    scalar flush)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke

    name, n, spacing, cutoff, jitter = chip_smoke.water_cases()[which]
    c = chip_smoke.water_case(n, spacing, cutoff, jitter)
    orders = chip_smoke.water_spread_orders(c)
    kmesh = c["f32"]._ewald.cfg.kmax
    if odd_mesh:
        orders = {k: orders[k] for k in ("cell", "random")}
        kmesh = (chip_smoke.ODD_MESH[name],) * 3
        assert kmesh[2] % 4 != 0
    n0 = tpme.SPREAD_LAUNCHES
    chip_smoke.spread_checks(name, c, orders, kmesh)
    assert tpme.SPREAD_LAUNCHES == n0 + len(orders)
