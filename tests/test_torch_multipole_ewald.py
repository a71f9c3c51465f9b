"""The port's multipole Ewald sums (`torchmd_tpu_torch.multipole_ewald`)
against the JAX package at f64.

The AMOEBA water dimer (water03 charges, dipoles and quadrupoles) in a
12 A box, cutoff 5.5 A, Ewald tolerance 1e-4 (7 k-vectors per axis
each way; a 16^3 PME mesh at order 8), a seeded jitter with one water
across the box face:

  - `MultipoleEwald` (the exact reciprocal sum) and `MultipolePme`
    (forced, pme=True): energies within 1e-7 relative of the JAX
    energies; forces within 1e-7 of the largest, against central
    differences of the JAX energy (its nested-AD gradient compiles for
    minutes) and, with the quadrupoles dropped from the spec, against
    jax.grad itself;
  - the derivative B-spline taps equal `ewald.bspline_weights_d2`, and
    their autograd derivative is the analytic one, also on a mesh node;
  - the erf(alpha r)/r tensors B_0..B_4 of the exclusion and self tiers
    in f32 against f64: within 5e-6 relative for t = (alpha r)^2 in
    (0, 4], where B_n = bare - erfc in f32 loses every digit at rank 2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_multipoles import WATER03_PRM, _Ffp, dimer, jax_ffparams, water_mask

from torchmd_tpu import amoeba as jam
from torchmd_tpu import ewald as jew
from torchmd_tpu import multipole_ewald as jme
from torchmd_tpu_torch import amoeba as tam
from torchmd_tpu_torch import ewald as tew
from torchmd_tpu_torch import interop
from torchmd_tpu_torch import multipole_ewald as tme

torch.set_num_threads(1)

L, CUTOFF, TOL = 12.0, 5.5, 1e-4
BOX = np.full(3, L)


def box_positions(seed):
    pos = dimer(seed, 0.06)[0] + np.array([L / 2, L / 2, 9.5])
    return pos - L * np.floor(pos / L)     # the second water wraps in z


def engines(pme, quads=True):
    """(JAX engine, port engine) of the dimer's permanent multipoles."""
    _, types, bonds = dimer()
    mask = water_mask(2)
    kw = dict(cutoff=CUTOFF, mutual=False, ewald=True, box=BOX, ewald_tol=TOL, pme=pme)
    jel, q = jam.make_amoeba_electrostatics(jax_ffparams(mask), types, bonds,
                                            jam.parse_tinker_prm(WATER03_PRM), **kw)
    tel, _ = tam.make_amoeba_electrostatics(_Ffp(mask), types, bonds,
                                            tam.parse_tinker_prm(WATER03_PRM), device="cpu",
                                            **kw)
    jeng, teng = jel.multipoles, tel.multipoles
    if not quads:
        spec = jeng.spec._replace(quad_local=None)
        cls = jme.MultipolePme if pme else jme.MultipoleEwald
        jeng = cls(spec, jeng.charges, BOX, CUTOFF, tol=TOL)
        tspec = interop.multipole_spec_from_numpy(jax.tree_util.tree_map(np.asarray, spec))
        teng = (tme.MultipolePme if pme else tme.MultipoleEwald)(tspec, q, BOX, CUTOFF,
                                                                 tol=TOL)
    assert type(teng).__name__ == type(jeng).__name__
    return jeng, teng


def port_energy_forces(eng, pos):
    x = torch.as_tensor(pos).requires_grad_(True)
    e = eng.energy_fn(x, torch.as_tensor(BOX))
    (g,) = torch.autograd.grad(e, x)
    return float(e.detach()), -g.numpy()


def central_forces(efn, pos, h=1e-5):
    f = np.zeros_like(pos)
    for i in range(pos.shape[0]):
        for a in range(3):
            pp, pm = pos.copy(), pos.copy()
            pp[i, a] += h
            pm[i, a] -= h
            f[i, a] = -(float(efn(jnp.asarray(pp))) - float(efn(jnp.asarray(pm)))) / (2 * h)
    return f


def assert_close(e, f, e_ref, f_ref, frel=1e-7):
    assert abs(e - e_ref) <= 1e-7 * max(1.0, abs(e_ref)), (e, e_ref)
    assert np.abs(f - f_ref).max() <= frel * max(1.0, np.abs(f_ref).max())


@pytest.mark.parametrize("pme", [False, True], ids=["exact", "pme"])
def test_multipole_ewald_matches_jax(pme):
    """Charges, dipoles and quadrupoles: energies against the JAX energy,
    forces against its central differences (O(h^2) ~ 1e-10 here)."""
    jeng, teng = engines(pme)
    bj = jnp.asarray(BOX)
    efn = jax.jit(lambda p: jeng.energy_fn(p, bj))
    for seed in (0, 1):
        pos = box_positions(seed)
        e, f = port_energy_forces(teng, pos)
        assert_close(e, f, float(efn(jnp.asarray(pos))), central_forces(efn, pos))


@pytest.mark.parametrize("pme", [False, True], ids=["exact", "pme"])
def test_dipole_ewald_forces_match_jax_grad(pme):
    """Without quadrupoles the JAX gradient compiles in seconds: forces
    against jax.grad (1e-7 of the largest)."""
    jeng, teng = engines(pme, quads=False)
    bj = jnp.asarray(BOX)
    pos = box_positions(2)
    ej, gj = jax.jit(jax.value_and_grad(lambda p: jeng.energy_fn(p, bj)))(jnp.asarray(pos))
    e, f = port_energy_forces(teng, pos)
    assert_close(e, f, float(ej), -np.asarray(gj))
    assert teng.kmesh == jeng.kmesh if pme else teng.cfg.kmax == jeng.cfg.kmax


def test_energy_with_moments_is_the_jax_tier_sum():
    """Explicit random moments (the polarization solver's entry point),
    exact engine, charges and dipoles."""
    jeng, teng = engines(False, quads=False)
    rs = np.random.RandomState(3)
    pos = box_positions(3)
    q, mu = rs.randn(6) * 0.3, rs.randn(6, 3) * 0.2
    want = float(jax.jit(lambda p, b, q, m: jeng.energy_with_moments(p, b, q, m, None))(
        jnp.asarray(pos), jnp.asarray(BOX), jnp.asarray(q), jnp.asarray(mu)))
    got = float(teng.energy_with_moments(torch.as_tensor(pos), BOX, torch.as_tensor(q),
                                         torch.as_tensor(mu), None))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("order", [4, 6, 8])
def test_bspline_taps_match_jax(order):
    frac = np.concatenate([[0.0], np.random.RandomState(order).rand(15)])
    want = jew.bspline_weights_d2(jnp.asarray(frac), order)
    x = torch.as_tensor(frac).requires_grad_(True)
    got = tew.bspline_weights_d2(x, order)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=1e-14)
    # d/dfrac of the taps is the next tap set, at the node frac = 0 too
    for k in range(2):
        (d,) = torch.autograd.grad(got[k].sum(), x, retain_graph=True)
        np.testing.assert_allclose(d.numpy(), got[k + 1].detach().sum(-1).numpy(),
                                   rtol=0, atol=1e-13)
    with pytest.raises(ValueError):
        tew.bspline_weights_d2(x, 3)


def test_erf_tensors_f32_against_f64():
    alpha = 0.4
    t = np.linspace(1e-4, 4.0, 4001)
    r2 = t / alpha ** 2
    b64 = tme.b_erf(alpha, torch.as_tensor(r2), 4)
    b32 = tme.b_erf(alpha, torch.as_tensor(r2, dtype=torch.float32), 4)
    for n in range(5):
        rel = np.abs(b32[n].double().numpy() / b64[n].numpy() - 1.0)
        assert rel.max() <= 5e-6, (n, rel.max(), t[rel.argmax()])
    # the series at t -> 0 is the self term's limit
    zero = tme.b_erf(alpha, torch.zeros(1, dtype=torch.float64), 4)
    for n in range(5):
        want = 2 * alpha / np.sqrt(np.pi) * (2 * alpha ** 2) ** n / (2 * n + 1)
        assert float(zero[n]) == pytest.approx(want, rel=1e-15)
    # the control: bare minus erfc in f32 has nothing left at rank 2
    r2t = torch.as_tensor(r2, dtype=torch.float32)
    naive = tme.b_bare(r2t, 4)[2] - tme.b_erfc(alpha, r2t, 4)[2]
    assert np.abs(naive.double().numpy() / b64[2].numpy() - 1.0).max() > 0.5


@pytest.mark.gpu
def test_multipole_pme_on_the_card():
    """f32 on the card against f64 on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, types, bonds = dimer()
    pos = box_positions(4)
    out = {}
    for dev, dt in (("cpu", torch.float64), ("cuda", torch.float32)):
        el, _ = tam.make_amoeba_electrostatics(
            _Ffp(water_mask(2)), types, bonds, tam.parse_tinker_prm(WATER03_PRM),
            cutoff=CUTOFF, mutual=False, ewald=True, box=BOX, ewald_tol=TOL, pme=True,
            device=dev)
        x = torch.as_tensor(pos, dtype=dt, device=dev).requires_grad_(True)
        e = el.multipoles.energy_fn(x, torch.as_tensor(BOX, dtype=dt, device=dev))
        (g,) = torch.autograd.grad(e, x)
        out[dev] = (float(e), g.double().cpu().numpy())
    # the self term (~1e2 kcal/mol per water) sets the f32 rounding scale
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * max(1.0, abs(out["cpu"][0]))
    assert np.abs(out["cuda"][1] - out["cpu"][1]).max() <= 1e-4 * np.abs(out["cpu"][1]).max()
