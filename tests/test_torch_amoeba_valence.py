"""The port's AMOEBA valence terms (`torchmd_tpu_torch.amoeba_valence`)
against the JAX package at f64.

Every form on the parameter blocks of tests/test_amoeba_valence.py
(copied here, not imported): the water03 bond, angle and Urey-Bradley
expansions, torsions with 0-wildcards, the out-of-plane bend,
stretch-bend and pi-torsion of an sp2 fragment, and torsion-torsion
grids under forward and reversed keys. The same positions (a seeded
jitter of each test geometry) go through `AmoebaValence.energy_fn` of
both packages: energies within 1e-7 relative, forces (autograd against
jax.grad) within 1e-7 of the largest. The parsed tables and derived
instances equal the JAX ones.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmd_tpu import amoeba_valence as jval
from torchmd_tpu_torch import amoeba_valence as tval

torch.set_num_threads(1)

WATER03_VALENCE = """
bond-cubic              -2.55
bond-quartic            3.793125
angle-cubic             -0.014
angle-quartic           0.000056
angle-pentic            -0.0000007
angle-sextic            0.000000022

atom          1    1    O     "AMOEBA Water O"               8    15.995    2
atom          2    2    H     "AMOEBA Water H"               1     1.008    1

bond          1    2          529.60     0.9572
angle         2    1    2      34.05     108.50
ureybrad      2    1    2      38.25     1.5537
"""

TORSION_PRM = """
torsionunit             0.5

atom          1    1    C     "sp3 carbon"      6    12.011    4

torsion       1    1    1    1      1.50   0.0  1   0.80 180.0  2   0.30   0.0  3
"""

OPBEND_PRM = """
opbend-cubic            -0.014
opbend-quartic          0.000056

atom          1    1    C     "sp2 carbon"      6    12.011    3
atom          2    2    H     "H on sp2 C"      1     1.008    1

opbend        2    1    0    0            14.40
strbnd        2    1    2            5.50   5.50
bond          1    2          370.00     1.09
angle         2    1    2      35.00     120.00
pitors        1    1           6.85
"""

TT_EXTRA = ('\natom          2    2    N     "head"      7    14.007    3'
            '\natom          3    3    O     "tail"      8    15.999    1\n')


def _tortors_prm(fn, n=12, key="1    1    1    1    1"):
    """A TINKER-style (n+1) x (n+1) tortors table of fn(phi, psi) (deg)."""
    h = 360.0 / n
    lines = ["tortorunit              1.0", "",
             'atom          1    1    C     "chain atom"      6    12.011    4', "",
             f"tortors       {key}       {n + 1}  {n + 1}"]
    for i in range(n + 1):
        for j in range(n + 1):
            x, y = -180.0 + i * h, -180.0 + j * h
            lines.append(f"  {x:.1f} {y:.1f} {fn(x, y):.10f}")
    return "\n".join(lines)


def _surface(x_deg, y_deg):
    x, y = np.deg2rad(x_deg), np.deg2rad(y_deg)
    return np.cos(x) + 0.25 * np.sin(y) + 0.1 * np.cos(x + 2 * y)


def _chain(phi, psi):
    pos = np.zeros((5, 3))
    pos[1], pos[2], pos[3] = [0.0, 0.0, 1.5], [0.0, 1.0, 2.5], [0.0, 1.0, 4.0]
    pos[0] = pos[1] + [np.sin(phi), -np.cos(phi), -1.0]
    pos[4] = pos[3] + [np.sin(psi), np.cos(psi), 1.0]
    return pos


def _water():
    th, r = np.deg2rad(108.5), 0.9572
    return np.asarray([[0.0, 0.0, 0.0], [r * np.sin(th / 2), 0.0, r * np.cos(th / 2)],
                       [-r * np.sin(th / 2), 0.0, r * np.cos(th / 2)]])


def _sp2():
    r0, c, s = 1.09, np.cos(np.pi / 3), np.sin(np.pi / 3)
    return np.asarray([[0.0, 0.0, 0.0], [1.33, 0.0, 0.0], [-r0 * c, r0 * s, 0.0],
                       [-r0 * c, -r0 * s, 0.0], [1.33 + r0 * c, r0 * s, 0.02],
                       [1.33 + r0 * c, -r0 * s, -0.03]])


CASES = {
    # name: (prm text, types, bonds, positions)
    "water": (WATER03_VALENCE, [1, 2, 2], [[0, 1], [0, 2]], _water()),
    "torsion": (TORSION_PRM, [1, 1, 1, 1], [[0, 1], [1, 2], [2, 3]],
                np.asarray([[1.0, 0.0, -1.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.5],
                            [0.5, 0.5, 2.5]])),
    "torsion_wildcard": (TORSION_PRM.replace("torsion       1    1    1    1",
                                             "torsion       0    1    1    0"),
                         [1, 1, 1, 1], [[0, 1], [1, 2], [2, 3]],
                         np.asarray([[1.0, 0.0, -1.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.5],
                                     [0.5, 0.5, 2.5]])),
    "opbend_strbnd": (OPBEND_PRM, [1, 2, 2, 2], [[0, 1], [0, 2], [0, 3]], _sp2()[[0, 1, 2, 3]]),
    "pitors": (OPBEND_PRM + "\nbond 1 1  600.0  1.33\n", [1, 1, 2, 2, 2, 2],
               [[0, 1], [0, 2], [0, 3], [1, 4], [1, 5]], _sp2()),
    "tortors": (_tortors_prm(_surface, n=24), [1] * 5, [[0, 1], [1, 2], [2, 3], [3, 4]],
                _chain(np.deg2rad(67.3), np.deg2rad(-141.8))),
    "tortors_reversed": (_tortors_prm(lambda x, y: _surface(y, x), n=12,
                                      key="3    1    1    1    2") + TT_EXTRA,
                         [2, 1, 1, 1, 3], [[0, 1], [1, 2], [2, 3], [3, 4]],
                         _chain(np.deg2rad(55.0), np.deg2rad(-120.0))),
}


def _jitter(pos, seed, scale=0.04):
    return pos + scale * np.random.RandomState(seed).randn(*pos.shape)


@pytest.mark.parametrize("name", sorted(CASES))
def test_valence_matches_jax(name):
    prm, types, bonds, pos0 = CASES[name]
    jpot = jval.AmoebaValence(prm, types, bonds)
    tpot = tval.make_amoeba_valence(prm, types, bonds, device="cpu")
    for seed in (0, 1):
        pos = _jitter(pos0, seed)
        ej, gj = jax.value_and_grad(jpot.energy_fn)(jnp.asarray(pos))
        x = torch.as_tensor(pos).requires_grad_(True)
        et = tpot.energy_fn(x)
        (gt,) = torch.autograd.grad(et, x)
        ej, gj = float(ej), np.asarray(gj)
        et = float(et.detach())
        assert abs(et - ej) <= 1e-7 * max(1.0, abs(ej)), (name, et, ej)
        assert np.abs(gt.numpy() - gj).max() <= 1e-7 * max(1.0, np.abs(gj).max()), name
    # every table the case exercises is present in both
    for k in ("_bonds", "_angles", "_ureys", "_strbnd", "_opbend", "_torsions", "_pitors",
              "_tortors"):
        assert (getattr(jpot, k) is None) == (getattr(tpot, k) is None), (name, k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_valence_tables_match_jax(name):
    prm, types, bonds, _ = CASES[name]
    jv, tv = jval.parse_tinker_valence(prm), tval.parse_tinker_valence(prm)
    assert jv["scales"] == tv["scales"]
    for k in ("bond", "angle", "ureybrad", "opbend", "strbnd", "torsion", "pitors"):
        assert jv[k] == tv[k], k
    assert jv["tortors"].keys() == tv["tortors"].keys()
    for k in jv["tortors"]:
        np.testing.assert_array_equal(tv["tortors"][k], jv["tortors"][k])
    n = len(types)
    for a, b in zip(jval.derive_valence_instances(n, bonds),
                    tval.derive_valence_instances(n, bonds)):
        assert a == b
    jpot = jval.AmoebaValence(prm, types, bonds)
    tpot = tval.AmoebaValence(prm, types, bonds, device="cpu")
    for k in ("_bonds", "_angles", "_ureys", "_strbnd", "_opbend", "_torsions", "_pitors"):
        if getattr(jpot, k) is not None:
            for want, got in zip(getattr(jpot, k), getattr(tpot, k)):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_valence_masses_select_theta0():
    """Multi-theta0 angle records pick by the hydrogens on the centre
    outside the angle; explicit masses override the .prm's."""
    prm = WATER03_VALENCE.replace("34.05     108.50", "34.05     108.50  107.0  106.0")
    types, bonds = [1, 2, 2], [[0, 1], [0, 2]]
    pos = _jitter(_water(), 3)
    for masses in (None, [15.995, 12.0, 12.0]):
        jpot = jval.make_amoeba_valence(prm, types, bonds, masses=masses)
        tpot = tval.make_amoeba_valence(prm, types, bonds, masses=masses, device="cpu")
        np.testing.assert_array_equal(tpot._angles[1].numpy(), np.asarray(jpot._angles[1]))
        assert float(tpot.energy_fn(torch.as_tensor(pos))) == pytest.approx(
            float(jpot.energy_fn(jnp.asarray(pos))), rel=1e-12)


def test_valence_calculate_is_batched():
    prm, types, bonds, pos0 = CASES["pitors"]
    tpot = tval.AmoebaValence(prm, types, bonds, device="cpu")
    pos = np.stack([_jitter(pos0, 5), _jitter(pos0, 6)])
    e, f = tpot.calculate(pos)
    assert e.shape == (2,) and f.shape == (2, 6, 3)
    x = torch.as_tensor(pos[1]).requires_grad_(True)
    (g,) = torch.autograd.grad(tpot.energy_fn(x), x)
    np.testing.assert_allclose(f[1].numpy(), -g.numpy(), rtol=0, atol=1e-14)


@pytest.mark.gpu
def test_valence_on_the_card():
    """f32 on the card against f64 on the CPU, every case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, (prm, types, bonds, pos0) in CASES.items():
        pos = _jitter(pos0, 7)
        out = {}
        for dev, dt in (("cpu", torch.float64), ("cuda", torch.float32)):
            pot = tval.AmoebaValence(prm, types, bonds, device=dev)
            x = torch.as_tensor(pos, dtype=dt, device=dev).requires_grad_(True)
            e = pot.energy_fn(x)
            (g,) = torch.autograd.grad(e, x)
            out[dev] = (float(e), g.double().cpu().numpy())
        ref = out["cpu"]
        assert abs(out["cuda"][0] - ref[0]) <= 1e-4 * max(1.0, abs(ref[0])), name
        assert np.abs(out["cuda"][1] - ref[1]).max() <= 1e-4 * max(1.0, np.abs(ref[1]).max())
