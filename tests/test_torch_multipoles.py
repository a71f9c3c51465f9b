"""The port's permanent multipoles (`torchmd_tpu_torch.multipoles`) against
the JAX package at f64, on the AMOEBA water dimer.

The water03 multipole records (copied from tests/test_amoeba.py) give
bisector frames on O and z-then-x frames on H; a seeded jitter of the
dimer (and of a third, lab-frame site) goes through both packages:

  - parsed records, per-site specs and the lab frames, dipoles and
    quadrupoles (under a box, so the frame vectors wrap) equal the JAX
    ones to 1e-12;
  - `Multipoles.energy_fn` (charge-dipole, dipole-dipole and the three
    quadrupole tiers) without a cutoff, with a cutoff, and with a cutoff
    and the cubic switch: energies within 1e-7 relative, forces
    (autograd against jax.grad, frame torques included) within 1e-7 of
    the largest; the JAX spec handed over (`multipole_spec_from_numpy`)
    gives the same numbers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmd_tpu import amoeba as jam
from torchmd_tpu import multipoles as jmp
from torchmd_tpu.potentials import FFParams as JaxFFParams
from torchmd_tpu_torch import amoeba as tam
from torchmd_tpu_torch import interop
from torchmd_tpu_torch import multipoles as tmp

torch.set_num_threads(1)

WATER03_PRM = """
atom          1    1    O     "AMOEBA Water O"               8    15.995    2
atom          2    2    H     "AMOEBA Water H"               1     1.008    1

multipole     1   -2   -2              -0.51966
                                        0.00000    0.00000    0.14279
                                        0.37928
                                        0.00000   -0.41809
                                        0.00000    0.00000    0.03881
multipole     2    1    2               0.25983
                                       -0.03859    0.00000   -0.05818
                                       -0.03673
                                        0.00000   -0.10739
                                       -0.00203    0.00000    0.14412

polarize      1           0.8370     0.3900       2
polarize      2           0.4960     0.3900       1
"""

WATER_DIMER_XYZ = """6  water dimer (near the hydrogen-bonded minimum)
 1  O      0.000000    0.000000    0.000000     1     2     3
 2  H      0.757000    0.000000    0.586000     2     1
 3  H     -0.757000    0.000000    0.586000     2     1
 4  O      0.000000    0.000000    2.900000     1     5     6
 5  H      0.757000    0.000000    3.486000     2     4
 6  H     -0.757000    0.000000    3.486000     2     4
"""


class _Ffp:
    """The two FFParams fields the multipole factories read."""

    def __init__(self, mask):
        self.nb_mask = torch.as_tensor(mask)
        self.charges = torch.zeros(mask.shape[0], dtype=torch.float64)


def water_mask(nwater, extra=0):
    """Nonbonded mask of `nwater` waters (intramolecular pairs excluded)
    and `extra` free atoms."""
    n = 3 * nwater + extra
    mask = ~np.eye(n, dtype=bool)
    for m in range(0, 3 * nwater, 3):
        mask[m:m + 3, m:m + 3] = False
    return mask


def jax_ffparams(mask):
    n = mask.shape[0]
    return JaxFFParams(charges=jnp.zeros(n), masses=jnp.ones((n, 1)),
                       mapped_atom_types=jnp.zeros(n, jnp.int32), lj_params=None,
                       bonds=None, angles=None, dihedrals=None, impropers=None,
                       nb14=None, nb_mask=jnp.asarray(mask))


def dimer(seed=0, scale=0.05):
    coords, types, bonds, _ = jam.read_tinker_xyz(WATER_DIMER_XYZ)
    return coords + scale * np.random.RandomState(seed).randn(*coords.shape), types, bonds


def both_multipoles(**kw):
    """(JAX Multipoles, port Multipoles) of the dimer from the .prm."""
    _, types, bonds = dimer()
    mask = water_mask(2)
    jrec = jam.parse_tinker_prm(WATER03_PRM)["multipoles"]
    trec = tam.parse_tinker_prm(WATER03_PRM)["multipoles"]
    jm, jq = jam.make_amoeba_multipoles(jax_ffparams(mask), types, bonds, jrec, **kw)
    tm, tq = tam.make_amoeba_multipoles(_Ffp(mask), types, bonds, trec, device="cpu", **kw)
    np.testing.assert_array_equal(tq, jq)
    return jm, tm


def compare(jobj, tobj, pos, box=None, rel=1e-7):
    jb = None if box is None else jnp.asarray(box)
    tb = None if box is None else torch.as_tensor(box)
    ej, gj = jax.value_and_grad(lambda x: jobj.energy_fn(x, jb))(jnp.asarray(pos))
    x = torch.as_tensor(pos).requires_grad_(True)
    et = tobj.energy_fn(x, tb)
    (gt,) = torch.autograd.grad(et, x)
    ej, gj = float(ej), np.asarray(gj)
    assert abs(float(et.detach()) - ej) <= rel * max(1.0, abs(ej)), (float(et.detach()), ej)
    assert np.abs(gt.numpy() - gj).max() <= rel * max(1.0, np.abs(gj).max())
    return ej


def test_parse_records_match_jax():
    jr, tr = jmp.parse_tinker_multipoles(WATER03_PRM), tmp.parse_tinker_multipoles(WATER03_PRM)
    assert jr.keys() == tr.keys()
    for k in jr:
        for f in ("monopole", "frame", "z_type", "x_type"):
            assert jr[k][f] == tr[k][f]
        np.testing.assert_array_equal(tr[k]["dipole"], jr[k]["dipole"])
        np.testing.assert_array_equal(tr[k]["quad"], jr[k]["quad"])
    _, types, bonds = dimer()
    jf = jam.resolve_frames(types, bonds, jam.parse_tinker_prm(WATER03_PRM)["multipoles"])
    tf = tam.resolve_frames(types, bonds, tam.parse_tinker_prm(WATER03_PRM)["multipoles"])
    for a, b in zip(jf, tf):
        assert {k: a[k] for k in ("atom", "frame", "z", "x", "type")} == \
            {k: b[k] for k in ("atom", "frame", "z", "x", "type")}


def test_spec_and_lab_moments_match_jax():
    jm, tm = both_multipoles()
    for f in ("sites", "mu_local", "frame_kind", "z_atom", "x_atom", "quad_local", "nb_mask"):
        np.testing.assert_array_equal(getattr(tm.spec, f).numpy(),
                                      np.asarray(getattr(jm.spec, f)), err_msg=f)
    L = 7.0   # the dimer across the box faces: frame vectors wrap
    box = np.full(3, L)
    for seed in (1, 2):
        pos = dimer(seed)[0] + np.array([3.2, 3.3, 5.4])
        pos = pos - L * np.floor(pos / L)
        for fn in ("lab_frames", "lab_dipoles", "lab_quadrupoles"):
            want = np.asarray(getattr(jmp, fn)(jm.spec, jnp.asarray(pos), jnp.asarray(box)))
            got = getattr(tmp, fn)(tm.spec, torch.as_tensor(pos), torch.as_tensor(box)).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=fn)


@pytest.mark.parametrize("kw", [dict(), dict(cutoff=3.2), dict(cutoff=3.2, switch_dist=2.4)],
                         ids=["no-cutoff", "cutoff", "switch"])
def test_multipole_energy_and_forces_match_jax(kw):
    jm, tm = both_multipoles(**kw)
    for seed in (3, 4):
        compare(jm, tm, dimer(seed, 0.08)[0])


def test_lab_frame_site_and_dipole_only_spec():
    """A third, lab-frame site with a literal dipole beside the dimer, no
    quadrupoles (the dipole-only tiers), from make_multipoles directly;
    also handed over from the JAX spec."""
    pos, types, bonds = dimer(5)
    pos = np.concatenate([pos, [[2.0, 1.5, 1.3]]])
    mask = water_mask(2, extra=1)
    rec = tam.resolve_frames(types, bonds, tam.parse_tinker_prm(WATER03_PRM)["multipoles"])
    dip = [{"atom": f["atom"], "mu": np.asarray(f["dipole"]) * tam.BOHR, "frame": f["frame"],
            "z": f["z"], "x": f["x"]} for f in rec]
    dip.append({"atom": 6, "mu": [0.1, -0.2, 0.3]})
    q = np.array([-0.5, 0.25, 0.25, -0.5, 0.25, 0.25, 0.3])
    jm = jmp.make_multipoles(jax_ffparams(mask), dip, cutoff=4.0, switch_dist=3.0,
                             charges=q)
    tm = tmp.make_multipoles(_Ffp(mask), dip, cutoff=4.0, switch_dist=3.0, charges=q,
                             device="cpu")
    assert tm.spec.quad_local is None and jm.spec.quad_local is None
    e = compare(jm, tm, pos)
    spec = interop.multipole_spec_from_numpy(jax.tree_util.tree_map(np.asarray, jm.spec))
    assert float(tmp.Multipoles(spec, q).energy_fn(torch.as_tensor(pos))) == \
        pytest.approx(e, rel=1e-12)


def test_make_multipoles_rejects_what_jax_rejects():
    mask = water_mask(1)
    ffp = _Ffp(mask)
    bad = [
        [{"atom": 0, "mu": [0.0, 0.0, 0.1], "frame": "z-then-x"}],             # no z
        [{"atom": 0, "frame": "bisector", "z": 1}],                            # no x
        [{"atom": 0, "mu": [0.1, 0.0, 0.0], "frame": "z-then-x", "z": 1}],     # transverse
        [{"atom": 0, "quad": np.diag([1.0, 1.0, 1.0])}],                       # trace
    ]
    for dip in bad:
        with pytest.raises(ValueError):
            jmp.make_multipoles(jax_ffparams(mask), dip)
        with pytest.raises(ValueError):
            tmp.make_multipoles(ffp, dip, device="cpu")
    with pytest.raises(ValueError):
        tmp.make_multipoles(ffp, [{"atom": 0}], switch_dist=2.0, device="cpu")


@pytest.mark.gpu
def test_multipoles_on_the_card():
    """f32 on the card against f64 on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pos, types, bonds = dimer(6)
    rec = tam.parse_tinker_prm(WATER03_PRM)["multipoles"]
    out = {}
    for dev, dt in (("cpu", torch.float64), ("cuda", torch.float32)):
        m, _ = tam.make_amoeba_multipoles(_Ffp(water_mask(2)), types, bonds, rec,
                                          cutoff=3.2, switch_dist=2.4, device=dev)
        x = torch.as_tensor(pos, dtype=dt, device=dev).requires_grad_(True)
        e = m.energy_fn(x)
        (g,) = torch.autograd.grad(e, x)
        out[dev] = (float(e), g.double().cpu().numpy())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * max(1.0, abs(out["cpu"][0]))
    assert np.abs(out["cuda"][1] - out["cpu"][1]).max() <= 1e-5 * np.abs(out["cpu"][1]).max()
