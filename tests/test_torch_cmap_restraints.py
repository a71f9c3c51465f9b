"""The port's CMAP, GROMOS-96 bonded forms and restraints against the JAX
package, at f64 on the CPU.

  - the periodic spline derivatives and the bicubic coefficient tables
    of CMAP grids, and the CMAP energy and forces of a 5-atom chain:
    within 1e-9 of `torchmd_tpu.cmap` (forces by autograd against
    jax.value_and_grad);
  - a CMAP table carried by `interop.ffparams_from_numpy`;
  - CMAP through `Forces` (a CHARMM .prm with a CMAP section and the
    chain's topology, the tests/test_cmap.py:216 system) on the kernel
    path (the kernel wrappers' plain versions on the CPU) and the torch-op
    path: per-term energies and forces against the JAX package's Forces;
  - GROMOS-96 bonds and angles (GROMACS funct 2) through `Forces` alike;
  - every restraint class on seeded positions in a box: energies and
    autograd forces within 1e-9 of the JAX classes;
  - the GROMACS position, distance and dihedral restraints through an
    .mdp `define = -DPOSRES` and both CLIs' `setup`: the same restraint
    records, and the external term's energy and forces of both packages'
    Forces within 1e-9; `combine_externals` refuses a source without
    `energy_fn`.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cmap import _chain_pos, _grid, _write_prm
from test_gromacs import DISRES_TOP, G96_TOP, POSRES_TOP, write

from torchmd_tpu import cmap as jcmap
from torchmd_tpu import restraints as jres
from torchmd_tpu import run as jrun
from torchmd_tpu.forcefields import ForceField as JaxForceField
from torchmd_tpu.forcefields.ff_charmm import CharmmForcefield as JaxCharmm
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.io import Molecule as JaxMolecule
from torchmd_tpu.parameters import Parameters as JaxParameters
from torchmd_tpu_torch import cmap as tcmap
from torchmd_tpu_torch import interop
from torchmd_tpu_torch import restraints as tres
from torchmd_tpu_torch import run as trun
from torchmd_tpu_torch.external import TorchExternal, combine_externals
from torchmd_tpu_torch.forcefields import ForceField
from torchmd_tpu_torch.forcefields.ff_charmm import CharmmForcefield
from torchmd_tpu_torch.forces import Forces
from torchmd_tpu_torch.io import Molecule
from torchmd_tpu_torch.parameters import Parameters

torch.set_num_threads(1)

CMAP_TERMS = ["bonds", "angles", "dihedrals", "cmap"]


def _grad(fn, pos):
    """(energy, -grad) of a torch energy of one conformation."""
    p = torch.as_tensor(pos).clone().requires_grad_(True)
    e = fn(p)
    (g,) = torch.autograd.grad(e, p)
    return float(e.detach()), -g.numpy()


def _jgrad(fn, pos):
    e, g = jax.value_and_grad(fn)(jnp.asarray(pos))
    return float(e), -np.asarray(g)


def _close(got, want, tol=1e-9):
    (eg, fg), (ew, fw) = got, want
    assert abs(eg - ew) <= tol * max(1.0, abs(ew)), (eg, ew)
    np.testing.assert_allclose(fg, fw, rtol=0, atol=tol * max(1.0, np.abs(fw).max()))


# ----------------------------------------------------------------------
# CMAP
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 24])
def test_cmap_tables_energy_and_forces_match_jax(n):
    grids = [_grid(n), 0.5 * _grid(n).T]
    np.testing.assert_allclose(tcmap.periodic_spline_derivatives(grids[0], axis=1),
                               jcmap.periodic_spline_derivatives(grids[0], axis=1),
                               rtol=0, atol=1e-12)
    tab_t = tcmap.build_cmap_coeff_table(grids)
    np.testing.assert_allclose(tab_t, jcmap.build_cmap_coeff_table(grids), rtol=0,
                               atol=1e-9)
    idx = np.array([[0, 1, 2, 3, 1, 2, 3, 4], [4, 3, 2, 1, 3, 2, 1, 0]])
    typ = np.array([0, 1])
    jt = jcmap.CMapTable(jnp.asarray(idx), jnp.asarray(typ), jnp.asarray(tab_t))
    tt = tcmap.CMapTable(torch.as_tensor(idx), torch.as_tensor(typ), torch.as_tensor(tab_t))
    rs = np.random.RandomState(n)
    for box in (None, np.array([30.0, 30.0, 30.0])):
        pos = _chain_pos(rs) + (0 if box is None else 28.0)  # across the boundary
        tb = None if box is None else torch.as_tensor(box)
        jb = None if box is None else jnp.asarray(box)
        _close(_grad(lambda p: tcmap.cmap_energy(tt, p, tb), pos),
               _jgrad(lambda p: jcmap.cmap_energy(jt, p, jb), pos))
        np.testing.assert_allclose(
            tcmap.cmap_energy_rows(tt, torch.as_tensor(pos), tb).numpy(),
            np.asarray(jcmap.cmap_energy_rows(jt, jnp.asarray(pos), jb)), atol=1e-9)


def _chain_system(tmp_path, M, FF, P, precision="double"):
    _write_prm(tmp_path / "t.prm", n=8)
    mol = M()
    mol.numAtoms = 5
    mol.atomtype = np.array(["A1"] * 5, dtype=object)
    mol.charge = np.zeros(5)
    mol.masses = np.full(5, 12.011)
    mol.bonds = np.array([[i, i + 1] for i in range(4)])
    mol.angles = np.array([[i, i + 1, i + 2] for i in range(3)])
    mol.dihedrals = np.array([[i, i + 1, i + 2, i + 3] for i in range(2)])
    mol.crossterms = np.array([[0, 1, 2, 3, 1, 2, 3, 4]])
    mol.coords = _chain_pos(np.random.RandomState(11))[:, :, None]
    return mol, P(FF(mol, str(tmp_path / "t.prm")), mol, CMAP_TERMS, precision=precision)


def _forces_match(jf, tf, pos, box=None):
    """Per-term energies and forces of two Forces on one conformation."""
    jd = jf.compute(pos[None], box, returnDetails=True)[0]
    frc_j = np.zeros((1,) + pos.shape)
    jf.compute(pos[None], box, frc_j)
    td = tf.compute(pos[None], box, returnDetails=True)[0]
    assert {k for k, v in jd.items() if v != 0.0} <= set(td)
    for k, v in jd.items():
        assert abs(td.get(k, 0.0) - v) <= 1e-9 * max(1.0, abs(v)), (k, td.get(k), v)
    frc_t = tf.last_forces.numpy()
    np.testing.assert_allclose(frc_t, frc_j, rtol=0, atol=1e-9 * max(1.0, np.abs(frc_j).max()))
    return td


@pytest.mark.parametrize("kernel", ["auto", "dense"])
def test_cmap_through_forces_matches_jax(kernel, tmp_path):
    jmol, jpar = _chain_system(tmp_path, JaxMolecule, JaxCharmm, JaxParameters)
    tmol, tpar = _chain_system(tmp_path, Molecule, CharmmForcefield, Parameters)
    jf = JaxForces(jpar, terms=CMAP_TERMS, precision="double")
    tf = Forces(tpar, terms=CMAP_TERMS, precision="double", device="cpu", kernel=kernel)
    td = _forces_match(jf, tf, jmol.coords[:, :, 0])
    assert td["cmap"] != 0.0 and tf.ffparams.cmap is not None


def test_cmap_table_carried_by_interop(tmp_path):
    _, jpar = _chain_system(tmp_path, JaxMolecule, JaxCharmm, JaxParameters)
    jffp = JaxForces(jpar, terms=CMAP_TERMS, precision="double").ffparams
    tffp = interop.ffparams_from_numpy(jax.tree_util.tree_map(np.asarray, jffp))
    for f in tcmap.CMapTable._fields:
        np.testing.assert_array_equal(getattr(tffp.cmap, f).numpy(),
                                      np.asarray(getattr(jffp.cmap, f)))
    assert tffp.cmap.idx.dtype == torch.int64


@pytest.mark.parametrize("kernel", ["auto", "dense"])
def test_g96_bonds_and_angles_through_forces_match_jax(kernel, tmp_path):
    top = write(tmp_path / "g96.top", G96_TOP)
    pos = np.array([[0.0, 0.0, 0.0], [1.57, 0.0, 0.0], [2.2, 1.4, 0.1]])
    terms = ["bonds", "angles"]
    out = []
    for M, FF, P in ((JaxMolecule, JaxForceField, JaxParameters),
                     (Molecule, ForceField, Parameters)):
        mol = M(top)
        mol.coords = pos[:, :, None]
        out.append(P(FF.create(mol, top), mol, terms, precision="double"))
    jf = JaxForces(out[0], terms=terms, precision="double")
    tf = Forces(out[1], terms=terms, precision="double", device="cpu", kernel=kernel)
    td = _forces_match(jf, tf, pos)
    assert td["bonds"] > 0.0 and td["angles"] > 0.0


# ----------------------------------------------------------------------
# Restraints
# ----------------------------------------------------------------------

def _restraint_pairs(rs, n):
    ref = rs.rand(n, 3) * 20.0
    idx = np.array([0, 3, 5, 8])
    k = rs.uniform(0.5, 2.0, len(idx))
    quads = np.array([[0, 1, 2, 3], [4, 5, 6, 7]])
    pairs = np.array([[0, 9], [2, 7], [4, 5]])
    kvec = rs.rand(len(idx), 3)
    return [
        (jres.HarmonicPositionalRestraint(ref[idx], k, atom_idx=idx),
         tres.HarmonicPositionalRestraint(ref[idx], k, atom_idx=idx)),
        (jres.HarmonicPositionalRestraint(ref, 1.5), tres.HarmonicPositionalRestraint(ref, 1.5)),
        (jres.FlatBottomRestraint(ref[idx], k, 0.3, atom_idx=idx),
         tres.FlatBottomRestraint(ref[idx], k, 0.3, atom_idx=idx)),
        (jres.AnisotropicPositionalRestraint(ref[idx], kvec, atom_idx=idx),
         tres.AnisotropicPositionalRestraint(ref[idx], kvec, atom_idx=idx)),
        (jres.GromacsDistanceRestraint(pairs, [1.0, 3.0, 9.0], [2.0, 4.0, 10.0],
                                       [3.0, 5.0, 11.0], [1.0, 2.0, 0.5]),
         tres.GromacsDistanceRestraint(pairs, [1.0, 3.0, 9.0], [2.0, 4.0, 10.0],
                                       [3.0, 5.0, 11.0], [1.0, 2.0, 0.5])),
        (jres.GromacsDihedralRestraint(quads, [0.5, -2.0], [0.1, 0.2], [3.0, 4.0]),
         tres.GromacsDihedralRestraint(quads, [0.5, -2.0], [0.1, 0.2], [3.0, 4.0])),
    ]


def test_every_restraint_class_matches_jax():
    rs = np.random.RandomState(4)
    n = 10
    cases = _restraint_pairs(rs, n)
    box = np.array([12.0, 13.0, 14.0])
    pos = rs.rand(n, 3) * 20.0
    for jr, tr in cases:
        for b in (None, box):
            tb = None if b is None else torch.as_tensor(b)
            jb = None if b is None else jnp.asarray(b)
            got = _grad(lambda p: tr.energy_fn(p, tb), pos)
            _close(got, _jgrad(lambda p: jr.energy_fn(p, jb), pos))
            assert got[0] > 0.0, type(tr).__name__
    # calculate: the batched protocol
    e, f = cases[0][1].calculate(np.stack([pos, pos]), None)
    assert e.shape == (2,) and f.shape == (2, n, 3)


RESTR_TOP = POSRES_TOP.replace("M 2\n", "M 1\n").replace(
    "  2 AR 1 M AR2 1 0.0 39.95\n",
    "  2 AR 1 M AR2 1 0.0 39.95\n  3 AR 1 M A3 1 0.0 39.95\n  4 AR 1 M A4 1 0.0 39.95\n",
).replace("[ system ]", DISRES_TOP[DISRES_TOP.index("[ distance_restraints ]"):
                                   DISRES_TOP.index("[ system ]")] + "[ system ]")


def test_gromacs_restraints_through_mdp_define_match_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("TMD_GMX_DEFINES", raising=False)
    top = write(tmp_path / "restr.top", RESTR_TOP)
    mol = JaxMolecule(top)
    mol.coords = np.array([[1.0, 2.0, 3.0], [4.6, 2.0, 3.0], [1.0, 5.0, 3.0],
                           [6.0, 5.5, 4.0]])[:, :, None]
    mol.box = np.full((3, 1), 30.0)
    gro = str(tmp_path / "c.gro")
    mol.write(gro)
    mdp = write(tmp_path / "pr.mdp", "integrator = md\ndt = 0.001\nnsteps = 10\n"
                "define = -DPOSRES\ndisre-fc = 800\n")
    argv = ["--conf", mdp, "--topology", top, "--coordinates", gro, "--forcefield", top,
            "--forceterms", "lj", "--precision", "double", "--device", "cpu"]
    _, jsys, jf = jrun.setup(jrun.get_args(argv + ["--log-dir", str(tmp_path / "j")]))
    _, tsys, tf = trun.setup(trun.get_args(argv + ["--log-dir", str(tmp_path / "t")]))
    assert "TMD_GMX_DEFINES" not in os.environ
    for k in ("gmx_posres", "gmx_distres", "gmx_dihres"):
        assert getattr(tf.par, k) and np.allclose(getattr(tf.par, k), getattr(jf.par, k))
    moved = np.asarray(jsys.pos, np.float64) + np.random.RandomState(3).randn(1, 4, 3) * 0.5
    td = _forces_match(jf, tf, moved[0], jsys.box)
    assert td["external"] > 0.0
    # without the define: no position restraints
    argv0 = [a for a in argv if a not in ("--conf", mdp)]
    _, _, tf0 = trun.setup(trun.get_args(argv0 + ["--log-dir", str(tmp_path / "t0")]))
    assert tf0.par.gmx_posres == []


def test_combine_externals_sums_and_refuses_host_sources():
    rs = np.random.RandomState(8)
    ref = rs.rand(6, 3)
    a = tres.HarmonicPositionalRestraint(ref, 2.0)
    b = TorchExternal(lambda p, box: (p ** 2).sum() * 0.1)
    both = combine_externals([a, b])
    pos = torch.as_tensor(rs.rand(6, 3))
    e, f = both.energy_forces_fn(pos, None)
    ea, fa = _grad(lambda p: a.energy_fn(p, None), pos.numpy())
    eb, fb = _grad(lambda p: b.energy_fn(p, None), pos.numpy())
    assert float(e) == pytest.approx(ea + eb, rel=1e-14)
    np.testing.assert_allclose(f.numpy(), fa + fb, atol=1e-14)

    class HostOnly:
        def calculate(self, pos, box):
            raise AssertionError

    with pytest.raises(NotImplementedError, match="energy_fn"):
        combine_externals([a, HostOnly()])


@pytest.mark.gpu
def test_cmap_and_restraints_on_the_card(tmp_path):
    """CMAP through Forces on the card (f32, the bonded kernel plus CMAP by
    autograd) and a restraint's energy and forces on the card, against
    f64 on the CPU at the Pallas bars (tests/test_pallas.py:51-57)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torchmd_tpu_torch.external import external_ef

    mol, p32 = _chain_system(tmp_path, Molecule, CharmmForcefield, Parameters, "single")
    _, p64 = _chain_system(tmp_path, Molecule, CharmmForcefield, Parameters)
    fc = Forces(p32, terms=CMAP_TERMS, precision="single", device="cuda")
    fh = Forces(p64, terms=CMAP_TERMS, precision="double", device="cpu")
    assert fc.path == "kernels"
    pos = mol.coords[:, :, 0][None]
    dc, dh = fc.compute(pos, None, returnDetails=True)[0], fh.compute(pos, None,
                                                                     returnDetails=True)[0]
    for k, v in dh.items():
        assert abs(dc[k] - v) <= 2e-5 * max(1.0, abs(v)), (k, dc[k], v)
    Fc, Fh = fc.last_forces.cpu().double(), fh.last_forces
    assert float((Fc - Fh).abs().max()) <= 5e-5 * max(1.0, float(Fh.abs().max()))

    rs = np.random.RandomState(2)
    ref, x = rs.rand(40, 3) * 10.0, rs.rand(40, 3) * 10.0
    r = tres.FlatBottomRestraint(ref, 1.5, 0.5)
    ef = external_ef(r)
    e32, f32 = ef(torch.as_tensor(x, dtype=torch.float32, device="cuda"), None)
    e64, f64 = ef(torch.as_tensor(x), None)
    assert abs(float(e32) - float(e64)) <= 2e-5 * max(1.0, abs(float(e64)))
    assert float((f32.cpu().double() - f64).abs().max()) <= 5e-5 * max(
        1.0, float(f64.abs().max()))
