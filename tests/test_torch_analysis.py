"""The port's trajectory analysis (`torchmd_tpu_torch.analysis`) against
the JAX package at f64 on the CPU: Kabsch rotations, RMSD, RDF (full and
partial selections), MSD, group interaction energies and normal modes
(a four-atom torsion's bonded terms: the mass-weighted Hessian's
eigenvalues within 1e-9 of the largest), and the analysis CLI's CSVs against the JAX CLI's
(1e-12).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from common import ALL_TERMS, load_system
from conftest import DATA_DIR

from torchmd_tpu import analysis as jan
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.parameters import Parameters
from torchmd_tpu_torch import Forces
from torchmd_tpu_torch import analysis as tan

torch.set_num_threads(1)


def _traj(natoms=24, nframes=6, seed=0, L=12.0):
    rs = np.random.RandomState(seed)
    x = rs.rand(natoms, 3) * L
    steps = 0.3 * rs.randn(nframes, natoms, 3)
    return np.cumsum(steps, axis=0) + x[None]     # (nframes, natoms, 3)


def test_kabsch_and_rmsd_match_jax():
    rs = np.random.RandomState(1)
    P, Q = rs.randn(10, 3), rs.randn(10, 3)
    np.testing.assert_allclose(tan.kabsch_rotation(P, Q), jan.kabsch_rotation(P, Q),
                               rtol=0, atol=1e-14)
    traj = _traj()
    w = rs.rand(24) + 0.5
    for kw in (dict(), dict(weights=w), dict(align=False), dict(sel=np.arange(5, 15)),
               dict(ref=traj[3])):
        np.testing.assert_allclose(tan.rmsd(traj, **kw), jan.rmsd(traj, **kw),
                                   rtol=1e-12, atol=1e-12)
    # the run loop's layout (natoms, 3, nframes)
    np.testing.assert_allclose(tan.rmsd(np.transpose(traj, (1, 2, 0))),
                               jan.rmsd(traj), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sel", [None, "partial"])
def test_rdf_and_msd_match_jax(sel):
    traj = _traj(natoms=40, nframes=4, seed=2)
    kw = {} if sel is None else dict(sel_a=np.arange(10), sel_b=np.arange(5, 40))
    r_j, g_j = jan.rdf(traj, [12.0, 12.0, 12.0], nbins=40, **kw)
    r_t, g_t = tan.rdf(traj, [12.0, 12.0, 12.0], nbins=40, device="cpu", **kw)
    np.testing.assert_allclose(r_t, r_j, rtol=1e-14)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tan.msd(traj, device="cpu"), jan.msd(traj), rtol=1e-12)
    np.testing.assert_allclose(tan.msd(traj, sel=np.arange(7), device="cpu"),
                               jan.msd(traj, sel=np.arange(7)), rtol=1e-12)


def _ligand():
    mol, ff, _ = load_system(os.path.join(DATA_DIR, "ligand-amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    return mol, par


def test_interaction_energies_match_jax():
    mol, par = _ligand()
    kw = dict(terms=ALL_TERMS, precision="double", cutoff=9.0)
    jf, tf = JaxForces(par, **kw), Forces(par, device="cpu", **kw)
    pos = mol.coords[:, :, 0]
    for sel_b in (None, np.arange(30, 52)):
        want = jan.interaction_energies(jf, pos, sel_a=np.arange(20), sel_b=sel_b)
        got = tan.interaction_energies(tf, pos, sel_a=np.arange(20), sel_b=sel_b)
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-10, abs=1e-10)


def test_normal_modes_match_jax():
    """A four-atom torsion (tests/data/singledihedral) with its bonded
    terms (the JAX package's Hessian of every term compiles for ~17 s on
    a CPU even at this size; the nonbonded energies it would add are held
    to the JAX package's elsewhere): the mass-weighted Hessian's
    eigenvalues as
    signed squared wavenumbers within 1e-9 of the largest (the six
    near-zero rigid-body modes sit at the rounding floor, where a
    wavenumber's square root magnifies it)."""
    mol, ff, _ = load_system(os.path.join(DATA_DIR, "singledihedral"))
    terms = ["bonds", "angles", "dihedrals"]
    par = Parameters(ff, mol, terms, precision="double")
    kw = dict(terms=terms, precision="double")
    pos = mol.coords[:, :, 0]
    nu_j, modes_j = jan.normal_modes(JaxForces(par, **kw), pos)
    nu_t, modes_t = tan.normal_modes(Forces(par, device="cpu", **kw), pos)
    lam_j, lam_t = nu_j * np.abs(nu_j), nu_t * np.abs(nu_t)
    assert np.abs(lam_t - lam_j).max() <= 1e-9 * np.abs(lam_j).max()
    # eigenvectors up to sign, for the well separated high modes
    for k in range(-3, 0):
        dot = float((modes_t[k] * modes_j[k]).sum()) / float((modes_j[k] ** 2).sum())
        assert abs(abs(dot) - 1.0) <= 1e-6


def test_analysis_cli_matches_jax(tmp_path):
    traj = np.transpose(_traj(natoms=12, nframes=5, seed=3), (1, 2, 0))
    np.save(tmp_path / "output_0.npy", traj)
    for mod, tag, extra in ((jan, "j", []), (tan, "t", ["--device", "cpu"])):
        mod.main([str(tmp_path), "--traj", "output_0.npy",
                  "--rmsd", str(tmp_path / f"{tag}_r.csv"),
                  "--msd", str(tmp_path / f"{tag}_m.csv"),
                  "--rdf", str(tmp_path / f"{tag}_g.csv"), "--box", "12.0",
                  "--rdf-bins", "20"] + extra)
    for name in ("r", "m", "g"):
        want = np.loadtxt(tmp_path / f"j_{name}.csv", delimiter=",", skiprows=1)
        got = np.loadtxt(tmp_path / f"t_{name}.csv", delimiter=",", skiprows=1)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
