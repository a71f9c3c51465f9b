"""The PyTorch port's potentials against the JAX package at f64.

Per-term energies and forces of `torchmd_tpu_torch.potentials` (autograd
and the fused analytic path) against `torchmd_tpu.potentials` on the
bundled test systems, fed the same Parameters and positions. Tolerance:
|delta| <= 1e-7 * max(1, |x|) per term, the parity bar of CLAUDE.md.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import ALL_TERMS, load_system
from conftest import DATA_DIR

from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.parameters import Parameters
from torchmd_tpu import potentials as jpot
from torchmd_tpu_torch import potentials as tpot

# one intra-op thread per test process: the suite runs under xdist, and
# a pool of one thread per core in every worker oversubscribes the CPU
torch.set_num_threads(1)

TOL = 1e-7
F64 = torch.float64


CASES = {
    "alanine-nobox": "prod_alanine_dipeptide_amber",
    "alanine-pbc": "prod_alanine_dipeptide_amber",
    "ligand-amber": "ligand-amber",
    "waterbox": "waterbox",
}


def _setup(case):
    """(jax Forces, port FFParams, port config, positions, torch box,
    jax box) of one system; a zero box is no box (None)."""
    folder = os.path.join(DATA_DIR, CASES[case])
    mol, ff, nbconf = load_system(folder)
    if case == "alanine-nobox":
        # input.coor only: the configuration of the golden energy
        from torchmd_tpu.io import Molecule
        from torchmd_tpu.forcefields import ForceField

        mol = Molecule(os.path.join(folder, "structure.prmtop"))
        mol.read(os.path.join(folder, "input.coor"))
        ff = ForceField.create(mol, os.path.join(folder, "structure.prmtop"))
    if case.startswith("alanine"):
        nbconf = dict(cutoff=9.0, switch_dist=7.5, rfa=True)
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    if case == "alanine-nobox":
        # the golden was made with parameters that passed through f32
        # (tests/test_golden.py:35-45)
        for t in (par.bond_params, par.angle_params, par.dihedral_params,
                  par.improper_params, par.nonbonded_14_params,
                  par.nonbonded_params):
            if t is not None and len(t["params"]):
                t["params"] = np.asarray(t["params"], np.float32).astype(np.float64)
    jf = JaxForces(par, terms=ALL_TERMS, precision="double", **nbconf)
    ffp = tpot.make_ffparams(par, dtype=F64)
    cfg = tpot.ForceTermConfig(**jf.config._asdict())
    pos = mol.coords[:, :, 0].astype(np.float64)
    box = mol.box[:, 0].astype(np.float64)
    if not np.any(box != 0):
        return jf, ffp, cfg, pos, None, None
    return jf, ffp, cfg, pos, torch.as_tensor(box), jnp.asarray(box)


def _assert_terms(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= TOL * max(1.0, abs(w)), (k, g, w)


def _assert_forces(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_compute_potentials_and_autograd_forces(case):
    jf, ffp, cfg, pos, tbox, jbox = _setup(case)
    cfg_j = jf.config

    @jax.jit
    def reference(ffp_j, p, b):
        pot = jpot.compute_potentials(ffp_j, p, b, cfg_j)
        grad = jax.grad(lambda q: jpot.total_energy(ffp_j, q, b, cfg_j))(p)
        return pot, -grad

    want, want_f = reference(jf.ffparams, jnp.asarray(pos), jbox)
    got, got_f = tpot.energy_and_forces(ffp, torch.as_tensor(pos), tbox, cfg)
    _assert_terms(got, want)
    _assert_forces(got_f, want_f)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_energy_and_forces(case):
    jf, ffp, cfg, pos, tbox, jbox = _setup(case)
    cfg_j = jf.config
    want, want_f = jax.jit(
        lambda ffp_j, p, b: jpot.energy_and_forces_fused(ffp_j, p, b, cfg_j)
    )(jf.ffparams, jnp.asarray(pos), jbox)
    got, got_f = tpot.energy_and_forces_fused(ffp, torch.as_tensor(pos), tbox, cfg)
    _assert_terms(got, want)
    _assert_forces(got_f, want_f)


@pytest.mark.parametrize("cutoff,rfa,golden", [(9.0, True, -1722.3569),
                                               (None, False, -1768.8915)])
def test_golden_alanine_energy(cutoff, rfa, golden):
    """Alanine dipeptide, all terms, switch 7.5, no box: the upstream
    goldens (tests/test_golden.py) with cutoff 9 + RFA and with neither."""
    _, ffp, cfg, pos, tbox, _ = _setup("alanine-nobox")
    cfg = cfg._replace(cutoff=cutoff, rfa=rfa)
    pot = tpot.compute_potentials(ffp, torch.as_tensor(pos), tbox, cfg)
    assert abs(float(sum(pot.values())) - golden) < 1e-4


def test_term_functions_keep_dtype():
    """Nothing reads torch's default dtype: f32 parameters and positions
    give f32 energies under an f64 default."""
    jf, _, cfg, pos, _, _ = _setup("ligand-amber")
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        ffp = tpot.make_ffparams(jf.par, dtype=torch.float32)
        pot = tpot.compute_potentials(
            ffp, torch.as_tensor(pos, dtype=torch.float32), None, cfg)
    finally:
        torch.set_default_dtype(old)
    assert all(v.dtype == torch.float32 for v in pot.values())
