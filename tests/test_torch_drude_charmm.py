"""The port's CHARMM Drude-2013 ingestion (`torchmd_tpu_torch.drude`:
RTF ALPHA/THOLE tables, LONEPAIR sites, NBTHOLE pairs) against the JAX
package at f64 on the CPU, on the published SWM4-NDP water (Lamoureux et
al., Chem. Phys. Lett. 418, 245 (2006)) read from
tests/data/swm4-ndp/swm4ndp.str.

  - the parsed RTF atom and lone-pair records and `charmm_drude_tables`
    equal to the JAX package's;
  - `lonepair_positions` of bisector, relative and colinear (degenerate
    frame) sites on random hosts within 1e-12 A;
  - lone-pair force transfer: autograd through `constrain_lonepairs`
    against `jax.grad` within 1e-9, the site rows' own gradient 0;
  - NBTHOLE: `charmm_nbthole_pairs` and the Drude spec built from them,
    and their energy, equal to the JAX package's;
  - the 2x2x2 SWM4-NDP lattice under Ewald (`make_drude_ewald`), M sites
    constrained, Drudes relaxed by `scf_drude`: positions within 1e-8 A
    and the molecular dipoles within 1e-8 D of the JAX package's;
  - the planted fault: the M site placed along O->H1 (a relative frame)
    instead of the HOH bisector must miss the model's gas-phase dipole.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from conftest import DATA_DIR

from torchmd_tpu import drude as jdr
from torchmd_tpu.forcefields.ff_charmm import CharmmParameterSet as JaxPrm
from torchmd_tpu.io import Molecule
from torchmd_tpu.potentials import FFParams as JaxFFParams
from torchmd_tpu.potentials import ForceTermConfig as JaxCfg
from torchmd_tpu_torch import drude as tdr
from torchmd_tpu_torch.forcefields.ff_charmm import CharmmParameterSet as TorchPrm
from torchmd_tpu_torch.interop import ffparams_from_numpy, lonepair_spec_from_numpy
from torchmd_tpu_torch.potentials import ForceTermConfig

torch.set_num_threads(1)

STR = os.path.join(DATA_DIR, "swm4-ndp", "swm4ndp.str")
DEBYE = 4.80320425
NBTHOLE_PRM = """* ion-water pair-specific Thole
*
MASS 1 SOD 22.98977
MASS 2 ODW 15.99940

NBTHOLE
SOD    ODW    1.83

END
"""


def _swm4_mol(offsets):
    """One SWM4 water (O, M placeholder, H1, H2) at each offset."""
    mol = Molecule()
    nres = len(offsets)
    mol.numAtoms = 4 * nres
    mol.name = np.array(["OH2", "OM", "H1", "H2"] * nres, dtype=object)
    mol.resname = np.array(["SWM4"] * 4 * nres, dtype=object)
    mol.resid = np.repeat(np.arange(nres), 4)
    r, th = 0.9572, np.deg2rad(104.52)
    base = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                     [r * np.sin(th / 2), 0.0, r * np.cos(th / 2)],
                     [-r * np.sin(th / 2), 0.0, r * np.cos(th / 2)]])
    mol.coords = np.concatenate([base + o for o in offsets])[:, :, None]
    return mol


def test_rtf_records_and_tables_match_jax():
    jp, tp = JaxPrm(STR), TorchPrm(STR)
    assert tp.rtf_atoms == jp.rtf_atoms
    assert tp.rtf_lonepairs == jp.rtf_lonepairs
    assert tp.rtf_atoms[("SWM4", "OH2")]["alpha"] == pytest.approx(0.97825)
    mol = _swm4_mol([[0.0, 0.0, 0.0], [0.0, 0.0, 4.0]])
    want = jdr.charmm_drude_tables(jp, mol)
    got = tdr.charmm_drude_tables(tp, mol)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3] and len(got[3]) == 2


def _random_lonepairs(rs, n=6):
    kinds = [tdr.LP_BISECTOR, tdr.LP_RELATIVE, tdr.LP_COLINEAR] * (n // 3)
    hosts = [rs.choice(12, 3, replace=False) for _ in kinds]
    for h, k in zip(hosts, kinds):
        if k == tdr.LP_COLINEAR:
            h[2] = h[1]                         # the degenerate frame
    return jdr.LonePairSpec(
        kind=jnp.asarray(kinds, jnp.int32), hosts=jnp.asarray(hosts, jnp.int32),
        dist=jnp.asarray(rs.uniform(0.2, 0.8, n)),
        angle=jnp.asarray([0.0 if k == tdr.LP_COLINEAR else a
                           for k, a in zip(kinds, rs.uniform(0.1, 2.5, n))]),
        dihe=jnp.asarray(rs.uniform(-3.0, 3.0, n)), charge=jnp.asarray(rs.randn(n)))


def test_lonepair_positions_match_jax():
    rs = np.random.RandomState(1)
    jspec = _random_lonepairs(rs)
    tspec = lonepair_spec_from_numpy(jax.tree_util.tree_map(np.asarray, jspec))
    pos = rs.uniform(0, 6, (12, 3))
    for box in (None, np.full(3, 5.0)):
        want = np.asarray(jdr.lonepair_positions(
            jspec, jnp.asarray(pos), None if box is None else jnp.asarray(box)))
        got = tdr.lonepair_positions(tspec, torch.as_tensor(pos),
                                     None if box is None else torch.as_tensor(box))
        assert np.abs(got.numpy() - want).max() <= 1e-12


def _pair_energy_fn(q, sites, spec, constrain, xp):
    """Intermolecular Coulomb of constrained positions (the JAX test's
    energy), in numpy-like namespace `xp` (jnp or torch)."""
    def energy(p):
        pc = constrain(spec, sites, p)
        dv = pc[None, :, :] - pc[:, None, :]
        d2 = (dv * dv).sum(-1)
        n = pc.shape[0]
        idx = xp.arange(n)
        mask = ((idx[:, None] // 4) != (idx[None, :] // 4)) & (idx[:, None] < idx[None, :])
        d2 = xp.where(mask, d2, xp.ones_like(d2))
        e = 332.0636 * q[:, None] * q[None, :] * d2 ** -0.5
        return xp.where(mask, e, xp.zeros_like(e)).sum()
    return energy


def test_lonepair_forces_transfer_to_hosts_as_jax():
    jp, tp = JaxPrm(STR), TorchPrm(STR)
    mol = _swm4_mol([[0.0, 0.0, 0.0], [0.3, -0.2, 4.0]])
    _, _, charges, lps = tdr.charmm_drude_tables(tp, mol)
    sites = [lp["site"] for lp in lps]
    jspec = jdr.make_lonepair_spec(jdr.charmm_drude_tables(jp, mol)[3])
    tspec = tdr.make_lonepair_spec(lps, device="cpu")
    pos = mol.coords[:, :, 0] + 0.05 * np.random.RandomState(3).randn(8, 3)
    want = np.asarray(jax.grad(_pair_energy_fn(
        jnp.asarray(charges), jnp.asarray(sites), jspec, jdr.constrain_lonepairs, jnp))(
        jnp.asarray(pos)))
    x = torch.as_tensor(pos).requires_grad_(True)
    e = _pair_energy_fn(torch.as_tensor(charges), sites, tspec, tdr.constrain_lonepairs,
                        torch)(x)
    (got,) = torch.autograd.grad(e, x)
    assert np.abs(got.numpy()[sites]).max() == 0.0      # the sites are not DOFs
    assert np.abs(got.numpy() - want).max() <= 1e-9 * max(1.0, np.abs(want).max())


def test_nbthole_pairs_and_energy_match_jax(tmp_path):
    path = tmp_path / "nbthole.str"
    path.write_text(NBTHOLE_PRM)
    mol = Molecule()
    mol.numAtoms = 3
    mol.atomtype = np.array(["SOD", "ODW", "ODW"], dtype=object)
    mol.name = np.array(["SOD", "OH2", "OH2"], dtype=object)
    mol.resname = np.array(["SOD", "SWM4", "SWM4"], dtype=object)
    want = jdr.charmm_nbthole_pairs(JaxPrm(str(path)), mol)
    got = tdr.charmm_nbthole_pairs(TorchPrm(str(path)), mol)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 3)

    ffp = JaxFFParams(
        charges=jnp.asarray([1.0, 0.0, 0.0]), masses=jnp.asarray([[22.99], [16.0], [16.0]]),
        mapped_atom_types=jnp.zeros(3, jnp.int32), lj_params=jnp.zeros((1, 2)),
        bonds=None, angles=None, dihedrals=None, impropers=None, nb14=None,
        nb_mask=jnp.asarray(~np.eye(3, dtype=bool)))
    alpha = [0.16, 0.98, 0.98]
    jext, jspec = jdr.make_drude_ffparams(ffp, alpha, nbthole_pairs=want)
    text, tspec = tdr.make_drude_ffparams(
        ffparams_from_numpy(jax.tree_util.tree_map(np.asarray, ffp)), alpha,
        nbthole_pairs=got)
    np.testing.assert_array_equal(tspec.nbthole_i.numpy(), np.asarray(jspec.nbthole_i))
    np.testing.assert_allclose(tspec.nbthole_coeff.numpy(), np.asarray(jspec.nbthole_coeff),
                               rtol=1e-15)
    p = np.array(jdr.init_drude_positions(jnp.asarray([[0.0, 0, 0], [2.4, 0.3, 0],
                                                       [-1.1, 2.0, 0.5]]), jspec))
    p[3:] += 0.05 * np.random.RandomState(5).randn(3, 3)
    e_want = float(jdr.nbthole_energy(jspec, jnp.asarray(p), None))
    e_got = float(tdr.nbthole_energy(tspec, torch.as_tensor(p), None))
    assert abs(e_got - e_want) <= 1e-10 * max(1.0, abs(e_want)) and e_want != 0.0


def _relaxed(pkg, prm, coords, L, cutoff, tol):
    """(relaxed extended positions, per-molecule dipoles, induced dipoles
    |q_D d|, both in D) of SWM4-NDP waters at `coords` (O, M placeholder,
    H1, H2 each) in an L A box under Ewald (`make_drude_ewald`)."""
    dr = jdr if pkg == "jax" else tdr
    nres = len(coords) // 4
    mol = _swm4_mol(np.zeros((nres, 3)))
    mol.coords = np.asarray(coords, np.float64)[:, :, None]
    alpha, thole, charges, lps = dr.charmm_drude_tables(prm, mol)
    n = 4 * nres
    intra = np.kron(np.eye(nres, dtype=bool), np.ones((4, 4), bool))
    ffp = JaxFFParams(
        charges=jnp.asarray(charges),
        masses=jnp.asarray(np.tile([15.999, 1e-9, 1.008, 1.008], nres).reshape(-1, 1)),
        mapped_atom_types=jnp.zeros(n, jnp.int32), lj_params=jnp.zeros((1, 2)),
        bonds=None, angles=None, dihedrals=None, impropers=None, nb14=None,
        nb_mask=jnp.asarray(~intra))
    thole_atom = np.where(alpha > 0, thole, np.nan)
    sites = [lp["site"] for lp in lps]
    box = np.full(3, L)
    if pkg == "jax":
        ext, spec = jdr.make_drude_ffparams(ffp, alpha, thole_atom=thole_atom)
        pos = jdr.constrain_lonepairs(jdr.make_lonepair_spec(lps), sites,
                                      jnp.asarray(mol.coords[:, :, 0]))
        recip, aew = jdr.make_drude_ewald(ext, box, cutoff, tol=tol)
        cfg = JaxCfg(terms=("electrostatics", "bonds"), cutoff=cutoff, ewald_alpha=aew)
        r = jdr.scf_drude(ext, spec, cfg, jdr.init_drude_positions(pos, spec),
                          jnp.asarray(box), recip=recip)
        q_ext = np.asarray(ext.charges)
    else:
        ext, spec = tdr.make_drude_ffparams(
            ffparams_from_numpy(jax.tree_util.tree_map(np.asarray, ffp)), alpha,
            thole_atom=thole_atom)
        pos = tdr.constrain_lonepairs(tdr.make_lonepair_spec(lps, device="cpu"), sites,
                                      torch.as_tensor(mol.coords[:, :, 0]))
        recip, aew = tdr.make_drude_ewald(ext, box, cutoff, tol=tol)
        cfg = ForceTermConfig(terms=("electrostatics", "bonds"), cutoff=cutoff, ewald_alpha=aew)
        r = tdr.scf_drude(ext, spec, cfg, tdr.init_drude_positions(pos, spec), box,
                          recip=recip)
        q_ext = ext.charges.numpy()
    r = np.asarray(r)
    mus = [np.linalg.norm(sum(q_ext[i] * (r[i] - r[4 * m])
                              for i in list(range(4 * m, 4 * m + 4)) + [n + m])) * DEBYE
           for m in range(nres)]
    induced = np.abs(q_ext[n:]) * np.linalg.norm(r[n:] - r[0:n:4], axis=1) * DEBYE
    return r, np.asarray(mus), induced


def _lattice_relaxed(pkg, prm):
    """`_relaxed` on the 2x2x2 SWM4-NDP lattice (edge 4 A, box 8 A, cutoff
    3.5 A, Ewald tol 1e-6)."""
    g = np.arange(2) * 4.0 + 1.0
    mol = _swm4_mol(np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3))
    return _relaxed(pkg, prm, mol.coords[:, :, 0], 8.0, 3.5, 1e-6)[:2]


def test_swm4_lattice_scf_matches_jax():
    r_want, mu_want = _lattice_relaxed("jax", JaxPrm(STR))
    r_got, mu_got = _lattice_relaxed("torch", TorchPrm(STR))
    assert np.abs(r_got - r_want).max() <= 1e-8
    assert np.abs(mu_got - mu_want).max() <= 1e-8
    assert np.all(mu_got > 1.86) and np.all(mu_got < 3.2)


def test_swm4_random_box_sets_the_card_witness():
    """chip_smoke.py's randomly oriented SWM4-NDP box cut to n = 6 (216
    waters, 18.64 A, the card box's density, cutoff and Ewald tolerance;
    exact Ewald below PME_AUTO_N particles): the port's relaxed positions
    and dipoles equal the JAX package's, and the JAX package's mean and
    spread of the induced dipoles are the values the card's f64 solve is
    held to (`chip_smoke.SWM4_WITNESS`, which also bounds the card's
    12^3 box)."""
    n, mean, std = chip_smoke.SWM4_WITNESS
    coords = chip_smoke.swm4_coords(n)
    args = (coords, n * chip_smoke.SWM4_L / chip_smoke.SWM4_N, chip_smoke.SWM4_CUTOFF,
            chip_smoke.SWM4_TOL)
    r_want, mu_want, ind_want = _relaxed("jax", JaxPrm(STR), *args)
    r_got, mu_got, ind_got = _relaxed("torch", TorchPrm(STR), *args)
    assert np.abs(r_got - r_want).max() <= 1e-8
    assert np.abs(mu_got - mu_want).max() <= 1e-8
    assert np.abs(ind_got - ind_want).max() <= 1e-8
    assert abs(ind_want.mean() - mean) <= 1e-6 and abs(ind_want.std() - std) <= 1e-6, (
        ind_want.mean(), ind_want.std())


@pytest.mark.parametrize("kind", [tdr.LP_BISECTOR, tdr.LP_RELATIVE])
def test_gas_dipole_and_misplaced_site(kind):
    """SWM4-NDP's charges and M site give its published gas dipole, 1.85
    D; the planted fault (the M site along O->H1) misses it."""
    prm = TorchPrm(STR)
    mol = _swm4_mol([[0.0, 0.0, 0.0]])
    _, _, charges, lps = tdr.charmm_drude_tables(prm, mol)
    spec = tdr.make_lonepair_spec(lps, device="cpu")
    spec = spec._replace(kind=torch.full_like(spec.kind, kind))
    pos = tdr.constrain_lonepairs(spec, [lp["site"] for lp in lps],
                                  torch.as_tensor(mol.coords[:, :, 0]))
    mu = float(np.linalg.norm((charges[:, None] * pos.numpy()).sum(0))) * DEBYE
    if kind == tdr.LP_BISECTOR:
        assert mu == pytest.approx(1.85, abs=0.01)
    else:
        assert abs(mu - 1.85) > 0.05, mu
