"""The port's Drude oscillators (`torchmd_tpu_torch.drude`) against the
JAX package at f64 on the CPU.

  - `make_drude_ffparams` / `make_drude`: every array of the extended
    FFParams and every DrudeSpec field equal to the JAX package's, on a
    16-atom polarizable gas (bonded pairs: Thole; NBTHOLE pairs), alanine
    dipeptide with heavy-atom alpha (bonded-neighbour Thole pairs, 1-4 on
    the shifted core charges) and the YAML-polarizable argon;
  - per-term energies (1e-7 relative) and forces (1e-8 of max |F|) of
    the evaluator `drude_energy_forces` and the total of `drude_energy`,
    against JAX's `compute_potentials` + Thole + NBTHOLE + reciprocal
    and `jax.grad` of `drude_energy`: the gas (open boundary), an 8-atom
    Ewald box (the exact sum) and the same box on PME (pme=True, the
    exact gather), Drudes displaced and on their cores;
  - `scf_drude`: the same iteration count and positions within 1e-9 A
    (with damping 0.5: the same positions in more iterations);
  - `DrudeIntegrator`, 20 steps with both packages' normal draws patched
    to the same values: positions within 1e-8 A, `step()`'s tuple within
    1e-10; a JAX run handed to the port after 10 steps
    (`interop.drude_state_from_numpy`) continues identically;
  - planted faults that must fail: the centre-of-mass and relative kicks
    swapped, and the Drude charge's sign flipped;
  - on the card (`gpu`): kernels #1 and #3 on an extended system against
    their plain versions at the Pallas bars, Drudes on their cores and
    displaced.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import ALL_TERMS, load_system
from conftest import DATA_DIR, SYSTEMS_DIR
from test_torch_remd import patch_draws

from torchmd_tpu import drude as jdr
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.parameters import Parameters
from torchmd_tpu.potentials import FFParams as JaxFFParams
from torchmd_tpu.potentials import ForceTermConfig as JaxCfg
from torchmd_tpu.potentials import compute_potentials as jax_potentials
from torchmd_tpu_torch import Forces
from torchmd_tpu_torch import drude as tdr
from torchmd_tpu_torch.interop import (drude_spec_from_numpy, drude_state_from_numpy,
                                       ffparams_from_numpy)
from torchmd_tpu_torch.potentials import ForceTermConfig

torch.set_num_threads(1)

TOL = 1e-7


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gas(n=16, periodic=False, seed=3):
    """A polarizable gas: random charges, one LJ type, three excluded
    (bonded) pairs that carry Thole screening, two NBTHOLE pairs; on a
    4 A lattice (open) or in a 12 A box."""
    rs = np.random.RandomState(seed)
    if periodic:
        g = np.arange(2) * 4.0 + 2.0
        pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)[:n]
    else:
        g = np.arange(4) * 4.0
        pos = np.stack(np.meshgrid(g, g, [0.0], indexing="ij"), -1).reshape(-1, 3)
        pos = np.concatenate([pos, pos + [0.0, 0.0, 4.0]])[:n]
    pos = pos + 0.1 * rs.randn(*pos.shape)
    q = rs.randn(n) * 0.2
    q -= q.mean()
    mask = ~np.eye(n, dtype=bool)
    for i, j in ((0, 1), (2, 3), (1, 4)):
        mask[i, j] = mask[j, i] = False
    ffp = JaxFFParams(
        charges=jnp.asarray(q), masses=jnp.asarray(np.full((n, 1), 40.0)),
        mapped_atom_types=jnp.zeros(n, jnp.int32), lj_params=jnp.asarray([[3.0, 0.1]]),
        bonds=None, angles=None, dihedrals=None, impropers=None, nb14=None,
        nb_mask=jnp.asarray(mask))
    alpha = 0.6 + 0.4 * rs.rand(n)
    alpha[5] = 0.0                            # one non-polarizable atom
    return ffp, pos, alpha, np.asarray([[6, n - 1, 1.8], [2, n - 2, 2.1]])


def _extend(ffp, alpha, nbthole=None, **kw):
    jext, jspec = jdr.make_drude_ffparams(ffp, alpha, nbthole_pairs=nbthole, **kw)
    text, tspec = tdr.make_drude_ffparams(ffparams_from_numpy(_np(ffp)), alpha,
                                          nbthole_pairs=nbthole, **kw)
    return jext, jspec, text, tspec


def _same_tree(got, want, what):
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None, (what, name)
        elif isinstance(g, (float, int)):
            assert g == pytest.approx(float(w), rel=1e-15), (what, name)
        elif hasattr(w, "_fields"):
            _same_tree(g, w, f"{what}.{name}")
        elif isinstance(w, tuple):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{what}.{name}")


ALANINE_NB = dict(cutoff=9.0, switch_dist=7.5, rfa=True)


def _alanine():
    mol, ff, _ = load_system(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber"))
    return mol, Parameters(ff, mol, ALL_TERMS, precision="double")


def _alanine_forces():
    mol, par = _alanine()
    return (mol, JaxForces(par, terms=ALL_TERMS, precision="double", **ALANINE_NB),
            Forces(par, terms=ALL_TERMS, precision="double", device="cpu", **ALANINE_NB))


def _argon_forces(tmp_path):
    import yaml

    from torchmd_tpu.forcefields import ForceField
    from torchmd_tpu.io import Molecule

    with open(os.path.join(SYSTEMS_DIR, "argon", "argon_forcefield.yaml")) as fh:
        ff_dict = yaml.safe_load(fh)
    at = list(ff_dict["atomtypes"])[0]
    ff_dict["polarizabilities"] = {at: {"alpha": 1.6, "thole": 1.3}}
    path = tmp_path / "polar.yaml"
    path.write_text(yaml.safe_dump(ff_dict))
    mol = Molecule(os.path.join(SYSTEMS_DIR, "argon", "argon_start.pdb"))
    par = Parameters(ForceField.create(mol, str(path)), mol, ["lj", "bonds"],
                     precision="double")
    terms = ["lj", "electrostatics", "bonds"]
    return (JaxForces(par, terms=terms, precision="double", cutoff=9.0),
            Forces(par, terms=terms, precision="double", cutoff=9.0, device="cpu"))


@pytest.mark.parametrize("system", ["gas", "alanine", "argon_yaml"])
def test_extended_topology_matches_jax(system, tmp_path):
    if system == "gas":
        ffp, _, alpha, nbthole = _gas()
        jext, jspec, text, tspec = _extend(ffp, alpha, nbthole)
        assert tspec.thole_i is not None and tspec.nbthole_i is not None
    elif system == "alanine":
        mol, jf, tf = _alanine_forces()
        alpha = np.where(np.asarray(mol.element) == "H", 0.0, 1.0)
        jext, jspec = jdr.make_drude(jf, alpha=alpha)
        text, tspec = tdr.make_drude(tf, alpha=alpha)
        assert len(tspec.thole_i) > 10 and text.nb14 is not None
    else:
        jf, tf = _argon_forces(tmp_path)
        jext, jspec = jdr.make_drude(jf)
        text, tspec = tdr.make_drude(tf)
        np.testing.assert_allclose(tspec.alpha.numpy(), 1.6)
    _same_tree(text, _np(jext), "ffp_ext")
    _same_tree(tspec, _np(jspec), "spec")
    _same_tree(drude_spec_from_numpy(_np(jspec)), _np(jspec), "interop spec")


def _jax_terms(jext, jspec, cfg, p, box, recip):
    """JAX per-term energies in the port's keys: compute_potentials, Thole,
    NBTHOLE, the reciprocal term added to electrostatics."""
    jb = None if box is None else jnp.asarray(box)
    pot = {k: float(v) for k, v in jax_potentials(jext, p, jb, cfg).items()}
    if jspec.thole_i is not None:
        pot["thole"] = float(jdr.thole_energy(jspec, p, jb))
    if jspec.nbthole_i is not None:
        pot["nbthole"] = float(jdr.nbthole_energy(jspec, p, jb))
    if recip is not None:
        pot["electrostatics"] += float(recip.energy(p, jb))
    grad = jax.jit(jax.grad(lambda q: jdr.drude_energy(jext, jspec, cfg, q, jb, recip=recip)))(p)
    return pot, -np.asarray(grad)


def _case(name):
    """(ffp, pos, alpha, nbthole, cfg kwargs, box, pme) of an energy case."""
    if name == "gas":
        ffp, pos, alpha, nbt = _gas()
        return ffp, pos, alpha, nbt, dict(terms=("lj", "electrostatics", "bonds"),
                                          cutoff=6.0), None, None
    ffp, pos, alpha, nbt = _gas(8, periodic=True)
    return ffp, pos, alpha, nbt, dict(terms=("lj", "electrostatics", "bonds"), cutoff=5.0), \
        np.full(3, 12.0), name == "pme"


@pytest.mark.parametrize("name, displaced", [("gas", False), ("gas", True), ("ewald", True),
                                             ("pme", True)])
def test_energies_and_forces_match_jax(name, displaced):
    ffp, pos, alpha, nbt, cfg_kw, box, pme = _case(name)
    jext, jspec, text, tspec = _extend(ffp, alpha, nbt)
    p = np.array(jdr.init_drude_positions(jnp.asarray(pos), jspec))
    if displaced:
        p[len(pos):] += 0.05 * np.random.RandomState(4).randn(len(p) - len(pos), 3)
    jrec = trec = None
    if box is not None:
        jrec, alpha_j = jdr.make_drude_ewald(jext, box, cfg_kw["cutoff"], pme=pme)
        trec, alpha_t = tdr.make_drude_ewald(text, box, cfg_kw["cutoff"], pme=pme)
        assert type(trec).__name__ == ("PmeRecip" if pme else "EwaldRecip")
        assert alpha_t == alpha_j
        if pme:
            assert trec.gather == "exact" and tuple(trec.cfg.kmax) == tuple(jrec.cfg.kmax)
        cfg_kw = dict(cfg_kw, ewald_alpha=alpha_j)
    jcfg, tcfg = JaxCfg(**cfg_kw), ForceTermConfig(**cfg_kw)
    want, f_want = _jax_terms(jext, jspec, jcfg, jnp.asarray(p), box, jrec)
    tbox = None if box is None else torch.as_tensor(box)
    pot, frc = tdr.drude_energy_forces(text, tspec, tcfg, recip=trec)(torch.as_tensor(p), tbox)
    assert set(pot) == set(want)
    for k, w in want.items():
        assert abs(float(pot[k]) - w) <= TOL * max(1.0, abs(w)), (k, float(pot[k]), w)
    scale = max(1.0, np.abs(f_want).max())
    assert np.abs(frc.numpy() - f_want).max() <= 1e-8 * scale
    total = float(tdr.drude_energy(text, tspec, tcfg, torch.as_tensor(p), tbox, recip=trec))
    assert abs(total - sum(want.values())) <= TOL * max(1.0, abs(sum(want.values())))


def test_flipped_drude_charge_must_fail():
    """The planted fault: the Drude charges' sign flipped (cores keep q -
    q_D) moves the energies far beyond the tolerance."""
    ffp, pos, alpha, nbt, cfg_kw, _, _ = _case("gas")
    jext, jspec, text, tspec = _extend(ffp, alpha, nbt)
    p = np.array(jdr.init_drude_positions(jnp.asarray(pos), jspec))
    p[len(pos):] += 0.05 * np.random.RandomState(4).randn(len(p) - len(pos), 3)
    want, _ = _jax_terms(jext, jspec, JaxCfg(**cfg_kw), jnp.asarray(p), None, None)
    q = text.charges.clone()
    q[tspec.drude_idx] = -q[tspec.drude_idx]
    bad = text._replace(charges=q)
    pot, _ = tdr.drude_energy_forces(bad, tspec._replace(q_drude=-tspec.q_drude),
                                     ForceTermConfig(**cfg_kw))(torch.as_tensor(p), None)
    err = max(abs(float(pot[k]) - w) / max(1.0, abs(w)) for k, w in want.items())
    assert err > 1e3 * TOL, err


def test_validation_matches_jax():
    ffp, pos, alpha, nbt = _gas()
    text, tspec = tdr.make_drude_ffparams(ffparams_from_numpy(_np(ffp)), alpha)
    p = tdr.init_drude_positions(torch.as_tensor(pos), tspec)
    with pytest.raises(ValueError, match="bonds"):
        tdr.drude_energy(text, tspec, ForceTermConfig(terms=("electrostatics",)), p, None)
    with pytest.raises(ValueError, match="reciprocal"):
        tdr.drude_energy_forces(text, tspec, ForceTermConfig(
            terms=("electrostatics", "bonds"), cutoff=5.0, ewald_alpha=0.3))
    with pytest.raises(ValueError, match="alpha == 0"):
        tdr.make_drude_ffparams(text, np.zeros(len(p)))
    with pytest.raises(ValueError, match=">= 0"):
        tdr.make_drude_ffparams(ffparams_from_numpy(_np(ffp)), -alpha)


def _jax_scf_iterations(jext, jspec, cfg, p0, box, recip, n):
    """The JAX solve's positions after at most n iterations."""
    return np.asarray(jdr.scf_drude(jext, jspec, cfg, p0, box, iters=n, recip=recip))


@pytest.mark.parametrize("name", ["gas", "ewald"])
def test_scf_matches_jax(name):
    ffp, pos, alpha, nbt, cfg_kw, box, pme = _case(name)
    jext, jspec, text, tspec = _extend(ffp, alpha, nbt)
    jrec = trec = None
    if box is not None:
        jrec, a = jdr.make_drude_ewald(jext, box, cfg_kw["cutoff"], pme=pme)
        trec, _ = tdr.make_drude_ewald(text, box, cfg_kw["cutoff"], pme=pme)
        cfg_kw = dict(cfg_kw, ewald_alpha=a)
    p0 = jdr.init_drude_positions(jnp.asarray(pos), jspec)
    jb = None if box is None else jnp.asarray(box)
    want = np.asarray(jdr.scf_drude(jext, jspec, JaxCfg(**cfg_kw), p0, jb, recip=jrec))
    got, info = tdr.scf_drude(text, tspec, ForceTermConfig(**cfg_kw),
                              torch.as_tensor(np.array(p0)), box, recip=trec,
                              return_info=True)
    assert np.abs(got.numpy() - want).max() <= 1e-9
    n = info["iterations"]
    assert 3 < n < 200 and info["host_reads"] == n and info["gmax"] <= 1e-10
    # JAX stops at the same iteration: capped at n it gives its own answer,
    # capped at n - 1 it does not
    cfg = JaxCfg(**cfg_kw)
    np.testing.assert_array_equal(_jax_scf_iterations(jext, jspec, cfg, p0, jb, jrec, n), want)
    assert np.abs(_jax_scf_iterations(jext, jspec, cfg, p0, jb, jrec, n - 1) - want).max() > 0
    # a damped step reaches the same fixed point in more iterations
    half, info_h = tdr.scf_drude(text, tspec, ForceTermConfig(**cfg_kw),
                                 torch.as_tensor(np.array(p0)), box, recip=trec,
                                 return_info=True, damping=0.5)
    assert np.abs(half.numpy() - want).max() <= 1e-9 and info_h["iterations"] > n


def _run(pkg, monkeypatch, steps, handover=None, swap_kicks=False):
    """(positions, [step tuples]) of the gas's dual-Langevin run, chunks of
    10 steps, draws patched; `handover` = (pos, vel, forces) of a JAX run
    the port continues."""
    patch_draws(monkeypatch)
    ffp, pos, alpha, nbt, cfg_kw, _, _ = _case("gas")
    jext, jspec, text, tspec = _extend(ffp, alpha, nbt)
    p0 = np.array(jdr.init_drude_positions(jnp.asarray(pos), jspec))
    kw = dict(timestep=1.0, T=300.0, gamma=5.0, T_drude=1.0, gamma_drude=20.0, seed=5)
    if pkg == "jax":
        integ = jdr.DrudeIntegrator(jext, jspec, JaxCfg(**cfg_kw), jnp.asarray(p0), **kw)
    else:
        integ = tdr.DrudeIntegrator(text, tspec, ForceTermConfig(**cfg_kw), p0,
                                    device="cpu", **kw)
        if swap_kicks:
            integ._vc_com, integ._vc_rel = integ._vc_rel, integ._vc_com
            integ.gamma, integ.gamma_d = integ.gamma_d, integ.gamma
    integ.set_velocities_boltzmann(seed=5)
    if handover is not None:
        drude_state_from_numpy(integ, *handover)
    outs = [integ.step(niter=10) for _ in range(steps // 10)]
    return integ, np.asarray(integ.pos), outs


def test_integrator_matches_jax(monkeypatch):
    jint, jpos, jout = _run("jax", monkeypatch, 20)
    _, tpos, tout = _run("torch", monkeypatch, 20)
    assert np.abs(jpos - tpos).max() <= 1e-8
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, np.asarray(b, np.float64), rtol=1e-10, atol=1e-10)
    assert jout[-1][3] < jout[-1][2]          # the relative coordinates stay colder

    # a JAX run handed over after 10 steps continues identically
    j10, _, _ = _run("jax", monkeypatch, 10)
    _, hpos, hout = _run("torch", monkeypatch, 10, handover=(
        np.asarray(j10.pos), np.asarray(j10.vel), np.asarray(j10._last_frc)))
    assert np.abs(hpos - jpos).max() <= 1e-8
    np.testing.assert_allclose(hout[-1], np.asarray(jout[-1], np.float64), rtol=1e-10,
                               atol=1e-10)


def test_swapped_kicks_must_fail(monkeypatch):
    """The planted fault: the centre-of-mass kick at the relative bath and
    the relative kick at the physical one leaves the JAX trajectory."""
    _, jpos, _ = _run("jax", monkeypatch, 20)
    _, tpos, _ = _run("torch", monkeypatch, 20, swap_kicks=True)
    assert np.abs(tpos - jpos).max() > 1e3 * 1e-8


@pytest.mark.gpu
def test_kernels_on_extended_system():
    """Kernels #1 and #3 (f32) against their plain versions (f64) on the
    extended alanine dipeptide at the Pallas bars, Drudes on their cores
    (r = 0 pairs) and displaced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn

    mol, par = _alanine()
    alpha = np.where(np.asarray(mol.element) == "H", 0.0, 1.0)
    ext = {}
    for dt, prec in ((torch.float64, "double"), (torch.float32, "single")):
        tf = Forces(par, terms=ALL_TERMS, precision=prec, device="cuda", **ALANINE_NB)
        ext[dt], spec = tdr.make_drude(tf, alpha=alpha)
    cfg = tf.config
    p = tdr.init_drude_positions(torch.as_tensor(mol.coords[:, :, 0], dtype=torch.float64,
                                                 device="cuda"), spec)
    disp = p.clone()
    disp[spec.drude_idx] += 0.05 * torch.as_tensor(
        np.random.RandomState(2).randn(len(spec.drude_idx), 3), device="cuda")
    d32, d64 = (kn.prepare_nb_data(ext[dt]) for dt in (torch.float32, torch.float64))
    plan32, plan64 = (kb.build_bonded_kernel_plan(ext[dt], cfg)
                      for dt in (torch.float32, torch.float64))
    for x in (p, disp):
        n0 = (kn.LAUNCHES, kb.LAUNCHES)
        got = [kn.nonbonded_energy_forces(d32, cfg, x.float()),
               kb.bonded_energy_forces(plan32, x.float())]
        assert (kn.LAUNCHES - n0[0], kb.LAUNCHES - n0[1]) == (1, 1)
        want = [kn.pair_terms_reference(d64, cfg, x), kb.bonded_reference(plan64, x)]
        for (pk, fk), (pp, fp) in zip(got, want):
            for k, v in pp.items():
                assert abs(float(pk[k]) - float(v)) <= 2e-5 * max(1.0, abs(float(v))), k
            scale = max(1.0, float(fp.abs().max()))
            assert float((fk.double() - fp).abs().max()) <= 5e-5 * scale
