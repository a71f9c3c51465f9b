"""The port's alchemical coupling (`torchmd_tpu_torch.alchemy`) and
lambda-dynamics (`torchmd_tpu_torch.lambda_dynamics`) against the JAX
package at f64 on the CPU.

  - argon of tests/systems/argon (one LJ type, cutoff 9 A, the 77.4 A
    box): the coupling energy at several lambdas, dU/dlambda and the
    energies of stored frames equal the JAX package's (1e-7 relative);
    `make_alchemical` at lambda 0.5 gives the JAX `Forces.compute`'s
    energies and forces, and at lambda 1 the unmodified system's, on the
    kernel path (its plain versions) and the dense torch-op path; the
    estimators `ti_integrate`, `fep_exponential` and `bar` equal the JAX
    package's;
  - the planted fault of stale pair data (the exclusion mask and its tile
    words as before `make_alchemical`) counts every crossing pair twice
    and must fail the lambda = 1 identity;
  - alanine dipeptide in water (several LJ types, a decoupled residue and
    a water whose hydrogens have eps 0): the port's lambda = 1 identity
    holds; the JAX package's coupling there indexes its per-atom LJ rows
    with type ids (ROADMAP.md section 3), so it is not the reference: at
    lambda 0.3, 0.5 and 0.8 the coupling energy and dU/dlambda are held to
    a pair-by-pair f64 reference with the force field's own type-mixed
    A/B (1e-7), and the JAX indexing planted in the port must fail it;
  - `LambdaDynamics` on argon with two sites, one with a pH bias, 20
    steps in two chunks, both packages' draws patched to the same values:
    positions within 1e-8 A and the lambda traces within 1e-10; the
    thetas handed across by `interop.lambda_state_from_numpy`;
    `protonation_fraction` and `ph_bias` as the JAX package's.
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

from torchmd_tpu import alchemy as jal
from torchmd_tpu import lambda_dynamics as jld
from torchmd_tpu.forcefields import ForceField
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.io import Molecule
from torchmd_tpu.parameters import Parameters
from torchmd_tpu.systems import System as JaxSystem
from torchmd_tpu_torch import Forces, System
from torchmd_tpu_torch import alchemy as tal
from torchmd_tpu_torch import lambda_dynamics as tld
from torchmd_tpu_torch.interop import coupling_from_numpy, lambda_state_from_numpy
from torchmd_tpu_torch.ops import nonbonded as kn

torch.set_num_threads(1)

TOL = 1e-7
BOX = 77.395
ALCH = np.arange(0, 12)


def _argon(terms=("lj",)):
    mol = Molecule(os.path.join(SYSTEMS_DIR, "argon", "argon_start.pdb"))
    ff = ForceField.create(mol, os.path.join(SYSTEMS_DIR, "argon", "argon_forcefield.yaml"))
    return mol, Parameters(ff, mol, list(terms), precision="double")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _pos(mol, seed=0):
    return mol.coords[:, :, 0] + 0.1 * np.random.RandomState(seed).randn(mol.numAtoms, 3)


def test_coupling_matches_jax():
    mol, par = _argon()
    jf = JaxForces(par, terms=["lj"], precision="double", cutoff=9.0, switch_dist=7.5)
    tf = Forces(par, terms=["lj"], precision="double", cutoff=9.0, switch_dist=7.5,
                device="cpu")
    jc = jal.AlchemicalCoupling(jf.ffparams, jf.config, ALCH, lam=0.4, alpha=0.5)
    tc = tal.AlchemicalCoupling(tf.ffparams, tf.config, ALCH, lam=0.4, alpha=0.5)
    tc2 = coupling_from_numpy(jc, tf.ffparams, tf.config)
    pos = _pos(mol)
    box = np.full(3, BOX)
    for lam in (0.0, 0.3, 0.7, 1.0):
        want = float(jc.energy_lambda(jnp.asarray(pos), jnp.asarray(box), lam))
        for c in (tc, tc2):
            assert _rel(float(c.energy_lambda(torch.as_tensor(pos), torch.as_tensor(box), lam)),
                        want) <= TOL
    want = float(jc.dudl(jnp.asarray(pos), jnp.asarray(box), 0.6))
    assert _rel(float(tc.dudl(torch.as_tensor(pos), torch.as_tensor(box), 0.6)), want) <= TOL
    frames = np.stack([_pos(mol, s) for s in (1, 2, 3)])
    boxes = np.full((3, 3), BOX)
    want = np.asarray(jc.energies_over_frames(jnp.asarray(frames), jnp.asarray(boxes), 0.5))
    got = tc.energies_over_frames(torch.as_tensor(frames), torch.as_tensor(boxes), 0.5)
    assert _rel(got.numpy(), want) <= TOL


def _alchemical_pair(kernel, lam):
    mol, par = _argon(("lj", "electrostatics"))
    kw = dict(terms=["lj", "electrostatics"], precision="double", cutoff=9.0, rfa=True)
    jf, tf = JaxForces(par, **kw), Forces(par, kernel=kernel, device="cpu", **kw)
    jal.make_alchemical(jf, ALCH, lam=lam)
    tal.make_alchemical(tf, ALCH, lam=lam)
    return mol, par, kw, jf, tf


@pytest.mark.parametrize("kernel", ["auto", "dense"])
def test_make_alchemical_matches_jax_and_lambda_one(kernel):
    mol, par, kw, jf, tf = _alchemical_pair(kernel, 0.5)
    pos = np.stack([_pos(mol, 4), _pos(mol, 5)])
    boxes = np.full((2, 3), BOX)
    jfrc, tfrc = np.zeros_like(pos), np.zeros_like(pos)
    want = jf.compute(pos, boxes, jfrc, returnDetails=True)
    got = tf.compute(pos, boxes, tfrc, returnDetails=True)
    for w, g in zip(want, got):
        for k in w:
            assert _rel(g[k], w[k]) <= TOL, (k, g[k], w[k])
    assert _rel(tfrc, jfrc) <= TOL
    # lambda = 1: the unmodified system
    tf.external.lam = 1.0
    base = Forces(par, kernel=kernel, device="cpu", **kw)
    bfrc, afrc = np.zeros_like(pos), np.zeros_like(pos)
    e_base = base.compute(pos, boxes, bfrc)
    e_alch = tf.compute(pos, boxes, afrc)
    assert _rel(e_alch, e_base) <= 1e-10 and _rel(afrc, bfrc) <= 1e-10


def test_stale_exclusion_words_fail(monkeypatch):
    """Pair data left from before make_alchemical (the old mask and its
    tile words) counts each crossing pair in the base terms and again in
    the coupling: the lambda = 1 identity must fail."""
    mol, par = _argon(("lj", "electrostatics"))
    kw = dict(terms=["lj", "electrostatics"], precision="double", cutoff=9.0, rfa=True)
    tf = Forces(par, device="cpu", **kw)
    stale = kn.prepare_nb_data(tf.ffparams)
    monkeypatch.setattr(kn, "prepare_nb_data", lambda ffp, dtype=None: stale)
    tal.make_alchemical(tf, ALCH, lam=1.0)
    pos = _pos(mol, 6)[None]
    box = np.full((1, 3), BOX)
    e_base = Forces(par, device="cpu", **kw).compute(pos, box)
    assert _rel(tf.compute(pos, box), e_base) > 1e-6


def test_lambda_one_identity_with_several_lj_types():
    """Alanine dipeptide in water: the ALA residue and one water (its
    hydrogens have eps 0, as every water's) decoupled at lambda = 1 give
    the unmodified system. The JAX coupling mixes its LJ rows by atom
    index rather than by type and misses it."""
    mol, ff, nb = load_system(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    pdb = Molecule(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber", "structure.pdb"))
    water = np.flatnonzero(pdb.resname == "WAT")[:3]
    alch = np.concatenate([np.flatnonzero(pdb.resname == "ALA"), water])
    pos = mol.coords[:, :, 0][None]
    box = mol.box[:, 0][None]
    base = Forces(par, terms=ALL_TERMS, precision="double", device="cpu", **nb)
    tf = Forces(par, terms=ALL_TERMS, precision="double", device="cpu", **nb)
    tal.make_alchemical(tf, alch, lam=1.0)
    bfrc, afrc = np.zeros_like(pos), np.zeros_like(pos)
    e_base = base.compute(pos, box, bfrc)
    e_alch = tf.compute(pos, box, afrc)
    assert _rel(e_alch, e_base) <= 1e-10 and _rel(afrc, bfrc) <= 1e-10
    jf = JaxForces(par, terms=ALL_TERMS, precision="double", **nb)
    jal.make_alchemical(jf, alch, lam=1.0)
    e_jax = jf.compute(pos, box)
    assert not np.isfinite(e_jax[0]) or _rel(e_jax, e_base) > 1e-3


def _coupling_reference(mol, ff, par, alch, pos, box, lam, cutoff, switch_dist,
                        alpha=0.5, eps_rf=78.5):
    """(coupling energy, dU/dlambda) of the crossing pairs, pair by pair
    in f64 from the force field's own atom-type sigma/epsilon:
    Lorentz-Berthelot A = 4 eps sig^12, B = 4 eps sig^6 per pair, the
    Beutler soft-core lambda (A / r_sc^12 - B / r_sc^6) with r_sc^6 =
    alpha (1 - lambda) sig^6 + r^6 (switched on r), and lambda times the
    reaction-field Coulomb at r_sc."""
    import math

    from torchmd_tpu.units import ELEC_FACTOR

    lj = [ff.get_LJ(t) for t in mol.atomtype]
    q = np.asarray(mol.charge, np.float64)
    excl = {(int(i), int(j)) for i, j in par.get_exclusions(types=("bonds", "angles", "1-4"))}
    krf = (eps_rf - 1.0) / (2.0 * eps_rf + 1.0) / cutoff ** 3
    crf = 3.0 * eps_rf / (2.0 * eps_rf + 1.0) / cutoff
    in_alch = set(int(i) for i in alch)
    env = [j for j in range(mol.numAtoms) if j not in in_alch]
    e_tot = dudl = 0.0
    for i in sorted(in_alch):
        for j in env:
            if (min(i, j), max(i, j)) in excl:
                continue
            d = [pos[i, k] - pos[j, k] for k in range(3)]
            d = [x - box[k] * round(x / box[k]) for k, x in enumerate(d)]
            r = math.sqrt(sum(x * x for x in d))
            if r > cutoff:
                continue
            sig = 0.5 * (lj[i][0] + lj[j][0])
            eps = math.sqrt(lj[i][1] * lj[j][1])
            A, B, s6 = 4.0 * eps * sig ** 12, 4.0 * eps * sig ** 6, sig ** 6
            D = alpha * (1.0 - lam) * s6 + r ** 6          # r_sc^6
            dD = -alpha * s6                                 # dD / dlambda
            sw = 1.0
            if r > switch_dist:
                t = (r - switch_dist) / (cutoff - switch_dist)
                sw = 1.0 + t ** 3 * (-10.0 + t * (15.0 - 6.0 * t))
            u_lj = A / D ** 2 - B / D
            du_lj = (-2.0 * A / D ** 3 + B / D ** 2) * dD
            rsc = D ** (1.0 / 6.0)
            drsc = D ** (-5.0 / 6.0) * dD / 6.0
            qq = ELEC_FACTOR * q[i] * q[j]
            g = qq * (1.0 / rsc + krf * rsc * rsc - crf)
            dg = qq * (-1.0 / rsc ** 2 + 2.0 * krf * rsc) * drsc
            e_tot += lam * u_lj * sw + lam * g
            dudl += (u_lj + lam * du_lj) * sw + g + lam * dg
    return e_tot, dudl


@pytest.mark.parametrize("lam", [0.3, 0.5, 0.8])
def test_several_lj_types_coupling_matches_plain_reference(lam):
    """Alanine dipeptide in water (ten LJ types; water hydrogens with eps
    0): the coupling energy and dU/dlambda at lambda 0.3, 0.5 and 0.8
    equal a pair-by-pair f64 reference that mixes the force field's
    per-type sigma and epsilon (1e-7). The planted fault, the coupling
    mixing per-atom LJ rows indexed by type ids (the JAX package's
    indexing), must fail it."""
    mol, ff, nb = load_system(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    pdb = Molecule(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber", "structure.pdb"))
    alch = np.concatenate([np.flatnonzero(pdb.resname == "ALA"),
                           np.flatnonzero(pdb.resname == "WAT")[:3]])
    pos = mol.coords[:, :, 0] + 0.05 * np.random.RandomState(4).randn(mol.numAtoms, 3)
    box = mol.box[:, 0].astype(np.float64)
    e_ref, d_ref = _coupling_reference(mol, ff, par, alch, pos, box, lam,
                                       nb["cutoff"], nb["switch_dist"])
    tf = Forces(par, terms=ALL_TERMS, precision="double", device="cpu", **nb)
    ffp = tf.ffparams
    coupling = tal.make_alchemical(tf, alch, lam=lam)
    pt, bt = torch.as_tensor(pos), torch.as_tensor(box)
    assert _rel(float(coupling.energy_lambda(pt, bt, lam)), e_ref) <= TOL
    assert _rel(float(coupling.dudl(pt, bt, lam)), d_ref) <= TOL
    planted = tal.AlchemicalCoupling(
        ffp._replace(lj_params=ffp.lj_params[ffp.mapped_atom_types]), tf.config, alch,
        lam=lam)
    assert _rel(float(planted.energy_lambda(pt, bt, lam)), e_ref) > 1e-3


def test_estimators_match_jax():
    rs = np.random.RandomState(7)
    lams = np.array([0.0, 0.5, 0.25, 1.0, 0.75])
    means = rs.randn(5) * 3.0
    assert tal.ti_integrate(lams, means) == pytest.approx(jal.ti_integrate(lams, means),
                                                          rel=1e-14)
    du = rs.randn(200) + 1.0
    assert tal.fep_exponential(du, 0.6) == pytest.approx(jal.fep_exponential(du, 0.6),
                                                         rel=1e-14)
    wf, wr = rs.randn(150) + 2.0, rs.randn(120) - 1.5
    assert tal.bar(wf, wr, 0.6) == pytest.approx(jal.bar(wf, wr, 0.6), rel=1e-12)


def _ld(pkg, chunks=(8, 12), hand_over=None):
    mol, par = _argon()
    n = mol.numAtoms
    if pkg == "jax":
        forces = JaxForces(par, terms=["lj"], precision="double", cutoff=9.0)
        couplings = jld.make_lambda_sites(forces, [[0, 1], [5]])
        system, L, bias = JaxSystem(n, 1, "double", "cpu"), jld.LambdaDynamics, jld.ph_bias
    else:
        forces = Forces(par, terms=["lj"], precision="double", cutoff=9.0, device="cpu")
        couplings = tld.make_lambda_sites(forces, [[0, 1], [5]])
        system, L, bias = System(n, 1, "double"), tld.LambdaDynamics, tld.ph_bias
    system.set_positions(mol.coords)
    system.set_box(np.full(3, BOX))
    m = np.asarray(par.masses, np.float64).reshape(1, -1, 1)
    system.set_velocities(np.random.RandomState(8).randn(1, n, 3) * np.sqrt(0.24 / m))
    ld = L(system, forces, couplings, biases=[bias(4.8, 6.0, 120.0, barrier=1.0), None],
           timestep=2.0, T=120.0, gamma=5.0, lam0=[0.3, 0.6])
    if hand_over is not None:
        pos, vel, theta, vtheta = hand_over
        system.pos[:], system.vel[:] = pos, vel
        lambda_state_from_numpy(ld, theta, vtheta)
    outs = [ld.step(niter=c) for c in chunks]
    return system, ld, outs


def test_lambda_dynamics_matches_jax(monkeypatch):
    patch_draws(monkeypatch)
    js, jl, jouts = _ld("jax")
    ts, tl, touts = _ld("port")
    assert float(np.abs(ts.pos - np.asarray(js.pos)).max()) <= 1e-8
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t[3], np.asarray(j[3]), rtol=0, atol=1e-10)
        for a, b in zip(t[:3], j[:3]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9)
    np.testing.assert_allclose(tl.lambdas, jl.lambdas, atol=1e-10)
    assert tl.theta_kinetic_energy() == pytest.approx(jl.theta_kinetic_energy(), rel=1e-8)
    trace = np.concatenate([t[3] for t in touts])
    np.testing.assert_array_equal(tld.protonation_fraction(trace, 0.4),
                                  jld.protonation_fraction(trace, 0.4))


def test_lambda_dynamics_handed_over_from_jax(monkeypatch):
    patch_draws(monkeypatch)
    js, jl, _ = _ld("jax", chunks=(8,))
    state = (np.array(js.pos), np.array(js.vel), np.array(jl.theta), np.array(jl.vtheta))
    jl.step(niter=6)
    ts, tl, _ = _ld("port", chunks=(6,), hand_over=state)
    assert float(np.abs(ts.pos - np.asarray(js.pos)).max()) <= 1e-8
    np.testing.assert_allclose(tl.lambdas, jl.lambdas, atol=1e-10)


def test_ph_bias_and_site_checks():
    for args in ((4.8, 7.4, 300.0), (4.8, 2.0, 300.0, 0.5, 2.0)):
        tb, jb = tld.ph_bias(*args), jld.ph_bias(*args)
        for lam in (0.0, 0.3, 1.0):
            assert tb(lam) == pytest.approx(jb(lam), rel=1e-14, abs=1e-14)
    mol, par = _argon()
    forces = Forces(par, terms=["lj"], precision="double", cutoff=9.0, device="cpu")
    with pytest.raises(ValueError, match="disjoint"):
        tld.make_lambda_sites(forces, [[0, 1], [1, 2]])
    cell = Forces(par, terms=["lj"], precision="double", cutoff=9.0, device="cpu",
                  kernel="cell")
    with pytest.raises(NotImplementedError, match="cell"):
        tal.make_alchemical(cell, ALCH)
