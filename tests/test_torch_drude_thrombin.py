"""Drude thrombin's collapse, witnessed by both packages at f64 on the CPU.

`chip_smoke.py` runs thrombin with alpha = DRUDE_ALPHA on every heavy
atom (its DRUDE_TERMS: no "1-4" term, 1-2, 1-3 and 1-4 pairs excluded).
On the card its dual-Langevin run leaves the model within tens of
femtoseconds (chip_smoke.py's `[drude_collapse]` line): a Drude (no LJ)
and a polar hydrogen (no LJ in the AMBER force field, type HO) fall onto
each other. Full thrombin (7,033 particles) is too large
for a dense f64 run of the JAX package in a test, so the witness here is
a piece of the same system: the heavy atoms within RADIUS of one Tyr
hydroxyl hydrogen (SITE, H-bonded 1.72 A to a backbone O), with their
hydrogens, cut out of the JAX package's thrombin FFParams (the terms that
cross the cut dropped). Both packages build the Drude topology on it, the
port relaxes it (`scf_drude`, chip_smoke.py's damping and tolerance), and
both integrators run from that state with the JAX package's
Maxwell-Boltzmann velocities:

  - NVE (no draws), and the dual Langevin with the port's normal draws
    made the JAX integrator's own (`jax_draws`: the JAX key chain, so
    both run the real thermostat on the same noise);
  - the positions agree within 1e-8 A at every step before the
    collapse, and the first step where a Drude is COLLAPSE_A from its
    core is the same in both (227 in NVE, 239 with the thermostat); at
    that step the Drude's nearest particle is a type-HO hydrogen (a
    backbone O's Drude 0.40 A from the Tyr hydroxyl hydrogen); by the end
    of the window T_rel is beyond 1,000 K in both;
  - the control: the hydroxyl hydrogens given a small LJ core
    (CONTROL_LJ, the CHARMM Drude remedy) run the whole window with every
    Drude within COLLAPSE_A of its core (a collapse with another cause
    would fail it).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from common import load_system
from conftest import DATA_DIR

from torchmd_tpu import drude as jdr
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.parameters import Parameters
from torchmd_tpu.potentials import ForceTermConfig as JaxCfg
from torchmd_tpu_torch import drude as tdr
from torchmd_tpu_torch.interop import drude_state_from_numpy, ffparams_from_numpy
from torchmd_tpu_torch.potentials import ForceTermConfig

torch.set_num_threads(1)

SITE, RADIUS = 1483, 9.0       # Tyr HH, atom row in thrombin-ligand-amber
STEPS, COLLAPSE_A = 250, 0.5   # the window (1 fs steps); a collapsed Drude
CONTROL_LJ = (1.0, 0.05)       # sigma (A), epsilon (kcal/mol) for type HO


def _crop(ffp, keep):
    """`ffp` (numpy leaves) restricted to the atom rows `keep`: per-atom
    arrays and the mask sliced, every term instance with an atom outside
    dropped, the rest renumbered."""
    n = len(ffp.charges)
    remap = np.full(n, -1)
    remap[keep] = np.arange(len(keep))

    def table(t):
        if t is None:
            return None
        rows = np.flatnonzero((remap[t.idx] >= 0).all(1))
        rmap = np.full(len(t.idx), -1)
        rmap[rows] = np.arange(len(rows))
        a = np.flatnonzero(rmap[t.map_term] >= 0)
        return t._replace(idx=remap[t.idx[rows]], map_term=rmap[t.map_term[a]],
                          map_param=t.map_param[a])

    assert ffp.urey_bradley is None and ffp.cmap is None and ffp.bonds_g96 is None
    return ffp._replace(
        charges=ffp.charges[keep], masses=ffp.masses[keep],
        mapped_atom_types=ffp.mapped_atom_types[keep], nb_mask=ffp.nb_mask[np.ix_(keep, keep)],
        **{k: table(getattr(ffp, k)) for k in ("bonds", "angles", "dihedrals", "impropers",
                                                "nb14")})


@pytest.fixture(scope="module")
def piece():
    """(JAX FFParams, JAX cfg, masses, atom types, positions) of the piece
    of Drude thrombin around SITE."""
    mol, ff, _ = load_system(os.path.join(DATA_DIR, "thrombin-ligand-amber"))
    terms = chip_smoke.DRUDE_TERMS
    par = Parameters(ff, mol, terms, precision="double")
    forces = JaxForces(par, terms=terms, cutoff=chip_smoke.CUTOFF, rfa=chip_smoke.RFA,
                       precision="double")
    ffp = jax.tree_util.tree_map(np.asarray, forces.ffparams)
    pos = np.asarray(mol.coords[:, :, 0], np.float64)
    assert str(mol.name[SITE]) == "HH" and str(mol.atomtype[SITE]) == "HO"
    heavy = np.asarray(mol.element) != "H"
    parent = np.arange(mol.numAtoms)
    for a, b in ffp.bonds.idx:
        if not heavy[a]:
            parent[a] = b
        if not heavy[b]:
            parent[b] = a
    near = np.linalg.norm(pos - pos[SITE], axis=1) < RADIUS
    keep = np.flatnonzero(near[parent] & heavy[parent])
    return (_crop(ffp, keep), forces.config, ffp.masses[keep, 0],
            np.asarray(mol.atomtype)[keep], pos[keep])


def _extend(piece, lj=None):
    """Both packages' Drude topologies of the piece (alpha DRUDE_ALPHA on
    the heavy atoms); `lj` replaces type HO's LJ row in both."""
    ffp, cfg, masses, types, _ = piece
    if lj is not None:
        t = int(ffp.mapped_atom_types[np.flatnonzero(types == "HO")[0]])
        ffp = ffp._replace(lj_params=ffp.lj_params.copy())
        ffp.lj_params[t] = lj
        assert ffp.lj_ab is None
    alpha = np.where(masses < 1.5, 0.0, chip_smoke.DRUDE_ALPHA)
    jext, jspec = jdr.make_drude_ffparams(jax.tree_util.tree_map(jnp.asarray, ffp), alpha)
    text, tspec = tdr.make_drude_ffparams(ffparams_from_numpy(ffp), alpha)
    return jext, jspec, text, tspec, cfg


def _start(piece, text, tspec, cfg):
    """The port's SCF state of the piece, as chip_smoke.py relaxes thrombin."""
    p0 = tdr.init_drude_positions(torch.as_tensor(piece[4]), tspec)
    p, info = tdr.scf_drude(text, tspec, cfg, p0, None, iters=chip_smoke.SCF_ITERS,
                            tol=chip_smoke.DRUDE_SCF_TOL, damping=chip_smoke.DRUDE_SCF_DAMPING,
                            return_info=True)
    assert info["gmax"] <= chip_smoke.DRUDE_SCF_TOL
    return p.numpy()


def _trajectory(integ, spec):
    """Step by step over the window: (positions, max Drude displacement,
    T_rel) after each step."""
    ci, di = np.asarray(spec.core_idx), np.asarray(spec.drude_idx)
    out = []
    for _ in range(STEPS):
        t_rel = integ.step(niter=1)[3]
        p = np.asarray(integ.pos, np.float64)
        out.append((p, float(np.linalg.norm(p[di] - p[ci], axis=1).max()), t_rel))
    return out


def jax_draws(monkeypatch, seed):
    """The port's normal draws made the JAX integrator's own: per step
    (key, sub) = split(key), (k1, k2, k3) = split(sub, 3) from
    PRNGKey(seed), the per-atom, centre-of-mass and relative draws from
    k1, k2, k3 (torchmd_tpu/drude.py:497-513, :527-528)."""
    state = {"key": jax.random.PRNGKey(seed), "subs": []}

    def randn(*size, generator=None, device=None, dtype=None, **kw):
        shape = size[0] if len(size) == 1 and not isinstance(size[0], int) else size
        if not state["subs"]:
            state["key"], sub = jax.random.split(state["key"])
            state["subs"] = list(jax.random.split(sub, 3))
        draw = jax.random.normal(state["subs"].pop(0), tuple(shape), dtype=jnp.float64)
        return torch.as_tensor(np.array(draw), dtype=dtype, device=device)

    monkeypatch.setattr(torch, "randn", randn)


def _runs(piece, langevin, monkeypatch, lj=None, jax_too=True):
    jext, jspec, text, tspec, jcfg = _extend(piece, lj)
    start = _start(piece, text, tspec, ForceTermConfig(**jcfg._asdict()))
    kw = dict(timestep=chip_smoke.DRUDE_DT, T=chip_smoke.TEMP, T_drude=1.0, seed=1,
              gamma=1.0 if langevin else 0.0, gamma_drude=20.0 if langevin else 0.0)
    if langevin:
        jax_draws(monkeypatch, kw["seed"])
    jint = jdr.DrudeIntegrator(jext, jspec, JaxCfg(**jcfg._asdict()), jnp.asarray(start), **kw)
    jint.set_velocities_boltzmann(seed=1)
    tint = tdr.DrudeIntegrator(text, tspec, ForceTermConfig(**jcfg._asdict()), start,
                               device="cpu", **kw)
    drude_state_from_numpy(tint, np.asarray(jint.pos), np.asarray(jint.vel))
    return (_trajectory(jint, jspec) if jax_too else None), _trajectory(tint, tspec), tspec


def _first(traj):
    return next((k for k, (_, d, _) in enumerate(traj) if d > COLLAPSE_A), None)


@pytest.mark.parametrize("langevin", [False, True], ids=["nve", "langevin-jax-draws"])
def test_collapse_at_the_same_step(piece, langevin, monkeypatch):
    jt, tt, tspec = _runs(piece, langevin, monkeypatch)
    k = _first(jt)
    assert k is not None and _first(tt) == k, (k, _first(tt))
    for (jp, _, _), (tp, _, _) in zip(jt[:k], tt[:k]):
        assert np.abs(jp - tp).max() <= 1e-8
    # the collapsed Drude's nearest particle: a hydroxyl hydrogen (no LJ)
    p, ci, di = tt[k][0], np.asarray(tspec.core_idx), np.asarray(tspec.drude_idx)
    d = di[np.argmax(np.linalg.norm(p[di] - p[ci], axis=1))]
    dist = np.linalg.norm(p - p[d], axis=1)
    dist[d] = np.inf
    near = int(np.argmin(dist))
    assert near < len(piece[3]) and piece[3][near] == "HO", (near, dist[near])
    assert jt[-1][2] > 1e3 and tt[-1][2] > 1e3, (jt[-1][2], tt[-1][2])


def test_hydroxyl_lj_control(piece, monkeypatch):
    _, tt, _ = _runs(piece, False, monkeypatch, lj=CONTROL_LJ, jax_too=False)
    assert _first(tt) is None, _first(tt)
