"""The Verlet build by cells (`neighbors.build_binned_verlet_list`) and the
front end without (N, N) arrays, against the JAX package at f64 on the
CPU.

  - the build's neighbour table equals the JAX `build_verlet_list`'s
    array for array, with the same overflow flag, on thrombin with no box
    (4,676 atoms, cutoff 7.3 A) and on the alanine box tiled 2 x 2 x 2
    (5,504 atoms, cutoff 9 A) with its box (39.7 A: 3 cells of 11 A a
    side) and without it;
  - on thrombin: the capacity from the build's row counts equals the
    JAX `VerletKernel`'s, the list equals the port's dense build bit for
    bit at f64 and at f32, and a capacity too small overflows in both;
  - the port's `Parameters` of the tiled box builds with
    `get_exclusions(fullarray=True)` raising, and its 1-4 table equals the
    JAX package's array for array;
  - on the card (gpu marker): the build at f64 equals the CPU's.
"""

from __future__ import annotations

import copy
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DATA_DIR

from torchmd_tpu import neighbors as jnb
from torchmd_tpu.forcefields import ForceField as JaxForceField
from torchmd_tpu.io import Molecule as JaxMolecule
from torchmd_tpu.parameters import Parameters as JaxParameters
from torchmd_tpu_torch import neighbors as tnb
from torchmd_tpu_torch.forcefields import ForceField
from torchmd_tpu_torch.io import Molecule
from torchmd_tpu_torch.parameters import Parameters

torch.set_num_threads(1)

TERMS = ["bonds", "angles", "dihedrals", "impropers", "1-4", "electrostatics", "lj"]
ALA = "prod_alanine_dipeptide_amber"
THROMBIN = "thrombin-ligand-amber"


def _tile(mol, tile):
    """A copy of `mol` tiled tile[0] x tile[1] x tile[2] along its box,
    every topology table shifted by the copy's atom offset."""
    n, L = mol.numAtoms, mol.box[:, 0]
    shifts = [np.array([i, j, k]) * L for i in range(tile[0]) for j in range(tile[1])
              for k in range(tile[2])]
    big = copy.copy(mol)
    big.numAtoms = n * len(shifts)
    big.coords = np.concatenate([mol.coords[:, :, 0] + s for s in shifts])[:, :, None]
    big.box = (L * np.asarray(tile))[:, None]
    for a in ("name", "element", "atomtype", "charge", "masses"):
        setattr(big, a, np.concatenate([getattr(mol, a)] * len(shifts)))
    for a in ("bonds", "angles", "dihedrals", "impropers"):
        v = getattr(mol, a)
        if len(v):
            setattr(big, a, np.concatenate([v + t * n for t in range(len(shifts))]))
    return big


def _load(Mol, FF, Par, name):
    d = os.path.join(DATA_DIR, name)
    mol = Mol(os.path.join(d, "structure.prmtop"))
    if name == ALA:
        mol.read(os.path.join(d, "input.coor"))
        mol.read(os.path.join(d, "input.xsc"))
    else:
        mol.read(os.path.join(d, "structure.pdb"))
    ff = FF.create(mol, os.path.join(d, "structure.prmtop"))
    if name == ALA:
        mol = _tile(mol, (2, 2, 2))
    return mol, Par(ff, mol, TERMS, precision="double")


def _dense_guard(monkeypatch):
    """The port's `Parameters.get_exclusions(fullarray=True)` raises."""
    get = Parameters.get_exclusions

    def guarded(self, types=("bonds", "angles", "1-4"), fullarray=False):
        if fullarray:
            raise AssertionError("get_exclusions(fullarray=True)")
        return get(self, types=types)

    monkeypatch.setattr(Parameters, "get_exclusions", guarded)


@functools.lru_cache(maxsize=None)
def _systems(name):
    """(JAX Parameters, the port's Parameters, positions) of a test
    system; the port's built with its dense exclusion matrix raising."""
    jmol, jpar = _load(JaxMolecule, JaxForceField, JaxParameters, name)
    mp = pytest.MonkeyPatch()
    try:
        _dense_guard(mp)
        _, tpar = _load(Molecule, ForceField, Parameters, name)
    finally:
        mp.undo()
    return jpar, tpar, jmol.coords[:, :, 0].astype(np.float64), jmol.box.reshape(-1).copy()


CASES = {"thrombin-open": (THROMBIN, 7.3, False), "alanine8-box": (ALA, 9.0, True),
         "alanine8-open": (ALA, 9.0, False)}


def _case(case):
    name, cutoff, boxed = CASES[case]
    jpar, tpar, pos, box = _systems(name)
    return jpar, tpar, pos, (box if boxed else None), cutoff


class _Cfg:
    """The slice of a ForceTermConfig the Verlet kernels read."""

    def __init__(self, cutoff):
        self.cutoff = cutoff


@pytest.mark.parametrize("case", list(CASES))
def test_binned_build_matches_jax_and_dense(case):
    """The new build against the JAX `build_verlet_list` on every case;
    on thrombin also the capacity from its row counts against the JAX
    `VerletKernel`'s, the port's dense build bit for bit at f64 and f32,
    and a capacity too small in both (the tiled boxes take
    the JAX kernel's capacity: one build each keeps the file short)."""
    jpar, tpar, pos, box, cutoff = _case(case)
    n = len(pos)
    full = case == "thrombin-open"
    mask = ~jpar.get_exclusions(fullarray=True)
    np.fill_diagonal(mask, False)

    class JFFP:
        nb_mask = jnp.asarray(mask)
        charges = jnp.zeros(n)

    jkern = jnb.VerletKernel(JFFP, _Cfg(cutoff), box=box, pos0=pos)
    excl = tnb.build_exclusion_table(tpar, n)

    class TFFP:
        nb_mask = None
        charges = torch.zeros(n, dtype=torch.float64)

    tkern = tnb.VerletKernel(TFFP, _Cfg(cutoff), box=box, pos0=pos,
                             capacity=None if full else jkern.vcfg.capacity,
                             excl_table=excl)
    assert tkern.binned and tkern.vcfg == jkern.vcfg
    if box is not None:
        assert tkern.grid.periodic and min(tkern.grid.ncells) >= 3
    tbox = None if box is None else torch.as_tensor(box)
    jbox = None if box is None else jnp.asarray(box)
    tpos = torch.as_tensor(pos)
    tnl = tkern.build(tpos, tbox)
    jnl = jnb.build_verlet_list(jnp.asarray(pos), jnp.asarray(mask), jkern.vcfg, jbox)
    np.testing.assert_array_equal(tnl.nbr.numpy(), np.asarray(jnl.nbr))
    assert bool(tnl.overflow) == bool(jnl.overflow) is False
    if not full:
        return
    tmask = torch.as_tensor(mask)
    assert torch.equal(tnl.nbr, tnb.build_verlet_list(tpos, tmask, tkern.vcfg, tbox).nbr)
    p32 = tpos.float()
    assert torch.equal(tkern.build(p32).nbr, tnb.build_verlet_list(p32, tmask, tkern.vcfg).nbr)
    # a capacity too small overflows in both builds
    small = tkern.vcfg.with_capacity(tkern.capacity // 3)
    got = tnb.build_binned_verlet_list(tpos, tkern.excl, small, tkern.grid, tkern.stencil)
    assert bool(got.overflow) and bool(tnb.build_verlet_list(tpos, tmask, small).overflow)


def test_frontend_builds_without_the_dense_matrix(monkeypatch):
    """The tiled box's `Parameters` builds with get_exclusions(fullarray=
    True) raising, and its 1-4 table (pairs, map, parameters) equals the
    JAX package's array for array."""
    jpar, _, _, _ = _systems(ALA)
    _dense_guard(monkeypatch)
    _, tpar = _load(Molecule, ForceField, Parameters, ALA)
    with pytest.raises(AssertionError):
        tpar.get_exclusions(fullarray=True)
    want, got = jpar.nonbonded_14_params, tpar.nonbonded_14_params
    assert len(got["idx"]) == len(want["idx"]) > 0
    for key in ("idx", "map", "params"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["alanine8-box", "alanine8-open"])
def test_binned_build_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tpar, pos, box, cutoff = _case(case)
    n = len(pos)
    excl = tnb.build_exclusion_table(tpar, n)
    out = {}
    for dev in ("cpu", "cuda"):
        class FFP:
            nb_mask = None
            charges = torch.zeros(n, dtype=torch.float64, device=dev)

        kern = tnb.VerletKernel(FFP, _Cfg(cutoff), box=box, pos0=pos, excl_table=excl)
        tbox = None if box is None else torch.as_tensor(box, device=dev)
        nl = kern.build(torch.as_tensor(pos, device=dev), tbox)
        out[dev] = (kern.capacity, nl.nbr.cpu(), bool(nl.overflow))
    assert out["cuda"][0] == out["cpu"][0] and out["cuda"][2] == out["cpu"][2] is False
    assert torch.equal(out["cuda"][1], out["cpu"][1])
