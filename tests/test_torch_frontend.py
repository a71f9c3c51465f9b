"""The port's own front end and its isolation from the JAX package.

  - `torchmd_tpu_torch.io.Molecule`, `.forcefields.ForceField` and
    `.parameters.Parameters` (the port's copy) build the same arrays as the
    JAX package's front end on thrombin-ligand and alanine dipeptide
    (AMBER prmtop) and on a TIP4P/2005 GROMACS topology, exclusion pairs
    and virtual sites included (exact equality);
  - the port imports and builds thrombin and the TIP4P box in a
    subprocess where `torchmd_tpu` and `jax` cannot be imported;
  - the entry points default to the CUDA card and, without one, raise
    rather than run on the CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import DATA_DIR
from test_gromacs import TIP4P2005_TOP, tip4p_water

from torchmd_tpu.forcefields import ForceField as JaxForceField
from torchmd_tpu.io import Molecule as JaxMolecule
from torchmd_tpu.parameters import Parameters as JaxParameters
from torchmd_tpu_torch.forcefields import ForceField
from torchmd_tpu_torch.io import Molecule
from torchmd_tpu_torch.parameters import Parameters

# one intra-op thread per test process: the suite runs under xdist, and
# a pool of one thread per core in every worker oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AMBER_TERMS = ["bonds", "angles", "dihedrals", "impropers", "1-4",
               "electrostatics", "lj"]
WATER_TERMS = ["bonds", "lj", "electrostatics"]
MOL_FIELDS = ("numAtoms", "name", "resname", "resid", "atomtype", "charge",
              "masses", "bonds", "angles", "dihedrals", "impropers", "coords",
              "box", "element")
TABLES = ("bond_params", "angle_params", "dihedral_params", "improper_params",
          "nonbonded_params", "nonbonded_14_params")


def _water_top(tmp_path, nw):
    top = tmp_path / f"tip4p{nw}.top"
    top.write_text(TIP4P2005_TOP.replace("SOL 2", f"SOL {nw}"))
    return str(top)


def _build(M, FF, P, case, tmp_path):
    if case == "tip4p":
        top = _water_top(tmp_path, 8)
        mol = M(top)
        mol.coords = np.concatenate(
            [tip4p_water(np.array([i % 2, i // 2 % 2, i // 4]) * 3.1 + 0.9)
             for i in range(8)])[:, :, None]
        mol.box = np.full((3, 1), 6.2)
        ff = FF.create(mol, top)
        return mol, P(ff, mol, WATER_TERMS, precision="double")
    folder, coords, extra = {
        "thrombin": ("thrombin-ligand-amber", "structure.pdb", None),
        "alanine": ("prod_alanine_dipeptide_amber", "input.coor", "input.xsc"),
    }[case]
    d = os.path.join(DATA_DIR, folder)
    mol = M(os.path.join(d, "structure.prmtop"))
    mol.read(os.path.join(d, coords))
    if extra:
        mol.read(os.path.join(d, extra))
    ff = FF.create(mol, os.path.join(d, "structure.prmtop"))
    return mol, P(ff, mol, AMBER_TERMS, precision="double")


def _equal(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif a is None or b is None:
        assert a is None and b is None, what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, what
        assert a.dtype.kind == b.dtype.kind, what
        assert np.array_equal(a, b), what


@pytest.mark.parametrize("case", ["thrombin", "alanine", "tip4p"])
def test_front_end_copy_builds_the_jax_arrays(case, tmp_path):
    jmol, jpar = _build(JaxMolecule, JaxForceField, JaxParameters, case, tmp_path)
    tmol, tpar = _build(Molecule, ForceField, Parameters, case, tmp_path)
    for f in MOL_FIELDS:
        _equal(getattr(jmol, f), getattr(tmol, f), f"mol.{f}")
    for f in TABLES + ("charges", "masses", "mapped_atom_types"):
        _equal(getattr(jpar, f), getattr(tpar, f), f"par.{f}")
    for types in (("bonds", "angles", "1-4"), ("bonds",)):
        _equal(jpar.get_exclusions(types=types), tpar.get_exclusions(types=types),
               f"exclusions {types}")
        _equal(jpar.get_exclusions(types=types, fullarray=True),
               tpar.get_exclusions(types=types, fullarray=True), "exclusion mask")
    jv, tv = getattr(jpar, "vsites", ()) or (), getattr(tpar, "vsites", ()) or ()
    assert len(jv) == len(tv) == (1 if case == "tip4p" else 0)
    for g, h in zip(jv, tv):
        assert tuple(g.kind) == h.kind
        for f in ("sites", "hosts", "params"):
            _equal(np.asarray(getattr(g, f)), getattr(h, f).numpy(), f"vsites.{f}")


ISOLATED = r"""
import sys
sys.modules["torchmd_tpu"] = None
sys.modules["jax"] = None
import numpy as np
import torchmd_tpu_torch as t
from torchmd_tpu_torch import ewald, neighbors, vsites, constraints, thermostats
from torchmd_tpu_torch import columns, barostat, integrator, interop
from torchmd_tpu_torch.ops import cell, column, pme, nonbonded, bonded
t.MTKBarostat(1.0, 300.0, tau_fs=2000.0)
d = sys.argv[1]
mol = t.Molecule(d + "/structure.prmtop"); mol.read(d + "/structure.pdb")
par = t.Parameters(t.ForceField.create(mol, d + "/structure.prmtop"), mol,
                   ["bonds", "angles", "electrostatics", "lj"])
top = sys.argv[2]
w = t.Molecule(top)
wpar = t.Parameters(t.ForceField.create(w, top), w, ["bonds", "lj", "electrostatics"])
forces = t.Forces(wpar, terms=["bonds", "lj", "electrostatics"], cutoff=2.0,
                  kernel="cell", elec="pme", device="cpu")
print(mol.numAtoms, w.numAtoms, len(wpar.vsites), forces._cell_kernel is None)
"""


def test_port_builds_without_jax_or_the_jax_package(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", ISOLATED,
         os.path.join(DATA_DIR, "thrombin-ligand-amber"), _water_top(tmp_path, 27)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["4676", "108", "1", "True"]


def test_entry_points_default_to_the_card(tmp_path):
    """Without a card the default device raises, naming device='cpu';
    asking for the CPU works."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    from torchmd_tpu_torch import Forces, Integrator, System, maxwell_boltzmann
    from torchmd_tpu_torch.systems import resolve_device

    _, par = _build(Molecule, ForceField, Parameters, "tip4p", tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Forces(par, terms=WATER_TERMS, cutoff=2.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        maxwell_boltzmann(par.masses, 300.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    forces = Forces(par, terms=WATER_TERMS, cutoff=2.0, device="cpu")
    assert forces.device.type == "cpu"
    system = System(par.natoms, 1, "double")
    integ = Integrator(system, forces, 1.0)
    assert integ.device.type == "cpu"
    assert maxwell_boltzmann(par.masses, 300.0, device="cpu").device.type == "cpu"
