"""The port's external-potential hook and the CLI's inputs against the
JAX package.

  - `TorchExternal` forces equal -autograd of its energy and the JAX
    `external_ef` on the same well (1e-10), per replica through
    `calculate`, and through `Forces(external=)` they add to the
    internal terms with an `"external"` energy term;
  - tests/test_run_external.py's npz run goes through both CLIs with one
    potential file written as `k * (pos * pos).sum()`, for `jnp` and
    `torch` alike (carried velocities, no noise, 1e-8 A);
  - the port's xtc, npz, mdp and YAML readers and `ff_yaml` give the JAX
    package's arrays on tests/systems/*;
  - on a card (`gpu`): the external check on CUDA tensors and a 20-step
    CLI run through the kernels.
"""

from __future__ import annotations

import os
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from conftest import SYSTEMS_DIR
from test_gromacs import MDP_TEXT

from torchmd_tpu import run as jrun
from torchmd_tpu.external import JaxExternal, external_ef as jax_external_ef
from torchmd_tpu_torch import run as trun
from torchmd_tpu_torch.external import TorchExternal, external_ef

torch.set_num_threads(1)

K_WELL, EPS = 0.7, 0.3


def _well(xp, k=K_WELL, eps=EPS):
    """One energy for jnp and torch: a harmonic well about (1, 2, 3) plus
    a periodic ripple in units of the box."""
    def energy(pos, box):
        c = pos - xp.asarray([1.0, 2.0, 3.0], dtype=pos.dtype) if xp is jnp else \
            pos - torch.tensor([1.0, 2.0, 3.0], dtype=pos.dtype, device=pos.device)
        return k * (c * c).sum() + eps * xp.sin(2.0 * np.pi * pos / box).sum()
    return energy


def _inputs(nrep=2, natoms=7, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(nrep, natoms, 3) * 3.0, np.array([[11.0, 12.0, 13.0]] * nrep)


def test_torch_external_matches_autograd_and_jax():
    pos, box = _inputs()
    ext = TorchExternal(_well(torch))
    jef = jax_external_ef(JaxExternal(_well(jnp)))
    ef = external_ef(ext)
    e_b, f_b = ext.calculate(torch.as_tensor(pos), box)
    for r in range(pos.shape[0]):
        p = torch.as_tensor(pos[r]).requires_grad_(True)
        b = torch.as_tensor(box[r])
        e_ad = _well(torch)(p, b)
        (g,) = torch.autograd.grad(e_ad, p)
        e, f = ef(torch.as_tensor(pos[r]), b)
        ej, fj = jef(jnp.asarray(pos[r]), jnp.asarray(box[r]))
        for got, want in ((f, -g), (f, np.asarray(fj)), (f_b[r], -g)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-10)
        for got in (float(e), float(e_b[r])):
            assert abs(got - float(ej)) <= 1e-10 * max(1.0, abs(float(ej)))
    # an analytic energy_forces_fn replaces the autograd path
    marker = TorchExternal(_well(torch), energy_forces_fn=lambda p, b: ("e", "f"))
    assert external_ef(marker)(None, None) == ("e", "f")
    assert external_ef(None) is None and external_ef(object()) is None


def _water_forces(external=None, device="cpu", precision="double"):
    from torchmd_tpu_torch.forcefields import ForceField
    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.parameters import Parameters

    d = os.path.join(SYSTEMS_DIR, "water")
    mol = Molecule(os.path.join(d, "structure.psf"))
    mol.read(os.path.join(d, "structure.pdb"))
    terms = ["lj", "bonds", "angles", "electrostatics"]
    par = Parameters(ForceField.create(mol, os.path.join(d, "water_forcefield.yaml")),
                     mol, terms, precision=precision)
    return mol, Forces(par, terms=terms, cutoff=7.3, precision=precision,
                       device=device, external=external)


class _HostOnly:
    """An external with only the reference's batched `calculate`."""

    def calculate(self, pos, box):
        ef = external_ef(TorchExternal(_well(torch)))
        out = [ef(p, torch.as_tensor([11.0, 12.0, 13.0], dtype=p.dtype)) for p in pos]
        return (np.array([float(e) for e, _ in out]),
                np.stack([f.numpy() for _, f in out]))


@pytest.mark.parametrize("kind", ["energy_fn", "calculate"])
def test_forces_add_the_external(kind):
    """Forces(external=) = Forces() + the callable's energy and forces,
    per term, with the JAX Forces' "external" key."""
    ext = TorchExternal(_well(torch)) if kind == "energy_fn" else _HostOnly()
    mol, plain = _water_forces()
    _, withext = _water_forces(ext)
    pos = mol.coords.transpose(2, 0, 1).repeat(2, axis=0)
    pos[1] += 0.01
    box = np.array([[11.0, 12.0, 13.0]] * 2)
    d0 = plain.compute(pos, box, returnDetails=True)
    f0 = plain.last_forces.numpy()
    d1 = withext.compute(pos, box, returnDetails=True)
    f1 = withext.last_forces.numpy()
    e_ext, f_ext = TorchExternal(_well(torch)).calculate(torch.as_tensor(pos), box)
    for r in range(2):
        assert set(d1[r]) == set(d0[r]) and d0[r]["external"] == 0.0
        for k in d0[r]:
            want = d0[r][k] + (float(e_ext[r]) if k == "external" else 0.0)
            assert abs(d1[r][k] - want) <= 1e-10 * max(1.0, abs(want)), k
    np.testing.assert_allclose(f1, f0 + f_ext.numpy(), rtol=0, atol=1e-9)


def test_npt_with_external_matches_jax():
    """MTK NPT on the 216-water box (SETTLE, TIP4P sites, PME, the cell
    path) with a weak external well: the port's virial takes the
    external's energy_fn by autograd over (pos, s), as the JAX NPT scan
    does; 5 steps at f64 against the JAX package."""
    from test_torch_npt import _setup
    from test_torch_water import shared_velocities, water_box
    from torchmd_tpu import barostat as jbaro
    from torchmd_tpu.forces import Forces as JForces
    from torchmd_tpu.integrator import Integrator as JIntegrator
    from torchmd_tpu.systems import System as JSystem
    from torchmd_tpu_torch import Forces, Integrator, MTKBarostat, System

    jpar, tpar, coords, L = water_box()
    vel = shared_velocities(jpar)
    well = dict(k=1e-3, eps=0.05)
    _, js, jinteg, _ = _setup(JForces, JSystem, JIntegrator, jbaro.MTKBarostat, jpar,
                              coords, L, vel, external=JaxExternal(_well(jnp, **well)))
    _, ts, tinteg, _ = _setup(Forces, System, Integrator, MTKBarostat, tpar, coords, L,
                              vel, device="cpu", external=TorchExternal(_well(torch, **well)))
    want, got = jinteg.step(niter=5), tinteg.step(niter=5)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-9)
    np.testing.assert_allclose(ts.box_diag, np.asarray(js.box_diag), rtol=1e-10)
    assert np.abs(ts.pos - np.asarray(js.pos)).max() <= 1e-6


NPZ_POTENTIAL = """
def make_potential(embeddings, k=1.0):
    k = float(k)

    def energy_fn(pos, box):
        return k * (pos * pos).sum()

    return energy_fn
"""


def test_npz_external_run_matches_jax(tmp_path):
    """tests/test_run_external.py's run through both CLIs: one potential
    file for jnp and torch, the JAX velocities carried over, no noise."""
    rs = np.random.RandomState(0)
    npz = tmp_path / "mol.npz"
    np.savez(npz, z=np.full(8, 6), coord=rs.randn(8, 3) * 2.0, charges=np.zeros(8))
    potential = tmp_path / "well.py"
    potential.write_text(textwrap.dedent(NPZ_POTENTIAL))

    def conf(module, out):
        path = tmp_path / f"{out}.yaml"
        path.write_text(yaml.dump({
            "npz_file": str(npz), "forcefield": None, "forceterms": [],
            "external": {"module": module, "file": str(potential),
                         "embeddings": [6] * 8, "k": 0.5},
            "steps": 40, "output_period": 10, "save_period": 20, "timestep": 1.0,
            "temperature": 100, "langevin_temperature": 0, "langevin_gamma": 1.0,
            "precision": "double", "device": "cpu", "log_dir": str(tmp_path / out),
            "seed": 3}))
        return ["--conf", str(path)]

    jargs = jrun.get_args(conf("torchmd_tpu.external", "jax"))
    targs = trun.get_args(conf("torchmd_tpu_torch.external", "torch"))
    jmol, jsys, jf = jrun.setup(jargs)
    tmol, tsys, tf = trun.setup(targs)
    assert tf.external is not None
    tsys.set_velocities(np.asarray(jsys.vel))
    jrun.dynamics(jargs, jmol, jsys, jf)
    trun.dynamics(targs, tmol, tsys, tf)
    jt = np.load(tmp_path / "jax" / "output_0.npy")
    tt = np.load(tmp_path / "torch" / "output_0.npy")
    assert tt.shape == (8, 3, 4)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tsys.pos, np.asarray(jsys.pos), rtol=0, atol=1e-8)
    d = tf.compute(tsys.pos, tsys.box, returnDetails=True)[0]
    assert d["external"] == pytest.approx(0.5 * float((tsys.pos ** 2).sum()), rel=1e-12)


def _arrays_equal(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _arrays_equal(a[k], b[k], f"{what}.{k}")
        return
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, what
    assert np.array_equal(a, b), what


SYSTEMS = {
    "argon": ("argon/argon_start.pdb", None, "argon/argon_forcefield.yaml", ["lj"]),
    "oscillator": ("oscillator/dummy.pdb", None, "oscillator/oscillator_forcefield.yaml",
                   ["bonds"]),
    "water": ("water/structure.psf", "water/structure.pdb", "water/water_forcefield.yaml",
              ["lj", "bonds", "angles", "electrostatics"]),
    "cg": ("cg/cg_structure.psf", "cg/cg_structure.xtc", "cg/forcefield.yaml",
           ["bonds", "angles", "repulsioncg"]),
}


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_readers_and_ff_yaml_match_jax(name):
    from torchmd_tpu.forcefields import ForceField as JFF
    from torchmd_tpu.io import Molecule as JMol
    from torchmd_tpu.parameters import Parameters as JPar
    from torchmd_tpu_torch.forcefields import ForceField
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.parameters import Parameters

    top, coords, ffile, terms = SYSTEMS[name]
    out = []
    for M, F, P in ((JMol, JFF, JPar), (Molecule, ForceField, Parameters)):
        mol = M(os.path.join(SYSTEMS_DIR, top))
        if coords:
            mol.read(os.path.join(SYSTEMS_DIR, coords))
        ff = F.create(mol, os.path.join(SYSTEMS_DIR, ffile))
        out.append((mol, ff, P(ff, mol, terms, precision="double")))
    (jm, jff, jp), (tm, tff, tp) = out
    assert type(tff).__name__ == type(jff).__name__ == "YamlForcefield"
    for f in ("numAtoms", "name", "atomtype", "charge", "masses", "bonds", "angles",
              "dihedrals", "coords", "box", "element"):
        _arrays_equal(getattr(jm, f), getattr(tm, f), f"mol.{f}")
    for f in ("bond_params", "angle_params", "dihedral_params", "nonbonded_params",
              "charges", "masses", "mapped_atom_types"):
        _arrays_equal(getattr(jp, f), getattr(tp, f), f"par.{f}")
    assert sorted(tff.get_atom_types()) == sorted(jff.get_atom_types())


def test_xtc_npz_and_mdp_readers_match_jax(tmp_path, monkeypatch):
    from torchmd_tpu.io import mdp as jmdp, npz as jnpz, xtc as jxtc
    from torchmd_tpu_torch import native
    from torchmd_tpu_torch.io import mdp, npz, xtc

    path = os.path.join(SYSTEMS_DIR, "cg", "cg_structure.xtc")
    want = jxtc.read_xtc(path)
    assert native.available()  # g++ builds the shared host source here
    got_native = xtc.read_xtc(path)
    monkeypatch.setattr(native, "xtc_decode", lambda data: None)
    got_python = xtc.read_xtc(path)
    for got in (got_native, got_python):
        for k in ("coords", "box", "step", "time"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert native.library_path().startswith(native.BUILD_DIR)

    f = tmp_path / "m.npz"
    np.savez(f, z=np.array([6, 1, 8, 7]), coord=np.arange(12.0).reshape(4, 3),
             charges=np.array([0.1, -0.1, 0.0, 0.0]), box=np.array([10.0, 11.0, 12.0]))
    a, b = npz.read_npz(str(f)), jnpz.read_npz(str(f))
    assert set(a) == set(b)
    for k in a:
        _arrays_equal(a[k], b[k], k)

    warn = lambda *a: None  # noqa: E731
    assert (mdp.mdp_to_args(mdp.read_mdp(MDP_TEXT, is_text=True), warn=warn)
            == jmdp.mdp_to_args(jmdp.read_mdp(MDP_TEXT, is_text=True), warn=warn))
    # the --conf action: the same namespace from a YAML and from an .mdp
    conf = tmp_path / "md.mdp"
    conf.write_text(MDP_TEXT)
    base = ["--log-dir", str(tmp_path / "o"), "--device", "cpu"]
    for src in (os.path.join(SYSTEMS_DIR, "argon", "conf.yaml"), str(conf)):
        ja = vars(jrun.get_args(["--conf", src] + base))
        ta = vars(trun.get_args(["--conf", src] + base))
        ja.pop("conf"), ta.pop("conf")
        assert ja == ta


def _small_module(seed=0):
    """A restraint to the start plus a two-layer MLP over each atom's
    distance to the centroid (the chip smoke's external, at its widths)."""
    torch.manual_seed(seed)
    mlp = torch.nn.Sequential(torch.nn.Linear(1, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 1))
    return mlp


@pytest.mark.gpu
def test_external_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pos, box = _inputs(natoms=64)
    mlp = _small_module().double().cuda()

    def energy(p, b):
        d = (p - p.mean(0)).norm(dim=1, keepdim=True)
        return _well(torch)(p, b) + mlp(d).sum()

    ext = TorchExternal(energy)
    e, f = ext.calculate(torch.as_tensor(pos, device="cuda"), box)
    assert e.device.type == "cuda" and f.device.type == "cuda"
    for r in range(pos.shape[0]):
        p = torch.as_tensor(pos[r], device="cuda").requires_grad_(True)
        (g,) = torch.autograd.grad(energy(p, torch.as_tensor(box[r], device="cuda")), p)
        np.testing.assert_allclose(f[r].cpu().numpy(), -g.cpu().numpy(), rtol=0, atol=1e-10)
    mol, plain = _water_forces(device="cuda", precision="single")
    _, withext = _water_forces(TorchExternal(_well(torch)), "cuda", "single")
    p = mol.coords.transpose(2, 0, 1)
    b = np.array([[11.0, 12.0, 13.0]])
    d0, d1 = plain.compute(p, b, returnDetails=True), withext.compute(p, b, returnDetails=True)
    e_ext, f_ext = TorchExternal(_well(torch)).calculate(
        torch.as_tensor(p, dtype=torch.float32, device="cuda"), b)
    assert abs(d1[0]["external"] - float(e_ext[0])) <= 2e-5 * max(1.0, abs(float(e_ext[0])))
    want = plain.last_forces + f_ext
    assert float((withext.last_forces - want).abs().max()) <= 5e-5 * max(
        1.0, float(want.abs().max()))


@pytest.mark.gpu
def test_cli_twenty_steps_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torchmd_tpu_torch.ops import bonded as kb, nonbonded as kn

    d = os.path.join(os.path.dirname(SYSTEMS_DIR), "data", "thrombin-ligand-amber")
    n_pair, n_bonded = kn.LAUNCHES, kb.LAUNCHES
    summary = trun.main([
        "--topology", os.path.join(d, "structure.prmtop"),
        "--coordinates", os.path.join(d, "structure.pdb"),
        "--forcefield", os.path.join(d, "structure.prmtop"),
        "--forceterms", "bonds", "angles", "dihedrals", "impropers", "1-4",
        "electrostatics", "lj", "--cutoff", "7.3", "--rfa", "--timestep", "2",
        "--temperature", "300", "--langevin-temperature", "300",
        "--precision", "single", "--steps", "20", "--output-period", "10",
        "--save-period", "20", "--device", "cuda", "--log-dir", str(tmp_path)])
    assert summary["steps"] == 20
    assert kn.LAUNCHES - n_pair >= 20 and kb.LAUNCHES - n_bonded >= 20
    traj = np.load(tmp_path / "output_0.npy")
    assert traj.shape == (4676, 3, 2) and np.all(np.isfinite(traj))


def test_trr_ndx_mol2_and_charmm_match_jax(tmp_path):
    """The rest of the CLI's inputs: trr and ndx written by the port read
    back alike by both packages, benzamidine's mol2, and the CHARMM
    force field of the water system (prm + psf) through Parameters."""
    from torchmd_tpu.forcefields import ForceField as JFF
    from torchmd_tpu.io import Molecule as JMol
    from torchmd_tpu.io import ndx as jndx, trr as jtrr
    from torchmd_tpu.parameters import Parameters as JPar
    from torchmd_tpu_torch.forcefields import ForceField
    from torchmd_tpu_torch.io import Molecule, ndx, trr
    from torchmd_tpu_torch.parameters import Parameters

    rs = np.random.RandomState(1)
    coords, box = rs.rand(9, 3, 2) * 20.0, np.full((3, 2), 25.0)
    trr.write_trr(str(tmp_path / "t.trr"), coords, box)
    a, b = trr.read_trr(str(tmp_path / "t.trr")), jtrr.read_trr(str(tmp_path / "t.trr"))
    _arrays_equal(a["coords"], b["coords"], "trr coords")
    np.testing.assert_allclose(a["coords"], coords, atol=1e-4)
    groups = {"System": np.arange(9), "Water": np.array([0, 3, 6])}
    ndx.write_ndx(str(tmp_path / "i.ndx"), groups)
    a, b = ndx.read_ndx(str(tmp_path / "i.ndx")), jndx.read_ndx(str(tmp_path / "i.ndx"))
    _arrays_equal(a, b, "ndx")

    mol2 = os.path.join(os.path.dirname(SYSTEMS_DIR), "data", "benzamidine-amber", "mol.mol2")
    jm, tm = JMol(mol2), Molecule(mol2)
    for f in ("numAtoms", "name", "atomtype", "charge", "bonds", "coords", "element"):
        _arrays_equal(getattr(jm, f), getattr(tm, f), f"mol2.{f}")

    d = os.path.join(SYSTEMS_DIR, "water")
    terms = ["lj", "bonds", "angles", "electrostatics"]
    out = []
    for M, F, P in ((JMol, JFF, JPar), (Molecule, ForceField, Parameters)):
        mol = M(os.path.join(d, "structure.psf"))
        ff = F.create(mol, os.path.join(d, "parameters.prm"))
        assert type(ff).__name__ == "CharmmForcefield"
        out.append(P(ff, mol, terms, precision="double"))
    for f in ("bond_params", "angle_params", "nonbonded_params", "charges", "masses"):
        _arrays_equal(getattr(out[0], f), getattr(out[1], f), f"charmm.{f}")
