"""The port's slice end to end through its public entry points, against
the JAX package at f64.

  - `Forces.compute` per-term energies and forces on alanine dipeptide and
    the ligand equal the JAX `Forces.compute` (1e-7), on the kernel path
    (plain versions on the CPU) and on the dense torch-op path;
  - the JAX FFParams handed over as numpy (`ffparams_from_numpy`) give the
    same energies;
  - a short Langevin run through Parameters -> Forces -> System ->
    Integrator gives finite numbers;
  - importing every module of the port loads no jax;
  - options of later slices raise NotImplementedError naming their
    ROADMAP item; those of this slice (Verlet lists, the exact Ewald sum,
    r-RESPA) run.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import ALL_TERMS, load_system
from conftest import DATA_DIR

from torchmd_tpu import potentials as jpot
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.parameters import Parameters
from torchmd_tpu_torch import Forces, Integrator, System, maxwell_boltzmann
from torchmd_tpu_torch import potentials as tpot
from torchmd_tpu_torch.interop import ffparams_from_numpy

# one intra-op thread per test process: the suite runs under xdist, and
# a pool of one thread per core in every worker oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYSTEMS = {
    "alanine": ("prod_alanine_dipeptide_amber",
                dict(cutoff=9.0, switch_dist=7.5, rfa=True)),
    "ligand": ("ligand-amber", {}),
}
SLICE_MODULES = (
    "torchmd_tpu_torch", "torchmd_tpu_torch.systems",
    "torchmd_tpu_torch.potentials", "torchmd_tpu_torch.bonded",
    "torchmd_tpu_torch.forces", "torchmd_tpu_torch.integrator",
    "torchmd_tpu_torch.interop", "torchmd_tpu_torch.ops",
    "torchmd_tpu_torch.ops._build", "torchmd_tpu_torch.ops.nonbonded",
    "torchmd_tpu_torch.ops.bonded", "torchmd_tpu_torch.ewald",
    "torchmd_tpu_torch.neighbors", "torchmd_tpu_torch.constraints",
    "torchmd_tpu_torch.checkpoint", "torchmd_tpu_torch.run",
    "torchmd_tpu_torch.multipoles", "torchmd_tpu_torch.multipole_ewald",
    "torchmd_tpu_torch.amoeba_valence", "torchmd_tpu_torch.amoeba",
)
# names of the JAX package's __all__ whose modules are not ported yet
# (ROADMAP item 20: drude, viz, train; item 21: parallel)
UNPORTED_NAMES = ("make_drude", "DrudeIntegrator", "make_drude_ewald", "view_frame",
                  "train", "parallel")


def _system(name):
    folder, nb = SYSTEMS[name]
    mol, ff, _ = load_system(os.path.join(DATA_DIR, folder))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    return mol, par, nb


@pytest.mark.parametrize("kernel", ["auto", "dense"])
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_forces_compute_matches_jax(name, kernel):
    mol, par, nb = _system(name)
    pos = np.repeat(mol.coords[:, :, 0][None], 2, axis=0)
    pos[1] += 0.01 * np.random.RandomState(0).randn(*pos[1].shape)
    box = np.repeat(mol.box[:, 0][None], 2, axis=0)
    jf = JaxForces(par, terms=ALL_TERMS, precision="double", **nb)
    tf = Forces(par, terms=ALL_TERMS, precision="double", kernel=kernel,
                device="cpu", **nb)
    jforces = np.zeros_like(pos)
    tforces = np.zeros_like(pos)
    want = jf.compute(pos, box, jforces, returnDetails=True)
    got = tf.compute(pos, box, tforces, returnDetails=True)
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-7 * max(1.0, abs(w[k])), (k, g[k], w[k])
    scale = max(1.0, np.abs(jforces).max())
    assert np.abs(tforces - jforces).max() <= 1e-7 * scale
    totals = tf.compute(pos, box)
    np.testing.assert_allclose(totals, [sum(w.values()) for w in want],
                               rtol=1e-9)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_ffparams_from_numpy_gives_the_same_energies(name):
    mol, par, nb = _system(name)
    jf = JaxForces(par, terms=ALL_TERMS, precision="double", **nb)
    ffp = ffparams_from_numpy(jax.tree_util.tree_map(np.asarray, jf.ffparams))
    assert ffp.nb_mask.dtype == torch.bool
    assert ffp.bonds.idx.dtype == torch.int64
    cfg = tpot.ForceTermConfig(**jf.config._asdict())
    pos = mol.coords[:, :, 0].astype(np.float64)
    box = mol.box[:, 0].astype(np.float64)
    tbox = torch.as_tensor(box) if np.any(box) else None
    jbox = jnp.asarray(box) if np.any(box) else None
    jcfg = jf.config
    want = jax.jit(lambda f, p, b: jpot.compute_potentials(f, p, b, jcfg))(
        jf.ffparams, jnp.asarray(pos), jbox)
    got = tpot.compute_potentials(ffp, torch.as_tensor(pos), tbox, cfg)
    same = tpot.compute_potentials(tpot.make_ffparams(par, dtype=torch.float64),
                                   torch.as_tensor(pos), tbox, cfg)
    for k in want:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= 1e-7 * max(1.0, abs(w)), k
        assert float(got[k]) == float(same[k]), k


def test_langevin_run_through_public_entry_points():
    mol, par, nb = _system("alanine")
    forces = Forces(par, terms=ALL_TERMS, precision="single", device="cpu", **nb)
    system = System(mol.numAtoms, 1, "single")
    system.set_positions(mol.coords)
    system.set_box(mol.box)
    gen = torch.Generator().manual_seed(1)
    system.set_velocities(maxwell_boltzmann(par.masses, 300.0, generator=gen))
    integ = Integrator(system, forces, 1.0, gamma=0.1, T=300.0, seed=2)
    Ekin, Epot, T = integ.step(niter=5)
    assert np.isfinite(Ekin).all() and np.isfinite(Epot).all()
    assert 100.0 < T[0] < 600.0
    assert system.pos.dtype == np.float32 and np.isfinite(system.pos).all()


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import torchmd_tpu_torch as t\n"
        "for name in t._LAZY:\n"
        "    getattr(t, name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'torchmd_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_exports_the_jax_names():
    """Every name of the JAX package's __all__ resolves in the port (a
    lazy name or a submodule), but for the unported modules' names."""
    import importlib

    import torchmd_tpu
    import torchmd_tpu_torch

    want = [n for n in torchmd_tpu.__all__ if n not in UNPORTED_NAMES]
    missing = [n for n in want if n not in torchmd_tpu_torch.__all__]
    assert not missing, missing
    for name in want:
        if name in torchmd_tpu_torch._LAZY:
            assert getattr(torchmd_tpu_torch, name) is not None, name
        else:
            importlib.import_module(f"torchmd_tpu_torch.{name}")
    assert set(UNPORTED_NAMES) <= set(torchmd_tpu.__all__)
    assert not set(UNPORTED_NAMES) & set(torchmd_tpu_torch.__all__)


@pytest.mark.parametrize("kwargs, item", [
    (dict(mesh=object()), "21"), (dict(batch=np.zeros(52, int)), None),
    (dict(T=np.array([300.0]), gamma=1.0), None),
])
def test_later_slices_raise_not_implemented(kwargs, item):
    """Options of later slices raise NotImplementedError naming their
    ROADMAP item: the device mesh. Atom batching and per-replica
    temperatures (item 11b) are ported and step (as Verlet lists, the
    exact Ewald sum and r-RESPA: test_later_slice_options_run)."""
    mol, par, _ = _system("ligand")
    forces = Forces(par, terms=ALL_TERMS, precision="double", device="cpu")
    system = System(mol.numAtoms, 1, "double")
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            Integrator(system, forces, 1.0, **kwargs)
        return
    system.set_positions(mol.coords)
    forces.compute(system.pos, system.box, system.forces)
    ekin, epot, T = Integrator(system, forces, 1.0, **kwargs).step(niter=2)
    assert np.all(np.isfinite(T)) and np.all(np.isfinite(system.pos))


@pytest.mark.parametrize("kwargs", [
    dict(kernel="verlet", cutoff=9.0), dict(elec="ewald", cutoff=9.0), dict(mts=2)],
    ids=["verlet", "ewald", "mts"])
def test_later_slice_options_run(kwargs):
    """Verlet lists, the exact Ewald sum below PME_AUTO_N atoms and
    r-RESPA, which raised before this slice, now run: the ligand in a
    40 A box, two steps."""
    from torchmd_tpu_torch.ewald import EwaldRecip
    from torchmd_tpu_torch.neighbors import VerletKernel

    mol, par, _ = _system("ligand")
    integ_kw = {k: kwargs.pop(k) for k in ("mts",) if k in kwargs}
    forces = Forces(par, terms=ALL_TERMS, precision="double", device="cpu", **kwargs)
    s = System(mol.numAtoms, 1, "double")
    s.set_positions(mol.coords)
    s.set_box(np.full((3, 1), 40.0))
    forces.compute(s.pos, s.box, s.forces)
    integ = Integrator(s, forces, 1.0, **integ_kw)
    ek, ep, _ = integ.step(niter=2)
    assert np.isfinite([ek[0], ep[0]]).all() and np.isfinite(s.pos).all()
    if "kernel" in kwargs:
        assert isinstance(forces._cell_kernel, VerletKernel)
    if "elec" in kwargs:
        assert isinstance(forces._ewald, EwaldRecip)


def test_kernel_path_on_cuda_needs_single_precision():
    """The CUDA kernels are f32: asking for the cell kernel at f64 on the
    card raises at construction instead of falling back to another path
    (kernel='auto' at f64 selects the torch-op path by rule, as the JAX
    package does: tests/test_torch_run.py::test_f64_path_selection)."""
    _, par, _ = _system("ligand")
    with pytest.raises(ValueError, match="single precision"):
        Forces(par, terms=ALL_TERMS, precision="double", device="cuda",
               kernel="cell", cutoff=9.0)


@pytest.mark.gpu
def test_slice_on_cuda_matches_cpu_plain_path():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from torchmd_tpu_torch.ops import bonded as kb
    from torchmd_tpu_torch.ops import nonbonded as kn

    mol, par, nb = _system("alanine")
    pos, box = mol.coords[:, :, 0][None], mol.box[:, 0][None]
    cpu = Forces(par, terms=ALL_TERMS, precision="double", device="cpu", **nb)
    gpu = Forces(par, terms=ALL_TERMS, precision="single", device="cuda", **nb)
    n_pair, n_bonded = kn.LAUNCHES, kb.LAUNCHES
    want = cpu.compute(pos, box, returnDetails=True)[0]
    got = gpu.compute(pos, box, returnDetails=True)[0]
    assert kn.LAUNCHES == n_pair + 1 and kb.LAUNCHES == n_bonded + 1
    for k in want:
        assert abs(got[k] - want[k]) <= 2e-5 * max(1.0, abs(want[k])), k
    f_cpu = cpu.last_forces.numpy()
    f_gpu = gpu.last_forces.double().cpu().numpy()
    assert np.abs(f_gpu - f_cpu).max() <= 5e-5 * max(1.0, np.abs(f_cpu).max())
