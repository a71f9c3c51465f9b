"""The port's CLI (`torchmd_tpu_torch.run`) against the JAX package's.

  - the bundled run configs (argon, oscillator, water with 2 replicas,
    coarse-grained cg with 2 replicas) go through `setup` then
    `dynamics` in both packages at f64 on the CPU, the JAX system's
    initial velocities carried into the port's System and no Langevin
    noise (`--langevin-temperature 0`): trajectories to 1e-8 A, monitor
    epot and ekin to 1e-7 relative;
  - the port's checkpoint resume with Langevin noise equals its
    continuous run (1e-8 A, the model of tests/test_run.py:89);
  - its DCD output reads back alike through both packages' readers;
  - FIRE minimisation equals the JAX run (1e-6 A), L-BFGS reaches the
    JAX run's final energy;
  - `--help` runs where `jax` and `torchmd_tpu` cannot be imported;
  - the production protocol's flags against the JAX CLI: `--constraints
    hbonds|allbonds|settle` with `--hmr 3` on the water case (NVE),
    `--thermostat csvr` and `--pressure` with each Monte Carlo
    `--barostat-mode` on argon, both packages fed the same thermostat and
    barostat draws: positions and boxes within 1e-8 A;
  - `--mts` through both CLIs, `--mts-recip` refused alike on a small
    system; checkpoint resume of r-RESPA (CLI), of the reciprocal tier
    and of the dense MTK scan with SHAKE (API);
  - the flag of an unported module (GB) raises NotImplementedError,
    `--device` accepts cuda[:k] and cpu only;
  - the f64 path selection of `Forces` (`Forces.path`, `select_path`),
    and on a card the f64 Forces against the CPU's.
"""

from __future__ import annotations

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import DATA_DIR, SYSTEMS_DIR

from torchmd_tpu import run as jrun
from torchmd_tpu.io.dcd import read_dcd as jax_read_dcd
from torchmd_tpu_torch import run as trun
from torchmd_tpu_torch.forces import Forces, select_path
from torchmd_tpu_torch.io.dcd import read_dcd

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGON = ["--structure", os.path.join(SYSTEMS_DIR, "argon", "argon_start.pdb"),
         "--forcefield", os.path.join(SYSTEMS_DIR, "argon", "argon_forcefield.yaml"),
         "--forceterms", "LJ", "--cutoff", "9.0"]
CASES = {
    "argon": ARGON + ["--steps", "40", "--output-period", "10", "--save-period", "20",
                      "--temperature", "120"],
    "oscillator": [
        "--structure", os.path.join(SYSTEMS_DIR, "oscillator", "dummy.pdb"),
        "--forcefield", os.path.join(SYSTEMS_DIR, "oscillator", "oscillator_forcefield.yaml"),
        "--forceterms", "Bonds", "--steps", "200", "--output-period", "50",
        "--save-period", "100", "--temperature", "50"],
    "water": [
        "--topology", os.path.join(SYSTEMS_DIR, "water", "structure.psf"),
        "--coordinates", os.path.join(SYSTEMS_DIR, "water", "structure.pdb"),
        "--forcefield", os.path.join(SYSTEMS_DIR, "water", "water_forcefield.yaml"),
        "--forceterms", "LJ", "Bonds", "Angles", "Electrostatics", "--cutoff", "7.3",
        "--replicas", "2", "--steps", "20", "--output-period", "10",
        "--save-period", "20", "--temperature", "300"],
    "cg": [
        "--topology", os.path.join(SYSTEMS_DIR, "cg", "cg_structure.psf"),
        "--coordinates", os.path.join(SYSTEMS_DIR, "cg", "cg_structure.xtc"),
        "--forcefield", os.path.join(SYSTEMS_DIR, "cg", "forcefield.yaml"),
        "--forceterms", "Bonds", "Angles", "RepulsionCG", "--cutoff", "7.3",
        "--replicas", "2", "--steps", "20", "--output-period", "10",
        "--save-period", "20", "--temperature", "350", "--exclusions", "bonds"],
}
NO_NOISE = ["--precision", "double", "--device", "cpu", "--langevin-temperature", "0"]


def _monitor(path):
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    return {k: np.array([float(r[k]) for r in rows]) for k in ("iter", "epot", "ekin", "T")}


def _run_pair(argv, tmp_path, carry=True):
    """(JAX args, mol, system), (port args, mol, system) after dynamics
    from the same start: the JAX system's velocities carried over."""
    jargs = jrun.get_args(argv + ["--log-dir", str(tmp_path / "jax")])
    targs = trun.get_args(argv + ["--log-dir", str(tmp_path / "torch")])
    jmol, jsys, jf = jrun.setup(jargs)
    tmol, tsys, tf = trun.setup(targs)
    if carry:
        tsys.set_velocities(np.asarray(jsys.vel))
    np.testing.assert_array_equal(tsys.pos, np.asarray(jsys.pos))
    jrun.dynamics(jargs, jmol, jsys, jf)
    trun.dynamics(targs, tmol, tsys, tf)
    return (jargs, jsys), (targs, tsys)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_jax(case, tmp_path):
    (jargs, jsys), (targs, tsys) = _run_pair(CASES[case] + NO_NOISE, tmp_path)
    np.testing.assert_allclose(tsys.pos, np.asarray(jsys.pos), rtol=0, atol=1e-8)
    for k in range(jargs.replicas):
        jt = np.load(tmp_path / "jax" / f"output_{k}.npy")
        tt = np.load(tmp_path / "torch" / f"output_{k}.npy")
        assert tt.shape == jt.shape and tt.shape[:2] == (tsys.natoms, 3)
        np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-8)
        jm = _monitor(tmp_path / "jax" / f"monitor_{k}.csv")
        tm = _monitor(tmp_path / "torch" / f"monitor_{k}.csv")
        np.testing.assert_array_equal(tm["iter"], jm["iter"])
        for key in ("epot", "ekin"):
            scale = np.maximum(1.0, np.abs(jm[key]))
            assert np.all(np.abs(tm[key] - jm[key]) <= 1e-7 * scale), (key, tm[key], jm[key])
        assert os.path.exists(tmp_path / "torch" / f"output_{k}.xyz")
    assert os.path.exists(tmp_path / "torch" / "input.yaml")


@pytest.mark.parametrize("thermostat", ["langevin", "nhc"])
def test_checkpoint_resume_with_noise(thermostat, tmp_path):
    """Langevin noise (the generator's state) and the Nose-Hoover chain
    (its aux state) come back from the checkpoint."""
    common = ARGON + ["--precision", "double", "--output-period", "10",
                      "--temperature", "120", "--langevin-temperature", "120",
                      "--thermostat", thermostat, "--device", "cpu", "--seed", "7"]

    def run(extra, d):
        args = trun.get_args(common + extra + ["--log-dir", str(tmp_path / d)])
        mol, system, forces = trun.setup(args)
        trun.dynamics(args, mol, system, forces)
        return system

    full = run(["--steps", "40"], "full")
    run(["--steps", "20", "--checkpoint-period", "20"], "part1")
    chk = tmp_path / "part1" / "output.chk"
    assert chk.exists()
    resumed = run(["--steps", "40", "--resume", str(chk)], "part2")
    np.testing.assert_allclose(resumed.pos, full.pos, rtol=0, atol=1e-8)
    np.testing.assert_allclose(resumed.vel, full.vel, rtol=0, atol=1e-8)
    assert np.abs(full.pos - run(["--steps", "40", "--seed", "8"], "other").pos).max() > 1e-6


def test_checkpoint_restores_the_mtk_state(tmp_path):
    """NPT (MTK barostat, Nose-Hoover chain, SETTLE) on the 216-water box:
    a run continued from a checkpoint, into a fresh System and
    Integrator, equals the run that went on (v_eps and both chains come
    back; the virial is recomputed)."""
    from test_torch_water import CUTOFF, TERMS, shared_velocities, water_box
    from torchmd_tpu_torch import Integrator, MTKBarostat, System
    from torchmd_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    _, tpar, coords, L = water_box()
    vel = shared_velocities(tpar)

    def build():
        forces = Forces(tpar, terms=TERMS, precision="double", cutoff=CUTOFF,
                        kernel="cell", elec="pme", device="cpu")
        s = System(coords.shape[0], 1, "double")
        s.set_positions(coords)
        s.set_box(np.full((3, 1), L))
        s.set_velocities(vel)
        forces.compute(s.pos, s.box, s.forces)
        integ = Integrator(s, forces, 2.0, T=300.0, thermostat="nhc",
                           constraints="settle", barostat=MTKBarostat(1.0, 300.0, tau_fs=200.0))
        return s, integ

    s, integ = build()
    integ.step(niter=3)
    chk = str(tmp_path / "npt.chk")
    save_checkpoint(chk, s, integ, 3)
    integ.step(niter=3)
    s2, integ2 = build()
    assert load_checkpoint(chk, s2, integ2) == 3
    integ2.step(niter=3)
    np.testing.assert_allclose(s2.pos, s.pos, rtol=0, atol=1e-10)
    np.testing.assert_allclose(s2.box_diag, s.box_diag, rtol=1e-12)
    assert not np.allclose(s.box_diag, L)
    np.testing.assert_allclose(integ2.npt_energy(), integ.npt_energy(), rtol=1e-10)
    np.testing.assert_allclose(integ2.thermostat_energy(), integ.thermostat_energy(),
                               rtol=1e-10)


def test_dcd_output_reads_alike(tmp_path):
    args = trun.get_args(ARGON + [
        "--precision", "double", "--steps", "30", "--output-period", "10",
        "--save-period", "30", "--temperature", "120", "--traj-format", "dcd",
        "--log-dir", str(tmp_path), "--device", "cpu"])
    mol, system, forces = trun.setup(args)
    trun.dynamics(args, mol, system, forces)
    path = str(tmp_path / "output_0.dcd")
    ours, theirs = read_dcd(path), jax_read_dcd(path)
    assert ours["coords"].shape == (mol.numAtoms, 3, 3)
    for k in ("coords", "box"):
        np.testing.assert_array_equal(ours[k], theirs[k])
    np.testing.assert_allclose(ours["coords"][:, :, -1], system.pos[0], atol=1e-4)
    assert np.all(ours["box"][:, 0] > 70)


def _argon_pair(tmp_path):
    argv = ARGON + ["--precision", "double", "--device", "cpu", "--temperature", "10"]
    jargs = jrun.get_args(argv + ["--log-dir", str(tmp_path / "jax")])
    targs = trun.get_args(argv + ["--log-dir", str(tmp_path / "torch")])
    return jrun.setup(jargs), trun.setup(targs)


def test_fire_matches_jax(tmp_path):
    from torchmd_tpu.minimizers import minimize_fire as jfire
    from torchmd_tpu_torch.minimizers import minimize_fire

    (_, jsys, jf), (_, tsys, tf) = _argon_pair(tmp_path)
    je = jfire(jsys, jf, steps=50)
    te = minimize_fire(tsys, tf, steps=50)
    np.testing.assert_allclose(tsys.pos, np.asarray(jsys.pos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(te, je, rtol=1e-6, atol=1e-9)
    assert te[-1] < te[0]


@pytest.mark.parametrize("case", ["argon", "water"])
def test_pressure_matches_jax(case, tmp_path):
    """The virial by autograd through a box scaling against jax.jvp: the
    argon gas and the water box (LJ, Coulomb with a cutoff, bonds,
    angles) in its CRYST1 box."""
    from torchmd_tpu.observables import pressure as jpressure
    from torchmd_tpu_torch.observables import pressure

    if case == "argon":
        (_, jsys, jf), (_, tsys, tf) = _argon_pair(tmp_path)
    else:
        argv = CASES["water"] + NO_NOISE
        jsys, jf = jrun.setup(jrun.get_args(argv + ["--log-dir", str(tmp_path / "j")]))[1:]
        tsys, tf = trun.setup(trun.get_args(argv + ["--log-dir", str(tmp_path / "t")]))[1:]
        for s in (jsys, tsys):
            s.set_box(np.array([16.919, 16.633, 16.639]))
    tsys.set_velocities(np.asarray(jsys.vel))
    pj, pt = jpressure(jf, jsys), pressure(tf, tsys)
    assert np.isfinite(pt).all() and pt.shape == pj.shape
    np.testing.assert_allclose(pt, pj, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", ["argon", "water"])
def test_pressure_on_the_cell_path_matches_jax(case, tmp_path):
    """The cell path (kernel="cell", no dense mask): the pair kernel's
    per-axis virial, PME's analytic one and autograd for the rest against
    jax.jvp through the JAX package's cell kernel. Argon at a 9 A cutoff;
    the 216-water TIP4P/2005 box (virtual sites, SETTLE bonds, PME) at a
    4 A cutoff on 3x3x3 cells."""
    from test_torch_water import CUTOFF, TERMS, shared_velocities, water_box

    from torchmd_tpu.forces import Forces as JaxForces
    from torchmd_tpu.observables import pressure as jpressure
    from torchmd_tpu.systems import System as JaxSystem
    from torchmd_tpu_torch.observables import pressure
    from torchmd_tpu_torch.systems import System

    if case == "argon":
        (_, jsys, jf), (_, tsys, tf) = _argon_pair(tmp_path)
        jf = JaxForces(jf.par, terms=jf.energies, cutoff=9.0, kernel="cell")
        tf = Forces(tf.par, terms=tf.energies, cutoff=9.0, kernel="cell", device="cpu")
        tsys.set_velocities(np.asarray(jsys.vel))
    else:
        jpar, tpar, coords, L = water_box()
        kw = dict(terms=TERMS, precision="double", cutoff=CUTOFF, kernel="cell",
                  elec="pme")
        jf, tf = JaxForces(jpar, **kw), Forces(tpar, device="cpu", **kw)
        vel = shared_velocities(jpar)
        jsys, tsys = JaxSystem(coords.shape[0], 1, "double"), System(coords.shape[0], 1,
                                                                     "double")
        for s in (jsys, tsys):
            s.set_positions(coords)
            s.set_box(np.full((3, 1), L))
            s.set_velocities(vel)
    jf.ensure_cell_kernel(np.asarray(jsys.box_diag)[0])
    # the JAX Forces sets up its reciprocal term at the first evaluation;
    # before it, its pressure leaves PME out
    jf.compute(jsys.pos, jsys.box)
    pj, pt = jpressure(jf, jsys), pressure(tf, tsys)
    assert tf.nb_path == "cell" and tf.ffparams.nb_mask is None
    assert np.isfinite(pt).all() and pt.shape == pj.shape
    np.testing.assert_allclose(pt, pj, rtol=1e-9, atol=1e-9)


def test_lbfgs_reaches_the_jax_energy(tmp_path):
    """Different L-BFGS implementations (optax, torch.optim) on
    benzamidine in vacuum (18 atoms, 7 terms): held by the converged
    energy, not by the path."""
    from torchmd_tpu.minimizers import minimize_lbfgs as jlbfgs
    from torchmd_tpu_torch.minimizers import minimize_lbfgs

    d = os.path.join(DATA_DIR, "benzamidine-amber")
    argv = ["--topology", os.path.join(d, "structure.prmtop"),
            "--coordinates", os.path.join(d, "structure.pdb"),
            "--forcefield", os.path.join(d, "structure.prmtop"),
            "--forceterms", "bonds", "angles", "dihedrals", "impropers", "1-4",
            "electrostatics", "lj", "--cutoff", "9", "--precision", "double",
            "--device", "cpu"]
    _, jsys, jf = jrun.setup(jrun.get_args(argv + ["--log-dir", str(tmp_path / "j")]))
    _, tsys, tf = trun.setup(trun.get_args(argv + ["--log-dir", str(tmp_path / "t")]))
    e0 = tf.compute(tsys.pos, tsys.box)[0]
    jlbfgs(jsys, jf, steps=10, max_iter=20, verbose=False)
    energies = minimize_lbfgs(tsys, tf, steps=10, max_iter=20, verbose=False)
    ej = jf.compute(np.asarray(jsys.pos), jsys.box)[0]
    et = tf.compute(tsys.pos, tsys.box)[0]
    assert et < e0 - 1.0 and energies[-1] == pytest.approx(et, abs=1e-12)
    assert abs(et - ej) <= 1e-9 * max(1.0, abs(ej)), (et, ej)


def test_help_without_jax(tmp_path):
    script = ("import sys, runpy\n"
              "sys.modules['torchmd_tpu'] = None\nsys.modules['jax'] = None\n"
              "sys.argv = ['run', '--help', '--log-dir', sys.argv[1]]\n"
              "runpy.run_module('torchmd_tpu_torch.run', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--external" in out.stdout and "--device" in out.stdout


PRODUCTION = {
    "water-hbonds-hmr": ("water", ["--constraints", "hbonds", "--hmr", "3"]),
    "water-allbonds": ("water", ["--constraints", "allbonds"]),
    "water-settle-hmr": ("water", ["--constraints", "settle", "--hmr", "3",
                                   "--timestep", "2"]),
    "argon-csvr": ("argon", ["--thermostat", "csvr", "--langevin-temperature", "120",
                             "--thermostat-tau", "50"]),
    "argon-mc-iso": ("argon", ["--pressure", "300", "--barostat-mode", "iso"]),
    "argon-mc-aniso": ("argon", ["--pressure", "300", "--barostat-mode", "aniso"]),
    "argon-mc-membrane": ("argon", ["--pressure", "300", "--barostat-mode", "membrane",
                                    "--surface-tension", "20"]),
}


def _shared_draws(monkeypatch):
    """The same barostat and CSVR draws in both packages: one U(0, 1)
    sequence read in the order each package draws (the JAX package's
    randint as floor(u * n)), CSVR's normal and gamma fixed."""
    import jax
    import jax.numpy as jnp

    from test_torch_mc_barostat import _patch_jax_draws, _patch_port_draws
    from torchmd_tpu_torch.barostat import MonteCarloBarostat

    u = np.random.RandomState(5).rand(1000)
    jit, tit = iter(u), iter(u)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.full(shape, next(jit)))
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.full(
        shape, lo + int(next(jit) * (hi - lo)), jnp.int32))
    monkeypatch.setattr(MonteCarloBarostat, "uniform", lambda self, n: np.full(n, next(tit)))
    _patch_jax_draws(monkeypatch)
    _patch_port_draws(monkeypatch)


@pytest.mark.parametrize("case", sorted(PRODUCTION))
def test_production_flags_match_jax(case, tmp_path, monkeypatch):
    base, extra = PRODUCTION[case]
    argv = (CASES[base] + ["--precision", "double", "--device", "cpu", "--seed", "3"]
            + (["--langevin-temperature", "0"] if "--langevin-temperature" not in extra
               else []) + extra)
    jargs = jrun.get_args(argv + ["--log-dir", str(tmp_path / "jax")])
    targs = trun.get_args(argv + ["--log-dir", str(tmp_path / "torch")])
    jmol, jsys, jf = jrun.setup(jargs)
    tmol, tsys, tf = trun.setup(targs)
    tsys.set_velocities(np.asarray(jsys.vel))
    if "--hmr" in extra:
        # the System carries the repartitioned masses, the parameters the
        # force field's (the JAX CLI writes them into its parameters)
        np.testing.assert_allclose(tsys.masses, np.asarray(jf.par.masses), rtol=1e-15)
        assert not np.allclose(np.asarray(tf.par.masses), tsys.masses)
    _shared_draws(monkeypatch)
    jrun.dynamics(jargs, jmol, jsys, jf)
    trun.dynamics(targs, tmol, tsys, tf)
    np.testing.assert_allclose(tsys.box, np.asarray(jsys.box), rtol=1e-12)
    np.testing.assert_allclose(tsys.pos, np.asarray(jsys.pos), rtol=0, atol=1e-8)
    if "--pressure" in extra:
        assert not np.allclose(tsys.box_diag, 77.395)  # a move was accepted
    jm = _monitor(tmp_path / "jax" / "monitor_0.csv")
    tm = _monitor(tmp_path / "torch" / "monitor_0.csv")
    for key in ("epot", "ekin", "T"):
        scale = np.maximum(1.0, np.abs(jm[key]))
        assert np.all(np.abs(tm[key] - jm[key]) <= 1e-7 * scale), (key, tm[key], jm[key])


@pytest.mark.parametrize("extra", [["--mts", "2"], ["--mts", "3", "--thermostat", "nhc",
                                                    "--langevin-temperature", "300"]],
                         ids=["mts2-nve", "mts3-nhc"])
def test_mts_flags_match_jax(extra, tmp_path):
    """`--mts` through both CLIs on the water case (two replicas, dense
    path): trajectories within 1e-8 A. `--mts-recip` on this small
    system (no neighbour-list path) raises alike in both packages."""
    argv = CASES["water"] + NO_NOISE[:-2] + extra
    if "--langevin-temperature" not in extra:
        argv += NO_NOISE[-2:]
    (jargs, jsys), (targs, tsys) = _run_pair(argv, tmp_path)
    assert targs.mts == int(extra[1])
    np.testing.assert_allclose(tsys.pos, np.asarray(jsys.pos), rtol=0, atol=1e-8)
    tm = _monitor(tmp_path / "torch" / "monitor_0.csv")
    jm = _monitor(tmp_path / "jax" / "monitor_0.csv")
    for key in ("epot", "ekin"):
        assert np.all(np.abs(tm[key] - jm[key]) <= 1e-7 * np.maximum(1.0, np.abs(jm[key])))
    for pkg, d in ((jrun, "jax2"), (trun, "torch2")):
        args = pkg.get_args(CASES["water"] + NO_NOISE + ["--mts-recip", "2",
                                                         "--log-dir", str(tmp_path / d)])
        mol, system, forces = pkg.setup(args)
        with pytest.raises(NotImplementedError, match="mts_recip"):
            pkg.dynamics(args, mol, system, forces)


def test_checkpoint_resume_with_mts(tmp_path):
    """An r-RESPA run (`--mts 2`, Langevin noise) resumed from its
    checkpoint equals the continuous run: the System's forces hold the
    carried slow forces, and each chunk evaluates the bonded tier afresh."""
    common = CASES["water"][:-8] + ["--precision", "double", "--output-period", "10",
                                    "--temperature", "300", "--langevin-temperature",
                                    "300", "--device", "cpu", "--seed", "7", "--mts", "2",
                                    "--replicas", "1"]

    def run(extra, d):
        args = trun.get_args(common + extra + ["--log-dir", str(tmp_path / d)])
        mol, system, forces = trun.setup(args)
        trun.dynamics(args, mol, system, forces)
        return system

    full = run(["--steps", "40"], "full")
    run(["--steps", "20", "--checkpoint-period", "20"], "part1")
    resumed = run(["--steps", "40", "--resume", str(tmp_path / "part1" / "output.chk")],
                  "part2")
    np.testing.assert_allclose(resumed.pos, full.pos, rtol=0, atol=1e-8)
    np.testing.assert_allclose(resumed.forces, full.forces, rtol=0, atol=1e-8)


@pytest.mark.parametrize("case", ["mts-recip-cell", "dense-npt-shake"])
def test_checkpoint_restores_slice6_state(case, tmp_path):
    """A run continued from a checkpoint into a fresh System and
    Integrator equals the run that went on: r-RESPA with the reciprocal
    tier on the 216-water box's cell path (mts 2, mts_recip 2), and the
    dense MTK scan with SHAKE on the alanine box (its carried virial holds
    the SHAKE term)."""
    from torchmd_tpu_torch import Integrator, MTKBarostat, System
    from torchmd_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    if case == "mts-recip-cell":
        from test_torch_water import CUTOFF, TERMS, shared_velocities, water_box

        _, par, coords, L = water_box()
        box = np.full((3, 1), L)
        fkw = dict(terms=TERMS, cutoff=CUTOFF, kernel="cell", elec="pme")
        ikw = dict(T=300.0, thermostat="nhc", constraints="settle", mts=2, mts_recip=2)
        vel, steps = shared_velocities(par), 2
    else:
        from test_torch_npt_dense import ALANINE_NB, _alanine

        from common import ALL_TERMS

        mol, par, vel = _alanine()
        coords, box = mol.coords, mol.box
        fkw = dict(terms=ALL_TERMS, **ALANINE_NB)
        ikw = dict(T=300.0, thermostat="nhc", constraints="hbonds",
                   barostat=MTKBarostat(1.0, 300.0, tau_fs=200.0))
        steps = 3

    def build():
        forces = Forces(par, precision="double", device="cpu", **fkw)
        s = System(coords.shape[0], 1, "double")
        s.set_positions(coords)
        s.set_box(box)
        s.set_velocities(vel)
        forces.compute(s.pos, s.box, s.forces)
        return s, Integrator(s, forces, 2.0, **ikw)

    s, integ = build()
    integ.step(niter=steps)
    chk = str(tmp_path / "run.chk")
    save_checkpoint(chk, s, integ, steps)
    integ.step(niter=steps)
    s2, integ2 = build()
    assert load_checkpoint(chk, s2, integ2) == steps
    integ2.step(niter=steps)
    np.testing.assert_allclose(s2.pos, s.pos, rtol=0, atol=1e-10)
    np.testing.assert_allclose(s2.box_diag, s.box_diag, rtol=1e-12)
    np.testing.assert_allclose(integ2.npt_energy(), integ.npt_energy(), rtol=1e-10)
    np.testing.assert_allclose(integ2.thermostat_energy(), integ.thermostat_energy(),
                               rtol=1e-10)


@pytest.mark.parametrize("extra", [["--gbsa"]])
def test_unported_flags_raise(extra, tmp_path):
    """No CLI flag names an unported module any more: `--gbsa`, the last
    one, builds GB/OBC (argon's PDB has no prmtop radii: the element
    defaults) as the external potential."""
    from torchmd_tpu_torch.gb import default_radii

    args = trun.get_args(ARGON + ["--device", "cpu", "--log-dir", str(tmp_path)] + extra)
    mol, system, forces = trun.setup(args)
    radii, _ = default_radii(mol.element)
    assert forces.external is not None and np.all(radii == 1.5)
    e = forces.external.energy_fn(torch.as_tensor(system.pos[0], dtype=torch.float64), None)
    assert torch.isfinite(e)


def test_gbsa_cli_matches_jax(tmp_path):
    """`--gbsa` on the ligand's prmtop (its RADII and SCREEN) through both
    CLIs at f64, 10 steps: positions within 1e-8 A, energies 1e-7."""
    d = os.path.join(DATA_DIR, "ligand-amber")
    argv = ["--topology", os.path.join(d, "structure.prmtop"),
            "--coordinates", os.path.join(d, "structure.pdb"),
            "--forcefield", os.path.join(d, "structure.prmtop"),
            "--forceterms", "bonds", "angles", "dihedrals", "impropers", "1-4",
            "electrostatics", "lj", "--cutoff", "9", "--gbsa", "--steps", "10",
            "--output-period", "5", "--save-period", "10", "--temperature", "300"]
    (jargs, jsys), (targs, tsys) = _run_pair(argv + NO_NOISE, tmp_path)
    np.testing.assert_allclose(tsys.pos, np.asarray(jsys.pos), rtol=0, atol=1e-8)
    jm, tm = _monitor(tmp_path / "jax" / "monitor_0.csv"), _monitor(tmp_path / "torch" /
                                                                    "monitor_0.csv")
    for key in ("epot", "ekin"):
        assert np.all(np.abs(tm[key] - jm[key]) <= 1e-7 * np.maximum(1.0, np.abs(jm[key])))


def test_device_flag():
    assert trun.resolve_cli_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="cuda"):
        trun.resolve_cli_device("tpu")
    if not torch.cuda.is_available():
        for name in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="--device cpu"):
                trun.resolve_cli_device(name)


def _argon_forces(precision, device, **kw):
    from torchmd_tpu_torch.forcefields import ForceField
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.parameters import Parameters

    mol = Molecule(os.path.join(SYSTEMS_DIR, "argon", "argon_start.pdb"))
    ff = ForceField.create(mol, os.path.join(SYSTEMS_DIR, "argon", "argon_forcefield.yaml"))
    par = Parameters(ff, mol, ["lj"], precision=precision)
    return mol, Forces(par, terms=["lj"], cutoff=9.0, precision=precision,
                       device=device, **kw)


def test_f64_path_selection():
    """f64 on the card takes the torch-op path (the CUDA kernels are f32
    only, as the JAX package gives Pallas only f32); kernel='cell' there
    raises; on the CPU the kernel wrappers run their plain versions."""
    assert _argon_forces("double", "cpu")[1].path == "kernels"
    assert _argon_forces("single", "cpu")[1].path == "kernels"
    assert _argon_forces("double", "cpu", kernel="dense")[1].path == "torch-ops"
    assert _argon_forces("double", "cpu", plain=True)[1].path == "torch-ops"
    assert not _argon_forces("double", "cpu", kernel="dense")[1].use_kernels
    f64, f32 = torch.float64, torch.float32
    assert select_path("auto", False, "cuda", f64) == "torch-ops"
    assert select_path("auto", False, "cuda:0", f32) == "kernels"
    assert select_path("cell", False, "cuda", f32) == "kernels"
    assert select_path("cell", True, "cuda", f64) == "torch-ops"
    with pytest.raises(ValueError, match="single precision"):
        select_path("cell", False, "cuda", f64)


@pytest.mark.gpu
def test_f64_forces_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mol, fc = _argon_forces("double", "cuda")
    _, fh = _argon_forces("double", "cpu")
    assert fc.path == "torch-ops"
    pos, box = mol.coords.transpose(2, 0, 1), mol.box.T
    ec, eh = fc.compute(pos, box)[0], fh.compute(pos, box)[0]
    assert abs(ec - eh) <= 1e-9 * max(1.0, abs(eh))
    Fc, Fh = fc.last_forces.cpu().numpy(), fh.last_forces.numpy()
    assert np.abs(Fc - Fh).max() <= 1e-9 * max(1.0, np.abs(Fh).max())
