"""The port's Verlet lists (`neighbors.VerletKernel`, Forces(kernel=
"verlet")) against the JAX package at f64 on the CPU.

Small size: the solvated alanine dipeptide (688 atoms) in its ACEMD box
(cutoff 9 A, switching from 7.5 A, reaction field) and without a box
(cutoff 7.3 A).

  - the list and the per-term energies and forces of one evaluation
    against the JAX `VerletKernel` (1e-7 per term), with and without a
    box, and against the port's dense path;
  - capacity: a list sized too small overflows, `Forces.prepare` grows
    it until the rows fit, and the Integrator's retry names the capacity
    it grew;
  - no automatic choice: kernel="auto" keeps the dense path where the
    JAX package's TMD_AUTO_VERLET_N would take the lists (the build forms
    (natoms, natoms) arrays, beyond the card at its 100,000 atoms);
  - Forces(kernel="verlet") trajectories (SETTLE, NHC, 2 x 10 steps)
    against the JAX package's Verlet scan: the standard step, and r-RESPA
    with the exact Ewald sum's reciprocal tier (mts 2, mts_recip 2),
    1e-8 A;
  - on the card (gpu marker): the list's energies and forces at f32
    against the CPU's at f64.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import ALL_TERMS, load_system
from conftest import DATA_DIR

from torchmd_tpu import neighbors as jnb
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.integrator import Integrator as JaxIntegrator
from torchmd_tpu.parameters import Parameters
from torchmd_tpu.systems import System as JaxSystem
from torchmd_tpu.units import BOLTZMANN
from torchmd_tpu_torch import Forces, Integrator, System
from torchmd_tpu_torch import forces as tforces
from torchmd_tpu_torch import neighbors as tnb
from torchmd_tpu_torch.interop import ffparams_from_numpy

torch.set_num_threads(1)

BOXED = dict(cutoff=9.0, switch_dist=7.5, rfa=True)
OPEN = dict(cutoff=7.3, rfa=True)


@functools.lru_cache(maxsize=None)
def _alanine():
    mol, ff, _ = load_system(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    m = np.asarray(par.masses, np.float64).reshape(1, -1, 1)
    vel = np.random.RandomState(2).randn(1, mol.numAtoms, 3) * np.sqrt(BOLTZMANN * 300.0 / m)
    return mol, par, vel


@pytest.mark.parametrize("boxed", [True, False], ids=["box", "open"])
def test_verlet_kernel_matches_jax(boxed):
    mol, par, _ = _alanine()
    nb = BOXED if boxed else OPEN
    pos = mol.coords[:, :, 0]
    box = mol.box.reshape(-1) if boxed else None
    jf = JaxForces(par, terms=ALL_TERMS, precision="double", kernel="verlet", **nb)
    jkern = jnb.VerletKernel(jf.ffparams, jf.config, box=box, pos0=pos)
    tffp = ffparams_from_numpy(jax.tree_util.tree_map(np.asarray, jf.ffparams))
    tkern = tnb.VerletKernel(tffp, jf.config, box=box, pos0=pos)
    assert tkern.vcfg == jkern.vcfg
    jbox = None if box is None else jnp.asarray(box)
    tbox = None if box is None else torch.as_tensor(box)
    jnl = jkern.build(jnp.asarray(pos), jbox)
    tnl = tkern.build(torch.as_tensor(pos), tbox)
    np.testing.assert_array_equal(tnl.nbr.numpy(), np.asarray(jnl.nbr))
    assert not bool(tnl.overflow)
    jpot, jfrc = jkern.energy_forces(jnp.asarray(pos), jbox, jnl)
    tpot, tfrc = tkern.energy_forces(torch.as_tensor(pos), tbox, tnl)
    assert set(tpot) == set(jpot)
    for k, w in jpot.items():
        assert abs(float(tpot[k]) - float(w)) <= 1e-7 * max(1.0, abs(float(w))), k
    jfrc = np.asarray(jfrc)
    assert np.abs(tfrc.numpy() - jfrc).max() <= 1e-7 * max(1.0, np.abs(jfrc).max())
    # the whole Forces against the JAX package's and against the port's
    # dense path (same pairs within the cutoff)
    b = mol.box.reshape(1, 3) if boxed else None
    out = []
    for F, kw in ((JaxForces, dict(kernel="verlet")),
                  (Forces, dict(kernel="verlet", device="cpu")),
                  (Forces, dict(kernel="dense", device="cpu"))):
        f = F(par, terms=ALL_TERMS, precision="double", **nb, **kw)
        frc = np.zeros((1, mol.numAtoms, 3))
        out.append((f.compute(pos[None], b, frc, returnDetails=True)[0], frc))
    assert isinstance(f, Forces)
    (je, jf_), (te, tf_), (de, df_) = out
    for k, w in je.items():
        assert abs(te[k] - w) <= 1e-7 * max(1.0, abs(w)), (k, te[k], w)
        assert abs(de[k] - w) <= 1e-7 * max(1.0, abs(w)), (k, de[k], w)
    assert np.abs(tf_ - jf_).max() <= 1e-7 * max(1.0, np.abs(jf_).max())
    assert np.abs(df_ - jf_).max() <= 1e-7 * max(1.0, np.abs(jf_).max())


def test_verlet_capacity_grows_on_overflow():
    mol, par, vel = _alanine()
    pos = torch.as_tensor(mol.coords[:, :, 0])
    box = torch.as_tensor(mol.box.reshape(-1))
    forces = Forces(par, terms=ALL_TERMS, precision="double", kernel="verlet",
                    device="cpu", **BOXED)
    want = forces.compute(pos[None].numpy(), mol.box.reshape(1, 3))[0]
    kern = forces._cell_kernel
    assert isinstance(kern, tnb.VerletKernel)
    occupancy = int(kern.build(pos, box).nbr.lt(mol.numAtoms).sum(1).max())
    cap = occupancy // 3
    small = tnb.VerletKernel(forces.ffparams, forces.config, box=mol.box.reshape(-1),
                             capacity=cap)
    assert bool(small.build(pos, box).overflow) and small.grow().capacity == 2 * cap
    forces.set_cell_kernel(small)
    got = forces.compute(pos[None].numpy(), mol.box.reshape(1, 3))[0]
    assert forces._cell_kernel.capacity == 4 * cap >= occupancy
    assert abs(got - want) <= 1e-9 * abs(want)
    s = System(mol.numAtoms, 1, "double")
    s.set_positions(mol.coords)
    s.set_box(mol.box)
    s.set_velocities(vel)
    integ = Integrator(s, forces, 2.0, T=300.0, thermostat="nhc", constraints="settle")
    cap = forces._cell_kernel.capacity
    integ._grow()
    assert integ.overflow_log == [   # doubled, at most every atom
        f"Verlet list capacity (neighbours per atom): {cap} -> "
        f"{min(mol.numAtoms, 2 * cap)}"]
    integ.step(niter=2)
    assert np.isfinite(s.pos).all() and forces._cell_kernel.rebuilds >= 1


def test_verlet_auto_selection(monkeypatch):
    """kernel='auto' never takes Verlet lists: where the JAX package's
    TMD_AUTO_VERLET_N would take them (no box, or a box that hosts no
    27-cell grid), the port keeps the dense path, and so does the
    Integrator, which reads the forces' choice (`Forces.nb_path`)."""
    mol, par, vel = _alanine()
    assert not hasattr(tforces, "VERLET_AUTO_N")
    monkeypatch.setenv("TMD_AUTO_VERLET_N", "500")
    jf = JaxForces(par, terms=ALL_TERMS, precision="double", **OPEN)
    box = mol.box.reshape(-1)
    for b in (None, box):
        assert jf.wants_verlet(b) is True
        f = Forces(par, terms=ALL_TERMS, precision="double", device="cpu", **OPEN)
        assert not f.wants_verlet(b)
        s = System(mol.numAtoms, 1, "double")
        s.set_positions(mol.coords)
        if b is not None:
            s.set_box(mol.box)
        s.set_velocities(vel)
        f.compute(s.pos, s.box, s.forces)
        assert f.nb_path == "dense" and f._cell_kernel is None
        integ = Integrator(s, f, 2.0)
        assert not (integ._use_verlet or integ._use_cell)
    f = Forces(par, terms=ALL_TERMS, precision="double", device="cpu", kernel="verlet",
               **OPEN)
    f.compute(mol.coords[:, :, 0][None], None)
    assert f.nb_path == "verlet" and isinstance(f._cell_kernel, tnb.VerletKernel)


def _verlet_run(F, S, I, dev, elec=None, **kw):
    mol, par, vel = _alanine()
    nb = dict(cutoff=9.0, switch_dist=7.5, elec=elec) if elec else BOXED
    forces = F(par, terms=ALL_TERMS, precision="double", kernel="verlet", **nb, **dev)
    s = S(mol.numAtoms, 1, "double")
    s.set_positions(mol.coords)
    s.set_box(mol.box)
    s.set_velocities(vel)
    forces.compute(s.pos, s.box, s.forces)
    integ = I(s, forces, 2.0, T=300.0, thermostat="nhc", constraints="settle", **kw)
    out = [integ.step(niter=10) for _ in range(2)]
    return np.asarray(s.pos).copy(), out, integ


@pytest.mark.parametrize("case", ["standard", "mts-recip-ewald"])
def test_verlet_trajectory_matches_jax(case):
    kw = dict(elec="ewald", mts=2, mts_recip=2) if case != "standard" else {}
    jpos, jout, jinteg = _verlet_run(JaxForces, JaxSystem, JaxIntegrator, {}, **kw)
    tpos, tout, tinteg = _verlet_run(Forces, System, Integrator, dict(device="cpu"), **kw)
    assert jinteg._use_verlet and tinteg._use_verlet
    assert isinstance(tinteg.forces._cell_kernel, tnb.VerletKernel)
    assert np.abs(tpos - jpos).max() <= 1e-8
    for a, b in zip(jout, tout):
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=1e-9)


@pytest.mark.gpu
def test_verlet_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mol, par, _ = _alanine()
    out = {}
    for dev, prec in (("cpu", "double"), ("cuda", "single")):
        f = Forces(par, terms=ALL_TERMS, precision=prec, kernel="verlet", device=dev,
                   **BOXED)
        frc = np.zeros((1, mol.numAtoms, 3))
        out[dev] = (f.compute(mol.coords[:, :, 0][None], mol.box.reshape(1, 3), frc,
                              returnDetails=True)[0], frc)
    for k, w in out["cpu"][0].items():
        assert abs(out["cuda"][0][k] - w) <= 1e-4 * max(1.0, abs(w)), k
    f64 = out["cpu"][1]
    assert np.abs(out["cuda"][1] - f64).max() <= 1e-4 * max(1.0, np.abs(f64).max())
