"""The periodic water-box slice of the port against the JAX package at f64.

Small size: the 216-water TIP4P/2005 box of tests/test_gromacs.py (864
sites, 19.5 A box), cutoff 4 A, PME order 6 on a 40^3 mesh. Inputs are
built from a seed with numpy and handed to both packages.

  - SETTLE positions and velocities, virtual sites (every construction
    kind: snap and force spreading) and the Nose-Hoover chain equal the
    JAX functions on identical inputs (1e-10 absolute or tighter);
  - the whole slice, Forces(kernel="cell", elec="pme") + Integrator(T=300,
    thermostat="nhc", constraints="settle") from shared velocities:
    per-term energies at step 0 within 1e-7 relative, positions after
    2 x 10 steps within 1e-6 A, Ekin/Epot/T and the thermostat energy
    within 1e-9 relative, the SETTLE bonds held and the sites snapped.
"""

from __future__ import annotations

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_gromacs import TIP4P2005_TOP, tip4p_water

from torchmd_tpu import constraints as jcon
from torchmd_tpu import thermostats as jthermo
from torchmd_tpu import vsites as jvs
from torchmd_tpu.forcefields import ForceField as JaxForceField
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.integrator import Integrator as JaxIntegrator
from torchmd_tpu.io import Molecule as JaxMolecule
from torchmd_tpu.parameters import Parameters as JaxParameters
from torchmd_tpu.systems import System as JaxSystem
from torchmd_tpu_torch import Forces, Integrator, System
from torchmd_tpu_torch import constraints as tcon
from torchmd_tpu_torch import interop
from torchmd_tpu_torch import thermostats as tthermo
from torchmd_tpu_torch import vsites as tvs
from torchmd_tpu_torch.forcefields import ForceField
from torchmd_tpu_torch.io import Molecule
from torchmd_tpu_torch.parameters import Parameters
from torchmd_tpu_torch.units import BOLTZMANN

# one intra-op thread per test process: the suite runs under xdist, and
# a pool of one thread per core in every worker oversubscribes the CPU
torch.set_num_threads(1)

TERMS = ["bonds", "lj", "electrostatics"]
CUTOFF = 4.0


@functools.lru_cache(maxsize=None)
def water_box(n=6, spacing=3.25):
    """(JAX Parameters, port Parameters, lattice coords (N, 3), box edge):
    n^3 TIP4P/2005 waters at `spacing`, offset 0.9 A (the M rows at O)."""
    with tempfile.TemporaryDirectory() as td:
        top = os.path.join(td, "tip4p.top")
        with open(top, "w") as fh:
            fh.write(TIP4P2005_TOP.replace("SOL 2", f"SOL {n**3}"))
        pars = []
        for M, FF, P in ((JaxMolecule, JaxForceField, JaxParameters),
                         (Molecule, ForceField, Parameters)):
            mol = M(top)
            pars.append(P(FF.create(mol, top), mol, TERMS, precision="double"))
    coords = np.concatenate([
        tip4p_water(np.array([ix, iy, iz]) * spacing + 0.9)
        for ix in range(n) for iy in range(n) for iz in range(n)])
    return pars[0], pars[1], coords, n * spacing


def shared_velocities(par, seed=9, T=300.0):
    """Maxwell-Boltzmann velocities from numpy (zero on massless rows)."""
    m = np.asarray(par.masses, np.float64).reshape(-1, 1)
    rs = np.random.RandomState(seed)
    std = np.sqrt(BOLTZMANN * T / np.where(m > 0, m, 1.0)) * (m > 0)
    return (rs.randn(1, m.shape[0], 3) * std)


def jittered(coords, seed, scale):
    return coords + np.random.RandomState(seed).randn(*coords.shape) * scale


# ----------------------------------------------------------------------
# SETTLE
# ----------------------------------------------------------------------

def test_settle_matches_jax():
    jpar, tpar, coords, _ = water_box()
    masses = np.asarray(jpar.masses)
    jss = jcon.build_settle(jpar, masses)
    tss = tcon.build_settle(tpar, masses)
    for f in tcon.SettleSet._fields:
        np.testing.assert_allclose(getattr(tss, f).numpy(), np.asarray(getattr(jss, f)),
                                   rtol=1e-15, atol=0, err_msg=f)
    ss = interop.settle_from_numpy(jss)
    ref = jittered(coords, 1, 0.0)
    new = jittered(coords, 2, 0.05)
    want = np.asarray(jcon.settle_positions(jss, jnp.asarray(new), jnp.asarray(ref)))
    got = tcon.settle_positions(ss, torch.as_tensor(new), torch.as_tensor(ref)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert float(tcon.max_settle_error(ss, torch.as_tensor(got))) < 1e-10
    vel = np.random.RandomState(3).randn(*coords.shape)
    want_v = np.asarray(jcon.settle_velocities(jss, jnp.asarray(want), jnp.asarray(vel)))
    got_v = tcon.settle_velocities(ss, torch.as_tensor(got), torch.as_tensor(vel)).numpy()
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-10)
    # a leading replica axis passes through
    two = tcon.settle_positions(ss, torch.as_tensor(np.stack([new, new])),
                                torch.as_tensor(np.stack([ref, ref]))).numpy()
    np.testing.assert_allclose(two[1], got, rtol=0, atol=1e-14)


def test_settle_spec_counts_constraints_and_rejects_shake():
    jpar, tpar, _, _ = water_box()
    masses = np.asarray(jpar.masses)
    spec = tcon.build_constraint_spec(tpar, masses, mode="settle")
    assert spec.ncon == jcon.build_constraint_spec(jpar, masses, mode="settle").ncon
    with pytest.raises(NotImplementedError, match="SHAKE"):
        tcon.build_constraint_spec(tpar, masses, mode="hbonds")


# ----------------------------------------------------------------------
# Virtual sites
# ----------------------------------------------------------------------

VSITE_ROWS = [  # (site, hosts...), nhosts kind, funct, raw GROMACS params
    ((0, 1, 2), 2, 1, [0.3]),
    ((3, 4, 5), 2, 2, [0.05]),
    ((6, 7, 8, 9), 3, 1, [0.2, 0.3]),
    ((10, 11, 12, 13), 3, 2, [0.4, 0.08]),
    ((14, 15, 16, 17), 3, 3, [110.0, 0.09]),
    ((18, 19, 20, 21), 3, 4, [0.3, 0.4, 2.0]),
    ((22, 23, 24, 25, 26), 4, 2, [0.7, 0.9, 0.1]),
]


@pytest.mark.parametrize("kinds", ["tip4p", "all"])
def test_vsites_match_jax(kinds):
    rows = VSITE_ROWS[2:3] if kinds == "tip4p" else VSITE_ROWS
    jg = jvs.build_vsite_groups(rows)
    tg = tvs.build_vsite_groups(rows)
    assert [g.kind for g in tg] == [tuple(g.kind) for g in jg]
    for g, h in zip(jg, tg):
        np.testing.assert_allclose(h.params.numpy(), np.asarray(g.params), rtol=1e-15)
    groups = interop.vsite_groups_from_numpy(jg)
    rs = np.random.RandomState(5)
    pos = rs.uniform(0.0, 6.0, (27, 3))
    frc = rs.randn(27, 3)
    box = np.full(3, 6.5)
    want = np.asarray(jvs.apply_vsites(jg, jnp.asarray(pos), jnp.asarray(box)))
    got = tvs.apply_vsites(groups, torch.as_tensor(pos), torch.as_tensor(box)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    want_f = np.asarray(jvs.spread_vsite_forces(jg, jnp.asarray(pos), jnp.asarray(frc),
                                                jnp.asarray(box)))
    got_f = tvs.spread_vsite_forces(groups, torch.as_tensor(pos), torch.as_tensor(frc),
                                    torch.as_tensor(box)).numpy()
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=1e-12)
    mask = tvs.vsite_mask(groups, 27)
    assert np.array_equal(mask, jvs.vsite_mask(jg, 27))


# ----------------------------------------------------------------------
# Nose-Hoover chain
# ----------------------------------------------------------------------

def test_nose_hoover_chain_matches_jax():
    rs = np.random.RandomState(4)
    masses = rs.uniform(1.0, 16.0, (40, 1))
    masses[::4] = 0.0
    vel = rs.randn(2, 40, 3) * 0.01
    ndof, dt = 3 * 30, 2.0 / 48.88821
    jn = jthermo.make_thermostat("nhc", 300.0, 200.0, ndof)
    tn = tthermo.make_thermostat("nhc", 300.0, 200.0, ndof)
    jaux = {"xi": jnp.asarray(rs.randn(2, 3) * 0.1), "vxi": jnp.asarray(rs.randn(2, 3))}
    taux = interop.nhc_state_from_numpy(jaux)
    jv = jnp.asarray(vel)
    tv = torch.as_tensor(vel)
    jm, tm = jnp.asarray(masses), torch.as_tensor(masses)
    for _ in range(3):
        jv, jaux = jax.vmap(lambda v, a: jn.pre(v, a, jm, dt))(jv, jaux)
        tv, taux = tn.pre(tv, taux, tm, dt)
        jv, jaux = jax.vmap(lambda v, a: jn.post(v, a, jm, dt))(jv, jaux)
        tv, taux = tn.post(tv, taux, tm, dt)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12, atol=1e-15)
    for k in ("xi", "vxi"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), rtol=1e-12)
    np.testing.assert_allclose(tn.conserved(taux).numpy(),
                               np.asarray(jn.conserved(jaux)), rtol=1e-12)
    with pytest.raises(NotImplementedError, match="CSVR"):
        tthermo.make_thermostat("csvr", 300.0, 200.0, ndof)


# ----------------------------------------------------------------------
# The slice as a whole
# ----------------------------------------------------------------------

def _run_slice(Fc, Sc, Ic, par, coords, L, vel, **device):
    forces = Fc(par, terms=TERMS, precision="double", cutoff=CUTOFF,
                kernel="cell", elec="pme", **device)
    s = Sc(coords.shape[0], 1, "double")
    s.set_positions(coords)
    s.set_box(np.full((3, 1), L))
    s.set_velocities(vel)
    e0 = forces.compute(s.pos, s.box, returnDetails=True)[0]
    integ = Ic(s, forces, 2.0, T=300.0, thermostat="nhc", constraints="settle")
    chunks = [integ.step(niter=10) for _ in range(2)]
    return e0, s.pos[0].copy(), chunks, integ.thermostat_energy()


def test_water_slice_matches_jax():
    jpar, tpar, coords, L = water_box()
    vel = shared_velocities(jpar)
    je0, jpos, jchunks, jthe = _run_slice(JaxForces, JaxSystem, JaxIntegrator,
                                          jpar, coords, L, vel)
    te0, tpos, tchunks, tthe = _run_slice(Forces, System, Integrator, tpar,
                                          coords, L, vel, device="cpu")
    assert set(je0) == set(te0)
    for k in je0:
        assert abs(te0[k] - je0[k]) <= 1e-7 * max(1.0, abs(je0[k])), (k, te0[k], je0[k])
    assert np.abs(tpos - jpos).max() <= 1e-6
    for want, got in zip(jchunks, tchunks):
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, rtol=1e-9)
    np.testing.assert_allclose(tthe, jthe, rtol=1e-9)
    pos = torch.as_tensor(tpos)
    ss = tcon.build_settle(tpar, np.asarray(tpar.masses))
    assert float(tcon.max_settle_error(ss, pos)) < 1e-9
    box = torch.full((3,), L, dtype=torch.float64)
    groups = tvs.vsite_groups_to(tpar.vsites, "cpu", torch.float64)
    snapped = tvs.apply_vsites(groups, pos, box)
    sites = groups[0].sites
    assert float((snapped[sites] - pos[sites]).abs().max()) < 1e-12


def test_water_box_bonded_plan_has_no_rows():
    """TIP4P/2005's only bonds are the SETTLE triangles' zero-force-constant
    ones: the kernel path's bonded plan has no rows (no launch), and the
    bond energy stays a 0 term."""
    _, tpar, coords, L = water_box()
    forces = Forces(tpar, terms=TERMS, precision="double", cutoff=CUTOFF,
                    kernel="cell", elec="pme", device="cpu")
    plan = forces._bonded_plan
    assert plan.families == () and plan.zero_terms == ("bonds",)
    e = forces.compute(coords[None], np.full((1, 3), L), returnDetails=True)[0]
    assert e["bonds"] == 0.0 and np.isfinite(e["electrostatics"])


@pytest.mark.gpu
def test_water_slice_on_cuda_matches_cpu_plain_path():
    """Kernel path (f32, card) against the plain path (f64, CPU): step-0
    energies at the Pallas bars and positions after 10 NVT steps, on the
    cell kernel (column=False: the column kernel is the card's default and
    has its own test in test_torch_npt.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from torchmd_tpu_torch.ops import cell as kc
    from torchmd_tpu_torch.ops import pme as kp

    _, tpar, coords, L = water_box()
    vel = shared_velocities(tpar)
    out = {}
    for dev, prec in (("cpu", "double"), ("cuda", "single")):
        forces = Forces(tpar, terms=TERMS, precision=prec, cutoff=CUTOFF,
                        kernel="cell", elec="pme", device=dev, column=False)
        s = System(coords.shape[0], 1, prec)
        s.set_positions(coords)
        s.set_box(np.full((3, 1), L))
        s.set_velocities(vel)
        e0 = forces.compute(s.pos, s.box, returnDetails=True)[0]
        launches = (kc.LAUNCHES, kp.SPREAD_LAUNCHES, kp.GATHER_LAUNCHES)
        Integrator(s, forces, 2.0, T=300.0, thermostat="nhc",
                   constraints="settle").step(niter=10)
        if dev == "cuda":
            assert all(a - b >= 10 for a, b in zip(
                (kc.LAUNCHES, kp.SPREAD_LAUNCHES, kp.GATHER_LAUNCHES), launches))
        out[dev] = (e0, s.pos.astype(np.float64))
    # the PME electrostatics is a small sum of large terms: its f32 error
    # scales with the self energy's magnitude (~6e4 kcal/mol here, one f32
    # rounding ~4e-3), not with the total (~60); held to 1e-6 of it
    q = np.asarray(tpar.charges, np.float64)
    alpha = forces._ewald.cfg.alpha
    scale = {"electrostatics": 332.0637 * alpha / np.sqrt(np.pi) * (q * q).sum()}
    for k, v in out["cpu"][0].items():
        err = abs(out["cuda"][0][k] - v)
        print(f"step-0 {k}: |dE| {err:.3e} of {v:.6g} (scale {scale.get(k, 0.0):.6g})")
        if k in scale:
            assert err <= 1e-6 * scale[k], k
        else:
            assert err <= 2e-5 * max(1.0, abs(v)), k
    dev = np.abs(out["cuda"][1] - out["cpu"][1]).max()
    print(f"positions after 10 steps: max |d| {dev:.3e} A")
    assert dev <= 2e-3
