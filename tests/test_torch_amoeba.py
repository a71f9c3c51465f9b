"""The port's AMOEBA stack (`torchmd_tpu_torch.amoeba`) against the JAX
package at f64, on the water dimer.

  - the .prm and .xyz readers, frame resolution, polarization groups and
    the Thole factors equal the JAX ones;
  - the real-space Thole polarization: induced dipoles within 1e-7
    relative, energy within 1e-7 relative and forces (autograd through
    the detached SCF solution against jax.grad) within 1e-7 of the
    largest, without and with a cutoff;
  - the Ewald-split polarization on a 12 A box (the exact engine, the
    permanent quadrupoles dropped so that the JAX gradient compiles in
    seconds; the full stack with them is test_torch_amoeba_ewald.py):
    induced dipoles, energy and forces likewise;
  - the buffered 14-7 vdW with its hydrogen reduction sites;
  - the dimer binding scan of tests/test_amoeba.py
    (test_full_amoeba_water_dimer_binding_curve) point by point, as
    parity: the port's energies equal the JAX ones at every O-O
    distance, wherever the minimum falls;
  - 10 steps of `Forces(terms=[], external=pot)` + `Integrator` on the
    flexible dimer (the complete real-space AMOEBA energy, valence
    included) from shared velocities, no thermostat noise: positions
    within 1e-8 A of the JAX trajectory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_multipoles import (WATER03_PRM, WATER_DIMER_XYZ, _Ffp, dimer, jax_ffparams,
                                   water_mask)

from torchmd_tpu import amoeba as jam
from torchmd_tpu_torch import amoeba as tam
from torchmd_tpu_torch import interop

torch.set_num_threads(1)

WATER03_VDW = WATER03_PRM + """
vdw           1               3.4050     0.1100
vdw           2               2.6550     0.0135      0.910
"""

WATER03_FULL = WATER03_VDW + """
bond-cubic              -2.55
bond-quartic            3.793125
angle-cubic             -0.014
angle-quartic           0.000056
angle-pentic            -0.0000007
angle-sextic            0.000000022

bond          1    2          529.60     0.9572
angle         2    1    2      34.05     108.50
ureybrad      2    1    2      38.25     1.5537
"""

L, CUTOFF = 12.0, 5.5
BOX = np.full(3, L)


def both(prm_text, nwater=2, **kw):
    """(JAX, port) make_amoeba_potential of `nwater` waters (types 1, 2, 2)."""
    types = np.tile([1, 2, 2], nwater)
    bonds = np.concatenate([[[m, m + 1], [m, m + 2]] for m in range(0, 3 * nwater, 3)])
    mask = water_mask(nwater)
    jp, jq = jam.make_amoeba_potential(jax_ffparams(mask), types, bonds,
                                       jam.parse_tinker_prm(prm_text), **kw)
    tp, tq = tam.make_amoeba_potential(_Ffp(mask), types, bonds,
                                       tam.parse_tinker_prm(prm_text), device="cpu", **kw)
    np.testing.assert_array_equal(tq, jq)
    return jp, tp


def check(jfn, tfn, pos, box=None, grad=True):
    """Energy (1e-7 relative) and forces (1e-7 of the largest) of a JAX
    and a port energy function at `pos`."""
    jb = None if box is None else jnp.asarray(box)
    tb = None if box is None else torch.as_tensor(box)
    x = torch.as_tensor(pos).requires_grad_(True)
    et = tfn(x, tb)
    if grad:
        ej, gj = jax.jit(jax.value_and_grad(lambda p: jfn(p, jb)))(jnp.asarray(pos))
        (gt,) = torch.autograd.grad(et, x)
        gj = np.asarray(gj)
        assert np.abs(gt.numpy() - gj).max() <= 1e-7 * max(1.0, np.abs(gj).max())
    else:
        ej = jfn(jnp.asarray(pos), jb)
    ej, et = float(ej), float(et.detach())
    assert abs(et - ej) <= 1e-7 * max(1.0, abs(ej)), (et, ej)
    return et


def test_readers_match_jax(tmp_path):
    jp, tp = jam.parse_tinker_prm(WATER03_FULL), tam.parse_tinker_prm(WATER03_FULL)
    for k in ("polarize", "atoms", "vdw"):
        assert jp[k] == tp[k], k
    assert jp["multipoles"].keys() == tp["multipoles"].keys()
    xyz_box = WATER_DIMER_XYZ.replace("\n", "\n 18.0 18.0 18.0 90.0 90.0 90.0\n", 1)
    path = tmp_path / "dimer.xyz"
    path.write_text(xyz_box)
    for src in (WATER_DIMER_XYZ, xyz_box, str(path)):
        for a, b in zip(jam.read_tinker_xyz(src), tam.read_tinker_xyz(src)):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError):
        tam.read_tinker_xyz("1\n 9.0 9.0 9.0 90.0 90.0 60.0\n 1 O 0. 0. 0. 1\n")


def test_frames_groups_and_thole_match_jax():
    _, types, bonds = dimer()
    rec = jam.parse_tinker_prm(WATER03_PRM)["polarize"]
    np.testing.assert_array_equal(tam.polarization_groups(types, bonds, rec),
                                  jam.polarization_groups(types, bonds, rec))
    rs = np.random.RandomState(0)
    d2, a, ai, aj = rs.rand(4, 20) + 0.3
    want = jam._thole_lambdas(jnp.asarray(d2), jnp.asarray(a), jnp.asarray(ai),
                              jnp.asarray(aj), jnp.float64)
    got = tam._thole_lambdas(*(torch.as_tensor(v) for v in (d2, a, ai, aj)))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14)
    q = tam._tinker_quad_to_jackson(np.diag([0.37928, -0.41809, 0.03881]))
    np.testing.assert_array_equal(
        q, jam._tinker_quad_to_jackson(np.diag([0.37928, -0.41809, 0.03881])))


@pytest.mark.parametrize("cutoff", [None, 3.2])
def test_real_space_polarization_matches_jax(cutoff):
    jp, tp = both(WATER03_PRM, cutoff=cutoff)
    jpol, tpol = jp.parts[0].polarization, tp.parts[0].polarization
    assert type(tpol).__name__ == "AmoebaPolarization"
    for seed in (0, 1):
        pos = dimer(seed, 0.06)[0]
        mj = np.asarray(jpol.induced_dipoles(jnp.asarray(pos), None))
        mt = tpol.induced_dipoles(torch.as_tensor(pos)).numpy()
        assert np.abs(mt - mj).max() <= 1e-7 * np.abs(mj).max()
        assert 0 < int(tpol.last_cg_iters) <= tpol.pspec.cg_iters
        check(jpol.energy_fn, tpol.energy_fn, pos)
        check(jp.parts[0].energy_fn, tp.parts[0].energy_fn, pos)


def test_ewald_polarization_matches_jax():
    """The Ewald-split solver (exact engine) with the quadrupoles dropped
    from the shared spec: both CG solves see the same periodic
    couplings, the direct-field and mutual patches included."""
    jp, tp = both(WATER03_PRM, cutoff=CUTOFF, ewald=True, box=BOX, ewald_tol=1e-4,
                  pme=False)
    jpol = jp.parts[0].polarization
    spec = jpol.engine.spec._replace(quad_local=None)
    jeng = type(jpol.engine)(spec, jpol.engine.charges, BOX, CUTOFF, tol=1e-4)
    jpol = jam.AmoebaPolarizationEwald(jeng, jpol.pspec)
    np_spec = jax.tree_util.tree_map(np.asarray, spec)
    teng = tam.MultipoleEwald(interop.multipole_spec_from_numpy(np_spec),
                              np.asarray(jeng.charges), BOX, CUTOFF, tol=1e-4)
    pspec = interop.polarization_spec_from_numpy(
        jax.tree_util.tree_map(np.asarray, jpol.pspec))
    tpol = tam.AmoebaPolarizationEwald(teng, pspec)
    pos = dimer(2, 0.06)[0] + np.array([L / 2, L / 2, 9.5])
    pos = pos - L * np.floor(pos / L)
    bj = jnp.asarray(BOX)
    mj = np.asarray(jax.jit(lambda p: jpol.induced_dipoles(p, bj))(jnp.asarray(pos)))
    mt = tpol.induced_dipoles(torch.as_tensor(pos), torch.as_tensor(BOX)).numpy()
    assert np.abs(mt - mj).max() <= 1e-7 * np.abs(mj).max()
    ej, gj = jax.jit(jax.value_and_grad(lambda p: jpol.energy_fn(p, bj)))(jnp.asarray(pos))
    x = torch.as_tensor(pos).requires_grad_(True)
    et = tpol.energy_fn(x, torch.as_tensor(BOX))
    (gt,) = torch.autograd.grad(et, x)
    assert abs(float(et.detach()) - float(ej)) <= 1e-7 * max(1.0, abs(float(ej)))
    assert np.abs(gt.numpy() - np.asarray(gj)).max() <= 1e-7 * np.abs(np.asarray(gj)).max()
    assert float(et.detach()) < 0.0


@pytest.mark.parametrize("kw", [dict(), dict(cutoff=3.2, switch_dist=2.6)],
                         ids=["no-cutoff", "switch"])
def test_vdw_matches_jax(kw):
    jp, tp = both(WATER03_VDW, mutual=False, **kw)
    jv, tv = jp.parts[-1], tp.parts[-1]
    assert type(tv).__name__ == "AmoebaVdw" and tv.part_name == "vdw"
    for seed in (3, 4):
        check(jv.energy_fn, tv.energy_fn, dimer(seed, 0.1)[0])


def test_binding_scan_matches_jax():
    """The rigid hydrogen-bonded dimer of the JAX binding-curve test
    scanned over the O-O distance: the port's AMOEBA energy (permanent
    multipoles, mutual polarization, monopole Coulomb, 14-7 vdW) equals
    the JAX one at every point (1e-7 relative of the interaction); the
    minimum is wherever the JAX package puts it."""
    from test_amoeba import _hbond_dimer

    jp, tp = both(WATER03_VDW, charge_charge=True)
    jfn = jax.jit(lambda p: jp.energy_fn(p, None))
    ds = np.concatenate([np.linspace(2.5, 3.4, 19), [60.0]])
    ej = np.array([float(jfn(jnp.asarray(_hbond_dimer(d)))) for d in ds])
    et = np.array([float(tp.energy_fn(torch.as_tensor(_hbond_dimer(d)))) for d in ds])
    bind_j, bind_t = ej[:-1] - ej[-1], et[:-1] - et[-1]
    assert np.abs(bind_t - bind_j).max() <= 1e-7 * np.abs(bind_j).max()
    assert np.argmin(bind_t) == np.argmin(bind_j)


def _dimer_md(pkg, pot, coords, vel, nsteps):
    """Positions after `nsteps` of Forces(terms=[], external=pot) +
    Integrator (0.5 fs, no thermostat noise) in the JAX package or the
    port."""
    if pkg == "jax":
        from torchmd_tpu.forcefields.ff_yaml import YamlForcefield
        from torchmd_tpu.forces import Forces
        from torchmd_tpu.integrator import Integrator
        from torchmd_tpu.io import Molecule
        from torchmd_tpu.parameters import Parameters
        from torchmd_tpu.systems import System
        dev = {}
    else:
        from torchmd_tpu_torch.forcefields.ff_yaml import YamlForcefield
        from torchmd_tpu_torch.forces import Forces
        from torchmd_tpu_torch.integrator import Integrator
        from torchmd_tpu_torch.io import Molecule
        from torchmd_tpu_torch.parameters import Parameters
        from torchmd_tpu_torch.systems import System
        dev = {"device": "cpu"}
    n = coords.shape[0]
    mol = Molecule()
    mol.numAtoms = n
    mol.atomtype = np.array(["OW", "HW", "HW"] * (n // 3), dtype=object)
    mol.charge = np.zeros(n)
    mol.masses = np.array([15.995, 1.008, 1.008] * (n // 3))
    mol.bonds = np.zeros((0, 2), np.int64)
    mol.coords = coords[:, :, None].copy()
    mol.box = np.zeros((3, 1))
    ff = YamlForcefield(mol, {"atomtypes": ["OW", "HW"],
                              "masses": {"OW": 15.995, "HW": 1.008}})
    par = Parameters(ff, mol, [], precision="double")
    forces = Forces(par, terms=[], external=pot, precision="double", **dev)
    system = System(n, 1, "double")
    system.set_positions(mol.coords)
    system.set_velocities(vel)
    integ = Integrator(system, forces, 0.5, gamma=0.0, T=0.0, **dev)
    integ.step(niter=nsteps)
    return np.asarray(system.pos)[0]


def test_dimer_md_matches_jax():
    jp, tp = both(WATER03_FULL, charge_charge=True, valence=True, cg_iters=60, cg_tol=1e-10)
    assert [p.part_name for p in tp.parts[1:]] == ["charge_charge", "vdw", "valence"]
    coords = dimer(7, 0.03)[0]
    vel = (np.random.RandomState(8).randn(1, 6, 3)
           * np.sqrt(0.0019872 * 150.0 / np.array([15.995, 1.008, 1.008] * 2))[None, :, None])
    pj = _dimer_md("jax", jp, coords, vel, 10)
    pt = _dimer_md("torch", tp, coords, vel, 10)
    assert np.abs(pj - coords).max() > 1e-3        # the waters moved
    assert np.abs(pt - pj).max() <= 1e-8


@pytest.mark.gpu
def test_amoeba_potential_on_the_card():
    """The full AMOEBA potential (Ewald, PME, mutual polarization with
    the fixed-count CG, vdW, valence) on 8 waters in f32 on the card
    against f64 on the card: parts, forces, induced dipoles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rs = np.random.RandomState(9)
    base, types, _ = dimer(9, 0.0)
    pos = np.concatenate([base[:3] + np.array([i, j, k]) * 3.1 + rs.randn(3) * 0.2
                          for i in range(2) for j in range(2) for k in range(2)]) + 0.5
    box = np.full(3, 12.0)
    out = {}
    for dt in (torch.float64, torch.float32):
        types = np.tile([1, 2, 2], 8)
        bonds = np.concatenate([[[m, m + 1], [m, m + 2]] for m in range(0, 24, 3)])
        pot, _ = tam.make_amoeba_potential(_Ffp(water_mask(8)), types, bonds,
                                           tam.parse_tinker_prm(WATER03_FULL), cutoff=5.5,
                                           switch_dist=5.0, ewald=True, box=box, pme=True,
                                           valence=True, device="cuda")
        x = torch.as_tensor(pos, dtype=dt, device="cuda").requires_grad_(True)
        b = torch.as_tensor(box, dtype=dt, device="cuda")
        parts = pot.energy_parts(x, b)
        (g,) = torch.autograd.grad(sum(parts.values()), x)
        mu = pot.parts[0].polarization.induced_dipoles(x.detach(), b)
        out[dt] = ({k: float(v) for k, v in parts.items()}, g.double().cpu().numpy(),
                   mu.double().cpu().numpy())
    ref, got = out[torch.float64], out[torch.float32]
    for k, v in ref[0].items():
        assert abs(got[0][k] - v) <= 2e-4 * max(1.0, abs(v)), (k, got[0][k], v)
    assert np.abs(got[1] - ref[1]).max() <= 1e-4 * np.abs(ref[1]).max()
    assert np.abs(got[2] - ref[2]).max() <= 1e-4 * np.abs(ref[2]).max()
