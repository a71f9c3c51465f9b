"""The port's halo-exchange MD (`torchmd_tpu_torch.parallel.HaloMD`)
against the JAX package on the CPU, over gloo process groups of 2 and 4
ranks (module fixtures; the ranks run `mesh_workers`, which imports no
JAX):

  - `make_halo_spec` equal to the JAX package's, field by field, and
    raising where it raises;
  - `Mesh.ppermute` in both transports along axes of 1, 2 and 4 ranks;
  - a zero-velocity step at f64 on 2 slabs and 2 x 2 pencils for a
    charged gas (reaction field), chains with the bonded terms and CMAP,
    an NBFIX gas and chains under classic Ewald: the energy within 1e-10
    relative of the JAX package's dense f64 `compute_potentials` and the
    forces recovered from the half-kick within 1e-9 of max |F|;
  - f32 NVE of a hot gas against the JAX `HaloMD` on the same mesh shape
    at its own tolerances (tests/test_halo.py:104-106), through
    migrations the port counts;
  - TIP4P/2005 with SETTLE and M sites at f64: 10 NVE steps within 1e-8 A
    of the port's unsharded `Integrator`, on 2 and 4 ranks;
  - Langevin at f64 on 1, 2 and 4 ranks: one trajectory (1e-9 A);
  - a planted too-small Gcap2 (pencils) and Mcap (slabs): every
    capacity grows, the log names the one that overflowed, and the run
    ends equal to one that never overflowed;
  - the kernel's layout: its plain prep pass (`halo_tiles_reference`)
    against a numpy recomputation of the contract, on the gas and edge
    cases;
  - HaloMD's two reads of the prep flag, set by hand on one rank and on
    2 slabs: each counts it with the fullest rank's count and its rank,
    clears it, and the run steps on;
  - `gpu`: the halo kernel against its plain version, its device prep
    bit for bit the plain prep, two calls bit-identical, a planted
    over-full cell through the bare wrapper and through HaloMD, which
    steps through it (skip without a card).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import mesh_workers as mw
from torchmd_tpu_torch.ops import halo as khalo
from torchmd_tpu_torch.ops.cell import CellData, prepare_cell_data
from torchmd_tpu_torch.parallel import launch
from torchmd_tpu_torch.parallel.halo import HaloSpec, make_halo_spec
from torchmd_tpu_torch.units import BOLTZMANN

torch.set_num_threads(1)

L_GAS = 24.0          # 2 slabs or 2 x 2 pencils at cutoff 7 (band 9)
CUTOFF = 7.0
SLABS = dict(axes=("sp",), shape=None, axis="sp")
ONE = dict(axes=("dp", "sp"), shape=(2, 1), axis="sp")     # a halo axis of one rank
PENCILS = dict(axes=("spx", "spy"), shape=(2, 2), axis=("spx", "spy"))
LAYOUTS = {"one": ONE, "slabs": SLABS, "pencils": PENCILS}


@pytest.fixture(scope="module")
def ranks2():
    with launch.Ranks(2, threads=1, timeout=300) as ranks:
        yield ranks


@pytest.fixture(scope="module")
def ranks4():
    with launch.Ranks(4, threads=1, timeout=300) as ranks:
        yield ranks


def _np_dict(ffp):
    """A JAX FFParams as a dict of numpy leaves (the ranks unpickle no JAX
    type)."""
    out = {}
    for k, v in ffp._asdict().items():
        if v is None:
            out[k] = None
        elif hasattr(v, "_asdict"):
            out[k] = {f: np.asarray(x) for f, x in v._asdict().items()}
        elif isinstance(v, tuple):
            out[k] = tuple(np.asarray(x) for x in v)
        else:
            out[k] = np.asarray(v)
    return out


def _grid(n, L, rs, jitter):
    m = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)[:n]
    return (g + 0.5) * (L / m) + rs.randn(n, 3) * jitter


def _jax_system(name, precision="double", seed=0, port=False):
    """(JAX Forces, positions, exclusion table) of a test system; with
    `port`, the port's front end builds it (on the CPU) and JAX is not
    imported."""
    import importlib

    pkg = "torchmd_tpu_torch" if port else "torchmd_tpu"
    YamlForcefield = importlib.import_module(f"{pkg}.forcefields.ff_yaml").YamlForcefield
    Forces = importlib.import_module(f"{pkg}.forces").Forces
    Molecule = importlib.import_module(f"{pkg}.io").Molecule
    build_exclusion_table = importlib.import_module(f"{pkg}.neighbors").build_exclusion_table
    Parameters = importlib.import_module(f"{pkg}.parameters").Parameters

    rs = np.random.RandomState(seed)
    mol = Molecule()
    if name in ("gas", "nbfix"):
        n = 300
        mol.numAtoms = n
        types = ["AR", "XE"] if name == "nbfix" else ["AR"]
        mol.atomtype = np.array((types * n)[:n], dtype=object)
        mol.charge = rs.randn(n) * 0.03 if name == "gas" else np.zeros(n)
        mol.masses = np.where(mol.atomtype == "AR", 39.948, 131.29)
        mol.bonds = np.zeros((0, 2), dtype=np.int64)
        pos = _grid(n, L_GAS, rs, 0.3)
        ffd = {"atomtypes": types,
               "lj": {"AR": {"sigma": 3.405, "epsilon": 0.238},
                      "XE": {"sigma": 3.96, "epsilon": 0.43}},
               "electrostatics": {t: {"charge": 0.0} for t in types},
               "masses": {"AR": 39.948, "XE": 131.29}}
        terms = ["lj", "electrostatics"] if name == "gas" else ["lj"]
    else:
        nch = 60
        n = 4 * nch
        mol.numAtoms = n
        mol.atomtype = np.array(["CT", "CM", "CM", "CT"] * nch, dtype=object)
        mol.charge = np.tile([0.08, -0.08, -0.08, 0.08], nch)
        mol.masses = np.full(n, 14.0)
        mol.bonds = np.concatenate([np.array([[0, 1], [1, 2], [2, 3]]) + 4 * i
                                    for i in range(nch)])
        mol.angles = np.concatenate([np.array([[0, 1, 2], [1, 2, 3]]) + 4 * i
                                     for i in range(nch)])
        mol.dihedrals = np.concatenate([np.array([[0, 1, 2, 3]]) + 4 * i for i in range(nch)])
        base = np.array([[0.0, 0.0, 0.0], [1.53, 0.0, 0.0], [2.05, 1.44, 0.0],
                         [3.58, 1.44, 0.4]])
        pos = np.concatenate([base + g for g in _grid(nch, L_GAS, rs, 0.4)])
        lj = {"sigma": 3.4, "epsilon": 0.109, "sigma14": 3.4, "epsilon14": 0.0545}
        ffd = {"atomtypes": ["CT", "CM"],
               "bonds": {"(CT, CM)": {"k0": 310.0, "req": 1.526},
                         "(CM, CM)": {"k0": 310.0, "req": 1.526}},
               "angles": {"(CT, CM, CM)": {"k0": 40.0, "theta0": 109.5},
                          "(CM, CM, CT)": {"k0": 40.0, "theta0": 109.5}},
               "dihedrals": {"(CT, CM, CM, CT)": {
                   "terms": [{"phi_k": 1.4, "phase": 0.0, "per": 3}],
                   "scnb": 2.0, "scee": 1.2}},
               "lj": {"CT": lj, "CM": lj},
               "electrostatics": {"CT": {"charge": 0.08}, "CM": {"charge": -0.08}},
               "masses": {"CT": 14.0, "CM": 14.0}}
        terms = ["bonds", "angles", "dihedrals", "1-4", "lj", "electrostatics"]
    mol.coords = pos[:, :, None]
    mol.box = np.full((3, 1), L_GAS)
    ff = YamlForcefield(mol, ffd)
    par = Parameters(ff, mol, terms, precision=precision)
    if name in ("gas", "chains-cmap", "chains-ewald"):
        par.charges = mol.charge.copy()
    if name == "nbfix":
        uq = sorted(set(np.asarray(mol.atomtype)))
        par.nbfix = np.asarray([[uq.index("AR"), uq.index("XE"), -0.9, 4.4]])
    kw = dict(elec="ewald") if name == "chains-ewald" else dict(rfa="electrostatics" in terms)
    if port:
        kw["device"] = "cpu"
    forces = Forces(par, terms=terms, precision=precision, cutoff=CUTOFF,
                    nbfix=name == "nbfix", **kw)
    if name == "chains-ewald":
        forces.ensure_ewald(np.full(3, L_GAS))
    if name == "chains-cmap":
        forces = _with_cmap(forces, nch)
    return forces, pos, build_exclusion_table(par, n)


def _with_cmap(forces, nchains):
    """One smooth synthetic 24x24 CMAP over each chain's dihedral (as phi
    and psi), as tests/test_halo.py:_with_cmap, at f64."""
    import jax.numpy as jnp

    from torchmd_tpu.cmap import CMapTable, build_cmap_coeff_table

    ang = -np.pi + np.arange(24) * (2.0 * np.pi / 24)
    P, S = np.meshgrid(ang, ang, indexing="ij")
    grid = 0.8 * np.cos(P + 0.3) + 0.5 * np.sin(2 * S - 0.7) + 0.3 * np.cos(P + S)
    idx = np.concatenate([np.array([[0, 1, 2, 3, 0, 1, 2, 3]]) + 4 * i
                          for i in range(nchains)])
    cm = CMapTable(idx=jnp.asarray(idx, jnp.int32), type=jnp.zeros(nchains, jnp.int32),
                   coeffs=jnp.asarray(build_cmap_coeff_table([grid])))
    forces.ffparams = forces.ffparams._replace(cmap=cm)
    forces.config = forces.config._replace(terms=tuple(forces.config.terms) + ("cmap",))
    return forces


def _dense_reference(forces, pos):
    """The JAX package's dense f64 energy and forces (compute_potentials
    plus the exact Ewald sum)."""
    import jax
    import jax.numpy as jnp

    from torchmd_tpu.potentials import compute_potentials

    box = jnp.full(3, L_GAS)

    def energy(p):
        e = sum(compute_potentials(forces.ffparams, p, box, forces.config).values())
        if forces._ewald is not None:
            e = e + forces._ewald.energy(p, box)
        return e

    e, g = jax.jit(jax.value_and_grad(energy))(jnp.asarray(pos))
    return float(e), -np.asarray(g)


def _halo_spec(forces, pos, vel, excl, precision="double", **kw):
    return dict(ffp=_np_dict(forces.ffparams), cfg=forces.config._asdict(), excl=excl,
                precision=precision, box=[L_GAS] * 3, pos=pos, vel=vel, **kw)


def _velocities(masses, T, seed):
    """Maxwell-Boltzmann velocities from numpy (massless rows at rest)."""
    m = np.asarray(masses, np.float64).reshape(-1, 1)
    std = np.sqrt(BOLTZMANN * T / np.where(m > 0, m, 1.0)) * (m > 0)
    return np.random.RandomState(seed).randn(m.shape[0], 3) * std


# ----------------------------------------------------------------------
# The spec and the neighbour shift
# ----------------------------------------------------------------------

SPEC_CASES = [
    dict(box=[90.0] * 3, cutoff=9.0, R=8, natoms=2000),
    dict(box=[260.0, 90.0, 90.0], cutoff=9.0, R=8, natoms=50_000, nexcl=12),
    dict(box=[90.0] * 3, cutoff=9.0, R=2, natoms=2000, Ry=4),
    dict(box=[79.36, 78.48, 78.52], cutoff=9.0, R=2, natoms=44_032, Ry=2, eps=1.2,
         slack=1.2),
]
SPEC_RAISES = [
    (dict(box=[40.0] * 3, cutoff=9.0, R=8, natoms=2000), "too many ranks"),
    (dict(box=[90.0, 40.0, 90.0], cutoff=9.0, R=2, natoms=2000, Ry=4), "y ranks"),
    (dict(box=[0.0, 90.0, 90.0], cutoff=9.0, R=2, natoms=2000), "periodic box"),
]


@pytest.mark.parametrize("case", range(len(SPEC_CASES) + len(SPEC_RAISES)))
def test_halo_spec_matches_jax(case):
    """make_halo_spec: every field and comm_bytes_per_step as the JAX
    package's, and the same errors."""
    from torchmd_tpu.parallel.halo import make_halo_spec as jax_spec

    if case < len(SPEC_CASES):
        kw = SPEC_CASES[case]
        got, want = make_halo_spec(**kw), jax_spec(**kw)
        assert isinstance(got, HaloSpec)
        assert tuple(got) == tuple(want)
        assert got.comm_bytes_per_step() == want.comm_bytes_per_step()
        assert (got.slab_w, got.pencil_w, got.band_w) == (want.slab_w, want.pencil_w,
                                                         want.band_w)
        return
    kw, match = SPEC_RAISES[case - len(SPEC_CASES)]
    with pytest.raises(ValueError, match=match):
        jax_spec(**kw)
    with pytest.raises(ValueError, match=match):
        make_halo_spec(**kw)


@pytest.mark.parametrize("transport", ["p2p", "all_gather"])
def test_ppermute_both_transports(ranks2, ranks4, transport):
    """Mesh.ppermute by shifts 1, -1, 2 along axes of 1, 2 and 4 ranks:
    each rank receives the block of the rank `shift` places back; an axis
    of one rank is a local copy, counted as no call."""
    for ranks, shapes in ((ranks2, ((1, 2), (2, 1))), (ranks4, ((1, 4), (2, 2)))):
        for shape in shapes:
            outs = ranks.run(mw.neighbour_shifts, dict(shape=shape, transport=transport))
            sizes = dict(zip(("dp", "sp"), shape))
            for rank, (coords, got, calls, nbytes, used) in enumerate(outs):
                assert used == transport
                for (axis, shift), x in got.items():
                    src = dict(coords)
                    src[axis] = (coords[axis] - shift) % sizes[axis]
                    src_rank = src["dp"] * shape[1] + src["sp"]
                    np.testing.assert_array_equal(
                        x, np.arange(6.0).reshape(2, 3) + 100.0 * src_rank)
                moved = sum(1 for a in ("dp", "sp") if sizes[a] > 1
                            for s in (1, -1, 2) if s % sizes[a])
                assert calls.get(f"ppermute_{transport}", 0) == moved
                assert set(calls) <= {f"ppermute_{transport}"}
                assert (nbytes.get(f"ppermute_{transport}", 0) > 0) == (moved > 0)


# ----------------------------------------------------------------------
# Against the JAX package
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _zero_velocity_case(system):
    forces, pos, excl = _jax_system(system)
    return (forces, pos, excl) + _dense_reference(forces, pos)


@pytest.mark.parametrize("layout", ["one", "slabs", "pencils"])
@pytest.mark.parametrize("system", ["gas", "chains-cmap", "nbfix", "chains-ewald"])
def test_zero_velocity_step_matches_jax_dense_f64(ranks2, ranks4, system, layout):
    """One step from rest at f64: positions stay, so the summed energy is
    the dense energy at the start, and the half-kick gives the forces. On
    one rank (a halo axis of one) an atom near a face comes back as its
    own ghost image, which the JAX package's Ewald correction of excluded
    pairs also counts (+0.57 % on chains-ewald; ROADMAP section 3)."""
    forces, pos, excl, e_ref, f_ref = _zero_velocity_case(system)
    if system == "chains-cmap":
        assert abs(float(forces.ffparams.cmap.coeffs.sum())) > 0
    ranks, lay = (ranks4 if layout == "pencils" else ranks2), LAYOUTS[layout]
    spec = _halo_spec(forces, pos, np.zeros_like(pos), excl, timestep=1.0, chunks=1, niter=1,
                      **lay)
    outs = ranks.run(mw.run_halo, spec)
    m = np.asarray(forces.ffparams.masses, np.float64).reshape(-1, 1)
    dt = 1.0 / 48.88821
    for o in outs:
        assert abs(o["epot"][0] - e_ref) <= 1e-10 * abs(e_ref)
        f = 2.0 * m * o["vel"] / dt
        assert np.abs(f - f_ref).max() <= 1e-9 * np.abs(f_ref).max()
        np.testing.assert_allclose(o["pos"], pos - L_GAS * np.floor(pos / L_GAS), atol=1e-12)


@pytest.mark.parametrize("layout", ["slabs", "pencils"])
def test_f32_nve_matches_jax_halo(ranks2, ranks4, layout):
    """A hot charged gas at f32 (1500 K, 5 fs, 3 x 8 steps) against the JAX
    HaloMD on the same mesh shape, at its tolerances (epot rtol 5e-5,
    positions and velocities 2e-3), through migrations."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from torchmd_tpu.parallel.halo import HaloMD as JaxHalo

    forces, pos, excl = _jax_system("gas", precision="single", seed=3)
    vel = _velocities(forces.ffparams.masses, 1500.0, seed=2)
    ranks, lay = (ranks2, SLABS) if layout == "slabs" else (ranks4, PENCILS)
    devs = np.array(jax.devices()[:2 if layout == "slabs" else 4])
    mesh = (Mesh(devs, ("sp",)) if layout == "slabs"
            else Mesh(devs.reshape(2, 2), ("spx", "spy")))
    h = JaxHalo(forces.ffparams, forces.config, mesh, np.full(3, L_GAS), timestep=5.0,
                axis=lay["axis"])
    h._step_fn = jax.jit(h._step_fn)     # one compile for the three chunks
    h.init(jnp.asarray(pos, jnp.float32), jnp.asarray(vel, jnp.float32))
    epot = np.asarray([h.step(niter=8)[1] for _ in range(3)])
    jpos, jvel = h.gather()
    outs = ranks.run(mw.run_halo, _halo_spec(forces, pos, vel, excl, precision="single",
                                             timestep=5.0, chunks=3, niter=8, **lay))
    for o in outs:
        assert o["migrations"] >= 1
        np.testing.assert_allclose(o["epot"], epot, rtol=5e-5)
        np.testing.assert_allclose(o["pos"], jpos, atol=2e-3)
        np.testing.assert_allclose(o["vel"], jvel, atol=2e-3)


# ----------------------------------------------------------------------
# Against the port's unsharded run and itself
# ----------------------------------------------------------------------

def _tip4p_spec(L=18.0, side=3):
    from test_gromacs import TIP4P2005_TOP, tip4p_water

    rs = np.random.RandomState(11)
    nw = side ** 3
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    coords = np.concatenate([tip4p_water(g * (L / side) + 2.0 + rs.randn(3) * 0.4)
                             for g in grid])
    mol, par, _ = mw.tip4p(TIP4P2005_TOP.replace("SOL 2", f"SOL {nw}"), coords, L)
    vel = _velocities(par.masses, 300.0, seed=6)
    return dict(system="tip4p", top=TIP4P2005_TOP.replace("SOL 2", f"SOL {nw}"),
                coords=coords, L=L, vel=vel, timestep=2.0)


def test_tip4p_settle_sites_match_unsharded_integrator(ranks2, ranks4):
    """27 TIP4P/2005 waters (SETTLE, M sites) at f64: 10 NVE steps on 2
    slabs and 2 x 2 pencils within 1e-8 A of the port's unsharded
    Integrator (positions up to the box: the halo wraps molecules
    whole), molecules whole on one rank."""
    spec = _tip4p_spec()
    L = spec["L"]
    ref = mw.run_md(0, dict(spec, vel=spec["vel"][None], chunks=1, niter=10,
                            integrator=dict(constraints="settle")))
    halo = dict(spec, box=[L] * 3, pos=spec["coords"], chunks=1, niter=10)
    for ranks, lay in ((ranks2, SLABS), (ranks4, PENCILS)):
        for o in ranks.run(mw.run_halo, dict(halo, **lay)):
            d = o["pos"] - ref["pos"][0]
            d -= L * np.round(d / L)
            assert np.abs(d).max() <= 1e-8
            assert abs(o["epot"][0] - ref["epot"][0][0]) <= 1e-9 * abs(ref["epot"][0][0])
            assert o["start"].eps > 0.9


@functools.lru_cache(maxsize=None)
def _langevin_spec():
    """The hot gas's Langevin run at f64 (20 steps of 5 fs, 300 K)."""
    forces, pos, excl = _jax_system("gas", seed=5)
    vel = _velocities(forces.ffparams.masses, 1500.0, seed=3)
    return _halo_spec(forces, pos, vel, excl, timestep=5.0, chunks=2, niter=10, T=300.0,
                      gamma=1.0, seed=7)


_LANGEVIN_RUNS = {}


def _langevin_run(ranks, layout):
    """The ranks' results of `_langevin_spec` on one layout, run once for
    the module (the layout test and the overflow tests' clean runs)."""
    if layout not in _LANGEVIN_RUNS:
        _LANGEVIN_RUNS[layout] = ranks.run(mw.run_halo,
                                           dict(_langevin_spec(), **LAYOUTS[layout]))
    return _LANGEVIN_RUNS[layout]


def test_langevin_does_not_depend_on_the_layout(ranks2, ranks4):
    """Langevin at f64 on 1 rank (a halo axis of one rank), 2 slabs and
    2 x 2 pencils: the same trajectory within 1e-9 A over 20 steps."""
    one = _langevin_run(ranks2, "one")
    runs = one + _langevin_run(ranks2, "slabs") + _langevin_run(ranks4, "pencils")
    assert one[0]["migrations"] >= 1
    for o in runs:
        assert np.abs(o["pos"] - one[0]["pos"]).max() <= 1e-9
        np.testing.assert_allclose(o["epot"], one[0]["epot"], rtol=1e-10)


@pytest.mark.parametrize("planted", ["Gcap2", "Mcap"])
def test_overflow_grows_every_capacity(ranks2, ranks4, planted):
    """A too-small Gcap2 on pencils, a too-small Mcap on slabs: the chunk
    is redone with every capacity grown, the log names the one that
    overflowed, and the run ends equal to one that never overflowed."""
    spec = _langevin_spec()
    ranks, layout = (ranks4, "pencils") if planted == "Gcap2" else (ranks2, "slabs")
    clean = _langevin_run(ranks, layout)
    # half the pencils' default Gcap2 (288; the run needs 216), one Mcap row
    small = make_halo_spec([L_GAS] * 3, CUTOFF, 2, len(spec["pos"]), Ry=2).Gcap2 // 2
    grown = ranks.run(mw.run_halo, dict(spec, plant={planted: small if planted == "Gcap2"
                                                     else 1}, **LAYOUTS[layout]))
    for c, g in zip(clean, grown):
        assert c["overflow_log"] == []
        assert g["overflow_log"] and all(planted in names for names in g["overflow_log"])
        for cap in ("Acap", "Gcap", "Mcap") + (("Gcap2",) if planted == "Gcap2" else ()):
            assert getattr(g["spec"], cap) > getattr(g["start"], cap), cap
        assert np.abs(g["pos"] - c["pos"]).max() <= 1e-10
        np.testing.assert_allclose(g["epot"], c["epot"], rtol=1e-10)


# ----------------------------------------------------------------------
# The pair stage alone: plain on the CPU, the kernel on the card
# ----------------------------------------------------------------------

def _one_rank_rows(pos, L, band, wrap_y):
    """The rows of a lone rank owning the whole box: owned atoms, then the
    x ghost bands (and on a pencil the y ones) shifted across the faces."""
    ids = np.arange(len(pos), dtype=np.float64)[:, None]
    pos = pos - L * np.floor(pos / L)
    rows = [np.concatenate([ids, pos], 1)]
    for ax in ((0,) if wrap_y else (0, 1)):
        src = np.concatenate(rows)
        for sel, shift in ((src[:, 1 + ax] > L - band, -L), (src[:, 1 + ax] < band, L)):
            r = src[sel].copy()
            r[:, 1 + ax] += shift
            rows.append(r)
    return np.concatenate(rows)


@pytest.mark.parametrize("wrap_y", [True, False])
def test_plain_pair_stage_matches_jax_dense(wrap_y):
    """halo_reference on one rank's rows (x ghosts, and y ghosts on a
    pencil) equals the JAX package's dense nonbonded energy and forces at
    f64 (the charged gas, reaction field; NBFIX)."""
    import jax
    import jax.numpy as jnp

    from torchmd_tpu.potentials import nonbonded_energy_forces
    from torchmd_tpu_torch import interop
    from torchmd_tpu_torch.potentials import ForceTermConfig

    for name in ("gas", "nbfix"):
        forces, pos, excl = _jax_system(name)
        pot, f_ref = nonbonded_energy_forces(forces.ffparams, jnp.asarray(pos),
                                             jnp.full(3, L_GAS), forces.config)
        e_ref = float(sum(jax.tree_util.tree_leaves(pot)))
        ffp = interop.ffparams_from_numpy(_np_dict(forces.ffparams))
        data = prepare_cell_data(ffp, excl)
        rows = torch.as_tensor(_one_rank_rows(pos, L_GAS, CUTOFF + 2.0, wrap_y))
        geom = khalo.HaloGeom(box=(L_GAS,) * 3, wrap=(False, wrap_y, True),
                              lo=(-11.0, -11.0, 0.0), hi=(L_GAS + 11.0,) * 2 + (L_GAS,))
        pot, f = khalo.halo_energy_forces(data, ForceTermConfig(**forces.config._asdict()),
                                          rows, len(pos), geom)
        assert abs(float(sum(pot.values())) - e_ref) <= 1e-10 * abs(e_ref)
        assert float((f - torch.as_tensor(np.array(f_ref))).abs().max()) <= 1e-9 * float(
            np.abs(f_ref).max())


@pytest.mark.gpu
@pytest.mark.parametrize("wrap_y", [True, False])
def test_cuda_halo_kernel_matches_plain(wrap_y):
    """The halo kernel (f32, on the card) against its plain f64 version on
    one rank's rows of the charged gas and the NBFIX gas, built by the
    port alone (the Pallas bars of tests/test_pallas.py:51-57); LAUNCHES
    counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    for name in ("gas", "nbfix"):
        forces, pos, excl = _jax_system(name, port=True)
        ffp, cfg = forces.ffparams, forces.config
        d64 = prepare_cell_data(ffp, excl)
        d32 = prepare_cell_data(ffp, excl, dtype=torch.float32)
        d32 = d32._replace(**{k: v.to(dev) for k, v in d32._asdict().items()
                              if torch.is_tensor(v)})
        rows = torch.as_tensor(_one_rank_rows(pos, L_GAS, CUTOFF + 2.0, wrap_y))
        geom = khalo.HaloGeom(box=(L_GAS,) * 3, wrap=(False, wrap_y, True),
                              lo=(-11.0, -11.0, 0.0), hi=(L_GAS + 11.0,) * 2 + (L_GAS,))
        n0 = khalo.LAUNCHES
        pot_k, f_k = khalo.halo_energy_forces(d32, cfg, rows.to(dev, torch.float32),
                                              len(pos), geom)
        pot_p, f_p = khalo.halo_reference(d64, cfg, rows, len(pos), geom)
        torch.cuda.synchronize()
        assert khalo.LAUNCHES == n0 + 1
        for key in pot_p:
            assert abs(float(pot_k[key]) - float(pot_p[key])) <= 2e-3 + 2e-5 * abs(
                float(pot_p[key]))
        assert float((f_k.double().cpu() - f_p).abs().max()) < 5e-5 * max(
            1.0, float(f_p.abs().max()))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _on(data, dev):
    return data._replace(**{k: v.to(dev) for k, v in data._asdict().items()
                            if torch.is_tensor(v)})


def _assert_same_bits(got, want):
    """Every field of two HaloTiles equal bit for bit."""
    for field, a, b in zip(want._fields, got, want):
        a, b = a.contiguous().cpu(), b.contiguous().cpu()
        assert a.shape == b.shape, field
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), field


def _slab_geom(wrap_y=True):
    return khalo.HaloGeom(box=(L_GAS,) * 3, wrap=(False, wrap_y, True),
                          lo=(-11.0, -11.0, 0.0), hi=(L_GAS + 11.0,) * 2 + (L_GAS,))


@pytest.mark.gpu
@pytest.mark.parametrize("wrap_y", [True, False])
def test_cuda_halo_prep_matches_plain_prep(wrap_y):
    """The kernel's device prep pass (`halo_tiles`) equals its plain
    version bit for bit (packed rows, tile boxes, each slot's row, each
    tile's cell) on one rank's rows of the charged gas and the NBFIX gas;
    the overflow flag stays 0."""
    dev = _card()
    for name in ("gas", "nbfix"):
        forces, pos, excl = _jax_system(name, port=True)
        d32 = prepare_cell_data(forces.ffparams, excl, dtype=torch.float32)
        rows = torch.as_tensor(_one_rank_rows(pos, L_GAS, CUTOFF + 2.0, wrap_y)).float()
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        got = khalo.halo_tiles(_on(d32, dev), forces.config, rows.to(dev), len(pos),
                               _slab_geom(wrap_y), overflow=flag)
        want = khalo.halo_tiles_reference(d32, forces.config, rows, len(pos),
                                          _slab_geom(wrap_y))
        _assert_same_bits(got, want)
        assert int(flag) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("wrap_y", [True, False])
def test_cuda_halo_kernel_is_deterministic(wrap_y):
    """Two calls of the halo kernel on the same rows give bit-identical
    forces and energies (the prep's atomics leave no trace in the layout,
    two force additions onto zero commute)."""
    dev = _card()
    forces, pos, excl = _jax_system("gas", port=True)
    d32 = _on(prepare_cell_data(forces.ffparams, excl, dtype=torch.float32), dev)
    rows = torch.as_tensor(_one_rank_rows(pos, L_GAS, CUTOFF + 2.0, wrap_y)).float().to(dev)
    (pot_a, f_a), (pot_b, f_b) = [
        khalo.halo_energy_forces(d32, forces.config, rows, len(pos), _slab_geom(wrap_y))
        for _ in range(2)]
    assert torch.equal(f_a, f_b)
    assert all(torch.equal(pot_a[k], pot_b[k]) for k in pot_a)


def _planted_gas(planted=1500, spacing=0.3):
    """The charged gas with `planted` chargeless atoms without LJ on a
    cubic lattice of `spacing` A inside one halo cell of a lone rank
    (x in [4.33, 12), y and z in [8, 16)), built by the port's front end:
    (Forces on the CPU at f64, positions, exclusion table). The planted
    atoms feel no force and exert none, but the pair kernel bins, sorts
    and walks them, and their x ghosts fill a cell too."""
    from torchmd_tpu_torch.forcefields.ff_yaml import YamlForcefield
    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.io import Molecule
    from torchmd_tpu_torch.neighbors import build_exclusion_table
    from torchmd_tpu_torch.parameters import Parameters

    rs = np.random.RandomState(0)
    gas = _grid(300, L_GAS, rs, 0.3)
    side = int(np.ceil(planted ** (1 / 3)))
    lat = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lat = (lat[:planted] - 0.5 * (side - 1)) * spacing + np.array([8.0, 12.0, 12.0])
    pos = np.concatenate([gas, lat])
    n = len(pos)
    mol = Molecule()
    mol.numAtoms = n
    mol.atomtype = np.array(["AR"] * len(gas) + ["DU"] * planted, dtype=object)
    mol.charge = np.concatenate([rs.randn(len(gas)) * 0.03, np.zeros(planted)])
    mol.masses = np.full(n, 39.948)
    mol.bonds = np.zeros((0, 2), dtype=np.int64)
    mol.coords = pos[:, :, None]
    mol.box = np.full((3, 1), L_GAS)
    ffd = {"atomtypes": ["AR", "DU"],
           "lj": {"AR": {"sigma": 3.405, "epsilon": 0.238},
                  "DU": {"sigma": 1.0, "epsilon": 0.0}},
           "electrostatics": {"AR": {"charge": 0.0}, "DU": {"charge": 0.0}},
           "masses": {"AR": 39.948, "DU": 39.948}}
    terms = ["lj", "electrostatics"]
    par = Parameters(YamlForcefield(mol, ffd), mol, terms, precision="double")
    par.charges = mol.charge.copy()
    forces = Forces(par, terms=terms, precision="double", cutoff=CUTOFF, rfa=True,
                    device="cpu")
    return forces, pos, build_exclusion_table(par, n)


@pytest.mark.gpu
def test_cuda_halo_prep_overflow_raises():
    """Beyond PREP_CAP rows in one cell. The bare wrapper: 1,100 ghost
    rows planted in one cell, beyond the cutoff of every owned row; the
    prep sorts the cell from device memory, bit for bit the plain prep
    (no row dropped), raises the flag to the cell's count,
    `check_overflow` raises naming it, and the forces stay the plain
    version's. Through HaloMD on the card (one NCCL rank): ~1,500 atoms
    planted in one cell; a step from rest runs, `prep_overflows` counts
    the cell with its rows and rank, and the energy and the forces from
    the half-kick match the plain f64 HaloMD's at the Pallas bars."""
    dev = _card()
    forces, pos, excl = _jax_system("gas", port=True)
    rs = np.random.RandomState(4)
    k = 1100
    plant = np.concatenate([(np.arange(k) % len(pos))[:, None].astype(np.float64),
                            rs.uniform([-11.0, 1.0, 1.0], [-10.2, 2.0, 2.0], (k, 3))], 1)
    rows = torch.as_tensor(np.concatenate([_one_rank_rows(pos, L_GAS, CUTOFF + 2.0, True),
                                           plant]))
    geom, nown = _slab_geom(), len(pos)
    d32 = prepare_cell_data(forces.ffparams, excl, dtype=torch.float32)
    want = khalo.halo_tiles_reference(d32, forces.config, rows.float(), nown, geom)
    cells = want.tile_cell.long().repeat_interleave(khalo.TILE)
    count = int(torch.bincount(cells[want.rowof >= 0]).max())
    assert count > khalo.PREP_CAP
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    got = khalo.halo_tiles(_on(d32, dev), forces.config, rows.float().to(dev), nown, geom,
                           overflow=flag)
    _assert_same_bits(got, want)
    assert int(flag) == count
    with pytest.raises(RuntimeError, match=f"a cell holds {count} rows"):
        khalo.check_overflow(flag)
    pot_k, f_k = khalo.halo_energy_forces(_on(d32, dev), forces.config, rows.float().to(dev),
                                          nown, geom)
    pot_p, f_p = khalo.halo_reference(prepare_cell_data(forces.ffparams, excl),
                                      forces.config, rows, nown, geom)
    for key in pot_p:
        assert abs(float(pot_k[key]) - float(pot_p[key])) <= 2e-3 + 2e-5 * abs(
            float(pot_p[key]))
    assert float((f_k.double().cpu() - f_p).abs().max()) < 5e-5 * max(
        1.0, float(f_p.abs().max()))

    forces, pos, excl = _planted_gas()
    spec = _halo_spec(forces, pos, np.zeros_like(pos), excl, timestep=1.0, chunks=1, niter=1,
                      axes=("sp",), shape=None, axis="sp")
    with launch.Ranks(1, backend="nccl", device="cuda:0", timeout=600) as ranks:
        card = ranks.run(mw.run_halo, dict(spec, precision="single", device="cuda:0"))[0]
    with launch.Ranks(1, threads=1, timeout=600) as ranks:
        plain = ranks.run(mw.run_halo, spec)[0]
    n_prep, last = card["prep"]
    assert n_prep >= 1 and last[0] > khalo.PREP_CAP and last[1] == 0, card["prep"]
    assert plain["prep"] == (0, None)
    assert np.isfinite(card["pos"]).all() and np.isfinite(card["T"]).all()
    e_k, e_p = float(card["epot"][0]), float(plain["epot"][0])
    assert abs(e_k - e_p) <= 2e-3 + 2e-5 * abs(e_p), (e_k, e_p)
    m = np.asarray(forces.ffparams.masses, np.float64).reshape(-1, 1)
    dt = 1.0 / 48.88821
    f_card, f_plain = 2.0 * m * card["vel"] / dt, 2.0 * m * plain["vel"] / dt
    assert np.abs(f_card - f_plain).max() < 5e-5 * max(1.0, np.abs(f_plain).max())


# ----------------------------------------------------------------------
# The kernel's layout: its plain prep pass against the contract
# ----------------------------------------------------------------------

def _contract_layout(rows, nown, geom, cutoff, natoms):
    """numpy recomputation of the layout contract (csrc/halo.cu): per real
    row its binned coordinates (f32: a wrapped axis takes x - L floor(x
    * f32(1 / L))) and its cell, clamped at an unwrapped end; rows sorted
    by (cell, ghost, Morton index of the 4x4x4 sub-cell, row); each cell
    in ceil(count / 32) tiles. Returns (expected rowof, binned (M, 3),
    each tile's cell)."""
    f32 = np.float32
    rows = np.asarray(rows, f32)
    m = len(rows)
    ids = rows[:, 0].astype(np.int64)
    real = ids < natoms
    xyz, cell3, sub = [], [], []
    for a, (o, nc, s) in enumerate(khalo.grid(geom, cutoff)):
        x = rows[:, 1 + a]
        if geom.wrap[a]:
            L = f32(geom.box[a])
            x = x - L * np.floor(x * f32(1.0 / float(geom.box[a])))
        f = (x - f32(o)) * f32(s)
        c = np.clip(np.floor(f), 0, nc - 1)
        sub.append(np.clip(((f - c) * f32(4)).astype(np.int64), 0, 3))
        xyz.append(x)
        cell3.append(c.astype(np.int64))
    dims = [nc for _, nc, _ in khalo.grid(geom, cutoff)]
    cell = (cell3[0] * dims[1] + cell3[1]) * dims[2] + cell3[2]
    morton = sum(((sub[a] >> b) & 1) << (3 * b + a) for b in range(2) for a in range(3))
    ghost = np.arange(m) >= nown
    order = sorted(np.nonzero(real)[0], key=lambda r: (cell[r], ghost[r], morton[r], r))
    counts = np.bincount(cell[real], minlength=int(np.prod(dims)))
    rowof = []
    for c in range(len(counts)):
        mine = [r for r in order if cell[r] == c]
        rowof += mine + [-1] * (-len(mine) % 32)
    tile_cell = np.repeat(np.arange(len(counts)), -(-counts // 32))
    return np.asarray(rowof, np.int64), np.stack(xyz, 1), tile_cell


def _check_layout(tiles, rows, nown, geom, cutoff, natoms, q):
    """HaloTiles against `_contract_layout`: the same slots, binned
    coordinates, charges and ids on real slots, padding elsewhere, tight
    boxes."""
    rowof, xyz, tile_cell = _contract_layout(rows, nown, geom, cutoff, natoms)
    np.testing.assert_array_equal(tiles.rowof.numpy(), rowof)
    np.testing.assert_array_equal(tiles.tile_cell.numpy(), tile_cell)
    real = rowof >= 0
    ids = np.asarray(rows, np.float32)[:, 0].astype(np.int64)
    pq, aux = tiles.pq.numpy(), tiles.aux.numpy()
    np.testing.assert_array_equal(pq[real, :3], xyz[rowof[real]])
    np.testing.assert_array_equal(pq[real, 3], np.asarray(q, np.float32)[ids[rowof[real]]])
    np.testing.assert_array_equal(aux[:, 2].view(np.int32),
                                  np.where(real, ids[rowof], natoms))
    assert (pq[~real, :3] == np.float32(1e18)).all()
    t = len(tile_cell)
    x = pq[:, :3].reshape(t, 32, 3)
    v = real.reshape(t, 32, 1)
    np.testing.assert_array_equal(tiles.tbox[:, 0, :3].numpy(), np.where(v, x, np.inf).min(1))
    np.testing.assert_array_equal(tiles.tbox[:, 1, :3].numpy(), np.where(v, x, -np.inf).max(1))


def _gas_layout_case(wrap_y):
    """(forces, CellData, rows, nown, HaloGeom) of the charged gas on one
    rank's rows (built by the port alone), 5 padding rows after the owned
    ones."""
    forces, pos, excl = _jax_system("gas", port=True)
    rows = torch.as_tensor(_one_rank_rows(pos, L_GAS, CUTOFF + 2.0, wrap_y)).float()
    pad = torch.tensor([[float(len(pos)), 0.0, 0.0, 0.0]]).expand(5, -1)
    rows = torch.cat([rows[:len(pos)], pad, rows[len(pos):]])
    geom = khalo.HaloGeom(box=(L_GAS,) * 3, wrap=(False, wrap_y, True),
                          lo=(-11.0, -11.0, 0.0), hi=(L_GAS + 11.0,) * 2 + (L_GAS,))
    data = prepare_cell_data(forces.ffparams, excl, dtype=torch.float32)
    return forces, data, rows, len(pos) + 5, geom


@pytest.mark.parametrize("wrap_y", [True, False])
def test_kernel_walk_order(wrap_y):
    """The kernel's walk order (`ops.halo.halo_tiles_reference`, the plain
    version of its prep pass) on one rank's rows with padding: every real
    row once, cell-major, each cell's owned rows before its ghosts, Morton
    and then row order within a class, each row in the cell of its binned
    coordinates, 32-row tiles per cell with tight boxes."""
    forces, data, rows, nown, geom = _gas_layout_case(wrap_y)
    tiles = khalo.halo_tiles_reference(data, forces.config, rows, nown, geom)
    _check_layout(tiles, rows, nown, geom, CUTOFF, data.natoms, data.q)
    assert (tiles.rowof.numpy() >= nown).any()


def _layout_case(name):
    """(rows (M, 4) f32, nown, HaloGeom, natoms) of a planted layout case;
    60 atoms, cutoff CUTOFF."""
    rs = np.random.RandomState(LAYOUT_CASES.index(name))
    n = 60

    def rows_of(ids, xyz):
        return np.concatenate([np.asarray(ids, np.float64)[:, None], xyz], 1)

    box, wrap, lo, hi = (L_GAS,) * 3, (False, True, True), (-9.0, 0.0, 0.0), (33.0, 0.0, 0.0)
    if name == "beyond_unwrapped_end":
        # rows past both ends of the unwrapped x region and on it
        own = rows_of(range(40), rs.uniform(0, L_GAS, (40, 3)))
        x = np.concatenate([rs.uniform(-20.0, -9.0, 10), rs.uniform(33.0, 45.0, 10)])
        gh = rows_of(range(40, 60), np.stack([x, rs.uniform(0, L_GAS, 20),
                                              rs.uniform(0, L_GAS, 20)], 1))
        nown, rows = 40, np.concatenate([own, gh])
    elif name in ("wrap_one_cell", "wrap_two_cells"):
        # z wraps with one cell (L < 2 cutoffs is refused by the kernel, but
        # the layout takes it) or two; coordinates outside [0, L) too
        lz = 10.0 if name == "wrap_one_cell" else 15.0
        box = (L_GAS, L_GAS, lz)
        xyz = np.stack([rs.uniform(0, L_GAS, n), rs.uniform(0, L_GAS, n),
                        rs.uniform(-lz, 2 * lz, n)], 1)
        nown, rows = 45, rows_of(range(n), xyz)
    elif name == "ghost_only_cells":
        # owned rows in x [0, 8), ghosts fill x cells of their own
        xyz = rs.uniform(0, L_GAS, (n, 3))
        xyz[:30, 0] = rs.uniform(0, 7.5, 30)
        xyz[30:, 0] = rs.uniform(16.0, 33.0, 30)
        nown, rows = 30, rows_of(range(n), xyz)
    elif name == "no_owned_rows":
        nown, rows = 0, rows_of(range(n), rs.uniform(-9.0, 33.0, (n, 3)))
    elif name == "padding_between":
        # padding rows inside the owned block and between owned and ghosts
        own = rows_of(range(30), rs.uniform(0, L_GAS, (30, 3)))
        pad = rows_of([n] * 7, np.zeros((7, 3)))
        gh = rows_of(range(30, 60), rs.uniform(-9.0, 33.0, (30, 3)))
        nown, rows = 37 + 4, np.concatenate([own[:20], pad[:4], own[20:], pad[4:], gh])
    else:
        raise KeyError(name)
    geom = khalo.HaloGeom(box=box, wrap=wrap, lo=lo, hi=hi)
    return torch.as_tensor(rows).float(), nown, geom, n


LAYOUT_CASES = ["beyond_unwrapped_end", "wrap_one_cell", "wrap_two_cells",
                "ghost_only_cells", "no_owned_rows", "padding_between"]


@pytest.mark.parametrize("name", LAYOUT_CASES)
def test_layout_edge_cases(name):
    """halo_tiles_reference on planted rows against the numpy contract:
    rows beyond an unwrapped end (clamped into the end cells), a wrapped
    axis of one and of two cells (coordinates wrapped into the box), cells
    holding only ghosts, no owned rows, padding rows among the owned rows
    and between owned and ghost rows."""
    from torchmd_tpu_torch.potentials import ForceTermConfig

    rows, nown, geom, n = _layout_case(name)
    rs = np.random.RandomState(1)
    data = CellData(natoms=n, q=torch.as_tensor(rs.randn(n), dtype=torch.float32),
                    sig=torch.full((n,), 1.7), eps=torch.full((n,), 0.3),
                    types=torch.zeros(n, dtype=torch.int32),
                    excl=torch.full((n, 1), n, dtype=torch.int32))
    cfg = ForceTermConfig(terms=("lj", "electrostatics"), cutoff=CUTOFF, rfa=True)
    tiles = khalo.halo_tiles_reference(data, cfg, rows, nown, geom)
    _check_layout(tiles, rows, nown, geom, CUTOFF, n, data.q)
    ids = rows[:, 0].long()
    assert sorted(tiles.rowof[tiles.rowof >= 0].tolist()) == torch.nonzero(ids < n)[:, 0].tolist()
    cells = tiles.tile_cell.long()
    if name == "beyond_unwrapped_end":
        g = khalo.grid(geom, CUTOFF)
        xcell = cells // (g[1][1] * g[2][1])
        assert xcell.min() == 0 and xcell.max() == g[0][1] - 1
    if name == "ghost_only_cells":
        owned_tiles = {int(c) for c, r in zip(cells.repeat_interleave(32), tiles.rowof)
                       if 0 <= r < nown}
        assert set(cells.tolist()) - owned_tiles
    if name == "wrap_one_cell":
        assert khalo.grid(geom, CUTOFF)[2][1] == 1


@pytest.mark.parametrize("layout", ["one", "slabs"])
def test_prep_overflow_raises_through_halomd(ranks2, layout):
    """The pair kernel's prep flag set on every rank (1,500 + rank rows,
    by hand: the plain pair stage never sets it), before a step and by the
    last step's pair stage: HaloMD's per-step read and its chunk end's
    read each count it in `prep_overflows`, keep the fullest rank's count
    and, across 2 slabs, that rank in `prep_overflow_last`, clear the flag
    and step on (the kernel's result is complete: it sorted such a cell
    from device memory); a step without the flag leaves them as they
    were."""
    forces, pos, excl = _jax_system("gas")
    spec = _halo_spec(forces, pos, np.zeros_like(pos), excl, timestep=1.0, planted=1500,
                      **LAYOUTS[layout])
    outs = ranks2.run(mw.halo_prep_overflow, spec)
    for rank, o in enumerate(outs):
        want = (1500 + rank, 0) if layout == "one" else (1501, 1)
        for read, count in (("step", 1), ("chunk", 2), ("cleared", 2)):
            got = o[read]
            assert got["count"] == count and tuple(got["last"]) == want, (read, got)
            assert got["flag"] == 0 and got["finite"], (read, got)
