"""The port's bonded kernel contract (`torchmd_tpu_torch.ops.bonded`) and
its torch-op bonded path (`torchmd_tpu_torch.bonded`) against the JAX
package.

On the CPU the kernel wrapper runs the kernel's plain PyTorch version:
  - at f32 against `pallas_bonded_energy_forces(..., interpret=True)` with
    the bars of tests/test_pallas_bonded.py:50-57 (energy 5e-6 relative,
    forces 5e-5 of the largest force);
  - at f64 against `torchmd_tpu.bonded.bonded_energy_forces` with 1e-7,
    as is the torch-op path.
Cases: alanine with PBC, the ligand with no box, a multi-term dihedral,
and a seeded random topology with PBC, multi-term maps, CHARMM impropers
and bonds beyond the cutoff.

The kernel plan gives each block of rows its atom window (the span of
the atoms its rows touch, which the kernel sums in shared memory): every
row's atoms lie in it, and blocks whose window exceeds the cap are
counted as adding straight to the forces (`gpu`: the kernel against the
plain version on thrombin and alanine with and without the windows, its
counters against the plan's).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DATA_DIR

from torchmd_tpu import bonded as jbonded
from torchmd_tpu import potentials as jpot
from torchmd_tpu.forcefields import ForceField
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.io import Molecule
from torchmd_tpu.ops import pallas_bonded as jpb
from torchmd_tpu.parameters import Parameters
from torchmd_tpu.units import ELEC_FACTOR
from torchmd_tpu_torch import bonded as tbonded
from torchmd_tpu_torch.interop import ffparams_from_numpy
from torchmd_tpu_torch.ops import bonded as kb
from torchmd_tpu_torch.potentials import ForceTermConfig

# one intra-op thread per test process: the suite runs under xdist, and
# a pool of one thread per core in every worker oversubscribes the CPU
torch.set_num_threads(1)

TERMS = ["bonds", "angles", "dihedrals", "impropers", "1-4",
         "electrostatics", "lj"]


def _data_case(folder, coords, extra=None, precision="double"):
    d = os.path.join(DATA_DIR, folder)
    mol = Molecule(os.path.join(d, "structure.prmtop"))
    mol.read(os.path.join(d, coords))
    if extra:
        mol.read(os.path.join(d, extra))
    ff = ForceField.create(mol, os.path.join(d, "structure.prmtop"))
    par = Parameters(ff, mol, TERMS, precision=precision)
    jf = JaxForces(par, terms=TERMS, precision=precision, cutoff=9.0,
                   rfa=True, switch_dist=7.5)
    box = mol.box[:, 0].astype(np.float64) if extra else None
    return jf.ffparams, jf.config, mol.coords[:, :, 0].astype(np.float64), box


def _multiterm_case(precision="double"):
    """Four atoms, one CHARMM-style dihedral with three terms (a
    non-identity instance -> assignment map)."""
    from torchmd_tpu.forcefields.ff_yaml import YamlForcefield

    types = ("C1", "C2", "C3", "C4")
    ffdict = {
        "atomtypes": list(types),
        "masses": {t: 12.0 for t in types},
        "bonds": {"(X, X)": {"k0": 100.0, "req": 1.5}},
        "angles": {"(X, X, X)": {"k0": 30.0, "theta0": 110.0}},
        "dihedrals": {"(C1, C2, C3, C4)": {"terms": [
            {"phi_k": 1.0, "phase": 0.0, "per": 1},
            {"phi_k": 0.5, "phase": 180.0, "per": 2},
            {"phi_k": 0.2, "phase": 0.0, "per": 3},
        ]}},
        "lj": {t: {"sigma": 3.0, "epsilon": 0.1, "sigma14": 3.0,
                   "epsilon14": 0.1} for t in types},
        "electrostatics": {t: {"charge": 0.05} for t in types},
    }
    mol = Molecule()
    mol.numAtoms = 4
    mol.atomtype = np.array(types, dtype=object)
    mol.charge = np.full(4, 0.05)
    mol.masses = np.full(4, 12.0)
    mol.bonds = np.array([[0, 1], [1, 2], [2, 3]])
    mol.angles = np.array([[0, 1, 2], [1, 2, 3]])
    mol.dihedrals = np.array([[0, 1, 2, 3]])
    mol.impropers = np.zeros((0, 4), dtype=np.int64)
    mol.coords = np.array(
        [[0.0, 0, 0], [1.5, 0, 0], [2.1, 1.3, 0], [3.0, 1.5, 1.1]]
    ).reshape(4, 3, 1)
    terms = ["bonds", "angles", "dihedrals"]
    par = Parameters(YamlForcefield(mol, ffdict), mol, terms, precision=precision)
    jf = JaxForces(par, terms=terms, precision=precision)
    assert len(np.asarray(jf.ffparams.dihedrals.map_term)) == 3
    return jf.ffparams, jf.config, mol.coords[:, :, 0].astype(np.float64), None


def _random_numpy_tables(seed=7):
    """A seeded random topology as numpy FFParams fields: 40 atoms on a
    jittered grid in a periodic box, random bonds (some beyond the 5 A
    cutoff), angles, multi-term AMBER dihedrals, CHARMM impropers and 1-4
    pairs."""
    rs = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(3),
                                indexing="ij"), -1).reshape(-1, 3) * 3.0
    n = 40
    pos = grid[:n] + 0.3 * rs.randn(n, 3)
    box = np.array([12.0, 12.0, 9.0])

    def distinct(k, arity):
        return np.stack([rs.choice(n, arity, replace=False) for _ in range(k)])

    def table(idx, params, terms_per=None):
        ninst = len(idx)
        if terms_per is None:
            map_term = np.arange(ninst)
            map_param = rs.randint(0, len(params), ninst)
        else:
            map_term = np.repeat(np.arange(ninst), terms_per)
            map_param = rs.randint(0, len(params), len(map_term))
        return dict(idx=idx, map_term=map_term, map_param=map_param,
                    params=params)

    nb14_idx = distinct(15, 2)
    d = dict(
        charges=0.3 * rs.randn(n),
        masses=np.full((n, 1), 12.0),
        mapped_atom_types=np.zeros(n, np.int64),
        lj_params=np.array([[3.0, 0.1]]),
        bonds=table(distinct(30, 2), np.column_stack(
            [rs.uniform(50, 300, 6), rs.uniform(1.0, 1.6, 6)])),
        angles=table(distinct(25, 3), np.column_stack(
            [rs.uniform(20, 80, 5), rs.uniform(1.7, 2.1, 5)])),
        dihedrals=table(distinct(20, 4), np.column_stack(
            [rs.uniform(0.1, 2.0, 8), rs.choice([0.0, np.pi], 8),
             rs.randint(1, 4, 8).astype(float)]),
            terms_per=rs.randint(1, 4, 20)),
        impropers=table(distinct(10, 4), np.column_stack(
            [rs.uniform(5, 40, 4), rs.uniform(-0.3, 0.3, 4), np.zeros(4)])),
        nb14=dict(idx=nb14_idx, map_term=np.arange(15),
                  map_param=np.arange(15), params=np.column_stack(
                      [rs.uniform(5e4, 2e5, 15), rs.uniform(50, 300, 15),
                       np.full(15, 2.0), np.full(15, 1.2)])),
    )
    cfg = dict(terms=tuple(TERMS), cutoff=5.0, dihedrals_amber=True,
               impropers_amber=False)
    return d, cfg, pos, box


def _random_case(precision="double"):
    d, cfg, pos, box = _random_numpy_tables()
    jdt = jnp.float32 if precision == "single" else jnp.float64

    def jtable(t):
        return jpot.TermTable(jnp.asarray(t["idx"], jnp.int32),
                              jnp.asarray(t["map_term"], jnp.int32),
                              jnp.asarray(t["map_param"], jnp.int32),
                              jnp.asarray(t["params"], jdt))

    jffp = jpot.FFParams(
        charges=jnp.asarray(d["charges"], jdt),
        masses=jnp.asarray(d["masses"], jdt),
        mapped_atom_types=jnp.asarray(d["mapped_atom_types"], jnp.int32),
        lj_params=jnp.asarray(d["lj_params"], jdt),
        bonds=jtable(d["bonds"]), angles=jtable(d["angles"]),
        dihedrals=jtable(d["dihedrals"]), impropers=jtable(d["impropers"]),
        nb14=jtable(d["nb14"]), nb_mask=None,
    )
    return jffp, jpot.ForceTermConfig(**cfg), pos, box


CASES = {
    "alanine-pbc": lambda p: _data_case("prod_alanine_dipeptide_amber",
                                        "input.coor", "input.xsc", p),
    "ligand-nobox": lambda p: _data_case("ligand-amber", "structure.pdb",
                                         precision=p),
    "multiterm-dihedral": _multiterm_case,
    "random-topology": _random_case,
}


def _port(jffp, jcfg, dtype):
    """The same parameters handed to the port through numpy."""
    ffp = ffparams_from_numpy(jax.tree_util.tree_map(np.asarray, jffp),
                              dtype=dtype)
    return ffp, ForceTermConfig(**jcfg._asdict())


def _jax_bonded(jffp, jcfg, pos, box):
    plan = jbonded.build_bonded_plan(jffp, jcfg)
    fn = jax.jit(lambda p, b: jbonded.bonded_energy_forces(jffp, plan, p, b, jcfg))
    return fn(jnp.asarray(pos), None if box is None else jnp.asarray(box))


def _t(a, dtype):
    return None if a is None else torch.as_tensor(a, dtype=dtype)


def _check(got, got_f, want, want_f, e_tol, f_tol):
    assert set(got) == set(want)
    for k in want:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= e_tol * max(1.0, abs(w)), (k, g, w)
    got_f, want_f = np.asarray(got_f), np.asarray(want_f)
    assert np.abs(got_f - want_f).max() <= f_tol * max(1.0, np.abs(want_f).max())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_pallas_interpret_f32(name):
    jffp, jcfg, pos, box = CASES[name]("single")
    jbox = None if box is None else jnp.asarray(box, jnp.float32)
    plan_j = jpb.build_pallas_bonded_plan(jffp, jcfg)
    want, want_f = jpb.pallas_bonded_energy_forces(
        plan_j, jnp.asarray(pos, jnp.float32), jbox, interpret=True)
    ffp, cfg = _port(jffp, jcfg, torch.float32)
    plan = kb.build_bonded_kernel_plan(ffp, cfg)
    got, got_f = kb.bonded_energy_forces(plan, _t(pos, torch.float32),
                                         _t(box, torch.float32))
    _check(got, got_f, want, want_f, 5e-6, 5e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_jax_bonded_f64(name):
    jffp, jcfg, pos, box = CASES[name]("double")
    want, want_f = _jax_bonded(jffp, jcfg, pos, box)
    ffp, cfg = _port(jffp, jcfg, torch.float64)
    plan = kb.build_bonded_kernel_plan(ffp, cfg)
    got, got_f = kb.bonded_energy_forces(plan, _t(pos, torch.float64),
                                         _t(box, torch.float64))
    _check(got, got_f, want, want_f, 1e-7, 1e-7)


@pytest.mark.parametrize("name", list(CASES))
def test_torch_op_bonded_matches_jax_bonded_f64(name):
    jffp, jcfg, pos, box = CASES[name]("double")
    want, want_f = _jax_bonded(jffp, jcfg, pos, box)
    ffp, cfg = _port(jffp, jcfg, torch.float64)
    got, got_f = tbonded.bonded_energy_forces(
        ffp, tbonded.build_bonded_plan(ffp, cfg), _t(pos, torch.float64),
        _t(box, torch.float64), cfg)
    _check(got, got_f, want, want_f, 1e-7, 1e-7)


def test_random_topology_exercises_the_cutoff_filter():
    """Some random bonds lie beyond the 5 A cutoff: dropping them changes
    the bond energy, so the filter is really tested above."""
    jffp, jcfg, pos, box = _random_case()
    ffp, cfg = _port(jffp, jcfg, torch.float64)
    p, b = _t(pos, torch.float64), _t(box, torch.float64)
    with_cut, _ = kb.bonded_energy_forces(kb.build_bonded_kernel_plan(ffp, cfg), p, b)
    cfg_nocut = cfg._replace(cutoff=None)
    no_cut, _ = kb.bonded_energy_forces(
        kb.build_bonded_kernel_plan(ffp, cfg_nocut), p, b)
    assert float(no_cut["bonds"]) > float(with_cut["bonds"]) + 1.0


def test_kernel_plan_layout():
    """Rows expanded per assignment, padded per family to whole blocks,
    sorted by lowest atom; 1-4 rows are A/scnb, B/scnb, ELEC*qi*qj/scee."""
    jffp, jcfg, _, _ = _random_case()
    ffp, cfg = _port(jffp, jcfg, torch.float64)
    plan = kb.build_bonded_kernel_plan(ffp, cfg)
    names = [f.name for f in plan.families]
    assert names == ["bonds", "angles", "dihedrals", "impropers", "1-4"]
    nassign = {"bonds": 30, "angles": 25, "impropers": 10, "1-4": 15,
               "dihedrals": len(np.asarray(jffp.dihedrals.map_term))}
    for f in plan.families:
        assert f.count == nassign[f.name]
        assert f.row0 % plan.rows == 0 and f.nblocks * plan.rows >= f.count
        rows = plan.idx[f.row0:f.row0 + f.nblocks * plan.rows].numpy()
        lo = rows[:f.count, :kb.ARITY[f.kind]].min(axis=1)
        assert np.all(np.diff(lo) >= 0)
        assert np.all(rows[f.count:] == -1)
    f = plan.families[-1]
    i, j = plan.idx[f.row0, 0].item(), plan.idx[f.row0, 1].item()
    d, _, _, _ = _random_numpy_tables()
    k = int(np.where((d["nb14"]["idx"] == [i, j]).all(1))[0][0])
    a, b, scnb, scee = d["nb14"]["params"][k]
    q = d["charges"]
    np.testing.assert_allclose(
        plan.par[f.row0].numpy(),
        [a / scnb, b / scnb, ELEC_FACTOR * q[i] * q[j] / scee], rtol=1e-12)


def _thrombin_kernel_inputs(dtype, device="cpu"):
    """(port FFParams, cfg, positions) of thrombin through the port's own
    front end (7 terms, cutoff 7.3 A, reaction field)."""
    from torchmd_tpu_torch import Forces
    from torchmd_tpu_torch.forcefields.ff_amber import AmberForcefield
    from torchmd_tpu_torch.io import Molecule as TMolecule
    from torchmd_tpu_torch.parameters import Parameters as TParameters

    d = os.path.join(DATA_DIR, "thrombin-ligand-amber")
    mol = TMolecule(os.path.join(d, "structure.prmtop"))
    mol.read(os.path.join(d, "structure.pdb"))
    par = TParameters(AmberForcefield(mol, os.path.join(d, "structure.prmtop")), mol, TERMS,
                      precision="double" if dtype == torch.float64 else "single")
    f = Forces(par, terms=TERMS, cutoff=7.3, rfa=True, device=device, kernel="dense")
    pos = torch.as_tensor(mol.coords[:, :, 0], dtype=dtype, device=device)
    return f.ffparams, f.config, pos


@pytest.mark.parametrize("cap", ["median", "zero"])
def test_kernel_plan_windows(cap):
    """Thrombin's plan: every row's atoms lie in its block's window
    [first, first + atoms), which is tight; the kernel's shared window is
    the widest window up to the cap, and the blocks over a cap (the median
    window, or 0: every block) are the ones counted as adding straight to
    the forces. The plain version gives the same bits whatever the cap,
    and with `out` adds into the caller's buffer."""
    ffp, cfg, pos = _thrombin_kernel_inputs(torch.float64)
    plan = kb.build_bonded_kernel_plan(ffp, cfg)
    rows = plan.rows
    idx = plan.idx.numpy().reshape(-1, rows, 4)
    win = plan.windows.numpy()
    assert win.shape == (idx.shape[0], 2)
    for b in range(idx.shape[0]):
        atoms = idx[b][idx[b] >= 0]
        assert atoms.min() == win[b, 0] and atoms.max() == win[b, 0] + win[b, 1] - 1, b
    assert plan.wcap == win[:, 1].max() <= kb.WCAP   # thrombin: every window fits
    real = sum(f.count for f in plan.families)
    assert kb.window_stats(plan) == {"window_rows": real, "direct_rows": 0,
                                     "window_blocks": len(win), "direct_blocks": 0}
    cap = int(np.median(win[:, 1])) if cap == "median" else 0
    small = kb.build_bonded_kernel_plan(ffp, cfg, wcap=cap)
    st = kb.window_stats(small)
    over = win[:, 1] > cap
    assert small.wcap == win[~over, 1].max(initial=0) <= cap
    assert (st["window_blocks"], st["direct_blocks"]) == (int((~over).sum()), int(over.sum()))
    assert st["window_rows"] + st["direct_rows"] == real and st["direct_rows"] > 0
    with pytest.raises(ValueError, match="wcap"):
        kb.build_bonded_kernel_plan(ffp, cfg, wcap=kb.WCAP + 1)
    e0, f0 = kb.bonded_energy_forces(plan, pos)
    e1, f1 = kb.bonded_energy_forces(small, pos)
    assert torch.equal(f0, f1) and all(torch.equal(e0[k], e1[k]) for k in e0)
    buf = torch.ones_like(pos)
    e2, f2 = kb.bonded_energy_forces(plan, pos, out=buf)
    assert f2 is buf and torch.allclose(f2, f0 + 1.0, rtol=0, atol=1e-9)


def test_zero_force_constant_rows_leave_the_plan():
    """Rows with a zero force constant add 0 energy and 0 force: the plan
    leaves them out and still matches the JAX package at f64 (1e-7); a term
    whose rows are all zero keeps its 0 energy with no rows."""
    jffp, jcfg, pos, box = _random_case()
    bp = np.asarray(jffp.bonds.params).copy()
    bp[::2, 0] = 0.0
    ap = np.asarray(jffp.angles.params).copy()
    ap[:, 0] = 0.0
    jffp = jffp._replace(bonds=jffp.bonds._replace(params=jnp.asarray(bp)),
                         angles=jffp.angles._replace(params=jnp.asarray(ap)))
    want, want_f = _jax_bonded(jffp, jcfg, pos, box)
    ffp, cfg = _port(jffp, jcfg, torch.float64)
    plan = kb.build_bonded_kernel_plan(ffp, cfg)
    live = int((bp[np.asarray(jffp.bonds.map_param), 0] != 0).sum())
    assert [f.name for f in plan.families] == ["bonds", "dihedrals", "impropers", "1-4"]
    assert 0 < plan.families[0].count == live < 30
    assert plan.zero_terms == ("angles",)
    got, got_f = kb.bonded_energy_forces(plan, _t(pos, torch.float64),
                                         _t(box, torch.float64))
    _check(got, got_f, want, want_f, 1e-7, 1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("wcap", [kb.WCAP, 0], ids=["window", "no-window"])
@pytest.mark.parametrize("case", ["thrombin", "alanine-pbc"])
def test_cuda_bonded_kernel_matches_plain(case, wcap):
    """The bonded kernel against the plain f64 version at the Pallas bars
    (5e-6 relative energy, 5e-5 of the largest force), its rows and
    blocks counted as the plan sets them (`chip_smoke.bonded_walk`), its
    energies bitwise equal over two runs, and with `out` adding into the
    caller's buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke

    c = dict(chip_smoke.dense_pair_cases())[case]
    plan = kb.build_bonded_kernel_plan(c["ffp32"], c["cfg"], wcap=wcap)
    want, want_f = kb.bonded_reference(kb.build_bonded_kernel_plan(c["ffp64"], c["cfg"]),
                                       c["p64"], c["b64"])
    got, got_f = chip_smoke.bonded_walk(case, plan, c["p32"], c["b32"])
    _check({k: float(v) for k, v in got.items()}, got_f.cpu().double().numpy(),
           {k: float(v) for k, v in want.items()}, want_f.cpu().numpy(), 5e-6, 5e-5)
    again = kb.bonded_energy_forces(plan, c["p32"], c["b32"])[0]
    assert all(torch.equal(got[k], again[k]) for k in got)
    buf = torch.ones_like(c["p32"])
    _, added = kb.bonded_energy_forces(plan, c["p32"], c["b32"], out=buf)
    assert added is buf
    assert float((added - 1.0 - got_f).abs().max()) <= 1e-5 * float(got_f.abs().max())
