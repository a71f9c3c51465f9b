"""The port's pair kernel contract (`torchmd_tpu_torch.ops.nonbonded`)
against the JAX package.

On the CPU the wrapper runs the kernel's plain PyTorch version, so these
tests pin that version (and the kernel inputs `prepare_nb_data` builds):
  - at f32 against `pallas_nonbonded_energy_forces(..., interpret=True)`
    with the bars of tests/test_pallas.py:51-57 (energy 2e-5 relative,
    forces 5e-5 of the largest force);
  - at f64 against `torchmd_tpu.potentials.nonbonded_energy_forces` with
    1e-7.
Branches: RFA + switch + PBC, no box (plain Coulomb), Ewald erfc,
repulsion, repulsioncg and NBFIX tables. `prepare_nb_data`'s tile form of
the exclusions (what the kernel reads instead of the mask) holds the
mask's zeros bit for bit. A term set with lj and repulsion takes one
launch per LJ-family term (`launch_cfgs`): `Forces` on that route equals
the JAX `Forces` at f64 per term. The CUDA kernel itself is held to the
plain version by chip_smoke.py and the `gpu`-marked tests below
(chip_smoke's cases, lj + repulsion, bitwise-repeatable forces).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import ALL_TERMS, load_system
from conftest import DATA_DIR

from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.ops import pallas_nonbonded as jpn
from torchmd_tpu.parameters import Parameters
from torchmd_tpu.potentials import nonbonded_energy_forces as jax_dense
from torchmd_tpu_torch.ops import _build
from torchmd_tpu_torch.ops import nonbonded as kn
from torchmd_tpu_torch.potentials import ForceTermConfig, make_ffparams

# one intra-op thread per test process: the suite runs under xdist, and
# a pool of one thread per core in every worker oversubscribes the CPU
torch.set_num_threads(1)

# name: (data folder, terms, Forces overrides, cfg overrides, nbfix)
CASES = {
    "rfa-switch-pbc": ("prod_alanine_dipeptide_amber", ALL_TERMS,
                       dict(cutoff=9.0, switch_dist=7.5, rfa=True), {}, False),
    "nobox-coulomb": ("ligand-amber", ALL_TERMS, {}, {}, False),
    "ewald": ("2watersperiodic", ALL_TERMS, dict(cutoff=8.0, rfa=False,
                                                 switch_dist=None),
              dict(ewald_alpha=0.4112), False),
    "repulsion": ("prod_alanine_dipeptide_amber",
                  ["bonds", "electrostatics", "repulsion"],
                  dict(cutoff=9.0, rfa=True), {}, False),
    "repulsioncg": ("prod_alanine_dipeptide_amber", ["repulsioncg"],
                    dict(cutoff=9.0), {}, False),
    "nbfix": ("waterbox", ALL_TERMS, {}, {}, True),
}


def _perturbed_tables(lj_params):
    """Lorentz-Berthelot A/B tables with one pair changed (as in
    tests/test_pallas.py::test_pallas_kernel_nbfix_tables)."""
    sig = np.asarray(lj_params[:, 0], np.float64)
    eps = np.abs(np.asarray(lj_params[:, 1], np.float64))
    s6 = (0.5 * (sig[:, None] + sig[None, :])) ** 6
    B = 4.0 * np.sqrt(eps[:, None] * eps[None, :]) * s6
    A = B * s6
    A[0, 1] = A[1, 0] = A[0, 1] * 1.35 + 10.0
    B[0, 1] = B[1, 0] = B[0, 1] * 0.8 + 1.0
    return A, B


def _case(name, precision):
    """(jax FFParams, jax cfg, port FFParams, port cfg, pos, box or None)."""
    folder, terms, over, cfg_over, nbfix = CASES[name]
    mol, ff, nbconf = load_system(os.path.join(DATA_DIR, folder))
    nbconf.update(over)
    par = Parameters(ff, mol, terms, precision=precision)
    jf = JaxForces(par, terms=terms, precision=precision, **nbconf)
    jcfg = jf.config._replace(**cfg_over)
    dt = torch.float32 if precision == "single" else torch.float64
    ffp = make_ffparams(par, dtype=dt)
    jffp = jf.ffparams
    if nbfix:
        A, B = _perturbed_tables(np.asarray(jffp.lj_params))
        jdt = jnp.float32 if precision == "single" else jnp.float64
        jffp = jffp._replace(lj_ab=(jnp.asarray(A, jdt), jnp.asarray(B, jdt)))
        ffp = ffp._replace(lj_ab=(torch.as_tensor(A, dtype=dt),
                                  torch.as_tensor(B, dtype=dt)))
    box = mol.box[:, 0].astype(np.float64)
    box = box if np.any(box != 0) else None
    return (jffp, jcfg, ffp, ForceTermConfig(**jcfg._asdict()),
            mol.coords[:, :, 0].astype(np.float64), box)


def _port(ffp, cfg, pos, box, dtype, **kw):
    data = kn.prepare_nb_data(ffp)
    tbox = None if box is None else torch.as_tensor(box, dtype=dtype)
    pot, frc = kn.nonbonded_energy_forces(data, cfg, torch.as_tensor(pos, dtype=dtype),
                                          tbox, **kw)
    return {k: float(v) for k, v in pot.items()}, frc.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_pallas_interpret_f32(name):
    jffp, jcfg, ffp, cfg, pos, box = _case(name, "single")
    jbox = None if box is None else jnp.asarray(box, jnp.float32)
    want, want_f = jpn.pallas_nonbonded_energy_forces(
        jpn.prepare_nb_data(jffp), jcfg, jnp.asarray(pos, jnp.float32), jbox,
        interpret=True)
    got, got_f = _port(ffp, cfg, pos, box, torch.float32)
    assert set(got) == set(want)
    for k in want:
        w = float(want[k])
        assert abs(got[k] - w) <= 2e-5 * max(1.0, abs(w)), (k, got[k], w)
    want_f = np.asarray(want_f)
    assert np.abs(got_f - want_f).max() <= 5e-5 * max(1.0, np.abs(want_f).max())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_dense_f64(name):
    jffp, jcfg, ffp, cfg, pos, box = _case(name, "double")
    want, want_f = jax_dense(jffp, jnp.asarray(pos),
                             None if box is None else jnp.asarray(box), jcfg)
    got, got_f = _port(ffp, cfg, pos, box, torch.float64)
    assert set(got) == set(want)
    for k in want:
        w = float(want[k])
        assert abs(got[k] - w) <= 1e-7 * max(1.0, abs(w)), (k, got[k], w)
    want_f = np.asarray(want_f)
    assert np.abs(got_f - want_f).max() <= 1e-7 * max(1.0, np.abs(want_f).max())


def test_row_blocks_do_not_change_the_result(monkeypatch):
    """The plain version walks the square in row blocks, as the kernel
    walks it in i-tiles: a block size that leaves a ragged last block
    gives the same numbers."""
    _, _, ffp, cfg, pos, box = _case("rfa-switch-pbc", "double")
    data = kn.prepare_nb_data(ffp)
    p, b = torch.as_tensor(pos), torch.as_tensor(box)
    pot1, f1 = kn.pair_terms_reference(data, cfg, p, b)
    monkeypatch.setattr(kn, "REFERENCE_ROWS", 100)
    pot2, f2 = kn.pair_terms_reference(data, cfg, p, b)
    for k in pot1:
        assert abs(float(pot1[k]) - float(pot2[k])) <= 1e-10 * abs(float(pot1[k]))
    assert float((f1 - f2).abs().max()) <= 1e-10


def test_launch_cfgs_split_the_lj_family():
    """One LJ-family term a launch: the first launch keeps the
    electrostatics, each further LJ-family term launches alone."""
    cfg = ForceTermConfig(terms=("bonds", "lj", "electrostatics", "repulsioncg", "repulsion"))
    got = [c.terms for c in kn.launch_cfgs(cfg)]
    assert got == [("bonds", "lj", "electrostatics"), ("repulsion",), ("repulsioncg",)]
    one = cfg._replace(terms=("lj", "electrostatics"))
    assert kn.launch_cfgs(one) == [one]
    assert all(kn.supported_terms(c) for c in kn.launch_cfgs(cfg))


def test_forces_lj_and_repulsion_on_the_kernel_route_match_jax_f64():
    """Alanine with lj + repulsion through `Forces` on the kernel route
    (the dense pair kernel's plain version, two launches) against the JAX
    `Forces` at f64: per term and forces within 1e-7."""
    from torchmd_tpu_torch import Forces

    mol, ff, _ = load_system(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber"))
    terms = ALL_TERMS + ["repulsion"]
    par = Parameters(ff, mol, terms, precision="double")
    pos, box = mol.coords[:, :, 0][None], mol.box[:, 0][None]
    kw = dict(terms=terms, precision="double", cutoff=9.0, switch_dist=7.5, rfa=True)
    jforces, tforces = np.zeros_like(pos), np.zeros_like(pos)
    want = JaxForces(par, **kw).compute(pos, box, jforces, returnDetails=True)[0]
    tf = Forces(par, device="cpu", **kw)
    assert tf.use_kernels and tf._cell_kernel is None
    got = tf.compute(pos, box, tforces, returnDetails=True)[0]
    assert set(got) == set(want) and {"lj", "repulsion"} <= set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-7, abs=1e-7), k
    assert np.abs(tforces - jforces).max() <= 1e-7 * max(1.0, np.abs(jforces).max())


def test_make_kernel_cfg_matches_jax():
    _, jcfg, _, cfg, _, _ = _case("rfa-switch-pbc", "double")
    assert kn.make_kernel_cfg(cfg, True) == jpn.make_kernel_cfg(jcfg, True)


def test_prepare_nb_data_rows():
    """Kernel rows carry sigma/2, sqrt|eps|, charges and the int8 mask."""
    jffp, _, ffp, _, _, _ = _case("rfa-switch-pbc", "double")
    data = kn.prepare_nb_data(ffp)
    jdata = jpn.prepare_nb_data(jffp)
    n = data.natoms
    np.testing.assert_allclose(data.sig.numpy(), np.asarray(jdata.sig)[0, :n],
                               rtol=1e-7)
    np.testing.assert_allclose(data.eps.numpy(), np.asarray(jdata.eps)[0, :n],
                               rtol=1e-7)
    np.testing.assert_allclose(data.q.numpy(), np.asarray(jdata.q)[0, :n],
                               rtol=1e-7)
    assert data.mask.dtype == torch.int8
    np.testing.assert_array_equal(data.mask.numpy(), np.asarray(jdata.mask)[:n, :n])


def test_wrapper_rejects_other_devices():
    _, _, ffp, cfg, pos, _ = _case("nobox-coulomb", "single")
    data = kn.prepare_nb_data(ffp)
    with pytest.raises(ValueError, match="no pair kernel"):
        kn.nonbonded_energy_forces(data, cfg, torch.empty((data.natoms, 3),
                                                          device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("NVCC", str(tmp_path / "missing-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("nonbonded")


def test_library_name_follows_the_source():
    """The build cache is keyed by the source's hash and the flags."""
    path = _build.library_path("nonbonded")
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libnonbonded_")
    assert path != _build.library_path("bonded")


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__c7e98fa1_12_nonbonded_cu_6ed012a011pair_kernelILb1ELb0EEEvPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__c7e98fa1_12_nonbonded_cu_6ed012a011pair_kernelILb1ELb0EEEvPKfS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 47 registers, used 1 barriers, 19488 bytes smem, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_Z11pair_finishPKfPKd' for 'sm_90a'
ptxas info    : Function properties for _Z11pair_finishPKfPKd
    32 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 18 registers, 424 bytes cmem[0]
"""


def test_resource_usage_reads_the_ptxas_report(monkeypatch, tmp_path):
    """A built library's log gives each kernel's registers and spills."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    lib = _build.library_path("nonbonded")
    open(lib, "wb").close()
    with open(lib[:-len(".so")] + ".log", "w") as fh:
        fh.write(PTXAS_LOG)
    assert _build.resource_usage("nonbonded") == {
        "pair_kernel<1,0>": dict(stack=0, spill_stores=0, spill_loads=0,
                                 registers=47, smem=19488),
        "pair_finish": dict(stack=32, spill_stores=8, spill_loads=4,
                            registers=18, smem=0),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rfa-switch-pbc", "ewald", "nbfix"])
def test_cuda_kernel_matches_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, _, ffp, cfg, pos, box = _case(name, "double")
    dev = torch.device("cuda")
    d64 = kn.prepare_nb_data(ffp)
    d32 = kn.NBData(*[v.to(dev, torch.float32) if isinstance(v, torch.Tensor)
                      and v.is_floating_point() else
                      (v.to(dev) if isinstance(v, torch.Tensor) else v)
                      for v in d64])
    b32 = None if box is None else torch.as_tensor(box, dtype=torch.float32,
                                                   device=dev)
    pot_k, f_k = kn.nonbonded_energy_forces(
        d32, cfg, torch.as_tensor(pos, dtype=torch.float32, device=dev), b32)
    pot_p, f_p = kn.pair_terms_reference(
        d64, cfg, torch.as_tensor(pos), None if box is None else torch.as_tensor(box))
    for k in pot_p:
        w = float(pot_p[k])
        assert abs(float(pot_k[k]) - w) <= 2e-5 * max(1.0, abs(w)), k
    f_k = f_k.double().cpu()
    assert float((f_k - f_p).abs().max()) <= 5e-5 * max(1.0, float(f_p.abs().max()))


def _expand_exclusions(natoms, start, tile, bits):
    """The (N, N) bool matrix of excluded pairs that `kn.tile_exclusions`
    describes: bit k of bits[x, r] is pair (32 I + r, 32 tile[x] + k) for
    the i tile I with start[I] <= x < start[I + 1]."""
    nt = int(start.shape[0]) - 1
    zero = torch.zeros((nt, kn.TILE, nt, kn.TILE), dtype=torch.bool)
    ti = torch.repeat_interleave(torch.arange(nt), (start[1:] - start[:-1]).long())
    set_bits = (bits.long()[:, :, None] >> torch.arange(kn.TILE)) & 1
    zero[ti, :, tile.long(), :] = set_bits.bool()
    return zero.view(nt * kn.TILE, nt * kn.TILE)[:natoms, :natoms]


@pytest.mark.parametrize("system", ["thrombin-ligand-amber", "prod_alanine_dipeptide_amber",
                                    "random"])
def test_tile_exclusions_equal_the_mask(system):
    """The kernel's exclusions (32-bit rows per tile pair that holds a
    zero of the mask, each i tile's j tiles ascending) expand back to the
    mask's zeros bit for bit: on thrombin, alanine dipeptide and a seeded
    random symmetric mask (10 % off-diagonal zeros, 301 atoms, so that the
    last tile is ragged)."""
    if system == "random":
        rs = np.random.RandomState(3)
        zeros = np.triu(rs.rand(301, 301) < 0.1, 1)
        mask = torch.as_tensor(~(zeros | zeros.T), dtype=torch.int8)
        mask.fill_diagonal_(0)
        start, tile, bits = kn.tile_exclusions(mask)
    else:
        mol, ff, _ = load_system(os.path.join(DATA_DIR, system))
        par = Parameters(ff, mol, ALL_TERMS, precision="single")
        data = kn.prepare_nb_data(make_ffparams(par, dtype=torch.float32))
        mask, start, tile, bits = data.mask, data.excl_start, data.excl_tile, data.excl_bits
    n = int(mask.shape[0])
    nt = -(-n // kn.TILE)
    assert start.dtype == tile.dtype == bits.dtype == torch.int32
    assert tuple(start.shape) == (nt + 1,) and tuple(bits.shape) == (tile.shape[0], kn.TILE)
    for t in range(nt):
        row = tile[start[t]:start[t + 1]]
        assert bool((row[1:] > row[:-1]).all()), t
    assert torch.equal(_expand_exclusions(n, start, tile, bits), mask == 0)


DENSE_CASES = ["thrombin", "alanine-pbc", "alanine-ewald", "alanine-repulsion",
               "alanine-nbfix", "thrombin-random-mask", "thrombin-permuted",
               "thrombin-nocutoff"]


def _card_dense_case(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke

    for case, inputs in chip_smoke.dense_pair_cases():
        if case == name:
            return inputs
    raise KeyError(name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", DENSE_CASES)
def test_cuda_dense_walk_matches_plain_f64(name):
    """The culled tile walk against the plain f64 version at the Pallas
    bars on chip_smoke.py's cases: the five systems of the kernel checks,
    thrombin with a random mask, in a random atom order (nothing left to
    cull: the culling never drops a pair) and without a cutoff."""
    c = _card_dense_case(name)
    pot_k, f_k = kn.nonbonded_energy_forces(c["d32"], c["cfg"], c["p32"], c["b32"])
    pot_p, f_p = kn.pair_terms_reference(c["d64"], c["cfg"], c["p64"], c["b64"])
    assert set(pot_k) == set(pot_p)
    for k in pot_p:
        w = float(pot_p[k])
        assert abs(float(pot_k[k]) - w) <= 2e-5 * max(1.0, abs(w)), (k, float(pot_k[k]), w)
    err = float((f_k.double() - f_p).abs().max())
    assert err <= 5e-5 * max(1.0, float(f_p.abs().max())), err


@pytest.mark.gpu
def test_cuda_dense_walk_is_bitwise_repeatable():
    """Partials sum in a fixed order: two runs give the same bits."""
    c = _card_dense_case("thrombin")
    (pot_a, f_a), (pot_b, f_b) = (kn.nonbonded_energy_forces(c["d32"], c["cfg"], c["p32"])
                                  for _ in range(2))
    assert torch.equal(f_a, f_b)
    assert all(torch.equal(pot_a[k], pot_b[k]) for k in pot_a)


@pytest.mark.gpu
def test_cuda_lj_repulsion_matches_plain():
    """lj + repulsion on the card: two launches of the dense pair kernel,
    each term keyed by itself, against the plain f64 version at the
    Pallas bars (chip_smoke's alanine-lj-repulsion case)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    c = _card_dense_case("alanine-lj-repulsion")
    n0 = kn.LAUNCHES
    pot_k, f_k = kn.nonbonded_energy_forces(c["d32"], c["cfg"], c["p32"], c["b32"])
    assert kn.LAUNCHES == n0 + 2
    pot_p, f_p = kn.pair_terms_reference(c["d64"], c["cfg"], c["p64"], c["b64"])
    assert set(pot_k) == set(pot_p) == {"lj", "repulsion", "electrostatics"}
    for k in pot_p:
        assert abs(float(pot_k[k]) - float(pot_p[k])) <= 2e-5 * max(1.0, abs(float(pot_p[k]))), k
    scale = max(1.0, float(f_p.abs().max()))
    assert float((f_k.double() - f_p).abs().max()) <= 5e-5 * scale
