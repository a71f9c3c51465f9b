"""The prep passes of the port's tile kernels (`ops.cell`, `ops.column`):
their plain versions on the CPU, the kernels' own passes on the card.

The cell and column kernels (csrc/cell.cu, csrc/column.cu) walk 32-atom
tiles (csrc/tile_pairs.cuh) from rows that a prep pass packs per call;
the cell list and the column layout themselves stay as they are. On the
216-water TIP4P/2005 box (3x3x3 cells, 3x3 columns) and the charged LJ gas
of tests/test_columns.py (1,500 atoms, 5x5x5 cells, 5x5 columns):

  - `cell_tiles_reference` permutes the atoms of each cell within the cell
    (the occupied slots hold the cell's atoms, each once), in ascending
    Morton order of their 4x4x4 sub-cells;
  - its packed rows equal the gather of the anchored positions, charges,
    sigma/2, sqrt|eps| and ids (exactly), padding at 1e18 A;
  - `column_tiles_reference` packs every extended slot as the gather plus
    its z ghost shift times the box (exactly);
  - every tile box contains its tile's atoms and is tight (its corners
    are the tile's extreme coordinates); an empty tile's box is empty;
  - on the card (marked gpu), the kernels' prep passes give the same rows
    and boxes, integer for integer and bit for bit.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from test_columns import _lj_gas
from test_torch_water import CUTOFF, TERMS, jittered, water_box

from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu_torch import columns as tcol
from torchmd_tpu_torch import interop
from torchmd_tpu_torch import neighbors as tnb
from torchmd_tpu_torch.ops import cell as tcell
from torchmd_tpu_torch.ops import column as kcol
from torchmd_tpu_torch.potentials import ForceTermConfig

# one intra-op thread per test process: the suite runs under xdist, and
# a pool of one thread per core in every worker oversubscribes the CPU
torch.set_num_threads(1)


def _water():
    jpar, _, coords, L = water_box()
    pos = jittered(coords, 7, 0.1)
    jf = JaxForces(jpar, terms=TERMS, precision="single", cutoff=CUTOFF)
    return jpar, jf.ffparams, jf.config._replace(ewald_alpha=0.82), pos, np.full(3, L)


def _gas():
    mol, par, forces, L = _lj_gas(natoms=1500, L=60.0, charges=True)
    return par, forces.ffparams, forces.config, mol.coords[:, :, 0], np.full(3, L)


SYSTEMS = {"water216": _water, "gas": _gas}


def _kernels(name, device="cpu"):
    """(cell kernel, its list, column kernel, its state, positions, box)
    of the port at f32 on `device`, positions moved off the build frame."""
    par, jffp, jcfg, pos, box = SYSTEMS[name]()
    ffp = interop.ffparams_from_numpy(jax.tree_util.tree_map(np.asarray, jffp),
                                      dtype=torch.float32, device=device)
    cfg = ForceTermConfig(**jcfg._asdict())
    p = torch.as_tensor(pos, dtype=torch.float32, device=device)
    b = torch.as_tensor(box, dtype=torch.float32, device=device)
    ck = tnb.CellKernel(ffp, cfg, par, box, pos0=pos)
    cl = ck.build(p, b)
    kk = tcol.ColumnKernel(ffp, cfg, par, box, pos0=pos)
    st = kk.build(p, b)
    # evaluate away from the build frame, across the periodic faces
    moved = p + torch.as_tensor(np.random.RandomState(3).uniform(-0.4, 0.4, pos.shape),
                                dtype=torch.float32, device=device)
    return ck, cl, kk, st, moved, b


def _cell_prep(name):
    from torchmd_tpu_torch.neighbors import anchored_positions

    ck, cl, _, _, p, b = _kernels(name)
    pos_w = anchored_positions(p, cl.ref_pos, b)
    return ck, cl, pos_w, b, tcell.cell_tiles_reference(ck.data, ck.clcfg, cl, pos_w, b)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_cell_prep_permutes_each_cell_in_morton_order(name):
    ck, cl, pos_w, b, tiles = _cell_prep(name)
    ncells, cap = int(np.prod(ck.clcfg.ncells)), ck.clcfg.capacity
    ids = tiles.ids.reshape(ncells, cap)
    counts = cl.counts.long()
    nc = ck.clcfg.ncells
    for c in range(ncells):
        k = int(counts[c])
        got = ids[c, :k]
        assert sorted(got.tolist()) == sorted(cl.slots[c, :k].tolist())
        assert bool((ids[c, k:] == ck.data.natoms).all())
        c3 = torch.tensor([[c // (nc[1] * nc[2]), (c // nc[2]) % nc[1], c % nc[2]]] * k).reshape(k, 3)
        key = tcell.sub_cells(pos_w[got.long()], ck.clcfg, c3, b)
        assert bool((key[1:] >= key[:-1]).all()), c
    assert int(counts.sum()) == ck.data.natoms


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_cell_prep_rows_equal_the_gather(name):
    ck, cl, pos_w, b, tiles = _cell_prep(name)
    ids = tiles.ids.long()
    valid = ids < ck.data.natoms
    i = ids[valid]
    assert torch.equal(tiles.pq[valid, :3], pos_w[i])
    assert torch.equal(tiles.pq[valid, 3], ck.data.q[i])
    assert torch.equal(tiles.aux[valid, 0], ck.data.sig[i])
    assert torch.equal(tiles.aux[valid, 1], ck.data.eps[i])
    # the LJ type's bits in w (the NBFIX instances read them), 0 on padding
    assert torch.equal(tiles.aux[valid, 3].contiguous().view(torch.int32), ck.data.types[i])
    assert bool((tiles.aux[~valid, 3] == 0).all())
    assert bool((tiles.pq[~valid, :3] == tcell.FAR).all())


def _assert_box(box, xyz):
    """`box` (2, 4) is the tight box of the rows `xyz` (k, 3), or empty."""
    lo, hi = box[0, :3], box[1, :3]
    assert bool((box[:, 3] == 0).all())
    if xyz.shape[0] == 0:
        assert bool((lo == tcell.FAR).all()) and bool((hi == -tcell.FAR).all())
        return
    assert torch.equal(lo, xyz.min(0).values) and torch.equal(hi, xyz.max(0).values)
    assert bool(((xyz >= lo) & (xyz <= hi)).all())


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_cell_tile_boxes_contain_their_atoms(name):
    ck, _, _, _, tiles = _cell_prep(name)
    ncells, cap = int(np.prod(ck.clcfg.ncells)), ck.clcfg.capacity
    tpc = -(-cap // tcell.TILE)
    assert tiles.tbox.shape == (ncells * tpc, 2, 4)
    valid = (tiles.ids < ck.data.natoms).reshape(ncells, cap)
    pq = tiles.pq.reshape(ncells, cap, 4)
    for c in range(ncells):
        for t in range(tpc):
            rows = slice(t * tcell.TILE, (t + 1) * tcell.TILE)
            _assert_box(tiles.tbox[c * tpc + t], pq[c, rows][valid[c, rows], :3])


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_column_prep_rows_and_boxes(name):
    from torchmd_tpu_torch.neighbors import anchored_positions

    _, _, kk, st, p, b = _kernels(name)
    pos_w = anchored_positions(p, st.ref_pos, b)
    tiles = kcol.column_tiles_reference(kk.data, st, pos_w, b)
    ids = st.jslot.reshape(-1).long()
    assert torch.equal(tiles.ids.long(), ids)
    valid = ids < kk.data.natoms
    want = pos_w[ids[valid]].clone()
    want[:, 2] = want[:, 2] + st.jzshift.reshape(-1)[valid] * b[2]
    assert torch.equal(tiles.pq[valid, :3], want)
    assert torch.equal(tiles.pq[valid, 3], kk.data.q[ids[valid]])
    assert torch.equal(tiles.aux[valid, 0], kk.data.sig[ids[valid]])
    assert torch.equal(tiles.aux[valid, 1], kk.data.eps[ids[valid]])
    assert bool((tiles.pq[~valid, :3] == tcell.FAR).all())
    ntiles = kk.ccfg.ncol * kk.ccfg.CE // tcell.TILE
    assert tiles.tbox.shape == (ntiles, 2, 4)
    for t in range(ntiles):
        rows = slice(t * tcell.TILE, (t + 1) * tcell.TILE)
        _assert_box(tiles.tbox[t], tiles.pq[rows][valid[rows], :3])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_prep_kernels_equal_their_plain_versions(name):
    from torchmd_tpu_torch.neighbors import anchored_positions

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ck, cl, kk, st, p, b = _kernels(name, "cuda")
    got = tcell.cell_tiles(ck.data, ck.cfg, ck.clcfg, cl, p, b)
    want = tcell.cell_tiles_reference(ck.data, ck.clcfg, cl,
                                      anchored_positions(p, cl.ref_pos, b), b)
    torch.cuda.synchronize()
    valid = want.ids < ck.data.natoms
    assert torch.equal(got.pq[valid], want.pq[valid])
    assert torch.equal(got.aux[valid], want.aux[valid])
    assert torch.equal(got.tbox, want.tbox)
    got = kcol.column_tiles(kk.data, kk.cfg, kk.ccfg, st, p, b)
    want = kcol.column_tiles_reference(kk.data, st, anchored_positions(p, st.ref_pos, b), b)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def _plain_inputs(ck, cl):
    """The kernel's CellData and structure at f64 on the CPU."""
    d64 = tcell.CellData(**{k: (v.cpu().double() if torch.is_tensor(v) and v.is_floating_point()
                                else v.cpu() if torch.is_tensor(v) else v)
                            for k, v in ck.data._asdict().items()})
    cpu = type(cl)(*(t.cpu() for t in cl))
    return d64, cpu._replace(ref_pos=cpu.ref_pos.double(), **(
        {"jzshift": cpu.jzshift.double()} if hasattr(cpu, "jzshift") else {}))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["cell", "column"])
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_tile_kernels_on_cuda_match_plain_with_virial(name, kernel):
    """The redesigned cell and column kernels (f32) against their plain
    versions (f64) at the Pallas bars, with the per-axis virial; forces
    bitwise equal from run to run (no atomics); the walk's counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ck, cl, kk, st, p, b = _kernels(name, "cuda")
    if kernel == "column":
        ck, cl = kk, st
        run, plain = kcol.column_energy_forces, kcol.column_reference
        layout = kk.ccfg
    else:
        run, plain = tcell.cell_energy_forces, tcell.cell_reference
        layout = ck.clcfg
    stats = torch.zeros(tcell.NSTATS, dtype=torch.int64, device="cuda")
    pot_k, f_k, vir_k = run(ck.data, ck.cfg, layout, cl, p, b, with_virial=True, stats=stats)
    _, f_again, _ = run(ck.data, ck.cfg, layout, cl, p, b, with_virial=True)
    d64, cl64 = _plain_inputs(ck, cl)
    pot_p, f_p, vir_p = plain(d64, ck.cfg, layout, cl64, p.cpu().double(), b.cpu().double(),
                              with_virial=True)
    assert torch.equal(f_k, f_again)
    for k in pot_p:
        assert abs(float(pot_k[k]) - float(pot_p[k])) <= 2e-5 * max(1.0, abs(float(pot_p[k])))
    assert float((f_k.cpu().double() - f_p).abs().max()) <= 5e-5 * max(1.0, float(f_p.abs().max()))
    err = (vir_k.cpu().double() - vir_p).abs()
    assert bool((err <= 2e-5 * torch.clamp(vir_p.abs(), min=1.0)).all()), (vir_k, vir_p)
    walk = dict(zip(tcell.STATS, stats.tolist()))
    assert 0 < walk["tile_pairs"] <= walk["candidate_tile_pairs"]
    assert 0 < walk["lane_rounds"] <= 32 * walk["rounds"]
    assert walk["lane_rounds"] <= walk["slot_pairs"]
