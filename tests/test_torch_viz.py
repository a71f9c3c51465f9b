"""The port's frame renderer (`torchmd_tpu_torch.viz`) against the JAX
package's, both under matplotlib's Agg backend.

  - `view_frame` writes a PNG;
  - the figure's scatter (positions and element colours), bond lines and
    force quiver equal the JAX figure's, for numpy inputs and for torch
    tensors; forces at twice the scale, the planted fault, must not;
  - `viewFrame` writes viewframe.png in the working directory;
  - `python -m torchmd_tpu_torch.analysis --traj ... --view` writes its
    PNG, as the JAX CLI does.
"""

from __future__ import annotations

import os

import pytest

# the card's machine has no matplotlib; its card-only run collects this
# module too, and the renderer has no card path
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import numpy as np
import torch

from torchmd_tpu import viz as jviz
from torchmd_tpu_torch import viz as tviz

torch.set_num_threads(1)


class _Mol:
    element = np.array(["O", "H", "H", "C", "N", "Xx"], dtype=object)
    bonds = np.array([[0, 1], [0, 2], [3, 4]])


def _frame(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(6, 3) * 2.0, rs.randn(6, 3) * 50.0


def _parts(fig):
    """(scatter offsets, face colours, line data, quiver segments)."""
    ax = fig.axes[0]
    sc = [c for c in ax.collections if hasattr(c, "_offsets3d")][0]
    quiv = [c for c in ax.collections if hasattr(c, "_segments3d")]
    lines = [np.asarray(ln.get_data_3d()) for ln in ax.lines]
    return (np.asarray(sc._offsets3d), sc.get_facecolors(), lines,
            [np.asarray(q._segments3d) for q in quiv])


def _same(a, b):
    (oa, ca, la, qa), (ob, cb, lb, qb) = a, b
    np.testing.assert_array_equal(oa, ob)
    np.testing.assert_array_equal(ca, cb)
    assert len(la) == len(lb) == 3
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)
    assert len(qa) == len(qb) == 1
    np.testing.assert_array_equal(qa[0], qb[0])


def test_view_frame_writes_a_png(tmp_path):
    pos, frc = _frame()
    out = tmp_path / "frame.png"
    tviz.view_frame(_Mol(), pos, frc, out=str(out), title="t")
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("as_tensor", [False, True])
def test_figure_matches_jax(tmp_path, as_tensor):
    pos, frc = _frame(1)
    want = _parts(jviz.view_frame(_Mol(), pos[None], frc[None], out=str(tmp_path / "j.png")))
    p, f = (torch.as_tensor(pos), torch.as_tensor(frc)) if as_tensor else (pos, frc)
    got = _parts(tviz.view_frame(_Mol(), p[None], f[None], out=str(tmp_path / "t.png")))
    _same(got, want)


def test_doubled_forces_must_fail(tmp_path):
    pos, frc = _frame(2)
    want = _parts(jviz.view_frame(_Mol(), pos, frc, out=str(tmp_path / "j.png")))
    got = _parts(tviz.view_frame(_Mol(), pos, 2.0 * frc, out=str(tmp_path / "t.png")))
    with pytest.raises(AssertionError):
        _same(got, want)


def test_viewframe_alias(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pos, frc = _frame(3)
    tviz.viewFrame(None, pos, frc)
    assert os.path.getsize(tmp_path / "viewframe.png") > 1000


def test_analysis_view_writes_png(tmp_path):
    from torchmd_tpu.analysis import main as jax_main
    from torchmd_tpu_torch.analysis import main

    traj = np.random.RandomState(4).randn(5, 3, 3)      # (natoms, 3, nframes)
    np.save(tmp_path / "output_0.npy", traj)
    main([str(tmp_path), "--traj", "output_0.npy", "--view", str(tmp_path / "t.png"),
          "--device", "cpu"])
    jax_main([str(tmp_path), "--traj", "output_0.npy", "--view", str(tmp_path / "j.png")])
    assert (tmp_path / "t.png").read_bytes()[:4] == b"\x89PNG"
    assert os.path.getsize(tmp_path / "j.png") > 1000
