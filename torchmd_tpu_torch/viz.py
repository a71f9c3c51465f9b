"""Frame visualization: a self-contained `viewFrame`, the port of
`torchmd_tpu.viz`.

The reference's debug helper (torchmd/run.py:20-25) pushes the current
frame into a moleculekit/VMD viewer and overlays force arrows. This
renders the same picture (atom scatter + force quiver, coloured by
element) with matplotlib into a PNG (or an interactive window). numpy and
matplotlib only; matplotlib is imported when a frame is drawn.
"""

from __future__ import annotations

import numpy as np

from .systems import to_numpy

__all__ = ["view_frame", "viewFrame"]

_ELEMENT_COLORS = {
    "H": "#d0d0d0", "C": "#303030", "N": "#2050c0", "O": "#c03030",
    "S": "#c0a020", "P": "#e08020", "CL": "#30a030", "NA": "#8040c0",
    "MG": "#208020", "K": "#a040a0", "CA": "#808080", "F": "#60c060",
    "ZN": "#707090", "FE": "#a05020",
}


def _colors(elements, natoms):
    if elements is None:
        return ["#4060a0"] * natoms
    out = []
    for e in elements:
        key = str(e).strip().upper()
        out.append(_ELEMENT_COLORS.get(key, _ELEMENT_COLORS.get(key[:1], "#4060a0")))
    return out


def view_frame(mol, pos, forces=None, out=None, force_scale=0.01, title=None):
    """Render one frame: atoms as a 3-D scatter (element-coloured), forces
    as a quiver scaled by `force_scale` (the reference's 0.01, run.py:25).

    mol: a Molecule (for elements and bonds), or None; pos: (natoms, 3) or
    (1, natoms, 3), an array or a tensor; forces: the same or None; out: a
    PNG path (None shows an interactive window). Returns the figure."""
    import matplotlib

    if out is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pos = to_numpy(pos).astype(np.float64)
    if pos.ndim == 3:
        pos = pos[0]
    natoms = pos.shape[0]
    elements = getattr(mol, "element", None) if mol is not None else None
    if elements is not None and len(elements) != natoms:
        elements = None

    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c=_colors(elements, natoms), s=18,
               depthshade=True)

    bonds = getattr(mol, "bonds", None) if mol is not None else None
    if bonds is not None and len(bonds):
        for s in pos[np.asarray(bonds, np.int64)]:   # (nbonds, 2, 3)
            ax.plot(s[:, 0], s[:, 1], s[:, 2], color="#909090", linewidth=0.6, alpha=0.6)

    if forces is not None:
        f = to_numpy(forces).astype(np.float64)
        if f.ndim == 3:
            f = f[0]
        ax.quiver(pos[:, 0], pos[:, 1], pos[:, 2], f[:, 0] * force_scale,
                  f[:, 1] * force_scale, f[:, 2] * force_scale, color="#c03030",
                  linewidth=0.8)

    ax.set_xlabel("x (A)")
    ax.set_ylabel("y (A)")
    ax.set_zlabel("z (A)")
    if title:
        ax.set_title(title)
    # equal aspect via symmetric limits
    c = pos.mean(axis=0)
    r = max(1.0, float(np.abs(pos - c).max()) * 1.1)
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    fig.tight_layout()
    if out is not None:
        fig.savefig(out, dpi=120)
        plt.close(fig)
    else:  # pragma: no cover - interactive
        plt.show()
    return fig


def viewFrame(mol, pos, forces):
    """Reference-compatible alias (torchmd/run.py:20-25): writes
    viewframe.png in the working directory."""
    return view_frame(mol, pos, forces, out="viewframe.png")
