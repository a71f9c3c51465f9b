"""Bonded terms on the halo-exchange path (`parallel.halo.HaloMD`).

Counterpart of `torchmd_tpu.parallel.halo_bonded`. Bonded terms are
spatially local (a dihedral spans ~5 A, far inside the ghost band of
cutoff + skin), so they need no communication beyond the position halo:
every rank holds the whole (small, static) topology and evaluates it
against the atoms it sees -- its owned rows plus the ghost bands --
scattered into a global-id position array whose unseen rows keep
`default_positions`.

  - forces: the bonded kernel (#3, `ops.bonded`) runs over that array
    and the rank keeps the rows of the atoms it owns. A term touching an
    owned atom is wholly visible (the band is wider than the largest
    bonded extent, guarded at HaloMD init), so owned rows get complete
    forces; terms with an unseen atom put whatever they compute on rows
    the rank drops. This equals the JAX package's gradient of the
    'prod'-weighted energy (the all-visible gate) on the owned rows. The
    terms no kernel computes (CMAP, the GROMOS-96 bond and angle forms)
    take that gradient by autograd, as they ride on the bonded stage of
    every path of the port.
  - energy: each term instance weighted by the fraction of its atoms
    the rank owns ('mean'); summed over the ranks the weights add to 1
    per term. The per-row physics is the bonded kernel's plain version
    (`ops.bonded._family_rows`) and the port's CMAP and GROMOS-96 rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..cmap import cmap_energy_rows
from ..ops import bonded as _ops_bonded
from ..potentials import TermTable, g96_angle_rows, g96_bond_rows

__all__ = ["HaloBondedPlan", "build_halo_bonded_plan", "max_bonded_extent",
           "default_positions", "weighted_bonded_energy", "bonded_forces"]


class HaloBondedPlan(NamedTuple):
    """The replicated bonded tables of the halo path: the bonded kernel's
    row plan (its families: bonds, Urey-Bradley, angles, dihedrals,
    impropers, 1-4) and the tables that ride by autograd."""

    kernel: Optional[_ops_bonded.BondedKernelPlan]
    bonds_g96: Optional[TermTable] = None
    angles_g96: Optional[TermTable] = None
    cmap: Optional[object] = None        # cmap.CMapTable


def build_halo_bonded_plan(ffp, cfg) -> Optional[HaloBondedPlan]:
    """The active bonded families of `ffp` under `cfg`; None when no
    bonded term is on."""
    t = cfg.terms

    def live(table):
        return table if table is not None and table.idx.shape[0] else None

    plan = HaloBondedPlan(
        kernel=_ops_bonded.build_bonded_kernel_plan(ffp, cfg),
        bonds_g96=live(ffp.bonds_g96) if "bonds" in t else None,
        angles_g96=live(ffp.angles_g96) if "angles" in t else None,
        cmap=live(ffp.cmap) if "cmap" in t else None)
    if all(v is None for v in plan):
        return None
    return plan


def _term_indices(plan: HaloBondedPlan):
    """(instances, arity) int64 atom tables of every term of the plan."""
    out = []
    k = plan.kernel
    if k is not None:
        for fam in k.families:
            rows = slice(fam.row0, fam.row0 + fam.count)
            out.append(k.idx[rows, :_ops_bonded.ARITY[fam.kind]].long())
    for table in (plan.bonds_g96, plan.angles_g96, plan.cmap):
        if table is not None:
            out.append(table.idx.long())
    return out


def max_bonded_extent(plan: HaloBondedPlan, pos, box) -> float:
    """Largest min-image distance between two atoms of any bonded term
    at the given geometry (host-side; the HaloMD init guard)."""
    p = np.asarray(torch.as_tensor(pos).detach().cpu(), np.float64).reshape(-1, 3)
    b = np.asarray(box, np.float64).reshape(3)
    dmax = 0.0
    for idx in _term_indices(plan):
        idx = idx.cpu().numpy()
        for a in range(idx.shape[1]):
            for c in range(a + 1, idx.shape[1]):
                d = p[idx[:, a]] - p[idx[:, c]]
                d -= b * np.round(d / b)
                if len(d):
                    dmax = max(dmax, float(np.sqrt(np.max(np.sum(d * d, axis=1)))))
    return dmax


def default_positions(natoms: int, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """(natoms + 1, 3) base of the global-id position scatter. Unseen atoms
    keep these; the terms they enter are dropped, but their geometry must
    not be degenerate (coincident points give NaN through the torsions'
    atan2): an R3-sequence spread gives distinct, generically
    non-collinear points (the JAX package's `default_positions`)."""
    ids = torch.arange(natoms + 1, dtype=torch.float64, device=device)[:, None] + 1.0
    alpha = torch.tensor([0.7548776662, 0.5698402910, 0.3028448153], dtype=torch.float64,
                         device=device)
    return ((ids * alpha) % 1.0 * 5.0).to(dtype)


def _weight(wg, idx, mode):
    """Per-instance weight of the atoms `idx` (instances, arity): 'mean'
    (ownership fraction, the energy) or 'prod' (all-visible gate)."""
    w = wg[idx]
    return w.mean(1) if mode == "mean" else w.prod(1)


def _weighted(e_rows, w):
    """sum e_rows * w, rows of weight 0 contributing exactly 0 (their
    atoms may sit at the defaults, where a row can overflow)."""
    return torch.where(w > 0, e_rows * w, torch.zeros_like(e_rows)).sum()


def _autograd_energy(plan: HaloBondedPlan, pg, wg, box, mode):
    """The weighted energy of the tables that ride by autograd."""
    e = pg.new_zeros(())
    for table, rows_fn in ((plan.bonds_g96, g96_bond_rows),
                           (plan.angles_g96, g96_angle_rows)):
        if table is not None:
            w = _weight(wg, table.idx, mode)[table.map_term]
            e = e + _weighted(rows_fn(table, pg, box), w)
    if plan.cmap is not None:
        e = e + _weighted(cmap_energy_rows(plan.cmap, pg, box),
                          _weight(wg, plan.cmap.idx, mode))
    return e


def weighted_bonded_energy(plan: HaloBondedPlan, pg, wg, box, mode: str):
    """Sum over every bonded row of e_row * weight(instance), the weight
    the 'mean' or 'prod' of `wg` over the instance's atoms. `pg` is the
    (natoms + 1, 3) global-id position scatter (row natoms: padding),
    `wg` (natoms + 1,)."""
    e = _autograd_energy(plan, pg, wg, box, mode)
    k = plan.kernel
    if k is None:
        return e
    for fam in k.families:
        rows = slice(fam.row0, fam.row0 + fam.count)
        idx = k.idx[rows, :_ops_bonded.ARITY[fam.kind]].long()
        e_main, e_aux, _ = _ops_bonded._family_rows(fam, pg, idx, k.par[rows].to(pg.dtype),
                                                    box)
        e = e + _weighted(e_main + e_aux, _weight(wg, idx, mode))
    return e


def bonded_forces(plan: HaloBondedPlan, pg, vis, box):
    """(natoms, 3) bonded forces at the global-id scatter `pg` (natoms + 1
    rows; `vis` (natoms + 1,) 1 where the rank sees the atom): the bonded
    kernel's wrapper over every term (the kernel on the card, its plain
    version on the CPU), plus the autograd tables' gradient of the
    'prod'-weighted energy. Rows of atoms in a term with an unseen atom
    are not complete (the caller keeps its owned rows only)."""
    n = pg.shape[0] - 1
    pos = pg[:n]
    k = plan.kernel
    if k is not None:
        _, frc = _ops_bonded.bonded_energy_forces(k, pos, box)
    else:
        frc = torch.zeros_like(pos)
    if any(t is not None for t in plan[1:]):
        with torch.enable_grad():
            p = pg.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(_autograd_energy(plan, p, vis, box, "prod"), p)
        frc = frc - g[:n]
    return frc
