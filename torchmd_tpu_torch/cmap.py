"""CMAP cross-terms: CHARMM36 coupled dihedral (phi, psi) correction maps.

Counterpart of `torchmd_tpu.cmap`. The tabulated grid (typically 24 x 24,
15 degree spacing, kcal/mol) is interpolated with a periodic bicubic
spline, a C1 energy surface E(phi, psi) whose forces come from
`torch.autograd` through the two dihedral angles.

  - Host (numpy, once per force field): nodal derivatives from periodic
    cubic splines and the 16 bicubic coefficients of every grid cell, a
    (ntypes, n, n, 4, 4) table.
  - Device: per cross-term two dihedral angles, one integer cell locate,
    one (4, 4) coefficient gather and a degree-3 polynomial.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class CMapTable(NamedTuple):
    """Cross-term instances and their bicubic coefficient tables."""

    idx: torch.Tensor     # (nc, 8) int64: the atoms of the two dihedrals
    type: torch.Tensor    # (nc,) int64: map index per cross-term
    coeffs: torch.Tensor  # (ntypes, n, n, 4, 4) bicubic coefficients


# ----------------------------------------------------------------------
# Host-side spline setup (numpy, float64)
# ----------------------------------------------------------------------

def periodic_spline_derivatives(y: np.ndarray, axis: int = -1) -> np.ndarray:
    """First derivatives (in grid-cell units) of the periodic cubic spline
    through uniformly spaced samples along `axis`: the cyclic tridiagonal
    system d[i-1] + 4 d[i] + d[i+1] = 3 (y[i+1] - y[i-1])."""
    y = np.moveaxis(np.asarray(y, dtype=np.float64), axis, -1)
    n = y.shape[-1]
    m = np.zeros((n, n))
    i = np.arange(n)
    m[i, i] = 4.0
    m[i, (i + 1) % n] = 1.0
    m[i, (i - 1) % n] = 1.0
    rhs = 3.0 * (np.roll(y, -1, axis=-1) - np.roll(y, 1, axis=-1))
    d = np.linalg.solve(m, rhs[..., None])[..., 0]
    return np.moveaxis(d, -1, axis)


# The bicubic interpolation matrix: A = M F M^T with
# F = [[f00, f01, fu00, fu01], [f10, f11, fu10, fu11],
#      [ft00, ft01, ftu00, ftu01], [ft10, ft11, ftu10, ftu11]]
_M = np.array([[1.0, 0.0, 0.0, 0.0],
               [0.0, 0.0, 1.0, 0.0],
               [-3.0, 3.0, -2.0, -1.0],
               [2.0, -2.0, 1.0, 1.0]])


def bicubic_coefficients(grid: np.ndarray) -> np.ndarray:
    """Periodic bicubic spline coefficients of one (n, n) CMAP grid,
    grid[i, j] = E(phi_i, psi_j) at phi_i = -pi + i 2pi/n (psi alike):
    (n, n, 4, 4) coefficients a with, in cell (i, j),
    E(t, u) = sum_pq a[i, j, p, q] t^p u^q, t and u the cell fractions."""
    f = np.asarray(grid, dtype=np.float64)
    n = f.shape[0]
    if f.shape != (n, n):
        raise ValueError(f"CMAP grid must be square, got {f.shape}")
    ft = periodic_spline_derivatives(f, axis=0)    # dE/dt (cell units)
    fu = periodic_spline_derivatives(f, axis=1)    # dE/du
    ftu = periodic_spline_derivatives(ft, axis=1)  # d2E/dtdu

    def corners(a):
        # (n, n, 2, 2): the value at each cell's four corners (periodic)
        a01 = np.roll(a, -1, axis=1)
        a10 = np.roll(a, -1, axis=0)
        a11 = np.roll(a10, -1, axis=1)
        return np.stack([np.stack([a, a01], axis=-1), np.stack([a10, a11], axis=-1)],
                        axis=-2)

    F = np.zeros((n, n, 4, 4))
    F[..., 0:2, 0:2] = corners(f)
    F[..., 0:2, 2:4] = corners(fu)
    F[..., 2:4, 0:2] = corners(ft)
    F[..., 2:4, 2:4] = corners(ftu)
    return np.einsum("pi,xyij,qj->xypq", _M, F, _M)


def build_cmap_coeff_table(grids) -> np.ndarray:
    """(ntypes, n, n, 4, 4) coefficients of per-type grids that share one
    resolution (CHARMM36 uses 24)."""
    grids = [np.asarray(g, dtype=np.float64) for g in grids]
    n = grids[0].shape[0]
    if any(g.shape != (n, n) for g in grids):
        raise ValueError("All CMAP grids must share one resolution")
    return np.stack([bicubic_coefficients(g) for g in grids])


def make_cmap_table(cmap_params, dtype=torch.float64, device="cpu"):
    """The `CMapTable` of a `Parameters.cmap_params` assembly (idx, map,
    tables) on `device`."""
    return CMapTable(
        idx=torch.as_tensor(np.asarray(cmap_params["idx"]), dtype=torch.int64,
                            device=device),
        type=torch.as_tensor(np.asarray(cmap_params["map"])[:, 1], dtype=torch.int64,
                             device=device),
        coeffs=torch.as_tensor(build_cmap_coeff_table(cmap_params["tables"]),
                               dtype=dtype, device=device))


# ----------------------------------------------------------------------
# Device-side evaluation
# ----------------------------------------------------------------------

def cmap_energy_rows(table: CMapTable, pos, box) -> torch.Tensor:
    """Per-cross-term CMAP correction energies, (nc,). Differentiable in
    `pos`: the cell locate is an integer, the in-cell polynomial smooth."""
    from .potentials import _dihedral_phi

    n = table.coeffs.shape[1]
    h = 2.0 * math.pi / n
    phi = _dihedral_phi(pos, table.idx[:, 0:4], box)
    psi = _dihedral_phi(pos, table.idx[:, 4:8], box)

    def locate(ang):
        x = (ang + math.pi) / h
        cell = torch.floor(x)
        return torch.remainder(cell.to(torch.int64), n), x - cell

    ci, t = locate(phi)
    cj, u = locate(psi)
    a = table.coeffs[table.type, ci, cj]          # (nc, 4, 4)
    one = torch.ones_like(t)
    tp = torch.stack([one, t, t * t, t * t * t], dim=-1)
    up = torch.stack([one, u, u * u, u * u * u], dim=-1)
    return torch.einsum("cp,cpq,cq->c", tp, a, up)


def cmap_energy(table: CMapTable, pos, box) -> torch.Tensor:
    """Total CMAP correction energy (kcal/mol) of one conformation."""
    return cmap_energy_rows(table, pos, box).sum()
