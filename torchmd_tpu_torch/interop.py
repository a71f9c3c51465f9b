"""Hand the JAX package's structures to the port as numpy arrays.

`ffparams_from_numpy(d, device, dtype)` takes the JAX package's `FFParams`
with every leaf as a numpy array (for example
`jax.tree_util.tree_map(np.asarray, ffp)`), or a mapping with the same
field names, and returns the port's `FFParams` on `device`. Integer
leaves become int64, boolean leaves stay bool, float leaves take `dtype`.
The functions below do the same for the periodic slices' structures: the
exclusion table, the cell and column configurations, the cell list, PME,
SETTLE, virtual sites, the Nose-Hoover chain state and the MTK barostat's
extended state, so that a test can run both packages on identical inputs
or hand a run from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .potentials import FFParams, TermTable

_TABLES = ("bonds", "angles", "dihedrals", "impropers", "nb14",
           "urey_bradley", "bonds_g96", "angles_g96")


def _tensor(a, device, dtype):
    a = np.array(a)  # a writable copy: the leaves may be read-only views
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, dtype=torch.int64, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _field(d, name):
    if isinstance(d, dict):
        return d.get(name)
    return getattr(d, name, None)


def ffparams_from_numpy(d, device="cpu", dtype=torch.float64) -> FFParams:
    if _field(d, "cmap") is not None:
        raise NotImplementedError("CMAP tables are not ported yet")
    out = {}
    for name in FFParams._fields:
        v = _field(d, name)
        if v is None:
            out[name] = None
        elif name in _TABLES:
            out[name] = TermTable(*(_tensor(_field(v, f), device, dtype)
                                    for f in TermTable._fields))
        elif name == "lj_ab":
            out[name] = tuple(_tensor(t, device, dtype) for t in v)
        else:
            out[name] = _tensor(v, device, dtype)
    return FFParams(**out)


# ----------------------------------------------------------------------
# The structures of the periodic slice: each takes the JAX package's
# object with numpy (or any array-like) leaves.
# ----------------------------------------------------------------------

def exclusion_table_from_numpy(table) -> np.ndarray:
    """(natoms, E) padded exclusion lists as the port's int32 table."""
    return np.asarray(table, dtype=np.int32)


def cell_config_from_numpy(clcfg):
    """A `CellListConfig` from the JAX package's (whose 27-cell stencil,
    split=1, is the only one the port takes)."""
    from .neighbors import CellListConfig

    if int(getattr(clcfg, "split", 1)) != 1:
        raise NotImplementedError("the port's cell path takes the 27-cell stencil")
    return CellListConfig(
        box=tuple(float(b) for b in clcfg.box), cutoff=float(clcfg.cutoff),
        skin=float(clcfg.skin), ncells=tuple(int(c) for c in clcfg.ncells),
        capacity=int(clcfg.capacity))


def cell_list_from_numpy(cl, device="cpu", dtype=torch.float64):
    """A `CellList` (slots, counts, ref_pos, overflow) on `device`."""
    from .neighbors import CellList

    return CellList(
        slots=torch.as_tensor(np.array(cl.slots), dtype=torch.int32, device=device),
        counts=torch.as_tensor(np.array(cl.counts), dtype=torch.int32, device=device),
        ref_pos=_tensor(cl.ref_pos, device, dtype),
        overflow=torch.as_tensor(bool(np.asarray(cl.overflow)), device=device))


def pme_recip_from_numpy(charges, box, cutoff, kmesh, alpha, order,
                         excl_pairs=None, tol=1e-5, device="cpu",
                         dtype=torch.float64, gather=None):
    """The port's `PmeRecip` for the same charges, box, cutoff and
    exclusions as a JAX `PmeRecip`; raises unless it derives the same mesh
    shape, splitting parameter and spline order."""
    from .ewald import PmeRecip

    rec = PmeRecip(torch.as_tensor(np.asarray(charges), dtype=dtype, device=device),
                   box, cutoff, excl_pairs=excl_pairs, tol=tol, order=order,
                   gather=gather)
    if tuple(rec.cfg.kmax) != tuple(int(k) for k in kmesh) or not np.isclose(
            rec.cfg.alpha, float(alpha), rtol=1e-15):
        raise ValueError(f"PME parameters differ: {rec.cfg} vs {kmesh}, {alpha}")
    return rec


def settle_from_numpy(ss, device="cpu", dtype=torch.float64):
    """A `SettleSet` from one with the same fields."""
    from .constraints import SettleSet

    ints = ("oidx", "h1", "h2")
    return SettleSet(**{
        f: (torch.as_tensor(np.array(getattr(ss, f)), dtype=torch.int64, device=device)
            if f in ints else _tensor(getattr(ss, f), device, dtype))
        for f in SettleSet._fields})


def vsite_groups_from_numpy(groups, device="cpu", dtype=torch.float64):
    """VSiteGroups from groups with the same fields."""
    from .vsites import vsite_groups_to

    return vsite_groups_to(groups, device, dtype)


def nhc_state_from_numpy(aux, device="cpu", dtype=torch.float64):
    """The Nose-Hoover chain state {"xi", "vxi"} ((nreplicas, nchain) each)."""
    return {k: _tensor(aux[k], device, dtype) for k in ("xi", "vxi")}


def column_config_from_numpy(ccfg):
    """A `ColumnConfig` from the JAX package's (whose phase replicas, P > 1,
    the port does not take)."""
    from .columns import ColumnConfig

    if int(getattr(ccfg, "P", 1)) != 1:
        raise NotImplementedError("the port's column layout has no phase replicas (P = 1)")
    return ColumnConfig(
        box=tuple(float(b) for b in ccfg.box), cutoff=float(ccfg.cutoff),
        skin=float(ccfg.skin), ncols=tuple(int(c) for c in ccfg.ncols),
        C=int(ccfg.C), CE=int(ccfg.CE), W=int(ccfg.W), IBLK=int(ccfg.IBLK),
        nbins=int(ccfg.nbins), nexcl=int(ccfg.nexcl))


def mtk_state_from_numpy(v_eps, xi, vxi, virial=None, device="cpu",
                         dtype=torch.float64):
    """The MTK extended state for `Integrator.npt_state`: v_eps (R, 3), the
    barostat chain {"xi", "vxi"} ((R, nchain) each) and, optionally, the
    carried virial (R, 3), from the JAX package's `_npt_extra` as numpy
    arrays. A run handed over with its virial continues exactly; without
    it the port recomputes the virial at the entry state."""
    vir = None if virial is None else _tensor(np.reshape(virial, (-1, 3)), device, dtype)
    return (_tensor(np.reshape(v_eps, (-1, 3)), device, dtype),
            {"xi": _tensor(xi, device, dtype), "vxi": _tensor(vxi, device, dtype)}, vir)
