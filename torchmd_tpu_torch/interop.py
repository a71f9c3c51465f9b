"""Hand the JAX package's structures to the port as numpy arrays.

`ffparams_from_numpy(d, device, dtype)` takes the JAX package's `FFParams`
with every leaf as a numpy array (for example
`jax.tree_util.tree_map(np.asarray, ffp)`), or a mapping with the same
field names, and returns the port's `FFParams` on `device` (its CMAP
coefficient table too). Integer leaves become int64, boolean leaves stay
bool, float leaves take `dtype`.
The functions below do the same for the periodic slices' structures: the
exclusion table, the cell and column configurations, the cell list, PME,
SETTLE, virtual sites, the Nose-Hoover chain state and the MTK barostat's
extended state, for the sampling slice's: a GBSA term, an alchemical
coupling, a metadynamics bias grid and the lambda-dynamics state, for
the polarizable slice's: the multipole and polarization specs, and for
the Drude slice's: the Drude and lone-pair specs, an NNP's weights and a
Drude run's state, so
that a test can run both packages on identical inputs or hand a run from
one to the other.
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
    from .cmap import CMapTable

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
        elif name == "cmap":
            out[name] = CMapTable(*(_tensor(_field(v, f), device, dtype)
                                    for f in CMapTable._fields))
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


def spatial_state_from_numpy(aux, npt_extra=None, device="cpu", dtype=torch.float64):
    """A spatially sharded JAX run's thermostat and MTK state, handed to
    the port's spatial run mid-run: the JAX spatial scans strip the
    replica axis (torchmd_tpu/integrator.py:441-447, :2014), the port
    keeps one. `aux`: the JAX `_thermo_aux` ({} for none, or the chain's
    {"xi", "vxi"} of shape (nchain,)); `npt_extra`: its `_npt_extra`
    (v_eps (3,), the barostat chain {"xi", "vxi"}, virial) or None.
    Returns (thermo_aux for `Integrator._thermo_aux`, the MTK state for
    `Integrator.npt_state` or None); the spatial MTK scan recomputes the
    virial at each chunk's entry, so none is carried. The rows come
    through the System (the JAX run's synced pos, vel and forces)."""
    thermo = {k: _tensor(np.reshape(aux[k], (1, -1)), device, dtype) for k in aux}
    if npt_extra is None:
        return thermo, None
    v_eps, aux_b = npt_extra[0], npt_extra[1]
    return thermo, mtk_state_from_numpy(
        np.reshape(v_eps, (1, 3)), np.reshape(aux_b["xi"], (1, -1)),
        np.reshape(aux_b["vxi"], (1, -1)), device=device, dtype=dtype)


# ----------------------------------------------------------------------
# The sampling slice: implicit solvent, alchemy, metadynamics and
# lambda-dynamics
# ----------------------------------------------------------------------

def gbsa_from_numpy(g, device="cpu"):
    """The port's `GBSA` with the charges, radii, screening factors,
    dielectrics, surface term and cutoff of a JAX `GBSA` (numpy leaves)."""
    from .gb import GBSA

    return GBSA(np.asarray(g.charges), np.asarray(g.radii), np.asarray(g.screen),
                solvent_dielectric=g.eps_out, solute_dielectric=g.eps_in, sa=g.sa,
                cutoff=g.cutoff, device=device)


def coupling_from_numpy(c, ffparams, cfg):
    """The port's `AlchemicalCoupling` over the port's `ffparams` and
    `cfg` with the alchemical and environment index sets, lambda, alpha
    and soft-core power of a JAX `AlchemicalCoupling` (numpy leaves)."""
    from .alchemy import AlchemicalCoupling

    return AlchemicalCoupling(ffparams, cfg, np.asarray(c.alch_idx), lam=c.lam, alpha=c.alpha,
                              softcore_power=c.softcore_power,
                              env_atoms=np.asarray(c.env_idx))


def metadynamics_state_from_numpy(metad, bias, step_count=0, nhills=0):
    """Give the port's `MetaDynamics` a bias grid (nbins,), its global step
    count and hill count (the JAX object's `bias`, `_step_count` and
    `nhills`), so that its next `run` continues that run."""
    bias = np.array(bias, np.float64).reshape(-1)
    if bias.shape != (metad.nbins,):
        raise ValueError(f"bias grid of {bias.shape[0]} bins, want {metad.nbins}")
    metad.bias = torch.as_tensor(bias, dtype=metad.dtype, device=metad.device)
    metad._step_count = int(step_count)
    metad.nhills = int(nhills)
    return metad


def lambda_state_from_numpy(ld, theta, vtheta):
    """Give the port's `LambdaDynamics` the thetas and their velocities
    ((nsites,) each) of a JAX one."""
    ld.theta = _tensor(np.reshape(theta, (-1,)), ld.device, ld.dtype)
    ld.vtheta = _tensor(np.reshape(vtheta, (-1,)), ld.device, ld.dtype)
    return ld


# ----------------------------------------------------------------------
# The polarizable slice: AMOEBA multipoles and polarization
# ----------------------------------------------------------------------

def multipole_spec_from_numpy(spec, device="cpu"):
    """The port's `MultipoleSpec` from a JAX `multipoles.MultipoleSpec`
    (numpy leaves): the same sites, local moments, frames, mask, cutoff
    and switch."""
    from .multipoles import MultipoleSpec

    def t(a):
        return _tensor(a, device, torch.float64)

    return MultipoleSpec(
        sites=t(spec.sites), mu_local=t(spec.mu_local), frame_kind=t(spec.frame_kind),
        z_atom=t(spec.z_atom), x_atom=t(spec.x_atom),
        nb_mask=_tensor(np.asarray(spec.nb_mask, bool), device, torch.float64),
        cutoff=None if spec.cutoff is None else float(spec.cutoff),
        quad_local=None if spec.quad_local is None else t(spec.quad_local),
        switch_dist=None if spec.switch_dist is None else float(spec.switch_dist))


def polarization_spec_from_numpy(pspec, device="cpu"):
    """The port's `amoeba.PolarizationSpec` from a JAX one (numpy leaves)."""
    from .amoeba import PolarizationSpec

    def t(a):
        return _tensor(a, device, torch.float64)

    return PolarizationSpec(
        sites=t(pspec.sites), alpha=t(pspec.alpha), thole=t(pspec.thole),
        perm_mask=_tensor(np.asarray(pspec.perm_mask, bool), device, torch.float64),
        cutoff=None if pspec.cutoff is None else float(pspec.cutoff),
        cg_iters=int(pspec.cg_iters), cg_tol=float(pspec.cg_tol))


# ----------------------------------------------------------------------
# The Drude slice: Drude oscillators, CHARMM lone pairs, the NNP
# ----------------------------------------------------------------------

def drude_spec_from_numpy(spec, device="cpu", dtype=torch.float64):
    """The port's `drude.DrudeSpec` from a JAX one (numpy leaves)."""
    from .drude import DrudeSpec

    def t(name):
        v = getattr(spec, name)
        return None if v is None else _tensor(v, device, dtype)

    return DrudeSpec(**{f: (float(spec.m_drude) if f == "m_drude" else
                            float(spec.k_drude) if f == "k_drude" else t(f))
                        for f in DrudeSpec._fields})


def lonepair_spec_from_numpy(spec, device="cpu", dtype=torch.float64):
    """The port's `drude.LonePairSpec` from a JAX one (numpy leaves)."""
    from .drude import LonePairSpec

    return LonePairSpec(*(_tensor(getattr(spec, f), device, dtype)
                          for f in LonePairSpec._fields))


def nnp_params_from_numpy(params, cfg, device="cpu", dtype=torch.float64):
    """The port's `nnp.NNP` carrying a JAX NNP's params dict (numpy
    leaves, the same names and (nin, nout) layouts)."""
    from .nnp import NNP

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return _tensor(v, device, dtype)

    return NNP(cfg, conv(dict(params)))


def drude_state_from_numpy(integ, pos, vel, forces=None):
    """Give the port's `drude.DrudeIntegrator` the positions, velocities
    and, optionally, the forces carried out of a JAX DrudeIntegrator's last
    step (`pos`, `vel`, `_last_frc`), so that its next `step` continues
    that run; without forces the port evaluates them at the entry state."""
    def t(a):
        return _tensor(np.reshape(a, (-1, 3)), integ.device, integ.dtype)

    integ.pos, integ.vel = t(pos), t(vel)
    integ._last_frc = None if forces is None else t(forces)
    integ._last_pos = integ.pos
    return integ
