"""Force-field potentials as plain PyTorch functions on tensors.

Counterpart of `torchmd_tpu.potentials`: the same data types (`TermTable`,
`FFParams`, `ForceTermConfig`), the same term energies and the same fused
analytic nonbonded path, written with torch ops. Every function takes its
tensors on one device and keeps their dtype; nothing here reads torch's
default dtype.

Physics (reference torchmd/forces.py, as in the JAX package):
  - bonds:      E = k0 (r - r0)^2, dropped beyond the cutoff
  - angles:     E = k0 (theta - theta0)^2
  - torsions:   AMBER  E = k (1 + cos(per*phi - phi0)) when all per > 0,
                CHARMM E = k (dphi wrapped to +-pi)^2 otherwise
  - 1-4:        scaled LJ (A/B/scnb) + scaled Coulomb (scee)
  - lj:         A r^-12 - B r^-6 with the polynomial switch
  - electrostatics: Coulomb, reaction field (krf/crf) or Ewald erfc
  - repulsion / repulsioncg: A r^-12 / B r^-6 only

`compute_potentials` gives per-term energies; forces come from
`torch.autograd.grad` (`energy_and_forces`). `energy_and_forces_fused` is
the analytic path: dense nonbonded row sums plus autograd bonded.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .units import ELEC_FACTOR

BONDED_TERMS = ("bonds", "angles", "dihedrals", "impropers", "1-4",
                "urey-bradley", "cmap")
NONBONDED_TERMS = ("electrostatics", "lj", "repulsion", "repulsioncg")
TERMS = BONDED_TERMS + NONBONDED_TERMS
LJ_FAMILY = ("lj", "repulsion", "repulsioncg")


class TermTable(NamedTuple):
    """One bonded term family: instance atom indices, the instance->param-row
    indirection (one-to-many for multi-term torsions), and unique param rows."""

    idx: torch.Tensor        # (ninstances, arity) int64
    map_term: torch.Tensor   # (nassign,) int64 -- term instance per assignment
    map_param: torch.Tensor  # (nassign,) int64 -- param row per assignment
    params: torch.Tensor     # (nrows, k) float


class FFParams(NamedTuple):
    """Force-field parameters of one topology, as tensors on one device."""

    charges: torch.Tensor            # (natoms,)
    masses: torch.Tensor             # (natoms, 1)
    mapped_atom_types: torch.Tensor  # (natoms,) int64
    lj_params: Optional[torch.Tensor]      # (ntypes, 2) sigma/epsilon
    bonds: Optional[TermTable]
    angles: Optional[TermTable]
    dihedrals: Optional[TermTable]
    impropers: Optional[TermTable]
    nb14: Optional[TermTable]        # idx (q, 2); params rows [A, B, scnb, scee]
    nb_mask: Optional[torch.Tensor]  # (natoms, natoms) bool: nonbonded pairs
    urey_bradley: Optional[TermTable] = None
    lj_ab: Optional[tuple] = None    # (A_table, B_table), (ntypes, ntypes)
    bonds_g96: Optional[TermTable] = None
    angles_g96: Optional[TermTable] = None
    cmap: Optional["CMapTable"] = None  # torchmd_tpu_torch.cmap.CMapTable


class ForceTermConfig(NamedTuple):
    """Static evaluation configuration (same fields as the JAX package)."""

    terms: tuple
    cutoff: Optional[float] = None
    rfa: bool = False
    solvent_dielectric: float = 78.5
    switch_dist: Optional[float] = None
    dihedrals_amber: bool = True
    impropers_amber: bool = True
    ewald_alpha: Optional[float] = None


def rfa_constants(cfg: ForceTermConfig):
    """Reaction-field (krf, crf) of the OpenMM form (Tironi et al. 1995)."""
    denom = 2.0 * cfg.solvent_dielectric + 1.0
    krf = (1.0 / cfg.cutoff**3) * (cfg.solvent_dielectric - 1.0) / denom
    crf = (1.0 / cfg.cutoff) * (3.0 * cfg.solvent_dielectric) / denom
    return krf, crf


# ----------------------------------------------------------------------
# Geometry helpers
# ----------------------------------------------------------------------

def wrap_displacement(dv: torch.Tensor, box: Optional[torch.Tensor]):
    """Minimum-image wrap for a rectangular box; a component <= 0 disables
    wrapping along that axis (box == 0 means no PBC)."""
    if box is None:
        return dv
    safe = torch.where(box > 0, box, torch.ones_like(box))
    return dv - torch.where(box > 0, safe * torch.round(dv / safe),
                            torch.zeros_like(dv))


def _gather_disp(pos, idx_a, idx_b, box):
    return wrap_displacement(pos[idx_a] - pos[idx_b], box)


def _safe_norm(v):
    return torch.sqrt(torch.clamp((v * v).sum(-1), min=1e-32))


def _zero(pos):
    return torch.zeros((), dtype=pos.dtype, device=pos.device)


# ----------------------------------------------------------------------
# Bonded terms
# ----------------------------------------------------------------------

def bond_energy(table: TermTable, pos, box, cutoff=None):
    p = table.params[table.map_param]
    r = _safe_norm(_gather_disp(pos, table.idx[:, 0], table.idx[:, 1], box))
    rr = r[table.map_term]
    x = rr - p[:, 1]
    e = p[:, 0] * x * x
    if cutoff is not None:
        # the reference drops bonds beyond the cutoff (forces.py:128-136)
        e = torch.where(rr <= cutoff, e, torch.zeros_like(e))
    return e.sum()


def g96_bond_energy(table: TermTable, pos, box):
    """GROMOS-96 quartic bond: E = kq (r^2 - b0^2)^2, rows [kq, b0]."""
    p = table.params[table.map_param]
    dv = _gather_disp(pos, table.idx[:, 0], table.idx[:, 1], box)
    x = (dv * dv).sum(1)[table.map_term] - p[:, 1] * p[:, 1]
    return (p[:, 0] * x * x).sum()


def _cos_angle(table, pos, box):
    r21 = _gather_disp(pos, table.idx[:, 0], table.idx[:, 1], box)
    r23 = _gather_disp(pos, table.idx[:, 2], table.idx[:, 1], box)
    dot = (r21 * r23).sum(1)
    return torch.clamp(dot / (_safe_norm(r21) * _safe_norm(r23)), -1.0, 1.0)


def g96_angle_energy(table: TermTable, pos, box):
    """GROMOS-96 cosine angle: E = kc (cos th - cos th0)^2, rows [kc, cos0]."""
    p = table.params[table.map_param]
    x = _cos_angle(table, pos, box)[table.map_term] - p[:, 1]
    return (p[:, 0] * x * x).sum()


def angle_energy(table: TermTable, pos, box):
    p = table.params[table.map_param]
    cos_theta = _cos_angle(table, pos, box)
    # atan2 form: the value of acos, with a bounded gradient at |cos| = 1
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=1e-24))
    theta = torch.atan2(sin_theta, cos_theta)
    dtheta = theta[table.map_term] - p[:, 1]
    return (p[:, 0] * dtheta * dtheta).sum()


def _dihedral_phi(pos, idx, box):
    r12 = _gather_disp(pos, idx[:, 0], idx[:, 1], box)
    r23 = _gather_disp(pos, idx[:, 1], idx[:, 2], box)
    r34 = _gather_disp(pos, idx[:, 2], idx[:, 3], box)
    crossA = torch.linalg.cross(r12, r23, dim=-1)
    crossB = torch.linalg.cross(r23, r34, dim=-1)
    crossC = torch.linalg.cross(r23, crossA, dim=-1)
    ncB = crossB / _safe_norm(crossB)[:, None]
    cos_phi = (crossA * ncB).sum(1) / _safe_norm(crossA)
    sin_phi = (crossC * ncB).sum(1) / _safe_norm(crossC)
    return -torch.atan2(sin_phi, cos_phi)


def torsion_energy(table: TermTable, pos, box, amber: bool):
    """Torsion energy with multi-term indirection. `amber` selects
    k(1 + cos(per*phi - phi0)); otherwise the CHARMM harmonic form
    k * wrap(phi - phi0)^2 is used for all rows (forces.py:566-579)."""
    phis = _dihedral_phi(pos, table.idx, box)[table.map_term]
    p = table.params[table.map_param]
    k0, phi0, per = p[:, 0], p[:, 1], p[:, 2]
    if amber:
        e = k0 * (1.0 + torch.cos(per * phis - phi0))
    else:
        diff = phis - phi0
        diff = diff - 2.0 * math.pi * torch.round(diff / (2.0 * math.pi))
        e = k0 * diff * diff
    return e.sum()


def nb14_energies(table: TermTable, pos, box, charges, want_lj, want_elec):
    """Scaled 1-4 LJ and electrostatics (no cutoff, switch or RFA)."""
    r = _safe_norm(_gather_disp(pos, table.idx[:, 0], table.idx[:, 1], box))
    p = table.params[table.map_param]
    rinv = 1.0 / r
    e_lj = e_elec = _zero(pos)
    if want_lj:
        rinv6 = rinv**6
        e_lj = ((p[:, 0] * rinv6 * rinv6 - p[:, 1] * rinv6) / p[:, 2]).sum()
    if want_elec:
        q = charges[table.idx[:, 0]] * charges[table.idx[:, 1]]
        e_elec = (ELEC_FACTOR * q * rinv / p[:, 3]).sum()
    return e_lj, e_elec


# ----------------------------------------------------------------------
# Nonbonded: dense masked pair matrix
# ----------------------------------------------------------------------

def _lorentz_berthelot(par: FFParams, rows=slice(None)):
    """Per-pair (A, B) blocks for `rows` x all atoms, from NBFIX tables
    when present, else Lorentz-Berthelot mixing (parameters.py:449-457)."""
    ti = par.mapped_atom_types
    if par.lj_ab is not None:
        return (par.lj_ab[0][ti[rows, None], ti[None, :]],
                par.lj_ab[1][ti[rows, None], ti[None, :]])
    s_at = par.lj_params[:, 0][ti]
    e_at = par.lj_params[:, 1][ti]
    sig_ij = 0.5 * (s_at[rows, None] + s_at[None, :])
    eps_ij = torch.sqrt(torch.abs(e_at[rows, None] * e_at[None, :]))
    s6 = sig_ij**6
    B = 4.0 * eps_ij * s6
    return B * s6, B


def nonbonded_energies(par: FFParams, pos, box, cfg: ForceTermConfig):
    """All-pairs nonbonded terms on the dense masked matrix; each pair is
    counted once (0.5 * symmetric sum). Differentiable by autograd."""
    mask = par.nb_mask
    dv = wrap_displacement(pos[:, None, :] - pos[None, :, :], box)
    d2 = torch.where(mask, (dv * dv).sum(-1), torch.ones_like(dv[..., 0]))
    dist = torch.sqrt(d2)
    rinv = 1.0 / dist
    if cfg.cutoff is not None:
        mask = mask & (dist <= cfg.cutoff)
    fmask = mask.to(pos.dtype)

    out = {}
    if any(t in cfg.terms for t in LJ_FAMILY):
        A_ij, B_ij = _lorentz_berthelot(par)
    if "lj" in cfg.terms:
        rinv6 = rinv**6
        pot = A_ij * rinv6 * rinv6 - B_ij * rinv6
        if cfg.switch_dist is not None and cfg.cutoff is not None:
            t = (dist - cfg.switch_dist) / (cfg.cutoff - cfg.switch_dist)
            sw = 1.0 + t * t * t * (-10.0 + t * (15.0 - t * 6.0))
            pot = torch.where(dist > cfg.switch_dist, pot * sw, pot)
        out["lj"] = 0.5 * (pot * fmask).sum()
    if "repulsion" in cfg.terms:
        rinv6 = rinv**6
        out["repulsion"] = 0.5 * (A_ij * rinv6 * rinv6 * fmask).sum()
    if "repulsioncg" in cfg.terms:
        out["repulsioncg"] = 0.5 * (B_ij * rinv**6 * fmask).sum()
    if "electrostatics" in cfg.terms:
        qq = ELEC_FACTOR * par.charges[:, None] * par.charges[None, :]
        if cfg.ewald_alpha is not None:
            pot = qq * torch.special.erfc(cfg.ewald_alpha * dist) * rinv
        elif cfg.rfa and cfg.cutoff is not None:
            krf, crf = rfa_constants(cfg)
            pot = qq * (rinv + krf * dist * dist - crf)
        else:
            pot = qq * rinv
        out["electrostatics"] = 0.5 * (pot * fmask).sum()
    return out


# ----------------------------------------------------------------------
# Total energy
# ----------------------------------------------------------------------

def add_energy(pot: dict, key, value) -> None:
    """pot[key] += value, creating the key on first use."""
    pot[key] = pot[key] + value if key in pot else value


def compute_potentials(par: FFParams, pos, box, cfg: ForceTermConfig,
                       nonbonded=True) -> dict:
    """Per-term potential energies (0-dim tensors) of one conformation.
    pos: (natoms, 3); box: (3,) diagonal or None (no PBC)."""
    pot = {}
    if "bonds" in cfg.terms and par.bonds is not None:
        pot["bonds"] = bond_energy(par.bonds, pos, box, cfg.cutoff)
    if "bonds" in cfg.terms and par.bonds_g96 is not None:
        add_energy(pot, "bonds", g96_bond_energy(par.bonds_g96, pos, box))
    if "angles" in cfg.terms and par.angles is not None:
        pot["angles"] = angle_energy(par.angles, pos, box)
    if "angles" in cfg.terms and par.angles_g96 is not None:
        add_energy(pot, "angles", g96_angle_energy(par.angles_g96, pos, box))
    if "urey-bradley" in cfg.terms and par.urey_bradley is not None:
        pot["urey-bradley"] = bond_energy(par.urey_bradley, pos, box)
    if "dihedrals" in cfg.terms and par.dihedrals is not None:
        pot["dihedrals"] = torsion_energy(par.dihedrals, pos, box,
                                          cfg.dihedrals_amber)
    if "impropers" in cfg.terms and par.impropers is not None:
        pot["impropers"] = torsion_energy(par.impropers, pos, box,
                                          cfg.impropers_amber)
    if "cmap" in cfg.terms and par.cmap is not None:
        from .cmap import cmap_energy

        pot["cmap"] = cmap_energy(par.cmap, pos, box)
    if "1-4" in cfg.terms and par.nb14 is not None:
        e_lj, e_elec = nb14_energies(
            par.nb14, pos, box, par.charges,
            want_lj="lj" in cfg.terms,
            want_elec="electrostatics" in cfg.terms,
        )
        if "lj" in cfg.terms:
            add_energy(pot, "lj", e_lj)
        if "electrostatics" in cfg.terms:
            add_energy(pot, "electrostatics", e_elec)
    if (nonbonded and any(t in cfg.terms for t in NONBONDED_TERMS)
            and par.nb_mask is not None):
        for k, v in nonbonded_energies(par, pos, box, cfg).items():
            add_energy(pot, k, v)
    return pot


def energy_and_forces(par: FFParams, pos, box, cfg: ForceTermConfig):
    """(per-term potentials, forces = -dE/dpos by autograd)."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        pot = compute_potentials(par, p, box, cfg)
        if not pot:
            return {}, torch.zeros_like(pos)
        (grad,) = torch.autograd.grad(sum(pot.values()), p)
    return {k: v.detach() for k, v in pot.items()}, -grad


# ----------------------------------------------------------------------
# Fused analytic nonbonded energy + forces
# ----------------------------------------------------------------------

def nonbonded_block_energy_forces(cfg: ForceTermConfig, dv, mask, qq,
                                  A_ij, B_ij, with_virial=False):
    """Pair-block nonbonded math: ({term: 0.5 * sum energy}, row forces).

    dv: (rows, cols, 3) minimum-image displacements; mask: (rows, cols)
    valid pairs (self, exclusions and padding removed); qq, A_ij, B_ij:
    per-pair coefficient blocks (None when no active term needs them).
    F_i = -sum_j g_ij dv_ij with g = (dE/dr)/r.

    With `with_virial=True` also returns the block's per-axis pair virial
    -0.5 sum g dv_a^2 (the 0.5 of the energies: each pair is visited from
    both sides), the scaling derivative -dE/ds_a of E(s pos, s box)."""
    out, g = pair_block_terms(cfg, dv, mask, qq, A_ij, B_ij)
    forces = -torch.einsum("ij,ijk->ik", g, dv)
    if with_virial:
        return out, forces, -0.5 * torch.einsum("ij,ijk->k", g, dv * dv)
    return out, forces


def pair_block_terms(cfg: ForceTermConfig, dv, mask, qq, A_ij, B_ij):
    """({term: 0.5 * sum energy}, g) of a pair block, g = (dE/dr)/r per
    pair (0 outside the mask and the cutoff); the arguments are those of
    `nonbonded_block_energy_forces`."""
    d2 = torch.where(mask, (dv * dv).sum(-1), torch.ones_like(dv[..., 0]))
    rinv2 = 1.0 / d2
    if "electrostatics" in cfg.terms or (
            cfg.switch_dist is not None and "lj" in cfg.terms):
        dist = torch.sqrt(d2)
        rinv = 1.0 / dist
    if cfg.cutoff is not None:
        mask = mask & (d2 <= cfg.cutoff * cfg.cutoff)
    fmask = mask.to(dv.dtype)

    out = {}
    g = torch.zeros_like(d2)
    if A_ij is not None:
        rinv6 = rinv2 * rinv2 * rinv2
        rinv12 = rinv6 * rinv6
    if "lj" in cfg.terms:
        pot = A_ij * rinv12 - B_ij * rinv6
        dEdr_r = (-12.0 * A_ij * rinv12 + 6.0 * B_ij * rinv6) * rinv2
        if cfg.switch_dist is not None and cfg.cutoff is not None:
            width = cfg.cutoff - cfg.switch_dist
            t = (dist - cfg.switch_dist) / width
            sw = 1.0 + t * t * t * (-10.0 + t * (15.0 - t * 6.0))
            dsw = t * t * (-30.0 + t * (60.0 - t * 30.0)) / width
            in_sw = dist > cfg.switch_dist
            dEdr_r = torch.where(in_sw, dEdr_r * sw + pot * dsw * rinv, dEdr_r)
            pot = torch.where(in_sw, pot * sw, pot)
        out["lj"] = 0.5 * (pot * fmask).sum()
        g = g + dEdr_r * fmask
    if "repulsion" in cfg.terms:
        out["repulsion"] = 0.5 * (A_ij * rinv12 * fmask).sum()
        g = g + (-12.0 * A_ij * rinv12 * rinv2) * fmask
    if "repulsioncg" in cfg.terms:
        out["repulsioncg"] = 0.5 * (B_ij * rinv6 * fmask).sum()
        g = g + (-6.0 * B_ij * rinv6 * rinv2) * fmask
    if "electrostatics" in cfg.terms:
        if cfg.ewald_alpha is not None:
            a = cfg.ewald_alpha
            erfc_t = torch.special.erfc(a * dist)
            pot = qq * erfc_t * rinv
            dEdr_r = -qq * rinv * rinv * (
                erfc_t * rinv
                + (2.0 * a / math.sqrt(math.pi)) * torch.exp(-(a * dist) ** 2)
            )
        elif cfg.rfa and cfg.cutoff is not None:
            krf, crf = rfa_constants(cfg)
            pot = qq * (rinv + krf * dist * dist - crf)
            dEdr_r = qq * (2.0 * krf - rinv * rinv * rinv)
        else:
            pot = qq * rinv
            dEdr_r = -qq * rinv * rinv * rinv
        out["electrostatics"] = 0.5 * (pot * fmask).sum()
        g = g + dEdr_r * fmask
    return out, g


def pair_coefficients(par: FFParams, cfg: ForceTermConfig, rows=None):
    """Per-pair (qq, A_ij, B_ij) blocks for `rows` (a (row0, nrows) tuple,
    or None for the full matrix). NBFIX tables or Lorentz-Berthelot."""
    sl = slice(None) if rows is None else slice(rows[0], rows[0] + rows[1])
    qq = None
    if "electrostatics" in cfg.terms:
        qq = ELEC_FACTOR * par.charges[sl, None] * par.charges[None, :]
    A_ij = B_ij = None
    if any(t in cfg.terms for t in LJ_FAMILY):
        A_ij, B_ij = _lorentz_berthelot(par, sl)
    return qq, A_ij, B_ij


def nonbonded_energy_forces(par: FFParams, pos, box, cfg: ForceTermConfig):
    """Dense nonbonded terms with analytic per-pair force coefficients:
    (energies dict, forces (natoms, 3)), row sums of the pair matrix."""
    dv = wrap_displacement(pos[:, None, :] - pos[None, :, :], box)
    qq, A_ij, B_ij = pair_coefficients(par, cfg)
    return nonbonded_block_energy_forces(cfg, dv, par.nb_mask, qq, A_ij, B_ij)


def energy_and_forces_fused(par: FFParams, pos, box, cfg: ForceTermConfig):
    """(per-term potentials, forces): analytic dense nonbonded plus the
    bonded terms by autograd."""
    has_nb = (any(t in cfg.terms for t in NONBONDED_TERMS)
              and par.nb_mask is not None)
    pot, forces = energy_and_forces(par._replace(nb_mask=None), pos, box, cfg)
    if has_nb:
        nb_pot, nb_forces = nonbonded_energy_forces(par, pos, box, cfg)
        for k, v in nb_pot.items():
            add_energy(pot, k, v)
        forces = forces + nb_forces
    return pot, forces


# ----------------------------------------------------------------------
# FFParams construction
# ----------------------------------------------------------------------

def _term_table(d, dtype, device) -> Optional[TermTable]:
    if d is None or d.get("params") is None or len(d["params"]) == 0:
        return None
    return TermTable(
        idx=torch.as_tensor(np.asarray(d["idx"]), dtype=torch.int64,
                            device=device),
        map_term=torch.as_tensor(np.asarray(d["map"])[:, 0], dtype=torch.int64,
                                 device=device),
        map_param=torch.as_tensor(np.asarray(d["map"])[:, 1],
                                  dtype=torch.int64, device=device),
        params=torch.as_tensor(np.asarray(d["params"]), dtype=dtype,
                               device=device),
    )


def make_ffparams(parameters, exclusions=("bonds", "angles", "1-4"),
                  dtype=torch.float32, device="cpu", nbfix=False,
                  dense_mask=True) -> FFParams:
    """Freeze a host-side `torchmd_tpu.parameters.Parameters` assembly
    into tensors on `device`. `exclusions` selects the bonded neighbour
    classes masked out of the all-pairs nonbonded sum; `nbfix=True` bakes
    CHARMM NBFIX overrides into (ntypes, ntypes) A/B tables; CMAP grids
    become their bicubic coefficient table (`cmap.make_cmap_table`)."""
    def tensor(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    nb_mask = None
    if dense_mask:
        mask = ~parameters.get_exclusions(types=exclusions, fullarray=True)
        np.fill_diagonal(mask, False)
        nb_mask = tensor(mask, torch.bool)

    lj_ab = None
    ab_tables = getattr(parameters, "lj_ab_tables", None)
    if ab_tables is not None:
        # non-Lorentz-Berthelot assemblies (GROMACS comb-rule 1/3) give
        # the full tables; always honoured, independent of `nbfix`
        lj_ab = (tensor(ab_tables[0]), tensor(ab_tables[1]))
    elif nbfix and parameters.nonbonded_params is not None and len(
            getattr(parameters, "nbfix", [])):
        sig = np.asarray(parameters.nonbonded_params["params"][:, 0])
        eps = np.abs(np.asarray(parameters.nonbonded_params["params"][:, 1]))
        sig_ij = 0.5 * (sig[:, None] + sig[None, :])
        s6 = sig_ij**6
        B_tab = 4.0 * np.sqrt(eps[:, None] * eps[None, :]) * s6
        A_tab = B_tab * s6
        for ti, tj, feps, frmin in np.asarray(parameters.nbfix):
            i, j = int(ti), int(tj)
            # NBFIX rows give Emin and the full Rmin of the pair
            A_tab[i, j] = A_tab[j, i] = feps * frmin**12
            B_tab[i, j] = B_tab[j, i] = 2.0 * feps * frmin**6
        lj_ab = (tensor(A_tab), tensor(B_tab))

    cmap = None
    cmap_par = getattr(parameters, "cmap_params", None)
    if cmap_par is not None and len(cmap_par.get("idx", [])):
        from .cmap import make_cmap_table

        cmap = make_cmap_table(cmap_par, dtype=dtype, device=device)

    return FFParams(
        cmap=cmap,
        charges=tensor(parameters.charges),
        masses=tensor(parameters.masses),
        mapped_atom_types=tensor(parameters.mapped_atom_types, torch.int64),
        lj_params=(tensor(parameters.nonbonded_params["params"])
                   if parameters.nonbonded_params is not None else None),
        bonds=_term_table(parameters.bond_params, dtype, device),
        angles=_term_table(parameters.angle_params, dtype, device),
        dihedrals=_term_table(parameters.dihedral_params, dtype, device),
        impropers=_term_table(parameters.improper_params, dtype, device),
        nb14=_term_table(parameters.nonbonded_14_params, dtype, device),
        nb_mask=nb_mask,
        urey_bradley=_term_table(
            getattr(parameters, "urey_bradley_params", None), dtype, device),
        lj_ab=lj_ab,
        bonds_g96=_term_table(
            getattr(parameters, "bond_g96_params", None), dtype, device),
        angles_g96=_term_table(
            getattr(parameters, "angle_g96_params", None), dtype, device),
    )
