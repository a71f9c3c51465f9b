"""Analytic bonded energies + forces with torch ops.

Counterpart of `torchmd_tpu.bonded`: one coordinate gather covering
every atom slot of every term family, the analytic force formulas of the
reference (torchmd/forces.py:494-605, including the OpenMM torsion force
distribution), and one scatter (`index_add_`) of all contributions back
to atoms. Per-assignment parameters are baked into the plan, so the hot
path gathers no parameter rows.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .units import ELEC_FACTOR

from .potentials import FFParams, ForceTermConfig, add_energy, wrap_displacement


class BondedPlan(NamedTuple):
    big_idx: torch.Tensor  # (G,) int64: coordinate gather plan, which is
                           # also the atom of each force contribution
    natoms: int
    families: tuple        # dicts: static description + baked parameters


def _expand(table):
    """Per-assignment parameter rows and the assignment -> instance map
    (None when it is the identity)."""
    params = table.params[table.map_param]
    ninst = int(table.idx.shape[0])
    map_term = table.map_term
    identity = bool(len(map_term) == ninst and torch.equal(
        map_term.cpu(), torch.arange(ninst)))
    return params, (None if identity else map_term), ninst


def build_bonded_plan(ffp: FFParams, cfg: ForceTermConfig
                      ) -> Optional[BondedPlan]:
    gather_cols = []
    families = []

    def add_family(kind, idx, **extras):
        offset = sum(len(c) for c in gather_cols)
        gather_cols.extend(idx[:, k] for k in range(idx.shape[1]))
        families.append(dict(kind=kind, offset=offset, count=int(idx.shape[0]),
                             **extras))

    for kind, name, tbl, cutoff in (
        ("bond", "bonds", ffp.bonds, cfg.cutoff),
        ("bond", "urey-bradley", ffp.urey_bradley, None),
    ):
        if name in cfg.terms and tbl is not None:
            params, map_term, ninst = _expand(tbl)
            add_family(kind, tbl.idx, name=name, k0=params[:, 0],
                       r0=params[:, 1], map_term=map_term, ninst=ninst,
                       cutoff=cutoff)
    if "angles" in cfg.terms and ffp.angles is not None:
        params, map_term, ninst = _expand(ffp.angles)
        add_family("angle", ffp.angles.idx, k0=params[:, 0], t0=params[:, 1],
                   map_term=map_term, ninst=ninst)
    for name, amber in (("dihedrals", cfg.dihedrals_amber),
                        ("impropers", cfg.impropers_amber)):
        tbl = getattr(ffp, name)
        if name in cfg.terms and tbl is not None:
            params, map_term, ninst = _expand(tbl)
            add_family("torsion", tbl.idx, name=name, k0=params[:, 0],
                       phi0=params[:, 1], per=params[:, 2],
                       map_term=map_term, ninst=ninst, amber=bool(amber))
    if "1-4" in cfg.terms and ffp.nb14 is not None:
        params, map_term, _ = _expand(ffp.nb14)
        if map_term is not None:
            raise ValueError("1-4 tables map one parameter row per pair")
        idx = ffp.nb14.idx
        q = ffp.charges
        add_family("nb14", idx, aa=params[:, 0] / params[:, 2],
                   bb=params[:, 1] / params[:, 2],
                   qq=ELEC_FACTOR * q[idx[:, 0]] * q[idx[:, 1]] / params[:, 3],
                   want_lj="lj" in cfg.terms,
                   want_elec="electrostatics" in cfg.terms)
    if not families:
        return None
    return BondedPlan(big_idx=torch.cat(gather_cols).to(torch.int64),
                      natoms=int(ffp.charges.shape[0]),
                      families=tuple(families))


def _norm(v):
    return torch.sqrt(torch.clamp((v * v).sum(-1), min=1e-32))


def _per_instance(coeff, f):
    """Sum per-assignment coefficients onto their term instance."""
    if f["map_term"] is None:
        return coeff
    out = torch.zeros(f["ninst"], dtype=coeff.dtype, device=coeff.device)
    return out.index_add_(0, f["map_term"], coeff)


def _per_assignment(x, f):
    return x if f["map_term"] is None else x[f["map_term"]]


def bonded_energy_forces(ffp: FFParams, plan: BondedPlan, pos, box,
                         cfg: ForceTermConfig):
    """(per-term bonded potentials dict, bonded forces (natoms, 3))."""
    P = pos[plan.big_idx]              # the single coordinate gather
    pot: dict = {}
    contribs = []

    for f in plan.families:
        o, c = f["offset"], f["count"]

        def col(k):
            return P[o + k * c:o + (k + 1) * c]

        if f["kind"] == "bond":
            dv = wrap_displacement(col(0) - col(1), box)
            r = _norm(dv)
            rr = _per_assignment(r, f)
            x = rr - f["r0"]
            e = f["k0"] * x * x
            coeff = 2.0 * f["k0"] * x
            if f["cutoff"] is not None:
                keep = rr <= f["cutoff"]
                e = torch.where(keep, e, torch.zeros_like(e))
                coeff = torch.where(keep, coeff, torch.zeros_like(coeff))
            fv = dv / r[:, None] * _per_instance(coeff, f)[:, None]
            add_energy(pot, f["name"], e.sum())
            contribs += [-fv, fv]

        elif f["kind"] == "angle":
            r21 = wrap_displacement(col(0) - col(1), box)
            r23 = wrap_displacement(col(2) - col(1), box)
            n21inv = 1.0 / _norm(r21)
            n23inv = 1.0 / _norm(r23)
            cos_t = torch.clamp((r21 * r23).sum(1) * n21inv * n23inv, -1.0, 1.0)
            sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
            theta = torch.atan2(torch.clamp(sin_t, min=1e-12), cos_t)
            sn = _per_assignment(sin_t, f)
            dt_ = _per_assignment(theta, f) - f["t0"]
            e = f["k0"] * dt_ * dt_
            coeff = torch.where(sn != 0,
                                -2.0 * f["k0"] * dt_ / torch.clamp(sn, min=1e-30),
                                torch.zeros_like(sn))
            coeff = _per_instance(coeff, f)[:, None]
            c_t = cos_t[:, None]
            u21 = r21 * n21inv[:, None]
            u23 = r23 * n23inv[:, None]
            f0 = coeff * (c_t * u21 - u23) * n21inv[:, None]
            f2 = coeff * (c_t * u23 - u21) * n23inv[:, None]
            add_energy(pot, "angles", e.sum())
            contribs += [f0, -(f0 + f2), f2]

        elif f["kind"] == "torsion":
            r12 = wrap_displacement(col(0) - col(1), box)
            r23 = wrap_displacement(col(1) - col(2), box)
            r34 = wrap_displacement(col(2) - col(3), box)
            crossA = torch.linalg.cross(r12, r23, dim=-1)
            crossB = torch.linalg.cross(r23, r34, dim=-1)
            crossC = torch.linalg.cross(r23, crossA, dim=-1)
            normA = _norm(crossA)
            normB = _norm(crossB)
            ncB = crossB / normB[:, None]
            cos_phi = (crossA * ncB).sum(1) / normA
            sin_phi = (crossC * ncB).sum(1) / _norm(crossC)
            phis = _per_assignment(-torch.atan2(sin_phi, cos_phi), f)
            if f["amber"]:
                diff = f["per"] * phis - f["phi0"]
                e = f["k0"] * (1.0 + torch.cos(diff))
                coeff = -f["per"] * f["k0"] * torch.sin(diff)
            else:
                diff = phis - f["phi0"]
                diff = diff - 2.0 * math.pi * torch.round(diff / (2.0 * math.pi))
                e = f["k0"] * diff * diff
                coeff = 2.0 * f["k0"] * diff
            coeff = _per_instance(coeff, f)
            normD = _norm(r23)
            norm2D = normD * normD
            ff0 = (-coeff * normD) / (normA * normA)
            ff1 = (r12 * r23).sum(1) / norm2D
            ff2 = (r34 * r23).sum(1) / norm2D
            ff3 = (coeff * normD) / (normB * normB)
            f0v = ff0[:, None] * crossA
            f3v = ff3[:, None] * crossB
            s = ff1[:, None] * f0v - ff2[:, None] * f3v
            add_energy(pot, f["name"], e.sum())
            contribs += [-f0v, f0v + s, f3v - s, -f3v]

        elif f["kind"] == "nb14":
            dv = wrap_displacement(col(0) - col(1), box)
            rinv = 1.0 / _norm(dv)
            coeff = torch.zeros_like(rinv)
            if f["want_lj"]:
                rinv6 = rinv**6
                rinv12 = rinv6 * rinv6
                add_energy(pot, "lj", (f["aa"] * rinv12 - f["bb"] * rinv6).sum())
                coeff = coeff + (-12.0 * f["aa"] * rinv12
                                 + 6.0 * f["bb"] * rinv6) * rinv
            if f["want_elec"]:
                p_e = f["qq"] * rinv
                add_energy(pot, "electrostatics", p_e.sum())
                coeff = coeff - p_e * rinv
            fv = dv * (rinv * coeff)[:, None]
            contribs += [-fv, fv]

    forces = torch.zeros((plan.natoms, 3), dtype=pos.dtype, device=pos.device)
    forces.index_add_(0, plan.big_idx, torch.cat(contribs, dim=0))
    return pot, forces
