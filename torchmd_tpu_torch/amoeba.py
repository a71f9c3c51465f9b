"""AMOEBA: TINKER file ingestion, Thole induced-dipole polarization,
buffered 14-7 van der Waals and the full potential, the port of
`torchmd_tpu.amoeba`.

  - `parse_tinker_prm` reads `multipole`, `polarize`, `vdw` and `atom`
    records of a TINKER .prm; `read_tinker_xyz` a TINKER .xyz frame
    (types and connectivity); `resolve_frames` maps per-type multipole
    records onto per-atom local frames (1-2 neighbours, then 1-3).
  - Units: dipoles e*Bohr -> e*A (x BOHR); quadrupoles, stored as the
    traceless second moment in e*Bohr^2, -> the Jackson convention
    (x 3 BOHR^2); polarizabilities A^3.
  - `AmoebaPolarization`: mutual induced point dipoles with Thole
    damping (lambda3 = 1 - exp(-a u^3), lambda5 = 1 - (1 + a u^3)
    exp(-a u^3), u = r / (alpha_i alpha_j)^(1/6), a = min(thole)), the
    permanent field masked within a polarization group (d-scale 0),
    nearest image inside a cutoff. `AmoebaPolarizationEwald`: the same
    model on the periodic Ewald couplings of a `MultipoleEwald` /
    `MultipolePme` engine (Sagui, Pedersen & Darden, JCP 120:73, 2004),
    as the quadratic functional W(mu) of the JAX class.
  - The SCF is conjugate gradients on a fixed number of iterations
    (`cg_iters`): once the residual meets `cg_tol` the carry is frozen
    with `torch.where`, which gives the JAX while loop's numbers with no
    host read per iteration. The geometry of the couplings is built once
    per solve. The energy is the variational functional evaluated at the
    detached solution mu*: by the envelope theorem one autograd pass over
    the positions gives forces exact to second order in the CG residual,
    without differentiating through the loop.
  - `AmoebaVdw`: Halgren's buffered 14-7 with AMOEBA's combining rules
    and the hydrogen reduction sites; `AmoebaValence` (amoeba_valence.py)
    the bonded terms; `make_amoeba_potential` the sum as one external
    potential (`Forces(terms=[], external=pot)`).

Every object keeps its tensors on the card unless given `device="cpu"`
(the factories raise without a card otherwise) and evaluates in the
dtype of the positions it is given.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .multipole_ewald import (MultipoleEwald, MultipolePme, b_bare, pair_energy)
from .multipoles import (BatchedExternal, _to_numpy, lab_dipoles, lab_quadrupoles,
                         make_multipoles, parse_tinker_multipoles, _switch_factor)
from .potentials import wrap_displacement
from .systems import resolve_device
from .units import ELEC_FACTOR

BOHR = 0.52917721067          # Angstrom (CODATA; TINKER's scale)
DEBYE = 4.80320425            # 1 e*Angstrom in Debye
# natoms from which pme="auto" takes the gridded MultipolePme. Provisional:
# the JAX package's default (TMD_MULTIPOLE_PME_N), not yet measured on the
# H100.
MULTIPOLE_PME_N = 256


# ----------------------------------------------------------------------
# File parsing
# ----------------------------------------------------------------------

def parse_tinker_prm(text):
    """The AMOEBA records of a TINKER .prm: {"multipoles": {type: ...},
    "polarize": {type: {"alpha", "thole", "group_types"}}, "atoms":
    {type: {"class", "name", "mass"}}, "vdw": {class: {"rmin", "eps",
    "reduction"}}, "_text": text}."""
    out = {"multipoles": parse_tinker_multipoles(text),
           "polarize": {}, "atoms": {}, "vdw": {}, "_text": text}
    for raw in text.splitlines():
        ln = raw.split("#")[0].strip()
        if not ln:
            continue
        parts = ln.split()
        key = parts[0].lower()
        if key == "vdw":
            out["vdw"][int(parts[1])] = {
                "rmin": float(parts[2]), "eps": float(parts[3]),
                "reduction": float(parts[4]) if len(parts) > 4 else 1.0}
        elif key == "polarize":
            out["polarize"][int(parts[1])] = {
                "alpha": float(parts[2]), "thole": float(parts[3]),
                "group_types": [int(p) for p in parts[4:] if _is_int(p)]}
        elif key == "atom":
            nums = [p for p in parts[4:] if _is_float(p)]
            out["atoms"][int(parts[1])] = {
                "class": int(parts[2]), "name": parts[3],
                "mass": float(nums[-2]) if len(nums) >= 2 else 0.0}
    return out


def _is_int(s):
    try:
        int(s)
        return True
    except ValueError:
        return False


def _is_float(s):
    try:
        float(s)
        return True
    except ValueError:
        return False


def read_tinker_xyz(path_or_text):
    """A TINKER .xyz frame -> (coords (N, 3) float64, types (N,) int,
    bonds (nb, 2) int, box (3,) or None); orthorhombic boxes only."""
    if "\n" in str(path_or_text):
        lines = str(path_or_text).splitlines()
    else:
        with open(path_or_text) as fh:
            lines = fh.read().splitlines()
    lines = [ln for ln in (s.strip() for s in lines) if ln]
    n = int(lines[0].split()[0])
    i = 1
    box = None
    parts = lines[i].split()
    if len(parts) == 6 and all(_is_float(p) for p in parts):
        vals = [float(p) for p in parts]
        if not all(abs(a - 90.0) < 1e-6 for a in vals[3:]):
            raise ValueError("only orthorhombic TINKER boxes supported")
        box = np.asarray(vals[:3])
        i += 1
    coords = np.zeros((n, 3))
    types = np.zeros(n, dtype=np.int64)
    bonds = set()
    for k in range(n):
        p = lines[i + k].split()
        idx = int(p[0]) - 1
        coords[idx] = [float(p[2]), float(p[3]), float(p[4])]
        types[idx] = int(p[5])
        for b in p[6:]:
            j = int(b) - 1
            bonds.add((min(idx, j), max(idx, j)))
    bonds = np.asarray(sorted(bonds), dtype=np.int64).reshape(-1, 2)
    return coords, types, bonds, box


# ----------------------------------------------------------------------
# Frame resolution (per-type records -> per-atom local frames)
# ----------------------------------------------------------------------

def _neighbor_lists(natoms, bonds):
    n12 = [[] for _ in range(natoms)]
    for a, b in np.asarray(bonds).reshape(-1, 2):
        n12[int(a)].append(int(b))
        n12[int(b)].append(int(a))
    return n12


def resolve_frames(atom_types, bonds, records):
    """Per-atom dicts (atom, frame, z, x, raw file-unit moments, type)
    from per-type multipole records. Axis atoms are searched among 1-2
    neighbours first, then 1-3 through the z atom (TINKER's kmpole
    order); three-axis frames are not implemented."""
    atom_types = np.asarray(atom_types).reshape(-1)
    n12 = _neighbor_lists(len(atom_types), bonds)
    out = []
    for a in range(len(atom_types)):
        t = int(atom_types[a])
        if t not in records:
            raise KeyError(f"atom {a}: no multipole record for type {t}")
        r = records[t]
        frame = r["frame"]
        z_at = x_at = a
        if frame != "none":
            zt = r["z_type"]
            zs = [b for b in n12[a] if int(atom_types[b]) == zt]
            if not zs:
                raise ValueError(f"atom {a} (type {t}): no bonded neighbour of z-axis "
                                 f"type {zt}")
            z_at = zs[0]
            xt = r.get("x_type", 0)
            if xt:
                xs = [b for b in n12[a] if b != z_at and int(atom_types[b]) == xt]
                if not xs:
                    xs = [c for c in n12[z_at] if c != a and int(atom_types[c]) == xt]
                if not xs:
                    raise ValueError(f"atom {a} (type {t}): no 1-2/1-3 neighbour of "
                                     f"x-axis type {xt}")
                x_at = xs[0]
            elif frame == "bisector":
                raise ValueError(f"atom {a}: bisector frame needs x type")
        out.append({"atom": a, "frame": frame, "z": z_at, "x": x_at,
                    "monopole": r["monopole"], "dipole": r["dipole"],
                    "quad": r["quad"], "type": t})
    return out


def _tinker_quad_to_jackson(Q_file):
    """Traceless second moment (file, e*Bohr^2) -> Jackson (e*A^2)."""
    Q = 3.0 * (BOHR ** 2) * np.asarray(Q_file, np.float64)
    return Q - np.eye(3) * (np.trace(Q) / 3.0)   # file rounding's trace


def make_amoeba_multipoles(ffparams, atom_types, bonds, records, cutoff=None,
                           switch_dist=None, device=None):
    """(`Multipoles`, monopole charges (natoms,) float64) from TINKER
    multipole records, units converted. The monopoles replace any point
    charges of the topology and feed the charge tiers directly."""
    frames = resolve_frames(atom_types, bonds, records)
    dipoles = []
    charges = np.zeros(len(frames))
    for f in frames:
        charges[f["atom"]] = f["monopole"]
        d = {"atom": f["atom"], "mu": np.asarray(f["dipole"], np.float64) * BOHR,
             "frame": f["frame"], "quad": _tinker_quad_to_jackson(f["quad"])}
        if f["frame"] != "none":
            d["z"], d["x"] = f["z"], f["x"]
        dipoles.append(d)
    mp = make_multipoles(ffparams, dipoles, cutoff=cutoff, switch_dist=switch_dist,
                         charges=charges, device=device)
    return mp, charges


# ----------------------------------------------------------------------
# Thole induced-dipole polarization
# ----------------------------------------------------------------------

class PolarizationSpec(NamedTuple):
    sites: torch.Tensor       # (np,) int64 polarizable atom rows
    alpha: torch.Tensor       # (np,) float64, A^3
    thole: torch.Tensor       # (np,) float64 damping factors
    perm_mask: torch.Tensor   # (np, np) bool: pairs whose permanent moments
    #                           polarize each other (False within a group)
    cutoff: Optional[float] = None
    cg_iters: int = 40
    cg_tol: float = 1e-6


def polarization_groups(atom_types, bonds, polarize_records):
    """Group id per atom: connected components of the bond graph over
    the edges whose endpoint types list each other in their `polarize`
    group lists (TINKER semantics)."""
    atom_types = np.asarray(atom_types).reshape(-1)
    parent = list(range(len(atom_types)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in np.asarray(bonds).reshape(-1, 2):
        ta, tb = int(atom_types[a]), int(atom_types[b])
        ga = polarize_records.get(ta, {}).get("group_types", [])
        gb = polarize_records.get(tb, {}).get("group_types", [])
        if tb in ga or ta in gb:
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[ra] = rb
    return np.asarray([find(i) for i in range(len(atom_types))])


def _thole_lambdas(d2, a_damp, alpha_i, alpha_j):
    """Thole damping factors (lambda3, lambda5) of the dipole tensor."""
    u3 = (torch.sqrt(d2) / (alpha_i * alpha_j) ** (1.0 / 6.0)) ** 3
    ex = torch.exp(-a_damp * u3)
    return 1.0 - ex, 1.0 - (1.0 + a_damp * u3) * ex


def _cg(A, b, x0, iters, tol):
    """Conjugate gradients on A x = b from x0, `iters` iterations; the
    carry freezes once r.r <= tol^2 (the JAX while loop's stop), so no
    iteration reads the device from the host. Returns (x, iterations
    taken, final r.r), 0-d tensors."""
    r = b - A(x0)
    x, p, rs = x0, r, (r * r).sum()
    taken = torch.zeros((), dtype=torch.int64, device=b.device)
    tol2 = tol * tol
    for _ in range(iters):
        live = rs > tol2
        Ap = A(p)
        denom = (p * Ap).sum()
        a = rs / torch.where(denom == 0, torch.ones_like(denom), denom)
        x_n = x + a * p
        r_n = r - a * Ap
        rs_n = (r_n * r_n).sum()
        beta = rs_n / torch.where(rs == 0, torch.ones_like(rs), rs)
        p_n = r_n + beta * p
        x, r, p = (torch.where(live, new, old) for new, old in ((x_n, x), (r_n, r), (p_n, p)))
        rs = torch.where(live, rs_n, rs)
        taken = taken + live.to(torch.int64)
    return x, taken, rs


def _capture(fn, static):
    """(graph, static inputs, outputs) of `fn(*static)` captured as one
    CUDA graph after two warm-up calls on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*static)
    return graph, static, out


def _replay(entry, args):
    """Copy `args` into the graph's static inputs, replay it and return
    copies of its outputs."""
    graph, static, out = entry
    for dst, src in zip(static, args):
        if dst is not None:
            dst.copy_(src)
    graph.replay()
    return tuple(t.clone() for t in out)


def _spec_rows(pspec, dtype):
    return pspec.alpha.to(dtype), pspec.thole.to(dtype)


class AmoebaPolarization(BatchedExternal):
    """Thole mutual induced dipoles over a permanent-multipole spec,
    nearest image inside `pspec.cutoff` (an external potential)."""

    def __init__(self, mp_spec, charges, pspec: PolarizationSpec):
        self.mp_spec = mp_spec
        self.pspec = pspec
        self.device = pspec.sites.device
        self.charges = torch.as_tensor(np.asarray(_to_numpy(charges), np.float64),
                                       device=self.device)
        self.last_cg_iters = self.last_cg_rs = None   # the last solve's, 0-d tensors

    def _perm_field(self, pos, box):
        """E_perm (np, 3), e/A^2: the field at each polarizable site from
        the permanent charge, dipole and quadrupole of every site that
        perm_mask allows, in raw Gaussian units."""
        ps, spec = self.pspec, self.mp_spec
        src = spec.sites
        qj = self.charges.to(pos.dtype)[src]
        mu = lab_dipoles(spec, pos, box)
        dv = wrap_displacement(pos[ps.sites][:, None, :] - pos[src][None, :, :], box)
        mask = ps.perm_mask
        if ps.cutoff is not None:
            mask = mask & ((dv * dv).sum(-1) <= ps.cutoff ** 2)
        d = torch.where(mask[..., None], dv, torch.ones_like(dv))
        r2 = (d * d).sum(-1)
        inv3 = r2 ** -1.5
        inv5 = inv3 / r2
        mud = (mu[None, :, :] * d).sum(-1)
        # grad of q/r + mu.d/r^3 + (1/2) d.Q.d/r^5
        g = (-(qj[None, :] * inv3)[..., None] * d + mu[None, :, :] * inv3[..., None]
             - 3.0 * (mud * inv5)[..., None] * d)
        if spec.quad_local is not None:
            Qd = torch.einsum("jab,ijb->ija", lab_quadrupoles(spec, pos, box), d)
            g = g + Qd * inv5[..., None] - 2.5 * ((Qd * d).sum(-1) * inv5 / r2)[..., None] * d
        return -torch.where(mask[..., None], g, torch.zeros_like(g)).sum(1)

    def _tmat(self, pos, box):
        """(dv, lambda3/r^3, 3 lambda5/r^5) over the polarizable site
        pairs, zero on the diagonal and beyond the cutoff."""
        ps = self.pspec
        x = pos[ps.sites]
        dv = wrap_displacement(x[:, None, :] - x[None, :, :], box)
        d2 = (dv * dv).sum(-1)
        mask = ~torch.eye(x.shape[0], dtype=torch.bool, device=pos.device)
        if ps.cutoff is not None:
            mask = mask & (d2 <= ps.cutoff ** 2)
        d2s = torch.where(mask, d2, torch.ones_like(d2))
        alpha, thole = _spec_rows(ps, pos.dtype)
        lam3, lam5 = _thole_lambdas(d2s, torch.minimum(thole[:, None], thole[None, :]),
                                    alpha[:, None], alpha[None, :])
        inv3 = d2s ** -1.5
        fm = mask.to(pos.dtype)
        return dv, lam3 * inv3 * fm, 3.0 * lam5 * inv3 / d2s * fm

    @staticmethod
    def _tmat_apply(t, mu):
        """(T mu)_i = sum_j [3 lambda5 (mu_j.r) r / r^5 - lambda3 mu_j / r^3]."""
        dv, a3, a5 = t
        mudotr = (mu[None, :, :] * dv).sum(-1)
        return ((a5 * mudotr)[..., None] * dv - a3[..., None] * mu[None, :, :]).sum(1)

    def _solve_induced(self, t, E):
        """CG on (alpha^-1 - T) mu = E from the direct guess alpha E."""
        ps = self.pspec
        alpha = ps.alpha.to(E.dtype)[:, None]

        def A(m):
            return m / alpha - self._tmat_apply(t, m)

        mu, self.last_cg_iters, self.last_cg_rs = _cg(A, E, alpha * E, ps.cg_iters,
                                                      ps.cg_tol)
        return mu

    def induced_dipoles(self, pos, box=None):
        """Converged induced dipoles (np, 3), e*A."""
        with torch.no_grad():
            return self._solve_induced(self._tmat(pos, box), self._perm_field(pos, box))

    def energy_fn(self, pos, box=None):
        """EF (1/2 mu a^-1 mu - 1/2 mu T mu - mu.E) at the detached SCF
        solution (envelope-exact forces)."""
        E = self._perm_field(pos, box)
        t = self._tmat(pos, box)
        with torch.no_grad():
            mu = self._solve_induced(tuple(x.detach() for x in t), E.detach())
        alpha = self.pspec.alpha.to(pos.dtype)[:, None]
        u = (0.5 * (mu * mu / alpha).sum() - 0.5 * (mu * self._tmat_apply(t, mu)).sum()
             - (mu * E).sum())
        return ELEC_FACTOR * u


class AmoebaPolarizationEwald(BatchedExternal):
    """Ewald-split Thole mutual induced dipoles (polarization PME): the
    JAX class's quadratic functional

        W(mu) = 1/2 mu alpha^-1 mu + [U_es(mu_perm + S mu) - U_es(mu_perm)]
              + U_pi_patch(mu) + U_mut_patch(mu),

    U_es the engine's four Ewald tiers. U_pi_patch moves the direct
    (permanent -> induced) coupling from the engine's exclusion set to
    the polarization-group mask (bare kernel, nearest image, coefficient
    perm_mask - nb_mask); U_mut_patch = -1/2 mu [T_thole - nb T_bare] mu
    turns the mutual coupling into the Thole-damped all-pairs form.

    The SCF minimises W by CG with A(m) = grad W(m) - grad W(0). W is
    quadratic, so that is the gradient of W's quadratic part alone,
    1/2 m alpha^-1 m + U_es(S m) + U_mut_patch(m), taken here by
    torch.autograd on the geometry built once per solve: the same
    operator without subtracting two large gradients (which costs f32
    digits). The right-hand side is -grad W(0), the periodic permanent
    field with its patch. On the card the whole solve is one CUDA graph
    per dtype and shape, captured at its first call (`cuda_graph = False`
    on an instance runs it eagerly)."""

    cuda_graph = True

    def __init__(self, engine, pspec: PolarizationSpec):
        ns = int(engine.spec.sites.shape[0])
        natoms = int(engine.charges.shape[0])
        if ns != natoms:
            raise ValueError("AmoebaPolarizationEwald assumes every atom is a "
                             "multipole site (AMOEBA); got ns != natoms")
        self.engine = engine
        self.pspec = pspec
        self.device = engine.device
        sites = _to_numpy(pspec.sites)
        nb = _to_numpy(engine.spec.nb_mask).astype(bool)
        src = _to_numpy(engine.spec.sites)
        c_pi = (_to_numpy(pspec.perm_mask).astype(np.float64)
                - nb[sites[:, None], src[None, :]].astype(np.float64))
        c_pi[np.equal(sites[:, None], src[None, :])] = 0.0
        pi, pj = np.nonzero(np.abs(c_pi) > 0.5)

        def t(v, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(v), dtype=dtype, device=self.device)

        # the direct-field patch over its (few) nonzero pairs (i: induced
        # site row, j: source atom)
        self._pi_pairs = (t(pi, torch.int64), t(pj, torch.int64),
                          t(c_pi[pi, pj], torch.float64))
        iu, ju = np.triu_indices(len(sites), 1)
        self._mut_pairs = (t(iu, torch.int64), t(ju, torch.int64),
                           t(nb[sites[iu], sites[ju]], torch.float64))
        self.last_cg_iters = self.last_cg_rs = None   # the last solve's, 0-d tensors
        self._graphs = {}

    # -- patches ---------------------------------------------------------
    def _mut_geom(self, pos, box):
        """(i, j, d, (lambda3 - nb)/r^3, 3 (lambda5 - nb)/r^5) over the
        site pairs i < j, nearest image."""
        i, j, nb = self._mut_pairs
        x = pos[self.pspec.sites]
        d = wrap_displacement(x.index_select(0, i) - x.index_select(0, j), box)
        d2 = (d * d).sum(-1)
        alpha, thole = _spec_rows(self.pspec, pos.dtype)
        lam3, lam5 = _thole_lambdas(d2, torch.minimum(thole[i], thole[j]), alpha[i],
                                    alpha[j])
        nb = nb.to(pos.dtype)
        inv3 = d2 ** -1.5
        return i, j, d, (lam3 - nb) * inv3, 3.0 * (lam5 - nb) * inv3 / d2

    @staticmethod
    def _u_mut(mg, mu):
        i, j, d, a3, a5 = mg
        mi, mj = mu.index_select(0, i), mu.index_select(0, j)
        return -(a5 * (mi * d).sum(-1) * (mj * d).sum(-1) - a3 * (mi * mj).sum(-1)).sum()

    def _u_pi(self, pos, box, q, mu_perm, Q, mu_ind):
        """sum c_ij [mu_i . grad_i][L_j] (1/r), nearest image."""
        i, j, c = self._pi_pairs
        if i.numel() == 0:
            return torch.zeros((), dtype=pos.dtype, device=pos.device)
        d = wrap_displacement(pos[self.pspec.sites[i]] - pos[j], box)
        e = pair_energy(b_bare((d * d).sum(-1), 3 if Q is not None else 2), d,
                        None, mu_ind[i], None, q[j], mu_perm[j],
                        None if Q is None else Q[j])
        return (c.to(pos.dtype) * e).sum()

    def _w_quadratic(self, geom, mg, mu):
        """W's part quadratic in the induced dipoles."""
        alpha = self.pspec.alpha.to(mu.dtype)[:, None]
        full = torch.zeros((self.engine.charges.shape[0], 3), dtype=mu.dtype,
                           device=mu.device).index_add(0, self.pspec.sites, mu)
        return (0.5 * (mu * mu / alpha).sum() + self.engine.energy_geom(geom, None, full, None)
                + self._u_mut(mg, mu))

    def _solve(self, pos, box, geom, mg, q, mu_perm, Q):
        """CG for the induced dipoles at detached inputs."""
        ps = self.pspec
        sites = ps.sites
        with torch.enable_grad():
            m = torch.zeros((sites.shape[0], 3), dtype=pos.dtype, device=pos.device,
                            requires_grad=True)
            w_lin = (self.engine.energy_geom(geom, q, mu_perm.index_add(0, sites, m), Q)
                     + self._u_pi(pos, box, q, mu_perm, Q, m))
            (g0,) = torch.autograd.grad(w_lin, m)

        def A(p):
            with torch.enable_grad():
                x = p.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(self._w_quadratic(geom, mg, x), x)
            return g

        b = -g0
        mu, self.last_cg_iters, self.last_cg_rs = _cg(
            A, b, ps.alpha.to(pos.dtype)[:, None] * b, ps.cg_iters, ps.cg_tol)
        return mu

    def _box(self, pos, box):
        if box is None:
            raise ValueError("AmoebaPolarizationEwald needs a box")
        return torch.as_tensor(box, dtype=pos.dtype, device=pos.device).reshape(-1)[:3]

    def _solve_at(self, pos, box):
        """(mu, iterations, r.r) of the solve at detached pos and box."""
        with torch.no_grad():
            geom = self.engine.geometry(pos, box)
            q, mu_perm, Q = self.engine._moments(pos, box)
            mu = self._solve(pos, box, geom, self._mut_geom(pos, box), q, mu_perm, Q)
        return mu, self.last_cg_iters, self.last_cg_rs

    def _graphed(self, pos, box):
        """The solve as one CUDA graph per (dtype, shape, cg_iters,
        cg_tol): its 40 iterations' ~14,000 small launches cost one launch
        from the host."""
        key = (pos.dtype, tuple(pos.shape), self.pspec.cg_iters, self.pspec.cg_tol)
        if key not in self._graphs:
            self._graphs[key] = _capture(self._solve_at, (pos.clone(), box.clone()))
        mu, self.last_cg_iters, self.last_cg_rs = _replay(self._graphs[key], (pos, box))
        return mu

    def induced_dipoles(self, pos, box=None):
        """Converged induced dipoles (np, 3), e*A. On the card the solve
        replays a CUDA graph (`cuda_graph`)."""
        box = self._box(pos, box)
        pos, box = pos.detach(), box.detach()
        if self.cuda_graph and pos.is_cuda and not torch.cuda.is_current_stream_capturing():
            return self._graphed(pos, box)
        return self._solve_at(pos, box)[0]

    def energy_parts(self, pos, box=None):
        """(EF U_es(perm), EF [W(mu*) - W(0)]): the permanent Ewald energy
        and the polarization energy from one geometry, mu* detached."""
        eng = self.engine
        box = self._box(pos, box)
        mu = self.induced_dipoles(pos, box)
        geom = eng.geometry(pos, box)
        q, mu_perm, Q = eng._moments(pos, box)
        u_perm = eng.energy_geom(geom, q, mu_perm, Q)
        alpha = self.pspec.alpha.to(pos.dtype)[:, None]
        u_pol = (eng.energy_geom(geom, q, mu_perm.index_add(0, self.pspec.sites, mu), Q)
                 - u_perm + 0.5 * (mu * mu / alpha).sum()
                 + self._u_pi(pos, box, q, mu_perm, Q, mu)
                 + self._u_mut(self._mut_geom(pos, box), mu))
        return ELEC_FACTOR * u_perm, ELEC_FACTOR * u_pol

    def energy_fn(self, pos, box=None):
        """Polarization energy, envelope-exact gradients."""
        return self.energy_parts(pos, box)[1]


class AmoebaVdw(BatchedExternal):
    """AMOEBA buffered 14-7 van der Waals (Halgren),

        E = eps_ij (1.07 / (rho + 0.07))^7 (1.12 / (rho^7 + 0.12) - 2),

    rho = r / rmin_ij, rmin_ij = (r_i^3 + r_j^3) / (r_i^2 + r_j^2), eps_ij =
    4 e_i e_j / (sqrt(e_i) + sqrt(e_j))^2, over the non-excluded pairs;
    hydrogen sites sit at heavy + lam (r_H - r_heavy) (the `reduction`
    factor), so autograd moves their forces onto the heavy atom."""

    part_name = "vdw"

    def __init__(self, ffparams, atom_types, bonds, prm, cutoff=None, switch_dist=None,
                 device=None):
        if ffparams.nb_mask is None:
            raise ValueError("AMOEBA vdW needs the dense nonbonded mask")
        self.device = resolve_device(device)
        atom_types = np.asarray(atom_types).reshape(-1)
        natoms = len(atom_types)
        rec, atoms = prm["vdw"], prm.get("atoms", {})
        rmin, eps, lam = np.zeros(natoms), np.zeros(natoms), np.ones(natoms)
        parent = np.arange(natoms)
        n12 = _neighbor_lists(natoms, bonds)
        for a, t in enumerate(atom_types):
            cls = atoms.get(int(t), {}).get("class", int(t))
            if cls not in rec:
                raise KeyError(f"atom {a}: no vdw record for class {cls} (type {t})")
            r = rec[cls]
            rmin[a], eps[a], lam[a] = r["rmin"], r["eps"], r["reduction"]
            if r["reduction"] != 1.0:
                if len(n12[a]) != 1:
                    raise ValueError(f"atom {a}: vdw reduction needs exactly one bonded "
                                     "heavy neighbour")
                parent[a] = n12[a][0]
        mask = _to_numpy(ffparams.nb_mask).astype(bool)
        iu, ju = np.triu_indices(natoms, 1)
        keep = mask[iu, ju]
        iu, ju = iu[keep], ju[keep]
        # per-pair combined parameters (float64; cast per evaluation)
        r_ij = (rmin[iu] ** 3 + rmin[ju] ** 3) / (rmin[iu] ** 2 + rmin[ju] ** 2)
        se = np.sqrt(eps)
        e_ij = 4.0 * eps[iu] * eps[ju] / ((se[iu] + se[ju]) ** 2 + 1e-300)

        def t(v):
            return torch.as_tensor(np.ascontiguousarray(v), device=self.device)

        self._pairs = (t(iu.astype(np.int64)), t(ju.astype(np.int64)), t(r_ij), t(e_ij))
        self.lam = t(lam)
        self.parent = t(parent.astype(np.int64))
        self.cutoff = None if cutoff is None else float(cutoff)
        self.switch_dist = None if switch_dist is None else float(switch_dist)

    def energy_fn(self, pos, box=None):
        i, j, r_ij, e_ij = self._pairs
        lam = self.lam.to(pos.dtype)[:, None]
        sites = pos[self.parent] + lam * (pos - pos[self.parent])
        d = wrap_displacement(sites.index_select(0, j) - sites.index_select(0, i), box)
        d2 = (d * d).sum(-1)
        mask = None
        if self.cutoff is not None:
            mask = d2 <= self.cutoff ** 2
            d2 = torch.where(mask, d2, torch.ones_like(d2))
        rho = torch.sqrt(d2) / r_ij.to(pos.dtype)
        e = e_ij.to(pos.dtype) * (1.07 / (rho + 0.07)) ** 7 * (1.12 / (rho ** 7 + 0.12) - 2.0)
        if self.switch_dist is not None and self.cutoff is not None:
            e = e * _switch_factor(d2, self.cutoff, self.switch_dist)
        if mask is not None:
            e = torch.where(mask, e, torch.zeros_like(e))
        return e.sum()


class AmoebaElectrostatics(BatchedExternal):
    """Permanent multipoles + induced polarization as one external term."""

    def __init__(self, multipoles, polarization=None):
        self.multipoles = multipoles
        self.polarization = polarization

    def energy_parts(self, pos, box=None):
        """{"permanent", "polarization"} energies; the Ewald form shares
        one geometry between them."""
        pol = self.polarization
        if isinstance(pol, AmoebaPolarizationEwald) and pol.engine is self.multipoles:
            e_perm, e_pol = pol.energy_parts(pos, box)
            return {"permanent": e_perm, "polarization": e_pol}
        out = {"permanent": self.multipoles.energy_fn(pos, box)}
        if pol is not None:
            out["polarization"] = pol.energy_fn(pos, box)
        return out

    def energy_fn(self, pos, box=None):
        return sum(self.energy_parts(pos, box).values())


class AmoebaPotential(BatchedExternal):
    """The sum of AMOEBA external terms (electrostatics, vdW, valence).
    `energy_forces_fn` (what `Forces` calls) is, on the card, one CUDA
    graph per dtype and shape of the whole evaluation, the CG solve and
    the backward pass included, captured at its first call (`cuda_graph =
    False` on an instance: eager autograd, as on the CPU)."""

    cuda_graph = True

    def __init__(self, parts):
        self.parts = parts
        self._graphs = {}

    def _ef(self, pos, box):
        with torch.enable_grad():
            x = pos.detach().requires_grad_(True)
            e = self.energy_fn(x, box)
            (g,) = torch.autograd.grad(e, x)
        return e.detach(), -g

    def energy_forces_fn(self, pos, box=None):
        """(energy, forces = -dE/dpos) of one conformation."""
        if not (self.cuda_graph and pos.is_cuda):
            return self._ef(pos, box)
        key = (pos.dtype, tuple(pos.shape), box is None)
        if key not in self._graphs:
            self._graphs[key] = _capture(self._ef, (pos.detach().clone(),
                                                    None if box is None else box.clone()))
        return _replay(self._graphs[key], (pos, box))

    def energy_parts(self, pos, box=None):
        """Energy per part: "permanent", "polarization", "charge_charge",
        "vdw", "valence"."""
        out = {}
        for p in self.parts:
            if isinstance(p, AmoebaElectrostatics):
                out.update(p.energy_parts(pos, box))
            else:
                out[p.part_name] = p.energy_fn(pos, box)
        return out

    def energy_fn(self, pos, box=None):
        return sum(self.energy_parts(pos, box).values())


class ChargeCharge(BatchedExternal):
    """Plain Coulomb over the nonbonded mask, for a standalone
    `AmoebaPotential` (the engine's point-charge term usually owns it)."""

    part_name = "charge_charge"

    def __init__(self, charges, nb_mask, cutoff=None, device=None):
        self.device = resolve_device(device)
        mask = _to_numpy(nb_mask).astype(bool)
        iu, ju = np.triu_indices(mask.shape[0], 1)
        keep = mask[iu, ju]
        q = np.asarray(_to_numpy(charges), np.float64)
        self._pairs = tuple(torch.as_tensor(np.ascontiguousarray(v), device=self.device)
                            for v in (iu[keep].astype(np.int64), ju[keep].astype(np.int64),
                                      q[iu[keep]] * q[ju[keep]]))
        self.cutoff = None if cutoff is None else float(cutoff)

    def energy_fn(self, pos, box=None):
        i, j, qq = self._pairs
        d = wrap_displacement(pos.index_select(0, j) - pos.index_select(0, i), box)
        d2 = (d * d).sum(-1)
        e = ELEC_FACTOR * qq.to(pos.dtype)
        if self.cutoff is None:
            return (e * d2 ** -0.5).sum()
        mask = d2 <= self.cutoff ** 2
        d2 = torch.where(mask, d2, torch.ones_like(d2))
        return torch.where(mask, e * d2 ** -0.5, torch.zeros_like(d2)).sum()


def make_amoeba_potential(ffparams, atom_types, bonds, prm, cutoff=None,
                          switch_dist=None, mutual=True, vdw=True, charge_charge=False,
                          cg_iters=40, cg_tol=1e-6, ewald=False, box=None, ewald_tol=1e-5,
                          pme="auto", pol_ewald=True, valence=False, device=None):
    """The AMOEBA stack from parsed .prm data as one external potential:
    (AmoebaPotential, monopole charges). Permanent multipoles + Thole
    mutual polarization + buffered 14-7 vdW; `valence=True` adds the
    .prm's bonded terms (the complete AMOEBA energy: build
    `Forces(terms=[], external=pot)`); `charge_charge=True` adds the
    monopole Coulomb for standalone use; `ewald=True` (needs `box` and
    `cutoff`) takes the full multipole Ewald sum, monopoles included.
    Runs on the card unless given `device`."""
    if ewald and charge_charge:
        raise ValueError("ewald=True already includes the monopole Coulomb term")
    device = resolve_device(device)
    elec, charges = make_amoeba_electrostatics(
        ffparams, atom_types, bonds, prm, cutoff=cutoff, switch_dist=switch_dist,
        mutual=mutual, cg_iters=cg_iters, cg_tol=cg_tol, ewald=ewald, box=box,
        ewald_tol=ewald_tol, pme=pme, pol_ewald=pol_ewald, device=device)
    parts = [elec]
    if charge_charge:
        parts.append(ChargeCharge(charges, ffparams.nb_mask, cutoff=cutoff, device=device))
    if vdw and prm.get("vdw"):
        parts.append(AmoebaVdw(ffparams, atom_types, bonds, prm, cutoff=cutoff,
                               switch_dist=switch_dist, device=device))
    if valence:
        from .amoeba_valence import AmoebaValence

        parts.append(AmoebaValence(prm["_text"], atom_types, bonds, device=device))
    return AmoebaPotential(parts), charges


def make_amoeba_electrostatics(ffparams, atom_types, bonds, prm, cutoff=None,
                               switch_dist=None, mutual=True, cg_iters=40, cg_tol=1e-6,
                               ewald=False, box=None, ewald_tol=1e-5, pme="auto",
                               pol_ewald=True, device=None):
    """(AmoebaElectrostatics, monopole charges) from parsed .prm data.

    ewald=True (needs `box` (3,) and `cutoff`): the permanent term is the
    full Ewald sum, monopoles included, and the polarization the
    Ewald-split solver (pol_ewald=False keeps the real-space one). pme:
    "auto" takes `MultipolePme` from `MULTIPOLE_PME_N` atoms and the exact
    `MultipoleEwald` below; True/False force the choice."""
    device = resolve_device(device)
    mp, charges = make_amoeba_multipoles(
        ffparams, atom_types, bonds, prm["multipoles"],
        cutoff=None if ewald else cutoff, switch_dist=None if ewald else switch_dist,
        device=device)
    atom_types = np.asarray(atom_types).reshape(-1)
    pol = None
    if mutual and prm["polarize"]:
        rec = prm["polarize"]
        sites = [a for a, t in enumerate(atom_types) if int(t) in rec]
        if sites:
            groups = polarization_groups(atom_types, bonds, rec)
            gs = groups[np.asarray(sites)]

            def t(v, dtype=None):
                return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

            pspec = PolarizationSpec(
                sites=t(sites, torch.int64),
                alpha=t([rec[int(atom_types[a])]["alpha"] for a in sites], torch.float64),
                thole=t([rec[int(atom_types[a])]["thole"] for a in sites], torch.float64),
                perm_mask=t(gs[:, None] != gs[None, :]),
                cutoff=None if cutoff is None else float(cutoff),
                cg_iters=int(cg_iters), cg_tol=float(cg_tol))
            pol = AmoebaPolarization(mp.spec, charges, pspec)
    perm = mp
    if ewald:
        if box is None or cutoff is None:
            raise ValueError("ewald=True needs box=(3,) and a cutoff")
        use_pme = pme if isinstance(pme, bool) else len(atom_types) >= MULTIPOLE_PME_N
        cls = MultipolePme if use_pme else MultipoleEwald
        perm = cls(mp.spec, charges, np.asarray(box), cutoff, tol=ewald_tol, device=device)
        if pol is not None and pol_ewald:
            pol = AmoebaPolarizationEwald(perm, pol.pspec)
    return AmoebaElectrostatics(perm, pol), charges
