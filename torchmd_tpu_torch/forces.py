"""User-facing force/energy evaluator.

`Forces` keeps the reference class surface (torchmd/forces.py:7-346) as the
JAX package does: the same constructor arguments, the same
`compute(pos, box, forces, returnDetails, explicit_forces, toNumpy,
calculateForces)` signature and return shapes, and the split into
`bonded_ef_one` / `nb_ef_one` / `ef_one` evaluators of one conformation.
Those evaluators come from `build_evaluators`, the one composition of
the force field, which the Drude path (`drude.drude_energy_forces`)
calls too.

The path follows the device:

  - `kernel="auto"` calls the kernel wrappers of `torchmd_tpu_torch.ops`:
    on a CUDA device they launch the hand-written kernels (f32), on the
    CPU they run the kernels' plain PyTorch versions. Periodic systems of
    at least CELL_AUTO_N atoms whose box hosts a 27-cell grid take the
    cell-list path (`neighbors.CellKernel`, the cell kernel); others the
    dense pair kernel;
  - `kernel="cell"` asks for the cell-list path;
  - `kernel="verlet"` asks for Verlet lists (`neighbors.VerletKernel`, a
    padded per-atom list with a skin, with or without a box; torch ops on
    every device, as the JAX package has no kernel for it). `"auto"`
    takes them, as the JAX package does (torchmd_tpu/forces.py:213-219,
    :577-585), for a system with a cutoff of at least VERLET_AUTO_N atoms
    that no cell grid covers (no box, or a box too small for a 27-cell
    grid). The list is built by cells (`neighbors.
    build_binned_verlet_list`: no (natoms, natoms) array, which would be
    ~10 GB as a mask and ~128 GB as displacements at 103,200 atoms)
    wherever that applies: no box, or a box of at least 3 cells of edge
    cutoff + skin a side; in a smaller box over the dense mask;
  - on that large-N path, `column` picks the neighbour structure: the
    z-sorted column kernel (`columns.ColumnKernel`) or the 27-cell
    kernel (`neighbors.CellKernel`). None (the default) takes the column
    kernel on CUDA f32 with the kernels, where the JAX package takes it
    on TPU f32 with Pallas, whenever `columns.column_supported` (a 3x3
    column grid, Lorentz-Berthelot LJ, one LJ-family term); True asks for
    it on any device (its plain version off the card); False keeps the
    cell kernel. The cell kernel serves wherever the column kernel
    cannot (NBFIX tables, which it reads by type pair; several LJ-family
    terms, one launch per such term, as the dense pair kernel takes them;
    f64; narrow grids);
  - `kernel="dense"` selects the torch-op path on any device: analytic
    dense nonbonded (`potentials`) and analytic bonded (`bonded`);
  - `plain=True` runs every kernel's plain PyTorch version on any device
    (the f64 reference path on the card);
  - at f64 on the card (`precision="double"`), `kernel="auto"` takes the
    torch-op path of the same configuration, as the JAX package gives its
    Pallas kernels only f32 (`torchmd_tpu/forces.py:229`, `:258`): the
    CUDA kernels run in single precision. `kernel="cell"` at f64 on the
    card raises. `Forces.path` records the choice (`select_path`).

`external=` takes an external potential (`external.TorchExternal`, or
any object with the reference's `calculate` protocol): `ef_one`
evaluates it after the internal terms, reports its `"external"` energy
and adds its forces into the same buffer.

`ef_batch(pos (R, N, 3), boxes)` evaluates a replica ladder: on the
dense kernel path `ef_one` itself takes the R conformations, with one
launch of the pair kernel and one of the bonded kernel for all of them
(the replica axis the vmapped Pallas calls of the JAX package have,
torchmd_tpu/integrator.py:547) and its other stages (the reciprocal
term, the autograd terms, the virtual sites, the external) per replica;
on the other paths, or for replicas that mix a box and none, `ef_one`
per replica. `compute` and the Integrator's dense path take it.

`gather` picks the PME force gather ("ik" or "exact", `ewald.PmeRecip`;
default ik for CUDA f32, exact otherwise).

`elec="pme"`, and `elec="ewald"` at PME_AUTO_N atoms or more, add smooth
PME (`ewald.PmeRecip`) with erfc-damped real-space pairs; `elec="ewald"`
below PME_AUTO_N atoms adds the exact Ewald sum (`ewald.EwaldRecip`).

The force field also comes in the tiers of r-RESPA (`mts_tiers`, the
JAX package's `bonded_ef_one` / `nb_ef_one` split): the bonded terms in
their own buffer, the real-space pairs with the reciprocal term and the
external, and the reciprocal term alone. Virtual sites
(`parameters.vsites`) wrap every path: evaluation at the reconstructed
site geometry, site forces spread onto the hosts. On the cell path, and
on Verlet lists built by cells, the dense (natoms, natoms) exclusion mask
is never built (3.9 GB at 62,500 atoms): only the paths that read it
build it (`require_nb_mask`): the dense pair kernel and the torch-op
pairs, the spatial row block (`prepare_rows`), alchemy, the dense MTK
scan's pair term and the autograd observables.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import bonded as _bonded
from . import potentials as _potentials
from .ops import bonded as _ops_bonded
from .ops import nonbonded as _ops_nonbonded
from .potentials import (
    BONDED_TERMS,
    NONBONDED_TERMS,
    TERMS,
    ForceTermConfig,
    add_energy,
    make_ffparams,
)
from .cmap import cmap_energy
from .external import batch_box, external_ef
from .systems import resolve_device, to_numpy, torch_dtype
from .vsites import vsite_groups_to, wrap_energy_forces

# Size thresholds of the automatic choices. Provisional: the JAX package's
# values, tuned on a TPU; not yet measured on the H100.
CELL_AUTO_N = 12000   # kernel="auto": cell-list path from this many atoms
PME_AUTO_N = 4096     # elec="ewald": PME from this many atoms
VERLET_AUTO_N = 100_000  # kernel="auto": Verlet lists from this many atoms, no grid
CELL_SKIN = 2.0       # A, cell edges >= cutoff + skin


def _box_to_diag(box, nreplicas) -> np.ndarray:
    """Accept (R,3,3), (R,3), (3,3), (3,) or None -> (R,3) float64 diagonal."""
    if box is None:
        return np.zeros((nreplicas, 3))
    box = to_numpy(box).astype(np.float64)
    if box.ndim == 3:
        return np.diagonal(box, axis1=1, axis2=2).copy()
    if box.ndim == 2 and box.shape == (3, 3):
        return np.tile(np.diag(box)[None], (nreplicas, 1))
    if box.ndim == 2:
        return box
    return np.tile(box.reshape(1, 3), (nreplicas, 1))


def _stack_terms(outs):
    """[(per-term energies, forces)] of R replicas -> ({term: (R,)},
    forces (R, N, 3)); a term missing in a replica counts 0."""
    keys = list(dict.fromkeys(k for pot, _ in outs for k in pot))
    frc = torch.stack([f for _, f in outs])
    zero = frc.new_zeros(())
    return ({k: torch.stack([pot.get(k, zero) for pot, _ in outs]) for k in keys}, frc)


def _each(fn):
    """A stage of one conformation, fn(pos (N, 3), box, *args) ->
    ({term: energy}, forces), also applied to R conformations: pos (R, N,
    3) with box (R, 3) or None, one replica at a time, stacked."""
    def lifted(pos, box, *args):
        if pos.dim() == 2:
            return fn(pos, box, *args)
        return _stack_terms([fn(pos[r], None if box is None else box[r], *args)
                             for r in range(pos.shape[0])])

    return lifted


def select_path(kernel, plain, device, dtype) -> str:
    """"kernels" (the kernel wrappers of `ops`: the CUDA kernels on the
    card, their plain PyTorch versions on the CPU) or "torch-ops" (the
    analytic torch-op path, `potentials` and `bonded`, or the cell list's
    plain version). The CUDA kernels are f32 only, so f64 on the card
    takes the torch-op path; `kernel="cell"` asks for the cell kernel
    and raises there."""
    if kernel == "dense" or plain:
        return "torch-ops"
    if torch.device(device).type == "cuda" and dtype != torch.float32:
        if kernel == "cell":
            raise ValueError(
                "kernel='cell' at f64 on the card: the cell kernel runs in "
                "single precision only; use precision='single', kernel='auto' "
                "(f64 takes the torch-op path) or plain=True")
        return "torch-ops"
    return "kernels"


def _with_external(internal, ext):
    """`internal` (pos, box, cl) -> (pot, forces), then the external
    potential: its energy as the "external" term, its forces added into
    the same buffer. An external with only the batched `calculate(pos[R,
    N, 3], box)` protocol is called with one replica."""
    ext_ef = external_ef(ext)

    @_each
    def external_one(pos, box):
        """The external's ({"external": energy ()}, forces) at one
        conformation: through `ext_ef` when it has a torch energy, else
        its batched `calculate` with one replica."""
        if ext_ef is not None:
            e, f = ext_ef(pos, batch_box(box, pos[None])[0])
        else:
            e, f = (torch.as_tensor(to_numpy(x), dtype=pos.dtype, device=pos.device)
                    for x in ext.calculate(pos[None], None if box is None else box[None]))
        return {"external": e.reshape(())}, f.reshape(pos.shape)

    def ef_one(pos, box, cl=None):
        pot, frc = internal(pos, box, cl)
        e, f = external_one(pos, box)
        return {**pot, **e}, frc.add_(f)

    return ef_one


def autograd_tables(ffp, terms):
    """(term, energy function, table) of the bonded terms that ride on
    the bonded stage of every path by autograd, as in the JAX package
    (`torchmd_tpu/forces.py:286-338`): CMAP and the GROMOS-96 bond and
    angle forms, tiny terms that no kernel computes."""
    return [(name, fn, table) for name, fn, table in (
        ("cmap", cmap_energy, ffp.cmap),
        ("bonds", _potentials.g96_bond_energy, ffp.bonds_g96),
        ("angles", _potentials.g96_angle_energy, ffp.angles_g96))
        if name in terms and table is not None]


class Evaluators(NamedTuple):
    """The evaluators of one composition of the force field (see
    `build_evaluators`); the `*_ef_one` stages are None where the force
    field has no such stage."""
    bonded_plan: object     # the bonded kernel's or the torch-op plan
    kernel_batch: bool      # ef_one also takes (R, N, 3) in one call
    bonded_ef_one: object
    nb_ef_one: object
    pair_ef_one: object
    recip_ef_one: object
    ef_one: object
    pair_rows_ef_one: object = None  # dense path: (pos, box, tiles) -> rows


def _with_autograd(bonded_ef_one, energy):
    """`bonded_ef_one` plus the terms of `energy(pos, box) -> {term:
    energy}`: their energies added to the per-term dict, their forces by
    `torch.autograd`."""
    @_each
    def autograd_ef(pos, box):
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            terms = energy(p, box)
            (g,) = torch.autograd.grad(sum(terms.values()), p)
        return {k: v.detach() for k, v in terms.items()}, g

    def wrapped(pos, box, out=None):
        pot, frc = bonded_ef_one(pos, box, out=out)
        terms, g = autograd_ef(pos, box)
        pot = dict(pot)
        for k, v in terms.items():
            add_energy(pot, k, v)
        return pot, frc - g

    return wrapped


def build_evaluators(ffp, config, use_kernels, recip=None, cell_kernel=None,
                     extra_autograd=None) -> Evaluators:
    """The one composition of the force field that `Forces` and the Drude
    path (`drude.drude_energy_forces`) evaluate: the bonded stage (the
    bonded kernel's wrapper with `use_kernels`, else the torch-op plan),
    with the `autograd_tables` terms and `extra_autograd(pos, box) ->
    {term: energy}` by autograd; the real-space pairs (`cell_kernel`'s
    neighbour path, else the dense pair kernel's wrapper or the torch-op
    pairs over `ffp.nb_mask`); the reciprocal term `recip`. Every stage
    maps (pos, box[, cl]) -> ({term: energy}, forces); `ef_one` sums them,
    the bonded forces added into the pair forces' buffer."""
    if use_kernels:
        plan = _ops_bonded.build_bonded_kernel_plan(ffp, config)

        def bonded_ef_one(pos, box, out=None):
            """Bonded terms; with `out`, their forces added into it
            (the kernel adds into the caller's buffer)."""
            if plan is None:
                return {}, torch.zeros_like(pos) if out is None else out
            return _ops_bonded.bonded_energy_forces(plan, pos, box, out=out)
    else:
        plan = _bonded.build_bonded_plan(ffp, config)

        def bonded_ef_one(pos, box, out=None):
            if plan is None:
                return {}, torch.zeros_like(pos) if out is None else out
            pot, frc = _bonded.bonded_energy_forces(ffp, plan, pos, box, config)
            return pot, frc if out is None else out + frc
    tables = autograd_tables(ffp, config.terms)
    if tables or extra_autograd is not None:
        def autograd_energy(pos, box):
            out = {} if extra_autograd is None else dict(extra_autograd(pos, box))
            for name, fn, table in tables:
                add_energy(out, name, fn(table, pos, box))
            return out

        bonded_ef_one = _with_autograd(bonded_ef_one, autograd_energy)

    nb = nb_rows = None
    kern = cell_kernel
    has_nb = any(t in config.terms for t in NONBONDED_TERMS)
    # the dense kernel path evaluates a ladder in one `ef_one` call
    # (`ef_batch`): both kernels take (R, N, 3) positions
    kernel_batch = use_kernels and kern is None
    if kern is not None:
        def nb(pos, box, cl):
            return kern.energy_forces(pos, box, cl)
    elif has_nb and ffp.nb_mask is not None:
        if use_kernels:
            nb_data = _ops_nonbonded.prepare_nb_data(ffp)

            def nb(pos, box, cl):
                return _ops_nonbonded.nonbonded_energy_forces(nb_data, config, pos, box)

            def nb_rows(pos, box, tiles):
                return _ops_nonbonded.nonbonded_energy_forces(nb_data, config, pos, box,
                                                              rows=tiles)
        else:
            def nb(pos, box, cl):
                return _potentials.nonbonded_energy_forces(ffp, pos, box, config)

            def nb_rows(pos, box, tiles):
                lo, hi = _ops_nonbonded.row_span(pos.shape[-2], tiles)
                return _potentials.rowblock_energy_forces(ffp, config, pos[lo:hi], pos,
                                                          box, lo)
    elif has_nb:
        kernel_batch = False

        def nb(pos, box, cl):
            raise RuntimeError(
                "the (N, N) exclusion mask is deferred for the cell path; "
                "build the cell kernel (ensure_cell_kernel) or the mask "
                "(require_nb_mask) first")
    rec = recip

    def pair_ef_one(pos, box, cl=None):
        """The real-space pair terms (with `cl`, a prebuilt neighbour
        structure, on the cell, column and Verlet paths)."""
        if kern is not None and cl is None:
            cl = kern.build(pos, box)
        return nb(pos, box, cl)

    @_each
    def recip_ef_one(pos, box, cl=None):
        """The reciprocal term (PME or the exact Ewald sum) as
        ({"electrostatics": e}, forces); the PME spread follows the
        neighbour structure's order of the atoms."""
        order = None if kern is None or cl is None else kern.spread_order(cl)
        er, ef = rec.energy_forces(pos, box, order_idx=order)
        return {"electrostatics": er}, ef

    def nb_ef_one(pos, box, cl=None):
        """Nonbonded pairs plus the reciprocal term."""
        if kern is not None and cl is None:
            cl = kern.build(pos, box)
        pot, frc = nb(pos, box, cl)
        if rec is not None:
            er, ef = recip_ef_one(pos, box, cl)
            pot = dict(pot)
            add_energy(pot, "electrostatics", er["electrostatics"])
            frc = frc + ef
        return pot, frc

    def ef_one(pos, box, cl=None):
        """All terms of one conformation: (per-term energies, forces).
        The bonded forces add into the nonbonded ones' buffer. On the
        dense kernel path also of R conformations (pos (R, N, 3), box
        (R, 3) or None): each kernel launches once for all of them, the
        other stages run per replica."""
        if nb is None:
            return bonded_ef_one(pos, box)
        nb_pot, frc = nb_ef_one(pos, box, cl)
        pot, frc = bonded_ef_one(pos, box, out=frc)
        pot = dict(pot)
        for k, v in nb_pot.items():
            add_energy(pot, k, v)
        return pot, frc

    return Evaluators(
        bonded_plan=plan, kernel_batch=kernel_batch, bonded_ef_one=bonded_ef_one,
        nb_ef_one=nb_ef_one if nb is not None else None,
        pair_ef_one=pair_ef_one if nb is not None else None,
        recip_ef_one=recip_ef_one if rec is not None else None, ef_one=ef_one,
        pair_rows_ef_one=nb_rows)


class Forces:
    bonded = list(BONDED_TERMS)
    nonbonded = list(NONBONDED_TERMS)
    terms = list(TERMS)

    def __init__(
        self,
        parameters,
        terms=None,
        external=None,
        cutoff=None,
        rfa=False,
        solventDielectric=78.5,
        switch_dist=None,
        exclusions=("bonds", "angles", "1-4"),
        precision=None,
        kernel="auto",
        nbfix=False,
        elec="auto",
        device=None,
        plain=False,
        gather=None,
        column=None,
    ):
        self.par = parameters
        if terms is None:
            raise RuntimeError(
                'Set force terms or leave empty brackets [].\nAvailable options: '
                '"bonds", "angles", "dihedrals", "impropers", "1-4", '
                '"electrostatics", "lj", "repulsion", "repulsioncg".'
            )
        self.energies = [t.lower() for t in terms]
        for t in self.energies:
            if t not in TERMS:
                raise ValueError(f"Force term {t} is not implemented.")
        if "1-4" in self.energies and "dihedrals" not in self.energies:
            raise RuntimeError(
                "You cannot enable 1-4 interactions without enabling dihedrals"
            )
        if elec not in ("auto", "ewald", "pme"):
            raise ValueError(f"Unknown elec mode: {elec}")
        if elec != "auto" and cutoff is None:
            raise ValueError(f"elec='{elec}' requires a cutoff")
        if kernel not in ("auto", "dense", "cell", "verlet"):
            raise ValueError(f"Unknown kernel: {kernel}")

        self.natoms = len(parameters.masses)
        self.external = external
        self.cutoff = cutoff
        self.rfa = rfa
        self.solventDielectric = solventDielectric
        self.switch_dist = switch_dist
        self.exclusions = exclusions
        self.kernel = kernel
        self.elec_mode = elec
        self.plain = bool(plain)
        self.pme_gather = gather
        if column not in (None, True, False):
            raise ValueError(f"column={column!r} (want None, True or False)")
        self.column = column
        self.device = resolve_device(device)
        self.dtype = torch_dtype(
            precision if precision is not None
            else getattr(parameters, "precision", None))

        def _amber(tbl):
            return bool(tbl is not None and len(tbl["params"]) and
                        np.all(np.asarray(tbl["params"])[:, 2] > 0))

        self.config = ForceTermConfig(
            terms=tuple(self.energies),
            cutoff=None if cutoff is None else float(cutoff),
            rfa=bool(rfa),
            solvent_dielectric=float(solventDielectric),
            switch_dist=None if switch_dist is None else float(switch_dist),
            dihedrals_amber=_amber(parameters.dihedral_params),
            impropers_amber=_amber(parameters.improper_params),
        )
        self.path = select_path(kernel, self.plain, self.device, self.dtype)
        self.use_kernels = self.path == "kernels"
        self.has_nb = any(t in self.energies for t in NONBONDED_TERMS)
        self.cell_requested = kernel == "cell" and self.has_nb
        self.cell_auto = (kernel == "auto" and self.has_nb
                          and self.natoms >= CELL_AUTO_N)
        self.verlet_requested = kernel == "verlet" and self.has_nb
        if self.verlet_requested and cutoff is None:
            raise ValueError("kernel='verlet' requires a cutoff")
        # the JAX package's automatic choice; `wants_verlet` defers to the
        # cell grid where one fits
        self.verlet_auto = (kernel == "auto" and self.has_nb and cutoff is not None
                            and self.natoms >= VERLET_AUTO_N)
        # the cell path and the binned Verlet build never read the dense
        # mask: defer it until a path that needs it asks (require_nb_mask)
        self._nb_mask_deferred = (self.cell_requested or self.cell_auto
                                  or self.verlet_requested or self.verlet_auto)
        # set by alchemy: the mask holds edits the exclusion table lacks
        self._nb_mask_authoritative = False
        self.ffparams = make_ffparams(parameters, exclusions, dtype=self.dtype,
                                      device=self.device, nbfix=nbfix,
                                      dense_mask=not self._nb_mask_deferred)
        self.vsites = None
        if getattr(parameters, "vsites", None):
            self.vsites = vsite_groups_to(parameters.vsites, self.device, self.dtype)
        self._ewald = None
        self._cell_kernel = None
        self.nb_path = None   # set by choose_nb_path
        self._build_evaluators()

    # ------------------------------------------------------------------
    def _build_evaluators(self):
        ev = build_evaluators(self.ffparams, self.config, self.use_kernels,
                              recip=self._ewald, cell_kernel=self._cell_kernel)
        self._bonded_plan = ev.bonded_plan
        self._kernel_batch = ev.kernel_batch
        self.bonded_ef_one = ev.bonded_ef_one
        self.nb_ef_one = ev.nb_ef_one
        self.pair_ef_one = ev.pair_ef_one
        self.recip_ef_one = ev.recip_ef_one
        # the dense path's row block: (pos (N, 3), box, (it0, it1)) ->
        # (energies, forces of the i tiles' rows) (parallel.spatial)
        self.pair_rows_ef_one = ev.pair_rows_ef_one
        ef_one = ev.ef_one
        # virtual sites: evaluate at the snapped geometry, spread the site
        # forces onto the hosts
        if self.vsites:
            ef_one = wrap_energy_forces(self.vsites, ef_one)
        if self.external is not None:
            ef_one = _with_external(ef_one, self.external)
        self.ef_one = ef_one

    def has_autograd_terms(self) -> bool:
        """True when a term rides on the bonded stage by autograd
        (`autograd_tables`)."""
        return bool(autograd_tables(self.ffparams, self.energies))

    def ef_batch(self, pos, boxes):
        """All terms of R conformations: (per-term energies (R,), forces
        (R, N, 3)). `boxes`: one (3,) tensor or None per replica (None: no
        PBC). On the dense kernel path, when the replicas all have a box or
        all have none, one `ef_one` call: the pair kernel and the bonded
        kernel launch once each for the whole ladder. Otherwise `ef_one`
        per replica."""
        nrep = pos.shape[0]
        nobox = [b is None for b in boxes]
        if self._kernel_batch and (all(nobox) or not any(nobox)):
            return self.ef_one(pos, None if nobox[0] else torch.stack(list(boxes)))
        return _stack_terms([self.ef_one(pos[r], boxes[r]) for r in range(nrep)])

    def replicated_ef(self):
        """The terms the spatially sharded path evaluates on every rank of
        a conformation, (pos, box, cl=None) -> (per-term energies,
        forces): the bonded terms, the reciprocal term (its PME spread in
        the order of `cl`) and the external (torchmd_tpu/integrator.py:
        2340-2365). The real-space pairs are the rank's row block or
        slab."""
        bonded, rec = self.bonded_ef_one, self.recip_ef_one

        def ef(pos, box, cl=None):
            pot, frc = bonded(pos, box)
            if rec is not None:
                er, fr = rec(pos, box, cl)
                pot = dict(pot)
                add_energy(pot, "electrostatics", er["electrostatics"])
                frc = frc + fr
            return pot, frc

        return ef if self.external is None else _with_external(ef, self.external)

    def mts_tiers(self, recip_tier=False):
        """The r-RESPA tiers of one conformation, each (pos, box[, cl]) ->
        (per-term energies, forces in a buffer of its own), as the JAX
        integrator composes them (torchmd_tpu/integrator.py:635-675,
        :966-1015):

          - fast(pos, box): the bonded terms (the bonded kernel with
            `out=None`, and the autograd terms);
          - slow(pos, box, cl): the real-space pairs through the
            neighbour structure `cl` (None on the dense path), the
            reciprocal term unless `recip_tier`, and the external;
          - recip(pos, box, cl): the reciprocal term alone (None without
            Ewald or PME); `cl` gives the PME spread its order.

        With virtual sites each tier evaluates at the snapped geometry and
        spreads its own site forces onto the hosts."""
        inner = self.pair_ef_one if recip_tier else self.nb_ef_one
        fast = self.bonded_ef_one

        def slow(pos, box, cl=None):
            if inner is None:
                return {}, torch.zeros_like(pos)
            return inner(pos, box, cl)

        recip = self.recip_ef_one if recip_tier else None
        if self.external is not None:
            slow = _with_external(slow, self.external)
        if self.vsites:
            fast, slow = (wrap_energy_forces(self.vsites, f) for f in (fast, slow))
            if recip is not None:
                recip = wrap_energy_forces(self.vsites, recip)
        return fast, slow, recip

    # ------------------------------------------------------------------
    def ensure_ewald(self, box, exact=None):
        """Build (once) the reciprocal term for a concrete box and switch
        the pair terms to erfc-damped real space: the exact Ewald sum
        (`EwaldRecip`) for elec='ewald' below PME_AUTO_N atoms, smooth PME
        (`PmeRecip`) otherwise. `exact` True or False picks the exact sum
        or PME at any size instead."""
        if self.elec_mode == "auto" or self._ewald is not None:
            return self._ewald
        from .ewald import EwaldRecip, PmeRecip

        box = np.asarray(box, np.float64).reshape(-1)[:3]
        excl = self.par.get_exclusions(types=self.exclusions)
        if exact is None:
            exact = self.elec_mode == "ewald" and self.natoms < PME_AUTO_N
        if exact:
            self._ewald = EwaldRecip(self.ffparams.charges, box, self.cutoff,
                                     excl_pairs=excl)
        else:
            self._ewald = PmeRecip(self.ffparams.charges, box, self.cutoff,
                                   excl_pairs=excl, gather=self.pme_gather,
                                   plain=not self.use_kernels)
        self.config = self.config._replace(ewald_alpha=self._ewald.cfg.alpha)
        if self._cell_kernel is not None:
            self._cell_kernel.cfg = self.config
        self._build_evaluators()
        return self._ewald

    def _grid_feasible(self, box) -> bool:
        """Can this concrete box host a 27-cell grid?"""
        if self.cutoff is None or box is None:
            return False
        b = np.asarray(box, dtype=np.float64).reshape(-1)[:3]
        rc = float(self.cutoff) + CELL_SKIN
        return bool(np.all(b > 0) and np.min(b) // rc >= 3)

    def wants_cell(self, box) -> bool:
        """True when evaluation runs on the cell-list path for this box:
        requested, or automatic for a large system whose box hosts a grid."""
        return self.cell_requested or (self.cell_auto and self._grid_feasible(box))

    def wants_verlet(self, box=None) -> bool:
        """True when evaluation runs on Verlet lists for this box (None: no
        box): requested, or automatic for a large system with a cutoff
        whose box hosts no cell grid (torchmd_tpu/forces.py:577-585)."""
        return self.verlet_requested or (self.verlet_auto and not self.wants_cell(box))

    def choose_nb_path(self, box_diag) -> str:
        """The neighbour path for an (R, 3) box (zeros: no box), recorded
        in `nb_path`: "cell" (the cell or column kernel), "verlet" or
        "dense". Resolves the automatic cell choice for this box and sets
        up the reciprocal term; `prepare` and the Integrator read it."""
        box_diag = np.asarray(box_diag, np.float64).reshape(-1, 3)
        box0 = box_diag[0]
        periodic = bool(np.any(box_diag != 0))
        if not periodic and (self.elec_mode != "auto" or self.cell_requested):
            raise ValueError("PME and the cell-list path need a periodic box")
        self.resolve_kernel_for_box(box0 if periodic else None)
        if periodic and self.elec_mode != "auto":
            self.ensure_ewald(box0)
        if periodic and self.wants_cell(box0):
            self.nb_path = "cell"
        elif self.wants_verlet(box0 if periodic else None):
            self.nb_path = "verlet"
        else:
            self.nb_path = "dense"
        return self.nb_path

    def ensure_verlet_kernel(self, box=None, pos0=None):
        """Build (once) the Verlet-list kernel into the neighbour-kernel
        slot; `pos0` sizes its capacity from the real occupancy. It builds
        by cells from the exclusion table where that applies (no box, or
        3 cells of cutoff + skin a side) and the mask holds no alchemical
        edit; otherwise over the dense mask, built here."""
        from .neighbors import VerletKernel, build_exclusion_table

        if not isinstance(self._cell_kernel, VerletKernel):
            b = None if box is None or not np.any(np.asarray(box) != 0) else box
            excl = None
            if not self._nb_mask_authoritative and (b is None or self._grid_feasible(b)):
                excl = build_exclusion_table(self.par, self.natoms, self.exclusions)
            else:
                self.require_nb_mask()
            self._cell_kernel = VerletKernel(self.ffparams, self.config, box=b,
                                             skin=CELL_SKIN, pos0=pos0, excl_table=excl)
            self._build_evaluators()
        return self._cell_kernel

    def resolve_kernel_for_box(self, box):
        """An automatic cell choice stands only while the box hosts a
        grid; otherwise Verlet lists take over where they are automatic
        (`verlet_auto`), else the dense path, which needs the mask."""
        if self.cell_auto and not self._grid_feasible(box):
            self.cell_auto = False
            if not self.verlet_auto:
                self.require_nb_mask()

    def require_nb_mask(self):
        """Materialize the deferred dense (natoms, natoms) exclusion mask
        and rebuild the evaluators."""
        if self._nb_mask_deferred:
            m = ~self.par.get_exclusions(types=self.exclusions, fullarray=True)
            np.fill_diagonal(m, False)
            self.ffparams = self.ffparams._replace(
                nb_mask=torch.as_tensor(m, device=self.device))
            self._nb_mask_deferred = False
            self._build_evaluators()
        return self.ffparams

    def wants_column(self, box) -> bool:
        """The column kernel rather than the cell kernel for this box (see
        `column` in the module docstring)."""
        from .columns import column_supported

        if self.column is False:
            return False
        supported = column_supported(
            self.config, self.ffparams, np.asarray(box, np.float64).reshape(-1)[:3],
            skin=CELL_SKIN)
        if self.column is True:
            if not supported:
                raise ValueError(
                    "column=True: the column kernel cannot serve this system (it "
                    "needs a 3x3 column grid, Lorentz-Berthelot LJ and one "
                    "LJ-family term)")
            return True
        return (supported and self.use_kernels and self.device.type == "cuda"
                and self.dtype == torch.float32)

    def ensure_cell_kernel(self, box, pos0=None, allow_column=True):
        """Build (once) the large-N neighbour kernel for a concrete box
        diagonal, the column or the cell kernel (`wants_column`); `pos0`
        sizes the capacities from the real occupancy. `allow_column=False`
        (the spatially sharded path, whose slabs are the cell kernel's)
        takes the cell kernel, replacing a column kernel built before."""
        from .neighbors import CellKernel

        if not allow_column and self._cell_kernel is not None and not isinstance(
                self._cell_kernel, CellKernel):
            self._cell_kernel = None
        if self._cell_kernel is None:
            box = np.asarray(box, np.float64).reshape(-1)[:3]
            Kernel = CellKernel
            if allow_column and self.wants_column(box):
                from .columns import ColumnKernel as Kernel
            self._cell_kernel = Kernel(
                self.ffparams, self.config, self.par, box, skin=CELL_SKIN,
                exclusions=self.exclusions, pos0=pos0, plain=not self.use_kernels)
            self._build_evaluators()
        return self._cell_kernel

    def set_cell_kernel(self, kern):
        """Swap in a grown or reboxed cell or column kernel."""
        self._cell_kernel = kern
        self._build_evaluators()

    def prepare(self, pos, box_diag):
        """Resolve the box-dependent parts for (R, N, 3) positions and an
        (R, 3) box (zeros: no box): the neighbour path (`choose_nb_path`),
        the reciprocal term, the neighbour kernel, and a capacity that
        holds every replica (grown until it does)."""
        box_diag = np.asarray(box_diag, np.float64)
        box0 = box_diag[0]
        path = self.choose_nb_path(box_diag)
        if path == "dense":
            return
        if path == "verlet" and not np.any(box_diag != 0):
            kern = self.ensure_verlet_kernel(None, pos0=to_numpy(pos[0]))
            box_t = None
        else:
            if not np.allclose(box_diag, box0):
                raise ValueError("the neighbour-list paths require equal replica boxes")
            if path == "cell":
                kern = self.ensure_cell_kernel(box0, pos0=to_numpy(pos[0]))
                if not kern.covers(box_diag):
                    kern = kern.with_box(np.min(box_diag, axis=0), pos0=to_numpy(pos[0]))
            else:
                kern = self.ensure_verlet_kernel(box0, pos0=to_numpy(pos[0]))
                if not kern.covers(box_diag):
                    # the box left the binned build's grid: a new kernel
                    self._cell_kernel = None
                    kern = self.ensure_verlet_kernel(np.min(box_diag, axis=0),
                                                     pos0=to_numpy(pos[0]))
            box_t = torch.as_tensor(box0, dtype=self.dtype, device=self.device)
        for _ in range(4):
            if not any(bool(kern.build(p, box_t).overflow) for p in pos):
                break
            kern = kern.grow()
        else:
            raise RuntimeError(f"{kern.capacity_name} kept overflowing")
        if kern is not self._cell_kernel:
            self.set_cell_kernel(kern)

    def prepare_rows(self, box_diag):
        """`prepare` for the spatially sharded row block: the reciprocal
        term, and the dense pair kernel's row range (`pair_rows_ef_one`)
        over the dense mask. A Verlet kernel gives way to it: the JAX
        package's spatial scan evaluates the row block on the Verlet path
        too (torchmd_tpu/integrator.py:448-470)."""
        if self.choose_nb_path(box_diag) == "cell":
            raise ValueError("prepare_rows: the cell path's slabs use prepare")
        if self._cell_kernel is not None:
            self.set_cell_kernel(None)
        if self.has_nb:
            self.require_nb_mask()

    # ------------------------------------------------------------------
    def compute(
        self,
        pos,
        box,
        forces=None,
        returnDetails=False,
        explicit_forces=True,
        toNumpy=True,
        calculateForces=True,
    ):
        """Evaluate potentials (and forces) for a batch of replicas.

        pos: (nreplicas, natoms, 3); box: (nreplicas, 3, 3) or (nreplicas, 3).
        If `forces` is a numpy array it is filled in place (reference
        in-place semantics); the forces are also kept in `self.last_forces`.
        """
        pos_t = torch.as_tensor(pos if isinstance(pos, torch.Tensor)
                                else np.asarray(pos),
                                dtype=self.dtype, device=self.device)
        nreplicas = pos_t.shape[0]
        box_np = _box_to_diag(box, nreplicas)
        self.prepare(pos_t, box_np)
        # an all-zero box is no PBC: the wrap is left out
        boxes = [torch.as_tensor(box_np[r], dtype=self.dtype, device=self.device)
                 if np.any(box_np[r] != 0) else None for r in range(nreplicas)]
        with torch.no_grad():
            pot, frc = self.ef_batch(pos_t, boxes)
        keys = list(pot.keys())
        if "external" not in keys:
            keys.append("external")
            pot["external"] = torch.zeros(nreplicas, dtype=self.dtype, device=self.device)

        if calculateForces:
            self.last_forces = frc
            if isinstance(forces, np.ndarray):
                forces[:] = frc.cpu().numpy().astype(forces.dtype)

        if returnDetails:
            if toNumpy:
                host = {k: v.cpu().numpy() for k, v in pot.items()}
                return [{k: float(host[k][i]) for k in keys}
                        for i in range(nreplicas)]
            return [{k: pot[k][i] for k in keys} for i in range(nreplicas)]
        total = sum(pot[k] for k in keys)
        if toNumpy:
            return [float(x) for x in total.cpu().numpy()]
        return total
