"""User-facing force/energy evaluator.

`Forces` keeps the reference class surface (torchmd/forces.py:7-346) as the
JAX package does: the same constructor arguments, the same
`compute(pos, box, forces, returnDetails, explicit_forces, toNumpy,
calculateForces)` signature and return shapes, and the split into
`bonded_ef_one` / `nb_ef_one` / `ef_one` evaluators of one conformation.

The path follows the device:

  - `kernel="auto"` calls the kernel wrappers of `torchmd_tpu_torch.ops`:
    on a CUDA device they launch the hand-written kernels (f32), on the
    CPU they run the kernels' plain PyTorch versions. Periodic systems of
    at least CELL_AUTO_N atoms whose box hosts a 27-cell grid take the
    cell-list path (`neighbors.CellKernel`, the cell kernel); others the
    dense pair kernel;
  - `kernel="cell"` asks for the cell-list path;
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
    (the f64 reference path on the card).

`gather` picks the PME force gather ("ik" or "exact", `ewald.PmeRecip`;
default ik for CUDA f32, exact otherwise).

`elec="pme"`, and `elec="ewald"` at PME_AUTO_N atoms or more, add smooth
PME (`ewald.PmeRecip`) with erfc-damped real-space pairs. Virtual sites
(`parameters.vsites`) wrap every path: evaluation at the reconstructed
site geometry, site forces spread onto the hosts. On the cell path the
dense (natoms, natoms) exclusion mask is never built (3.9 GB at 62,500
atoms).
"""

from __future__ import annotations

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
from .systems import resolve_device, to_numpy, torch_dtype
from .vsites import vsite_groups_to, wrap_energy_forces

# Size thresholds of the automatic choices. Provisional: the JAX package's
# values, tuned on a TPU; not yet measured on the H100.
CELL_AUTO_N = 12000   # kernel="auto": cell-list path from this many atoms
PME_AUTO_N = 4096     # elec="ewald": PME from this many atoms
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
        if external is not None:
            raise NotImplementedError(
                "external potentials are not ported yet (external.py comes "
                "with a later slice of the port)")
        if elec not in ("auto", "ewald", "pme"):
            raise ValueError(f"Unknown elec mode: {elec}")
        if elec != "auto" and cutoff is None:
            raise ValueError(f"elec='{elec}' requires a cutoff")
        if kernel == "verlet":
            raise NotImplementedError(
                "kernel='verlet' is not ported yet (Verlet lists come with a "
                "later slice of the port)")
        if kernel not in ("auto", "dense", "cell"):
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
        self.use_kernels = kernel != "dense" and not self.plain
        if self.use_kernels and self.device.type == "cuda":
            if self.dtype != torch.float32:
                raise ValueError(
                    "the CUDA kernels run in single precision; use "
                    "precision='single', kernel='dense' or plain=True")
        self.has_nb = any(t in self.energies for t in NONBONDED_TERMS)
        self.cell_requested = kernel == "cell" and self.has_nb
        self.cell_auto = (kernel == "auto" and self.has_nb
                          and self.natoms >= CELL_AUTO_N)
        # the cell path never reads the dense mask: defer it until a path
        # that needs it asks (require_nb_mask)
        self._nb_mask_deferred = self.cell_requested or self.cell_auto
        self.ffparams = make_ffparams(parameters, exclusions, dtype=self.dtype,
                                      device=self.device, nbfix=nbfix,
                                      dense_mask=not self._nb_mask_deferred)
        ffp = self.ffparams
        if (("bonds" in self.energies and ffp.bonds_g96 is not None)
                or ("angles" in self.energies and ffp.angles_g96 is not None)):
            raise NotImplementedError(
                "GROMOS-96 bonded forms are not ported to the Forces path yet")
        self.vsites = None
        if getattr(parameters, "vsites", None):
            self.vsites = vsite_groups_to(parameters.vsites, self.device, self.dtype)
        self._ewald = None
        self._cell_kernel = None
        self._build_evaluators()

    # ------------------------------------------------------------------
    def _build_evaluators(self):
        ffp, config = self.ffparams, self.config
        if self.use_kernels:
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
        self._bonded_plan = plan

        nb = None
        kern = self._cell_kernel
        if kern is not None:
            def nb(pos, box, cl):
                return kern.energy_forces(pos, box, cl)
        elif self.has_nb and ffp.nb_mask is not None:
            if self.use_kernels:
                nb_data = _ops_nonbonded.prepare_nb_data(ffp)

                def nb(pos, box, cl):
                    return _ops_nonbonded.nonbonded_energy_forces(
                        nb_data, config, pos, box)
            else:
                def nb(pos, box, cl):
                    return _potentials.nonbonded_energy_forces(ffp, pos, box, config)
        elif self.has_nb:
            def nb(pos, box, cl):
                raise RuntimeError(
                    "the (N, N) exclusion mask is deferred for the cell path; "
                    "build the cell kernel (ensure_cell_kernel) or the mask "
                    "(require_nb_mask) first")
        rec = self._ewald

        def nb_ef_one(pos, box, cl=None):
            """Nonbonded pairs (with `cl`, a prebuilt cell list, on the
            cell path) plus the PME reciprocal term, whose spread follows
            the neighbour structure's order of the atoms."""
            if kern is not None and cl is None:
                cl = kern.build(pos, box)
            pot, frc = nb(pos, box, cl)
            if rec is not None:
                er, ef = rec.energy_forces(
                    pos, box, order_idx=None if kern is None else kern.spread_order(cl))
                pot = dict(pot)
                add_energy(pot, "electrostatics", er)
                frc = frc + ef
            return pot, frc

        def ef_one(pos, box, cl=None):
            """All terms of one conformation: (per-term energies, forces).
            The bonded forces add into the nonbonded ones' buffer."""
            if nb is None:
                return bonded_ef_one(pos, box)
            nb_pot, frc = nb_ef_one(pos, box, cl)
            pot, frc = bonded_ef_one(pos, box, out=frc)
            pot = dict(pot)
            for k, v in nb_pot.items():
                add_energy(pot, k, v)
            return pot, frc

        self.bonded_ef_one = bonded_ef_one
        self.nb_ef_one = nb_ef_one if nb is not None else None
        # virtual sites: evaluate at the snapped geometry, spread the site
        # forces onto the hosts
        self.ef_one = wrap_energy_forces(self.vsites, ef_one) if self.vsites else ef_one

    # ------------------------------------------------------------------
    def ensure_ewald(self, box):
        """Build (once) the PME reciprocal term for a concrete box and
        switch the pair terms to erfc-damped real space. elec='ewald'
        below PME_AUTO_N atoms would take the exact Ewald sum, which is
        not ported yet."""
        if self.elec_mode == "auto" or self._ewald is not None:
            return self._ewald
        if self.elec_mode == "ewald" and self.natoms < PME_AUTO_N:
            raise NotImplementedError(
                f"elec='ewald' below {PME_AUTO_N} atoms takes the exact Ewald "
                "sum (EwaldRecip), which is not ported yet; use elec='pme'")
        from .ewald import PmeRecip

        self._ewald = PmeRecip(
            self.ffparams.charges, np.asarray(box, np.float64).reshape(-1)[:3],
            self.cutoff, excl_pairs=self.par.get_exclusions(types=self.exclusions),
            gather=self.pme_gather, plain=not self.use_kernels)
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

    def resolve_kernel_for_box(self, box):
        """An automatic cell choice stands only while the box hosts a
        grid; otherwise the dense path takes over and needs the mask."""
        if self.cell_auto and not self._grid_feasible(box):
            self.cell_auto = False
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

    def ensure_cell_kernel(self, box, pos0=None):
        """Build (once) the large-N neighbour kernel for a concrete box
        diagonal, the column or the cell kernel (`wants_column`); `pos0`
        sizes the capacities from the real occupancy."""
        if self._cell_kernel is None:
            box = np.asarray(box, np.float64).reshape(-1)[:3]
            if self.wants_column(box):
                from .columns import ColumnKernel as Kernel
            else:
                from .neighbors import CellKernel as Kernel
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
        (R, 3) box: the dense/cell choice, PME, the cell kernel, and a
        cell capacity that holds every replica (grown until it does)."""
        box0 = np.asarray(box_diag, np.float64)[0]
        self.resolve_kernel_for_box(box0)
        if self.elec_mode != "auto":
            self.ensure_ewald(box0)
        if not self.wants_cell(box0):
            return
        if not np.allclose(box_diag, box0):
            raise ValueError("the cell-list path requires equal replica boxes")
        kern = self.ensure_cell_kernel(box0, pos0=to_numpy(pos[0]))
        if not kern.covers(box_diag):
            kern = kern.with_box(np.min(box_diag, axis=0), pos0=to_numpy(pos[0]))
        box_t = torch.as_tensor(box0, dtype=self.dtype, device=self.device)
        for _ in range(4):
            if not any(bool(kern.build(p, box_t).overflow) for p in pos):
                break
            kern = kern.grow()
        else:
            raise RuntimeError("cell list capacity kept overflowing")
        if kern is not self._cell_kernel:
            self.set_cell_kernel(kern)

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
        if np.any(box_np != 0):
            self.prepare(pos_t, box_np)
        elif self.elec_mode != "auto" or self.cell_requested:
            raise ValueError("PME and the cell-list path need a periodic box")
        pots, frcs = [], []
        with torch.no_grad():
            for r in range(nreplicas):
                # an all-zero box is no PBC: the wrap is left out
                b = (torch.as_tensor(box_np[r], dtype=self.dtype, device=self.device)
                     if np.any(box_np[r] != 0) else None)
                pot, frc = self.ef_one(pos_t[r], b)
                pots.append(pot)
                frcs.append(frc)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        keys = list(pots[0].keys()) + ["external"]
        pot = {k: torch.stack([p.get(k, zero) for p in pots]) for k in keys}

        if calculateForces:
            frc = torch.stack(frcs)
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
