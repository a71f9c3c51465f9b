"""User-facing force/energy evaluator.

`Forces` keeps the reference class surface (torchmd/forces.py:7-346) as the
JAX package does: the same constructor arguments, the same
`compute(pos, box, forces, returnDetails, explicit_forces, toNumpy,
calculateForces)` signature and return shapes, and the split into
`bonded_ef_one` / `nb_ef_one` / `ef_one` evaluators of one conformation.

The path follows the device. With `kernel="auto"` the evaluators call the
kernel wrappers of `torchmd_tpu_torch.ops`: on a CUDA device they launch
the hand-written pair and bonded kernels (f32), on the CPU they run the
kernels' plain PyTorch versions. `kernel="dense"` selects the torch-op
path on any device: analytic dense nonbonded (`potentials`) and analytic
bonded (`bonded`), the counterpart of the JAX package's fused jnp path.
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
    compute_potentials,
    make_ffparams,
)
from .systems import to_numpy, torch_dtype


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
        if elec in ("ewald", "pme"):
            raise NotImplementedError(
                f"elec='{elec}' is not ported yet (Ewald/PME come with "
                "slice 3 of the port)")
        if elec != "auto":
            raise ValueError(f"Unknown elec mode: {elec}")
        if kernel in ("cell", "verlet"):
            raise NotImplementedError(
                f"kernel='{kernel}' is not ported yet (neighbour-list kernels "
                "come with slice 3 of the port)")
        if kernel not in ("auto", "dense"):
            raise ValueError(f"Unknown kernel: {kernel}")
        if getattr(parameters, "vsites", None):
            raise NotImplementedError(
                "virtual sites are not ported yet (vsites.py comes with "
                "slice 3 of the port)")

        self.natoms = len(parameters.masses)
        self.external = external
        self.cutoff = cutoff
        self.rfa = rfa
        self.solventDielectric = solventDielectric
        self.switch_dist = switch_dist
        self.exclusions = exclusions
        self.kernel = kernel
        self.device = torch.device(
            device if device is not None
            else getattr(parameters, "device", None) or "cpu")
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
        self.use_kernels = kernel == "auto"
        if self.use_kernels and self.device.type == "cuda":
            if self.dtype != torch.float32:
                raise ValueError(
                    "the CUDA kernels run in single precision; use "
                    "precision='single' or kernel='dense'")
            if not _ops_nonbonded.supported_terms(self.config):
                raise NotImplementedError(
                    "the pair kernel takes one of lj/repulsion/repulsioncg "
                    "at a time; use kernel='dense'")
        self.ffparams = make_ffparams(parameters, exclusions, dtype=self.dtype,
                                      device=self.device, nbfix=nbfix)
        ffp = self.ffparams
        if (("bonds" in self.energies and ffp.bonds_g96 is not None)
                or ("angles" in self.energies and ffp.angles_g96 is not None)):
            raise NotImplementedError(
                "GROMOS-96 bonded forms are not ported to the Forces path yet")
        self._build_evaluators()

    def _build_evaluators(self):
        ffp, config = self.ffparams, self.config
        has_nb = (any(t in self.energies for t in NONBONDED_TERMS)
                  and ffp.nb_mask is not None)
        if self.use_kernels:
            plan = _ops_bonded.build_bonded_kernel_plan(ffp, config)
            nb_data = _ops_nonbonded.prepare_nb_data(ffp) if has_nb else None
            self._bonded_plan, self._nb_data = plan, nb_data

            def bonded_ef_one(pos, box):
                if plan is None:
                    return {}, torch.zeros_like(pos)
                return _ops_bonded.bonded_energy_forces(plan, pos, box)

            def nb_ef_one(pos, box):
                return _ops_nonbonded.nonbonded_energy_forces(
                    nb_data, config, pos, box)
        else:
            plan = _bonded.build_bonded_plan(ffp, config)
            self._bonded_plan, self._nb_data = plan, None

            def bonded_ef_one(pos, box):
                if plan is None:
                    return {}, torch.zeros_like(pos)
                return _bonded.bonded_energy_forces(ffp, plan, pos, box, config)

            def nb_ef_one(pos, box):
                return _potentials.nonbonded_energy_forces(ffp, pos, box, config)

        self.bonded_ef_one = bonded_ef_one
        self.nb_ef_one = nb_ef_one if has_nb else None
        if has_nb:
            def ef_one(pos, box):
                pot, frc = bonded_ef_one(pos, box)
                nb_pot, nb_frc = nb_ef_one(pos, box)
                pot = dict(pot)
                for k, v in nb_pot.items():
                    add_energy(pot, k, v)
                return pot, frc + nb_frc
        else:
            ef_one = bonded_ef_one
        self.ef_one = ef_one

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
        pots, frcs = [], []
        for r in range(nreplicas):
            # an all-zero box is no PBC: the wrap is left out
            b = (torch.as_tensor(box_np[r], dtype=self.dtype, device=self.device)
                 if np.any(box_np[r] != 0) else None)
            if calculateForces:
                pot, frc = self.ef_one(pos_t[r], b)
                frcs.append(frc)
            else:
                with torch.no_grad():
                    pot = compute_potentials(self.ffparams, pos_t[r], b,
                                             self.config)
            pots.append(pot)
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

