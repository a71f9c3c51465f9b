"""Trajectory analysis: RMSD (Kabsch), RDF, MSD, group interaction
energies and normal modes, the port of `torchmd_tpu.analysis`.

RDF and MSD run as batched torch ops on the card unless given
`device="cpu"`; the 3x3 Kabsch fits and RMSD run in numpy float64, as in
the JAX package. Trajectories come in the run loop's save layout
(natoms, 3, nframes) or frame-major (nframes, natoms, 3).

`normal_modes` takes the Hessian of the torch-op path's total energy
(`potentials.compute_potentials`, the reciprocal term, the external's
`energy_fn`): the CUDA kernels have no backward pass, and the JAX
package likewise differentiates its jnp energy.
"""

from __future__ import annotations

import numpy as np
import torch

from .systems import resolve_device, to_numpy

__all__ = ["kabsch_rotation", "rmsd", "rdf", "msd", "interaction_energies",
           "normal_modes", "main"]


def _frames(traj) -> np.ndarray:
    """(nframes, natoms, 3) from either storage layout."""
    traj = to_numpy(traj)
    if traj.ndim == 2:
        traj = traj[None]
    if traj.shape[-1] == 3:
        return traj
    if traj.shape[1] == 3:
        return np.transpose(traj, (2, 0, 1))
    raise ValueError(f"Unrecognized trajectory shape {traj.shape}")


def kabsch_rotation(P, Q, weights=None):
    """Optimal rotation aligning P onto Q (both centred, (N, 3)), by SVD
    with the determinant correction for proper rotations, in numpy
    float64."""
    P = np.asarray(P, np.float64)
    Q = np.asarray(Q, np.float64)
    w = (np.ones((P.shape[0], 1)) if weights is None
         else np.asarray(weights, np.float64).reshape(-1, 1))
    H = (w * P).T @ Q
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    return Vt.T @ np.diag([1.0, 1.0, d]) @ U.T


def rmsd(traj, ref=None, weights=None, align=True, sel=None):
    """Per-frame RMSD (Angstrom) to `ref` (default: the first frame);
    align=True removes the best rigid-body fit per frame (Kabsch);
    `weights` weight the fit and the RMSD; `sel` selects atoms. numpy
    float64."""
    F = _frames(traj).astype(np.float64)
    if sel is not None:
        F = F[:, np.asarray(sel)]
    if ref is None:
        ref = F[0]
    else:
        ref = _frames(ref).astype(np.float64)[0]
        if sel is not None:
            ref = ref[np.asarray(sel)]
    w = (np.ones((F.shape[1], 1)) if weights is None
         else np.asarray(weights, np.float64).reshape(-1, 1))
    wsum = w.sum()
    refc = ref - (w * ref).sum(0) / wsum
    out = []
    for frame in F:
        p = frame - (w * frame).sum(0) / wsum
        if align:
            p = p @ kabsch_rotation(p, refc, w[:, 0]).T
        out.append(np.sqrt(((w * (p - refc) ** 2).sum()) / wsum))
    return np.asarray(out)


def rdf(traj, box, r_max=None, nbins=100, sel_a=None, sel_b=None, device=None):
    """Radial distribution function g(r) averaged over frames.

    box: (3,) rectangular box diagonal (minimum image applied); sel_a /
    sel_b: index selections for partial RDFs (defaults: all atoms).
    Returns (r centres, g) numpy arrays. f64 throughout."""
    dev, dtype = resolve_device(device), torch.float64
    F = torch.as_tensor(_frames(traj), dtype=dtype, device=dev)
    box_np = np.asarray(box, np.float64).reshape(-1)[:3]
    box_t = torch.as_tensor(box_np, dtype=dtype, device=dev)
    if r_max is None:
        r_max = float(np.min(box_np)) / 2.0
    a = np.arange(F.shape[1]) if sel_a is None else np.asarray(sel_a)
    b = np.arange(F.shape[1]) if sel_b is None else np.asarray(sel_b)
    # identical-atom pairs never count, also for overlapping selections
    self_pair = a[:, None] == b[None, :]
    nself = int(self_pair.sum())
    self_t = torch.as_tensor(self_pair, device=dev)
    edges = torch.linspace(0.0, r_max, nbins + 1, dtype=dtype, device=dev)
    ia, ib = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    hist = torch.zeros(nbins + 1, dtype=dtype, device=dev)
    for frame in F:
        dv = frame[ia][:, None, :] - frame[ib][None, :, :]
        dv = dv - box_t * torch.round(dv / box_t)
        d = torch.sqrt((dv * dv).sum(-1))
        d = torch.where(self_t, torch.full_like(d, 2.0 * r_max), d).reshape(-1)
        # numpy's bins: [e_k, e_k+1), the last one closed; others to the
        # spare bin nbins
        k = torch.bucketize(d, edges, right=True) - 1
        k = torch.where(d == edges[-1], torch.full_like(k, nbins - 1), k)
        k = torch.where((k < 0) | (k >= nbins), torch.full_like(k, nbins), k)
        hist.index_add_(0, k, torch.ones_like(d))
    hist = hist[:nbins].cpu().numpy()
    e = edges.cpu().numpy()
    vol = float(np.prod(box_np))
    shell = (4.0 / 3.0) * np.pi * (e[1:] ** 3 - e[:-1] ** 3)
    ideal = (len(a) * len(b) - nself) / vol * shell * F.shape[0]
    return 0.5 * (e[1:] + e[:-1]), hist / np.maximum(ideal, 1e-12)


def msd(traj, sel=None, device=None):
    """Mean-squared displacement against frame lag 0..F-1 (a direct
    average over the frame pairs of each lag), f64."""
    F = torch.as_tensor(_frames(traj), dtype=torch.float64, device=resolve_device(device))
    if sel is not None:
        F = F[:, torch.as_tensor(np.asarray(sel), device=F.device)]
    nf = F.shape[0]
    out = torch.stack([((F[lag:] - F[:nf - lag]) ** 2).sum(-1).mean() for lag in range(nf)])
    return out.cpu().numpy()


def interaction_energies(forces, pos, box=None, sel_a=None, sel_b=None):
    """Nonbonded interaction energy between two atom groups (GROMACS
    "energygrps"): the force field's masked dense nonbonded terms over the
    pairs with one atom in `sel_a` and the other in `sel_b` (default: the
    complement of sel_a), exclusions applied. Returns {term: kcal/mol}."""
    from .potentials import nonbonded_energies

    ffp = forces.ffparams
    if ffp.nb_mask is None and getattr(forces, "_nb_mask_deferred", False):
        ffp = forces.require_nb_mask()
    if ffp.nb_mask is None:
        raise ValueError("forces has no nonbonded terms")
    if sel_a is None:
        raise ValueError("sel_a (the first atom group) is required")
    n = int(ffp.charges.shape[0])
    in_a = np.zeros(n, bool)
    in_a[np.asarray(sel_a, dtype=np.int64)] = True
    if sel_b is None:
        in_b = ~in_a
    else:
        in_b = np.zeros(n, bool)
        in_b[np.asarray(sel_b, dtype=np.int64)] = True
    cross = (in_a[:, None] & in_b[None, :]) | (in_b[:, None] & in_a[None, :])
    mask = ffp.nb_mask.bool() & torch.as_tensor(cross, device=ffp.nb_mask.device)
    p = torch.as_tensor(to_numpy(pos), dtype=forces.dtype, device=forces.device)
    if p.ndim == 3:
        p = p[:, :, 0]
    box_t = None if box is None else torch.as_tensor(
        np.asarray(box, np.float64).reshape(-1)[:3], dtype=forces.dtype, device=forces.device)
    if getattr(forces, "vsites", None):
        from .vsites import apply_vsites

        p = apply_vsites(forces.vsites, p, box_t)
    with torch.no_grad():
        out = nonbonded_energies(ffp._replace(nb_mask=mask), p, box_t, forces.config)
    return {k: float(v) for k, v in out.items()}


def normal_modes(forces, pos, box=None):
    """Harmonic normal modes at a (minimised) geometry: the mass-weighted
    Hessian of the total potential (every term, the reciprocal term and
    an external with `energy_fn`) by autograd. Use precision="double".

    Returns (wavenumbers in cm^-1 ascending, negative for imaginary
    modes; the mass-weighted eigenvectors as (3N, natoms, 3) displacement
    fields)."""
    from .potentials import compute_potentials

    dtype, dev = forces.dtype, forces.device
    p0 = torch.as_tensor(to_numpy(pos), dtype=dtype, device=dev)
    box_t = None if box is None else torch.as_tensor(
        np.asarray(box, np.float64).reshape(-1)[:3], dtype=dtype, device=dev)
    ffp, cfg = forces.ffparams, forces.config
    ext_fn = getattr(getattr(forces, "external", None), "energy_fn", None)
    vsg = getattr(forces, "vsites", None)
    rec = getattr(forces, "_ewald", None)

    def etot(p):
        if vsg:
            from .vsites import apply_vsites

            p = apply_vsites(vsg, p, box_t)
        e = sum(compute_potentials(ffp, p, box_t, cfg).values())
        if rec is not None:
            e = e + rec.energy(p, box_t)
        if ext_fn is not None:
            e = e + ext_fn(p, torch.zeros(3, dtype=dtype, device=dev) if box_t is None
                           else box_t)
        return e

    n = p0.shape[0]
    H = torch.autograd.functional.hessian(etot, p0).reshape(3 * n, 3 * n)
    masses = np.asarray(forces.par.masses, dtype=np.float64).reshape(-1)
    # massless rows (virtual sites) carry no dynamics: zero inverse weight
    inv_sqrt_m = np.where(masses > 0, 1.0 / np.sqrt(np.maximum(masses, 1e-30)), 0.0)
    w = np.repeat(inv_sqrt_m, 3)
    Hw = H.detach().cpu().numpy().astype(np.float64) * w[:, None] * w[None, :]
    Hw = 0.5 * (Hw + Hw.T)
    evals, evecs = np.linalg.eigh(Hw)
    # kcal/mol/A^2/amu -> cm^-1
    factor = np.sqrt(4184.0 / 1e-23) / (2.0 * np.pi * 2.99792458e10)
    nu = np.sign(evals) * factor * np.sqrt(np.abs(evals))
    return nu, (evecs.T * w[None, :]).reshape(3 * n, n, 3)


def main(argv=None):
    """Post-process a run directory: monitor plots (pandas, matplotlib)
    and/or structural observables (--rmsd/--rdf/--msd) over a saved
    trajectory."""
    import argparse
    import glob
    import os

    ap = argparse.ArgumentParser(prog="python -m torchmd_tpu_torch.analysis")
    ap.add_argument("log_dir")
    ap.add_argument("--out", default=None, help="Write a monitor PNG instead of showing")
    ap.add_argument("--traj", default=None,
                    help="Trajectory (.npy, .xtc, .dcd, .trr) inside log_dir")
    ap.add_argument("--rmsd", default=None, help="Write per-frame RMSD CSV")
    ap.add_argument("--rdf", default=None, help="Write g(r) CSV (needs --box)")
    ap.add_argument("--msd", default=None, help="Write MSD-vs-lag CSV")
    ap.add_argument("--box", type=float, nargs="+", default=None,
                    help="Box diagonal (1 or 3 values) for the RDF")
    ap.add_argument("--rdf-bins", type=int, default=100)
    ap.add_argument("--view", default=None,
                    help="Render the last frame to this PNG (not ported: raises)")
    ap.add_argument("--device", default=None,
                    help="Device of the RDF and MSD (default the CUDA card; "
                         "cpu for the CPU)")
    args = ap.parse_args(argv)

    if args.traj is not None:
        path = os.path.join(args.log_dir, args.traj)
        if not os.path.exists(path) and os.path.exists(args.traj):
            path = args.traj
        ext = os.path.splitext(path)[-1].lower()
        if ext == ".npy":
            traj = np.load(path)
        elif ext == ".xtc":
            from .io.xtc import read_xtc

            traj = read_xtc(path)["coords"]
        elif ext == ".dcd":
            from .io.dcd import read_dcd

            traj = read_dcd(path)["coords"]
        elif ext == ".trr":
            from .io.trr import read_trr

            traj = read_trr(path)["coords"]
        else:
            raise SystemExit(f"unsupported trajectory format: {path}")
        if args.view:
            raise NotImplementedError(
                "--view: the frame renderer (viz.py) is not ported yet; see ROADMAP.md")
        if args.rmsd:
            vals = rmsd(traj)
            np.savetxt(args.rmsd, np.column_stack([np.arange(len(vals)), vals]),
                       delimiter=",", header="frame,rmsd", comments="")
            print("wrote", args.rmsd)
        if args.rdf:
            if args.box is None:
                raise SystemExit("--rdf needs --box")
            b = args.box * 3 if len(args.box) == 1 else args.box
            r, g = rdf(traj, b, nbins=args.rdf_bins, device=args.device)
            np.savetxt(args.rdf, np.column_stack([r, g]), delimiter=",", header="r,g",
                       comments="")
            print("wrote", args.rdf)
        if args.msd:
            vals = msd(traj, device=args.device)
            np.savetxt(args.msd, np.column_stack([np.arange(len(vals)), vals]),
                       delimiter=",", header="lag,msd", comments="")
            print("wrote", args.msd)
        if not (args.rmsd or args.rdf or args.msd):
            raise SystemExit("--traj given but no analysis selected")
        return

    import matplotlib
    import pandas as pd

    files = sorted(glob.glob(os.path.join(args.log_dir, "monitor_*.csv")))
    if not files:
        raise SystemExit(f"No monitor_*.csv files in {args.log_dir}")
    if args.out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 1, figsize=(8, 7), sharex=True)
    for f in files:
        df = pd.read_csv(f, comment="#")
        label = os.path.basename(f).replace("monitor_", "r").replace(".csv", "")
        axes[0].plot(df["ns"], df["epot"], label=f"{label} epot", alpha=0.8)
        axes[0].plot(df["ns"], df["ekin"], label=f"{label} ekin", alpha=0.8)
        axes[0].plot(df["ns"], df["etot"], label=f"{label} etot", alpha=0.8)
        axes[1].plot(df["ns"], df["T"], label=label, alpha=0.8)
    axes[0].set_ylabel("energy (kcal/mol)")
    axes[0].legend(fontsize=7)
    axes[1].set_ylabel("T (K)")
    axes[1].set_xlabel("time (ns)")
    axes[1].legend(fontsize=7)
    fig.tight_layout()
    if args.out:
        fig.savefig(args.out, dpi=120)
        print("wrote", args.out)
    else:
        plt.show()


if __name__ == "__main__":
    main()
