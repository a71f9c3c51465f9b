"""Where the time of one halo pair-stage call goes, on the card.

`chip_smoke.py`'s halo phase times `ops.halo.halo_energy_forces` as a
whole. This script takes the phase's one-rank rows (the ACEMD alanine
dipeptide box tiled 4 x 4 x 4, 44,032 atoms, cutoff 9 A, Ewald real
space, `HaloMD.pair_inputs()` at the start on a mesh of one rank) and
splits a call:

  - `call_ms`: the whole call, CUDA events behind a sleep kernel
    (`roofline.device_ms`, median of `--calls`);
  - from `torch.profiler` over `--calls` calls (`chip_smoke._device_ops`):
    each device operation's microseconds and count a call, summed into
    `chip_smoke.halo_kernel_class`'s parts (`walk`, `finish`, `prep`:
    csrc/halo.cu's other kernels and memsets, `other`: torch ops), and
    `kernels_per_call`, the device operations of one call;
  - `call_ms_excl<k>` with `--excl-cols k`: the same call with the
    exclusion table cut to its first k columns. Not a correct result: it
    prices the table's tail, which the walk scans for every pair inside
    the cutoff (tile_pairs.cuh holds the first REG_EXCL = 8 entries in
    registers);
  - `steps_per_s` with `--steps N`: N Langevin steps of HaloMD on these
    atoms as the halo phase times them (hbonds, 2 fs, 300 K, chunks of
    20 steps after one warm-up chunk).

`--tree DIR` takes `torchmd_tpu_torch` from DIR (an unpacked `git
archive` of another commit) and everything else from this checkout, so
two versions of the package are compared in one call on one card, in
turns:

    python scripts/halo_split.py --tree _scratch/parent --tag before
    python scripts/halo_split.py --tag after

Prints one line `[halo_split] {...}` (JSON) with the card's name and power
limit. `--device cpu` prints instead the layout's counts from its plain
prep (`halo_tiles_reference`): `tiles`, `walk_tiles` (those holding owned
rows, the walk's blocks), `mixed_tiles` (holding owned and ghost rows),
`real_rows` and `excl_width`, the exclusion table's width.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 20


def layout_counts(kh, data, cfg, rows, nown, geom):
    """Tiles of the layout (the plain prep): all, those holding owned rows,
    those holding owned and ghost rows; real rows; the exclusion table's
    width."""
    slots = kh.halo_tiles_reference(data, cfg, rows, nown, geom).rowof
    r = slots.reshape(-1, kh.TILE)
    owned, ghost = ((r >= 0) & (r < nown)).any(1), (r >= nown).any(1)
    return dict(tiles=int(r.shape[0]), walk_tiles=int(owned.sum()),
                mixed_tiles=int((owned & ghost).sum()), real_rows=int((r >= 0).sum()),
                excl_width=int(data.excl.shape[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--tag", default="")
    ap.add_argument("--tile", type=int, nargs=3, default=(4, 4, 4))
    ap.add_argument("--calls", type=int, default=30)
    ap.add_argument("--excl-cols", type=int, default=None)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    sys.path.insert(0, tree)

    import numpy as np
    import torch
    import torch.distributed as dist

    from torchmd_tpu_torch.constraints import build_constraint_spec
    from torchmd_tpu_torch.integrator import maxwell_boltzmann
    from torchmd_tpu_torch.neighbors import build_exclusion_table
    from torchmd_tpu_torch.ops import halo as kh
    from torchmd_tpu_torch.parallel import HaloMD, make_mesh
    from torchmd_tpu_torch.parallel.launch import free_port
    from torchmd_tpu_torch.roofline import device_ms

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("halo_split.py: no CUDA device (--device cpu prints the counts)")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mol, par = cs.halo_system(tuple(args.tile))
        box = mol.box[:, 0]
        forces = cs._halo_forces(par, box, dev)
        excl = build_exclusion_table(par, mol.numAtoms)
        mesh = make_mesh(axes=("sp",), device=dev)

        def halo(**kw):
            return HaloMD(forces.ffparams, forces.config, mesh, box, excl_table=excl,
                          timestep=cs.TIMESTEP, axis="sp", **kw)

        h = halo()
        pos0 = mol.coords[:, :, 0]
        h.init(pos0, np.zeros_like(pos0))
        rows, nown, geom = h.pair_inputs()
        cfg = forces.config
        out = dict(tag=args.tag, tree=os.path.relpath(tree, ROOT), rows=int(rows.shape[0]),
                   nown=int(nown))
        if dev.type != "cuda":
            out.update(layout_counts(kh, h.data, cfg, rows, nown, geom))
            print("[halo_split] " + json.dumps(out), flush=True)
            return

        def call():
            return kh.halo_energy_forces(h.data, cfg, rows, nown, geom)

        out["call_ms"] = device_ms(call, args.calls, 3)
        if args.excl_cols is not None:
            k = args.excl_cols
            cut_data = h.data._replace(excl=h.data.excl[:, :k].contiguous())
            out[f"call_ms_excl{k}"] = device_ms(
                lambda: kh.halo_energy_forces(cut_data, cfg, rows, nown, geom), args.calls, 3)
        ops, kernels = cs._device_ops(call, args.calls)
        parts = {}
        for name, (us, n) in kernels.items():
            p = parts.setdefault(cs.halo_kernel_class(name), dict(us=0.0, kernels=0.0))
            p["us"], p["kernels"] = round(p["us"] + us, 3), p["kernels"] + n
        out.update(parts=parts, kernels_per_call=ops,
                   device_us_per_call=round(sum(us for us, _ in kernels.values()), 3),
                   top=[dict(name=k[:60], part=cs.halo_kernel_class(k), us=round(us, 3),
                             count=n)
                        for k, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])
                        ][:12])
        del h
        if args.steps:
            masses = np.asarray(par.masses, np.float64).reshape(-1, 1)
            con = build_constraint_spec(par, masses, mode="hbonds", device=dev,
                                        dtype=torch.float32)
            vel0 = maxwell_boltzmann(par.masses, cs.TEMP, 1, seed=1, device="cpu",
                                     dtype=torch.float64)[0].numpy()
            md = halo(constraints=con, T=cs.TEMP, gamma=cs.MESH_T_GAMMA, seed=2)
            md.init(pos0, vel0)
            md.step(CHUNK)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.steps // CHUNK):
                md.step(CHUNK)
            torch.cuda.synchronize()
            out["steps_per_s"] = args.steps // CHUNK * CHUNK / (time.perf_counter() - t0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        out["card"] = smi.stdout.strip()
        print("[halo_split] " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
