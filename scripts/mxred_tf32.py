"""The staged probe's mxred on the tensor cores, emulated on the CPU: the
row error of the TF32 split by number of products.

`ops.roofline.mxred_tf32_reference(inp, products)` rounds g and the
coordinates to TF32 hi + lo and sums the first `products` of (hi.hi,
hi.lo, lo.hi, lo.lo) in f64, so it measures the operands' rounding only
(not the tensor cores' f32 accumulation). For each count this prints the
largest row error against the plain f32 `forces` stage, over each row's
`force_scale`, on the probe's rows without pairs nearer than 2 A: the
quantity `chip_smoke.py` gates at MXRED_TOL = 1e-5 on the card.

Usage: python scripts/mxred_tf32.py [--n 4676] [--tile 512]
(one JSON line; ~1 min at 4,676 atoms on a few CPU cores)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torchmd_tpu_torch.ops import roofline as rl  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4676)
    ap.add_argument("--tile", type=int, default=512)
    args = ap.parse_args(argv)
    near = rl.without_close_pairs(rl.make_inputs(args.n, args.tile))
    scale = rl.force_scale(rl.in_f64(near))
    forces = rl.stage_reference("forces", near)[:3]
    errs = {p: rl.row_error(rl.mxred_tf32_reference(near, p)[:3], forces, scale)
            for p in range(1, len(rl.TF32_PRODUCTS) + 1)}
    print(json.dumps({"n": args.n, "inputs": "no_close_pairs", "device": "cpu (emulation)",
                      "row_err_by_products": errs}))


if __name__ == "__main__":
    main()
