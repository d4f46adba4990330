#!/usr/bin/env python3
"""A/B of the batched dense decodes on the card, from one set of features.

    python3 -m giga_tpu_torch.scripts.measure_decoder_kernels [--batch 64] [--iters 10]

Run from the repository root. The shipped checkpoint's encoder turns
chip_smoke's seeded scenes into one set of lattice features; from those the
script times four decodes of (qual, rot, width), each per batch by CUDA
events after a synchronize:
  * the module path (``decode_affordance_dense_batched``, plain PyTorch);
  * K2's path: projections materialised by PyTorch, then the trunk kernel;
  * K4's path: all three projections formed in the kernel from the raw
    features, at each ``--chunks`` run of x-slabs per block;
  * K5's path: pyz materialised by PyTorch, the xz/xy rows in the kernel.
Each decode's three outputs are summed into one device scalar, so nothing
goes unused, and its largest difference from the module path is printed.
Every line carries the card's name and power limit. fp32 only: the bf16
modes of K4 and K5 are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description="Time the batched dense decodes on the card.")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32")
    ap.add_argument("--chunks", type=int, nargs="*", default=[8, 40],
                    help="x-slabs per block of K4 to time")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if args.dtype == "bf16":
        raise NotImplementedError("the bf16 modes of K4 and K5 are not ported yet")

    import torch

    if not torch.cuda.is_available():
        print("measure_decoder_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from giga_tpu_torch.inference.dense_decode import (
        decode_affordance_dense_batched, lattice_coords, sample_planes_on_lattice_batched)
    from giga_tpu_torch.inference.planner import full_precision
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.ops.kernels import decoder as dk

    card = chip_smoke.card_line()
    net, cfg = load_network(ROOT / chip_smoke.CHECKPOINT)
    net = net.cuda().eval()
    R = chip_smoke.RESOLUTION
    coords = lattice_coords(R, "cuda")
    dec = net.decoder_aff.params()
    nb = cfg.decoder.n_blocks
    tsdfs = torch.from_numpy(chip_smoke.make_scenes(args.batch)).cuda()

    paths = {
        "module path": lambda f: decode_affordance_dense_batched(dec, f, coords, nb),
        "K2 projections + trunk": lambda f: dk.decode_affordance_dense_kernel_batched(
            dec, f, coords, nb),
        **{f"K4 raw features, x_chunk={c}":
           (lambda f, c=c: dk.decode_affordance_dense_kernel_feats_batched(
               dec, f, coords, nb, x_chunk=c)) for c in args.chunks},
        "K5 hybrid": lambda f: dk.decode_affordance_dense_kernel_hybrid_batched(
            dec, f, coords, nb),
    }
    with torch.inference_mode(), full_precision():
        feats = sample_planes_on_lattice_batched(net.encode(tsdfs), coords,
                                                 cfg.encoder.plane_resolution,
                                                 cfg.decoder.padding)
        ref = paths["module path"](feats)
        total = torch.zeros((), device="cuda")

        def reduced(fn):
            def run():
                qual, rot, width = fn(feats)
                total.add_(qual.sum() + rot.sum() + width.sum())
            return run

        for name, fn in paths.items():
            qual, rot, width = fn(feats)
            if rot.ndim == 3:  # K2's transposed (B, 4, R^3) rotations
                rot = rot.permute(0, 2, 1).reshape(ref[1].shape)
            diff = max(float((a - b).abs().max()) for a, b in zip((qual, rot, width), ref))
            ms = chip_smoke.cuda_ms(reduced(fn), args.iters)
            print(f"{name:28s} {ms:9.3f} ms/batch  {args.batch / ms * 1e3:9.1f} scenes/s  "
                  f"max |diff| vs module path {diff:.3g}  B={args.batch} R={R} fp32 | {card}")
        torch.cuda.synchronize()
        if not torch.isfinite(total):
            raise AssertionError("a decode produced non-finite values")
    return 0


if __name__ == "__main__":
    sys.exit(main())
