#!/usr/bin/env python3
"""A/B of the batched dense decodes on the card, from one set of features.

    python3 -m giga_tpu_torch.scripts.measure_decoder_kernels [--dtype fp32|bf16]
        [--batch 64] [--chunks 8 40] [--iters 10]

Run from the repository root. The shipped checkpoint's encoder turns
chip_smoke's seeded scenes into one set of lattice features; from those the
script times four decodes of (qual, rot, width), each per batch by CUDA
events after a synchronize:
  * the module path (``decode_affordance_dense_batched``, plain PyTorch);
  * K2's path: projections materialised by PyTorch, then the trunk kernel;
  * K4's path: all three projections formed in the kernel from the raw
    features, at each ``--chunks`` run of x-slabs per block;
  * K5's path: pyz materialised by PyTorch, the xz/xy rows in the kernel;
  * K2's path with the TPU kernel's numeric options: ``fold_b1`` (in bf16
    with ``hidden_bf16``, the serving flags' pair), and in bf16 also
    ``resident_bf16``. Each one's raw qual is held against K2's default
    path: within 1e-5 in fp32, and in bf16 within the bf16 gates below.
Each decode's three outputs are summed into one device scalar, so nothing
goes unused.

``--dtype fp32`` (the default) prints each decode's largest difference
from the module path. ``--dtype bf16`` runs the decodes as the JAX
package's scripts/measure_decoder_kernels.py does in bf16: a bf16 copy of
the net encodes the scenes, so the planes and lattice features are bf16;
the module path runs on the bf16 params, K2, K4 and K5 in their bf16 modes
(``compute_dtype=torch.bfloat16``). Each decode's raw qual is held against
K2 bf16's, the decode bf16 serving runs, within 4e-2 at most and 3e-3 at
the median (chip_smoke.check_qual_bf16); a decode past them fails the run.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# K2 with an option against K2's default path, raw qual, float32
TOL_OPTION = 1e-5


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Time the batched dense decodes on the card.")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32",
                    help="the decodes' mode; bf16 also encodes with a bf16 copy of the net")
    ap.add_argument("--chunks", type=int, nargs="*", default=[8, 40],
                    help="x-slabs per block of K4 to time")
    ap.add_argument("--iters", type=int, default=10)
    return ap.parse_args(argv)


def decode_paths(dec: dict, coords, n_blocks: int, chunks, dtype) -> dict:
    """{name: feats -> float32 (qual, rot, width)} of the four decodes and
    K2's option rows in ``dtype``'s mode (torch.float32 or torch.bfloat16),
    on the decoder params ``dec``. K2's rot is (B, 4, R^3), the others'
    (B, R, R, R, 4)."""
    import torch

    from giga_tpu_torch.inference.dense_decode import decode_affordance_dense_batched
    from giga_tpu_torch.ops.kernels import decoder as dk

    if dtype == torch.bfloat16:
        options = {"K2 + fold_b1, hidden_bf16": dict(fold_b1=True, hidden_bf16=True),
                   "K2 + resident_bf16": dict(resident_bf16=True)}
    else:
        options = {"K2 + fold_b1": dict(fold_b1=True)}
    return {
        "module path": lambda f: tuple(
            v.float() for v in decode_affordance_dense_batched(dec, f, coords, n_blocks)),
        "K2 projections + trunk": lambda f: dk.decode_affordance_dense_kernel_batched(
            dec, f, coords, n_blocks, dtype),
        **{f"K4 raw features, x_chunk={c}":
           (lambda f, c=c: dk.decode_affordance_dense_kernel_feats_batched(
               dec, f, coords, n_blocks, x_chunk=c, compute_dtype=dtype)) for c in chunks},
        "K5 hybrid": lambda f: dk.decode_affordance_dense_kernel_hybrid_batched(
            dec, f, coords, n_blocks, compute_dtype=dtype),
        **{name: (lambda f, o=o: dk.decode_affordance_dense_kernel_batched(
            dec, f, coords, n_blocks, dtype, **o)) for name, o in options.items()},
    }


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("measure_decoder_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from giga_tpu_torch.inference.dense_decode import (
        lattice_coords, sample_planes_on_lattice_batched)
    from giga_tpu_torch.inference.planner import full_precision
    from giga_tpu_torch.models.registry import load_network

    bf16 = args.dtype == "bf16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    card = chip_smoke.card_line()
    net, cfg = load_network(ROOT / chip_smoke.CHECKPOINT)
    net = net.cuda().eval().to(dtype)
    R = chip_smoke.RESOLUTION
    coords = lattice_coords(R, "cuda")
    tsdfs = torch.from_numpy(chip_smoke.make_scenes(args.batch)).cuda().to(dtype)
    paths = decode_paths(net.decoder_aff.params(), coords, cfg.decoder.n_blocks, args.chunks,
                         dtype)
    with torch.inference_mode(), full_precision():
        feats = sample_planes_on_lattice_batched(net.encode(tsdfs), coords,
                                                 cfg.encoder.plane_resolution,
                                                 cfg.decoder.padding)
        ref_name = "K2 projections + trunk" if bf16 else "module path"
        ref = paths[ref_name](feats)
        k2_qual = paths["K2 projections + trunk"](feats)[0]
        total = torch.zeros((), device="cuda")

        def reduced(fn):
            def run():
                qual, rot, width = fn(feats)
                total.add_(qual.sum() + rot.sum() + width.sum())
            return run

        for name, fn in paths.items():
            qual, rot, width = fn(feats)
            ms = chip_smoke.cuda_ms(reduced(fn), args.iters)
            if bf16:
                worst, median = chip_smoke.check_qual_bf16(
                    qual.cpu().numpy(), ref[0].cpu().numpy(), f"{name} vs {ref_name}")
                against = f"raw qual vs K2 bf16 max {worst:.3g} median {median:.3g}"
            else:
                if rot.ndim == 3:  # K2's transposed (B, 4, R^3) rotations
                    rot = rot.permute(0, 2, 1).reshape(ref[1].shape)
                diff = max(float((a - b).abs().max()) for a, b in zip((qual, rot, width), ref))
                against = f"max |diff| vs module path {diff:.3g}"
                if name.startswith("K2 +"):
                    option = float((qual - k2_qual).abs().max())
                    if not option <= TOL_OPTION:
                        raise AssertionError(f"{name}: raw qual differs from K2's default path "
                                             f"by {option} > {TOL_OPTION}")
                    against += f", raw qual vs K2 default {option:.3g}"
            print(f"{name:28s} {ms:9.3f} ms/batch  {args.batch / ms * 1e3:9.1f} scenes/s  "
                  f"{against}  B={args.batch} R={R} {args.dtype} | {card}", flush=True)
        torch.cuda.synchronize()
        if not torch.isfinite(total):
            raise AssertionError("a decode produced non-finite values")
    return 0


if __name__ == "__main__":
    sys.exit(main())
