#!/usr/bin/env python3
"""How far K2's bf16 modes move with the order of their float32 sums.

    python3 -m giga_tpu_torch.scripts.bf16_sum_order [--batch 64]
        [--device cuda|cpu]

Run from the repository root. A bf16 mode rounds values to bf16 at fixed
points (each product's operands; in ``resident_bf16`` also the residual
stream after every add), and a float32 sum taken in another order can land
on the other side of one of those roundings, which moves everything
downstream of it by a bf16 step. chip_smoke.py holds each bf16 mode
against its plain version by a share of outputs within 1e-5 and a far
bound on max |a - b| / (1 + |b|); this script measures that distance for
sums in another order: for each bf16 mode of K2 (default, fold_b1,
resident_bf16, both) on the shipped checkpoint's lattice features of
chip_smoke's scenes, it prints the plain version with float32 sums
against the same plain version with float64 sums (the same bf16 rounding
points) and, on the card, the kernel against both. Each line gives the
share within 1e-5, the max err / (1 + |ref|) and the count of outputs past
1e-2 of it, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[2]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Sum-order spread of K2's bf16 modes.")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def spread(got, ref) -> tuple:
    """(share of |got - ref| within 1e-5, max |got - ref| / (1 + |ref|),
    outputs past 1e-2 of that), in float64."""
    got, ref = got.double(), ref.double()
    d = (got - ref).abs()
    rel = d / (1 + ref.abs())
    return float((d <= 1e-5).double().mean()), float(rel.max()), int((rel > 1e-2).sum())


def plain_float64(dk, inputs, fold_b1: bool, resident_bf16: bool):
    """K2's plain version with its products' operands and its rounded
    residual stream widened to float64 instead of float32: the same bf16
    roundings, every sum in float64."""
    import torch

    with mock.patch.object(dk, "_operand", lambda a, _: a.to(torch.bfloat16).double()), \
            mock.patch.object(dk, "_round_bf16", lambda a: a.to(torch.bfloat16).double()):
        return dk.dense_decode_plain(*inputs, fold_b1=fold_b1, resident_bf16=resident_bf16)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bf16_sum_order: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from giga_tpu_torch.inference.dense_decode import (
        lattice_coords, sample_planes_on_lattice_batched)
    from giga_tpu_torch.inference.planner import full_precision
    from giga_tpu_torch.models.encoder import encode_planes_fused
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.ops.kernels import decoder as dk

    device = torch.device(args.device)
    bf = torch.bfloat16
    net, cfg = load_network(ROOT / chip_smoke.CHECKPOINT)
    bnet = copy.deepcopy(net).to(device).eval().to(bf)
    R = chip_smoke.RESOLUTION
    coords = lattice_coords(R, device)
    tsdfs = torch.from_numpy(chip_smoke.make_scenes(args.batch)).to(device)
    card = chip_smoke.card_line() if device.type == "cuda" else "cpu (no card measured)"
    with torch.inference_mode(), full_precision():
        feats = sample_planes_on_lattice_batched(encode_planes_fused(bnet.encoder, tsdfs.to(bf)),
                                                 coords, cfg.encoder.plane_resolution,
                                                 cfg.decoder.padding)
        for dtype, fold, resident in dk.K2_MODES:
            if dtype != bf:
                continue
            inputs = dk.prepare_projections_batched(bnet.decoder_aff.params(), feats, coords,
                                                    cfg.decoder.n_blocks, bf, fold_b1=fold)
            plain = dk.dense_decode_plain(*inputs, fold_b1=fold, resident_bf16=resident)
            wide = plain_float64(dk, inputs, fold, resident)
            rows = {"plain float32 sums vs plain float64 sums": spread(plain, wide)}
            if device.type == "cuda":
                kernel = dk.dense_decode_batched(*inputs, fold_b1=fold, resident_bf16=resident)
                rows["kernel vs plain float32 sums"] = spread(kernel, plain)
                rows["kernel vs plain float64 sums"] = spread(kernel, wide)
            name = dk.dense_decode_entry(dtype, fold, resident)
            for what, (share, rel, past) in rows.items():
                print(f"{name:32s} {what:42s} share within 1e-5 {share:.6f}, max err/(1+|ref|) "
                      f"{rel:.4g}, {past} past 1e-2  B={args.batch} R={R} | {card}", flush=True)
            del plain, wide, rows
    return 0


if __name__ == "__main__":
    sys.exit(main())
