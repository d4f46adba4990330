#!/usr/bin/env python3
"""Stage times of the batched GIGA serving program, by prefix differencing.

    python3 -m giga_tpu_torch.scripts.profile_batched [--batch 64]
        [--dtype fp32|bf16] [--fold-b1] [--hidden-bf16] [--iters 10]
        [--device cuda|cpu]

Run from the repository root. The counterpart of the JAX package's
scripts/profile_batched.py on the port's kernels' path: the shipped
checkpoint (a bf16 copy of it with ``--dtype bf16``) plans ``--batch``
seeded random TSDFs, and four prefixes of the batched program are timed,
each stage's cost being its prefix's time less the previous prefix's:

    encode       K1 (stem + pool) and the 2D U-Net
    +sample      bilinear sampling of the planes onto the R^2 lattices
    +decode      K2's projections and trunk (``--fold-b1``, ``--hidden-bf16``:
                 the JAX package's ``pallas_fold_b1`` / ``pallas_hidden_bf16``)
    full (post)  the whole program: masks, NMS and top-K too

Every output of a prefix is reduced into one device scalar, so no work is
skipped. On the card each prefix is timed by CUDA events around ``--iters``
calls after a warm-up call and a synchronize; each line carries the card's
name and power limit. The +decode line also gives the trunk's operations
(``chip_smoke.trunk_flops``, the benchmark's frozen count) and the rate
its stage time implies. The JAX script's XLA cost analysis has no
counterpart here. Without a card the script exits 2 unless ``--device
cpu`` is given, which times the kernels' plain versions by the host clock
(a check that the script runs, not a measurement of the card).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CHECKPOINT = ROOT / "checkpoints" / "synthetic_giga_best.msgpack"
STAGES = ("encode", "+sample", "+decode", "full (post)")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Stage times of the batched serving program.")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32")
    ap.add_argument("--fold-b1", action="store_true")
    ap.add_argument("--hidden-bf16", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def prefixes(net, cfg, planner_cfg, coords, fold_b1: bool, hidden_bf16: bool) -> dict:
    """{stage: tsdfs -> the outputs of the program up to that stage}, in
    the net's dtype, on the kernels' path."""
    from giga_tpu_torch.inference.dense_decode import sample_planes_on_lattice_batched
    from giga_tpu_torch.inference.planner import build_batched_giga_planner_fn, net_dtype
    from giga_tpu_torch.models.encoder import can_encode_fused, encode_planes_fused
    from giga_tpu_torch.ops.kernels.decoder import decode_affordance_dense_kernel_batched

    dtype = net_dtype(net)
    P, n_blocks = cfg.encoder.plane_resolution, cfg.decoder.n_blocks

    def encode(tsdfs):
        if can_encode_fused(cfg.encoder, tsdfs.shape, dtype):
            return encode_planes_fused(net.encoder, tsdfs.to(dtype))
        return net.encode(tsdfs.to(dtype))

    def sample(tsdfs):
        return sample_planes_on_lattice_batched(encode(tsdfs), coords, P, cfg.decoder.padding)

    def decode(tsdfs):
        return decode_affordance_dense_kernel_batched(
            net.decoder_aff.params(), sample(tsdfs), coords, n_blocks, dtype, fold_b1=fold_b1,
            hidden_bf16=hidden_bf16)

    program = build_batched_giga_planner_fn(net, cfg, planner_cfg, 0.3, use_kernels=True,
                                            fold_b1=fold_b1, hidden_bf16=hidden_bf16)
    return dict(zip(STAGES, (encode, sample, decode, lambda t: program(t, t))))


def reduce_into(total, out) -> None:
    """Add every tensor of ``out`` (nested dicts, tuples) into ``total``,
    non-finite values as zero."""
    import torch

    if isinstance(out, torch.Tensor):
        x = out.float()
        total.add_(torch.where(torch.isfinite(x), x, 0.0).sum())
    else:
        for v in (out.values() if isinstance(out, dict) else out):
            reduce_into(total, v)


def stage_ms(fn, tsdfs, iters: int, device) -> float:
    """Milliseconds per call of ``fn(tsdfs)`` with its outputs reduced:
    CUDA events on the card, the host clock on the CPU."""
    import torch

    total = torch.zeros((), device=device)

    def run():
        reduce_into(total, fn(tsdfs))

    run()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return (time.perf_counter() - t0) * 1e3 / iters


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or "cpu"."""
    if device.type != "cuda":
        return "cpu (host clock; no card measured)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    args = parse_args(argv)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_batched: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import trunk_flops
    from giga_tpu_torch.core.config import PlannerConfig
    from giga_tpu_torch.inference.dense_decode import lattice_coords
    from giga_tpu_torch.inference.planner import full_precision
    from giga_tpu_torch.models.registry import load_network

    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    net, cfg = load_network(CHECKPOINT)
    net = net.to(device).eval().to(dtype)
    pcfg = PlannerConfig()
    R = pcfg.resolution
    coords = lattice_coords(R, device)
    rng = np.random.RandomState(0)
    P = cfg.encoder.plane_resolution
    tsdfs = torch.from_numpy(rng.rand(args.batch, P, P, P).astype(np.float32)).to(device)
    card = card_line(device)
    fns = prefixes(net, cfg, pcfg, coords, args.fold_b1, args.hidden_bf16)
    # the decode trunk's operations at this batch (heads run apart)
    heads = net.decoder_aff.params()["fc_p_kernel"].shape[0]
    flops = trunk_flops(args.batch * R ** 3, heads, cfg.decoder.hidden_size, cfg.decoder.n_blocks,
                        4, fold_b1=args.fold_b1)
    print(f"B={args.batch} R={R} {args.dtype} fold_b1={args.fold_b1} "
          f"hidden_bf16={args.hidden_bf16} iters={args.iters} | {card}")
    print(f"{'stage':12s} {'ms':>10s} {'delta ms':>10s} {'scenes/s':>10s}")
    prev = 0.0
    with torch.inference_mode(), full_precision():
        for name, fn in fns.items():
            ms = stage_ms(fn, tsdfs, args.iters, device)
            extra = ""
            if name == "+decode" and ms > prev:
                extra = (f"  trunk {flops / 1e9:.1f} GFLOP, {flops / (ms - prev) / 1e9:.1f} "
                         f"TFLOP/s over the stage's delta")
            print(f"{name:12s} {ms:10.3f} {ms - prev:10.3f} {args.batch / ms * 1e3:10.1f}"
                  f"{extra} | {card}", flush=True)
            prev = ms
    return 0


if __name__ == "__main__":
    sys.exit(main())
