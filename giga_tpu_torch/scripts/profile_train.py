#!/usr/bin/env python3
"""Where the time of the port's train step goes, on the card.

    python3 -m giga_tpu_torch.scripts.profile_train [--variants full,fwd,enc]
        [--samplers gather,mm] [--precisions fp32,bf16] [--batch 32]
        [--n-occ 2048] [--reps 3]

Run from the repository root. Trains the shipped giga checkpoint on
chip_smoke's seeded batch (``chip_smoke.train_batch``, bench.py's recipe)
at the reference's defaults (B=32, 2048 occupancy points a sample), and
splits the step's time by variant:

  full/<sampler>/<prec>   the train step (forward, backward, Adam)
  fwd/<sampler>/<prec>    the loss only, no gradients
  enc/<prec>              the encoder alone, forward + backward + Adam on
                          its parameters (loss: mean square of the planes);
                          full minus enc ~ the decoders, sampling and loss

The samplers are DecoderConfig.sampler 'gather' (4 row gathers a point,
backward a scatter-add into the planes) and 'mm' (dense interpolation
weights and matmuls); precisions fp32 (TF32 off) and bf16 (mixed
precision, fp32 master weights). For each it prints, beside the card's name
and power limit, the marginal time of a step by CUDA events (chains of 9
and of 1 steps, the least of ``--reps`` each: (t9 - t1) / 8), the kernels
launched a step and the device's idle share over 3 warm steps
(torch.profiler), and the peak memory of a step; then one JSON summary
line.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _variant_step(variant: str, net, cfg, sampler, dtype):
    """step(state, batch) of one profiled variant; ``enc`` trains the
    encoder's parameters with an Adam of their own."""
    import contextlib

    import torch
    from torch.func import functional_call

    from giga_tpu_torch.core.precision import full_precision
    from giga_tpu_torch.train.trainer import (
        Adam, _with_sampler, make_loss_fn, make_train_step)

    scope = full_precision if dtype is None else contextlib.nullcontext
    if variant == "full":
        return make_train_step(net, cfg, dtype=dtype, sampler=sampler)
    if variant == "fwd":
        loss_fn = make_loss_fn(_with_sampler(net, cfg, sampler), cfg, dtype=dtype)

        def fwd(state, batch):
            with scope(), torch.no_grad():
                return loss_fn(state.params, batch)[0]
        return fwd

    names = [k for k, _ in net.encoder.named_parameters()]
    adam = Adam([p for _, p in net.encoder.named_parameters()])

    def enc(state, batch):
        leaves = [state.module.encoder.get_parameter(k) for k in names]
        with scope(), torch.enable_grad():
            params = {k: p if dtype is None else p.to(dtype) for k, p in zip(names, leaves)}
            tsdf = batch["tsdf"] if dtype is None else batch["tsdf"].to(dtype)
            planes = functional_call(state.module.encoder, params, (tsdf,))
            loss = sum(torch.mean(v.float() ** 2) for v in planes.values())
            grads = torch.autograd.grad(loss, leaves)
        adam.update(leaves, grads)
        return loss
    return enc


def main() -> int:
    ap = argparse.ArgumentParser(description="Profile the port's train step on the card.")
    ap.add_argument("--variants", default="full,fwd,enc")
    ap.add_argument("--samplers", default="gather,mm")
    ap.add_argument("--precisions", default="fp32,bf16")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n-occ", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from giga_tpu_torch.core.device import to_device
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.scripts.profile_planner import _trace
    from giga_tpu_torch.train.trainer import create_train_state

    card = chip_smoke.card_line()
    net, cfg = load_network(ROOT / chip_smoke.CHECKPOINT)
    B = args.batch
    batch = to_device(chip_smoke.train_batch(chip_smoke.SEED, B, args.n_occ), "cuda")
    summary = {}
    for prec in args.precisions.split(","):
        dtype = torch.bfloat16 if prec == "bf16" else None
        for variant in args.variants.split(","):
            for sampler in (["mm"] if variant == "enc" else args.samplers.split(",")):
                key = f"{variant}/{prec}" if variant == "enc" else f"{variant}/{sampler}/{prec}"
                state = create_train_state(copy.deepcopy(net), device="cuda")
                step = _variant_step(variant, state.module, cfg,
                                     None if sampler == "gather" else sampler, dtype)
                step(state, batch)
                ms = chip_smoke.chain_step_ms(step, state, batch, args.reps)
                busy, wall, rows = _trace(lambda: step(state, batch), 3)
                kernels = sum(r[1] for r in rows if not r[2].startswith(("Memcpy", "Memset")))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                step(state, batch)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() / 1e9
                idle = max(0.0, 1 - busy / wall)
                summary[key] = {"ms": ms, "samples_per_s": B / ms * 1e3, "kernels": kernels,
                                "idle_share": idle, "peak_gb": peak}
                print(f"{key}: {ms:.3f} ms a step ({B / ms * 1e3:.1f} samples/s), {kernels} "
                      f"kernels a step, idle share {idle:.3f} (traced {busy:.3f} ms device of "
                      f"{wall:.3f} ms wall), peak {peak:.2f} GB | {card}", flush=True)
                for k_ms, calls, name in rows[:5]:
                    print(f"  {k_ms:8.3f} ms  x{calls:<4d} {name[:90]}")
    print(json.dumps({"train_profile": summary, "batch": B, "n_occ": args.n_occ, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
