#!/usr/bin/env python3
"""Stage and precision split of the VGN dense planner on the card
(counterpart of scripts/profile_vgn.py).

    python3 -m giga_tpu_torch.scripts.profile_vgn [--inner 16] [--device cuda]

Run from the repository root. A VGN net with ``reference_init(net, 0)``
weights on one seeded 40^3 grid; each row timed by
``utils.benchmark.serial_chain_latency`` (CUDA events; every output
reduced, so no head is skipped):

  * the single-scene program (``build_vgn_planner_fn``) at ``highest`` (TF32
    off), ``default`` (TF32 on) and ``bf16`` (a bf16 copy of the net);
  * the postprocess alone (mask, bound, NMS, top-K on fixed volumes);
  * the bare forward at each precision;
  * the stage split at ``default``: encoder, encoder + decoder, + the three
    heads (the module's forward);
  * encoder + decoder + the three heads as ONE 6-channel k5 conv, its bias
    inside the conv (the JAX script's fused form, built here).

The fused form's qual must match the shipped program's (its raw volume at
``highest``) within 1e-5, or the script raises. Each line stands beside the
card's name and power limit; the last is one JSON object. ``--device cpu``
is a rehearsal by the host clock, not a device metric.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

import numpy as np

TOL_FUSED = 1e-5  # fused qual against the shipped program's, absolute
SIZE = 0.3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inner", type=int, default=16, help="chain length of a timed run")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def fused_heads(net):
    """f(x) -> (qual, rot, width): the three heads of ``net`` as ONE 6-channel
    k5 conv of the trunk's features, its bias inside the conv (the JAX
    script's fused form)."""
    import torch
    import torch.nn.functional as F

    from giga_tpu_torch.models.conv_onet import normalize_quat
    from giga_tpu_torch.models.vgn import HEADS

    fk = torch.cat([getattr(net, h).weight for h in HEADS])
    fb = torch.cat([getattr(net, h).bias for h in HEADS])

    def heads(x):
        out = F.conv3d(x, fk, fb, padding=2)
        return torch.sigmoid(out[:, 0]), normalize_quat(out[:, 1:5], dim=1), out[:, 5]

    return heads


def fused_qual_error(net, grid) -> float:
    """max |qual| difference of the fused form against the shipped program's
    raw qual volume, both at highest (TF32 off); raises past TOL_FUSED."""
    import torch

    from giga_tpu_torch.core.config import PlannerConfig
    from giga_tpu_torch.core.precision import full_precision
    from giga_tpu_torch.inference.planner import build_vgn_planner_fn

    with torch.inference_mode():
        with full_precision():
            fused = fused_heads(net)(net.trunk(grid[None]))[0][0]
        shipped = build_vgn_planner_fn(net, PlannerConfig(), SIZE, precision="highest",
                                       return_raw=True)(grid, grid)[1][0]
        err = float((fused - shipped).abs().max())
    if not err <= TOL_FUSED:
        raise AssertionError(f"fused qual against the shipped program's: {err} > {TOL_FUSED}")
    return err


def main(argv=None) -> int:
    args = parse_args(argv)

    import copy

    import torch
    import torch.nn.functional as F

    from giga_tpu_torch.core.config import PlannerConfig
    from giga_tpu_torch.core.device import resolve_device
    from giga_tpu_torch.core.precision import full_precision, tf32_precision
    from giga_tpu_torch.inference.planner import build_vgn_planner_fn, lattice_positions
    from giga_tpu_torch.inference.postprocess import bound_quality, mask_quality, select_grasps
    from giga_tpu_torch.models.registry import get_network, reference_init
    from giga_tpu_torch.models.vgn import upsample2
    from giga_tpu_torch.scripts.profile_batched import card_line
    from giga_tpu_torch.scripts.profile_geo import chain_ms

    device = resolve_device(args.device)
    card = card_line(device)
    net, cfg = get_network("vgn")
    net = reference_init(net, 0).to(device).eval()
    bf16 = copy.deepcopy(net).to(torch.bfloat16)
    rng = np.random.RandomState(0)
    grid = torch.from_numpy(rng.rand(40, 40, 40).astype(np.float32)).to(device)
    scopes = {"highest": full_precision, "default": tf32_precision, "bf16": tf32_precision,
              None: contextlib.nullcontext}

    def chain(fn, scope="default"):
        """``fn``'s chain ms under ``scope``'s TF32 setting (None: the
        program sets its own)."""
        with scopes[scope]():
            return chain_ms(fn, grid, args.inner, args.repeats)

    ms = {}

    def report(tag, value):
        ms[tag] = value
        print(f"{tag:34s} {value:8.3f} ms | {card}", flush=True)

    # 1. the shipped program in each precision
    plans = {p: build_vgn_planner_fn(bf16 if p == "bf16" else net, PlannerConfig(), SIZE,
                                     precision="default" if p == "bf16" else p)
             for p in ("highest", "default", "bf16")}
    for p, plan in plans.items():
        report(f"plan {p}", chain(lambda g, f=plan: f(g, g), None))

    # 2. the postprocess alone
    pcfg = dataclasses.replace(PlannerConfig(), min_width=1.33, max_width=9.33)
    qual0 = torch.from_numpy(rng.rand(40, 40, 40).astype(np.float32)).to(device)
    rot0 = torch.from_numpy(rng.randn(40, 40, 40, 4).astype(np.float32)).to(device)
    positions = lattice_positions(torch.arange(40, dtype=torch.float32, device=device))

    def post(g):
        w = g * 5.0
        q = mask_quality(qual0 + g * 1e-24, g, w, pcfg)
        q = bound_quality(q, SIZE / 40, pcfg)
        return select_grasps(q, rot0, w, positions, pcfg)

    report("postprocess only", chain(post, "highest"))

    # 3. the bare forward in each precision
    report("net fwd highest", chain(lambda g: net(g[None]), "highest"))
    report("net fwd default (TF32)", chain(lambda g: net(g[None])))
    report("net fwd bf16", chain(lambda g: bf16(g[None].to(torch.bfloat16)), "bf16"))

    # 4. the stage split at default precision
    def enc_only(g):
        x = g[None, None]
        for i in (1, 2, 3):
            x = F.relu(getattr(net.encoder, f"conv{i}")(x))
        return x

    def enc_dec(g):
        x = enc_only(g)
        for i in (1, 2, 3):
            x = upsample2(F.relu(getattr(net.decoder, f"conv{i}")(x)))
        return x

    report("encoder only", chain(enc_only))
    report("encoder+decoder", chain(enc_dec))
    report("encoder+decoder+heads", chain(lambda g: net(g[None])))

    # 5. the three heads as one 6-channel conv, the bias inside it
    heads = fused_heads(net)
    report("enc+dec+fused heads", chain(lambda g: heads(enc_dec(g))))
    err = fused_qual_error(net, grid)
    print(f"fused-head qual within {err:.3g} of the shipped program's at highest (tol "
          f"{TOL_FUSED}) | {card}")
    print(json.dumps({"script": "profile_vgn", "card": card, "ms": ms, "fused_qual_err": err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
