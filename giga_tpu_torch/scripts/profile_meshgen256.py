#!/usr/bin/env python3
"""The 257^3 refine chain's stages on the card (counterpart of
scripts/profile_meshgen256.py).

    python3 -m giga_tpu_torch.scripts.profile_meshgen256 [--precision fp32|bf16]
        [--resolution0 32] [--steps 3] [--tier 0] [--inner 4] [--seed 0]
        [--device cuda]

Run from the repository root. The shipped GIGA-Geo checkpoint on the first
scene of ``RandomState(--seed)``, strategy "refine". ``--tier`` picks the
budget tier the chain runs at (0 the half budgets, 1 the full), forced
through ``MeshGenerator.refine_program(planes, tier)``, as the JAX script
forces it through its chain builder; the first ``generate_mesh`` reports
the tier that call ran on its own. The JAX script times prefixes of the
chain; the port's chain marks each stage's end with a CUDA event
(``gen.marks``: the resolution0 dense decode, each level's mask and
compaction, each level's decode and scatter, the band's emission), so one
run gives every stage, and the medians of ``--inner`` runs are printed,
with the whole chain's time by ``utils.benchmark.serial_chain_latency``
(the planes moved by 1e-30 x the last outputs; every output reduced).
Every line stands beside the card's name and power limit; the last is one
JSON object. ``--device cpu`` is a rehearsal by the host clock (no stage
split).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--precision", choices=["fp32", "bf16"], default="fp32")
    ap.add_argument("--resolution0", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--tier", type=int, default=0,
                    help="refine budget tier the chain runs at (0 = half, 1 = full), forced "
                         "through MeshGenerator.refine_program")
    ap.add_argument("--inner", type=int, default=4, help="runs a stage's median is over")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from giga_tpu_torch.core.device import resolve_device
    from giga_tpu_torch.geometry.generation import MeshGenerator
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.scripts.profile_batched import card_line
    from giga_tpu_torch.scripts.profile_geo import reduce_all
    from giga_tpu_torch.scripts.profile_meshgen import CHECKPOINT, bench_scenes, marked
    from giga_tpu_torch.utils.benchmark import serial_chain_latency

    device = resolve_device(args.device)
    card = card_line(device)
    net, _ = load_network(CHECKPOINT, "giga_geo")
    gen = MeshGenerator(net, resolution0=args.resolution0, upsampling_steps=args.steps,
                        strategy="refine", precision=args.precision, device=device)
    tsdf = bench_scenes(1, seed=args.seed)[0]
    mesh, st = gen.generate_mesh(tsdf)
    K_f, K_ps = gen._refine_tiers[args.tier]
    print(f"tier ran: {st.get('refine tier')} ({st.get('path')}), counts "
          f"{st.get('refine cells (band/points-per-level)')}, budgets of tier {args.tier}: "
          f"{K_f} band cells, {list(K_ps)} points a level | {card}", flush=True)

    planes = gen.encode(tsdf)
    runs = [marked(gen, lambda: gen.refine_program(planes, args.tier))[1]
            for _ in range(args.inner + 1)][1:]  # the first warms
    stages = {k: float(np.median([r[k] for r in runs])) for k in (runs[0] if runs else {})}

    def loop(n, first):
        acc = torch.zeros((), device=first.device)
        for _ in range(n):
            pl = {t: v + acc * 1e-30 for t, v in planes.items()}
            acc = acc + reduce_all(gen.refine_program(pl, args.tier)) * 1e-30
        return acc

    with torch.inference_mode():
        whole = serial_chain_latency(loop, (next(iter(planes.values())),),
                                     inner=args.inner) * 1e3
    print("stage medians (CUDA events between the chain's marks):")
    for k, v in stages.items():
        print(f"  {k:>8}: {v:9.3f} ms | {card}")
    print(f"whole chain (serial chain, tier {args.tier}): {whole:.3f} ms; stages sum "
          f"{sum(stages.values()):.3f} ms | {card}")
    print(json.dumps({"script": "profile_meshgen256", "card": card,
                      "precision": args.precision, "tier": args.tier,
                      "tier_ran": st.get("refine tier"),
                      "counts": st.get("refine cells (band/points-per-level)"),
                      "budgets": [K_f, list(K_ps)], "stages_ms": stages,
                      "chain_ms": whole, "faces": len(mesh.faces)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
