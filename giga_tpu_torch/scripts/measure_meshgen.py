#!/usr/bin/env python3
"""Mesh generation's strategies on the card (counterpart of
scripts/measure_meshgen.py).

    python3 -m giga_tpu_torch.scripts.measure_meshgen [--scenes 3] [--reps 3]
        [--dense256] [--device cuda]

Run from the repository root. The shipped GIGA-Geo checkpoint on the first
``--scenes`` of bench.py's scenes (profile_meshgen.bench_scenes): the dense
band program (strategy "dense") against the refine chain (strategy
"refine") at 129^3 (resolution0 32, 2 upsampling steps) and 257^3 (3
steps), in fp32 and bf16; the dense form at 257^3 only with
``--dense256``. Each row is the median wall time of warm ``generate_mesh``
calls (host marching included: what a user of the reconstruction path
waits), with the faces, the refine tier and the band counts of the last
call, beside the card's name and power limit; the last line is one JSON
object. ``--device cpu`` is a rehearsal by the host clock.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def measure(gen, tsdfs, reps: int):
    """(median seconds of a warm generate_mesh over every scene x reps,
    (faces, refine tier, band counts) of the last call)."""
    gen.generate_mesh(tsdfs[0], return_stats=False)  # warm
    ts, info = [], None
    for tsdf in tsdfs:
        for _ in range(reps):
            t0 = time.perf_counter()
            m, st = gen.generate_mesh(tsdf)
            ts.append(time.perf_counter() - t0)
            info = (len(m.faces), st.get("refine tier"),
                    st.get("refine cells (band/points-per-level)"))
    return float(np.median(ts)), info


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--dense256", action="store_true",
                    help="also time the full dense decode at 257^3")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from giga_tpu_torch.core.device import resolve_device
    from giga_tpu_torch.geometry.generation import MeshGenerator
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.scripts.profile_batched import card_line
    from giga_tpu_torch.scripts.profile_meshgen import CHECKPOINT, bench_scenes

    device = resolve_device(args.device)
    card = card_line(device)
    net, _ = load_network(CHECKPOINT, "giga_geo")
    tsdfs = bench_scenes(args.scenes)
    rows = []
    for steps, label in ((2, "129^3"), (3, "257^3")):
        for strategy in ("dense", "refine"):
            if strategy == "dense" and label == "257^3" and not args.dense256:
                continue  # a 17M-point decode: only when asked
            for precision in ("fp32", "bf16"):
                gen = MeshGenerator(net, resolution0=32, upsampling_steps=steps,
                                    strategy=strategy, precision=precision, device=device)
                med, info = measure(gen, tsdfs, args.reps)
                rows.append({"lattice": label, "strategy": strategy, "precision": precision,
                             "ms_per_scene": med * 1e3, "faces": info[0], "tier": info[1],
                             "bands": info[2]})
                print(f"{label} {strategy} {precision}: {med * 1e3:.3f} ms a scene (faces, "
                      f"tier, bands {info}) | {card}", flush=True)
    print("summary:")
    for r in rows:
        print(f"  {r['lattice']:6s} {r['strategy']:6s} {r['precision']}: "
              f"{r['ms_per_scene']:9.3f} ms a scene | {card}")
    print(json.dumps({"script": "measure_meshgen", "card": card, "scenes": args.scenes,
                      "reps": args.reps, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
