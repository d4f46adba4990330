#!/usr/bin/env python3
"""How far a 129^3 reconstruction's time moves with the scene, on the card
(counterpart of scripts/diag_meshgen128.py).

    python3 -m giga_tpu_torch.scripts.diag_meshgen128 [--reps 9] [--scenes 6]
        [--device cuda]

Run from the repository root. The shipped GIGA-Geo checkpoint through the
129^3 band program (resolution0 32, 2 upsampling steps): (a) bench.py's
scene (``RandomState(0)`` draws both the scene and its surface samples),
its median over ``--reps`` warm ``generate_mesh`` calls, the spread, the
call's own stage times and one call's split (encode and program by CUDA
events, fetch, host marching: profile_meshgen.split_call); (b) per-scene
medians over seeds 0 .. ``--scenes`` - 1, with each one's decode and
marching times, and the mean, deviation and range across scenes. Every
line stands beside the card's name and power limit; the last is one JSON
object. ``--device cpu`` is a rehearsal by the host clock.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def measure_scene(gen, tsdf, reps: int):
    """(wall seconds of ``reps`` warm generate_mesh calls, the last stats)."""
    ts, stats = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        _, stats = gen.generate_mesh(tsdf)
        ts.append(time.perf_counter() - t0)
    return np.asarray(ts), stats


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--scenes", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from giga_tpu_torch.core.device import resolve_device
    from giga_tpu_torch.geometry.generation import MeshGenerator
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.scripts.profile_batched import card_line
    from giga_tpu_torch.scripts.profile_meshgen import CHECKPOINT, SIZE, bench_scenes, split_call
    from giga_tpu_torch.utils.synthetic import mesh_to_tsdf, random_scene

    device = resolve_device(args.device)
    card = card_line(device)
    net, _ = load_network(CHECKPOINT, "giga_geo")
    gen = MeshGenerator(net, resolution0=32, upsampling_steps=2, device=device)

    tsdf = bench_scenes(1)[0]
    gen.generate_mesh(tsdf, return_stats=False)  # warm
    ts, stats = measure_scene(gen, tsdf, args.reps)
    bench = {"median_ms": float(np.median(ts)) * 1e3, "min_ms": float(ts.min()) * 1e3,
             "max_ms": float(ts.max()) * 1e3,
             "stats_ms": {k: v * 1e3 for k, v in stats.items() if k.startswith("time")}}
    print(f"bench scene: median {bench['median_ms']:.3f} ms over {args.reps} reps, spread "
          f"[{bench['min_ms']:.3f}, {bench['max_ms']:.3f}] | {card}")
    for k, v in bench["stats_ms"].items():
        print(f"  {k}: {v:.3f} ms")
    if device.type == "cuda":
        bench["split"] = {k: v for k, v in split_call(gen, tsdf, 10000).items()
                          if k not in ("simplify", "faces")}
        print(f"  one call: encode {bench['split']['encode']:.3f} ms, program "
              f"{bench['split']['program']:.3f} ms, fetch {bench['split']['fetch']:.3f} ms "
              f"(CUDA events), marching {bench['split']['marching']:.3f} ms (host) | {card}")

    print(f"per-scene medians ({args.scenes} scenes x {args.reps} reps):")
    per = []
    for seed in range(args.scenes):
        rs = np.random.RandomState(seed)
        grid = np.squeeze(mesh_to_tsdf(random_scene(rs, SIZE), SIZE, 40, rng=rs))
        ts, stats = measure_scene(gen, grid, args.reps)
        row = {"seed": seed, "median_ms": float(np.median(ts)) * 1e3,
               "eval_ms": stats.get("time (eval points)", 0.0) * 1e3,
               "marching_ms": stats.get("time (marching cubes)", 0.0) * 1e3}
        per.append(row)
        print(f"  seed {seed}: {row['median_ms']:.3f} ms (eval {row['eval_ms']:.3f} / marching "
              f"{row['marching_ms']:.3f}) | {card}")
    meds = np.asarray([r["median_ms"] for r in per])
    across = {"mean_ms": float(meds.mean()), "std_ms": float(meds.std()),
              "min_ms": float(meds.min()), "max_ms": float(meds.max())}
    print(f"cross-scene: mean {across['mean_ms']:.3f} ms, std {across['std_ms']:.3f}, range "
          f"[{across['min_ms']:.3f}, {across['max_ms']:.3f}] | {card}")
    print(json.dumps({"script": "diag_meshgen128", "card": card, "bench_scene": bench,
                      "per_scene": per, "across": across}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
