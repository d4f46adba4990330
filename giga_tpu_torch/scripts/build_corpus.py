#!/usr/bin/env python3
"""Build a sharded synthetic grasp corpus: scenes, occupancy samples and
oracle-labeled grasps (counterpart of scripts/build_corpus.py).

    python3 -m giga_tpu_torch.scripts.build_corpus [--n-scenes 480]
        [--n-grasps 160] [--n-occ 8192] [--shard-size 60] [--size 0.3]
        [--seed 0] [--tag ""] [--out data/corpus]

Run from the repository root. One pass produces, per scene, the ideal
TSDF, pre-sampled occupancy points and labels, and oracle-labeled grasp
candidates (train/corpus.build_scene), sharded to
<out>/shard_<tag>NNN.npz; class balancing happens at sample time
(train/corpus.CorpusSampler). Scene i draws from RandomState(seed + i), so
shards are independent of build order and equal the JAX package's script's.
Resumable: existing shards are skipped. Host code only; no device.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    from giga_tpu_torch.train.corpus import build_scene, write_shard

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n-scenes", type=int, default=480)
    p.add_argument("--n-grasps", type=int, default=160)
    p.add_argument("--n-occ", type=int, default=8192)
    p.add_argument("--shard-size", type=int, default=60)
    p.add_argument("--size", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tag", type=str, default="",
                   help="shard filename tag (shard_<tag>NNN.npz)")
    p.add_argument("--out", type=str, default="data/corpus")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    n_shards = (args.n_scenes + args.shard_size - 1) // args.shard_size
    t0 = time.time()
    built = 0
    for shard in range(n_shards):
        path = out / f"shard_{args.tag}{shard:03d}.npz"
        lo = shard * args.shard_size
        hi = min(lo + args.shard_size, args.n_scenes)
        if path.exists():
            print(f"{path} exists, skipping", flush=True)
            continue
        scenes = [build_scene(np.random.RandomState(args.seed + i), args.size, args.n_occ,
                              args.n_grasps) for i in range(lo, hi)]
        write_shard(path, scenes)
        built += len(scenes)
        frac = np.mean([s["grasp_label"].mean() for s in scenes])
        print(f"{path}: {hi - lo} scenes, positive fraction {frac:.2f}, "
              f"{(time.time() - t0) / max(built, 1):.2f} s/scene", flush=True)
    print(f"corpus complete: {args.n_scenes} scenes in {out}")
    return 0


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    raise SystemExit(main())
