#!/usr/bin/env python3
"""Where the time of VGN planning and TSDF fusion goes, on the card.

    python3 -m giga_tpu_torch.scripts.profile_vgn_fusion [--batch 64] [--iters 10]

Run from the repository root. Each line stands beside the card's name and
power limit:
  * VGN's batched program (B scenes of chip_smoke, the golden file's seeded
    weights) and its single-scene program, in each precision (``highest``:
    TF32 off, ``default``: TF32 on, ``bf16``): ms per call by CUDA events,
    then a torch.profiler trace of ``--iters`` warm calls: device time by
    kernel name, kernels per call, and the device's idle share;
  * ``fuse_views`` of the golden file's six 640x480 views at 40^3 and at
    120^3, the depth already on the card, traced the same way.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _report(name: str, fn, iters: int, card: str) -> None:
    import chip_smoke
    from giga_tpu_torch.scripts.profile_planner import _trace

    ms = chip_smoke.cuda_ms(fn, iters)
    busy, wall, rows = _trace(fn, iters)
    print(f"{name}: {ms:.3f} ms per call by CUDA events; traced {busy:.3f} ms device time "
          f"of {wall:.3f} ms wall, idle share {max(0.0, 1 - busy / wall):.3f}, "
          f"{sum(r[1] for r in rows)} kernels per call | {card}")
    for k_ms, calls, kname in rows[:6]:
        print(f"  {k_ms:8.3f} ms  x{calls:<3d} {kname[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description="Profile VGN planning and TSDF fusion on the card.")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_vgn_fusion: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from giga_tpu_torch.inference.planner import VGNPlanner
    from giga_tpu_torch.ops.tsdf import fuse_views

    card = chip_smoke.card_line()
    params = chip_smoke.unflatten_params(np.load(ROOT / chip_smoke.GOLDEN_VGN))
    grids = torch.from_numpy(chip_smoke.make_scenes(args.batch)).cuda()
    for precision in ("highest", "default", "bf16"):
        planner = VGNPlanner(params=params, precision=precision, **chip_smoke.VGN_KW)
        batched, single = planner._ensure_batched_fn(), planner._ensure_fn()
        with torch.inference_mode():
            _report(f"VGN {precision} batched program B={args.batch}",
                    lambda: batched(grids, grids), args.iters, card)
            _report(f"VGN {precision} single-scene program",
                    lambda: single(grids[0], grids[0]), 4 * args.iters, card)
    golden = np.load(ROOT / chip_smoke.GOLDEN_FUSION)
    depth = torch.from_numpy(golden["depth"][0]).cuda()
    K = torch.from_numpy(golden["K"]).cuda()
    E = torch.from_numpy(golden["extrinsics"]).cuda()
    for res in (chip_smoke.RESOLUTION, chip_smoke.FUSION_HIGH_RES):
        _report(f"fuse_views of {len(depth)} views at {res}^3",
                lambda: fuse_views(depth, K, E, resolution=res, size=chip_smoke.SIZE,
                                   sdf_trunc=4 * chip_smoke.SIZE / res), args.iters, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
