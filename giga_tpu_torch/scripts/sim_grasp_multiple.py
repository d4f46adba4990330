#!/usr/bin/env python3
"""Multi-seed clutter-removal benchmark (counterpart of
scripts/sim_grasp_multiple.py; protocol of reference
scripts/sim_grasp_multiple.py: 100 rounds x 5 objects per seed, seeds
{0..4}, GSR/DR aggregated mean +- std to JSON).

    python3 -m giga_tpu_torch.scripts.sim_grasp_multiple --model CKPT --type giga
        [--scene pile|packed] [--object-set blocks] [--num-rounds 100]
        [--seeds 0 1 2 3 4] [--best] [--urdf-root data/urdfs]
        [--precision fp32|bf16 (giga) or default|highest|bf16 (vgn)]
        [--device cuda] [--result-path FILE]

Run from the repository root. Dispatch: giga / giga_aff / giga_detach ->
GIGAPlanner, vgn -> VGNPlanner. The simulator needs pybullet; the planner
and the scans' TSDF fusion run on the card unless ``--device`` says
otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
GIGA_TYPES = ("giga", "giga_aff", "giga_detach")


def build_planner(args):
    from giga_tpu_torch.inference.planner import GIGAPlanner, VGNPlanner

    common = dict(
        best=args.best, qual_th=args.qual_th, force_detection=args.force,
        out_th=0.1, visualize=args.vis, device=args.device,
    )
    if args.precision:
        common["precision"] = args.precision
    if args.type in GIGA_TYPES:
        return GIGAPlanner(args.model, args.type, **common)
    if args.type == "vgn":
        return VGNPlanner(args.model, args.type, **common)
    raise NotImplementedError(f"model type {args.type!r} not implemented")


def main(args) -> dict:
    """Run every seed; returns the summary {"gsr"/"dr": {mean, std, val}}."""
    from giga_tpu_torch.experiments import clutter_removal
    from giga_tpu_torch.sim.noise import set_random_seed

    planner = build_planner(args)
    per_seed = {"gsr": [], "dr": []}
    for seed in args.seeds:
        set_random_seed(seed)
        gsr, dr = clutter_removal.run(
            grasp_plan_fn=planner,
            logdir=args.logdir,
            description=args.description,
            scene=args.scene,
            object_set=args.object_set,
            num_objects=args.num_objects,
            n=args.num_view,
            num_rounds=args.num_rounds,
            seed=seed,
            sim_gui=args.sim_gui,
            add_noise=args.add_noise,
            sideview=args.sideview,
            silence=args.silence,
            visualize=args.vis,
            urdf_root=args.urdf_root,
            device=args.device,
        )
        per_seed["gsr"].append(gsr)
        per_seed["dr"].append(dr)

    summary = {
        k: {"mean": float(np.mean(v)), "std": float(np.std(v)), "val": v}
        for k, v in per_seed.items()
    }
    print("Average results:")
    print(f"Grasp success rate: {summary['gsr']['mean']:.2f} +- {summary['gsr']['std']:.2f} %")
    print(f"Declutter rate: {summary['dr']['mean']:.2f} +- {summary['dr']['std']:.2f} %")
    if args.result_path:
        Path(args.result_path).write_text(json.dumps(summary, indent=2))
    return summary


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", type=Path, required=True)
    p.add_argument("--type", type=str, required=True)
    p.add_argument("--logdir", type=Path, default=Path("data/experiments"))
    p.add_argument("--description", type=str, default="")
    p.add_argument("--scene", type=str, choices=["pile", "packed"], default="pile")
    p.add_argument("--object-set", type=str, default="blocks")
    p.add_argument("--num-objects", type=int, default=5)
    p.add_argument("--num-view", type=int, default=1)
    p.add_argument("--num-rounds", type=int, default=100)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--qual-th", type=float, default=0.9)
    p.add_argument("--result-path", type=str)
    p.add_argument("--add-noise", type=str, default="")
    p.add_argument("--sim-gui", action="store_true")
    p.add_argument("--best", action="store_true",
                   help="take the best grasp instead of a random valid one")
    p.add_argument("--force", action="store_true",
                   help="fall back to the best sub-threshold grasp")
    p.add_argument("--sideview", action="store_true")
    p.add_argument("--silence", action="store_true")
    p.add_argument("--vis", action="store_true")
    p.add_argument("--urdf-root", type=str, default="data/urdfs",
                   help="root of the object sets and the setup/panda URDFs")
    p.add_argument("--precision", type=str, default=None,
                   help="planner precision: fp32 or bf16 for GIGA, default, highest or "
                        "bf16 for VGN (default: the planner's)")
    p.add_argument("--device", type=str, default=None,
                   help="where the planner and the TSDF fusion run (default: the card)")
    return p


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    main(parser().parse_args())
