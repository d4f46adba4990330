#!/usr/bin/env python3
"""Run single clutter-removal rounds and save per-step world snapshots for
offline rendering (counterpart of scripts/sim_grasp_save_scene.py;
reference scripts/sim_grasp_save_scene.py).

    python3 -m giga_tpu_torch.scripts.sim_grasp_save_scene --model CKPT --type giga
        --save-dir DIR [--num-rounds 10] [--seed 42] [--urdf-root data/urdfs]
        [--precision ...] [--device cuda]

Run from the repository root. Each round writes its snapshots (mesh-pose
pickles every 8 simulation steps) to DIR/round_NNN, and DIR/results.json
holds (successes, attempts, objects) per round; render them with
``giga_tpu_torch.scripts.render_rollouts``. The planner and the scans' TSDF
fusion run on the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def build_planner(args):
    from giga_tpu_torch.inference.planner import GIGAPlanner, VGNPlanner

    extra = {"precision": args.precision} if args.precision else {}
    if "giga" in args.type:
        return GIGAPlanner(
            args.model, args.type, best=args.best, qual_th=args.qual_th,
            force_detection=args.force, out_th=args.out_th, resolution=args.res,
            device=args.device, **extra,
        )
    if args.type == "vgn":
        return VGNPlanner(
            args.model, args.type, best=args.best, qual_th=args.qual_th,
            force_detection=args.force, out_th=args.out_th, device=args.device, **extra,
        )
    raise NotImplementedError(f"model type {args.type} not implemented")


def main(args) -> dict:
    """Run the rounds; returns {round: (successes, attempts, objects)}."""
    from giga_tpu_torch.experiments import clutter_removal_single
    from giga_tpu_torch.sim.noise import set_random_seed

    planner = build_planner(args)
    set_random_seed(args.seed)
    results = {}
    for n in range(args.num_rounds):
        seed = int(np.random.randint(3000))
        save_dir = args.save_dir / f"round_{n:03d}"
        results[n] = clutter_removal_single.run(
            grasp_plan_fn=planner, save_dir=save_dir, scene=args.scene,
            object_set=args.object_set, num_objects=args.num_objects,
            n=args.num_view, seed=seed, sim_gui=args.sim_gui,
            add_noise=args.add_noise, sideview=args.sideview,
            urdf_root=args.urdf_root, device=args.device,
        )
        print(f"Round {n} finished, result: {results[n]}")
    with open(args.save_dir / "results.json", "w") as f:
        json.dump(results, f, indent=2)
    return results


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", type=Path, required=True)
    p.add_argument("--type", type=str, required=True)
    p.add_argument("--save-dir", type=Path, required=True)
    p.add_argument("--scene", type=str, choices=["pile", "packed"], default="pile")
    p.add_argument("--object-set", type=str, default="blocks")
    p.add_argument("--num-objects", type=int, default=5)
    p.add_argument("--num-view", type=int, default=1)
    p.add_argument("--num-rounds", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sim-gui", action="store_true")
    p.add_argument("--qual-th", type=float, default=0.9)
    p.add_argument("--out-th", type=float, default=0.5)
    p.add_argument("--res", type=int, default=40)
    p.add_argument("--best", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--add-noise", type=str, default="")
    p.add_argument("--sideview", action="store_true")
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
