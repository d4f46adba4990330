#!/usr/bin/env python3
"""Pre-sample occupancy supervision points per scene (counterpart of
scripts/save_occ_data_parallel.py; reference scripts/save_occ_data_parallel.py).

    python3 -m giga_tpu_torch.scripts.save_occ_data_parallel RAW
        NUM_POINT_PER_FILE NUM_FILE [--num-proc 1] [--uniform]

Run from the repository root. For each recorded mesh_pose_list, samples
num_point_per_file * num_file points in the scene bbox (or uniformly in the
workspace) from numpy's global generator, labels them by mesh containment
(the host C++ library), and stores float16 shards under occ/<scene_id>/.
Host code only; with ``--num-proc`` above 1 the scenes go to a pool of
``spawn``ed processes, each drawing from its own freshly seeded generator.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def sample_occ(mesh_pose_list_path, num_point, uniform):
    from giga_tpu_torch.utils.implicit import get_scene_from_mesh_pose_list, sample_iou_points

    mesh_pose_list = np.load(mesh_pose_list_path, allow_pickle=True)["pc"]
    scene, mesh_list = get_scene_from_mesh_pose_list(mesh_pose_list, return_list=True)
    return sample_iou_points(mesh_list, scene.bounds, num_point, uniform=uniform)


def save_occ(mesh_pose_list_path, args):
    points, occ = sample_occ(
        mesh_pose_list_path, args.num_point_per_file * args.num_file, args.uniform
    )
    points = points.astype(np.float16).reshape(args.num_file, args.num_point_per_file, 3)
    occ = occ.reshape(args.num_file, args.num_point_per_file)
    name = Path(mesh_pose_list_path).stem
    save_root = Path(args.raw) / "occ" / name
    save_root.mkdir(parents=True, exist_ok=True)
    for i in range(args.num_file):
        np.savez(save_root / f"{i:04d}.npz", points=points[i], occ=occ[i])
    return name


def main(args) -> None:
    files = sorted(Path(args.raw).glob("mesh_pose_list/*.npz"))
    t0 = time.time()
    if args.num_proc > 1:
        with mp.get_context("spawn").Pool(processes=args.num_proc) as pool:
            results = [pool.apply_async(save_occ, args=(f, args)) for f in files]
            for done, r in enumerate(results, 1):
                r.get()  # surface worker exceptions
                if done % 1000 == 0:
                    print(f"{done:05d}/{len(files):05d} finished, {time.time() - t0:.0f}s")
    else:
        for f in files:
            save_occ(f, args)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("raw", type=str)
    p.add_argument("num_point_per_file", type=int)
    p.add_argument("num_file", type=int)
    p.add_argument("--num-proc", type=int, default=1)
    p.add_argument("--uniform", action="store_true")
    return p


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    main(parser().parse_args())
