#!/usr/bin/env python3
"""Build the processed training dataset from raw sensor data (counterpart of
scripts/construct_dataset_parallel.py; reference
scripts/construct_dataset_parallel.py).

    python3 -m giga_tpu_torch.scripts.construct_dataset_parallel RAW DATASET
        [--num-proc 1] [--single-view] [--add-noise dex|trans|norm]
        [--device cuda]

Run from the repository root. Re-integrates stored depth images (optionally
single-view, optionally with depth noise) into 40^3 TSDF grids, fused on
``--device`` (the card unless it says otherwise), converts the grasp table
to voxel units, and extracts workspace-cropped point clouds from a 120^3
fusion. With ``--num-proc`` above 1 the scenes go to a pool of ``spawn``ed
processes (a CUDA context does not survive ``fork``), each fusing on
``--device``.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
RESOLUTION = 40


def process_one_scene(args, size, intrinsic, path):
    from giga_tpu_torch.core import io
    from giga_tpu_torch.core.perception import create_tsdf
    from giga_tpu_torch.sim.noise import apply_noise

    if path.suffix != ".npz":
        return path.stem
    device = getattr(args, "device", None)
    depth_imgs, extrinsics = io.read_sensor_data(args.raw, path.stem)
    depth_imgs = np.array([apply_noise(d, args.add_noise) for d in depth_imgs])
    view = [0] if args.single_view else slice(None)
    tsdf = create_tsdf(size, RESOLUTION, depth_imgs[view], intrinsic, extrinsics[view],
                       device=device)
    io.write_voxel_grid(args.dataset, path.stem, tsdf.get_grid())

    pc = create_tsdf(size, 120, depth_imgs[view], intrinsic, extrinsics[view],
                     device=device).get_cloud()
    lower, upper = np.r_[0.02, 0.02, 0.055], np.r_[0.28, 0.28, 0.30]
    pc = pc[np.all((pc >= lower) & (pc <= upper), axis=1)]
    io.write_point_cloud(args.dataset, path.stem, pc)
    return path.stem


def main(args) -> None:
    from giga_tpu_torch.core import io

    if args.single_view:
        print("Loading first view only!")
    (args.dataset / "scenes").mkdir(parents=True, exist_ok=True)
    (args.dataset / "point_clouds").mkdir(parents=True, exist_ok=True)

    size, intrinsic, _, finger_depth = io.read_setup(args.raw)
    assert np.isclose(size, 6.0 * finger_depth)
    voxel_size = size / RESOLUTION

    # grasp table in voxel units (i, j, k)
    df = io.read_df(args.raw)
    for c in ("x", "y", "z", "width"):
        df.columns[c] = df[c] / voxel_size
    df.columns = {{"x": "i", "y": "j", "z": "k"}.get(k, k): v for k, v in df.columns.items()}
    io.write_df(df, args.dataset)

    files = sorted((args.raw / "scenes").iterdir())
    if args.num_proc > 1:
        with mp.get_context("spawn").Pool(processes=args.num_proc) as pool:
            results = [pool.apply_async(process_one_scene, args=(args, size, intrinsic, f))
                       for f in files]
            for r in results:
                r.get()  # surface worker exceptions
    else:
        for f in files:
            process_one_scene(args, size, intrinsic, f)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("raw", type=Path)
    p.add_argument("dataset", type=Path)
    p.add_argument("--num-proc", type=int, default=1)
    p.add_argument("--single-view", action="store_true")
    p.add_argument("--add-noise", type=str, default="")
    p.add_argument("--device", type=str, default=None,
                   help="where the TSDFs are fused (default: the card)")
    return p


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    main(parser().parse_args())
