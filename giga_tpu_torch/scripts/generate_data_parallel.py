#!/usr/bin/env python3
"""Self-supervised grasp-trial data generation (counterpart of
scripts/generate_data_parallel.py; protocol of reference
scripts/generate_data_parallel.py).

    python3 -m giga_tpu_torch.scripts.generate_data_parallel ROOT
        [--scene pile|packed] [--object-set blocks] [--num-grasps 10000]
        [--grasps-per-scene 120] [--num-proc 1] [--seed S]
        [--urdf-root data/urdfs] [--device cuda]

Each worker owns a PyBullet sim. Per scene: spawn Poisson(4)+1 objects,
render 6 random viewpoints plus one canonical side view, fuse a 120^3 TSDF
for the surface cloud, then sample grasp candidates along surface normals
and label each by executing it at 6 yaw angles — the mid-point of the widest
run of successful yaws becomes the stored grasp.

Run from the repository root. The simulator needs pybullet; each worker
fuses its TSDFs on ``--device`` (the card unless it says otherwise).
Workers run in a pool of ``spawn``ed processes (a CUDA context does not
survive ``fork``), worker ``rank`` seeded with ``--seed`` + rank.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
from pathlib import Path

import numpy as np
import scipy.signal as signal

from giga_tpu_torch.core import io
from giga_tpu_torch.core.grasp import Grasp, Label
from giga_tpu_torch.core.perception import camera_on_sphere, create_tsdf
from giga_tpu_torch.core.transform import Rotation, Transform
from giga_tpu_torch.sim.simulation import ClutterRemovalSim
from giga_tpu_torch.utils.implicit import get_mesh_pose_list_from_world

OBJECT_COUNT_LAMBDA = 4
MAX_VIEWPOINT_COUNT = 6


def render_views(sim, view_specs):
    """Render depth images for (r, theta, phi) camera placements.

    Top-down-ish views orbit the workspace-floor center; the side view orbits
    a raised origin (matching the reference's two camera trajectories).
    """
    h, w = sim.camera.intrinsic.height, sim.camera.intrinsic.width
    depth_imgs = np.empty((len(view_specs), h, w), np.float32)
    extrinsics = np.empty((len(view_specs), 7), np.float32)
    for i, (origin_z, r, theta, phi) in enumerate(view_specs):
        origin = Transform(
            Rotation.identity(), np.r_[sim.size / 2, sim.size / 2, origin_z]
        )
        extrinsic = camera_on_sphere(origin, r, theta, phi)
        extrinsics[i] = extrinsic.to_list()
        depth_imgs[i] = sim.camera.render(extrinsic)[1]
    return depth_imgs, extrinsics


def random_top_views(sim, n):
    specs = [
        (
            0.0,
            np.random.uniform(1.6, 2.4) * sim.size,
            np.random.uniform(0.0, np.pi / 4.0),
            np.random.uniform(0.0, 2.0 * np.pi),
        )
        for _ in range(n)
    ]
    return render_views(sim, specs)


def side_views(sim, n=1, randomize=False):
    specs = []
    for _ in range(n):
        if randomize:
            specs.append(
                (
                    sim.size / 3,
                    np.random.uniform(1.6, 2.4) * sim.size,
                    np.random.uniform(np.pi / 4.0, 5.0 * np.pi / 12.0),
                    np.random.uniform(-np.pi, -3.0 * np.pi / 8.0),
                )
            )
        else:
            specs.append((sim.size / 3, 2 * sim.size, np.pi / 3.0, -np.pi / 2.0))
    return render_views(sim, specs)


def pick_surface_candidate(points, normals, finger_depth, eps=0.1,
                           max_attempts=200):
    """Random upward-facing surface point, pushed along its outward normal.

    Returns None after max_attempts (a scan can contain ONLY downward-facing
    normals, e.g. overhangs; the reference's unbounded loop hangs there)."""
    for _ in range(max_attempts):
        k = np.random.randint(len(points))
        if normals[k][2] > -0.1:
            depth_offset = np.random.uniform(
                -eps * finger_depth, (1.0 + eps) * finger_depth)
            return points[k] + normals[k] * depth_offset, normals[k]
    return None


def grasp_frame_from_normal(normal):
    """Right-handed frame with approach axis z = -normal."""
    z_axis = -normal
    x_axis = np.r_[1.0, 0.0, 0.0]
    if np.isclose(np.abs(np.dot(x_axis, z_axis)), 1.0, 1e-4):
        x_axis = np.r_[0.0, 1.0, 0.0]
    y_axis = np.cross(z_axis, x_axis)
    x_axis = np.cross(y_axis, z_axis)
    return Rotation.from_matrix(np.vstack((x_axis, y_axis, z_axis)).T)


def label_grasp_point(sim, pos, normal, num_rotations=6):
    """Execute at several yaws; return (grasp at widest-success-peak, label)."""
    base = grasp_frame_from_normal(normal)
    yaws = np.linspace(0.0, np.pi, num_rotations)
    outcomes, widths = [], []
    for yaw in yaws:
        ori = base * Rotation.from_euler("z", yaw)
        sim.restore_state()
        outcome, width = sim.execute_grasp(
            Grasp(Transform(ori, pos), width=sim.gripper.max_opening_width),
            remove=False,
        )
        outcomes.append(outcome)
        widths.append(width)

    ori = base * Rotation.from_euler("z", yaws[-1])
    width = widths[-1]
    successes = (np.asarray(outcomes) == Label.SUCCESS).astype(float)
    if successes.sum():
        peaks, props = signal.find_peaks(np.r_[0, successes, 0], height=1, width=1)
        best = peaks[np.argmax(props["widths"])] - 1
        ori = base * Rotation.from_euler("z", yaws[best])
        width = widths[best]
    return Grasp(Transform(ori, pos), width), int(np.max(outcomes))


def worker(args, rank):
    if getattr(args, "seed", None) is not None:
        np.random.seed(args.seed + rank)
    else:
        np.random.seed()
        np.random.seed(np.random.randint(0, 1000) + rank)
    device = getattr(args, "device", None)
    sim = ClutterRemovalSim(
        args.scene, args.object_set, gui=args.sim_gui,
        urdf_root=getattr(args, "urdf_root", "data/urdfs"), device=device,
    )
    quota = args.num_grasps // args.num_proc

    if rank == 0:
        (args.root / "scenes").mkdir(parents=True, exist_ok=True)
        io.write_setup(
            args.root, sim.size, sim.camera.intrinsic,
            sim.gripper.max_opening_width, sim.gripper.finger_depth,
        )
        if args.save_scene:
            (args.root / "mesh_pose_list").mkdir(parents=True, exist_ok=True)

    for _ in range(quota // args.grasps_per_scene):
        sim.reset(np.random.poisson(OBJECT_COUNT_LAMBDA) + 1)
        sim.save_state()

        depth_imgs, extrinsics = random_top_views(sim, MAX_VIEWPOINT_COUNT)
        depth_side, extr_side = side_views(sim, 1, args.random)

        tsdf = create_tsdf(sim.size, 120, depth_imgs, sim.camera.intrinsic, extrinsics,
                           device=sim.device)
        points, normals = tsdf.get_cloud(with_normals=True)
        keep = np.all((points >= sim.lower) & (points <= sim.upper), axis=1)
        points, normals = points[keep], normals[keep]
        if len(points) == 0:
            print("Point cloud empty, skipping scene")
            continue

        scene_id = io.write_sensor_data(args.root, depth_side, extr_side)
        if args.save_scene:
            mpl = get_mesh_pose_list_from_world(sim.world, args.object_set)
            io.write_point_cloud(
                args.root, scene_id, np.asarray(mpl, dtype=object), name="mesh_pose_list"
            )

        for _ in range(args.grasps_per_scene):
            cand = pick_surface_candidate(points, normals, sim.gripper.finger_depth)
            if cand is None:
                print("No upward-facing surface point, skipping scene")
                break
            point, normal = cand
            grasp, label = label_grasp_point(sim, point, normal)
            io.write_grasp(args.root, scene_id, grasp, label)
    print(f"Process {rank} finished!")


def main(args) -> None:
    if args.num_proc > 1:
        with mp.get_context("spawn").Pool(processes=args.num_proc) as pool:
            results = [pool.apply_async(func=worker, args=(args, i))
                       for i in range(args.num_proc)]
            for r in results:
                r.get()  # surface worker exceptions instead of exiting 0 silently
    else:
        worker(args, 0)


def parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("root", type=Path)
    parser.add_argument("--scene", type=str, choices=["pile", "packed"], default="pile")
    parser.add_argument("--object-set", type=str, default="blocks")
    parser.add_argument("--num-grasps", type=int, default=10000)
    parser.add_argument("--grasps-per-scene", type=int, default=120)
    parser.add_argument("--num-proc", type=int, default=1)
    parser.add_argument("--save-scene", action="store_true", default=True)
    parser.add_argument("--random", action="store_true")
    parser.add_argument("--sim-gui", action="store_true")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--urdf-root", type=str, default="data/urdfs")
    parser.add_argument("--device", type=str, default=None,
                        help="where each worker fuses its TSDFs (default: the card)")
    return parser


if __name__ == "__main__":
    main(parser().parse_args())
