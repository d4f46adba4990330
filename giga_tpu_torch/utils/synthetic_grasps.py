"""Geometric grasp oracle for simulator-free affordance training
(counterpart of giga_tpu/utils/synthetic_grasps.py; the same draws give the
same labels).

Labels parallel-jaw grasps on synthetic scenes with a physics-free but
physically-meaningful criterion (in the spirit of antipodal analysis):

  success <=> both finger sweep volumes are collision-free AND the closing
  region between the fingers contains object surface.

Candidates follow the reference's data-generation geometry
(scripts/generate_data_parallel.py:133-179): a surface point pushed along its
outward normal, approach axis z = -normal, a sampled yaw about the approach
axis. Widths are measured from the surface span inside the closing region.

Used by the E2E self-check to train ALL GIGA heads (qual/rot/width/occ)
end-to-end without PyBullet.
"""

from __future__ import annotations

import numpy as np

from giga_tpu_torch.core.grasp import Grasp
from giga_tpu_torch.core.transform import Rotation, Transform
from giga_tpu_torch.geometry.mesh import TriMesh
from giga_tpu_torch.geometry.native import check_mesh_contains

FINGER_DEPTH = 0.05
MAX_OPENING = 0.08
FINGER_THICKNESS = 0.01


def grasp_frame(normal: np.ndarray, yaw: float) -> Rotation:
    """Right-handed frame with approach z = -normal, rotated by yaw about z."""
    z = -normal / np.linalg.norm(normal)
    x = np.r_[1.0, 0.0, 0.0]
    if abs(np.dot(x, z)) > 1.0 - 1e-4:
        x = np.r_[0.0, 1.0, 0.0]
    y = np.cross(z, x)
    y /= np.linalg.norm(y)
    x = np.cross(y, z)
    return Rotation.from_matrix(np.stack([x, y, z], axis=1)) * Rotation.from_euler("z", yaw)


def _box_points(rng, n, half_extents):
    return rng.uniform(-1.0, 1.0, (n, 3)) * half_extents


def evaluate_grasp(mesh: TriMesh, surface_points: np.ndarray, pose: Transform,
                   rng, n_probe: int = 64):
    """(label, width) for a TCP pose against the scene.

    Finger sweep volumes: boxes of FINGER_DEPTH depth at y = +-MAX_OPENING/2.
    Closing region: box between the fingers.
    """
    R = pose.rotation.as_matrix()
    t = pose.translation

    # finger collision probes (local frames of the two finger volumes)
    half = np.r_[FINGER_THICKNESS, FINGER_THICKNESS, FINGER_DEPTH / 2]
    local = _box_points(rng, n_probe, half)
    for side in (-1.0, 1.0):
        center = np.r_[0.0, side * MAX_OPENING / 2, FINGER_DEPTH / 2]
        pts = (local + center) @ R.T + t
        if check_mesh_contains(mesh, pts).any():
            return 0, MAX_OPENING

    # closing region: surface must be present between the fingers
    local_surf = (surface_points - t) @ R
    in_region = (
        (np.abs(local_surf[:, 0]) < FINGER_DEPTH * 0.4)
        & (np.abs(local_surf[:, 1]) < MAX_OPENING / 2)
        & (local_surf[:, 2] > 0.0)
        & (local_surf[:, 2] < FINGER_DEPTH)
    )
    if in_region.sum() < 5:
        return 0, MAX_OPENING
    span = local_surf[in_region, 1]
    width = float(np.clip(span.max() - span.min() + 0.01, 0.0, MAX_OPENING))
    return 1, width


def sample_labeled_grasps(mesh: TriMesh, size: float, n_grasps: int, rng,
                         n_surface: int = 20000, background_frac: float = 0.3):
    """Sample grasp candidates on a scene -> list[(Grasp, label)] (metric).

    A ``background_frac`` share of candidates is drawn uniformly in the
    workspace (rather than on surfaces) so the learned quality field is
    trained on the whole query distribution a dense grasp-grid planner
    probes — the oracle labels them honestly (almost always failures).
    """
    surf, fi, normals = mesh.sample_surface(n_surface, rng=rng, return_normals=True)
    out = []
    attempts = 0
    num_yaws = 6
    while len(out) < n_grasps and attempts < n_grasps * 20:
        attempts += 1
        if rng.rand() < background_frac:
            pos = rng.uniform(0.02, size - 0.02, 3)
            normal = rng.randn(3)
            normal[2] = abs(normal[2])  # approach from above-ish
            normal /= np.linalg.norm(normal)
        else:
            k = rng.randint(len(surf))
            normal = normals[k]
            if normal[2] < -0.1:  # never approach from below
                continue
            depth = rng.uniform(-0.1 * FINGER_DEPTH, 1.1 * FINGER_DEPTH)
            pos = surf[k] + normal * depth
            if np.any(pos < 0.02) or np.any(pos > size - 0.02):
                continue
        # reference protocol (generate_data_parallel.py:147-179): the POINT's
        # label is the best outcome over several yaws; the stored rotation is
        # a successful yaw when one exists
        yaws = np.linspace(0.0, np.pi, num_yaws)
        results = []
        for yaw in yaws:
            pose = Transform(grasp_frame(normal, yaw), pos)
            results.append((evaluate_grasp(mesh, surf, pose, rng), pose))
        successes = [i for i, ((lbl, _), _) in enumerate(results) if lbl]
        if successes:
            # midpoint of the WIDEST contiguous success run (the reference's
            # widest-peak rule): the probe-based oracle makes isolated
            # single-yaw successes noisy, and a mid-run yaw is the robust
            # rotation target for the rot head
            runs, start = [], successes[0]
            for prev, cur in zip(successes, successes[1:] + [None]):
                if cur != prev + 1:
                    runs.append((start, prev))
                    if cur is not None:
                        start = cur
            s, e = max(runs, key=lambda r: r[1] - r[0])
            (label, width), pose = results[(s + e) // 2]
        else:
            (label, width), pose = results[rng.randint(num_yaws)]
        out.append((Grasp(pose, width), label))
    return out


def grasps_to_batch_arrays(grasps_labels, size: float):
    """-> dict of arrays in normalized units (pos in [-0.5,0.5], width/size),
    with the two gripper-symmetric target quaternions."""
    Rz = Rotation.from_rotvec(np.pi * np.r_[0.0, 0.0, 1.0])
    pos, rots, width, label = [], [], [], []
    for g, lbl in grasps_labels:
        pos.append(g.pose.translation / size - 0.5)
        q = g.pose.rotation
        rots.append(np.stack([q.as_quat(), (q * Rz).as_quat()]))
        width.append(g.width / size)
        label.append(lbl)
    return {
        "pos": np.asarray(pos, np.float32),
        "rotations": np.asarray(rots, np.float32),
        "width": np.asarray(width, np.float32),
        "label": np.asarray(label, np.float32),
    }
