"""Occupancy ground truth from simulator state (counterpart of
giga_tpu/utils/implicit.py; reference src/vgn/utils/implicit.py:33-96).

The scene mesh is assembled from (mesh_path, scale, pose) triples recorded
from the physics world, and labelled occupancy points are sampled through
the native containment test. The functions that read a world take any
object with a BtWorld's attributes (``bodies`` {uid: body with ``get_pose()``
and ``scale``}, and ``p``, the physics client's ``getBodyInfo`` /
``getVisualShapeData``); nothing here imports a simulator.
"""

from __future__ import annotations

import os

import numpy as np

from giga_tpu_torch.geometry.mesh import TriMesh, concatenate, load_mesh
from giga_tpu_torch.geometry.native import check_mesh_contains

N_IOU_POINTS = 100000
N_IOU_POINTS_FILES = 10


def get_mesh_pose_list_from_world(world, object_set, exclude_plane: bool = True):
    """[(mesh_path, scale, pose 4x4)] for every body of the world."""
    mesh_pose_list = []
    for uid, body in world.bodies.items():
        name = world.p.getBodyInfo(uid)[1].decode("utf8")
        if name == "plane" and exclude_plane:
            continue
        pose = body.get_pose().as_matrix()
        visuals = world.p.getVisualShapeData(uid)
        assert len(visuals) == 1, f"body {name} has {len(visuals)} visual shapes"
        mesh_path = visuals[0][4].decode("utf8")
        if mesh_path == "":
            mesh_path = os.path.join("./data/urdfs", object_set, name + ".urdf")
        mesh_pose_list.append((mesh_path, body.scale, pose))
    return mesh_pose_list


def get_scene_from_mesh_pose_list(mesh_pose_list, return_list: bool = False):
    """The posed meshes concatenated into one TriMesh (and the list)."""
    from giga_tpu_torch.utils.urdf import load_urdf_mesh

    mesh_list = []
    for mesh_path, scale, pose in mesh_pose_list:
        mesh = (load_urdf_mesh(mesh_path) if os.path.splitext(mesh_path)[1] == ".urdf"
                else load_mesh(mesh_path))
        mesh.apply_scale(scale)
        mesh.apply_transform(np.asarray(pose))
        mesh_list.append(mesh)
    scene = concatenate(mesh_list)
    return (scene, mesh_list) if return_list else scene


def as_mesh(scene_or_mesh) -> TriMesh:
    """A TriMesh as it is; a list of meshes concatenated."""
    if isinstance(scene_or_mesh, TriMesh):
        return scene_or_mesh
    return concatenate(list(scene_or_mesh))


def sample_iou_points(mesh_list, bounds, num_point, padding: float = 0.02,
                      uniform: bool = False, size: float = 0.3, rng=None):
    """Points in the (padded) scene box, or the workspace with ``uniform``,
    and their occupancy labels."""
    rng = rng or np.random
    points = rng.rand(num_point, 3).astype(np.float32)
    bounds = np.asarray(bounds)
    if uniform:
        points = points * (size + 2 * padding) - padding
    else:
        points = points * (bounds[[1]] + 2 * padding - bounds[[0]]) + bounds[[0]] - padding
    occ = np.zeros(num_point, dtype=bool)
    for mesh in mesh_list:
        occ |= check_mesh_contains(mesh, points)
    return points, occ


def get_occ_from_world(world, object_set, rng=None):
    """The standard 1M labelled occupancy points of one scene (pass ``rng``
    for reproducible points)."""
    scene, mesh_list = get_scene_from_mesh_pose_list(
        get_mesh_pose_list_from_world(world, object_set), return_list=True)
    return sample_iou_points(mesh_list, scene.bounds, N_IOU_POINTS * N_IOU_POINTS_FILES, rng=rng)
