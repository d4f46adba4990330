"""Synthetic scene generation for self-contained end-to-end validation
(counterpart of giga_tpu/utils/synthetic.py; the same draws give the same
arrays).

Builds random tabletop-like scenes out of box/sphere meshes, computes
"ideal" TSDF grids (signed distance to the surface, truncated, in the
planner's [0, 1] convention) and labeled occupancy points — no simulator or
renderer required. Used by the E2E learning self-check and integration
tests: the full train -> reconstruct -> evaluate loop runs on these scenes.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from giga_tpu_torch.geometry.mesh import TriMesh, box_mesh, concatenate
from giga_tpu_torch.geometry.native import check_mesh_contains


def icosphere(radius: float, center, subdivisions: int = 2) -> TriMesh:
    """Subdivided icosahedron sphere."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        float,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts = list(map(tuple, verts))

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
                verts.append(tuple(m))
                edge_mid[key] = len(verts) - 1
            return edge_mid[key]

        for f in faces:
            a, b, c = (int(v) for v in f)
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = np.asarray(new_faces)
        verts = np.asarray(verts, float)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return TriMesh(verts * radius + np.asarray(center), faces)


def random_scene(rng, size: float = 0.3, n_objects: int = 3) -> TriMesh:
    """Random boxes + spheres resting in the [0, size]^3 workspace."""
    parts = []
    for _ in range(n_objects):
        kind = rng.choice(["box", "sphere"])
        if kind == "box":
            extents = rng.uniform(0.25, 0.5, 3) * size / 2
            center_xy = rng.uniform(0.3, 0.7, 2) * size
            center = [center_xy[0], center_xy[1], extents[2] / 2 + 0.05 * size]
            parts.append(box_mesh(extents, center))
        else:
            r = rng.uniform(0.08, 0.18) * size
            center_xy = rng.uniform(0.3, 0.7, 2) * size
            parts.append(icosphere(r, [center_xy[0], center_xy[1], r + 0.05 * size], 2))
    return concatenate(parts)


def mesh_to_tsdf(mesh: TriMesh, size: float, resolution: int,
                 trunc_voxels: float = 4.0, n_surface: int = 30000, rng=None) -> np.ndarray:
    """Ideal TSDF grid in the planner's convention ([0,1], 0.5 = surface).

    Distance via surface-sample cKDTree; sign via containment. Every voxel is
    'observed' (weightless ideal fusion).
    """
    rng = rng or np.random
    voxel_size = size / resolution
    trunc = trunc_voxels * voxel_size
    surf, _ = mesh.sample_surface(n_surface, rng=rng)
    tree = cKDTree(surf)
    lin = (np.arange(resolution) + 0.5) * voxel_size
    centers = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    # bounded query: distances beyond the truncation band clip to +-1 anyway,
    # and the upper bound prunes the kd-tree walk ~10x (scipy returns inf for
    # out-of-bound points, which clips identically)
    dist, _ = tree.query(centers, distance_upper_bound=trunc)
    inside = check_mesh_contains(mesh, centers)
    sdf = np.where(inside, -dist, dist)
    f = np.clip(sdf / trunc, -1.0, 1.0)
    return ((f + 1.0) * 0.5).reshape(resolution, resolution, resolution).astype(np.float32)


def make_occ_samples(mesh: TriMesh, size: float, n_points: int, rng) -> tuple:
    """(points metric, occ bool) sampled uniformly in the workspace."""
    points = rng.uniform(0, size, (n_points, 3)).astype(np.float32)
    occ = check_mesh_contains(mesh, points)
    return points, occ
