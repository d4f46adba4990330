"""Mesh voxelization (counterpart of giga_tpu/geometry/voxelize.py; role of
the reference's libvoxelize and ConvONets' VoxelGrid utilities).

``voxelize_solid``: voxel centres inside the mesh, by the native
containment test. ``voxelize_surface``: the voxels a triangle overlaps,
by the exact triangle / box separating-axis test in the port's geometry
library (geometry/csrc/voxelize.cpp). ``voxelize_surface_sampled`` marks the
voxels that stratified surface samples fall in: a subset of the exact
result, kept as its plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np

from giga_tpu_torch.geometry.mesh import TriMesh
from giga_tpu_torch.geometry.native import check_mesh_contains, get_lib


def voxelize_solid(mesh: TriMesh, resolution: int, bounds=None) -> np.ndarray:
    """(R, R, R) bool: voxel centres inside the (watertight) mesh."""
    lo, hi = _bounds(mesh, bounds)
    lin = [lo[d] + (np.arange(resolution) + 0.5) * (hi[d] - lo[d]) / resolution for d in range(3)]
    centers = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    return check_mesh_contains(mesh, centers).reshape(resolution, resolution, resolution)


def voxelize_surface(mesh: TriMesh, resolution: int, bounds=None, rng=None) -> np.ndarray:
    """(R, R, R) bool: the voxels the mesh surface overlaps (exact)."""
    if mesh.is_empty():
        return np.zeros((resolution,) * 3, bool)
    lo, hi = (np.ascontiguousarray(b, np.float64) for b in _bounds(mesh, bounds))
    verts = np.ascontiguousarray(mesh.vertices, np.float64)
    faces = np.ascontiguousarray(mesh.faces, np.int64)
    out = np.zeros(resolution ** 3, np.uint8)
    D, I = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    rc = get_lib().voxelize_surface_exact(
        verts.ctypes.data_as(D), len(verts), faces.ctypes.data_as(I), len(faces), resolution,
        lo.ctypes.data_as(D), hi.ctypes.data_as(D),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"voxelize_surface_exact failed ({rc})")
    return out.astype(bool).reshape(resolution, resolution, resolution)


def voxelize_surface_sampled(mesh: TriMesh, resolution: int, bounds=None,
                             samples_per_voxel_area: float = 4.0, rng=None) -> np.ndarray:
    """The voxels that surface samples (about ``samples_per_voxel_area`` a
    voxel face's area, 1,000 to 4,000,000) and the vertices fall in."""
    rng = rng or np.random
    lo, hi = _bounds(mesh, bounds)
    cell = (hi - lo) / resolution
    if mesh.is_empty():
        return np.zeros((resolution,) * 3, bool)
    n = int(np.ceil(samples_per_voxel_area * mesh.area / max(float(np.min(cell)) ** 2, 1e-12)))
    pts, _ = mesh.sample_surface(int(np.clip(n, 1000, 4_000_000)), rng=rng)
    pts = np.concatenate([pts, mesh.vertices])
    idx = np.floor((pts - lo) / cell).astype(int)
    idx = idx[np.all((idx >= 0) & (idx < resolution), axis=1)]
    out = np.zeros((resolution,) * 3, bool)
    out[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    return out


def _bounds(mesh: TriMesh, bounds):
    if bounds is not None:
        return np.asarray(bounds[0], float), np.asarray(bounds[1], float)
    b = mesh.bounds
    return b[0], b[1]
