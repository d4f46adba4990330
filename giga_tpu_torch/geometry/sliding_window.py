"""Sliding-window mesh generation for scenes larger than the training
workspace (counterpart of giga_tpu/geometry/sliding_window.py; reference
conv_onet/generation.py:150-258 'pointcloud_crop').

The scene is tiled into query crops, with larger, overlapping input crops
for the encoder's context. Each crop is encoded and decoded on its own with
crop-normalized coordinates, the crops' value grids are placed into one
float64 grid on the host, and one mesh is extracted from it by the port's
``marching_tetrahedra``. Memory is bounded by one crop whatever the scene's
size.
"""

from __future__ import annotations

import numpy as np

from giga_tpu_torch.geometry.mesh import TriMesh
from giga_tpu_torch.geometry.native import marching_tetrahedra


def compute_crop_bounds(points: np.ndarray, query_crop_size: float, input_crop_size: float,
                        margin: float = 0.01) -> dict:
    """Tile the point cloud's bounding box into crops (reference
    get_crop_bound): 'query_vol' / 'input_vol' (n_crop, 2, 3) and
    'axis_n_crop' (3,); crops enumerate x-major, then y, z fastest."""
    lb = points.min(axis=0) - margin
    ub = points.max(axis=0) + margin
    axis_n = np.maximum(np.ceil((ub - lb) / query_crop_size).astype(int), 1)
    grids = [lb[d] + query_crop_size * np.arange(axis_n[d]) for d in range(3)]
    lo = np.stack(np.meshgrid(*grids, indexing="ij"), axis=-1).reshape(-1, 3)
    hi = lo + query_crop_size
    center = (lo + hi) / 2
    return {
        "query_vol": np.stack([lo, hi], axis=1),
        "input_vol": np.stack([center - input_crop_size / 2, center + input_crop_size / 2],
                              axis=1),
        "axis_n_crop": axis_n,
        "n_crop": int(np.prod(axis_n)),
        "query_crop_size": query_crop_size,
        "input_crop_size": input_crop_size,
    }


class SlidingWindowGenerator:
    """Assembles a scene mesh from per-crop implicit evaluations.

    Args:
        encode_crop_fn: (points (M, 3), input_vol (lo, hi)) -> a crop latent,
            given the scene points inside the input crop.
        eval_crop_fn: (latent, query points (N, 3) float32, input_vol) ->
            (N,) logits.
        resolution: query lattice a crop edge.
        threshold: occupancy probability iso level.
    """

    def __init__(self, encode_crop_fn, eval_crop_fn, resolution: int = 32,
                 threshold: float = 0.5, min_crop_points: int = 1):
        self.encode_crop_fn = encode_crop_fn
        self.eval_crop_fn = eval_crop_fn
        self.resolution = resolution
        self.threshold = threshold
        self.min_crop_points = min_crop_points

    def generate_mesh(self, points: np.ndarray, query_crop_size: float,
                      input_crop_size: float) -> TriMesh:
        """points (P, 3) -> TriMesh in world coordinates."""
        vb = compute_crop_bounds(points, query_crop_size, input_crop_size)
        r = self.resolution
        nxc, nyc, nzc = vb["axis_n_crop"]
        logit_th = float(np.log(self.threshold) - np.log(1.0 - self.threshold))
        value = np.full((nxc * r, nyc * r, nzc * r), -1e6, np.float64)
        for ci in range(vb["n_crop"]):
            in_lo, in_hi = vb["input_vol"][ci]
            q_lo, q_hi = vb["query_vol"][ci]
            crop_points = points[np.all((points >= in_lo) & (points <= in_hi), axis=1)]
            # the crop's query lattice (cell corners)
            lin = [np.linspace(q_lo[d], q_hi[d], r, endpoint=False) for d in range(3)]
            q = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
            if len(crop_points) >= self.min_crop_points:
                latent = self.encode_crop_fn(crop_points, (in_lo, in_hi))
                logits = np.asarray(self.eval_crop_fn(latent, q.astype(np.float32),
                                                      (in_lo, in_hi))).reshape(r, r, r)
            else:
                logits = np.full((r, r, r), -1e6)
            # crop index -> grid offset (x-major, z fastest like the reference)
            iz, iy, ix = ci % nzc, (ci // nzc) % nyc, ci // (nzc * nyc)
            value[ix * r:(ix + 1) * r, iy * r:(iy + 1) * r, iz * r:(iz + 1) * r] = logits
        padded = np.pad(value, 1, mode="constant", constant_values=-1e6)
        verts, faces = marching_tetrahedra(padded, logit_th)
        # index -> world: a cell is query_crop_size / r, the origin the scene's lb
        verts = (verts - 1.0) * (query_crop_size / r) + vb["query_vol"][0][0]
        return TriMesh(verts, faces)
