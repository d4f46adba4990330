"""Hierarchical iso-surface refinement on the host (counterpart of
giga_tpu/geometry/refine.py; role of the reference's MISE octree,
ConvONets/utils/libmise, driven by generation.py:126-142).

Instead of an incremental octree with per-point bookkeeping, each
refinement level doubles the grid resolution, re-evaluating ONLY points
inside active cells (cells whose corners straddle the threshold, dilated by
one cell), in one large batched query per level. Inactive regions keep
trilinearly-upsampled values — exactly the points whose sign is already
decided. Same asymptotic savings as MISE (evaluations concentrate on the
surface), with large queries that keep the card busy. The values are the
JAX package's bit for bit for the same ``eval_fn`` values. The mesh
generator's device refine chain (geometry/generation.py) is its mirror on
the card; this path is its fallback.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import binary_dilation


def _upsample_double(grid: np.ndarray) -> np.ndarray:
    """Trilinear upsampling from (n+1)^3 to (2n+1)^3 lattice values."""
    out = grid
    for axis in range(3):
        a = np.moveaxis(out, axis, 0)
        mid = 0.5 * (a[:-1] + a[1:])
        new = np.empty((2 * a.shape[0] - 1,) + a.shape[1:], a.dtype)
        new[0::2] = a
        new[1::2] = mid
        out = np.moveaxis(new, 0, axis)
    return out


def refine_grid(eval_fn, resolution0: int, upsampling_steps: int, threshold: float,
                coords_for_index=None):
    """Evaluate an implicit field on a (R+1)^3 lattice, R = res0 * 2^steps.

    Args:
        eval_fn: (N, 3) int index coords at the FINEST lattice scale, given as
            float fractions in [0, 1] -> (N,) field values.
        threshold: iso level; cells straddling it are refined.
    Returns:
        (R+1, R+1, R+1) array of field values (exact on/near the surface,
        interpolated in decided regions).
    """
    n = resolution0
    total = resolution0 * (2**upsampling_steps)

    # level 0: dense evaluation
    lin = np.linspace(0.0, 1.0, n + 1, dtype=np.float64)
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1).reshape(-1, 3)
    grid = np.asarray(eval_fn(pts), dtype=np.float64).reshape(n + 1, n + 1, n + 1)

    for _ in range(upsampling_steps):
        inside = grid > threshold
        # active cells: mixed corner signs
        c = inside
        all_in = (
            c[:-1, :-1, :-1] & c[1:, :-1, :-1] & c[:-1, 1:, :-1] & c[:-1, :-1, 1:]
            & c[1:, 1:, :-1] & c[1:, :-1, 1:] & c[:-1, 1:, 1:] & c[1:, 1:, 1:]
        )
        any_in = (
            c[:-1, :-1, :-1] | c[1:, :-1, :-1] | c[:-1, 1:, :-1] | c[:-1, :-1, 1:]
            | c[1:, 1:, :-1] | c[1:, :-1, 1:] | c[:-1, 1:, 1:] | c[1:, 1:, 1:]
        )
        active = any_in & ~all_in
        # dilate by one cell so the band survives sub-cell detail
        active = binary_dilation(active, iterations=1)

        n2 = 2 * (grid.shape[0] - 1)
        grid = _upsample_double(grid)

        # points needing exact evaluation: lattice points touching active cells
        touch = np.zeros((n2 + 1,) * 3, dtype=bool)
        act = np.repeat(np.repeat(np.repeat(active, 2, 0), 2, 1), 2, 2)  # fine cells
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    touch[dx : n2 + dx, dy : n2 + dy, dz : n2 + dz] |= act
        idx = np.argwhere(touch)
        if len(idx):
            pts = idx.astype(np.float64) / n2
            vals = np.asarray(eval_fn(pts), dtype=np.float64)
            grid[idx[:, 0], idx[:, 1], idx[:, 2]] = vals

    assert grid.shape[0] == total + 1
    return grid
