"""Plain reference of GIGA-Geo's reconstruction: the occupancy logits of
the decoder on the whole generation lattice, as ConvONet's generator
evaluates them (``make_3d_grid``: linspace(-box / 2, box / 2, n) along each
axis), in blocks of points so that any lattice fits."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.giga import GigaReference, grid_points

BLOCK = 1 << 18


def occupancy(ref: GigaReference, tsdf: np.ndarray, n: int, box: float) -> np.ndarray:
    """(n, n, n) float32 logits of one scene, x slowest."""
    grid = torch.from_numpy(np.ascontiguousarray(tsdf[None], np.float32)).to(ref.device)
    planes = ref.encode(grid)
    p = grid_points(torch.linspace(-box / 2, box / 2, n, device=ref.device))
    out = [ref.occupancy(planes, p[None, s:s + BLOCK])[0] for s in range(0, len(p), BLOCK)]
    return torch.cat(out).reshape(n, n, n).cpu().numpy()
