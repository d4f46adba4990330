"""Feature-plane sampling with exact torch ``grid_sample`` semantics.

Counterpart of giga_tpu/ops/sampling.py for the planner's lattice path. The
GIGA decoders sample each 2D feature plane with ``grid_sample(bilinear,
padding_mode='border', align_corners=True)`` after normalizing coordinates
to [0, 1] (reference ConvONets/common.py:238-261). On a tensor-product
lattice of query points that sampling factorizes into two small dense
matmuls per plane.

Conventions:
  * Points live in [-0.5, 0.5]^3.
  * ``normalize_coordinate``: u = p / (1 + padding + 1e-5) + 0.5, then
    values >= 1 become 1 - 1e-5 and values < 0 become 0 (not a clamp).
  * align_corners=True: u in [0, 1] maps to pixel coordinate u * (R - 1).
  * Plane layout (H, W, C): ``col`` indexes the first plane axis, ``row``
    the second.
"""

from __future__ import annotations

import torch


def normalize_coordinate(p2: torch.Tensor, padding: float = 0.0) -> torch.Tensor:
    """Map plane coordinates from [-0.5, 0.5] to [0, 1): divide by
    (1 + padding + 1e-5), shift by 0.5, set values >= 1 to 1 - 1e-5 and
    values < 0 to 0. Values in (1 - 1e-5, 1) pass through unchanged."""
    u = p2 / (1.0 + padding + 1e-5) + 0.5
    u = torch.where(u >= 1.0, torch.full_like(u, 1.0 - 1e-5), u)
    u = torch.where(u < 0.0, torch.zeros_like(u), u)
    return u


def interp_matrix_1d(coords: torch.Tensor, reso: int, padding: float = 0.0) -> torch.Tensor:
    """(N, reso) matrix M with M @ f == bilinear 1D interpolation of f at
    ``coords`` (raw coordinates in [-0.5, 0.5]); the lower tap index is
    clipped to reso - 2, so the last cell interpolates with weight 1."""
    u = normalize_coordinate(coords.to(torch.float32), padding)
    f = torch.clamp(u * (reso - 1), 0.0, reso - 1)
    i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, reso - 2)
    w = f - i0.to(f.dtype)
    cols = torch.arange(reso, device=coords.device)[None, :]
    m0 = (cols == i0[:, None]).to(f.dtype) * (1.0 - w)[:, None]
    m1 = (cols == (i0 + 1)[:, None]).to(f.dtype) * w[:, None]
    return m0 + m1


def sample_plane_lattice(plane: torch.Tensor, row_m: torch.Tensor, col_m: torch.Tensor):
    """Sample a (H, W, C) plane on the lattice of two 1D interp matrices:
    returns (Nrow, Ncol, C) = row_m @ plane @ col_m^T per channel."""
    t = torch.einsum("rh,hwc->rwc", row_m, plane)
    return torch.einsum("qw,rwc->rqc", col_m, t)
