"""Point -> plane / grid pooling by segment reductions (counterpart of
giga_tpu/ops/scatter.py; reference: torch_scatter's scatter_mean and
scatter_max in ConvONets/encoder/voxels.py:65 and pointnet.py:5).

Every function takes a batch: points (B, N, 3), features (B, N, C), and
reduces each scene's features into its own segments with one
``scatter_add_`` / ``scatter_reduce_`` over the whole batch, no Python loop
over scenes. Segments that no point reaches are 0, as torch_scatter fills
them.

On the card ``scatter_add_`` sums with atomics, so the order of a segment's
float32 sum (and its last bits) varies from run to run; the CPU sums in
point order, as XLA's CPU scatter does.
"""

from __future__ import annotations

import torch

from giga_tpu_torch.ops.sampling import PLANE_AXES, normalize_3d_coordinate, normalize_coordinate


def plane_index(p: torch.Tensor, plane_type: str, reso: int, padding: float = 0.0):
    """Flattened plane cell index of each point (reference: common.py:303-318):
    col + reso * row with col = floor(u0 * reso), row = floor(u1 * reso)."""
    a0, a1 = PLANE_AXES[plane_type]
    u = normalize_coordinate(torch.stack((p[..., a0], p[..., a1]), dim=-1), padding)
    ij = (u * reso).to(torch.int64)  # u >= 0: truncation is the floor
    return ij[..., 0] + reso * ij[..., 1]


def grid_index(p: torch.Tensor, reso: int, padding: float = 0.0):
    """Flattened 3D grid index (common.py:315-316): x + reso * (y + reso * z)."""
    ijk = (normalize_3d_coordinate(p, padding) * reso).to(torch.int64)
    return ijk[..., 0] + reso * (ijk[..., 1] + reso * ijk[..., 2])


def _expand(index: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    return index[..., None].expand(feat.shape)


def segment_mean(feat: torch.Tensor, index: torch.Tensor, num_segments: int):
    """(B, N, C) features + (B, N) segment ids -> (B, num_segments, C) means,
    0 where a segment is empty."""
    B, _, C = feat.shape
    total = feat.new_zeros((B, num_segments, C)).scatter_add_(1, _expand(index, feat), feat)
    count = feat.new_zeros((B, num_segments)).scatter_add_(1, index, torch.ones_like(index,
                                                                                     dtype=feat.dtype))
    return total / torch.clamp_min(count, 1.0)[..., None]


def segment_max(feat: torch.Tensor, index: torch.Tensor, num_segments: int):
    """(B, N, C) -> (B, num_segments, C) maxima; an empty segment is 0 (the
    reduction leaves the zero buffer where no point lands), a reached one
    its true maximum, negative or not."""
    B, _, C = feat.shape
    return feat.new_zeros((B, num_segments, C)).scatter_reduce_(
        1, _expand(index, feat), feat, "amax", include_self=False)


def scatter_mean_planes(points: torch.Tensor, feat: torch.Tensor, plane_type: str, reso: int,
                        padding: float = 0.0) -> torch.Tensor:
    """Batched point -> plane mean pooling: points (B, N, 3) in
    [-0.5, 0.5]^3, feat (B, N, C) -> (B, reso, reso, C), rows the second
    plane axis."""
    idx = plane_index(points, plane_type, reso, padding)
    return segment_mean(feat, idx, reso * reso).reshape(feat.shape[0], reso, reso, -1)


def scatter_mean_grid(points: torch.Tensor, feat: torch.Tensor, reso: int,
                      padding: float = 0.0) -> torch.Tensor:
    """Batched point -> 3D grid mean pooling -> (B, reso, reso, reso, C),
    indexed [b, z, y, x, c] (the flat index x + reso * (y + reso * z))."""
    idx = grid_index(points, reso, padding)
    return segment_mean(feat, idx, reso ** 3).reshape(feat.shape[0], reso, reso, reso, -1)
