"""On-device grasp post-processing: smooth -> mask -> bound -> select
(counterpart of giga_tpu/inference/postprocess.py).

Static-shape reimplementation of the reference host pipeline
(detection_implicit.py:87-185): Gaussian smoothing, surface-band masking
via masked dilation, width window, workspace border zeroing, LOW_TH /
threshold gating with the force-detection fallback, max-filter NMS and a
fixed-K top-K (-inf padded). Nothing here waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from giga_tpu_torch.core.config import PlannerConfig
from giga_tpu_torch.ops.filters import gaussian_blur_3d, masked_binary_dilation, max_filter_3d


class GraspCandidates(NamedTuple):
    """Top-K grasp candidates in normalized grid coordinates.

    scores: (..., K) descending, -inf past ``count``.
    positions: (..., K, 3) query-lattice coords.
    rotations: (..., K, 4) quaternions (xyzw).
    widths: (..., K) predicted widths (normalized units).
    count: (...) int32, number of valid candidates.
    """

    scores: torch.Tensor
    positions: torch.Tensor
    rotations: torch.Tensor
    widths: torch.Tensor
    count: torch.Tensor


def mask_quality(qual, tsdf, width, cfg: PlannerConfig):
    """Smoothing + surface-band + width-window masking (reference process())."""
    qual = gaussian_blur_3d(qual, cfg.gaussian_sigma)
    outside = tsdf > cfg.out_th
    inside = (tsdf > 1e-3) & (tsdf < cfg.out_th)
    valid = masked_binary_dilation(outside, ~inside, iterations=2)
    zero = torch.zeros((), dtype=qual.dtype, device=qual.device)
    qual = torch.where(valid, qual, zero)
    return torch.where((width < cfg.min_width) | (width > cfg.max_width), zero, qual)


def bound_quality(qual, voxel_size: float, cfg: PlannerConfig):
    """Zero out workspace borders (reference bound()); last 3 axes spatial.
    Margins truncate with int() on Python floats, as the reference does."""
    lx = int(cfg.bound_limits[0] / voxel_size)
    ly = int(cfg.bound_limits[1] / voxel_size)
    lz = int(cfg.bound_limits[2] / voxel_size)
    R = qual.shape[-1]
    ix = torch.arange(R, device=qual.device)
    mx = ((ix >= lx) & (ix < R - lx)).to(qual.dtype)
    my = ((ix >= ly) & (ix < R - ly)).to(qual.dtype)
    mz = (ix >= lz).to(qual.dtype)
    return qual * (mx[:, None, None] * my[None, :, None] * mz[None, None, :])


def select_grasps(qual, rot, width, positions, cfg: PlannerConfig) -> GraspCandidates:
    """One scene's threshold + NMS + top-K: qual (R, R, R), rot
    (R, R, R, 4), width (R, R, R), positions (R, R, R, 3) -> unbatched
    GraspCandidates, count a 0-d tensor. ``select_grasps_batched`` on a
    unit batch, so the two agree scene by scene."""
    cands = select_grasps_batched(qual[None], rot[None], width[None], positions, cfg)
    return GraspCandidates(*(t[0] for t in cands))


def select_grasps_batched(qual, rot, width, positions, cfg: PlannerConfig) -> GraspCandidates:
    """Batched threshold + NMS + top-K over (B, R, R, R) scenes.

    ``rot`` is (B, R, R, R, 4) or transposed (B, 4, R^3), the layout kernel
    K2 writes. ``positions`` is the shared (R, R, R, 3) lattice. Returns
    GraspCandidates with a leading batch axis on every field. Exact top-k
    by ``torch.topk``; ties at the k-th score may order equal candidates
    differently from the JAX package (same scores either way).
    """
    B = qual.shape[0]
    zero = torch.zeros((), dtype=qual.dtype, device=qual.device)
    q = torch.where(qual < cfg.low_th, zero, qual)
    any_above = (q >= cfg.qual_th).flatten(1).any(dim=1)
    best_only = ~any_above if cfg.force_detection else torch.zeros_like(any_above)
    q = torch.where(best_only[:, None, None, None], q, torch.where(q < cfg.qual_th, zero, q))

    max_vol = max_filter_3d(q, cfg.max_filter_size)
    peaks = (q == max_vol) & (q > 0.0)

    flat_scores = torch.where(peaks, q, torch.full_like(q, -torch.inf)).reshape(B, -1)
    k = min(cfg.max_grasps, flat_scores.shape[1])
    top_scores, top_idx = torch.topk(flat_scores, k, dim=1)
    count = peaks.flatten(1).sum(dim=1).to(torch.int32)
    count = torch.where(best_only, torch.clamp_max(count, 1), count)
    count = torch.clamp_max(count, k)
    rank = torch.arange(k, device=q.device)[None, :]
    top_scores = torch.where(rank < count[:, None], top_scores,
                             torch.full_like(top_scores, -torch.inf))

    top_pos = positions.reshape(-1, 3)[top_idx]
    if rot.ndim == 3:  # transposed (B, 4, R^3)
        top_rot = torch.gather(rot, 2, top_idx[:, None, :].expand(B, rot.shape[1], k))
        top_rot = top_rot.permute(0, 2, 1)
    else:
        flat_rot = rot.reshape(B, -1, 4)
        top_rot = torch.gather(flat_rot, 1, top_idx[..., None].expand(B, k, 4))
    top_width = torch.gather(width.reshape(B, -1), 1, top_idx)
    return GraspCandidates(top_scores, top_pos, top_rot.to(torch.float32),
                           top_width.to(torch.float32), count)
