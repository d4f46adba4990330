"""PointNet++ per-point feature extractor (counterpart of
giga_tpu/models/pointnetpp.py; reference ConvONets/encoder/pointnetpp.py:105-130,
the standard set-abstraction / feature-propagation stack).

The JAX package's fixed-shape formulation, kept exactly:
  * ``square_distance`` is |a|^2 + |b|^2 - 2 a.b, in that order (a product,
    run with TF32 off on the card);
  * farthest-point sampling starts at point 0 and takes the first maximum
    of the running distance, ``npoint - 1`` steps on the device with no host
    sync inside;
  * a ball query keeps the ``nsample`` nearest points within the radius and
    fills the slots beyond their count with the nearest one; it and the
    3-nearest interpolation order ties by the lower index, as ``lax.top_k``
    does: a stable sort (``torch.topk`` orders ties otherwise);
  * ``SharedMLP``'s BatchNorm is flax's: momentum 0.99, epsilon 1e-5, the
    batch's biased variance in train mode, both for normalizing and for the
    running average (``torch.nn.BatchNorm1d`` keeps the unbiased one).

Train mode is the module's (``net.train()``), the JAX package's
``train=True``; its running statistics update in place. Each
set-abstraction and feature-propagation layer keeps the neighbours it
picked in its last call (``picked``: FPS and ball-query indices, or the
3-nearest) and, where ``neighbours`` is set, uses those instead of picking:
so one evaluation can be repeated on another device or in float64 on the
same neighbours (points at a ball's radius, or tied, may be picked
otherwise where the distances' last bits differ).
"""

from __future__ import annotations

import torch
from torch import nn

from giga_tpu_torch.core.precision import full_precision

BN_MOMENTUM = 0.99
BN_EPS = 1e-5


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, N, M) squared distances."""
    with full_precision():
        return (torch.sum(a ** 2, -1)[:, :, None] + torch.sum(b ** 2, -1)[:, None, :]
                - 2.0 * torch.einsum("bnd,bmd->bnm", a, b))


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) indices by iterative farthest-point sampling."""
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    dist = torch.full((B, N), float("inf"), dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    idx = [last]
    for _ in range(npoint - 1):
        d = torch.sum((xyz - xyz[rows, last][:, None, :]) ** 2, dim=-1)
        dist = torch.minimum(dist, d)
        last = torch.argmax(dist, dim=1)
        idx.append(last)
    return torch.stack(idx, dim=1)


def nearest_k(neg: torch.Tensor, k: int):
    """``lax.top_k(neg, k)``: the k largest along the last axis, ties by the
    lower index -> (values, indices)."""
    vals, idx = torch.sort(neg, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) x (B, S, 3) -> (B, S, nsample) neighbour indices: the nsample
    nearest within the radius, the slots beyond their count the nearest."""
    d2 = square_distance(new_xyz, xyz)
    masked = torch.where(d2 <= radius ** 2, d2, torch.full_like(d2, float("inf")))
    neg, idx = nearest_k(-masked, nsample)
    return torch.where(torch.isfinite(-neg), idx, idx[..., :1])


def _gather(f: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """f (B, N, D) at idx (B, ...) -> (B, ..., D)."""
    B, D = f.shape[0], f.shape[-1]
    flat = idx.reshape(B, -1)
    return torch.gather(f, 1, flat[..., None].expand(-1, -1, D)).reshape(*idx.shape, D)


class FlaxBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over every axis but the last: (x - mean) *
    (rsqrt(var + eps) * weight) + bias, the batch's mean and biased variance
    in train mode (each running average then moves by 1 - momentum), the
    running ones in eval mode."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = torch.mean(x, dim=axes)
            var = torch.mean((x - mean) ** 2, dim=axes)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.weight) + self.bias


class SharedMLP(nn.Module):
    """Per-point MLP (the reference's 1x1 convs): Linear, BatchNorm, ReLU per layer."""

    def __init__(self, in_features: int, channels: tuple):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"conv{i}", nn.Linear(in_features, c))
            self.add_module(f"bn{i}", FlaxBatchNorm(c))
            in_features = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


class SetAbstraction(nn.Module):
    """forward(xyz (B, N, 3), points (B, N, D)) -> (B, S, 3), (B, S, mlp[-1]):
    FPS centroids, ball-query groups of relative positions and features, the
    shared MLP, a max over each group (``group_all``: one group of every
    point around the origin)."""

    def __init__(self, npoint, radius, nsample, in_features: int, mlp: tuple,
                 group_all: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample, self.group_all = npoint, radius, nsample, group_all
        self.mlp = SharedMLP(in_features + 3, mlp)
        self.neighbours = self.picked = None

    def forward(self, xyz: torch.Tensor, points: torch.Tensor):
        if self.group_all:
            new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
            feats = torch.cat([xyz[:, None], points[:, None]], dim=-1)
        else:
            if self.neighbours is None:
                fps_idx = farthest_point_sample(xyz, self.npoint)
                group_idx = ball_query(self.radius, self.nsample, xyz, _gather(xyz, fps_idx))
            else:
                fps_idx, group_idx = self.neighbours
            self.picked = (fps_idx, group_idx)
            new_xyz = _gather(xyz, fps_idx)
            rel = _gather(xyz, group_idx) - new_xyz[:, :, None, :]
            feats = torch.cat([rel, _gather(points, group_idx)], dim=-1)  # (B, S, k, 3 + D)
        return new_xyz, torch.amax(self.mlp(feats), dim=2)


class FeaturePropagation(nn.Module):
    """Interpolates coarse features (xyz2, points2) onto xyz1 by inverse
    squared distance over the 3 nearest, concatenated after points1."""

    def __init__(self, in_features: int, mlp: tuple):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp)
        self.neighbours = self.picked = None

    def forward(self, xyz1, xyz2, points1, points2):
        B, N, _ = xyz1.shape
        if xyz2.shape[1] == 1:
            interpolated = points2.expand(B, N, points2.shape[-1])
        else:
            d2 = square_distance(xyz1, xyz2)
            if self.neighbours is None:
                neg, idx = nearest_k(-d2, 3)
            else:
                idx = self.neighbours
                neg = -torch.gather(d2, 2, idx)
            self.picked = idx
            w = 1.0 / (-neg + 1e-8)
            w = w / w.sum(dim=-1, keepdim=True)
            interpolated = (_gather(points2, idx) * w[..., None]).sum(dim=2)
        if points1 is not None:
            interpolated = torch.cat([points1, interpolated], dim=-1)
        return self.mlp(interpolated)


class PointNetPlusPlus(nn.Module):
    """The 3-level SA / FP stack: forward(xyz (B, N, 3)) -> (xyz, per-point
    features (B, N, c_dim))."""

    def __init__(self, c_dim: int = 32):
        super().__init__()
        self.sa1 = SetAbstraction(512, 0.2, 32, 3, (64, 64, 128))
        self.sa2 = SetAbstraction(128, 0.4, 64, 128, (128, 128, 256))
        self.sa3 = SetAbstraction(None, None, None, 256, (256, 512, 1024), group_all=True)
        self.fp3 = FeaturePropagation(256 + 1024, (256, 256))
        self.fp2 = FeaturePropagation(128 + 256, (256, 128))
        self.fp1 = FeaturePropagation(128, (128, 128, c_dim))

    def forward(self, xyz: torch.Tensor):
        with full_precision():
            l1_xyz, l1_points = self.sa1(xyz, xyz)
            l2_xyz, l2_points = self.sa2(l1_xyz, l1_points)
            l3_xyz, l3_points = self.sa3(l2_xyz, l2_points)
            l2_points = self.fp3(l2_xyz, l3_xyz, l2_points, l3_points)
            l1_points = self.fp2(l1_xyz, l2_xyz, l1_points, l2_points)
            return xyz, self.fp1(xyz, l1_xyz, None, l1_points)
