"""Stacked local implicit decoder (counterpart of
giga_tpu/models/decoder.py::StackedLocalDecoder and ``query_planes``;
reference ConvONets/conv_onet/models/decoder.py:61-176).

``heads`` LocalDecoders that share query points, their weights stacked
along a leading head axis with the JAX package's names and layouts:
fc_p_kernel (heads, 3, h), fc_c{i}_kernel (heads, 3*c_dim, h),
block{i}_fc{0,1}_kernel (heads, h, h), fc_out_kernel (heads, h, out_dim),
and a (heads, n) bias beside each. ``forward`` decodes at arbitrary query
points, every head in one batched product per layer; the lattice decode
(inference/dense_decode.py, ops/kernels/decoder.py) reads the weights
through ``params()``.

The point-model decoders (giga_tpu/models/decoder.py:90-219): FCDecoder
(summed plane samples and the point through one Linear), PatchLocalDecoder
(the crop model's: crop-normalized plane coordinates, clamped bilinear and
trilinear samplers, per-voxel local positions) and LocalPointDecoder
(features on the input points, a Gaussian-kernel softmax over them). Their
module names are the reference's (``fc_p``, ``fc_c.{i}``, ``blocks.{i}``,
``fc_out``, ``fc``); each forward runs under ``full_precision`` and takes
the batch at once (``torch.vmap`` over a scene's sampler).
"""

from __future__ import annotations

import torch
from torch import nn

from giga_tpu_torch.core.config import DecoderConfig
from giga_tpu_torch.core.precision import full_precision
from giga_tpu_torch.models.layers import ResnetBlockFC
from giga_tpu_torch.ops.sampling import (
    _divide,
    map2local,
    sample_grid,
    sample_plane,
    sample_planes_concat,
    sample_planes_concat_mm,
)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of two operands promoted to one dtype, as the JAX package's
    einsum promotes them (bf16 weights against float32 features: float32)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dtype), b.to(dtype))


class StackedLocalDecoder(nn.Module):
    """forward(planes {t: (B, H, W, C)}, p (B, N, 3), feature=None) ->
    (heads, B, N, out_dim) raw head outputs (no activations)."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig(), heads: int = 3, out_dim: int = 4):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        c_dim = cfg.c_dim * (3 if cfg.concat_feat else 1)
        self.n_blocks = cfg.n_blocks
        shapes = {"fc_p_kernel": (3, h), "fc_p_bias": (h,)}
        for i in range(cfg.n_blocks):
            shapes[f"fc_c{i}_kernel"] = (c_dim, h)
            shapes[f"fc_c{i}_bias"] = (h,)
            for fc in ("fc0", "fc1"):
                shapes[f"block{i}_{fc}_kernel"] = (h, h)
                shapes[f"block{i}_{fc}_bias"] = (h,)
        shapes["fc_out_kernel"] = (h, out_dim)
        shapes["fc_out_bias"] = (out_dim,)
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.zeros((heads,) + shape)))

    def params(self) -> dict:
        """{flax name: stacked tensor} for the functional decode paths."""
        return {name: p for name, p in self.named_parameters()}

    def forward(self, planes: dict, p: torch.Tensor, feature: torch.Tensor | None = None):
        """net = fc_p(p); per block net += fc_c(c), then ResnetBlockFC; out =
        fc_out(relu(net)), for every head at once; c is ``feature`` or the
        planes sampled at p (``query_planes``)."""
        w = self.params()
        c = query_planes(planes, p, self.cfg) if feature is None else feature

        def bias(name):
            return w[name][:, None, None, :]

        net = _einsum("bnd,edk->ebnk", p, w["fc_p_kernel"]) + bias("fc_p_bias")
        for i in range(self.n_blocks):
            net = net + _einsum("bnc,eck->ebnk", c, w[f"fc_c{i}_kernel"]) + bias(f"fc_c{i}_bias")
            hidden = (_einsum("ebnk,ekj->ebnj", torch.relu(net), w[f"block{i}_fc0_kernel"])
                      + bias(f"block{i}_fc0_bias"))
            dx = (_einsum("ebnk,ekj->ebnj", torch.relu(hidden), w[f"block{i}_fc1_kernel"])
                  + bias(f"block{i}_fc1_bias"))
            net = net + dx
        return _einsum("ebnk,eko->ebno", torch.relu(net), w["fc_out_kernel"]) + bias("fc_out_bias")


def query_planes(planes: dict, p: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """Plane (or grid) features at a batch of query sets: planes
    {t: (B, H, W, C)} (or {'grid': (B, D, H, W, C)}), p (B, N, 3).

    ``concat_feat`` concatenates the plane samples -> (B, N, 3C)
    (decoder.py:136-147), by gathers (``sampler="gather"``) or by matmuls
    (``"mm"``; ``"mm_highest"`` at full precision); otherwise, and always
    for a 'grid', the samples are summed -> (B, N, C) (decoder.py:149-158)."""
    B = p.shape[0]

    def scene(b):
        return {t: v[b] for t, v in planes.items()}

    if cfg.concat_feat and "grid" not in planes:
        if cfg.sampler in ("mm", "mm_highest"):
            precision = "highest" if cfg.sampler == "mm_highest" else None
            return torch.stack([sample_planes_concat_mm(scene(b), p[b], cfg.padding,
                                                        precision=precision)
                                for b in range(B)])
        return torch.stack([sample_planes_concat(scene(b), p[b], cfg.padding) for b in range(B)])

    def summed(b):
        c = 0
        for t, plane in scene(b).items():
            c = c + (sample_grid(plane, p[b], cfg.padding) if t == "grid"
                     else sample_plane(plane, p[b], t, cfg.padding))
        return c

    return torch.stack([summed(b) for b in range(B)])


def _sum_samples(planes: dict, p: torch.Tensor, padding: float) -> torch.Tensor:
    """Every plane (or grid) of {t: (B, ...)} sampled at p (B, N, 3), summed
    in the dict's order -> (B, N, C)."""
    c = 0
    for t, plane in planes.items():
        if t == "grid":
            c = c + torch.vmap(sample_grid, in_dims=(0, 0, None))(plane, p, padding)
        else:
            c = c + torch.vmap(sample_plane, in_dims=(0, 0, None, None))(plane, p, t, padding)
    return c


class FCDecoder(nn.Module):
    """Single-linear decoder (reference decoder.py:7-59): forward(planes,
    p (B, N, 3)) -> (B, N) (or (B, N, out_dim)) = fc([summed plane samples,
    p])."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig(), out_dim: int = 1):
        super().__init__()
        self.cfg, self.out_dim = cfg, out_dim
        self.fc = nn.Linear(cfg.c_dim + 3, out_dim)

    def forward(self, planes: dict, p: torch.Tensor) -> torch.Tensor:
        with full_precision():
            out = self.fc(torch.cat([_sum_samples(planes, p, self.cfg.padding), p], dim=-1))
        return out[..., 0] if self.out_dim == 1 else out


class _LocalStack(nn.Module):
    """net = fc_p(p); per block net = block(net + fc_c[i](c)); out =
    fc_out(relu(net)): the ResNet-FC stack the point decoders share."""

    def __init__(self, dim: int, c_dim: int, hidden: int, n_blocks: int, out_dim: int):
        super().__init__()
        self.out_dim = out_dim
        self.fc_p = nn.Linear(dim, hidden)
        self.fc_c = nn.ModuleList([nn.Linear(c_dim, hidden) for _ in range(n_blocks)])
        self.blocks = nn.ModuleList([ResnetBlockFC(hidden) for _ in range(n_blocks)])
        self.fc_out = nn.Linear(hidden, out_dim)

    def stack(self, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        net = self.fc_p(p)
        for fc_c, block in zip(self.fc_c, self.blocks):
            net = block(net + fc_c(c))
        out = self.fc_out(torch.relu(net))
        return out[..., 0] if self.out_dim == 1 else out


def sample_normalized(plane: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of one (H, W, C) plane at (N, 2) coordinates already
    in [0, 1] (giga_tpu/models/decoder.py:137-150): the coordinate clamped
    to [0, W - 1], the corner to at most W - 2."""
    H, W, _ = plane.shape
    fx = torch.clamp(u[:, 0] * (W - 1), 0.0, W - 1)
    fy = torch.clamp(u[:, 1] * (H - 1), 0.0, H - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, H - 2)
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]
    top = plane[y0, x0] * (1 - wx) + plane[y0, x0 + 1] * wx
    bot = plane[y0 + 1, x0] * (1 - wx) + plane[y0 + 1, x0 + 1] * wx
    return top * (1 - wy) + bot * wy


def sample_normalized_grid(grid: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of one [z, y, x, c] grid at (N, 3) coordinates in
    [0, 1] (giga_tpu/models/decoder.py:152-170), clamped as
    ``sample_normalized``."""
    D, H, W, _ = grid.shape
    fx = torch.clamp(u[:, 0] * (W - 1), 0.0, W - 1)
    fy = torch.clamp(u[:, 1] * (H - 1), 0.0, H - 1)
    fz = torch.clamp(u[:, 2] * (D - 1), 0.0, D - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, H - 2)
    z0 = torch.clamp(torch.floor(fz).to(torch.int64), 0, D - 2)
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]
    wz = (fz - z0)[:, None]

    def face(z):
        top = grid[z, y0, x0] * (1 - wx) + grid[z, y0, x0 + 1] * wx
        bot = grid[z, y0 + 1, x0] * (1 - wx) + grid[z, y0 + 1, x0 + 1] * wx
        return top * (1 - wy) + bot * wy

    return face(z0) * (1 - wz) + face(z0 + 1) * wz


class PatchLocalDecoder(_LocalStack):
    """The crop decoder (reference decoder.py:208-301): forward(p (B, N, 3)
    raw points, p_n {t: (B, N, 2 | 3)} crop-normalized coordinates, planes)
    -> (B, N) logits. Plane samples are summed; positions enter as
    ``map2local`` coordinates (``local_coord``), linear or sin/cos."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig(), out_dim: int = 1,
                 local_coord: bool = True, unit_size: float = 0.1, pos_encoding: str = "linear"):
        dim = 60 if local_coord and pos_encoding == "sin_cos" else 3
        super().__init__(dim, cfg.c_dim, cfg.hidden_size, cfg.n_blocks, out_dim)
        self.cfg = cfg
        self.local_coord, self.unit_size, self.pos_encoding = local_coord, unit_size, pos_encoding

    def forward(self, p: torch.Tensor, p_n: dict, planes: dict) -> torch.Tensor:
        with full_precision():
            c = 0
            for t, plane in planes.items():
                fn = sample_normalized_grid if t == "grid" else sample_normalized
                c = c + torch.vmap(fn)(plane, p_n[t])
            if self.local_coord:
                p = map2local(p, self.unit_size, self.pos_encoding)
            return self.stack(p, c)


# bytes of the (B, chunk, T, 3) query-point differences LocalPointDecoder
# forms at once
POINT_DECODE_BYTES = 1 << 30


class LocalPointDecoder(_LocalStack):
    """Point-interpolation decoder (reference decoder.py:303-391):
    forward(points (B, T, 3), point_feats (B, T, C), p (B, N, 3)) -> (B, N).
    A query's feature is the softmax over -||q - x||^2 / sigma^2 across the T
    input points, weighting their features; then the ResNet-FC stack. The
    (B, N, T) weights are formed in chunks of queries only where their
    differences pass POINT_DECODE_BYTES (each query's softmax and sum lie
    whole in its chunk)."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig(), out_dim: int = 1,
                 sigma: float = 0.1):
        super().__init__(3, cfg.c_dim, cfg.hidden_size, cfg.n_blocks, out_dim)
        self.cfg, self.sigma = cfg, sigma

    def forward(self, points: torch.Tensor, point_feats: torch.Tensor,
                p: torch.Tensor) -> torch.Tensor:
        B, T = points.shape[:2]
        chunk = max(1, POINT_DECODE_BYTES // (B * T * 3 * points.element_size()))
        with full_precision():
            cs = []
            for s in range(0, p.shape[1], chunk):
                q = p[:, s:s + chunk]
                d2 = torch.sum((q[:, :, None, :] - points[:, None, :, :]) ** 2, dim=-1)
                w = torch.softmax(_divide(-d2, self.sigma ** 2), dim=-1)
                cs.append(torch.einsum("bnt,btc->bnc", w, point_feats))
            return self.stack(p, torch.cat(cs, dim=1))
