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
"""

from __future__ import annotations

import torch
from torch import nn

from giga_tpu_torch.core.config import DecoderConfig
from giga_tpu_torch.ops.sampling import (
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
