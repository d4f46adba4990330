"""Stacked local implicit decoder parameters (counterpart of
giga_tpu/models/decoder.py::StackedLocalDecoder; reference
ConvONets/conv_onet/models/decoder.py:61-176).

``heads`` LocalDecoders that share query points, their weights stacked
along a leading head axis with the JAX package's names and layouts:
fc_p_kernel (heads, 3, h), fc_c{i}_kernel (heads, 3*c_dim, h),
block{i}_fc{0,1}_kernel (heads, h, h), fc_out_kernel (heads, h, out_dim),
and a (heads, n) bias beside each. The lattice decode
(inference/dense_decode.py, ops/kernels/decoder.py) reads them through
``params()``; decoding at arbitrary query points is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from giga_tpu_torch.core.config import DecoderConfig


class StackedLocalDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig = DecoderConfig(), heads: int = 3, out_dim: int = 4):
        super().__init__()
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
