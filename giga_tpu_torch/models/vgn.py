"""Dense VGN baseline network in PyTorch (counterpart of giga_tpu/models/vgn.py;
reference: src/vgn/networks.py:48-63, 172-212).

3D conv-deconv over the 40^3 TSDF with three dense prediction heads:
    encoder: 3 x stride-2 convs (16/32/64 channels, kernels 5/3/3), 40->5
    decoder: 3 convs, each followed by nearest x2 upsampling, back to 40^3
    heads:   k5 convs -> qual (sigmoid), rot (channel-normalized 4), width

Layout is NCDHW: a (B, R, R, R) TSDF enters as (B, 1, R, R, R), spatial
axes in the JAX package's order. Every conv pads k // 2 on each side. The
module and parameter names are the reference's (``encoder.conv1``,
``decoder.conv1``, ``conv_qual`` ...), so a reference state dict loads as is.

``trunk`` (encoder + decoder features) is separate so the planner can run
the three k=5 heads as one 6-channel conv (``fused_head_conv``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from giga_tpu_torch.core.config import VGNConfig
from giga_tpu_torch.models.conv_onet import normalize_quat

HEADS = ("conv_qual", "conv_rot", "conv_width")


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, k, stride=stride, padding=k // 2)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsampling on the three spatial axes of NCDHW."""
    for dim in (2, 3, 4):
        x = torch.repeat_interleave(x, 2, dim=dim)
    return x


class VGNNet(nn.Module):
    def __init__(self, cfg: VGNConfig = VGNConfig()):
        super().__init__()
        if len(cfg.encoder_filters) != 3 or len(cfg.decoder_filters) != 3:
            raise ValueError("VGN has three encoder and three decoder convs")
        self.cfg = cfg
        cin = 1
        self.encoder = nn.Module()
        for i, (f, k) in enumerate(zip(cfg.encoder_filters, cfg.encoder_kernels), 1):
            setattr(self.encoder, f"conv{i}", _conv(cin, f, k, stride=2))
            cin = f
        self.decoder = nn.Module()
        for i, (f, k) in enumerate(zip(cfg.decoder_filters, cfg.decoder_kernels), 1):
            setattr(self.decoder, f"conv{i}", _conv(cin, f, k))
            cin = f
        self.conv_qual = _conv(cin, 1, 5)
        self.conv_rot = _conv(cin, 4, 5)
        self.conv_width = _conv(cin, 1, 5)

    def trunk(self, tsdf: torch.Tensor) -> torch.Tensor:
        """(B, R, R, R) -> (B, C, R, R, R) pre-head features."""
        x = tsdf[:, None]
        for i in (1, 2, 3):
            x = F.relu(getattr(self.encoder, f"conv{i}")(x))
        for i in (1, 2, 3):
            x = upsample2(F.relu(getattr(self.decoder, f"conv{i}")(x)))
        return x

    def forward(self, tsdf: torch.Tensor):
        """(B, R, R, R) -> qual (B,R,R,R), rot (B,4,R,R,R), width (B,R,R,R)."""
        x = self.trunk(tsdf)
        qual = torch.sigmoid(self.conv_qual(x)[:, 0])
        rot = normalize_quat(self.conv_rot(x), dim=1)
        width = self.conv_width(x)[:, 0]
        return qual, rot, width


def fused_head_conv(net: VGNNet, x: torch.Tensor):
    """conv_qual, conv_rot and conv_width as one 6-channel k=5 conv over the
    trunk's features x (B, C, R, R, R), the weights in x's dtype; the bias
    added after the conv, as the JAX package's fused head does. Returns
    (qual (B,R,R,R), rot (B,4,R,R,R), width (B,R,R,R)) with the reference
    activations applied, in x's dtype. Output channels of a conv are
    independent dot products, so the fused conv computes what the three
    heads compute, in the channel order qual, rot (4), width."""
    heads = [getattr(net, n) for n in HEADS]
    w = torch.cat([h.weight for h in heads]).to(x.dtype)
    b = torch.cat([h.bias for h in heads]).to(x.dtype)
    out = F.conv3d(x, w, padding=2) + b[:, None, None, None]
    return torch.sigmoid(out[:, 0]), normalize_quat(out[:, 1:5], dim=1), out[:, 5]
