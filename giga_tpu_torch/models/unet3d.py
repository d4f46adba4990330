"""3D U-Net of the 'grid' feature branch (counterpart of
giga_tpu/models/unet3d.py; reference: ConvONets/encoder/unet3d.py:361-500,
the pytorch-3dunet ``UNet3D`` with ``DoubleConv`` blocks and layer order
'gcr').

  * SingleConv: GroupNorm (8 groups, 1 below 8 channels, eps 1e-5) ->
    Conv3d(k3, p1, no bias) -> ReLU.
  * DoubleConv: in an encoder level conv1 gives max(out // 2, in) channels;
    in a decoder level in -> out -> out.
  * Encoder levels: MaxPool3d(2) before every level but the first.
  * Decoder levels: a nearest resize to the skip's size by the JAX
    package's index formula (``nearest_resize``), cat([skip, x]) on
    channels, DoubleConv with in = f[i] + f[i+1].
  * A final 1x1 Conv3d with bias, no activation.

Module names are the reference's (``encoders.{i}.basic_module.SingleConv1
.groupnorm``, ``decoders.{i}...``, ``final_conv``), so the state dict reads
as the reference's. The public layout is channels-last (B, D, H, W, C) like
the JAX module's; the convolutions run on the NCDHW view of it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def feature_maps(f_maps: int, num_levels: int) -> list:
    return [f_maps * 2 ** k for k in range(num_levels)]


class SingleConvGCR(nn.Sequential):
    """groupnorm -> conv3d (no bias) -> relu (reference order 'gcr')."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int = 8):
        groups = num_groups if in_channels >= num_groups else 1
        super().__init__()
        self.add_module("groupnorm", nn.GroupNorm(groups, in_channels, eps=1e-5))
        self.add_module("conv", nn.Conv3d(in_channels, out_channels, 3, padding=1, bias=False))
        self.add_module("ReLU", nn.ReLU())


class DoubleConv3D(nn.Sequential):
    def __init__(self, in_channels: int, out_channels: int, encoder: bool, num_groups: int = 8):
        mid = max(out_channels // 2, in_channels) if encoder else out_channels
        super().__init__()
        self.add_module("SingleConv1", SingleConvGCR(in_channels, mid, num_groups))
        self.add_module("SingleConv2", SingleConvGCR(mid, out_channels, num_groups))


class _Level(nn.Module):
    """A level holding its DoubleConv as ``basic_module``, the reference's name."""

    def __init__(self, basic_module: nn.Module):
        super().__init__()
        self.basic_module = basic_module

    def forward(self, x):
        return self.basic_module(x)


def nearest_resize(x: torch.Tensor, sizes) -> torch.Tensor:
    """Nearest resize of an NCDHW tensor's three spatial axes to ``sizes``:
    row i of an axis of n rows resized to m takes row floor(i * (n / m)),
    the JAX package's float32 formula (F.interpolate's own scale may pick
    other rows at sizes that do not divide)."""
    for axis, out in zip((2, 3, 4), sizes):
        n = x.shape[axis]
        if n == out:
            continue
        pos = torch.arange(out, dtype=torch.float32, device=x.device) * (n / out)
        x = torch.index_select(x, axis, torch.floor(pos).to(torch.int64))
    return x


class UNet3D(nn.Module):
    """(B, D, H, W, in_channels) -> (B, D, H, W, out_channels)."""

    def __init__(self, in_channels: int, out_channels: int, f_maps: int = 32,
                 num_levels: int = 3, num_groups: int = 8):
        super().__init__()
        fmaps = feature_maps(f_maps, num_levels)
        self.encoders = nn.ModuleList()
        ins = in_channels
        for f in fmaps:
            self.encoders.append(_Level(DoubleConv3D(ins, f, encoder=True,
                                                     num_groups=num_groups)))
            ins = f
        self.decoders = nn.ModuleList()
        for i in range(num_levels - 1, 0, -1):
            self.decoders.append(_Level(DoubleConv3D(fmaps[i - 1] + fmaps[i], fmaps[i - 1],
                                                     encoder=False, num_groups=num_groups)))
        self.final_conv = nn.Conv3d(fmaps[0], out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)
        skips = []
        for i, level in enumerate(self.encoders):
            if i > 0:
                x = F.max_pool3d(x, 2, 2)
            x = level(x)
            skips.append(x)
        for level, skip in zip(self.decoders, reversed(skips[:-1])):
            x = nearest_resize(x, skip.shape[2:])
            x = level(torch.cat([skip, x], dim=1))
        return self.final_conv(x).permute(0, 2, 3, 4, 1)
