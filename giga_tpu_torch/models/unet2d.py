"""2D U-Net over feature planes (counterpart of giga_tpu/models/unet2d.py;
reference: ConvONets/encoder/unet.py:48-239).

Module names follow the reference (``down_convs``, ``up_convs``,
``conv_final``) so the state dict reads like the reference's. The public
layout is channels-last (B, H, W, C) like the JAX module; the convolutions
run NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from giga_tpu_torch.core.config import UNet2DConfig
from giga_tpu_torch.models.layers import ConvTranspose2x2


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool over the last two axes of an NCHW tensor."""
    return F.max_pool2d(x, 2, 2)


class DownConv(nn.Module):
    """Two 3x3 convs (+ReLU) with an optional 2x2 max-pool."""

    def __init__(self, in_features: int, features: int, pooling: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.pooling = pooling

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        before_pool = x
        if self.pooling:
            x = max_pool_2x2(x)
        return x, before_pool


class UpConv(nn.Module):
    """2x2 transpose-conv upsample, skip merge [from_up, from_down], then two
    3x3 convs (+ReLU)."""

    def __init__(self, in_features: int, features: int, merge_mode: str = "concat"):
        super().__init__()
        self.upconv = ConvTranspose2x2(in_features, features)
        self.merge_mode = merge_mode
        merged = 2 * features if merge_mode == "concat" else features
        self.conv1 = nn.Conv2d(merged, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, from_down, from_up):
        from_up = self.upconv(from_up)
        if self.merge_mode == "concat":
            x = torch.cat([from_up, from_down], dim=1)
        else:
            x = from_up + from_down
        x = F.relu(self.conv1(x))
        return F.relu(self.conv2(x))


class UNet2D(nn.Module):
    """Configurable U-Net; spatial dims must divide by 2**(depth-1).
    (B, H, W, num_classes) -> (B, H, W, num_classes), as the encoder uses it."""

    def __init__(self, num_classes: int, cfg: UNet2DConfig = UNet2DConfig()):
        super().__init__()
        if cfg.up_mode != "transpose":
            raise NotImplementedError(f"up_mode {cfg.up_mode!r}")
        self.down_convs = nn.ModuleList()
        outs = num_classes
        for i in range(cfg.depth):
            ins, outs = outs, cfg.start_filts * (2 ** i)
            self.down_convs.append(DownConv(ins, outs, pooling=i < cfg.depth - 1))
        self.up_convs = nn.ModuleList()
        for i in range(cfg.depth - 1):
            ins, outs = outs, cfg.start_filts * (2 ** (cfg.depth - 2 - i))
            self.up_convs.append(UpConv(ins, outs, cfg.merge_mode))
        self.conv_final = nn.Conv2d(outs, num_classes, 1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        encoder_outs = []
        for down in self.down_convs:
            x, before_pool = down(x)
            encoder_outs.append(before_pool)
        for i, up in enumerate(self.up_convs):
            x = up(encoder_outs[-(i + 2)], x)
        return self.conv_final(x).permute(0, 2, 3, 1)
