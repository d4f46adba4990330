"""Layers of the GIGA encoder in PyTorch (counterpart of giga_tpu/models/layers.py).

Weights always come from a converted checkpoint or seeded parameter tree
(models/convert.py), so the layers keep PyTorch's default initialization.
"""

from __future__ import annotations

import torch
from torch import nn


class ConvStem3d(nn.Conv3d):
    """Conv3d(1 -> C, k, stride 1, zero 'same' padding): the plain form of
    the encoder's stem (giga_tpu ZBandedConvStem). Weight (C, 1, k, k, k)
    indexed [c, 0, dx, dy, dz] over a (B, 1, X, Y, Z) input."""

    def __init__(self, features: int, kernel_size: int = 3):
        super().__init__(1, features, kernel_size, padding=kernel_size // 2)


class ConvTranspose2x2(nn.ConvTranspose2d):
    """ConvTranspose2d(k=2, s=2): each input pixel emits a 2x2 block,
    out[o, 2i+di, 2j+dj] = sum_c in[c, i, j] * W[c, o, di, dj] + b[o].
    The JAX kernel (C_in, 2, 2, C_out) maps to W by transpose(0, 3, 1, 2)."""

    def __init__(self, in_features: int, features: int):
        super().__init__(in_features, features, kernel_size=2, stride=2)


class ResnetBlockFC(nn.Module):
    """Fully-connected ResNet block (giga_tpu/models/layers.py:60; reference
    ConvONets/layers.py:6-47): shortcut(x) + fc_1(relu(fc_0(relu(x)))),
    the shortcut a bias-free Linear where the sizes differ, else the
    identity. fc_1 starts at zero, as the reference initializes it."""

    def __init__(self, size_in: int, size_out: int | None = None, size_h: int | None = None):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        nn.init.zeros_(self.fc_1.weight)
        self.shortcut = nn.Linear(size_in, size_out, bias=False) if size_in != size_out else None

    def forward(self, x):
        dx = self.fc_1(torch.relu(self.fc_0(torch.relu(x))))
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + dx
