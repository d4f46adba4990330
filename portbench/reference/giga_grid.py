"""Plain PyTorch reference of giga_grid, in float32: GIGA's decoders on
ConvONet's 3D feature-grid encoder.

Written from ConvONet (Peng et al., ECCV 2020,
https://github.com/autonomousvision/convolutional_occupancy_networks:
``configs/voxel/shapenet_grid32.yaml`` with ``plane_type: grid``, ``unet3d``,
``num_levels: 3``, ``f_maps: 32``; ``LocalVoxelEncoder`` and its
``generate_grid_features``, ``encoder/unet3d.py``) and GIGA's LocalDecoder
heads, with no kernel, no lattice factorization and no batching trick:

  * Conv3d(1 -> c_dim, k3, p1) and ReLU on the (B, 1, X, Y, Z) TSDF;
  * ConvONet's scatter-mean of the voxel features onto the grid: voxel
    (i, j, k) sits at (x, y, z) = linspace(-0.5, 0.5, n) per axis, its
    normalized coordinate u = p / (1 + padding + 10e-4) + 0.5 (u >= 1 set to
    1 - 10e-4, u < 0 to 0), its cell floor(u * reso), flat index
    x + reso * (y + reso * z); the features are summed there by
    ``index_add`` and divided by the count (an empty cell is 0), and the flat
    grid is read as (B, C, z, y, x). With padding 0 and reso = n each cell
    holds exactly one voxel, so the scatter-mean is the transpose
    (x, y, z) -> (z, y, x) of the voxel features;
  * ConvONet's UNet3D (pytorch-3dunet, layer order 'gcr'): every conv is a
    GroupNorm (8 groups, 1 where the channels are fewer than 8, eps 1e-5),
    a Conv3d (k3, p1, no bias) and a ReLU. An encoder level's first conv
    gives max(out // 2, in) channels: 32->32->32 | max-pool 2 | 32->32->64
    | max-pool 2 | 64->64->128 at f_maps 32. A decoder level upsamples by
    ``F.interpolate`` (nearest) to its skip's size, concatenates (skip, x)
    on channels and runs in -> out -> out: 192->64->64, then 96->32->32.
    A final 1x1 Conv3d 32 -> c_dim with bias, no activation;
  * per query point, ``F.grid_sample`` on the 5-D grid (bilinear, which is
    trilinear there; border; align_corners=True) at 2 u - 1, u the normalized
    (x, y, z), so x indexes the grid's last axis;
  * each head's ResNet-FC stack on the sampled features
    (``GigaReference.decode``): GIGA sums the features of every feature type,
    and the grid is the only one.

Departures from ConvONet: the weights are the repository's seeded ones (no
trained giga_grid checkpoint exists); the affordance heads are read from the
port's stacked flax layout (``decoder_aff``: qual, rot, width, each padded
to 4 outputs), as ``GigaReference`` reads them.

Weights are read from the flax ``.msgpack`` checkpoint by the benchmark's
frozen reader. Conv3d kernels are (D, H, W, I, O), D H W the grid's
(z, y, x). Every computation runs with TF32 off unless ``tf32=True`` (the
control). This module imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.frozen.msgpack import load_params
from portbench.reference.giga import GigaReference, matmul_precision

GROUPS = 8


def normalize_3d(p: torch.Tensor, padding: float) -> torch.Tensor:
    """ConvONet's ``normalize_3d_coordinate``: [-0.5, 0.5] -> [0, 1)."""
    u = p / (1 + padding + 10e-4) + 0.5
    u = torch.where(u >= 1, torch.full_like(u, 1 - 10e-4), u)
    return torch.where(u < 0, torch.zeros_like(u), u)


class GridReference(GigaReference):
    """The network of a giga_grid checkpoint: ``encode`` gives the refined
    (B, C, z, y, x) grid; ``decode``, ``affordance`` and ``occupancy`` are
    ``GigaReference``'s, on this class's ``features``."""

    def __init__(self, path, device, tf32: bool = False, padding: float = 0.0):
        # GigaReference's constructor reads a triplane encoder; this one reads the grid's
        tree = load_params(path)
        tree = tree.get("params", tree)
        self.device = torch.device(device)
        self.tf32, self.padding = tf32, padding

        def t(a):
            return torch.from_numpy(np.array(a, np.float32)).to(self.device)

        def conv3d(kernel):
            return t(np.transpose(kernel, (4, 3, 0, 1, 2)))

        enc = tree["encoder"]
        self.stem = conv3d(enc["conv_in"]["conv"]["kernel"]), t(enc["conv_in"]["conv"]["bias"])
        unet = enc["unet3d"]

        def level(node):
            return [(t(node[c]["groupnorm"]["scale"]), t(node[c]["groupnorm"]["bias"]),
                     conv3d(node[c]["conv"]["conv"]["kernel"]))
                    for c in ("SingleConv1", "SingleConv2")]

        n_enc = sum(1 for k in unet if k.startswith("encoders_"))
        self.encoders = [level(unet[f"encoders_{i}"]) for i in range(n_enc)]
        self.decoders_3d = [level(unet[f"decoders_{i}"]) for i in range(n_enc - 1)]
        final = unet["final_conv"]["conv"]
        self.final = conv3d(final["kernel"]), t(final["bias"])
        self.decoders = {name: {k: t(v) for k, v in tree[name].items()}
                         for name in ("decoder_aff", "decoder_occ") if name in tree}

    # -- encoder ---------------------------------------------------------------

    def encode(self, tsdf: torch.Tensor) -> torch.Tensor:
        """(B, X, Y, Z) TSDF -> the refined (B, C, z, y, x) feature grid."""
        with torch.no_grad(), matmul_precision(self.tf32):
            feat = F.relu(F.conv3d(tsdf[:, None].float(), *self.stem, padding=1))
            return self.unet3d(self.scatter_mean(feat))

    def scatter_mean(self, feat: torch.Tensor) -> torch.Tensor:
        """(B, C, X, Y, Z) voxel features -> (B, C, z, y, x) grid of the
        same resolution (ConvONet's ``generate_grid_features``)."""
        B, C, X, Y, Z = feat.shape
        reso = X
        axes = [torch.linspace(-0.5, 0.5, n, device=feat.device) for n in (X, Y, Z)]
        p = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
        cell = (normalize_3d(p, self.padding) * reso).long()
        index = cell[:, 0] + reso * (cell[:, 1] + reso * cell[:, 2])
        flat = feat.reshape(B, C, -1)
        total = flat.new_zeros(B, C, reso ** 3).index_add_(2, index, flat)
        ones = torch.ones_like(index, dtype=flat.dtype)
        count = flat.new_zeros(reso ** 3).index_add_(0, index, ones)
        return (total / count.clamp(min=1)).reshape(B, C, reso, reso, reso)

    @staticmethod
    def double_conv(x: torch.Tensor, convs) -> torch.Tensor:
        for scale, bias, w in convs:
            groups = GROUPS if x.shape[1] >= GROUPS else 1
            x = F.relu(F.conv3d(F.group_norm(x, groups, scale, bias, eps=1e-5), w, padding=1))
        return x

    def unet3d(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i, convs in enumerate(self.encoders):
            if i > 0:
                x = F.max_pool3d(x, 2, 2)
            x = self.double_conv(x, convs)
            skips.append(x)
        for convs, skip in zip(self.decoders_3d, reversed(skips[:-1])):
            x = F.interpolate(x, size=skip.shape[2:], mode="nearest")
            x = self.double_conv(torch.cat([skip, x], dim=1), convs)
        return F.conv3d(x, *self.final)

    # -- decoder ---------------------------------------------------------------

    def features(self, grid: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) points in [-0.5, 0.5] -> (B, N, C) grid features."""
        vgrid = 2.0 * normalize_3d(p, self.padding) - 1.0
        s = F.grid_sample(grid, vgrid[:, :, None, None], mode="bilinear",
                          padding_mode="border", align_corners=True)  # (B, C, N, 1, 1)
        return s[..., 0, 0].transpose(1, 2)
