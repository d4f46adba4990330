"""Triplane voxel encoder (counterpart of giga_tpu/models/encoder.py;
reference: ConvONets/encoder/voxels.py:10-121).

(B, R, R, R) TSDF -> Conv3d(1 -> c_dim, k3) + ReLU -> mean over each dropped
axis onto three R^2 planes -> one shared 2D U-Net refines the three planes
as a batch of 3B. With padding 0 and input resolution == plane resolution
the reference's scatter-mean onto the planes is exactly that axis mean (the
lattice-exact path). Only that path is ported; the scatter path, the grid
branch and ``GlobalVoxelEncoder`` are not.

Planes are returned as {t: (B, H, W, C)} with row = second plane axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from giga_tpu_torch.core.config import EncoderConfig
from giga_tpu_torch.models.layers import ConvStem3d
from giga_tpu_torch.models.unet2d import UNet2D
from giga_tpu_torch.ops.kernels.stem import axis_mean_planes, can_stem_pool, stem_pool_batched

PLANE_ORDER = ("xz", "xy", "yz")


class TriplaneVoxelEncoder(nn.Module):
    """LocalVoxelEncoder equivalent, lattice-exact path."""

    def __init__(self, cfg: EncoderConfig = EncoderConfig()):
        super().__init__()
        if "grid" in cfg.plane_types:
            raise NotImplementedError("the 'grid' encoder branch is not ported yet")
        self.cfg = cfg
        self.conv_in = ConvStem3d(cfg.c_dim, cfg.kernel_size)
        self.unet = UNet2D(cfg.c_dim, cfg.unet)

    def forward(self, x: torch.Tensor) -> dict:
        if not is_lattice_exact(self.cfg, x.shape):
            raise NotImplementedError(
                "only the lattice-exact encoder path is ported (padding 0, "
                f"input resolution {self.cfg.plane_resolution}^3); got {tuple(x.shape)}")
        feat = F.relu(self.conv_in(x[:, None]))
        return self.refine(axis_mean_planes(feat, self.cfg.plane_types))

    def refine(self, planes: dict) -> dict:
        """Run the shared U-Net over the pooled planes, batched as (3B, H, W, C)."""
        order = [t for t in PLANE_ORDER if t in self.cfg.plane_types]
        stacked = torch.cat([planes[t] for t in order], dim=0)
        refined = self.unet(stacked)
        return dict(zip(order, torch.chunk(refined, len(order), dim=0)))


def encode_planes_fused(encoder: TriplaneVoxelEncoder, tsdfs: torch.Tensor) -> dict:
    """Batched triplane encode with kernel K1 (stem + pool) and the module's
    own U-Net. Callers check ``can_encode_fused`` first."""
    conv = encoder.conv_in
    return encoder.refine(stem_pool_batched(conv.weight, conv.bias, tsdfs.contiguous()))


def is_lattice_exact(enc_cfg: EncoderConfig, tsdf_shape) -> bool:
    """The encoder's lattice-exact branch, the only one ported: triplanes,
    padding 0, input resolution equal to the plane resolution."""
    return (
        "grid" not in enc_cfg.plane_types
        and enc_cfg.padding == 0.0
        and tuple(tsdf_shape[-3:]) == (enc_cfg.plane_resolution,) * 3
    )


def can_encode_fused(enc_cfg: EncoderConfig, tsdf_shape,
                     dtype: torch.dtype = torch.float32) -> bool:
    """Whether ``encode_planes_fused`` takes (B, X, Y, Z) TSDFs in ``dtype``:
    the lattice-exact branch with a 3^3 stem, at a shape K1 takes
    (``can_stem_pool``). A 3-D shape is one scene."""
    X, Y, Z = tuple(tsdf_shape[-3:])
    B = tsdf_shape[0] if len(tsdf_shape) == 4 else 1
    return (is_lattice_exact(enc_cfg, tsdf_shape) and enc_cfg.kernel_size == 3
            and can_stem_pool(B, X, Y, Z, enc_cfg.c_dim, dtype))
