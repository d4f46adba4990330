"""Point-cloud encoders (counterpart of giga_tpu/models/pointnet.py;
reference: ConvONets/encoder/pointnet.py:11-290).

LocalPoolPointnet: per-point ResNet-FC blocks with local pooling between
them: each point's features scatter (max or mean) into its plane (and
optionally grid) cells and the pooled value is gathered back, so every
point sees its cells' aggregate. The final point features scatter-mean onto
feature planes refined by the shared 2D U-Net (and onto a grid refined by
the 3D U-Net). PatchLocalPoolPointnet is the crop variant: the cell indices
come from the caller (crop-normalized, models/crop.py) and the points enter
through per-voxel local coordinates.

Every reduction takes the whole batch at once (ops/scatter.py), with no
loop over scenes. Module names are the reference's (``fc_pos``,
``blocks.{i}``, ``fc_c``, ``unet``, ``unet3d``), so a reference state dict
loads as it is; models/convert.py maps the JAX package's flax trees.
The forward passes run under ``full_precision`` (TF32 off on the card), as
the JAX package's CPU float32 computes; a backward pass takes the caller's
setting, so a float32 gradient is taken inside ``full_precision`` too
(cuDNN's convolution gradients use TF32 by default).
"""

from __future__ import annotations

import torch
from torch import nn

from giga_tpu_torch.core.config import EncoderConfig
from giga_tpu_torch.core.precision import full_precision
from giga_tpu_torch.models.layers import ResnetBlockFC
from giga_tpu_torch.models.unet2d import UNet2D
from giga_tpu_torch.models.unet3d import UNet3D
from giga_tpu_torch.ops.sampling import map2local
from giga_tpu_torch.ops.scatter import grid_index, plane_index, segment_max, segment_mean

PLANE_ORDER = ("xz", "xy", "yz")


def pool_local(net: torch.Tensor, indices: dict, cells: dict, scatter_type: str) -> torch.Tensor:
    """(B, T, C) point features pooled (max or mean) into each index's cells
    and gathered back to the points, summed over the indices in their order."""
    reduce = segment_max if scatter_type == "max" else segment_mean
    out = 0
    for key, idx in indices.items():
        pooled = reduce(net, idx, cells[key])
        out = out + torch.gather(pooled, 1, idx[..., None].expand(-1, -1, net.shape[-1]))
    return out


class _PointTrunk(nn.Module):
    """fc_pos, block0, then blocks that concatenate the pooled features, fc_c."""

    def __init__(self, dim: int, c_dim: int, hidden_dim: int, n_blocks: int):
        super().__init__()
        h = hidden_dim
        self.fc_pos = nn.Linear(dim, 2 * h)
        self.blocks = nn.ModuleList([ResnetBlockFC(2 * h, h) for _ in range(n_blocks)])
        self.fc_c = nn.Linear(h, c_dim)

    def trunk(self, p: torch.Tensor, indices: dict, cells: dict, scatter_type: str):
        net = self.blocks[0](self.fc_pos(p))
        for block in self.blocks[1:]:
            pooled = pool_local(net, indices, cells, scatter_type)
            net = block(torch.cat([net, pooled], dim=-1))
        return self.fc_c(net)


def _refine_planes(unet: UNet2D, planes: dict) -> dict:
    """The planes stacked on the batch axis through one U-Net, split back."""
    order = list(planes)
    refined = unet(torch.cat([planes[t] for t in order], dim=0))
    return dict(zip(order, torch.chunk(refined, len(order), dim=0)))


class LocalPoolPointnet(_PointTrunk):
    """forward(p (B, T, 3) in [-0.5, 0.5]^3) -> {t: (B, R, R, c_dim)}
    (+ 'grid' (B, G, G, G, c_dim) with ``use_grid``)."""

    def __init__(self, cfg: EncoderConfig = EncoderConfig(), hidden_dim: int = 32,
                 n_blocks: int = 5, scatter_type: str = "max", grid_resolution: int | None = None,
                 use_grid: bool = False):
        super().__init__(3, cfg.c_dim, hidden_dim, n_blocks)
        self.cfg, self.scatter_type = cfg, scatter_type
        self.grid_resolution, self.use_grid = grid_resolution, use_grid
        self.order = [t for t in PLANE_ORDER if t in cfg.plane_types]
        if self.order:
            self.unet = UNet2D(cfg.c_dim, cfg.unet)
        if use_grid:
            self.unet3d = UNet3D(cfg.c_dim, cfg.c_dim, cfg.unet3d.f_maps, cfg.unet3d.num_levels,
                                 cfg.unet3d.num_groups)

    def forward(self, p: torch.Tensor) -> dict:
        cfg = self.cfg
        reso, B = cfg.plane_resolution, p.shape[0]
        indices = {t: plane_index(p, t, reso, cfg.padding) for t in cfg.plane_types}
        cells = {t: reso * reso for t in cfg.plane_types}
        if self.use_grid:
            indices["grid"] = grid_index(p, self.grid_resolution, cfg.padding)
            cells["grid"] = self.grid_resolution ** 3
        with full_precision():
            c = self.trunk(p, indices, cells, self.scatter_type)
            fea = {}
            if self.order:
                fea = _refine_planes(self.unet, {
                    t: segment_mean(c, indices[t], reso * reso).reshape(B, reso, reso, -1)
                    for t in self.order})
            if self.use_grid:
                g = self.grid_resolution
                fea["grid"] = self.unet3d(
                    segment_mean(c, indices["grid"], g ** 3).reshape(B, g, g, g, -1))
        return fea


class PatchLocalPoolPointnet(_PointTrunk):
    """The crop encoder: forward(p (B, T, 3), index {t: (B, T) cell ids})
    -> {t: (B, R, R, c_dim)} for the planes in ``index`` (+ 'grid'
    (B, G, G, G, c_dim) when it holds 'grid', G = cfg.grid_resolution).
    Points enter as ``map2local`` coordinates (``local_coord``), linear or
    sin/cos-encoded."""

    def __init__(self, cfg: EncoderConfig = EncoderConfig(), hidden_dim: int = 32,
                 n_blocks: int = 5, scatter_type: str = "max", local_coord: bool = True,
                 unit_size: float = 0.1, pos_encoding: str = "linear"):
        dim = 60 if local_coord and pos_encoding == "sin_cos" else 3
        super().__init__(dim, cfg.c_dim, hidden_dim, n_blocks)
        self.cfg, self.scatter_type = cfg, scatter_type
        self.local_coord, self.unit_size, self.pos_encoding = local_coord, unit_size, pos_encoding
        if any(t in cfg.plane_types for t in PLANE_ORDER):
            self.unet = UNet2D(cfg.c_dim, cfg.unet)
        if "grid" in cfg.plane_types:
            self.unet3d = UNet3D(cfg.c_dim, cfg.c_dim, cfg.unet3d.f_maps, cfg.unet3d.num_levels,
                                 cfg.unet3d.num_groups)

    def forward(self, p: torch.Tensor, index: dict) -> dict:
        cfg = self.cfg
        reso, greso, B = cfg.plane_resolution, cfg.grid_resolution, p.shape[0]
        cells = {t: greso ** 3 if t == "grid" else reso * reso for t in index}
        pin = map2local(p, self.unit_size, self.pos_encoding) if self.local_coord else p
        with full_precision():
            c = self.trunk(pin, index, cells, self.scatter_type)
            fea = {}
            if "grid" in index:
                fea["grid"] = self.unet3d(
                    segment_mean(c, index["grid"], greso ** 3).reshape(B, greso, greso, greso, -1))
            order = [t for t in PLANE_ORDER if t in index]
            if order:
                fea.update(_refine_planes(self.unet, {
                    t: segment_mean(c, index[t], reso * reso).reshape(B, reso, reso, -1)
                    for t in order}))
        return fea
