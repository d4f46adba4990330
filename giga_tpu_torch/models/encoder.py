"""Voxel encoders (counterpart of giga_tpu/models/encoder.py; reference:
ConvONets/encoder/voxels.py:10-156).

``TriplaneVoxelEncoder``: (B, R, R, R) TSDF -> Conv3d(1 -> c_dim, k3) +
ReLU -> per-voxel features pooled onto three planes -> one shared 2D U-Net
refines the three planes as a batch of 3B. With padding 0 and input
resolution == plane resolution the reference's scatter-mean onto the planes
is exactly the mean over each dropped axis (the lattice-exact path, which
kernel K1 fuses with the stem); any other resolution or padding takes the
scatter path (``ops/scatter.py``) from the voxels' lattice points. The
'grid' branch pools onto a 3D grid instead (a transpose on the exact
lattice, else ``scatter_mean_grid``) and refines it with a 3D U-Net
(``models/unet3d.py``).

``GlobalVoxelEncoder``: the global-latent variant, a strided Conv3d pyramid
and one FC to a single code per scene.

Planes are returned as {t: (B, H, W, C)} with row = second plane axis; the
grid as {"grid": (B, Z, Y, X, C)}.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from giga_tpu_torch.core.config import EncoderConfig
from giga_tpu_torch.models.layers import ConvStem3d
from giga_tpu_torch.models.unet2d import UNet2D
from giga_tpu_torch.models.unet3d import UNet3D
from giga_tpu_torch.ops.kernels.stem import axis_mean_planes, can_stem_pool, stem_pool_batched
from giga_tpu_torch.ops.sampling import linspace_f32
from giga_tpu_torch.ops.scatter import scatter_mean_grid, scatter_mean_planes

PLANE_ORDER = ("xz", "xy", "yz")


def voxel_lattice_points(shape, device=None) -> torch.Tensor:
    """(X, Y, Z, 3) per-voxel (x, y, z) coordinates, linspace(-0.5, 0.5, n)
    per axis (voxels.py:95-103), in ``jnp.linspace``'s float32 formula."""
    axes = [torch.from_numpy(linspace_f32(-0.5, 0.5, n)).to(device) for n in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def _lattice_points_batch(feat: torch.Tensor):
    """(B, C, X, Y, Z) voxel features -> (points (B, N, 3), features
    (B, N, C)), voxels in (x, y, z)-lexicographic order."""
    B, C = feat.shape[:2]
    pts = voxel_lattice_points(feat.shape[2:], feat.device).reshape(1, -1, 3)
    return pts.expand(B, -1, -1), feat.permute(0, 2, 3, 4, 1).reshape(B, -1, C)


class TriplaneVoxelEncoder(nn.Module):
    """LocalVoxelEncoder equivalent: the triplane branch, or with
    ``plane_types=("grid",)`` the grid branch."""

    def __init__(self, cfg: EncoderConfig = EncoderConfig()):
        super().__init__()
        self.cfg = cfg
        self.conv_in = ConvStem3d(cfg.c_dim, cfg.kernel_size)
        if "grid" in cfg.plane_types:
            u = cfg.unet3d
            self.unet3d = UNet3D(cfg.c_dim, cfg.c_dim, u.f_maps, u.num_levels, u.num_groups)
        else:
            self.unet = UNet2D(cfg.c_dim, cfg.unet)

    def forward(self, x: torch.Tensor) -> dict:
        feat = F.relu(self.conv_in(x[:, None]))  # (B, C, X, Y, Z)
        if "grid" in self.cfg.plane_types:
            # the grid branch replaces the planes entirely (voxels.py:111-113)
            return {"grid": self._grid_features(feat)}
        if is_lattice_exact(self.cfg, x.shape):
            return self.refine(axis_mean_planes(feat, self.cfg.plane_types))
        pts, flat = _lattice_points_batch(feat)
        return self.refine({t: scatter_mean_planes(pts, flat, t, self.cfg.plane_resolution,
                                                   self.cfg.padding)
                            for t in self.cfg.plane_types})

    def refine(self, planes: dict) -> dict:
        """Run the shared U-Net over the pooled planes, batched as (3B, H, W, C)."""
        order = [t for t in PLANE_ORDER if t in self.cfg.plane_types]
        stacked = torch.cat([planes[t] for t in order], dim=0)
        refined = self.unet(stacked)
        return dict(zip(order, torch.chunk(refined, len(order), dim=0)))

    def _grid_features(self, feat: torch.Tensor) -> torch.Tensor:
        """(B, C, X, Y, Z) voxel features -> refined (B, Z, Y, X, C) grid
        (reference generate_grid_features, voxels.py:74-86). With padding 0
        and grid resolution == input resolution, voxel (x, y, z) falls in
        cell (z, y, x) one to one: a transpose, not a scatter."""
        cfg = self.cfg
        if cfg.padding == 0.0 and tuple(feat.shape[2:]) == (cfg.grid_resolution,) * 3:
            grid = feat.permute(0, 4, 3, 2, 1)
        else:
            pts, flat = _lattice_points_batch(feat)
            grid = scatter_mean_grid(pts, flat, cfg.grid_resolution, cfg.padding)
        return self.unet3d(grid)


class GlobalVoxelEncoder(nn.Module):
    """Global-latent voxel encoder (reference: ConvONets/encoder/voxels.py:123-156):
    Conv3d 1 -> 32 (k3, p1), then four k3 stride-2 convs 32 -> 64 -> 128 ->
    256 -> 512 each after a ReLU, then ReLU, flatten and FC to one ``c_dim``
    code a scene. Input (B, 32, 32, 32) (or (B, 1, 32, 32, 32)), which the
    pyramid collapses to a 2^3 block, as the reference's FC of 512 * 8
    inputs takes it. Names and layouts are the reference's; the flatten is
    torch's channel-major order."""

    def __init__(self, c_dim: int = 128):
        super().__init__()
        self.conv_in = nn.Conv3d(1, 32, 3, padding=1)
        for i, (cin, cout) in enumerate(((32, 64), (64, 128), (128, 256), (256, 512))):
            self.add_module(f"conv_{i}", nn.Conv3d(cin, cout, 3, stride=2, padding=1))
        self.fc = nn.Linear(512 * 2 * 2 * 2, c_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            x = x[:, None]
        h = self.conv_in(x)
        for i in range(4):
            h = getattr(self, f"conv_{i}")(F.relu(h))
        return self.fc(F.relu(h).reshape(x.shape[0], -1))


def encode_planes_fused(encoder: TriplaneVoxelEncoder, tsdfs: torch.Tensor) -> dict:
    """Batched triplane encode with kernel K1 (stem + pool) and the module's
    own U-Net. Callers check ``can_encode_fused`` first."""
    conv = encoder.conv_in
    return encoder.refine(stem_pool_batched(conv.weight, conv.bias, tsdfs.contiguous()))


def is_lattice_exact(enc_cfg: EncoderConfig, tsdf_shape) -> bool:
    """The encoder's lattice-exact triplane branch: triplanes, padding 0,
    input resolution equal to the plane resolution."""
    return (
        "grid" not in enc_cfg.plane_types
        and enc_cfg.padding == 0.0
        and tuple(tsdf_shape[-3:]) == (enc_cfg.plane_resolution,) * 3
    )


def can_encode_fused(enc_cfg: EncoderConfig, tsdf_shape,
                     dtype: torch.dtype = torch.float32) -> bool:
    """Whether ``encode_planes_fused`` takes (B, X, Y, Z) TSDFs in ``dtype``:
    the lattice-exact triplane branch (never the grid) with a 3^3 stem, at a
    shape K1 takes (``can_stem_pool``). A 3-D shape is one scene."""
    X, Y, Z = tuple(tsdf_shape[-3:])
    B = tsdf_shape[0] if len(tsdf_shape) == 4 else 1
    return (is_lattice_exact(enc_cfg, tsdf_shape) and enc_cfg.kernel_size == 3
            and can_stem_pool(B, X, Y, Z, enc_cfg.c_dim, dtype))
