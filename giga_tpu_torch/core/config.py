"""Typed model/pipeline configuration with the GIGA presets.

The port's own copy of the JAX package's configuration dataclasses (frozen,
hashable, introspectable). Field names and defaults are identical, so a
configuration means the same model in both packages.

Presets (reference names):
    giga        triplane encoder + qual/rot/width + occupancy decoder
    giga_aff    affordance only (no occupancy decoder)
    giga_geo    occupancy decoder only
    giga_detach occupancy gradient does not flow into the encoder features
    vgn         the dense conv-deconv VGN baseline
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    """2D U-Net over each feature plane (reference: ConvONets/encoder/unet.py:140-209)."""

    depth: int = 3
    start_filts: int = 32
    merge_mode: str = "concat"  # 'concat' | 'add'
    up_mode: str = "transpose"  # only 'transpose' supported (shipped presets use it)


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    """3D U-Net of the 'grid' branch (reference: ConvONets/encoder/unet3d.py:477;
    models/unet3d.py)."""

    f_maps: int = 32
    num_levels: int = 3
    num_groups: int = 8


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Triplane voxel encoder (reference: ConvONets/encoder/voxels.py:10-121)."""

    c_dim: int = 32
    plane_resolution: int = 40
    plane_types: Tuple[str, ...] = ("xz", "xy", "yz")
    kernel_size: int = 3
    padding: float = 0.0  # coordinate-normalization padding, 0 for GIGA
    unet: UNet2DConfig = UNet2DConfig()
    # 'grid' branch: pool onto a 3D grid refined by a 3D U-Net instead of
    # planes (reference voxels.py:74-86)
    grid_resolution: int = 32
    unet3d: UNet3DConfig = UNet3DConfig()


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Local implicit decoder (reference: ConvONets/conv_onet/models/decoder.py:61-176)."""

    c_dim: int = 32
    hidden_size: int = 32
    n_blocks: int = 5
    concat_feat: bool = True  # concat per-plane features (3*c_dim) instead of summing
    sample_mode: str = "bilinear"
    padding: float = 0.0
    sampler: str = "gather"


@dataclasses.dataclass(frozen=True)
class GIGAConfig:
    """Full model assembly (reference: conv_onet/config.py:15-91 + networks.py:65-169)."""

    name: str = "giga"
    encoder: EncoderConfig = EncoderConfig()
    decoder: DecoderConfig = DecoderConfig()
    decoder_tsdf: bool = True  # include the occupancy decoder
    tsdf_only: bool = False  # geometry-only model (no qual/rot/width heads)
    detach_tsdf: bool = False  # stop-gradient on features fed to the occupancy decoder

    @property
    def has_affordance(self) -> bool:
        return not self.tsdf_only


@dataclasses.dataclass(frozen=True)
class VGNConfig:
    """Dense conv-deconv VGN baseline (reference: networks.py:48-63, 172-212)."""

    name: str = "vgn"
    encoder_filters: Tuple[int, ...] = (16, 32, 64)
    encoder_kernels: Tuple[int, ...] = (5, 3, 3)
    decoder_filters: Tuple[int, ...] = (64, 32, 16)
    decoder_kernels: Tuple[int, ...] = (3, 3, 5)


def giga() -> GIGAConfig:
    return GIGAConfig(name="giga", decoder_tsdf=True)


def giga_aff() -> GIGAConfig:
    return GIGAConfig(name="giga_aff", decoder_tsdf=False)


def giga_geo() -> GIGAConfig:
    return GIGAConfig(
        name="giga_geo",
        decoder=DecoderConfig(sampler="mm"),
        decoder_tsdf=True,
        tsdf_only=True,
    )


def giga_detach() -> GIGAConfig:
    return GIGAConfig(name="giga_detach", decoder_tsdf=True, detach_tsdf=True)


def giga_wide() -> GIGAConfig:
    """2x-width GIGA (c_dim/hidden 64, U-Net start 64): not a shipped preset."""
    return GIGAConfig(
        name="giga_wide",
        encoder=EncoderConfig(c_dim=64, unet=UNet2DConfig(start_filts=64)),
        decoder=DecoderConfig(c_dim=64, hidden_size=64),
        decoder_tsdf=True,
    )


def giga_grid() -> GIGAConfig:
    """3D-feature-grid variant (reference voxels.py:74-86 + unet3d.py:477):
    a 40^3 grid of c_dim features refined by the 3D U-Net, sampled
    trilinearly by the decoders, whose features sum (the reference's
    grid + concat path is unreachable)."""
    return GIGAConfig(
        name="giga_grid",
        encoder=EncoderConfig(plane_types=("grid",), grid_resolution=40),
        decoder=DecoderConfig(concat_feat=False),
        decoder_tsdf=True,
    )


def vgn() -> VGNConfig:
    return VGNConfig()


PRESETS = {
    "giga": giga,
    "giga_aff": giga_aff,
    "giga_geo": giga_geo,
    "giga_detach": giga_detach,
    "giga_grid": giga_grid,
    "giga_wide": giga_wide,
    "vgn": vgn,
}


def get_config(name: str):
    try:
        return PRESETS[name.lower()]()
    except KeyError:
        raise KeyError(f"unknown model preset {name!r}; options: {sorted(PRESETS)}") from None


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Grasp-grid planner settings (reference: detection_implicit.py:17-31, 115-185)."""

    resolution: int = 40
    qual_th: float = 0.9
    low_th: float = 0.5
    out_th: float = 0.5
    max_filter_size: int = 4
    gaussian_sigma: float = 1.0
    min_width: float = 0.033  # normalized units (width / scene size)
    max_width: float = 0.233
    bound_limits: Tuple[float, float, float] = (0.02, 0.02, 0.055)  # meters
    max_grasps: int = 128  # static top-K capacity of the on-device selection
    force_detection: bool = False
    best: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: scripts/train_giga.py:248-263)."""

    net: str = "giga"
    batch_size: int = 32
    lr: float = 2e-4
    epochs: int = 10
    val_split: float = 0.1
    augment: bool = False
    num_point_occ: int = 2048
    seed: int = 0
