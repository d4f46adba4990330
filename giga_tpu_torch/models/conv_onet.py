"""GIGA model assembly (counterpart of giga_tpu/models/conv_onet.py;
reference: ConvONets/conv_onet/models/__init__.py:15-226).

Triplane encoder + stacked affordance decoder (qual/rot/width) + optional
occupancy decoder. The occupancy decoder's weights load and are carried,
but no path of this package decodes occupancy yet.
"""

from __future__ import annotations

import torch
from torch import nn

from giga_tpu_torch.core.config import GIGAConfig
from giga_tpu_torch.inference.dense_decode import decode_affordance_dense_batched
from giga_tpu_torch.models.decoder import StackedLocalDecoder
from giga_tpu_torch.models.encoder import TriplaneVoxelEncoder


class GIGANet(nn.Module):
    """Convolutional occupancy network with grasp-affordance heads."""

    def __init__(self, cfg: GIGAConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = TriplaneVoxelEncoder(cfg.encoder)
        if cfg.has_affordance:
            self.decoder_aff = StackedLocalDecoder(cfg.decoder, heads=3, out_dim=4)
        if cfg.decoder_tsdf:
            self.decoder_occ = StackedLocalDecoder(cfg.decoder, heads=1, out_dim=1)

    def encode(self, tsdf: torch.Tensor) -> dict:
        """(B, R, R, R) -> plane dict {t: (B, H, W, C)}."""
        return self.encoder(tsdf)

    def decode_affordance_lattice(self, feats: dict, coords: torch.Tensor):
        """Affordance trunk on the R^3 query lattice (plain PyTorch):
        feats {t: (B, R, R, C)} -> qual (B,R,R,R), rot (B,R,R,R,4), width (B,R,R,R)."""
        return decode_affordance_dense_batched(
            self.decoder_aff.params(), feats, coords, self.cfg.decoder.n_blocks)
