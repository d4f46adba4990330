"""GIGA model assembly (counterpart of giga_tpu/models/conv_onet.py;
reference: ConvONets/conv_onet/models/__init__.py:15-226).

Triplane encoder + stacked affordance decoder (qual/rot/width) + optional
occupancy decoder. Heads:
    qual  -> sigmoid         (grasp success probability)
    rot   -> L2-normalized 4-vector (quaternion, xyzw)
    width -> raw             (normalized gripper width)
    occ   -> raw logits      (occupancy)

The entry points run in the network's parameter dtype (the TSDF is cast to
it, as the planner's bf16 copy does) and, on the card, under
``full_precision`` (TF32 off), as the JAX package pins
``default_matmul_precision("highest")``.
"""

from __future__ import annotations

import torch
from torch import nn

from giga_tpu_torch.core.config import GIGAConfig
from giga_tpu_torch.core.precision import full_precision
from giga_tpu_torch.inference.dense_decode import decode_affordance_dense_batched
from giga_tpu_torch.models.decoder import StackedLocalDecoder, query_planes
from giga_tpu_torch.models.encoder import TriplaneVoxelEncoder


def normalize_quat(q: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics: q / max(||q||, eps)."""
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=dim, keepdim=True), eps)


class GIGANet(nn.Module):
    """Convolutional occupancy network with grasp-affordance heads.

    forward(tsdf, p, p_tsdf) mirrors the reference forward
    (conv_onet/models/__init__.py:42-67): encode once, decode affordance at
    p, and occupancy at p_tsdf when given."""

    def __init__(self, cfg: GIGAConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = TriplaneVoxelEncoder(cfg.encoder)
        if cfg.has_affordance:
            self.decoder_aff = StackedLocalDecoder(cfg.decoder, heads=3, out_dim=4)
        if cfg.decoder_tsdf:
            self.decoder_occ = StackedLocalDecoder(cfg.decoder, heads=1, out_dim=1)

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def encode(self, tsdf: torch.Tensor) -> dict:
        """(B, R, R, R) -> plane dict {t: (B, H, W, C)}."""
        with full_precision():
            return self.encoder(tsdf.to(self.dtype))

    def decode_affordance(self, planes: dict, p: torch.Tensor, feature=None):
        """(B, N, 3) -> qual (B, N), rot (B, N, 4), width (B, N)."""
        with full_precision():
            out = self.decoder_aff(planes, p, feature=feature)
        return torch.sigmoid(out[0, ..., 0]), normalize_quat(out[1]), out[2, ..., 0]

    def decode_occupancy(self, planes: dict, p: torch.Tensor, feature=None) -> torch.Tensor:
        """(B, N, 3) -> occupancy logits (B, N). With ``cfg.detach_tsdf`` no
        gradient reaches the planes or the feature ('giga_detach',
        networks.py:144-169)."""
        if self.cfg.detach_tsdf:
            planes = {t: v.detach() for t, v in planes.items()}
            feature = None if feature is None else feature.detach()
        with full_precision():
            return self.decoder_occ(planes, p, feature=feature)[0, ..., 0]

    def forward(self, tsdf: torch.Tensor, p: torch.Tensor | None,
                p_tsdf: torch.Tensor | None = None) -> dict:
        """{qual, rot, width} at p and {occ} at p_tsdf, those the config has."""
        planes = self.encode(tsdf)
        outputs = {}
        if self.cfg.has_affordance and p is not None:
            outputs.update(zip(("qual", "rot", "width"), self.decode_affordance(planes, p)))
        if self.cfg.decoder_tsdf and p_tsdf is not None:
            outputs["occ"] = self.decode_occupancy(planes, p_tsdf)
        return outputs

    def query_feature(self, planes: dict, p: torch.Tensor) -> torch.Tensor:
        """Sampled + concatenated plane features at p (for feature reuse)."""
        with full_precision():
            return query_planes(planes, p, self.cfg.decoder)

    def grad_refine(self, tsdf: torch.Tensor, pos: torch.Tensor, bound_value: float = 0.0125,
                    lr: float = 1e-6, num_step: int = 1):
        """Gradient-ascent refinement of query positions on grasp quality
        (reference: conv_onet/models/__init__.py:136-164): ``num_step``
        steps p -= lr * d(-sum qual)/dp, then p clamped to pos +-
        bound_value. Returns (qual, refined p, rot, width).

        It takes gradients even when the caller runs in inference mode, with
        respect to the points only: the weights' ``requires_grad`` and
        ``.grad`` are left as they were."""
        with torch.inference_mode(False), torch.enable_grad():
            with torch.no_grad():
                planes = self.encode(tsdf.clone())
            pos = pos.clone()
            p = pos
            for _ in range(num_step):
                q = p.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(-self.decode_affordance(planes, q)[0].sum(), q)
                p = p - lr * g
            p = torch.clamp(p.detach(), pos - bound_value, pos + bound_value)
            with torch.no_grad():
                qual, rot, width = self.decode_affordance(planes, p)
        return qual, p, rot, width

    def decode_affordance_lattice(self, feats: dict, coords: torch.Tensor):
        """Affordance trunk on the R^3 query lattice (plain PyTorch):
        feats {t: (B, R, R, C)} -> qual (B,R,R,R), rot (B,R,R,R,4), width (B,R,R,R)."""
        return decode_affordance_dense_batched(
            self.decoder_aff.params(), feats, coords, self.cfg.decoder.n_blocks)
