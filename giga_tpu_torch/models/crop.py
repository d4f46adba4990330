"""The learned crop model of the sliding-window pipeline (counterpart of
giga_tpu/models/crop.py; reference 'pointcloud_crop' mode, ConvONets
generation.py:150-297 and common.py:281-301).

``PatchLocalPoolPointnet`` (models/pointnet.py) wired to ``PatchLocalDecoder``
(models/decoder.py): points and queries are normalized to [0, 1] within an
explicit input-crop volume, plane-cell indices come from those normalized
coordinates, and positions enter the networks through per-voxel local
coordinates, so one trained model evaluates any crop of a scene larger
than its workspace. ``CropGenerator`` assembles whole-scene meshes through
geometry/sliding_window.py: it resamples every crop's points on the host
from one ``np.random.RandomState`` (the JAX package's draws, so one seed
gives the same crops in both packages), and encodes and decodes each crop
on its device (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from giga_tpu_torch.core.config import DecoderConfig, EncoderConfig
from giga_tpu_torch.core.device import resolve_device, to_device
from giga_tpu_torch.models.decoder import PatchLocalDecoder
from giga_tpu_torch.models.pointnet import PatchLocalPoolPointnet
from giga_tpu_torch.ops.sampling import normalize_coord

PLANE_TYPES = ("xz", "xy", "yz")


def crop_plane_indices(points: torch.Tensor, input_vol, reso: int) -> dict:
    """{plane: (..., T) flat cell ids} of points inside an input crop
    (``input_vol`` = (lo, hi), each (3,)): flat id = i1 * reso + i0 on the
    crop-normalized coordinates, the decoder's plane[row, col] layout."""
    out = {}
    for t in PLANE_TYPES:
        u = normalize_coord(points, input_vol, t)
        cell = torch.clamp((u * reso).to(torch.int64), 0, reso - 1)
        out[t] = cell[..., 1] * reso + cell[..., 0]
    return out


def crop_grid_indices(points: torch.Tensor, input_vol, reso: int) -> torch.Tensor:
    """Flat 3D cell ids of the grid branch, laid out [z, y, x, c]:
    iz * reso^2 + iy * reso + ix on the crop-normalized coordinates."""
    cell = torch.clamp((normalize_coord(points, input_vol, "grid") * reso).to(torch.int64),
                       0, reso - 1)
    return cell[..., 2] * reso * reso + cell[..., 1] * reso + cell[..., 0]


def crop_query_coords(query: torch.Tensor, input_vol, plane_types=PLANE_TYPES) -> dict:
    """{t: (..., N, 2)} crop-normalized query coordinates ((..., N, 3) for
    'grid')."""
    return {t: normalize_coord(query, input_vol, t) for t in plane_types}


class CropOccupancyNet(nn.Module):
    """PatchLocalPoolPointnet encoder + PatchLocalDecoder occupancy head:
    forward(points, index, query, q_n) -> (B, N) logits. ``points`` and
    ``query`` are raw world coordinates, seen by the networks only through
    ``map2local``; ``index`` / ``q_n`` carry the crop-relative geometry."""

    def __init__(self, cfg: EncoderConfig = EncoderConfig(), dec_cfg: DecoderConfig | None = None,
                 hidden_dim: int = 32, n_blocks: int = 5, unit_size: float = 0.02,
                 pos_encoding: str = "linear"):
        super().__init__()
        self.cfg, self.unit_size = cfg, unit_size
        dec_cfg = dec_cfg or DecoderConfig(c_dim=cfg.c_dim, concat_feat=False, n_blocks=n_blocks)
        self.encoder = PatchLocalPoolPointnet(cfg, hidden_dim=hidden_dim, n_blocks=n_blocks,
                                              unit_size=unit_size, pos_encoding=pos_encoding)
        self.decoder = PatchLocalDecoder(dec_cfg, out_dim=1, unit_size=unit_size,
                                         pos_encoding=pos_encoding)

    def encode(self, points: torch.Tensor, index: dict) -> dict:
        """(B, T, 3) + {t: (B, T)} -> {t: (B, R, R, C)} (+ 'grid')."""
        return self.encoder(points, index)

    def decode(self, planes: dict, query: torch.Tensor, q_n: dict) -> torch.Tensor:
        """planes + (B, N, 3) + {t: (B, N, 2)} -> (B, N) logits."""
        return self.decoder(query, q_n, planes)

    def forward(self, points, index, query, q_n):
        return self.decode(self.encode(points, index), query, q_n)


class CropGenerator:
    """Whole-scene meshes from a crop model: every crop's points resampled
    with replacement to ``n_crop_points`` (one shape for every crop), a
    ``resolution``^3 query lattice a crop. ``params``, a flax tree, replaces
    ``net``'s weights when given."""

    def __init__(self, net: CropOccupancyNet, params=None, n_crop_points: int = 2048,
                 resolution: int = 32, threshold: float = 0.5,
                 rng: np.random.RandomState | None = None, device=None):
        from giga_tpu_torch.models.convert import flax_to_state_dict

        self.device = resolve_device(device)
        if params is not None:
            net.load_state_dict(flax_to_state_dict(params))
        self.net = net.to(self.device).eval()
        self.n_crop_points = n_crop_points
        self.resolution = resolution
        self.threshold = threshold
        self.rng = rng if rng is not None else np.random.RandomState(0)
        cfg = net.cfg
        self.plane_types = tuple(t for t in PLANE_TYPES if t in cfg.plane_types)
        self.query_types = self.plane_types + (("grid",) if "grid" in cfg.plane_types else ())

    def _vol(self, vol) -> tuple:
        lo, hi = (np.asarray(v, np.float32) for v in vol)
        d = to_device({"lo": lo, "hi": hi}, self.device)
        return d["lo"], d["hi"]

    def _encode_crop(self, points: np.ndarray, vol) -> dict:
        idx = self.rng.randint(0, len(points), self.n_crop_points)
        p = to_device({"p": points[idx].astype(np.float32)[None]}, self.device)["p"]
        vol = self._vol(vol)
        cfg = self.net.cfg
        index = crop_plane_indices(p, vol, cfg.plane_resolution)
        index = {t: index[t] for t in self.plane_types}
        if "grid" in cfg.plane_types:
            index["grid"] = crop_grid_indices(p, vol, cfg.grid_resolution)
        with torch.no_grad():
            return self.net.encode(p, index)

    def _eval_crop(self, planes: dict, q: np.ndarray, vol) -> np.ndarray:
        query = to_device({"q": np.asarray(q, np.float32)[None]}, self.device)["q"]
        q_n = crop_query_coords(query, self._vol(vol), plane_types=self.query_types)
        with torch.no_grad():
            return self.net.decode(planes, query, q_n)[0].cpu().numpy()

    def generate_mesh(self, points: np.ndarray, query_crop_size: float, input_crop_size: float):
        """(P, 3) scene point cloud -> TriMesh in world coordinates."""
        from giga_tpu_torch.geometry.sliding_window import SlidingWindowGenerator

        gen = SlidingWindowGenerator(self._encode_crop, self._eval_crop,
                                     resolution=self.resolution, threshold=self.threshold)
        return gen.generate_mesh(points, query_crop_size, input_crop_size)
