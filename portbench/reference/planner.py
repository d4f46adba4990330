"""Plain reference of GIGA's grasp planning: the network's volumes on the
query lattice, then GIGA's host postprocess in scipy and numpy.

Follows GIGA's ``detection_implicit.py`` (``VGNImplicit.__call__``,
``process``, ``bound``, ``select``, ``select_index``): the qual volume
smoothed by ``ndimage.gaussian_filter`` (mode 'nearest'), zeroed away from
the observed surface band (``binary_dilation`` of the outside voxels, two
iterations, masked by the inside band) and where the width leaves its
window, the workspace borders zeroed, then below LOW_TH zeroed, then below
the threshold zeroed unless ``force_detection`` finds nothing above it
(then the best voxel alone), max-filter non-maximum suppression, and the
peaks ordered by score. A grasp sits at (lattice position + 0.5) * size
with width * size. ``max_grasps`` keeps the best that many, the static cap
the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from portbench.reference.giga import GigaReference, grid_points


def lattice(resolution: int, device) -> torch.Tensor:
    """GIGA's query coordinates linspace(-0.5, 0.5 - 1/R, R)."""
    return torch.linspace(-0.5, 0.5 - 1.0 / resolution, resolution, device=device)


def volumes(ref: GigaReference, tsdfs: np.ndarray, resolution: int, block: int = 8):
    """qual, width (B, R, R, R) and rot (B, R, R, R, 4) float32 numpy of B
    scenes, computed ``block`` scenes at a time."""
    R = resolution
    p = grid_points(lattice(R, ref.device))
    quals, rots, widths = [], [], []
    for s in range(0, len(tsdfs), block):
        grids = torch.from_numpy(np.ascontiguousarray(tsdfs[s:s + block])).to(ref.device)
        planes = ref.encode(grids)
        q, r, w = ref.affordance(planes, p.expand(len(grids), -1, -1))
        quals.append(q.reshape(-1, R, R, R).cpu().numpy())
        rots.append(r.reshape(-1, R, R, R, 4).cpu().numpy())
        widths.append(w.reshape(-1, R, R, R).cpu().numpy())
    return np.concatenate(quals), np.concatenate(rots), np.concatenate(widths)


def process(tsdf: np.ndarray, qual: np.ndarray, width: np.ndarray, s: dict) -> np.ndarray:
    """GIGA's process() and bound(): the smoothed and masked qual volume."""
    qual = ndimage.gaussian_filter(qual, sigma=s["gaussian_sigma"], mode="nearest")
    outside = tsdf > s["out_th"]
    inside = np.logical_and(1e-3 < tsdf, tsdf < s["out_th"])
    valid = ndimage.binary_dilation(outside, iterations=2, mask=np.logical_not(inside))
    qual[~valid] = 0.0
    qual[np.logical_or(width < s["min_width"], width > s["max_width"])] = 0.0
    voxel = s["size"] / tsdf.shape[0]
    lx, ly, lz = (int(lim / voxel) for lim in s["bound_limits"])
    qual[:lx] = 0.0
    qual[-lx:] = 0.0
    qual[:, :ly] = 0.0
    qual[:, -ly:] = 0.0
    qual[:, :, :lz] = 0.0
    return qual


def select(qual: np.ndarray, s: dict):
    """GIGA's select() thresholds: (thresholded volume, best_only)."""
    qual = qual.copy()
    qual[qual < s["low_th"]] = 0.0
    best_only = bool(s["force_detection"]) and not (qual >= s["qual_th"]).any()
    if not best_only:
        qual[qual < s["qual_th"]] = 0.0
    return qual, best_only


def window_max(qual: np.ndarray, size: int) -> np.ndarray:
    """ndimage.maximum_filter(size) as GIGA's NMS takes it."""
    return ndimage.maximum_filter(qual, size=size)


def candidates(qual_sel: np.ndarray, best_only: bool, s: dict) -> np.ndarray:
    """(k, 3) voxel indices of the grasps GIGA keeps, best first."""
    peaks = (qual_sel == window_max(qual_sel, s["max_filter_size"])) & (qual_sel > 0)
    idx = np.argwhere(peaks)
    order = np.argsort(-qual_sel[tuple(idx.T)], kind="stable")
    idx = idx[order][: s["max_grasps"]]
    return idx[:1] if best_only else idx


def plan(ref: GigaReference, tsdfs: np.ndarray, s: dict) -> list:
    """Per scene a dict: the processed qual volume ``qual`` (scores are its
    values), the thresholded one ``qual_sel``, ``best_only``, ``rot``,
    ``width`` (normalized) and the kept voxels ``idx``."""
    if not len(tsdfs):
        return []
    qual, rot, width = volumes(ref, tsdfs, s["resolution"])
    out = []
    for b in range(len(tsdfs)):
        q = process(tsdfs[b], qual[b], width[b], s)
        q_sel, best_only = select(q, s)
        out.append({"qual": q, "qual_sel": q_sel, "best_only": best_only, "rot": rot[b],
                    "width": width[b], "idx": candidates(q_sel, best_only, s)})
    return out


def grasp_arrays(scene: dict, s: dict) -> dict:
    """A reference plan's kept grasps as the arrays a served list gives:
    metric positions, xyzw quaternions, metric widths and scores."""
    idx = scene["idx"]
    R = s["resolution"]
    ii = tuple(idx.T)
    pos = (idx.astype(np.float64) / R) * s["size"]  # ((-0.5 + i / R) + 0.5) * size
    return {"pos": pos, "quat": scene["rot"][ii].astype(np.float64),
            "width": scene["width"][ii].astype(np.float64) * s["size"],
            "score": scene["qual"][ii].astype(np.float64)}
