"""Mesh / occupancy evaluation metrics (counterpart of
giga_tpu/geometry/eval.py; reference: ConvONets/eval.py:28-232).

Metrics: occupancy IoU (via native containment), Chamfer-L1/L2
(completeness/accuracy split), normal consistency, F-score at 1/1.5/2 % of
the unit-cube scale. Nearest neighbors through scipy's cKDTree (the compiled
replacement for the vendored pykdtree).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from giga_tpu_torch.geometry.native import check_mesh_contains

# worst-case values with the SAME keys the non-empty path returns, so
# aggregating consumers don't need a schema branch on the 'empty' sentinel
EMPTY_PCL_DICT = {
    "completeness": np.sqrt(3),
    "accuracy": np.sqrt(3),
    "completeness2": 3.0,
    "accuracy2": 3.0,
    "chamfer-L1": np.sqrt(3),
    "chamfer-L2": 3.0,
    "f-score": 0.0,
    "f-score-15": 0.0,
    "f-score-20": 0.0,
    "empty": True,
}

EMPTY_PCL_DICT_NORMALS = {
    "normals completeness": -1.0,
    "normals accuracy": -1.0,
    "normals": -1.0,
}


def compute_iou(occ1, occ2):
    """IoU of two boolean/probability occupancy vectors (common.py:11-39)."""
    occ1 = np.asarray(occ1) >= 0.5
    occ2 = np.asarray(occ2) >= 0.5
    union = (occ1 | occ2).sum(axis=-1)
    inter = (occ1 & occ2).sum(axis=-1)
    return inter / np.maximum(union, 1)


def distance_p2p(points_src, normals_src, points_tgt, normals_tgt):
    """NN distance from each src point to tgt + |normal dot| at the NN."""
    kdtree = cKDTree(points_tgt)
    dist, idx = kdtree.query(points_src)
    if normals_src is not None and normals_tgt is not None:
        ns = normals_src / np.linalg.norm(normals_src, axis=-1, keepdims=True)
        nt = normals_tgt / np.linalg.norm(normals_tgt, axis=-1, keepdims=True)
        dots = np.abs((nt[idx] * ns).sum(axis=-1))
    else:
        dots = np.full(len(points_src), np.nan, np.float32)
    return dist, dots


def get_threshold_percentage(dist, thresholds):
    """Fraction of distances <= each threshold.

    One sort + searchsorted instead of a pass per threshold (the reference
    sweeps 1000 thresholds over 100k distances per mesh)."""
    s = np.sort(np.asarray(dist))
    return (np.searchsorted(s, np.asarray(thresholds), side="right")
            / max(len(s), 1)).tolist()


class MeshEvaluator:
    """Evaluates predicted meshes against GT point clouds + occupancy."""

    def __init__(self, n_points: int = 100000, rng=None):
        self.n_points = n_points
        self.rng = rng or np.random

    def eval_mesh(self, mesh, pointcloud_tgt, normals_tgt, points_iou, occ_tgt):
        if len(mesh.vertices) and len(mesh.faces):
            pointcloud, idx = mesh.sample_surface(self.n_points, rng=self.rng)
            pointcloud = pointcloud.astype(np.float32)
            normals = mesh.face_normals[idx]
        else:
            pointcloud = np.empty((0, 3))
            normals = np.empty((0, 3))

        out = self.eval_pointcloud(pointcloud, pointcloud_tgt, normals, normals_tgt)
        if len(mesh.vertices) and len(mesh.faces):
            occ = check_mesh_contains(mesh, points_iou)
            out["iou"] = float(compute_iou(occ, occ_tgt))
        else:
            out["iou"] = 0.0
        return out

    def eval_occ(self, mesh, points_iou, occ_tgt, ext: str = ""):
        out = {}
        occ = np.zeros(len(points_iou), bool)
        if len(mesh.vertices) and len(mesh.faces):
            occ = check_mesh_contains(mesh, points_iou)
            out["iou" + ext] = float(compute_iou(occ, occ_tgt))
        else:
            out["iou" + ext] = 0.0
        out["precision" + ext] = float(np.logical_and(occ, occ_tgt).sum() / max(occ.sum(), 1))
        out["recall" + ext] = float(np.logical_and(occ, occ_tgt).sum() / max(occ_tgt.sum(), 1))
        return out

    def eval_pointcloud(self, pointcloud, pointcloud_tgt, normals=None, normals_tgt=None,
                        thresholds=np.linspace(1.0 / 1000, 1, 1000)):
        if pointcloud.shape[0] == 0:
            out = EMPTY_PCL_DICT.copy()
            if normals is not None and normals_tgt is not None:
                out.update(EMPTY_PCL_DICT_NORMALS)
            return out

        pointcloud = np.asarray(pointcloud)
        pointcloud_tgt = np.asarray(pointcloud_tgt)

        completeness, completeness_normals = distance_p2p(
            pointcloud_tgt, normals_tgt, pointcloud, normals
        )
        recall = get_threshold_percentage(completeness, thresholds)
        completeness2 = (completeness**2).mean()
        completeness = completeness.mean()
        completeness_normals = completeness_normals.mean()

        accuracy, accuracy_normals = distance_p2p(
            pointcloud, normals, pointcloud_tgt, normals_tgt
        )
        precision = get_threshold_percentage(accuracy, thresholds)
        accuracy2 = (accuracy**2).mean()
        accuracy = accuracy.mean()
        accuracy_normals = accuracy_normals.mean()

        chamferL2 = 0.5 * (completeness2 + accuracy2)
        chamferL1 = 0.5 * (completeness + accuracy)
        normals_correctness = 0.5 * completeness_normals + 0.5 * accuracy_normals
        F = [
            2 * precision[i] * recall[i] / max(precision[i] + recall[i], 1e-12)
            for i in range(len(precision))
        ]
        return {
            "completeness": float(completeness),
            "accuracy": float(accuracy),
            "normals completeness": float(completeness_normals),
            "normals accuracy": float(accuracy_normals),
            "normals": float(normals_correctness),
            "completeness2": float(completeness2),
            "accuracy2": float(accuracy2),
            "chamfer-L2": float(chamferL2),
            "chamfer-L1": float(chamferL1),
            "f-score": F[9],       # 1.0 %
            "f-score-15": F[14],   # 1.5 %
            "f-score-20": F[19],   # 2.0 %
        }
