"""Point-cloud ICP alignment (counterpart of giga_tpu/geometry/icp.py; role
of ConvONets/utils/icp.py): iterated nearest-neighbour correspondences
(scipy's cKDTree) and the Kabsch / Umeyama closed form."""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def best_fit_transform(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid transform (with a scale if asked) of paired
    points src -> dst: (T 4x4, R 3x3, t (3,))."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    s, d = src - mu_s, dst - mu_d
    U, S, Vt = np.linalg.svd(s.T @ d)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:  # a reflection
        Vt[-1] *= -1
        R = Vt.T @ U.T
    if with_scale:
        R = R * (S.sum() / max((s ** 2).sum(), 1e-12))
    t = mu_d - R @ mu_s
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T, R, t


def icp(src: np.ndarray, dst: np.ndarray, max_iterations: int = 50, tolerance: float = 1e-7,
        with_scale: bool = False):
    """Align src onto dst: (T 4x4, final mean nearest distance, iterations)."""
    tree = cKDTree(dst)
    cur = np.asarray(src, float).copy()
    prev_err, T_total, it = np.inf, np.eye(4), 0
    for it in range(max_iterations):
        dist, idx = tree.query(cur)
        T, _, _ = best_fit_transform(cur, dst[idx], with_scale)
        cur = cur @ T[:3, :3].T + T[:3, 3]
        T_total = T @ T_total
        err = dist.mean()
        if abs(prev_err - err) < tolerance:
            break
        prev_err = err
    dist, _ = tree.query(cur)
    return T_total, float(dist.mean()), it + 1
