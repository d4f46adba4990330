"""The comparison that decides ``correct``: each served answer judged by
what it says against the plain reference.

Grasp lists (one served request against the reference's plan of its
scene), in the units of the qual volume and of the pose:

  * ``score_gap``: the widest gap, in qual, by which a served list departs
    from the reference: a served score against the reference's qual at its
    voxel; by how much the reference's NMS window around a served grasp
    holds a better value (it is no peak there); by how much a served grasp
    lies below the threshold; a served list out of order; and by how much a
    grasp the reference keeps, with no served grasp at its voxel, lies above
    the best served one within its NMS window's reach, or else above the
    threshold (the only one, when force_detection keeps the best alone). A tie that
    rounding breaks the other way reads as the size of the tie.
  * ``pose_gap``: the widest of a served quaternion's components against the
    reference's at its voxel (up to sign), a served width against the
    reference's (both over the workspace size), and a served position's
    distance from its lattice point, in voxels.

Meshes (one returned mesh against the reference's occupancy logits on the
same lattice, padded as the configuration states), in units of a lattice
edge:

  * ``vertex_gap``: each vertex lies on an edge of the tetrahedral split
    (reference/marching.py), a + t d, and says the field crosses the level
    at t; the gap is |t - t_ref| from the reference's values at a and a + d.
    A vertex at a lattice point takes its nearest crossing among the edges
    there. An edge the reference crosses and the mesh does not reads
    min(t_ref, 1 - t_ref): a corner that rounding puts on the other side
    lies close to the level. A vertex on no edge reads infinity.
  * ``face_gap``: the triangles in each cell against the count the
    reference's signs give that cell, summed over the cells as absolute
    differences, over the reference's total.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.marching import DIRS, TRIANGLES_PER_CUBE, cube_codes
from portbench.reference.planner import window_max


def plan_gaps(served: dict, scene: dict, s: dict):
    """(score_gap, pose_gap) of one served grasp list (arrays ``pos`` (k, 3)
    metres, ``quat`` (k, 4) xyzw, ``width`` (k,) metres, ``score`` (k,))
    against the reference plan of its scene (reference/planner.py's
    ``plan``)."""
    R, size = s["resolution"], s["size"]
    voxel = size / R
    qual, qual_sel = scene["qual"], scene["qual_sel"]
    pos = np.asarray(served["pos"], np.float64).reshape(-1, 3)
    k = len(pos)
    idx = np.rint(pos / voxel).astype(np.int64)
    if k and (idx.min() < 0 or idx.max() >= R):
        return np.inf, np.inf
    ii = tuple(idx.T)
    score = np.asarray(served["score"], np.float64).reshape(-1)
    gaps = [0.0]
    if k:
        q = qual[ii].astype(np.float64)
        wm = window_max(qual_sel, s["max_filter_size"])[ii]
        gaps += [np.abs(score - q).max(), np.maximum(wm - q, 0).max()]
        first = 1 if scene["best_only"] else 0
        if k > first:
            gaps.append(np.maximum(s["qual_th"] - q[first:], 0).max())
        if k > 1:
            gaps.append(np.maximum(np.diff(score), 0).max())
    served_q = qual[ii].astype(np.float64) if k else np.zeros(0)
    floor = 0.0 if scene["best_only"] else s["qual_th"]
    if k >= s["max_grasps"]:
        floor = max(floor, served_q.min())
    reach = s["max_filter_size"] // 2  # the farthest offset of scipy's window
    have = {tuple(v) for v in idx}
    for c in scene["idx"]:
        if tuple(c) in have:
            continue
        qc = float(qual[tuple(c)])
        near = np.abs(idx - c).max(1) <= reach if k else np.zeros(0, bool)
        gaps.append(max(qc - (served_q[near].max() if near.any() else floor), 0.0))
    score_gap = float(max(gaps))
    if not k:
        return score_gap, 0.0
    quat = np.asarray(served["quat"], np.float64).reshape(-1, 4)
    ref_q = scene["rot"][ii].astype(np.float64)
    rot = np.minimum(np.abs(quat - ref_q).max(1), np.abs(quat + ref_q).max(1)).max()
    width = np.abs(np.asarray(served["width"], np.float64) / size
                   - scene["width"][ii].astype(np.float64)).max()
    at = np.abs(pos / voxel - idx).max()
    return score_gap, float(max(rot, width, at))


def padded(values: np.ndarray, pad: float) -> np.ndarray:
    """The lattice of values with one layer of ``pad`` around it."""
    return np.pad(np.asarray(values, np.float64), 1, constant_values=pad)


def mesh_gaps(vertices: np.ndarray, faces: np.ndarray, values: np.ndarray, iso: float,
              box: float, pad: float):
    """(vertex_gap, face_gap) of one mesh (vertices in workspace units,
    lattice point i of n at box * (i / (n - 1) - 0.5)) against the
    reference's (n, n, n) values."""
    n = values.shape[0]
    P = padded(values, pad)
    m = P.shape[0]
    flat = np.array([m * m, m, 1])
    g = (np.asarray(vertices, np.float64) / box + 0.5) * (n - 1) + 1.0
    r = np.rint(g)
    isint = np.abs(g - r) < 1e-6
    a = np.where(isint, r, np.floor(g)).astype(np.int64)
    frac = np.where(isint, 0.0, g - a)
    t = frac.max(1) if len(g) else np.zeros(0)
    on_edge = np.all(isint | (np.abs(frac - t[:, None]) < 1e-6), axis=1)
    inside = np.all((a >= 0) & (a < m), axis=1)

    def t_ref(lo, d):
        fa, fb = P[tuple(lo.T)], P[tuple((lo + d).T)]
        with np.errstate(divide="ignore", invalid="ignore"):
            return (iso - fa) / (fb - fa)

    gap = np.full(len(g), np.inf)
    keys = np.full(len(g), -1, np.int64)
    gen = on_edge & inside & ~isint.all(1)
    d = (~isint[gen]).astype(np.int64)
    lo = a[gen]
    ok = np.all(lo + d < m, axis=1)
    tr = np.full(len(lo), np.nan)
    tr[ok] = t_ref(lo[ok], d[ok])
    gap[gen] = np.where(ok, np.abs(t[gen] - tr), np.inf)
    keys[gen] = (lo @ flat) * 8 + d @ np.array([1, 2, 4])
    pts = np.flatnonzero(on_edge & inside & isint.all(1))
    if len(pts):
        p = a[pts]
        best = np.full(len(pts), np.inf)
        best_key = np.full(len(pts), -1, np.int64)
        for dv in DIRS:
            code = dv @ np.array([1, 2, 4])
            for low, side in ((p, 0.0), (p - dv, 1.0)):
                ok = np.all((low >= 0) & (low + dv < m), axis=1)
                dist = np.full(len(pts), np.inf)
                dist[ok] = np.abs(side - t_ref(low[ok], dv))
                better = dist < best
                best = np.where(better, dist, best)
                best_key = np.where(better, (low @ flat) * 8 + code, best_key)
        gap[pts], keys[pts] = best, best_key
    worst = float(gap.max()) if len(gap) else 0.0
    above = P > iso
    missing = 0.0
    for dv in DIRS:
        dx, dy, dz = dv
        cross = above[:m - dx, :m - dy, :m - dz] != above[dx:, dy:, dz:]
        lo = np.argwhere(cross)
        ek = (lo @ flat) * 8 + dv @ np.array([1, 2, 4])
        miss = ~np.isin(ek, keys)
        if miss.any():
            tr = t_ref(lo[miss], dv)
            missing = max(missing, float(np.minimum(tr, 1 - tr).max()))
    vertex_gap = max(worst, missing)

    ref_counts = TRIANGLES_PER_CUBE[cube_codes(P, iso)].reshape(-1)
    if len(faces):
        cen = g[np.asarray(faces)].mean(1)
        cell = np.clip(np.floor(cen).astype(np.int64), 0, m - 2)
        cells = cell @ np.array([(m - 1) ** 2, m - 1, 1])
        counts = np.bincount(cells, minlength=(m - 1) ** 3)
    else:
        counts = np.zeros_like(ref_counts)
    face_gap = float(np.abs(counts - ref_counts).sum() / max(ref_counts.sum(), 1))
    return vertex_gap, face_gap
