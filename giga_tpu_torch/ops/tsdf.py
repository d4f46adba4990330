"""Projective TSDF fusion in PyTorch (counterpart of giga_tpu/ops/tsdf.py).

``integrate_tsdf`` and ``fuse_views`` run on the device of the tensors they
are given: a map over the voxel grid in float32, the JAX function's
operations in the order its source writes them (the camera transform
summed term by term, ``round`` half-to-even, the pixel casts and the
frustum and truncation tests), each rounded as XLA:CPU rounds them at the
planner's resolutions. XLA compiles the JAX function with roundings of its
own, which move a voxel's camera depth by a float32 step (6e-8 at 0.6 m),
hence its stored value by up to 0.5 * 6e-8 / sdf_trunc (1e-6 at 40^3 over
0.3 m), and at 60^3 flip voxels' pixels: its algebraic simplifier takes
``sdf / sdf_trunc`` as a product with the float32 reciprocal and, in the
jitted ``integrate_tsdf`` (and in a scan of one view, which XLA unrolls,
but not in ``fuse_views``' scan of more), each product
``R[r, c] * ((i + 0.5) * voxel_size)`` as ``(i + 0.5) * (R[r, c] *
voxel_size)``; its code fuses the y term's product into its add to the x
term, and the running mean's ``tsdf * weight + stored``, into fused
multiply-adds. This module does the same (the fused multiply-adds in
float64, which rounds them once), and matches JAX's volumes bit for bit at
40^3, and at 60^3 but for one-view scans (tests/test_torch_tsdf.py); at
120^3 XLA also fuses the z term, and the two lie a float32 step of depth
apart. Scalars enter as
float32 tensors on the device, the counterparts of JAX's weak-typed Python
floats, and each operation is between tensors: eager ops are not
contracted, and a Python-scalar divisor would go through its rounded
reciprocal on CUDA, so the card and the CPU give the same bits.
``extract_surface_points`` is the JAX package's host numpy code.

Value convention: stored TSDF in [0, 1]; 0.5 = surface; 0 = unobserved
(weight 0). The signed distance f in [-1, 1] is stored as (f + 1) / 2, what
the reference planner reads from Open3D's voxel colors.
"""

from __future__ import annotations

import numpy as np
import torch


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """x as a 0-d float32 tensor on ``like``'s device, filled there: a copy
    from host memory would wait for the card's queue."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float32, rounded once as a fused multiply-add rounds it:
    the product of two float32 values is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _integrate(tsdf, weight, depth_img, K, extrinsic, size: float, sdf_trunc: float,
               depth_trunc: float, fold_voxel_size: bool):
    """One view's update; ``fold_voxel_size`` takes the camera transform's
    products as XLA's jitted ``integrate_tsdf`` does (see the module
    docstring), else as its ``fuse_views`` scan does."""
    res = tsdf.shape[0]
    H, W = depth_img.shape
    voxel_size = _scalar(size / res, tsdf)
    trunc = _scalar(sdf_trunc, tsdf)
    inv_trunc = _scalar(np.float32(1.0) / np.float32(sdf_trunc), tsdf)

    # voxel centers in the task frame, and their camera-frame coordinates
    half = torch.arange(res, dtype=torch.float32, device=tsdf.device) + 0.5
    R_cw = extrinsic[:3, :3]
    t_cw = extrinsic[:3, 3]
    if fold_voxel_size:
        R_cw, idx = R_cw * voxel_size, half
    else:
        idx = half * voxel_size
    px = idx[:, None, None]
    py = idx[None, :, None]
    pz = idx[None, None, :]
    cx_ = _fma(py, R_cw[0, 1], R_cw[0, 0] * px) + R_cw[0, 2] * pz + t_cw[0]
    cy_ = _fma(py, R_cw[1, 1], R_cw[1, 0] * px) + R_cw[1, 2] * pz + t_cw[1]
    cz_ = _fma(py, R_cw[2, 1], R_cw[2, 0] * px) + R_cw[2, 2] * pz + t_cw[2]

    # project to pixel coordinates (nearest-neighbour depth lookup)
    u = torch.round(K[0, 0] * cx_ / cz_ + K[0, 2]).to(torch.int32)
    v = torch.round(K[1, 1] * cy_ / cz_ + K[1, 2]).to(torch.int32)
    in_frustum = (cz_ > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)

    u_safe = torch.clamp(u, 0, W - 1).long()
    v_safe = torch.clamp(v, 0, H - 1).long()
    d = depth_img[v_safe, u_safe]
    valid_depth = (d > 0) & (d <= _scalar(depth_trunc, tsdf))

    sdf = d - cz_
    observed = in_frustum & valid_depth & (sdf >= -trunc)
    f = torch.clamp_max(sdf * inv_trunc, 1.0)  # truncated signed distance in [-1, 1]
    stored = (f + 1.0) * 0.5

    new_weight = weight + observed.to(torch.float32)
    # running mean of stored values; untouched voxels keep their value
    upd = torch.where(new_weight > 0,
                      _fma(tsdf, weight, stored) / torch.clamp_min(new_weight, 1.0), tsdf)
    new_tsdf = torch.where(observed, upd, tsdf)
    return new_tsdf, new_weight


def integrate_tsdf(tsdf: torch.Tensor, weight: torch.Tensor, depth_img: torch.Tensor,
                   K: torch.Tensor, extrinsic: torch.Tensor, *, size: float, sdf_trunc: float,
                   depth_trunc: float = 2.0):
    """Fuse one depth image into a running (tsdf, weight) pair.

    Args:
        tsdf: (R, R, R) float32 stored values in [0, 1].
        weight: (R, R, R) float32 observation counts.
        depth_img: (H, W) float32 metric depth; 0 = invalid.
        K: (3, 3) float32 intrinsics.
        extrinsic: (4, 4) float32 task-frame -> camera-frame transform.
        size: cube edge length; voxel centers at (i + 0.5) * size / R.
    Returns:
        (tsdf, weight) updated, new tensors on the same device.
    """
    return _integrate(tsdf, weight, depth_img, K, extrinsic, size, sdf_trunc, depth_trunc,
                      fold_voxel_size=True)


def fuse_views(depth_imgs: torch.Tensor, K: torch.Tensor, extrinsics: torch.Tensor, *,
               resolution: int | None = None, size: float, sdf_trunc: float,
               depth_trunc: float = 2.0, init=None):
    """Fuse a stack of views, one view's update after another (the
    counterpart of the JAX package's ``lax.scan``, rounded as XLA compiles
    it: see the module docstring), on the tensors' device.

    Args:
        depth_imgs: (V, H, W); extrinsics: (V, 4, 4); K: (3, 3).
        init: optional (tsdf, weight) to continue from; else zeros at ``resolution``.
    """
    if init is None:
        tsdf = torch.zeros((resolution,) * 3, dtype=torch.float32, device=depth_imgs.device)
        weight = torch.zeros_like(tsdf)
    else:
        tsdf, weight = init
    for d, E in zip(depth_imgs, extrinsics):
        tsdf, weight = _integrate(tsdf, weight, d, K, E, size, sdf_trunc, depth_trunc,
                                  fold_voxel_size=len(depth_imgs) == 1)
    return tsdf, weight


def extract_surface_points(
    tsdf: np.ndarray, weight: np.ndarray, voxel_size: float, with_normals: bool = False
):
    """Host-side surface point extraction at the 0.5 iso-level.

    Finds zero-crossings of (tsdf - 0.5) between observed neighbor voxels
    along each axis and linearly interpolates the crossing point, yielding an
    (N, 3) metric point cloud (equivalent role to Open3D's
    ``extract_point_cloud`` used at perception.py:117-118). With
    ``with_normals``, also returns unit normals from the central-difference
    TSDF gradient (pointing from inside [low values] toward free space
    [high values], i.e. out of the surface).
    """
    tsdf = np.asarray(tsdf)
    weight = np.asarray(weight)
    f = tsdf - 0.5
    obs = weight > 0

    if with_normals:
        # gradient on a nearest-observed fill: unobserved voxels store 0
        # ("deeply inside"), so a raw gradient at observation boundaries
        # would point sideways into the unobserved region instead of out of
        # the surface
        filled = tsdf
        if not obs.all():
            from scipy import ndimage

            nearest = ndimage.distance_transform_edt(
                ~obs, return_distances=False, return_indices=True
            )
            filled = tsdf[tuple(nearest)]
        grad = np.stack(np.gradient(filled), axis=-1)

    pts, nrms = [], []
    for axis in range(3):
        a = [slice(None)] * 3
        b = [slice(None)] * 3
        a[axis] = slice(0, -1)
        b[axis] = slice(1, None)
        a, b = tuple(a), tuple(b)
        fa, fb = f[a], f[b]
        cross = (np.sign(fa) != np.sign(fb)) & obs[a] & obs[b] & (fa != fb)
        ii, jj, kk = np.nonzero(cross)
        if ii.size == 0:
            continue
        frac = fa[cross] / (fa[cross] - fb[cross])
        base = np.stack([ii, jj, kk], axis=1).astype(np.float64) + 0.5
        base[:, axis] += frac
        pts.append(base * voxel_size)
        if with_normals:
            g = grad[ii, jj, kk]
            n = g / np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-12)
            nrms.append(n)
    if not pts:
        empty = np.zeros((0, 3))
        return (empty, empty.copy()) if with_normals else empty
    points = np.concatenate(pts, axis=0)
    if with_normals:
        return points, np.concatenate(nrms, axis=0)
    return points
