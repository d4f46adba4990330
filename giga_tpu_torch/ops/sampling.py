"""Feature-plane sampling with exact torch ``grid_sample`` semantics
(counterpart of giga_tpu/ops/sampling.py).

The GIGA decoders sample each 2D feature plane with ``grid_sample(bilinear,
padding_mode='border', align_corners=True)`` after normalizing coordinates
to [0, 1] (reference ConvONets/common.py:238-261), in three forms:

  * ``sample_plane``: bilinear sampling by gathers, for arbitrary points;
  * ``sample_plane_mm``: the same weights as one dense (N, H*W) matrix per
    chunk of points, one matmul instead of four gathers a point;
  * ``interp_matrix_1d`` / ``sample_plane_lattice``: on a tensor-product
    lattice of points (the planner's R^3 grid) sampling factorizes into
    two small dense matmuls per plane.

Conventions:
  * Points live in [-0.5, 0.5]^3.
  * ``normalize_coordinate``: u = p / (1 + padding + 1e-5) + 0.5, then
    values >= 1 become 1 - 1e-5 and values < 0 become 0 (not a clamp);
    ``normalize_3d_coordinate`` the same with 1e-3. The division is a true
    division on every device (``_divide``), so the card's coordinates are
    the CPU's bit for bit.
  * align_corners=True: u in [0, 1] maps to pixel coordinate u * (R - 1);
    border padding clamps it to [0, R - 1], and the lower tap is clipped to
    R - 2, so the last cell interpolates with weight 1.
  * Plane layout (H, W, C): ``col`` indexes the first plane axis (u[..., 0]),
    ``row`` the second; a 3D grid (D, H, W, C) is laid out [z, y, x, c].

Operands of mixed dtypes (bf16 planes, float32 weights) are promoted as
the JAX package's arithmetic promotes them: the result is float32.
"""

from __future__ import annotations

import contextlib
import math

import torch

from giga_tpu_torch.core.precision import full_precision

# first/second plane coordinate for each canonical plane, as indices into (x, y, z)
PLANE_AXES = {"xz": (0, 2), "xy": (0, 1), "yz": (1, 2)}
PLANE_ORDER = ("xz", "xy", "yz")


def _divide(p: torch.Tensor, d: float) -> torch.Tensor:
    """p / d, correctly rounded on every device: CUDA divides by a Python
    scalar as a product with its rounded reciprocal, a bit off the CPU's
    (and XLA's) quotient, and a sampling coordinate carries that bit times
    the plane's gradient into the features."""
    return p / torch.full((), d, dtype=p.dtype, device=p.device)


def normalize_coordinate(p2: torch.Tensor, padding: float = 0.0) -> torch.Tensor:
    """Map plane coordinates from [-0.5, 0.5] to [0, 1): divide by
    (1 + padding + 1e-5), shift by 0.5, set values >= 1 to 1 - 1e-5 and
    values < 0 to 0. Values in (1 - 1e-5, 1) pass through unchanged."""
    u = _divide(p2, 1.0 + padding + 1e-5) + 0.5
    u = torch.where(u >= 1.0, torch.full_like(u, 1.0 - 1e-5), u)
    u = torch.where(u < 0.0, torch.zeros_like(u), u)
    return u


def normalize_3d_coordinate(p3: torch.Tensor, padding: float = 0.0) -> torch.Tensor:
    """The 3D variant of ``normalize_coordinate``, with the reference's
    other epsilon, 1e-3 (common.py:263-279)."""
    u = _divide(p3, 1.0 + padding + 1e-3) + 0.5
    u = torch.where(u >= 1.0, torch.full_like(u, 1.0 - 1e-3), u)
    u = torch.where(u < 0.0, torch.zeros_like(u), u)
    return u


def _taps(f: torch.Tensor, n: int):
    """The lower and upper taps of pixel coordinates ``f`` on an axis of n
    samples: floor(f) clipped to [0, n - 2], and the next one. An axis of
    one sample takes both at 0, as the JAX package's gather clamps its
    out-of-range index (its ``W > 1`` / ``H > 1`` guards); f is 0 there."""
    i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, max(n - 2, 0))
    return i0, torch.clamp(i0 + 1, max=n - 1)


def sample_plane(plane: torch.Tensor, p: torch.Tensor, plane_type: str,
                 padding: float = 0.0) -> torch.Tensor:
    """Bilinearly sample one (H, W, C) feature plane at (N, 3) points by
    gathers -> (N, C)."""
    a0, a1 = PLANE_AXES[plane_type]
    # a stack, not p[:, [a0, a1]]: a list index is a host tensor, copied to
    # the card with a sync
    u = normalize_coordinate(torch.stack((p[:, a0], p[:, a1]), dim=-1), padding)
    H, W, _ = plane.shape
    fx = torch.clamp(u[:, 0] * (W - 1), 0.0, W - 1)  # col
    fy = torch.clamp(u[:, 1] * (H - 1), 0.0, H - 1)  # row
    (x0, x1), (y0, y1) = _taps(fx, W), _taps(fy, H)
    wx = (fx - x0.to(fx.dtype))[:, None]
    wy = (fy - y0.to(fy.dtype))[:, None]
    f00, f01 = plane[y0, x0], plane[y0, x1]
    f10, f11 = plane[y1, x0], plane[y1, x1]
    top = f00 + (f01 - f00) * wx
    bot = f10 + (f11 - f10) * wx
    return top + (bot - top) * wy


def sample_planes_concat(planes: dict, p: torch.Tensor, padding: float = 0.0) -> torch.Tensor:
    """Every plane of {t: (H, W, C)} sampled at (N, 3) points, concatenated
    in the reference decoder's order xz, xy, yz -> (N, 3C)."""
    return torch.cat([sample_plane(planes[t], p, t, padding) for t in PLANE_ORDER
                      if t in planes], dim=-1)


def normalize_coord(p: torch.Tensor, vol_range, plane_type: str = "xz") -> torch.Tensor:
    """Points normalized to [0, 1] within an explicit volume range and
    projected onto a plane ('grid' keeps 3D): the sliding-window-crop
    variant (reference common.py:281-301)."""
    lo = torch.as_tensor(vol_range[0], dtype=p.dtype, device=p.device)
    hi = torch.as_tensor(vol_range[1], dtype=p.dtype, device=p.device)
    u = (p - lo) / (hi - lo)
    if plane_type == "grid":
        return u
    a0, a1 = PLANE_AXES[plane_type]
    return u[..., [a0, a1]]


def positional_encoding_sincos(p: torch.Tensor, num_freqs: int = 10) -> torch.Tensor:
    """NeRF-style encoding (reference common.py:422-444): p in [0, 1] mapped
    to [-1, 1], then [sin(f pi x), cos(f pi x)] for f = 2^0 .. 2^(L-1);
    (..., D) -> (..., 2 L D)."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=p.dtype, device=p.device) * math.pi
    args = (2.0 * p - 1.0)[..., None, :] * freqs[:, None]  # (..., L, D)
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1).reshape(*p.shape[:-1], -1)


def map2local(p: torch.Tensor, unit_size: float, pos_encoding: str = "linear") -> torch.Tensor:
    """Points mapped to per-voxel local coordinates (reference
    common.py:404-420), sin/cos-encoded for ``pos_encoding="sin_cos"``."""
    local = _divide(torch.remainder(p, unit_size), unit_size)
    if pos_encoding == "sin_cos":
        return positional_encoding_sincos(local)
    return local


def sample_grid(grid: torch.Tensor, p: torch.Tensor, padding: float = 0.0) -> torch.Tensor:
    """Trilinearly sample a (D, H, W, C) feature grid laid out [z, y, x, c]
    at (N, 3) points -> (N, C): ``normalize_3d_coordinate``, then
    grid_sample(bilinear, border, align_corners=True) on 5D inputs
    (reference decoder.py:124-130)."""
    u = normalize_3d_coordinate(p, padding)
    D, H, W, _ = grid.shape
    fx = torch.clamp(u[:, 0] * (W - 1), 0.0, W - 1)
    fy = torch.clamp(u[:, 1] * (H - 1), 0.0, H - 1)
    fz = torch.clamp(u[:, 2] * (D - 1), 0.0, D - 1)
    xs, ys, zs = _taps(fx, W), _taps(fy, H), _taps(fz, D)
    wx = (fx - xs[0].to(fx.dtype))[:, None]
    wy = (fy - ys[0].to(fy.dtype))[:, None]
    wz = (fz - zs[0].to(fz.dtype))[:, None]

    def at(dz, dy, dx):
        return grid[zs[dz], ys[dy], xs[dx]]

    c00 = at(0, 0, 0) * (1 - wx) + at(0, 0, 1) * wx
    c01 = at(0, 1, 0) * (1 - wx) + at(0, 1, 1) * wx
    c10 = at(1, 0, 0) * (1 - wx) + at(1, 0, 1) * wx
    c11 = at(1, 1, 0) * (1 - wx) + at(1, 1, 1) * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


def interp_matrix_1d(coords: torch.Tensor, reso: int, padding: float = 0.0) -> torch.Tensor:
    """(N, reso) matrix M with M @ f == bilinear 1D interpolation of f at
    ``coords`` (raw coordinates in [-0.5, 0.5]); the lower tap index is
    clipped to reso - 2, so the last cell interpolates with weight 1.
    The weights are formed in the dtype of ``coords`` (bf16 query points in
    the bf16 training step, as the JAX package forms them) and returned in
    float32."""
    u = normalize_coordinate(coords, padding)
    f = torch.clamp(u * (reso - 1), 0.0, reso - 1)
    i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, reso - 2)
    w = f - i0.to(f.dtype)
    cols = torch.arange(reso, device=coords.device)[None, :]
    m0 = (cols == i0[:, None]).to(f.dtype) * (1.0 - w)[:, None]
    m1 = (cols == (i0 + 1)[:, None]).to(f.dtype) * w[:, None]
    return (m0 + m1).to(torch.float32)


def sample_plane_lattice(plane: torch.Tensor, row_m: torch.Tensor, col_m: torch.Tensor):
    """Sample a (H, W, C) plane on the lattice of two 1D interp matrices:
    returns (Nrow, Ncol, C) = row_m @ plane @ col_m^T per channel."""
    t = torch.einsum("rh,hwc->rwc", row_m, plane)
    return torch.einsum("qw,rwc->rqc", col_m, t)


def sample_plane_mm(plane: torch.Tensor, p: torch.Tensor, plane_type: str,
                    padding: float = 0.0, chunk: int = 8192,
                    precision: str | None = None) -> torch.Tensor:
    """``sample_plane`` without gathers: each point's four bilinear weights
    are one row of a dense (N, H*W) matrix (the outer product of its two
    ``interp_matrix_1d`` rows: the same clamping and epsilon), and sampling
    is one (chunk, H*W) @ (H*W, C) matmul per chunk of points -> (N, C).

    ``precision="highest"`` runs the matmuls under ``full_precision`` (TF32
    off on the card), the JAX package's ``Precision.HIGHEST``; None takes
    the ambient precision, as its default does."""
    a0, a1 = PLANE_AXES[plane_type]
    H, W, C = plane.shape
    mc = interp_matrix_1d(p[:, a0], W, padding)  # (N, W) col weights
    mr = interp_matrix_1d(p[:, a1], H, padding)  # (N, H) row weights
    dtype = torch.promote_types(mc.dtype, plane.dtype)
    flat = plane.reshape(H * W, C).to(dtype)
    out = []
    with full_precision() if precision == "highest" else contextlib.nullcontext():
        for i in range(0, p.shape[0], chunk):
            w2 = (mr[i:i + chunk, :, None] * mc[i:i + chunk, None, :]).reshape(-1, H * W)
            out.append(w2.to(dtype) @ flat)
    return torch.cat(out) if out else flat.new_zeros((0, C))


def sample_planes_concat_mm(planes: dict, p: torch.Tensor, padding: float = 0.0,
                            chunk: int = 8192, precision: str | None = None) -> torch.Tensor:
    """``sample_planes_concat`` through ``sample_plane_mm``."""
    return torch.cat([sample_plane_mm(planes[t], p, t, padding, chunk, precision)
                      for t in PLANE_ORDER if t in planes], dim=-1)

