"""Small 3D stencil ops for the grasp planner (counterpart of
giga_tpu/ops/filters.py), over the LAST THREE axes of a tensor; leading
axes are batch.

  * ``gaussian_blur_3d``       ~ ndimage.gaussian_filter(sigma, mode='nearest')
  * ``masked_binary_dilation`` ~ ndimage.binary_dilation(iterations, mask=...)
  * ``max_filter_3d``          ~ ndimage.maximum_filter(size=k)
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy-compatible 1D Gaussian kernel: radius = int(truncate*sigma + 0.5)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    return (phi / phi.sum()).astype(np.float32)


def blur_matrix_1d(n: int, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """(n, n) operator of a 1D Gaussian blur with edge-replicate boundaries:
    out[i] = sum_j T[i, j] v[j]; clamped taps accumulate on the border
    columns, so it equals correlation with edge padding."""
    k = gaussian_kernel_1d(sigma, truncate)
    r = (len(k) - 1) // 2
    T = np.zeros((n, n), np.float32)
    rows = np.arange(n)
    for t, w in enumerate(k):
        np.add.at(T, (rows, np.clip(rows + t - r, 0, n - 1)), w)
    return T


@functools.lru_cache(maxsize=32)
def _blur_operator(n: int, sigma: float, truncate: float, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """``blur_matrix_1d`` on ``device``, copied there once: a copy from
    pageable host memory waits for the card's queue, which would stall every
    planning call mid-way."""
    return torch.from_numpy(blur_matrix_1d(n, sigma, truncate)).to(device=device, dtype=dtype)


def gaussian_blur_3d(vol: torch.Tensor, sigma: float = 1.0, truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur with 'nearest' boundaries, one dense (n, n)
    matmul per axis. Needs full-precision fp32 matmuls (no TF32)."""
    for axis in range(vol.ndim - 3, vol.ndim):
        T = _blur_operator(vol.shape[axis], float(sigma), float(truncate), vol.device, vol.dtype)
        v = torch.movedim(vol, axis, -1)
        vol = torch.movedim(v @ T.T, -1, axis)
    return vol


def _shift(b: torch.Tensor, axis: int, step: int) -> torch.Tensor:
    """b shifted by ``step`` along ``axis``, zero (False) filled."""
    n = b.shape[axis]
    out = torch.zeros_like(b)
    if step > 0:
        out.narrow(axis, step, n - step).copy_(b.narrow(axis, 0, n - step))
    else:
        out.narrow(axis, 0, n + step).copy_(b.narrow(axis, -step, n + step))
    return out


def _cross_dilate(b: torch.Tensor) -> torch.Tensor:
    """One binary dilation step with the 6-connected structure."""
    out = b
    for axis in range(b.ndim - 3, b.ndim):
        out = out | _shift(b, axis, 1) | _shift(b, axis, -1)
    return out


def masked_binary_dilation(seed: torch.Tensor, mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """Positions where ``mask`` is False keep their ``seed`` value; masked-in
    positions take the dilation result each iteration."""
    cur = seed
    for _ in range(iterations):
        cur = torch.where(mask, _cross_dilate(cur), seed)
    return cur


def max_filter_3d(vol: torch.Tensor, size: int) -> torch.Tensor:
    """ndimage.maximum_filter(vol, size=size). For even ``size`` scipy's
    window spans offsets [-size//2, size - size//2 - 1] (size 4: [-2, +1]),
    so each axis is padded with -inf unevenly; -inf equals scipy's 'reflect'
    here because reflected values always lie inside the window."""
    lo = size // 2
    hi = size - lo - 1
    for axis in range(vol.ndim - 3, vol.ndim):
        n = vol.shape[axis]

        def fill(k):
            shape = vol.shape[:axis] + (k,) + vol.shape[axis + 1:]
            return torch.full(shape, -torch.inf, dtype=vol.dtype, device=vol.device)

        padded = torch.cat([fill(lo), vol, fill(hi)], dim=axis)
        out = padded.narrow(axis, 0, n)
        for s in range(1, size):
            out = torch.maximum(out, padded.narrow(axis, s, n))
        vol = out
    return vol
