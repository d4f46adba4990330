"""Kernel K1: fused conv stem + triplane pooling (csrc/stem_pool.cu).

Counterpart of giga_tpu/ops/pallas/stem_kernel.py. ``stem_pool_batched``
launches the CUDA kernel for CUDA tensors and runs ``stem_pool_plain`` for
CPU tensors; there is no other fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from giga_tpu_torch.ops.kernels import _build


def axis_mean_planes(feat: torch.Tensor, plane_types=("xz", "xy", "yz")) -> dict:
    """(B, C, X, Y, Z) voxel features -> {t: (B, H, W, C)}: the mean over the
    dropped axis, spatial axes in the plane layout (row = second axis)."""
    reductions = {"xz": 3, "xy": 4, "yz": 2}
    return {t: feat.mean(dim=reductions[t]).permute(0, 3, 2, 1) for t in plane_types}


def stem_pool_plain(weight: torch.Tensor, bias: torch.Tensor, tsdfs: torch.Tensor) -> dict:
    """Plain PyTorch version of K1: relu(conv3d(tsdf) + bias), then the three
    axis means. weight (C, 1, k, k, k), bias (C,), tsdfs (B, X, Y, Z)."""
    k = weight.shape[-1]
    feat = F.relu(F.conv3d(tsdfs[:, None], weight, bias, padding=k // 2))
    return axis_mean_planes(feat)


def stem_pool_batched(weight: torch.Tensor, bias: torch.Tensor, tsdfs: torch.Tensor) -> dict:
    """(B, X, Y, Z) TSDF -> {'xz': (B, Z, X, C), 'xy': (B, Y, X, C),
    'yz': (B, Z, Y, C)} pooled planes; the CUDA kernel for CUDA tensors."""
    if tsdfs.device.type == "cpu":
        return stem_pool_plain(weight, bias, tsdfs)
    if tsdfs.device.type != "cuda":
        raise ValueError(f"stem_pool_batched: unsupported device {tsdfs.device}")
    C = weight.shape[0]
    if tsdfs.ndim != 4 or weight.shape[1:] != (1, 3, 3, 3) or bias.shape != (C,):
        raise ValueError(f"stem_pool_batched: shapes weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)}, tsdfs {tuple(tsdfs.shape)}")
    for name, t in (("weight", weight), ("bias", bias), ("tsdfs", tsdfs)):
        if t.device != tsdfs.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"stem_pool_batched: {name} must be contiguous float32 "
                             f"on {tsdfs.device}")
    B, X, Y, Z = tsdfs.shape
    lib = _lib()
    if C % 4 != 0 or Y * Z > lib.stem_pool_max_yz():
        raise ValueError(f"stem_pool_batched: needs C % 4 == 0 and Y*Z <= "
                         f"{lib.stem_pool_max_yz()}, got C={C}, Y*Z={Y * Z}")
    xz = torch.empty((B, Z, X, C), device=tsdfs.device, dtype=torch.float32)
    xy = torch.empty((B, Y, X, C), device=tsdfs.device, dtype=torch.float32)
    yz = torch.empty((B, Z, Y, C), device=tsdfs.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(tsdfs.device).cuda_stream
    err = lib.stem_pool_f32(tsdfs.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                            xz.data_ptr(), xy.data_ptr(), yz.data_ptr(),
                            B, X, Y, Z, C, stream)
    _build.check(err, "stem_pool_f32")
    stem_pool_batched.launches += 1
    return {"xz": xz, "xy": xy, "yz": yz}


stem_pool_batched.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use, its C signatures bound."""
    lib = _build.load("stem_pool")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stem_pool_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.stem_pool_f32.restype = i
    lib.stem_pool_max_yz.argtypes = []
    lib.stem_pool_max_yz.restype = i
    return lib
