"""Kernel K1: fused conv stem + triplane pooling (csrc/stem_pool.cu).

Counterpart of giga_tpu/ops/pallas/stem_kernel.py. ``stem_pool_batched``
launches the CUDA kernel for CUDA tensors and runs ``stem_pool_plain`` for
CPU tensors; there is no other fallback.

Two modes, chosen by the inputs' dtype, each a kernel of its own: float32
(``stem_pool_f32``), and bfloat16 TSDF, weights and bias (``stem_pool_bf16``,
the TPU kernel's ``compute_dtype=bf16``): the conv runs on the tensor cores
on the bf16 operands with float32 sums, bias, ReLU and means stay float32,
and the planes come out bf16 for the U-Net.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from giga_tpu_torch.ops.kernels import _build

# the library's entry points for each input dtype: the kernel's launch and
# its launch configuration
ENTRY = {torch.float32: "stem_pool_f32", torch.bfloat16: "stem_pool_bf16"}
CONFIG = {torch.float32: "stem_pool_config", torch.bfloat16: "stem_pool_bf16_config"}
# what each kernel needs of a shape beyond C a multiple of 8 and its tiles in
# shared memory
LIMITS = {torch.float32: "Y * ceil(Z / 4) <= 416 tap threads",
          torch.bfloat16: "Z <= 48 and ceil(Y / 10) * ceil(Z / 16) <= 12 tiles of 16 z a warp"}
# csrc/stem_pool.cu's design constants, which fix the shapes each kernel takes:
# float32: channels a block, z of a tap thread's micro-tile, pooling warps,
# threads a block at most, x-slabs in shared memory; bf16: tap and pooling
# warps, m16 tiles a tap warp carries, floats per y of the xy sums; and the
# shared bytes a block may use on sm_90
CB, TZ, POOL_WARPS, MAX_THREADS, RING = 8, 4, 6, 608, 4
BF_TAP_WARPS, BF_POOL_WARPS, BF_MAX_TILES, XYS = 10, 6, 12, 72
SMEM_LIMIT = 232448


def _f32_shared_bytes(Y: int, Z: int) -> int:
    """stem_pool_config's shared bytes: the weights, the ring of zero-padded
    x-slabs and the two pooling tiles (``Layout`` in csrc/stem_pool.cu)."""
    nzr = -(-Z // TZ)
    nzq = TZ * nzr // 4
    zp = TZ * nzr + 4
    zt = TZ * nzr + (0 if nzq % 2 else 4)
    tile = Y * (CB * zt + 4)
    return 4 * (28 * CB + RING * (Y + 2) * zp + 2 * tile)


def _bf16_shared_bytes(Y: int, Z: int) -> int:
    """stem_pool_bf16_config's shared bytes (``PairGeometry<NTZ>::words``),
    0 for a Z no instance takes."""
    ntz = -(-Z // 16)
    if ntz not in (1, 2, 3):
        return 0
    zp = 16 * ntz + 4 + (0 if ntz % 2 else 8)
    return 4 * (RING * (Y + 2) * zp + 2 * (BF_TAP_WARPS * 16 * ntz * 8 + Y * XYS))


def can_stem_pool(B: int, X: int, Y: int, Z: int, C: int,
                  dtype: torch.dtype = torch.float32) -> bool:
    """Whether K1's kernel in the mode of ``dtype`` takes a (B, X, Y, Z)
    TSDF and C channels: exactly the shapes ``stem_pool_config`` /
    ``stem_pool_bf16_config`` accept (C a multiple of 8, ``LIMITS``, the
    block's shared memory). Pure Python: it loads no library, so the CPU
    evaluates it as the card does."""
    if min(B, X, Y, Z) < 1 or C < CB or C % CB:
        return False
    if dtype == torch.float32:
        threads = -(-Y * -(-Z // TZ) // 32) * 32 + 32 * POOL_WARPS
        return threads <= MAX_THREADS and _f32_shared_bytes(Y, Z) <= SMEM_LIMIT
    if dtype == torch.bfloat16:
        shmem = _bf16_shared_bytes(Y, Z)
        return (0 < shmem <= SMEM_LIMIT
                and -(-Y // BF_TAP_WARPS) * -(-Z // 16) <= BF_MAX_TILES)
    return False


def axis_mean_planes(feat: torch.Tensor, plane_types=("xz", "xy", "yz")) -> dict:
    """(B, C, X, Y, Z) voxel features -> {t: (B, H, W, C)}: the mean over the
    dropped axis, spatial axes in the plane layout (row = second axis)."""
    reductions = {"xz": 3, "xy": 4, "yz": 2}
    return {t: feat.mean(dim=reductions[t]).permute(0, 3, 2, 1) for t in plane_types}


def stem_pool_plain(weight: torch.Tensor, bias: torch.Tensor, tsdfs: torch.Tensor) -> dict:
    """Plain PyTorch version of K1: relu(conv3d(tsdf) + bias), then the three
    axis means. weight (C, 1, k, k, k), bias (C,), tsdfs (B, X, Y, Z). For
    bf16 inputs the conv, bias, ReLU and means run in float32 on the bf16
    values (products of bf16 values are exact in float32) and the planes
    are rounded to bf16."""
    k = weight.shape[-1]
    feat = F.relu(F.conv3d(tsdfs[:, None].float(), weight.float(), bias.float(),
                           padding=k // 2))
    planes = axis_mean_planes(feat)
    return {t: v.to(tsdfs.dtype) for t, v in planes.items()}


def stem_pool_batched(weight: torch.Tensor, bias: torch.Tensor, tsdfs: torch.Tensor) -> dict:
    """(B, X, Y, Z) TSDF -> {'xz': (B, Z, X, C), 'xy': (B, Y, X, C),
    'yz': (B, Z, Y, C)} pooled planes in the inputs' dtype (float32 or
    bfloat16); the CUDA kernel for CUDA tensors."""
    if tsdfs.device.type == "cpu":
        return stem_pool_plain(weight, bias, tsdfs)
    if tsdfs.device.type != "cuda":
        raise ValueError(f"stem_pool_batched: unsupported device {tsdfs.device}")
    C = weight.shape[0]
    if tsdfs.ndim != 4 or weight.shape[1:] != (1, 3, 3, 3) or bias.shape != (C,):
        raise ValueError(f"stem_pool_batched: shapes weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)}, tsdfs {tuple(tsdfs.shape)}")
    dtype = tsdfs.dtype
    if dtype not in ENTRY:
        raise ValueError(f"stem_pool_batched: unsupported dtype {dtype}")
    for name, t in (("weight", weight), ("bias", bias), ("tsdfs", tsdfs)):
        if t.device != tsdfs.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"stem_pool_batched: {name} must be contiguous {dtype} "
                             f"on {tsdfs.device}")
    B, X, Y, Z = tsdfs.shape
    stem_pool_launch_config(B, X, Y, Z, C, dtype)
    xz = torch.empty((B, Z, X, C), device=tsdfs.device, dtype=dtype)
    xy = torch.empty((B, Y, X, C), device=tsdfs.device, dtype=dtype)
    yz = torch.empty((B, Z, Y, C), device=tsdfs.device, dtype=dtype)
    stream = torch.cuda.current_stream(tsdfs.device).cuda_stream
    err = getattr(_lib(), ENTRY[dtype])(tsdfs.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                        xz.data_ptr(), xy.data_ptr(), yz.data_ptr(),
                                        B, X, Y, Z, C, stream)
    _build.check(err, ENTRY[dtype])
    stem_pool_batched.launches += 1
    return {"xz": xz, "xy": xy, "yz": yz}


stem_pool_batched.launches = 0


def stem_pool_launch_config(B: int, X: int, Y: int, Z: int, C: int,
                            dtype: torch.dtype = torch.float32) -> dict:
    """The launch K1 makes in the mode of ``dtype`` for a (B, X, Y, Z) TSDF
    and C channels: blocks, threads and dynamic shared bytes per block,
    channels per block. Raises ValueError for shapes the kernel does not
    take."""
    if dtype not in CONFIG:
        raise ValueError(f"stem_pool_launch_config: unsupported dtype {dtype}")
    info = (ctypes.c_int * 4)()
    if getattr(_lib(), CONFIG[dtype])(B, X, Y, Z, C, info) != 0:
        raise ValueError(f"stem_pool_batched: the {dtype} kernel does not take B={B}, X={X}, "
                         f"Y={Y}, Z={Z}, C={C} (it needs C a multiple of 8, {LIMITS[dtype]} "
                         f"and its slabs and tiles in shared memory)")
    return {"blocks": info[0], "threads": info[1], "shared_bytes": info[2],
            "channels_per_block": info[3]}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use, its C signatures bound."""
    lib = _build.load("stem_pool")
    p, i = ctypes.c_void_p, ctypes.c_int
    for entry in ENTRY.values():
        getattr(lib, entry).argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        getattr(lib, entry).restype = i
    for config in CONFIG.values():
        getattr(lib, config).argtypes = [i] * 5 + [ctypes.POINTER(i)]
        getattr(lib, config).restype = i
    return lib
