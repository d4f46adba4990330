"""Grid-decode kernel K6 (csrc/grid_decode.cu), with its inputs, its plain
version and its shape predicate.

K6 decodes B scenes' R^3 query lattices straight from the encoder's
(B, G, G, G, C) float32 feature grids (laid out [b, z, y, x, c]) in one
launch: the trilinear sampling of ``ops/sampling.sample_grid_lattice_batched``
(the same taps, the same order), each block's fc_c projection of the
sampled row and the per-head ResnetBlockFC trunk of K2 (``decoder.py``),
written as K2 writes, (B, heads*O, R^3). It replaces no Pallas kernel: the
JAX package decodes a grid model with XLA, as the module path
(``inference/dense_decode.py``) does here.

``grid_decode_batched`` launches the CUDA kernel for CUDA tensors and runs
``grid_decode_plain`` for CPU tensors; there is no other fallback. Float32
only: the batched planning program of a grid model takes K6 where
``can_grid_decode`` admits its shapes in float32 (``program_paths``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from giga_tpu_torch.ops.kernels import _build
from giga_tpu_torch.ops.kernels.decoder import (
    KERNEL_H,
    KERNEL_O,
    SMEM_LIMIT,
    _cat_out,
    _check,
    _device,
    _f32_weight_floats,
    _heads,
    _lattice_start,
    _project,
    _trunk_expect,
    _trunk_plain,
    _trunk_weights,
    prepare_axis_terms,
    split_heads_transposed,
)
from giga_tpu_torch.ops.sampling import _axis_taps, sample_grid_taps_batched

# csrc/grid_decode.cu's design constants that fix the shapes K6 takes: its
# warps a block and floats of a warp's activation or feature buffer (a 4 x 8
# micro-tile: 32 points, 36 floats a channel), and the grid's channels (one
# a lane)
GRID_WARPS, GRID_BUFFER_FLOATS, GRID_C = 16, 32 * 36, 32
INT_MAX = 0x7FFFFFFF


def lattice_taps(coords: torch.Tensor, G: int, padding: float):
    """The lower and upper taps (2, R) int32 and the upper weights (R,)
    float32 of the lattice ``coords`` (R,) on a grid axis of G cells
    (``ops/sampling._axis_taps``): the same on the three axes of a cubic
    grid and lattice."""
    i0, i1, w = _axis_taps(coords, G, padding)
    return torch.stack((i0, i1)).to(torch.int32).contiguous(), w.float().contiguous()


def prepare_grid_inputs(dec: dict, grid: torch.Tensor, coords: torch.Tensor, padding: float,
                        n_blocks: int = 5):
    """K6's inputs, float32 (the taps int32): the grid (B, G, G, G, C); the
    taps (2, R) and upper weights (R,) (``lattice_taps``); px/py/pz (R, F),
    the fc_p bias in px (``prepare_axis_terms``); wc (n_blocks, C, F) and bc
    (n_blocks, F), head e's columns e*H .. e*H + H - 1; the per-head trunk
    and head weights."""
    taps, w = lattice_taps(coords, grid.shape[1], padding)
    px, py, pz = prepare_axis_terms(dec, coords)
    wc = torch.stack([_cat_out(dec[f"fc_c{i}_kernel"]) for i in range(n_blocks)])
    bc = torch.stack([dec[f"fc_c{i}_bias"].reshape(-1) for i in range(n_blocks)])
    return (grid.float().contiguous(), taps, w,
            *(t.float().contiguous() for t in (px, py, pz, wc, bc, *_trunk_weights(dec, n_blocks))))


def grid_decode_plain(grid, taps, w, px, py, pz, wc, bc, w0, b0, w1, b1, wout, bout):
    """Plain PyTorch version of K6 on the same inputs -> (B, heads*O, R^3)
    float32, points flattened as (x*R + y)*R + z: the grid sampled at the
    lattice from the taps (``sample_grid_taps_batched``, the module path's
    operations), then the per-head trunk, block i adding
    (net + f @ wc[i]) + bc[i]."""
    B, R = grid.shape[0], taps.shape[1]
    t = (taps[0].long(), taps[1].long(), w)
    feats = sample_grid_taps_batched(grid.float(), t, t, t)

    def block_input(net, i):
        return (net + _project(feats, wc[i])) + bc[i]

    out = _trunk_plain(_lattice_start(px, py, pz, B), block_input, w0, b0, w1, b1, wout, bout)
    return out.reshape(B, R ** 3, -1).permute(0, 2, 1).contiguous()


def _shared_bytes(n_blocks: int) -> int:
    """grid_decode.cu's ``shared_bytes``: the head's trunk weights, its fc_c
    weights and biases, and every warp's two buffers."""
    return 4 * (_f32_weight_floats(n_blocks) + n_blocks * (GRID_C * KERNEL_H + KERNEL_H)
                + GRID_WARPS * 2 * GRID_BUFFER_FLOATS)


def can_grid_decode(B: int, R: int, G: int, C: int, heads: int, H: int, O: int, n_blocks: int,
                    dtype: torch.dtype = torch.float32) -> bool:
    """Whether K6 takes B scenes of an R^3 lattice on G^3 grids of C
    channels, ``heads`` heads of hidden width H and O outputs, and
    ``n_blocks`` blocks in ``dtype``: exactly the shapes its launch accepts
    (float32; the width and outputs the trunk is built for; C = 32, one
    channel a lane; a block's shared memory, which refuses n_blocks above
    6; 32-bit point and grid offsets). Pure Python: it loads no library, so
    the CPU evaluates it as the card does."""
    return (dtype == torch.float32 and min(B, R, G, heads) >= 1 and n_blocks >= 0
            and H == KERNEL_H and O == KERNEL_O and C == GRID_C
            and R ** 3 <= INT_MAX and G ** 3 * C <= INT_MAX
            and _shared_bytes(n_blocks) <= SMEM_LIMIT)


def grid_decode_batched(grid, taps, w, px, py, pz, wc, bc, w0, b0, w1, b1, wout, bout):
    """K6 -> (B, heads*O, R^3) float32; the CUDA kernel for CUDA tensors,
    every input float32 but the int32 taps. ``launches`` counts every
    launch."""
    args = (grid, taps, w, px, py, pz, wc, bc, w0, b0, w1, b1, wout, bout)
    device = _device("grid_decode_batched", grid)
    if device is None:
        return grid_decode_plain(*args)
    lib = _lib()
    B, G, C = grid.shape[0], grid.shape[1], grid.shape[-1]
    R, F = px.shape
    n_blocks, E, H, _ = w0.shape
    O = wout.shape[-1]
    if (H, O, C) != (lib.grid_decode_hidden(), lib.grid_decode_outputs(),
                     lib.grid_decode_channels()):
        raise ValueError(f"grid_decode_batched: K6 is built for hidden {lib.grid_decode_hidden()}, "
                         f"{lib.grid_decode_outputs()} outputs a head and "
                         f"{lib.grid_decode_channels()} channels, got {H}, {O} and {C}")
    _check("grid_decode_batched", {"taps": (2, R)}, (taps,), device, torch.int32)
    _check("grid_decode_batched",
           {"grid": (B, G, G, G, C), "w": (R,), "px": (R, F), "py": (R, F), "pz": (R, F),
            "wc": (n_blocks, C, F), "bc": (n_blocks, F), **_trunk_expect(n_blocks, E, H, O)},
           args[:1] + args[2:], device)
    out = torch.empty((B, E * O, R ** 3), device=device, dtype=torch.float32)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.grid_decode_f32(*(t.data_ptr() for t in args), out.data_ptr(),
                              B, R, G, C, E, n_blocks, stream)
    _build.check(err, "grid_decode_f32")
    grid_decode_batched.launches += 1
    return out


grid_decode_batched.launches = 0


def decode_affordance_grid_kernel_batched(dec: dict, grid: torch.Tensor, coords: torch.Tensor,
                                          padding: float, n_blocks: int = 5):
    """Batched float32 (qual, rot, width) through K6 from the grids (B, G,
    G, G, C): qual (B,R,R,R), rot (B,4,R^3), width (B,R,R,R), as K2's
    ``decode_affordance_dense_kernel_batched`` gives them."""
    out = grid_decode_batched(*prepare_grid_inputs(dec, grid, coords, padding, n_blocks))
    return split_heads_transposed(out, _heads(dec), coords.shape[0])


def grid_decode_launch_config(B: int, R: int, G: int, C: int, heads: int, n_blocks: int) -> dict:
    """The launch K6 makes for these shapes on the current card: resident
    blocks per SM, SMs, grid (blocks per head x heads), threads and dynamic
    shared bytes per block, warps a block."""
    info = (ctypes.c_int * 7)()
    _build.check(_lib().grid_decode_config(B, R, G, C, heads, n_blocks, info),
                 "grid_decode_config")
    return {"blocks_per_sm": info[0], "sms": info[1], "grid": (info[2], info[3]),
            "threads": info[4], "shared_bytes": info[5], "warps": info[6]}


@functools.cache
def _lib() -> ctypes.CDLL:
    """K6's library, built and loaded on first use, its C signatures bound."""
    lib = _build.load("grid_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grid_decode_f32.argtypes = [p] * 15 + [i] * 6 + [p]
    lib.grid_decode_f32.restype = i
    lib.grid_decode_config.argtypes = [i] * 6 + [ctypes.POINTER(i)]
    lib.grid_decode_config.restype = i
    for name in ("grid_decode_hidden", "grid_decode_outputs", "grid_decode_channels"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    return lib
