"""Frozen operation and byte counts: the yardstick of the kernels' roofline
shares and of the programs' share of the card's peak.

Sources, at commit 8d606019c5dd88c01735d48ffa24d97b29762a1c:
  * ``PEAK_*`` and ``bound``: chip_smoke.py (``PEAK_FP32_FLOPS``,
    ``PEAK_BF16_FLOPS``, ``PEAK_BYTES``, ``bound``), unchanged;
  * ``stem_pool_work``: chip_smoke.py, unchanged (K1);
  * ``trunk_flops``: giga_tpu_torch/ops/kernels/decoder.py, unchanged;
  * ``dense_decode_work``: K2's bytes as tests/test_torch_bounds.py's
    ``_dense_decode_bytes`` counts them (chip_smoke.py's ``nbytes`` of K2's
    inputs and outputs), with its operations from ``trunk_flops``;
  * ``unet2d_flops``, ``lattice_sampling_flops``, ``projection_flops`` and
    the two program counts are the benchmark's own: the programs had no
    count of their own.

The peaks are NVIDIA's published ones for one H100 SXM at its full 700 W
(dense rates): 67 TFLOP/s in float32 outside the tensor cores, 989 TFLOP/s
in dense bf16, 3.35 TB/s of HBM. A card set to a lower ``power.limit``
reaches less; the harness prints the limit beside every share.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    """Least time (ms) for the work on the card and what bounds it; ``peak``
    is the operations' rate (PEAK_BF16_FLOPS for a bf16 mode's)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def stem_pool_work(B: int, R: int, C: int, elem: int = 4):
    """(operations, bytes) of K1 on B scenes of R^3 voxels and C channels:
    per voxel and channel 27 multiply-adds, the bias add and 3 pooling adds;
    the TSDF and the weights read once, the three (B, R, R, C) planes written
    once, ``elem`` bytes each (2 in the bf16 mode).
    ``bound(*stem_pool_work(...))`` is K1's bound."""
    N = R ** 3
    return B * N * C * (2 * 27 + 1 + 3), elem * (B * N + 28 * C + 3 * B * R * R * C)


def trunk_flops(points: int, heads: int, H: int, n_blocks: int, O: int,
                extra_adds: int = 0, fold_b1: bool = False) -> int:
    """fp32 operations of the per-head trunk (the fused trunk's off-diagonal
    zeros are no work): per point and head the fc_p sum (2H), per block the
    three plane adds, the fc0 and fc1 products and three bias/residual adds
    (4H^2 + 6H, plus ``extra_adds`` * H), then the head (2HO + O). With
    ``fold_b1`` every block but the last adds no b1 (H fewer each)."""
    per_block = 4 * H * H + (6 + extra_adds) * H
    folded = (n_blocks - 1) * H if fold_b1 else 0
    return points * heads * (2 * H + n_blocks * per_block - folded + 2 * H * O + O)


def dense_decode_work(B: int, R: int, heads: int, H: int, n_blocks: int, O: int,
                      elem: int = 4):
    """(operations, bytes) of K2 on B scenes of an R^3 lattice: the trunk's
    operations; px/py/pz, the three per-block plane projections and the
    trunk weights read once (``elem`` bytes a value, 2 in the bf16 mode),
    the float32 (B, heads*O, R^3) output written once.
    ``bound(*dense_decode_work(...))`` is K2's bound."""
    F = heads * H
    weights = 2 * n_blocks * heads * H * H + 2 * n_blocks * heads * H + heads * H * O + heads * O
    inputs = 3 * R * F + 3 * B * n_blocks * R * R * F + weights
    return (trunk_flops(B * R ** 3, heads, H, n_blocks, O),
            elem * inputs + 4 * B * heads * O * R ** 3)


def unet2d_flops(n: int, H: int, W: int, c: int, depth: int, start: int) -> int:
    """Multiply-add operations (2 each) of the encoder's 2D U-Net on n
    planes of H x W x c: per level two 3x3 convs down, per level up a 2x2
    transpose conv and two 3x3 convs, and the 1x1 output conv."""
    flops, h, w, cin = 0, H, W, c
    widths = [start * 2 ** i for i in range(depth)]
    for i, cout in enumerate(widths):
        flops += 2 * 9 * h * w * (cin * cout + cout * cout)
        cin = cout
        if i < depth - 1:
            h, w = h // 2, w // 2
    for cout in reversed(widths[:-1]):
        flops += 2 * 4 * h * w * cin * cout  # 2x2 stride-2 transpose conv
        h, w = h * 2, w * 2
        flops += 2 * 9 * h * w * (2 * cout * cout + cout * cout)
        cin = cout
    return n * (flops + 2 * h * w * cin * c)


def lattice_sampling_flops(R: int, P: int, C: int, planes: int = 3) -> int:
    """One scene's bilinear sampling of ``planes`` P x P x C planes on an
    R x R query lattice as two dense interpolation matmuls a plane."""
    return planes * 2 * C * R * P * (P + R)


def projection_flops(R: int, C: int, F: int, n_blocks: int, planes: int = 3) -> int:
    """One scene's per-block projections of each plane's R x R sampled rows
    of C features onto the F trunk columns."""
    return planes * n_blocks * R * R * 2 * C * F


def giga_plan_flops(R: int = 40, P: int = 40, C: int = 32, H: int = 32, heads: int = 3,
                    n_blocks: int = 5, O: int = 4, depth: int = 3, start: int = 32) -> int:
    """One scene's operations in the batched planning program: K1's stem and
    pooling, the U-Net on the three planes, the lattice sampling, the
    projections and K2's trunk."""
    return (stem_pool_work(1, P, C)[0] + unet2d_flops(3, P, P, C, depth, start)
            + lattice_sampling_flops(R, P, C) + projection_flops(R, C, heads * H, n_blocks)
            + trunk_flops(R ** 3, heads, H, n_blocks, O))


def giga_geo_mesh_flops(n: int = 129, P: int = 40, C: int = 32, H: int = 32,
                        n_blocks: int = 5, depth: int = 3, start: int = 32) -> int:
    """One mesh's operations in the band program: the encoder (stem,
    pooling, U-Net) and the occupancy decoder (one head of one output) on
    the n^3 lattice."""
    return (stem_pool_work(1, P, C)[0] + unet2d_flops(3, P, P, C, depth, start)
            + lattice_sampling_flops(n, P, C) + projection_flops(n, C, H, n_blocks)
            + trunk_flops(n ** 3, 1, H, n_blocks, 1))
