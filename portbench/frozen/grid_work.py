"""Frozen operation and byte counts of giga_grid's batched planning program:
the yardstick of ``unet3d_roofline``, ``grid_decode_roofline`` and
``gridplan.mfu``. The benchmark's own counts, written from the architecture
(portbench/reference/giga_grid.py), not from the program. The peaks and
``bound`` are portbench/frozen/work.py's.

Operations: a multiply-add is 2. The U-Net's count is its convolutions';
its GroupNorms, ReLUs, pools and resizes are left out of both its
operations and its bytes. Bytes: float32, each tensor counted once where it
is read or written.
"""

from __future__ import annotations


def unet3d_convs(R: int, c: int, f_maps: int, num_levels: int) -> list:
    """(voxels, in channels, out channels, taps) of every conv of the 3D
    U-Net on one R^3 grid of c channels, in order: each encoder level's two
    3^3 convs (the first gives max(out // 2, in)), each decoder level's two
    (in = skip + below), then the 1x1 output conv to c."""
    widths = [f_maps * 2 ** k for k in range(num_levels)]
    convs, cin = [], c
    for i, cout in enumerate(widths):
        n = (R // 2 ** i) ** 3
        mid = max(cout // 2, cin)
        convs += [(n, cin, mid, 27), (n, mid, cout, 27)]
        cin = cout
    for i in range(num_levels - 2, -1, -1):
        n, cout = (R // 2 ** i) ** 3, widths[i]
        convs += [(n, widths[i] + cin, cout, 27), (n, cout, cout, 27)]
        cin = cout
    return convs + [(R ** 3, cin, c, 1)]


def unet3d_flops(R: int = 40, c: int = 32, f_maps: int = 32, num_levels: int = 3) -> int:
    """One scene's U-Net operations: 2 * taps * cin * cout a voxel a conv,
    the output conv's bias left out."""
    return sum(2 * taps * cin * cout * n for n, cin, cout, taps in
               unet3d_convs(R, c, f_maps, num_levels))


def unet3d_bytes(R: int = 40, c: int = 32, f_maps: int = 32, num_levels: int = 3,
                 elem: int = 4) -> int:
    """One scene's U-Net bytes: each conv's input, weights and output, one
    pass, ``elem`` bytes a value."""
    return elem * sum(n * cin + taps * cin * cout + n * cout for n, cin, cout, taps in
                      unet3d_convs(R, c, f_maps, num_levels))


def grid_decode_point_flops(C: int = 32, H: int = 32, heads: int = 3, n_blocks: int = 5,
                            O: int = 4) -> int:
    """Operations at one lattice point: the 8-tap trilinear sample of C
    channels (8 products and 7 sums a channel); then per head fc_p (2 * 3 * H
    and its bias H), per block fc_c (2 * C * H, its bias and the add into the
    residual stream), fc_0 and fc_1 (2 H^2 each, their biases) and the
    residual add, and the head (2 H O and its bias O)."""
    block = 2 * C * H + 2 * H + 4 * H * H + 3 * H
    return 15 * C + heads * (7 * H + n_blocks * block + 2 * H * O + O)


def grid_decode_work(B: int, R: int = 40, G: int = 40, C: int = 32, H: int = 32,
                     heads: int = 3, n_blocks: int = 5, O: int = 4, elem: int = 4):
    """(operations, bytes) of the decode of B scenes' R^3 query lattices from
    their G^3 grids of C channels: ``grid_decode_point_flops`` a point; the
    grids and the heads' weights read once, the (B, heads * O, R^3) outputs
    written once."""
    weights = heads * (3 * H + H + n_blocks * (C * H + H + 2 * H * H + 2 * H) + H * O + O)
    return (B * R ** 3 * grid_decode_point_flops(C, H, heads, n_blocks, O),
            elem * (B * G ** 3 * C + weights + B * heads * O * R ** 3))


def grid_plan_flops(R: int = 40, G: int = 40, C: int = 32, H: int = 32, f_maps: int = 32,
                    num_levels: int = 3, heads: int = 3, n_blocks: int = 5, O: int = 4) -> int:
    """One scene's operations in the batched planning program of giga_grid:
    the stem (a 3^3 conv of 1 -> C at G^3), the U-Net and the decode."""
    return (2 * 27 * C * G ** 3 + unet3d_flops(G, C, f_maps, num_levels)
            + R ** 3 * grid_decode_point_flops(C, H, heads, n_blocks, O))
