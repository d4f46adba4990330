"""The frozen counts reproduce the kernel table's bounds (PERF.md): K2 at
B=64 267 GFLOP and 787 MB, 3.992 ms; K1 at B=64 7.60 GFLOP and 55.7 MB,
0.1135 ms; both bound by operations."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.frozen import work  # noqa: E402


def test_k2_counts_are_the_kernel_tables():
    flops, nbytes = work.dense_decode_work(64, 40, 3, 32, 5, 4)
    assert round(flops / 1e9) == 267
    assert round(nbytes / 1e6) == 787
    assert tuple(round(x, 3) if isinstance(x, float) else x
                 for x in work.bound(flops, nbytes)) == (3.992, "operations")


def test_k1_counts_are_the_kernel_tables():
    flops, nbytes = work.stem_pool_work(64, 40, 32)
    assert round(flops / 1e9, 2) == 7.60
    assert round(nbytes / 1e6, 1) == 55.7
    ms, by = work.bound(flops, nbytes)
    assert (round(ms, 4), by) == (0.1135, "operations")


def test_k3_trunk_count_is_the_kernel_tables():
    """K3 (one scene) from the same trunk count: 4.18 GFLOP."""
    assert round(work.trunk_flops(40 ** 3, 3, 32, 5, 4) / 1e9, 2) == 4.18


@pytest.mark.parametrize("depth,expected", [(1, 2 * 9 * 4 * (2 * 2 + 2 * 2) * 1 + 2 * 4 * 2 * 2),
                                            (2, None)])
def test_unet_count_by_hand(depth, expected):
    """One level: two 3x3 convs and the 1x1 output conv; two levels add the
    pooled level's convs, the 2x2 transpose conv and the merged convs."""
    H = W = 2
    c, start = 2, 2
    got = work.unet2d_flops(1, H, W, c, depth, start)
    if expected is None:
        level0 = 2 * 9 * 4 * (2 * 2 + 2 * 2)
        level1 = 2 * 9 * 1 * (2 * 4 + 4 * 4)
        up = 2 * 4 * 1 * 4 * 2 + 2 * 9 * 4 * (2 * 2 * 2 + 2 * 2)
        expected = level0 + level1 + up + 2 * 4 * 2 * 2
    assert got == expected


def test_program_counts_are_what_perf_md_quotes():
    """5.49 GFLOP a planned scene (K2's trunk 4.18, the U-Net on three
    planes 1.02, the projections 0.15, K1 0.12, the sampling 0.02); 48.1
    GFLOP a 129^3 mesh."""
    assert round(work.unet2d_flops(3, 40, 40, 32, 3, 32) / 1e9, 2) == 1.02
    assert round(work.giga_plan_flops() / 1e9, 2) == 5.49
    assert round(work.giga_geo_mesh_flops() / 1e9, 1) == 48.1
