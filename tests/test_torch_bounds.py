"""The yardstick chip_smoke.py holds the dense-decode kernels against.

PERF.md reads each kernel's time against its bound: the least time an H100
could take for the work, from ``chip_smoke.trunk_flops`` and
``chip_smoke.bound``. The redesigned trunk kernel's target is half of that
bound, so the numbers PERF.md quotes are pinned here, on the CPU, from the
shapes of the serving path (B=64, R=40, 5 blocks, 3 heads of 32 columns, 4
outputs each). Also checked: the ptxas log parser that chip_smoke.py uses to
print each kernel's registers and spills.
"""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

R, NB, E, H, O = 40, 5, 3, 32, 4


def _dense_decode_bytes(B: int) -> int:
    """Bytes K2 (B scenes) or K3 (B = 1) must move: px/py/pz, the three
    plane projections, the trunk weights read once, the outputs written once."""
    F = E * H
    weights = 2 * NB * E * H * H + 2 * NB * E * H + E * H * O + E * O
    inputs = 3 * R * F + 3 * B * NB * R * R * F + weights
    return 4 * (inputs + B * E * O * R ** 3)


@pytest.mark.parametrize("kernel,B,gflop,ms", [("K2", 64, 267, 3.992), ("K3", 1, 4.18, 0.0624)])
def test_trunk_bound_is_what_perf_md_quotes(kernel, B, gflop, ms):
    flops = chip_smoke.trunk_flops(B * R ** 3, E, H, NB, O)
    assert round(flops / 1e9, 2 if B == 1 else 0) == gflop
    bound_ms, by = chip_smoke.bound(flops, _dense_decode_bytes(B))
    assert by == "operations"
    assert round(bound_ms, 4 if B == 1 else 3) == ms


def test_trunk_flops_count_per_point_and_head():
    """Per point and head: the fc_p sum (2H), per block the two H x H
    products (4H^2) and six H-wide adds, then the head (2HO + O); the
    fused kernels' off-diagonal zeros are no work."""
    per = 2 * H + NB * (4 * H * H + 6 * H) + 2 * H * O + O
    assert chip_smoke.trunk_flops(1, 1, H, NB, O) == per == 21764
    assert chip_smoke.trunk_flops(10, E, H, NB, O) == 10 * E * per
    assert chip_smoke.trunk_flops(1, 1, H, NB, O, extra_adds=1) == per + NB * H


def test_bound_takes_the_slower_of_bytes_and_operations():
    ms, by = chip_smoke.bound(67e9, 3.35e9 * 2)
    assert (round(ms, 6), by) == (2.0, "bytes")
    ms, by = chip_smoke.bound(67e9 * 3, 3.35e9)
    assert (round(ms, 6), by) == (3.0, "operations")


LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119dense_decode_kernelILb0EEEvPKfS2_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119dense_decode_kernelILb0EEEvPKfS2_Pfiiii
    272 bytes stack frame, 268 bytes spill stores, 276 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 272 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119dense_decode_kernelILb1EEEvPKfS2_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119dense_decode_kernelILb1EEEvPKfS2_Pfiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


@pytest.mark.parametrize("point_major,expected", [
    (0, "168 registers, 268/276 bytes spill stores/loads"),
    (1, "128 registers, 0/0 bytes spill stores/loads"),
])
def test_kernel_resources_reads_the_ptxas_log(point_major, expected):
    assert chip_smoke.kernel_resources(LOG, f"dense_decode_kernelILb{point_major}E") == expected


def test_kernel_resources_refuses_an_ambiguous_name():
    with pytest.raises(AssertionError, match="2 kernels"):
        chip_smoke.kernel_resources(LOG, "dense_decode_kernel")
