"""The yardstick chip_smoke.py holds the kernels against.

PERF.md reads each kernel's time against its bound: the least time an H100
could take for the work, from ``chip_smoke.trunk_flops``,
``chip_smoke.stem_pool_work``, ``chip_smoke.dense_decode_feats_work``,
``chip_smoke.dense_decode_hybrid_work``, ``chip_smoke.grid_decode_work`` and
``chip_smoke.bound``. A redesigned kernel's target is half of that bound, so
the numbers PERF.md quotes are pinned here, on the CPU, from the shapes of
the serving path (B=64, R=40, C=32, 5 blocks, 3 heads of 32 columns, 4
outputs each). Also checked: the ptxas log parser that chip_smoke.py uses to
print each kernel's registers and spills, and the reader of each K2
instance's launch configuration that it prints beside them.
"""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

R, NB, E, H, O = 40, 5, 3, 32, 4


def _dense_decode_bytes(B: int, elem: int = 4) -> int:
    """Bytes K2 (B scenes) or K3 (B = 1) must move: px/py/pz, the three
    plane projections, the trunk weights read once (``elem`` bytes a value,
    2 in the bf16 mode), the float32 outputs written once."""
    F = E * H
    weights = 2 * NB * E * H * H + 2 * NB * E * H + E * H * O + E * O
    inputs = 3 * R * F + 3 * B * NB * R * R * F + weights
    return elem * inputs + 4 * B * E * O * R ** 3


@pytest.mark.parametrize("kernel,B,gflop,ms", [("K2", 64, 267, 3.992), ("K3", 1, 4.18, 0.0624)])
def test_trunk_bound_is_what_perf_md_quotes(kernel, B, gflop, ms):
    flops = chip_smoke.trunk_flops(B * R ** 3, E, H, NB, O)
    assert round(flops / 1e9, 2 if B == 1 else 0) == gflop
    bound_ms, by = chip_smoke.bound(flops, _dense_decode_bytes(B))
    assert by == "operations"
    assert round(bound_ms, 4 if B == 1 else 3) == ms


def test_grid_decode_bound_is_what_perf_md_quotes():
    """K6 at B=64 on giga_grid's 40^3 grids of 32 channels: 395 GFLOP (96,492
    operations a lattice point) and 721 MB, bound by operations at 5.90 ms,
    the count the benchmark's ``grid_decode_roofline`` reads against."""
    flops, nbytes = chip_smoke.grid_decode_work(64, R, 40, 32, E, H, NB, O)
    assert flops == 64 * R ** 3 * 96_492
    assert (round(flops / 1e9, 1), round(nbytes / 1e6)) == (395.2, 721)
    bound_ms, by = chip_smoke.bound(flops, nbytes)
    assert (round(bound_ms, 3), by) == (5.899, "operations")


@pytest.mark.parametrize("kernel,work,gflop,mb,ms", [
    ("K1", lambda: chip_smoke.stem_pool_work(64, R, 32), 7.60, 55.7, 0.1135),
    ("K4", lambda: chip_smoke.dense_decode_feats_work(64, R, 32, E, H, NB, O), 278.8, 236, 4.162),
    ("K5", lambda: chip_smoke.dense_decode_hybrid_work(64, R, 32, E, H, NB, O), 273.7, 420, 4.085),
])
def test_stem_and_feats_bounds_are_what_perf_md_quotes(kernel, work, gflop, mb, ms):
    """K1 at B=64, R=40, C=32, and K4 and K5 at B=64 on 32-channel
    features: all bound by operations."""
    flops, nbytes = work()
    assert round(flops / 1e9, 2 if kernel == "K1" else 1) == gflop
    assert round(nbytes / 1e6, 1 if kernel == "K1" else 0) == mb
    bound_ms, by = chip_smoke.bound(flops, nbytes)
    assert (round(bound_ms, 4 if kernel == "K1" else 3), by) == (ms, "operations")


def test_stem_work_counts_per_voxel_and_channel():
    """27 multiply-adds, the bias add and 3 pooling adds per voxel and
    channel; the TSDF, 27 weights and a bias per channel, and three planes."""
    flops, nbytes = chip_smoke.stem_pool_work(1, 2, 1)
    assert flops == 8 * 58
    assert nbytes == 4 * (8 + 28 + 3 * 4)


def test_feats_work_adds_the_projections_once_per_plane_row():
    """K4's operations are the trunk's with the fc_c bias as a fourth plane
    add, plus 3 planes x R^2 rows x blocks of C -> heads*H products."""
    B, C = 2, 8
    flops, nbytes = chip_smoke.dense_decode_feats_work(B, R, C, E, H, NB, O)
    trunk = chip_smoke.trunk_flops(B * R ** 3, E, H, NB, O, extra_adds=1)
    assert flops - trunk == 3 * B * R * R * NB * 2 * C * E * H
    weights = 2 * NB * E * H * H + 2 * NB * E * H + E * H * O + E * O
    assert nbytes == 4 * (3 * R * E * H + 3 * B * R * R * C + 3 * NB * C * E * H + NB * E * H
                          + weights + B * R ** 3 * E * O)


def test_hybrid_work_adds_two_projections_and_reads_pyz():
    """K5's operations are the trunk's (pyz carries the fc_c bias) plus the
    xz and xy planes' projections; it reads two raw feature planes, pyz at
    its storage width and two fc_c weight splits."""
    B, C = 2, 8
    F = E * H
    for elem in (4, 2):
        flops, nbytes = chip_smoke.dense_decode_hybrid_work(B, R, C, E, H, NB, O, pyz_elem=elem)
        trunk = chip_smoke.trunk_flops(B * R ** 3, E, H, NB, O)
        assert flops - trunk == 2 * B * R * R * NB * 2 * C * F
        weights = 2 * NB * F * H + 2 * NB * F + F * O + E * O
        assert nbytes == (4 * (3 * R * F + 2 * B * R * R * C + 2 * NB * C * F + weights
                               + B * R ** 3 * E * O) + elem * B * NB * R * R * F)


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
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116stem_pool_kernelEPKfS1_S1_PfS2_S2_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116stem_pool_kernelEPKfS1_S1_PfS2_S2_iiii
    88 bytes stack frame, 84 bytes spill stores, 56 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 88 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114project_kernelENS_8ProjJobsEiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114project_kernelENS_8ProjJobsEiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 63 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125dense_decode_feats_kernelEPKfS1_S1_S1_S1_S1_S1_S1_S1_S1_S1_S1_S1_Pfiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125dense_decode_feats_kernelEPKfS1_S1_S1_S1_S1_S1_S1_S1_S1_S1_S1_S1_Pfiiiiii
    336 bytes stack frame, 328 bytes spill stores, 332 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 336 bytes cumulative stack size
"""


@pytest.mark.parametrize("point_major,expected", [
    (0, "168 registers, 268/276 bytes spill stores/loads"),
    (1, "128 registers, 0/0 bytes spill stores/loads"),
])
def test_kernel_resources_reads_the_ptxas_log(point_major, expected):
    assert chip_smoke.kernel_resources(LOG, f"dense_decode_kernelILb{point_major}E") == expected


@pytest.mark.parametrize("kernel,expected", [
    ("stem_pool_kernel", "96 registers, 84/56 bytes spill stores/loads"),
    ("project_kernel", "63 registers, 0/0 bytes spill stores/loads"),
    ("dense_decode_feats_kernel", "168 registers, 328/332 bytes spill stores/loads"),
])
def test_kernel_resources_reads_the_stem_and_feats_kernels(kernel, expected):
    """K1 (stem_pool_kernel) and K4's two kernels, by the part of the
    mangled name chip_smoke.py asks for."""
    assert chip_smoke.kernel_resources(LOG, kernel) == expected


def test_kernel_resources_falls_back_to_an_older_name():
    """A parent tree's build names K4's trunk without its template argument:
    the A/B scripts ask for the template instance, then the plain name."""
    names = ("dense_decode_feats_kernelILb1E", "dense_decode_feats_kernel")
    assert (chip_smoke.kernel_resources(LOG, *names)
            == "168 registers, 328/332 bytes spill stores/loads")
    templated = LOG.replace("25dense_decode_feats_kernelE", "25dense_decode_feats_kernelILb1EEv")
    assert chip_smoke.kernel_resources(templated, *names[:1]) == chip_smoke.kernel_resources(
        LOG, *names)
    with pytest.raises(AssertionError, match="0 kernels"):
        chip_smoke.kernel_resources(LOG, "dense_decode_feats_bf16_kernel")


def test_kernel_resources_refuses_an_ambiguous_name():
    with pytest.raises(AssertionError, match="2 kernels"):
        chip_smoke.kernel_resources(LOG, "dense_decode_kernel")


# -- the bf16 modes -------------------------------------------------------------

def test_bf16_bounds_are_what_perf_md_quotes():
    """The bf16 modes' bounds: operations at the H100's 989 TFLOP/s dense
    bf16 rate, bytes read at 2 a value where the mode reads bf16 (K1's TSDF,
    weights and planes; K2's and K3's every input) and K2/K3's float32
    outputs at 4."""
    peak = chip_smoke.PEAK_BF16_FLOPS
    flops, nbytes = chip_smoke.stem_pool_work(64, R, 32, elem=2)
    assert round(nbytes / 1e6, 1) == 27.9
    assert tuple(round(x, 4) if isinstance(x, float) else x
                 for x in chip_smoke.bound(flops, nbytes, peak)) == (0.0083, "bytes")
    for B, ms in ((64, 0.2704), (1, 0.0042)):
        flops = chip_smoke.trunk_flops(B * R ** 3, E, H, NB, O)
        bound_ms, by = chip_smoke.bound(flops, _dense_decode_bytes(B, elem=2), peak)
        assert (round(bound_ms, 4), by) == (ms, "operations")
    assert [round(_dense_decode_bytes(64, e) / 1e6) for e in (2, 4)] == [492, 787]


@pytest.mark.parametrize("kernel,work,gflop,mb,ms", [
    ("K4", lambda: chip_smoke.dense_decode_feats_work(64, R, 32, E, H, NB, O), 278.8, 236, 0.2819),
    ("K5", lambda: chip_smoke.dense_decode_hybrid_work(64, R, 32, E, H, NB, O, pyz_elem=2),
     273.7, 321, 0.2768),
])
def test_feats_bf16_bounds_are_what_perf_md_quotes(kernel, work, gflop, mb, ms):
    """K4's and K5's bf16 modes: the float32 modes' operations at 989
    TFLOP/s; K4 reads float32 features as in its float32 mode, K5 its pyz in
    bf16. Both bound by the tensor cores, not by their bytes."""
    flops, nbytes = work()
    assert (round(flops / 1e9, 1), round(nbytes / 1e6)) == (gflop, mb)
    bound_ms, by = chip_smoke.bound(flops, nbytes, chip_smoke.PEAK_BF16_FLOPS)
    assert (round(bound_ms, 4), by) == (ms, "operations")


LOG_BF16 = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__41ea8798_12_stem_pool_cu_f3fe8c6621stem_pool_bf16_kernelILi3EEvPK13__nv_bfloat16S2_S2_PS0_S3_S3_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__41ea8798_12_stem_pool_cu_f3fe8c6621stem_pool_bf16_kernelILi3EEvPK13__nv_bfloat16S2_S2_PS0_S3_S3_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 112 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__41ea8798_12_stem_pool_cu_f3fe8c6616stem_pool_kernelI13__nv_bfloat16EEvPKT_S4_S4_PS2_S5_S5_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__41ea8798_12_stem_pool_cu_f3fe8c6616stem_pool_kernelI13__nv_bfloat16EEvPKT_S4_S4_PS2_S5_S5_iiii
    88 bytes stack frame, 84 bytes spill stores, 56 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 88 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__41ea8798_12_stem_pool_cu_f3fe8c6616stem_pool_kernelIfEEvPKT_S3_S3_PS1_S4_S4_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__41ea8798_12_stem_pool_cu_f3fe8c6616stem_pool_kernelIfEEvPKT_S3_S3_PS1_S4_S4_iiii
    88 bytes stack frame, 84 bytes spill stores, 56 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 88 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__f57dc4bd_15_dense_decode_cu_a7e05b3624dense_decode_bf16_kernelILb1EEEvPK13__nv_bfloat16S3_S3_S3_S3_S3_S3_S3_S3_S3_S3_S3_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__f57dc4bd_15_dense_decode_cu_a7e05b3624dense_decode_bf16_kernelILb1EEEvPK13__nv_bfloat16S3_S3_S3_S3_S3_S3_S3_S3_S3_S3_S3_Pfiiii
    88 bytes stack frame, 56 bytes spill stores, 88 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 88 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__f57dc4bd_15_dense_decode_cu_a7e05b3619dense_decode_kernelILb0EEEvPKfS2_S2_S2_S2_S2_S2_S2_S2_S2_S2_S2_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__f57dc4bd_15_dense_decode_cu_a7e05b3619dense_decode_kernelILb0EEEvPKfS2_S2_S2_S2_S2_S2_S2_S2_S2_S2_S2_Pfiiii
    272 bytes stack frame, 268 bytes spill stores, 276 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 272 bytes cumulative stack size
"""


@pytest.mark.parametrize("kernel,expected", [
    ("stem_pool_kernelI13__nv_bfloat16E", "96 registers, 84/56 bytes spill stores/loads"),
    (chip_smoke.k1_bf16_kernel(40), "112 registers, 0/0 bytes spill stores/loads"),
    ("stem_pool_kernelIfE", "96 registers, 84/56 bytes spill stores/loads"),
    ("dense_decode_bf16_kernelILb1E", "255 registers, 56/88 bytes spill stores/loads"),
    ("dense_decode_kernelILb0E", "168 registers, 268/276 bytes spill stores/loads"),
])
def test_kernel_resources_tells_the_modes_apart(kernel, expected):
    """The names chip_smoke.py and the A/B scripts ask for pick one mode's
    kernel from a build log that holds several: K1's bf16 kernel, and the
    bf16 instance of its float32 template that older trees build, K2/K3's
    two kernels."""
    assert chip_smoke.kernel_resources(LOG_BF16, kernel) == expected


LOG_FEATS_BF16 = """\
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__03a320ea_21_dense_decode_feats_cu_6a57f16130dense_decode_feats_bf16_kernelILb0EEEv14CUtensorMap_stS1_PKfS3_S3_S3_S3_S3_S3_S3_S3_S3_S3_S3_S3_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN54_GLOBAL__N__03a320ea_21_dense_decode_feats_cu_6a57f16130dense_decode_feats_bf16_kernelILb0EEEv14CUtensorMap_stS1_PKfS3_S3_S3_S3_S3_S3_S3_S3_S3_S3_S3_S3_Pfiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__03a320ea_21_dense_decode_feats_cu_6a57f16130dense_decode_feats_bf16_kernelILb1EEEv14CUtensorMap_stS1_PKfS3_S3_S3_S3_S3_S3_S3_S3_S3_S3_S3_S3_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN54_GLOBAL__N__03a320ea_21_dense_decode_feats_cu_6a57f16130dense_decode_feats_bf16_kernelILb1EEEv14CUtensorMap_stS1_PKfS3_S3_S3_S3_S3_S3_S3_S3_S3_S3_S3_S3_Pfiiii
    48 bytes stack frame, 68 bytes spill stores, 88 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 48 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__03a320ea_21_dense_decode_feats_cu_6a57f16125dense_decode_feats_kernelILb1EEEvPKfS2_S2_S2_S2_S2_S2_S2_S2_S2_S2_S2_S2_Pfiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN54_GLOBAL__N__03a320ea_21_dense_decode_feats_cu_6a57f16125dense_decode_feats_kernelILb1EEEvPKfS2_S2_S2_S2_S2_S2_S2_S2_S2_S2_S2_S2_Pfiiiiii
    232 bytes stack frame, 328 bytes spill stores, 332 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 232 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__03a320ea_21_dense_decode_feats_cu_6a57f16121round_features_kernelENS_6PlanesEP13__nv_bfloat16l' for 'sm_90a'
ptxas info    : Function properties for _ZN54_GLOBAL__N__03a320ea_21_dense_decode_feats_cu_6a57f16121round_features_kernelENS_6PlanesEP13__nv_bfloat16l
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__03a320ea_21_dense_decode_feats_cu_6a57f16114project_kernelENS_8ProjJobsEiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN54_GLOBAL__N__03a320ea_21_dense_decode_feats_cu_6a57f16114project_kernelENS_8ProjJobsEiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 63 registers, used 1 barriers
"""


@pytest.mark.parametrize("hybrid,expected", [
    (False, "128 registers, 68/88 bytes spill stores/loads"),
    (True, "128 registers, 0/0 bytes spill stores/loads"),
])
def test_kernel_resources_reads_the_feats_bf16_kernels(hybrid, expected):
    """K4's and K5's bf16 kernel (dense_decode_feats_bf16_kernel<kK4>, TMA
    maps as its first parameters) by the names chip_smoke.py's phase 18 and
    ab_dense_decode_feats.py --bf16 ask for, apart from each other and from
    the float32 trunk; an older tree's bf16 trunk by its own names."""
    from giga_tpu_torch.scripts.ab_dense_decode_feats import bf16_kernel_names

    names = bf16_kernel_names(hybrid)
    assert names[0] == f"dense_decode_feats_bf16_kernelILb{int(not hybrid)}E"
    assert chip_smoke.kernel_resources(LOG_FEATS_BF16, *names) == expected
    older = LOG_FEATS_BF16.replace("30dense_decode_feats_bf16_kernelILb1EEEv14CUtensorMap_stS1_",
                                   "30dense_decode_feats_bf16_kernelIfLb1EEEvPKfS2_")
    older = older.replace("30dense_decode_feats_bf16_kernelILb0EEEv14CUtensorMap_stS1_",
                          "30dense_decode_feats_bf16_kernelI13__nv_bfloat16Lb0EEEvPKfS3_")
    assert chip_smoke.kernel_resources(older, *names) == expected
    with pytest.raises(AssertionError, match="0 kernels"):
        chip_smoke.kernel_resources(older, names[0])


@pytest.mark.parametrize("kernel,expected", [
    ("round_features_kernel", "16 registers, 0/0 bytes spill stores/loads"),
    ("project_kernel", "63 registers, 0/0 bytes spill stores/loads"),
    ("dense_decode_feats_kernelILb1E", "168 registers, 328/332 bytes spill stores/loads"),
])
def test_kernel_resources_reads_the_feats_prologue_and_float32_kernels(kernel, expected):
    """The bf16 mode's rounding prologue, and the float32 mode's projection
    kernel (no template since the bf16 mode left it) and trunk, from the
    same build log."""
    assert chip_smoke.kernel_resources(LOG_FEATS_BF16, kernel) == expected


# -- K2's options ---------------------------------------------------------------

def test_fold_skips_the_folded_bias_adds():
    """fold_b1 drops one H-wide add for every block but the last, per point
    and head; chip_smoke reckons with the package's trunk_flops."""
    from giga_tpu_torch.ops.kernels.decoder import trunk_flops

    assert chip_smoke.trunk_flops is trunk_flops
    assert trunk_flops(1, 1, H, NB, O, fold_b1=True) == 21764 - (NB - 1) * H
    assert trunk_flops(3, E, H, 1, O, fold_b1=True) == trunk_flops(3, E, H, 1, O)


@pytest.mark.parametrize("elem,peak,gflop,ms", [
    (4, chip_smoke.PEAK_FP32_FLOPS, 265.9, 3.968),
    (2, chip_smoke.PEAK_BF16_FLOPS, 265.9, 0.2688),
])
def test_fold_bounds_are_what_perf_md_quotes(elem, peak, gflop, ms):
    """K2 with fold_b1 at B=64: the default mode's bytes, 0.6 % fewer
    operations; resident_bf16 does the default bf16 mode's operations (its
    roundings are conversions, not operations at the tensor cores' rate)."""
    flops = chip_smoke.trunk_flops(64 * R ** 3, E, H, NB, O, fold_b1=True)
    assert round(flops / 1e9, 1) == gflop
    bound_ms, by = chip_smoke.bound(flops, _dense_decode_bytes(64, elem), peak)
    assert (round(bound_ms, 4 if elem == 2 else 3), by) == (ms, "operations")


K2_INSTANCES = [  # (bf16, point_major, fold_b1, resident_bf16): every kernel of dense_decode.cu
    (False, False, False, False), (False, True, False, False), (False, False, True, False),
    (True, False, False, False), (True, True, False, False), (True, False, True, False),
    (True, False, False, True), (True, False, True, True)]


@pytest.mark.parametrize("instance,name", [
    (K2_INSTANCES[0], "dense_decode_kernelILb0ELb0E"),
    (K2_INSTANCES[1], "dense_decode_kernelILb1ELb0E"),
    (K2_INSTANCES[2], "dense_decode_kernelILb0ELb1E"),
    (K2_INSTANCES[3], "dense_decode_bf16_tma_kernelILb0ELb0ELb0E"),
    (K2_INSTANCES[7], "dense_decode_bf16_tma_kernelILb0ELb1ELb1E"),
])
def test_k2_kernel_names_one_instance(instance, name):
    """chip_smoke.k2_kernel names one template instance of dense_decode.cu's
    kernels, which kernel_resources then finds alone in a log of all eight
    (instance i given i registers here)."""
    assert chip_smoke.k2_kernel(*instance) == name
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{k}EEvPKfi' for 'sm_90a'\n"
        f"ptxas info    : Used {i} registers\n"
        for i, k in enumerate(chip_smoke.k2_kernel(*inst) for inst in K2_INSTANCES))
    assert chip_smoke.kernel_resources(log, name).startswith(
        f"{K2_INSTANCES.index(instance)} registers")


@pytest.mark.parametrize("instance", K2_INSTANCES)
def test_k2_launch_config_reads_its_instance(monkeypatch, instance):
    """decoder.dense_decode_launch_config asks dense_decode.cu for one
    instance's launch (the entry by dtype; mode point_major + 2 fold_b1 +
    4 resident_bf16, as its config entries number them) and reads all
    eleven ints the entry fills: here the mode, then 1 to 10."""
    import torch

    from giga_tpu_torch.ops.kernels import decoder as dk

    calls = []

    def entry(name):
        def fill(mode, B, R_, heads, nb, info):
            calls.append((name, mode, B, R_, heads, nb))
            for i in range(11):
                info[i] = mode if i == 0 else i
            return 0
        return staticmethod(fill)

    lib = type("Lib", (), {n: entry(n) for n in ("dense_decode_config",
                                                 "dense_decode_bf16_config")})
    monkeypatch.setattr(dk, "_lib", lambda: lib)
    bf16, point_major, fold, resident = instance
    lc = dk.dense_decode_launch_config(64, R, E, NB, point_major,
                                       torch.bfloat16 if bf16 else torch.float32, fold, resident)
    mode = int(point_major) + 2 * int(fold) + 4 * int(resident)
    assert calls == [("dense_decode_bf16_config" if bf16 else "dense_decode_config", mode,
                      64, R, E, NB)]
    assert lc == {"blocks_per_sm": mode, "sms": 1, "grid": (2, 3), "threads": 4,
                  "shared_bytes": 5, "warps": 6, "stages": 7, "slab_stages": 8, "slab": (9, 10)}
