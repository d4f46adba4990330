"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from giga_tpu_torch.inference.planner import (
    GIGAPlanner,
    State,
    build_batched_giga_planner_fn,
    build_giga_planner_fn,
)
from giga_tpu_torch.inference.serving import PlannerService
from giga_tpu_torch.core.config import PlannerConfig, giga
from giga_tpu_torch.models.conv_onet import GIGANet
from giga_tpu_torch.ops.kernels import decoder as dk
from giga_tpu_torch.ops.kernels.decoder import dense_decode_batched, dense_decode_plain
from giga_tpu_torch.ops.kernels.stem import stem_pool_batched, stem_pool_plain

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TOL_STEM = 2e-5
TOL_KERNEL = 1e-5
BF16 = torch.bfloat16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _u(rng, *shape, s=0.5):
    return torch.from_numpy(rng.uniform(-s, s, shape).astype(np.float32))


def _stem_args(rng, C, shape, device):
    w = _u(rng, C, 1, 3, 3, 3).to(device)
    b = _u(rng, C, s=0.2).to(device)
    t = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(device)
    return w, b, t


# R = 7 and 13 leave a ragged z-run of K1's 4-z micro-tile (and R = 7 a
# block of 14 threads); R = 40 is the serving lattice.
@pytest.mark.cuda
@pytest.mark.parametrize("B,R,C", [(2, 16, 8)]
                         + [(B, R, C) for R in (7, 13, 40) for B in (1, 3) for C in (8, 32)])
def test_stem_kernel_matches_plain(cuda_device, B, R, C):
    rng = np.random.RandomState(0)
    w, b, t = _stem_args(rng, C, (B, R, R, R), cuda_device)
    n = stem_pool_batched.launches
    got = stem_pool_batched(w, b, t)
    ref = stem_pool_plain(w, b, t)
    assert stem_pool_batched.launches == n + 1
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], atol=TOL_STEM, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 5, 11, 6), (1, 9, 3, 40)])
def test_stem_kernel_takes_a_box_that_is_not_a_cube(cuda_device, shape):
    """X, Y and Z apart, each pooled over its own length; Z = 6 reads the
    TSDF's rows with scalar loads."""
    rng = np.random.RandomState(9)
    w, b, t = _stem_args(rng, 16, shape, cuda_device)
    got = stem_pool_batched(w, b, t)
    ref = stem_pool_plain(w, b, t)
    for k in ref:
        assert got[k].shape == ref[k].shape
        torch.testing.assert_close(got[k], ref[k], atol=TOL_STEM, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [13, 40])
def test_stem_kernel_scenes_are_independent(cuda_device, R):
    """Three scenes in one launch give the bytes of three one-scene launches
    (at R = 13 the later scenes start off a 16-byte boundary)."""
    rng = np.random.RandomState(10)
    w, b, t = _stem_args(rng, 32, (3, R, R, R), cuda_device)
    together = stem_pool_batched(w, b, t)
    for i in range(3):
        one = stem_pool_batched(w, b, t[i:i + 1].contiguous())
        for k in together:
            assert torch.equal(one[k][0], together[k][i])


# Lattices whose R^3 is no multiple of the trunk kernel's 64-point warp tile
# (R = 7, 13: a ragged last tile) and the serving R = 40; one and several
# scenes, one and five blocks.
RAGGED = [(B, R, nb) for R in (7, 13, 40) for B in (1, 3) for nb in (1, 5)]


def _decode_args(rng, B, R, nb, E=3, H=32, O=4, s=0.5):
    """K2's inputs; ``s`` bounds the trunk weights."""
    F = E * H
    return [_u(rng, R, F), _u(rng, R, F), _u(rng, R, F),
            _u(rng, B, nb, R, R, F), _u(rng, B, nb, R, R, F), _u(rng, B, nb, R, R, F),
            *_trunk(rng, nb, E, H, O, s)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,nb", [(2, 12, 5), (1, 7, 2)] + RAGGED)
def test_decode_kernel_matches_plain(cuda_device, B, R, nb):
    """K2 against its plain version."""
    rng = np.random.RandomState(1)
    args = [a.to(cuda_device) for a in _decode_args(rng, B, R, nb)]
    n = dense_decode_batched.launches
    got = dense_decode_batched(*args)
    ref = dense_decode_plain(*args)
    assert dense_decode_batched.launches == n + 1
    torch.testing.assert_close(got, ref, atol=TOL_KERNEL, rtol=TOL_KERNEL)


@pytest.mark.cuda
@pytest.mark.parametrize("R,nb", [(13, 5), (40, 2)])
def test_decode_kernel_scenes_are_independent(cuda_device, R, nb):
    """K2's persistent blocks walk (scene, tile) pairs of all scenes: three
    scenes in one launch give the bytes of three one-scene launches, and
    K3 gives K2's bytes for one scene in its point-major layout."""
    rng = np.random.RandomState(8)
    args = [a.to(cuda_device) for a in _decode_args(rng, 3, R, nb)]
    together = dense_decode_batched(*args)
    for b in range(3):
        one = args[:3] + [p[b:b + 1].contiguous() for p in args[3:6]] + args[6:]
        assert torch.equal(dense_decode_batched(*one)[0], together[b])
        single = args[:3] + [p[b].contiguous() for p in args[3:6]] + args[6:]
        assert torch.equal(dk.fused_dense_decode(*single).reshape(R ** 3, -1).T, together[b])


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    rng = np.random.RandomState(2)
    w = _u(rng, 6, 1, 3, 3, 3).to(cuda_device)  # 6 channels: not a multiple of 4
    t = torch.zeros(1, 8, 8, 8, device=cuda_device)
    with pytest.raises(ValueError):
        stem_pool_batched(w, torch.zeros(6, device=cuda_device), t)
    with pytest.raises(ValueError):
        stem_pool_batched(w[:4], torch.zeros(4, device=cuda_device), t.double())
    with pytest.raises(ValueError, match="does not take"):  # 4 channels: K1 takes 8 a block
        stem_pool_batched(w[:4].contiguous(), torch.zeros(4, device=cuda_device), t)
    w8 = _u(rng, 8, 1, 3, 3, 3).to(cuda_device)
    with pytest.raises(ValueError, match="does not take"):  # 48 * 12 = 576 threads > 512
        stem_pool_batched(w8, torch.zeros(8, device=cuda_device),
                          torch.zeros(1, 4, 48, 48, device=cuda_device))


def _random_giga(device):
    """The giga preset with seeded random weights, its planner config and
    two random 40^3 grids, on ``device``."""
    torch.manual_seed(0)
    cfg = giga()
    net = GIGANet(cfg)
    with torch.no_grad():
        for p in net.parameters():
            p.uniform_(-0.1, 0.1)
    pcfg = PlannerConfig(low_th=0.05, qual_th=0.5, force_detection=True,
                         min_width=-10.0, max_width=10.0)
    grids = torch.from_numpy(np.random.RandomState(3).rand(2, 40, 40, 40)
                             .astype(np.float32)).to(device)
    return net.to(device).eval(), cfg, pcfg, grids


@pytest.mark.cuda
def test_program_with_kernels_matches_module_path(cuda_device):
    """The batched program through K1 and K2 gives the candidates of the
    module path, on seeded random weights (small B)."""
    net, cfg, pcfg, grids = _random_giga(cuda_device)
    kern = build_batched_giga_planner_fn(net, cfg, pcfg, 0.3, use_kernels=True)(grids, grids)
    plain = build_batched_giga_planner_fn(net, cfg, pcfg, 0.3, use_kernels=False)(grids, grids)
    assert torch.equal(kern.count, plain.count)
    for i, n in enumerate(kern.count.tolist()):
        torch.testing.assert_close(kern.scores[i, :n], plain.scores[i, :n], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_program_queues_without_waiting_for_the_card(cuda_device):
    """Once warm, the batched program makes no synchronizing CUDA call: it
    only queues work, so PlannerService can build one batch's Grasp objects
    while the card runs the next batch."""
    net, cfg, pcfg, grids = _random_giga(cuda_device)
    fn = build_batched_giga_planner_fn(net, cfg, pcfg, 0.3, use_kernels=True)
    fn(grids, grids)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cands = fn(grids, grids)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(cands.count.sum()) > 0


@pytest.mark.cuda
def test_service_pipelined_batches_match_plan_batch(cuda_device):
    """Batches in flight together on the card (lag-1: batch k+1 queued
    before batch k's fetch is awaited) resolve with plan_batch's grasps."""
    net, cfg, pcfg, grids = _random_giga(cuda_device)
    planner = GIGAPlanner(net=net, model_cfg=cfg, device=cuda_device)
    planner.planner_cfg = dataclasses.replace(pcfg, best=True)
    scenes = grids.cpu().numpy()
    ref = planner.plan_batch(scenes)
    with PlannerService(planner, batch_size=2, max_wait_ms=5.0) as svc:
        served = [f.result(timeout=120) for f in [svc.submit(scenes[i % 2]) for i in range(7)]]
        assert svc.stats()["batches"] >= 4
    for i, (grasps, scores) in enumerate(served):
        ref_grasps, ref_scores = ref[i % 2]
        assert len(grasps) == len(ref_grasps) > 0
        for a, b in zip(grasps, ref_grasps):
            np.testing.assert_array_equal(a.pose.translation, b.pose.translation)
            np.testing.assert_allclose(a.width, b.width, atol=1e-6)
        np.testing.assert_allclose(scores, ref_scores, atol=1e-6)


def _trunk(rng, nb, E=3, H=32, O=4, s=0.5):
    return [_u(rng, nb, E, H, H, s=s), _u(rng, nb, E, H, s=s), _u(rng, nb, E, H, H, s=s),
            _u(rng, nb, E, H, s=s), _u(rng, E, H, O, s=s), _u(rng, E, O, s=s)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,nb", [(40, 5), (7, 2), (7, 1), (7, 5), (13, 1), (13, 5), (40, 1)])
def test_single_scene_kernel_matches_plain(cuda_device, R, nb):
    """K3, [x, y, z, o] output; R = 7 and 13 leave a ragged last tile."""
    rng = np.random.RandomState(4)
    F = 96
    args = [_u(rng, R, F), _u(rng, R, F), _u(rng, R, F), _u(rng, nb, R, R, F),
            _u(rng, nb, R, R, F), _u(rng, nb, R, R, F), *_trunk(rng, nb)]
    args = [a.to(cuda_device) for a in args]
    n = dk.fused_dense_decode.launches
    got = dk.fused_dense_decode(*args)
    ref = dk.fused_dense_decode_plain(*args)
    assert dk.fused_dense_decode.launches == n + 1 and tuple(got.shape) == (R, R, R, 12)
    torch.testing.assert_close(got, ref, atol=TOL_KERNEL, rtol=TOL_KERNEL)


def _feats_args(rng, B, R, C, nb, F=96, s=0.5):
    """K4's inputs; ``s`` bounds the fc_c and trunk weights."""
    return [_u(rng, R, F), _u(rng, R, F), _u(rng, R, F), _u(rng, B, R, R, C),
            _u(rng, B, R, R, C), _u(rng, B, R, R, C), _u(rng, nb, C, F, s=s),
            _u(rng, nb, C, F, s=s), _u(rng, nb, C, F, s=s), _u(rng, nb, F), *_trunk(rng, nb, s=s)]


def _hybrid_args(rng, B, R, C, nb, F=96, s=0.5):
    """K5's inputs (pyz float32); ``s`` bounds the fc_c and trunk weights."""
    return [_u(rng, R, F), _u(rng, R, F), _u(rng, R, F), _u(rng, B, R, R, C),
            _u(rng, B, R, R, C), _u(rng, B, nb, R, R, F), _u(rng, nb, C, F, s=s),
            _u(rng, nb, C, F, s=s), *_trunk(rng, nb, s=s)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,C,nb,x_chunk", [(2, 40, 32, 5, 8), (1, 17, 8, 2, 5),
                                              (2, 7, 4, 1, 40)]
                         + [(2, 17, 32, 5, c) for c in (1, 5, 8, 40)])
def test_feats_kernel_matches_plain(cuda_device, B, R, C, nb, x_chunk):
    """K4, equal bit for bit at every x_chunk to x_chunk 1. R = 17 (4,913
    points a scene) ends on a ragged 64-point tile, and x_chunk 5 or 8 on
    a ragged last pass; R = 7 is one pass smaller than a tile."""
    rng = np.random.RandomState(5)
    args = [a.to(cuda_device) for a in _feats_args(rng, B, R, C, nb)]
    n = dk.dense_decode_feats_batched.launches
    got = dk.dense_decode_feats_batched(*args, x_chunk=x_chunk)
    ref = dk.dense_decode_feats_plain(*args)
    assert dk.dense_decode_feats_batched.launches == n + 1
    torch.testing.assert_close(got, ref, atol=TOL_KERNEL, rtol=TOL_KERNEL)
    assert torch.equal(dk.dense_decode_feats_batched(*args, x_chunk=1), got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,C,nb", [(2, 40, 32, 5), (1, 7, 8, 2)]
                         + [(B, R, 32, 5) for R in (17, 40) for B in (1, 3)])
def test_hybrid_kernel_matches_plain(cuda_device, B, R, C, nb):
    """K5 (its projections, then the tiled trunk), equal to its plain
    version bit for bit at 32 channels, as its order (each row a dot over c
    ascending from zero, ((net + xz) + xy) + pyz) is the plain version's
    there; R = 7 (343 points a scene) and R = 17 (4,913) end on ragged
    64-point tiles."""
    rng = np.random.RandomState(6)
    args = [a.to(cuda_device) for a in _hybrid_args(rng, B, R, C, nb)]
    n = dk.dense_decode_hybrid_batched.launches
    got = dk.dense_decode_hybrid_batched(*args)
    ref = dk.dense_decode_hybrid_plain(*args)
    assert dk.dense_decode_hybrid_batched.launches == n + 1
    torch.testing.assert_close(got, ref, atol=TOL_KERNEL, rtol=TOL_KERNEL)
    if C == 32:
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_decode_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    rng = np.random.RandomState(7)
    args = [a.to(cuda_device) for a in _feats_args(rng, 1, 8, 4, 2)]
    with pytest.raises(ValueError, match="shape"):  # fyz of another scene count
        dk.dense_decode_feats_batched(*args[:5], args[5][:0], *args[6:])
    with pytest.raises(ValueError, match="float32"):
        dk.dense_decode_feats_batched(*args[:3], args[3].double(), *args[4:])
    with pytest.raises(ValueError, match="contiguous"):
        dk.dense_decode_feats_batched(*args[:3], args[3].transpose(1, 2), *args[4:])
    with pytest.raises(ValueError, match="x_chunk"):
        dk.dense_decode_feats_batched(*args, x_chunk=0)
    with pytest.raises(ValueError, match="hidden"):  # 16 wide heads: the kernels take 32
        dk.dense_decode_feats_batched(*args[:10], *_trunk(rng, 2, H=16))
    misaligned = torch.empty(args[3].numel() + 1, device=cuda_device)[1:].view(args[3].shape)
    hybrid = args[:5] + [_u(rng, 1, 2, 8, 8, 96).to(cuda_device)] + args[6:8] + args[10:]
    with pytest.raises(ValueError, match="aligned"):
        dk.dense_decode_hybrid_batched(*hybrid[:3], misaligned, *hybrid[4:])
    single = [_u(rng, 8, 96), _u(rng, 8, 96), _u(rng, 8, 96), *[_u(rng, 2, 8, 8, 96)] * 3,
              *_trunk(rng, 2)]
    single = [a.to(cuda_device) for a in single]
    with pytest.raises(ValueError, match="shape"):  # a batched pxz
        dk.fused_dense_decode(*single[:3], single[3][None], *single[4:])
    with pytest.raises(ValueError, match="on cuda"):  # px left on the CPU
        dk.fused_dense_decode(single[0].cpu(), *single[1:])


@pytest.mark.cuda
def test_single_scene_program_queues_without_waiting_for_the_card(cuda_device):
    """Once warm, the single-scene program (K3 on the card) makes no
    synchronizing CUDA call, and equals the module-path program."""
    net, cfg, pcfg, grids = _random_giga(cuda_device)
    fn = build_giga_planner_fn(net, cfg, pcfg, 0.3, use_kernels=True)
    fn(grids[0], grids[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cands = fn(grids[0], grids[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    plain = build_giga_planner_fn(net, cfg, pcfg, 0.3, use_kernels=False)(grids[0], grids[0])
    n = int(cands.count)
    assert n == int(plain.count) > 0
    torch.testing.assert_close(cands.scores[:n], plain.scores[:n], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_plan_stream_fetch_does_not_wait_for_the_next_scene(cuda_device):
    """plan_stream queues scene i's program before it waits for scene i-1's
    candidates, and that wait ends before scene i's work does: each program
    here is followed by a ~0.2 s spin on the card, and scene i-1's
    candidates arrive while scene i's spin still runs."""
    net, cfg, pcfg, grids = _random_giga(cuda_device)
    planner = GIGAPlanner(net=net, model_cfg=cfg, device=cuda_device)
    planner.planner_cfg = dataclasses.replace(pcfg, best=True)
    scenes = grids.cpu().numpy()
    ref = [planner(State(tsdf=s))[:2] for s in scenes]
    fn = planner._ensure_fn()
    done = []  # per scene: the event after its spin

    def slow(g, p):
        cands = fn(g, p)
        torch.cuda._sleep(int(2e8))
        done.append(torch.cuda.Event())
        done[-1].record()
        return cands

    planner._fn = slow
    seen = []
    to_grasps = planner._to_grasps

    def record(cands):
        seen.append((len(done), [e.query() for e in done]))
        return to_grasps(cands)

    planner._to_grasps = record
    got = planner.plan_stream(list(scenes) + list(scenes))
    # the first scene is collected once the second is queued, while the
    # second's spin still runs
    queued, finished = seen[0]
    assert queued == 2 and finished == [True, False]
    for (g1, s1), (g2, s2) in zip(got, ref + ref):
        assert len(g1) == len(g2)
        np.testing.assert_allclose(s1, s2, atol=1e-6)


# -- the bf16 modes (check_bf16: at least 99.9 % of outputs within 1e-5 of the
# plain version, all within 2e-2 * (1 + |plain|)) -----------------------------

# Trunk weights for the bf16 modes at nn.Linear's initial scale, 1/sqrt(H):
# at +-0.5, five blocks grow the outputs large out of terms that cancel, and
# a float32 sum taken in another order moves some outputs past
# 2e-2 * (1 + |plain|) in any mode that rounds activations to bf16, the
# plain version summed in float64 included.
BF16_W = 32 ** -0.5

# K1's bf16 kernel runs m16 tiles of 16 z: R = 7 and 13 leave one ragged tile a
# row, R = 24 a whole one and a ragged one (Z no multiple of 16), R = 40 two
# whole ones and a ragged one; R = 7 and 13 also read the TSDF's rows with
# scalar loads. B = 1 and 5, and C = 8, 16 and 32 (one, two and four blocks a
# scene). check_bf16 lets 0.1 % of the outputs lie a bf16 step from the plain
# version, whose float32 sums run in another order; each case's planes hold
# at least 1,000 values (B R^2 C), so that a case admits one such step, as
# every case here did before this kernel (R = 7 at B = 1 runs at C = 32).
BF16_STEM = [(2, 16, 8), (1, 7, 32), (3, 13, 8), (2, 40, 32)] + [
    (B, R, C) for R in (7, 13, 24) for B in (1, 5) for C in (8, 16, 32)
    if B * R * R * C >= 1000 and (B, R, C) != (1, 7, 32)] + [(5, 40, 16), (1, 40, 8)]
# the cases whose planes hold fewer than 1,000 values, where one output a
# bf16 step from the plain version is more than 0.1 %: every output within
# one bf16 step of its own exponent (chip_smoke.check_bf16_steps)
BF16_STEM_SMALL = [(1, 7, 8), (1, 7, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,C", BF16_STEM)
def test_stem_bf16_kernel_matches_plain(cuda_device, B, R, C):
    """K1's bf16 entry point: bf16 TSDF, weights and bias in, bf16 planes out."""
    rng = np.random.RandomState(10)
    w, b, t = (a.to(BF16) for a in _stem_args(rng, C, (B, R, R, R), cuda_device))
    n = stem_pool_batched.launches
    got = stem_pool_batched(w, b, t)
    ref = stem_pool_plain(w, b, t)
    assert stem_pool_batched.launches == n + 1
    for k in ref:
        assert got[k].dtype == BF16 and got[k].shape == ref[k].shape
        chip_smoke.check_bf16(got[k], ref[k], f"K1 bf16 {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,C", BF16_STEM_SMALL)
def test_stem_bf16_kernel_small_planes_within_one_step(cuda_device, B, R, C):
    """K1's bf16 mode where a plane holds fewer than 1,000 values: every
    output within one bf16 step of the plain version."""
    rng = np.random.RandomState(10)
    w, b, t = (a.to(BF16) for a in _stem_args(rng, C, (B, R, R, R), cuda_device))
    got = stem_pool_batched(w, b, t)
    ref = stem_pool_plain(w, b, t)
    for k in ref:
        assert got[k].dtype == BF16 and got[k].shape == ref[k].shape
        chip_smoke.check_bf16_steps(got[k], ref[k], f"K1 bf16 {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 5, 11, 6), (1, 9, 3, 40), (2, 6, 20, 17)])
def test_stem_bf16_kernel_takes_a_box_that_is_not_a_cube(cuda_device, shape):
    """X, Y and Z apart in the bf16 mode, each pooled over its own length;
    Z = 6 and 17 read the TSDF's rows with scalar loads."""
    rng = np.random.RandomState(15)
    w, b, t = (a.to(BF16) for a in _stem_args(rng, 16, shape, cuda_device))
    got = stem_pool_batched(w, b, t)
    ref = stem_pool_plain(w, b, t)
    for k in ref:
        assert got[k].shape == ref[k].shape
        chip_smoke.check_bf16(got[k], ref[k], f"K1 bf16 {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("R", [13, 24, 40])
def test_stem_bf16_kernel_scenes_are_independent(cuda_device, R):
    """The bf16 mode's three scenes in one launch give the bytes of three
    one-scene launches (at R = 13 the later scenes start off an 8-byte
    boundary, and every row is read with scalar loads)."""
    rng = np.random.RandomState(10)
    w, b, t = (a.to(BF16) for a in _stem_args(rng, 32, (3, R, R, R), cuda_device))
    together = stem_pool_batched(w, b, t)
    for i in range(3):
        one = stem_pool_batched(w, b, t[i:i + 1].contiguous())
        for k in together:
            assert torch.equal(one[k][0], together[k][i])


@pytest.mark.cuda
def test_stem_launch_config_reports_each_mode_its_own_kernel(cuda_device):
    """K1's bf16 mode has a launch of its own (10 tap and 6 pooling warps a
    block, pair slabs) at the serving shape; both modes take one block per
    scene and 8 channels; the bf16 kernel refuses a lattice past its 12
    tiles a warp (R = 48: 5 rows of 3) that the float32 kernel refuses too,
    and a Z past three tiles a row."""
    from giga_tpu_torch.ops.kernels.stem import stem_pool_launch_config

    f32 = stem_pool_launch_config(64, 40, 40, 40, 32)
    bf = stem_pool_launch_config(64, 40, 40, 40, 32, BF16)
    assert f32 == {"blocks": 256, "threads": 608, "shared_bytes": 144384,
                   "channels_per_block": 8}
    assert bf["blocks"] == 256 and bf["channels_per_block"] == 8
    assert bf["threads"] == 32 * (10 + 6) and bf["shared_bytes"] != f32["shared_bytes"]
    assert stem_pool_launch_config(1, 7, 7, 7, 8, BF16)["threads"] == 512
    for dtype in (torch.float32, BF16):
        with pytest.raises(ValueError, match="does not take"):
            stem_pool_launch_config(1, 48, 48, 48, 32, dtype)
    with pytest.raises(ValueError, match="does not take"):
        stem_pool_launch_config(1, 4, 4, 49, 8, BF16)
    with pytest.raises(ValueError, match="dtype"):
        stem_pool_launch_config(1, 8, 8, 8, 8, torch.float16)


# The bf16 kernel's tiles are 32 consecutive (y, z) points of a slab, a
# block's tiles a contiguous run of them: R = 7, 13 and 40 end each slab on a
# ragged tile (R^2 = 49, 169, 1600; 7 and 13 make tiles that span several
# y-lines); B = 5 at R = 40 leaves the blocks' runs and the warps' last
# tiles uneven, and B = 1 at R = 7 gives a block more warps than tiles. The
# slab's shape follows R and NB (dense_decode.cu, bf16_shape): whole x-planes
# at R = 40 and NB <= 5; half planes at NB = 10 (20 y-lines) and at R = 96
# (48); z-chunks of 32 columns at R = 96, NB = 10 and at R = 200, of 96 past
# a TMA box's 256 rows at R = 264. One slab stage (NB >= 15) is DEEP's.
BF16_TILING = [(5, 40, 5), (2, 40, 3), (64, 13, 5), (3, 40, 10), (2, 96, 5), (1, 96, 10),
               (1, 200, 5), (1, 264, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,nb", [(2, 12, 5), (1, 7, 2)] + RAGGED + BF16_TILING)
def test_decode_bf16_kernel_matches_plain(cuda_device, B, R, nb):
    """K2's bf16 entry point (tensor cores) against its plain version."""
    rng = np.random.RandomState(11)
    args = [a.to(cuda_device).to(BF16) for a in _decode_args(rng, B, R, nb, s=BF16_W)]
    n = dense_decode_batched.launches
    got = dense_decode_batched(*args)
    ref = dense_decode_plain(*args)
    assert dense_decode_batched.launches == n + 1 and got.dtype == torch.float32
    chip_smoke.check_bf16(got, ref, "K2 bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("R,nb", [(40, 5), (7, 1), (13, 5), (7, 5), (13, 1), (40, 1), (12, 2),
                                  (96, 5), (200, 2)])
def test_single_scene_bf16_kernel_matches_plain(cuda_device, R, nb):
    """K3's bf16 entry point, [x, y, z, o] output, ragged last tiles."""
    rng = np.random.RandomState(12)
    F = 96
    args = [_u(rng, R, F), _u(rng, R, F), _u(rng, R, F), _u(rng, nb, R, R, F),
            _u(rng, nb, R, R, F), _u(rng, nb, R, R, F), *_trunk(rng, nb, s=BF16_W)]
    args = [a.to(cuda_device).to(BF16) for a in args]
    n = dk.fused_dense_decode.launches
    got = dk.fused_dense_decode(*args)
    assert dk.fused_dense_decode.launches == n + 1 and tuple(got.shape) == (R, R, R, 12)
    chip_smoke.check_bf16(got, dk.fused_dense_decode_plain(*args), "K3 bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("fold,resident", [(False, False), (True, False), (False, True),
                                           (True, True)])
@pytest.mark.parametrize("R,nb", [(13, 5), (40, 2), (7, 1)])
def test_decode_bf16_scenes_are_independent(cuda_device, R, nb, fold, resident):
    """Each bf16 instance's scenes are independent: a scene decoded alone
    gives its bytes in a batch (whichever block's run the scene's slabs fall
    in), and K3's bf16 entry gives the default instance's bytes for one
    scene."""
    rng = np.random.RandomState(13)
    args = [a.to(cuda_device).to(BF16) for a in _decode_args(rng, 3, R, nb)]
    options = dict(fold_b1=fold, resident_bf16=resident)
    together = dense_decode_batched(*args, **options)
    for b in range(3):
        one = args[:3] + [p[b:b + 1].contiguous() for p in args[3:6]] + args[6:]
        assert torch.equal(dense_decode_batched(*one, **options)[0], together[b])
        if not (fold or resident):
            single = args[:3] + [p[b].contiguous() for p in args[3:6]] + args[6:]
            assert torch.equal(dk.fused_dense_decode(*single).reshape(R ** 3, -1).T,
                               together[b])


@pytest.mark.cuda
def test_bf16_wrappers_refuse_mixed_dtypes(cuda_device):
    """A mode takes all its inputs in one dtype: bf16 projections beside
    float32 weights, or a float32 bias beside a bf16 TSDF, raise."""
    rng = np.random.RandomState(14)
    args = [a.to(cuda_device) for a in _decode_args(rng, 1, 8, 2)]
    mixed = args[:3] + [p.to(BF16) for p in args[3:6]] + args[6:]
    with pytest.raises(ValueError, match="bfloat16"):
        dense_decode_batched(*mixed)
    with pytest.raises(ValueError, match="bfloat16"):
        dk.fused_dense_decode(*mixed[:3], *(p[0] for p in mixed[3:6]), *mixed[6:])
    w, b, t = _stem_args(rng, 8, (1, 8, 8, 8), cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        stem_pool_batched(w.to(BF16), b, t.to(BF16))
    with pytest.raises(ValueError, match="dtype"):
        stem_pool_batched(w.half(), b.half(), t.half())


@pytest.mark.cuda
def test_bf16_programs_queue_without_waiting_for_the_card(cuda_device):
    """Once warm, the bf16 programs (K1 + K2 batched, K3 single-scene) make
    no synchronizing CUDA call, and launch the bf16 kernels."""
    net, cfg, pcfg, grids = _random_giga(cuda_device)
    net = net.to(BF16)
    batched = build_batched_giga_planner_fn(net, cfg, pcfg, 0.3, use_kernels=True)
    single = build_giga_planner_fn(net, cfg, pcfg, 0.3, use_kernels=True)
    batched(grids, grids)
    single(grids[0], grids[0])
    torch.cuda.synchronize()
    n = (stem_pool_batched.launches, dense_decode_batched.launches, dk.fused_dense_decode.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        cands = batched(grids, grids)
        one = single(grids[0], grids[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (stem_pool_batched.launches, dense_decode_batched.launches,
            dk.fused_dense_decode.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    assert int(cands.count.sum()) > 0 and int(one.count) > 0
    assert cands.scores.dtype == torch.float32


@pytest.mark.cuda
def test_bf16_kernels_launch_without_waiting_for_the_card(cuda_device):
    """Each bf16 K2 instance and K3 bf16 encode their tensor maps on the
    host at every launch: once built, no launch makes a synchronizing call."""
    rng = np.random.RandomState(18)
    args = [a.to(cuda_device).to(BF16) for a in _decode_args(rng, 2, 13, 5, s=BF16_W)]
    single = args[:3] + [p[0].contiguous() for p in args[3:6]] + args[6:]
    modes = [m for m in dk.K2_MODES if m[0] == BF16]
    for _, fold, resident in modes:
        dense_decode_batched(*args, fold_b1=fold, resident_bf16=resident)
    dk.fused_dense_decode(*single)
    torch.cuda.synchronize()
    n = (dense_decode_batched.launches, dk.fused_dense_decode.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [dense_decode_batched(*args, fold_b1=fold, resident_bf16=resident)
                for _, fold, resident in modes]
        outs.append(dk.fused_dense_decode(*single))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (dense_decode_batched.launches, dk.fused_dense_decode.launches) == (
        n[0] + len(modes), n[1] + 1)
    assert all(bool(torch.isfinite(o).all()) for o in outs)


# Trunks deeper than the checkpoint's five blocks. There two plain versions
# that differ only in the order of their float32 sums (float32 against
# float64, the same bf16 roundings) already lie farther apart than
# check_bf16's share gate allows: 0.9992 of outputs within 1e-5 at NB = 5,
# 0.9981 at NB = 10, 0.9954 at NB = 18, 0.9940 at NB = 22 (R = 40, these
# inputs at B = 2, 2, 2, 1; bf16_sum_order.spread on the CPU). So here the kernel is held no farther from the float32 plain
# version than the float64 one is, and within TOL_BF16_FAR. Both shapes
# take one slab stage: whole z-lines x 14 y-lines at NB = 18; 32 z-columns
# x 14 y-lines at NB = 22, the deepest trunk that fits a block at R = 40.
DEEP = [(2, 40, 18), (1, 40, 22)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,nb", DEEP)
def test_decode_bf16_deep_trunks_match_plain(cuda_device, B, R, nb):
    """K2's bf16 entry point on one slab stage against its plain versions,
    and K3's bf16 entry giving K2's bytes for scene 0."""
    from giga_tpu_torch.scripts import bf16_sum_order

    rng = np.random.RandomState(20)
    args = [a.to(cuda_device).to(BF16) for a in _decode_args(rng, B, R, nb, s=BF16_W)]
    n = dense_decode_batched.launches
    got = dense_decode_batched(*args)
    assert dense_decode_batched.launches == n + 1
    ref = dense_decode_plain(*args)
    share, rel, _ = bf16_sum_order.spread(got, ref)
    floor = bf16_sum_order.spread(bf16_sum_order.plain_float64(dk, args, False, False), ref)[0]
    assert share >= floor and rel <= chip_smoke.TOL_BF16_FAR, (share, floor, rel)
    single = args[:3] + [p[0].contiguous() for p in args[3:6]] + args[6:]
    assert torch.equal(dk.fused_dense_decode(*single).reshape(R ** 3, -1).T, got[0])


@pytest.mark.cuda
def test_bf16_kernel_raises_where_no_slab_fits(cuda_device):
    """No fallback: at R = 40 and NB = 23 the head's weights (4.4 KB a
    block) and the smallest slab (one stage of 32 z-columns and one y-line,
    3 KB a block) outgrow a block's shared memory beside 15 warps' pyz
    rings, and the launch raises instead of taking another path (NB = 22
    runs: DEEP)."""
    rng = np.random.RandomState(19)
    args = [a.to(cuda_device).to(BF16) for a in _decode_args(rng, 1, 40, 23, s=BF16_W)]
    n = dense_decode_batched.launches
    with pytest.raises(RuntimeError, match="dense_decode_bf16 failed"):
        dense_decode_batched(*args)
    assert dense_decode_batched.launches == n


# K4's and K5's bf16 modes: float32 inputs but for K5's bf16 pyz. A tile is
# 32 consecutive (y, z) points of an x-plane: R = 7 (49 points) gives one
# whole tile and one ragged one, R = 17 (289) a plane that ends mid-tile;
# NB = 0 runs no ring box, NB = 1 one a tile (K4's fyz, K5's pyz alike).
FEATS_BF16 = [(B, R, nb) for R in (7, 17, 40) for nb in (0, 1, 5) for B in (1, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,nb", FEATS_BF16)
@pytest.mark.parametrize("x_chunk", [1, 8, 40])
def test_feats_bf16_kernel_matches_plain(cuda_device, B, R, nb, x_chunk):
    """K4's bf16 entry point (projections on mma.sync from the rounded raw
    features, tensor-core trunk) against its plain version, equal bit for
    bit at every x_chunk (one pass whatever x_chunk)."""
    rng = np.random.RandomState(15)
    args = [a.to(cuda_device) for a in _feats_args(rng, B, R, 32, nb, s=BF16_W)]
    n = dk.dense_decode_feats_batched.launches
    got = dk.dense_decode_feats_batched(*args, x_chunk=x_chunk, compute_dtype=BF16)
    assert dk.dense_decode_feats_batched.launches == n + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, R, R, R, 12)
    chip_smoke.check_bf16(got, dk.dense_decode_feats_plain(*args, compute_dtype=BF16), "K4 bf16")
    assert torch.equal(dk.dense_decode_feats_batched(*args, x_chunk=1, compute_dtype=BF16), got)
    assert dk.dense_decode_feats_launch_config(B, R, 32, 3, nb, x_chunk, False,
                                               BF16)["passes"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,nb", FEATS_BF16)
def test_hybrid_bf16_kernel_matches_plain(cuda_device, B, R, nb):
    """K5's bf16 entry point (bf16 pyz) against its plain version."""
    rng = np.random.RandomState(16)
    args = [a.to(cuda_device) for a in _hybrid_args(rng, B, R, 32, nb, s=BF16_W)]
    args[5] = args[5].to(BF16)
    n = dk.dense_decode_hybrid_batched.launches
    got = dk.dense_decode_hybrid_batched(*args)
    assert dk.dense_decode_hybrid_batched.launches == n + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, R, R, R, 12)
    chip_smoke.check_bf16(got, dk.dense_decode_hybrid_plain(*args), "K5 bf16")


@pytest.mark.cuda
def test_feats_bf16_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """K4's bf16 mode takes float32 inputs and a bf16 or float32 mode; K5's
    takes float32 inputs beside its bf16 pyz; both take 32 channels only."""
    rng = np.random.RandomState(17)
    args = [a.to(cuda_device) for a in _feats_args(rng, 1, 8, 8, 2)]
    with pytest.raises(ValueError, match="dtype"):
        dk.dense_decode_feats_batched(*args, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="float32"):
        dk.dense_decode_feats_batched(*args[:3], args[3].to(BF16), *args[4:],
                                      compute_dtype=BF16)
    hybrid = [a.to(cuda_device) for a in _hybrid_args(rng, 1, 8, 8, 2)]
    hybrid[5] = hybrid[5].to(BF16)
    with pytest.raises(ValueError, match="float32"):
        dk.dense_decode_hybrid_batched(*hybrid[:3], hybrid[3].to(BF16), *hybrid[4:])
    with pytest.raises(ValueError, match="dtype"):
        dk.dense_decode_hybrid_batched(*hybrid[:5], hybrid[5].half(), *hybrid[6:])
    n4, n5 = dk.dense_decode_feats_batched.launches, dk.dense_decode_hybrid_batched.launches
    with pytest.raises(ValueError, match="32 feature channels"):  # C = 8
        dk.dense_decode_feats_batched(*args, compute_dtype=BF16)
    with pytest.raises(ValueError, match="32 feature channels"):
        dk.dense_decode_hybrid_batched(*hybrid)
    assert (dk.dense_decode_feats_batched.launches,
            dk.dense_decode_hybrid_batched.launches) == (n4, n5)


# -- K2's numeric options: fold_b1 in both modes, resident_bf16 in bf16 ----------

OPTIONS = [(torch.float32, True, False), (BF16, True, False), (BF16, False, True),
           (BF16, True, True)]  # (dtype, fold_b1, resident_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fold,resident", OPTIONS)
@pytest.mark.parametrize("B,R,nb", [(2, 12, 5), (1, 7, 2), (3, 13, 1), (2, 40, 5)])
def test_decode_option_kernels_match_plain(cuda_device, dtype, fold, resident, B, R, nb):
    """Each option's entry point against its plain version (float32 within
    1e-5, bf16 by check_bf16), one launch of that entry point."""
    rng = np.random.RandomState(20)
    s = BF16_W if dtype == BF16 else 0.5
    args = [a.to(cuda_device).to(dtype) for a in _decode_args(rng, B, R, nb, s=s)]
    entry = dk.dense_decode_entry(dtype, fold, resident)
    n = dk.dense_decode_batched.entry_launches[entry]
    got = dense_decode_batched(*args, fold_b1=fold, resident_bf16=resident)
    ref = dense_decode_plain(*args, fold_b1=fold, resident_bf16=resident)
    assert dk.dense_decode_batched.entry_launches[entry] == n + 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=TOL_KERNEL, rtol=TOL_KERNEL)
    else:
        chip_smoke.check_bf16(got, ref, entry)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,resident", [(torch.float32, False), (BF16, False),
                                            (BF16, True)])
def test_fold_kernel_equals_default_kernel_with_b1_zeroed(cuda_device, dtype, resident):
    """The kFoldB1 instance skips b1 in every block but the last: the
    instance without it, given those b1 as zeros, writes the same bytes."""
    rng = np.random.RandomState(21)
    args = [a.to(cuda_device).to(dtype) for a in _decode_args(rng, 2, 13, 5, s=BF16_W)]
    b1 = args[9].clone()
    b1[:-1] = 0
    zeroed = args[:9] + [b1] + args[10:]
    assert torch.equal(dense_decode_batched(*args, fold_b1=True, resident_bf16=resident),
                       dense_decode_batched(*zeroed, resident_bf16=resident))


@pytest.mark.cuda
def test_resident_kernel_is_another_function(cuda_device):
    """resident_bf16 rounds the residual stream: not the default bf16 bytes."""
    rng = np.random.RandomState(22)
    args = [a.to(cuda_device).to(BF16) for a in _decode_args(rng, 1, 12, 5, s=BF16_W)]
    assert not torch.equal(dense_decode_batched(*args, resident_bf16=True),
                           dense_decode_batched(*args))
    with pytest.raises(ValueError, match="resident_bf16"):
        dense_decode_batched(*(a.float() for a in args), resident_bf16=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_option_programs_queue_and_return_raw(cuda_device, dtype):
    """The batched program with fold_b1 (and hidden_bf16 in bf16), once
    warm, makes no synchronizing call and launches K1 and K2's fold entry
    point once; return_raw leaves its candidates bit-equal."""
    net, cfg, pcfg, grids = _random_giga(cuda_device)
    net = net.to(dtype)
    options = dict(fold_b1=True, hidden_bf16=dtype == BF16)
    fn = build_batched_giga_planner_fn(net, cfg, pcfg, 0.3, use_kernels=True, **options)
    raw_fn = build_batched_giga_planner_fn(net, cfg, pcfg, 0.3, use_kernels=True,
                                           return_raw=True, **options)
    fn(grids, grids)
    torch.cuda.synchronize()
    entry = dk.dense_decode_entry(dtype, fold_b1=True)
    n = (stem_pool_batched.launches, dk.dense_decode_batched.entry_launches[entry])
    torch.cuda.set_sync_debug_mode("error")
    try:
        cands = fn(grids, grids)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (stem_pool_batched.launches,
            dk.dense_decode_batched.entry_launches[entry]) == (n[0] + 1, n[1] + 1)
    got, raw = raw_fn(grids, grids)
    assert all(torch.equal(a, b) for a, b in zip(cands, got))
    assert [tuple(v.shape) for v in raw] == [(2, 40, 40, 40), (2, 4, 40 ** 3), (2, 40, 40, 40)]
    assert int(cands.count.sum()) > 0


# -- the shape predicates against the kernels' launch configurations ------------

def _admitted(config, *args, **kw) -> bool:
    """Whether a launch configuration takes the shapes: it returns, or
    raises for shapes its kernel does not take."""
    try:
        config(*args, **kw)
    except (ValueError, RuntimeError):
        return False
    return True


# (Y, Z) on both sides of K1's limits: float32 Y * ceil(Z / 4) <= 416 (and
# the shared memory of long rows), bf16 Z <= 48 and ceil(Y / 10) *
# ceil(Z / 16) <= 12
STEM_SWEEP = [(40, 40), (41, 40), (42, 40), (48, 48), (104, 16), (105, 16), (13, 128),
              (14, 128), (2, 800), (1, 1660), (1, 1700), (40, 48), (41, 48), (60, 32),
              (61, 32), (120, 16), (121, 16), (10, 49), (7, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_stem_predicate_matches_launch_config(cuda_device, dtype):
    from giga_tpu_torch.ops.kernels.stem import can_stem_pool, stem_pool_launch_config

    for Y, Z in STEM_SWEEP:
        for B, X, C in ((1, 40, 32), (64, 3, 64), (2, 9, 8), (1, 40, 12), (1, 40, 4)):
            assert can_stem_pool(B, X, Y, Z, C, dtype) == _admitted(
                stem_pool_launch_config, B, X, Y, Z, C, dtype), (B, X, Y, Z, C, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_decode_predicate_matches_launch_config(cuda_device, dtype):
    """K2/K3: hidden 32 and 4 outputs only; float32 n_blocks <= 15 (the
    weights and 12 warps' tiles in shared memory), bf16 n_blocks 1 .. 22
    (the slab shape); the option sets each mode has."""
    lib = dk._lib()
    built = (lib.dense_decode_hidden(), lib.dense_decode_outputs())
    for R in (1, 7, 40, 64, 100, 257, 300):
        for nb in (0, 1, 5, 15, 16, 22, 23):
            for pm, fold, res in ((False, False, False), (True, False, False),
                                  (False, True, False), (False, False, True),
                                  (False, True, True), (True, True, False)):
                for B, heads in ((1, 3), (64, 1)):
                    ok = _admitted(dk.dense_decode_launch_config, B, R, heads, nb, pm, dtype,
                                   fold, res)
                    for H, O in ((32, 4), (64, 4), (32, 1)):
                        assert dk.can_dense_decode(B, R, heads, H, O, nb, dtype, pm, fold,
                                                   res) == (ok and (H, O) == built), \
                            (B, R, heads, H, O, nb, dtype, pm, fold, res)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_feats_predicate_matches_launch_config(cuda_device, dtype):
    """K4/K5: float32 n_blocks <= 14, heads * 32 <= 256 (the projection
    kernel's threads), C <= 854 (its staged rows); bf16 C = 32 only, R <= 256
    (an x-plane in one TMA box), at R = 40 n_blocks <= 14 (K4) and <= 18
    (K5), at R = 256 <= 9 and <= 12 (the layout's shared bytes)."""
    for R in (40, 256, 257):
        for C in (1, 32, 854, 855):
            for heads in (1, 3, 8, 9):
                for nb in (0, 5, 9, 10, 12, 13, 14, 15, 18, 19):
                    for x_chunk, hybrid in ((1, False), (40, False), (40, True)):
                        ok = _admitted(dk.dense_decode_feats_launch_config, 2, R, C, heads, nb,
                                       x_chunk, hybrid, dtype)
                        assert dk.can_dense_decode_feats(2, R, C, heads, 32, 4, nb, x_chunk,
                                                         hybrid, dtype) == ok, \
                            (R, C, heads, nb, x_chunk, hybrid, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_giga_wide_plans_on_the_card(cuda_device, precision):
    """GIGAPlanner(model_type="giga_wide") with seeded weights: __call__ and
    plan_batch plan on the card through K1 and the module decode (K2 and K3
    take hidden 32 only). In float32 their decisions are those of the same
    planner on the CPU; in bf16 their raw qual lies within
    chip_smoke.WIDE_BF16_STEPS bf16 steps of the CPU's."""
    import copy

    from giga_tpu_torch.models.registry import init_network

    net, cfg = init_network("giga_wide", chip_smoke.WIDE_SEED)
    scenes = chip_smoke.make_scenes(2)
    planners = []
    for device in ("cuda", "cpu"):
        planner = GIGAPlanner(net=copy.deepcopy(net), model_cfg=cfg, precision=precision,
                              device=device, **chip_smoke.WIDE_KW)
        planner.planner_cfg = dataclasses.replace(planner.planner_cfg,
                                                  min_width=chip_smoke.WIDE_WIDTHS[0],
                                                  max_width=chip_smoke.WIDE_WIDTHS[1])
        planners.append(planner)
    card, cpu = planners
    assert card._ensure_fn().paths == {"encode": "module", "decode": "module"}
    assert card._ensure_batched_fn().paths == {"encode": "K1", "decode": "module"}
    n = (stem_pool_batched.launches, dense_decode_batched.launches, dk.fused_dense_decode.launches)
    batch, batch_cpu = card.plan_batch(scenes), cpu.plan_batch(scenes)
    called = [card(State(tsdf=g))[:2] for g in scenes]
    torch.cuda.synchronize()
    assert (stem_pool_batched.launches, dense_decode_batched.launches,
            dk.fused_dense_decode.launches) == (n[0] + 1, n[1], n[2])
    voxel = 0.3 / 40
    for i, g in enumerate(scenes):
        assert len(batch[i][0]) > 0
        if precision == "fp32":
            chip_smoke.compare_grasps(batch[i], batch_cpu[i], voxel, f"plan_batch {i}")
            chip_smoke.compare_grasps(called[i], cpu(State(tsdf=g))[:2], voxel, f"__call__ {i}")
    if precision == "bf16":
        raw = [build_giga_planner_fn(p.net, cfg, p.planner_cfg, 0.3, use_kernels=True,
                                     return_raw=True) for p in planners]
        grid = torch.from_numpy(scenes[0])
        quals = [fn(grid.to(p.device), grid.to(p.device))[1][0].cpu()
                 for fn, p in zip(raw, planners)]
        chip_smoke.check_bf16_steps(*quals, "giga_wide bf16 raw qual vs the CPU's",
                                    chip_smoke.WIDE_BF16_STEPS)


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["mean", "max"])
def test_ensemble_launches_k3_once_per_member(cuda_device, combine):
    """A three-member ensemble's __call__ and plan_stream launch K3 three
    times a scene; its plans equal the CPU's."""
    from giga_tpu_torch.models.checkpoint import load_params

    params = load_params(REPO / chip_smoke.CHECKPOINT)
    members = [params, chip_smoke.perturbed_params(params, 1), chip_smoke.perturbed_params(params, 2)]
    scenes = chip_smoke.make_scenes(2)
    kw = dict(params=members, ensemble_combine=combine, **chip_smoke.PLANNER_KW)
    card, cpu = GIGAPlanner(**kw), GIGAPlanner(device="cpu", **kw)
    n = dk.fused_dense_decode.launches
    called = [card(State(tsdf=g))[:2] for g in scenes]
    streamed = card.plan_stream(scenes)
    torch.cuda.synchronize()
    assert dk.fused_dense_decode.launches == n + 3 * 2 * len(scenes)
    for i, g in enumerate(scenes):
        chip_smoke.compare_grasps(called[i], cpu(State(tsdf=g))[:2], 0.3 / 40, f"scene {i}")
        chip_smoke.compare_grasps(streamed[i], called[i], 0.3 / 40, f"stream {i}", tol=1e-6)
    with pytest.raises(NotImplementedError):
        card.plan_batch(scenes)


def _vgn_params():
    return chip_smoke.unflatten_params(np.load(REPO / chip_smoke.GOLDEN_VGN))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default", "bf16"])
def test_vgn_planner_on_the_card(cuda_device, precision):
    """VGN plan_batch and __call__ on the card against the CPU: ``highest``
    equal decisions (and batch equal to single within 1e-6), ``default``
    (TF32) and ``bf16`` by tests/test_vgn_fast.py's four gates against the
    CPU's ``highest``; the TF32 flags are restored after each plan."""
    from giga_tpu_torch.inference.planner import VGNPlanner

    params = _vgn_params()
    scenes = chip_smoke.make_scenes(4)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    card = VGNPlanner(params=params, precision=precision, **chip_smoke.VGN_KW)
    cpu = VGNPlanner(params=params, precision="highest", device="cpu", **chip_smoke.VGN_KW)
    batch = card.plan_batch(scenes)
    called = [card(State(tsdf=g))[:2] for g in scenes]
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    ref = cpu.plan_batch(scenes)
    voxel = 0.3 / 40
    if precision == "highest":
        for i in range(len(scenes)):
            chip_smoke.compare_grasps(batch[i], ref[i], voxel, f"scene {i}")
            chip_smoke.compare_grasps(called[i], batch[i], voxel, f"single {i}",
                                      tol=chip_smoke.TOL_BATCH)
    else:
        for got in (batch, called):
            chip_smoke.bf16_gates(ref, got, voxel, f"VGN {precision}",
                                  overlap_mean=chip_smoke.VGN_OVERLAP_MEAN)


@pytest.mark.cuda
@pytest.mark.parametrize("resolution", [40, 120])
def test_fuse_views_on_the_card(cuda_device, resolution):
    """fuse_views and TSDFVolume on the card give the CPU's volumes: the
    same bits (eager ops, tensor divisors, float64 fused multiply-adds)."""
    from giga_tpu_torch.core.perception import CameraIntrinsic, create_tsdf
    from giga_tpu_torch.ops.tsdf import fuse_views

    views = chip_smoke.camera_views()
    objects = chip_smoke.scene_objects(2)[1]
    cam = dict(width=160, height=120, fx=135.0, fy=135.0, cx=80.0, cy=60.0)
    depth = np.stack([chip_smoke.render_depth(objects, e, **cam) for e in views])
    E = np.stack([e.as_matrix() for e in views]).astype(np.float32)
    K = np.array([[135.0, 0, 80.0], [0, 135.0, 60.0], [0, 0, 1]], np.float32)
    kw = dict(resolution=resolution, size=0.3, sdf_trunc=4 * 0.3 / resolution)
    args = [torch.from_numpy(a) for a in (depth, K, E)]
    card = fuse_views(*(a.to(cuda_device) for a in args), **kw)
    cpu = fuse_views(*args, **kw)
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a.cpu(), b, atol=0, rtol=0)
    intr = CameraIntrinsic(**cam)
    lists = np.stack([e.to_list() for e in views])
    vol = create_tsdf(0.3, resolution, depth, intr, lists)
    ref = create_tsdf(0.3, resolution, depth, intr, lists, device="cpu")
    assert vol.tsdf.device.type == "cuda"
    np.testing.assert_array_equal(vol.get_grid(), ref.get_grid())
    np.testing.assert_array_equal(vol.get_cloud(), ref.get_cloud())


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["giga", "vgn"])
def test_visualize_on_the_card(cuda_device, family):
    """visualize=True on the card composes the CPU's scene."""
    from giga_tpu_torch.inference.planner import VGNPlanner

    objects = chip_smoke.scene_objects(1)[0]
    scene = chip_smoke.make_scenes(1)
    if family == "giga":
        make = lambda d: GIGAPlanner(REPO / chip_smoke.CHECKPOINT, visualize=True, device=d,
                                     **chip_smoke.PLANNER_KW)
    else:
        make = lambda d: VGNPlanner(params=_vgn_params(), precision="highest", visualize=True,
                                    device=d, **chip_smoke.VGN_KW)
    card = make(None)(State(tsdf=scene), scene_mesh=chip_smoke.scene_mesh(objects))
    cpu = make("cpu")(State(tsdf=scene), scene_mesh=chip_smoke.scene_mesh(objects))
    assert len(card) == 4 and len(card[0]) >= 1
    chip_smoke.compare_meshes(card[3], cpu[3], family)


# ------------------------------------------------------------------ training

def _train_net(name="giga", seed=0):
    from giga_tpu_torch.models.registry import init_network

    return init_network(name, seed=seed)


@pytest.mark.cuda
@pytest.mark.parametrize("name,sampler,tol", [
    ("giga", "mm", chip_smoke.TOL_TRAIN_GRAD),
    ("giga", None, chip_smoke.TOL_TRAIN_GRAD_GATHER),
    ("giga_geo", "mm", chip_smoke.TOL_TRAIN_GRAD),
    ("vgn", "mm", chip_smoke.TOL_TRAIN_GRAD)], ids=["giga-mm", "giga-gather", "geo", "vgn"])
def test_train_step_on_card_matches_cpu(cuda_device, name, sampler, tol):
    """One fp32 step on the card against the CPU port's: loss, every
    gradient leaf, params after the step (chip_smoke's bounds)."""
    net, cfg = _train_net(name)
    batch = chip_smoke.train_batch(1, 4, 256, vgn=name == "vgn")
    res = chip_smoke.compare_train_step(net, cfg, batch, "cuda", sampler=sampler, tol_grad=tol)
    assert res["state"].params["encoder.conv_in.weight" if name != "vgn"
                               else "conv_qual.weight"].is_cuda


@pytest.mark.cuda
def test_bf16_train_step_on_card(cuda_device):
    """The bf16 step on the card: loss within 3e-2 of the fp32 step's,
    master params and moments float32, the loss falls over three steps."""
    from giga_tpu_torch.train.trainer import create_train_state, make_train_step

    net, cfg = _train_net("giga")
    batch = chip_smoke.train_batch(1, 4, 256)
    losses = {}
    for dtype in (None, BF16):
        state = create_train_state(_train_net("giga")[0], device="cuda")
        step = make_train_step(state.module, cfg, dtype=dtype)
        losses[dtype] = [float(step(state, batch)[1]["loss_all"]) for _ in range(4)]
    assert abs(losses[BF16][0] - losses[None][0]) < chip_smoke.TOL_TRAIN_BF16_LOSS
    assert losses[BF16][-1] < losses[BF16][0]
    assert {t.dtype for t in [*state.params.values(), *state.tx.mu]} == {torch.float32}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp32", "bf16", "gather", "clip_skip", "corpus", "vgn"])
def test_warm_train_step_makes_no_sync(cuda_device, kind):
    """A warm train step with its batch (or corpus and indices) on the card
    makes no synchronizing CUDA call: the loss terms stay on the card."""
    from giga_tpu_torch.core.device import to_device
    from giga_tpu_torch.train import corpus as tc
    from giga_tpu_torch.train.trainer import create_train_state, make_train_step

    net, cfg = _train_net("vgn" if kind == "vgn" else "giga")
    state = create_train_state(net, device="cuda", clip_norm=1.0 if kind == "clip_skip" else None,
                               skip_nonfinite=kind == "clip_skip")
    dtype = BF16 if kind == "bf16" else None
    sampler = None if kind == "gather" else "mm"
    if kind == "corpus":
        corpus = chip_smoke.make_corpus(4, 512, 16)
        args = (tc.device_corpus(corpus, device="cuda"),
                to_device(tc.CorpusSampler(corpus, range(4), 4, 128, seed=0)(), "cuda"))
        step = make_train_step(state.module, cfg, assemble=tc.assemble_batch)
    else:
        args = (to_device(chip_smoke.train_batch(2, 4, 256, vgn=kind == "vgn"), "cuda"),)
        step = make_train_step(state.module, cfg, dtype=dtype, sampler=sampler)
    step(state, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, terms = step(state, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert terms["loss_all"].is_cuda and np.isfinite(float(terms["loss_all"]))


@pytest.mark.cuda
def test_corpus_assembly_on_card_equals_cpu(cuda_device):
    """assemble_batch on the card equals the CPU's, array for array, for
    every quarter turn and for mixed turns."""
    from giga_tpu_torch.core.device import to_device
    from giga_tpu_torch.train import corpus as tc

    corpus = chip_smoke.make_corpus(6, 300, 20)
    on_card = tc.device_corpus(corpus, device="cuda")
    on_cpu = tc.device_corpus(corpus, device="cpu")
    sampler = tc.CorpusSampler(corpus, range(6), batch=8, occ_sub=64, seed=1)
    for k in (0, 1, 2, 3, None):
        sel = sampler()
        if k is not None:
            sel["rotk"] = np.full(8, k, np.int32)
        got = tc.assemble_batch(on_card, to_device(sel, "cuda"))
        ref = tc.assemble_batch(on_cpu, to_device(sel, "cpu"))
        for name, v in ref.items():
            assert got[name].is_cuda and torch.equal(got[name].cpu(), v), (name, k)


def _mesh_generators(device_kw, **kw):
    """(card generator, CPU generator) on the shipped GIGA-Geo checkpoint."""
    import copy

    from giga_tpu_torch.geometry.generation import MeshGenerator
    from giga_tpu_torch.models.registry import load_network

    net, _ = load_network(REPO / chip_smoke.GEO_CHECKPOINT, "giga_geo")
    cpu_net = copy.deepcopy(net)
    return (MeshGenerator(net, device="cuda", **kw, **device_kw),
            MeshGenerator(cpu_net, device="cpu", **kw, **device_kw))


def _mesh_scenes(n=3):
    from giga_tpu_torch.scripts.profile_meshgen import bench_scenes

    return bench_scenes(n)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(resolution0=32, upsampling_steps=1, strategy="dense"),
                                dict(resolution0=16, upsampling_steps=2, strategy="refine")])
def test_mesh_bands_on_card_equal_cpu(cuda_device, kw):
    """The band program and the refine chain on the card against the CPU's,
    cell by cell (chip_smoke.compare_bands), and the meshes' face counts."""
    from giga_tpu_torch.geometry.generation import fetch

    card, cpu = _mesh_generators({}, **kw)
    for tsdf in _mesh_scenes(2):
        bands = []
        for gen in (card, cpu):
            gen.encode(tsdf)
            out = fetch(*(gen.refine_program(gen._planes, 0) if gen.strategy == "refine"
                          else gen.band_program(gen._planes)))
            bands.append((out[0][:int(out[2])], out[1][:int(out[2])]))
        res = chip_smoke.compare_bands(bands[0], bands[1], f"{kw}")
        mesh, stats = card.generate_mesh(tsdf)
        ref, ref_stats = cpu.generate_mesh(tsdf)
        assert stats["path"] == ref_stats["path"]
        assert abs(len(mesh.faces) - len(ref.faces)) <= 12 * sum(res["only"])


@pytest.mark.cuda
def test_bf16_meshes_on_card_near_cpu(cuda_device):
    """bf16 on the card against bf16 on the CPU: the two sum bf16 products
    in other orders, so they are held by the bf16 gate (median vertex
    distance below chip_smoke.TOL_MESH_BF16), the paths equal."""
    from scipy.spatial import cKDTree

    card, cpu = _mesh_generators({}, resolution0=16, upsampling_steps=1, precision="bf16")
    for tsdf in _mesh_scenes(2):
        (mesh, stats), (ref, ref_stats) = card.generate_mesh(tsdf), cpu.generate_mesh(tsdf)
        assert stats["path"] == ref_stats["path"] and len(mesh.faces) > 0
        assert np.median(cKDTree(ref.vertices).query(mesh.vertices)[0]) < chip_smoke.TOL_MESH_BF16


@pytest.mark.cuda
def test_mesh_programs_make_no_sync(cuda_device):
    """The band and refine programs, single and batched, warm, run with no
    synchronizing call before their fetch."""
    card, _ = _mesh_generators({}, resolution0=16, upsampling_steps=2)
    scenes = _mesh_scenes(3)
    one, batch = card.upload(scenes[:1]), card.upload(scenes)
    with torch.no_grad():
        planes = card.net.encode(one)
    card.strategy = "refine"
    programs = [lambda: card.band_program(planes), lambda: card.band_program_batched(batch),
                lambda: card.refine_program(planes, 0),
                lambda: card.refine_program_batched(batch, 0)]
    for fn in programs:
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert all(t.is_cuda for t in out)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["dense", "refine"])
def test_generate_meshes_on_card_equal_per_scene(cuda_device, strategy):
    """generate_meshes on the card against its per-scene generate_mesh
    (tests/test_band_generation.py's gates), the paths equal."""
    card, _ = _mesh_generators({}, resolution0=16, upsampling_steps=2, strategy=strategy)
    scenes = _mesh_scenes(3)
    meshes = card.generate_meshes(scenes)
    singles = [card.generate_mesh(g) for g in scenes]
    assert [s["path"] for s in card.batch_stats] == [s["path"] for _, s in singles]
    chip_smoke.compare_batched(meshes, [m for m, _ in singles], strategy)


@pytest.mark.cuda
def test_band_program_on_k2_equals_module_path(cuda_device):
    """The batched band program's lattice decode on K2 against the module
    path's on the card, B=2 at 65^3: equal band counts and ids, corners
    within one float16 step + TOL_DECODE * (1 + |b|) (near 0 a float16 step
    is below the two float32 sums' difference); K2 launched once a program,
    never on the module
    path; and ``generate_meshes`` on K2 equal to its per-scene
    ``generate_mesh``, every scene's stats naming K2."""
    from giga_tpu_torch.geometry.generation import fetch

    kw = dict(resolution0=16, upsampling_steps=2, strategy="dense")
    k2, module = _mesh_generators({}, **kw)[0], _mesh_generators({}, **kw)[0]
    module.band_decode = "module"
    assert k2.band_decode == "K2"
    scenes = _mesh_scenes(2)
    grids = k2.upload(scenes)
    bands = []
    for gen, launches in ((k2, 1), (module, 0)):
        n = dense_decode_batched.launches
        bands.append(fetch(*gen.band_program_batched(grids)))
        assert dense_decode_batched.launches == n + launches, gen.band_decode
    (ids, vals, counts), (rids, rvals, rcounts) = bands
    np.testing.assert_array_equal(counts, rcounts)
    np.testing.assert_array_equal(ids, rids)
    for b, c in enumerate(counts):
        a, r = vals[b, :c], rvals[b, :c]
        step = np.spacing(np.maximum(np.abs(a), np.abs(r))).astype(np.float64)
        excess = np.abs(a.astype(np.float64) - r) - step - chip_smoke.TOL_DECODE * (1 + np.abs(r))
        assert excess.max(initial=-1.0) <= 0, (b, excess.max())
    meshes = k2.generate_meshes(scenes)
    singles = [k2.generate_mesh(g) for g in scenes]
    assert [s["decode"] for s in k2.batch_stats] == [s["decode"] for _, s in singles] == ["K2"] * 2
    assert [s["path"] for s in k2.batch_stats] == [s["path"] for _, s in singles]
    chip_smoke.compare_batched(meshes, [m for m, _ in singles], "K2")


@pytest.mark.cuda
def test_refine_mesh_on_card_equals_cpu(cuda_device):
    """Normals and two refinement steps (the same Dirichlet draws) on the
    card against the CPU's."""
    card, cpu = _mesh_generators({}, resolution0=8, upsampling_steps=1)
    tsdf = _mesh_scenes(1)[0]
    mesh = cpu.generate_mesh(tsdf, return_stats=False)
    card.encode(tsdf)
    np.testing.assert_allclose(card.estimate_normals(mesh.vertices),
                               cpu.estimate_normals(mesh.vertices), atol=3e-5, rtol=0)
    np.testing.assert_allclose(card.refine_mesh(mesh, 2).vertices, cpu.refine_mesh(mesh, 2).vertices,
                               atol=1e-5, rtol=0)
