"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from giga_tpu_torch.inference.planner import GIGAPlanner, build_batched_giga_planner_fn
from giga_tpu_torch.inference.serving import PlannerService
from giga_tpu_torch.core.config import PlannerConfig, giga
from giga_tpu_torch.models.conv_onet import GIGANet
from giga_tpu_torch.ops.kernels.decoder import dense_decode_batched, dense_decode_plain
from giga_tpu_torch.ops.kernels.stem import stem_pool_batched, stem_pool_plain

TOL_STEM = 2e-5
TOL_KERNEL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _u(rng, *shape, s=0.5):
    return torch.from_numpy(rng.uniform(-s, s, shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,C", [(3, 40, 32), (2, 16, 8)])
def test_stem_kernel_matches_plain(cuda_device, B, R, C):
    rng = np.random.RandomState(0)
    w = _u(rng, C, 1, 3, 3, 3).to(cuda_device)
    b = _u(rng, C, s=0.2).to(cuda_device)
    t = torch.from_numpy(rng.rand(B, R, R, R).astype(np.float32)).to(cuda_device)
    n = stem_pool_batched.launches
    got = stem_pool_batched(w, b, t)
    ref = stem_pool_plain(w, b, t)
    assert stem_pool_batched.launches == n + 1
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], atol=TOL_STEM, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,nb", [(2, 12, 5), (1, 7, 2)])
def test_decode_kernel_matches_plain(cuda_device, B, R, nb):
    """R = 7 leaves a ragged last tile of lattice rows."""
    rng = np.random.RandomState(1)
    E, H, O = 3, 32, 4
    F = E * H
    args = [_u(rng, R, F), _u(rng, R, F), _u(rng, R, F),
            _u(rng, B, nb, R, R, F), _u(rng, B, nb, R, R, F), _u(rng, B, nb, R, R, F),
            _u(rng, nb, E, H, H), _u(rng, nb, E, H), _u(rng, nb, E, H, H), _u(rng, nb, E, H),
            _u(rng, E, H, O), _u(rng, E, O)]
    args = [a.to(cuda_device) for a in args]
    n = dense_decode_batched.launches
    got = dense_decode_batched(*args)
    ref = dense_decode_plain(*args)
    assert dense_decode_batched.launches == n + 1
    torch.testing.assert_close(got, ref, atol=TOL_KERNEL, rtol=TOL_KERNEL)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    rng = np.random.RandomState(2)
    w = _u(rng, 6, 1, 3, 3, 3).to(cuda_device)  # 6 channels: not a multiple of 4
    t = torch.zeros(1, 8, 8, 8, device=cuda_device)
    with pytest.raises(ValueError):
        stem_pool_batched(w, torch.zeros(6, device=cuda_device), t)
    with pytest.raises(ValueError):
        stem_pool_batched(w[:4], torch.zeros(4, device=cuda_device), t.double())


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
