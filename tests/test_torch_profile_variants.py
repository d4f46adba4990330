"""The variant pairs of the port's stage profilers
(giga_tpu_torch/scripts/profile_{geo,postprocess,vgn}.py) on the CPU at a
tiny size, through the functions the scripts assert with and their own
tolerances (the timings run only on the card):

* profile_geo: every stage of the query program once, the mm sampler's
  features and logits at ``highest`` within 2e-5 * (1 + |b|) of the gather
  sampler's (``check_variants``, 64 points);
* profile_postprocess: the blur as taps within 1e-6 of the matrix form
  (``ops.filters.gaussian_blur_3d``); the dense window equal to
  ``max_filter_3d``, on random volumes and on volumes full of ties; the
  postprocess with the dense window giving the shipped one's candidates;
* profile_vgn: the fused 6-channel head's qual within 1e-5 of the shipped
  program's (``fused_qual_error``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from giga_tpu_torch.core.config import PlannerConfig
from giga_tpu_torch.inference import postprocess as post
from giga_tpu_torch.inference.planner import lattice_positions
from giga_tpu_torch.models.registry import get_network, reference_init
from giga_tpu_torch.ops.filters import gaussian_blur_3d, max_filter_3d
from giga_tpu_torch.scripts import profile_geo, profile_postprocess, profile_vgn
from torch_sim import one_torch_thread  # noqa: F401  (autouse)


def test_profile_geo_mm_agrees_with_gather():
    net, cfg = get_network("giga_geo")
    net = reference_init(net, 3).eval()
    rng = np.random.RandomState(0)
    grid = torch.from_numpy(rng.rand(1, 40, 40, 40).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 64, 3)).astype(np.float32))
    stages = profile_geo.build_stages(net, cfg, pts)
    assert [n for n, _, _ in stages][:3] == ["encode", "+sample", "+trunk (full)"]
    assert len(stages) == 3 + 3 * len(profile_geo.PRECISIONS)
    agree, distance = profile_geo.check_variants(stages, grid)
    assert max(agree.values()) <= profile_geo.TOL_AGREE
    assert set(distance) == {"tf32", "bf16"} and distance["tf32"] == 0.0  # no TF32 on a CPU


@pytest.mark.parametrize("shape,ties", [((2, 9, 7, 8), False), ((1, 6, 6, 6), True)])
def test_blur_and_nms_forms_agree(shape, ties):
    rng = np.random.RandomState(0)
    vol = rng.rand(*shape).astype(np.float32)
    if ties:  # plateaus: equal values across each window
        vol = np.round(vol * 3) / 3
    v = torch.from_numpy(vol)
    err = float((profile_postprocess.blur_taps(v, 1.0) - gaussian_blur_3d(v, 1.0)).abs().max())
    assert err <= profile_postprocess.TOL_BLUR
    for size in (3, 4):
        assert torch.equal(profile_postprocess.nms_dense(v, size), max_filter_3d(v, size))


def test_postprocess_with_the_dense_window_equals_the_shipped_one():
    """The script's swap of the postprocess's max filter on 2 scenes of 12^3
    whose thresholds leave candidates: the same candidates."""
    R = 12
    rng = np.random.RandomState(1)
    cfg = dataclasses.replace(PlannerConfig(resolution=R), qual_th=0.5, low_th=0.1,
                              force_detection=True, min_width=0.0, max_width=1.0)
    qual = torch.from_numpy(rng.rand(2, R, R, R).astype(np.float32))
    tsdf = torch.from_numpy(rng.rand(2, R, R, R).astype(np.float32))
    rot = torch.from_numpy(rng.rand(2, R, R, R, 4).astype(np.float32))
    width = torch.from_numpy(rng.rand(2, R, R, R).astype(np.float32) * 0.8)
    positions = lattice_positions((torch.arange(R, dtype=torch.float32) + 0.5) / R)

    def candidates(nms):
        with profile_postprocess.swapped(post, gaussian_blur_3d, nms):
            m = post.bound_quality(post.mask_quality(qual, tsdf, width, cfg), 0.3 / R, cfg)
            return post.select_grasps_batched(m, rot, width, positions, cfg)

    got, ref = candidates(profile_postprocess.nms_dense), candidates(max_filter_3d)
    assert int(ref.count.sum()) > 0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert post.max_filter_3d is max_filter_3d  # the swap is undone


def test_profile_vgn_fused_head_matches_shipped():
    net, _ = get_network("vgn")
    net = reference_init(net, 0).eval()
    grid = torch.from_numpy(np.random.RandomState(0).rand(40, 40, 40).astype(np.float32))
    assert profile_vgn.fused_qual_error(net, grid) <= profile_vgn.TOL_FUSED
