"""The batched planning program's stage marks (``GIGAPlanner.marks``) and
the ``k1``/``k2``/``k6`` counts of ``plan_batch``'s ``planner.enqueue``
span, on the CPU: the marks change no candidate, record nothing without a
card and come in stage order, K6's program too; the counts read each
call's K1, K2 and K6 launches (giga 1, 1 and 0, giga_grid 0, 0 and 1)."""

import sys
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from giga_tpu_torch.inference import planner as planner_mod
from giga_tpu_torch.inference.planner import GIGAPlanner
from giga_tpu_torch.models.registry import load_network
from giga_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

GRID_WEIGHTS = REPO / "checkpoints" / "seeded_giga_grid_0.msgpack"
STAGES = ["start", "encode", "features", "decode", "post"]


@pytest.fixture(scope="module")
def scenes():
    return chip_smoke.make_scenes(2, seed=5)


def _planner(model_type: str) -> GIGAPlanner:
    path = GRID_WEIGHTS if model_type == "giga_grid" else REPO / chip_smoke.CHECKPOINT
    net, cfg = load_network(path, model_type)
    return GIGAPlanner(net=net, model_cfg=cfg, size=chip_smoke.SIZE, device="cpu",
                       **chip_smoke.PLANNER_KW)


@pytest.fixture(scope="module")
def grid_planner():
    return _planner("giga_grid")


def _flat(out):
    return [(np.array([g.pose.to_list() for g in grasps]), np.asarray(scores))
            for grasps, scores in out]


def test_marks_change_no_candidate_and_stay_empty_on_the_cpu(grid_planner, scenes):
    assert grid_planner.marks is None
    assert grid_planner._ensure_batched_fn().paths == {"encode": "module", "decode": "K6"}
    plain = _flat(grid_planner.plan_batch(scenes))
    grid_planner.marks = []
    try:
        marked = _flat(grid_planner.plan_batch(scenes))
        assert grid_planner.marks == []
    finally:
        grid_planner.marks = None
    assert len(plain) == len(scenes) and sum(len(s) for _, s in plain) > 0
    for (pa, sa), (pb, sb) in zip(plain, marked):
        assert np.array_equal(pa, pb) and np.array_equal(sa, sb)


def test_the_program_marks_its_stages_in_order(grid_planner, scenes, monkeypatch):
    """A recorder stands in for the CUDA event (the CPU records none)."""
    def recorder(marks, name, device):
        if marks is not None:
            marks.append((name, device.type))

    monkeypatch.setattr(planner_mod, "mark", recorder)
    grid_planner.marks = []
    try:
        grid_planner.plan_batch(scenes)
        assert grid_planner.marks == [(name, "cpu") for name in STAGES]
    finally:
        grid_planner.marks = None


@pytest.mark.parametrize("model_type,k1,k2", [("giga", 1, 1), ("giga_grid", 0, 0)])
def test_enqueue_counts_k1_and_k2_launches(scenes, monkeypatch, model_type, k1, k2,
                                           grid_planner):
    """On the CPU the kernels' wrappers run their plain versions and count
    nothing, so counting stand-ins take their place where the program
    calls them, each counting on the real wrapper's ``launches``. K6 runs
    for giga_grid alone."""
    from giga_tpu_torch.models import encoder
    from giga_tpu_torch.ops.kernels import decoder, grid_decode

    k6 = int(model_type == "giga_grid")
    for module, name in ((encoder, "stem_pool_batched"), (decoder, "dense_decode_batched"),
                         (grid_decode, "grid_decode_batched")):
        real = getattr(module, name)
        monkeypatch.setattr(real, "launches", real.launches)

        def counting(*args, _real=real, **kw):
            _real.launches += 1
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, counting)
    planner = grid_planner if model_type == "giga_grid" else _planner("giga")
    profiling.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        planner.plan_batch(scenes)
    (enqueue,) = [r for r in profiling.spans() if r.name == "planner.enqueue"]
    assert enqueue.counts == {"scenes": len(scenes), "k1": k1, "k2": k2, "k6": k6}
