"""The port's tracer (utils/profiling.py) and the spans at its layer
boundaries, on the CPU: off without a profiler; under one, the spans of
``plan_batch``, ``generate_meshes`` and PlannerService's worker, their
counts and call numbers, the host ranges they open in the profiler's events,
and Python's collections as ``host.gc`` spans."""

import gc
import sys
import threading
import time
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

from giga_tpu_torch.geometry.generation import MeshGenerator
from giga_tpu_torch.inference.planner import GIGAPlanner
from giga_tpu_torch.inference.serving import PlannerService
from giga_tpu_torch.models.registry import load_network
from giga_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

PLANNER = ("planner.upload", "planner.enqueue", "planner.fetch", "planner.convert")
MESHGEN = ("meshgen.upload", "meshgen.enqueue", "meshgen.fetch", "meshgen.marching")
SERVICE = ("service.gather", "service.dispatch", "service.resolve")


@pytest.fixture(scope="module")
def scenes():
    return chip_smoke.make_scenes(3, seed=5)


@pytest.fixture(scope="module")
def planner():
    net, cfg = load_network(REPO / chip_smoke.CHECKPOINT, "giga")
    return GIGAPlanner(net=net, model_cfg=cfg, size=chip_smoke.SIZE, device="cpu",
                       **chip_smoke.PLANNER_KW)


@pytest.fixture(autouse=True)
def no_records():
    profiling.spans()
    yield
    profiling.spans()


def _program(records) -> list:
    """The records of the program's spans: collections left out."""
    return [r for r in records if r.name != "host.gc"]


def _traced(fn):
    """(fn's result, the profiler's events, the span records) of fn run
    under a CPU profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events(), profiling.spans()


def _top_level(events, prefix: str) -> list:
    return [e.name for e in sorted(events, key=lambda e: e.time_range.start)
            if e.cpu_parent is None and e.name.startswith(prefix)]


def test_span_is_the_shared_no_op_without_a_profiler(planner, scenes):
    assert profiling.span("planner.upload", 1, bytes=4) is profiling.OFF
    with profiling.span("x") as s:
        assert not s
        s.count(grasps=3)
    planner.plan_batch(scenes[:2])
    assert profiling.spans() == []


def test_plan_batch_emits_its_four_spans_per_call(planner, scenes):
    B, R = 2, scenes.shape[-1]
    out, events, records = _traced(lambda: [planner.plan_batch(scenes[:B]) for _ in range(2)])
    records = _program(records)
    assert [r.name for r in records] == list(PLANNER) * 2
    assert _top_level(events, "planner.") == list(PLANNER) * 2
    for k in range(2):
        call = records[4 * k: 4 * k + 4]
        assert len({r.call for r in call}) == 1 and all(r.parent is None for r in call)
        assert all(a.end_ns <= b.start_ns for a, b in zip(call, call[1:]))
        upload, enqueue, _, convert = call
        assert upload.counts == {"bytes": B * R ** 3 * 4, "pinned": False}
        # the CPU runs the kernels' plain versions, which launch nothing
        assert enqueue.counts == {"scenes": B, "k1": 0, "k2": 0, "k6": 0}
        assert convert.counts == {"scenes": B, "grasps": sum(len(g) for g, _ in out[k])}
    assert records[0].call != records[4].call


def test_generate_meshes_emits_its_four_spans(scenes):
    net, _ = load_network(REPO / chip_smoke.GEO_CHECKPOINT, "giga_geo")
    gen = MeshGenerator(net, resolution0=8, upsampling_steps=1, device="cpu")
    meshes, events, records = _traced(lambda: gen.generate_meshes(scenes))
    records = _program(records)
    assert [r.name for r in records] == list(MESHGEN)
    assert _top_level(events, "meshgen.") == list(MESHGEN)
    assert len({r.call for r in records}) == 1
    marching = records[-1]
    assert marching.counts == {
        "meshes": len(scenes), "vertices": sum(len(m.vertices) for m in meshes),
        "faces": sum(len(m.faces) for m in meshes), "fallbacks": 0}
    assert marching.counts["faces"] > 0
    assert records[0].counts == {"bytes": scenes.nbytes}


@pytest.mark.parametrize("precision,k2", [("fp32", 1), ("bf16", 0)])
def test_meshgen_enqueue_counts_k2_launches(scenes, monkeypatch, precision, k2):
    """``meshgen.enqueue``'s ``k2``: the K2 launches of the call, read from
    ``dense_decode_batched.launches`` (one a batched band program on K2, none
    on the module path). On the CPU the wrapper runs its plain version and
    counts nothing, so a counting stand-in takes its place here."""
    from giga_tpu_torch.geometry import generation

    real = generation.dense_decode_batched

    def counting(*args, **kw):
        counting.launches += 1
        return real(*args, **kw)

    counting.launches = 0
    monkeypatch.setattr(generation, "dense_decode_batched", counting)
    net, _ = load_network(REPO / chip_smoke.GEO_CHECKPOINT, "giga_geo")
    gen = MeshGenerator(net, resolution0=8, upsampling_steps=1, precision=precision,
                        device="cpu")
    _, _, records = _traced(lambda: gen.generate_meshes(scenes))
    (enqueue,) = [r for r in records if r.name == "meshgen.enqueue"]
    assert enqueue.counts == {"k2": k2}
    assert counting.launches == k2


def test_service_spans_come_from_its_worker(planner, scenes, tmp_path):
    with PlannerService(planner, batch_size=2, max_wait_ms=20.0) as svc:
        with profiling.device_trace(tmp_path) as prof:
            time.sleep(0.3)  # the worker's untraced wait for work (0.1 s) ends
            results = [f.result(timeout=60) for f in [svc.submit(g) for g in scenes]]
    records = _program(profiling.spans())
    worker = {r.thread for r in records}
    assert worker and threading.get_ident() not in worker and len(worker) == 1
    names = [r.name for r in records]
    assert set(SERVICE) <= set(names)
    gathers = [r for r in records if r.name == "service.gather" and r.counts["requests"]]
    assert sum(r.counts["requests"] for r in gathers) == len(scenes)
    assert sum(r.counts["padded"] for r in gathers) == 2 * len(gathers) - len(scenes)
    resolves = [r for r in records if r.name == "service.resolve"]
    assert {r.call for r in resolves} == {r.call for r in gathers}
    assert {r.call for r in records if r.name == "service.dispatch"} == {r.call for r in gathers}
    assert sum(r.counts["grasps"] for r in resolves) == sum(len(g) for g, _ in results)
    assert set(SERVICE) <= {e.name for e in prof.events()}
    assert (tmp_path / "trace.json").exists()


def test_a_collection_inside_a_span_is_its_child():
    def work():
        with profiling.span("outer", call=profiling.next_call()) as s:
            gc.collect()
        return s.record

    outer, events, records = _traced(work)
    forced = [r for r in records if r.name == "host.gc" and r.counts["generation"] == 2]
    assert len(forced) == 1 and forced[0].parent == outer.id
    assert forced[0].counts["collected"] >= 0
    assert outer.start_ns <= forced[0].start_ns <= forced[0].end_ns <= outer.end_ns
    assert "outer" in {e.cpu_parent.name for e in events
                       if e.name == "host.gc" and e.cpu_parent is not None}


def test_spans_clears_and_orders_by_start():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a", 1):
            with profiling.span("b", 1, n=2) as inner:
                pass
    a, b = _program(profiling.spans())
    assert (a.name, b.name) == ("a", "b") and b.parent == a.id and a.parent is None
    assert inner.record is b and b.counts == {"n": 2}
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns
    assert profiling.spans() == []


def test_no_collection_is_recorded_untraced():
    gc.collect()
    assert profiling.spans() == []


def test_a_collection_that_outlasts_the_profile_is_closed(monkeypatch):
    """A collection begun while tracing is on ends its span after tracing
    has stopped; one begun after it records nothing."""
    gc.disable()  # no collection of the interpreter's own in between
    try:
        monkeypatch.setattr(profiling._autograd_profiler, "_is_profiler_enabled", True)
        profiling._on_gc("start", {"generation": 1})
        monkeypatch.undo()
        profiling._on_gc("stop", {"generation": 1, "collected": 3})
        profiling._on_gc("start", {"generation": 0})
        profiling._on_gc("stop", {"generation": 0, "collected": 0})
    finally:
        gc.enable()
    (r,) = profiling.spans()
    assert r.name == "host.gc" and r.counts == {"generation": 1, "collected": 3}
