"""The readers of the program's spans (portbench/spans.py and the metrics
built on it) on a hand-made traced stretch: device operations, top-level
host ranges and span records given by hand, with every answer worked out
to the microsecond; then the records taken from the program itself, and a
traced run of the plan cell on the CPU."""

import time
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import run as harness
from portbench.spans import idle_in_spans_s, records
from portbench.tests.small import PLAN, RECON, ROOT, run_small
from portbench.trace import Stretch, idle_share

T0 = 1000.0  # the stretch's start on the host clock, s
WINDOW_US = 10_000
KERNELS = [("k2", 1000, 3000), ("copy", 2500, 4000), ("k1", 6000, 7000)]
HOST = [("planner.upload", 0, 1500), ("planner.enqueue", 1500, 2000),
        ("planner.fetch", 2000, 3800), ("planner.convert", 4000, 5000),
        ("host.gc", 8000, 8500), ("aten::to", 9000, 9500)]
# the span records: (name, start, end) in us from the stretch's start
SPANS = [("planner.upload", 0, 1500), ("planner.enqueue", 1500, 2000),
         ("planner.fetch", 2000, 3800), ("planner.convert", 4000, 5000),
         ("planner.convert", 9990, 10_990), ("host.gc", 8000, 8500),
         ("host.gc", 9800, 10_300)]


def _record(name, s_us, e_us):
    ns = T0 * 1e9
    return SimpleNamespace(name=name, start_ns=ns + s_us * 1e3, end_ns=ns + e_us * 1e3)


def _run(spans=SPANS, kernels=KERNELS, host=HOST):
    stretch = Stretch(WINDOW_US * 1e-6)
    stretch.t0, stretch.t1 = T0, T0 + WINDOW_US * 1e-6
    stretch.begin_us, stretch.end_us = 0, WINDOW_US
    stretch.kernels, stretch.host = list(kernels), list(host)
    return SimpleNamespace(stretch=stretch, program_spans=[_record(*s) for s in spans])


def _read(name, run):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py").read(run)


def _brute_force_us(run, names):
    """(idle us, idle us outside every named host range), counted a us at a time."""
    idle = unnamed = 0
    for t in range(WINDOW_US):
        if any(s <= t < e for _, s, e in run.stretch.kernels):
            continue
        idle += 1
        unnamed += not any(n in names and s <= t < e for n, s, e in run.stretch.host)
    return idle, unnamed


@pytest.mark.parametrize("metric", ["plan.idle_unnamed", "recon.idle_unnamed"])
def test_unnamed_idle_is_the_idle_time_outside_every_span(metric):
    run = _run()
    idle, unnamed = _brute_force_us(run, {s[0] for s in SPANS})
    assert (idle, unnamed) == (6000, 3500)
    share = _read(metric, run)
    assert share * WINDOW_US / 100 == pytest.approx(unnamed, abs=1)
    inside = idle_in_spans_s(run.stretch, {s[0] for s in SPANS})
    assert inside * 1e6 == pytest.approx(idle - unnamed, abs=1)
    assert share + 100 * inside / run.stretch.window_s == pytest.approx(idle_share(run),
                                                                        abs=1e-9)


def test_the_mean_span_a_batch():
    run = _run()
    assert _read("planner.upload_ms", run) == pytest.approx(1.5)
    assert _read("planner.enqueue_ms", run) == pytest.approx(0.5)
    assert _read("planner.convert_ms", run) == pytest.approx(1.0)


@pytest.mark.parametrize("metric", ["plan.gc_ms", "recon.gc_ms"])
def test_collections_are_summed_over_the_stretch(metric):
    # 0.5 ms inside, and 0.2 of the one that outlasts the stretch, in 10 ms
    assert _read(metric, _run()) == pytest.approx(0.7 / 0.01)
    assert _read(metric, _run(spans=SPANS[:4])) == 0.0


@pytest.mark.parametrize("metric", ["planner.upload_ms", "planner.enqueue_ms",
                                    "planner.convert_ms", "plan.gc_ms", "plan.idle_unnamed",
                                    "recon.gc_ms", "recon.idle_unnamed"])
def test_a_run_without_spans_reads_none(metric):
    assert _read(metric, _run(spans=[])) is None
    assert _read(metric, SimpleNamespace(stretch=None)) is None


def test_a_stretch_without_device_operations_has_no_unnamed_idle():
    assert _read("plan.idle_unnamed", _run(kernels=[])) is None


def test_records_are_taken_from_the_program_once_a_run():
    from giga_tpu_torch.utils import profiling

    profiling.spans()
    stretch = Stretch(1.0)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("before"):
            pass
        stretch.t0 = time.perf_counter()
        with profiling.span("planner.upload", profiling.next_call(), bytes=8):
            pass
        stretch.t1 = time.perf_counter()
        with profiling.span("after"):
            pass
    run = SimpleNamespace(stretch=stretch)
    assert [r.name for r in records(run) if r.name != "host.gc"] == ["planner.upload"]
    assert records(run) is run.program_spans and profiling.spans() == []
    assert _read("planner.upload_ms", run) > 0


@pytest.mark.parametrize("name,spans", [(PLAN, ("planner.upload_ms", "planner.enqueue_ms",
                                                "planner.convert_ms", "plan.gc_ms")),
                                        (RECON, ("recon.gc_ms",))])
def test_a_traced_run_reads_the_programs_spans(name, spans):
    """On the CPU the trace holds no device operation: the span readers
    give numbers, the unnamed idle share is left out."""
    # a window long enough that a batch slowed by a busy host still leaves
    # one whole batch inside the traced stretch
    result = run_small(name, seconds=12.0, trace=True)
    assert result["correct"] and "breakdown" in result
    assert set(spans) <= set(result["metrics"])
    assert not {"plan.idle_unnamed", "recon.idle_unnamed"} & set(result["metrics"])
