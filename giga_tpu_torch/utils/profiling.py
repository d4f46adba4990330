"""The program's tracer: named spans and counts at its layer boundaries, on
the clock of a ``torch.profiler`` trace (counterpart of
giga_tpu/utils/profiling.py).

Tracing is on exactly while a ``torch.profiler`` profile runs in the
process (``torch.autograd.profiler._is_profiler_enabled``): the
benchmark's traced stretch, ``device_trace`` below, or an operator's own
profiler. Nothing else switches it.

  * ``span(name, call=None, **counts)``: a context manager around one step
    of a layer. With tracing off it is the shared ``OFF``, which records and
    allocates nothing. With tracing on it opens a host range named ``name``
    in the profiler's timeline (so the Chrome trace shows it, beside the
    kernels it launched) and, on exit, appends a ``Span`` record: name,
    start and end (``time.perf_counter_ns()``), the id of the enclosing span
    on the same thread, ``call`` (the number shared by the spans of one
    batch, from ``next_call()``) and its counts. ``span.count(...)`` adds
    counts known only at the end; a span is true and ``OFF`` false, so a
    count that costs work is computed under ``if s:``.
  * ``spans()``: the finished records, oldest first; clears them.
  * ``host.gc``: each of Python's collections while tracing is on is a span
    of its own (counts ``generation`` and ``collected``), nested in the span
    it interrupted.
  * ``device_trace(logdir)``: the operator's exporter. Wrap a serving loop
    in it to get ``<logdir>/trace.json`` (Perfetto, chrome://tracing) with
    the program's spans among the kernels, then read ``spans()``.

The spans of one call are siblings, with no enclosing span per call: a
top-level host range is what a reader of the trace sees. A profile records
host ranges only on the threads it covers; a thread started before it
(PlannerService's worker) shows in its events only if it profiles every
thread (``device_trace`` does), but its ``spans()`` records are kept
either way. The host range is the profiler's fast record function: a
``torch.profiler.record_function`` would add a device-side annotation
range, which a reader of the trace's device events would count as device
work.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from pathlib import Path
from typing import Iterator

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["OFF", "Span", "device_trace", "next_call", "span", "spans"]


class Span:
    """A finished span: ``parent`` is the id of the span that was open on the
    same thread when it began (None at the top level), ``call`` the number
    shared by the spans of one call."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "call", "thread", "counts")

    def __init__(self, name: str, call, counts: dict):
        self.id = next(_ids)
        self.name, self.call, self.counts = name, call, counts
        self.parent = self.start_ns = self.end_ns = None
        self.thread = threading.get_ident()


class _Off:
    """The span of untraced code: enters, leaves and counts nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def count(self, **counts) -> None:
        pass


OFF = _Off()

_ids = itertools.count(1)
_calls = itertools.count(1)
_local = threading.local()
_lock = threading.RLock()
_records: list = []


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _On:
    """An open span of traced code."""

    __slots__ = ("record", "_range")

    def __init__(self, name: str, call, counts: dict):
        self.record = Span(name, call, counts)
        self._range = _RecordFunctionFast(name)

    def __enter__(self):
        self._range.__enter__()
        stack = _stack()
        rec = self.record
        rec.parent = stack[-1] if stack else None
        stack.append(rec.id)
        rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        _stack().pop()
        self._range.__exit__(None, None, None)
        with _lock:
            _records.append(rec)
        return False

    def __bool__(self) -> bool:
        return True

    def count(self, **counts) -> None:
        self.record.counts.update(counts)


def span(name: str, call: int | None = None, **counts):
    """A span named ``name`` while tracing is on, else ``OFF``."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    return _On(name, call, counts)


def next_call() -> int:
    """A new number for the spans of one call (unique in the process)."""
    return next(_calls)


def spans() -> list:
    """The finished span records, by start; the store is emptied."""
    global _records
    fresh = []
    with _lock:
        out, _records = _records, fresh
    out.sort(key=lambda r: r.start_ns)
    return out


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a collection that starts while tracing is on
    becomes a ``host.gc`` span on the collecting thread."""
    if phase == "start":
        if _autograd_profiler._is_profiler_enabled:
            open_gc = _On("host.gc", None, {"generation": info["generation"]})
            open_gc.__enter__()
            _local.gc = open_gc
    else:
        open_gc = getattr(_local, "gc", None)
        if open_gc is not None:
            _local.gc = None
            open_gc.count(collected=info["collected"])
            open_gc.__exit__(None, None, None)


if _on_gc not in gc.callbacks:
    gc.callbacks.append(_on_gc)


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[object]:
    """Trace the host and, where there is one, the card with
    ``torch.profiler`` on every thread while the block runs (tracing on, so
    the program's spans are recorded); yields the profiler (its
    ``key_averages()`` sum the kernels and spans by name) and writes
    ``<logdir>/trace.json`` on exit."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
