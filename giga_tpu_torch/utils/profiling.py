"""Structured timing + device profiling (counterpart of
giga_tpu/utils/profiling.py).

  * ``Timer``: named host wall-clock sections with summary statistics. A
    section around card work measures the card only if it ends in a
    synchronizing call (a fetch, ``torch.cuda.synchronize()``): CUDA launches
    return before the work is done.
  * ``stage``: context manager recording into the process-wide Timer.
  * ``device_trace``: a ``torch.profiler`` trace of the host and the card,
    written as a Chrome trace (Perfetto, chrome://tracing).
  * ``annotate``: a named host range visible inside that trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Iterator


class Timer:
    """Accumulates named wall-clock sections."""

    def __init__(self):
        self.records = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        out = {}
        for name, times in self.records.items():
            arr = sorted(times)
            n = len(arr)
            out[name] = {
                "count": n,
                "total": sum(arr),
                "mean": sum(arr) / n,
                "median": arr[n // 2],
                "min": arr[0],
                "max": arr[-1],
            }
        return out

    def report(self) -> str:
        lines = [f"{'section':<32}{'count':>7}{'mean ms':>10}{'median ms':>11}{'total s':>9}"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:<32}{s['count']:>7}{s['mean'] * 1e3:>10.3f}"
                f"{s['median'] * 1e3:>11.3f}{s['total']:>9.2f}"
            )
        return "\n".join(lines)

    def reset(self):
        self.records.clear()


GLOBAL_TIMER = Timer()


def stage(name: str):
    """Record a section into the process-wide timer."""
    return GLOBAL_TIMER.section(name)


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[object]:
    """Trace the host and, where there is one, the card with
    ``torch.profiler`` while the block runs; yields the profiler (its
    ``key_averages()`` sum the kernels by name) and writes
    ``<logdir>/trace.json`` on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def annotate(name: str):
    """A named range for host code, visible inside device traces."""
    import torch

    return torch.profiler.record_function(name)
