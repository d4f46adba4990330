"""A torch.profiler trace of a steady stretch of the window, reduced to
what the per-layer metrics read: the device's busy time, each kernel's
time by name, the device operations that took most time and the longest
idle gaps of the device with what the host was doing in them.

Only the stretch is traced, so the trace stays small and the rest of the
window runs without the profiler's cost.
"""

from __future__ import annotations

import time
from collections import defaultdict


class Stretch:
    """A traced stretch of ``seconds``: ``step`` starts and stops it inside a
    window; then the readings."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.prof = None
        self.t0 = self.t1 = None
        self.kernels = []   # (name, start_us, end_us) of device operations
        self.host = []      # (name, start_us, end_us) of top-level host operations
        self.begin_us = self.end_us = None

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        loads and initializes the device tracer, which takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities):
            torch.ones(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)

    def step(self, now: float, start_at: float, stop_by: float = float("inf")) -> None:
        """Start at ``start_at``; stop ``seconds`` later or at ``stop_by``."""
        if self.t0 is None:
            if now >= start_at:
                self.start()
        elif self.t1 is None and (now >= self.t0 + self.seconds or now >= stop_by):
            self.stop()

    def finish(self) -> None:
        """Stop the stretch if the window closed before it ran its length."""
        if self.t0 is not None and self.t1 is None:
            self.stop()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        for e in self.prof.events():
            span = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                self.kernels.append(span)
            elif e.cpu_parent is None:
                self.host.append(span)
        self.prof = None
        starts = [s for _, s, _ in self.kernels + self.host]
        ends = [e for _, _, e in self.kernels + self.host]
        if starts:
            # the trace's clock: the stretch spans its first to its last event
            self.begin_us, self.end_us = min(starts), max(ends)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list:
        """The device's busy time as disjoint (start_us, end_us) intervals."""
        merged = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_times_s(self, match) -> list:
        """Durations (s) of the device operations whose name ``match`` accepts."""
        return [(e - s) * 1e-6 for name, s, e in self.kernels if match(name)]

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds], ...]: the device operations that took most time."""
        total = defaultdict(float)
        for name, s, e in self.kernels:
            total[name] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host was doing, seconds], ...]: the longest stretches
        with no device operation, named by the top-level host operation that
        overlaps each most ("host" where none does)."""
        if self.begin_us is None:
            return []
        gaps, prev = [], self.begin_us
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.end_us > prev:
            gaps.append((prev, self.end_us))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        out = []
        for gs, ge in gaps:
            best, name = 0.0, "host"
            for hn, hs, he in self.host:
                ov = min(ge, he) - max(gs, hs)
                if ov > best:
                    best, name = ov, hn
            out.append([name, (ge - gs) * 1e-6])
        return out


def mean_kernel_s(run, kernel) -> float | None:
    """Mean time (s) of a kernel (portbench/frozen/kernels.py) in a run's
    traced stretch, or None where the stretch holds none."""
    from portbench.frozen.kernels import matches

    stretch = getattr(run, "stretch", None)
    if stretch is None or stretch.t1 is None:
        return None
    times = stretch.kernel_times_s(lambda name: matches(name, kernel))
    return sum(times) / len(times) if times else None


def idle_share(run) -> float | None:
    """The share (%) of a run's traced stretch with no device operation,
    or None where the stretch holds no device operation."""
    stretch = getattr(run, "stretch", None)
    if stretch is None or stretch.t1 is None or not stretch.kernels:
        return None
    return 100.0 * max(0.0, 1.0 - stretch.busy_s / stretch.window_s)
