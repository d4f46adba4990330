"""What the per-layer metrics read of the program's own tracer
(``giga_tpu_torch.utils.profiling``): its span records of a run's traced
stretch (the program's clock, ``time.perf_counter_ns``), and the device's
idle time inside and outside the host ranges those spans open in the
stretch's trace (the profiler's clock). A reader gives None where the
program recorded no span, as a program without the tracer does."""

from __future__ import annotations

from bisect import bisect_left

from portbench.trace import idle_share


def _stretch(run):
    stretch = getattr(run, "stretch", None)
    return stretch if stretch is not None and stretch.t1 is not None else None


def _take(run) -> list:
    """The program's records that began inside the traced stretch, or []."""
    stretch = _stretch(run)
    if stretch is None:
        return []
    from giga_tpu_torch.utils import profiling

    take = getattr(profiling, "spans", None)
    if take is None:
        return []
    lo, hi = stretch.t0 * 1e9, stretch.t1 * 1e9
    return [r for r in take() if lo <= r.start_ns < hi]


def records(run) -> list:
    """The run's span records, taken from the program once a run (taking
    them empties the program's store) and kept as ``run.program_spans``."""
    if getattr(run, "program_spans", None) is None:
        run.program_spans = _take(run)
    return run.program_spans


def mean_ms(run, name: str) -> float | None:
    """The mean length (ms) of the spans named ``name``, or None."""
    times = [(r.end_ns - r.start_ns) * 1e-6 for r in records(run) if r.name == name]
    return sum(times) / len(times) if times else None


def gc_ms_per_s(run) -> float | None:
    """The ms of Python's collections (``host.gc`` spans, clipped to the
    stretch) per second of the traced stretch; None without any span."""
    spans, stretch = records(run), _stretch(run)
    if not spans or stretch is None:
        return None
    lo, hi = stretch.t0 * 1e9, stretch.t1 * 1e9
    ns = sum(max(0.0, min(r.end_ns, hi) - max(r.start_ns, lo))
             for r in spans if r.name == "host.gc")
    return ns * 1e-6 / stretch.window_s


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_in_spans_s(stretch, names) -> float:
    """The device's idle time (s) inside the top-level host ranges named in
    ``names``, within the stretch's first and last event: the ranges'
    union less the device's busy intervals."""
    named = _merged((max(s, stretch.begin_us), min(e, stretch.end_us))
                    for n, s, e in stretch.host if n in names and e > s)
    busy = stretch.busy_intervals()
    starts = [s for s, _ in busy]
    total = 0.0
    for s, e in named:
        if e <= s:
            continue
        covered = 0.0
        i = max(0, bisect_left(starts, s) - 1)
        while i < len(busy) and busy[i][0] < e:
            covered += max(0.0, min(e, busy[i][1]) - max(s, busy[i][0]))
            i += 1
        total += (e - s) - covered
    return total * 1e-6


def unnamed_idle_share(run) -> float | None:
    """The share (%) of the traced stretch with the device idle and no span
    of the program open: the device's idle share less its idle time inside
    the program's top-level host ranges. None without a span, or without a
    device operation in the stretch."""
    spans, stretch = records(run), _stretch(run)
    share = idle_share(run)
    if not spans or share is None:
        return None
    inside = idle_in_spans_s(stretch, {r.name for r in spans})
    return share - 100.0 * inside / stretch.window_s
