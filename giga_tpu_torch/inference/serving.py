"""Production serving: micro-batching grasp-planning service (counterpart
of giga_tpu/inference/serving.py).

The reference serves one scene per ``VGNImplicit.__call__`` (reference:
detection_implicit.py:33-85) — fine for a single robot cell, but a fleet or
a simulation farm wants the batched program. This module turns the batched
planner into a service: callers submit single TSDF grids from any thread
and get ``Future``s back; a worker thread packs requests into fixed-size
batches, runs ONE batched program per batch, and resolves each request with
exactly what ``planner.plan_batch`` returns for that scene.

Decisions:
- **Fixed batch shape.** Partial batches are padded (repeating the last
  grid) so every load level runs the same shapes (and the same cuDNN
  algorithms), whatever the occupancy.
- **Lag-1 pipelining.** The program only queues CUDA work, and each
  batch's copy to host memory is queued right behind it with an event;
  batch k+1 is queued before the host waits for batch k's event (the only
  wait on the card), so the card runs batch k+1 while the host turns batch
  k into Grasp objects.
- **Adaptive micro-batching.** The worker waits at most ``max_wait_ms`` for
  the batch to fill; under light load requests still see bounded latency,
  under heavy load batches run full (best scenes/s).

Tracing (utils/profiling.py): each worker iteration is a ``service.gather``
span (counts ``requests``, ``padded``), then for a batch a
``service.dispatch`` span (stack, upload, program, queued fetch) and, when
it drains, a ``service.resolve`` span (the event wait, the conversion, the
futures; ``grasps``), tied by the batch's ``call`` number.

Lifecycle contract: every accepted submit() resolves — with a result, the
batch's exception, or CancelledError if the caller cancelled before the
batch was packed. close() drains already-queued work (so no accepted future
is orphaned) and then stops the worker; submissions racing with close()
either complete or raise, never hang.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from queue import Empty, Full, Queue

import numpy as np
import torch

from giga_tpu_torch.inference.postprocess import GraspCandidates
from giga_tpu_torch.utils.profiling import next_call, span

__all__ = ["PlannerService", "ServiceStats", "fetch_async"]


@dataclass
class ServiceStats:
    """Aggregate counters (read via PlannerService.stats())."""

    requests: int = 0
    batches: int = 0
    padded_slots: int = 0
    errors: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def snapshot(self) -> dict:
        with self._lock:
            occ = (
                self.requests / (self.requests + self.padded_slots)
                if self.requests
                else 0.0
            )
            return {
                "requests": self.requests,
                "batches": self.batches,
                "mean_batch_occupancy": occ,
                "errors": self.errors,
            }


def fetch_async(cands: GraspCandidates):
    """Queue the copy of a program's candidates to (pinned) host memory right
    behind the program that makes them; returns the host tensors and the
    event that marks them ready (None on the CPU). A plain ``.cpu()`` at
    drain time would queue behind the next batch's program and wait for it."""
    host = GraspCandidates(*(t.to("cpu", non_blocking=True) for t in cands))
    if cands.scores.device.type != "cuda":
        return host, None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(cands.scores.device))
    return host, ready


def _fail(fut: Future, exc: Exception):
    """set_exception tolerant of a concurrent cancel()."""
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


class PlannerService:
    """Micro-batching front-end over a GIGAPlanner's batched program.

    Args:
        planner: a ``GIGAPlanner`` (its postprocess config, weights and
            precision are served as-is: its batched program is the one
            ``plan_batch`` runs, so results match ``planner.plan_batch``).
        batch_size: device batch B — every batch runs at this shape.
        max_wait_ms: max time the batcher waits for a batch to fill before
            dispatching a padded partial batch.
        queue_depth: submit() raises RuntimeError when this many requests
            are pending (backpressure instead of unbounded memory growth).

    Usage::

        svc = PlannerService(planner, batch_size=64)
        fut = svc.submit(tsdf)            # from any thread
        grasps, scores = fut.result()
        svc.close()
    """

    def __init__(self, planner, batch_size: int = 64, max_wait_ms: float = 2.0,
                 queue_depth: int = 1024):
        self.planner = planner
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) * 1e-3
        self.queue_depth = int(queue_depth)
        self._queue: Queue = Queue(maxsize=queue_depth)
        self._stats = ServiceStats()
        self._vfn = planner._ensure_batched_fn()
        self._closed = False
        self._close_lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._run, name="giga-planner-service", daemon=True
        )
        self._worker.start()

    # -- client surface ----------------------------------------------------

    def submit(self, tsdf_grid) -> Future:
        """Queue one (R, R, R) (or (1, R, R, R)) TSDF; resolves to
        (grasps, scores) exactly as the single-scene planner returns them.

        Raises RuntimeError when the service is closed or the queue is at
        queue_depth (backpressure), ValueError on a wrong grid shape.
        """
        grid = np.asarray(tsdf_grid, np.float32)
        grid = grid.reshape(grid.shape[-3:])
        R = self.planner.planner_cfg.resolution
        if grid.shape != (R, R, R):
            # reject here, not in the worker: a bad grid batched with good
            # requests would otherwise fail the whole batch
            raise ValueError(f"expected ({R}, {R}, {R}) TSDF, got {grid.shape}")
        fut: Future = Future()
        # the lock orders submit against close(): once close() flips _closed
        # under the lock, nothing new can enter the queue, so the worker's
        # final drain cannot strand an accepted future
        with self._close_lock:
            if self._closed:
                raise RuntimeError("PlannerService is closed")
            try:
                self._queue.put_nowait((grid, fut))
            except Full:
                raise RuntimeError(
                    f"PlannerService queue full ({self.queue_depth} pending)"
                ) from None
        return fut

    def plan(self, tsdf_grid, timeout: float | None = None):
        """Synchronous convenience wrapper around submit()."""
        return self.submit(tsdf_grid).result(timeout=timeout)

    def stats(self) -> dict:
        return self._stats.snapshot()

    def close(self, timeout: float | None = 30.0):
        """Drain already-queued requests, then stop the worker. Idempotent.

        If the device wedges mid-fetch the join can time out; the daemon
        worker then dies with the process rather than blocking exit.
        """
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        self._worker.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker ------------------------------------------------------------

    def _gather_batch(self):
        """Block briefly for the first request, then fill up to batch_size
        within the max_wait deadline."""
        try:
            first = self._queue.get(timeout=0.1)
        except Empty:
            return []
        items = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(items) < self.batch_size:
            budget = deadline - time.monotonic()
            try:
                items.append(self._queue.get(timeout=max(budget, 0.0)))
            except Empty:
                break
        return items

    def _dispatch(self, items):
        """One padded batch queued on the card, its fetch to host memory
        queued right behind it; returns (fetch, items, pad)."""
        grids = [g for g, _ in items]
        pad = self.batch_size - len(grids)
        if pad:
            grids = grids + [grids[-1]] * pad
        batch = torch.from_numpy(np.stack(grids)).to(self.planner.device)
        return fetch_async(self._vfn(batch, batch)), items, pad

    def _resolve(self, fetch, items, call: int):
        """Wait for a batch's fetch (the wait on the card) and resolve futures."""
        with span("service.resolve", call) as s:
            cands, ready = fetch
            if ready is not None:
                ready.synchronize()
            host = GraspCandidates(*(t.numpy() for t in cands))
            grasps = 0
            for i, (_, fut) in enumerate(items):
                result = self.planner._to_grasps(GraspCandidates(*(x[i] for x in host)))
                grasps += len(result[0])
                fut.set_result(result)
            if s:
                s.count(grasps=grasps)

    def _drain_one(self, pending: deque):
        fetch, batch_items, call = pending.popleft()
        try:
            self._resolve(fetch, batch_items, call)
        except Exception as e:  # noqa: BLE001 — fail the batch, not the service
            with self._stats._lock:
                self._stats.errors += len(batch_items)
            for _, fut in batch_items:
                if not fut.done():
                    _fail(fut, e)

    def _run(self):
        pending: deque = deque()  # lag-1: at most one un-fetched batch
        while True:
            stopping = self._stop.is_set()
            call = next_call()
            with span("service.gather", call) as s:
                items = self._gather_batch()
                # transition accepted futures to RUNNING; a future whose caller
                # cancelled before packing is dropped here (and its waiters
                # notified) — afterwards cancel() can no longer race set_result
                live = [(g, f) for g, f in items
                        if f.set_running_or_notify_cancel()]
                if s:
                    s.count(requests=len(live),
                            padded=self.batch_size - len(live) if live else 0)
            if live:
                try:
                    with span("service.dispatch", call):
                        fetch, _, pad = self._dispatch(live)
                    pending.append((fetch, live, call))
                    with self._stats._lock:
                        self._stats.requests += len(live)
                        self._stats.batches += 1
                        self._stats.padded_slots += pad
                except Exception as e:  # noqa: BLE001
                    with self._stats._lock:
                        self._stats.errors += len(live)
                    for _, fut in live:
                        _fail(fut, e)
            # lag-1 drain: keep one dispatched batch in flight while more
            # work is queued (overlaps device compute + fetch with the next
            # dispatch); fetch immediately when the queue is idle so light
            # load sees no extra latency. Dispatch failures above fall
            # through here, so a pending batch is never stranded.
            while pending and (stopping or len(pending) > 1
                               or self._queue.empty()):
                self._drain_one(pending)
            if stopping and not pending and self._queue.empty():
                return
