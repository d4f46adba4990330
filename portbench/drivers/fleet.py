"""Fleet planning through the port's PlannerService: a closed loop of
simulated robots, each waiting for its grasps before it sends its next
scan.

Traffic parameters (portbench/traffic/<name>.json): ``robots`` (requests
kept outstanding), ``pool`` (scenes drawn from the seed in set-up),
``min_objects``/``max_objects`` (clutter a scene holds), ``batch_size``
and ``max_wait_ms`` (the service's), ``warmup_requests`` (completions
before the window opens), ``sample`` (requests compared with the
reference, besides the one with the most grasps) and ``trace_seconds``
(the traced stretch of a ``--trace 1`` window).

One client thread keeps ``robots`` requests outstanding: each future's
done-callback hands the finished request back to it, and it sends that
robot's next scan. Robot r's k-th scan is pool scene (r + k) mod pool.
"""

from __future__ import annotations

import queue
import time

import numpy as np

from portbench import plans
from portbench.frozen.scenes import make_pool
from portbench.phases import Phases
from portbench.sample import Reservoir
from portbench.trace import Stretch


class Run:
    """One run of the cell: ``setup``, ``measure``, ``release``, ``check``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, trace: bool, root):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.root = seed, device, root
        self.settings = config["planner"]
        self.stretch = Stretch(traffic["trace_seconds"]) if trace else None

    # -- set-up ------------------------------------------------------------------

    def setup(self) -> None:
        from giga_tpu_torch.inference.serving import PlannerService

        tr, s = self.traffic, self.settings
        self.phases = Phases()
        self.planner = plans.make_planner(self.config, self.device, self.root)
        self.phases.mark("weights and program")
        self.pool, _ = make_pool(self.seed, tr["pool"], s["resolution"], s["size"],
                                 tr["min_objects"], tr["max_objects"], device=self.device)
        self.phases.mark("scenes")
        self.svc = PlannerService(self.planner, batch_size=tr["batch_size"],
                                  max_wait_ms=tr["max_wait_ms"],
                                  queue_depth=max(1024, 2 * tr["robots"]))
        if self.stretch is not None:
            self.stretch.warm()
            self.phases.mark("profiler")
        self.done = queue.SimpleQueue()
        self.outstanding = 0
        for robot in range(tr["robots"]):
            self._submit(robot, 0)
        for i in range(tr["warmup_requests"]):
            robot, k, _, _, _, fut = self._next()
            fut.result()
            self._submit(robot, k + 1)
            if i == tr["batch_size"] - 1:  # the first batch: the kernels' load or build
                self.phases.mark("first batch")
        self.phases.mark("warm-up")

    def _submit(self, robot: int, k: int) -> None:
        scene = (robot + k) % len(self.pool)
        t = time.perf_counter()
        fut = self.svc.submit(self.pool[scene])
        self.outstanding += 1
        done = self.done
        fut.add_done_callback(
            lambda f: done.put((robot, k, scene, t, time.perf_counter(), f)))

    def _next(self):
        item = self.done.get(timeout=120)
        self.outstanding -= 1
        return item

    # -- the window --------------------------------------------------------------

    def measure(self, seconds: float) -> None:
        tr = self.traffic
        self.latencies, self.grasps, self.failed = [], [], 0
        self.sampled = Reservoir(tr["sample"], np.random.default_rng([self.seed, 1]))
        self.longest = (-1, None)
        stats0 = self.svc.stats()
        t0 = time.perf_counter()
        t1 = t0 + seconds
        trace_at = t0 + max(0.0, (seconds - tr["trace_seconds"]) / 2)
        stats1 = None
        while self.outstanding:
            robot, k, scene, t_sub, t_done, fut = self._next()
            now = time.perf_counter()
            if self.stretch is not None:
                self.stretch.step(now, trace_at, t1)
            if now < t1:
                self._submit(robot, k + 1)
            elif stats1 is None:
                stats1 = self.svc.stats()
            if t_done > t1:
                continue
            if fut.exception() is not None:
                self.failed += 1
                continue
            grasps, scores = fut.result()
            self.latencies.append(t_done - t_sub)
            self.grasps.append(len(grasps))
            item = (scene, grasps, scores)
            self.sampled.offer(item)
            if len(grasps) > self.longest[0]:
                self.longest = (len(grasps), item)
        if self.stretch is not None:
            self.stretch.finish()
        stats1 = stats1 or self.svc.stats()
        self.window_s = t1 - t0
        self.completed = len(self.latencies)
        self.attempted = self.completed + self.failed
        self.batches = stats1["batches"] - stats0["batches"]
        self.requests = stats1["requests"] - stats0["requests"]

    def release(self) -> None:
        """Close the service and free the program's state on the card."""
        self.svc.close()
        self.sample = plans.sample_with_longest(self.sampled, self.longest[1])
        del self.svc, self.planner, self.sampled, self.longest
        plans.free_card()

    def check(self, tf32: bool = False) -> dict:
        return plans.check(self, tf32)
