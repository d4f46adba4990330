"""Fleet planning through ``GIGAPlanner.plan_batch``: batches of scans
planned back to back by one caller, as a simulation farm steps its scenes
in lockstep.

Traffic parameters (portbench/traffic/<name>.json): ``pool`` (scenes drawn
from the seed in set-up), ``min_objects``/``max_objects``, ``batch_size``
(scenes a call), ``warmup_batches``, ``sample`` (scenes compared with the
reference, besides the one with the most grasps) and ``trace_seconds``.
Batch j holds pool scenes Bj .. Bj + B - 1 (mod pool).

The window runs whole calls: it closes when the call that passes
``--seconds`` returns, so its rate takes all the work and all the time.
"""

from __future__ import annotations

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

    def setup(self) -> None:
        tr, s = self.traffic, self.settings
        self.phases = Phases()
        self.planner = plans.make_planner(self.config, self.device, self.root)
        self.phases.mark("weights and program")
        self.pool, _ = make_pool(self.seed, tr["pool"], s["resolution"], s["size"],
                                 tr["min_objects"], tr["max_objects"], device=self.device)
        self.phases.mark("scenes")
        if self.stretch is not None:
            self.stretch.warm()
            self.phases.mark("profiler")
        self.batch = 0
        for i in range(tr["warmup_batches"]):
            self._plan()
            self.phases.mark("first batch" if i == 0 else "warm-up")

    def _plan(self):
        B, n = self.traffic["batch_size"], len(self.pool)
        scenes = [(self.batch * B + i) % n for i in range(B)]
        self.batch += 1
        return scenes, self.planner.plan_batch(self.pool[scenes])

    def measure(self, seconds: float) -> None:
        tr = self.traffic
        self.sampled = Reservoir(tr["sample"], np.random.default_rng([self.seed, 1]))
        self.longest = (-1, None)
        self.grasps, self.failed = [], 0
        t0 = time.perf_counter()
        t1 = t0 + seconds
        trace_at = t0 + max(0.0, (seconds - tr["trace_seconds"]) / 2)
        while True:
            now = time.perf_counter()
            if self.stretch is not None:
                self.stretch.step(now, trace_at)
            scenes, results = self._plan()
            for scene, (grasps, scores) in zip(scenes, results):
                self.grasps.append(len(grasps))
                item = (scene, grasps, scores)
                self.sampled.offer(item)
                if len(grasps) > self.longest[0]:
                    self.longest = (len(grasps), item)
            end = time.perf_counter()
            if end >= t1:
                break
        if self.stretch is not None:
            self.stretch.finish()
        self.window_s = end - t0
        self.completed = self.attempted = len(self.grasps)

    def release(self) -> None:
        """Free the program's state on the card."""
        self.sample = plans.sample_with_longest(self.sampled, self.longest[1])
        del self.planner, self.sampled, self.longest
        plans.free_card()

    def check(self, tf32: bool = False) -> dict:
        return plans.check(self, tf32)
