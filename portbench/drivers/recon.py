"""Batch reconstruction with the port's MeshGenerator: batches of scenes
meshed back to back, as an evaluation over a dataset of scenes runs.

Traffic parameters (portbench/traffic/<name>.json): ``pool`` (scenes drawn
from the seed in set-up), ``min_objects``/``max_objects``, ``batch_size``
(scenes a ``generate_meshes`` call), ``warmup_batches``, ``sample``
(meshes compared with the reference, besides the one with the most
vertices) and ``trace_seconds``. Batch j holds pool scenes 8j .. 8j + 7
(mod pool), for a batch size of 8.

The window runs whole batches: it closes when the batch that passes
``--seconds`` returns, so its rate takes all the work and all the time.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.frozen.scenes import make_pool
from portbench.plans import free_card
from portbench.phases import Phases
from portbench.sample import Reservoir
from portbench.trace import Stretch


class Run:
    """One run of the cell: ``setup``, ``measure``, ``release``, ``check``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, trace: bool, root):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.root = seed, device, root
        self.settings = config["generator"]
        self.stretch = Stretch(traffic["trace_seconds"]) if trace else None

    def setup(self) -> None:
        from giga_tpu_torch.geometry.generation import MeshGenerator
        from giga_tpu_torch.models.registry import load_network

        tr, g = self.traffic, self.settings
        self.phases = Phases()
        net, _ = load_network(self.root / self.config["weights"], self.config["model_type"])
        self.gen = MeshGenerator(net, threshold=g["threshold"], resolution0=g["resolution0"],
                                 upsampling_steps=g["upsampling_steps"], strategy=g["strategy"],
                                 precision=self.config["precision"], device=self.device)
        self.phases.mark("weights and program")
        self.pool, _ = make_pool(self.seed, tr["pool"], g["resolution"], g["size"],
                                 tr["min_objects"], tr["max_objects"], device=self.device)
        self.phases.mark("scenes")
        if self.stretch is not None:
            self.stretch.warm()
            self.phases.mark("profiler")
        self.batch = 0
        for i in range(tr["warmup_batches"]):
            self._generate()
            self.phases.mark("first batch" if i == 0 else "warm-up")

    def _generate(self):
        B, n = self.traffic["batch_size"], len(self.pool)
        scenes = [(self.batch * B + i) % n for i in range(B)]
        self.batch += 1
        return scenes, self.gen.generate_meshes(self.pool[scenes])

    def measure(self, seconds: float) -> None:
        import torch

        tr = self.traffic
        cuda = torch.cuda.is_available() and self.stretch is not None
        self.sampled = Reservoir(tr["sample"], np.random.default_rng([self.seed, 1]))
        self.longest = (-1, None)
        self.meshes, self.failed, self.marching_s, self.events = 0, 0, [], []
        t0 = time.perf_counter()
        t1 = t0 + seconds
        trace_at = t0 + max(0.0, (seconds - tr["trace_seconds"]) / 2)
        while True:
            now = time.perf_counter()
            if self.stretch is not None:
                self.stretch.step(now, trace_at)
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                self.gen.marks = []
            scenes, meshes = self._generate()
            if cuda:
                self.events.append((start, self.gen.marks))
            for scene, mesh, stats in zip(scenes, meshes, self.gen.batch_stats):
                self.meshes += 1
                self.marching_s.append(stats.get("time (marching cubes)", 0.0))
                item = (scene, mesh)
                self.sampled.offer(item)
                if len(mesh.vertices) > self.longest[0]:
                    self.longest = (len(mesh.vertices), item)
            end = time.perf_counter()
            if end >= t1:
                break
        if self.stretch is not None:
            self.stretch.finish()
        self.gen.marks = None
        self.window_s = end - t0
        self.completed = self.meshes
        self.attempted = self.meshes
        # per batch: the program from the event before the call to the band's mark
        self.program_s = [start.elapsed_time(marks[-1][1]) * 1e-3
                          for start, marks in self.events if marks]

    def release(self) -> None:
        """Free the program's state on the card."""
        picked = list(self.sampled.items)
        if self.longest[1] is not None and all(i is not self.longest[1] for i in picked):
            picked.append(self.longest[1])
        self.sample = [(scene, np.asarray(m.vertices), np.asarray(m.faces)) for scene, m in picked]
        del self.gen, self.sampled, self.longest, self.events
        free_card()

    def check(self, tf32: bool = False) -> dict:
        """{number: value} of the sampled meshes against the reference's
        occupancy on the same lattice (with ``tf32``, the reference computed
        in TF32 and triangulated by the reference's marching is judged in
        the program's place)."""
        from portbench.reference.giga import GigaReference
        from portbench.reference.judge import mesh_gaps
        from portbench.reference.marching import march
        from portbench.reference.recon import occupancy

        g = self.settings
        n = g["resolution0"] * 2 ** g["upsampling_steps"] + 1
        iso = float(np.log(g["threshold"]) - np.log(1.0 - g["threshold"]))
        box = 1.0 + g["padding"]
        ref = GigaReference(self.root / self.config["weights"], self.device)
        if tf32:
            control = GigaReference(self.root / self.config["weights"], self.device, tf32=True)
        gaps = []
        for scene, verts, faces in self.sample:
            values = occupancy(ref, self.pool[scene], n, box)
            if tf32:
                v, faces = march(np.pad(occupancy(control, self.pool[scene], n, box), 1,
                                        constant_values=g["pad"]), iso)
                verts = box * ((v - 1.0) / (n - 1) - 0.5)
            gaps.append(mesh_gaps(verts, faces, values, iso, box, g["pad"]))
        gaps = np.array(gaps or [(np.inf, np.inf)])
        return {"vertex_gap": float(gaps[:, 0].max()), "face_gap": float(gaps[:, 1].max()),
                "compared": len(self.sample),
                "vertices": int(sum(len(v) for _, v, _ in self.sample))}
