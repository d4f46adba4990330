"""Fleet planning of giga_grid through ``GIGAPlanner.plan_batch``: the run
of the ``plan`` traffic kind (portbench/drivers/plan.py: the same traffic
parameters, batches and window), judged against the grid reference
(portbench/reference/giga_grid.py). A traced run also keeps, for every
batch of its window, the batched program's stage marks
(``GIGAPlanner.marks``, CUDA events at the program's start and at each
stage's end) as ``stage_s``: {stage: [seconds a batch]}, a stage running
from the mark before it to its own. A program without the marks leaves
``stage_s`` empty.
"""

from __future__ import annotations

import numpy as np

from portbench.drivers import plan


def stage_seconds(batches) -> dict:
    """{stage: [seconds, one a batch]} of each batch's [(name, event), ...]."""
    out = {}
    for marks in batches:
        for (_, before), (name, event) in zip(marks, marks[1:]):
            out.setdefault(name, []).append(before.elapsed_time(event) * 1e-3)
    return out


def mean_stage_ms(run, stages) -> float | None:
    """The mean time (ms) a batch from the mark before ``stages[0]`` to the
    mark ``stages[-1]`` (consecutive stages), over the traced window's
    batches; None where the run kept no such marks."""
    stage_s = getattr(run, "stage_s", None) or {}
    times = [stage_s.get(name) for name in stages]
    if not all(times):
        return None
    return 1e3 * sum(sum(t) / len(t) for t in times)


class Run(plan.Run):
    """One run of the cell: ``setup``, ``measure``, ``release``, ``check``."""

    def __init__(self, *args):
        super().__init__(*args)
        self.stage_marks = None  # each batch's marks, while a traced window runs
        self.stage_s = {}

    def _plan(self):
        if self.stage_marks is None:
            return super()._plan()
        self.planner.marks = []
        out = super()._plan()
        self.stage_marks.append(self.planner.marks)
        return out

    def measure(self, seconds: float) -> None:
        if self.stretch is not None:
            self.stage_marks = []
        super().measure(seconds)
        # the window's last fetch waited for the card, so every event is done
        self.stage_s = stage_seconds(self.stage_marks or [])
        self.stage_marks = self.planner.marks = None

    def check(self, tf32: bool = False) -> dict:
        """{number: value} of the run's sample (``run.sample``: (scene,
        arrays)) against the grid reference's plans of the same pool scenes;
        with ``tf32``, the reference computed in TF32 is judged in the
        program's place (``portbench/plans.py``'s ``check``, on the grid
        reference)."""
        from portbench.reference.giga_grid import GridReference
        from portbench.reference.judge import plan_gaps
        from portbench.reference.planner import grasp_arrays as ref_arrays
        from portbench.reference.planner import plan as ref_plan

        s = self.settings
        weights, padding = self.root / self.config["weights"], self.config["model"]["padding"]
        scenes = sorted({scene for scene, _ in self.sample})
        ref = GridReference(weights, self.device, padding=padding)
        plans = dict(zip(scenes, ref_plan(ref, self.pool[scenes], s)))
        if tf32:
            control = GridReference(weights, self.device, tf32=True, padding=padding)
            ctl = dict(zip(scenes, ref_plan(control, self.pool[scenes], s)))
            answers = [(scene, ref_arrays(ctl[scene], s)) for scene, _ in self.sample]
        else:
            answers = self.sample
        gaps = np.array([plan_gaps(a, plans[scene], s) for scene, a in answers]
                        or [(np.inf, np.inf)])
        return {"score_gap": float(gaps[:, 0].max()), "pose_gap": float(gaps[:, 1].max()),
                "compared": len(answers),
                "grasps": int(sum(len(a["score"]) for _, a in answers))}
