"""Simulated clutter-removal benchmark (counterpart of
giga_tpu/experiments/clutter_removal.py; protocol of reference
src/vgn/experiments/clutter_removal.py:22-245).

Protocol per round: spawn N objects; loop scan -> plan -> execute the first
returned grasp until the table is clear, the planner returns nothing, or two
grasps fail back-to-back. Reported metrics:
    GSR = 100 * successes / attempts
    DR  = 100 * successes / total objects spawned

The simulator fuses its scans on ``device`` (the card unless the caller
passes ``device="cpu"``). Logs are read with the ``csv`` module and numpy
(``core.io.read_csv``), not pandas; ``Data``'s summaries equal pandas' on
the same directory.
"""

from __future__ import annotations

import dataclasses
import uuid
from datetime import datetime
from pathlib import Path

import numpy as np

from giga_tpu_torch.core import io
from giga_tpu_torch.core.grasp import Label
from giga_tpu_torch.inference.planner import State
from giga_tpu_torch.sim.simulation import ClutterRemovalSim

MAX_CONSECUTIVE_FAILURES = 2

GRASP_LOG_COLUMNS = [
    "round_id", "scene_id", "qx", "qy", "qz", "qw", "x", "y", "z",
    "width", "score", "label", "integration_time", "planning_time",
]


@dataclasses.dataclass
class BenchmarkTally:
    """Aggregated counters across rounds."""

    attempts: int = 0
    successes: int = 0
    total_objects: int = 0
    objects_left: int = 0
    aborts_consecutive_failures: int = 0
    aborts_no_grasp: int = 0
    planning_times: list = dataclasses.field(default_factory=list)
    total_times: list = dataclasses.field(default_factory=list)

    @property
    def success_rate(self) -> float:
        return 100.0 * self.successes / max(self.attempts, 1)

    @property
    def declutter_rate(self) -> float:
        return 100.0 * self.successes / max(self.total_objects, 1)


def _scan_scene(sim, n, N, resolution):
    """Acquire planner input from the simulator (40^3 + optional hi-res)."""
    tsdf, pc, t_int = sim.acquire_tsdf(n=n, N=N, resolution=40)
    if resolution == 40:
        return State(tsdf=tsdf, pc=pc), t_int
    extra, _, _ = sim.acquire_tsdf(n=n, N=N, resolution=resolution)
    return State(tsdf=tsdf, pc=pc, tsdf_process=extra), t_int


def _play_round(sim, grasp_plan_fn, logger, round_id, tally, n, N, resolution,
                visualize, object_set):
    """One round of the scan/plan/execute loop."""
    consecutive_failures = 1
    last_label = None
    trial = 0
    while sim.num_objects > 0 and consecutive_failures < MAX_CONSECUTIVE_FAILURES:
        state, t_integration = _scan_scene(sim, n, N, resolution)
        if len(state.pc) == 0:
            break  # nothing visible; give up on the round

        if visualize:
            from giga_tpu_torch.utils.implicit import (
                get_mesh_pose_list_from_world,
                get_scene_from_mesh_pose_list,
            )

            scene_mesh = get_scene_from_mesh_pose_list(
                get_mesh_pose_list_from_world(sim.world, object_set)
            )
            grasps, scores, t_plan, aff_mesh = grasp_plan_fn(state, scene_mesh)
            logger.log_mesh(scene_mesh, aff_mesh, f"round_{round_id:03d}_trial_{trial:03d}")
        else:
            grasps, scores, t_plan = grasp_plan_fn(state)
        tally.planning_times.append(t_plan)
        tally.total_times.append(t_plan + t_integration)

        if not grasps:
            tally.aborts_no_grasp += 1
            break

        label, _ = sim.execute_grasp(grasps[0], allow_contact=True)
        tally.attempts += 1
        tally.successes += int(label != Label.FAILURE)
        logger.log_grasp(round_id, state, t_integration, t_plan, grasps[0], scores[0], label)

        if label == Label.FAILURE and last_label == Label.FAILURE:
            consecutive_failures += 1
        else:
            consecutive_failures = 1
        if consecutive_failures >= MAX_CONSECUTIVE_FAILURES:
            tally.aborts_consecutive_failures += 1
        last_label = label
        trial += 1


def run(
    grasp_plan_fn,
    logdir,
    description: str = "",
    scene: str = "pile",
    object_set: str = "blocks",
    num_objects: int = 5,
    n: int = 6,
    N=None,
    num_rounds: int = 40,
    seed: int = 1,
    sim_gui: bool = False,
    result_path=None,
    add_noise=False,
    sideview: bool = False,
    resolution: int = 40,
    silence: bool = False,
    visualize: bool = False,
    urdf_root: str = "data/urdfs",
    device=None,
):
    """Run the benchmark; returns (success_rate, declutter_rate)."""
    sim = ClutterRemovalSim(
        scene, object_set, gui=sim_gui, seed=seed, add_noise=add_noise,
        sideview=sideview, urdf_root=urdf_root, device=device,
    )
    logger = Logger(Path(logdir), description)
    tally = BenchmarkTally()

    for k in range(num_rounds):
        if not silence:
            print(f"round {k + 1}/{num_rounds}", flush=True)
        sim.reset(num_objects)
        round_id = logger.last_round_id() + 1
        logger.log_round(round_id, sim.num_objects)
        tally.total_objects += sim.num_objects
        _play_round(sim, grasp_plan_fn, logger, round_id, tally, n, N,
                    resolution, visualize, object_set)
        tally.objects_left += sim.num_objects

    print(
        f"Grasp success rate: {tally.success_rate:.2f} %, "
        f"Declutter rate: {tally.declutter_rate:.2f} %"
    )
    print(
        f"Average planning time: {np.mean(tally.planning_times):.4f}s, "
        f"total time: {np.mean(tally.total_times):.4f}s"
    )
    if result_path is not None:
        Path(result_path).write_text(
            f"{tally.success_rate:.2f}%, {tally.declutter_rate:.2f}%; "
            f"{tally.aborts_consecutive_failures}, {tally.aborts_no_grasp}\n"
        )
    return tally.success_rate, tally.declutter_rate


class Logger:
    """Per-run CSVs (rounds, grasps) + compressed scene snapshots."""

    def __init__(self, root: Path, description: str):
        stamp = datetime.now().strftime("%y-%m-%d-%H-%M-%S")
        self.logdir = root / f"{stamp}_{description}".strip("_")
        for sub in ("scenes", "meshes"):
            (self.logdir / sub).mkdir(parents=True, exist_ok=True)
        self.rounds_csv_path = self.logdir / "rounds.csv"
        self.grasps_csv_path = self.logdir / "grasps.csv"
        if not self.rounds_csv_path.exists():
            io.create_csv(self.rounds_csv_path, ["round_id", "object_count"])
        if not self.grasps_csv_path.exists():
            io.create_csv(self.grasps_csv_path, GRASP_LOG_COLUMNS)

    def last_round_id(self) -> int:
        ids = io.read_csv(self.rounds_csv_path, ints=("round_id",))["round_id"]
        return -1 if len(ids) == 0 else int(ids.max())

    def log_round(self, round_id: int, object_count: int) -> None:
        io.append_csv(self.rounds_csv_path, round_id, object_count)

    def log_mesh(self, scene_mesh, aff_mesh, name: str) -> None:
        scene_mesh.export(self.logdir / "meshes" / (name + "_scene.obj"))
        aff_mesh.export(self.logdir / "meshes" / (name + "_aff.obj"))
        # rendered affordance imagery (role of the reference's pyrender
        # offscreen rendering of the composed scene, utils/visual.py)
        from giga_tpu_torch.utils.render import render_mesh_image, save_image

        img = render_mesh_image(aff_mesh)
        save_image(img, self.logdir / "meshes" / (name + "_aff.png"))

    def log_grasp(self, round_id, state, t_integration, t_plan, grasp, score, label) -> None:
        scene_id = uuid.uuid4().hex
        np.savez_compressed(
            self.logdir / "scenes" / (scene_id + ".npz"),
            grid=state.tsdf.get_grid(),
            points=np.asarray(state.pc),
        )
        quat = grasp.pose.rotation.as_quat()
        pos = grasp.pose.translation
        io.append_csv(
            self.grasps_csv_path, round_id, scene_id,
            quat[0], quat[1], quat[2], quat[3], pos[0], pos[1], pos[2],
            grasp.width, score, int(label), t_integration, t_plan,
        )


class Data:
    """Loads and summarizes a benchmark log directory (pandas' results from
    numpy columns)."""

    def __init__(self, logdir: Path):
        self.logdir = Path(logdir)
        self.rounds = io.read_csv(self.logdir / "rounds.csv", ints=("round_id", "object_count"))
        self.grasps = io.read_csv(self.logdir / "grasps.csv", ints=("round_id", "label"))

    def num_rounds(self) -> int:
        return len(self.rounds)

    def num_grasps(self) -> int:
        return len(self.grasps)

    def success_rate(self) -> float:
        return _mean(self.grasps["label"]) * 100

    def percent_cleared(self) -> float:
        # pandas' left join of the per-round label sums onto rounds.csv: a
        # grasp of a round that rounds.csv lacks counts nowhere
        known = np.isin(self.grasps["round_id"], self.rounds["round_id"])
        cleared = float(self.grasps["label"][known].sum())
        return cleared / int(self.rounds["object_count"].sum()) * 100

    def avg_planning_time(self) -> float:
        return _mean(self.grasps["planning_time"])

    def read_grasp(self, i: int):
        scene_id, grasp, label = io.read_grasp(self.grasps, i)
        score = self.grasps["score"][i]
        scene_data = np.load(self.logdir / "scenes" / (scene_id + ".npz"))
        return scene_data["points"], grasp, score, label


def _mean(values) -> float:
    """pandas' mean: NaN for no values."""
    return float(np.mean(values)) if len(values) else float("nan")
