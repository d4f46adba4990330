"""Single-round clutter removal with per-step world snapshots (counterpart
of giga_tpu/experiments/clutter_removal_single.py; reference:
src/vgn/experiments/clutter_removal_single.py:22-97).

Like the main benchmark but runs ONE round with the simulator's periodic
mesh-pose pickling enabled (BtWorld save_dir/save_freq), producing the
state stream consumed by offline rollout rendering. The simulator fuses
its scans on ``device`` (the card unless the caller passes ``"cpu"``).
"""

from __future__ import annotations

import os

from giga_tpu_torch.core.grasp import Label
from giga_tpu_torch.inference.planner import State
from giga_tpu_torch.sim.simulation import ClutterRemovalSim

MAX_CONSECUTIVE_FAILURES = 2


def run(
    grasp_plan_fn,
    save_dir,
    scene: str,
    object_set: str,
    num_objects: int = 5,
    n: int = 6,
    N=None,
    seed: int = 1,
    sim_gui: bool = False,
    add_noise=False,
    sideview: bool = False,
    resolution: int = 40,
    save_freq: int = 8,
    urdf_root: str = "data/urdfs",
    device=None,
):
    """One round; returns (successes, attempts, total_objects)."""
    os.makedirs(save_dir, exist_ok=True)
    sim = ClutterRemovalSim(
        scene, object_set, gui=sim_gui, seed=seed, add_noise=add_noise,
        sideview=sideview, save_dir=save_dir, save_freq=save_freq,
        urdf_root=urdf_root, device=device,
    )
    attempts = success = 0
    sim.reset(num_objects)
    total_objs = sim.num_objects
    consecutive_failures = 1
    last_label = None

    while sim.num_objects > 0 and consecutive_failures < MAX_CONSECUTIVE_FAILURES:
        tsdf, pc, _ = sim.acquire_tsdf(n=n, N=N, resolution=40)
        state = State(tsdf=tsdf, pc=pc)
        if resolution != 40:
            extra_tsdf, _, _ = sim.acquire_tsdf(n=n, N=N, resolution=resolution)
            state = State(tsdf=tsdf, pc=pc, tsdf_process=extra_tsdf)
        if len(pc) == 0:
            break

        grasps, scores, _ = grasp_plan_fn(state)
        if len(grasps) == 0:
            break

        label, _ = sim.execute_grasp(grasps[0], allow_contact=True)
        attempts += 1
        if label != Label.FAILURE:
            success += 1

        if last_label == Label.FAILURE and label == Label.FAILURE:
            consecutive_failures += 1
        else:
            consecutive_failures = 1
        last_label = label

    return success, attempts, total_objs
