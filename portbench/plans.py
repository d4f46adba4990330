"""What the planning cells share: served grasp lists as arrays, and their
comparison with the plain reference."""

from __future__ import annotations

import numpy as np


def grasp_arrays(grasps, scores) -> dict:
    """A served (grasps, scores) pair as arrays: metric positions, xyzw
    quaternions, metric widths, scores."""
    k = len(grasps)
    quats = [g.pose.rotation.as_quat() for g in grasps]
    return {"pos": np.array([g.pose.translation for g in grasps], np.float64).reshape(k, 3),
            "quat": np.array(quats, np.float64).reshape(k, 4),
            "width": np.array([g.width for g in grasps], np.float64),
            "score": np.asarray(scores, np.float64).reshape(k)}


def make_planner(config: dict, device, root):
    """The port's GIGAPlanner of a configuration, its weights loaded."""
    from giga_tpu_torch.inference.planner import GIGAPlanner
    from giga_tpu_torch.models.registry import load_network

    s = config["planner"]
    net, cfg = load_network(root / config["weights"], config["model_type"])
    return GIGAPlanner(net=net, model_cfg=cfg, best=s["best"],
                       force_detection=s["force_detection"], qual_th=s["qual_th"],
                       out_th=s["out_th"], low_th=s["low_th"], resolution=s["resolution"],
                       size=s["size"], max_grasps=s["max_grasps"],
                       precision=config["precision"], device=device)


def sample_with_longest(sampled, longest) -> list:
    """A reservoir's (scene, grasps, scores) items, with the list that held
    the most grasps, as (scene, arrays)."""
    picked = list(sampled.items)
    if longest is not None and all(i is not longest for i in picked):
        picked.append(longest)
    return [(scene, grasp_arrays(g, sc)) for scene, g, sc in picked]


def check(run, tf32: bool = False) -> dict:
    """{number: value} of a run's sample (``run.sample``: (scene, arrays))
    against the reference's plans of the same pool scenes; with ``tf32``, the
    reference computed in TF32 is judged in the program's place."""
    from portbench.reference.giga import GigaReference
    from portbench.reference.judge import plan_gaps
    from portbench.reference.planner import grasp_arrays as ref_arrays
    from portbench.reference.planner import plan

    s = run.settings
    weights = run.root / run.config["weights"]
    scenes = sorted({scene for scene, _ in run.sample})
    plans = dict(zip(scenes, plan(GigaReference(weights, run.device), run.pool[scenes], s)))
    if tf32:
        control = GigaReference(weights, run.device, tf32=True)
        ctl = dict(zip(scenes, plan(control, run.pool[scenes], s)))
        answers = [(scene, ref_arrays(ctl[scene], s)) for scene, _ in run.sample]
    else:
        answers = run.sample
    gaps = np.array([plan_gaps(a, plans[scene], s) for scene, a in answers]
                    or [(np.inf, np.inf)])
    return {"score_gap": float(gaps[:, 0].max()), "pose_gap": float(gaps[:, 1].max()),
            "compared": len(answers), "grasps": int(sum(len(a["score"]) for _, a in answers))}


def free_card() -> None:
    """Collect what the program left and return the card's cached memory."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
