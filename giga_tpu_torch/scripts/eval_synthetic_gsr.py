#!/usr/bin/env python3
"""Multi-scene synthetic grasp-success rate (GSR) of a trained checkpoint
(counterpart of scripts/eval_synthetic_gsr.py).

    python3 -m giga_tpu_torch.scripts.eval_synthetic_gsr CHECKPOINT [CHECKPOINT ...]
        [--n-scenes 8] [--top-k 5] [--seed 1000] [--precision fp32|bf16]
        [--ensemble-combine mean|max] [--net giga] [--device cuda]

Run from the repository root. Plans on fresh synthetic scenes
(utils/synthetic.random_scene) with GIGAPlanner.__call__ and scores the top
grasps of each with the geometric oracle (utils/synthetic_grasps
.evaluate_grasp): a deterministic, simulator-free stand-in for the GSR
benchmark. Several checkpoints plan as an inference-time ensemble. The
planner draws from RandomState(0), the scenes, their surface samples and
the oracle from RandomState(seed), in the JAX package's order, so one seed
gives the same scenes and draws in both packages. The planner runs on the
card (``device`` None) or where ``device`` says.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
PLANNER_KW = dict(best=True, force_detection=True, low_th=0.1)


def make_planner(net_name: str = "giga", params=None, net=None, qual_th: float = 0.8,
                 precision: str = "fp32", ensemble_combine: str = "mean", device=None):
    """The protocol's GIGAPlanner: ``params`` a flax tree (or a list of them,
    an ensemble), or a loaded ``net``."""
    from giga_tpu_torch.inference.planner import GIGAPlanner
    from giga_tpu_torch.models.registry import get_network

    if net is None:
        net, cfg = get_network(net_name)
    else:
        cfg = net.cfg
    return GIGAPlanner(net=net if params is None else None, model_cfg=cfg, params=params,
                       model_type=net_name, qual_th=qual_th, rng=np.random.RandomState(0),
                       precision=precision, ensemble_combine=ensemble_combine, device=device,
                       **PLANNER_KW)


def evaluate_planner(planner, n_scenes: int = 8, top_k: int = 5, seed: int = 1000,
                     record: list | None = None) -> dict:
    """The protocol on a ready planner -> {gsr, n_grasps,
    median_surface_dist_mm, mean_candidates}. With ``record`` a list, one
    row (scene, position (3,), quaternion xyzw (4,), width, label) is
    appended for each scored grasp."""
    from scipy.spatial import cKDTree

    from giga_tpu_torch.inference.planner import State
    from giga_tpu_torch.utils.synthetic import mesh_to_tsdf, random_scene
    from giga_tpu_torch.utils.synthetic_grasps import evaluate_grasp

    rng = np.random.RandomState(seed)
    labels_all, dists_all, counts = [], [], []
    for scene in range(n_scenes):
        mesh = random_scene(rng, 0.3)
        tsdf = mesh_to_tsdf(mesh, 0.3, 40, rng=rng)
        grasps, _, _ = planner(State(tsdf=tsdf[None]))
        counts.append(len(grasps))
        surf, _ = mesh.sample_surface(20000, rng=rng)
        tree = cKDTree(surf)
        for g in grasps[:top_k]:
            label = evaluate_grasp(mesh, surf, g.pose, rng)[0]
            labels_all.append(label)
            dists_all.append(float(tree.query(g.pose.translation)[0]))
            if record is not None:
                record.append((scene, g.pose.translation, g.pose.rotation.as_quat(), g.width,
                               float(label)))
    return {
        "gsr": 100.0 * np.mean(labels_all) if labels_all else 0.0,
        "n_grasps": len(labels_all),
        "median_surface_dist_mm": (float(np.median(dists_all)) * 1e3 if dists_all
                                   else float("nan")),
        "mean_candidates": float(np.mean(counts)),
    }


def evaluate_checkpoint(params_path, n_scenes=8, top_k=5, seed=1000, qual_th=0.8,
                        precision="fp32", ensemble_combine="mean", net="giga", device=None):
    """GSR of a checkpoint (``.msgpack``) or of an ensemble, a list of them."""
    from giga_tpu_torch.models.checkpoint import load_params

    if isinstance(params_path, (list, tuple)) and len(params_path) == 1:
        params_path = params_path[0]
    if isinstance(params_path, (list, tuple)):
        # K checkpoints -> inference-time ensemble (mean quality / aligned
        # quaternion mean; see planner.build_ensemble_giga_planner_fn)
        params = [load_params(p) for p in params_path]
    else:
        params = load_params(params_path)
    planner = make_planner(net, params, qual_th=qual_th, precision=precision,
                           ensemble_combine=ensemble_combine, device=device)
    return evaluate_planner(planner, n_scenes, top_k, seed)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("params", type=str, nargs="+",
                        help="checkpoint path(s); >1 evaluates the inference-time ensemble")
    parser.add_argument("--n-scenes", type=int, default=8)
    parser.add_argument("--top-k", type=int, default=5)
    parser.add_argument("--seed", type=int, default=1000)
    parser.add_argument("--precision", choices=["fp32", "bf16"], default="fp32",
                        help="planner trunk precision")
    parser.add_argument("--ensemble-combine", choices=["mean", "max"], default="mean",
                        help="K-member combiner: mean (blend) or max (union-of-peaks; "
                             "per-voxel winner's rot/width)")
    parser.add_argument("--net", type=str, default="giga",
                        help="model preset the checkpoint was trained with")
    parser.add_argument("--device", type=str, default=None,
                        help="where the planner runs (default: the card)")
    args = parser.parse_args(argv)
    out = evaluate_checkpoint(args.params, args.n_scenes, args.top_k, args.seed,
                              precision=args.precision,
                              ensemble_combine=args.ensemble_combine, net=args.net,
                              device=args.device)
    print(out)


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    main()
