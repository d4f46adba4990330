#!/usr/bin/env python3
"""Geometry reconstruction evaluation on a dataset's scenes (counterpart of
scripts/eval_geometry.py; reference scripts/eval_geometry_voxel.py).

    python3 -m giga_tpu_torch.scripts.eval_geometry --model-path CKPT
        --type giga_geo --dataset PROCESSED --dataset_raw RAW [--roi]
        [--batch 8] [--device cuda]

Run from the repository root. The mesh generator (geometry/generation.py)
reconstructs each scene from its TSDF on the card (``--device`` None) or
where ``--device`` says, ``--batch`` scenes a dispatch; each mesh is compared
with the scene's ground-truth mesh: occupancy IoU, Chamfer-L1, normal
accuracy, F-score at 1 %, and with ``--roi`` the occupancy of the gripper
regions (of the mesh and of the decoder's own logits). Writes
``<logdir>/<stamp>_eval_geo_.../<idx>/results.json`` a scene, the meshes,
and ``mean_results.json``: the JAX script's files, from the same draws of
one seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from datetime import datetime
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def main(args) -> Path:
    """Evaluate as ``args`` (the parsed flags) say; returns the log directory."""
    from giga_tpu_torch.geometry.datasets import GeometryEvalDataset, GeometryEvalDatasetROI
    from giga_tpu_torch.geometry.eval import MeshEvaluator, compute_iou
    from giga_tpu_torch.geometry.generation import MeshGenerator
    from giga_tpu_torch.models.registry import load_network

    stamp = datetime.now().strftime("%y-%m-%d-%H-%M-%S")
    logdir = args.logdir / (f"{stamp}_eval_geo_dataset={args.dataset.name},net={args.type},"
                            f"th={args.th}")
    logdir.mkdir(parents=True, exist_ok=True)

    net, _ = load_network(args.model_path, args.type)
    generator = MeshGenerator(net, threshold=args.th, resolution0=args.resolution0,
                              upsampling_steps=args.upsampling_steps,
                              precision=getattr(args, "precision", "fp32"),
                              device=getattr(args, "device", None))
    rng = np.random.RandomState(args.seed)
    kind = GeometryEvalDatasetROI if args.roi else GeometryEvalDataset
    dataset = kind(args.dataset, args.dataset_raw, num_point_occ=args.num_point_occ, rng=rng)
    evaluator = MeshEvaluator(rng=rng)

    mean_keys = ["iou", "chamfer-L1", "normals accuracy", "f-score"]
    if args.roi:
        mean_keys += ["iou_ROI", "precision_ROI", "recall_ROI",
                      "iou_ROI_infer", "precision_ROI_infer", "recall_ROI_infer"]
    mean_dict = {k: [] for k in mean_keys}

    def batched_meshes():
        """(idx, dataset item, predicted mesh), ``--batch`` scenes a
        dispatch (MeshGenerator.generate_meshes), items read lazily in the
        JAX script's order (their draws interleave with the evaluation's)."""
        bs = max(1, args.batch)
        for start in range(0, len(dataset), bs):
            idxs = range(start, min(start + bs, len(dataset)))
            items = [dataset[i] for i in idxs]
            if bs == 1:
                preds = [generator.generate_mesh(items[0][0], return_stats=False)]
            else:
                preds = generator.generate_meshes(
                    np.stack([np.squeeze(np.asarray(it[0], np.float32)) for it in items]))
            yield from zip(idxs, items, preds)

    for idx, item, pred_mesh in batched_meshes():
        if args.roi:
            tsdf, points_occ, occ, roi_points, occ_roi, gt_mesh = item
        else:
            tsdf, points_occ, occ, gt_mesh = item
        gt_mesh.vertices = gt_mesh.vertices / dataset.size - 0.5
        pts_tgt, _, normals_tgt = gt_mesh.sample_surface(evaluator.n_points, rng=rng,
                                                         return_normals=True)
        out = evaluator.eval_mesh(pred_mesh, pts_tgt.astype(np.float32), normals_tgt,
                                  points_occ, occ)
        if args.roi and "empty" not in out:
            out.update(evaluator.eval_occ(pred_mesh, roi_points, occ_roi, ext="_ROI"))
            if args.batch > 1:  # the batched path caches no scene's planes
                generator.encode(tsdf)
            logits = generator.eval_occ_logits(roi_points.astype(np.float32))
            occ_pred = 1.0 / (1.0 + np.exp(-logits)) > args.th
            out["iou_ROI_infer"] = float(compute_iou(occ_pred, occ_roi))
            out["precision_ROI_infer"] = float(
                np.logical_and(occ_pred, occ_roi).sum() / max(occ_pred.sum(), 1))
            out["recall_ROI_infer"] = float(
                np.logical_and(occ_pred, occ_roi).sum() / max(occ_roi.sum(), 1))

        save_dir = logdir / f"{idx:05d}"
        save_dir.mkdir()
        if "empty" not in out:
            for k in mean_keys:
                if out.get(k, -np.inf) >= -1e5:
                    mean_dict[k].append(out[k])
            gt_mesh.export(save_dir / "gt_mesh.obj")
            pred_mesh.export(save_dir / "pred_mesh.obj")
        else:
            print(f"{idx} empty mesh!")
        with open(save_dir / "results.json", "w") as f:
            json.dump({k: float(v) for k, v in out.items()}, f, indent=4)

    print("Geometry prediction results:")
    summary = {"model_path": str(Path(args.model_path).resolve())}
    for k, v in mean_dict.items():
        summary[k] = float(np.mean(v)) if v else float("nan")
        print(f"{k}: {summary[k]:.6f}")
    with open(logdir / "mean_results.json", "w") as f:
        json.dump(summary, f, indent=4)
    return logdir


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--type", type=str, default="giga")
    parser.add_argument("--dataset", type=Path, required=True)
    parser.add_argument("--dataset_raw", type=Path, required=True)
    parser.add_argument("--logdir", type=Path, default=Path("data/eval_geo"))
    parser.add_argument("--roi", action="store_true")
    parser.add_argument("--th", type=float, default=0.5)
    parser.add_argument("--num-point-occ", type=int, default=100000)
    parser.add_argument("--resolution0", type=int, default=32)
    parser.add_argument("--upsampling-steps", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--batch", type=int, default=8,
                        help="scenes reconstructed per device dispatch")
    parser.add_argument("--precision", choices=["fp32", "bf16"], default="fp32",
                        help="bf16 runs the occupancy decode in bf16")
    parser.add_argument("--device", type=str, default=None,
                        help="where the generator runs (default: the card)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from giga_tpu_torch.sim.noise import set_random_seed

    args = parse_args()
    set_random_seed(args.seed)
    main(args)
