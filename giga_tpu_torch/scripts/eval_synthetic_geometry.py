#!/usr/bin/env python3
"""Reconstruction quality of a GIGA-Geo checkpoint on held-out synthetic
scenes: IoU / Chamfer-L1 / normal consistency / F-score against ground
truth (counterpart of scripts/eval_synthetic_geometry.py).

    python3 -m giga_tpu_torch.scripts.eval_synthetic_geometry CHECKPOINT
        [--n-scenes 16] [--seed 2000] [--resolution0 32]
        [--upsampling-steps 2] [--device cuda]

Run from the repository root. Scenes come from utils/synthetic.random_scene,
ground-truth occupancy and point clouds from the scene mesh itself, the
prediction from geometry/generation.MeshGenerator on the card (``device``
None) or where ``device`` says. All geometry is compared in the normalized
[-0.5, 0.5]^3 frame. The same seed draws the same scenes and samples as the
JAX package's script.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def evaluate_geo_checkpoint(params_path, n_scenes=16, seed=2000, size=0.3, resolution0=32,
                            upsampling_steps=2, net_name="giga_geo", n_eval_points=100000,
                            device=None):
    """Mean metrics over ``n_scenes`` scenes."""
    from giga_tpu_torch.geometry.eval import MeshEvaluator
    from giga_tpu_torch.geometry.generation import MeshGenerator
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.utils.synthetic import make_occ_samples, mesh_to_tsdf, random_scene

    net, _ = load_network(params_path, net_name)
    gen = MeshGenerator(net, resolution0=resolution0, upsampling_steps=upsampling_steps,
                        device=device)
    ev = MeshEvaluator(n_points=n_eval_points, rng=np.random.RandomState(0))
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n_scenes):
        gt = random_scene(rng, size)
        tsdf = mesh_to_tsdf(gt, size, 40, rng=rng)
        pred, _ = gen.generate_mesh(tsdf)
        gt_n = gt.copy().apply_scale(1.0 / size).apply_translation([-0.5] * 3)
        pc_tgt, fidx = gt_n.sample_surface(n_eval_points, rng=np.random.RandomState(1))
        normals_tgt = gt_n.face_normals[fidx]
        pts, occ = make_occ_samples(gt, size, n_eval_points, rng)
        pts_n = (pts / size - 0.5).astype(np.float32)
        rows.append(ev.eval_mesh(pred, pc_tgt.astype(np.float32), normals_tgt, pts_n,
                                 occ.astype(bool)))
    keys = [k for k, v in rows[0].items() if np.isscalar(v) or np.ndim(v) == 0]
    return {k: float(np.mean([r[k] for r in rows])) for k in keys}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("params", type=str)
    ap.add_argument("--n-scenes", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2000)
    ap.add_argument("--net", type=str, default="giga_geo")
    ap.add_argument("--resolution0", type=int, default=32)
    ap.add_argument("--upsampling-steps", type=int, default=2)
    ap.add_argument("--device", type=str, default=None)
    args = ap.parse_args(argv)
    out = evaluate_geo_checkpoint(
        args.params, args.n_scenes, args.seed, net_name=args.net,
        resolution0=args.resolution0, upsampling_steps=args.upsampling_steps,
        device=args.device)
    print(json.dumps({k: round(v, 5) for k, v in out.items()}, indent=1))


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    main()
