#!/usr/bin/env python3
"""End-to-end learning self-check: synthetic scenes -> train from scratch ->
reconstruct a held-out scene, or plan on it -> gate (counterpart of
scripts/selfcheck_e2e.py).

    python3 -m giga_tpu_torch.scripts.selfcheck_e2e [--mode geo|giga]
        [--n-scenes 24] [--n-occ 8192] [--n-grasps 64] [--batch 8]
        [--batch-occ 1024] [--steps 400] [--iou-threshold 0.5]
        [--gsr-threshold 30] [--planner-qual-th 0.8] [--top-k 10] [--seed 0]
        [--lr 2e-4] [--clip-norm 1.0] [--cosine-lr] [--save-params PATH]
        [--device cuda]

Run from the repository root. ``--mode geo`` trains GIGA-Geo and passes when
the held-out scene's mesh (MeshGenerator, resolution0 20 with one
upsampling step) reaches ``--iou-threshold``; ``--mode giga`` trains full
GIGA and passes when the planner's top ``--top-k`` grasps on the held-out
scene (GIGAPlanner.__call__, the single-scene program) score an oracle GSR
of at least ``--gsr-threshold`` % with a median surface distance under
60 mm. The data, the batch draw (one numpy RandomState, the class-balanced
grasp pick, zero grasp points in geo mode) and the gates are the JAX
script's; the weights start from ``reference_init`` (the JAX package's
``net.init`` rules, drawn from a torch generator, so from the same
distribution and not the same numbers). Each batch is uploaded in one
pinned copy. Training runs on the card unless ``--device`` says otherwise;
times are printed beside the card's name and power limit. Exits 0 on a
pass and 1 on a fail.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

SIZE = 0.3
RESOLUTION = 40


def build_dataset(n_scenes, size, resolution, n_occ, seed):
    """(meshes, TSDFs, occupancy points in [-0.5, 0.5]^3, their labels) of
    ``n_scenes`` random scenes drawn from one RandomState(seed)."""
    from giga_tpu_torch.utils.synthetic import make_occ_samples, mesh_to_tsdf, random_scene

    rng = np.random.RandomState(seed)
    scenes, tsdfs, occ_pts, occ_lbls = [], [], [], []
    for _ in range(n_scenes):
        mesh = random_scene(rng, size)
        scenes.append(mesh)
        tsdfs.append(mesh_to_tsdf(mesh, size, resolution, rng=rng))
        pts, occ = make_occ_samples(mesh, size, n_occ, rng)
        occ_pts.append(pts / size - 0.5)
        occ_lbls.append(occ.astype(np.float32))
    return scenes, np.stack(tsdfs), np.stack(occ_pts), np.stack(occ_lbls)


def build_grasp_labels(scenes, size, n_grasps, seed):
    """Per scene, ``n_grasps`` oracle-labelled grasps as batch arrays, drawn
    from RandomState(seed + 1)."""
    from giga_tpu_torch.utils.synthetic_grasps import grasps_to_batch_arrays, sample_labeled_grasps

    rng = np.random.RandomState(seed + 1)
    per_scene = []
    pos_frac = []
    for mesh in scenes:
        gl = sample_labeled_grasps(mesh, size, n_grasps, rng)
        arrs = grasps_to_batch_arrays(gl, size)
        per_scene.append(arrs)
        pos_frac.append(arrs["label"].mean())
    print(f"grasp labels: {np.mean(pos_frac):.2f} positive fraction")
    return per_scene


def draw_batch(rng, tsdfs, occ_pts, occ_lbls, grasp_data, args) -> dict:
    """One training batch of numpy arrays, drawn from ``rng`` as the JAX
    script draws it: scenes from the first n_scenes - 1, occupancy points
    with replacement, and in giga mode one grasp a scene, positive or
    negative by a fair coin (the reference's clean_balance step)."""
    n_train = args.n_scenes - 1
    idx = rng.randint(0, n_train, args.batch)
    sub = rng.randint(0, args.n_occ, (args.batch, args.batch_occ))
    batch = {
        "tsdf": tsdfs[idx],
        "pos": np.zeros((args.batch, 3), np.float32),
        "pos_occ": occ_pts[idx[:, None], sub],
        "occ": occ_lbls[idx[:, None], sub],
    }
    if grasp_data is not None:
        gsel = [grasp_data[i] for i in idx]
        gi = []
        for g in gsel:
            lbl = g["label"]
            pool = np.nonzero(lbl == (1.0 if rng.rand() < 0.5 else 0.0))[0]
            if len(pool) == 0:
                pool = np.arange(len(lbl))
            gi.append(int(pool[rng.randint(len(pool))]))
        for key in ("pos", "label", "rotations", "width"):
            batch[key] = np.asarray([g[key][k] for g, k in zip(gsel, gi)], np.float32)
    return batch


def train_loop(state, step, data, args, log=print):
    """``args.steps`` steps of ``step`` from ``state`` (a TrainState: the
    port's ``reference_init``, or any weights a caller put there) on
    batches of ``data`` = (tsdfs, occupancy points, labels, grasp arrays or
    None) drawn from RandomState(args.seed). Logs the loss at every 50th
    step and the last (one fetch each). Returns (state, {step: loss})."""
    tsdfs, occ_pts, occ_lbls, grasp_data = data
    rng = np.random.RandomState(args.seed)
    losses = {}
    for it in range(args.steps):
        batch = draw_batch(rng, tsdfs, occ_pts, occ_lbls, grasp_data, args)
        state, terms = step(state, batch)
        if it % 50 == 0 or it == args.steps - 1:
            losses[it] = float(terms["loss_all"])
            msg = f"step {it}: loss {losses[it]:.4f}"
            if grasp_data is not None and "accuracy" not in terms:
                msg += f" qual {float(terms['loss_qual']):.3f}"
            log(msg)
    return state, losses


def make_state(net, args, device):
    """The JAX script's optimizer: Adam at ``args.lr`` (cosine-decayed to 2 %
    over ``args.steps`` with ``--cosine-lr``), global-norm clipping at
    ``args.clip_norm`` (off at 0) and non-finite steps skipped."""
    from giga_tpu_torch.train.trainer import cosine_decay_schedule, create_train_state

    lr = args.lr
    if args.cosine_lr:
        lr = cosine_decay_schedule(args.lr, args.steps, alpha=0.02)
    clip = args.clip_norm if args.clip_norm > 0 else None
    return create_train_state(net, lr=lr, clip_norm=clip, skip_nonfinite=True, device=device)


def main(args) -> int:
    import torch

    from giga_tpu_torch.core.device import resolve_device
    from giga_tpu_torch.models.registry import get_network, reference_init
    from giga_tpu_torch.scripts.profile_batched import card_line
    from giga_tpu_torch.train.trainer import make_train_step

    device = resolve_device(args.device)
    card = card_line(device)
    size = SIZE
    print(f"building {args.n_scenes} synthetic scenes...")
    t0 = time.perf_counter()
    scenes, tsdfs, occ_pts, occ_lbls = build_dataset(
        args.n_scenes, size, RESOLUTION, args.n_occ, args.seed)
    test_mesh, test_tsdf = scenes[-1], tsdfs[-1]

    full_giga = args.mode == "giga"
    grasp_data = build_grasp_labels(scenes, size, args.n_grasps, args.seed) if full_giga else None
    print(f"dataset built in {time.perf_counter() - t0:.2f} s (host)")

    net, cfg = get_network("giga" if full_giga else "giga_geo")
    reference_init(net, args.seed)
    state = make_state(net, args, device)
    step = make_train_step(net, cfg)

    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = train_loop(state, step, (tsdfs, occ_pts, occ_lbls, grasp_data), args,
                          log=lambda m: print(m, flush=True))
    if device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"trained {args.steps} steps in {secs:.1f}s ({secs / max(args.steps, 1) * 1e3:.2f} "
          f"ms a step) | {card}")

    if args.save_params:
        from giga_tpu_torch.models.checkpoint import save_params
        from giga_tpu_torch.models.convert import state_dict_to_flax

        save_params(state_dict_to_flax({k: v.detach().cpu() for k, v in
                                        state.module.state_dict().items()}), args.save_params)
        print(f"saved params to {args.save_params}")

    if full_giga:
        ok, _ = check_planner(state.module, cfg, test_mesh, test_tsdf, size, args, device, card)
    else:
        ok, _ = check_geometry(state.module, test_mesh, test_tsdf, size, args, device)
    return 0 if ok else 1


def check_geometry(net, test_mesh, test_tsdf, size, args, device):
    """Reconstruct the held-out scene and score it (IoU, Chamfer, normals,
    F-score) with the JAX script's evaluation draws. Returns (passed,
    metrics)."""
    from giga_tpu_torch.geometry.eval import MeshEvaluator
    from giga_tpu_torch.geometry.generation import MeshGenerator
    from giga_tpu_torch.geometry.native import check_mesh_contains

    gen = MeshGenerator(net, resolution0=20, upsampling_steps=1, device=device)
    pred_mesh, stats = gen.generate_mesh(test_tsdf)
    print({k: round(v, 3) if isinstance(v, float) else v for k, v in stats.items()})

    gt = test_mesh.copy()
    gt.vertices = gt.vertices / size - 0.5
    ev_rng = np.random.RandomState(0)
    evaluator = MeshEvaluator(n_points=20000, rng=ev_rng)
    pts_tgt, _, normals_tgt = gt.sample_surface(20000, rng=ev_rng, return_normals=True)
    points_iou = ev_rng.uniform(-0.5, 0.5, (20000, 3)).astype(np.float32)
    occ_tgt = check_mesh_contains(gt, points_iou)
    out = evaluator.eval_mesh(pred_mesh, pts_tgt.astype(np.float32), normals_tgt,
                              points_iou, occ_tgt)
    print("held-out scene:", {k: round(float(v), 4) for k, v in out.items() if k != "empty"})
    ok = out["iou"] >= args.iou_threshold
    print(f"SELFCHECK {'PASSED' if ok else 'FAILED'}: IoU {out['iou']:.3f} "
          f"(threshold {args.iou_threshold})")
    return ok, out


def check_planner(net, cfg, test_mesh, test_tsdf, size, args, device, card=""):
    """Plan on the held-out scene and score the top ``args.top_k`` grasps
    with the oracle, the JAX script's draws. Returns (passed, {"grasps"
    (their count), "gsr", "median_mm", "plan" (the planner's grasps and
    scores), "labels" and "dists" (the top grasps' oracle labels and
    surface distances in metres)})."""
    from scipy.spatial import cKDTree

    from giga_tpu_torch.inference.planner import GIGAPlanner, State
    from giga_tpu_torch.utils.synthetic_grasps import evaluate_grasp

    planner = GIGAPlanner(
        net=net, model_cfg=cfg, qual_th=args.planner_qual_th, low_th=0.1, best=True,
        force_detection=True, rng=np.random.RandomState(0), device=device)
    grasps, scores, toc = planner(State(tsdf=test_tsdf[None]))
    print(f"planner returned {len(grasps)} grasps in {toc * 1e3:.1f} ms | {card}")
    if not grasps:
        print("SELFCHECK FAILED: no grasps returned")
        return False, {"grasps": 0, "gsr": 0.0, "median_mm": float("inf"),
                       "plan": (grasps, scores), "labels": [], "dists": []}

    rng = np.random.RandomState(123)
    surf, _ = test_mesh.sample_surface(20000, rng=rng)
    tree = cKDTree(surf)
    top = grasps[: args.top_k]
    dists = [float(tree.query(g.pose.translation)[0]) for g in top]
    labels = [evaluate_grasp(test_mesh, surf, g.pose, rng)[0] for g in top]
    gsr = 100.0 * np.mean(labels)
    print(
        f"held-out scene: top-{len(top)} synthetic GSR {gsr:.0f}%, "
        f"median surface distance {np.median(dists) * 1e3:.1f} mm"
    )
    ok = bool(gsr >= args.gsr_threshold and np.median(dists) < 0.06)
    print(f"SELFCHECK {'PASSED' if ok else 'FAILED'}: GSR {gsr:.0f}% "
          f"(threshold {args.gsr_threshold}%)")
    return ok, {"grasps": len(grasps), "gsr": float(gsr),
                "median_mm": float(np.median(dists) * 1e3), "plan": (grasps, scores),
                "labels": labels, "dists": dists}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=["geo", "giga"], default="geo")
    p.add_argument("--n-scenes", type=int, default=24)
    p.add_argument("--n-occ", type=int, default=8192)
    p.add_argument("--n-grasps", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--batch-occ", type=int, default=1024)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--iou-threshold", type=float, default=0.5)
    p.add_argument("--gsr-threshold", type=float, default=30.0)
    p.add_argument("--planner-qual-th", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--clip-norm", type=float, default=1.0,
                   help="global-norm gradient clip (loss spikes on the small synthetic set can "
                        "otherwise NaN a run); pass 0 to disable")
    p.add_argument("--cosine-lr", action="store_true",
                   help="cosine-decay the learning rate over --steps")
    p.add_argument("--save-params", type=str, default="",
                   help="save trained params (flax msgpack) to this path")
    p.add_argument("--device", default="cuda",
                   help="where training, reconstruction and planning run (cuda or cpu)")
    return p


if __name__ == "__main__":
    sys.exit(main(parser().parse_args()))
