#!/usr/bin/env python3
"""Giga training at the scale the JAX package documents for its self-check
(``--mode giga --steps 3000 --n-scenes 40 --n-grasps 160``), scored on more
than one held-out scene: a diagnostic, with no gate.

    python3 -m giga_tpu_torch.scripts.selfcheck_scale
        [--init golden|seed:S [...]] [--weights golden] [--trajectory N]
        [--control] [--out PATH]
        [selfcheck_e2e's flags, at the documented scale by default]
        [--device cuda]

Run from the repository root. Each ``--init`` trains with selfcheck_e2e's
own functions (``build_dataset``, ``build_grasp_labels``, ``make_state``,
``train_loop``; the data built once for all runs) from JAX's initial
params in GOLDEN (``golden``: the JAX script's ``create_train_state(...,
PRNGKey(0))``) or from ``reference_init(net, S)`` (``seed:S``); ``--weights
golden`` scores JAX's params after its own 3000 steps, without training.
Every run is scored by selfcheck_e2e's ``check_planner`` (its planner, its
oracle, its draws) on the script's held-out scene and on EXTRA_SCENES
more, ``build_dataset(EXTRA_SCENES, ..., seed=EXTRA_SEED)`` (scenes the
training never sees): per scene the grasps, the top-``--top-k`` GSR and the
median surface distance, then the mean and the spread over scenes. A run
prints the loss every 50 steps, the steps skipped as non-finite (a step
whose gradient was not finite: ``apply_if_finite``'s ``notfinite_count``
above 0 after it, JAX's ``not last_finite``, which past 100 such steps in
a row applies the update all the same), the batches with a positive whose
qual is exactly 1.0 and those with any qual exactly 1.0 or 0.0, ms a step
by CUDA events over the loop (batch draw and upload included) and the
card's name and power limit.
``--out`` appends each run's readings as a JSON line.

``--trajectory N`` trains N steps from each ``--init`` and holds each
step's loss terms and skip to GOLDEN's record of the JAX script's first
steps (``traj/``): it prints the envelope, the running maximum over the
terms of |a - b| / (1 + |b|), and scores nothing. ``--control`` trains
once more from the same weights nudged one float32 ulp and prints that
run's envelope against the first: how far rounding alone carries it. Runs on the card unless
``--device cpu`` is given; no card and no ``--device cpu`` raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from giga_tpu_torch.scripts import selfcheck_e2e as sc

GOLDEN = "giga_tpu_torch/testdata/golden_selfcheck_giga.npz"
DOCUMENTED = dict(mode="giga", steps=3000, n_scenes=40, n_grasps=160)
TERMS = ("loss_all", "loss_qual", "loss_rot", "loss_width", "loss_occ")
SATURATION = ("saturated_pos", "saturated")
# the held-out scenes beyond the script's own: build_dataset's seed 1000
EXTRA_SCENES = 8
EXTRA_SEED = 1000


def parser() -> argparse.ArgumentParser:
    p = sc.parser()
    p.description = __doc__.split("\n\n")[0]
    p.set_defaults(**DOCUMENTED)
    p.add_argument("--init", nargs="*", default=None,
                   help="golden (JAX's PRNGKey(0) params) or seed:S (reference_init(net, S)); "
                        "several train one after another")
    p.add_argument("--weights", choices=["golden"], default=None,
                   help="also score JAX's params after its 3000 steps, without training")
    p.add_argument("--trajectory", type=int, default=0,
                   help="train this many steps and hold them to the golden's, no scoring")
    p.add_argument("--control", action="store_true",
                   help="with --trajectory: also train from the weights nudged one ulp and "
                        "hold that run to the first")
    p.add_argument("--out", default="", help="append each run's readings here (JSON lines)")
    return p


def golden_state_dict(golden, prefix: str) -> dict:
    """{name: tensor} of the giga net from the golden's flax leaves stored
    under ``prefix + "a/b/c"``."""
    from giga_tpu_torch.models.convert import flax_to_state_dict

    tree = {}
    for key in golden.files:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = np.asarray(golden[key])
    return flax_to_state_dict({"params": tree})


def train(net, cfg, data, args, device, log=print) -> tuple:
    """``args.steps`` steps of selfcheck_e2e's ``train_loop`` from ``net``'s
    weights. Returns (state, {term or saturation flag: (steps,) array,
    "skipped": (steps,) bool}, ms a step). Every step's readings stay on
    the device until the loop ends and come back in one copy.

    A step is saturated when its batch has a positive whose qual is exactly
    1.0 (``saturated_pos``) or any qual exactly 1.0 or 0.0 (``saturated``):
    the BCE clamps log(p) and log1p(-p) at -100, and at p == 1.0 (or 0.0)
    the clamped branch's gradient is 0 * inf = NaN whatever the label, so
    such a step is skipped. The qual is read by a forward hook: the step
    runs ``net``'s params through a twin of its class (the training
    sampler's), so the hook is global, kept to that class, and removed when
    the loop ends."""
    import torch
    from torch.nn.modules.module import register_module_forward_hook

    from giga_tpu_torch.train.trainer import make_train_step

    state = sc.make_state(net, args, device)
    step = make_train_step(net, cfg)
    keys = TERMS + SATURATION
    quals, rows = [], []

    def keep_qual(module, inputs, out):
        if isinstance(module, type(net)):
            quals.append(out["qual"].detach()[:, 0])

    def recorded(state, batch):
        state, terms = step(state, batch)
        qual = quals.pop()
        label = torch.as_tensor(batch["label"], device=qual.device)
        rows.append([terms[k] for k in TERMS]
                    + [((qual == 1.0) & (label == 1.0)).any(),
                       ((qual == 1.0) | (qual == 0.0)).any(), state.tx.notfinite_count])
        return state, terms

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    handle = register_module_forward_hook(keep_qual)
    try:
        state, _ = sc.train_loop(state, recorded, data, args, log=log)
    finally:
        handle.remove()
    if cuda:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / max(args.steps, 1)
    else:
        ms = (time.perf_counter() - t0) * 1e3 / max(args.steps, 1)
    table = torch.stack([torch.stack([v.to(torch.float32) for v in r]) for r in rows])
    table = table.cpu().numpy().astype(np.float64)
    rec = {k: table[:, i] for i, k in enumerate(keys)}
    rec["skipped"] = table[:, -1] > 0
    for k in SATURATION:
        rec[k] = rec[k] > 0
    return state, rec, ms


def golden_traj(golden) -> dict:
    """The JAX script's first steps: {term: (n,) array, "skipped": (n,)}."""
    return {k: np.asarray(golden[f"traj/{k}"]) for k in TERMS + ("skipped",)}


def envelope(rec: dict, ref: dict, n: int) -> np.ndarray:
    """(n,): the running maximum over the terms of |a - b| / (1 + |b|),
    ``rec``'s first n steps against ``ref``'s (``golden_traj``, or another
    run's record)."""
    worst = np.zeros(n)
    for k in TERMS:
        b = np.asarray(ref[k][:n], np.float64)
        worst = np.maximum(worst, np.abs(np.asarray(rec[k][:n], np.float64) - b) / (1 + np.abs(b)))
    return np.maximum.accumulate(worst)


def nudged(state_dict: dict) -> dict:
    """Every float32 weight moved one ulp toward +inf: the control of
    ``--control``, how far float32 rounding alone carries the training."""
    import torch

    return {k: torch.from_numpy(np.nextafter(v.numpy(), np.float32(np.inf))) for k, v in
            state_dict.items()}


def trajectory(rec: dict, ref: dict, n: int, what: str, label: str, card: str) -> dict:
    """Print and return ``rec``'s envelope against ``ref`` over n steps: at
    every step, and the first step past 1e-3."""
    env = envelope(rec, ref, n)
    over = np.flatnonzero(env > 1e-3)
    shown = [i for i in (1, 2, 3, 5, 10, 15, 20, 30, 50, 100, 150, n) if i <= n]
    print(f"{label}: envelope against {what} terms "
          + ", ".join(f"step {i} {env[i - 1]:.3e}" for i in dict.fromkeys(shown))
          + f"; first step past 1e-3: {int(over[0]) + 1 if len(over) else None} | {card}",
          flush=True)
    return {"envelope": env.tolist(), "first_over_1e3": int(over[0]) + 1 if len(over) else None}


def score(net, cfg, scenes, args, device, card) -> list:
    """check_planner on each (mesh, TSDF) of ``scenes``: per scene the
    grasps, the top-k GSR and the median surface distance (mm)."""
    rows = []
    for i, (mesh, tsdf) in enumerate(scenes):
        _, gate = sc.check_planner(net, cfg, mesh, tsdf, sc.SIZE, args, device, card)
        rows.append({"scene": i, "grasps": gate["grasps"], "gsr": gate["gsr"],
                     "median_mm": gate["median_mm"]})
    return rows


def summary(rows: list) -> dict:
    gsr = np.asarray([r["gsr"] for r in rows])
    med = np.asarray([r["median_mm"] for r in rows])
    return {"mean_gsr": float(gsr.mean()), "std_gsr": float(gsr.std()),
            "min_gsr": float(gsr.min()), "max_gsr": float(gsr.max()),
            "median_mm_mean": float(med[np.isfinite(med)].mean()) if np.isfinite(med).any()
            else float("inf"),
            "grasps_mean": float(np.mean([r["grasps"] for r in rows]))}


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import torch

    from giga_tpu_torch.core.device import resolve_device
    from giga_tpu_torch.models.registry import get_network, reference_init
    from giga_tpu_torch.scripts.profile_batched import card_line

    device = resolve_device(args.device)
    card = card_line(device)
    inits = args.init if args.init is not None else ([] if args.weights else ["golden"])
    golden = np.load(GOLDEN)
    if args.trajectory:
        args.steps = args.trajectory
    if device.type == "cuda":
        torch.backends.cudnn.deterministic = True

    t0 = time.perf_counter()
    scenes, tsdfs, occ_pts, occ_lbls = sc.build_dataset(
        args.n_scenes, sc.SIZE, sc.RESOLUTION, args.n_occ, args.seed)
    grasps = sc.build_grasp_labels(scenes, sc.SIZE, args.n_grasps, args.seed) if inits else None
    held_out = [(scenes[-1], tsdfs[-1])]
    if not args.trajectory and EXTRA_SCENES:
        extra, extra_tsdfs, _, _ = sc.build_dataset(
            EXTRA_SCENES, sc.SIZE, sc.RESOLUTION, args.n_occ, EXTRA_SEED)
        held_out += list(zip(extra, extra_tsdfs))
    print(f"dataset built in {time.perf_counter() - t0:.2f} s (host); {len(held_out)} "
          f"held-out scenes | {card}", flush=True)

    runs = [("init", i) for i in inits] + ([("weights", "golden")] if args.weights else [])
    for kind, name in runs:
        net, cfg = get_network("giga")
        if name == "golden":
            net.load_state_dict(golden_state_dict(golden, "init/" if kind == "init"
                                                  else "trained/params/"))
        else:
            reference_init(net, int(name.split(":", 1)[1]))
        init_sd = {k: v.clone() for k, v in net.state_dict().items()}
        label = f"{kind} {name}"
        out = {"run": label, "card": card}
        if kind == "init":
            state, rec, ms = train(net, cfg, (tsdfs, occ_pts, occ_lbls, grasps), args, device,
                                   log=lambda m: print(f"{label}: {m}", flush=True))
            net = state.module
            out.update(steps=args.steps, skipped=int(rec["skipped"].sum()),
                       skipped_steps=np.flatnonzero(rec["skipped"]).tolist()[:50],
                       saturated_pos=int(rec["saturated_pos"].sum()),
                       saturated=int(rec["saturated"].sum()), ms_step=ms,
                       loss_last=float(rec["loss_all"][-1]))
            clock = "CUDA events" if device.type == "cuda" else "host clock"
            print(f"{label}: {args.steps} steps, {out['skipped']} skipped as non-finite, "
                  f"{out['saturated_pos']} batches with a positive at qual 1.0, "
                  f"{out['saturated']} with any qual at 1.0 or 0.0, {ms:.3f} ms a step "
                  f"({clock} over the loop) | {card}", flush=True)
            if args.trajectory:
                ref = golden_traj(golden)
                n = min(args.trajectory, len(ref["loss_all"]))
                out.update(trajectory(rec, ref, n, "JAX's", label, card),
                           skips_equal=bool(np.array_equal(rec["skipped"][:n],
                                                           ref["skipped"][:n])))
                if args.control:
                    net2, _ = get_network("giga")
                    net2.load_state_dict(nudged(init_sd))
                    _, rec2, _ = train(net2, cfg, (tsdfs, occ_pts, occ_lbls, grasps), args,
                                       device, log=lambda m: None)
                    out["control"] = trajectory(rec2, rec, n, "the unnudged run's",
                                                f"{label} nudged one ulp", card)
        if not args.trajectory:
            rows = score(net, cfg, held_out, args, device, card)
            out.update(scenes=rows, **summary(rows))
            print(f"{label}: " + "; ".join(
                f"scene {r['scene']} {r['grasps']} grasps GSR {r['gsr']:.1f} % median "
                f"{r['median_mm']:.1f} mm" for r in rows), flush=True)
            print(f"{label}: over {len(rows)} scenes GSR mean {out['mean_gsr']:.2f} % (std "
                  f"{out['std_gsr']:.2f}, {out['min_gsr']:.1f}-{out['max_gsr']:.1f}), "
                  f"{out['grasps_mean']:.2f} grasps a scene | {card}", flush=True)
        print(json.dumps(out), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
