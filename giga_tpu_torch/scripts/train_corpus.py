#!/usr/bin/env python3
"""Train GIGA on a pre-built synthetic corpus with the device-resident
pipeline, challenge the incumbent with the grasp oracle at intervals, and
keep the best checkpoint (counterpart of scripts/train_corpus.py).

    python3 -m giga_tpu_torch.scripts.train_corpus [--net giga]
        [--corpus data/corpus] [--steps 12000] [--batch 32] [--batch-occ 1024]
        [--lr 2e-4] [--seed 0] [--bf16] [--no-augment] [--log-every 200]
        [--eval-every 1500] [--eval-scenes 12] [--eval-seed 1000]
        [--eval-reps 2] [--ema 0.999] [--soup-k 4] [--val-frac 0.05]
        [--out checkpoints/corpus_giga.msgpack] [--device cuda]

Run from the repository root. The corpus (scripts/build_corpus) goes to the
device once (train/corpus.device_corpus); each step uploads only the index
arrays of its batch (CorpusSampler) and assembles and augments the batch on
the device (assemble_batch). Adam with a cosine decay of the rate to 2 %
over ``--steps``, global-norm clipping at 1 and non-finite steps skipped,
as the JAX package's script trains. Selection: giga by the oracle GSR of
eval_synthetic_gsr's protocol over ``--eval-reps`` seeds (the raw params
and their EMA), then a greedy soup of the scored checkpoints; giga_geo by
held-out occupancy accuracy. Checkpoints are flax ``.msgpack`` files; the
validation history goes next to ``--out``. The weights start from
``reference_init(net, seed)``, the JAX package's ``net.init`` rules.
Training runs on the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def oracle_eval(params: dict, n_scenes: int, seed: int, top_k: int = 5, qual_th: float = 0.8,
                net_name: str = "giga", device=None) -> float:
    """Fresh-scene GSR of a state dict by eval_synthetic_gsr's protocol."""
    from giga_tpu_torch.models.registry import get_network
    from giga_tpu_torch.scripts.eval_synthetic_gsr import evaluate_planner, make_planner

    net, _ = get_network(net_name)
    net.load_state_dict(params)
    planner = make_planner(net_name, net=net, qual_th=qual_th, device=device)
    return float(evaluate_planner(planner, n_scenes, top_k, seed)["gsr"])


def host_copy(params: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}


def main(args) -> int:
    import torch

    from giga_tpu_torch.core.device import resolve_device
    from giga_tpu_torch.models.checkpoint import save_params
    from giga_tpu_torch.models.convert import state_dict_to_flax
    from giga_tpu_torch.models.registry import get_network, reference_init
    from giga_tpu_torch.train.corpus import (
        CorpusSampler,
        assemble_batch,
        device_corpus,
        load_corpus,
    )
    from giga_tpu_torch.train.trainer import (
        cosine_decay_schedule,
        create_train_state,
        fetch_terms,
        make_eval_step,
        make_train_step,
        summarize_metrics,
    )

    device = resolve_device(args.device)

    def save(params, path):
        save_params(state_dict_to_flax(params), path)

    corpus_np = load_corpus(args.corpus)
    n_scenes = corpus_np["tsdf"].shape[0]
    print(f"corpus: {n_scenes} scenes, {corpus_np['grasp_label'].shape[1]} grasps/scene, "
          f"positive fraction {corpus_np['grasp_label'].mean():.3f}", flush=True)

    net, cfg = get_network(args.net)
    reference_init(net, args.seed)
    is_geo = getattr(cfg, "tsdf_only", False)
    state = create_train_state(net, lr=cosine_decay_schedule(args.lr, args.steps, alpha=0.02),
                               clip_norm=1.0, skip_nonfinite=True, device=device)
    step = make_train_step(net, cfg, dtype=torch.bfloat16 if args.bf16 else None,
                           assemble=assemble_batch)

    # held-out validation split: the tail of a seeded permutation of the scenes
    perm = np.random.RandomState(args.seed + 7).permutation(n_scenes)
    n_val = int(round(args.val_frac * n_scenes))
    train_idx, val_idx = perm[:n_scenes - n_val], perm[n_scenes - n_val:]
    corpus = device_corpus(corpus_np, device=device)
    sampler = CorpusSampler(corpus_np, train_idx, args.batch, args.batch_occ, seed=args.seed,
                            augment=not args.no_augment)

    history_path, val_batches, eval_step = None, [], None
    if n_val > 0:
        eval_step = make_eval_step(net, cfg)
        vs = CorpusSampler(corpus_np, val_idx, args.batch, args.batch_occ, seed=12345,
                           augment=False)
        val_batches = [vs() for _ in range(max(1, (2 * n_val) // args.batch))]
        history_path = Path(args.out).with_suffix(".history.jsonl") if args.out else None
        if history_path is not None:
            history_path.parent.mkdir(parents=True, exist_ok=True)
            history_path.write_text("")  # a fresh run

    def val_summary(params) -> dict:
        return summarize_metrics(fetch_terms(
            [eval_step(params, assemble_batch(corpus, {k: torch.as_tensor(v).to(device)
                                                       for k, v in sel.items()}))
             for sel in val_batches]))

    def run_val(params, it) -> dict:
        summary = val_summary(params)
        print(f"step {it}: val loss {summary.get('loss_all', float('nan')):.4f} "
              f"acc {summary.get('accuracy', 0):.3f} prec {summary.get('precision', 0):.3f} "
              f"rec {summary.get('recall', 0):.3f} ({len(val_batches)} batches x {args.batch})",
              flush=True)
        if history_path is not None:
            with history_path.open("a") as f:
                f.write(json.dumps({"step": it, **summary}) + "\n")
        return summary

    # EMA of the params: a slow weight average is a flatter candidate than
    # the raw trajectory's oscillating checkpoints
    ema = None
    seeds = [args.eval_seed + 97 * k for k in range(args.eval_reps)]

    def score(params) -> float:
        return float(np.mean([oracle_eval(params, args.eval_scenes, s, net_name=args.net,
                                          device=device) for s in seeds]))

    t0 = time.time()
    best = (-1.0, None, "")  # (score, host params, tag)
    best_ema = (-1.0, None)
    ema_out = (str(Path(args.out).with_suffix(".ema.msgpack"))
               if args.out and args.ema > 0 else None)
    pool = []  # every scored candidate: (gsr, host params, tag)
    for it in range(1, args.steps + 1):
        state, terms = step(state, corpus, sampler())
        if args.ema > 0:
            live = list(state.params.values())
            if ema is None:
                ema = [p.detach().clone() for p in live]
            else:
                with torch.no_grad():
                    torch._foreach_mul_(ema, args.ema)
                    torch._foreach_add_(ema, torch._foreach_mul(live, 1.0 - args.ema))
        if it % args.log_every == 0 or it == args.steps:
            print(f"step {it}: loss {float(terms['loss_all']):.4f} "
                  f"({(time.time() - t0) / it * 1e3:.0f} ms/step avg)", flush=True)
        ema_params = None if ema is None else dict(zip(state.params, ema))
        at_eval = it % args.eval_every == 0 or it == args.steps
        if eval_step is not None and at_eval:
            summary = run_val(state.params, it)
            if is_geo:
                # GIGA-Geo selection: the best held-out occupancy accuracy
                cands = [("", state.params, summary["accuracy"])]
                if ema_params is not None:
                    cands.append(("ema ", ema_params, val_summary(ema_params)["accuracy"]))
                for tag, params, acc in cands:
                    if acc > best[0]:
                        best = (acc, host_copy(params), tag)
                        if args.out:
                            save(best[1], args.out)
                        print(f"step {it}: {tag}val occ accuracy {acc:.4f} *best*", flush=True)
        if not is_geo and at_eval:
            # multi-seed selection: one seed's few scenes pick checkpoints
            # that lose on a wide evaluation
            cands = [("", host_copy(state.params))]
            if ema_params is not None:
                cands.append(("ema ", host_copy(ema_params)))
            for tag, params in cands:
                per_seed = [oracle_eval(params, args.eval_scenes, s, net_name=args.net,
                                        device=device) for s in seeds]
                gsr = float(np.mean(per_seed))
                pool.append((gsr, params, f"{tag}step-{it}"))
                mark = ""
                if gsr > best[0]:
                    best, mark = (gsr, params, tag), " *best*"
                    if args.out:
                        save(params, args.out)
                if tag == "ema " and gsr > best_ema[0]:
                    best_ema = (gsr, params)
                    if ema_out:
                        save(params, ema_out)
                detail = "/".join(f"{g:.0f}" for g in per_seed)
                print(f"step {it}: {tag}oracle GSR {gsr:.1f}% [{detail}] (top-5 x "
                      f"{args.eval_scenes} scenes x {len(seeds)} seeds){mark}", flush=True)

    if not is_geo and args.soup_k > 1 and len(pool) > 1:
        from giga_tpu_torch.train.soup import greedy_soup

        soup_gsr, soup, members = greedy_soup(pool, score, k=args.soup_k,
                                              verbose=lambda m: print(m, flush=True))
        if len(members) > 1 and soup_gsr >= best[0]:
            best = (soup_gsr, soup, f"soup[{','.join(members)}]")
            if args.out:
                save(soup, args.out)
            print(f"soup of {len(members)} checkpoints selected: {soup_gsr:.1f}% "
                  f"[{', '.join(members)}]", flush=True)
    what = f"val occ accuracy {best[0]:.4f}" if is_geo else f"GSR {best[0]:.1f}%"
    print(f"trained {args.steps} steps in {(time.time() - t0) / 60:.1f} min; best in-training "
          f"{what} {best[2]}")
    if best_ema[1] is not None:
        print(f"best EMA-trajectory candidate: GSR {best_ema[0]:.1f}% (saved to {ema_out})")
    if args.out and best[1] is not None:
        save(best[1], args.out)
        print(f"saved best params to {args.out}")
    return 0


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--net", type=str, default="giga",
                   help="giga (grasp+occ) or giga_geo (occupancy-only; selection by "
                        "held-out occ accuracy)")
    p.add_argument("--corpus", type=str, default="data/corpus")
    p.add_argument("--steps", type=int, default=12000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--batch-occ", type=int, default=1024)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--log-every", type=int, default=200)
    p.add_argument("--eval-every", type=int, default=1500)
    p.add_argument("--eval-scenes", type=int, default=12)
    p.add_argument("--eval-seed", type=int, default=1000)
    p.add_argument("--eval-reps", type=int, default=2,
                   help="independent eval seeds averaged for selection")
    p.add_argument("--ema", type=float, default=0.999, help="params EMA decay; 0 disables")
    p.add_argument("--soup-k", type=int, default=4,
                   help="greedy-soup pool size over eval-point checkpoints (giga only; <=1 "
                        "disables)")
    p.add_argument("--val-frac", type=float, default=0.05,
                   help="held-out scene fraction for val loss/acc curves (history written "
                        "next to --out); 0 disables")
    p.add_argument("--out", type=str, default="checkpoints/corpus_giga.msgpack")
    p.add_argument("--device", type=str, default=None,
                   help="where training runs (default: the card)")
    return p


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    raise SystemExit(main(parser().parse_args()))
