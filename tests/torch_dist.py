"""Rank programs of the port's multi-process CPU tests
(tests/test_torch_parallel*.py).

Each function runs on every rank of a gloo group that
``giga_tpu_torch.parallel.dryrun.launch`` spawns (the ``spawn`` start
method, a file rendezvous, a timeout on the group and on the ranks), gets
this rank's device and its inputs as numpy arrays, and returns numpy arrays
and numbers. The module imports no JAX: the ranks start from a fresh
interpreter and import it by name, so the test files' JAX stays in the
test process, which compares the ranks' results with the JAX package's
sharded programs.
"""

import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
for p in (REPO, REPO / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

RANK_TIMEOUT_S = 240.0   # a test's whole group, spawn to last report
GROUP_TIMEOUT_S = 60.0   # each collective


def run(fn, world: int, **kwargs) -> list:
    """``fn(device, **kwargs)`` on ``world`` CPU ranks (one torch thread
    each); their results in rank order."""
    from giga_tpu_torch.parallel.dryrun import launch

    return launch(fn, world, device="cpu", timeout=RANK_TIMEOUT_S, threads=1,
                  group_timeout=GROUP_TIMEOUT_S, **kwargs)


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return [_np(t) for t in tree]


# ------------------------------------------------------------- distributed, mesh

def basics(device) -> dict:
    """2 ranks: ranks, batch slices, shard_batch, replicate, gather_batch,
    all_reduce_sum and the errors of an indivisible batch or a mesh that is
    not the world."""
    from giga_tpu_torch.parallel import distributed
    from giga_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(2, device=device)
    rank = distributed.process_index()
    out = {"rank": rank, "count": distributed.process_count(),
           "primary": distributed.is_primary(), "again": distributed.initialize(),
           "mesh_rank": mesh.rank("dp"), "mesh_size": mesh.size()}
    sl = distributed.global_batch_slice(8)
    out["slice"] = (sl.start, sl.stop)
    errors = []
    for bad in (lambda: distributed.global_batch_slice(7), lambda: M.make_mesh(3),
                lambda: M.shard_batch(mesh, {"x": np.zeros((7, 2))})):
        try:
            bad()
        except ValueError:
            errors.append(True)
    out["errors"] = errors
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    shard = M.shard_batch(mesh, {"x": x, "t": torch.arange(8)})
    out["shard"] = _np(shard)
    out["shard_again"] = M.shard_batch(mesh, shard) is shard
    out["replicated"] = _np(M.replicate(mesh, {"w": torch.full((3,), float(rank)),
                                               "i": np.array([rank, 7]), "v": [rank] * 2}))
    out["gathered"] = _np(M.gather_batch(mesh, {"a": shard["x"] * 2,
                                                "n": shard["t"].to(torch.int32)}))
    out["summed"] = _np(M.all_reduce_sum(mesh, [torch.tensor([rank + 1.0]),
                                                torch.full((2, 2), float(rank))], "dp"))
    return out


def x_split(device, dec: dict, feats: dict, coords: np.ndarray, n_blocks: int) -> dict:
    """3 ranks: the decode with the lattice's x axis sharded over ``sp``
    (R=40 splits 14, 13, 13), single-scene and batched, and the same
    decode unsharded."""
    from giga_tpu_torch.inference.dense_decode import decode_dense, decode_dense_batched
    from giga_tpu_torch.parallel.mesh import Mesh, NamedSharding

    mesh = Mesh((3,), ("sp",), device)
    dec = {k: torch.from_numpy(v) for k, v in dec.items()}
    one = {k: torch.from_numpy(v) for k, v in feats.items()}
    two = {k: torch.stack([v, v.flip(0)]) for k, v in one.items()}
    c = torch.from_numpy(coords)
    return {"single": _np(decode_dense(dec, one, c, n_blocks, NamedSharding(mesh, ("sp",)))),
            "batched": _np(decode_dense_batched(dec, two, c, n_blocks,
                                                NamedSharding(mesh, (None, "sp")))),
            "whole": _np(decode_dense_batched(dec, two, c, n_blocks))}


# ------------------------------------------------------------------ planning

def _planner(checkpoint):
    from giga_tpu_torch.core.config import PlannerConfig
    from giga_tpu_torch.models.registry import load_network

    net, cfg = load_network(checkpoint)
    return net, cfg, PlannerConfig(force_detection=True)


def plan_dp_sp(device, scenes: np.ndarray, checkpoint: str) -> dict:
    """2 ranks: dp batched serving on the module path and with the kernels
    (their plain versions on the CPU), and the sp planner on scene 0."""
    from giga_tpu_torch.inference.planner import (build_batched_giga_planner_fn,
                                                  build_sharded_giga_planner_fn)
    from giga_tpu_torch.parallel.mesh import Mesh, make_mesh

    net, cfg, pcfg = _planner(checkpoint)
    mesh = make_mesh(2, device=device)
    out = {}
    for name, kernels in (("dp", False), ("dp_kernels", True)):
        fn = build_batched_giga_planner_fn(net, cfg, pcfg, 0.3, use_kernels=kernels, mesh=mesh)
        out[name] = _np(fn(scenes, scenes))
    sp = build_sharded_giga_planner_fn(net, cfg, pcfg, 0.3, Mesh((2,), ("sp",), device))
    cands, raw = sp(scenes[0], scenes[0])
    out["sp"], out["sp_qual"] = _np(cands), _np(raw[0])
    return out


def plan_composed(device, scenes: np.ndarray, checkpoint: str) -> dict:
    """4 ranks: the dp x sp program on a 2 x 2 mesh."""
    from giga_tpu_torch.inference.planner import build_batched_giga_planner_fn
    from giga_tpu_torch.parallel.mesh import Mesh

    net, cfg, pcfg = _planner(checkpoint)
    mesh = Mesh((2, 2), ("dp", "sp"), device)
    fn = build_batched_giga_planner_fn(net, cfg, pcfg, 0.3, mesh=mesh, sp_axis="sp")
    out = {"cands": _np(fn(scenes, scenes))}
    try:
        build_batched_giga_planner_fn(net, cfg, pcfg, 0.3, use_kernels=True, mesh=mesh,
                                      sp_axis="sp")
    except ValueError:
        out["kernels_refused"] = True
    return out


# ------------------------------------------------------------------ training

def _recording(state) -> list:
    """The gradients each step applies (after the all-reduce)."""
    seen, apply = [], state.apply_gradients
    state.apply_gradients = lambda grads: (seen.append([g.clone() for g in grads]),
                                           apply(grads))[1]
    return seen


def train_dp(device, batch: dict, corpus: dict, sel: dict, dataset: dict, logdir: str) -> dict:
    """2 ranks: one dp train step of giga (``init_network`` seed 1) with its
    all-reduced gradients, the eval step after it, one corpus step, and
    Trainer(mesh=...).fit for one epoch of giga_aff writing to ``logdir``."""
    import os

    from giga_tpu_torch.core.config import TrainConfig
    from giga_tpu_torch.models.registry import init_network
    from giga_tpu_torch.parallel.mesh import make_mesh
    from giga_tpu_torch.train import corpus as tc
    from giga_tpu_torch.train import data as tdata
    from giga_tpu_torch.train import trainer as tt

    mesh = make_mesh(2, device=device)
    net, cfg = init_network("giga", seed=1)
    state = tt.create_train_state(net, device=device)
    grads = _recording(state)
    state, terms = tt.make_train_step(net, cfg, mesh=mesh)(state, batch)
    out = {"terms": _np(terms), "grads": dict(zip(state.params, _np(grads[0]))),
           "params": _np(state.params),
           "eval": _np(tt.make_eval_step(net, cfg, mesh=mesh)(state.params, batch))}

    net2, _ = init_network("giga", seed=1)
    state2 = tt.create_train_state(net2, device=device)
    step = tt.make_train_step(net2, cfg, mesh=mesh, assemble=tc.assemble_batch)
    state2, cterms = step(state2, tc.device_corpus(corpus, device=device), sel)
    out["corpus_terms"], out["corpus_params"] = _np(cterms), _np(state2.params)

    loaders = tdata.create_train_val_loaders(**dataset)
    net3, cfg3 = init_network("giga_aff", seed=0)
    trainer = tt.Trainer(net3, cfg3, TrainConfig(net="giga_aff"), mesh=mesh, logdir=logdir)
    state3, history = trainer.fit(tt.create_train_state(net3, device=device), *loaders,
                                  epochs=1, log=lambda *_: None)
    out["history"], out["fit_params"] = history, _np(state3.params)
    out["logdir"] = sorted(os.listdir(logdir))
    return out
