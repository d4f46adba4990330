"""Every sharded program once, across spawned ranks (counterpart of
``__graft_entry__.dryrun_multichip``).

    python3 -m giga_tpu_torch.parallel.dryrun [--ranks N] [--backend gloo|nccl]
        [--device cuda|cuda:0|cpu] [--batch 64] [--train-batch 32]
        [--train-points 2048] [--steps 3]

``dryrun_multichip`` spawns ``n_devices`` ranks (one process each, the
``spawn`` start method, rendezvous through a file) and runs on every rank,
with the shipped GIGA checkpoint:

  * dp batched serving (``build_batched_giga_planner_fn(mesh=...)``) of the
    global batch in float32 and bf16 with the kernels (K1 and K2 on every
    rank on the card: the launch counters read exactly 1 per rank per call;
    on the CPU their plain versions, which count nothing), held against the
    single-process program on the whole batch on the same device: counts
    and positions equal, float32 scores within 1e-5 (tests/
    test_sharded_planner.py), bf16 counts and positions equal; then the
    module path on 2 scenes a rank the same way;
  * the dp train step (``make_train_step(mesh=...)``, float32, mm sampler)
    for ``steps`` steps: each step's loss terms and all-reduced gradients
    held against the single-process step on the whole batch at the same
    params (terms within 1e-5 * (1 + |b|), counts equal; each gradient leaf
    within 1e-5 * (1 + max |g|), or past that within 1e-4 * (1 + max |g|) of
    a float64 run, tests/test_torch_train.py's and chip_smoke.py's rule),
    and the params bit-identical across ranks after every step; the eval
    step's ``summarize_metrics`` against the single-process eval's;
  * the sp planner (``build_sharded_giga_planner_fn``) on one scene against
    the single-device module program (raw qual within 1e-5, candidates as
    above);
  * with 4 or more ranks (an even number), the composed dp x sp program on a
    (2, n/2) mesh against the single-process module program.

On the card each rank takes ``cuda:{rank % cards}`` unless ``device`` names
one card for all (several ranks on one card need ``backend="gloo"``: NCCL
refuses them); the kernels are built in the parent before the ranks start.
Each rank returns a report (its device, launch counts, the largest
differences, whether dp serving was bit-equal, and on the card the
program, gather, train step and all-reduce times by CUDA events). Any
failed check raises in its rank, and the parent raises with the rank's
traceback; a rank that hangs is killed at ``timeout``.
"""

from __future__ import annotations

import argparse
import copy
import json
import multiprocessing as mp
import queue as queue_mod
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from giga_tpu_torch.parallel import distributed

ROOT = Path(__file__).resolve().parents[2]
CHECKPOINT = ROOT / "checkpoints" / "synthetic_giga_best.msgpack"
SIZE = 0.3
PLANNER_KW = dict(force_detection=True, low_th=0.1, qual_th=0.8, best=True)
TOL_SCORE = 1e-5       # candidate scores, absolute (tests/test_sharded_planner.py)
TOL_RAW = 1e-5         # the sp planner's raw qual, absolute (the same test)
TOL_TRAIN_LOSS = 1e-5  # |a - b| <= tol * (1 + |b|) (tests/test_torch_train.py)
TOL_TRAIN_GRAD = 1e-5  # each leaf, max |a - b| <= tol * (1 + max |b|)
TOL_TRAIN_GRAD_F64 = 1e-4  # past TOL_TRAIN_GRAD: against a float64 run (chip_smoke.py)
GROUP_TIMEOUT_S = 300.0


# ---------------------------------------------------------------- launching

def _entry(rank, world, init, backend, device, threads, fn, kwargs, results):
    """One rank: join the group, run ``fn(device, **kwargs)``, report."""
    try:
        if threads:
            torch.set_num_threads(threads)
        distributed.initialize(init, world, rank, backend=backend, device=device,
                               timeout=kwargs.pop("group_timeout", GROUP_TIMEOUT_S))
        results.put((rank, True, fn(distributed.local_device(device, rank), **kwargs)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        distributed.shutdown()


def launch(fn, world: int, backend: str | None = None, device=None, timeout: float = 900.0,
           threads: int | None = None, **kwargs) -> list:
    """Run ``fn(device, **kwargs)`` on ``world`` spawned ranks of a fresh
    process group; their return values in rank order.

    ``fn`` must be importable by its module path (the ranks start from a
    fresh interpreter), its arguments and result picklable. ``device`` and
    ``backend`` as ``distributed.initialize``'s; ``threads`` sets each rank's
    torch thread count; ``group_timeout`` (s, in ``kwargs``) bounds each
    collective. The first failure or a rank still running after ``timeout``
    seconds kills every rank and raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{Path(tmp) / 'rendezvous'}"
        procs = [ctx.Process(target=_entry, args=(r, world, init, backend, device, threads,
                                                  fn, dict(kwargs), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        try:
            while len(got) < world:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank(s) exited without a report: {dead}")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world - len(got)} rank(s) still running after "
                                           f"{timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------- inputs

def synthetic_scenes(n: int, seed: int = 0) -> np.ndarray:
    """(n, 40, 40, 40) float32 TSDFs of the synthetic scene generator
    (``utils/synthetic.py``), one RandomState for all."""
    from giga_tpu_torch.utils.synthetic import mesh_to_tsdf, random_scene

    rng = np.random.RandomState(seed)
    return np.stack([mesh_to_tsdf(random_scene(rng, SIZE), SIZE, 40, rng=rng)
                     for _ in range(n)]).astype(np.float32)


def make_train_batch(seed: int, batch: int, points: int) -> dict:
    """A seeded GIGA training batch, bench.py's recipe (chip_smoke.train_batch)."""
    r = np.random.RandomState(seed)
    return {"tsdf": r.rand(batch, 40, 40, 40).astype(np.float32),
            "pos": r.uniform(-0.4, 0.4, (batch, 3)).astype(np.float32),
            "label": r.randint(0, 2, batch).astype(np.float32),
            "rotations": r.randn(batch, 2, 4).astype(np.float32),
            "width": r.rand(batch).astype(np.float32),
            "pos_occ": r.uniform(-0.4, 0.4, (batch, points, 3)).astype(np.float32),
            "occ": r.randint(0, 2, (batch, points)).astype(np.float32)}


# ---------------------------------------------------------------- checks

def _ms(fn, device, iters: int = 5):
    """Mean ms a call by CUDA events on the card (after a warm call); None
    on the CPU, where no device time exists."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare_candidates(got, ref, what: str, tol: float | None = TOL_SCORE) -> dict:
    """Batched or single-scene GraspCandidates: counts equal, each scene's
    positions equal, scores within ``tol`` (None: decisions only); {the
    largest score difference, whether every field is bit-equal}."""
    g, r = ([t.cpu().numpy() for t in c] for c in (got, ref))
    counts = np.atleast_1d(r[4])
    if not np.array_equal(np.atleast_1d(g[4]), counts):
        raise AssertionError(f"{what}: counts {g[4].tolist()} != {counts.tolist()}")
    worst = 0.0
    for b, n in enumerate(counts):
        gs, rs = (x.reshape(len(counts), -1)[b, :n] for x in (g[0], r[0]))
        gp, rp = (x.reshape(len(counts), -1, 3)[b, :n] for x in (g[1], r[1]))
        if not np.array_equal(gp, rp):
            raise AssertionError(f"{what}: scene {b}'s positions differ")
        worst = max(worst, float(np.abs(gs - rs).max(initial=0.0)))
    if tol is not None and worst > tol:
        raise AssertionError(f"{what}: scores differ by {worst} > {tol}")
    return {"score_diff": worst,
            "bit_equal": all(np.array_equal(a, b) for a, b in zip(g, r))}


def _planner_cfg():
    from giga_tpu_torch.core.config import PlannerConfig

    return PlannerConfig(**PLANNER_KW)


def _serve(mesh, net, cfg, scenes: np.ndarray, module_batch: int) -> dict:
    """dp batched serving with the kernels in float32 and bf16, then on the
    module path, each against the single-process program."""
    from giga_tpu_torch.inference.planner import build_batched_giga_planner_fn
    from giga_tpu_torch.ops.kernels.decoder import dense_decode_batched
    from giga_tpu_torch.ops.kernels.stem import stem_pool_batched
    from giga_tpu_torch.parallel.mesh import gather_batch, shard_batch

    device, pcfg = mesh.device, _planner_cfg()
    expect = 1 if device.type == "cuda" else 0
    out = {}
    runs = [("fp32", net, True, scenes), ("bf16", copy.deepcopy(net).to(torch.bfloat16), True,
                                            scenes),
            ("module", net, False, scenes[:module_batch])]
    for name, net_p, kernels, x in runs:
        ref_fn = build_batched_giga_planner_fn(net_p, cfg, pcfg, SIZE, use_kernels=kernels)
        dp_fn = build_batched_giga_planner_fn(net_p, cfg, pcfg, SIZE, use_kernels=kernels,
                                              mesh=mesh)
        stem_pool_batched.launches = dense_decode_batched.launches = 0
        got = dp_fn(x, x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launches = {"stem_pool": stem_pool_batched.launches,
                    "dense_decode": dense_decode_batched.launches}
        want = expect if kernels else 0
        if launches != {"stem_pool": want, "dense_decode": want}:
            raise AssertionError(f"dp {name}: launches {launches} on one call, expected {want} "
                                 f"each")
        if any(t.device != device for t in got):
            raise AssertionError(f"dp {name}: candidates on {got.scores.device}, not {device}")
        full = torch.from_numpy(x).to(device)
        row = compare_candidates(got, ref_fn(full, full), f"dp {name} vs single-process",
                                 tol=None if name == "bf16" else TOL_SCORE)
        local = shard_batch(mesh, {"x": x})["x"]
        cands = dp_fn.local(local, local)
        row.update(launches=launches, scenes=int(x.shape[0]), grasps=int(got.count.sum()),
                   program_ms=_ms(lambda: dp_fn.local(local, local), device),
                   gather_ms=_ms(lambda: gather_batch(mesh, cands), device),
                   call_ms=_ms(lambda: dp_fn(x, x), device))
        out[name] = row
    return out


def _leaf_errors(got, ref) -> list:
    return [float((a.double() - b.double()).abs().max()) / (1 + float(b.abs().max()))
            for a, b in zip(got, ref)]


def _train(mesh, net, cfg, batch: dict, steps: int) -> dict:
    """The dp train step against the single-process step, the params across
    ranks, and the dp eval step."""
    import torch.distributed as dist

    from giga_tpu_torch.core.device import to_device
    from giga_tpu_torch.parallel.mesh import all_reduce_sum
    from giga_tpu_torch.train import trainer as tt

    device = mesh.device
    state = tt.create_train_state(copy.deepcopy(net), device=device)
    step = tt.make_train_step(state.module, cfg, mesh=mesh)
    value_and_grad = tt.make_value_and_grad(state.module, cfg)
    full = to_device(batch, device)
    reduced = []
    apply = state.apply_gradients
    state.apply_gradients = lambda grads: (reduced.append([g.clone() for g in grads]),
                                           apply(grads))[1]
    worst = {"loss": 0.0, "grad": 0.0, "grad_f64": 0.0, "n_f64": 0}
    for s in range(steps):
        (_, (terms, out)), grads = value_and_grad(state.params, full)
        ref = {**terms, **tt._step_metrics(cfg, out, full)}
        params_before = {k: v.detach().clone() for k, v in state.params.items()}
        state, got = step(state, batch)
        for k, r in ref.items():
            a, b = float(got[k]), float(r)
            if k in tt.COUNT_TERMS:
                if a != b:
                    raise AssertionError(f"train step {s}: {k} {a} != {b}")
            elif not abs(a - b) <= TOL_TRAIN_LOSS * (1 + abs(b)):
                raise AssertionError(f"train step {s}: {k} {a} vs {b}")
            else:
                worst["loss"] = max(worst["loss"], abs(a - b) / (1 + abs(b)))
        errs = _leaf_errors(reduced[-1], grads)
        if max(errs) > TOL_TRAIN_GRAD:  # a float64 run only where a leaf needs it
            net64 = copy.deepcopy(state.module).double()
            with torch.no_grad():
                for k, p in net64.named_parameters():
                    p.copy_(params_before[k])
            b64 = {k: v.double() if v.is_floating_point() else v for k, v in full.items()}
            g64 = tt.make_value_and_grad(net64, cfg)(dict(net64.named_parameters()), b64)[1]
            for i, (e, a, b) in enumerate(zip(errs, reduced[-1], g64)):
                if e > TOL_TRAIN_GRAD:
                    e64 = _leaf_errors([a], [b])[0]
                    worst["n_f64"] += 1
                    worst["grad_f64"] = max(worst["grad_f64"], e64)
                    if e64 > TOL_TRAIN_GRAD_F64:
                        raise AssertionError(f"train step {s}: gradient leaf {i} {e} from the "
                                             f"single-process step, {e64} from float64")
        worst["grad"] = max(worst["grad"], max(errs))
        flat = torch.cat([p.detach().reshape(-1) for p in state.params.values()])
        every = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
        dist.all_gather(every, flat)
        if not all(torch.equal(every[0], f) for f in every):
            raise AssertionError(f"train step {s}: params differ across ranks")
    state.apply_gradients = apply
    got_e = tt.summarize_metrics(tt.fetch_terms([tt.make_eval_step(
        state.module, cfg, mesh=mesh)(state.params, batch)]))
    ref_e = tt.summarize_metrics(tt.fetch_terms([tt.make_eval_step(state.module, cfg)(
        state.params, full)]))
    for k, b in ref_e.items():
        if not abs(got_e[k] - b) <= TOL_TRAIN_LOSS * (1 + abs(b)):
            raise AssertionError(f"eval step: {k} {got_e[k]} vs {b}")
    grads = reduced[-1]
    return {**worst, "steps": steps, "eval": got_e, "loss_all": float(got["loss_all"]),
            "step_ms": _ms(lambda: step(state, batch), device, iters=3),
            "allreduce_ms": _ms(lambda: all_reduce_sum(mesh, grads, "dp"), device)}


def _sp(device, world: int, net, cfg, scene: np.ndarray) -> dict:
    """The sp planner on one scene against the single-device module program."""
    from giga_tpu_torch.inference.planner import (build_giga_planner_fn,
                                                  build_sharded_giga_planner_fn)
    from giga_tpu_torch.parallel.mesh import Mesh

    pcfg = _planner_cfg()
    sp_fn = build_sharded_giga_planner_fn(net, cfg, pcfg, SIZE, Mesh((world,), ("sp",), device))
    ref_fn = build_giga_planner_fn(net, cfg, pcfg, SIZE, return_raw=True)
    got, raw = sp_fn(scene, scene)
    x = torch.from_numpy(scene).to(device)
    ref, ref_raw = ref_fn(x, x)
    raw_diff = float((raw[0] - ref_raw[0]).abs().max())
    if not raw_diff <= TOL_RAW:
        raise AssertionError(f"sp planner: raw qual differs by {raw_diff} > {TOL_RAW}")
    row = compare_candidates(got, ref, "sp planner vs single device")
    return {**row, "raw_diff": raw_diff, "grasps": int(got.count),
            "call_ms": _ms(lambda: sp_fn(scene, scene), device)}


def _composed(device, world: int, net, cfg, scenes: np.ndarray) -> dict:
    """dp x sp on a (2, world/2) mesh against the single-process module program."""
    from giga_tpu_torch.inference.planner import build_batched_giga_planner_fn
    from giga_tpu_torch.parallel.mesh import Mesh

    pcfg = _planner_cfg()
    mesh2 = Mesh((2, world // 2), ("dp", "sp"), device)
    fn = build_batched_giga_planner_fn(net, cfg, pcfg, SIZE, mesh=mesh2, sp_axis="sp")
    ref_fn = build_batched_giga_planner_fn(net, cfg, pcfg, SIZE)
    got = fn(scenes, scenes)
    x = torch.from_numpy(scenes).to(device)
    row = compare_candidates(got, ref_fn(x, x), "dp x sp vs single process")
    return {**row, "mesh": [2, world // 2], "scenes": int(scenes.shape[0]),
            "call_ms": _ms(lambda: fn(scenes, scenes), device)}


def _rank(device, scenes, train: dict, steps: int, module_batch: int, checkpoint: str) -> dict:
    import torch.distributed as dist

    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.parallel.mesh import make_mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    if device.type == "cuda" and torch.cuda.current_device() != device.index:
        raise AssertionError(f"rank {rank}: current card {torch.cuda.current_device()}, "
                             f"not {device}")
    mesh = make_mesh(world, "dp", device)
    net, cfg = load_network(checkpoint)
    net = net.to(device)
    report = {"rank": rank, "world": world, "device": str(device),
              "backend": dist.get_backend()}
    t0 = time.perf_counter()
    report["serve"] = _serve(mesh, net, cfg, scenes, module_batch)
    report["train"] = _train(mesh, net, cfg, train, steps)
    report["sp"] = _sp(device, world, net, cfg, scenes[0])
    if world >= 4 and world % 2 == 0:
        report["dp_sp"] = _composed(device, world, net, cfg, scenes[:4])
    report["seconds"] = time.perf_counter() - t0
    return report


def dryrun_multichip(n_devices: int, backend: str | None = None, device=None,
                     scenes: np.ndarray | None = None, batch: int = 64, train_batch: int = 32,
                     train_points: int = 2048, steps: int = 3, timeout: float = 900.0,
                     threads: int | None = None) -> list:
    """Run every sharded program on ``n_devices`` spawned ranks (module
    docstring); the ranks' reports in rank order. ``scenes`` is the global
    serving batch ((batch, 40, 40, 40) TSDFs; made by ``synthetic_scenes``
    when None). ``device`` as ``distributed.initialize``'s: the card by
    default, ``"cpu"`` for a gloo rehearsal on the CPU."""
    if scenes is None:
        scenes = synthetic_scenes(batch)
    scenes = np.ascontiguousarray(scenes[:batch], np.float32)
    if device is None or torch.device(device).type == "cuda":
        from giga_tpu_torch.ops.kernels import _build

        _build.build_all()  # once here, not once a rank
    return launch(_rank, n_devices, backend=backend, device=device, timeout=timeout,
                  threads=threads, scenes=scenes,
                  train=make_train_batch(0, train_batch, train_points), steps=steps,
                  module_batch=2 * n_devices, checkpoint=str(CHECKPOINT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks to spawn (default: one per card)")
    p.add_argument("--backend", default=None, help="nccl (default on the card) or gloo")
    p.add_argument("--device", default=None,
                   help="cuda (a card a rank), cuda:0 (every rank on card 0, gloo) or cpu")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--train-batch", type=int, default=32)
    p.add_argument("--train-points", type=int, default=2048)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    ranks = args.ranks or (torch.cuda.device_count() if args.device != "cpu" else 2)
    reports = dryrun_multichip(ranks, args.backend, args.device, batch=args.batch,
                               train_batch=args.train_batch, train_points=args.train_points,
                               steps=args.steps)
    for r in reports:
        print(json.dumps(r))
    print(f"dryrun_multichip({ranks}): ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
