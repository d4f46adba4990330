#!/usr/bin/env python3
"""Where the time of the port's planning goes, on the card.

    python3 -m giga_tpu_torch.scripts.profile_planner [--batch 64] [--iters 10]
        [--precision fp32|bf16]

Run from the repository root. Loads the shipped checkpoint, plans
chip_smoke's seeded scenes with the batched program (kernels K1 and K2 on
the card), and prints, each line beside the card's name and power limit:
  * the program's time per batch by CUDA events;
  * a torch.profiler trace of ``--iters`` warm program calls: device time
    by kernel name, and the device's busy and idle share of the window;
  * the time per ``plan_batch`` call, and its parts timed one by one with a
    synchronize after each (upload, program, fetch + Grasp objects);
  * PlannerService's scenes/s on thirty batches of requests submitted at
    once, three times;
  * a cProfile of ``--iters`` ``plan_batch`` calls: the host functions with
    the most time of their own. cProfile slows Python calls, not the card,
    so read its shares, not its totals;
  * one scene through ``GIGAPlanner.__call__`` (the single-scene program,
    kernel K3): the program by CUDA events, its trace (device time by
    kernel, idle share), the call's latency split (upload, program, fetch of
    candidates), and beside it the batched program at B=1 (K1 + K2) timed
    the same way, the two in turns.
``--precision bf16`` profiles GIGAPlanner(precision="bf16"), whose programs
run the bf16 modes of K1, K2 and K3.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description="Profile the port's planning on the card.")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--precision", choices=["fp32", "bf16"], default="fp32")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_planner: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from giga_tpu_torch.inference.planner import GIGAPlanner, candidates_to_host
    from giga_tpu_torch.inference.postprocess import GraspCandidates
    from giga_tpu_torch.inference.serving import PlannerService
    from giga_tpu_torch.models.registry import load_network

    card = chip_smoke.card_line()
    net, cfg = load_network(ROOT / chip_smoke.CHECKPOINT)
    planner = GIGAPlanner(net=net, model_cfg=cfg, size=chip_smoke.SIZE,
                          rng=np.random.RandomState(0), precision=args.precision,
                          **chip_smoke.PLANNER_KW)
    card = f"{card}, {args.precision}"
    fn = planner._ensure_batched_fn()
    scenes = chip_smoke.make_scenes(args.batch)
    tsdfs = torch.from_numpy(scenes).cuda()
    n = args.iters
    program_ms = chip_smoke.cuda_ms(lambda: fn(tsdfs, tsdfs), n)

    busy, wall, rows = _trace(lambda: fn(tsdfs, tsdfs), n)
    print(f"program B={args.batch}: {program_ms:.3f} ms/batch by CUDA events | {card}")
    print(f"traced: {busy:.3f} ms device time per batch of {wall:.3f} ms "
          f"wall; device idle share {max(0.0, 1 - busy / wall):.3f} | {card}")
    for ms, calls, name in rows[:25]:
        print(f"  {ms:8.3f} ms  x{calls:<3d} {name[:90]}")

    up = prog = host = 0.0
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grids = torch.from_numpy(scenes).to("cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cands = fn(grids, grids)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host_c = candidates_to_host(cands)
        for i in range(args.batch):
            planner._to_grasps(GraspCandidates(*(x[i] for x in host_c)))
        t3 = time.perf_counter()
        up, prog, host = up + t1 - t0, prog + t2 - t1, host + t3 - t2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        planner.plan_batch(scenes)
    total = (time.perf_counter() - t0) / n
    print(f"plan_batch B={args.batch}: {total * 1e3:.3f} ms per call, "
          f"{args.batch / total:.1f} scenes/s | {card}")
    print(f"plan_batch split per call: upload {up / n * 1e3:.3f} ms, program "
          f"{prog / n * 1e3:.3f} ms, fetch + Grasp objects {host / n * 1e3:.3f} ms | {card}")

    reqs = 30 * args.batch
    with PlannerService(planner, batch_size=args.batch, max_wait_ms=5.0,
                        queue_depth=reqs) as svc:
        for f in [svc.submit(s) for s in scenes]:
            f.result(timeout=300)
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            futs = [svc.submit(scenes[i % args.batch]) for i in range(reqs)]
            for f in futs:
                f.result(timeout=300)
            rates.append(reqs / (time.perf_counter() - t0))
    print(f"PlannerService B={args.batch}: {reqs} requests submitted at once, three times: "
          f"{', '.join(f'{r:.1f}' for r in rates)} scenes/s | {card}")

    prof_host = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof_host.enable()
    for _ in range(n):
        planner.plan_batch(scenes)
    prof_host.disable()
    traced = (time.perf_counter() - t0) / n
    out = io.StringIO()
    pstats.Stats(prof_host, stream=out).sort_stats("tottime").print_stats(20)
    print(f"cProfile of plan_batch: {traced * 1e3:.3f} ms per call under the profiler, "
          f"functions by own time over {n} calls | {card}")
    body = out.getvalue()
    print(body[body.find("ncalls"):].rstrip())
    profile_single(planner, scenes[0], card, n)
    return 0


def _trace(fn, n: int):
    """(device ms per call, wall ms per call, [(ms per call, calls, kernel)])
    of ``n`` warm calls of ``fn`` under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    # device kernels only: operator rows would count their kernels twice
    rows = sorted(((e.self_device_time_total / 1e3 / n, round(e.count / n), e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    return sum(r[0] for r in rows), wall, rows


def profile_single(planner, scene, card: str, n: int) -> None:
    """One scene: the single-scene program of __call__ against the batched
    program at B=1, each traced and its call split."""
    import torch

    import chip_smoke
    from giga_tpu_torch.inference.planner import State, candidates_to_host, upload

    single, batched = planner._ensure_fn(), planner._ensure_batched_fn()
    programs = {
        "single-scene program (K3)": (single, lambda g: g),
        "batched program at B=1 (K1, K2)": (batched, lambda g: g[None]),
    }
    reps = 4 * n
    for name, (fn, shape) in programs.items():
        t = shape(torch.from_numpy(scene).cuda())
        ms = chip_smoke.cuda_ms(lambda: fn(t, t), reps)
        busy, wall, rows = _trace(lambda: fn(t, t), reps)
        print(f"{name}: {ms:.3f} ms per call by CUDA events; traced {busy:.3f} ms device "
              f"time of {wall:.3f} ms wall, idle share {max(0.0, 1 - busy / wall):.3f}, "
              f"{sum(r[1] for r in rows)} kernels per call | {card}")
        for k_ms, calls, kname in rows[:8]:
            print(f"  {k_ms:8.3f} ms  x{calls:<3d} {kname[:90]}")
    # the call's split, the two programs in turns (A, B, B, A)
    split = {name: [0.0, 0.0, 0.0] for name in programs}
    for name in [*programs, *reversed(programs)]:
        fn, shape = programs[name]
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = shape(upload(scene, planner.device))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cands = fn(g, g)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            candidates_to_host(cands)
            t3 = time.perf_counter()
            for i, dt in enumerate((t1 - t0, t2 - t1, t3 - t2)):
                split[name][i] += dt * 1e3 / (2 * reps)
    for name, (up, prog, fetch) in split.items():
        print(f"{name}, split per call in turns: upload {up:.3f} ms, program (enqueue + "
              f"run) {prog:.3f} ms, fetch {fetch:.3f} ms | {card}")
    state = State(tsdf=scene)
    for _ in range(3):
        planner(state)
    t0 = time.perf_counter()
    for _ in range(reps):
        planner(state)
    print(f"__call__: {(time.perf_counter() - t0) / reps * 1e3:.3f} ms per call | {card}")


if __name__ == "__main__":
    sys.exit(main())
