#!/usr/bin/env python3
"""Where the time of mesh generation goes, on the card.

    python3 -m giga_tpu_torch.scripts.profile_meshgen [--settings single,batched,refine]
        [--reps 5] [--simplify-nfaces 10000]

Run from the repository root. Reconstructs bench.py's scenes (the first
``random_scene`` TSDF of ``RandomState(0)`` and the next 8 of the same
draw) with the shipped GIGA-Geo checkpoint, in bench.py's three settings:

  single    resolution0=32, 2 upsampling steps: the 129^3 band program
  batched   the same on a batch of 8 (``generate_meshes``)
  refine    resolution0=32, 3 upsampling steps: the 257^3 refine chain

For each it prints, beside the card's name and power limit: ms per scene
end to end (``generate_mesh`` / ``generate_meshes``, host clock, the median
of ``--reps``); one call split into encode and program (CUDA events), fetch
(the copy, CUDA events), host marching and simplify (host clock; the
generator simplifies nothing by default, so the split times
``simplify_mesh`` to ``--simplify-nfaces`` faces on the call's mesh); the
refine chain's stages (dense decode, each level's mask and decode, band);
the kernels a call launches and the device's idle share over warm calls
(torch.profiler); the peak memory a call allocates. Then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
CHECKPOINT = ROOT / "checkpoints" / "synthetic_giga_geo.msgpack"
SIZE = 0.3
SETTINGS = {"single": dict(resolution0=32, upsampling_steps=2),
            "batched": dict(resolution0=32, upsampling_steps=2),
            "refine": dict(resolution0=32, upsampling_steps=3, strategy="refine")}


def bench_scenes(n: int = 9, seed: int = 0) -> np.ndarray:
    """bench.py's meshgen scenes: (n, 40, 40, 40) TSDFs of one RandomState,
    the first its single scene, the next 8 its batch."""
    from giga_tpu_torch.utils.synthetic import mesh_to_tsdf, random_scene

    r = np.random.RandomState(seed)
    return np.stack([np.squeeze(mesh_to_tsdf(random_scene(r, SIZE), SIZE, 40, rng=r))
                     for _ in range(n)])


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``reps`` calls after one warm call."""
    import torch

    fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def marked(gen, fn):
    """(``fn()``'s outputs, {stage: ms}): the program's stage marks
    (``gen.marks``, CUDA events) as times from the previous mark, the first
    from an event recorded just before ``fn``; no stages on the CPU."""
    import torch

    if gen.device.type != "cuda":
        return fn(), {}
    gen.marks = []
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    torch.cuda.synchronize()
    marks, gen.marks = gen.marks, None
    times, prev = {}, start
    for name, ev in marks:
        times[name] = prev.elapsed_time(ev)
        prev = ev
    return out, times


def split_call(gen, grids: np.ndarray, simplify_nfaces: int) -> dict:
    """One reconstruction of ``grids`` ((R, R, R), or (B, R, R, R) for the
    batched band program) split by stage, in ms: encode, program and fetch
    by CUDA events, marching and simplify by the host clock; the program's
    own stages (``gen.marks``) under "stages"."""
    import torch

    from giga_tpu_torch.geometry.native import simplify_mesh
    from giga_tpu_torch.utils.profiling import mark

    batched = grids.ndim == 4
    dev = gen.upload(grids if batched else grids[None])
    torch.cuda.synchronize()
    gen.marks = []
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    if batched:
        out = gen.band_program_batched(dev)
    else:
        with torch.no_grad():
            gen._planes = gen.net.encode(dev)
        mark(gen.marks, "encode", gen.device)
        out = (gen.refine_program(gen._planes, 0) if gen.strategy == "refine"
               else gen.band_program(gen._planes))
    host = [t.to("cpu", non_blocking=True) for t in out]
    copied = torch.cuda.Event(enable_timing=True)
    copied.record()
    copied.synchronize()
    marks, gen.marks = gen.marks, None
    times, prev = {}, start
    for name, ev in marks:
        times[name] = prev.elapsed_time(ev)
        prev = ev
    res = {"encode": times.pop("encode"),
           "program": sum(times.values()),
           "fetch": prev.elapsed_time(copied),
           "stages": times}
    ids, vals, counts = (h.numpy() for h in host[:3])
    t0 = time.perf_counter()
    if batched:
        meshes = [gen._mesh_from_band(ids[b, :int(counts[b])], vals[b, :int(counts[b])], {})
                  for b in range(len(grids))]
    else:
        meshes = [gen._mesh_from_band(ids[:int(counts)], vals[:int(counts)], {})]
    res["marching"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for m in meshes:
        simplify_mesh(m, simplify_nfaces)
    res["simplify"] = (time.perf_counter() - t0) * 1e3
    res["faces"] = [len(m.faces) for m in meshes]
    return res


def trace_call(fn, n: int = 3) -> dict:
    """Kernels a call, the device's idle share over ``n`` warm calls
    (torch.profiler) and the peak memory one call allocates above what was
    live before it (GB)."""
    import torch

    from giga_tpu_torch.scripts.profile_planner import _trace

    fn()
    busy, wall, rows = _trace(fn, n)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return {"kernels": sum(r[1] for r in rows if not r[2].startswith(("Memcpy", "Memset"))),
            "idle": max(0.0, 1 - busy / wall), "busy_ms": busy, "wall_ms": wall,
            "peak_gb": (torch.cuda.max_memory_allocated() - live) / 1e9}


def profile(setting: str, net, scenes: np.ndarray, reps: int, simplify_nfaces: int) -> dict:
    """Every reading of one setting."""
    from giga_tpu_torch.geometry.generation import MeshGenerator

    gen = MeshGenerator(net, **SETTINGS[setting])
    if setting == "batched":
        batch = scenes[1:9]
        call = lambda: gen.generate_meshes(batch)  # noqa: E731
        per = len(batch)
        grids = batch
    else:
        call = lambda: gen.generate_mesh(scenes[0])  # noqa: E731
        per = 1
        grids = scenes[0]
    out = {"ms_per_scene": host_ms(call, reps) / per}
    out.update(split_call(gen, grids, simplify_nfaces))
    out.update(trace_call(call))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--settings", default="single,batched,refine")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--simplify-nfaces", type=int, default=10000)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from giga_tpu_torch.models.registry import load_network

    if not torch.cuda.is_available():
        raise SystemExit("profile_meshgen needs a CUDA device")
    card = chip_smoke.card_line()
    net, _ = load_network(CHECKPOINT, "giga_geo")
    scenes = bench_scenes()
    summary = {}
    for setting in args.settings.split(","):
        r = profile(setting, net, scenes, args.reps, args.simplify_nfaces)
        summary[setting] = r
        stages = ", ".join(f"{k} {v:.3f}" for k, v in r["stages"].items())
        print(f"{setting}: {r['ms_per_scene']:.3f} ms a scene end to end; one call: encode "
              f"{r['encode']:.3f} ms, program {r['program']:.3f} ms ({stages}), fetch "
              f"{r['fetch']:.3f} ms, marching {r['marching']:.3f} ms, simplify to "
              f"{args.simplify_nfaces} faces {r['simplify']:.3f} ms; faces {r['faces']}; "
              f"{r['kernels']} kernels a call, device idle share {r['idle']:.3f} (traced "
              f"{r['busy_ms']:.3f} of {r['wall_ms']:.3f} ms), peak {r['peak_gb']:.3f} GB | {card}")
    print(json.dumps({"card": card, **summary}))


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    main()
