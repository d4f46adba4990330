#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (giga_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from giga_tpu_torch/csrc (timed);
  2. load the shipped checkpoint through the port's msgpack reader and
     weight bridge;
  3. hold kernels K1 (stem + pool) and K2 (dense-decode trunk) against
     their plain PyTorch versions at the serving shape (B=64, R=40), and
     time kernel, plain version and the reckoned bound;
  4. run GIGAPlanner.plan_batch on 64 seeded scenes with the launch
     counters zeroed just before, and check its candidates against the
     plain-version program on the card;
  5. check the first scenes' candidates against the committed JAX golden
     file (giga_tpu_torch/testdata/golden_plan_giga.npz);
  6. send requests through PlannerService and check each result against
     plan_batch's;
  7. assert that the main path launched both kernels;
  8. print timings (kernels, plan_batch scenes/s at B=64, __call__ at B=1),
     each beside the card's name and power limit.

Scenes come from ``make_scenes``: an analytic TSDF of a few boxes and
spheres in the planner's convention ([0, 1], 0.5 at the surface,
truncation at 4 voxels). The last line of standard output is
{"ok": true, "device": {...}}; the line before lists the kernels checked.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SIZE = 0.3
RESOLUTION = 40
BATCH = 64
SEED = 0
CHECKPOINT = "checkpoints/synthetic_giga_best.msgpack"
GOLDEN = "giga_tpu_torch/testdata/golden_plan_giga.npz"
PLANNER_KW = dict(best=True, force_detection=True, low_th=0.1, qual_th=0.8)

# published fp32 (non-tensor-core) peak and memory rate of one H100 SXM
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

TOL_STEM = 2e-5     # K1 vs its plain version, absolute, on plane features
TOL_DECODE = 1e-5   # K2 vs its plain version, |a - b| <= tol * (1 + |b|)
TOL_SCORE = 1e-5    # candidate scores and widths, absolute
TOL_POS = 1e-6      # candidate positions (lattice coordinates), absolute


def make_scenes(n: int, seed: int = SEED, resolution: int = RESOLUTION,
                size: float = SIZE, trunc_voxels: float = 4.0) -> np.ndarray:
    """(n, R, R, R) float32 analytic TSDFs of random boxes and spheres.

    Objects rest on z = 0.05 * size as in the JAX package's synthetic scenes;
    the signed distance is exact (union = min over objects), truncated at
    ``trunc_voxels`` voxels and mapped to [0, 1] with 0.5 at the surface,
    inside below 0.5. Scene i depends only on draws made before it, so a
    prefix of a larger set equals a smaller set."""
    rng = np.random.RandomState(seed)
    voxel = size / resolution
    lin = (np.arange(resolution) + 0.5) * voxel
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    out = np.empty((n, resolution, resolution, resolution), np.float32)
    for s in range(n):
        sdf = np.full(len(pts), np.inf)
        for _ in range(3):
            if rng.rand() < 0.5:
                half = rng.uniform(0.25, 0.5, 3) * size / 4
                xy = rng.uniform(0.3, 0.7, 2) * size
                center = np.array([xy[0], xy[1], half[2] + 0.05 * size])
                q = np.abs(pts - center) - half
                d = (np.linalg.norm(np.maximum(q, 0.0), axis=1)
                     + np.minimum(q.max(axis=1), 0.0))
            else:
                r = rng.uniform(0.08, 0.18) * size
                xy = rng.uniform(0.3, 0.7, 2) * size
                center = np.array([xy[0], xy[1], r + 0.05 * size])
                d = np.linalg.norm(pts - center, axis=1) - r
            sdf = np.minimum(sdf, d)
        f = np.clip(sdf / (trunc_voxels * voxel), -1.0, 1.0)
        out[s] = ((f + 1.0) * 0.5).reshape((resolution,) * 3)
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the card: CUDA events around
    ``iters`` calls, after warm-up and a synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    """Least time (ms) for the work on the card and what bounds it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compare_candidates(a, b, scenes, R: int, what: str) -> dict:
    """Hold two host GraspCandidates sets equal scene by scene: equal
    counts, the same lattice positions, and scores, widths and rotations
    within tolerance. Candidates are matched by position, so equal scores
    in another order (ties) still compare equal."""
    worst = {"score": 0.0, "width": 0.0, "rot": 0.0, "pos": 0.0}
    for i in scenes:
        n = int(a.count[i])
        if n != int(b.count[i]):
            raise AssertionError(f"{what}: scene {i} has {n} vs {int(b.count[i])} candidates")

        def keyed(c):
            idx = np.rint((np.asarray(c.positions[i][:n]) + 0.5) * R).astype(int)
            return {tuple(k): j for j, k in enumerate(idx)}

        ka, kb = keyed(a), keyed(b)
        if set(ka) != set(kb) or len(ka) != n:
            raise AssertionError(f"{what}: scene {i} selects other positions")
        for key, ja in ka.items():
            jb = kb[key]
            for name, field in (("score", "scores"), ("width", "widths"),
                                ("rot", "rotations"), ("pos", "positions")):
                d = float(np.max(np.abs(np.asarray(getattr(a, field)[i][ja], np.float64)
                                        - np.asarray(getattr(b, field)[i][jb], np.float64))))
                worst[name] = max(worst[name], d)
    tol = {"score": TOL_SCORE, "width": TOL_SCORE, "rot": TOL_SCORE, "pos": TOL_POS}
    for name, d in worst.items():
        if not d <= tol[name]:
            raise AssertionError(f"{what}: {name} differs by {d} > {tol[name]}")
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from giga_tpu_torch.inference.dense_decode import (
        lattice_coords, sample_planes_on_lattice_batched)
    from giga_tpu_torch.inference.planner import (
        GIGAPlanner, State, build_batched_giga_planner_fn, candidates_to_host,
        full_precision)
    from giga_tpu_torch.inference.postprocess import GraspCandidates
    from giga_tpu_torch.inference.serving import PlannerService
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.ops.kernels import _build
    from giga_tpu_torch.ops.kernels.decoder import (
        dense_decode_batched, dense_decode_plain, prepare_projections_batched)
    from giga_tpu_torch.ops.kernels.stem import stem_pool_batched, stem_pool_plain

    card = card_line()
    print(f"card: {card}")

    # 1. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 2. checkpoint
    net, cfg = load_network(root / CHECKPOINT)
    net = net.cuda()
    print(f"phase 2: loaded {CHECKPOINT} ({cfg.name}, "
          f"{sum(p.numel() for p in net.parameters())} parameters)")

    # 3. kernels against their plain versions at the serving shape
    scenes = make_scenes(BATCH)
    tsdfs = torch.from_numpy(scenes).cuda()
    R, C = RESOLUTION, cfg.encoder.c_dim
    n_blocks, H = cfg.decoder.n_blocks, cfg.decoder.hidden_size
    coords = lattice_coords(R, "cuda")
    conv = net.encoder.conv_in
    with torch.inference_mode(), full_precision():
        k1 = stem_pool_batched(conv.weight, conv.bias, tsdfs)
        p1 = stem_pool_plain(conv.weight, conv.bias, tsdfs)
        err1 = max(float((k1[t] - p1[t]).abs().max()) for t in k1)
        feats = sample_planes_on_lattice_batched(net.encoder.refine(k1), coords, R, 0.0)
        inputs = prepare_projections_batched(net.decoder_aff.params(), feats, coords, n_blocks)
        k2 = dense_decode_batched(*inputs)
        p2 = dense_decode_plain(*inputs)
        err2 = float((k2 - p2).abs().max())
        rel2 = float(((k2 - p2).abs() / (1.0 + p2.abs())).max())
        torch.cuda.synchronize()
        if not (err1 <= TOL_STEM and torch.isfinite(k1["xz"]).all()):
            raise AssertionError(f"K1 differs from its plain version by {err1} > {TOL_STEM}")
        if not (rel2 <= TOL_DECODE and torch.isfinite(k2).all()):
            raise AssertionError(f"K2 differs from its plain version by {rel2} > {TOL_DECODE}")
        print(f"phase 3: K1 max abs err {err1:.3g} (tol {TOL_STEM}); K2 max abs err "
              f"{err2:.3g}, max err/(1+|plain|) {rel2:.3g} (tol {TOL_DECODE})")
        ms1 = cuda_ms(lambda: stem_pool_batched(conv.weight, conv.bias, tsdfs), 50)
        plain1 = cuda_ms(lambda: stem_pool_plain(conv.weight, conv.bias, tsdfs), 20)
        ms2 = cuda_ms(lambda: dense_decode_batched(*inputs), 10)
        plain2 = cuda_ms(lambda: dense_decode_plain(*inputs), 3, warmup=1)
    del p2
    B, N = BATCH, R ** 3
    # K1: 27 multiply-adds, the bias add and 3 pooling adds per voxel and channel
    bound1 = bound(B * N * C * (2 * 27 + 1 + 3), 4 * (B * N + 28 * C + 3 * B * R * R * C))
    # K2, run per head (the fused trunk's off-diagonal zeros are no work):
    # per point and head 2H + n_blocks*(4H^2 + 6H) + 2*H*O + O flops
    heads, O = 3, 4
    flops2 = B * N * heads * (2 * H + n_blocks * (4 * H * H + 6 * H) + 2 * H * O + O)
    bytes2 = 4 * (sum(t.numel() for t in inputs) + B * heads * O * N)
    bound2 = bound(flops2, bytes2)
    launch0 = {"stem_pool": stem_pool_batched.launches, "dense_decode": dense_decode_batched.launches}

    # 4. the main path: GIGAPlanner.plan_batch on the card, counters zeroed
    planner = GIGAPlanner(net=net, model_cfg=cfg, size=SIZE, rng=np.random.RandomState(0),
                          **PLANNER_KW)
    stem_pool_batched.launches = 0
    dense_decode_batched.launches = 0
    results = planner.plan_batch(scenes)
    torch.cuda.synchronize()
    launches = {"stem_pool": stem_pool_batched.launches,
                "dense_decode": dense_decode_batched.launches}
    kern_fn = planner._ensure_batched_fn()
    plain_fn = build_batched_giga_planner_fn(net, cfg, planner.planner_cfg, SIZE,
                                             use_kernels=False)
    ck = candidates_to_host(kern_fn(tsdfs, tsdfs))
    cp = candidates_to_host(plain_fn(tsdfs, tsdfs))
    worst = compare_candidates(ck, cp, range(B), R, "kernels vs plain program")
    counts = [len(g) for g, _ in results]
    if counts != [int(c) for c in ck.count] or sum(counts) == 0:
        raise AssertionError(f"plan_batch counts {counts} disagree with the program's")
    for i in range(B):
        n = counts[i]
        if not (np.isfinite(ck.scores[i][:n]).all() and (ck.scores[i][:n] >= PLANNER_KW["low_th"]).all()
                and (np.abs(ck.positions[i][:n]) <= 0.5).all()):
            raise AssertionError(f"scene {i}: candidates out of range")
    print(f"phase 4: plan_batch B={B}: {sum(counts)} grasps, {min(counts)}..{max(counts)} "
          f"per scene; equal to the plain-version program (max diffs {worst})")

    # 5. the JAX golden file
    golden = np.load(root / GOLDEN)
    np.testing.assert_allclose(golden["tsdf"], scenes[:len(golden["tsdf"])], atol=1e-6)
    gc = GraspCandidates(*(golden[f] for f in GraspCandidates._fields))
    worst_g = compare_candidates(ck, gc, range(len(gc.count)), R, "card vs JAX golden")
    print(f"phase 5: first {len(gc.count)} scenes equal the JAX golden candidates "
          f"(max diffs {worst_g})")

    # 6. PlannerService: a full and a padded batch, the second queued on the
    # card before the first is fetched (lag-1)
    n_req = B + B // 2
    with PlannerService(planner, batch_size=B, max_wait_ms=5.0) as svc:
        futs = [svc.submit(scenes[i % B]) for i in range(n_req)]
        served = [f.result(timeout=300) for f in futs]
        stats = svc.stats()
    expected = [results[i % B] for i in range(n_req)]
    for i, ((g1, s1), (g2, s2)) in enumerate(zip(served, expected)):
        if len(g1) != len(g2):
            raise AssertionError(f"service scene {i}: {len(g1)} vs {len(g2)} grasps")
        for a, b in zip(g1, g2):
            np.testing.assert_allclose(a.pose.translation, b.pose.translation, atol=1e-6)
            np.testing.assert_allclose(a.width, b.width, atol=1e-6)
        np.testing.assert_allclose(s1, s2, atol=1e-6)
    print(f"phase 6: PlannerService served {n_req} requests in {stats['batches']} batches, "
          f"each equal to plan_batch's result")

    # 7. the main path launched both kernels
    if not all(launches.values()):
        raise AssertionError(f"main path did not launch every kernel: {launches}")
    print(f"phase 7: launches on plan_batch: {launches} (comparison launches before: {launch0})")

    # 8. timings
    plan_ms = cuda_ms(lambda: kern_fn(tsdfs, tsdfs), 10)
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        planner.plan_batch(scenes)
    sps = reps * B / (time.perf_counter() - t0)
    state = State(tsdf=scenes[0][None])
    for _ in range(3):
        planner(state)
    t0 = time.perf_counter()
    for _ in range(20):
        planner(state)
    call_ms = (time.perf_counter() - t0) / 20 * 1e3
    print(f"K1 stem_pool: {ms1:.4f} ms (plain {plain1:.4f} ms, bound {bound1[0]:.4f} ms "
          f"by {bound1[1]}) B={B} R={R} | {card}")
    print(f"K2 dense_decode: {ms2:.4f} ms (plain {plain2:.4f} ms, bound {bound2[0]:.4f} ms "
          f"by {bound2[1]}) B={B} R={R} | {card}")
    print(f"plan_batch B={B}: {sps:.1f} scenes/s end to end, batched program "
          f"{plan_ms:.3f} ms/batch ({B / plan_ms * 1e3:.1f} scenes/s) | {card}")
    print(f"__call__ B=1: {call_ms:.3f} ms | {card}")

    kernels = [
        {"name": "stem_pool", "route": "cuda", "source": "giga_tpu_torch/csrc/stem_pool.cu",
         "replaces": "giga_tpu/ops/pallas/stem_kernel.py:120",
         "launches": launches["stem_pool"], "max_abs_err": err1, "ms": ms1,
         "plain_ms": plain1, "bound_ms": bound1[0], "bound_by": bound1[1], "library_ms": None},
        {"name": "dense_decode", "route": "cuda", "source": "giga_tpu_torch/csrc/dense_decode.cu",
         "replaces": "giga_tpu/ops/pallas/decoder_kernel.py:348",
         "launches": launches["dense_decode"], "max_abs_err": err2, "ms": ms2,
         "plain_ms": plain2, "bound_ms": bound2[0], "bound_by": bound2[1], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
