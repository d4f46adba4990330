#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (giga_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from giga_tpu_torch/csrc (timed, one nvcc per
     source, all started together);
  2. load the shipped checkpoint through the port's msgpack reader and
     weight bridge;
  3. hold kernels K1 (stem + pool) and K2 (dense-decode trunk) against
     their plain PyTorch versions at the serving shape (B=64, R=40), and
     time kernel, plain version and the reckoned bound; print K1's ptxas
     registers and spills, shared memory per block, grid and share of bound;
  4. run GIGAPlanner.plan_batch on 64 seeded scenes with the launch
     counters zeroed just before, and check its candidates against the
     plain-version program on the card;
  5. check the first scenes' candidates against the committed JAX golden
     file (giga_tpu_torch/testdata/golden_plan_giga.npz);
  6. send requests through PlannerService and check each result against
     plan_batch's;
  7. assert that plan_batch launched K1 and K2;
  8. hold kernel K3 (single-scene trunk) against its plain version on one
     scene at R=40, and time both and the bound;
  9. run GIGAPlanner.__call__ (the single-scene program) on the golden
     file's scenes with K3's counter zeroed just before: each equals the
     golden candidates and plan_batch's grasps, one K3 launch per call;
 10. run plan_stream over 8 scenes and hold it against per-scene calls;
 11. hold kernels K4 (raw-feature trunk) and K5 (hybrid trunk; both their
     projections, then the tiled trunk) against their plain versions at
     B=64, R=40, and their decodes against K2's; plan the batch from K4's
     volumes and hold it against plan_batch; drive the two decode entry
     points with the counters zeroed; time kernels, plain versions and
     bounds; print K4's and K5's resources, launches and shares of bound;
 12. print timings (kernels, plan_batch scenes/s at B=64, __call__ of one
     scene), each beside the card's name and power limit; then K2's and K3's
     resources: ptxas registers and spills, shared memory per block, the
     grid and resident blocks per SM their launcher picks on this card, and
     the share of its bound each reaches;
 13-17. the bf16 serving configuration, GIGAPlanner(precision="bf16")
     (``bf16_phases``): the bf16 modes of K1, K2 and K3 against their plain
     versions (at least 99.9 % of outputs within 1e-5, all within 2e-2 *
     (1 + |plain|)), with their resources, times and bounds at 989 TFLOP/s;
     bf16 plan_batch at B=64 with the counters zeroed just before (one K1
     and one K2 launch), held by tests/test_bf16_serving.py's four decision
     gates against the float32 plan and against the committed JAX TPU bf16
     golden file (golden_plan_giga_bf16.npz); PlannerService equal to it;
     __call__ on the golden scenes (one K3 launch each) by the same gates
     against the float32 plan and against the committed golden file of
     JAX's GIGAPlanner(precision="bf16").__call__ (golden_call_giga_bf16.npz);
     plan_stream equal to per-scene calls; the bf16 programs' timings;
 18. the bf16 decode A/B's kernels (``bf16_decode_phase``): the bf16 modes of
     K4 and K5 against their plain versions at B=64, R=40 on the bf16 net's
     lattice features; the memory each call allocates beside its output,
     no more than its bf16 workspace of rounded features (no float32 rows);
     the two bf16 decode entry points with the counters zeroed just before
     (one launch each), their raw qual held against K2 bf16's decode
     (within 4e-2 at most, 3e-3 at the median); their resources, times and
     shares of bound at 989 TFLOP/s;
 19. K2's numeric options (``options_phase``): fold_b1 (float32 and bf16)
     and resident_bf16 (with and without fold_b1) against their plain
     versions at B=64, R=40 (the resident mode's far bound
     TOL_BF16_RESIDENT_FAR), the resident mode not equal to the default
     one, hidden_bf16's volumes equal to the bf16 mode's; the batched
     program with fold_b1 (float32; equal to the JAX golden and to the
     default program) and with fold_b1 and hidden_bf16 (bf16; the four
     gates and raw qual against golden_plan_giga_bf16_fold.npz), counters
     zeroed just before (one K1 and one option launch each); return_raw's
     candidates equal to the program's; resident_bf16 through the decode
     entry point (one launch each); every K2 mode's resources, time and
     share of bound beside the default modes';
 20. every preset through the kernels' shape predicates (``presets_phase``):
     the giga_wide preset (c_dim and hidden 64, seeded weights) through
     plan_batch (B=64), __call__, plan_stream and PlannerService in float32
     and bf16, each program's paths (K1, then the module decode: K2 and K3
     take hidden 32 only) and launch counts, its decisions against the same
     planner on the CPU, the program's time; the shipped checkpoint at plane
     resolution 48, past K1's float32 limit (net.encode, then K2);
 21. checkpoint ensembles (``ensemble_phase``): GIGAPlanner(params=[ckpt,
     perturbed ckpt]) with each combiner, float32 then bf16: [ckpt, ckpt]
     against ckpt alone, two K3 launches a __call__, the float32 plans
     against the JAX golden file (golden_call_giga_ensemble.npz), the bf16
     plans by the four gates against the float32 ones, plan_stream, and
     plan_batch raising; the __call__ latencies;
 22. decoding at arbitrary points (``points_phase``): giga_geo's encode and
     occupancy at 100,000 points (samplers mm and gather), giga's forward,
     grad_refine and decode_lattice_points at 4,096 lattice points, each
     against the same call on the CPU and no kernel launched; their times;
 23. VGN (``vgn_phase``) at full width with the golden file's seeded weights:
     VGNPlanner.plan_batch (B=64) and __call__ in each precision with the
     counters zeroed just before (no kernel of this package: cuDNN
     convolutions), ``highest`` against JAX's golden candidates
     (golden_plan_vgn.npz) and its batch against its single-scene program,
     ``default`` (TF32) and ``bf16`` against ``highest`` by
     tests/test_vgn_fast.py's four gates, ``visualize=True``; ms per batch
     and __call__ latencies;
 24. TSDF fusion at the simulator's settings (``fusion_phase``): 6 ray-cast
     640x480 views a scene fused at 40^3 (against JAX's golden_tsdf_fusion.npz
     and the CPU) and 120^3 (against the CPU), then GIGA plan_batch (one K1
     and one K2 launch), GIGA __call__ (one K3 launch a scene) and VGN
     __call__ from the fused TSDFVolumes, each against the CPU's; fusion ms
     per scene;
 25. affordance visualization (``visual_phase``): GIGA and VGN
     ``visualize=True``, the composed scene against the CPU's;
 26. GIGA training (``train_phase``; no kernel of this package, counters
     zeroed just before and read after): three fp32 steps from the shipped
     checkpoint against the JAX golden (golden_train_giga.npz); at full
     width (B=32, 2048 occupancy points a sample) fp32 mm, fp32 gather and
     bf16 mm, one step each against the CPU port's (loss, every gradient
     leaf, params after the step; bf16 against fp32), 10 chained steps
     whose loss falls, samples/s, kernels a step, idle share and peak
     memory; giga_geo and VGN one step each against the CPU; the device
     corpus (assemble_batch on the card equal to the CPU's, 5 corpus
     steps); Trainer.fit with checkpoints and resume.
 27. mesh generation (``meshgen_phase``; no kernel of this package, counters
     of K1-K5 zeroed just before and read after) with the shipped GIGA-Geo
     checkpoint in bench.py's settings: the 129^3 band program's and the
     257^3 refine chain's bands against a JAX golden
     (golden_mesh_geo.npz) and the CPU; generate_meshes on a batch of 8
     against per-scene generate_mesh (129^3 and 257^3); bf16 against fp32;
     the programs under set_sync_debug_mode("error") up to their fetch;
     scripts/eval_synthetic_geometry.py's protocol at the geo gate's
     floors; ms per scene, one call's split, kernels, idle share and peak
     memory.

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

from giga_tpu_torch.ops.kernels.decoder import trunk_flops

SIZE = 0.3
RESOLUTION = 40
BATCH = 64
SEED = 0
CHECKPOINT = "checkpoints/synthetic_giga_best.msgpack"
GOLDEN = "giga_tpu_torch/testdata/golden_plan_giga.npz"
GOLDEN_BF16 = "giga_tpu_torch/testdata/golden_plan_giga_bf16.npz"
GOLDEN_CALL_BF16 = "giga_tpu_torch/testdata/golden_call_giga_bf16.npz"
GOLDEN_BF16_FOLD = "giga_tpu_torch/testdata/golden_plan_giga_bf16_fold.npz"
GOLDEN_ENSEMBLE = "giga_tpu_torch/testdata/golden_call_giga_ensemble.npz"
GEO_CHECKPOINT = "checkpoints/synthetic_giga_geo.msgpack"
GOLDEN_VGN = "giga_tpu_torch/testdata/golden_plan_vgn.npz"
GOLDEN_FUSION = "giga_tpu_torch/testdata/golden_tsdf_fusion.npz"
PLANNER_KW = dict(best=True, force_detection=True, low_th=0.1, qual_th=0.8)
# VGN ships no checkpoint: its weights are the JAX package's seeded init
# (``net.init(PRNGKey(VGN_SEED))``, as tests/test_vgn_fast.py), with the
# width head's bias moved by VGN_WIDTH_SHIFT into VGN's voxel-unit width
# window, and the qual head's kernel and bias scaled by VGN_QUAL_SCALE,
# then its bias moved by VGN_QUAL_SHIFT. Unscaled (bias + 2, as
# test_vgn_fast.py does) the seeded net's quality lies within [0.8806,
# 0.8817] on every scene: bf16 rounds it to one value, so JAX's own bf16
# program selects 128 plateau voxels with no overlap with its float32
# plan, and one float32 step between XLA's and PyTorch's convolutions
# flips its NMS peaks. Scaled, qualities span ~0.003-0.985. The planner
# settings are test_vgn_fast.py's. The golden file carries the weights to
# the card, which has no JAX
VGN_SEED = 3
VGN_QUAL_SCALE = 1000.0
VGN_QUAL_SHIFT = -4.0
VGN_WIDTH_SHIFT = 5.0
VGN_KW = dict(best=True, force_detection=True, qual_th=0.85)
VGN_OVERLAP_MEAN = 0.7  # tests/test_vgn_fast.py's mean-overlap gate
# TSDF fusion at the simulator's settings (giga_tpu/sim/simulation.py:67,
# :161-185): a 640x480 camera (fx = fy = 540, cx 320, cy 240) with depth
# range 0.1-2.0 m, N_VIEWS views on a circle, fused at 40^3 and at 120^3
CAMERA = (640, 480, 540.0, 540.0, 320.0, 240.0)
DEPTH_RANGE = (0.1, 2.0)
N_VIEWS = 6
FUSION_HIGH_RES = 120
FUSION_SCENES = 4  # the golden file's scenes, then scenes rendered here
TOL_TSDF = 1e-6     # fused TSDF values, absolute
TOL_BATCH = 1e-6    # VGN's batched against its single-scene candidates
TOL_VERTEX = 1e-6   # composed scenes' vertices (metres), card against CPU
# the giga_wide preset with seeded weights (init_network): its qualities lie
# in [0.56, 0.62] and its widths in [0.10, 0.80] (normalized), so it plans
# with these thresholds and a width window that holds them
WIDE_SEED = 0
WIDE_KW = dict(best=True, force_detection=True, low_th=0.5, qual_th=0.59)
WIDE_WIDTHS = (-1.0, 1.0)
# the ensemble's second member: the shipped checkpoint with every leaf moved
# by ENSEMBLE_SCALE times its mean magnitude times standard normal draws
# (perturbed_params)
ENSEMBLE_SEED = 1
ENSEMBLE_SCALE = 0.1
TOL_ENSEMBLE_SAME = 1e-6  # [ckpt, ckpt] against ckpt alone (tests/test_ensemble.py)
# the seeded giga_wide's bf16 raw qual on the card against the CPU's, in
# bf16 steps: the two sum the bf16 products in other orders, which moves a
# rounding by a step (one step at most in the first card run); its
# qualities span ~15 steps, so a step can reorder its candidates, and its
# bf16 decisions are counted, not held (the shipped checkpoint's bf16
# decisions are held by the four gates in phases 14, 16 and 21)
WIDE_BF16_STEPS = 2
# decoding at arbitrary points (phase 22): occupancy queries a call (bench.py's
# giga_geo_100k_queries_ms), lattice indices and points of the affordance
# decodes, and the card's results against the CPU's and against the lattice
# decode: |a - b| <= tol * (1 + |b|) for the unit-scale outputs (qual, rot,
# width, points). giga_geo's occupancy logits reach |164| as sums of larger
# terms, where float32 itself is coarser than that: the CPU's own float32
# logits lie 3.4e-5 * (1 + |b|) from a float64 run of the same call (my CPU
# run, PR 11); so they are held to tol * (1 + max |b|), the logits' scale,
# and the phase prints the CPU's own distance from float64 beside it
N_QUERIES = 100_000
N_POINTS = 4096
TOL_POINTS = 2e-5
# training (phase 26): the reference's batch and occupancy points a sample
# (scripts/train_giga.py:256-259, bench.py's train rows); the JAX golden's
# smaller batch, steps and entries kept a leaf; the card's steps against the
# CPU port's and the golden: loss terms |a - b| <= tol * (1 + |b|), each
# gradient leaf within tol * (1 + max |g|) of the leaf, params after a step
# absolute (tests/test_train.py:171-177), a bf16 step's loss against the
# fp32 step's (tests/test_train.py:202). The gather sampler's backward adds
# into the planes with atomics in no fixed order on the card, so its
# gradients get a looser scaled bound. And float32 itself lies up to ~1e-4 *
# (1 + max |g|) from a float64 run of a step on some leaves (the CPU's own:
# 1.04e-4 on giga's first U-Net conv at B=4, measured on the CPU), the card's
# cuDNN algorithms elsewhere than the CPU's (giga_geo's second U-Net level:
# 2.34e-5 from float64 on the card, 3.8e-6 at most on the CPU, measured on
# one H100); so a leaf past the bound against the CPU is held to
# TOL_TRAIN_GRAD_F64 against a float64 run (``compare_train_step``). Adam's
# first steps move a param by
# ~lr * sign(g) whatever |g| is (above its eps of 1e-8), so where the
# reference's gradient lies within the gradient bound of zero the other
# device's may have the other sign or none: the shipped checkpoint has
# weights whose gradient is exactly 0 in float32 on the CPU and ~1e-8 on the
# card, which then move by ~0.7 lr (measured on one H100). So after one step
# a param is held to TOL_TRAIN_PARAM beyond the move Adam's first step makes
# of the two gradients measured (``adam_first_move``); after three steps,
# where only the first gradients are known, a param whose first gradient is
# ``undetermined`` is held to what Adam can move it, 2 * ADAM_STEP * lr a
# step apart (ADAM_STEP bounds |m_hat| / sqrt(v_hat) over Adam's first three
# steps: 1, 1.0013, 1.0036)
TRAIN_BATCH = 32
TRAIN_POINTS = 2048
GOLDEN_TRAIN = "giga_tpu_torch/testdata/golden_train_giga.npz"
GOLDEN_TRAIN_BATCH = 8
GOLDEN_TRAIN_POINTS = 512
GOLDEN_TRAIN_STEPS = 3
GOLDEN_TRAIN_ENTRIES = 64
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-5
TOL_TRAIN_GRAD_GATHER = 1e-4
TOL_TRAIN_GRAD_F64 = 1e-4
TOL_TRAIN_PARAM = 5e-5
TRAIN_LR = 2e-4
ADAM_STEP = 1.01
TOL_TRAIN_BF16_LOSS = 3e-2
# mesh generation (phase 27): the shipped GIGA-Geo checkpoint in bench.py's
# settings (resolution0 32 with 2 upsampling steps, the 129^3 band program,
# one scene and a batch of MESH_BATCH; 3 steps, the 257^3 refine chain) on
# bench.py's scenes (profile_meshgen.bench_scenes). The golden file holds
# JAX's bands for the first two at 129^3 and the first at 257^3. Two bands
# are compared cell by cell: a shared cell's corner logits within one
# float16 step of the larger plus TOL_BAND * (1 + |b|) (float32 sums in
# another order: the port's CPU logits lie 1.5e-5 * (1 + |b|) from JAX's
# at 65^3, tests/test_torch_meshgen.py::test_float32_logits_match_jax), and
# a cell in one band only must have a corner within TOL_FLIP of the
# threshold (a corner whose float32 logit changes sign between the two). The batched gate is
# tests/test_band_generation.py's; bf16 meshes are held by the median
# distance of their vertices to the fp32 mesh's; the quality floors are
# tests/test_geo_gate.py's, at scripts/eval_synthetic_geometry.py's default
# protocol (16 scenes, seed 2000, 100,000 evaluation points)
GOLDEN_MESH = "giga_tpu_torch/testdata/golden_mesh_geo.npz"
MESH_BATCH = 8
TOL_BAND = 5e-5
TOL_FLIP = 5e-4
TOL_MESH_BATCH = 5e-3   # sorted vertices, batched against per-scene
TOL_MESH_BF16 = 0.01    # median distance of bf16 vertices to the fp32 mesh
GEO_IOU_FLOOR = 0.82
GEO_FSCORE_FLOOR = 0.78
GEO_CHAMFER_L1_CEIL = 0.0075

# published fp32 (non-tensor-core) and dense bf16 (tensor-core) peaks and
# the memory rate of one H100 SXM
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

TOL_STEM = 2e-5     # K1 vs its plain version, absolute, on plane features
TOL_DECODE = 1e-5   # K2-K5 vs their plain versions, |a - b| <= tol * (1 + |b|)
TOL_VOLUME = 1e-5   # K4's and K5's (qual, rot, width) vs K2's, absolute
TOL_SCORE = 1e-5    # candidate scores and widths, absolute
TOL_POS = 1e-6      # candidate positions (lattice coordinates), absolute
# bf16 modes against their plain versions: a float32 sum taken in another
# order can flip the bf16 rounding of an activation, which moves the outputs
# downstream of it by a bf16 step; so at least BF16_SHARE of the outputs
# within TOL_BF16_CLOSE, and every output within TOL_BF16_FAR * (1 + |ref|)
TOL_BF16_CLOSE = 1e-5
BF16_SHARE = 0.999
TOL_BF16_FAR = 2e-2
# K2's resident_bf16 mode also rounds the residual stream itself, five times
# a block: a flip there moves net by a bf16 step of |net|, which the head
# carries to the outputs. Two plain versions of a bf16 mode that differ
# only in the order of their float32 sums already lie up to ~1.7e-2 *
# (1 + |ref|) apart on the serving data at B=64, and the resident kernel
# read 2.07e-2 from its plain version there (giga_tpu_torch.scripts.
# bf16_sum_order; PERF.md §6): its far bound is twice the other
# modes', its share gate the same
TOL_BF16_RESIDENT_FAR = 4e-2
# raw qual of one bf16 program against another (the port's against the JAX
# package's, one decode against another): each bf16 program keeps qual
# within 2e-2 of the float32 program at most and 3e-3 at the median
# (tests/test_pallas_kernel.py:91-92), so two of them can be up to twice
# the maximum apart; the median keeps its 3e-3
TOL_QUAL_BF16_MAX = 4e-2
TOL_QUAL_BF16_MEDIAN = 3e-3


def scene_objects(n: int, seed: int = SEED, size: float = SIZE) -> list:
    """The objects of ``make_scenes``' n scenes: per scene three
    ("box", center, half extents) or ("sphere", center, radius) tuples,
    resting on z = 0.05 * size, drawn from one RandomState. Scene i depends
    only on draws made before it, so a prefix of a larger set equals a
    smaller set."""
    rng = np.random.RandomState(seed)
    scenes = []
    for _ in range(n):
        objects = []
        for _ in range(3):
            if rng.rand() < 0.5:
                half = rng.uniform(0.25, 0.5, 3) * size / 4
                xy = rng.uniform(0.3, 0.7, 2) * size
                objects.append(("box", np.array([xy[0], xy[1], half[2] + 0.05 * size]), half))
            else:
                r = rng.uniform(0.08, 0.18) * size
                xy = rng.uniform(0.3, 0.7, 2) * size
                objects.append(("sphere", np.array([xy[0], xy[1], r + 0.05 * size]), r))
        scenes.append(objects)
    return scenes


def make_scenes(n: int, seed: int = SEED, resolution: int = RESOLUTION,
                size: float = SIZE, trunc_voxels: float = 4.0) -> np.ndarray:
    """(n, R, R, R) float32 analytic TSDFs of ``scene_objects``' boxes and
    spheres.

    The signed distance is exact (union = min over objects), truncated at
    ``trunc_voxels`` voxels and mapped to [0, 1] with 0.5 at the surface,
    inside below 0.5."""
    voxel = size / resolution
    lin = (np.arange(resolution) + 0.5) * voxel
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    out = np.empty((n, resolution, resolution, resolution), np.float32)
    for s, objects in enumerate(scene_objects(n, seed, size)):
        f = np.clip(scene_sdf(objects, pts) / (trunc_voxels * voxel), -1.0, 1.0)
        out[s] = ((f + 1.0) * 0.5).reshape((resolution,) * 3)
    return out


def scene_sdf(objects, pts: np.ndarray) -> np.ndarray:
    """The exact signed distance (metres, negative inside) of (N, 3) points
    to a scene's boxes and spheres: the minimum over its objects."""
    sdf = np.full(len(pts), np.inf)
    for kind, center, extent in objects:
        if kind == "box":
            q = np.abs(pts - center) - extent
            d = np.linalg.norm(np.maximum(q, 0.0), axis=1) + np.minimum(q.max(axis=1), 0.0)
        else:
            d = np.linalg.norm(pts - center, axis=1) - extent
        sdf = np.minimum(sdf, d)
    return sdf


def make_corpus(n: int, n_occ: int, n_grasps: int, seed: int = SEED) -> dict:
    """A training corpus in train/corpus.py's ``load_corpus`` layout from
    ``make_scenes``' n analytic scenes: their TSDFs; n_occ seeded points a
    scene in the workspace (normalized to [-0.5, 0.5]^3) labelled occupied
    inside an object; n_grasps seeded grasps a scene (points in
    [-0.4, 0.4]^3, a random unit quaternion q and its gripper twin
    q * Rz(pi), widths, labels)."""
    rng = np.random.RandomState(seed + 1)
    pts = rng.uniform(0.0, SIZE, (n, n_occ, 3))
    occ = np.stack([scene_sdf(objects, p) < 0.0
                    for objects, p in zip(scene_objects(n, seed), pts)])
    q = rng.randn(n, n_grasps, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = np.moveaxis(q, -1, 0)
    return {
        "tsdf": make_scenes(n, seed),
        "occ_pts": (pts / SIZE - 0.5).astype(np.float32),
        "occ_lbl": occ.astype(np.float32),
        "grasp_pos": rng.uniform(-0.4, 0.4, (n, n_grasps, 3)).astype(np.float32),
        "grasp_rot": np.stack([q, np.stack([y, -x, w, -z], -1)], axis=2).astype(np.float32),
        "grasp_width": rng.uniform(0.05, 0.25, (n, n_grasps)).astype(np.float32),
        "grasp_label": rng.randint(0, 2, (n, n_grasps)).astype(np.float32),
    }


def train_batch(seed: int, batch: int, points: int, vgn: bool = False) -> dict:
    """A seeded training batch of numpy arrays, bench.py's recipe: uniform
    TSDFs, grasp points in [-0.4, 0.4]^3, random labels, unnormalized target
    quaternions and widths; with ``points`` occupancy points and labels a
    sample (GIGA), or a labeled voxel index a sample (``vgn``)."""
    r = np.random.RandomState(seed)
    out = {"tsdf": r.rand(batch, RESOLUTION, RESOLUTION, RESOLUTION).astype(np.float32)}
    if vgn:
        out["index"] = r.randint(0, RESOLUTION, (batch, 3)).astype(np.int32)
    else:
        out["pos"] = r.uniform(-0.4, 0.4, (batch, 3)).astype(np.float32)
    out["label"] = r.randint(0, 2, batch).astype(np.float32)
    out["rotations"] = r.randn(batch, 2, 4).astype(np.float32)
    out["width"] = r.rand(batch).astype(np.float32)
    if not vgn:
        out["pos_occ"] = r.uniform(-0.4, 0.4, (batch, points, 3)).astype(np.float32)
        out["occ"] = r.randint(0, 2, (batch, points)).astype(np.float32)
    return out


def leaf_entries(params: dict, grads: dict | None = None, first: dict | None = None,
                 seed: int = SEED, entries: int = GOLDEN_TRAIN_ENTRIES) -> dict:
    """{"sum/<leaf>": its float64 sum, "idx/<leaf>": ``entries`` seeded flat
    indices, "val/<leaf>": the values there} of {name: float32 array}, the
    leaves in sorted order, every index drawn from one RandomState(seed);
    with ``grads`` (the first step's gradients) also "grad/<leaf>", the
    gradient at those indices, and "gmax/<leaf>", the leaf's max |g|; with
    ``first`` (the params after the first step) "val1/<leaf>", its values
    there."""
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(params):
        v = np.asarray(params[k], np.float32).reshape(-1)
        idx = rng.randint(0, v.size, entries)
        out[f"sum/{k}"] = np.float64(v.astype(np.float64).sum())
        out[f"idx/{k}"] = idx.astype(np.int64)
        out[f"val/{k}"] = v[idx]
        if grads is not None:
            g = np.asarray(grads[k], np.float32).reshape(-1)
            out[f"grad/{k}"] = g[idx]
            out[f"gmax/{k}"] = np.float32(np.abs(g).max())
        if first is not None:
            out[f"val1/{k}"] = np.asarray(first[k], np.float32).reshape(-1)[idx]
    return out


def adam_first_move(g_a, g_b, eps: float = 1e-8):
    """|a - b| of the moves Adam's first step makes of two gradients of one
    param: lr * |g_a / (|g_a| + eps) - g_b / (|g_b| + eps)| (mu_hat = g,
    sqrt(nu_hat) = |g| at step 1)."""
    g_a, g_b = np.asarray(g_a, np.float64), np.asarray(g_b, np.float64)
    return TRAIN_LR * np.abs(g_a / (np.abs(g_a) + eps) - g_b / (np.abs(g_b) + eps))


def undetermined(g, gmax, tol: float = TOL_TRAIN_GRAD):
    """Where a reference gradient lies within the gradient bound of zero:
    |g| <= tol * (1 + max |g| of its leaf). Adam's step there is ~lr times a
    sign the bound does not fix (see TOL_TRAIN_PARAM's note)."""
    return np.abs(np.asarray(g)) <= tol * (1.0 + np.asarray(gmax))


def check_train_golden(golden, terms: list, params: dict, grads: dict, first: dict) -> dict:
    """Hold train steps' loss terms (one {name: value} a step), the first
    step's gradients, the params after it (``first``) and after the last
    step against the JAX golden: each term within TOL_TRAIN_LOSS * (1 + |b|);
    each seeded gradient entry within TOL_TRAIN_GRAD * (1 + the leaf's max
    |g|); each seeded entry after the first step within TOL_TRAIN_PARAM
    beyond ``adam_first_move`` of the two gradients; after the last step
    within TOL_TRAIN_PARAM, or within 2 * ADAM_STEP * TRAIN_LR a step where
    JAX's first gradient is ``undetermined``; each leaf's sum within
    TOL_TRAIN_PARAM * its size. Returns the worst of each and the count of
    undetermined entries; raises past a bound or on a non-finite value."""
    names = [str(n) for n in golden["term_names"]]
    got_terms = np.array([[float(t[n]) for n in names] for t in terms])
    ref = golden["terms"].astype(np.float64)
    if got_terms.shape != ref.shape:
        raise AssertionError(f"{len(terms)} steps against the golden's {len(ref)}")
    term_err = float((np.abs(got_terms - ref) / (1 + np.abs(ref))).max())
    got = leaf_entries(params, grads, first)
    if set(got) != {k for k in golden.files if "/" in k}:
        raise AssertionError("the params' leaves differ from the golden's")
    move = 2 * ADAM_STEP * TRAIN_LR * len(terms)
    leaves = [k[4:] for k in got if k.startswith("val/")]
    grad_err = max(float(np.abs(got[f"grad/{k}"] - golden[f"grad/{k}"]).max()
                         / (1 + golden[f"gmax/{k}"])) for k in leaves)
    first_err = max(float((np.abs(got[f"val1/{k}"] - golden[f"val1/{k}"])
                           - adam_first_move(got[f"grad/{k}"], golden[f"grad/{k}"])).max())
                    for k in leaves)
    free = {k: undetermined(golden[f"grad/{k}"], golden[f"gmax/{k}"]) for k in leaves}
    diff = {k: np.abs(got[f"val/{k}"] - golden[f"val/{k}"]) for k in leaves}
    entry_err = max([float(diff[k][~free[k]].max()) for k in leaves if (~free[k]).any()])
    free_err = max([float(diff[k][free[k]].max()) for k in leaves if free[k].any()], default=0.0)
    sum_err = max(abs(float(got[f"sum/{k}"]) - float(golden[f"sum/{k}"]))
                  / np.asarray(params[k]).size for k in leaves)
    if not (np.isfinite(got_terms).all() and term_err <= TOL_TRAIN_LOSS
            and grad_err <= TOL_TRAIN_GRAD and first_err <= TOL_TRAIN_PARAM
            and entry_err <= TOL_TRAIN_PARAM and free_err <= move
            and sum_err <= TOL_TRAIN_PARAM):
        raise AssertionError(
            f"train steps against the JAX golden: terms {term_err:.3g} (tol {TOL_TRAIN_LOSS}), "
            f"first gradients {grad_err:.3g} (tol {TOL_TRAIN_GRAD}), entries after step 1 "
            f"beyond Adam's move of the two gradients {first_err:.3g}, after the last "
            f"{entry_err:.3g} (tol {TOL_TRAIN_PARAM}), undetermined entries {free_err:.3g} "
            f"(tol {move:.3g}), sums / size {sum_err:.3g} (tol {TOL_TRAIN_PARAM})")
    return {"terms": term_err, "grads": grad_err, "first": first_err, "entries": entry_err,
            "free": free_err, "n_free": int(sum(f.sum() for f in free.values())),
            "sums": sum_err}


def scene_mesh(objects, size: float = SIZE):
    """A TriMesh of one scene's objects and the table top: boxes as boxes,
    spheres as their circumscribed boxes, for the affordance visualization."""
    from giga_tpu_torch.geometry.mesh import box_mesh, concatenate

    parts = [box_mesh((size, size, 0.002), (size / 2, size / 2, 0.05 * size - 0.001))]
    for kind, center, extent in objects:
        parts.append(box_mesh(2 * np.broadcast_to(extent, (3,)), center))
    return concatenate(parts)


def camera_views(n_views: int = N_VIEWS, size: float = SIZE) -> list:
    """The simulator's extrinsics for an n-view acquisition: cameras on a
    circle around (size/2, size/2, 0), r = 2 size, theta = pi/6, phi = 2 pi
    i / n (giga_tpu/sim/simulation.py acquire_tsdf)."""
    from giga_tpu_torch.core.perception import camera_on_sphere
    from giga_tpu_torch.core.transform import Rotation, Transform

    origin = Transform(Rotation.identity(), np.r_[size / 2, size / 2, 0.0])
    return [camera_on_sphere(origin, 2.0 * size, np.pi / 6.0, 2.0 * np.pi * i / n_views)
            for i in range(n_views)]


def render_depth(objects, extrinsic, size: float = SIZE, width: int = CAMERA[0],
                 height: int = CAMERA[1], fx: float = CAMERA[2], fy: float = CAMERA[3],
                 cx: float = CAMERA[4], cy: float = CAMERA[5]) -> np.ndarray:
    """(H, W) float32 z-depth image of one scene's objects on the table
    plane z = 0.05 * size, ray-cast in float64: the nearest hit of each
    pixel's ray (slabs for boxes, the quadratic for spheres), clipped to the
    camera's far plane DEPTH_RANGE[1], as the simulator's renderer gives it."""
    T_wc = extrinsic.inverse()
    origin = T_wc.translation
    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    dirs = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, float)], -1).reshape(-1, 3)
    dirs = T_wc.rotation.apply(dirs)  # z-depth = t along the unnormalized ray
    t = np.full(len(dirs), np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        plane = (0.05 * size - origin[2]) / dirs[:, 2]
        t = np.where(plane > 0, plane, t)
        for kind, center, extent in objects:
            if kind == "box":
                t0 = (center - extent - origin) / dirs
                t1 = (center + extent - origin) / dirs
                near = np.minimum(t0, t1).max(axis=1)
                far = np.maximum(t0, t1).min(axis=1)
                hit = (near <= far) & (near > 0)
                t = np.where(hit, np.minimum(t, near), t)
            else:
                oc = origin - center
                a = (dirs * dirs).sum(axis=1)
                b = 2.0 * dirs @ oc
                c = oc @ oc - extent ** 2
                disc = b * b - 4 * a * c
                near = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
                t = np.where((disc >= 0) & (near > 0), np.minimum(t, near), t)
    return np.minimum(t, DEPTH_RANGE[1]).reshape(height, width).astype(np.float32)


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


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    """Least time (ms) for the work on the card and what bounds it; ``peak``
    is the operations' rate (PEAK_BF16_FLOPS for a bf16 mode's)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def stem_pool_work(B: int, R: int, C: int, elem: int = 4):
    """(operations, bytes) of K1 on B scenes of R^3 voxels and C channels:
    per voxel and channel 27 multiply-adds, the bias add and 3 pooling adds;
    the TSDF and the weights read once, the three (B, R, R, C) planes written
    once, ``elem`` bytes each (2 in the bf16 mode).
    ``bound(*stem_pool_work(...))`` is K1's bound."""
    N = R ** 3
    return B * N * C * (2 * 27 + 1 + 3), elem * (B * N + 28 * C + 3 * B * R * R * C)


def dense_decode_feats_work(B: int, R: int, C: int, heads: int, H: int, n_blocks: int,
                            O: int):
    """(fp32 operations, bytes) of K4: the per-head trunk with the fc_c bias
    as a fourth plane add, and each block's three C -> heads*H projections
    counted once per plane row; px/py/pz, the raw (B, R, R, C) features and
    every weight read once, the (B, R, R, R, heads*O) output written once.
    ``bound(*dense_decode_feats_work(...))`` is K4's bound."""
    F = heads * H
    proj = B * R * R * n_blocks * 2 * C * F
    flops = trunk_flops(B * R ** 3, heads, H, n_blocks, O, extra_adds=1) + 3 * proj
    weights = 2 * n_blocks * F * H + 2 * n_blocks * F + F * O + heads * O
    inputs = 3 * R * F + 3 * B * R * R * C + 3 * n_blocks * C * F + n_blocks * F + weights
    return flops, 4 * (inputs + B * R ** 3 * heads * O)


def dense_decode_hybrid_work(B: int, R: int, C: int, heads: int, H: int, n_blocks: int,
                             O: int, pyz_elem: int = 4):
    """(operations, bytes) of K5: the per-head trunk, and each block's xz
    and xy C -> heads*H projections counted once per plane row; px/py/pz,
    the raw (B, R, R, C) xz and xy features and every weight read once in
    float32, pyz (B, n_blocks, R, R, heads*H) once at ``pyz_elem`` bytes a
    value (2 in the bf16 mode), the float32 (B, R, R, R, heads*O) output
    written once. ``bound(*dense_decode_hybrid_work(...))`` is K5's bound."""
    F = heads * H
    proj = B * R * R * n_blocks * 2 * C * F
    flops = trunk_flops(B * R ** 3, heads, H, n_blocks, O) + 2 * proj
    weights = 2 * n_blocks * F * H + 2 * n_blocks * F + F * O + heads * O
    inputs = 3 * R * F + 2 * B * R * R * C + 2 * n_blocks * C * F + weights
    return (flops, 4 * (inputs + B * R ** 3 * heads * O)
            + pyz_elem * B * n_blocks * R * R * F)


def ptxas_resources(log: str) -> dict:
    """{kernel name: "N registers, S/L bytes spill stores/loads"} from an
    nvcc -Xptxas -v build log."""
    import re

    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            found.setdefault(name, {})["spills"] = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found.setdefault(name, {})["registers"] = int(m.group(1))
    return {k: f"{v.get('registers')} registers, {v.get('spills', '?')} bytes spill stores/loads"
            for k, v in found.items()}


def kernel_resources(log: str, kernel: str, *older: str) -> str:
    """ptxas_resources of the one kernel whose mangled name contains
    ``kernel``; in the log of an older source that names none, of the one
    that contains the first of ``older`` to name one."""
    found = ptxas_resources(log)
    for name in (kernel, *older):
        hits = [v for k, v in found.items() if name in k]
        if hits:
            break
    if len(hits) != 1:
        raise AssertionError(f"ptxas log names {len(hits)} kernels like {name!r}")
    return hits[0]


def k2_kernel(bf16: bool, point_major: bool = False, fold_b1: bool = False,
              resident_bf16: bool = False) -> str:
    """The mangled name's start of one instance of K2's (K3's, with
    ``point_major``) kernel template in dense_decode.cu, for
    ``kernel_resources``: dense_decode_kernel<kPointMajor, kFoldB1> in
    float32, dense_decode_bf16_tma_kernel<kPointMajor, kFoldB1, kResident>
    in bf16."""
    flags = [point_major, fold_b1] + ([resident_bf16] if bf16 else [])
    return (f"dense_decode{'_bf16_tma' * bf16}_kernelI"
            + "".join(f"Lb{int(f)}E" for f in flags))


def k1_bf16_kernel(R: int) -> str:
    """The mangled name's start of the instance of K1's bf16 kernel
    (stem_pool.cu: stem_pool_bf16_kernel<NTZ>, NTZ m16 tiles of z a slab
    row) that a lattice of R runs, for ``kernel_resources``."""
    return f"stem_pool_bf16_kernelILi{(R + 15) // 16}E"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_close(got, ref, tol: float, what: str):
    """(max |a - b|, max |a - b| / (1 + |b|)); raises past ``tol`` on the
    second or on non-finite values."""
    import torch

    err = float((got - ref).abs().max())
    rel = float(((got - ref).abs() / (1.0 + ref.abs())).max())
    if not (rel <= tol and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{what} differs from its plain version by {rel} > {tol}")
    return err, rel


def check_scaled(got, ref, tol: float, what: str) -> float:
    """max |a - b| / (1 + max |b|); raises past ``tol`` or on non-finite values."""
    import torch

    err = float((got - ref).abs().max() / (1.0 + ref.abs().max()))
    if not (err <= tol and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{what} differs by {err} x (1 + max |ref|) > {tol}")
    return err


def check_bf16(got, ref, what: str, far: float = TOL_BF16_FAR):
    """(share of outputs within TOL_BF16_CLOSE, max |a - b| / (1 + |b|), max
    |a - b|) of a bf16 mode's outputs against a reference on the same
    inputs; raises past the bf16 tolerance (``far``: TOL_BF16_RESIDENT_FAR
    for the resident mode) or on non-finite values."""
    import torch

    got, ref = torch.as_tensor(got).float(), torch.as_tensor(ref).float()
    d = (got - ref).abs()
    share = float((d <= TOL_BF16_CLOSE).double().mean())
    rel = float((d / (1.0 + ref.abs())).max())
    if not (share >= BF16_SHARE and rel <= far and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{what}: {share:.5f} of outputs within {TOL_BF16_CLOSE} (need "
                             f"{BF16_SHARE}), max err/(1+|ref|) {rel:.3g} (tol {far})")
    return share, rel, float(d.max())


def check_bf16_steps(got, ref, what: str, steps: int = 1):
    """Max |a - b| in bf16 steps of bf16 outputs ``got`` against a reference:
    each output's step is 2^(e - 8) for its own exponent e (|got| in
    [2^(e-1), 2^e)), the reference's where the output is 0. Raises past
    ``steps`` or on non-finite values."""
    import torch

    got, ref = torch.as_tensor(got).float(), torch.as_tensor(ref).float()
    exponent = torch.frexp(torch.where(got == 0, ref, got)).exponent
    step = torch.ldexp(torch.ones_like(got), exponent - 8)
    worst = float(((got - ref).abs() / step).max())
    if not (worst <= steps and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{what}: {worst:.3g} bf16 steps from the plain version "
                             f"(tol {steps})")
    return worst


def unflatten_params(arrays, prefix: str = "params/") -> dict:
    """The nested flax parameter tree of the arrays stored under keys
    ``prefix + "a/b/c"`` (``flatten_params``' form)."""
    tree = {}
    for key in arrays:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = np.asarray(arrays[key])
    return {"params": tree}


def flatten_params(params: dict, prefix: str = "params/") -> dict:
    """{prefix + "a/b/c": array} of a flax parameter tree ({"params": ...})."""
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + k + "/")
            else:
                out[path + k] = np.asarray(v, np.float32)

    walk(params["params"], prefix)
    return out


def perturbed_params(params: dict, seed: int = ENSEMBLE_SEED, scale: float = ENSEMBLE_SCALE):
    """A flax parameter tree (nested dicts of numpy arrays) with every leaf
    moved by ``scale`` * its mean magnitude * standard normal draws, leaves
    taken in sorted-key order from one numpy RandomState: the second member
    of the ensemble phase and of its golden file."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        a = np.asarray(tree, np.float32)
        return (a + scale * np.abs(a).mean() * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(params)


def decisions(result, voxel: float) -> list:
    """The lattice voxels a (grasps, scores) result chose, sorted."""
    return sorted(tuple(np.rint(g.pose.translation / voxel).astype(int)) for g in result[0])


def check_qual_bf16(got, ref, what: str):
    """(max, median) of |got - ref| over two bf16 programs' raw qual
    volumes; raises past TOL_QUAL_BF16_MAX or TOL_QUAL_BF16_MEDIAN or on
    non-finite values."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    worst, median = float(d.max()), float(np.median(d))
    if not (worst <= TOL_QUAL_BF16_MAX and median <= TOL_QUAL_BF16_MEDIAN):
        raise AssertionError(f"{what}: raw qual differs by {worst:.4g} at most (tol "
                             f"{TOL_QUAL_BF16_MAX}), {median:.3g} at the median (tol "
                             f"{TOL_QUAL_BF16_MEDIAN})")
    return worst, median


def bf16_gates(ref, got, voxel: float, what: str, overlap_mean: float = 0.65) -> dict:
    """Hold bf16 plans ``got`` against reference plans ``ref`` (lists of
    (grasps, scores) per scene) by tests/test_bf16_serving.py's four
    decision gates: the top-1 score within 5e-3; the top-1 voxel identical
    on at least 60 % of the scenes; candidate-set overlap at least 0.5 on
    every scene and ``overlap_mean`` on average (tests/test_vgn_fast.py
    asks 0.7); the scores of grasps at a voxel both choose within 0.02.
    Raises on a failed gate; returns the readings."""
    def voxels(grasps):
        return [tuple(np.round(g.pose.translation / voxel).astype(int)) for g in grasps]

    top1, same_top1, overlaps, drift = 0.0, 0, [], 0.0
    for i, ((g_ref, s_ref), (g_got, s_got)) in enumerate(zip(ref, got)):
        if not (len(g_ref) and len(g_got)):
            raise AssertionError(f"{what}: scene {i} has {len(g_ref)} vs {len(g_got)} grasps")
        top1 = max(top1, abs(float(s_got[0]) - float(s_ref[0])))
        a, b = voxels(g_ref), voxels(g_got)
        same_top1 += a[0] == b[0]
        overlaps.append(len(set(a) & set(b)) / max(len(a), len(b)))
        by_voxel = dict(zip(a, s_ref))
        drift = max([drift] + [abs(float(s) - float(by_voxel[v])) for v, s in zip(b, s_got)
                               if v in by_voxel])
    n = len(overlaps)
    readings = {"scenes": n, "top1_score_diff": top1, "top1_same": same_top1,
                "overlap_min": min(overlaps), "overlap_mean": float(np.mean(overlaps)),
                "score_drift": drift}
    if not (n and top1 <= 5e-3 and same_top1 >= int(0.6 * n) and min(overlaps) >= 0.5
            and np.mean(overlaps) >= overlap_mean and drift <= 0.02):
        raise AssertionError(f"{what}: a bf16 decision gate failed: {readings}")
    return readings


def compare_grasps(a, b, voxel: float, what: str, tol: float = TOL_SCORE):
    """Hold two (grasps, scores) results equal: the same count and grasp
    positions, scores, widths and quaternions within ``tol``; grasps are
    matched by lattice position, so ties in another order compare equal."""
    (ga, sa), (gb, sb) = a, b
    if len(ga) != len(gb):
        raise AssertionError(f"{what}: {len(ga)} vs {len(gb)} grasps")

    def keyed(grasps, scores):
        return {tuple(np.rint(g.pose.translation / voxel).astype(int)): (g, s)
                for g, s in zip(grasps, scores)}

    ka, kb = keyed(ga, sa), keyed(gb, sb)
    if set(ka) != set(kb) or len(ka) != len(ga):
        raise AssertionError(f"{what}: other grasp positions")
    worst = 0.0
    for key, (g1, s1) in ka.items():
        g2, s2 = kb[key]
        worst = max(worst, abs(s1 - s2), abs(g1.width - g2.width),
                    float(np.abs(g1.pose.rotation.as_quat() - g2.pose.rotation.as_quat()).max()),
                    float(np.abs(g1.pose.translation - g2.pose.translation).max()))
    if not worst <= tol:
        raise AssertionError(f"{what}: differs by {worst} > {tol}")
    return worst


def compare_candidates(a, b, scenes, R: int, what: str, tol: float = TOL_SCORE,
                       index_positions: bool = False) -> dict:
    """Hold two host GraspCandidates sets equal scene by scene: equal
    counts, the same lattice positions, and scores, widths and rotations
    within ``tol``. Candidates are matched by position, so equal scores in
    another order (ties) still compare equal. Positions are GIGA's lattice
    coordinates in [-0.5, 0.5), or VGN's lattice indices with
    ``index_positions``."""
    worst = {"score": 0.0, "width": 0.0, "rot": 0.0, "pos": 0.0}
    for i in scenes:
        n = int(a.count[i])
        if n != int(b.count[i]):
            raise AssertionError(f"{what}: scene {i} has {n} vs {int(b.count[i])} candidates")

        def keyed(c):
            pos = np.asarray(c.positions[i][:n])
            idx = np.rint(pos if index_positions else (pos + 0.5) * R).astype(int)
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
    tol = {"score": tol, "width": tol, "rot": tol, "pos": TOL_POS}
    for name, d in worst.items():
        if not d <= tol[name]:
            raise AssertionError(f"{what}: {name} differs by {d} > {tol[name]}")
    return worst


def bf16_phases(net, cfg, scenes, fp32_results, card, fp32_ms):
    """Phases 13-17, the bf16 serving configuration (GIGAPlanner(precision=
    "bf16")): its kernels against their plain versions, plan_batch,
    PlannerService, __call__ and plan_stream. Returns the program's timings
    and the bf16 kernels' rows for the kernels line."""
    import torch

    from giga_tpu_torch.inference.dense_decode import (
        lattice_coords, sample_planes_on_lattice_batched)
    from giga_tpu_torch.inference.planner import GIGAPlanner, State, full_precision
    from giga_tpu_torch.inference.postprocess import GraspCandidates
    from giga_tpu_torch.inference.serving import PlannerService
    from giga_tpu_torch.ops.kernels import _build
    from giga_tpu_torch.ops.kernels import decoder as dk
    from giga_tpu_torch.ops.kernels.stem import (
        stem_pool_batched, stem_pool_launch_config, stem_pool_plain)

    bf = torch.bfloat16
    planner = GIGAPlanner(net=net, model_cfg=cfg, size=SIZE, rng=np.random.RandomState(0),
                          precision="bf16", **PLANNER_KW)
    bnet = planner.net
    B, R, N = len(scenes), RESOLUTION, RESOLUTION ** 3
    C, n_blocks, H = cfg.encoder.c_dim, cfg.decoder.n_blocks, cfg.decoder.hidden_size
    heads, O = 3, 4
    voxel = SIZE / R
    coords = lattice_coords(R, "cuda")
    conv = bnet.encoder.conv_in
    dec = bnet.decoder_aff.params()
    tsdfs = torch.from_numpy(scenes).cuda().to(bf)

    # 13. the bf16 modes of K1, K2 and K3 against their plain versions
    with torch.inference_mode(), full_precision():
        k1 = stem_pool_batched(conv.weight, conv.bias, tsdfs)
        p1 = stem_pool_plain(conv.weight, conv.bias, tsdfs)
        err1 = [check_bf16(k1[t], p1[t], f"K1 bf16 {t}") for t in k1]
        feats = sample_planes_on_lattice_batched(bnet.encoder.refine(k1), coords, R, 0.0)
        inputs = dk.prepare_projections_batched(dec, feats, coords, n_blocks, bf)
        k2 = dk.dense_decode_batched(*inputs)
        err2 = check_bf16(k2, dk.dense_decode_plain(*inputs), "K2 bf16")
        inputs3 = dk.prepare_projections(dec, {t: v[0] for t, v in feats.items()}, coords,
                                         n_blocks, bf)
        k3 = dk.fused_dense_decode(*inputs3)
        err3 = check_bf16(k3, dk.fused_dense_decode_plain(*inputs3), "K3 bf16")
        torch.cuda.synchronize()
        if not all(v.dtype == bf for v in k1.values()):
            raise AssertionError("K1 bf16 did not write bf16 planes")
        ms1 = cuda_ms(lambda: stem_pool_batched(conv.weight, conv.bias, tsdfs), 50)
        plain1 = cuda_ms(lambda: stem_pool_plain(conv.weight, conv.bias, tsdfs), 20)
        ms2 = cuda_ms(lambda: dk.dense_decode_batched(*inputs), 20)
        plain2 = cuda_ms(lambda: dk.dense_decode_plain(*inputs), 3, warmup=1)
        ms3 = cuda_ms(lambda: dk.fused_dense_decode(*inputs3), 50)
        plain3 = cuda_ms(lambda: dk.fused_dense_decode_plain(*inputs3), 10)
    bounds = {"K1": bound(*stem_pool_work(B, R, C, elem=2), peak=PEAK_BF16_FLOPS),
              "K2": bound(trunk_flops(B * N, heads, H, n_blocks, O),
                          nbytes(*inputs) + 4 * B * heads * O * N, peak=PEAK_BF16_FLOPS),
              "K3": bound(trunk_flops(N, heads, H, n_blocks, O), nbytes(*inputs3, k3),
                          peak=PEAK_BF16_FLOPS)}
    times = {"K1": (ms1, plain1), "K2": (ms2, plain2), "K3": (ms3, plain3)}
    print(f"phase 13: bf16 modes against their plain versions (share within {TOL_BF16_CLOSE}, "
          f"max err/(1+|plain|), max abs err; tol {BF16_SHARE} and {TOL_BF16_FAR}): K1 "
          f"{[tuple(round(x, 6) for x in e) for e in err1]}, K2 "
          f"{tuple(round(x, 6) for x in err2)}, K3 {tuple(round(x, 6) for x in err3)}")
    logs = {name: _build.build_log(name) for name in ("stem_pool", "dense_decode")}
    lc = stem_pool_launch_config(B, R, R, R, C, bf)
    shapes = {"K1": f"{lc['shared_bytes']} bytes shared per block, grid {lc['blocks']} blocks of "
                    f"{lc['threads']} threads"}
    for k, batch, point_major in (("K2", B, False), ("K3", 1, True)):
        lc = dk.dense_decode_launch_config(batch, R, heads, n_blocks, point_major, bf)
        shapes[k] = (f"{lc['shared_bytes']} bytes shared per block, grid {lc['grid'][0]}x"
                     f"{lc['grid'][1]} blocks of {lc['threads']} threads ({lc['warps']} warps "
                     f"taking tiles, pyz ring of {lc['stages']} stages, slabs of "
                     f"{lc['slab'][0]} z x {lc['slab'][1]} y in {lc['slab_stages']} stages), "
                     f"{lc['blocks_per_sm']} "
                     f"resident blocks per SM on {lc['sms']} SMs")
    mangled = {"K1": ("stem_pool", k1_bf16_kernel(R)),
               "K2": ("dense_decode", k2_kernel(True)),
               "K3": ("dense_decode", k2_kernel(True, point_major=True))}
    for k, (lib, name) in mangled.items():
        ms, plain = times[k]
        bnd = bounds[k]
        print(f"phase 13: {k} bf16 resources: {kernel_resources(logs[lib], name)}, {shapes[k]}; "
              f"{ms:.4f} ms (plain {plain:.4f} ms, float32 mode {fp32_ms[k]:.4f} ms), "
              f"{bnd[0] / ms:.1%} of its bound ({bnd[0]:.4f} ms by {bnd[1]}) | {card}")
    del k2, inputs

    # 14. the bf16 main path: plan_batch, counters zeroed just before
    stem_pool_batched.launches = 0
    dk.dense_decode_batched.launches = 0
    results = planner.plan_batch(scenes)
    torch.cuda.synchronize()
    launches = {"stem_pool": stem_pool_batched.launches,
                "dense_decode": dk.dense_decode_batched.launches}
    if launches != {"stem_pool": 1, "dense_decode": 1}:
        raise AssertionError(f"bf16 plan_batch launched {launches}")
    for i, (grasps, scores) in enumerate(results):
        if not (np.isfinite(scores).all() and (scores >= PLANNER_KW["low_th"]).all()
                and all(np.all(np.abs(g.pose.translation / SIZE - 0.5) <= 0.5) for g in grasps)):
            raise AssertionError(f"bf16 scene {i}: candidates out of range")
    gates32 = bf16_gates(fp32_results, results, voxel, "bf16 vs float32 plan_batch")
    golden_bf16 = np.load(Path(__file__).resolve().parent / GOLDEN_BF16)
    np.testing.assert_allclose(golden_bf16["tsdf"], scenes[:len(golden_bf16["tsdf"])], atol=1e-6)
    gb = GraspCandidates(*(golden_bf16[f] for f in GraspCandidates._fields))
    n_gold = len(gb.count)
    golden_grasps = [planner._to_grasps(GraspCandidates(*(np.asarray(x[i]) for x in gb)))
                     for i in range(n_gold)]
    gates_gold = bf16_gates(golden_grasps, results[:n_gold], voxel, "bf16 vs JAX bf16 golden")
    print(f"phase 14: bf16 plan_batch B={B}: {sum(len(g) for g, _ in results)} grasps; launches "
          f"{launches}; against float32 plan_batch {gates32}; against the JAX TPU bf16 golden "
          f"candidates {gates_gold}")

    # 15. PlannerService in bf16
    n_req = B + B // 2
    with PlannerService(planner, batch_size=B, max_wait_ms=5.0) as svc:
        served = [f.result(timeout=300) for f in [svc.submit(scenes[i % B]) for i in range(n_req)]]
    for i, got in enumerate(served):
        compare_grasps(got, results[i % B], voxel, f"bf16 service scene {i}", tol=1e-6)
    print(f"phase 15: bf16 PlannerService served {n_req} requests, each equal to bf16 plan_batch")

    # 16. bf16 __call__ on the golden scenes (K3 bf16) and plan_stream
    golden_call = np.load(Path(__file__).resolve().parent / GOLDEN_CALL_BF16)
    np.testing.assert_allclose(golden_call["tsdf"], scenes[:n_gold], atol=1e-6)
    gc = GraspCandidates(*(golden_call[f] for f in GraspCandidates._fields))
    call_grasps = [planner._to_grasps(GraspCandidates(*(np.asarray(x[i]) for x in gc)))
                   for i in range(n_gold)]
    dk.fused_dense_decode.launches = 0
    called = [planner(State(tsdf=scenes[i][None]))[:2] for i in range(n_gold)]
    torch.cuda.synchronize()
    if dk.fused_dense_decode.launches != n_gold:
        raise AssertionError(f"bf16 __call__ launched K3 {dk.fused_dense_decode.launches} times "
                             f"in {n_gold} calls")
    gates_call = bf16_gates(call_grasps, called, voxel,
                            "bf16 __call__ vs JAX bf16 GIGAPlanner.__call__ golden")
    gates_call32 = bf16_gates(fp32_results[:n_gold], called, voxel, "bf16 __call__ vs float32")
    n_stream = 8
    for i, got in enumerate(planner.plan_stream(scenes[:n_stream])):
        compare_grasps(got, planner(State(tsdf=scenes[i]))[:2], voxel,
                       f"bf16 plan_stream vs __call__, scene {i}", tol=1e-6)
    print(f"phase 16: bf16 __call__ on {n_gold} golden scenes, K3 bf16 launches {n_gold}: against "
          f"the golden of JAX's bf16 GIGAPlanner.__call__ {gates_call}, against float32 "
          f"plan_batch {gates_call32}; plan_stream over {n_stream} scenes equals per-scene "
          f"__call__")

    # 17. timings of the bf16 programs
    fn = planner._ensure_batched_fn()
    raw = torch.from_numpy(scenes).cuda()
    plan_ms = cuda_ms(lambda: fn(raw, raw), 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        planner.plan_batch(scenes)
    sps = 5 * B / (time.perf_counter() - t0)
    state = State(tsdf=scenes[0][None])
    for _ in range(3):
        planner(state)
    t0 = time.perf_counter()
    for _ in range(20):
        planner(state)
    call_ms = (time.perf_counter() - t0) / 20 * 1e3
    for k, name in (("K1", "stem_pool"), ("K2", "dense_decode"), ("K3", "fused_dense_decode")):
        ms, plain = times[k]
        print(f"{k} {name} bf16: {ms:.4f} ms (plain {plain:.4f} ms, bound {bounds[k][0]:.4f} ms "
              f"by {bounds[k][1]}) {'one scene' if k == 'K3' else f'B={B}'} R={R} | {card}")
    n_launch = {"K1": launches["stem_pool"], "K2": launches["dense_decode"], "K3": n_gold}
    errs = {"K1": max(e[2] for e in err1), "K2": err2[2], "K3": err3[2]}
    rows = [(f"{name}_bf16", source, replaces, n_launch[k], errs[k], *times[k], bounds[k])
            for k, name, source, replaces in (
                ("K1", "stem_pool", "stem_pool.cu", "stem_kernel.py:120"),
                ("K2", "dense_decode", "dense_decode.cu", "decoder_kernel.py:348"),
                ("K3", "fused_dense_decode", "dense_decode.cu", "decoder_kernel.py:153"))]
    rows += bf16_decode_phase(dec, feats, coords, cfg, card, fp32_ms)
    return {"plan_ms": plan_ms, "sps": sps, "call_ms": call_ms}, rows


def bf16_decode_phase(dec, feats, coords, cfg, card, fp32_ms):
    """Phase 18, the bf16 decode A/B's kernels on the bf16 net's decoder
    params ``dec`` and bf16 lattice features ``feats`` {t: (B, R, R, C)}:
    the bf16 modes of K4 and K5 against their plain versions; the memory a
    call allocates beside its output (the bf16 workspace of the rounded
    features, no float32 rows); the two bf16 decode entry points with the
    counters zeroed just before; their raw qual against K2 bf16's decode.
    Returns the kernels' rows for the kernels line."""
    import torch

    from giga_tpu_torch.inference.planner import full_precision
    from giga_tpu_torch.ops.kernels import _build
    from giga_tpu_torch.ops.kernels import decoder as dk

    bf = torch.bfloat16
    B, R, _, C = feats["xz"].shape
    n_blocks, H = cfg.decoder.n_blocks, cfg.decoder.hidden_size
    heads, O = 3, 4
    with torch.inference_mode(), full_precision():
        inputs4 = dk.prepare_feats_inputs(dec, feats, coords, n_blocks)
        inputs5 = dk.prepare_hybrid_inputs(dec, feats, coords, n_blocks, bf)
        errs = {"K4": check_bf16(dk.dense_decode_feats_batched(*inputs4, compute_dtype=bf),
                                 dk.dense_decode_feats_plain(*inputs4, compute_dtype=bf),
                                 "K4 bf16"),
                "K5": check_bf16(dk.dense_decode_hybrid_batched(*inputs5),
                                 dk.dense_decode_hybrid_plain(*inputs5), "K5 bf16")}
        # what a call allocates beside its output: the workspace of the
        # rounded feature planes, (planes, B, R, R, C) bf16, and nothing else
        work = {}
        for k, call, planes in (
                ("K4", lambda: dk.dense_decode_feats_batched(*inputs4, compute_dtype=bf), 3),
                ("K5", lambda: dk.dense_decode_hybrid_batched(*inputs5), 2)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out = call()
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - before - nbytes(out)
            del out
            workspace = planes * B * R * R * C * 2
            if extra > workspace + (1 << 21):  # the allocator rounds each block up to 2 MB
                raise AssertionError(f"{k} bf16 allocated {extra} bytes beside its output, more "
                                     f"than its {workspace}-byte bf16 workspace")
            work[k] = (extra, workspace)
        qual2 = dk.decode_affordance_dense_kernel_batched(dec, feats, coords, n_blocks, bf)[0]
        # the bf16 decode entry points, counters zeroed just before
        dk.dense_decode_feats_batched.launches = 0
        dk.dense_decode_hybrid_batched.launches = 0
        vols = {"K4": dk.decode_affordance_dense_kernel_feats_batched(dec, feats, coords, n_blocks,
                                                                      compute_dtype=bf),
                "K5": dk.decode_affordance_dense_kernel_hybrid_batched(dec, feats, coords, n_blocks,
                                                                       compute_dtype=bf)}
        torch.cuda.synchronize()
        launches = {"K4": dk.dense_decode_feats_batched.launches,
                    "K5": dk.dense_decode_hybrid_batched.launches}
        if launches != {"K4": 1, "K5": 1}:
            raise AssertionError(f"the bf16 decode entry points launched {launches}")
        quals = {}
        for k, vol in vols.items():
            if not all(bool(torch.isfinite(v).all()) for v in vol):
                raise AssertionError(f"{k} bf16's decode gave non-finite volumes")
            quals[k] = check_qual_bf16(vol[0].cpu().numpy(), qual2.cpu().numpy(),
                                       f"{k} bf16 decode vs K2 bf16's")
        del vols, qual2
        times = {"K4": (cuda_ms(lambda: dk.dense_decode_feats_batched(*inputs4, compute_dtype=bf),
                                20),
                        cuda_ms(lambda: dk.dense_decode_feats_plain(*inputs4, compute_dtype=bf),
                                3, warmup=1)),
                 "K5": (cuda_ms(lambda: dk.dense_decode_hybrid_batched(*inputs5), 20),
                        cuda_ms(lambda: dk.dense_decode_hybrid_plain(*inputs5), 3, warmup=1))}
    bounds = {"K4": bound(*dense_decode_feats_work(B, R, C, heads, H, n_blocks, O),
                          peak=PEAK_BF16_FLOPS),
              "K5": bound(*dense_decode_hybrid_work(B, R, C, heads, H, n_blocks, O, pyz_elem=2),
                          peak=PEAK_BF16_FLOPS)}
    print(f"phase 18: K4 and K5 bf16 against their plain versions (share within "
          f"{TOL_BF16_CLOSE}, max err/(1+|plain|), max abs err): "
          f"{ {k: tuple(round(x, 6) for x in e) for k, e in errs.items()} }; their bf16 decode "
          f"entry points launched {launches}, raw qual against K2 bf16's decode (max, median; "
          f"tol {TOL_QUAL_BF16_MAX}, {TOL_QUAL_BF16_MEDIAN}): "
          f"{ {k: tuple(round(x, 6) for x in q) for k, q in quals.items()} }")
    log = _build.build_log("dense_decode_feats")
    for k, hybrid in (("K4", False), ("K5", True)):
        lc = dk.dense_decode_feats_launch_config(B, R, C, heads, n_blocks,
                                                 R if hybrid else dk.FEATS_X_CHUNK, hybrid, bf)
        ms, plain = times[k]
        bnd = bounds[k]
        kernel = f"dense_decode_feats_bf16_kernelILb{int(not hybrid)}E"
        print(f"phase 18: {k} bf16 resources: kernel {kernel_resources(log, kernel)}, rounding "
              f"prologue {kernel_resources(log, 'round_features_kernel')}; {lc['shared_bytes']} "
              f"bytes shared per block, grid {lc['grid'][0]}x{lc['grid'][1]} blocks of "
              f"{lc['threads']} threads, {lc['blocks_per_sm']} resident blocks per SM on "
              f"{lc['sms']} SMs, {lc['passes']} pass; allocated beside its output "
              f"{work[k][0] / 1e6:.1f} MB (bf16 workspace {work[k][1] / 1e6:.1f} MB, no float32 "
              f"rows); {ms:.4f} ms (plain {plain:.4f} ms, float32 mode {fp32_ms[k]:.4f} ms), "
              f"{bnd[0] / ms:.1%} of its bound ({bnd[0]:.4f} ms by {bnd[1]}) B={B} R={R} | {card}")
    return [(f"{name}_bf16", "dense_decode_feats.cu", replaces, launches[k], errs[k][2],
             *times[k], bounds[k])
            for k, name, replaces in (("K4", "dense_decode_feats", "decoder_kernel.py:608"),
                                      ("K5", "dense_decode_hybrid", "decoder_kernel.py:447"))]


def options_phase(net, cfg, scenes, feats, default_cands, card):
    """Phase 19, K2's numeric options (the TPU kernel's fold_b1, hidden_bf16
    and resident_bf16) at B=64, R=40: each option's kernel against its plain
    version; the batched program with fold_b1 (float32) and with fold_b1 and
    hidden_bf16 (bf16), counters zeroed just before each, against the golden
    files and the default program, and return_raw's candidates equal to the
    program's; resident_bf16 through the decode entry point, counters
    zeroed; each option's kernel timed beside K2's default mode. Returns the
    kernels' rows for the kernels line."""
    import copy

    import torch

    from giga_tpu_torch.inference.dense_decode import (
        lattice_coords, sample_planes_on_lattice_batched)
    from giga_tpu_torch.inference.planner import (
        GIGAPlanner, build_batched_giga_planner_fn, candidates_to_host, full_precision)
    from giga_tpu_torch.inference.postprocess import GraspCandidates
    from giga_tpu_torch.models.encoder import encode_planes_fused
    from giga_tpu_torch.ops.kernels import _build
    from giga_tpu_torch.ops.kernels import decoder as dk
    from giga_tpu_torch.ops.kernels.stem import stem_pool_batched

    bf = torch.bfloat16
    B, R, N = len(scenes), RESOLUTION, RESOLUTION ** 3
    n_blocks, H, P = cfg.decoder.n_blocks, cfg.decoder.hidden_size, cfg.encoder.plane_resolution
    heads, O = 3, 4
    voxel = SIZE / R
    coords = lattice_coords(R, "cuda")
    tsdfs = torch.from_numpy(scenes).cuda()
    bnet = copy.deepcopy(net).to(bf)
    dec, bdec = net.decoder_aff.params(), bnet.decoder_aff.params()
    planner = GIGAPlanner(net=net, model_cfg=cfg, size=SIZE, rng=np.random.RandomState(0),
                          **PLANNER_KW)
    pcfg = planner.planner_cfg

    def grasps(cands, n):
        return [planner._to_grasps(GraspCandidates(*(np.asarray(x[i]) for x in cands)))
                for i in range(n)]

    def zero_counters():
        stem_pool_batched.launches = 0
        dk.dense_decode_batched.entry_launches.clear()

    def counters():
        return {"stem_pool": stem_pool_batched.launches, **dk.dense_decode_batched.entry_launches}

    # each option's kernel against its plain version; (inputs, fold_b1, resident_bf16)
    with torch.inference_mode(), full_precision():
        bfeats = sample_planes_on_lattice_batched(encode_planes_fused(bnet.encoder, tsdfs.to(bf)),
                                                  coords, P, cfg.decoder.padding)
        inputs = {(torch.float32, fold): dk.prepare_projections_batched(
                      dec, feats, coords, n_blocks, fold_b1=fold) for fold in (False, True)}
        inputs.update({(bf, fold): dk.prepare_projections_batched(
                           bdec, bfeats, coords, n_blocks, bf, fold_b1=fold)
                       for fold in (False, True)})
        modes = {dk.dense_decode_entry(dtype, fold, res): (dtype, fold, res)
                 for dtype, fold, res in dk.K2_MODES}
        errs, outs = {}, {}
        for entry, (dtype, fold, res) in modes.items():
            args = inputs[dtype, fold]
            outs[entry] = dk.dense_decode_batched(*args, fold_b1=fold, resident_bf16=res)
            plain = dk.dense_decode_plain(*args, fold_b1=fold, resident_bf16=res)
            if dtype == torch.float32:
                errs[entry] = check_close(outs[entry], plain, TOL_DECODE, entry)
            else:
                errs[entry] = check_bf16(outs[entry], plain, entry,
                                         TOL_BF16_RESIDENT_FAR if res else TOL_BF16_FAR)
            del plain
        if torch.equal(outs["dense_decode_bf16_resident"], outs["dense_decode_bf16"]):
            raise AssertionError("resident_bf16 gave the default bf16 mode's outputs")
        hidden = [dk.decode_affordance_dense_kernel_batched(bdec, bfeats, coords, n_blocks, bf,
                                                            fold_b1=True, hidden_bf16=h)
                  for h in (True, False)]
        if not all(torch.equal(a, b) for a, b in zip(*hidden)):
            raise AssertionError("hidden_bf16 changed the bf16 mode's volumes")
        del outs, hidden
    print(f"phase 19: K2's options against their plain versions (float32: max abs err, max "
          f"err/(1+|plain|), tol {TOL_DECODE}; bf16: share within {TOL_BF16_CLOSE}, max "
          f"err/(1+|plain|), max abs err; tol {BF16_SHARE} and {TOL_BF16_FAR}, resident "
          f"{TOL_BF16_RESIDENT_FAR}): "
          f"{ {k: tuple(round(x, 6) for x in e) for k, e in errs.items()} }; resident_bf16 "
          f"differs from the default bf16 mode; hidden_bf16's volumes torch.equal to fold_b1's")

    # the main path with the options, counters zeroed just before each program
    fns = {name: build_batched_giga_planner_fn(n, cfg, pcfg, SIZE, use_kernels=True, fold_b1=True,
                                               hidden_bf16=name == "bf16")
           for name, n in (("fp32", net), ("bf16", bnet))}
    launches, cands = {}, {}
    for name, fn in fns.items():
        zero_counters()
        cands[name] = candidates_to_host(fn(tsdfs, tsdfs))
        torch.cuda.synchronize()
        launches[name] = counters()
    expect = {"fp32": {"stem_pool": 1, "dense_decode_f32_fold": 1},
              "bf16": {"stem_pool": 1, "dense_decode_bf16_fold": 1}}
    if launches != expect:
        raise AssertionError(f"the option programs launched {launches}, expected {expect}")
    root = Path(__file__).resolve().parent
    golden = np.load(root / GOLDEN)
    gc = GraspCandidates(*(golden[f] for f in GraspCandidates._fields))
    n_gold = len(gc.count)
    worst_gold = compare_candidates(cands["fp32"], gc, range(n_gold), R,
                                    "fold_b1 plan vs JAX golden")
    worst_default = compare_candidates(cands["fp32"], default_cands, range(B), R,
                                       "fold_b1 plan vs the default plan")
    golden_fold = np.load(root / GOLDEN_BF16_FOLD)
    np.testing.assert_allclose(golden_fold["tsdf"], scenes[:n_gold], atol=1e-6)
    gf = GraspCandidates(*(golden_fold[f] for f in GraspCandidates._fields))
    gates = bf16_gates(grasps(gf, n_gold), grasps(cands["bf16"], n_gold), voxel,
                       "bf16 fold_b1 + hidden_bf16 plan vs JAX golden")
    raw_fns = {name: build_batched_giga_planner_fn(n, cfg, pcfg, SIZE, use_kernels=True,
                                                   fold_b1=True, hidden_bf16=name == "bf16",
                                                   return_raw=True)
               for name, n in (("fp32", net), ("bf16", bnet))}
    raws = {}
    for name, fn in raw_fns.items():
        got, raws[name] = fn(tsdfs, tsdfs)
        got = candidates_to_host(got)
        if not all(np.array_equal(a, b) for a, b in zip(got, cands[name])):
            raise AssertionError(f"{name} return_raw changed the candidates")
        shapes = [tuple(v.shape) for v in raws[name]]
        if (shapes != [(B, R, R, R), (B, 4, N), (B, R, R, R)]
                or any(v.dtype != torch.float32 for v in raws[name])):
            raise AssertionError(f"{name} return_raw gave {shapes}")
    qual_gold = check_qual_bf16(raws["bf16"][0][:n_gold].cpu().numpy(), golden_fold["qual"],
                                "bf16 fold_b1 + hidden_bf16 raw qual vs JAX golden")
    print(f"phase 19: batched program with fold_b1, launches {launches['fp32']}, "
          f"{int(cands['fp32'].count.sum())} candidates: equal to the JAX golden (max diffs "
          f"{worst_gold}) and to the default program on {B} scenes (max diffs {worst_default}); "
          f"bf16 with fold_b1 and hidden_bf16, launches {launches['bf16']}: against the JAX TPU "
          f"bf16 fold golden {gates}, raw qual (max, median) {qual_gold}; return_raw: candidates "
          f"equal in both, volumes of shapes {shapes}")
    del raws

    # resident_bf16 through the decode entry point, counters zeroed just before
    with torch.inference_mode(), full_precision():
        qual = dk.decode_affordance_dense_kernel_batched(bdec, bfeats, coords, n_blocks, bf)[0]
        zero_counters()
        vols = [dk.decode_affordance_dense_kernel_batched(bdec, bfeats, coords, n_blocks, bf,
                                                          fold_b1=fold, resident_bf16=True)
                for fold in (False, True)]
        torch.cuda.synchronize()
        launches_res = counters()
        del launches_res["stem_pool"]
        if launches_res != {"dense_decode_bf16_resident": 1, "dense_decode_bf16_resident_fold": 1}:
            raise AssertionError(f"the resident_bf16 decodes launched {launches_res}")
        if not all(bool(torch.isfinite(v).all()) for vol in vols for v in vol):
            raise AssertionError("a resident_bf16 decode gave non-finite volumes")
        qual_res = [check_qual_bf16(vol[0].cpu().numpy(), qual.cpu().numpy(),
                                    "resident_bf16 qual vs the default bf16 mode's")
                    for vol in vols]
        del vols, qual
        times = {}
        for entry, (dtype, fold, res) in modes.items():
            args = inputs[dtype, fold]
            times[entry] = (
                cuda_ms(lambda: dk.dense_decode_batched(*args, fold_b1=fold, resident_bf16=res),
                        20),
                cuda_ms(lambda: dk.dense_decode_plain(*args, fold_b1=fold, resident_bf16=res), 3,
                        warmup=1))
    print(f"phase 19: resident_bf16 decode entry point, launches {launches_res}; raw qual "
          f"against the default bf16 mode's (max, median; without and with fold_b1): "
          f"{[tuple(round(x, 6) for x in q) for q in qual_res]}")
    log = _build.build_log("dense_decode")
    rows, n_launch = [], {**launches["fp32"], **launches["bf16"], **launches_res}
    for entry, (dtype, fold, res) in modes.items():
        is_bf16 = dtype == bf
        bnd = bound(trunk_flops(B * N, heads, H, n_blocks, O, fold_b1=fold),
                    nbytes(*inputs[dtype, fold]) + 4 * B * heads * O * N,
                    peak=PEAK_BF16_FLOPS if is_bf16 else PEAK_FP32_FLOPS)
        lc = dk.dense_decode_launch_config(B, R, heads, n_blocks, dtype=dtype, fold_b1=fold,
                                           resident_bf16=res)
        ms, plain = times[entry]
        print(f"phase 19: {entry}: {kernel_resources(log, k2_kernel(is_bf16, False, fold, res))}, "
              f"{lc['shared_bytes']} bytes shared per block, grid {lc['grid'][0]}x"
              f"{lc['grid'][1]} blocks of {lc['threads']} threads, {lc['blocks_per_sm']} resident "
              f"blocks per SM; {ms:.4f} ms (plain {plain:.4f} ms), {bnd[0] / ms:.1%} of its bound "
              f"({bnd[0]:.4f} ms by {bnd[1]}) B={B} R={R} | {card}")
        if fold or res:
            err = errs[entry][0] if dtype == torch.float32 else errs[entry][2]
            name = entry.replace("_f32", "")
            rows.append((name, "dense_decode.cu", "decoder_kernel.py:348", n_launch[entry], err,
                         ms, plain, bnd))
    return rows


def kernel_counts(all_five: bool = False) -> dict:
    """The launch counts of K1, K2 and K3 (and K4 and K5 with ``all_five``)."""
    from giga_tpu_torch.ops.kernels import decoder as dk
    from giga_tpu_torch.ops.kernels.stem import stem_pool_batched

    counts = {"K1": stem_pool_batched.launches, "K2": dk.dense_decode_batched.launches,
              "K3": dk.fused_dense_decode.launches}
    if all_five:
        counts.update(K4=dk.dense_decode_feats_batched.launches,
                      K5=dk.dense_decode_hybrid_batched.launches)
    return counts


def zero_kernel_counts(all_five: bool = False) -> None:
    from giga_tpu_torch.ops.kernels import decoder as dk
    from giga_tpu_torch.ops.kernels.stem import stem_pool_batched

    stem_pool_batched.launches = 0
    dk.dense_decode_batched.launches = 0
    dk.fused_dense_decode.launches = 0
    if all_five:
        dk.dense_decode_feats_batched.launches = 0
        dk.dense_decode_hybrid_batched.launches = 0


def presets_phase(net, scenes, card) -> dict:
    """Phase 20: every preset plans on the card through the kernels' shape
    predicates. The giga_wide preset (c_dim and hidden 64) with seeded
    weights through __call__, plan_stream, plan_batch (B=64) and
    PlannerService, in float32 and bf16: each program's paths (K1 for the
    batched encode, the module decode: K2 and K3 take hidden 32 only), the
    launch counts of each entry point with the counters zeroed just before,
    the decisions against the same planner on the CPU; then the shipped
    checkpoint at plane resolution 48 (past K1's float32 limit), whose
    batched program must encode with net.encode and decode with K2. Returns
    the giga_wide programs' times."""
    import copy
    import dataclasses

    import torch

    from giga_tpu_torch.core.config import giga
    from giga_tpu_torch.inference.planner import (
        GIGAPlanner, State, build_batched_giga_planner_fn, candidates_to_host)
    from giga_tpu_torch.inference.serving import PlannerService
    from giga_tpu_torch.models.conv_onet import GIGANet
    from giga_tpu_torch.models.registry import init_network
    from giga_tpu_torch.ops.kernels.stem import can_stem_pool

    B, R = len(scenes), RESOLUTION
    voxel = SIZE / R
    n_cpu = 4
    wide, wcfg = init_network("giga_wide", WIDE_SEED)
    expect_paths = {"__call__": {"encode": "module", "decode": "module"},
                    "plan_batch": {"encode": "K1", "decode": "module"}}
    times = {}
    for precision in ("fp32", "bf16"):
        planners = {}
        for device in ("cuda", "cpu"):
            planner = GIGAPlanner(net=copy.deepcopy(wide), model_cfg=wcfg, size=SIZE,
                                  precision=precision,
                                  rng=np.random.RandomState(0), device=device, **WIDE_KW)
            planner.planner_cfg = dataclasses.replace(
                planner.planner_cfg, min_width=WIDE_WIDTHS[0], max_width=WIDE_WIDTHS[1])
            planners[device] = planner
        card_p, cpu_p = planners["cuda"], planners["cpu"]
        paths = {"__call__": card_p._ensure_fn().paths,
                 "plan_batch": card_p._ensure_batched_fn().paths}
        if paths != expect_paths or cpu_p._ensure_batched_fn().paths != paths["plan_batch"]:
            raise AssertionError(f"giga_wide {precision} programs chose {paths}")
        zero_kernel_counts()
        batch = card_p.plan_batch(scenes)
        torch.cuda.synchronize()
        n_batch = kernel_counts()
        zero_kernel_counts()
        called = [card_p(State(tsdf=scenes[i]))[:2] for i in range(n_cpu)]
        streamed = card_p.plan_stream(scenes[:n_cpu])
        torch.cuda.synchronize()
        n_call = kernel_counts()
        zero_kernel_counts()
        with PlannerService(card_p, batch_size=B, max_wait_ms=5.0) as svc:
            served = [f.result(timeout=300) for f in [svc.submit(scenes[i]) for i in range(n_cpu)]]
            n_served_batches = svc.stats()["batches"]
        torch.cuda.synchronize()
        n_service = kernel_counts()
        expect = ({"K1": 1, "K2": 0, "K3": 0}, {"K1": 0, "K2": 0, "K3": 0},
                  {"K1": n_served_batches, "K2": 0, "K3": 0})
        if (n_batch, n_call, n_service) != expect:
            raise AssertionError(f"giga_wide {precision} launched {n_batch} (plan_batch), "
                                 f"{n_call} (__call__ and plan_stream), {n_service} (service)")
        for i in range(n_cpu):
            compare_grasps(streamed[i], called[i], voxel, f"giga_wide plan_stream {i}", tol=1e-6)
            compare_grasps(served[i], batch[i], voxel, f"giga_wide service {i}", tol=1e-6)
        # the same planner on the CPU: raw volumes, then the decisions
        tsdf_cpu = torch.from_numpy(scenes[:n_cpu])
        raw_fns = {d: build_batched_giga_planner_fn(p.net, wcfg, p.planner_cfg, SIZE,
                                                    use_kernels=True, return_raw=True)
                   for d, p in planners.items()}
        raw = {d: [v.float().cpu() for v in fn(tsdf_cpu.to(d), tsdf_cpu.to(d))[1]]
               for d, fn in raw_fns.items()}
        qual_diff = float((raw["cuda"][0] - raw["cpu"][0]).abs().max())
        batch_cpu = cpu_p.plan_batch(scenes[:n_cpu])
        called_cpu = [cpu_p(State(tsdf=scenes[i]))[:2] for i in range(n_cpu)]
        print(f"phase 20: giga_wide {precision} on the card against the CPU: raw qual max diff "
              f"{qual_diff:.3g}; grasps a scene {[len(g) for g, _ in batch[:n_cpu]]} (card), "
              f"{[len(g) for g, _ in batch_cpu]} (CPU)")
        if precision == "fp32":
            worst = max(max(compare_grasps(batch[i], batch_cpu[i], voxel,
                                           f"giga_wide plan_batch {i} vs CPU"),
                            compare_grasps(called[i], called_cpu[i], voxel,
                                           f"giga_wide __call__ {i} vs CPU"))
                        for i in range(n_cpu))
            against = f"decisions equal to the CPU planner's (max diff {worst:.3g})"
        else:
            steps = check_bf16_steps(raw["cuda"][0], raw["cpu"][0],
                                     "giga_wide bf16 raw qual vs the CPU's", WIDE_BF16_STEPS)
            equal = sum(decisions(batch[i], voxel) == decisions(batch_cpu[i], voxel)
                        for i in range(n_cpu))
            against = (f"raw qual within {steps:.3g} bf16 steps of the CPU planner's (tol "
                       f"{WIDE_BF16_STEPS}); decisions equal on {equal} of {n_cpu}")
        fn = card_p._ensure_batched_fn()
        grids = torch.from_numpy(scenes).cuda()
        times[precision] = cuda_ms(lambda: fn(grids, grids), 5)
        print(f"phase 20: giga_wide {precision}: paths {paths}; launches plan_batch {n_batch}, "
              f"__call__ and plan_stream {n_call}, PlannerService ({n_served_batches} batches) "
              f"{n_service}; {sum(len(g) for g, _ in batch)} grasps on B={B}; on {n_cpu} "
              f"scenes {against}; plan_batch program {times[precision]:.3f} ms/batch | {card}")

    # past K1's float32 limit: plane resolution 48
    P = 48
    cfg48 = dataclasses.replace(giga(), encoder=dataclasses.replace(giga().encoder,
                                                                    plane_resolution=P))
    net48 = GIGANet(cfg48)
    net48.load_state_dict(net.state_dict())
    net48 = net48.cuda().eval()
    tsdf48 = torch.from_numpy(make_scenes(B, resolution=P)).cuda()
    proc = torch.from_numpy(scenes).cuda()
    planner48 = GIGAPlanner(net=net48, model_cfg=cfg48, size=SIZE, **PLANNER_KW)
    fn48 = planner48._ensure_batched_fn()
    if fn48.paths != {"encode": "module", "decode": "K2"} or can_stem_pool(B, P, P, P, 32):
        raise AssertionError(f"plane resolution {P} chose {fn48.paths}")
    zero_kernel_counts()
    c48 = candidates_to_host(fn48(tsdf48, proc))
    torch.cuda.synchronize()
    n48 = kernel_counts()
    if n48 != {"K1": 0, "K2": 1, "K3": 0}:
        raise AssertionError(f"plane resolution {P} launched {n48}")
    plain48 = build_batched_giga_planner_fn(net48, cfg48, planner48.planner_cfg, SIZE)
    worst48 = compare_candidates(c48, candidates_to_host(plain48(tsdf48, proc)), range(B), R,
                                 f"plane resolution {P} vs its module program")
    print(f"phase 20: plane resolution {P} (K1 takes Y * ceil(Z / 4) <= 416): paths "
          f"{fn48.paths}, launches {n48}, {int(c48.count.sum())} candidates equal to the module "
          f"program's (max diffs {worst48})")
    return times


def ensemble_phase(params: dict, scenes, card) -> dict:
    """Phase 21: checkpoint ensembles, GIGAPlanner(params=[...]), with two
    members: the shipped checkpoint ``params`` and its perturbed copy
    (``perturbed_params``); each combiner, float32 then bf16. [ckpt, ckpt]
    against the checkpoint alone (raw volumes within TOL_ENSEMBLE_SAME,
    equal candidates); the two-member __call__ on the golden scenes with
    the K3 counter zeroed just before (two launches a call), in float32
    against the JAX golden (golden_call_giga_ensemble.npz: candidates, raw
    qual within TOL_VOLUME), in bf16 by the four decision gates against the
    float32 ensemble; plan_stream equal to per-scene calls; plan_batch
    raising NotImplementedError. Returns the __call__ latencies."""
    import torch

    from giga_tpu_torch.inference.planner import (
        GIGAPlanner, State, build_ensemble_giga_planner_fn, build_giga_planner_fn,
        candidates_to_host)
    from giga_tpu_torch.inference.postprocess import GraspCandidates
    from giga_tpu_torch.ops.kernels import decoder as dk

    R = RESOLUTION
    voxel = SIZE / R
    golden = np.load(Path(__file__).resolve().parent / GOLDEN_ENSEMBLE)
    n = len(golden["tsdf"])
    np.testing.assert_allclose(golden["tsdf"], scenes[:n], atol=1e-6)
    second = perturbed_params(params)
    kw = dict(size=SIZE, rng=np.random.RandomState(0), **PLANNER_KW)
    results, times = {}, {}
    for precision in ("fp32", "bf16"):
        single = GIGAPlanner(params=params, precision=precision, **kw)
        for combine in ("mean", "max"):
            same = GIGAPlanner(params=[params, params], ensemble_combine=combine,
                               precision=precision, **kw)
            two = GIGAPlanner(params=[params, second], ensemble_combine=combine,
                              precision=precision, **kw)
            pcfg = single.planner_cfg
            fn1 = build_giga_planner_fn(single.net, single.model_cfg, pcfg, SIZE,
                                        use_kernels=True, return_raw=True)
            fn2 = build_ensemble_giga_planner_fn(same.net, same.stacked, same.model_cfg, pcfg,
                                                 SIZE, combine, use_kernels=True, return_raw=True)
            if not fn2.paths == fn1.paths == {"encode": "module", "decode": "K3"}:
                raise AssertionError(f"ensemble programs chose {fn1.paths}, {fn2.paths}")
            worst_same = 0.0
            for i in range(n):
                g = torch.from_numpy(scenes[i]).cuda()
                (c1, raw1), (c2, raw2) = fn1(g, g), fn2(g, g)
                worst_same = max([worst_same] + [float((a - b).abs().max())
                                                 for a, b in zip(raw1, raw2)])
                c1, c2 = candidates_to_host(c1), candidates_to_host(c2)
                compare_candidates(GraspCandidates(*(x[None] for x in c1)),
                                   GraspCandidates(*(x[None] for x in c2)), [0], R,
                                   f"[ckpt, ckpt] {combine} {precision} vs ckpt, scene {i}")
            if not worst_same <= TOL_ENSEMBLE_SAME:
                raise AssertionError(f"[ckpt, ckpt] {combine} {precision}: raw volumes differ "
                                     f"from the checkpoint's by {worst_same}")
            dk.fused_dense_decode.launches = 0
            called = [two(State(tsdf=scenes[i]))[:2] for i in range(n)]
            torch.cuda.synchronize()
            if dk.fused_dense_decode.launches != 2 * n:
                raise AssertionError(f"ensemble {combine} {precision} launched K3 "
                                     f"{dk.fused_dense_decode.launches} times in {n} calls")
            for i, got in enumerate(two.plan_stream(scenes[:n])):
                compare_grasps(got, called[i], voxel, f"ensemble plan_stream {i}", tol=1e-6)
            try:
                two.plan_batch(scenes[:1])
            except NotImplementedError:
                pass
            else:
                raise AssertionError("plan_batch planned an ensemble")
            if precision == "fp32":
                gc = GraspCandidates(*(golden[f"{combine}_{f}"] for f in GraspCandidates._fields))
                worst = max(compare_grasps(got, two._to_grasps(GraspCandidates(
                    *(np.asarray(x[i]) for x in gc))), voxel, f"ensemble {combine} vs golden {i}")
                            for i, got in enumerate(called))
                fn = build_ensemble_giga_planner_fn(two.net, two.stacked, two.model_cfg, pcfg,
                                                    SIZE, combine, use_kernels=True,
                                                    return_raw=True)
                quals = np.stack([fn(g, g)[1][0].cpu().numpy() for g in
                                  (torch.from_numpy(scenes[i]).cuda() for i in range(n))])
                qual_err = float(np.abs(quals - golden[f"{combine}_qual"]).max())
                if not qual_err <= TOL_VOLUME:
                    raise AssertionError(f"ensemble {combine} raw qual differs from the JAX "
                                         f"golden by {qual_err} > {TOL_VOLUME}")
                against = f"the JAX golden (max diff {worst:.3g}, raw qual {qual_err:.3g})"
            else:
                gates = bf16_gates(results["fp32", combine], called, voxel,
                                   f"bf16 ensemble {combine} vs float32")
                against = f"the float32 ensemble by the four gates {gates}"
            results[precision, combine] = called
            state = State(tsdf=scenes[0])
            for _ in range(3):
                two(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                two(state)
            times[precision, combine] = (time.perf_counter() - t0) / 20 * 1e3
            print(f"phase 21: ensemble {combine} {precision}: [ckpt, ckpt] within "
                  f"{worst_same:.3g} of ckpt alone; two members on {n} golden scenes "
                  f"({sum(len(g) for g, _ in called)} grasps, K3 launches {2 * n}) equal to "
                  f"{against}; plan_stream equals __call__; plan_batch raises; __call__ "
                  f"{times[precision, combine]:.3f} ms | {card}")
    return times


def points_phase(scenes, card) -> dict:
    """Phase 22: decoding at arbitrary points, at full width, with no kernel
    (the JAX package runs none there either; the counters are zeroed just
    before and read after). The shipped giga_geo checkpoint (sampler "mm")
    encodes a scene and decodes occupancy at N_QUERIES seeded uniform
    points in [-0.5, 0.5]^3, and again with the "gather" sampler; the
    shipped giga checkpoint runs forward (affordance and occupancy),
    grad_refine (2 steps of lr 1e-2) and decode_lattice_points at N_POINTS
    seeded lattice indices (the points of the other two). Each result
    against the same call on the CPU, decode_lattice_points also against
    the lattice decode (decode_affordance_dense) at the same indices, all
    within TOL_POINTS. Returns each call's time (ms, CUDA events)."""
    import copy
    import dataclasses

    import torch

    from giga_tpu_torch.inference.dense_decode import (
        decode_affordance_dense, decode_lattice_points, lattice_coords,
        sample_planes_on_lattice)
    from giga_tpu_torch.inference.planner import lattice_positions
    from giga_tpu_torch.models.conv_onet import GIGANet, normalize_quat
    from giga_tpu_torch.models.registry import load_network

    root = Path(__file__).resolve().parent
    R = RESOLUTION
    rng = np.random.RandomState(SEED)
    queries = rng.uniform(-0.5, 0.5, (1, N_QUERIES, 3)).astype(np.float32)
    idx = rng.randint(0, R, (3, N_POINTS))
    tsdf = scenes[:1]
    geo, gcfg = load_network(root / GEO_CHECKPOINT, "giga_geo")
    gather_cfg = dataclasses.replace(gcfg, decoder=dataclasses.replace(gcfg.decoder,
                                                                       sampler="gather"))
    geo_gather = GIGANet(gather_cfg)
    geo_gather.load_state_dict(geo.state_dict())
    giga, _ = load_network(root / CHECKPOINT)

    def heads(raw):
        return torch.sigmoid(raw[0, :, 0]), normalize_quat(raw[1]), raw[2, :, 0]

    def calls(device) -> dict:
        """{name: (thunk, its outputs)} of every call, on ``device``."""
        t = torch.from_numpy(tsdf).to(device)
        q = torch.from_numpy(queries).to(device)
        ix, iy, iz = (torch.from_numpy(i).to(device) for i in idx)
        coords = lattice_coords(R, device)
        p = lattice_positions(coords)[ix, iy, iz][None]
        nets = {k: copy.deepcopy(n).to(device) for k, n in
                (("mm", geo), ("gather", geo_gather), ("giga", giga))}
        dec = nets["giga"].decoder_aff.params()

        def lattice_points():
            planes = nets["giga"].encode(t)
            feats = sample_planes_on_lattice({k: v[0] for k, v in planes.items()}, coords, R, 0.0)
            return heads(decode_lattice_points(dec, feats, coords, ix, iy, iz,
                                               giga.cfg.decoder.n_blocks)), feats

        thunks = {
            "occupancy_mm": lambda: nets["mm"].decode_occupancy(nets["mm"].encode(t), q),
            "occupancy_gather": lambda: nets["gather"].decode_occupancy(
                nets["gather"].encode(t), q),
            "forward": lambda: nets["giga"](t, p, p),
            "grad_refine": lambda: nets["giga"].grad_refine(t, p, 0.0125, 1e-2, 2),
            "lattice_points": lambda: lattice_points()[0],
        }
        with torch.inference_mode():
            out = {k: f() for k, f in thunks.items() if k != "lattice_points"}
            out["lattice_points"], feats = lattice_points()
            dense = decode_affordance_dense(dec, feats, coords, giga.cfg.decoder.n_blocks)
            out["lattice_dense"] = tuple(v[ix, iy, iz] for v in dense)
        if not float((out["grad_refine"][1] - p).abs().max()) > 1e-4:
            raise AssertionError("grad_refine did not move the points")
        return thunks, out

    def flat(v):
        if isinstance(v, dict):
            return [v[k] for k in sorted(v)]
        return list(v) if isinstance(v, (tuple, list)) else [v]

    zero_kernel_counts()
    thunks, card_out = calls("cuda")
    _, cpu_out = calls("cpu")
    torch.cuda.synchronize()
    launches = kernel_counts()
    if any(launches.values()):
        raise AssertionError(f"decoding at points launched {launches}")
    errs = {}
    for k, got in card_out.items():
        if k.startswith("occupancy"):
            errs[k] = check_scaled(got.cpu(), cpu_out[k], TOL_POINTS, f"{k} on points")
            continue
        pairs = list(zip(flat(got), flat(cpu_out[k])))
        if k == "lattice_points":
            pairs += list(zip(flat(got), flat(card_out["lattice_dense"])))
        errs[k] = max(check_close(a.float().cpu(), b.float().cpu(), TOL_POINTS,
                                  f"{k} on points")[1] for a, b in pairs)
    with torch.inference_mode():  # the CPU's own float32 logits against float64
        geo64 = copy.deepcopy(geo).double()
        ref64 = geo64.decode_occupancy(geo64.encode(torch.from_numpy(tsdf).double()),
                                       torch.from_numpy(queries).double())
        own = float((cpu_out["occupancy_mm"].double() - ref64).abs().max()
                    / (1 + ref64.abs().max()))
    with torch.inference_mode():
        times = {k: cuda_ms(f, 10) for k, f in thunks.items() if k != "grad_refine"}
    times["grad_refine"] = cuda_ms(thunks["grad_refine"], 10)
    print(f"phase 22: decoding at points, each against the CPU within {TOL_POINTS} * (1 + |b|), "
          f"the occupancy logits within {TOL_POINTS} * (1 + max |b|) (decode_lattice_points "
          f"also against the lattice decode): max err/(1+|b|) "
          f"{ {k: float(f'{e:.3g}') for k, e in errs.items()} } (the CPU's own float32 "
          f"logits against float64: {own:.3g}); kernel launches {launches} (none expected)")
    print(f"phase 22: encode + {N_QUERIES} occupancy queries (giga_geo): sampler mm "
          f"{times['occupancy_mm']:.3f} ms, gather {times['occupancy_gather']:.3f} ms; giga at "
          f"{N_POINTS} points: forward {times['forward']:.3f} ms, grad_refine (2 steps) "
          f"{times['grad_refine']:.3f} ms, encode + decode_lattice_points "
          f"{times['lattice_points']:.3f} ms | {card}")
    return times


def stack_candidates(cands) -> "GraspCandidates":
    """Host candidates of single-scene runs stacked along a scene axis."""
    from giga_tpu_torch.inference.postprocess import GraspCandidates

    return GraspCandidates(*(np.stack(f) for f in zip(*cands)))


def compare_meshes(got, ref, what: str) -> float:
    """Hold two composed scenes equal: faces and face colors equal,
    vertices within TOL_VERTEX. Returns the vertices' largest difference."""
    if got.faces.shape != ref.faces.shape or not np.array_equal(got.faces, ref.faces):
        raise AssertionError(f"{what}: faces differ ({len(got.faces)} vs {len(ref.faces)})")
    if not np.array_equal(got.face_colors, ref.face_colors):
        raise AssertionError(f"{what}: {int((got.face_colors != ref.face_colors).any(1).sum())} "
                             f"face colors differ")
    worst = float(np.abs(got.vertices - ref.vertices).max())
    if not worst <= TOL_VERTEX:
        raise AssertionError(f"{what}: vertices differ by {worst} > {TOL_VERTEX}")
    return worst


def vgn_phase(scenes, card) -> dict:
    """Phase 23: VGN at full width (40^3, filters 16/32/64, k=5 heads) with
    the golden file's seeded weights (VGN_* recipe). VGNPlanner in each
    precision: plan_batch on the B scenes and __call__ on the golden
    scenes, with the kernel counters zeroed just before (VGN runs no kernel
    of this package: cuDNN convolutions); ``highest``'s batched and
    single-scene candidates against JAX's (golden_plan_vgn.npz: equal
    positions, values within TOL_SCORE, raw qual within TOL_VOLUME), its
    batch against its single-scene program (positions equal, values within
    TOL_BATCH); ``default`` (TF32) and ``bf16`` against ``highest`` by
    tests/test_vgn_fast.py's four gates; the composed scene of
    ``visualize=True``. Returns ms per batch (CUDA events) and the
    ``__call__`` latency (host clock) of each precision."""
    import torch

    from giga_tpu_torch.inference.planner import (
        State, VGNPlanner, build_vgn_planner_fn, candidates_to_host)
    from giga_tpu_torch.inference.postprocess import GraspCandidates

    root = Path(__file__).resolve().parent
    golden = np.load(root / GOLDEN_VGN)
    n = len(golden["tsdf"])
    np.testing.assert_allclose(golden["tsdf"], scenes[:n], atol=1e-6)
    params = unflatten_params(golden)
    R, B = RESOLUTION, len(scenes)
    voxel = SIZE / R
    grids = torch.from_numpy(scenes).cuda()
    planners, batch, called, out = {}, {}, {}, {}
    for precision in ("highest", "default", "bf16"):
        planner = VGNPlanner(params=params, precision=precision, size=SIZE,
                             rng=np.random.RandomState(0), **VGN_KW)
        zero_kernel_counts()
        batch[precision] = planner.plan_batch(scenes)
        called[precision] = [planner(State(tsdf=scenes[i]))[:2] for i in range(n)]
        torch.cuda.synchronize()
        if any(kernel_counts().values()):
            raise AssertionError(f"VGN {precision} launched a kernel: {kernel_counts()}")
        planners[precision] = planner
    hi = planners["highest"]
    fn = build_vgn_planner_fn(hi.net, hi.planner_cfg, SIZE, precision="highest", return_raw=True)
    singles, quals = [], []
    for g in grids:
        c, raw = fn(g, g)
        singles.append(candidates_to_host(c))
        quals.append(raw[0].cpu().numpy())
    single = stack_candidates(singles)
    cb = candidates_to_host(hi._ensure_batched_fn()(grids, grids))
    gold = {k: GraspCandidates(*(golden[f"{k}_{f}"] for f in GraspCandidates._fields))
            for k in ("single", "batch")}
    worst = {"single": compare_candidates(single, gold["single"], range(n), R,
                                          "VGN single vs JAX golden", index_positions=True),
             "batch": compare_candidates(cb, gold["batch"], range(n), R,
                                         "VGN batch vs JAX golden", index_positions=True),
             "batch_vs_single": compare_candidates(cb, single, range(B), R,
                                                   "VGN batch vs single", tol=TOL_BATCH,
                                                   index_positions=True)}
    qual_err = float(np.abs(np.stack(quals[:n]) - golden["single_qual"]).max())
    if not qual_err <= TOL_VOLUME:
        raise AssertionError(f"VGN raw qual differs from the JAX golden by {qual_err}")
    for i in range(n):
        compare_grasps(called["highest"][i], batch["highest"][i], voxel,
                       f"VGN __call__ vs plan_batch, scene {i}", tol=TOL_BATCH)
    gates = {}
    for precision in ("default", "bf16"):
        gates[precision] = bf16_gates(batch["highest"], batch[precision], voxel,
                                      f"VGN {precision} plan_batch vs highest",
                                      overlap_mean=VGN_OVERLAP_MEAN)
        bf16_gates(called["highest"], called[precision], voxel,
                   f"VGN {precision} __call__ vs highest", overlap_mean=VGN_OVERLAP_MEAN)
    counts = [len(g) for g, _ in batch["highest"]]
    print(f"phase 23: VGN plan_batch B={B} ({sum(counts)} grasps, {min(counts)}..{max(counts)} "
          f"per scene) and __call__ on {n} golden scenes, no kernel launched; highest equal to "
          f"the JAX golden (max diffs single {worst['single']}, batch {worst['batch']}; raw qual "
          f"{qual_err:.3g}), batch equal to single on all {B} scenes (max diffs "
          f"{worst['batch_vs_single']})")
    for precision, g in gates.items():
        print(f"phase 23: VGN {precision} against highest by the four gates: {g}")
    viz = VGNPlanner(params=params, precision="highest", size=SIZE, visualize=True, **VGN_KW)
    objects = scene_objects(1)[0]
    grasps, scores, _, composed = viz(State(tsdf=scenes[0]), scene_mesh=scene_mesh(objects))
    if not (len(grasps) and len(composed.faces) > len(scene_mesh(objects).faces)):
        raise AssertionError("VGN visualize composed no grasps")
    for precision, planner in planners.items():
        vfn = planner._ensure_batched_fn()
        with torch.inference_mode():
            out[precision, "batch_ms"] = cuda_ms(lambda: vfn(grids, grids), 10)
        state = State(tsdf=scenes[0])
        for _ in range(3):
            planner(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            planner(state)
        out[precision, "call_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    print(f"phase 23: VGN batched program B={B}: " + ", ".join(
        f"{p} {out[p, 'batch_ms']:.3f} ms" for p in planners) + "; __call__ " + ", ".join(
        f"{p} {out[p, 'call_ms']:.3f} ms" for p in planners) + f"; visualize composed "
          f"{len(composed.faces)} faces | {card}")
    return out


def fusion_phase(card) -> dict:
    """Phase 24: TSDF fusion at the simulator's settings. The golden file's
    ray-cast views (N_VIEWS at 640x480) fused on the card at 40^3 against
    JAX's fuse_views (tsdf within TOL_TSDF, weights equal) and against the
    port's CPU run, and at 120^3 against the CPU run; the same views
    rendered afresh here against the golden's (reported); then FUSION_SCENES
    scenes fused into TSDFVolumes (create_tsdf) and planned from them with
    GIGA plan_batch (kernel counters zeroed just before: one K1 and one K2
    launch), GIGA __call__ (one K3 launch each) and VGN __call__, each
    against the same planner on the CPU. Returns fusion ms per scene."""
    import torch

    from giga_tpu_torch.core.perception import CameraIntrinsic, create_tsdf
    from giga_tpu_torch.inference.planner import GIGAPlanner, State, VGNPlanner
    from giga_tpu_torch.ops.tsdf import fuse_views

    root = Path(__file__).resolve().parent
    golden = np.load(root / GOLDEN_FUSION)
    views = camera_views()
    fresh = np.stack([render_depth(scene_objects(1)[0], e) for e in views])
    render_diff = float(np.abs(fresh - golden["depth"][0]).max())
    K = torch.from_numpy(golden["K"])
    E = torch.from_numpy(golden["extrinsics"])
    errs = {"golden40": 0.0, "cpu40": 0.0, "cpu120": 0.0}
    times = {}
    for i, depth in enumerate(golden["depth"]):
        d = torch.from_numpy(depth)
        for res in (RESOLUTION, FUSION_HIGH_RES):
            kw = dict(resolution=res, size=SIZE, sdf_trunc=4 * SIZE / res)
            card_t, card_w = (t.cpu().numpy() for t in fuse_views(d.cuda(), K.cuda(), E.cuda(),
                                                                  **kw))
            cpu_t, cpu_w = (t.numpy() for t in fuse_views(d, K, E, **kw))
            pairs = [("cpu%d" % res, cpu_t, cpu_w)]
            if res == RESOLUTION:
                pairs.append(("golden40", golden["tsdf"][i], golden["weight"][i]))
            for name, t, w in pairs:
                if not np.array_equal(card_w, w):
                    raise AssertionError(f"fused {res}^3 weights of scene {i} differ from {name}")
                errs[name] = max(errs[name], float(np.abs(card_t - t).max()))
            if i == 0:
                dc, Kc, Ec = d.cuda(), K.cuda(), E.cuda()
                times[f"fuse{res}_ms"] = cuda_ms(lambda: fuse_views(dc, Kc, Ec, **kw), 10)
    bad = {k: e for k, e in errs.items() if not e <= TOL_TSDF}
    if bad:
        raise AssertionError(f"fused volumes differ by {bad} > {TOL_TSDF}")
    w_, h_, fx, fy, cx, cy = CAMERA
    intrinsic = CameraIntrinsic(w_, h_, fx, fy, cx, cy)
    lists = np.stack([e.to_list() for e in views])
    depths = list(golden["depth"]) + [
        np.stack([render_depth(objects, e) for e in views])
        for objects in scene_objects(FUSION_SCENES)[len(golden["depth"]):]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    volumes = [create_tsdf(SIZE, RESOLUTION, d, intrinsic, lists) for d in depths]
    torch.cuda.synchronize()
    times["create_tsdf_ms"] = (time.perf_counter() - t0) / len(depths) * 1e3
    cpu_volumes = [create_tsdf(SIZE, RESOLUTION, d, intrinsic, lists, device="cpu")
                   for d in depths]
    for v, c in zip(volumes, cpu_volumes):
        if not (np.array_equal(v.weight.cpu().numpy(), c.weight.numpy())
                and float(np.abs(v.get_grid() - c.get_grid()).max()) <= TOL_TSDF):
            raise AssertionError("a TSDFVolume on the card differs from the CPU's")
    grids = np.concatenate([v.get_grid() for v in volumes])
    root_ckpt = root / CHECKPOINT
    kw = dict(size=SIZE, rng=np.random.RandomState(0), **PLANNER_KW)
    giga, giga_cpu = GIGAPlanner(root_ckpt, **kw), GIGAPlanner(root_ckpt, device="cpu", **kw)
    voxel = SIZE / RESOLUTION
    zero_kernel_counts()
    batch = giga.plan_batch(grids)
    torch.cuda.synchronize()
    launches_batch = kernel_counts()
    zero_kernel_counts()
    called = [giga(State(tsdf=v))[:2] for v in volumes]
    torch.cuda.synchronize()
    launches_call = kernel_counts()
    if not (launches_batch["K1"] == 1 and launches_batch["K2"] == 1
            and launches_call["K3"] == len(volumes)):
        raise AssertionError(f"planning from fused volumes launched {launches_batch} "
                             f"(plan_batch), {launches_call} (__call__)")
    for i, (b, c) in enumerate(zip(batch, giga_cpu.plan_batch(grids))):
        compare_grasps(b, c, voxel, f"GIGA plan_batch of fused scene {i} vs the CPU")
    for i, (v, c) in enumerate(zip(called, cpu_volumes)):
        compare_grasps(v, giga_cpu(State(tsdf=c))[:2], voxel,
                       f"GIGA __call__ of fused scene {i} vs the CPU")
        compare_grasps(v, batch[i], voxel, f"GIGA __call__ vs plan_batch, fused scene {i}")
    params = unflatten_params(np.load(root / GOLDEN_VGN))
    vgn = VGNPlanner(params=params, precision="highest", size=SIZE, **VGN_KW)
    vgn_cpu = VGNPlanner(params=params, precision="highest", size=SIZE, device="cpu", **VGN_KW)
    for i, (v, c) in enumerate(zip(volumes, cpu_volumes)):
        compare_grasps(vgn(State(tsdf=v))[:2], vgn_cpu(State(tsdf=c))[:2], voxel,
                       f"VGN __call__ of fused scene {i} vs the CPU")
    n_grasps = sum(len(g) for g, _ in batch)
    print(f"phase 24: fused {len(golden['depth'])} golden scenes ({N_VIEWS} views of "
          f"{CAMERA[0]}x{CAMERA[1]}): 40^3 against JAX's fuse_views within "
          f"{errs['golden40']:.3g}, against the CPU within {errs['cpu40']:.3g}, 120^3 against "
          f"the CPU within {errs['cpu120']:.3g} (tol {TOL_TSDF}, weights equal); views "
          f"rendered here against the golden's: {render_diff:.3g} m")
    print(f"phase 24: planned from {len(volumes)} fused TSDFVolumes: GIGA plan_batch "
          f"({n_grasps} grasps) launches {launches_batch}, __call__ launches {launches_call}, "
          f"VGN __call__; each equal to the CPU planner's")
    print(f"phase 24: fusion of {N_VIEWS} views a scene: fuse_views 40^3 "
          f"{times[f'fuse{RESOLUTION}_ms']:.3f} ms, 120^3 {times[f'fuse{FUSION_HIGH_RES}_ms']:.3f} ms "
          f"(CUDA events, depth on the card); create_tsdf 40^3 from host depth "
          f"{times['create_tsdf_ms']:.3f} ms (host clock) | {card}")
    return {"launches_batch": launches_batch, "launches_call": launches_call, **times}


def visual_phase(scenes, card) -> None:
    """Phase 25: affordance visualization. GIGAPlanner and VGNPlanner with
    ``visualize=True`` on the card, each composed scene (the scene mesh
    colored by the raw qual volume, a glyph per grasp) against the same
    planner's on the CPU: faces and colors equal, vertices within
    TOL_VERTEX."""
    from giga_tpu_torch.inference.planner import GIGAPlanner, State, VGNPlanner

    root = Path(__file__).resolve().parent
    params = unflatten_params(np.load(root / GOLDEN_VGN))
    made = {
        "GIGA": lambda device: GIGAPlanner(root / CHECKPOINT, size=SIZE, visualize=True,
                                           device=device, **PLANNER_KW),
        "VGN": lambda device: VGNPlanner(params=params, precision="highest", size=SIZE,
                                         visualize=True, device=device, **VGN_KW)}
    readings = []
    for i, objects in enumerate(scene_objects(2)):
        mesh = scene_mesh(objects)
        for name, make in made.items():
            card_out = make(None)(State(tsdf=scenes[i]), scene_mesh=mesh)
            cpu_out = make("cpu")(State(tsdf=scenes[i]), scene_mesh=mesh)
            compare_grasps(card_out[:2], cpu_out[:2], SIZE / RESOLUTION,
                           f"{name} visualize grasps, scene {i}")
            worst = compare_meshes(card_out[3], cpu_out[3], f"{name} composed scene {i}")
            readings.append(f"{name} scene {i}: {len(card_out[0])} grasps, "
                            f"{len(card_out[3].faces)} faces, vertices within {worst:.3g}")
    print("phase 25: visualize=True on the card equals the CPU's composed scenes: "
          + "; ".join(readings) + f" | {card}")


def compare_train_step(net, cfg, batch: dict, device: str, dtype=None, sampler="mm",
                       tol_grad: float = TOL_TRAIN_GRAD) -> dict:
    """One train step of ``net`` on ``device`` against the CPU port's on the
    same weights and batch: the loss within TOL_TRAIN_LOSS * |b|; each
    gradient leaf within ``tol_grad`` * (1 + max |g|) of the CPU's, or, past
    that, within TOL_TRAIN_GRAD_F64 * (1 + max |g|) of a float64 run of the
    step on the CPU (float32's own reach, TOL_TRAIN_GRAD_F64's note); the
    params after the step within TOL_TRAIN_PARAM beyond ``adam_first_move``
    of the two gradients. Returns the card's loss, the worst of each error
    (against the CPU, the card's and the CPU's against float64), the count
    of leaves held by float64 (the float64 step runs only when one is), the
    largest ``adam_first_move``, and the state after the card's step."""
    import copy

    import torch

    from giga_tpu_torch.core.device import to_device
    from giga_tpu_torch.train.trainer import create_train_state, make_value_and_grad

    out = {}
    for dev in (device, "cpu"):
        state = create_train_state(copy.deepcopy(net), device=dev)
        (loss, _), grads = make_value_and_grad(state.module, cfg, dtype, sampler)(
            state.params, to_device(batch, dev))
        state.apply_gradients(grads)
        out[dev] = float(loss), {k: g.float().cpu() for k, g in zip(state.params, grads)}, state
    (loss, grads, state), (ref_loss, ref_grads, ref_state) = out[device], out["cpu"]

    def scaled(a, ref) -> float:
        return float((a.double() - ref.double()).abs().max()) / (1 + float(ref.abs().max()))

    errs = {k: scaled(grads[k], g) for k, g in ref_grads.items()}
    grads64 = None
    if max(errs.values()) > tol_grad:  # a float64 run only where a leaf needs it
        net64 = copy.deepcopy(net).double()
        batch64 = {k: torch.from_numpy(np.asarray(v, np.float64 if v.dtype == np.float32
                                                  else v.dtype)) for k, v in batch.items()}
        grads64 = dict(zip(ref_grads, make_value_and_grad(net64, cfg, dtype, sampler)(
            dict(net64.named_parameters()), batch64)[1]))
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    worst = {"cpu": 0.0, "f64": 0.0, "own": 0.0, "share": 0.0, "params": 0.0, "moved": 0.0}
    n_f64 = 0
    for k, g in ref_grads.items():
        err, share = errs[k], errs[k] / tol_grad
        if err > tol_grad:
            n_f64 += 1
            err64 = scaled(grads[k], grads64[k])
            share = min(share, err64 / TOL_TRAIN_GRAD_F64)
            worst["f64"] = max(worst["f64"], err64)
            worst["own"] = max(worst["own"], scaled(g, grads64[k]))
        worst["cpu"], worst["share"] = max(worst["cpu"], err), max(worst["share"], share)
        d = (state.params[k].detach().cpu() - ref_state.params[k].detach()).abs().numpy()
        adam = adam_first_move(grads[k].numpy(), g.numpy())
        worst["params"] = max(worst["params"], float((d - adam).max()))
        worst["moved"] = max(worst["moved"], float(adam.max()))
    if not (np.isfinite(loss) and loss_err <= TOL_TRAIN_LOSS and worst["share"] <= 1.0
            and worst["params"] <= TOL_TRAIN_PARAM):
        raise AssertionError(
            f"train step on {device} against the CPU: loss {loss_err:.3g} (tol "
            f"{TOL_TRAIN_LOSS}), gradients {worst['cpu']:.3g} against the CPU (tol {tol_grad}), "
            f"{worst['f64']:.3g} against float64 (tol {TOL_TRAIN_GRAD_F64}; the CPU's own "
            f"{worst['own']:.3g}), params beyond Adam's move of the two gradients "
            f"{worst['params']:.3g} (tol {TOL_TRAIN_PARAM})")
    return {"loss": loss, "loss_err": loss_err, "grad_err": worst["cpu"],
            "grad_err64": worst["f64"], "own_err": worst["own"], "n_f64": int(n_f64),
            "param_err": worst["params"], "adam_move": worst["moved"], "state": state}


def chain_step_ms(step, state, batch, reps: int = 3) -> float:
    """Marginal ms a train step on the card: CUDA events around chains of 9
    and of 1 chained steps (bench.py's train protocol), the least of
    ``reps`` each, (t9 - t1) / 8."""
    import torch

    def chain(n):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            step(state, batch)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    lo = min(chain(1) for _ in range(reps))
    hi = min(chain(9) for _ in range(reps))
    return (hi - lo) / 8


def train_phase(card, device: str = "cuda", batch_size: int = TRAIN_BATCH,
                points: int = TRAIN_POINTS) -> dict:
    """Phase 26: GIGA training on the card (the port's train/ package), no
    kernel of this package (training reaches none in the JAX package: XLA
    autodiff of the module path; here autograd of the same modules), the
    counters zeroed just before and read after.
      a. three fp32 steps (mm sampler) from the shipped checkpoint on the
         golden's seeded batch (B=8, 512 points) against the JAX golden
         (``check_train_golden``);
      b. at full width (giga, B=32, 2048 occupancy points a sample) in three
         variants, fp32 mm, fp32 gather and bf16 mm: one step against the
         CPU port's (``compare_train_step``; gather's gradients at
         TOL_TRAIN_GRAD_GATHER, bf16's loss within TOL_TRAIN_BF16_LOSS of the
         fp32 step's and its master params and moments float32), then 10
         chained steps on one batch (every loss finite, the last below the
         first), then the step's time (``chain_step_ms``), kernels launched
         a step and the device's idle share (torch.profiler) and its peak
         memory;
      c. giga_geo (its shipped checkpoint) and VGN (the VGN golden's
         weights): one fp32 step each at full width against the CPU port;
      d. the device corpus: 16 of ``make_scenes``' scenes in load_corpus's
         layout (``make_corpus``, written as shards and loaded back),
         ``assemble_batch`` on the card equal to the CPU's for every k,
         then 5 corpus steps from ``CorpusSampler`` draws;
      e. ``Trainer.fit``, 2 epochs of 4 batches into a temporary logdir: last
         and best .msgpack, history.jsonl, tensorboard events and the state
         checkpoint written; ``try_resume`` restores the epoch, the params
         and Adam's moments exactly; the saved .msgpack loads through
         ``load_network`` equal to the trained module.
    ``device``, ``batch_size`` and ``points`` let the phase rehearse on the
    CPU at a small size (no timings there). Returns the timings."""
    import copy
    import tempfile

    import torch

    from giga_tpu_torch.core.config import TrainConfig
    from giga_tpu_torch.core.device import to_device
    from giga_tpu_torch.models.convert import flax_to_state_dict
    from giga_tpu_torch.models.registry import get_network, load_network
    from giga_tpu_torch.train import corpus as tc
    from giga_tpu_torch.train.trainer import (
        Trainer, create_train_state, fetch_terms, make_train_step, make_value_and_grad)

    root = Path(__file__).resolve().parent
    on_card = device != "cpu"
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    net, cfg = load_network(root / CHECKPOINT)
    zero_kernel_counts()

    # a. the JAX golden
    state = create_train_state(copy.deepcopy(net), device=device)
    gb = to_device(train_batch(SEED, GOLDEN_TRAIN_BATCH, GOLDEN_TRAIN_POINTS), device)
    _, grads = make_value_and_grad(state.module, cfg)(state.params, gb)
    grads = {k: g.cpu().numpy() for k, g in zip(state.params, grads)}
    step = make_train_step(state.module, cfg)

    def host_params():  # a copy: on the CPU .numpy() shares the live weights
        return {k: v.detach().cpu().numpy().copy() for k, v in state.params.items()}

    terms = [step(state, gb)[1]]
    first = host_params()
    terms += [step(state, gb)[1] for _ in range(GOLDEN_TRAIN_STEPS - 1)]
    terms = fetch_terms(terms)
    golden_err = check_train_golden(np.load(root / GOLDEN_TRAIN), terms, host_params(), grads,
                                    first)
    print(f"phase 26: {GOLDEN_TRAIN_STEPS} fp32 steps (B={GOLDEN_TRAIN_BATCH}, "
          f"{GOLDEN_TRAIN_POINTS} points) against the JAX golden: loss terms within "
          f"{golden_err['terms']:.3g} * (1 + |b|) (tol {TOL_TRAIN_LOSS}), first gradients "
          f"within {golden_err['grads']:.3g} * (1 + max |g|) (tol {TOL_TRAIN_GRAD}), params' "
          f"seeded entries after step 1 within {golden_err['first']:.3g} beyond Adam's move "
          f"of the two gradients, after step {GOLDEN_TRAIN_STEPS} within "
          f"{golden_err['entries']:.3g} (tol {TOL_TRAIN_PARAM}; {golden_err['n_free']} entries "
          f"undetermined by their first gradient within {golden_err['free']:.3g}, tol "
          f"{2 * ADAM_STEP * TRAIN_LR * GOLDEN_TRAIN_STEPS:.3g}), leaf sums within "
          f"{golden_err['sums']:.3g} a value; loss_all "
          + " -> ".join(f"{t['loss_all']:.5f}" for t in terms))

    # b. full width, three variants
    B, N = batch_size, points
    batch = train_batch(SEED + 1, B, N)
    dev_batch = to_device(batch, device)
    variants = {"fp32 mm": (None, "mm", TOL_TRAIN_GRAD),
                "fp32 gather": (None, None, TOL_TRAIN_GRAD_GATHER),
                "bf16 mm": (torch.bfloat16, "mm", None)}
    out = {}
    for name, (dtype, sampler, tol) in variants.items():
        if dtype is None:
            res = compare_train_step(net, cfg, batch, device, dtype, sampler, tol)
            print(f"phase 26: giga {name} step B={B}, N={N} on the card against the CPU: loss "
                  f"{res['loss']:.6f} within {res['loss_err']:.3g} relative (tol "
                  f"{TOL_TRAIN_LOSS}), gradients within {res['grad_err']:.3g} * (1 + max |g|) "
                  f"(tol {tol}; {res['n_f64']} leaves past it, held within "
                  f"{TOL_TRAIN_GRAD_F64} of float64: the card's {res['grad_err64']:.3g} there, "
                  f"the CPU's own {res['own_err']:.3g}), params after the step within "
                  f"{res['param_err']:.3g} beyond "
                  f"Adam's move of the two gradients (tol {TOL_TRAIN_PARAM}; that move "
                  f"{res['adam_move']:.3g} at most)")
        else:
            state = create_train_state(copy.deepcopy(net), device=device)
            _, t = make_train_step(state.module, cfg, dtype=dtype, sampler=sampler)(
                state, dev_batch)
            loss = float(t["loss_all"])
            ref = out["fp32 mm"]["loss"]
            dtypes = {v.dtype for v in [*state.params.values(), *state.tx.mu, *state.tx.nu]}
            if not (abs(loss - ref) < TOL_TRAIN_BF16_LOSS and dtypes == {torch.float32}):
                raise AssertionError(f"bf16 step: loss {loss} against fp32 {ref} (tol "
                                     f"{TOL_TRAIN_BF16_LOSS}), master dtypes {dtypes}")
            res = {"loss": loss}
            print(f"phase 26: giga {name} step B={B}, N={N}: loss {loss:.6f}, "
                  f"{abs(loss - ref):.3g} from the fp32 step's (tol {TOL_TRAIN_BF16_LOSS}); "
                  f"master params and moments float32")
        state = create_train_state(copy.deepcopy(net), device=device)
        step = make_train_step(state.module, cfg, dtype=dtype, sampler=sampler)
        losses = [float(step(state, dev_batch)[1]["loss_all"]) for _ in range(10)]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"giga {name}: 10 chained steps gave losses {losses}")
        res["chain"] = losses
        if on_card:
            from giga_tpu_torch.scripts.profile_planner import _trace

            res["ms"] = chain_step_ms(step, state, dev_batch)
            busy, wall, rows = _trace(lambda: step(state, dev_batch), 3)
            res["launches"] = sum(r[1] for r in rows if not r[2].startswith(("Memcpy", "Memset")))
            res["idle"] = max(0.0, 1 - busy / wall)
            torch.cuda.synchronize()
            live = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step(state, dev_batch)
            torch.cuda.synchronize()
            res["peak_gb"] = (torch.cuda.max_memory_allocated() - live) / 1e9
            print(f"phase 26: giga {name} B={B}: 10 chained steps, loss_all {losses[0]:.5f} -> "
                  f"{losses[-1]:.5f}; {res['ms']:.3f} ms a step ({B / res['ms'] * 1e3:.1f} "
                  f"samples/s), {res['launches']} kernels a step, device idle share "
                  f"{res['idle']:.3f} (traced {busy:.3f} of {wall:.3f} ms), peak "
                  f"{res['peak_gb']:.2f} GB above what was live before the step | {card}")
        out[name] = res

    # c. giga_geo and VGN, one fp32 step each
    geo, geo_cfg = load_network(root / GEO_CHECKPOINT, "giga_geo")
    vgn, vgn_cfg = get_network("vgn")
    vgn.load_state_dict(flax_to_state_dict(unflatten_params(np.load(root / GOLDEN_VGN))))
    vgn_batch = train_batch(SEED + 2, B, N, vgn=True)
    for name, model, mcfg, b in (("giga_geo", geo, geo_cfg, batch),
                                 ("vgn", vgn, vgn_cfg, vgn_batch)):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = compare_train_step(model, mcfg, b, device)
        print(f"phase 26: {name} fp32 step B={B} on the card against the CPU: loss "
              f"{res['loss']:.6f} within {res['loss_err']:.3g} relative, gradients within "
              f"{res['grad_err']:.3g} * (1 + max |g|) ({res['n_f64']} leaves past "
              f"{TOL_TRAIN_GRAD}, held within {TOL_TRAIN_GRAD_F64} of float64: the card's "
              f"{res['grad_err64']:.3g} there, the CPU's own {res['own_err']:.3g}), params "
              f"within {res['param_err']:.3g} "
              f"beyond Adam's move ({res['adam_move']:.3g} at most; one step each way, "
              f"{time.perf_counter() - t0:.2f} s with the CPU's)")
        out[name] = res

    # d. the device corpus
    corpus_np = make_corpus(16, 2 * N, 64)
    with tempfile.TemporaryDirectory() as tmp:
        tc.write_shard(Path(tmp) / "shard_000.npz",
                       [{k: v[i] for k, v in corpus_np.items()} for i in range(8)])
        tc.write_shard(Path(tmp) / "shard_001.npz",
                       [{k: v[i] for k, v in corpus_np.items()} for i in range(8, 16)])
        corpus_np = tc.load_corpus(tmp)
    on_dev = tc.device_corpus(corpus_np, device=device)
    on_cpu = tc.device_corpus(corpus_np, device="cpu")
    sampler = tc.CorpusSampler(corpus_np, range(16), batch=B, occ_sub=N, seed=SEED)
    for k in (0, 1, 2, 3, None):
        sel = sampler()
        if k is not None:
            sel["rotk"] = np.full(B, k, np.int32)
        got = tc.assemble_batch(on_dev, to_device(sel, device))
        ref = tc.assemble_batch(on_cpu, to_device(sel, "cpu"))
        for name, v in ref.items():
            if not torch.equal(got[name].cpu(), v):
                raise AssertionError(f"assemble_batch on the card differs in {name}, rotk {k}")
    state = create_train_state(copy.deepcopy(net), device=device)
    step = make_train_step(state.module, cfg, assemble=tc.assemble_batch)
    corpus_losses = [float(step(state, on_dev, sampler())[1]["loss_all"]) for _ in range(5)]
    if not np.isfinite(corpus_losses).all():
        raise AssertionError(f"corpus steps gave losses {corpus_losses}")
    print(f"phase 26: device corpus of 16 scenes ({2 * N} occupancy points, 64 grasps each): "
          f"assemble_batch on the card equal to the CPU's for rotk 0-3 and mixed; 5 corpus "
          f"steps B={B}, loss_all " + " -> ".join(f"{v:.5f}" for v in corpus_losses))

    # e. Trainer.fit and resume
    train = [train_batch(SEED + 10 + i, B, N) for i in range(4)]
    val = [train_batch(SEED + 20, B, N)]
    with tempfile.TemporaryDirectory() as logdir:
        logdir = Path(logdir)
        state = create_train_state(copy.deepcopy(net), device=device)
        trainer = Trainer(state.module, cfg, TrainConfig(), logdir=logdir, save_state=True)
        t0 = time.perf_counter()
        state, history = trainer.fit(state, train, val, epochs=2,
                                     log=lambda m: print(f"phase 26: Trainer.fit {m}"))
        fit_s = time.perf_counter() - t0
        written = {f: (logdir / f).exists() for f in
                   ("giga_last.msgpack", "giga_best.msgpack", "history.jsonl")}
        written["events"] = bool(list(logdir.glob("events.out.tfevents.*")))
        written["state"] = trainer.ckpt_mgr.epochs() == [1, 2]
        if not all(written.values()) or [r["epoch"] for r in history] != [1, 2]:
            raise AssertionError(f"Trainer.fit wrote {written}, history {history}")
        fresh = create_train_state(copy.deepcopy(net), device=device)
        trainer2 = Trainer(fresh.module, cfg, TrainConfig(), logdir=logdir, save_state=True)
        resumed = trainer2.try_resume(fresh)
        mine = [*state.params.values(), *state.tx.mu, *state.tx.nu, state.tx.count]
        theirs = [*resumed.params.values(), *resumed.tx.mu, *resumed.tx.nu, resumed.tx.count]
        if not (trainer2.start_epoch == 3 and all(torch.equal(a, b)
                                                    for a, b in zip(mine, theirs))):
            raise AssertionError("try_resume did not restore the epoch, params and moments")
        loaded, _ = load_network(logdir / "giga_last.msgpack", "giga")
        if not all(torch.equal(a.cpu(), b.detach().cpu()) for a, b in
                   zip(loaded.state_dict().values(), state.module.state_dict().values())):
            raise AssertionError("the saved .msgpack differs from the trained module")
    print(f"phase 26: Trainer.fit 2 epochs of 4 batches B={B} in {fit_s:.2f} s: last and best "
          f".msgpack, history.jsonl, tensorboard events and the state checkpoint written; "
          f"try_resume restored epoch 2, the params and Adam's moments exactly; the saved "
          f".msgpack loads through load_network equal to the trained module")

    if on_card:
        torch.cuda.synchronize()
    launches = kernel_counts()
    if any(launches.values()):
        raise AssertionError(f"training launched a kernel of this package: {launches}")
    if (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) != flags:
        raise AssertionError("training left the TF32 flags changed")
    print(f"phase 26: kernel launches {launches} (none expected: training reaches no Pallas "
          f"kernel in the JAX package); TF32 flags as before")
    return out


def compare_bands(got, ref, what: str) -> dict:
    """Two surface bands, each (cell ids, float16 corner values (n, 8)) of
    its valid prefix, held cell by cell (see TOL_BAND, TOL_FLIP). Returns
    the cells in each band only, the corners that differ and the largest
    corner difference beyond one float16 step."""
    (ia, va), (ib, vb) = got, ref
    common, pa, pb = np.intersect1d(ia, ib, assume_unique=True, return_indices=True)
    a, b = va[pa].astype(np.float64), vb[pb].astype(np.float64)
    step = np.spacing(np.maximum(np.abs(va[pa]), np.abs(vb[pb]))).astype(np.float64)
    beyond = np.abs(a - b) - step
    excess = beyond - TOL_BAND * (1 + np.abs(b))
    only = [v[~np.isin(i, common)] for i, v in ((ia, va), (ib, vb))]
    near = [np.abs(o.astype(np.float64)).min(axis=1) if len(o) else np.zeros(0) for o in only]
    if excess.max(initial=-1.0) > 0 or any((n > TOL_FLIP).any() for n in near):
        raise AssertionError(
            f"{what}: corners past one float16 step + {TOL_BAND} * (1 + |b|) by "
            f"{excess.max(initial=0.0):.3g}; cells in one band only {[len(o) for o in only]}, "
            f"their nearest corners {[float(n.max(initial=0.0)) for n in near]} (tol {TOL_FLIP})")
    return {"cells": len(ib), "only": (len(only[0]), len(only[1])),
            "corners": int((a != b).sum()), "beyond_step": float(beyond.max(initial=0.0))}


def compare_mesh_counts(mesh, n_verts: int, n_faces: int, band: dict, what: str) -> None:
    """A mesh's face count against a reference's: equal when the two bands
    hold the same cells, else within the 12 triangles a cell can hold per
    cell in one band only."""
    slack = 12 * sum(band["only"])
    if abs(len(mesh.faces) - n_faces) > slack or (slack == 0 and len(mesh.vertices) != n_verts):
        raise AssertionError(f"{what}: {len(mesh.vertices)} vertices, {len(mesh.faces)} faces "
                             f"against {n_verts}, {n_faces} (slack {slack})")


def compare_batched(meshes, refs, what: str) -> float:
    """tests/test_band_generation.py's batched gates: equal face counts,
    sorted vertices within TOL_MESH_BATCH. Returns the largest difference."""
    worst = 0.0
    for b, (m, r) in enumerate(zip(meshes, refs)):
        if len(m.faces) != len(r.faces) or len(m.faces) == 0:
            raise AssertionError(f"{what} scene {b}: {len(m.faces)} faces against {len(r.faces)}")
        d = float(np.abs(np.sort(m.vertices, axis=0) - np.sort(r.vertices, axis=0)).max())
        if d > TOL_MESH_BATCH:
            raise AssertionError(f"{what} scene {b}: sorted vertices {d} apart")
        worst = max(worst, d)
    return worst


def meshgen_phase(card, device: str = "cuda", eval_scenes: int = 16,
                  eval_points: int = 100_000) -> dict:
    """Phase 27: mesh generation on the card (geometry/generation.py's
    MeshGenerator with the shipped GIGA-Geo checkpoint at full width; no
    kernel of this package: the JAX package's mesh generation reaches no
    Pallas kernel), every counter, K4 and K5 included, zeroed just before
    and read after:
      a. the golden file's scenes: the 129^3 band program's bands (two
         scenes) and the 257^3 refine chain's (one) against JAX's, cell by
         cell (``compare_bands``), and the meshes' counts against its;
      b. the same bands against the port's on the CPU;
      c. ``generate_meshes`` on bench.py's batch of MESH_BATCH at 129^3 and
         at 257^3 against per-scene ``generate_mesh`` (``compare_batched``),
         the paths each scene took equal;
      d. bf16 against fp32 at 129^3 on the batch: the median distance of
         the bf16 mesh's vertices to the fp32 mesh's below TOL_MESH_BF16;
      e. the band and refine programs, single and batched, warm, under
         ``torch.cuda.set_sync_debug_mode("error")`` up to their one fetch;
      f. scripts/eval_synthetic_geometry.py's protocol (``eval_scenes``
         scenes, ``eval_points`` points) at the geo gate's floors;
      g. ms per scene (129^3 single, batched, 257^3 refine), one call's
         split, kernels a call, idle share and peak memory
         (scripts/profile_meshgen.py).
    ``device``, ``eval_scenes`` and ``eval_points`` let the phase rehearse
    on the CPU at a small size (no sync check, no timings there). Returns
    the timings."""
    import copy

    import torch
    from scipy.spatial import cKDTree

    from giga_tpu_torch.geometry.generation import MeshGenerator, fetch
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.scripts.eval_synthetic_geometry import evaluate_geo_checkpoint
    from giga_tpu_torch.scripts.profile_meshgen import SETTINGS, bench_scenes, profile

    root = Path(__file__).resolve().parent
    on_card = device != "cpu"
    net, _ = load_network(root / GEO_CHECKPOINT, "giga_geo")
    cpu_net = copy.deepcopy(net)
    golden = np.load(root / GOLDEN_MESH)
    t0 = time.perf_counter()
    scenes = bench_scenes(1 + MESH_BATCH)
    scenes_s = time.perf_counter() - t0
    same_tsdf = bool(np.array_equal(scenes[:len(golden["tsdf"])], golden["tsdf"]))
    gen = {k: MeshGenerator(net, **SETTINGS[k], device=device) for k in ("single", "refine")}
    cpu = {k: MeshGenerator(cpu_net, **SETTINGS[k], device="cpu") for k in ("single", "refine")}
    zero_kernel_counts(all_five=True)

    def band(g, tsdf, refine: bool = False):
        g.encode(tsdf)
        out = fetch(*(g.refine_program(g._planes, 0) if refine else g.band_program(g._planes)))
        n = int(out[2])
        return (out[0][:n], out[1][:n]), out

    # a, b. the golden's bands, and the CPU's
    rows = []
    for i, tsdf in enumerate(golden["tsdf"]):
        got, _ = band(gen["single"], tsdf)
        ref = (golden[f"band{i}_ids"], golden[f"band{i}_vals"])
        res = compare_bands(got, ref, f"129^3 band, golden scene {i}")
        mesh, stats = gen["single"].generate_mesh(tsdf)
        compare_mesh_counts(mesh, int(golden["band_verts"][i]), int(golden["band_faces"][i]),
                            res, f"129^3 mesh, golden scene {i}")
        if stats["path"] != "band":
            raise AssertionError(f"golden scene {i} took {stats['path']}")
        rows.append(f"scene {i} {res['cells']} cells, {res['corners']} corners differ, "
                    f"{res['only']} in one band only, {len(mesh.faces)} faces")
        if i == 0:
            cpu_res = compare_bands(got, band(cpu["single"], tsdf)[0], "129^3 band, card vs CPU")
    got, out = band(gen["refine"], golden["tsdf"][0], refine=True)
    ref_res = compare_bands(got, (golden["refine_ids"], golden["refine_vals"]),
                            "257^3 refine band, golden scene 0")
    counts_p = out[3]
    K_f, K_ps = gen["refine"]._refine_tiers[0]
    if not all(int(c) <= k for c, k in zip(counts_p, K_ps)):
        raise AssertionError(f"257^3 refine chain past tier 0: {counts_p} against {K_ps}")
    mesh, stats = gen["refine"].generate_mesh(golden["tsdf"][0])
    compare_mesh_counts(mesh, int(golden["refine_verts"]), int(golden["refine_faces"]), ref_res,
                        "257^3 mesh, golden scene 0")
    cpu_got, cpu_out = band(cpu["refine"], golden["tsdf"][0], refine=True)
    cpu_ref_res = compare_bands(got, cpu_got, "257^3 refine band, card vs CPU")
    print(f"phase 27: 129^3 band program against the JAX golden: " + "; ".join(rows)
          + f"; 257^3 refine chain (tier {stats['refine tier']}, point counts "
          f"{counts_p.tolist()} against JAX's {golden['refine_counts_p'].tolist()} and the CPU's "
          f"{cpu_out[3].tolist()}): {ref_res['cells']} cells, {ref_res['corners']} corners "
          f"differ, {ref_res['only']} in one band only, {len(mesh.faces)} faces; card against "
          f"the CPU: 129^3 {cpu_res['corners']} corners differ, {cpu_res['only']} cells in one "
          f"band only, 257^3 {cpu_ref_res['corners']} and {cpu_ref_res['only']}; largest corner "
          f"difference beyond a float16 step {max(r['beyond_step'] for r in (res, ref_res, cpu_res, cpu_ref_res)):.3g} "
          f"(tol {TOL_BAND} * (1 + |b|)); bench.py's scenes made on this host equal the "
          f"golden's: {same_tsdf} ({scenes_s:.2f} s for {len(scenes)})")

    # c. batched against per-scene, both strategies
    batch = scenes[1:1 + MESH_BATCH]
    worst = {}
    for k in ("single", "refine"):
        meshes = gen[k].generate_meshes(batch)
        paths = [st["path"] for st in gen[k].batch_stats]
        singles = [gen[k].generate_mesh(g) for g in batch]
        if paths != [st["path"] for _, st in singles]:
            raise AssertionError(f"{k} batched paths {paths} against per-scene "
                                 f"{[st['path'] for _, st in singles]}")
        worst[k] = (compare_batched(meshes, [m for m, _ in singles], f"{k} generate_meshes"),
                    paths)
    fp32_meshes = [m for m, _ in [gen["single"].generate_mesh(g) for g in batch]]

    # d. bf16 against fp32
    gen_bf16 = MeshGenerator(net, **SETTINGS["single"], precision="bf16", device=device)
    bf16_meshes = gen_bf16.generate_meshes(batch)
    medians = [float(np.median(cKDTree(r.vertices).query(m.vertices)[0]))
               for m, r in zip(bf16_meshes, fp32_meshes)]
    if not max(medians) < TOL_MESH_BF16:
        raise AssertionError(f"bf16 meshes: median vertex distances {medians}")
    print(f"phase 27: generate_meshes B={MESH_BATCH} against per-scene generate_mesh: 129^3 "
          f"paths {worst['single'][1]}, sorted vertices within {worst['single'][0]:.3g}; 257^3 "
          f"paths {worst['refine'][1]}, within {worst['refine'][0]:.3g} (tol {TOL_MESH_BATCH}, "
          f"face counts equal); bf16 against fp32 at 129^3: median vertex distance "
          f"{max(medians):.3g} at most (tol {TOL_MESH_BF16}), paths "
          f"{[st['path'] for st in gen_bf16.batch_stats]}")

    # e. no sync inside the programs
    if on_card:
        dev1 = gen["single"].upload(scenes[:1])
        devb = gen["single"].upload(batch)
        with torch.no_grad():
            planes = gen["single"].net.encode(dev1)
        programs = {"band": lambda: gen["single"].band_program(planes),
                    "band batched": lambda: gen["single"].band_program_batched(devb),
                    "refine": lambda: gen["refine"].refine_program(planes, 0),
                    "refine batched": lambda: gen["refine"].refine_program_batched(devb, 0)}
        for name, fn in programs.items():
            warm = fetch(*fn())
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if not all(np.array_equal(a, b) for a, b in zip(fetch(*out), warm)):
                raise AssertionError(f"the {name} program gave another result warm")
        print(f"phase 27: {', '.join(programs)} programs ran under "
              f"set_sync_debug_mode('error') up to their fetch, equal to their warm runs")

    # f. the evaluation protocol
    t0 = time.perf_counter()
    metrics = evaluate_geo_checkpoint(root / GEO_CHECKPOINT, n_scenes=eval_scenes,
                                      n_eval_points=eval_points, device=device)
    eval_s = time.perf_counter() - t0
    if not (metrics["iou"] >= GEO_IOU_FLOOR and metrics["f-score"] >= GEO_FSCORE_FLOOR
            and metrics["chamfer-L1"] <= GEO_CHAMFER_L1_CEIL):
        raise AssertionError(f"geometry evaluation below the geo gate's floors: {metrics}")
    print(f"phase 27: eval_synthetic_geometry ({eval_scenes} scenes, seed 2000, {eval_points} "
          f"points, 129^3 band program): IoU {metrics['iou']:.5f} (floor {GEO_IOU_FLOOR}), "
          f"F-score {metrics['f-score']:.5f} (floor {GEO_FSCORE_FLOOR}), Chamfer-L1 "
          f"{metrics['chamfer-L1']:.5f} (ceiling {GEO_CHAMFER_L1_CEIL}), normals "
          f"{metrics['normals']:.5f}; {eval_s:.2f} s")

    # g. timings
    out = {"eval": metrics}
    if on_card:
        for setting in ("single", "batched", "refine"):
            r = profile(setting, net, scenes, 5, 10000)
            out[setting] = r
            stages = ", ".join(f"{k} {v:.3f}" for k, v in r["stages"].items())
            print(f"phase 27: {setting} ({SETTINGS[setting]}): {r['ms_per_scene']:.3f} ms a "
                  f"scene end to end; one call: encode {r['encode']:.3f} ms, program "
                  f"{r['program']:.3f} ms ({stages}), fetch {r['fetch']:.3f} ms, marching "
                  f"{r['marching']:.3f} ms, simplify to 10000 faces {r['simplify']:.3f} ms; "
                  f"{r['kernels']} kernels a call, device idle share {r['idle']:.3f}, peak "
                  f"{r['peak_gb']:.3f} GB | {card}")
        torch.cuda.synchronize()
    launches = kernel_counts(all_five=True)
    if any(launches.values()):
        raise AssertionError(f"mesh generation launched a kernel of this package: {launches}")
    print(f"phase 27: kernel launches {launches} (none expected: mesh generation reaches no "
          f"Pallas kernel in the JAX package)")
    return out


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
        full_precision, lattice_positions)
    from giga_tpu_torch.inference.postprocess import (
        GraspCandidates, bound_quality, mask_quality, select_grasps_batched)
    from giga_tpu_torch.inference.serving import PlannerService
    from giga_tpu_torch.models.checkpoint import load_params
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.ops.kernels import _build
    from giga_tpu_torch.ops.kernels import decoder as dk
    from giga_tpu_torch.ops.kernels.decoder import (
        dense_decode_batched, dense_decode_plain, prepare_projections_batched)
    from giga_tpu_torch.ops.kernels.stem import (
        stem_pool_batched, stem_pool_launch_config, stem_pool_plain)

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
    bound1 = bound(*stem_pool_work(B, R, C))
    # K2, run per head (the fused trunk's off-diagonal zeros are no work)
    heads, O = 3, 4
    bound2 = bound(trunk_flops(B * N, heads, H, n_blocks, O),
                   nbytes(*inputs) + 4 * B * heads * O * N)
    lc1 = stem_pool_launch_config(B, R, R, R, C)
    print(f"phase 3: K1 resources: {kernel_resources(_build.build_log('stem_pool'), 'stem_pool_kernelIfE')}, "
          f"{lc1['shared_bytes']} bytes shared per block, grid {lc1['blocks']} blocks of "
          f"{lc1['threads']} threads ({lc1['channels_per_block']} channels each); {ms1:.4f} ms, "
          f"{bound1[0] / ms1:.1%} of its bound ({bound1[0]:.4f} ms by {bound1[1]}) | {card}")
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

    dec = net.decoder_aff.params()
    voxel = SIZE / R
    # 8. K3 against its plain version on one scene
    with torch.inference_mode(), full_precision():
        inputs3 = dk.prepare_projections(dec, {t: v[0] for t, v in feats.items()}, coords,
                                         n_blocks)
        k3 = dk.fused_dense_decode(*inputs3)
        err3, rel3 = check_close(k3, dk.fused_dense_decode_plain(*inputs3), TOL_DECODE, "K3")
        ms3 = cuda_ms(lambda: dk.fused_dense_decode(*inputs3), 50)
        plain3 = cuda_ms(lambda: dk.fused_dense_decode_plain(*inputs3), 10)
    bound3 = bound(trunk_flops(N, heads, H, n_blocks, O), nbytes(*inputs3, k3))
    print(f"phase 8: K3 max abs err {err3:.3g}, max err/(1+|plain|) {rel3:.3g} "
          f"(tol {TOL_DECODE}), one scene R={R}")

    # 9. the single-scene path: GIGAPlanner.__call__ on the golden scenes
    n_gold = len(gc.count)
    dk.fused_dense_decode.launches = 0
    called = [planner(State(tsdf=scenes[i][None]))[:2] for i in range(n_gold)]
    torch.cuda.synchronize()
    launches3 = dk.fused_dense_decode.launches
    if launches3 != n_gold:
        raise AssertionError(f"__call__ launched K3 {launches3} times in {n_gold} calls")
    worst9 = 0.0
    for i, got in enumerate(called):
        golden_i = planner._to_grasps(GraspCandidates(*(np.asarray(x[i]) for x in gc)))
        worst9 = max(worst9, compare_grasps(got, golden_i, voxel, f"__call__ vs golden, scene {i}"),
                     compare_grasps(got, results[i], voxel, f"__call__ vs plan_batch, scene {i}"))
    print(f"phase 9: __call__ on {n_gold} golden scenes ({sum(len(g) for g, _ in called)} "
          f"grasps) equals the JAX golden candidates and plan_batch (max diff {worst9:.3g}); "
          f"K3 launches {launches3}")

    # 10. plan_stream against per-scene calls
    n_stream = 8
    streamed = planner.plan_stream(scenes[:n_stream])
    for i, got in enumerate(streamed):
        compare_grasps(got, planner(State(tsdf=scenes[i]))[:2], voxel,
                       f"plan_stream vs __call__, scene {i}", tol=1e-6)
    print(f"phase 10: plan_stream over {n_stream} scenes ({sum(len(g) for g, _ in streamed)} "
          f"grasps) equals per-scene __call__")

    # 11. K4 and K5 at the serving shape, against their plain versions and K2
    with torch.inference_mode(), full_precision():
        inputs4 = dk.prepare_feats_inputs(dec, feats, coords, n_blocks)
        k4 = dk.dense_decode_feats_batched(*inputs4)
        err4, rel4 = check_close(k4, dk.dense_decode_feats_plain(*inputs4), TOL_DECODE, "K4")
        inputs5 = dk.prepare_hybrid_inputs(dec, feats, coords, n_blocks)
        k5 = dk.dense_decode_hybrid_batched(*inputs5)
        p5 = dk.dense_decode_hybrid_plain(*inputs5)
        err5, rel5 = check_close(k5, p5, TOL_DECODE, "K5")
        equal5 = bool(torch.equal(k5, p5))
        del p5
        torch.cuda.synchronize()
        ref2 = dk.split_heads_transposed(k2, heads, R)
        ref2 = (ref2[0], ref2[1].permute(0, 2, 1).reshape(B, R, R, R, 4), ref2[2])
        vols = {}
        for name, out in (("K4", k4), ("K5", k5)):
            vols[name] = dk.split_heads(out, heads)
            diff = max(float((a - b).abs().max()) for a, b in zip(vols[name], ref2))
            if not diff <= TOL_VOLUME:
                raise AssertionError(f"{name}'s volumes differ from K2's by {diff} > {TOL_VOLUME}")
        qual4, rot4, width4 = vols["K4"]
        masked = bound_quality(mask_quality(qual4, tsdfs, width4, planner.planner_cfg),
                               voxel, planner.planner_cfg)
        c4 = candidates_to_host(select_grasps_batched(masked, rot4, width4,
                                                      lattice_positions(coords),
                                                      planner.planner_cfg))
        worst11 = compare_candidates(c4, ck, range(B), R, "K4's volumes vs plan_batch")
        del k4, k5
        # the decode A/B entry points, counters zeroed just before
        dk.dense_decode_feats_batched.launches = 0
        dk.dense_decode_hybrid_batched.launches = 0
        for vol in (dk.decode_affordance_dense_kernel_feats_batched(dec, feats, coords, n_blocks),
                    dk.decode_affordance_dense_kernel_hybrid_batched(dec, feats, coords, n_blocks)):
            if not all(bool(torch.isfinite(v).all()) for v in vol):
                raise AssertionError("a decode entry point gave non-finite volumes")
        torch.cuda.synchronize()
        launches45 = {"dense_decode_feats": dk.dense_decode_feats_batched.launches,
                      "dense_decode_hybrid": dk.dense_decode_hybrid_batched.launches}
        if not all(launches45.values()):
            raise AssertionError(f"the decode entry points did not launch K4/K5: {launches45}")
        ms4 = cuda_ms(lambda: dk.dense_decode_feats_batched(*inputs4), 10)
        plain4 = cuda_ms(lambda: dk.dense_decode_feats_plain(*inputs4), 3, warmup=1)
        ms5 = cuda_ms(lambda: dk.dense_decode_hybrid_batched(*inputs5), 10)
        plain5 = cuda_ms(lambda: dk.dense_decode_hybrid_plain(*inputs5), 3, warmup=1)
    bound4 = bound(*dense_decode_feats_work(B, R, C, heads, H, n_blocks, O))
    bound5 = bound(*dense_decode_hybrid_work(B, R, C, heads, H, n_blocks, O))
    print(f"phase 11: K4 max abs err {err4:.3g}, max err/(1+|plain|) {rel4:.3g}; K5 max abs "
          f"err {err5:.3g}, max err/(1+|plain|) {rel5:.3g} (tol {TOL_DECODE}), equal to its "
          f"plain version: {equal5}; both within "
          f"{TOL_VOLUME} of K2's volumes; planning from K4's volumes equals plan_batch (max "
          f"diffs {worst11}); launches on the decode entry points {launches45}")
    log4 = _build.build_log("dense_decode_feats")
    for k, hybrid, ms, bnd in (("K4", False, ms4, bound4), ("K5", True, ms5, bound5)):
        lc = dk.dense_decode_feats_launch_config(B, R, C, heads, n_blocks,
                                                 R if hybrid else dk.FEATS_X_CHUNK, hybrid)
        trunk = kernel_resources(log4, f"dense_decode_feats_kernelILb{int(not hybrid)}E")
        print(f"phase 11: {k} resources: trunk {trunk}, projections "
              f"{kernel_resources(log4, 'project_kernel')}; trunk {lc['shared_bytes']} bytes "
              f"shared per block, grid {lc['grid'][0]}x{lc['grid'][1]} blocks of "
              f"{lc['threads']} threads, {lc['blocks_per_sm']} resident blocks per SM on "
              f"{lc['sms']} SMs, {lc['passes']} passes; {ms:.4f} ms, {bnd[0] / ms:.1%} of its "
              f"bound ({bnd[0]:.4f} ms by {bnd[1]}) | {card}")

    # 12. timings
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
    rows = [("K1 stem_pool", ms1, plain1, bound1, f"B={B}"),
            ("K2 dense_decode", ms2, plain2, bound2, f"B={B}"),
            ("K3 fused_dense_decode", ms3, plain3, bound3, "one scene"),
            ("K4 dense_decode_feats", ms4, plain4, bound4, f"B={B}"),
            ("K5 dense_decode_hybrid", ms5, plain5, bound5, f"B={B}")]
    for name, ms, plain, bnd, shape in rows:
        print(f"{name}: {ms:.4f} ms (plain {plain:.4f} ms, bound {bnd[0]:.4f} ms "
              f"by {bnd[1]}) {shape} R={R} | {card}")
    print(f"plan_batch B={B}: {sps:.1f} scenes/s end to end, batched program "
          f"{plan_ms:.3f} ms/batch ({B / plan_ms * 1e3:.1f} scenes/s) | {card}")
    print(f"__call__ (single-scene program, K3): {call_ms:.3f} ms | {card}")
    log2 = _build.build_log("dense_decode")
    for name, point_major, batch, ms, bnd in (("K2", False, B, ms2, bound2),
                                              ("K3", True, 1, ms3, bound3)):
        lc = dk.dense_decode_launch_config(batch, R, heads, n_blocks, point_major=point_major)
        res = kernel_resources(log2, k2_kernel(False, point_major))
        print(f"{name} resources: {res}, {lc['shared_bytes']} bytes shared per block, "
              f"grid {lc['grid'][0]}x{lc['grid'][1]} blocks of {lc['threads']} threads, "
              f"{lc['blocks_per_sm']} resident blocks per SM on {lc['sms']} SMs; "
              f"{bnd[0] / ms:.1%} of its bound ({bnd[0]:.4f} ms / {ms:.4f} ms) | {card}")

    bf16_rows, bf16_kernels = bf16_phases(
        net, cfg, scenes, results, card, {"K1": ms1, "K2": ms2, "K3": ms3, "K4": ms4, "K5": ms5})
    option_kernels = options_phase(net, cfg, scenes, feats, ck, card)
    wide_ms = presets_phase(net, scenes, card)
    ensemble_ms = ensemble_phase(load_params(root / CHECKPOINT), scenes, card)
    points_ms = points_phase(scenes, card)
    vgn_ms = vgn_phase(scenes, card)
    fusion = fusion_phase(card)
    visual_phase(scenes, card)
    train = train_phase(card)
    meshgen = meshgen_phase(card)
    print(f"bf16 plan_batch B={B}: {bf16_rows['sps']:.1f} scenes/s end to end, batched program "
          f"{bf16_rows['plan_ms']:.3f} ms/batch ({B / bf16_rows['plan_ms'] * 1e3:.1f} scenes/s; "
          f"float32 {plan_ms:.3f} ms) | {card}")
    print(f"bf16 __call__ (single-scene program, K3 bf16): {bf16_rows['call_ms']:.3f} ms "
          f"(float32 {call_ms:.3f} ms) | {card}")
    print(f"giga_wide plan_batch program B={B}: {wide_ms['fp32']:.3f} ms/batch float32, "
          f"{wide_ms['bf16']:.3f} ms/batch bf16 | {card}")
    print("ensemble __call__ (two members): " + ", ".join(
        f"{combine} {precision} {ms:.3f} ms" for (precision, combine), ms in ensemble_ms.items())
        + f" | {card}")
    print(f"decoding at points: encode + {N_QUERIES} occupancy queries {points_ms['occupancy_mm']:.3f} "
          f"ms (mm), {points_ms['occupancy_gather']:.3f} ms (gather); grad_refine "
          f"{points_ms['grad_refine']:.3f} ms | {card}")

    print(f"VGN batched program B={B}: " + ", ".join(
        f"{p} {vgn_ms[p, 'batch_ms']:.3f} ms/batch" for p in ("highest", "default", "bf16"))
        + "; __call__ " + ", ".join(f"{p} {vgn_ms[p, 'call_ms']:.3f} ms"
                                   for p in ("highest", "default", "bf16")) + f" | {card}")
    print(f"train giga B={TRAIN_BATCH}, N={TRAIN_POINTS} (a step by CUDA events, chains of 9 "
          f"less 1): " + ", ".join(
              f"{v} {TRAIN_BATCH / train[v]['ms'] * 1e3:.1f} samples/s ({train[v]['ms']:.3f} ms, "
              f"{train[v]['launches']} kernels, idle share {train[v]['idle']:.3f}, peak "
              f"{train[v]['peak_gb']:.2f} GB)" for v in ("fp32 mm", "fp32 gather", "bf16 mm"))
          + f" | {card}")
    print(f"TSDF fusion ({N_VIEWS} views, {CAMERA[0]}x{CAMERA[1]}) per scene: "
          f"{fusion[f'fuse{RESOLUTION}_ms']:.3f} ms at 40^3, "
          f"{fusion[f'fuse{FUSION_HIGH_RES}_ms']:.3f} ms at 120^3 | {card}")
    print("mesh generation (giga_geo, ms a scene end to end, program ms, peak GB): " + ", ".join(
        f"{k} {meshgen[k]['ms_per_scene']:.3f} ({meshgen[k]['program']:.3f}, "
        f"{meshgen[k]['peak_gb']:.3f})" for k in ("single", "batched", "refine")) + f" | {card}")

    def entry(name, source, replaces, n, err, ms, plain, bnd):
        return {"name": name, "route": "cuda", "source": f"giga_tpu_torch/csrc/{source}",
                "replaces": f"giga_tpu/ops/pallas/{replaces}", "launches": n,
                "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None}

    kernels = [
        entry("stem_pool", "stem_pool.cu", "stem_kernel.py:120", launches["stem_pool"],
              err1, ms1, plain1, bound1),
        entry("dense_decode", "dense_decode.cu", "decoder_kernel.py:348",
              launches["dense_decode"], err2, ms2, plain2, bound2),
        entry("fused_dense_decode", "dense_decode.cu", "decoder_kernel.py:153", launches3,
              err3, ms3, plain3, bound3),
        entry("dense_decode_feats", "dense_decode_feats.cu", "decoder_kernel.py:608",
              launches45["dense_decode_feats"], err4, ms4, plain4, bound4),
        entry("dense_decode_hybrid", "dense_decode_feats.cu", "decoder_kernel.py:447",
              launches45["dense_decode_hybrid"], err5, ms5, plain5, bound5),
        *(entry(*k) for k in bf16_kernels + option_kernels),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
