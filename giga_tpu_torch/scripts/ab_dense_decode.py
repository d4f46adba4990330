#!/usr/bin/env python3
"""A/B of the dense-decode trunk kernel's designs (K2 and K3) on the card.

    python3 -m giga_tpu_torch.scripts.ab_dense_decode [--tree NAME=DIR ...]
        [--builds NAME ...] [--rounds 4] [--bf16]

Run from the repository root. Each build in ``DESIGNS`` and ``ABLATIONS``
(by default all of them) is a copy of ``giga_tpu_torch/csrc/dense_decode.cu``
and its headers, edited in ``build/giga_tpu_torch/ab/``:

- a design sets the source's design constants (micro-tile TP x TC, warps per
  block, blocks per SM asked of ptxas, k unroll) and may stage the next
  block's plane rows in shared memory by ``cp.async`` (``STAGED_ROWS``);
- an ablation deletes statements (the plane-row loads; each block's two
  stores of the activation buffer with their bias and ReLU, the first
  product's result added into the residual instead so that ptxas keeps the
  product; the second product of each block) to show what each costs. Its
  outputs are wrong by construction and are not checked.

With ``--options`` the builds are ``OPTION_DESIGNS``, the code forms of
K2's option instances (``fold_b1`` as a per-block trunk instance or as a
runtime flag, in each trunk): every K2 entry point, default and option
modes in both dtypes, is held ``torch.equal`` to the shipped library's
and timed in turns, with each instance's ptxas registers and spills.

With ``--bf16`` the builds are ``BF16_DESIGNS`` and ``BF16_ABLATIONS``
instead, the designs of the bf16 mode's tensor-core kernel
(``dense_decode_bf16``, ``dense_decode_single_bf16``): m16 tiles a warp
carries (``BF_MT``), consumer warps a block, the stages of the rings of TMA
boxes, each operand's ReLU apart from its bf16 conversion; and its ablations (no plane rows, no
products, no operand conversions and bias adds, no residual add). Its
inputs are the bf16 ones the bf16 program makes, and its bound is at 989
TFLOP/s. ``--ablate-tree NAME=DIR`` adds ``TREE_BF16_ABLATIONS`` of a tree
of the design before this one (the parent commit, unpacked).

Each ``--tree NAME=DIR`` adds ``DIR/giga_tpu_torch/csrc/dense_decode.cu`` as
it stands, for example the parent commit unpacked by ``git archive``. All
builds compile at once, one nvcc each. On one set of inputs (chip_smoke's
seeded scenes through the shipped checkpoint's encoder, B=64, R=40) every
build but the ablations must give K2 and K3 (scene 0) outputs equal,
``torch.equal``, to the shipped library's. Then each build is timed by CUDA events in turns (the builds in order, then in
reverse, ``--rounds`` times). Prints each build's ptxas registers and
spills, its launch configuration, every reading and its range, beside the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "giga_tpu_torch" / "csrc"


def _design(tp: int, tc: int, warps: int, blocks: int, unroll: int) -> dict:
    return {"TP": tp, "TC": tc, "WARPS": warps, "MIN_BLOCKS": blocks, "KUNROLL": unroll}


# name -> (design constants, staged rows)
DESIGNS = {
    "8x8, 12 x 1, k unroll 2 (shipped)": ({}, False),
    "8x8, 12 x 1, full unroll": (_design(8, 8, 12, 1, 32), False),
    "8x8, 8 x 1, k unroll 4": (_design(8, 8, 8, 1, 4), False),
    "8x8, 8 x 1, full unroll": (_design(8, 8, 8, 1, 32), False),
    "4x8, 8 x 2, full unroll": (_design(4, 8, 8, 2, 32), False),
    "4x8, 8 x 2, k unroll 4": (_design(4, 8, 8, 2, 4), False),
    "4x8, 16 x 1, k unroll 4": (_design(4, 8, 16, 1, 4), False),
    "8x4, 8 x 2, full unroll": (_design(8, 4, 8, 2, 32), False),
    "8x8, 4 x 1, k unroll 2, staged rows": (_design(8, 8, 4, 1, 2), True),
    "4x8, 8 x 1, k unroll 4, staged rows": (_design(4, 8, 8, 1, 4), True),
}

_ROWS = [(f"tiled::add_rows(net, rows[{t}], ln);", "") for t in range(3)]
# each block's two stores of its activations, with their bias and ReLU. The
# first product's result is added into net instead, so that it stays live;
# head_out's store stays, so the buffer is still written and read.
_STORES = [("store_act(act, net, nullptr, ln);\n  __syncwarp();\n  product(acc, act, s.w0",
            "__syncwarp();\n  product(acc, act, s.w0"),
           ("store_act(act, acc, s.b0 + blk * H, ln);",
            "for (int p = 0; p < TP; ++p)\n    for (int c = 0; c < TC; ++c) net[p][c] += acc[p][c];")]

# name -> {file: [(old, new) edits]}, on the shipped design
ABLATIONS = {
    "ablation: no plane-row loads": {"dense_decode.cu": _ROWS},
    "ablation: no block activation stores": {"trunk_tiled.cuh": _STORES},
    "ablation: one product per block": {
        "trunk_tiled.cuh": [("product(acc, act, s.w1 + blk * H * H, ln);", "")]},
    "ablation: neither rows nor stores": {"dense_decode.cu": _ROWS, "trunk_tiled.cuh": _STORES},
}

# (old, new) edits of dense_decode.cu that stage block i+1's plane rows in
# shared memory by cp.async while block i's products run
STAGED_ROWS = [
    ("""size_t shared_bytes(int NB) {
  return ((size_t)trunk::weight_floats(NB) + (size_t)WARPS * Lane::ACT_FLOATS) * sizeof(float);
}
""", """// a lane's three planes' rows (3 x TP x TC floats), interleaved by lane
constexpr int STAGE_FLOATS = 3 * TP * TC * 32;

size_t shared_bytes(int NB) {
  return ((size_t)trunk::weight_floats(NB) + (size_t)WARPS * (Lane::ACT_FLOATS + STAGE_FLOATS))
         * sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\\n" ::"r"(d), "l"(src) : "memory");
}

// 16-byte slot (((plane * TP + p) * TC/4 + q) * 32 + lane) of `stage`
__device__ __forceinline__ void stage_rows(float* stage, const float* const (&rows)[3][TP],
                                           const Lane& ln, int lane) {
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int p = 0; p < TP; ++p)
#pragma unroll
      for (int q = 0; q < TC / 4; ++q)
        cp_async16(stage + ((((t * TP + p) * (TC / 4)) + q) * 32 + lane) * 4,
                   rows[t][p] + ln.column(4 * q));
  asm volatile("cp.async.commit_group;\\n" ::);
}

__device__ __forceinline__ void add_staged(float (&net)[TP][TC], const float* stage, int lane) {
  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int p = 0; p < TP; ++p)
#pragma unroll
      for (int q = 0; q < TC / 4; ++q) {
        const float4 u =
            reinterpret_cast<const float4*>(stage)[((t * TP + p) * (TC / 4) + q) * 32 + lane];
        net[p][4 * q + 0] += u.x;
        net[p][4 * q + 1] += u.y;
        net[p][4 * q + 2] += u.z;
        net[p][4 * q + 3] += u.w;
      }
}
"""),
    ("  float* act = smem + trunk::weight_floats(NB) + warp * Lane::ACT_FLOATS;\n",
     "  float* act = smem + trunk::weight_floats(NB) + warp * (Lane::ACT_FLOATS + STAGE_FLOATS);\n"
     "  float* stage = act + Lane::ACT_FLOATS;\n"),
    ("""    for (int blk = 0; blk < NB; ++blk) {
      const size_t plane = ((size_t)b * NB + blk) * RR;""",
     """    auto stage_block = [&](int blk) {
      const size_t plane = ((size_t)b * NB + blk) * RR;"""),
    ("""      tiled::add_rows(net, rows[0], ln);
      tiled::add_rows(net, rows[1], ln);
      tiled::add_rows(net, rows[2], ln);
      if (kFoldB1 && blk < NB - 1)
        tiled::resnet_block<true>(net, act, s, blk, ln);
      else
        tiled::resnet_block<false>(net, act, s, blk, ln);
""", """      stage_rows(stage, rows, ln, lane);
    };
    stage_block(0);
    for (int blk = 0; blk < NB; ++blk) {
      add_staged(net, stage, lane);
      if (blk + 1 < NB) stage_block(blk + 1);
      if (kFoldB1 && blk < NB - 1)
        tiled::resnet_block<true>(net, act, s, blk, ln);
      else
        tiled::resnet_block<false>(net, act, s, blk, ln);
"""),
]


def _bf16_design(**constants) -> tuple:
    return {f"BF_{k.upper()}": v for k, v in constants.items()}, {}


# each operand pair's ReLU as two fmaxf before the conversion, as the first
# bf16 design had it, instead of inside cvt.rn.relu.bf16x2
_RELU_APART = {"trunk_mma.cuh": [
    ("a[m][s][2 * half] = pack_relu(v[0] + c0, v[1] + c1);",
     "a[m][s][2 * half] = pack_relu(fmaxf(v[0] + c0, 0.f), fmaxf(v[1] + c1, 0.f));"),
    ("a[m][s][2 * half + 1] = pack_relu(v[2] + c0, v[3] + c1);",
     "a[m][s][2 * half + 1] = pack_relu(fmaxf(v[2] + c0, 0.f), fmaxf(v[3] + c1, 0.f));"),
    ("a[m][s][2 * half] = pack_relu(v[0], v[1]);",
     "a[m][s][2 * half] = pack_relu(fmaxf(v[0], 0.f), fmaxf(v[1], 0.f));"),
    ("a[m][s][2 * half + 1] = pack_relu(v[2], v[3]);",
     "a[m][s][2 * half + 1] = pack_relu(fmaxf(v[2], 0.f), fmaxf(v[3], 0.f));")]}

# name -> (design constants, {file: edits}) of the bf16 mode's kernel: m16
# tiles a warp carries, consumer warps a block, stages of a warp's pyz ring
# and of the block's slab ring
BF16_DESIGNS = {
    "bf16: 32-point tiles, 15 + 1 warps, slab ring 2, pyz ring 2 (shipped)": ({}, {}),
    "bf16: mma.sync, 16 + 1 warps": _bf16_design(warps=16),
    "bf16: mma.sync, 12 + 1 warps": _bf16_design(warps=12),
    "bf16: ReLU apart from the conversion": ({}, _RELU_APART),
    "bf16: 64-point tiles, 7 + 1 warps": _bf16_design(mt=4, warps=7),
    "bf16: pyz ring 3": _bf16_design(pyz_stages=3),
    "bf16: slab ring 3": _bf16_design(slab_stages=3),
}

# a constant added to every accumulator of the tile in place of a plane's rows
_BF_CONST = ("for (int m = 0; m < BF_MT; ++m) for (int n = 0; n < tc::NT; ++n) "
             "for (int r = 0; r < 4; ++r) net.v[m][n][r] += 0.125f;")
# each product instruction replaced by moves of its A registers into its
# accumulators (B's registers folded into two of them): the
# operands stay live, the tensor cores do nothing
_NO_MMA_SYNC = [(
    """  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));""",
    """  d[0] = __uint_as_float(a[0] ^ b.x);
  d[1] = __uint_as_float(a[1] ^ b.y);
  d[2] = __uint_as_float(a[2]);
  d[3] = __uint_as_float(a[3]);""")]
_BF_NO_PRODUCTS = {"trunk_mma.cuh": _NO_MMA_SYNC}
# the A fragments taken from the accumulators' bits: no bias add, no ReLU,
# no bf16 conversion
_BF_NO_CONVERSIONS = {"trunk_mma.cuh": [
    ("a[m][s][2 * half] = pack_relu(v[0] + c0, v[1] + c1);",
     "a[m][s][2 * half] = __float_as_uint(v[0]);"),
    ("a[m][s][2 * half + 1] = pack_relu(v[2] + c0, v[3] + c1);",
     "a[m][s][2 * half + 1] = __float_as_uint(v[2]);"),
    ("a[m][s][2 * half] = pack_relu(v[0], v[1]);", "a[m][s][2 * half] = __float_as_uint(v[0]);"),
    ("a[m][s][2 * half + 1] = pack_relu(v[2], v[3]);",
     "a[m][s][2 * half + 1] = __float_as_uint(v[2]);")]}
# the block's output replaces the residual stream: no b1 add, no net + dx
_BF_NO_RESIDUAL = {"trunk_mma.cuh": [
    (f"net.v[m][n][{r}] = net.v[m][n][{r}] + (acc.v[m][n][{r}] + c{r % 2});",
     f"net.v[m][n][{r}] = acc.v[m][n][{r}];") for r in range(4)]}

# name -> {file: edits} of the bf16 mode's kernel: what each part of the
# shipped design costs; outputs wrong by construction, not checked. Without
# plane rows, the blocks' ldmatrix reads give way to a constant, and the
# warps fetch and wait for no pyz box (the slabs' boxes still come in).
BF16_ABLATIONS = {
    "bf16 ablation: no plane-row loads": {"dense_decode.cu": [
        ("rows::add<false>(net, zs + (1 + k) * L.zbox, off_z);", _BF_CONST),
        ("rows::add<false>(net, ys + (1 + k) * L.ybox, off_y);", _BF_CONST),
        ("rows::add<false>(net, pyz + stage * BF_PYZ_BYTES, off_p);", _BF_CONST),
        ("rows::bar_wait(pyz_bar + 8 * stage, (step / BF_PYZ_STAGES) & 1);", ""),
        ("      if (lane == 0) {\n        const unsigned ahead",
         "      if (false) {\n        const unsigned ahead"),
        ("for (int d = 0; d < AHEAD; ++d) fetch(next, d, d);", ";")]},
    "bf16 ablation: no products": _BF_NO_PRODUCTS,
    "bf16 ablation: no operand conversions or bias adds": _BF_NO_CONVERSIONS,
    "bf16 ablation: no residual add": _BF_NO_RESIDUAL,
}
# the same ablations of the design before this one (32-point tiles in
# flattened order, rows read as bf16 pairs through the read-only path), for
# a tree of it given by --ablate-tree: its rows came from tc::rows
TREE_BF16_ABLATIONS = {
    **BF16_ABLATIONS,
    "bf16 ablation: no plane-row loads": {"dense_decode.cu": [
        (f"tc::rows<false>(net, {p} + first, i{p[1:]}, F, lane);", _BF_CONST)
        for p in ("pxz", "pxy", "pyz")]},
}


# fold_b1's b1 skip in the tiled (fp32) trunk as a runtime flag, as the mma
# trunk takes it, instead of a per-block trunk instance
_FOLD_FLAG_TILED = {
    "trunk_tiled.cuh": [
        ("const Lane<TP, TC, KU>& ln) {\n  float acc[TP][TC];",
         "const Lane<TP, TC, KU>& ln, bool last = true) {\n  float acc[TP][TC];"),
        ("  if (kNoB1) {\n", "  if (kNoB1 && !last) {\n")],
    "dense_decode.cu": [
        ("      if (kFoldB1 && blk < NB - 1)\n        tiled::resnet_block<true>(net, act, s, blk, ln);\n"
         "      else\n        tiled::resnet_block<false>(net, act, s, blk, ln);\n",
         "      tiled::resnet_block<kFoldB1>(net, act, s, blk, ln, blk == NB - 1);\n")]}
# the mma (bf16) trunk's b1 skip as a per-block instance, as the tiled one
_FOLD_PER_BLOCK_MMA = {
    "trunk_mma.cuh": [("    if (!kFoldB1 || last) add_columns", "    if (!kFoldB1) add_columns")],
    "dense_decode.cu": [
        ("      tc::resnet_block<kFoldB1, kResident>(net, s, k, lane, k == NB - 1);\n",
         "      if (kFoldB1 && k < NB - 1)\n        tc::resnet_block<true, kResident>(net, s, k, lane);\n"
         "      else\n        tc::resnet_block<false, kResident>(net, s, k, lane);\n")]}

# name -> (design constants, {file: edits}) of K2's option instances
OPTION_DESIGNS = {
    "options: fp32 fold per block, bf16 fold by flag (shipped)": ({}, {}),
    "options: fold by flag in both trunks": ({}, _FOLD_FLAG_TILED),
    "options: fold per block in both trunks": ({}, _FOLD_PER_BLOCK_MMA),
}


def _replace_once(text: str, old: str, new: str, what: str) -> str:
    if text.count(old) != 1:
        raise AssertionError(f"{what}: {old.strip()[:60]!r} found {text.count(old)} times")
    return text.replace(old, new)


def edited_copy(directory: Path, source: str, constants: dict, edits: dict,
                csrc: Path = CSRC) -> Path:
    """Copy ``csrc/<source>`` and the headers into ``directory``, set the
    source's design constants (``constexpr int NAME = value;``) and apply
    ``edits`` {file: [(old, new)]}, each old text found exactly once; returns
    the copy of the source."""
    directory.mkdir(parents=True, exist_ok=True)
    for f in [*csrc.glob("*.cuh"), csrc / source]:
        shutil.copy(f, directory / f.name)
    src = (directory / source).read_text()
    for name, value in constants.items():
        src, n = re.subn(rf"^constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         src, flags=re.M)
        if n != 1:
            raise AssertionError(f"{source} defines {name} {n} times")
    (directory / source).write_text(src)
    for fname, pairs in edits.items():
        text = (directory / fname).read_text()
        for old, new in pairs:
            text = _replace_once(text, old, new, fname)
        (directory / fname).write_text(text)
    return directory / source


def build_edits(name: str) -> tuple:
    """(design constants, {file: edits}) of one of ``DESIGNS``, ``ABLATIONS``,
    ``BF16_DESIGNS`` or ``OPTION_DESIGNS``."""
    if name in BF16_DESIGNS:
        return BF16_DESIGNS[name]
    if name in BF16_ABLATIONS:
        return {}, BF16_ABLATIONS[name]
    if name in OPTION_DESIGNS:
        return OPTION_DESIGNS[name]
    constants, staged = DESIGNS.get(name, ({}, False))
    edits = dict(ABLATIONS.get(name, {}))
    if staged:
        edits["dense_decode.cu"] = STAGED_ROWS
    return constants, edits


def build(sources: dict, stem: str = "dense_decode") -> dict:
    """{name: source} -> {name: (ctypes library, ptxas log)}, one nvcc per
    build, all started together; the libraries are ``lib<stem>_ab<i>.so``."""
    from giga_tpu_torch.ops.kernels import _build

    procs = {}
    (_build.BUILD_DIR / "ab").mkdir(parents=True, exist_ok=True)
    for i, (name, source) in enumerate(sources.items()):
        lib = _build.BUILD_DIR / "ab" / f"lib{stem}_ab{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(source)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (ctypes.CDLL(str(lib)), log)
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description="A/B the dense-decode trunk kernel's designs.")
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="a tree whose giga_tpu_torch/csrc/dense_decode.cu joins the A/B")
    ap.add_argument("--ablate-tree", action="append", default=[], metavar="NAME=DIR",
                    help="with --bf16: TREE_BF16_ABLATIONS of a tree of the design before "
                         "this one join the A/B")
    ap.add_argument("--builds", nargs="*",
                    choices=list({**DESIGNS, **ABLATIONS, **BF16_DESIGNS, **BF16_ABLATIONS,
                                  **OPTION_DESIGNS}))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--bf16", action="store_true",
                    help="time the bf16 mode's designs (BF16_DESIGNS) instead")
    ap.add_argument("--options", action="store_true",
                    help="time the code forms of K2's option instances (OPTION_DESIGNS)")
    args = ap.parse_args()
    if args.options and args.tree:
        ap.error("--options takes no --tree: an older tree may lack the option entry points")
    if args.builds is None:
        args.builds = list(OPTION_DESIGNS if args.options else
                           {**BF16_DESIGNS, **BF16_ABLATIONS} if args.bf16 else
                           {**DESIGNS, **ABLATIONS})

    import torch

    if not torch.cuda.is_available():
        print("ab_dense_decode: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from giga_tpu_torch.inference.dense_decode import (
        lattice_coords, sample_planes_on_lattice_batched)
    from giga_tpu_torch.inference.planner import full_precision
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.ops.kernels import _build
    from giga_tpu_torch.ops.kernels import decoder as dk

    card = chip_smoke.card_line()
    sources = {}
    for i, name in enumerate(args.builds):
        sources[name] = edited_copy(_build.BUILD_DIR / "ab" / f"src{i}", "dense_decode.cu",
                                    *build_edits(name))
    for tree in args.tree:
        name, path = tree.split("=", 1)
        sources[name] = Path(path).resolve() / "giga_tpu_torch" / "csrc" / "dense_decode.cu"
    tree_ablations = []
    for tree in args.ablate_tree:
        name, path = tree.split("=", 1)
        for ablation, edits in TREE_BF16_ABLATIONS.items():
            tree_ablations.append(f"{name} {ablation}")
            sources[tree_ablations[-1]] = edited_copy(
                _build.BUILD_DIR / "ab" / f"src{len(sources)}", "dense_decode.cu", {}, edits,
                Path(path).resolve() / "giga_tpu_torch" / "csrc")
    libs = build(sources)
    if args.options:
        return time_options(libs, args, card)

    net, cfg = load_network(ROOT / chip_smoke.CHECKPOINT)
    net = net.cuda().eval()
    R, B, E, O = chip_smoke.RESOLUTION, args.batch, 3, 4
    nb = cfg.decoder.n_blocks
    coords = lattice_coords(R, "cuda")
    tsdfs = torch.from_numpy(chip_smoke.make_scenes(B)).cuda()
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    suffix, kernel, config = (("bf16", "dense_decode_bf16_kernel", "dense_decode_bf16_config")
                              if args.bf16 else
                              ("f32", "dense_decode_kernel", "dense_decode_config"))
    with torch.inference_mode(), full_precision():
        if args.bf16:
            net = net.to(dtype)
            tsdfs = tsdfs.to(dtype)
        feats = sample_planes_on_lattice_batched(net.encode(tsdfs), coords,
                                                 cfg.encoder.plane_resolution,
                                                 cfg.decoder.padding)
        inputs = dk.prepare_projections_batched(net.decoder_aff.params(), feats, coords, nb,
                                                dtype)
        inputs3 = inputs[:3] + tuple(p[0].contiguous() for p in inputs[3:6]) + inputs[6:]
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        out2 = torch.empty((B, E * O, R ** 3), device="cuda")
        out3 = torch.empty((R, R, R, E * O), device="cuda")
        ptrs2 = [ctypes.c_void_p(t.data_ptr()) for t in (*inputs, out2)]
        ptrs3 = [ctypes.c_void_p(t.data_ptr()) for t in (*inputs3, out3)]

        def k2(lib):
            _build.check(getattr(lib, f"dense_decode_{suffix}")(*ptrs2, B, R, E, nb, stream),
                         f"dense_decode_{suffix}")

        def k3(lib):
            _build.check(getattr(lib, f"dense_decode_single_{suffix}")(*ptrs3, R, E, nb, stream),
                         f"dense_decode_single_{suffix}")

        ref2 = dk.dense_decode_batched(*inputs)
        ref3 = dk.fused_dense_decode(*inputs3)
        for name, (lib, log) in libs.items():
            out2.fill_(float("nan"))
            out3.fill_(float("nan"))
            k2(lib)
            k3(lib)
            torch.cuda.synchronize()
            same = torch.equal(out2, ref2) and torch.equal(out3, ref3)
            # the default instances; an older tree's kernels had other names
            # (the bf16 kernel before its TMA rows) or no options
            res = {k: chip_smoke.kernel_resources(log, chip_smoke.k2_kernel(args.bf16, bool(i)),
                                                  f"dense_decode_bf16_kernelILb{i}ELb0ELb0E",
                                                  f"{kernel}ILb{i}E")
                   for k, i in (("K2", 0), ("K3", 1))}
            cfg_line = ""
            if hasattr(lib, config):
                info = (ctypes.c_int * 11)()  # an older tree's fills the first 6 or 8
                _build.check(getattr(lib, config)(0, B, R, E, nb, info), config)
                cfg_line = (f"; grid ({info[2]}, {info[3]}), {info[0]} blocks of {info[4]} "
                            f"threads per SM, {info[5]} B shared per block, {info[6]} warps "
                            f"taking tiles, pyz ring {info[7]}, slab ring {info[8]} of "
                            f"{info[9]} z x {info[10]} y")
            print(f"{name}: K2 and K3 outputs equal the shipped library's bit for bit: {same}; "
                  f"ptxas {', '.join(f'{k}: {v}' for k, v in res.items())}{cfg_line}",
                  flush=True)
            if not (same or name in ABLATIONS or name in BF16_ABLATIONS
                    or name in tree_ablations):
                raise AssertionError(f"{name} gives other outputs than the shipped library")

        times = {name: {"K2": [], "K3": []} for name in libs}
        order = list(libs)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                lib = libs[name][0]
                times[name]["K2"].append(chip_smoke.cuda_ms(lambda: k2(lib), args.iters))
                times[name]["K3"].append(chip_smoke.cuda_ms(lambda: k3(lib), 5 * args.iters))
    peak = chip_smoke.PEAK_BF16_FLOPS if args.bf16 else chip_smoke.PEAK_FP32_FLOPS
    b2 = chip_smoke.bound(chip_smoke.trunk_flops(B * R ** 3, E, 32, nb, O),
                          chip_smoke.nbytes(*inputs) + 4 * B * E * O * R ** 3, peak)
    b3 = chip_smoke.bound(chip_smoke.trunk_flops(R ** 3, E, 32, nb, O),
                          chip_smoke.nbytes(*inputs3, out3), peak)
    for name, t in times.items():
        for kern, bnd in (("K2", b2), ("K3", b3)):
            ms = t[kern]
            print(f"{name:42s} {kern}: {min(ms):.4f}-{max(ms):.4f} ms "
                  f"[{', '.join(f'{m:.4f}' for m in ms)}] bound {bnd[0]:.4f} ms by {bnd[1]} "
                  f"({bnd[0] / min(ms):.1%} of it at best) B={B if kern == 'K2' else 1} R={R} "
                  f"| {card}")
    return 0


def time_options(libs: dict, args, card: str) -> int:
    """Hold every K2 entry point (``decoder.K2_MODES``) of each build
    ``torch.equal`` to the shipped library's on the serving inputs, print
    each instance's ptxas registers and spills, and time each in turns."""
    import copy

    import torch

    import chip_smoke
    from giga_tpu_torch.inference.dense_decode import (
        lattice_coords, sample_planes_on_lattice_batched)
    from giga_tpu_torch.inference.planner import full_precision
    from giga_tpu_torch.models.encoder import encode_planes_fused
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.ops.kernels import _build
    from giga_tpu_torch.ops.kernels import decoder as dk

    bf = torch.bfloat16
    net, cfg = load_network(ROOT / chip_smoke.CHECKPOINT)
    net = net.cuda().eval()
    bnet = copy.deepcopy(net).to(bf)
    R, B, E, nb = chip_smoke.RESOLUTION, args.batch, 3, cfg.decoder.n_blocks
    P, pad = cfg.encoder.plane_resolution, cfg.decoder.padding
    coords = lattice_coords(R, "cuda")
    tsdfs = torch.from_numpy(chip_smoke.make_scenes(B)).cuda()
    out = torch.empty((B, E * 4, R ** 3), device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    with torch.inference_mode(), full_precision():
        feats = {torch.float32: sample_planes_on_lattice_batched(net.encode(tsdfs), coords, P, pad),
                 bf: sample_planes_on_lattice_batched(
                     encode_planes_fused(bnet.encoder, tsdfs.to(bf)), coords, P, pad)}
        decs = {torch.float32: net.decoder_aff.params(), bf: bnet.decoder_aff.params()}
        inputs = {(dtype, fold): dk.prepare_projections_batched(decs[dtype], feats[dtype], coords,
                                                                 nb, dtype, fold_b1=fold)
                  for dtype in (torch.float32, bf) for fold in (False, True)}
        ref = {m: dk.dense_decode_batched(*inputs[m[:2]], fold_b1=m[1], resident_bf16=m[2])
               for m in dk.K2_MODES}

        def call(lib, mode):
            fn = getattr(lib, dk.dense_decode_entry(*mode))
            fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*inputs[mode[:2]], out)]
            return lambda: _build.check(fn(*ptrs, B, R, E, nb, stream), "dense_decode")

        for name, (lib, log) in libs.items():
            for mode in dk.K2_MODES:
                out.fill_(float("nan"))
                call(lib, mode)()
                torch.cuda.synchronize()
                same = torch.equal(out, ref[mode])
                res = chip_smoke.kernel_resources(log, chip_smoke.k2_kernel(mode[0] == bf, False,
                                                                            *mode[1:]))
                print(f"{name}: {dk.dense_decode_entry(*mode)} equal to the shipped library's bit "
                      f"for bit: {same}; ptxas {res}", flush=True)
                if not same:
                    raise AssertionError(f"{name} gives other outputs than the shipped library")
        times = {(name, mode): [] for name in libs for mode in dk.K2_MODES}
        order = list(libs)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                for mode in dk.K2_MODES:
                    times[name, mode].append(chip_smoke.cuda_ms(call(libs[name][0], mode),
                                                                args.iters))
    for (name, mode), ms in times.items():
        print(f"{name:58s} {dk.dense_decode_entry(*mode):32s} {min(ms):.4f}-{max(ms):.4f} ms "
              f"[{', '.join(f'{m:.4f}' for m in ms)}] B={B} R={R} | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
