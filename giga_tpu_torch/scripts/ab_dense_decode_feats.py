#!/usr/bin/env python3
"""A/B of the raw-feature dense-decode kernel's designs (K4) on the card.

    python3 -m giga_tpu_torch.scripts.ab_dense_decode_feats [--tree NAME=DIR ...]
        [--builds NAME ...] [--chunks 8 40] [--rounds 4]
    python3 -m giga_tpu_torch.scripts.ab_dense_decode_feats --bf16 --tree NAME=DIR ...
        [--rounds 4]

Run from the repository root. Each build in ``DESIGNS`` and ``ABLATIONS``
(by default all of them) is a copy of
``giga_tpu_torch/csrc/dense_decode_feats.cu`` and its headers, edited in
``build/giga_tpu_torch/ab/``:

- a design sets the source's design constants (the trunk's micro-tile TP x
  TC, warps per block, blocks per SM asked of ptxas and k unroll; the
  projections' rows per block ``PROJ_ROWS`` and register tile
  ``PROJ_TR`` x ``PROJ_TC``) and may patch statements (the fc_c biases read
  through L1, as K4's first design did);
- an ablation deletes work to show what it costs: the xz and xy row
  projections of every pass (the trunk then reads the scratch as it was),
  the pyz projection with the trunk's pyz add, or the trunk's fc_c bias
  add. Its outputs are wrong by construction and are not checked. K5
  shares the edited trunk and projections but is not timed here.

Each ``--tree NAME=DIR`` adds ``DIR/giga_tpu_torch/csrc/dense_decode_feats.cu``
as it stands, for example the parent commit unpacked by ``git archive`` (a
source without ``dense_decode_feats_config`` is called with the earlier
signature, which takes no scratch; a source whose trunk kernel is no
template is read by its plain name in the ptxas log). All builds compile at once, one nvcc each.
On chip_smoke's seeded scenes (B=64, R=40) through the shipped checkpoint's
encoder, every build but the ablations must give an output equal,
``torch.equal``, to the shipped library's at every ``--chunks`` x_chunk; then
each (build, x_chunk) is timed by CUDA events in turns (in order, then in
reverse, ``--rounds`` times). Prints each build's ptxas registers and spills
for the trunk and every reading with its range and share of the bound,
beside the card's name and power limit.

``--bf16`` times the bf16 modes of K4 and K5 of the shipped source against
each ``--tree``'s, from bf16 lattice features (a bf16 copy of the net
encodes the scenes, as ``measure_decoder_kernels --dtype bf16`` does). A
source whose bf16 entry points take a bf16 workspace (it has
``round_features_kernel``) is called with one; an older one with its
float32 row scratch. Every build's outputs are held to the plain versions
by ``chip_smoke.check_bf16`` (the tensor cores sum in their own order, so
two designs need not agree bit for bit); then each (build, kernel) is timed
in turns as above, at least 4 rounds.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

from giga_tpu_torch.scripts.ab_dense_decode import build, edited_copy

ROOT = Path(__file__).resolve().parents[2]
SOURCE = "dense_decode_feats.cu"


def _design(tp: int, tc: int, warps: int, blocks: int, unroll: int) -> dict:
    return {"TP": tp, "TC": tc, "WARPS": warps, "MIN_BLOCKS": blocks, "KUNROLL": unroll}


# (old, new) edits of dense_decode_feats.cu that read the trunk's fc_c
# biases through L1, as K4's first design did, instead of from shared memory
_BIAS_L1 = [
    ("  float* bsh = smem + trunk::weight_floats(NB) + WARPS * Lane::ACT_FLOATS;  // (NB, H): head "
     "e's bc\n  if (kBias)\n    for (int i = threadIdx.x; i < NB * H; i += blockDim.x)\n"
     "      bsh[i] = bc[(size_t)(i / H) * F + e * H + i % H];\n", ""),
    ("          const float4 v = *reinterpret_cast<const float4*>(bsh + blk * H + "
     "ln.column(4 * q));\n",
     "          const float4 v = __ldg(reinterpret_cast<const float4*>(bc + (size_t)blk * F + "
     "col +\n                                                                 "
     "ln.column(4 * q)));\n"),
]
# ... and that index the projections' job parameter by blockIdx.y (ptxas then
# copies it to local memory), as K4's first design did
_JOB_BY_INDEX = [
    ("  const ProjJob jb = blockIdx.y == 0 ? jobs.job[0] : blockIdx.y == 1 ? jobs.job[1] : "
     "jobs.job[2];\n", "  const ProjJob& jb = jobs.job[blockIdx.y];\n"),
]

# name -> (design constants, edits)
DESIGNS = {
    "trunk 8x8, 12 x 1, k unroll 2; projections 8x4, 64 rows (shipped)": ({}, []),
    "trunk 8x8, 8 x 1, k unroll 4": (_design(8, 8, 8, 1, 4), []),
    "trunk 4x8, 16 x 1, k unroll 4": (_design(4, 8, 16, 1, 4), []),
    "projections 8x8, 64 rows": ({"PROJ_TC": 8}, []),
    "projections 8x8, 128 rows": ({"PROJ_ROWS": 128, "PROJ_TC": 8}, []),
    "fc_c biases through L1": ({}, _BIAS_L1),
    "first design: biases through L1, projections capped at 64 registers": (
        {"PROJ_MAX_THREADS": 1024}, _BIAS_L1 + _JOB_BY_INDEX),
}

_PROJECT_ROWS = [
    ("    jobs.job[n++] = {fxz, wxz, sxz, x0, xr};\n", ""),
    ("    jobs.job[n++] = {fxy, wxy, sxy, x0, xr};\n", ""),
]
_PYZ = [
    ("    if (kK4 && x0 == 0) jobs.job[n++] = {fyz, wyz, syz, 0, R};\n", ""),
    ("      tiled::add_rows(net, rows[2], ln);\n", ""),
]
_BIAS = [("        for (int p = 0; p < TP; ++p)\n#pragma unroll\n"
          "          for (int c = 0; c < TC; ++c) net[p][c] += bias[c];\n",
          "        for (int p = 0; p < TP; ++p) {}\n")]

# name -> [(old, new) edits of dense_decode_feats.cu], on the shipped design
ABLATIONS = {
    "ablation: no xz/xy row projections": _PROJECT_ROWS,
    "ablation: no pyz (projection and add)": _PYZ,
    "ablation: no fc_c bias add": _BIAS,
}


def build_edits(name: str) -> tuple:
    """(design constants, {file: edits}) of one of ``DESIGNS`` or ``ABLATIONS``."""
    constants, edits = DESIGNS.get(name, ({}, []))
    return constants, {SOURCE: edits + ABLATIONS.get(name, [])}


def takes_workspace(source: Path) -> bool:
    """Whether a source's bf16 entry points take a bf16 workspace (the
    rounding prologue's) instead of float32 row scratch."""
    return "round_features_kernel" in source.read_text()


def bf16_kernel_names(hybrid: bool) -> tuple:
    """The mangled name's start of K4's (K5's, ``hybrid``) bf16 kernel for
    ``chip_smoke.kernel_resources``: the shipped template instance, then the
    trunk of the design before it (float32 rows; K5's pyz bf16)."""
    return (f"dense_decode_feats_bf16_kernelILb{int(not hybrid)}E",
            "dense_decode_feats_bf16_kernelI13__nv_bfloat16Lb0E" if hybrid
            else "dense_decode_feats_bf16_kernelIfLb1E")


def main_bf16(args, sources: dict) -> int:
    """--bf16: K4 and K5 bf16 of each build, checked, then timed in turns."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from giga_tpu_torch.inference.dense_decode import (
        lattice_coords, sample_planes_on_lattice_batched)
    from giga_tpu_torch.inference.planner import full_precision
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.ops.kernels import _build
    from giga_tpu_torch.ops.kernels import decoder as dk

    if args.rounds < 4:
        raise SystemExit("ab_dense_decode_feats --bf16: at least 4 rounds")
    card = chip_smoke.card_line()
    libs = build(sources, "dense_decode_feats_bf16")
    bf = torch.bfloat16
    net, cfg = load_network(ROOT / chip_smoke.CHECKPOINT)
    net = net.cuda().eval().to(bf)
    R, B, E, H, O = chip_smoke.RESOLUTION, args.batch, 3, 32, 4
    nb, C, F = cfg.decoder.n_blocks, cfg.encoder.c_dim, 3 * 32
    coords = lattice_coords(R, "cuda")
    tsdfs = torch.from_numpy(chip_smoke.make_scenes(B)).cuda().to(bf)
    with torch.inference_mode(), full_precision():
        feats = sample_planes_on_lattice_batched(net.encode(tsdfs), coords,
                                                 cfg.encoder.plane_resolution,
                                                 cfg.decoder.padding)
        dec = net.decoder_aff.params()
        inputs = {"K4": dk.prepare_feats_inputs(dec, feats, coords, nb),
                  "K5": dk.prepare_hybrid_inputs(dec, feats, coords, nb, bf)}
        del feats, tsdfs
        out = torch.empty((B, R, R, R, E * O), device="cuda")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = {k: [ctypes.c_void_p(t.data_ptr()) for t in (*v, out)] for k, v in inputs.items()}
        scratch = {}

        def scratch_of(name, kernel):
            """The pointers a build's entry point takes after `out`."""
            if (name, kernel) not in scratch:
                if takes_workspace(sources[name]):
                    planes = 3 if kernel == "K4" else 2
                    ts = [torch.empty((planes, B, R, R, C), device="cuda", dtype=bf)]
                else:  # the float32 rows: xz, xy (and K4's yz) of every x-slab
                    ts = [torch.empty((B, nb, R, R, F), device="cuda")
                          for _ in range(3 if kernel == "K4" else 2)]
                scratch[(name, kernel)] = (ts, [ctypes.c_void_p(t.data_ptr()) for t in ts])
            return scratch[(name, kernel)][1]

        def call(name, kernel):
            lib = libs[name][0]
            if kernel == "K4":
                err = lib.dense_decode_feats_bf16(*ptrs["K4"], *scratch_of(name, "K4"), B, R, C, E,
                                                  nb, R, stream)
            else:
                err = lib.dense_decode_hybrid_bf16(*ptrs["K5"], *scratch_of(name, "K5"), B, R, C,
                                                   E, nb, stream)
            _build.check(err, f"{name} {kernel} bf16")

        plain = {"K4": dk.dense_decode_feats_plain(*inputs["K4"], compute_dtype=bf),
                 "K5": dk.dense_decode_hybrid_plain(*inputs["K5"])}
        for name, (lib, log) in libs.items():
            for kernel in ("K4", "K5"):
                out.fill_(float("nan"))
                call(name, kernel)
                torch.cuda.synchronize()
                share, rel, err = chip_smoke.check_bf16(out, plain[kernel], f"{name} {kernel}")
                res = chip_smoke.kernel_resources(log, *bf16_kernel_names(kernel == "K5"))
                print(f"{name}: {kernel} bf16 against its plain version: share within "
                      f"{chip_smoke.TOL_BF16_CLOSE} {share:.6f}, max err/(1+|plain|) {rel:.3g}, "
                      f"max abs err {err:.3g}; ptxas {res}", flush=True)
        del plain

        runs = [(name, k) for name in libs for k in ("K4", "K5")]
        times = {run: [] for run in runs}
        for r in range(args.rounds):
            for name, k in (runs if r % 2 == 0 else runs[::-1]):
                times[(name, k)].append(chip_smoke.cuda_ms(lambda: call(name, k), args.iters,
                                                           warmup=1))
    bounds = {"K4": chip_smoke.bound(*chip_smoke.dense_decode_feats_work(B, R, C, E, H, nb, O),
                                     peak=chip_smoke.PEAK_BF16_FLOPS),
              "K5": chip_smoke.bound(*chip_smoke.dense_decode_hybrid_work(B, R, C, E, H, nb, O,
                                                                          pyz_elem=2),
                                     peak=chip_smoke.PEAK_BF16_FLOPS)}
    for (name, k), ms in times.items():
        bnd = bounds[k]
        print(f"{name:24s} {k} bf16: {min(ms):.4f}-{max(ms):.4f} ms "
              f"[{', '.join(f'{m:.4f}' for m in ms)}] bound {bnd[0]:.4f} ms by {bnd[1]} "
              f"({bnd[0] / min(ms):.1%} of it at best) B={B} R={R} | {card}")
    return 0


def main(argv=None) -> int:
    builds = {**DESIGNS, **ABLATIONS}
    ap = argparse.ArgumentParser(description="A/B the raw-feature dense-decode kernel's designs.")
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help=f"a tree whose giga_tpu_torch/csrc/{SOURCE} joins the A/B")
    ap.add_argument("--builds", nargs="*", choices=list(builds), default=list(builds))
    ap.add_argument("--chunks", type=int, nargs="*", default=[8, 40])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--bf16", action="store_true",
                    help="time K4 and K5 bf16 of the shipped source against each --tree's")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ab_dense_decode_feats: no CUDA device", file=sys.stderr)
        return 2
    if args.bf16:
        sources = {"shipped": ROOT / "giga_tpu_torch" / "csrc" / SOURCE}
        for tree in args.tree:
            name, path = tree.split("=", 1)
            sources[name] = Path(path).resolve() / "giga_tpu_torch" / "csrc" / SOURCE
        return main_bf16(args, sources)
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
        sources[name] = edited_copy(_build.BUILD_DIR / "ab" / f"feats{i}", SOURCE,
                                    *build_edits(name))
    for tree in args.tree:
        name, path = tree.split("=", 1)
        sources[name] = Path(path).resolve() / "giga_tpu_torch" / "csrc" / SOURCE
    libs = build(sources, "dense_decode_feats")

    net, cfg = load_network(ROOT / chip_smoke.CHECKPOINT)
    net = net.cuda().eval()
    R, B, E, H, O = chip_smoke.RESOLUTION, args.batch, 3, 32, 4
    nb, C, F = cfg.decoder.n_blocks, cfg.encoder.c_dim, 3 * 32
    coords = lattice_coords(R, "cuda")
    tsdfs = torch.from_numpy(chip_smoke.make_scenes(B)).cuda()
    with torch.inference_mode(), full_precision():
        feats = sample_planes_on_lattice_batched(net.encode(tsdfs), coords,
                                                 cfg.encoder.plane_resolution,
                                                 cfg.decoder.padding)
        inputs = dk.prepare_feats_inputs(net.decoder_aff.params(), feats, coords, nb)
        out = torch.empty((B, R, R, R, E * O), device="cuda")
        syz = torch.empty((B, nb, R, R, F), device="cuda")
        sx = {c: [torch.empty((B, nb, min(c, R), R, F), device="cuda") for _ in range(2)]
              for c in args.chunks}
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*inputs, out)]

        def k4(lib, chunk):
            if hasattr(lib, "dense_decode_feats_config"):
                scratch = [ctypes.c_void_p(t.data_ptr()) for t in (*sx[chunk], syz)]
                err = lib.dense_decode_feats_f32(*ptrs, *scratch, B, R, C, E, nb, min(chunk, R),
                                                 stream)
            else:
                err = lib.dense_decode_feats_f32(*ptrs, B, R, C, E, nb, min(chunk, R), stream)
            _build.check(err, "dense_decode_feats_f32")

        refs = {c: dk.dense_decode_feats_batched(*inputs, x_chunk=c) for c in args.chunks}
        for name, (lib, log) in libs.items():
            same = True
            for c in args.chunks:
                out.fill_(float("nan"))
                k4(lib, c)
                torch.cuda.synchronize()
                same = same and torch.equal(out, refs[c])
            res = chip_smoke.kernel_resources(log, "dense_decode_feats_kernelILb1E",
                                              "dense_decode_feats_kernel")
            print(f"{name}: K4 output equals the shipped library's bit for bit at x_chunk "
                  f"{args.chunks}: {same}; ptxas trunk {res}", flush=True)
            if not same and name not in ABLATIONS:
                raise AssertionError(f"{name} gives other outputs than the shipped library")

        runs = [(name, c) for name in libs for c in args.chunks]
        times = {run: [] for run in runs}
        for r in range(args.rounds):
            for name, c in (runs if r % 2 == 0 else runs[::-1]):
                lib = libs[name][0]
                times[(name, c)].append(chip_smoke.cuda_ms(lambda: k4(lib, c), args.iters,
                                                           warmup=1))
    bnd = chip_smoke.bound(*chip_smoke.dense_decode_feats_work(B, R, C, E, H, nb, O))
    for (name, c), ms in times.items():
        print(f"{name:42s} x_chunk {c:2d} K4: {min(ms):.4f}-{max(ms):.4f} ms "
              f"[{', '.join(f'{m:.4f}' for m in ms)}] bound {bnd[0]:.4f} ms by {bnd[1]} "
              f"({bnd[0] / min(ms):.1%} of it at best) B={B} R={R} | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
