#!/usr/bin/env python3
"""A/B of the stem + pool kernel's designs (K1) on the card.

    python3 -m giga_tpu_torch.scripts.ab_stem_pool [--bf16] [--tree NAME=DIR ...]
        [--builds NAME ...] [--rounds 4]

Run from the repository root. Each build in ``DESIGNS`` and ``ABLATIONS``
(by default all of them) is a copy of ``giga_tpu_torch/csrc/stem_pool.cu``
edited in ``build/giga_tpu_torch/ab/``:

- a design sets the source's design constants (z of a thread's micro-tile
  ``TZ``, channels per block ``CB``, warps that only pool ``POOL_WARPS``,
  sums a pooling thread carries ``SUMS``, threads per block, resident
  blocks per SM asked of ptxas) and may pool each slab in every thread after its barrier instead
  (``POOL_AFTER_BARRIER``, the design before the pooling warps);
- an ablation deletes work to show what it costs: the pooling (each slab's
  tile stores and the xy/xz sums; the yz sums stay, so the taps stay live),
  the TSDF tap loads (every (dx, dy) column reads the same shared address,
  which ptxas loads once), or the weight loads (every tap reads the first
  tap's weights). Its outputs are wrong by construction and are not checked.

Each ``--tree NAME=DIR`` adds ``DIR/giga_tpu_torch/csrc/stem_pool.cu`` as it
stands, for example the parent commit unpacked by ``git archive``. All builds
compile at once, one nvcc each. On chip_smoke's seeded scenes (B=64, R=40)
through the shipped checkpoint's first convolution, every build but the
ablations must give xz, xy and yz equal, ``torch.equal``, to the shipped
library's; then each is timed by CUDA events in turns (the builds in order,
then in reverse, ``--rounds`` times). Prints each build's ptxas registers
and spills and every reading with its range and share of the bound, beside
the card's name and power limit.

``--bf16`` times the bf16 mode's entry point ``stem_pool_bf16`` instead, on
the same scenes and convolution in bf16, with the builds ``BF16_DESIGNS``
(the tensor-core kernel as shipped) and ``BF16_ABLATIONS`` (no pooling: the
tap warps' xy and xz sums' stores and the pooling warps' adds gone, yz kept;
no products: each ``mma`` replaced by an accumulate of its operands' bits). The tensor core sums a
tap's products in its own order, so no two designs need agree bit for bit:
every build but the ablations is held to ``chip_smoke.check_bf16`` against
the plain version, and each build's largest difference from the outputs of
the tree named ``parent`` is printed. The bound is at 989 TFLOP/s and 2
bytes a value.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

from giga_tpu_torch.scripts.ab_dense_decode import build, edited_copy

ROOT = Path(__file__).resolve().parents[2]

# (old, new) edits of stem_pool.cu (with POOL_WARPS = 0) that pool slab x in
# every thread after the slab's barrier, instead of in pooling warps of
# their own while the tap warps run slab x + 1
POOL_AFTER_BARRIER = [
    ("    } else if (tid >= pool0 && x > 0) {\n"
     "      pool_slab(x - 1, tid - pool0, 32 * POOL_WARPS);\n    }\n"
     "    __syncthreads();  // slab x's tile is whole; slab x + 2 is in the ring\n"
     "  }\n  pool_slab(X - 1, tid, blockDim.x);\n",
     "    }\n"
     "    __syncthreads();  // slab x's tile is whole; slab x + 2 is in the ring\n"
     "    pool_slab(x, tid, blockDim.x);\n  }\n"),
]

# name -> (design constants, edits)
DESIGNS = {
    "4 z x 8 channels, 6 pooling warps of 4 sums (shipped)": ({}, []),
    "4 z x 8 channels, 4 pooling warps of 4 sums": ({"POOL_WARPS": 4, "MAX_THREADS": 544}, []),
    "4 z x 8 channels, 8 pooling warps of 4 sums": ({"POOL_WARPS": 8, "MAX_THREADS": 672}, []),
    "4 z x 8 channels, 3 pooling warps of 8 sums": (
        {"POOL_WARPS": 3, "SUMS": 8, "MAX_THREADS": 512}, []),
    "4 z x 8 channels, 6 pooling warps of 8 sums": ({"SUMS": 8}, []),
    "8 z x 8 channels, 4 pooling warps of 4 sums": (
        {"TZ": 8, "POOL_WARPS": 4, "MAX_THREADS": 352}, []),
    "4 z x 8 channels, all threads pool after the barrier": (
        {"POOL_WARPS": 0, "MAX_THREADS": 416}, POOL_AFTER_BARRIER),
    "4 z x 4 channels, all threads pool after the barrier, 2 blocks per SM": (
        {"CB": 4, "POOL_WARPS": 0, "MAX_THREADS": 416, "MIN_BLOCKS": 2}, POOL_AFTER_BARRIER),
}

# name -> [(old, new) edits of stem_pool.cu], on the shipped design
ABLATIONS = {
    "ablation: no pooling (yz kept)": [
        ("reinterpret_cast<float4*>(tile + y * L.ys + c * L.zt + z0)[q] =\n"
         "              make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);", "{}"),
        ("for (int task = first; task < ntask;", "for (int task = ntask; task < ntask;")],
    "ablation: no TSDF tap loads": [
        ("const float* col = s + (y + dy) * L.zp + z0;",
         "const float* col = ring + y * L.zp + z0;")],
    "ablation: no weight loads": [
        ("const float4 u = ld4(w + 4 * q);", "const float4 u = ld4(wsh + 4 * q);")],
}


# name -> (design constants, edits) of the bf16 kernel (``--bf16``)
BF16_DESIGNS = {
    "bf16: m16 tap tiles on mma.sync, pooling in the 10 tap warps, 6 pooling warps (shipped)": ({}, []),
}

# name -> [(old, new) edits of stem_pool.cu], on the shipped bf16 kernel
BF16_ABLATIONS = {
    "bf16 ablation: no pooling (yz kept)": [
        ("        *reinterpret_cast<float2*>(row_xy) = make_float2(sxy[0], sxy[1]);\n", ""),
        ("        *reinterpret_cast<float2*>(sums + 16 * zt * 8) = make_float2(sxz[zt][0], sxz[zt][1]);\n"
         "        *reinterpret_cast<float2*>(sums + (16 * zt + 8) * 8) =\n"
         "            make_float2(sxz[zt][2], sxz[zt][3]);\n", ""),
        ("for (int job = first; job < 2 * (Y + Z);", "for (int job = 2 * (Y + Z); job < 2 * (Y + Z);")],
    "bf16 ablation: no products": [
        ("mma_bf16(d, a, bw[s]);",
         "d[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ bw[s].x ^ bw[s].y);")],
}


def _fp32_kernel(log: str) -> str:
    """K1's float32 kernel by its mangled name: a template instance since
    the bf16 mode, a plain function in earlier trees (``--tree``)."""
    return "stem_pool_kernelIfE" if "stem_pool_kernelIfE" in log else "stem_pool_kernel"


def _bf16_kernel(log: str, R: int) -> str:
    """ptxas resources of K1's bf16 kernel at R: its own kernel's instance,
    or in trees before it (``--tree``) the bf16 instance of the float32
    template."""
    import chip_smoke

    return chip_smoke.kernel_resources(log, chip_smoke.k1_bf16_kernel(R),
                                       "stem_pool_kernelI13__nv_bfloat16E")


def build_edits(name: str) -> tuple:
    """(design constants, {file: edits}) of one of ``DESIGNS``, ``ABLATIONS``,
    ``BF16_DESIGNS`` or ``BF16_ABLATIONS``."""
    if name in BF16_DESIGNS or name in BF16_ABLATIONS:
        constants, edits = BF16_DESIGNS.get(name, ({}, []))
        return constants, {"stem_pool.cu": edits + BF16_ABLATIONS.get(name, [])}
    constants, edits = DESIGNS.get(name, ({}, []))
    return constants, {"stem_pool.cu": edits + ABLATIONS.get(name, [])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="A/B the stem + pool kernel's designs.")
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="a tree whose giga_tpu_torch/csrc/stem_pool.cu joins the A/B")
    ap.add_argument("--builds", nargs="*",
                    choices=list({**DESIGNS, **ABLATIONS, **BF16_DESIGNS, **BF16_ABLATIONS}))
    ap.add_argument("--bf16", action="store_true",
                    help="time the bf16 mode's designs (BF16_DESIGNS, BF16_ABLATIONS) instead")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    designs, ablations = (BF16_DESIGNS, BF16_ABLATIONS) if args.bf16 else (DESIGNS, ABLATIONS)
    if args.builds is None:
        args.builds = [*designs, *ablations]

    import torch

    if not torch.cuda.is_available():
        print("ab_stem_pool: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from giga_tpu_torch.inference.planner import full_precision
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.ops.kernels import _build
    from giga_tpu_torch.ops.kernels.stem import stem_pool_batched, stem_pool_plain

    card = chip_smoke.card_line()
    sources = {}
    for i, name in enumerate(args.builds):
        sources[name] = edited_copy(_build.BUILD_DIR / "ab" / f"stem{i}", "stem_pool.cu",
                                    *build_edits(name))
    for tree in args.tree:
        name, path = tree.split("=", 1)
        sources[name] = Path(path).resolve() / "giga_tpu_torch" / "csrc" / "stem_pool.cu"
    libs = build(sources, "stem_pool")

    net, cfg = load_network(ROOT / chip_smoke.CHECKPOINT)
    conv = net.cuda().eval().encoder.conv_in
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    entry = "stem_pool_bf16" if args.bf16 else "stem_pool_f32"
    B, R, C = args.batch, chip_smoke.RESOLUTION, cfg.encoder.c_dim
    tsdfs = torch.from_numpy(chip_smoke.make_scenes(B)).cuda().to(dtype)
    with torch.inference_mode(), full_precision():
        w, b = conv.weight.to(dtype).contiguous(), conv.bias.to(dtype).contiguous()
        ref = stem_pool_batched(w, b, tsdfs)
        plain = stem_pool_plain(w, b, tsdfs)
        outs = {t: torch.empty_like(v) for t, v in ref.items()}
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tsdfs, w, b, outs["xz"], outs["xy"],
                                                         outs["yz"])]

        def k1(lib):
            _build.check(getattr(lib, entry)(*ptrs, B, R, R, R, C, stream), entry)

        results = {}
        for name, (lib, log) in libs.items():
            for v in outs.values():
                v.fill_(float("nan"))
            k1(lib)
            torch.cuda.synchronize()
            results[name] = {t: v.clone() for t, v in outs.items()}
            err = max(float((outs[t].float() - plain[t].float()).abs().max()) for t in ref)
            if args.bf16:
                res = _bf16_kernel(log, R)
                if name in ablations:
                    held = "not checked (ablation)"
                else:
                    held = [tuple(round(x, 6) for x in chip_smoke.check_bf16(
                        outs[t], plain[t], f"{name} {t}")) for t in ref]
                print(f"{name}: check_bf16 against the plain version (share within "
                      f"{chip_smoke.TOL_BF16_CLOSE}, max err/(1+|plain|), max abs err) "
                      f"{held}; ptxas {res}", flush=True)
                continue
            same = all(torch.equal(outs[t], ref[t]) for t in ref)
            print(f"{name}: xz, xy, yz equal the shipped library's bit for bit: {same}; max abs "
                  f"err vs the plain version {err:.3g}; ptxas "
                  f"{chip_smoke.kernel_resources(log, _fp32_kernel(log))}", flush=True)
            if not same and name not in ablations:
                raise AssertionError(f"{name} gives other outputs than the shipped library")
        if "parent" in results:
            for name, got in results.items():
                diff = max(float((got[t].float() - results["parent"][t].float()).abs().max())
                           for t in got)
                print(f"{name}: largest difference from the parent's outputs {diff:.3g}")

        times = {name: [] for name in libs}
        order = list(libs)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                lib = libs[name][0]
                times[name].append(chip_smoke.cuda_ms(lambda: k1(lib), args.iters))
    if args.bf16:
        bnd = chip_smoke.bound(*chip_smoke.stem_pool_work(B, R, C, elem=2),
                               peak=chip_smoke.PEAK_BF16_FLOPS)
    else:
        bnd = chip_smoke.bound(*chip_smoke.stem_pool_work(B, R, C))
    for name, ms in times.items():
        print(f"{name:46s} K1{' bf16' * args.bf16}: {min(ms):.4f}-{max(ms):.4f} ms "
              f"[{', '.join(f'{m:.4f}' for m in ms)}] bound {bnd[0]:.4f} ms by {bnd[1]} "
              f"({bnd[0] / min(ms):.1%} of it at best) B={B} R={R} C={C} | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
