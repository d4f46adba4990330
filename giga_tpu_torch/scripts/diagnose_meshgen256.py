#!/usr/bin/env python3
"""One warm 257^3 refine reconstruction split into its stages, on the card
(counterpart of scripts/diagnose_meshgen256.py).

    python3 -m giga_tpu_torch.scripts.diagnose_meshgen256 [--precision fp32|bf16]
        [--resolution0 32] [--steps 3] [--repeats 3] [--device cuda]

Run from the repository root. The shipped GIGA-Geo checkpoint on bench.py's
scene, strategy "refine". A first ``generate_mesh`` reports the budget tier
that ran, the band and per-level point counts against each tier's budgets,
and the faces. Then each of ``--repeats`` runs splits one call into

    encode       the encoder (CUDA events)
    refine       the chain at that tier (``refine_program``), its stages by
                 the generator's marks (CUDA events), and the band's fetch
                 (host clock to the copy's end; the fetched bytes)
    triangulate  the host's sparse marching and the TriMesh

and the last line before the JSON object gives the median of whole warm
``generate_mesh`` calls (bench.py's protocol). Every line stands beside the
card's name and power limit. ``--device cpu`` is a rehearsal by the host
clock (no stage split).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--precision", choices=["fp32", "bf16"], default="fp32")
    ap.add_argument("--resolution0", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from giga_tpu_torch.core.device import resolve_device
    from giga_tpu_torch.geometry.generation import MeshGenerator, fetch
    from giga_tpu_torch.models.registry import load_network
    from giga_tpu_torch.scripts.profile_batched import card_line
    from giga_tpu_torch.scripts.profile_meshgen import CHECKPOINT, bench_scenes, marked

    device = resolve_device(args.device)
    card = card_line(device)
    net, _ = load_network(CHECKPOINT, "giga_geo")
    gen = MeshGenerator(net, resolution0=args.resolution0, upsampling_steps=args.steps,
                        strategy="refine", precision=args.precision, device=device)
    tsdf = bench_scenes(1)[0]

    mesh, st = gen.generate_mesh(tsdf)  # warm; reports the tier
    tier = int(st.get("refine tier", 0))
    report = {"tier": st.get("refine tier"), "path": st.get("path"),
              "bands": st.get("refine cells (band/points-per-level)"),
              "budgets": [[k_f, list(k_ps)] for k_f, k_ps in gen._refine_tiers],
              "faces": len(mesh.faces)}
    print(f"tier {report['tier']} ({report['path']}), band / points a level "
          f"{report['bands']}, budgets a tier {report['budgets']}, faces {report['faces']} "
          f"| {card}", flush=True)

    reps = []
    for rep in range(args.repeats):
        planes, enc = marked(gen, lambda: gen.encode(tsdf))
        t0 = time.perf_counter()
        out, stages = marked(gen, lambda: gen.refine_program(planes, tier))
        ids, vals, count_f, _ = fetch(*out)
        refine_s = time.perf_counter() - t0
        cf = int(count_f)
        t0 = time.perf_counter()
        m = gen._mesh_from_band(ids[:cf], vals[:cf], {})
        tri_s = time.perf_counter() - t0
        row = {"encode_ms": enc.get("encode"), "refine_fetch_ms": refine_s * 1e3,
               "stages_ms": stages, "fetch_mb": (ids.nbytes + vals.nbytes) / 1e6,
               "triangulate_ms": tri_s * 1e3, "cells": cf, "faces": len(m.faces)}
        reps.append(row)
        enc_txt = "n/a" if row["encode_ms"] is None else f"{row['encode_ms']:.3f} ms"
        print(f"rep {rep}: encode {enc_txt} | refine+fetch {row['refine_fetch_ms']:.3f} ms ("
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f"; {row['fetch_mb']:.3f} MB band) | triangulate {row['triangulate_ms']:.3f} ms "
              f"({cf} cells, {row['faces']} faces) | {card}", flush=True)

    ts = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        gen.generate_mesh(tsdf, return_stats=False)
        ts.append(time.perf_counter() - t0)
    whole = float(np.median(ts)) * 1e3
    print(f"generate_mesh warm median: {whole:.3f} ms (bench.py's protocol) | {card}")
    print(json.dumps({"script": "diagnose_meshgen256", "card": card,
                      "precision": args.precision, **report, "reps": reps,
                      "generate_mesh_ms": whole}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
