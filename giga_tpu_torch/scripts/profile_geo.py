#!/usr/bin/env python3
"""Stage breakdown of giga_geo's encode + N occupancy queries on the card
(counterpart of scripts/profile_geo.py; bench.py's
``giga_geo_100k_queries_ms`` path, the reference's eval_points chunking).

    python3 -m giga_tpu_torch.scripts.profile_geo [--n 100000] [--repeats 3]
        [--n-hi 9] [--device cuda] [--cpu]

Run from the repository root. One seeded TSDF and N seeded points in
[-0.5, 0.5]^3 through a giga_geo net with ``reference_init(net, 3)``
weights. Each stage is a prefix of the query program, timed by
``utils.benchmark.serial_chain_latency`` (CUDA events over a chain whose
input moves by its last output; every output reduced, so no stage is
skipped):

  encode               TSDF -> triplane features
  +sample              + bilinear sampling at the N points, gather sampler
  +trunk (full)        + fc_p, 5 ResNet blocks, the occupancy head
  +sample_mm[p]        + the samples as dense matmuls (sampler "mm")
  +trunk_mm[p] (full)  + the trunk on the mm features

The gather stages run at ``highest`` (TF32 off, GIGANet's own scope); the
mm stages at each precision p: ``highest``, ``tf32`` (TF32 on for the
convolutions and matmuls) and ``bf16`` (a bf16 copy of the net; the
samples and the trunk promote to float32 as the JAX package's do). The mm
features and logits at ``highest`` must agree with the gather's within
2e-5 * (1 + |b|), or the script raises; the tf32 and bf16 distances are
printed. Each line stands beside the card's name and power limit; the last
is one JSON object. ``--cpu`` (or ``--device cpu``) runs on the CPU by the
host clock, a rehearsal and no device metric.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

TOL_AGREE = 2e-5  # mm against gather at highest, |a - b| <= tol * (1 + |b|)
PRECISIONS = ("highest", "tf32", "bf16")


def reduce_all(out):
    """The sum of every finite entry of every output tensor, in float32."""
    import torch

    from giga_tpu_torch.utils.benchmark import _leaves

    return sum(torch.nan_to_num(t.float(), nan=0.0, posinf=0.0, neginf=0.0).sum()
               for t in _leaves(out))


def chain_ms(fn, x, inner: int, repeats: int) -> float:
    """ms an iteration of ``fn`` in a serial chain: each call's input is
    ``x`` moved by 1e-24 x the sum of all previous outputs
    (``serial_chain_latency``: CUDA events on the card, the host clock on
    the CPU)."""
    import torch

    from giga_tpu_torch.utils.benchmark import serial_chain_latency

    def loop(n, x):
        acc = torch.zeros((), device=x.device)
        for _ in range(n):
            acc = acc + reduce_all(fn(x + acc * 1e-24))
        return acc

    with torch.inference_mode():
        return serial_chain_latency(loop, (x,), inner=inner, repeats=repeats) * 1e3


def scaled_err(got, ref) -> float:
    """max |a - b| / (1 + |b|) in float64."""
    got, ref = (t.detach().double().cpu() for t in (got, ref))
    return float(((got - ref).abs() / (1 + ref.abs())).max())


def scope(precision: str):
    from giga_tpu_torch.core.precision import full_precision, tf32_precision

    return tf32_precision() if precision == "tf32" else full_precision()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100000, help="occupancy queries")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--n-hi", type=int, default=9, help="chain length of a timed run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu (a rehearsal)")
    return ap.parse_args(argv)


def build_stages(net, cfg, pts) -> list:
    """[(name, precision, fn(grid) -> outputs)] of the query program's
    prefixes on ``net`` (and a bf16 copy of it) at the points ``pts``."""
    import copy
    import dataclasses

    import torch

    from giga_tpu_torch.models.decoder import query_planes
    from giga_tpu_torch.ops.sampling import sample_planes_concat_mm

    nets = {"highest": net, "tf32": net, "bf16": copy.deepcopy(net).to(torch.bfloat16)}
    dec = cfg.decoder
    gather_dec = dataclasses.replace(dec, sampler="gather")

    def encode(n, g):
        return n.encoder(g.to(n.dtype))

    def mm_feats(planes):
        return torch.stack([sample_planes_concat_mm({t: v[b] for t, v in planes.items()},
                                                    pts[b], dec.padding)
                            for b in range(pts.shape[0])])

    def trunk(n, planes, feats):
        return n.decoder_occ(planes, pts, feature=feats)[0, ..., 0]

    def stage_fns(n):
        """(encode, +sample_mm, +trunk_mm) on net ``n``."""
        def sample(g):
            return mm_feats(encode(n, g))

        def full(g):
            planes = encode(n, g)
            return trunk(n, planes, mm_feats(planes))

        return (lambda g: encode(n, g)), sample, full

    def gather_full(g):
        planes = encode(net, g)
        return trunk(net, planes, query_planes(planes, pts, gather_dec))

    stages = [("encode", "highest", lambda g: encode(net, g)),
              ("+sample", "highest", lambda g: query_planes(encode(net, g), pts, gather_dec)),
              ("+trunk (full)", "highest", gather_full)]
    for p in PRECISIONS:
        stages += list(zip((f"encode[{p}]", f"+sample_mm[{p}]", f"+trunk_mm[{p}] (full)"),
                           (p,) * 3, stage_fns(nets[p])))
    return stages


def check_variants(stages, grid) -> tuple:
    """Run every stage once; raise unless all outputs are finite and the mm
    features and logits at highest lie within TOL_AGREE * (1 + |b|) of the
    gather's. Returns ({features, logits}: that distance, {precision: its
    logits' distance from highest's})."""
    import torch

    from giga_tpu_torch.utils.benchmark import _leaves

    outs = {}
    with torch.inference_mode():
        for name, p, fn in stages:
            with scope(p):
                outs[name] = fn(grid)
    agree = {"features": scaled_err(outs["+sample_mm[highest]"], outs["+sample"]),
             "logits": scaled_err(outs["+trunk_mm[highest] (full)"], outs["+trunk (full)"])}
    if not all(torch.isfinite(t.float()).all() for o in outs.values() for t in _leaves(o)):
        raise AssertionError("a stage gave non-finite outputs")
    if not max(agree.values()) <= TOL_AGREE:
        raise AssertionError(f"mm against gather at highest: {agree} > {TOL_AGREE} * (1 + |b|)")
    distance = {p: scaled_err(outs[f"+trunk_mm[{p}] (full)"], outs["+trunk_mm[highest] (full)"])
                for p in PRECISIONS[1:]}
    return agree, distance


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from giga_tpu_torch.core.device import resolve_device
    from giga_tpu_torch.models.registry import get_network, reference_init
    from giga_tpu_torch.scripts.profile_batched import card_line

    device = resolve_device("cpu" if args.cpu else args.device)
    card = card_line(device)
    net, cfg = get_network("giga_geo")
    net = reference_init(net, 3).to(device).eval()
    rng = np.random.RandomState(0)
    grid = torch.from_numpy(rng.rand(1, 40, 40, 40).astype(np.float32)).to(device)
    pts = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, args.n, 3)).astype(np.float32)).to(device)
    stages = build_stages(net, cfg, pts)
    agree, distance = check_variants(stages, grid)
    print(f"N={args.n}: mm against gather at highest, features {agree['features']:.3g}, logits "
          f"{agree['logits']:.3g} * (1 + |b|) (tol {TOL_AGREE}); logits from highest's: "
          + ", ".join(f"{p} {d:.3g}" for p, d in distance.items()) + f" | {card}")

    ms = {}
    prev = 0.0
    print(f"{'stage':<24} {'ms':>9} {'delta ms':>9}")
    for name, p, fn in stages:
        if name.startswith("encode"):
            prev = 0.0
        with scope(p):
            ms[name] = chain_ms(fn, grid, args.n_hi - 1, args.repeats)
        print(f"{name:<24} {ms[name]:9.3f} {ms[name] - prev:9.3f} | {card}", flush=True)
        prev = ms[name]
    print(json.dumps({"script": "profile_geo", "card": card, "n": args.n,
                      "ms": ms, "agree": agree, "distance_from_highest": distance}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
