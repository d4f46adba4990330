#!/usr/bin/env python3
"""The batched postprocess (mask -> bound -> select) in isolation, on the
card (counterpart of scripts/profile_postprocess.py).

    python3 -m giga_tpu_torch.scripts.profile_postprocess [--batch 64]
        [--repeats 3] [--n-hi 17] [--device cuda]

Run from the repository root. On B seeded (40^3) quality, TSDF, rotation
and width volumes, each timed by ``utils.benchmark.serial_chain_latency``
(CUDA events; every output reduced, so no stage is skipped):

  * the primitives: the Gaussian blur as taps (a 1D correlation per axis
    over edge-padded rows, the JAX script's form) and as the port's matrix
    form (``ops.filters.gaussian_blur_3d``); NMS's max filter as a dense 4^3
    window and as the port's separable ``max_filter_3d``; the surface-band
    dilation;
  * the full postprocess with each blur x NMS pair;
  * the shipped chain's sub-stages by prefix: blur, +mask, +bound, +select.

The two blurs must agree within 1e-6 and the two max filters (and so the
four postprocesses' candidates) exactly, or the script raises. Each line
stands beside the card's name and power limit; the last is one JSON object.
``--device cpu`` is a rehearsal by the host clock, not a device metric.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np

TOL_BLUR = 1e-6  # taps against the matrix form, absolute


def blur_taps(vol, sigma: float = 1.0, truncate: float = 4.0):
    """The JAX script's blur: per spatial axis, edge-pad by the radius and
    correlate every row with the 1D kernel."""
    import torch
    import torch.nn.functional as F

    from giga_tpu_torch.ops.filters import gaussian_kernel_1d

    k = torch.from_numpy(gaussian_kernel_1d(sigma, truncate)).to(vol.device, vol.dtype)
    r = (k.shape[0] - 1) // 2
    for axis in range(vol.ndim - 3, vol.ndim):
        v = torch.movedim(vol, axis, -1)
        rows = F.pad(v.reshape(-1, 1, v.shape[-1]), (r, r), mode="replicate")
        out = F.conv1d(rows, k.view(1, 1, -1))  # correlation, as jnp.correlate
        vol = torch.movedim(out.reshape(v.shape), -1, axis)
    return vol


def nms_dense(vol, size: int):
    """The max over each voxel's size^3 window ([-size//2, size - size//2 - 1]
    on each axis, -inf past the border): the JAX script's reduce_window."""
    import torch.nn.functional as F

    lo = size // 2
    hi = size - lo - 1
    v = F.pad(vol, (lo, hi) * 3, value=-float("inf"))
    windows = v.unfold(-3, size, 1).unfold(-3, size, 1).unfold(-3, size, 1)
    return windows.amax(dim=(-3, -2, -1))


@contextlib.contextmanager
def swapped(post, blur, nms):
    """The postprocess module with its blur and max filter replaced."""
    saved = (post.gaussian_blur_3d, post.max_filter_3d)
    post.gaussian_blur_3d, post.max_filter_3d = blur, nms
    try:
        yield
    finally:
        post.gaussian_blur_3d, post.max_filter_3d = saved


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--n-hi", type=int, default=17, help="chain length of a timed run")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    import giga_tpu_torch.inference.postprocess as post
    from giga_tpu_torch.core.config import PlannerConfig
    from giga_tpu_torch.core.device import resolve_device
    from giga_tpu_torch.core.precision import full_precision
    from giga_tpu_torch.inference.planner import lattice_positions
    from giga_tpu_torch.ops.filters import gaussian_blur_3d, max_filter_3d
    from giga_tpu_torch.scripts.profile_batched import card_line
    from giga_tpu_torch.scripts.profile_geo import chain_ms
    from giga_tpu_torch.utils.benchmark import _leaves

    device = resolve_device(args.device)
    card = card_line(device)
    B, R = args.batch, 40
    cfg = PlannerConfig(resolution=R)
    voxel = 0.3 / R
    rng = np.random.RandomState(0)

    def vol(*shape, scale=1.0):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32) * scale).to(device)

    qual, tsdf = vol(B, R, R, R), vol(B, R, R, R)
    rot, width = vol(B, R, R, R, 4), vol(B, R, R, R, scale=0.8)
    coords = (torch.arange(R, dtype=torch.float32, device=device) + 0.5) / R
    positions = lattice_positions(coords)
    size = cfg.max_filter_size

    def full(q, blur=gaussian_blur_3d, nms=max_filter_3d):
        with swapped(post, blur, nms):
            m = post.mask_quality(q, tsdf, width, cfg)
            m = post.bound_quality(m, voxel, cfg)
            return post.select_grasps_batched(m, rot, width, positions, cfg)

    rows = [
        ("blur taps (correlate)", lambda q: blur_taps(q, cfg.gaussian_sigma)),
        ("blur matmul", lambda q: gaussian_blur_3d(q, cfg.gaussian_sigma)),
        (f"nms dense {size}^3 window", lambda q: nms_dense(q, size)),
        ("nms separable 3x1D", lambda q: max_filter_3d(q, size)),
        ("dilation (mask)", lambda q: post.masked_binary_dilation(
            tsdf + q * 0 > cfg.out_th, ~((tsdf > 1e-3) & (tsdf < cfg.out_th)), 2)),
    ]
    for bname, blur in (("taps", blur_taps), ("matmul", gaussian_blur_3d)):
        for nname, nms in (("dense", nms_dense), ("sep", max_filter_3d)):
            rows.append((f"postprocess blur={bname} nms={nname}",
                         lambda q, b=blur, n=nms: full(q, b, n)))
    rows += [
        ("chain: blur", lambda q: gaussian_blur_3d(q, cfg.gaussian_sigma)),
        ("chain: +mask", lambda q: post.mask_quality(q, tsdf, width, cfg)),
        ("chain: +bound", lambda q: post.bound_quality(post.mask_quality(q, tsdf, width, cfg),
                                                       voxel, cfg)),
        ("chain: +select (full)", full),
    ]

    with torch.inference_mode(), full_precision():
        out = {name: fn(qual) for name, fn in rows}
        blur_err = float((out["blur taps (correlate)"] - out["blur matmul"]).abs().max())
        nms_equal = bool(torch.equal(out[f"nms dense {size}^3 window"],
                                     out["nms separable 3x1D"]))
        ref = _leaves(out["postprocess blur=matmul nms=sep"])
        nms_post_equal = all(torch.equal(a, b) for a, b in
                             zip(_leaves(out["postprocess blur=matmul nms=dense"]), ref))
        counts = [int(c) for c in out["postprocess blur=matmul nms=sep"].count.cpu()]
    if not blur_err <= TOL_BLUR:
        raise AssertionError(f"blur taps against the matrix form: {blur_err} > {TOL_BLUR}")
    if not (nms_equal and nms_post_equal):
        raise AssertionError(f"the dense and separable max filters differ (volumes equal "
                             f"{nms_equal}, candidates equal {nms_post_equal})")
    print(f"B={B}: blur taps within {blur_err:.3g} of the matrix form (tol {TOL_BLUR}); dense "
          f"and separable NMS equal, and so the postprocesses' candidates ({sum(counts)} "
          f"grasps) | {card}")

    ms = {}
    with full_precision():
        for name, fn in rows:
            ms[name] = chain_ms(fn, qual, args.n_hi - 1, args.repeats)
            print(f"{name:36s} {ms[name]:8.3f} ms | {card}", flush=True)
    print(json.dumps({"script": "profile_postprocess", "card": card, "batch": B, "ms": ms,
                      "blur_err": blur_err, "nms_equal": nms_equal, "grasps": sum(counts)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
