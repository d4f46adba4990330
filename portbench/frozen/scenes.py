"""Seeded tabletop scenes of boxes and spheres as analytic TSDF grids.

Source: chip_smoke.py (``scene_objects``, ``make_scenes``, ``scene_sdf``) at
commit 8d606019c5dd88c01735d48ffa24d97b29762a1c, the generator of the
port's card checks: the same objects and the same signed distance. Three
changes, for the benchmark:
  * the draws come from ``numpy.random.default_rng`` (which takes seeds past
    32 bits);
  * a scene holds 1 to ``max_objects`` objects instead of always three, and
    every seed gets the same multiset of object counts in an order of its
    own (``object_counts``): a seed changes the scenes, not how much clutter
    a pool holds. A clutter-removal round starts at five objects and clears
    them one by one, so its scans spread evenly over 5..1 objects;
  * the distances are evaluated in float32 with torch, on the card in a
    run, all scenes at once, since a host loop took seconds of set-up.

The signed distance is exact (the union is the minimum over the objects),
truncated at ``trunc_voxels`` voxels and mapped to [0, 1] with 0.5 at the
surface, inside below 0.5: the planner's TSDF convention.
"""

from __future__ import annotations

import numpy as np
import torch

BOX, SPHERE = 0, 1


def object_counts(rng: np.random.Generator, n: int, lo: int = 1, hi: int = 5) -> np.ndarray:
    """(n,) object counts: lo..hi repeated as evenly as n allows, shuffled."""
    return rng.permutation(np.resize(np.arange(lo, hi + 1), n))


def scene_objects(rng: np.random.Generator, n_objects: int, size: float) -> list:
    """One scene's ("box", center, half extents) or ("sphere", center,
    radius) tuples, resting on z = 0.05 * size."""
    objects = []
    for _ in range(n_objects):
        if rng.random() < 0.5:
            half = rng.uniform(0.25, 0.5, 3) * size / 4
            xy = rng.uniform(0.3, 0.7, 2) * size
            objects.append(("box", np.array([xy[0], xy[1], half[2] + 0.05 * size]), half))
        else:
            r = rng.uniform(0.08, 0.18) * size
            xy = rng.uniform(0.3, 0.7, 2) * size
            objects.append(("sphere", np.array([xy[0], xy[1], r + 0.05 * size]), r))
    return objects


def object_table(scenes: list, slots: int) -> np.ndarray:
    """(n, slots, 7) float64: kind (-1 for an empty slot), center, half
    extents (a sphere's radius thrice)."""
    table = np.zeros((len(scenes), slots, 7))
    table[..., 0] = -1
    for s, objects in enumerate(scenes):
        for k, (kind, center, extent) in enumerate(objects):
            table[s, k, 0] = BOX if kind == "box" else SPHERE
            table[s, k, 1:4] = center
            table[s, k, 4:7] = extent
    return table


def scene_sdf(table: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(n, N) signed distances (metres, negative inside) of (N, 3) points to
    each scene's objects (``object_table`` rows), the minimum over them."""
    kind = table[..., 0][..., None]                       # (n, k, 1)
    q = (pts[None, None] - table[..., None, 1:4]).abs()  # (n, k, N, 3)
    box = q - table[..., None, 4:7]
    d_box = (torch.linalg.vector_norm(box.clamp_min(0.0), dim=-1)
             + box.amax(dim=-1).clamp_max(0.0))
    d_sphere = torch.linalg.vector_norm(q, dim=-1) - table[..., 4][..., None]
    d = torch.where(kind == BOX, d_box, d_sphere)
    return torch.where(kind < 0, torch.full_like(d, torch.inf), d).amin(dim=1)


def make_pool(seed: int, n: int, resolution: int, size: float, min_objects: int = 1,
              max_objects: int = 5, trunc_voxels: float = 4.0, device="cpu", chunk: int = 32):
    """(tsdfs (n, R, R, R) float32 numpy, object counts (n,)) of n scenes
    drawn from ``seed``, evaluated on ``device``."""
    rng = np.random.default_rng(seed)
    counts = object_counts(rng, n, min_objects, max_objects)
    scenes = [scene_objects(rng, int(k), size) for k in counts]
    table = torch.from_numpy(object_table(scenes, max_objects).astype(np.float32)).to(device)
    voxel = size / resolution
    lin = (torch.arange(resolution, device=device, dtype=torch.float32) + 0.5) * voxel
    pts = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    out = []
    for s in range(0, n, chunk):
        f = (scene_sdf(table[s:s + chunk], pts) / (trunc_voxels * voxel)).clamp(-1.0, 1.0)
        out.append(((f + 1.0) * 0.5).reshape(-1, resolution, resolution, resolution).cpu())
    return torch.cat(out).numpy(), counts
