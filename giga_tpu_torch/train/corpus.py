"""Device-resident synthetic grasp corpus: load, sample, augment
(counterpart of giga_tpu/train/corpus.py).

The whole corpus (TSDF volumes, occupancy samples, grasp labels) is put on
the card ONCE, and every training step uploads only integer selection
indices (a few hundred bytes). Gather, class-balanced grasp selection and
augmentation run on the device inside the train step
(``make_train_step(..., assemble=assemble_batch)``), so the host never
assembles the 8 MB of TSDF a B=32 batch holds.

Augmentation is the reference's z-rotation scheme (dataset_voxel.py:114-135)
restricted to exact k*90-degree rotations: the voxel lattice of the
synthetic scenes is symmetric about the workspace center, so rot90 on the
(x, y) grid axes is an exact permutation (no resampling blur, unlike the
reference's order-0 affine_transform) and the matching point/quaternion
rotation is exact too. Every function here gives the JAX package's values
bit for bit, on the CPU and on the card. The reference's random height
shift is omitted, as there.

``build_scene`` makes one scene of the synthetic corpus on the host (the
scene generator of ``utils/synthetic.py``, the geometric grasp oracle of
``utils/synthetic_grasps.py``, both over the native containment test),
array for array the JAX package's from the same ``RandomState``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from giga_tpu_torch.core.device import resolve_device


def write_shard(path, scenes: list[dict]):
    np.savez_compressed(path, **{k: np.stack([s[k] for s in scenes]) for k in scenes[0]})


def load_corpus(root) -> dict:
    """Stack all corpus shards (<root>/shard_*.npz) into host arrays."""
    paths = sorted(Path(root).glob("shard_*.npz"))
    if not paths:
        raise FileNotFoundError(f"no corpus shards under {root}")
    shards = [dict(np.load(p)) for p in paths]
    return {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}


# ---------------------------------------------------------------- building

def build_scene(rng, size: float, n_occ: int, n_grasps: int) -> dict:
    """One scene -> flat arrays (all normalized units, see synthetic_grasps)."""
    from giga_tpu_torch.utils.synthetic import make_occ_samples, mesh_to_tsdf, random_scene
    from giga_tpu_torch.utils.synthetic_grasps import (
        grasps_to_batch_arrays,
        sample_labeled_grasps,
    )

    mesh = random_scene(rng, size)
    tsdf = mesh_to_tsdf(mesh, size, 40, rng=rng)
    pts, occ = make_occ_samples(mesh, size, n_occ, rng)
    arrs = grasps_to_batch_arrays(sample_labeled_grasps(mesh, size, n_grasps, rng), size)
    n = len(arrs["label"])
    if n < n_grasps:  # pad by repetition so shards stack rectangular
        rep = rng.randint(0, n, n_grasps - n)
        arrs = {k: np.concatenate([v, v[rep]]) for k, v in arrs.items()}
    return {
        "tsdf": tsdf.astype(np.float32),
        "occ_pts": (pts / size - 0.5).astype(np.float32),
        "occ_lbl": occ.astype(np.float32),
        "grasp_pos": arrs["pos"],
        "grasp_rot": arrs["rotations"],
        "grasp_width": arrs["width"],
        "grasp_label": arrs["label"],
    }


# ------------------------------------------------------- device-side assembly

def _rotk_sincos() -> tuple:
    """[sin, cos] of k * (pi / 4) for k = 0..3: the half-angle formed in
    float32 as the JAX package forms it, its sine and cosine correctly
    rounded to float32 (what XLA gives), as Python floats."""
    half = np.arange(4, dtype=np.float32) * np.float32(np.pi / 4.0)
    return (tuple(float(np.float32(v)) for v in np.sin(half.astype(np.float64))),
            tuple(float(np.float32(v)) for v in np.cos(half.astype(np.float64))))


def _select(k: torch.Tensor, values) -> torch.Tensor:
    """values[k] as float32, formed on k's device from the scalars (no
    host-to-device copy, so no sync)."""
    out = torch.full(k.shape, values[0], dtype=torch.float32, device=k.device)
    for i, v in enumerate(values[1:], 1):
        out = torch.where(k == i, torch.full_like(out, v), out)
    return out


def _rotk_quat(k: torch.Tensor) -> torch.Tensor:
    """Quaternion (xyzw) of Rz(k * 90deg)."""
    sin, cos = _rotk_sincos()
    z = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    return torch.stack([z, z, _select(k, sin), _select(k, cos)], dim=-1)


def _quat_premul(qz: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Hamilton product qz * q in xyzw layout; broadcasts over leading dims.
    qz has zero x/y components (pure z rotation): specialized product."""
    x, y, z, w = q.unbind(-1)
    zz, zw = qz[..., 2], qz[..., 3]
    return torch.stack([zw * x - zz * y, zw * y + zz * x, zw * z + zz * w, zw * w - zz * z],
                       dim=-1)


def _rot_points(p: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) points (centered normalized coords) by Rz(k*90deg)."""
    c, s = _select(k, (1.0, 0.0, -1.0, 0.0)), _select(k, (0.0, 1.0, 0.0, -1.0))
    x, y, z = p.unbind(-1)
    return torch.stack([c * x - s * y, s * x + c * y, z], dim=-1)


def _rot_volume(vol: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact rot90 of (B, X, X, Z) volumes by k[b] quarter turns on (x, y),
    matching ``_rot_points``: out[b, i, j] = vol[b, j, X-1-i] for k = 1
    (np.rot90(axes=(0, 1)), jnp.rot90 as the JAX package applies it per
    sample), and its powers. One gather of permuted indices, no branch on
    the host."""
    B, X = vol.shape[0], vol.shape[1]
    i = torch.arange(X, device=vol.device)[:, None].expand(X, X)
    j = torch.arange(X, device=vol.device)[None, :].expand(X, X)
    r = X - 1
    src_i = torch.stack([i, j, r - i, r - j])[k.long()]  # (B, X, X)
    src_j = torch.stack([j, r - i, r - j, i])[k.long()]
    b = torch.arange(B, device=vol.device)[:, None, None]
    return vol[b, src_i, src_j]


def assemble_batch(corpus: dict, sel: dict) -> dict:
    """Gather + augment a train batch on the device from the resident corpus.

    sel: scene (B,) int32, grasp (B,) int32, occ (B, K) int32,
         rotk (B,) int32 in [0, 4).
    """
    scene, gi = sel["scene"].long(), sel["grasp"].long()
    occ_sel, rotk = sel["occ"].long(), sel["rotk"].long()
    tsdf = _rot_volume(corpus["tsdf"][scene], rotk)
    occ_pts = _rot_points(
        torch.take_along_dim(corpus["occ_pts"][scene], occ_sel[..., None], dim=1),
        rotk[:, None])
    occ_lbl = torch.take_along_dim(corpus["occ_lbl"][scene], occ_sel, dim=1)
    pos = _rot_points(corpus["grasp_pos"][scene, gi], rotk)
    rot = _quat_premul(_rotk_quat(rotk)[:, None, :], corpus["grasp_rot"][scene, gi])
    return {
        "tsdf": tsdf,
        "pos": pos,
        "rotations": rot,
        "width": corpus["grasp_width"][scene, gi],
        "label": corpus["grasp_label"][scene, gi],
        "pos_occ": occ_pts,
        "occ": occ_lbl,
    }


class CorpusSampler:
    """Host-side index sampler: class-balanced grasp choice per scene.

    Mirrors the reference's clean_balance_data step (positives ~= negatives)
    without materializing a rebalanced dataset: per draw, flip a fair coin
    for the target label and sample uniformly from that scene's matching
    grasp pool (falling back to any grasp when a scene lacks the class).
    Draws from its RandomState in the JAX package's order, so one seed gives
    the same selections in both packages.
    """

    def __init__(self, corpus: dict, train_scenes, batch: int, occ_sub: int,
                 seed: int = 0, augment: bool = True):
        self.rng = np.random.RandomState(seed)
        self.train_scenes = np.asarray(train_scenes)
        self.batch, self.occ_sub, self.augment = batch, occ_sub, augment
        self.n_occ = corpus["occ_pts"].shape[1]
        lbl = np.asarray(corpus["grasp_label"])
        self.pools = []
        for s in range(lbl.shape[0]):
            pos = np.nonzero(lbl[s] == 1.0)[0]
            neg = np.nonzero(lbl[s] == 0.0)[0]
            any_ = np.arange(lbl.shape[1])
            self.pools.append((pos if len(pos) else any_, neg if len(neg) else any_))

    def __call__(self) -> dict:
        r = self.rng
        scene = self.train_scenes[r.randint(0, len(self.train_scenes), self.batch)]
        grasp = np.empty(self.batch, np.int32)
        for i, s in enumerate(scene):
            pool = self.pools[s][0 if r.rand() < 0.5 else 1]
            grasp[i] = pool[r.randint(len(pool))]
        return {
            "scene": scene.astype(np.int32),
            "grasp": grasp,
            "occ": r.randint(0, self.n_occ, (self.batch, self.occ_sub)).astype(np.int32),
            "rotk": (r.randint(0, 4, self.batch) if self.augment
                     else np.zeros(self.batch)).astype(np.int32),
        }


def device_corpus(corpus: dict, drop: tuple = (), device=None) -> dict:
    """Put the training arrays on ``device`` (the card unless the caller
    asks for the CPU) once; see the module docstring."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in corpus.items()
            if k not in drop}
