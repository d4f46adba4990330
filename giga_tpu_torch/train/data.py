"""Host-side training data pipeline (counterpart of giga_tpu/train/data.py;
reference: src/vgn/dataset_voxel.py).

Reads the reference's on-disk dataset format:
    processed root: scenes/<id>.npz   {"grid": (1, 40, 40, 40)}
    raw root:       grasps.csv        metric grasp poses + labels
                    occ/<id>/*.npz    occupancy point shards (points, occ)
                    setup.json        workspace size etc.

Produces dict batches of fixed-shape numpy arrays:
    tsdf (B, 40, 40, 40), pos (B, 3) in [-0.5, 0.5], label (B,),
    rotations (B, 2, 4) [the two gripper-symmetric quats], width (B,),
    pos_occ (B, N, 3), occ (B, N).
The train step uploads a batch to the card in one pinned copy
(``core.device.to_device``).

Augmentation (z-rotation by k*90 deg + height shift) follows
dataset_voxel.py:114-135, applied in voxel units on grid + pose jointly.
Every draw comes from the dataset's RandomState in the JAX package's order,
so one seed gives the same batches in both packages.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy import ndimage

from giga_tpu_torch.core import io
from giga_tpu_torch.core.transform import Rotation, Transform


def _symmetric_quats(ori) -> np.ndarray:
    """The two target quats q and q * Rz(pi) (dataset_voxel.py:83-87)."""
    rotations = np.empty((2, 4), np.float32)
    R = Rotation.from_rotvec(np.pi * np.r_[0.0, 0.0, 1.0])
    rotations[0] = ori.as_quat()
    rotations[1] = (ori * R).as_quat()
    return rotations


class GraspDataset:
    """DatasetVoxelOccFile equivalent; samples one grasp (+occ points) per row."""

    def __init__(self, root, raw_root, num_point_occ: int = 2048, augment: bool = False,
                 load_occ: bool = True, seed: int = 0):
        self.root = Path(root)
        self.raw_root = Path(raw_root)
        self.num_point_occ = num_point_occ
        self.augment = augment
        self.load_occ = load_occ
        self.df = io.read_df(self.raw_root)
        self.size, _, _, _ = io.read_setup(self.raw_root)
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.df)

    def __getitem__(self, i: int) -> dict:
        scene_id = self.df["scene_id"][i]
        ori = Rotation.from_quat(self.df.row(i, ("qx", "qy", "qz", "qw")).astype(np.single))
        pos = self.df.row(i, ("x", "y", "z")).astype(np.single)
        width = np.float32(self.df["width"][i])
        label = np.float32(self.df["label"][i])
        voxel_grid = io.read_voxel_grid(self.root, scene_id)[0]

        if self.augment:
            voxel_grid, ori, pos = apply_aug_transform(
                voxel_grid, ori, pos * 40.0 / self.size, self.rng
            )
            pos = pos * self.size / 40.0

        pos = pos / self.size - 0.5
        width = width / self.size

        sample = {
            "tsdf": voxel_grid.astype(np.float32),
            "pos": pos.astype(np.float32),
            "label": label,
            "rotations": _symmetric_quats(ori),
            "width": np.float32(width),
        }
        if self.load_occ:
            occ_points, occ = self.read_occ(scene_id, self.num_point_occ)
            sample["pos_occ"] = (occ_points / self.size - 0.5).astype(np.float32)
            sample["occ"] = occ.astype(np.float32)
        return sample

    def read_occ(self, scene_id: str, num_point: int):
        occ_paths = sorted((self.raw_root / "occ" / scene_id).glob("*.npz"))
        path = occ_paths[self.rng.randint(len(occ_paths))]
        occ_data = np.load(path)
        points = occ_data["points"].astype(np.float32)
        occ = occ_data["occ"]
        idxs = self.rng.choice(
            points.shape[0], size=num_point, replace=num_point > points.shape[0]
        )
        return points[idxs], occ[idxs]


def apply_aug_transform(voxel_grid, orientation, position_vox, rng):
    """z-rotation by k*90deg + height shift, in voxel units (dataset_voxel.py:114-135)."""
    angle = np.pi / 2.0 * rng.choice(4)
    R_augment = Rotation.from_rotvec(np.r_[0.0, 0.0, angle])
    z_offset = rng.uniform(6, 34) - position_vox[2]
    t_augment = np.r_[0.0, 0.0, z_offset]
    T_augment = Transform(R_augment, t_augment)
    T_center = Transform(Rotation.identity(), np.r_[20.0, 20.0, 20.0])
    T = T_center * T_augment * T_center.inverse()

    T_inv = T.inverse()
    matrix, offset = T_inv.rotation.as_matrix(), T_inv.translation
    voxel_grid = ndimage.affine_transform(voxel_grid, matrix, offset, order=0)

    position = T.transform_point(position_vox)
    orientation = T.rotation * orientation
    return voxel_grid, orientation, position


class VGNDataset:
    """Index-based dataset for the dense VGN baseline (reference:
    src/vgn/dataset.py:10-42). Reads the PROCESSED root, whose grasp table is
    in voxel units (i, j, k, width in voxels)."""

    def __init__(self, root, augment: bool = False, seed: int = 0):
        self.root = Path(root)
        self.augment = augment
        self.df = io.read_df(self.root)
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.df)

    def __getitem__(self, i: int) -> dict:
        scene_id = self.df["scene_id"][i]
        ori = Rotation.from_quat(self.df.row(i, ("qx", "qy", "qz", "qw")).astype(np.single))
        pos = self.df.row(i, ("i", "j", "k")).astype(np.single)
        width = np.float32(self.df["width"][i])
        label = np.float32(self.df["label"][i])
        voxel_grid = io.read_voxel_grid(self.root, scene_id)[0]

        if self.augment:
            voxel_grid, ori, pos = apply_aug_transform(voxel_grid, ori, pos, self.rng)

        index = np.clip(np.round(pos), 0, voxel_grid.shape[0] - 1).astype(np.int32)
        return {
            "tsdf": voxel_grid.astype(np.float32),
            "index": index,
            "label": label,
            "rotations": _symmetric_quats(ori),
            "width": np.float32(width),
        }


def _collate(dataset, rows) -> dict:
    samples = [dataset[int(i)] for i in rows]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class Loader:
    """Minimal shuffling batcher yielding stacked dict batches (drop_last)."""

    def __init__(self, dataset, indices, batch_size: int, shuffle: bool, seed: int = 0):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.indices) // self.batch_size

    def _order(self) -> np.ndarray:
        order = self.indices.copy()
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def __iter__(self):
        order, bs = self._order(), self.batch_size
        for b in range(len(self)):
            yield _collate(self.dataset, order[b * bs:(b + 1) * bs])


class PrefetchLoader:
    """Wraps a Loader with a background worker pool assembling batches ahead
    (role of the reference's DataLoader(num_workers=16, pin_memory=True),
    train_giga.py:22). npz decompression releases the GIL, so threads give
    real overlap with the device step; batch order is preserved.
    """

    def __init__(self, loader: Loader, num_workers: int = 4, prefetch: int = 4):
        self.loader = loader
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import concurrent.futures as cf
        from collections import deque

        order, bs = self.loader._order(), self.loader.batch_size
        n_batches = len(self)
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = deque()
            submitted = 0
            while submitted < min(self.prefetch, n_batches):
                rows = order[submitted * bs:(submitted + 1) * bs]
                pending.append(pool.submit(_collate, self.loader.dataset, rows))
                submitted += 1
            while pending:
                batch = pending.popleft().result()
                if submitted < n_batches:
                    rows = order[submitted * bs:(submitted + 1) * bs]
                    pending.append(pool.submit(_collate, self.loader.dataset, rows))
                    submitted += 1
                yield batch


def _split_loaders(dataset, batch_size, val_split, seed):
    n = len(dataset)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    val_size = int(val_split * n)
    val_idx, train_idx = perm[:val_size], perm[val_size:]
    train_loader = Loader(dataset, train_idx, batch_size, shuffle=True, seed=seed)
    val_loader = Loader(dataset, val_idx, batch_size, shuffle=False, seed=seed)
    return train_loader, val_loader


def create_train_val_loaders(root, raw_root, batch_size: int, val_split: float,
                             augment: bool, num_point_occ: int = 2048,
                             load_occ: bool = True, seed: int = 0):
    """Random 0.9/0.1-style split (train_giga.py:123-138)."""
    dataset = GraspDataset(root, raw_root, num_point_occ, augment, load_occ, seed)
    return _split_loaders(dataset, batch_size, val_split, seed)


def create_vgn_train_val_loaders(root, batch_size: int, val_split: float,
                                 augment: bool, seed: int = 0):
    """Loaders for the dense VGN baseline (index-based processed dataset)."""
    dataset = VGNDataset(root, augment=augment, seed=seed)
    return _split_loaders(dataset, batch_size, val_split, seed)
