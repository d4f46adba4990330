"""Geometry-evaluation datasets (counterpart of giga_tpu/geometry/datasets.py;
reference src/vgn/dataset_voxel_occ.py).

One item a scene: its 40^3 TSDF, freshly sampled labelled occupancy points
and the ground-truth mesh assembled from the recorded mesh_pose_list. The
ROI variant keeps the scenes with a positive grasp and adds occupancy
points inside the gripper volume of each (dataset_voxel_occ.py:90-134).
The grasp table is read by the port's ``core/io.py``.
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path

import numpy as np

from giga_tpu_torch.core import io
from giga_tpu_torch.core.transform import Rotation
from giga_tpu_torch.geometry.native import check_mesh_contains
from giga_tpu_torch.utils.implicit import get_scene_from_mesh_pose_list, sample_iou_points


class GeometryEvalDataset:
    """Items (tsdf, occupancy points in [-0.5, 0.5], occupancy, gt mesh)."""

    def __init__(self, root, raw_root, num_point_occ: int = 100000, rng=None):
        self.root = Path(root)
        self.raw_root = Path(raw_root)
        self.num_point_occ = num_point_occ
        self.rng = rng or np.random
        self.df = io.read_df(self.raw_root)
        self.size, _, _, _ = io.read_setup(self.raw_root)
        self.scene_list = list(OrderedDict.fromkeys(self.df["scene_id"]))

    def __len__(self):
        return len(self.scene_list)

    def _load_scene(self, scene_id):
        path = self.raw_root / "mesh_pose_list" / (scene_id + ".npz")
        mesh_pose_list = np.load(path, allow_pickle=True)["pc"]
        return get_scene_from_mesh_pose_list(mesh_pose_list, return_list=True)

    def __getitem__(self, i: int):
        scene_id = self.scene_list[i]
        tsdf = io.read_voxel_grid(self.root, scene_id)[0]
        scene, mesh_list = self._load_scene(scene_id)
        points, occ = sample_iou_points(mesh_list, scene.bounds, self.num_point_occ,
                                        rng=self.rng)
        return tsdf, points / self.size - 0.5, occ, scene


class GeometryEvalDatasetROI(GeometryEvalDataset):
    """Adds occupancy points in the gripper volume of each positive grasp."""

    def __init__(self, root, raw_root, num_point_occ: int = 100000,
                 roi_scale: float = 0.3, uniform: bool = True, rng=None):
        super().__init__(root, raw_root, num_point_occ, rng)
        self.roi_scale = roi_scale
        self.uniform = uniform
        _, _, _, self.finger_depth = io.read_setup(self.raw_root)
        scene_grasps = OrderedDict()
        for idx in range(len(self.df)):
            sid = self.df["scene_id"][idx]
            scene_grasps.setdefault(sid, [])
            if self.df["label"][idx]:
                scene_grasps[sid].append(idx)
        self.scene_dict = {k: v for k, v in scene_grasps.items() if v}
        self.scene_list = list(self.scene_dict.keys())

    def sample_roi_points(self, scene_id):
        """Points in the closing region of each positive grasp, their count
        in proportion to the grasp's width."""
        pos_list, width_list, ori_list = [], [], []
        for gi in self.scene_dict[scene_id]:
            # the quaternion in single precision, as the reference reads it
            ori = Rotation.from_quat(self.df.row(gi, ("qx", "qy", "qz", "qw")).astype(np.single))
            pos = self.df.row(gi, ("x", "y", "z"))
            pos_list.append(pos + ori.apply(np.r_[0.0, 0.0, 1.0]) * self.finger_depth)
            width_list.append(float(self.df["width"][gi]))
            ori_list.append(ori)
        widths = np.asarray(width_list, float)
        counts = np.round(self.num_point_occ * widths / widths.sum()).astype(int)
        chunks = []
        for num, pos, width, ori in zip(counts, pos_list, width_list, ori_list):
            pts = self.rng.rand(num, 3)
            pts[:, 1] = (pts[:, 1] - 0.5) * width
            pts[:, [0, 2]] = (pts[:, [0, 2]] - 1.0) * self.finger_depth * self.roi_scale
            chunks.append(ori.as_matrix().dot(pts.T).T + pos)
        return np.concatenate(chunks, axis=0)

    def __getitem__(self, i: int):
        scene_id = self.scene_list[i]
        tsdf = io.read_voxel_grid(self.root, scene_id)[0]
        scene, mesh_list = self._load_scene(scene_id)
        roi_points = self.sample_roi_points(scene_id)
        occ_roi = np.zeros(len(roi_points), bool)
        for mesh in mesh_list:
            occ_roi |= check_mesh_contains(mesh, roi_points)
        points, occ = sample_iou_points(mesh_list, scene.bounds, self.num_point_occ,
                                        uniform=self.uniform, size=self.size, padding=0,
                                        rng=self.rng)
        return (tsdf, points / self.size - 0.5, occ, roi_points / self.size - 0.5, occ_roi,
                scene)
