"""Camera model and TSDF perception (counterpart of
giga_tpu/core/perception.py; reference: src/vgn/perception.py:10-137).

``TSDFVolume`` keeps its running (tsdf, weight) state as float32 tensors on
its device and fuses each depth image there (``ops.tsdf.integrate_tsdf``).
Values live in [0, 1]: 0.5 is the surface, values > 0.5 are observed free
space, values < 0.5 lie behind the surface, and exactly 0 means never
observed.
"""

from __future__ import annotations

from math import cos, sin

import numpy as np
import torch

from giga_tpu_torch.core.device import resolve_device
from giga_tpu_torch.core.transform import Transform
from giga_tpu_torch.ops.tsdf import extract_surface_points, integrate_tsdf


class CameraIntrinsic:
    """Pinhole camera intrinsics."""

    def __init__(self, width, height, fx, fy, cx, cy):
        self.width = width
        self.height = height
        self.K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])

    @property
    def fx(self):
        return self.K[0, 0]

    @property
    def fy(self):
        return self.K[1, 1]

    @property
    def cx(self):
        return self.K[0, 2]

    @property
    def cy(self):
        return self.K[1, 2]

    def to_dict(self):
        return {
            "width": self.width,
            "height": self.height,
            "K": self.K.flatten().tolist(),
        }

    @classmethod
    def from_dict(cls, data):
        return cls(
            width=data["width"],
            height=data["height"],
            fx=data["K"][0],
            fy=data["K"][4],
            cx=data["K"][2],
            cy=data["K"][5],
        )


class TSDFVolume:
    """Uniform TSDF over a cubic workspace [0, size]^3, fused on ``device``
    (``None``: the card, raising without one; ``"cpu"`` to fuse on the CPU).

    Args:
        size: metric edge length of the cube.
        resolution: voxels per edge.
    """

    def __init__(self, size: float, resolution: int, device=None):
        self.size = float(size)
        self.resolution = int(resolution)
        self.voxel_size = self.size / self.resolution
        self.sdf_trunc = 4 * self.voxel_size
        self.device = resolve_device(device)
        self.tsdf = torch.zeros((self.resolution,) * 3, dtype=torch.float32, device=self.device)
        self.weight = torch.zeros_like(self.tsdf)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=self.device)

    def integrate(self, depth_img, intrinsic: CameraIntrinsic, extrinsic: Transform) -> None:
        """Fuse one depth image. ``extrinsic`` maps task (TSDF) frame -> camera frame."""
        self.tsdf, self.weight = integrate_tsdf(
            self.tsdf, self.weight, self._tensor(depth_img), self._tensor(intrinsic.K),
            self._tensor(extrinsic.as_matrix()), size=self.size, sdf_trunc=self.sdf_trunc)

    def get_grid(self) -> np.ndarray:
        """Return the (1, R, R, R) float32 grid the planner consumes."""
        return self.tsdf.cpu().numpy()[None]

    def get_cloud(self, with_normals: bool = False):
        """Extract an (N, 3) surface point cloud at the 0.5 iso-level
        (optionally with outward unit normals from the TSDF gradient)."""
        return extract_surface_points(self.tsdf.cpu().numpy(), self.weight.cpu().numpy(),
                                      self.voxel_size, with_normals=with_normals)


def create_tsdf(size, resolution, depth_imgs, intrinsic, extrinsics, device=None) -> TSDFVolume:
    """Fuse a stack of depth images (reference: perception.py:121-126)."""
    tsdf = TSDFVolume(size, resolution, device=device)
    for i in range(depth_imgs.shape[0]):
        extrinsic = Transform.from_list(extrinsics[i])
        tsdf.integrate(depth_imgs[i], intrinsic, extrinsic)
    return tsdf


def camera_on_sphere(origin: Transform, radius, theta, phi) -> Transform:
    """Extrinsic for a camera on a sphere around ``origin`` looking at its center."""
    eye = np.r_[
        radius * sin(theta) * cos(phi),
        radius * sin(theta) * sin(phi),
        radius * cos(theta),
    ]
    target = np.array([0.0, 0.0, 0.0])
    up = np.array([0.0, 0.0, 1.0])  # breaks when looking straight down
    return Transform.look_at(eye, target, up) * origin.inverse()
