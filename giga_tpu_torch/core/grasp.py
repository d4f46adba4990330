"""Grasp types (reference parity: src/vgn/grasp.py:4-31).

A grasp is the pose of a two-finger hand (TCP frame) plus an opening width.
Voxel <-> metric conversion scales both translation and width by voxel size.
"""

from __future__ import annotations

import enum

from giga_tpu_torch.core.transform import Transform


class Label(enum.IntEnum):
    FAILURE = 0  # grasp execution failed due to collision or slippage
    SUCCESS = 1  # object was successfully removed


class Grasp:
    """Grasp parameterized as the pose of a 2-finger robot hand."""

    __slots__ = ("pose", "width")

    def __init__(self, pose: Transform, width: float):
        self.pose = pose
        self.width = width

    def __repr__(self):
        return f"Grasp(pose={self.pose!r}, width={self.width:.4f})"


def to_voxel_coordinates(grasp: Grasp, voxel_size: float) -> Grasp:
    pose = Transform(grasp.pose.rotation, grasp.pose.translation / voxel_size)
    return Grasp(pose, grasp.width / voxel_size)


def from_voxel_coordinates(grasp: Grasp, voxel_size: float) -> Grasp:
    pose = Transform(grasp.pose.rotation, grasp.pose.translation * voxel_size)
    return Grasp(pose, grasp.width * voxel_size)
