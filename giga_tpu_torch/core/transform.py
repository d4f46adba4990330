"""SE(3) rigid transforms on the host (numpy/scipy).

Covers the reference API surface of src/vgn/utils/transform.py:5-112
(Rotation with an ``identity`` constructor; Transform with composition,
inversion, matrix/list/dict round-trips, and a look-at constructor) —
re-implemented against scipy's Rotation rather than translated.

Quaternions follow scipy's (x, y, z, w) convention throughout.
"""

from __future__ import annotations

import numpy as np
import scipy.spatial.transform


class Rotation(scipy.spatial.transform.Rotation):
    """scipy Rotation with a convenience identity() that returns quat (0,0,0,1)."""

    @classmethod
    def identity(cls):
        return cls.from_quat([0.0, 0.0, 0.0, 1.0])


class Transform:
    """Rigid transform: rotation (scipy Rotation) + translation (3-vector).

    Composition convention: ``(a * b).apply(p) == a.apply(b.apply(p))``.
    """

    __slots__ = ("rotation", "translation")

    def __init__(self, rotation, translation):
        if not isinstance(rotation, scipy.spatial.transform.Rotation):
            raise TypeError(f"rotation must be a scipy Rotation, got {type(rotation)}")
        self.rotation = rotation
        self.translation = np.asarray(translation, dtype=np.float64)
        if self.translation.shape != (3,):
            raise ValueError(f"translation must be a 3-vector, got {self.translation.shape}")

    # --- composition / application -------------------------------------------------

    def __mul__(self, other: "Transform") -> "Transform":
        rotation = self.rotation * other.rotation
        translation = self.rotation.apply(other.translation) + self.translation
        return Transform(rotation, translation)

    def transform_point(self, point):
        return self.rotation.apply(point) + self.translation

    def transform_vector(self, vector):
        return self.rotation.apply(vector)

    def inverse(self) -> "Transform":
        rotation = self.rotation.inv()
        translation = -rotation.apply(self.translation)
        return Transform(rotation, translation)

    # --- conversions ---------------------------------------------------------------

    def as_matrix(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.rotation.as_matrix()
        m[:3, 3] = self.translation
        return m

    def to_dict(self) -> dict:
        return {
            "rotation": self.rotation.as_quat().tolist(),
            "translation": self.translation.tolist(),
        }

    def to_list(self) -> np.ndarray:
        """Concatenated [qx, qy, qz, qw, x, y, z]."""
        return np.r_[self.rotation.as_quat(), self.translation]

    @classmethod
    def from_matrix(cls, m) -> "Transform":
        m = np.asarray(m)
        return cls(Rotation.from_matrix(m[:3, :3]), m[:3, 3])

    @classmethod
    def from_dict(cls, dictionary) -> "Transform":
        return cls(
            Rotation.from_quat(dictionary["rotation"]),
            np.asarray(dictionary["translation"]),
        )

    @classmethod
    def from_list(cls, lst) -> "Transform":
        lst = np.asarray(lst)
        return cls(Rotation.from_quat(lst[:4]), lst[4:7])

    @classmethod
    def identity(cls) -> "Transform":
        return cls(Rotation.identity(), np.zeros(3))

    @classmethod
    def look_at(cls, eye, center, up) -> "Transform":
        """Camera extrinsic looking from ``eye`` toward ``center``.

        Returns the transform from the reference frame to the camera frame
        (i.e. the extrinsic matrix), matching the reference convention
        (transform.py:87-112): columns are (right, -up, forward) and the
        result is inverted so it maps world -> camera.
        """
        eye = np.asarray(eye, dtype=np.float64)
        center = np.asarray(center, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)

        forward = center - eye
        forward = forward / np.linalg.norm(forward)
        right = np.cross(forward, up)
        right = right / np.linalg.norm(right)
        down = np.cross(forward, right)  # = -(right x forward)

        m = np.eye(4)
        m[:3, 0] = right
        m[:3, 1] = down
        m[:3, 2] = forward
        m[:3, 3] = eye
        return cls.from_matrix(m).inverse()

    def __repr__(self):
        q = np.array2string(self.rotation.as_quat(), precision=4, suppress_small=True)
        t = np.array2string(self.translation, precision=4, suppress_small=True)
        return f"Transform(quat={q}, t={t})"
