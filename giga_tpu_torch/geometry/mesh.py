"""Minimal host-side triangle-mesh type (counterpart of
giga_tpu/geometry/mesh.py, which replaces the reference's trimesh use).

Supports what the planner's visualization and the scene tools need: loading
OBJ/OFF/STL files, uniform scaling, rigid/affine transforms, concatenation,
bounds, surface sampling, and OBJ export. Pure numpy.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


class TriMesh:
    """Triangle mesh: vertices (V, 3) float64, faces (F, 3) int32."""

    def __init__(self, vertices, faces):
        self.vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
        self.faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)

    # --- transforms ----------------------------------------------------------------

    def copy(self) -> "TriMesh":
        return TriMesh(self.vertices.copy(), self.faces.copy())

    def apply_scale(self, scale) -> "TriMesh":
        self.vertices = self.vertices * np.asarray(scale)
        return self

    def apply_transform(self, matrix4) -> "TriMesh":
        m = np.asarray(matrix4)
        self.vertices = self.vertices @ m[:3, :3].T + m[:3, 3]
        return self

    def apply_translation(self, t) -> "TriMesh":
        self.vertices = self.vertices + np.asarray(t)
        return self

    # --- properties ----------------------------------------------------------------

    @property
    def bounds(self) -> np.ndarray:
        """(2, 3): [min; max] vertex coordinates."""
        return np.stack([self.vertices.min(axis=0), self.vertices.max(axis=0)])

    @property
    def triangles(self) -> np.ndarray:
        """(F, 3, 3) triangle vertex coordinates."""
        return self.vertices[self.faces]

    @property
    def face_normals(self) -> np.ndarray:
        t = self.triangles
        n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        return n / np.maximum(norm, 1e-12)

    @property
    def area_faces(self) -> np.ndarray:
        t = self.triangles
        return 0.5 * np.linalg.norm(np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=1)

    @property
    def area(self) -> float:
        return float(self.area_faces.sum())

    def is_empty(self) -> bool:
        return len(self.faces) == 0

    # --- sampling ------------------------------------------------------------------

    def sample_surface(self, n: int, rng=None, return_normals: bool = False):
        """Uniform area-weighted surface samples -> (points, face_idx[, normals])."""
        rng = rng or np.random
        areas = self.area_faces
        probs = areas / max(areas.sum(), 1e-12)
        fi = rng.choice(len(self.faces), size=n, p=probs)
        t = self.triangles[fi]
        # uniform barycentric sampling
        r1 = np.sqrt(rng.uniform(size=(n, 1)))
        r2 = rng.uniform(size=(n, 1))
        pts = (1 - r1) * t[:, 0] + r1 * (1 - r2) * t[:, 1] + r1 * r2 * t[:, 2]
        if return_normals:
            return pts, fi, self.face_normals[fi]
        return pts, fi

    # --- io ------------------------------------------------------------------------

    def export(self, path) -> None:
        path = Path(path)
        if path.suffix.lower() not in (".obj",):
            raise ValueError(f"export supports .obj, got {path.suffix}")
        with path.open("w") as f:
            for v in self.vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for face in self.faces:
                f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def concatenate(meshes) -> TriMesh:
    meshes = [m for m in meshes if m is not None and len(m.faces)]
    if not meshes:
        return TriMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    verts, faces, off = [], [], 0
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + off)
        off += len(m.vertices)
    return TriMesh(np.concatenate(verts), np.concatenate(faces))


def load_mesh(path) -> TriMesh:
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".obj":
        return _load_obj(path)
    if suffix == ".off":
        return _load_off(path)
    if suffix == ".stl":
        return _load_stl(path)
    raise ValueError(f"unsupported mesh format {suffix!r} ({path})")


def _load_obj(path) -> TriMesh:
    verts, faces = [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate polygons
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriMesh(np.asarray(verts), np.asarray(faces))


def _load_off(path) -> TriMesh:
    with open(path, "r") as f:
        tokens = f.read().split()
    i = 0
    if tokens[i] == "OFF":
        i += 1
    nv, nf = int(tokens[i]), int(tokens[i + 1])
    i += 3
    verts = np.asarray(tokens[i : i + 3 * nv], dtype=np.float64).reshape(nv, 3)
    i += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(tokens[i])
        poly = [int(t) for t in tokens[i + 1 : i + 1 + k]]
        for j in range(1, k - 1):
            faces.append([poly[0], poly[j], poly[j + 1]])
        i += 1 + k
    return TriMesh(verts, np.asarray(faces))


def _load_stl(path) -> TriMesh:
    with open(path, "rb") as f:
        header = f.read(80)
        if header[:5].strip() == b"solid":
            # could be ASCII; try parsing as text
            try:
                return _load_stl_ascii(path)
            except Exception:
                f.seek(80)
        (n,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(n * 50), dtype=np.uint8).reshape(n, 50)
        tri = data[:, 12:48].copy().view(np.float32).reshape(n, 3, 3).astype(np.float64)
    verts = tri.reshape(-1, 3)
    faces = np.arange(len(verts)).reshape(-1, 3)
    return _dedupe(verts, faces)


def _load_stl_ascii(path) -> TriMesh:
    verts = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "vertex":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    if not verts:
        # a binary STL whose 'solid...' header decoded as text: no 'vertex'
        # tokens exist; raising sends _load_stl to the binary parser instead
        # of silently returning an empty mesh
        raise ValueError("no ASCII STL vertex records")
    verts = np.asarray(verts)
    faces = np.arange(len(verts)).reshape(-1, 3)
    return _dedupe(verts, faces)


def _dedupe(verts, faces) -> TriMesh:
    uniq, inv = np.unique(verts.round(decimals=9), axis=0, return_inverse=True)
    return TriMesh(uniq, inv[faces])


def box_mesh(extents, center=(0, 0, 0)) -> TriMesh:
    """Axis-aligned box (12 triangles) for tests and gripper glyphs."""
    ex, ey, ez = np.asarray(extents) / 2.0
    cx, cy, cz = center
    v = np.array(
        [
            [cx - ex, cy - ey, cz - ez], [cx + ex, cy - ey, cz - ez],
            [cx + ex, cy + ey, cz - ez], [cx - ex, cy + ey, cz - ez],
            [cx - ex, cy - ey, cz + ez], [cx + ex, cy - ey, cz + ez],
            [cx + ex, cy + ey, cz + ez], [cx - ex, cy + ey, cz + ez],
        ]
    )
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # bottom (-z)
            [4, 5, 6], [4, 6, 7],  # top (+z)
            [0, 1, 5], [0, 5, 4],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [1, 2, 6], [1, 6, 5],  # +x
            [3, 0, 4], [3, 4, 7],  # -x
        ]
    )
    return TriMesh(v, f)
