"""Affordance + grasp visualization (counterpart of giga_tpu/utils/visual.py;
reference: src/vgn/utils/visual.py).

Builds colored meshes entirely on the host with this package's TriMesh:
  * affordance_visual: splat predicted grasp quality onto scene-mesh faces
    (distance-kernel aggregation, Reds colormap).
  * grasp2mesh: a 4-cylinder gripper glyph at a grasp pose.
Colored meshes export to ASCII PLY (face colors); plain geometry to OBJ.
"""

from __future__ import annotations

import numpy as np

from giga_tpu_torch.core.transform import Rotation, Transform
from giga_tpu_torch.geometry.mesh import TriMesh, concatenate


def reds_colormap(v: np.ndarray) -> np.ndarray:
    """Approximation of matplotlib 'Reds': white -> red, (N,) -> (N, 4) uint8."""
    try:
        import matplotlib.pylab as plt

        return (plt.get_cmap("Reds")(v) * 255).astype(np.uint8)
    except ImportError:  # gradient fallback
        v = np.clip(np.asarray(v, float), 0, 1)
        r = 255 * (1.0 - 0.2 * v)
        g = 245 * (1.0 - v) ** 1.5
        b = 240 * (1.0 - v) ** 2
        a = np.full_like(v, 255)
        return np.stack([r, g, b, a], axis=-1).astype(np.uint8)


def quat_z_axis(rot_vol: np.ndarray) -> np.ndarray:
    """Third rotation-matrix column from quaternion volumes (..., 4) xyzw."""
    qx, qy, qz, qw = (rot_vol[..., i] for i in range(4))
    return np.stack(
        [
            2 * qx * qz + 2 * qy * qw,
            2 * qy * qz - 2 * qx * qw,
            1 - 2 * qx * qx - 2 * qy * qy,
        ],
        axis=-1,
    )


def affordance_visual(qual_vol, rot_vol, scene_mesh: TriMesh, size: float = 0.3,
                      resolution: int = 40, th: float = 0.5, temp: float = 150,
                      rad: float = 0.02, finger_depth: float = 0.05,
                      finger_offset: float = 0.5, move_center: bool = True,
                      aggregation: str = "max") -> TriMesh:
    """Color scene-mesh faces by nearby predicted grasp quality."""
    lin = np.linspace(0, size, num=resolution)
    X, Y, Z = np.meshgrid(lin, lin, lin)
    grid = np.stack((Y, X, Z), axis=-1)
    if move_center:
        grid = grid + quat_z_axis(rot_vol) * finger_depth * finger_offset

    mask = qual_vol > th
    if not np.any(mask):
        return scene_mesh
    coords = grid[mask].reshape(-1, 3)
    quals = qual_vol[mask].reshape(-1)

    mesh = scene_mesh.copy()
    centers = mesh.triangles.mean(axis=1)  # (F, 3)
    diff = centers[:, None, :] - coords[None, :, :]
    dist = np.sqrt((diff**2).sum(axis=-1))  # (F, P)

    if aggregation == "mean":
        weight = np.exp(-dist * temp)
        affordance = weight.dot(quals) / weight.sum(axis=-1)
    elif aggregation == "max":
        affordance = ((dist <= rad) * quals[None]).max(axis=1)
    elif aggregation == "softmax":
        masked = np.where(dist <= rad, quals[None], -1e10)
        weight = np.exp(masked * temp)
        affordance = weight.dot(quals) / (weight.sum(axis=-1) + 1e-5)
    else:
        raise ValueError(f"unknown aggregation {aggregation!r}")

    affordance = np.clip(affordance, th, 1.0)
    affordance = (affordance - th) / (1 - th)
    mesh.face_colors = reds_colormap(affordance**4)
    return mesh


def cylinder_mesh(radius: float, height: float, transform=None, sections: int = 16) -> TriMesh:
    """Closed cylinder along z centered at the origin."""
    ang = np.linspace(0, 2 * np.pi, sections, endpoint=False)
    circle = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=-1)
    bot = np.c_[circle, np.full(sections, -height / 2)]
    top = np.c_[circle, np.full(sections, height / 2)]
    verts = np.concatenate([bot, top, [[0, 0, -height / 2]], [[0, 0, height / 2]]])
    cb, ct = 2 * sections, 2 * sections + 1
    faces = []
    for i in range(sections):
        j = (i + 1) % sections
        faces.append([i, j, sections + i])          # side
        faces.append([j, sections + j, sections + i])
        faces.append([cb, j, i])                    # bottom cap
        faces.append([ct, sections + i, sections + j])  # top cap
    m = TriMesh(verts, np.asarray(faces))
    if transform is not None:
        m.apply_transform(np.asarray(transform))
    return m


def grasp2mesh(grasp, score=None, finger_depth: float = 0.05) -> TriMesh:
    """Gripper glyph: two fingers + wrist + palm cylinders at the grasp pose."""
    radius = 0.1 * finger_depth
    w, d = grasp.width, finger_depth
    parts = []
    pose = grasp.pose * Transform(Rotation.identity(), [0.0, -w / 2, d / 2])
    parts.append(cylinder_mesh(radius, d, pose.as_matrix()))
    pose = grasp.pose * Transform(Rotation.identity(), [0.0, w / 2, d / 2])
    parts.append(cylinder_mesh(radius, d, pose.as_matrix()))
    pose = grasp.pose * Transform(Rotation.identity(), [0.0, 0.0, -d / 4])
    parts.append(cylinder_mesh(radius, d / 2, pose.as_matrix()))
    pose = grasp.pose * Transform(
        Rotation.from_rotvec(np.pi / 2 * np.r_[1.0, 0.0, 0.0]), [0.0, 0.0, 0.0]
    )
    parts.append(cylinder_mesh(radius, w, pose.as_matrix()))
    glyph = concatenate(parts)
    glyph.face_colors = np.tile(
        np.array([0, 250, 0, 180], np.uint8), (len(glyph.faces), 1)
    )
    return glyph


def compose_scene(colored_scene_mesh: TriMesh, grasps, scores) -> TriMesh:
    """Scene mesh + one gripper glyph per grasp, concatenated."""
    parts = [colored_scene_mesh]
    colors = [getattr(colored_scene_mesh, "face_colors", None)]
    for g, s in zip(grasps, scores):
        glyph = grasp2mesh(g, s)
        parts.append(glyph)
        colors.append(glyph.face_colors)
    out = concatenate(parts)
    if any(c is not None for c in colors):
        # parts without colors (e.g. the uncolored scene mesh when
        # affordance splatting found no qualifying voxels) get an opaque
        # neutral gray instead of dropping every glyph's colors with them;
        # RGBA like the glyphs' (the JAX package's RGB gray fails to
        # concatenate with them)
        colors = [
            c if c is not None
            else np.full((len(p.faces), 4), (180, 180, 180, 255), np.uint8)
            for c, p in zip(colors, parts)
        ]
        out.face_colors = np.concatenate(colors)
    return out


def export_ply(mesh: TriMesh, path) -> None:
    """ASCII PLY export with per-face colors when present."""
    colors = getattr(mesh, "face_colors", None)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(mesh.vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(mesh.faces)}\n")
        f.write("property list uchar int vertex_indices\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for v in mesh.vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for i, face in enumerate(mesh.faces):
            row = f"3 {face[0]} {face[1]} {face[2]}"
            if colors is not None:
                c = colors[i]
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")
