"""Offscreen image rendering of scenes / affordance visuals (counterpart of
giga_tpu/utils/render.py).

The reference renders affordance imagery with pyrender offscreen GL
(reference src/vgn/utils/visual.py:21-99: compose colored scene + gripper
glyphs, render from an orbiting camera) and rollout videos with NViSII.
This module produces the same imagery with this package's z-buffer
rasterizer (geometry/csrc/raster.cpp through ``geometry.native.raster_mesh``,
host C++ built at first use) — no GL stack or GPU required:

    img = render_affordance_image(qual_vol, rot_vol, scene_mesh, grasps, scores)
    save_image(img, "affordance.png")
"""

from __future__ import annotations

import numpy as np

from giga_tpu_torch.core.perception import CameraIntrinsic, camera_on_sphere
from giga_tpu_torch.core.transform import Rotation, Transform
from giga_tpu_torch.geometry.mesh import TriMesh
from giga_tpu_torch.geometry.native import raster_mesh
from giga_tpu_torch.utils.visual import affordance_visual, compose_scene

DEFAULT_INTRINSIC = CameraIntrinsic(640, 480, 540.0, 540.0, 320.0, 240.0)


def default_camera(size: float = 0.3, radius_scale: float = 2.2,
                   theta: float = np.pi / 4.0, phi: float = -np.pi / 2.0) -> Transform:
    """World->camera extrinsic orbiting the workspace center, matching the
    viewpoint convention of the sim's round-capture cameras
    (reference simulation.py acquire_tsdf: camera_on_sphere over the
    workspace center)."""
    center = Transform(Rotation.identity(), np.r_[size / 2, size / 2, size / 4])
    return camera_on_sphere(center, radius_scale * size, theta, phi)


def render_mesh_image(mesh: TriMesh, extrinsic: Transform | None = None,
                      intrinsic: CameraIntrinsic = DEFAULT_INTRINSIC,
                      size: float = 0.3, background=(255, 255, 255),
                      ambient: float = 0.35) -> np.ndarray:
    """Rasterize a (possibly face-colored) world-frame mesh -> (H, W, 3) uint8."""
    if extrinsic is None:
        extrinsic = default_camera(size)
    verts = np.asarray(mesh.vertices, np.float64)
    if len(verts):
        verts_cam = verts @ extrinsic.rotation.as_matrix().T + extrinsic.translation
    else:
        verts_cam = verts.reshape(0, 3)
    colors = getattr(mesh, "face_colors", None)
    if colors is None:
        colors = np.tile(np.array([180, 180, 190, 255], np.uint8),
                         (len(mesh.faces), 1))
    colors = np.asarray(colors)
    if colors.shape[-1] == 3:
        colors = np.concatenate(
            [colors, np.full((len(colors), 1), 255, colors.dtype)], axis=-1
        )
    return raster_mesh(
        verts_cam, mesh.faces, colors,
        intrinsic.fx, intrinsic.fy, intrinsic.cx, intrinsic.cy,
        intrinsic.width, intrinsic.height, background, ambient=ambient,
    )


def render_affordance_image(qual_vol, rot_vol, scene_mesh: TriMesh,
                            grasps=(), scores=(), size: float = 0.3,
                            extrinsic: Transform | None = None,
                            intrinsic: CameraIntrinsic = DEFAULT_INTRINSIC,
                            **aff_kwargs) -> np.ndarray:
    """Affordance-colored scene + gripper glyphs -> rendered RGB image
    (image-producing counterpart of utils/visual.py's colored-PLY path)."""
    colored = affordance_visual(qual_vol, rot_vol, scene_mesh, size=size,
                                **aff_kwargs)
    composed = compose_scene(colored, list(grasps), list(scores))
    return render_mesh_image(composed, extrinsic, intrinsic, size=size)


class SoftwareRenderer:
    """Drop-in stand-in for NViSIIRenderer (utils/nvisii_render.py) that
    rasterizes mesh-pose snapshot pickles with the native z-buffer kernel —
    rollout videos render anywhere, no GPU ray tracer required.

    Snapshot format (utils/saver.py): {name: (mesh_path, scale,
    Transform)}.
    """

    def __init__(self, width: int = 640, height: int = 480,
                 camera_position=(0.6, 0.0, 0.6), look_at=(0.15, 0.15, 0.05),
                 fov: float = 0.85, background=(255, 255, 255)):
        # vertical field of view in radians, like nvisii's create_from_fov
        fy = (height / 2.0) / np.tan(fov / 2.0)
        self.intrinsic = CameraIntrinsic(width, height, fy, fy,
                                         width / 2.0, height / 2.0)
        self.extrinsic = Transform.look_at(
            np.asarray(camera_position, float), np.asarray(look_at, float),
            np.array([0.0, 0.0, 1.0]),
        )
        self.background = background
        self._mesh_cache: dict = {}
        self._scene: dict = {}

    def update(self, mesh_pose_dict: dict) -> None:
        """Sync to a {name: (mesh_path, scale, Transform)} snapshot."""
        self._scene = dict(mesh_pose_dict)

    def _load(self, mesh_path, scale):
        from giga_tpu_torch.geometry.mesh import load_mesh

        key = (str(mesh_path), tuple(np.atleast_1d(scale).tolist()))
        if key not in self._mesh_cache:
            mesh = load_mesh(mesh_path)
            s = np.atleast_1d(np.asarray(scale, float))
            if s.size == 1:
                s = np.repeat(s, 3)
            mesh = TriMesh(mesh.vertices * s[:3], mesh.faces)
            self._mesh_cache[key] = mesh
        return self._mesh_cache[key]

    def render(self, out_path=None) -> np.ndarray:
        from giga_tpu_torch.geometry.mesh import concatenate

        parts, colors = [], []
        palette = np.array(
            [[204, 112, 96], [110, 155, 205], [125, 185, 130],
             [200, 170, 90], [160, 125, 190], [120, 180, 180]], np.uint8
        )
        for i, (name, (mesh_path, scale, pose)) in enumerate(sorted(self._scene.items())):
            from pathlib import Path

            p = Path(str(mesh_path))
            # primitive visual shapes report no mesh file; nothing to draw
            if p.suffix.lower() not in (".obj", ".off", ".stl") or not p.exists():
                continue
            m = self._load(mesh_path, scale).copy()
            m.apply_transform(pose.as_matrix())
            parts.append(m)
            rgba = np.empty((len(m.faces), 4), np.uint8)
            rgba[:, :3] = palette[i % len(palette)]
            rgba[:, 3] = 255
            colors.append(rgba)
        if not parts:
            img = np.empty((self.intrinsic.height, self.intrinsic.width, 3), np.uint8)
            img[:] = np.asarray(self.background, np.uint8)
        else:
            scene = concatenate(parts)
            scene.face_colors = np.concatenate(colors)
            img = render_mesh_image(scene, self.extrinsic, self.intrinsic,
                                    background=self.background)
        if out_path is not None:
            save_image(img, out_path)
        return img

    def render_rollout(self, snapshot_dir, out_dir) -> None:
        import pickle
        from pathlib import Path

        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for pkl in sorted(Path(snapshot_dir).glob("*.pkl")):
            with open(pkl, "rb") as f:
                snapshot = pickle.load(f)
            self.update(snapshot)
            self.render(out_dir / (pkl.stem + ".png"))

    def close(self):
        self._mesh_cache.clear()


def save_image(img: np.ndarray, path) -> None:
    """Write an (H, W, 3) uint8 array as PNG (PIL when present, else a
    minimal self-contained PNG encoder)."""
    img = np.ascontiguousarray(img, np.uint8)
    try:
        from PIL import Image

        Image.fromarray(img).save(str(path))
        return
    except ImportError:
        pass
    _write_png(img, path)


def _write_png(img: np.ndarray, path) -> None:
    import struct
    import zlib

    h, w = img.shape[:2]

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
