"""Path-traced rollout rendering via NViSII (counterpart of
giga_tpu/utils/nvisii_render.py; reference: utils/nvisii_render.py).

Optional dependency: ``nvisii`` (GPU ray tracer) is import-gated; everything
here is offline post-processing of the mesh-pose pickles produced by
BtWorld's save_dir snapshots (utils/saver.py).
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

try:
    import nvisii

    NVISII_AVAILABLE = True
except ImportError:  # pragma: no cover
    nvisii = None
    NVISII_AVAILABLE = False


def require_nvisii():
    if not NVISII_AVAILABLE:
        raise ImportError(
            "nvisii is required for path-traced rollout rendering but is not "
            "installed; the simulation snapshots themselves need only pickle"
        )


class NViSIIRenderer:
    """Renders a directory of mesh-pose snapshot pickles to PNG frames."""

    def __init__(self, width=640, height=480, spp=64, camera_position=(0.6, 0.0, 0.6),
                 look_at=(0.15, 0.15, 0.05)):
        require_nvisii()
        self.width, self.height, self.spp = width, height, spp
        nvisii.initialize(headless=True)
        nvisii.enable_denoiser()
        camera = nvisii.entity.create(
            name="camera",
            transform=nvisii.transform.create("camera"),
            camera=nvisii.camera.create_from_fov(
                name="camera", field_of_view=0.85, aspect=width / height
            ),
        )
        camera.get_transform().look_at(at=look_at, up=(0, 0, 1), eye=camera_position)
        nvisii.set_camera_entity(camera)
        self._objects = {}

    def update(self, mesh_pose_dict: dict) -> None:
        """Sync the scene to a {name: (mesh_path, scale, Transform)} snapshot."""
        for name in list(self._objects):
            if name not in mesh_pose_dict:
                nvisii.entity.remove(name)
                del self._objects[name]
        for name, (mesh_path, scale, pose) in mesh_pose_dict.items():
            if name not in self._objects:
                mesh = nvisii.mesh.create_from_file(name, str(mesh_path))
                obj = nvisii.entity.create(
                    name=name,
                    mesh=mesh,
                    transform=nvisii.transform.create(name),
                    material=nvisii.material.create(name),
                )
                self._objects[name] = obj
            obj = self._objects[name]
            t = pose.translation
            q = pose.rotation.as_quat()
            obj.get_transform().set_position((t[0], t[1], t[2]))
            obj.get_transform().set_rotation((q[0], q[1], q[2], q[3]))
            obj.get_transform().set_scale(tuple(np.atleast_1d(scale)[:3].tolist() or [scale] * 3))

    def render(self, out_path: str) -> None:
        nvisii.render_to_file(
            width=self.width, height=self.height, samples_per_pixel=self.spp,
            file_path=str(out_path),
        )

    def render_rollout(self, snapshot_dir, out_dir) -> None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for pkl in sorted(Path(snapshot_dir).glob("*.pkl")):
            with open(pkl, "rb") as f:
                snapshot = pickle.load(f)
            self.update(snapshot)
            self.render(out_dir / (pkl.stem + ".png"))

    def close(self):
        nvisii.deinitialize()
