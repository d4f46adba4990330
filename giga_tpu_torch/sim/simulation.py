"""Clutter-removal simulator (counterpart of giga_tpu/sim/simulation.py;
role of reference src/vgn/simulation.py:14-353).

Generates "pile" / "packed" tabletop scenes, acquires multi-view TSDFs
(rendered on the host, fused on ``device`` by this package's TSDFVolume
rather than Open3D), and executes open-loop grasps with a simulated Panda
hand: pregrasp -> approach -> close -> retreat -> success check. Physics is
host code.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

import torch

from giga_tpu_torch.core.device import resolve_device
from giga_tpu_torch.core.grasp import Label
from giga_tpu_torch.core.perception import CameraIntrinsic, TSDFVolume, camera_on_sphere
from giga_tpu_torch.core.transform import Rotation, Transform
from giga_tpu_torch.sim import btsim
from giga_tpu_torch.sim.noise import apply_noise


def workspace_lines(size: float):
    """Line-segment endpoints outlining the cubic workspace (for the GUI)."""
    s = size
    corners = [
        ([0, 0, 0], [s, 0, 0]), ([s, 0, 0], [s, s, 0]), ([s, s, 0], [0, s, 0]), ([0, s, 0], [0, 0, 0]),
        ([0, 0, s], [s, 0, s]), ([s, 0, s], [s, s, s]), ([s, s, s], [0, s, s]), ([0, s, s], [0, 0, s]),
        ([0, 0, 0], [0, 0, s]), ([s, 0, 0], [s, 0, s]), ([s, s, 0], [s, s, s]), ([0, s, 0], [0, s, s]),
    ]
    pts = []
    for a, b in corners:
        pts.extend([a, b])
    return pts


GLOBAL_SCALING = {
    "blocks": 1.67,
    "google": 0.7,
    "google_pile": 0.7,
    "google_packed": 0.7,
}


class ClutterRemovalSim:
    """``device``: where ``acquire_tsdf`` fuses its views (``None``: the
    card, raising without one; ``"cpu"`` to fuse on the CPU)."""

    def __init__(self, scene: str, object_set: str, gui: bool = False, seed=None,
                 add_noise=False, sideview: bool = False, save_dir=None, save_freq: int = 8,
                 urdf_root="data/urdfs", device=None):
        if scene not in ("pile", "packed"):
            raise ValueError(f"scene must be 'pile' or 'packed', got {scene!r}")
        self.device = resolve_device(device)
        self.urdf_root = Path(urdf_root)
        self.scene = scene
        self.object_set = object_set
        self.discover_objects()

        self.global_scaling = GLOBAL_SCALING.get(object_set, 1.0)
        self.gui = gui
        self.add_noise = add_noise
        self.sideview = sideview

        # `is not None`: seed=0 must seed (0 is falsy but a valid seed)
        self.rng = np.random.RandomState(seed) if seed is not None else np.random
        self.world = btsim.BtWorld(gui, save_dir, save_freq)
        self.gripper = Gripper(self.world, self.urdf_root)
        self.size = 6 * self.gripper.finger_depth
        self.camera = self.world.add_camera(
            CameraIntrinsic(640, 480, 540.0, 540.0, 320.0, 240.0), 0.1, 2.0
        )

    @property
    def num_objects(self) -> int:
        return max(0, self.world.p.getNumBodies() - 1)  # exclude the table

    def discover_objects(self) -> None:
        root = self.urdf_root / self.object_set
        self.object_urdfs = [f for f in sorted(root.iterdir()) if f.suffix == ".urdf"]

    def save_state(self) -> None:
        self._snapshot_id = self.world.save_state()

    def restore_state(self) -> None:
        self.world.restore_state(self._snapshot_id)

    # --- scene generation ----------------------------------------------------------

    def reset(self, object_count: int) -> None:
        self.world.reset()
        self.world.set_gravity([0.0, 0.0, -9.81])
        if self.gui:
            self._draw_workspace()
            self.world.p.resetDebugVisualizerCamera(
                cameraDistance=1.0, cameraYaw=0.0, cameraPitch=-45,
                cameraTargetPosition=[0.15, 0.50, -0.3],
            )
        table_height = self.gripper.finger_depth
        self._place_table(table_height)
        if self.scene == "pile":
            self._generate_pile(object_count, table_height)
        else:
            self._generate_packed(object_count, table_height)

    def _draw_workspace(self) -> None:
        pts = workspace_lines(self.size)
        for i in range(0, len(pts), 2):
            self.world.p.addUserDebugLine(
                lineFromXYZ=pts[i], lineToXYZ=pts[i + 1], lineColorRGB=[0.5, 0.5, 0.5]
            )

    def _place_table(self, height: float) -> None:
        urdf = self.urdf_root / "setup" / "plane.urdf"
        pose = Transform(Rotation.identity(), [0.15, 0.15, height])
        self.world.load_urdf(urdf, pose, scale=0.6)
        # valid grasp-sampling volume
        m = 0.02
        self.lower = np.r_[m, m, height + 0.005]
        self.upper = np.r_[self.size - m, self.size - m, self.size]

    def _generate_pile(self, object_count: int, table_height: float) -> None:
        # drop objects into a box, then remove it
        box_urdf = self.urdf_root / "setup" / "box.urdf"
        box_pose = Transform(Rotation.identity(), np.r_[0.02, 0.02, table_height])
        box = self.world.load_urdf(box_urdf, box_pose, scale=1.3)

        for urdf in self.rng.choice(self.object_urdfs, size=object_count):
            rotation = Rotation.random(random_state=self.rng)
            xy = self.rng.uniform(self.size / 3.0, 2.0 * self.size / 3.0, 2)
            pose = Transform(rotation, np.r_[xy, table_height + 0.2])
            scale = self.rng.uniform(0.8, 1.0)
            self.world.load_urdf(urdf, pose, scale=self.global_scaling * scale)
            self.wait_for_objects_to_rest(timeout=1.0)

        self.world.remove_body(box)
        self.remove_and_wait()

    def _generate_packed(self, object_count: int, table_height: float) -> None:
        # rejection-sample upright placements without contact
        attempts, max_attempts = 0, 12
        while self.num_objects < object_count and attempts < max_attempts:
            self.save_state()
            urdf = self.rng.choice(self.object_urdfs)
            x = self.rng.uniform(0.08, 0.22)
            y = self.rng.uniform(0.08, 0.22)
            angle = self.rng.uniform(0.0, 2.0 * np.pi)
            rotation = Rotation.from_rotvec(angle * np.r_[0.0, 0.0, 1.0])
            scale = self.rng.uniform(0.7, 0.9)
            body = self.world.load_urdf(
                urdf, Transform(rotation, np.r_[x, y, 1.0]), scale=self.global_scaling * scale
            )
            lower, upper = self.world.p.getAABB(body.uid)
            z = table_height + 0.5 * (upper[2] - lower[2]) + 0.002
            body.set_pose(Transform(rotation, np.r_[x, y, z]))
            self.world.step()
            if self.world.get_contacts(body):
                self.world.remove_body(body)
                self.restore_state()
            else:
                self.remove_and_wait()
            attempts += 1

    # --- sensing -------------------------------------------------------------------

    def acquire_tsdf(self, n: int, N=None, resolution: int = 40):
        """Render n depth views on a circular trajectory and fuse TSDFs.

        Returns (tsdf at ``resolution``, surface point cloud from a 120^3
        fusion cropped to the workspace, integration seconds). Both volumes
        are fused on ``self.device``. The seconds are the host clock around
        the ``resolution`` volume's integrations; on the card the device is
        synchronized just before each span and again inside it, so a span
        holds that integration's device work and nothing queued before it,
        as it does on the CPU.
        """
        tsdf = TSDFVolume(self.size, resolution, device=self.device)
        high_res_tsdf = TSDFVolume(self.size, 120, device=self.device)

        if self.sideview:
            if n != 1:
                raise ValueError("sideview acquisition uses a single view")
            origin = Transform(
                Rotation.identity(), np.r_[self.size / 2, self.size / 2, self.size / 3]
            )
            theta, phi_list = np.pi / 3.0, [-np.pi / 2.0]
        else:
            origin = Transform(Rotation.identity(), np.r_[self.size / 2, self.size / 2, 0])
            theta = np.pi / 6.0
            N = N if N else n
            phi_list = 2.0 * np.pi * np.arange(n) / N
        r = 2.0 * self.size
        extrinsics = [camera_on_sphere(origin, r, theta, phi) for phi in phi_list]

        timing = 0.0
        for extrinsic in extrinsics:
            depth_img = self.camera.render(extrinsic)[1]
            depth_img = apply_noise(depth_img, self.add_noise)
            self._sync()
            tic = time.time()
            tsdf.integrate(depth_img, self.camera.intrinsic, extrinsic)
            self._sync()
            timing += time.time() - tic
            high_res_tsdf.integrate(depth_img, self.camera.intrinsic, extrinsic)

        pc = high_res_tsdf.get_cloud()
        inside = np.all((pc >= self.lower) & (pc <= self.upper), axis=1)
        return tsdf, pc[inside], timing

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- grasp execution -----------------------------------------------------------

    def execute_grasp(self, grasp, remove: bool = True, allow_contact: bool = False):
        T_world_grasp = grasp.pose
        T_world_pregrasp = T_world_grasp * Transform(Rotation.identity(), [0.0, 0.0, -0.05])

        approach = T_world_grasp.rotation.as_matrix()[:, 2]
        angle = np.arccos(np.clip(np.dot(approach, np.r_[0.0, 0.0, -1.0]), -1.0, 1.0))
        if angle > np.pi / 3.0:
            # side grasp: lift straight up after closing
            T_world_retreat = Transform(Rotation.identity(), [0.0, 0.0, 0.1]) * T_world_grasp
        else:
            T_world_retreat = T_world_grasp * Transform(Rotation.identity(), [0.0, 0.0, -0.1])

        self.gripper.reset(T_world_pregrasp)

        if self.gripper.detect_contact():
            result = Label.FAILURE, self.gripper.max_opening_width
        else:
            self.gripper.move_tcp_xyz(T_world_grasp, abort_on_contact=True)
            if self.gripper.detect_contact() and not allow_contact:
                result = Label.FAILURE, self.gripper.max_opening_width
            else:
                self.gripper.move(0.0)
                self.gripper.move_tcp_xyz(T_world_retreat, abort_on_contact=False)
                if self.check_success(self.gripper):
                    result = Label.SUCCESS, self.gripper.read()
                    if remove:
                        contacts = self.world.get_contacts(self.gripper.body)
                        self.world.remove_body(contacts[0].bodyB)
                else:
                    result = Label.FAILURE, self.gripper.max_opening_width

        self.world.remove_body(self.gripper.body)
        if remove:
            self.remove_and_wait()
        return result

    def remove_and_wait(self) -> None:
        removed = True
        while removed:
            self.wait_for_objects_to_rest()
            removed = self.remove_objects_outside_workspace()

    def wait_for_objects_to_rest(self, timeout: float = 2.0, tol: float = 0.01) -> None:
        deadline = self.world.sim_time + timeout
        resting = False
        while not resting and self.world.sim_time < deadline:
            for _ in range(60):  # quarter second at 240 Hz
                self.world.step()
            resting = all(
                np.linalg.norm(body.get_velocity()[0]) <= tol
                for body in self.world.bodies.values()
            )

    def remove_objects_outside_workspace(self) -> bool:
        removed = False
        for body in list(self.world.bodies.values()):
            xyz = body.get_pose().translation
            if np.any(xyz < 0.0) or np.any(xyz > self.size):
                self.world.remove_body(body)
                removed = True
        return removed

    def check_success(self, gripper) -> bool:
        # fingers must touch something and not be fully closed
        contacts = self.world.get_contacts(gripper.body)
        return len(contacts) > 0 and gripper.read() > 0.1 * gripper.max_opening_width


class Gripper:
    """Simulated Panda hand controlled through a fixed world constraint."""

    def __init__(self, world, urdf_root: Path):
        self.world = world
        self.urdf_path = Path(urdf_root) / "panda" / "hand.urdf"
        self.max_opening_width = 0.08
        self.finger_depth = 0.05
        self.T_body_tcp = Transform(Rotation.identity(), [0.0, 0.0, 0.022])
        self.T_tcp_body = self.T_body_tcp.inverse()

    def reset(self, T_world_tcp: Transform) -> None:
        btsim.require_pybullet()
        import pybullet

        T_world_body = T_world_tcp * self.T_tcp_body
        self.body = self.world.load_urdf(self.urdf_path, T_world_body)
        self.body.set_pose(T_world_body)
        self.constraint = self.world.add_constraint(
            self.body, None, None, None,
            pybullet.JOINT_FIXED, [0.0, 0.0, 0.0], Transform.identity(), T_world_body,
        )
        self.update_tcp_constraint(T_world_tcp)
        # gear constraint keeps the two fingers centered
        self.world.add_constraint(
            self.body, self.body.links["panda_leftfinger"],
            self.body, self.body.links["panda_rightfinger"],
            pybullet.JOINT_GEAR, [1.0, 0.0, 0.0], Transform.identity(), Transform.identity(),
        ).change(gearRatio=-1, erp=0.1, maxForce=50)
        self.joint1 = self.body.joints["panda_finger_joint1"]
        self.joint2 = self.body.joints["panda_finger_joint2"]
        self.joint1.set_position(0.5 * self.max_opening_width, kinematics=True)
        self.joint2.set_position(0.5 * self.max_opening_width, kinematics=True)

    def update_tcp_constraint(self, T_world_tcp: Transform) -> None:
        T_world_body = T_world_tcp * self.T_tcp_body
        self.constraint.change(
            jointChildPivot=T_world_body.translation,
            jointChildFrameOrientation=T_world_body.rotation.as_quat(),
            maxForce=300,
        )

    def set_tcp(self, T_world_tcp: Transform) -> None:
        self.body.set_pose(T_world_tcp * self.T_tcp_body)
        self.update_tcp_constraint(T_world_tcp)

    def move_tcp_xyz(self, target: Transform, eef_step: float = 0.002, vel: float = 0.10,
                     abort_on_contact: bool = True) -> None:
        T_world_tcp = self.body.get_pose() * self.T_body_tcp
        diff = target.translation - T_world_tcp.translation
        n_steps = max(int(np.linalg.norm(diff) / eef_step), 1)
        dist_step = diff / n_steps
        dur_step = np.linalg.norm(dist_step) / vel
        for _ in range(n_steps):
            T_world_tcp = Transform(T_world_tcp.rotation, T_world_tcp.translation + dist_step)
            self.update_tcp_constraint(T_world_tcp)
            for _ in range(int(dur_step / self.world.dt)):
                self.world.step()
            if abort_on_contact and self.detect_contact():
                return

    def detect_contact(self) -> bool:
        return bool(self.world.get_contacts(self.body))

    def move(self, width: float) -> None:
        self.joint1.set_position(0.5 * width)
        self.joint2.set_position(0.5 * width)
        for _ in range(int(0.5 / self.world.dt)):
            self.world.step()

    def read(self) -> float:
        return self.joint1.get_position() + self.joint2.get_position()
