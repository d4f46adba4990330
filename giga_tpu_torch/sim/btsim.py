"""PyBullet physics wrapper (counterpart of giga_tpu/sim/btsim.py; role of
reference src/vgn/utils/btsim.py).

Host-side simulation layer for data generation and the clutter-removal
benchmark: physics and depth rendering run on the host, only the TSDF
fusion of the rendered views runs on the card. PyBullet is an optional dependency —
importing this module without it raises a clear error only when a world is
actually created.

Key behaviors mirrored from the reference: 240 Hz stepping with 150 solver
iterations, TinyRenderer depth rendering through an OpenGL-style projection
built from pinhole intrinsics, contact queries wrapped into Contact records,
and save/restore of full world state for rejection sampling.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
import numpy as np

from giga_tpu_torch.core.transform import Rotation, Transform

try:
    import pybullet as _pb
    from pybullet_utils import bullet_client as _bullet_client

    PYBULLET_AVAILABLE = True
except ImportError:  # pragma: no cover - exercised only without pybullet
    _pb = None
    _bullet_client = None
    PYBULLET_AVAILABLE = False


def require_pybullet():
    if not PYBULLET_AVAILABLE:
        raise ImportError(
            "pybullet is required for the simulation stack "
            "(pip install pybullet) but is not installed in this environment"
        )


@dataclass
class Contact:
    bodyA: "Body"
    bodyB: "Body"
    point: tuple
    normal: tuple
    depth: float
    force: float


class BtWorld:
    """A PyBullet physics server plus bookkeeping of loaded bodies."""

    def __init__(self, gui: bool = False, save_dir=None, save_freq: int = 8):
        require_pybullet()
        self.p = _bullet_client.BulletClient(_pb.GUI if gui else _pb.DIRECT)
        self.gui = gui
        self.dt = 1.0 / 240.0
        self.solver_iterations = 150
        self.save_dir = save_dir
        self.save_freq = save_freq
        self.sim_step = 0
        self.reset()

    # --- lifecycle -----------------------------------------------------------------

    def reset(self) -> None:
        self.p.resetSimulation()
        self.p.setPhysicsEngineParameter(
            fixedTimeStep=self.dt, numSolverIterations=self.solver_iterations
        )
        self.bodies: dict[int, Body] = {}
        self.sim_time = 0.0

    def step(self) -> None:
        self.p.stepSimulation()
        if self.gui:
            _time.sleep(self.dt)
        if self.save_dir and self.sim_step % self.save_freq == 0:
            self._snapshot_meshes()
        self.sim_time += self.dt
        self.sim_step += 1

    def save_state(self) -> int:
        return self.p.saveState()

    def restore_state(self, state_uid: int) -> None:
        self.p.restoreState(stateId=state_uid)

    def close(self) -> None:
        self.p.disconnect()

    def _snapshot_meshes(self) -> None:
        import os
        import pickle

        from giga_tpu_torch.utils.saver import get_mesh_pose_dict_from_world

        mesh_pose_dict = get_mesh_pose_dict_from_world(self, self.p._client)
        path = os.path.join(self.save_dir, f"{self.sim_step:08d}.pkl")
        with open(path, "wb") as f:
            pickle.dump(mesh_pose_dict, f)

    # --- content -------------------------------------------------------------------

    def set_gravity(self, gravity) -> None:
        self.p.setGravity(*gravity)

    def load_urdf(self, urdf_path, pose: Transform, scale: float = 1.0) -> "Body":
        uid = self.p.loadURDF(
            str(urdf_path),
            pose.translation,
            pose.rotation.as_quat(),
            globalScaling=scale,
        )
        body = Body(self.p, uid, scale)
        self.bodies[uid] = body
        return body

    def remove_body(self, body: "Body") -> None:
        self.p.removeBody(body.uid)
        del self.bodies[body.uid]

    def add_constraint(self, *args, **kwargs) -> "BtConstraint":
        return BtConstraint(self.p, *args, **kwargs)

    def add_camera(self, intrinsic, near: float, far: float) -> "BtCamera":
        return BtCamera(self.p, intrinsic, near, far)

    def get_contacts(self, bodyA: "Body") -> list[Contact]:
        contacts = []
        for pt in self.p.getContactPoints(bodyA.uid):
            contacts.append(
                Contact(
                    bodyA=self.bodies[pt[1]],
                    bodyB=self.bodies[pt[2]],
                    point=pt[5],
                    normal=pt[7],
                    depth=pt[8],
                    force=pt[9],
                )
            )
        return contacts


class Body:
    """A multibody with its joints and links resolved by name."""

    def __init__(self, physics_client, uid: int, scale: float):
        self.p = physics_client
        self.uid = uid
        self.scale = scale
        self.name = self.p.getBodyInfo(uid)[1].decode("utf-8")
        self.joints: dict[str, Joint] = {}
        self.links: dict[str, Link] = {}
        for i in range(self.p.getNumJoints(uid)):
            info = self.p.getJointInfo(uid, i)
            self.joints[info[1].decode("utf-8")] = Joint(self.p, uid, i)
            self.links[info[12].decode("utf-8")] = Link(self.p, uid, i)

    def get_pose(self) -> Transform:
        pos, ori = self.p.getBasePositionAndOrientation(self.uid)
        return Transform(Rotation.from_quat(ori), np.asarray(pos))

    def set_pose(self, pose: Transform) -> None:
        self.p.resetBasePositionAndOrientation(
            self.uid, pose.translation, pose.rotation.as_quat()
        )

    def get_velocity(self):
        linear, angular = self.p.getBaseVelocity(self.uid)
        return linear, angular


class Link:
    def __init__(self, physics_client, body_uid: int, link_index: int):
        self.p = physics_client
        self.body_uid = body_uid
        self.link_index = link_index

    def get_pose(self) -> Transform:
        state = self.p.getLinkState(self.body_uid, self.link_index)
        return Transform(Rotation.from_quat(state[1]), state[0])


class Joint:
    def __init__(self, physics_client, body_uid: int, joint_index: int):
        self.p = physics_client
        self.body_uid = body_uid
        self.joint_index = joint_index
        info = self.p.getJointInfo(body_uid, joint_index)
        self.lower_limit, self.upper_limit, self.effort = info[8], info[9], info[10]

    def get_position(self) -> float:
        return self.p.getJointState(self.body_uid, self.joint_index)[0]

    def set_position(self, position: float, kinematics: bool = False) -> None:
        if kinematics:
            self.p.resetJointState(self.body_uid, self.joint_index, position)
        self.p.setJointMotorControl2(
            self.body_uid,
            self.joint_index,
            _pb.POSITION_CONTROL,
            targetPosition=position,
            force=self.effort,
        )


class BtConstraint:
    """createConstraint wrapper; parent_link/child/child_link may be None."""

    def __init__(self, physics_client, parent, parent_link, child, child_link,
                 joint_type, joint_axis, parent_frame: Transform, child_frame: Transform):
        self.p = physics_client
        self.uid = self.p.createConstraint(
            parentBodyUniqueId=parent.uid,
            parentLinkIndex=parent_link.link_index if parent_link else -1,
            childBodyUniqueId=child.uid if child else -1,
            childLinkIndex=child_link.link_index if child_link else -1,
            jointType=joint_type,
            jointAxis=joint_axis,
            parentFramePosition=parent_frame.translation,
            parentFrameOrientation=parent_frame.rotation.as_quat(),
            childFramePosition=child_frame.translation,
            childFrameOrientation=child_frame.rotation.as_quat(),
        )

    def change(self, **kwargs) -> None:
        self.p.changeConstraint(self.uid, **kwargs)


class BtCamera:
    """RGB-D rendering through PyBullet's TinyRenderer."""

    def __init__(self, physics_client, intrinsic, near: float, far: float):
        self.p = physics_client
        self.intrinsic = intrinsic
        self.near = near
        self.far = far
        self.proj_matrix = projection_matrix(intrinsic, near, far)

    def render(self, extrinsic: Transform):
        """Returns (rgb, metric depth). ``extrinsic`` maps world -> camera."""
        gl_view = extrinsic.as_matrix()
        gl_view[2, :] *= -1.0  # OpenGL looks down -z
        result = self.p.getCameraImage(
            width=self.intrinsic.width,
            height=self.intrinsic.height,
            viewMatrix=gl_view.flatten(order="F"),
            projectionMatrix=self.proj_matrix.flatten(order="F"),
            renderer=_pb.ER_TINY_RENDERER,
        )
        rgb, z_buffer = result[2][:, :, :3], result[3]
        depth = self.far * self.near / (self.far - (self.far - self.near) * z_buffer)
        return rgb, depth


def projection_matrix(intrinsic, near: float, far: float) -> np.ndarray:
    """OpenGL projection from pinhole intrinsics (perspective then ortho)."""
    persp = np.array(
        [
            [intrinsic.fx, 0.0, -intrinsic.cx, 0.0],
            [0.0, intrinsic.fy, -intrinsic.cy, 0.0],
            [0.0, 0.0, near + far, near * far],
            [0.0, 0.0, -1.0, 0.0],
        ]
    )
    left, right, bottom, top = 0.0, intrinsic.width, intrinsic.height, 0.0
    ortho = np.diag([2.0 / (right - left), 2.0 / (top - bottom), -2.0 / (far - near), 1.0])
    ortho[0, 3] = -(right + left) / (right - left)
    ortho[1, 3] = -(top + bottom) / (top - bottom)
    ortho[2, 3] = -(far + near) / (far - near)
    return ortho @ persp
