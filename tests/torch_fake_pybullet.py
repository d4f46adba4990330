"""Deterministic in-process pybullet double for exercising the sim stack.

Injected as ``sys.modules['pybullet']`` (plus a ``pybullet_utils`` shim) so
``giga_tpu_torch.sim.btsim`` / ``simulation`` / ``experiments.clutter_removal`` and
the data-generation scripts execute end-to-end under pytest without the real
physics engine (VERDICT round-1, item 2).

Physics model (kinematic, fully deterministic):
- every body is an oriented-box proxy (local AABB of its URDF mesh/box);
- gravity settles free bodies straight down onto the highest supporting
  body top (stacking supported); no lateral dynamics;
- contacts are world-AABB overlaps, reported in pybullet's tuple layout;
- the gripper is driven kinematically by its fixed world constraint; finger
  joints move toward their motor targets at a constant speed and block on an
  object inside the capture region, which then attaches and rides the hand
  (that is the grasp "force closure");
- depth rendering is an analytic ray/oriented-box intersection per body,
  decoding the intrinsics/extrinsics back out of the OpenGL matrices that
  ``btsim.BtCamera`` builds (reference btsim.py:290-337 semantics).
"""

from __future__ import annotations

import copy
import types
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from giga_tpu_torch.core.transform import Rotation, Transform

# --- pybullet constants (values match the real module) -----------------------------
GUI = 1
DIRECT = 2
POSITION_CONTROL = 2
JOINT_PRISMATIC = 1
JOINT_FIXED = 4
JOINT_GEAR = 6
ER_TINY_RENDERER = 65536
GEOM_MESH = 5

_GRAVITY_DEFAULT = (0.0, 0.0, 0.0)
_JOINT_SPEED = 0.10  # m/s finger travel
_CONTACT_MARGIN = 1e-3

_clients: dict[int, "FakeClient"] = {}
_next_client = [0]


def _quat_mat(quat) -> np.ndarray:
    """Quaternion (x, y, z, w) -> rotation matrix, no scipy (hot path)."""
    x, y, z, w = np.asarray(quat, dtype=np.float64)
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0.0 else 2.0 / n
    xx, yy, zz = s * x * x, s * y * y, s * z * z
    xy, xz, yz = s * x * y, s * x * z, s * y * z
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    return np.array([
        [1.0 - yy - zz, xy - wz, xz + wy],
        [xy + wz, 1.0 - xx - zz, yz - wx],
        [xz - wy, yz + wx, 1.0 - xx - yy],
    ])


def _mat_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w); Shepperd's method."""
    t = np.trace(R)
    if t > 0.0:
        s = np.sqrt(t + 1.0) * 2.0
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2.0
    q = np.empty(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


class _FJoint:
    def __init__(self, name, link_name, lower, upper, effort, position=0.0):
        self.name = name
        self.link_name = link_name
        self.lower, self.upper, self.effort = lower, upper, effort
        self.position = position
        self.target = position


class _FBody:
    def __init__(self, uid, name, urdf_path, mesh_path, scale, mass,
                 local_center, local_half, pos, quat, joints):
        self.uid = uid
        self.name = name
        self.urdf_path = urdf_path
        self.mesh_path = mesh_path
        self.scale = scale
        self.mass = mass
        self.local_center = np.asarray(local_center, np.float64)
        self.local_half = np.asarray(local_half, np.float64)
        self.pos = np.asarray(pos, np.float64)
        self.quat = np.asarray(quat, np.float64)
        self.vel = np.zeros(3)
        self.joints: list[_FJoint] = joints
        self.attached_to = None  # gripper uid
        self.T_grip_body: Transform | None = None
        self._rot_for = None
        self._rot = None

    # --- geometry ------------------------------------------------------------------

    @property
    def is_static(self) -> bool:
        return self.mass == 0.0

    @property
    def is_gripper(self) -> bool:
        return bool(self.joints)

    def rot(self) -> np.ndarray:
        # cache keyed on the quat array's identity: every quat write replaces
        # the array (never mutates in place)
        if self._rot_for is not self.quat:
            self._rot = _quat_mat(self.quat)
            self._rot_for = self.quat
        return self._rot

    def world_aabb(self):
        """World AABB of the (possibly opened) proxy box."""
        R = self.rot()
        center = self.pos + R @ self.local_center
        half = self.local_half.copy()
        if self.is_gripper and self.joints:
            # widen the proxy along the closing axis with the finger opening
            half = half + np.array([0.0, self.joints[0].position, 0.0])
        ext = np.abs(R) @ half
        return center - ext, center + ext

    def state_tuple(self):
        return (self.pos.copy(), self.quat.copy(), self.vel.copy(),
                [(j.position, j.target) for j in self.joints],
                self.attached_to,
                None if self.T_grip_body is None else
                (self.T_grip_body[0].copy(), self.T_grip_body[1].copy()))

    def restore_tuple(self, t):
        self.pos, self.quat, self.vel = t[0].copy(), t[1].copy(), t[2].copy()
        for j, (p, tgt) in zip(self.joints, t[3]):
            j.position, j.target = p, tgt
        self.attached_to = t[4]
        self.T_grip_body = t[5]


def _parse_urdf(path: str | Path, global_scaling: float):
    """Minimal URDF read: base-link proxy box + mesh path + mass + joints."""
    path = Path(path)
    root = ET.parse(path).getroot()
    name = root.get("name", path.stem)
    links = root.findall("link")
    base = links[0]
    mass_el = base.find("inertial/mass")
    mass = float(mass_el.get("value")) if mass_el is not None else 0.0

    mesh_path = ""
    geom = base.find("visual/geometry")
    if geom is None:
        geom = base.find("collision/geometry")
    local_center = np.zeros(3)
    local_half = np.full(3, 0.01)
    if geom is not None:
        box = geom.find("box")
        mesh = geom.find("mesh")
        if box is not None:
            size = np.array([float(v) for v in box.get("size").split()])
            local_half = 0.5 * size * global_scaling
        elif mesh is not None:
            mesh_file = (path.parent / mesh.get("filename")).resolve()
            mesh_path = str(mesh_file)
            from giga_tpu_torch.geometry.mesh import load_mesh

            m = load_mesh(mesh_file)
            if mesh.get("scale"):
                m.apply_scale([float(s) for s in mesh.get("scale").split()])
            lo, hi = m.bounds * global_scaling
            local_center = 0.5 * (lo + hi)
            local_half = 0.5 * (hi - lo)
    origin = base.find("visual/origin")
    if origin is not None and origin.get("xyz"):
        local_center = local_center + np.array(
            [float(v) for v in origin.get("xyz").split()]) * global_scaling

    joints = []
    for j in root.findall("joint"):
        if j.get("type") != "prismatic":
            continue
        limit = j.find("limit")
        joints.append(_FJoint(
            j.get("name"), j.find("child").get("link"),
            float(limit.get("lower", 0)), float(limit.get("upper", 0.04)),
            float(limit.get("effort", 20)),
        ))
    return name, mesh_path, mass, local_center, local_half, joints


class FakeClient:
    """One simulated world. Mirrors the pybullet client API surface that
    giga_tpu_torch.sim uses (see module docstring)."""

    def __init__(self, mode=DIRECT):
        self._client = _next_client[0]
        _next_client[0] += 1
        _clients[self._client] = self
        self.resetSimulation()

    # --- lifecycle -------------------------------------------------------------

    def resetSimulation(self):
        self.bodies: dict[int, _FBody] = {}
        self._next_uid = 0
        self.gravity = np.asarray(_GRAVITY_DEFAULT, np.float64)
        self.dt = 1.0 / 240.0
        self.constraints: dict[int, dict] = {}
        self._next_cid = 0
        self._saved: dict[int, dict] = {}
        self._next_sid = 0

    def setPhysicsEngineParameter(self, fixedTimeStep=None, **kw):
        if fixedTimeStep:
            self.dt = fixedTimeStep

    def setGravity(self, gx, gy, gz):
        self.gravity = np.array([gx, gy, gz], np.float64)

    def disconnect(self):
        _clients.pop(self._client, None)

    # --- bodies ----------------------------------------------------------------

    def loadURDF(self, fileName, basePosition=None, baseOrientation=None,
                 globalScaling=1.0, **kw):
        name, mesh_path, mass, c, h, joints = _parse_urdf(fileName, globalScaling)
        uid = self._next_uid
        self._next_uid += 1
        pos = np.zeros(3) if basePosition is None else np.asarray(basePosition, np.float64)
        quat = np.array([0, 0, 0, 1.0]) if baseOrientation is None else np.asarray(
            baseOrientation, np.float64)
        self.bodies[uid] = _FBody(uid, name, str(fileName), mesh_path, globalScaling,
                                  mass, c, h, pos, quat, joints)
        return uid

    def removeBody(self, uid):
        body = self.bodies.pop(uid)
        # drop anything it was holding
        for b in self.bodies.values():
            if b.attached_to == uid:
                b.attached_to, b.T_grip_body = None, None
        self.constraints = {
            cid: c for cid, c in self.constraints.items() if c["parent"] != uid
        }

    def getNumBodies(self):
        return len(self.bodies)

    def getBodyInfo(self, uid):
        return (b"base", self.bodies[uid].name.encode())

    def getBasePositionAndOrientation(self, uid, physicsClientId=None):
        b = self.bodies[uid]
        return tuple(b.pos), tuple(b.quat)

    def resetBasePositionAndOrientation(self, uid, pos, quat):
        b = self.bodies[uid]
        b.pos = np.asarray(pos, np.float64)
        b.quat = np.asarray(quat, np.float64)
        b.vel = np.zeros(3)

    def getBaseVelocity(self, uid):
        return tuple(self.bodies[uid].vel), (0.0, 0.0, 0.0)

    def getAABB(self, uid):
        lo, hi = self.bodies[uid].world_aabb()
        return tuple(lo), tuple(hi)

    def getDynamicsInfo(self, uid, link_index, physicsClientId=None):
        b = self.bodies[uid]
        return (b.mass, 0.5, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0),
                0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    def getVisualShapeData(self, uid, physicsClientId=None):
        b = self.bodies[uid]
        s = float(b.scale)
        return [(uid, -1, GEOM_MESH, (s, s, s), b.mesh_path.encode(),
                 (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0), (1.0, 1.0, 1.0, 1.0))]

    # --- joints ------------------------------------------------------------------

    def getNumJoints(self, uid):
        return len(self.bodies[uid].joints)

    def getJointInfo(self, uid, index):
        j = self.bodies[uid].joints[index]
        return (index, j.name.encode(), JOINT_PRISMATIC, 0, 0, 0, 0.0, 0.0,
                j.lower, j.upper, j.effort, 0.1, j.link_name.encode(),
                (0.0, 1.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0), -1)

    def getJointState(self, uid, index):
        j = self.bodies[uid].joints[index]
        return (j.position, 0.0, (0, 0, 0, 0, 0, 0), 0.0)

    def resetJointState(self, uid, index, targetValue):
        j = self.bodies[uid].joints[index]
        j.position = j.target = float(targetValue)

    def setJointMotorControl2(self, uid, index, controlMode, targetPosition=0.0,
                              force=None, **kw):
        self.bodies[uid].joints[index].target = float(targetPosition)

    def _finger_pose(self, body: _FBody, index: int):
        j = body.joints[index]
        sign = 1.0 if index == 0 else -1.0
        local = np.array([0.0, sign * (j.position + 0.004), 0.022])
        world = body.pos + body.rot() @ local
        return tuple(world), tuple(body.quat)

    def getLinkState(self, uid, link_index, physicsClientId=None, **kw):
        body = self.bodies[uid]
        pos, quat = self._finger_pose(body, min(link_index, len(body.joints) - 1))
        return (pos, quat, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0), pos, quat)

    # --- constraints ---------------------------------------------------------------

    def createConstraint(self, parentBodyUniqueId, parentLinkIndex, childBodyUniqueId,
                         childLinkIndex, jointType, jointAxis, parentFramePosition,
                         parentFrameOrientation, childFramePosition,
                         childFrameOrientation, **kw):
        cid = self._next_cid
        self._next_cid += 1
        self.constraints[cid] = dict(
            parent=parentBodyUniqueId, type=jointType,
            pivot=np.asarray(childFramePosition, np.float64),
            orn=np.asarray(childFrameOrientation, np.float64),
        )
        return cid

    def changeConstraint(self, cid, jointChildPivot=None,
                         jointChildFrameOrientation=None, **kw):
        c = self.constraints[cid]
        if jointChildPivot is not None:
            c["pivot"] = np.asarray(jointChildPivot, np.float64)
        if jointChildFrameOrientation is not None:
            c["orn"] = np.asarray(jointChildFrameOrientation, np.float64)

    # --- state save/restore ----------------------------------------------------------

    def saveState(self):
        sid = self._next_sid
        self._next_sid += 1
        self._saved[sid] = {uid: b.state_tuple() for uid, b in self.bodies.items()}
        return sid

    def restoreState(self, stateId):
        for uid, t in self._saved[stateId].items():
            if uid in self.bodies:
                self.bodies[uid].restore_tuple(t)

    # --- stepping --------------------------------------------------------------------

    def stepSimulation(self):
        # 1. constraint-driven grippers snap to their fixed-constraint target
        #    (arrays aliased, not copied: every write site replaces the array,
        #    which also keeps the body's rotation-matrix cache valid)
        for c in self.constraints.values():
            if c["type"] == JOINT_FIXED and c["parent"] in self.bodies:
                b = self.bodies[c["parent"]]
                b.pos, b.quat, b.vel = c["pivot"], c["orn"], np.zeros(3)
        # 2. finger joints track their motor targets; closing blocks on a
        #    captured object, which attaches to the hand
        for b in list(self.bodies.values()):
            if not b.is_gripper:
                continue
            held = self._held_body(b)
            block = 0.0
            if held is None and any(j.target < j.position for j in b.joints):
                cand = self._capture_candidate(b)
                if cand is not None:
                    block = self._closing_half_width(b, cand)
            elif held is not None:
                block = self._closing_half_width(b, held)
            for j in b.joints:
                step = _JOINT_SPEED * self.dt
                if j.target < j.position:
                    # blocking can stop the close early but never pushes open
                    j.position = max(j.target, j.position - step, min(block, j.position))
                elif j.target > j.position:
                    j.position = min(j.target, j.position + step)
            if held is None and block > 0.0:
                cand = self._capture_candidate(b)
                if cand is not None and all(
                    j.position <= block + 1e-6 for j in b.joints
                ):
                    cand.attached_to = b.uid
                    Rg = b.rot()
                    cand.T_grip_body = (Rg.T @ cand.rot(), Rg.T @ (cand.pos - b.pos))
                    cand.vel = np.zeros(3)
            if any(j.target > j.position + 1e-9 for j in b.joints):
                for o in self.bodies.values():  # opening releases the hold
                    if o.attached_to == b.uid:
                        o.attached_to, o.T_grip_body = None, None
        # 3. attached bodies ride their gripper (matrix math; quat only
        #    refreshed from the relative transform when the gripper moved)
        for b in self.bodies.values():
            if b.attached_to is not None and b.attached_to in self.bodies:
                g = self.bodies[b.attached_to]
                R_rel, t_rel = b.T_grip_body
                Rg = g.rot()
                b.pos = g.pos + Rg @ t_rel
                b._rot = Rg @ R_rel
                b._rot_for = b.quat = _mat_quat(b._rot)
                b.vel = np.zeros(3)
            elif b.attached_to is not None:
                b.attached_to, b.T_grip_body = None, None
        # 4. gravity settles free dynamic bodies straight down onto supports
        free = [b for b in self.bodies.values()
                if not b.is_static and not b.is_gripper and b.attached_to is None]
        free.sort(key=lambda b: b.world_aabb()[0][2])
        for b in free:
            b.vel[2] += self.gravity[2] * self.dt
            dz = b.vel[2] * self.dt
            lo, hi = b.world_aabb()
            support = self._support_height(b, lo, hi)
            bottom_offset = b.pos[2] - lo[2]
            rest_z = support + bottom_offset
            new_z = b.pos[2] + dz
            if new_z <= rest_z:
                b.pos[2] = rest_z
                b.vel = np.zeros(3)
            else:
                b.pos[2] = new_z

    def _support_height(self, body, lo, hi):
        """Highest top surface below the body's midplane that overlaps in xy."""
        support = -np.inf
        mid_z = 0.5 * (lo[2] + hi[2])
        for other in self.bodies.values():
            if other.uid == body.uid or other.is_gripper:
                continue
            olo, ohi = other.world_aabb()
            if olo[0] < hi[0] and ohi[0] > lo[0] and olo[1] < hi[1] and ohi[1] > lo[1]:
                if ohi[2] <= mid_z:
                    support = max(support, ohi[2])
        return support

    # --- grasp capture ----------------------------------------------------------------

    def _held_body(self, gripper):
        for b in self.bodies.values():
            if b.attached_to == gripper.uid:
                return b
        return None

    def _local_box(self, T_inv: Transform, body: "_FBody"):
        """Body proxy corners -> AABB in another frame (conservative OBB)."""
        R = body.rot()
        c = body.pos + R @ body.local_center
        corners = c + (np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
        ) * body.local_half) @ R.T
        local = corners @ T_inv.rotation.as_matrix().T + T_inv.translation
        return local.min(axis=0), local.max(axis=0)

    def _capture_candidate(self, gripper):
        """Body inside the closing region between the fingers (gripper frame:
        TCP at z=0.022, fingertips at z=0.047, closing axis y).  Any part of
        the body between the finger faces counts (like real finger closure),
        but its center must be straddled along the closing axis."""
        T_inv = Transform(Rotation.from_quat(gripper.quat), gripper.pos).inverse()
        best, best_y = None, np.inf
        jp = gripper.joints[0].position
        for b in self.bodies.values():
            if b.is_static or b.is_gripper or b.attached_to is not None:
                continue
            lo, hi = self._local_box(T_inv, b)
            cy = 0.5 * (lo[1] + hi[1])
            if (lo[0] < 0.02 and hi[0] > -0.02 and abs(cy) < jp
                    and lo[2] < 0.047 and hi[2] > 0.0 and abs(cy) < best_y):
                best, best_y = b, abs(cy)
        return best

    def _gripper_part_boxes(self, gripper):
        """(center, half) finger + palm boxes in the gripper's local frame."""
        jp = gripper.joints[0].position
        return [
            (np.array([0.0, jp + 0.004, 0.022]), np.array([0.010, 0.004, 0.025])),
            (np.array([0.0, -(jp + 0.004), 0.022]), np.array([0.010, 0.004, 0.025])),
            (np.array([0.0, 0.0, -0.0155]), np.array([0.020, 0.050, 0.0125])),  # palm
        ]

    def _gripper_touches(self, gripper, other) -> bool:
        """Finger/palm boxes vs the other body's proxy (corners -> local AABB).

        Finer than a hull AABB so that open fingers straddle a narrow object
        without reporting contact during the approach."""
        T_inv = Transform(Rotation.from_quat(gripper.quat), gripper.pos).inverse()
        olo, ohi = self._local_box(T_inv, other)
        for center, half in self._gripper_part_boxes(gripper):
            if np.all(olo <= center + half + _CONTACT_MARGIN) and np.all(
                center - half <= ohi + _CONTACT_MARGIN
            ):
                return True
        return False

    def _closing_half_width(self, gripper, body):
        """Projection of the body's proxy half-extents onto the closing axis."""
        y_axis = _quat_mat(gripper.quat)[:, 1]
        R = body.rot()
        return float(np.abs(y_axis @ R) @ body.local_half)

    # --- contacts ----------------------------------------------------------------------

    def getContactPoints(self, bodyA=None, **kw):
        out = []
        a = self.bodies.get(bodyA)
        if a is None:
            return out
        alo, ahi = a.world_aabb()
        for b in self.bodies.values():
            if b.uid == a.uid:
                continue
            touching = b.attached_to == a.uid or a.attached_to == b.uid
            if not touching:
                if a.is_gripper:
                    touching = self._gripper_touches(a, b)
                elif b.is_gripper:
                    touching = self._gripper_touches(b, a)
                else:
                    blo, bhi = b.world_aabb()
                    touching = bool(
                        np.all(alo <= bhi + _CONTACT_MARGIN)
                        and np.all(blo <= ahi + _CONTACT_MARGIN)
                    )
            if touching:
                point = tuple(0.5 * (a.pos + b.pos))
                out.append((0, a.uid, b.uid, -1, -1, point, point,
                            (0.0, 0.0, 1.0), -1e-4, 1.0, 0.0, (0, 0, 0), 0.0, (0, 0, 0)))
        return out

    # --- rendering -----------------------------------------------------------------------

    def getCameraImage(self, width, height, viewMatrix, projectionMatrix,
                       renderer=None, **kw):
        V = np.asarray(viewMatrix, np.float64).reshape(4, 4, order="F")
        P = np.asarray(projectionMatrix, np.float64).reshape(4, 4, order="F")
        # invert btsim's gl_view construction: row 2 was negated
        extrinsic = np.eye(4)
        extrinsic[0], extrinsic[1], extrinsic[2] = V[0], V[1], -V[2]
        fx = P[0, 0] * width / 2.0
        fy = -P[1, 1] * height / 2.0
        cx = (1.0 - P[0, 2]) * width / 2.0
        cy = (P[1, 2] + 1.0) * height / 2.0
        near = P[2, 3] / (P[2, 2] - 1.0)
        far = P[2, 3] / (P[2, 2] + 1.0)

        R_wc = extrinsic[:3, :3]
        t = extrinsic[:3, 3]
        origin = -R_wc.T @ t
        u = (np.arange(width) + 0.5 - cx) / fx
        v = (np.arange(height) + 0.5 - cy) / fy
        uu, vv = np.meshgrid(u, v)
        dirs_cam = np.stack([uu, vv, np.ones_like(uu)], axis=-1)  # z_cam component 1
        dirs = dirs_cam @ R_wc  # (H, W, 3) world rays; t along ray == camera z-depth

        depth = np.full((height, width), far, np.float64)
        for b in self.bodies.values():
            if b.is_gripper:
                continue
            R = b.rot()
            o_loc = R.T @ (origin - b.pos) - b.local_center
            d_loc = dirs @ R  # world->local via R^T on the right
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / d_loc
                t1 = (-b.local_half - o_loc) * inv
                t2 = (b.local_half - o_loc) * inv
                tmin = np.minimum(t1, t2).max(axis=-1)
                tmax = np.maximum(t1, t2).min(axis=-1)
            hit = (tmax >= tmin) & (tmax > 0)
            thit = np.where(tmin > 0, tmin, tmax)
            depth = np.where(hit & (thit > near) & (thit < depth), thit, depth)

        z_buffer = (far - far * near / depth) / (far - near)
        rgb = np.zeros((height, width, 4), np.uint8)
        seg = np.full((height, width), -1, np.int32)
        return width, height, rgb, z_buffer.astype(np.float32), seg

    # --- GUI no-ops ------------------------------------------------------------------------

    def addUserDebugLine(self, *a, **kw):
        return 0

    def resetDebugVisualizerCamera(self, *a, **kw):
        pass


# --- module-level API (saver.py calls these directly on the pybullet module) ------------

def connect(mode=DIRECT):
    return FakeClient(mode)._client


def _client_of(physicsClientId):
    cid = 0 if physicsClientId is None else physicsClientId
    return _clients[cid]


def getLinkState(bodyUniqueId, linkIndex, physicsClientId=None, **kw):
    return _client_of(physicsClientId).getLinkState(bodyUniqueId, linkIndex)


def getBasePositionAndOrientation(bodyUniqueId, physicsClientId=None):
    return _client_of(physicsClientId).getBasePositionAndOrientation(bodyUniqueId)


def getDynamicsInfo(bodyUniqueId, linkIndex, physicsClientId=None):
    return _client_of(physicsClientId).getDynamicsInfo(bodyUniqueId, linkIndex)


# --- pybullet_utils shim -----------------------------------------------------------------


class _BulletClient(FakeClient):
    """Stands in for pybullet_utils.bullet_client.BulletClient."""


bullet_client = types.ModuleType("pybullet_utils.bullet_client")
bullet_client.BulletClient = _BulletClient
pybullet_utils = types.ModuleType("pybullet_utils")
pybullet_utils.bullet_client = bullet_client


def reset_module_state():
    _clients.clear()
    _next_client[0] = 0
