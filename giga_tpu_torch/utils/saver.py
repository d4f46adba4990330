"""Mesh-pose capture from PyBullet visual shapes (counterpart of
giga_tpu/utils/saver.py; reference: utils/saver.py).

Used by BtWorld's periodic state snapshots for offline rollout rendering;
the pickled poses are this package's ``Transform``.
"""

from __future__ import annotations

import numpy as np

from giga_tpu_torch.core.transform import Rotation, Transform


def get_mesh_pose_dict_from_world(world, physics_client_id=0, exclude_plane: bool = True):
    """{'<uid>_<link>': (mesh_path, scale, Transform)} for all visual shapes."""
    import pybullet

    out = {}
    for uid in world.bodies:
        name = world.p.getBodyInfo(uid)[1].decode("utf8")
        if name == "plane" and exclude_plane:
            continue
        for visual in world.p.getVisualShapeData(uid, physics_client_id):
            body_uid, link_index = visual[0], visual[1]
            scale = visual[3]
            mesh_path = visual[4].decode("utf8")
            visual_offset = Transform(
                Rotation.from_quat(visual[6]), np.asarray(visual[5])
            )
            if link_index != -1:
                state = pybullet.getLinkState(
                    bodyUniqueId=body_uid, linkIndex=link_index,
                    physicsClientId=physics_client_id,
                )
                link_pose = Transform(Rotation.from_quat(state[5]), np.asarray(state[4]))
                local_ori = Transform(Rotation.from_quat(state[3]), np.zeros(3))
                pose = link_pose * (local_ori * visual_offset)
            else:
                pos, quat = pybullet.getBasePositionAndOrientation(
                    bodyUniqueId=body_uid, physicsClientId=physics_client_id
                )
                dyn = pybullet.getDynamicsInfo(body_uid, -1, physics_client_id)
                inertial = Transform(Rotation.from_quat(dyn[4]), np.asarray(dyn[3]))
                base = Transform(Rotation.from_quat(quat), np.asarray(pos)) * inertial.inverse()
                pose = base * visual_offset
            out[f"{body_uid}_{link_index}"] = (mesh_path, scale, pose)
    return out
