"""Affordance visualization in the PyTorch port (utils/visual.py,
geometry/mesh.py, and both planners' ``visualize=True``) on the CPU against
the JAX package: the colored scene, the gripper glyphs, the composed scene
and its PLY text equal (vertices, faces, colors), the mesh loaders equal,
and both planners' composed scenes equal to the JAX planners' on the same
scene and weights.
"""

from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from test_torch_vgn import jax_vgn_params
from giga_tpu.core.grasp import Grasp as JGrasp
from giga_tpu.core.transform import Rotation as JRotation
from giga_tpu.core.transform import Transform as JTransform
from giga_tpu.geometry import mesh as jm
from giga_tpu.inference.planner import GIGAPlanner as JGIGAPlanner
from giga_tpu.inference.planner import State as JState
from giga_tpu.inference.planner import VGNPlanner as JVGNPlanner
from giga_tpu.utils import visual as jv
from giga_tpu_torch.core.grasp import Grasp
from giga_tpu_torch.core.transform import Rotation, Transform
from giga_tpu_torch.geometry import mesh as pm
from giga_tpu_torch.inference.planner import GIGAPlanner, State, VGNPlanner
from giga_tpu_torch.utils import visual as pv

REPO = Path(__file__).resolve().parents[1]
TOL_VERTEX = 1e-6  # metres: grasp glyphs of rotations within 1e-5 of each other


def _meshes(objects):
    """The same scene mesh in both packages."""
    port = chip_smoke.scene_mesh(objects)
    return port, jm.TriMesh(port.vertices.copy(), port.faces.copy())


def assert_same_mesh(got, ref, tol=0.0):
    """Equal faces and face colors, vertices within ``tol``."""
    np.testing.assert_array_equal(got.faces, ref.faces)
    np.testing.assert_allclose(got.vertices, ref.vertices, atol=tol, rtol=0)
    colors = getattr(ref, "face_colors", None)
    assert (getattr(got, "face_colors", None) is None) == (colors is None)
    if colors is not None:
        np.testing.assert_array_equal(got.face_colors, colors)


def _volumes(seed=0, R=40):
    rng = np.random.RandomState(seed)
    qual = rng.rand(R, R, R).astype(np.float32) ** 3
    rot = rng.standard_normal((R, R, R, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    return qual, rot


@pytest.mark.parametrize("aggregation", ["max", "mean", "softmax"])
def test_affordance_visual_matches_jax(aggregation):
    qual, rot = _volumes()
    if aggregation == "softmax":  # exp(150 q) overflows float32
        qual = qual.astype(np.float64)
    port, ref = _meshes(chip_smoke.scene_objects(1)[0])
    got = pv.affordance_visual(qual, rot, port, 0.3, 40, aggregation=aggregation)
    expect = jv.affordance_visual(qual, rot, ref, 0.3, 40, aggregation=aggregation)
    assert_same_mesh(got, expect)
    assert got is not port and len(np.unique(got.face_colors, axis=0)) > 1
    with pytest.raises(ValueError):
        pv.affordance_visual(qual, rot, port, aggregation="median")


def test_affordance_visual_without_qualifying_voxels():
    """No voxel above the threshold: the scene mesh itself, uncolored."""
    qual, rot = _volumes()
    port, _ = _meshes(chip_smoke.scene_objects(1)[0])
    assert pv.affordance_visual(qual * 0.1, rot, port) is port
    np.testing.assert_array_equal(pv.reds_colormap(np.linspace(0, 1, 7)),
                                  jv.reds_colormap(np.linspace(0, 1, 7)))
    np.testing.assert_array_equal(pv.quat_z_axis(rot[:2, :2, :2]), jv.quat_z_axis(rot[:2, :2, :2]))


def _grasps(n=3, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        quat, pos, width = rng.standard_normal(4), rng.rand(3) * 0.3, 0.02 + 0.06 * rng.rand()
        quat /= np.linalg.norm(quat)
        out.append((Grasp(Transform(Rotation.from_quat(quat), pos), width),
                    JGrasp(JTransform(JRotation.from_quat(quat), pos), width)))
    return [g for g, _ in out], [g for _, g in out], rng.rand(n)


def test_compose_scene_and_ply_match_jax(tmp_path):
    qual, rot = _volumes()
    port, ref = _meshes(chip_smoke.scene_objects(2)[1])
    grasps, jgrasps, scores = _grasps()
    for g, jg in zip(grasps, jgrasps):
        assert_same_mesh(pv.grasp2mesh(g), jv.grasp2mesh(jg))
    colored = pv.affordance_visual(qual, rot, port)
    got = pv.compose_scene(colored, grasps, scores)
    expect = jv.compose_scene(jv.affordance_visual(qual, rot, ref), jgrasps, scores)
    assert_same_mesh(got, expect)
    # an uncolored scene mesh gets opaque gray and the glyphs keep their
    # colors; the JAX package's RGB gray fails to join the glyphs' RGBA
    plain = pv.compose_scene(port, grasps, scores)
    np.testing.assert_array_equal(plain.face_colors[:len(port.faces)], np.tile(
        np.array([180, 180, 180, 255], np.uint8), (len(port.faces), 1)))
    np.testing.assert_array_equal(plain.face_colors[len(port.faces):],
                                  got.face_colors[len(port.faces):])
    with pytest.raises(ValueError):
        jv.compose_scene(ref, jgrasps, scores)
    pv.export_ply(got, tmp_path / "port.ply")
    jv.export_ply(expect, tmp_path / "jax.ply")
    assert (tmp_path / "port.ply").read_text() == (tmp_path / "jax.ply").read_text()


def test_mesh_loaders_match_jax(tmp_path):
    """OBJ, OFF, ASCII and binary STL read alike; TriMesh's properties,
    transforms and seeded surface samples agree."""
    box = pm.box_mesh((0.1, 0.2, 0.3), (0.05, 0.0, 0.1))
    assert_same_mesh(box, jm.box_mesh((0.1, 0.2, 0.3), (0.05, 0.0, 0.1)))
    box.export(tmp_path / "box.obj")
    off = tmp_path / "box.off"
    off.write_text("OFF\n8 12 0\n" + "".join(f"{x} {y} {z}\n" for x, y, z in box.vertices)
                   + "".join(f"3 {a} {b} {c}\n" for a, b, c in box.faces))
    stl = tmp_path / "box_ascii.stl"
    stl.write_text("solid box\n" + "".join(
        "facet normal 0 0 0\nouter loop\n" + "".join(f"vertex {x} {y} {z}\n" for x, y, z in tri)
        + "endloop\nendfacet\n" for tri in box.triangles) + "endsolid box\n")
    tris = box.triangles.astype(np.float32)
    data = np.zeros((len(tris), 50), np.uint8)
    data[:, 12:48] = tris.reshape(len(tris), 9).view(np.uint8).reshape(len(tris), 36)
    binary = tmp_path / "box_binary.stl"
    binary.write_bytes(b"\0" * 80 + np.uint32(len(tris)).tobytes() + data.tobytes())
    for path in (tmp_path / "box.obj", off, stl, binary):
        got, ref = pm.load_mesh(path), jm.load_mesh(path)
        assert_same_mesh(got, ref)
        assert len(got.faces) == 12
    with pytest.raises(ValueError):
        pm.load_mesh(tmp_path / "box.ply")
    m = pm.concatenate([box, box.copy().apply_translation([1.0, 0, 0])])
    r = jm.concatenate([jm.box_mesh((0.1, 0.2, 0.3), (0.05, 0.0, 0.1)),
                        jm.box_mesh((0.1, 0.2, 0.3), (0.05, 0.0, 0.1)).apply_translation([1.0, 0, 0])])
    assert_same_mesh(m, r)
    np.testing.assert_array_equal(m.bounds, r.bounds)
    np.testing.assert_array_equal(m.face_normals, r.face_normals)
    assert m.area == r.area and not m.is_empty()
    for got, ref in zip(m.sample_surface(64, np.random.RandomState(2), return_normals=True),
                        r.sample_surface(64, np.random.RandomState(2), return_normals=True)):
        np.testing.assert_array_equal(got, ref)


def test_giga_planner_composed_scene_matches_jax():
    """GIGAPlanner(visualize=True).__call__ -> (grasps, scores, toc,
    composed) with the composed scene equal to the JAX planner's."""
    path = REPO / chip_smoke.CHECKPOINT
    tsdf = chip_smoke.make_scenes(1)
    port, ref = _meshes(chip_smoke.scene_objects(1)[0])
    got = GIGAPlanner(path, visualize=True, device="cpu", **chip_smoke.PLANNER_KW)(
        State(tsdf=tsdf), scene_mesh=port)
    expect = JGIGAPlanner(path, visualize=True, **chip_smoke.PLANNER_KW)(
        JState(tsdf=tsdf), scene_mesh=ref)
    assert len(got) == 4 and len(got[0]) == len(expect[0]) >= 1
    assert_same_mesh(got[3], expect[3], TOL_VERTEX)


def test_vgn_planner_composed_scene_matches_jax():
    jnet, params = jax_vgn_params()
    tsdf = chip_smoke.make_scenes(1)
    port, ref = _meshes(chip_smoke.scene_objects(1)[0])
    kw = dict(params=params, precision="highest", visualize=True, **chip_smoke.VGN_KW)
    got = VGNPlanner(device="cpu", **kw)(State(tsdf=tsdf), scene_mesh=port,
                                         aff_kwargs=dict(th=0.6))
    expect = JVGNPlanner(net=jnet, **kw)(JState(tsdf=tsdf), scene_mesh=ref,
                                         aff_kwargs=dict(th=0.6))
    assert len(got) == 4 and len(got[0]) == len(expect[0]) >= 1
    assert_same_mesh(got[3], expect[3], TOL_VERTEX)
