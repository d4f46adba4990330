"""Geometry evaluation on dataset scenes in the port (geometry/voxelize.py,
voxelgrid.py, icp.py, datasets.py; utils/urdf.py, implicit.py; sim/noise.py;
scripts/eval_geometry.py) against the JAX package's on the CPU, on its own
tests' cases (tests/test_voxelize.py, test_voxelgrid.py, test_icp.py,
test_eval_geometry_script.py).

Voxel grids and binvox bytes are held equal, ICP transforms within 1e-6,
dataset items equal, and eval_geometry's JSON within 1e-6 on IoU and 1e-5
on the other metrics (the distances within 1.3e-7 in fact; normal accuracy,
a mean of |n . n'| over sampled surface normals, within 7.3e-6).

``giga_tpu_torch/testdata/golden_eval_geometry.json`` holds the JAX
script's JSON on chip_smoke's fixture (``chip_smoke.geoeval_fixture``) with
the shipped GIGA-Geo checkpoint, with and without ``--roi``, at ``--batch``
1 and 2; chip_smoke.py's phase 33 holds the card against it. Rewrite it with

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write geoeval
"""

import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
for p in (REPO, REPO / "scripts"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import chip_smoke  # noqa: E402
from giga_tpu.core.transform import Rotation as JRotation  # noqa: E402
from giga_tpu.geometry import icp as jicp  # noqa: E402
from giga_tpu.geometry import voxelgrid as jvg  # noqa: E402
from giga_tpu.geometry import voxelize as jvox  # noqa: E402
from giga_tpu.geometry.mesh import TriMesh as JTriMesh  # noqa: E402
from giga_tpu.sim import noise as jnoise  # noqa: E402
from giga_tpu.utils import implicit as jimp  # noqa: E402
from giga_tpu.utils import urdf as jurdf  # noqa: E402
from giga_tpu.utils.synthetic import icosphere as jicosphere  # noqa: E402
from giga_tpu_torch.geometry import datasets as tds  # noqa: E402
from giga_tpu_torch.geometry import icp as ticp  # noqa: E402
from giga_tpu_torch.geometry import voxelgrid as tvg  # noqa: E402
from giga_tpu_torch.geometry import voxelize as tvox  # noqa: E402
from giga_tpu_torch.geometry.mesh import TriMesh, box_mesh  # noqa: E402
from giga_tpu_torch.sim import noise as tnoise  # noqa: E402
from giga_tpu_torch.utils import implicit as timp  # noqa: E402
from giga_tpu_torch.utils import urdf as turdf  # noqa: E402
from giga_tpu_torch.utils.synthetic import icosphere  # noqa: E402

GEOEVAL_CASES = ((False, 1), (False, 2), (True, 1), (True, 2))
TOL_IOU = 1e-6
TOL_METRIC = 1e-5


def _both(mesh: TriMesh):
    return mesh, JTriMesh(mesh.vertices.copy(), mesh.faces.copy())


def _box(half=0.3):
    """tests/test_voxelgrid.py's box."""
    corners = np.array([[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], float)
    quads = [(0, 4, 6, 2), (1, 3, 7, 5), (0, 1, 5, 4), (2, 6, 7, 3), (0, 2, 3, 1), (4, 5, 7, 6)]
    faces = [[q[0], q[1], q[2]] for q in quads] + [[q[0], q[2], q[3]] for q in quads]
    return TriMesh((corners * 2 - 1) * half, np.asarray(faces))


@pytest.mark.parametrize("res", [16, 24])
def test_voxelize_equals_jax(res):
    """tests/test_voxelize.py's solid box, the icosphere's exact surface, and
    the sampled surface with the same draws."""
    b = (np.zeros(3), np.ones(3))
    box, jbox = _both(box_mesh([0.5, 0.5, 0.5], center=(0.5, 0.5, 0.5)))
    np.testing.assert_array_equal(tvox.voxelize_solid(box, res, bounds=b),
                                  jvox.voxelize_solid(jbox, res, bounds=b))
    np.testing.assert_array_equal(tvox.voxelize_surface(box, res, bounds=b),
                                  jvox.voxelize_surface(jbox, res, bounds=b))
    sphere = icosphere(0.35, [0.5, 0.5, 0.5], 2)
    jsphere = jicosphere(0.35, [0.5, 0.5, 0.5], 2)
    exact = tvox.voxelize_surface(sphere, res, bounds=b)
    np.testing.assert_array_equal(exact, jvox.voxelize_surface(jsphere, res, bounds=b))
    sampled = tvox.voxelize_surface_sampled(sphere, res, bounds=b, rng=np.random.RandomState(0))
    np.testing.assert_array_equal(sampled, jvox._voxelize_surface_sampled(
        jsphere, res, bounds=b, rng=np.random.RandomState(0)))
    assert (~exact & sampled).sum() == 0 and exact.sum() >= sampled.sum() > 0
    assert not tvox.voxelize_surface(TriMesh(np.zeros((0, 3)), np.zeros((0, 3), int)), 4).any()


@pytest.mark.parametrize("method", ["solid", "surface"])
def test_voxelgrid_equals_jax(method):
    """from_mesh (given and padded boxes), contains, down_sample, to_mesh."""
    mesh, jmesh = _both(_box())
    for kw in (dict(loc=(0, 0, 0), scale=1.0), {}):
        g = tvg.VoxelGrid.from_mesh(mesh, 16, method=method, **kw)
        jg = jvg.VoxelGrid.from_mesh(jmesh, 16, method=method, **kw)
        np.testing.assert_array_equal(g.data, jg.data)
        np.testing.assert_array_equal(g.loc, jg.loc)
        assert g.scale == jg.scale
    pts = np.random.RandomState(0).uniform(-0.6, 0.6, (500, 3))
    np.testing.assert_array_equal(g.contains(pts), jg.contains(pts))
    np.testing.assert_array_equal(g.down_sample(2).data, jg.down_sample(2).data)
    m, jm = g.to_mesh(), jg.to_mesh()
    np.testing.assert_array_equal(m.faces, jm.faces)
    np.testing.assert_array_equal(m.vertices, jm.vertices)


def test_binvox_bytes_equal_jax():
    """tests/test_voxelgrid.py's grids (random, all empty with runs past 255):
    the port writes JAX's bytes, and each package reads the other's."""
    rng = np.random.RandomState(3)
    for data, loc, scale in ((rng.rand(8, 8, 8) > 0.5, (0.1, -0.2, 0.3), 2.5),
                             (np.zeros((16, 16, 16), bool), (0.0, 0.0, 0.0), 1.0),
                             (rng.rand(12, 12, 12) > 0.9, (1.5, 0.25, -3.0), 0.75)):
        bufs = []
        for m in (tvg, jvg):
            buf = io.BytesIO()
            m.write_binvox(m.VoxelGrid(data, loc, scale), buf)
            bufs.append(buf.getvalue())
        assert bufs[0] == bufs[1]
        got, ref = tvg.read_binvox(io.BytesIO(bufs[1])), jvg.read_binvox(io.BytesIO(bufs[0]))
        np.testing.assert_array_equal(got.data, ref.data)
        np.testing.assert_array_equal(got.loc, ref.loc)
        assert got.scale == ref.scale


@pytest.mark.parametrize("with_scale", [False, True])
def test_icp_equals_jax(with_scale):
    """tests/test_icp.py's cases: the exact fit and ICP from a small
    perturbation (scaled too)."""
    rng = np.random.RandomState(0)
    src = rng.randn(200, 3)
    R = JRotation.from_rotvec([0.1, -0.2, 0.3]).as_matrix()
    dst = (src @ R.T + np.array([0.5, -0.2, 1.0])) * (1.3 if with_scale else 1.0)
    for got, ref in zip(ticp.best_fit_transform(src, dst, with_scale),
                        jicp.best_fit_transform(src, dst, with_scale)):
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    rng = np.random.RandomState(1)
    dst = rng.rand(500, 3)
    R = JRotation.from_rotvec([0.02, 0.03, -0.02]).as_matrix()
    src = (dst - np.array([0.01, -0.02, 0.015])) @ R
    (T, err, it), (jT, jerr, jit) = ticp.icp(src, dst), jicp.icp(src, dst)
    np.testing.assert_allclose(T, jT, atol=1e-6, rtol=0)
    assert abs(err - jerr) <= 1e-6 and it == jit and err < 1e-3


def test_urdf_meshes_equal_jax(tmp_path):
    """The fixtures' single-link URDFs, and one with a scale and an origin."""
    urdfs = sorted((REPO / "tests" / "fixtures" / "urdfs").glob("[bcs]*/*.urdf"))
    (tmp_path / "m.urdf").write_text(
        '<robot name="m"><link name="base"><visual><origin xyz="0.1 0 -0.2" rpy="0.3 0 0.5"/>'
        f'<geometry><mesh filename="{urdfs[0].with_suffix(".obj")}" scale="1 2 0.5"/>'
        '</geometry></visual></link></robot>')
    for path in urdfs + [tmp_path / "m.urdf"]:
        got, ref = turdf.load_urdf_mesh(path), jurdf.load_urdf_mesh(path)
        np.testing.assert_array_equal(got.faces, ref.faces)
        np.testing.assert_allclose(got.vertices, ref.vertices, atol=1e-12, rtol=0)
    with pytest.raises(ValueError, match="links"):
        turdf.load_urdf_mesh(REPO / "tests" / "fixtures" / "urdfs" / "panda" / "hand.urdf")


class _World:
    """What the world readers use of a BtWorld: bodies with a pose and a
    scale, and the client's body info and visual shapes."""

    class _Body:
        def __init__(self, pose, scale):
            self.pose, self.scale = pose, scale

        def get_pose(self):
            return self.pose

    def __init__(self, bodies):
        self.bodies = {uid: self._Body(pose, scale) for uid, (_, _, pose, scale) in
                       enumerate(bodies)}
        self.p = self
        self._info = bodies

    def getBodyInfo(self, uid):  # noqa: N802 (the client's name)
        return (b"base", self._info[uid][0].encode())

    def getVisualShapeData(self, uid):  # noqa: N802
        return [(uid, -1, 5, (1, 1, 1), self._info[uid][1].encode())]


def test_implicit_equals_jax(tmp_path):
    """Mesh-pose lists from a world (the plane skipped, a body without a mesh
    path found by name), scenes from them, and sampled labelled points."""
    from giga_tpu_torch.core.transform import Rotation, Transform

    urdfs = REPO / "tests" / "fixtures" / "urdfs"
    bodies = [("plane", str(urdfs / "setup" / "plane.obj"), Transform.identity(), 1.0),
              ("cube", str(urdfs / "blocks" / "cube.urdf"),
               Transform(Rotation.from_rotvec([0, 0, 0.4]), [0.1, 0.12, 0.05]), 0.8),
              ("bar", str(urdfs / "blocks" / "bar.obj"),
               Transform(Rotation.identity(), [0.2, 0.1, 0.03]), 1.0)]
    world = _World(bodies)
    mpl, jmpl = (m.get_mesh_pose_list_from_world(world, "blocks") for m in (timp, jimp))
    assert [(a, s) for a, s, _ in mpl] == [(a, s) for a, s, _ in jmpl] and len(mpl) == 2
    scene, meshes = timp.get_scene_from_mesh_pose_list(mpl, return_list=True)
    jscene, jmeshes = jimp.get_scene_from_mesh_pose_list(jmpl, return_list=True)
    np.testing.assert_array_equal(scene.vertices, jscene.vertices)
    np.testing.assert_array_equal(scene.faces, jscene.faces)
    for uniform in (False, True):
        got = timp.sample_iou_points(meshes, scene.bounds, 3000, uniform=uniform,
                                     rng=np.random.RandomState(4))
        ref = jimp.sample_iou_points(jmeshes, jscene.bounds, 3000, uniform=uniform,
                                     rng=np.random.RandomState(4))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        assert uniform or 0 < got[1].sum() < 3000
    assert timp.as_mesh(meshes).faces.shape == scene.faces.shape


@pytest.mark.parametrize("kind", ["dex", "trans", "norm", None])
def test_depth_noise_equals_jax(kind):
    """set_random_seed, then each noise model on a depth image: the same
    draws and the same image."""
    img = np.random.RandomState(2).uniform(0.3, 0.7, (48, 64))
    out = []
    for m in (tnoise, jnoise):
        for seed in (0, 1):  # seed 1 takes the dex model's GP branch
            m.set_random_seed(seed)
            out.append(m.apply_noise(img, kind))
    for a, b in zip(out[:2], out[2:]):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    return chip_smoke.geoeval_fixture(tmp_path_factory.mktemp("geoeval"))


def test_fixture_equals_jax_fixture(fixture_dirs, tmp_path):
    """chip_smoke's fixture, built by the port, holds what the JAX test's
    _make_fixture writes."""
    from test_eval_geometry_script import _make_fixture

    jroot, jraw = _make_fixture(tmp_path)
    root, raw = fixture_dirs
    for sid in ("s0", "s1"):
        np.testing.assert_array_equal(np.load(root / "scenes" / f"{sid}.npz")["grid"],
                                      np.load(jroot / "scenes" / f"{sid}.npz")["grid"])
        a = np.load(raw / "mesh_pose_list" / f"{sid}.npz", allow_pickle=True)["pc"]
        b = np.load(jraw / "mesh_pose_list" / f"{sid}.npz", allow_pickle=True)["pc"]
        np.testing.assert_array_equal(a[0][2], b[0][2])
    assert (raw / "grasps.csv").read_text() == (jraw / "grasps.csv").read_text()
    assert json.loads((raw / "setup.json").read_text()) == json.loads(
        (jraw / "setup.json").read_text())


@pytest.mark.parametrize("roi", [False, True])
def test_dataset_items_equal_jax(fixture_dirs, roi):
    from giga_tpu.geometry import datasets as jds

    root, raw = fixture_dirs
    name = "GeometryEvalDatasetROI" if roi else "GeometryEvalDataset"
    ds = getattr(tds, name)(root, raw, num_point_occ=500, rng=np.random.RandomState(0))
    jds_ = getattr(jds, name)(root, raw, num_point_occ=500, rng=np.random.RandomState(0))
    assert len(ds) == len(jds_) == 2 and ds.scene_list == jds_.scene_list
    for i in range(len(ds)):
        for a, b in zip(ds[i][:-1], jds_[i][:-1]):
            np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
        np.testing.assert_array_equal(ds[i][-1].faces, jds_[i][-1].faces)
    assert ds[0][2].dtype == bool and ds[0][2].sum() > 0


def golden_geoeval(tmp: Path) -> dict:
    """The JAX script's results on chip_smoke's fixture for GEOEVAL_CASES."""
    import eval_geometry

    proc, raw = chip_smoke.geoeval_fixture(tmp / "fixture")
    out = {}
    for roi, batch in GEOEVAL_CASES:
        logdir = tmp / f"jax_{roi}_{batch}"
        eval_geometry.main(chip_smoke.geoeval_args(proc, raw, logdir, roi, batch))
        out[f"roi={roi},batch={batch}"] = chip_smoke.geoeval_results(next(logdir.iterdir()))
    return out


@pytest.mark.parametrize("roi,batch", [(False, 2), (True, 1)])
def test_eval_geometry_json_equals_jax(fixture_dirs, tmp_path, roi, batch):
    """The port's script (device="cpu") against the golden JSON of the JAX
    script, and (with --roi) against the JAX script run here, which must
    equal the golden. Two of the golden's four flag sets run here, to keep
    Tier-1 short (each run evaluates 100,000 surface samples a mesh);
    chip_smoke.py's phase 33 holds the card against all four."""
    from giga_tpu_torch.scripts.eval_geometry import main

    root, raw = fixture_dirs
    golden = json.loads((REPO / chip_smoke.GOLDEN_GEOEVAL).read_text())[
        f"roi={roi},batch={batch}"]
    logdir = main(chip_smoke.geoeval_args(root, raw, tmp_path / "port", roi, batch,
                                          device="cpu"))
    got = chip_smoke.geoeval_results(logdir)
    assert len(got["scenes"]) == 2 and got["mean"]["iou"] > 0.5
    chip_smoke.compare_geoeval(got, golden, "port vs golden", TOL_METRIC, TOL_IOU)
    for i in range(2):
        assert (logdir / f"{i:05d}" / "pred_mesh.obj").exists()
    if (roi, batch) == (True, 1):
        import eval_geometry

        eval_geometry.main(chip_smoke.geoeval_args(root, raw, tmp_path / "jax", roi, batch))
        ref = chip_smoke.geoeval_results(next((tmp_path / "jax").iterdir()))
        chip_smoke.compare_geoeval(got, ref, "port vs JAX", TOL_METRIC, TOL_IOU)
        chip_smoke.compare_geoeval(ref, golden, "JAX vs golden", 1e-6)
