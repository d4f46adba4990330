"""The port's host geometry library against the JAX package's: the native
build (its own sources, its own directory, a failed build raises), the
marching, simplification, containment and raster kernels equal exactly, the
synthetic scenes, TSDFs, occupancy samples and grasp labels bit for bit,
the host refinement, and the evaluation metrics."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from giga_tpu.core.transform import Transform as JTransform
from giga_tpu.geometry import eval as jeval
from giga_tpu.geometry import native as jnative
from giga_tpu.geometry.mesh import TriMesh as JTriMesh
from giga_tpu.geometry.mesh import box_mesh as jbox
from giga_tpu.geometry.mesh import concatenate as jconcat
from giga_tpu.geometry.refine import _upsample_double as j_upsample_double
from giga_tpu.geometry.refine import refine_grid as j_refine_grid
from giga_tpu.utils import synthetic as jsyn
from giga_tpu.utils import synthetic_grasps as jgr
from giga_tpu_torch.core.transform import Transform
from giga_tpu_torch.geometry import eval as teval
from giga_tpu_torch.geometry import native
from giga_tpu_torch.geometry.generation import upsample_double
from giga_tpu_torch.geometry.mesh import TriMesh, box_mesh, concatenate
from giga_tpu_torch.geometry.refine import _upsample_double, refine_grid
from giga_tpu_torch.utils import synthetic as syn
from giga_tpu_torch.utils import synthetic_grasps as gr

REPO = Path(__file__).resolve().parents[1]


def _sphere_grid(n=33, r=12.0):
    lin = np.arange(n, dtype=np.float64)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    c = (n - 1) / 2.0
    return r - np.sqrt((X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2)


def _noisy_grid(seed=0, n=17):
    """A smooth field with several components and saddles."""
    rng = np.random.RandomState(seed)
    g = _sphere_grid(n, 5.0) + rng.randn(n, n, n) * 0.8
    return g


def _active(grid, iso):
    n = grid.shape[0]
    ins = grid > iso
    s = sum(ins[dx:n - 1 + dx, dy:n - 1 + dy, dz:n - 1 + dz].astype(int)
            for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))
    idx = np.flatnonzero((s > 0) & (s < 8))
    xs, ys, zs = np.unravel_index(idx, (n - 1,) * 3)
    corner = np.stack([grid[xs + (ci & 1), ys + ((ci >> 1) & 1), zs + ((ci >> 2) & 1)]
                       for ci in range(8)], axis=1)
    return idx, corner


def _scene(seed):
    return syn.random_scene(np.random.RandomState(seed), 0.3), \
        jsyn.random_scene(np.random.RandomState(seed), 0.3)


def _assert_mesh_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


# ------------------------------------------------------------------ the build

def test_library_is_the_ports_own():
    """The library is built from the port's copy of the sources (equal to
    the JAX package's) into build/giga_tpu_torch, named by their hash."""
    native.get_lib()
    path = native.library_path()
    assert path.exists() and path.parent == REPO / "build" / "giga_tpu_torch"
    assert path.name.startswith("libgeometry-")
    for name in native.SOURCES:
        assert ((REPO / "giga_tpu_torch/geometry/csrc" / f"{name}.cpp").read_bytes()
                == (REPO / "giga_tpu/geometry/csrc" / f"{name}.cpp").read_bytes())
    assert native.CXX_FLAGS == ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def test_import_builds_nothing_and_never_loads_jax_library():
    """Importing the port's geometry modules starts no compiler; using them
    loads the port's library and never giga_tpu/geometry/_native.so."""
    code = (
        "import subprocess, sys\n"
        "sys.modules['giga_tpu'] = None\n"
        "import numpy.testing, scipy.ndimage, scipy.spatial, torch  # their own probes\n"
        "run, popen = subprocess.run, subprocess.Popen\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process was started at import')\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "import giga_tpu_torch.geometry.native as n\n"
        "import giga_tpu_torch.geometry.generation, giga_tpu_torch.geometry.eval\n"
        "import giga_tpu_torch.utils.synthetic, giga_tpu_torch.utils.synthetic_grasps\n"
        "import giga_tpu_torch.train.corpus\n"
        "subprocess.run, subprocess.Popen = run, popen\n"
        "assert n._lib is None\n"
        "from giga_tpu_torch.geometry.mesh import box_mesh\n"
        "import numpy as np\n"
        "assert n.check_mesh_contains(box_mesh([1, 1, 1]), np.array([[0.1, 0.2, 0.05]])).all()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'giga_tpu/geometry/_native.so' not in maps, 'the JAX library'\n"
        "assert str(n.library_path()) in maps, 'the port library'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s error, and nothing
    is loaded in its place."""
    csrc = tmp_path / "csrc"
    shutil.copytree(native.CSRC, csrc)
    (csrc / "marching.cpp").write_text((csrc / "marching.cpp").read_text() + "\nnot c++;\n")
    monkeypatch.setattr(native, "CSRC", csrc)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error: expected"):
        native.get_lib()
    assert native._lib is None
    assert not list((tmp_path / "build").glob("*.so"))
    with pytest.raises(RuntimeError):
        native.check_mesh_contains(box_mesh([1, 1, 1]), np.zeros((1, 3)))


# ------------------------------------------------------------ the kernels

@pytest.mark.parametrize("grid", ["sphere", "noisy"])
def test_marching_matches_jax(grid):
    g = _sphere_grid() if grid == "sphere" else _noisy_grid()
    _assert_mesh_equal(native.marching_tetrahedra(g, 0.0), jnative.marching_tetrahedra(g, 0.0))
    idx, corner = _active(g, 0.0)
    got = native.marching_tetrahedra_cells(idx, corner, g.shape, 0.0)
    _assert_mesh_equal(got, jnative.marching_tetrahedra_cells(idx, corner, g.shape, 0.0))
    assert len(got[1]) > 0
    empty = native.marching_tetrahedra_cells(np.zeros(0, np.int64), np.zeros((0, 8)), (8,) * 3, 0)
    assert len(empty[0]) == len(empty[1]) == 0


def test_simplify_matches_jax():
    v, f = native.marching_tetrahedra(_sphere_grid(), 0.0)
    for target in (500, 2000):
        got = native.simplify_mesh(TriMesh(v, f), target)
        _assert_mesh_equal(got, jnative.simplify_mesh(JTriMesh(v, f), target))
        assert len(got[1]) <= len(f)


@pytest.mark.parametrize("seed", [0, 1])
def test_containment_matches_jax_and_plain(seed):
    mesh, jmesh = _scene(seed)
    pts = np.random.RandomState(seed).uniform(-0.02, 0.32, (20000, 3))
    got = native.check_mesh_contains(mesh, pts)
    np.testing.assert_array_equal(got, jnative.check_mesh_contains(jmesh, pts))
    assert 0 < got.sum() < len(got)
    few = pts[:1500]
    np.testing.assert_array_equal(
        native.contains_plain(mesh.vertices, mesh.faces, few), got[:1500])
    np.testing.assert_array_equal(native.contains_plain(mesh.vertices, mesh.faces, few),
                                  jnative._contains_numpy(jmesh.vertices, jmesh.faces, few))
    assert not native.check_mesh_contains(TriMesh(np.zeros((0, 3)), np.zeros((0, 3))), pts).any()


def test_raster_matches_jax_and_plain():
    mesh = concatenate([box_mesh([0.4, 0.3, 0.2], (0.0, 0.0, 1.5)),
                        box_mesh([0.2, 0.2, 0.2], (0.2, 0.1, 1.2))])
    colors = np.tile(np.array([[200, 30, 30, 255], [30, 200, 30, 128]], np.uint8), (12, 1))
    args = (mesh.vertices, mesh.faces, colors, 60.0, 60.0, 32.0, 24.0, 64, 48)
    img = native.raster_mesh(*args, (255, 255, 255))
    np.testing.assert_array_equal(img, jnative.raster_mesh(*args, (255, 255, 255)))
    assert (img != 255).any()
    bg = np.full((48, 64, 3), 255, np.uint8)
    light = np.array([0.0, 0.0, 1.0])
    plain = native.raster_plain(*args, bg.copy(), 0.35, 1e-4, light)
    np.testing.assert_array_equal(plain, jnative._raster_numpy(*args, bg.copy(), 0.35, 1e-4,
                                                               light))
    assert np.abs(plain.astype(int) - img.astype(int)).max() <= 1


# --------------------------------------------------- synthetic scenes and grasps

@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_scene_tsdf_and_samples_match_jax(seed):
    r, jr = np.random.RandomState(seed), np.random.RandomState(seed)
    mesh, jmesh = syn.random_scene(r, 0.3), jsyn.random_scene(jr, 0.3)
    np.testing.assert_array_equal(mesh.vertices, jmesh.vertices)
    np.testing.assert_array_equal(mesh.faces, jmesh.faces)
    tsdf = syn.mesh_to_tsdf(mesh, 0.3, 40, rng=r)
    jtsdf = jsyn.mesh_to_tsdf(jmesh, 0.3, 40, rng=jr)
    assert tsdf.dtype == jtsdf.dtype == np.float32
    np.testing.assert_array_equal(tsdf, jtsdf)
    pts, occ = syn.make_occ_samples(mesh, 0.3, 5000, r)
    jpts, jocc = jsyn.make_occ_samples(jmesh, 0.3, 5000, jr)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(occ, jocc)
    assert 0 < occ.sum() < len(occ) and 0 < (tsdf < 0.5).mean() < 0.5
    ico, jico = syn.icosphere(0.1, [0.1, 0.2, 0.3], 2), jsyn.icosphere(0.1, [0.1, 0.2, 0.3], 2)
    np.testing.assert_array_equal(ico.vertices, jico.vertices)
    np.testing.assert_array_equal(ico.faces, jico.faces)


def test_grasp_oracle_matches_jax():
    mesh, jmesh = _scene(2)
    r, jr = np.random.RandomState(7), np.random.RandomState(7)
    for normal, yaw in (([0.0, 0.0, 1.0], 0.3), ([0.3, -0.2, 0.9], 2.0), ([1.0, 0.0, 0.0], 1.0)):
        np.testing.assert_array_equal(gr.grasp_frame(np.array(normal), yaw).as_matrix(),
                                      jgr.grasp_frame(np.array(normal), yaw).as_matrix())
    surf, _ = mesh.sample_surface(5000, rng=r)
    jsurf, _ = jmesh.sample_surface(5000, rng=jr)
    for pos in ([0.15, 0.15, 0.1], [0.1, 0.2, 0.05]):
        pose = Transform(gr.grasp_frame(np.r_[0.0, 0.0, 1.0], 0.5), np.array(pos))
        jpose = JTransform(jgr.grasp_frame(np.r_[0.0, 0.0, 1.0], 0.5), np.array(pos))
        assert gr.evaluate_grasp(mesh, surf, pose, r) == jgr.evaluate_grasp(jmesh, jsurf, jpose,
                                                                            jr)
    got = gr.sample_labeled_grasps(mesh, 0.3, 12, r, n_surface=5000)
    ref = jgr.sample_labeled_grasps(jmesh, 0.3, 12, jr, n_surface=5000)
    a, b = gr.grasps_to_batch_arrays(got, 0.3), jgr.grasps_to_batch_arrays(ref, 0.3)
    assert a.keys() == b.keys() and len(a["label"]) == 12
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------ host refinement

def _field(frac):
    """An analytic occupancy logit: two spheres of the unit cube."""
    p = np.asarray(frac, np.float64)
    a = 0.3 - np.linalg.norm(p - [0.35, 0.4, 0.45], axis=-1)
    b = 0.2 - np.linalg.norm(p - [0.7, 0.65, 0.6], axis=-1)
    return (np.maximum(a, b) * 20).astype(np.float32)


@pytest.mark.parametrize("res0,steps", [(8, 1), (8, 2), (16, 1)])
def test_refine_grid_matches_jax(res0, steps):
    calls, jcalls = [], []
    got = refine_grid(lambda p: calls.append(len(p)) or _field(p), res0, steps, 0.0)
    ref = j_refine_grid(lambda p: jcalls.append(len(p)) or _field(p), res0, steps, 0.0)
    np.testing.assert_array_equal(got, ref)
    assert calls == jcalls and len(calls) == steps + 1
    assert got.shape == (res0 * 2**steps + 1,) * 3


def test_upsample_double_matches_host():
    """The device refine chain's upsample (torch, any dtype) gives the host
    path's values bit for bit in float64."""
    g = np.random.RandomState(0).randn(5, 5, 5)
    np.testing.assert_array_equal(_upsample_double(g), j_upsample_double(g))
    np.testing.assert_array_equal(upsample_double(torch.from_numpy(g)).numpy(),
                                  _upsample_double(g))


# ------------------------------------------------------------------ evaluation

def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    a, b = rng.rand(2, 300) > 0.5
    assert teval.compute_iou(a, b) == jeval.compute_iou(a, b)
    src, tgt = rng.rand(200, 3), rng.rand(300, 3)
    ns, nt = rng.randn(200, 3), rng.randn(300, 3)
    for got, ref in zip(teval.distance_p2p(src, ns, tgt, nt), jeval.distance_p2p(src, ns, tgt, nt)):
        np.testing.assert_array_equal(got, ref)
    d = rng.rand(500)
    th = np.linspace(0.001, 1, 1000)
    assert teval.get_threshold_percentage(d, th) == jeval.get_threshold_percentage(d, th)


def test_mesh_evaluator_matches_jax():
    """MeshEvaluator.eval_mesh (and eval_occ) of a mesh against a scene's
    ground truth, both seeded alike: every metric within 1e-6."""
    mesh, jmesh = _scene(4)
    pred = concatenate([box_mesh([0.1, 0.1, 0.1], (0.15, 0.15, 0.06)), mesh])
    jpred = jconcat([jbox([0.1, 0.1, 0.1], (0.15, 0.15, 0.06)), jmesh])
    rng = np.random.RandomState(1)
    pc, fi = mesh.sample_surface(3000, rng=rng)
    normals = mesh.face_normals[fi]
    pts = rng.uniform(0, 0.3, (4000, 3))
    occ = native.check_mesh_contains(mesh, pts)
    got = teval.MeshEvaluator(3000, rng=np.random.RandomState(2)).eval_mesh(
        pred, pc, normals, pts, occ)
    ref = jeval.MeshEvaluator(3000, rng=np.random.RandomState(2)).eval_mesh(
        jpred, pc, normals, pts, occ)
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k
    assert 0 < got["iou"] < 1
    empty = teval.MeshEvaluator(100).eval_mesh(TriMesh(np.zeros((0, 3)), np.zeros((0, 3))), pc,
                                               normals, pts, occ)
    assert empty["iou"] == 0.0 and empty.keys() == got.keys() | {"empty"}
    occ_got = teval.MeshEvaluator(10).eval_occ(pred, pts, occ)
    assert occ_got == jeval.MeshEvaluator(10).eval_occ(jpred, pts, occ)

