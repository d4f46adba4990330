"""TSDF fusion in the PyTorch port (ops/tsdf.py, core/perception.py) on the
CPU against the JAX package on the same depth images: tests/test_tsdf.py's
cases (plane views from tests/test_tsdf.py, box-and-sphere views ray-cast
by chip_smoke.render_depth at 160x120), the fused volumes within 1e-6 with
equal weights, surface points within 1e-6; then the slice as a whole:
depth images -> fused TSDFVolume -> GIGA and VGN plans, against the JAX
package's planners on its own fused volume.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from test_tsdf import INTR, RES, SIZE, overhead_camera, render_plane_depth
from test_torch_vgn import assert_same_grasps, jax_vgn_params
from giga_tpu.core import perception as jp
from giga_tpu.core.transform import Rotation as JRotation
from giga_tpu.core.transform import Transform as JTransform
from giga_tpu.inference.planner import GIGAPlanner as JGIGAPlanner
from giga_tpu.inference.planner import State as JState
from giga_tpu.inference.planner import VGNPlanner as JVGNPlanner
from giga_tpu.ops import tsdf as jt
from giga_tpu_torch.core import perception as pp
from giga_tpu_torch.core.transform import Rotation, Transform
from giga_tpu_torch.inference.planner import GIGAPlanner, State, VGNPlanner
from giga_tpu_torch.ops import tsdf as pt

TOL_TSDF = 1e-6
REPO = Path(__file__).resolve().parents[1]
PORT_INTR = pp.CameraIntrinsic(INTR.width, INTR.height, INTR.fx, INTR.fy, INTR.cx, INTR.cy)
SMALL_CAMERA = dict(width=INTR.width, height=INTR.height, fx=INTR.fx, fy=INTR.fy,
                    cx=INTR.cx, cy=INTR.cy)


def _port(extrinsic):
    """The port's Transform of a JAX-package Transform."""
    return Transform.from_matrix(extrinsic.as_matrix())


def _sphere_views(n=3, phis=(0.0, 2.0, 4.0)):
    origin = JTransform(JRotation.identity(), np.r_[SIZE / 2, SIZE / 2, 0.0])
    return [jp.camera_on_sphere(origin, 2 * SIZE, np.pi / 6, phi) for phi in phis[:n]]


def _scene_views(scene: int = 2):
    """chip_smoke scene ``scene`` seen from the simulator's 6 cameras, 160x120."""
    objects = chip_smoke.scene_objects(scene + 1)[scene]
    views = chip_smoke.camera_views()
    depth = np.stack([chip_smoke.render_depth(objects, e, **SMALL_CAMERA) for e in views])
    return depth, views


def assert_same_volume(got, ref):
    """(tsdf, weight) pairs: tsdf within TOL_TSDF, weights equal."""
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]), atol=TOL_TSDF, rtol=0)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))


def _volume(v):
    if isinstance(v, pp.TSDFVolume):
        return v.tsdf.numpy(), v.weight.numpy()
    return np.asarray(v._tsdf), np.asarray(v._weight)


def test_camera_on_sphere_matches_jax():
    origin = JTransform(JRotation.identity(), np.r_[SIZE / 2, SIZE / 2, 0.0])
    port_origin = Transform(Rotation.identity(), np.r_[SIZE / 2, SIZE / 2, 0.0])
    for phi in (0.0, 1.0, 4.0):
        np.testing.assert_array_equal(
            pp.camera_on_sphere(port_origin, 0.6, np.pi / 6, phi).as_matrix(),
            jp.camera_on_sphere(origin, 0.6, np.pi / 6, phi).as_matrix())
    assert pp.CameraIntrinsic.from_dict(PORT_INTR.to_dict()).to_dict() == INTR.to_dict()


def test_flat_plane_band_matches_jax():
    """tests/test_tsdf.py's top-down view of the z = 0.1 plane: ~1 above, ~0.5
    at the plane, 0 unobserved below; equal to the JAX volume."""
    extr = overhead_camera()
    depth = render_plane_depth(extr, plane_z=0.1)
    tsdf = pp.TSDFVolume(SIZE, RES, device="cpu")
    tsdf.integrate(depth, PORT_INTR, _port(extr))
    ref = jp.TSDFVolume(SIZE, RES)
    ref.integrate(depth, INTR, extr)
    assert_same_volume(_volume(tsdf), _volume(ref))
    grid = tsdf.get_grid()
    assert grid.shape == (1, RES, RES, RES) and grid.dtype == np.float32
    col = grid[0, RES // 2, RES // 2, :]
    k_plane = int(0.1 / tsdf.voxel_size - 0.5)
    assert col[k_plane + 6] > 0.95
    assert np.all(col[k_plane:k_plane + 2] > 0.2) and np.all(col[k_plane:k_plane + 2] < 0.8)
    assert col[max(k_plane - 6, 0)] == 0.0


def test_weight_accumulates_and_mean_stable():
    extr = overhead_camera()
    depth = render_plane_depth(extr, plane_z=0.1)
    tsdf, ref = pp.TSDFVolume(SIZE, RES, device="cpu"), jp.TSDFVolume(SIZE, RES)
    tsdf.integrate(depth, PORT_INTR, _port(extr))
    g1 = tsdf.get_grid().copy()
    for _ in range(2):
        ref.integrate(depth, INTR, extr)
    tsdf.integrate(depth, PORT_INTR, _port(extr))
    np.testing.assert_allclose(g1, tsdf.get_grid(), atol=1e-6)
    assert float(tsdf.weight.max()) == 2.0
    assert_same_volume(_volume(tsdf), _volume(ref))


@pytest.mark.parametrize("views", ["plane", "scene"])
def test_fuse_views_matches_sequential_and_jax(views):
    """fuse_views against create_tsdf (tests/test_tsdf.py's 1e-5) and each
    against its JAX counterpart (1e-6, equal weights), on three plane views
    and on six views of a box-and-sphere scene."""
    if views == "plane":
        extrs = _sphere_views()
        depth = np.stack([render_plane_depth(e, plane_z=0.05) for e in extrs])
    else:
        depth, extrs = _scene_views()
    lists = np.stack([e.to_list() for e in extrs])
    matrices = np.stack([e.as_matrix() for e in extrs]).astype(np.float32)
    K = np.asarray(INTR.K, np.float32)
    kw = dict(resolution=RES, size=SIZE, sdf_trunc=4 * SIZE / RES)
    fused = pt.fuse_views(torch.from_numpy(depth), torch.from_numpy(K),
                          torch.from_numpy(matrices), **kw)
    ref = jt.fuse_views(jnp.asarray(depth), jnp.asarray(K), jnp.asarray(matrices), **kw)
    assert_same_volume(fused, ref)
    seq = pp.create_tsdf(SIZE, RES, depth, PORT_INTR, lists, device="cpu")
    np.testing.assert_allclose(seq.get_grid()[0], fused[0].numpy(), atol=1e-5)
    assert_same_volume(_volume(seq), _volume(jp.create_tsdf(SIZE, RES, depth, INTR, lists)))
    assert float(fused[1].max()) == len(depth)
    # a continued fusion equals one over all the views
    half = pt.fuse_views(torch.from_numpy(depth[1:]), torch.from_numpy(K),
                         torch.from_numpy(matrices[1:]), **kw,
                         init=pt.integrate_tsdf(torch.zeros(RES, RES, RES),
                                                torch.zeros(RES, RES, RES),
                                                torch.from_numpy(depth[0]), torch.from_numpy(K),
                                                torch.from_numpy(matrices[0]), size=SIZE,
                                                sdf_trunc=4 * SIZE / RES))
    np.testing.assert_allclose(half[0].numpy(), fused[0].numpy(), atol=1e-5)


def test_surface_extraction_matches_jax():
    """tests/test_tsdf.py's 60^3 plane at z = 0.12: points hug the plane and
    equal JAX's within 1e-6."""
    extr = overhead_camera()
    depth = render_plane_depth(extr, plane_z=0.12)
    tsdf, ref = pp.TSDFVolume(SIZE, 60, device="cpu"), jp.TSDFVolume(SIZE, 60)
    tsdf.integrate(depth, PORT_INTR, _port(extr))
    ref.integrate(depth, INTR, extr)
    assert_same_volume(_volume(tsdf), _volume(ref))
    pts, expect = tsdf.get_cloud(), ref.get_cloud()
    assert len(pts) > 100 and pts.shape == expect.shape
    np.testing.assert_allclose(pts, expect, atol=1e-6, rtol=0)
    assert abs(np.median(pts[:, 2]) - 0.12) < 0.01
    pts_n, nrm = tsdf.get_cloud(with_normals=True)
    ref_n, ref_nrm = ref.get_cloud(with_normals=True)
    np.testing.assert_allclose(pts_n, ref_n, atol=1e-6, rtol=0)
    np.testing.assert_allclose(nrm, ref_nrm, atol=1e-6, rtol=0)


def test_depth_trunc_ignores_far_pixels():
    extr = overhead_camera(height=2.5)
    depth = render_plane_depth(extr, plane_z=0.0)
    tsdf = pp.TSDFVolume(SIZE, RES, device="cpu")
    tsdf.integrate(depth, PORT_INTR, _port(extr))
    assert np.all(tsdf.get_grid() == 0.0) and float(tsdf.weight.sum()) == 0.0


def test_boundary_normals_match_jax():
    """tests/test_tsdf.py::TestSurfaceNormals' half-observed slab: unit
    normals that point up, equal to JAX's."""
    R = 24
    z = (np.arange(R) + 0.5) / R
    tsdf = np.broadcast_to(np.clip((z[None, None, :] - 0.5) * 8 + 0.5, 0, 1),
                           (R, R, R)).astype(np.float32).copy()
    w = np.ones((R, R, R), np.float32)
    w[R // 2:] = 0.0
    tsdf[R // 2:] = 0.0
    pts, nrm = pt.extract_surface_points(tsdf, w, 0.3 / R, with_normals=True)
    ref_pts, ref_nrm = jt.extract_surface_points(tsdf, w, 0.3 / R, with_normals=True)
    np.testing.assert_array_equal(pts, ref_pts)
    np.testing.assert_array_equal(nrm, ref_nrm)
    assert len(pts) and (nrm[:, 2] > 0.9).all()
    empty = pt.extract_surface_points(np.ones((4, 4, 4)), np.zeros((4, 4, 4)), 0.1,
                                      with_normals=True)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def test_volume_without_card_raises(monkeypatch):
    """device=None means the card: with no CUDA device the volume raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pp.TSDFVolume(SIZE, RES)
    assert pp.TSDFVolume(SIZE, RES, device="cpu").tsdf.device.type == "cpu"


def test_plans_from_fused_volume_match_jax():
    """The slice as a whole: six views of a scene fused into each package's
    TSDFVolume, then GIGA (__call__ on the volume, plan_batch on its grid)
    and VGN (__call__, its grasps scaled by the volume's voxel size) plan
    from it: equal grasps."""
    depth, views = _scene_views(0)
    lists = np.stack([e.to_list() for e in views])
    vol = pp.create_tsdf(SIZE, RES, depth, PORT_INTR, lists, device="cpu")
    ref = jp.create_tsdf(SIZE, RES, depth, INTR, lists)
    assert_same_volume(_volume(vol), _volume(ref))
    path = REPO / chip_smoke.CHECKPOINT
    kw = dict(rng=np.random.RandomState(0), **chip_smoke.PLANNER_KW)
    giga, jgiga = GIGAPlanner(path, device="cpu", **kw), JGIGAPlanner(path, **kw)
    assert_same_grasps(giga(State(tsdf=vol)), jgiga(JState(tsdf=ref)))
    assert_same_grasps(giga.plan_batch(vol.get_grid())[0], jgiga.plan_batch(ref.get_grid())[0])
    jnet, params = jax_vgn_params()
    vgn = VGNPlanner(params=params, precision="highest", device="cpu", **chip_smoke.VGN_KW)
    jvgn = JVGNPlanner(net=jnet, params=params, precision="highest", **chip_smoke.VGN_KW)
    got, expect = vgn(State(tsdf=vol)), jvgn(JState(tsdf=ref))
    assert_same_grasps(got, expect)
    # a grid array plans the same, scaled by size / 40
    assert_same_grasps(vgn(State(tsdf=vol.get_grid())), got, tol=0.0)
