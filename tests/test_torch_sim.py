"""The port's simulator (sim/btsim.py, sim/simulation.py, utils/saver.py)
and the sensor-data functions of core/io.py against the JAX package's, on
the CPU, each package under its own copy of the kinematic pybullet double
(tests/torch_sim.py): the same seeds on the fixture world give the same
scenes, renders, fused volumes, snapshots and grasp outcomes."""

import pickle
import re
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from torch_sim import SIM_URDF_ROOT, double, one_torch_thread  # noqa: E402,F401

TOL_POSE = 1e-12
TOL_TSDF = 1e-6


def make_sim(package, scene="pile", seed=7, object_set="blocks", **kw):
    if package == "jax":
        from giga_tpu.sim.simulation import ClutterRemovalSim
    else:
        from giga_tpu_torch.sim.simulation import ClutterRemovalSim

        kw.setdefault("device", "cpu")
    return ClutterRemovalSim(scene, object_set, seed=seed, urdf_root=str(SIM_URDF_ROOT), **kw)


def world_state(sim) -> dict:
    """{uid: (name, translation, quaternion, contacts)} of every body."""
    out = {}
    for uid, body in sim.world.bodies.items():
        pose = body.get_pose()
        contacts = sorted((c.bodyA.uid, c.bodyB.uid, c.depth, c.force)
                          for c in sim.world.get_contacts(body))
        out[uid] = (body.name, pose.translation.copy(), pose.rotation.as_quat(), contacts)
    return out


def assert_same_world(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for uid in ref:
        assert got[uid][0] == ref[uid][0]
        np.testing.assert_allclose(got[uid][1], ref[uid][1], atol=TOL_POSE, rtol=0)
        np.testing.assert_allclose(got[uid][2], ref[uid][2], atol=TOL_POSE, rtol=0)
        assert got[uid][3] == ref[uid][3]


def test_fake_pybullet_copy_is_current():
    """tests/torch_fake_pybullet.py is tests/fake_pybullet.py with every
    ``giga_tpu.`` read as ``giga_tpu_torch.`` (its Rotation, Transform and
    mesh loader come from the port), so the two doubles cannot drift."""
    ref = (REPO / "tests" / "fake_pybullet.py").read_text()
    got = (REPO / "tests" / "torch_fake_pybullet.py").read_text()
    assert got == re.sub(r"\bgiga_tpu\.", "giga_tpu_torch.", ref)
    assert "from giga_tpu_torch.core.transform import Rotation, Transform" in got


@pytest.mark.parametrize("scene", ["pile", "packed"])
def test_scene_generation_save_restore_and_contacts_match_jax(scene):
    """reset(5) on one seed: the same bodies at the same poses (1e-12) with
    the same contacts; then save, move every body, restore: both worlds
    back at their saved state."""
    states = {}
    for package in ("jax", "torch"):
        with double(package):
            sim = make_sim(package, scene, seed=0)
            sim.reset(5)
            before = world_state(sim)
            sim.save_state()
            moved = type(next(iter(sim.world.bodies.values())).get_pose())
            for b in sim.world.bodies.values():
                b.set_pose(moved(b.get_pose().rotation, [0.9, 0.9, 0.9]))
            sim.restore_state()
            states[package] = before, world_state(sim), sim.num_objects
    (jax_before, jax_after, jax_n), (got_before, got_after, got_n) = states["jax"], states["torch"]
    assert got_n == jax_n >= 1
    assert_same_world(got_before, jax_before)
    assert_same_world(got_after, jax_after)
    assert_same_world(got_after, got_before)


def test_camera_projection_and_render_match_jax():
    """projection_matrix and BtCamera.render (rgb and metric depth) equal
    JAX's bit for bit: the same double renders both."""
    from giga_tpu.sim import btsim as jbtsim
    from giga_tpu_torch.sim import btsim

    renders = {}
    for package in ("jax", "torch"):
        with double(package):
            sim = make_sim(package, "pile", seed=2)
            sim.reset(3)
            mod = jbtsim if package == "jax" else btsim
            cam = sim.camera
            np.testing.assert_array_equal(cam.proj_matrix,
                                          mod.projection_matrix(cam.intrinsic, cam.near, cam.far))
            ext = type(sim.world.bodies[0].get_pose()).look_at(
                np.r_[0.6, 0.1, 0.5], np.r_[0.15, 0.15, 0.05], np.r_[0.0, 0.0, 1.0])
            renders[package] = cam.proj_matrix, cam.render(ext)
    np.testing.assert_array_equal(renders["torch"][0], renders["jax"][0])
    for got, ref in zip(renders["torch"][1], renders["jax"][1]):
        np.testing.assert_array_equal(got, ref)
    assert (renders["torch"][1][1] < 2.0).any()  # the scene is in view


@pytest.mark.parametrize("case", ["40", "120", "sideview"])
def test_acquire_tsdf_matches_jax(case):
    """acquire_tsdf on the same scene: the grid within 1e-6, the weights
    equal, the workspace cloud equal (the 120^3 fusion bit for bit, as XLA
    rounds it: ops/tsdf.py's FMA_Z_RESOLUTION)."""
    kw = dict(scene="packed", seed=3, sideview=True) if case == "sideview" else dict(seed=11)
    acq = dict(n=1) if case == "sideview" else dict(n=2, N=3, resolution=int(case))
    out = {}
    for package in ("jax", "torch"):
        with double(package):
            sim = make_sim(package, **kw)
            sim.reset(3)
            tsdf, pc, timing = sim.acquire_tsdf(**acq)
            weight = tsdf.weight.numpy() if package == "torch" else np.asarray(tsdf._weight)
            out[package] = tsdf.get_grid(), weight, pc, timing
    (grid, weight, pc, timing), (jgrid, jweight, jpc, _) = out["torch"], out["jax"]
    assert grid.shape == jgrid.shape and grid.dtype == np.float32
    assert float(np.abs(grid - jgrid).max()) <= TOL_TSDF
    np.testing.assert_array_equal(weight, jweight)
    np.testing.assert_array_equal(pc, jpc)
    assert len(pc) > 10 and timing > 0


def test_execute_grasp_outcomes_match_jax():
    """tests/test_sim_integration.py's three outcomes (a top grasp that
    lifts the object, a grasp in empty space, a hand spawned in the table)
    with the same labels, widths and worlds after each as JAX's."""
    from tests.test_sim_integration import TOP_DOWN

    results = {}
    for package in ("jax", "torch"):
        if package == "jax":
            from giga_tpu.core.grasp import Grasp
            from giga_tpu.core.transform import Rotation, Transform
        else:
            from giga_tpu_torch.core.grasp import Grasp
            from giga_tpu_torch.core.transform import Rotation, Transform
        top_down = Rotation.from_quat(TOP_DOWN.as_quat())
        out = []
        with double(package):
            sim = make_sim(package, "packed", seed=5)
            sim.reset(1)
            body = next(b for b in sim.world.bodies.values() if b.name not in ("plane", "box"))
            body.set_pose(Transform(Rotation.identity(), [0.15, 0.15, 0.15]))
            sim.wait_for_objects_to_rest()
            c = body.get_pose().translation
            grasps = [(Grasp(Transform(top_down, np.r_[c[:2], c[2] + 0.01]), 0.08), True),
                      (Grasp(Transform(top_down, [0.27, 0.27, 0.20]), 0.08), True),
                      (Grasp(Transform(top_down, [0.15, 0.15, 0.02]), 0.08), False)]
            for grasp, allow in grasps:
                label, width = sim.execute_grasp(grasp, allow_contact=allow)
                out.append((int(label), width, sim.num_objects, world_state(sim)))
        results[package] = out
    labels = [(r[0], r[2]) for r in results["torch"]]
    assert labels == [(r[0], r[2]) for r in results["jax"]]
    assert [r[0] for r in results["torch"]] == [1, 0, 0]
    for got, ref in zip(results["torch"], results["jax"]):
        assert got[1] == pytest.approx(ref[1], abs=1e-12)
        assert_same_world(got[3], ref[3])


def test_snapshots_match_jax(tmp_path):
    """BtWorld's periodic snapshots (utils/saver.py) of the same world: the
    same files and keys, mesh paths and scales, poses within 1e-12; the
    port's hold its own Transform."""
    from giga_tpu_torch.core.transform import Transform

    snaps = {}
    for package in ("jax", "torch"):
        (tmp_path / package).mkdir()
        with double(package):
            sim = make_sim(package, "pile", seed=4, save_dir=tmp_path / package, save_freq=100)
            sim.reset(2)
        snaps[package] = sorted((tmp_path / package).glob("*.pkl"))
    assert [p.name for p in snaps["torch"]] == [p.name for p in snaps["jax"]] != []
    for got_path, ref_path in zip(snaps["torch"], snaps["jax"]):
        got, ref = (pickle.loads(p.read_bytes()) for p in (got_path, ref_path))
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k][:2] == ref[k][:2]
            assert isinstance(got[k][2], Transform)
            np.testing.assert_allclose(got[k][2].as_matrix(), ref[k][2].as_matrix(),
                                       atol=TOL_POSE, rtol=0)


def test_sensor_data_files_match_jax(tmp_path):
    """write_(full_)sensor_data write the members JAX's write, the same .npy
    bytes; each package reads the other's files."""
    from giga_tpu.core import io as jio
    from giga_tpu_torch.core import io

    rng = np.random.RandomState(0)
    depth = rng.rand(2, 6, 8).astype(np.float32)
    extr = rng.rand(2, 7).astype(np.float32)
    for sub in ("scenes", "full_scenes"):
        for pkg in ("port", "jax"):
            (tmp_path / pkg / sub).mkdir(parents=True)
    for write, jwrite, read, jread, sub in (
            (io.write_sensor_data, jio.write_sensor_data, io.read_sensor_data,
             jio.read_sensor_data, "scenes"),
            (io.write_full_sensor_data, jio.write_full_sensor_data, io.read_full_sensor_data,
             jio.read_full_sensor_data, "full_scenes")):
        sid = write(tmp_path / "port", depth, extr)
        assert re.fullmatch(r"[0-9a-f]{32}", sid)
        jwrite(tmp_path / "jax", depth, extr, scene_id=sid)
        files = [tmp_path / pkg / sub / f"{sid}.npz" for pkg in ("port", "jax")]
        members = []
        for f in files:
            with zipfile.ZipFile(f) as z:
                members.append({n: z.read(n) for n in z.namelist()})
        assert members[0] == members[1]
        for got in (jread(tmp_path / "port", sid), read(tmp_path / "jax", sid),
                    read(tmp_path / "port", sid)):
            np.testing.assert_array_equal(got[0], depth)
            np.testing.assert_array_equal(got[1], extr)


def test_import_gates_and_device_rule(monkeypatch):
    """Without pybullet (this sandbox has none) creating a world raises an
    ImportError naming it, as the JAX package's does; without nvisii the
    path tracer raises naming nvisii; device=None means the card, so without
    one the simulator raises before it needs pybullet."""
    from giga_tpu_torch.sim import btsim
    from giga_tpu_torch.sim.simulation import ClutterRemovalSim
    from giga_tpu_torch.utils import nvisii_render

    assert "pybullet" not in sys.modules or sys.modules["pybullet"] is None
    assert not btsim.PYBULLET_AVAILABLE
    with pytest.raises(ImportError, match="pybullet"):
        btsim.BtWorld(gui=False)
    with pytest.raises(ImportError, match="pybullet"):
        make_sim("torch")
    assert not nvisii_render.NVISII_AVAILABLE
    with pytest.raises(ImportError, match="nvisii"):
        nvisii_render.NViSIIRenderer()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClutterRemovalSim("pile", "blocks", urdf_root=str(SIM_URDF_ROOT))
