"""The port's clutter-removal experiments (experiments/clutter_removal.py,
experiments/clutter_removal_single.py), its software renderer
(utils/render.py) and the CLIs that drive them, against the JAX package's on
the CPU, each package under its own copy of the kinematic pybullet double
(tests/torch_sim.py), and the port's GIGA run against the JAX golden of
chip_smoke.py's phase 34."""

import argparse
import csv
import os
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
for p in (REPO, REPO / "scripts"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import chip_smoke  # noqa: E402
from torch_sim import (SIM_URDF_ROOT, double, one_torch_thread,  # noqa: E402,F401
                       port_heuristic_plan_fn)
from tests.test_sim_integration import heuristic_plan_fn  # noqa: E402

# the columns a run writes afresh: a uuid and two host-clock readings
VOLATILE = ("scene_id", "integration_time", "planning_time")


def clutter_modules(package):
    if package == "jax":
        from giga_tpu.experiments import clutter_removal, clutter_removal_single
        return clutter_removal, clutter_removal_single, heuristic_plan_fn, {}
    from giga_tpu_torch.experiments import clutter_removal, clutter_removal_single
    return clutter_removal, clutter_removal_single, port_heuristic_plan_fn, {"device": "cpu"}


def read_rows(path: Path):
    with path.open(newline="") as f:
        return list(csv.DictReader(f))


def test_run_matches_jax_and_data_matches_pandas(tmp_path):
    """tests/test_sim_integration.py's protocol (cubes, seed 4) at 2 objects,
    one view and 2 rounds, with its heuristic planner: rounds.csv and result.txt
    equal to JAX's, grasps.csv equal cell for cell but for the uuid and the
    two times, each logged scene's grid and points equal; then the port's
    Data (csv and numpy) against JAX's (pandas) on both directories."""
    from giga_tpu.experiments.clutter_removal import Data as JData
    from giga_tpu_torch.experiments.clutter_removal import Data

    logdirs, results = {}, {}
    for package in ("jax", "torch"):
        cr, _, plan_fn, kw = clutter_modules(package)
        with double(package):
            results[package] = cr.run(
                grasp_plan_fn=plan_fn, logdir=tmp_path / package, description="faketest",
                scene="pile", object_set="cubes", num_objects=2, n=1, num_rounds=2, seed=4,
                silence=True, urdf_root=str(SIM_URDF_ROOT),
                result_path=tmp_path / f"{package}.txt", **kw)
        logdirs[package] = next(p for p in (tmp_path / package).iterdir() if p.is_dir())
    assert results["torch"] == results["jax"]
    assert results["torch"][0] > 50.0
    assert (tmp_path / "torch.txt").read_text() == (tmp_path / "jax.txt").read_text()
    got, ref = logdirs["torch"], logdirs["jax"]
    assert (got / "rounds.csv").read_text() == (ref / "rounds.csv").read_text()
    got_rows, ref_rows = read_rows(got / "grasps.csv"), read_rows(ref / "grasps.csv")
    assert len(got_rows) == len(ref_rows) >= 3
    assert list(got_rows[0]) == list(ref_rows[0])
    for a, b in zip(got_rows, ref_rows):
        assert {k: v for k, v in a.items() if k not in VOLATILE} == \
            {k: v for k, v in b.items() if k not in VOLATILE}
        sa, sb = (np.load(d / "scenes" / (r["scene_id"] + ".npz"))
                  for d, r in ((got, a), (ref, b)))
        assert float(np.abs(sa["grid"] - sb["grid"]).max()) <= 1e-6
        np.testing.assert_array_equal(sa["points"], sb["points"])

    for logdir in (got, ref):
        mine, pandas = Data(logdir), JData(logdir)
        assert mine.num_rounds() == pandas.num_rounds() == 2
        assert mine.num_grasps() == pandas.num_grasps()
        for name in ("success_rate", "percent_cleared", "avg_planning_time"):
            assert getattr(mine, name)() == getattr(pandas, name)(), name
        for i in range(mine.num_grasps()):
            (p1, g1, s1, l1), (p2, g2, s2, l2) = mine.read_grasp(i), pandas.read_grasp(i)
            np.testing.assert_array_equal(p1, p2)
            # pandas' default parser reads a value up to an ulp off; the
            # port's reads it correctly rounded (core/io.py)
            np.testing.assert_allclose(g1.pose.as_matrix(), g2.pose.as_matrix(), rtol=0,
                                       atol=1e-12)
            assert g1.width == pytest.approx(g2.width, rel=1e-15)
            assert (s1, l1) == pytest.approx((s2, l2), rel=1e-15)
    assert Data(got).success_rate() == pytest.approx(results["torch"][0])
    assert Data(got).percent_cleared() == pytest.approx(results["torch"][1])


def test_data_follows_pandas_join_and_empty_logs(tmp_path):
    """Data on logs pandas treats specially: a round without grasps, a
    grasp of a round rounds.csv lacks (its left join drops it), and a log
    with no rounds (a NaN success rate, a ZeroDivisionError for the cleared
    share); Logger.last_round_id reads the rounds."""
    from giga_tpu.experiments.clutter_removal import Data as JData
    from giga_tpu_torch.core.grasp import Grasp, Label
    from giga_tpu_torch.core.transform import Rotation, Transform
    from giga_tpu_torch.experiments.clutter_removal import Data, Logger
    from giga_tpu_torch.inference.planner import State

    class Volume:
        def get_grid(self):
            return np.zeros((1, 4, 4, 4), np.float32)

    logger = Logger(tmp_path / "a", "log")
    assert logger.last_round_id() == -1
    empty = Data(logger.logdir)
    assert np.isnan(empty.success_rate()) and np.isnan(JData(logger.logdir).success_rate())
    for data in (empty, JData(logger.logdir)):
        with pytest.raises(ZeroDivisionError):
            data.percent_cleared()
    state = State(tsdf=Volume(), pc=np.zeros((4, 3)))
    g = Grasp(Transform(Rotation.identity(), [0.1, 0.1, 0.1]), 0.04)
    for round_id, count in ((0, 5), (1, 3), (2, 4)):
        logger.log_round(round_id, count)
    for round_id, label in ((0, Label.SUCCESS), (0, Label.FAILURE), (2, Label.SUCCESS),
                            (2, Label.SUCCESS), (7, Label.SUCCESS)):
        logger.log_grasp(round_id, state, 0.1, 0.01 * (round_id + 1), g, 0.9, label)
    assert logger.last_round_id() == 2
    mine, pandas = Data(logger.logdir), JData(logger.logdir)
    for name in ("num_rounds", "num_grasps", "success_rate", "percent_cleared",
                 "avg_planning_time"):
        assert getattr(mine, name)() == getattr(pandas, name)(), name
    assert mine.percent_cleared() == pytest.approx(3 / 12 * 100)


def test_visualize_writes_meshes_and_png(tmp_path):
    """run(visualize=True) with the port's GIGAPlanner(visualize=True): per
    trial the scene and affordance meshes and the PNG, whose pixels are the
    JAX renderer's image of the same affordance mesh."""
    from PIL import Image

    from giga_tpu.geometry.mesh import TriMesh as JTriMesh
    from giga_tpu.utils.render import render_mesh_image as jax_render
    from giga_tpu_torch.experiments import clutter_removal
    from giga_tpu_torch.inference.planner import GIGAPlanner

    planner = GIGAPlanner(REPO / chip_smoke.CHECKPOINT, visualize=True, device="cpu",
                          **chip_smoke.CLUTTER_KW)
    meshes = []

    def plan(state, scene_mesh):
        out = planner(state, scene_mesh)
        meshes.append(out[3])
        return out

    with double("torch"):
        clutter_removal.run(plan, tmp_path, scene="pile", object_set="blocks", num_objects=2,
                            n=1, num_rounds=1, seed=0, silence=True, visualize=True,
                            urdf_root=str(SIM_URDF_ROOT), device="cpu")
    out = next(tmp_path.iterdir()) / "meshes"
    assert meshes
    for trial, aff in enumerate(meshes):
        stem = out / f"round_000_trial_{trial:03d}"
        assert Path(f"{stem}_scene.obj").stat().st_size > 0
        assert Path(f"{stem}_aff.obj").stat().st_size > 0
        ref = JTriMesh(aff.vertices, aff.faces)
        ref.face_colors = aff.face_colors
        np.testing.assert_array_equal(np.asarray(Image.open(f"{stem}_aff.png")), jax_render(ref))


def test_rollout_capture_and_render_match_jax(tmp_path):
    """tests/test_rollout_capture.py's round (cubes, 2 objects, 3 views,
    seed 4, a snapshot every 200 steps) in both packages: the same result
    and snapshot files; the port's render_rollouts CLI and JAX's
    SoftwareRenderer give byte-equal PNG frames; the PNG fallback writer
    decodes to the image it was given."""
    from PIL import Image

    from giga_tpu.utils.render import SoftwareRenderer as JRenderer
    from giga_tpu_torch.scripts import render_rollouts
    from giga_tpu_torch.utils.render import _write_png

    results = {}
    for package in ("jax", "torch"):
        _, single, plan_fn, kw = clutter_modules(package)
        with double(package):
            results[package] = single.run(
                grasp_plan_fn=plan_fn, save_dir=tmp_path / package / "round_000",
                scene="pile", object_set="cubes", num_objects=2, n=3, seed=4, save_freq=200,
                urdf_root=str(SIM_URDF_ROOT), **kw)
    assert results["torch"] == results["jax"] and results["torch"][1] >= 1
    snaps = [sorted(p.name for p in (tmp_path / pkg / "round_000").glob("*.pkl"))
             for pkg in ("torch", "jax")]
    assert snaps[0] == snaps[1] != []
    render_rollouts.main(render_rollouts.parser().parse_args(
        [str(tmp_path / "torch"), str(tmp_path / "frames"), "--software"]))
    JRenderer().render_rollout(tmp_path / "jax" / "round_000", tmp_path / "jax_frames")
    frames = sorted((tmp_path / "frames" / "round_000").glob("*.png"))
    assert [f.stem + ".pkl" for f in frames] == snaps[0]
    for f in frames:
        assert f.read_bytes() == (tmp_path / "jax_frames" / f.name).read_bytes()
    img = np.asarray(Image.open(frames[0]))
    assert np.any(np.any(img != 255, axis=-1)), "scene must be visible"
    _write_png(img, tmp_path / "fallback.png")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "fallback.png")), img)


def test_port_giga_run_matches_golden(tmp_path):
    """The golden's protocol (chip_smoke.clutter_protocol) through the port's
    GIGAPlanner on the CPU: attempts, labels, object counts, GSR/DR and
    aborts equal to JAX's golden run, decisions within 1e-6 (positions) and
    1e-5 (quaternions), scores and widths within 1e-5."""
    from giga_tpu_torch.experiments import clutter_removal
    from giga_tpu_torch.inference.planner import GIGAPlanner

    planner = GIGAPlanner(REPO / chip_smoke.CHECKPOINT, "giga", device="cpu",
                          **chip_smoke.CLUTTER_KW)
    with double("torch"):
        got = chip_smoke.clutter_protocol(clutter_removal, planner, tmp_path, device="cpu")
    golden = dict(np.load(REPO / chip_smoke.GOLDEN_CLUTTER))
    chip_smoke.compare_clutter(got, golden, "port vs golden")


def test_sim_grasp_multiple_giga_and_vgn(tmp_path, monkeypatch):
    """The port's sim_grasp_multiple for one round each: giga (the shipped
    checkpoint, the golden's planner) gives the golden's first pile round;
    vgn (chip_smoke's seeded VGN weights written as a checkpoint) gives the
    JAX script's JSON and decisions on the same command line (run where
    its default data/urdfs is the fixture)."""
    import sim_grasp_multiple as jax_cli

    from giga_tpu_torch.models.checkpoint import save_params
    from giga_tpu_torch.scripts import sim_grasp_multiple

    golden = np.load(REPO / chip_smoke.GOLDEN_CLUTTER)
    first = (golden["scene"] == 0) & (golden["round"] == 0)
    flags = ["--seeds", "0", "--num-rounds", "1", "--best", "--silence"]
    with double("torch"):
        summary = sim_grasp_multiple.main(sim_grasp_multiple.parser().parse_args(
            ["--model", str(REPO / chip_smoke.CHECKPOINT), "--type", "giga", "--logdir",
             str(tmp_path / "giga"), "--urdf-root", str(SIM_URDF_ROOT), "--device", "cpu"]
            + flags))
    labels = golden["label"][first]
    assert summary["gsr"]["val"] == [100.0 * labels.sum() / len(labels)]
    assert summary["dr"]["val"] == [100.0 * labels.sum() / golden["round_objects"][0, 0]]

    save_params(chip_smoke.unflatten_params(np.load(REPO / chip_smoke.GOLDEN_VGN)),
                tmp_path / "vgn.msgpack")
    (tmp_path / "data").mkdir()
    os.symlink(SIM_URDF_ROOT, tmp_path / "data" / "urdfs")
    monkeypatch.chdir(tmp_path)
    flags += ["--model", str(tmp_path / "vgn.msgpack"), "--type", "vgn", "--force",
              "--qual-th", "0.85"]
    jax_parser = argparse.ArgumentParser()
    for name, kw in jax_cli.FLAGS:
        jax_parser.add_argument(name, **kw)
    with double("jax"):
        jax_cli.main(jax_parser.parse_args(flags + ["--logdir", "jax",
                                                    "--result-path", "jax.json"]))
    with double("torch"):
        sim_grasp_multiple.main(sim_grasp_multiple.parser().parse_args(
            flags + ["--logdir", "port", "--result-path", "port.json", "--device", "cpu",
                     "--precision", "highest"]))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    got, ref = (read_rows(next((tmp_path / d).iterdir()) / "grasps.csv") for d in ("port", "jax"))
    assert len(got) == len(ref) >= 1
    for a, b in zip(got, ref):
        assert (a["round_id"], a["label"]) == (b["round_id"], b["label"])
        for cols, tol in ((("x", "y", "z"), 1e-6), (("qx", "qy", "qz", "qw", "width", "score"),
                                                      1e-5)):
            for c in cols:
                assert abs(float(a[c]) - float(b[c])) <= tol, c
