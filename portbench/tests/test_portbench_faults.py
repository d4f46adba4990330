"""A whole run of each cell on the CPU at a small size, the harness's look
for a chip skipped: sound, ``correct`` is true; with the timed path broken
underneath (an answer altered where it is produced), ``correct`` comes out
false. A cell here has no training step, no batch to halve and no exchange
between chips, so altered answers are its faults."""

import numpy as np
import pytest

from portbench.tests.small import FLEET, PLAN, RECON, run_small


@pytest.mark.parametrize("name", [PLAN, RECON, FLEET])
def test_sound_runs_are_correct(name):
    result = run_small(name)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "compared"
    if name != FLEET:
        assert result["metrics"]["setup_s"]["value"] > 0


def _alter_grasps(monkeypatch, how):
    from giga_tpu_torch.inference.planner import GIGAPlanner

    original = GIGAPlanner._to_grasps

    def altered(self, cands):
        grasps, scores = original(self, cands)
        return how(grasps, np.array(scores, dtype=float))

    monkeypatch.setattr(GIGAPlanner, "_to_grasps", altered)


def _score(grasps, scores):
    return grasps, scores - 0.01 * (np.arange(len(scores)) == 0)


def _rotation(grasps, scores):
    from giga_tpu_torch.core.transform import Rotation

    for g in grasps[:1]:
        g.pose.rotation = g.pose.rotation * Rotation.from_euler("z", 0.05)
    return grasps, scores


def _dropped(grasps, scores):
    return grasps[1:], scores[1:]


@pytest.mark.parametrize("name,how", [(PLAN, _score), (PLAN, _rotation), (PLAN, _dropped),
                                      (FLEET, _score)],
                         ids=["score", "rotation", "drop", "fleet-score"])
def test_an_altered_grasp_list_is_not_correct(monkeypatch, name, how):
    _alter_grasps(monkeypatch, how)
    result = run_small(name)
    assert not result["correct"], result["compared"]


def _alter_meshes(monkeypatch, how):
    from giga_tpu_torch.geometry.generation import MeshGenerator
    from giga_tpu_torch.geometry.mesh import TriMesh

    original = MeshGenerator._mesh_from_band

    def altered(self, *args):
        mesh = original(self, *args)
        return TriMesh(*how(np.asarray(mesh.vertices), np.asarray(mesh.faces)))

    monkeypatch.setattr(MeshGenerator, "_mesh_from_band", altered)


@pytest.mark.parametrize("how", [
    lambda v, f: (v + np.array([0.01, 0.0, 0.0]), f),   # a sixth of a cell of the 17^3 lattice
    lambda v, f: (v, f[: len(f) // 2]),                  # half the triangles
], ids=["shifted", "half"])
def test_an_altered_mesh_is_not_correct(monkeypatch, how):
    _alter_meshes(monkeypatch, how)
    result = run_small(RECON)
    assert not result["correct"], result["compared"]


def test_a_traced_run_reports_its_per_layer_metrics():
    """On the CPU the trace holds no device operation, so the device's
    readings are left out and the host's are there."""
    result = run_small(PLAN, trace=True)
    assert result["correct"]
    assert {"planner.grasps_per_scene", "plan.mfu"} <= set(result["metrics"])
    assert not {"k2_roofline", "device.idle.plan"} & set(result["metrics"])
    assert "window_s" in result["device"] and "breakdown" in result
