"""The plain reference agrees with the port's CPU path at a small size:
the encoder's planes, the affordance and occupancy volumes, the judge's
numbers on the port's own grasp lists and meshes, and the reference's
marching tetrahedra against the port's native one."""

import numpy as np
import pytest
import torch

from portbench.frozen.scenes import make_pool
from portbench.reference.giga import GigaReference, grid_points
from portbench.reference.judge import mesh_gaps, plan_gaps
from portbench.reference.marching import march
from portbench.reference.planner import lattice, plan
from portbench.reference.recon import occupancy
from portbench.tests.small import PLAN, RECON, ROOT, small_cell

GIGA = ROOT / "checkpoints" / "synthetic_giga_best.msgpack"
GEO = ROOT / "checkpoints" / "synthetic_giga_geo.msgpack"


@pytest.fixture(scope="module")
def scenes():
    return make_pool(2 ** 33 + 5, 3, 40, 0.3)[0]


@pytest.fixture(scope="module")
def port_giga():
    from giga_tpu_torch.models.registry import load_network

    return load_network(GIGA, "giga")


def test_scene_pool_is_seeded_and_spreads_the_clutter():
    a, ka = make_pool(2 ** 40 + 1, 10, 8, 0.3)
    b, kb = make_pool(2 ** 40 + 1, 10, 8, 0.3)
    c, _ = make_pool(2 ** 40 + 2, 10, 8, 0.3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert sorted(ka.tolist()) == [1, 1, 2, 2, 3, 3, 4, 4, 5, 5] and np.array_equal(ka, kb)
    assert a.dtype == np.float32 and a.min() >= 0 and a.max() <= 1


def test_planes_match_the_port(scenes, port_giga):
    net, _ = port_giga
    grids = torch.from_numpy(scenes)
    with torch.no_grad():
        port = net.encode(grids)
    ref = GigaReference(GIGA, "cpu").encode(grids)
    for t in ("xz", "xy", "yz"):
        got = ref[t].permute(0, 2, 3, 1)
        assert torch.allclose(got, port[t], atol=2e-5, rtol=2e-5), t


def test_affordance_volumes_match_the_port(scenes, port_giga):
    from giga_tpu_torch.core.config import PlannerConfig
    from giga_tpu_torch.inference.planner import build_batched_giga_planner_fn

    net, cfg = port_giga
    fn = build_batched_giga_planner_fn(net, cfg, PlannerConfig(), 0.3, return_raw=True)
    grids = torch.from_numpy(scenes)
    _, (q, r, w) = fn(grids, grids)
    ref = GigaReference(GIGA, "cpu")
    qr, rr, wr = ref.affordance(ref.encode(grids), grid_points(lattice(40, "cpu"))
                                .expand(len(scenes), -1, -1))
    assert torch.allclose(qr.reshape(q.shape), q, atol=2e-5)
    assert torch.allclose(rr.reshape(r.shape), r, atol=2e-5)
    assert torch.allclose(wr.reshape(w.shape), w, atol=2e-5)


def test_judge_passes_the_ports_grasp_lists(scenes, port_giga):
    from giga_tpu_torch.inference.planner import GIGAPlanner

    from portbench.plans import grasp_arrays

    net, cfg = port_giga
    _, config, _, _ = small_cell(PLAN)
    s = config["planner"]
    planner = GIGAPlanner(net=net, model_cfg=cfg, best=s["best"],
                          force_detection=s["force_detection"], qual_th=s["qual_th"],
                          out_th=s["out_th"], low_th=s["low_th"], device="cpu")
    served = planner.plan_batch(scenes)
    plans = plan(GigaReference(GIGA, "cpu"), scenes, s)
    total = 0
    for (grasps, scores), ref in zip(served, plans):
        score_gap, pose_gap = plan_gaps(grasp_arrays(grasps, scores), ref, s)
        assert score_gap < 1e-5 and pose_gap < 1e-5
        total += len(grasps)
    assert total > 0


def test_judge_passes_the_ports_meshes(scenes):
    from giga_tpu_torch.geometry.generation import MeshGenerator
    from giga_tpu_torch.models.registry import load_network

    _, config, _, _ = small_cell(RECON)
    g = config["generator"]
    net, _ = load_network(GEO, "giga_geo")
    gen = MeshGenerator(net, threshold=g["threshold"], resolution0=g["resolution0"],
                        upsampling_steps=g["upsampling_steps"], strategy="dense", device="cpu")
    n = g["resolution0"] * 2 ** g["upsampling_steps"] + 1
    ref = GigaReference(GEO, "cpu")
    for tsdf, mesh in zip(scenes, gen.generate_meshes(scenes)):
        assert len(mesh.faces)
        vertex_gap, face_gap = mesh_gaps(mesh.vertices, mesh.faces, occupancy(ref, tsdf, n, 1.0),
                                         0.0, 1.0, g["pad"])
        # the band's float16 corners move a crossing by at most ~2.5e-4 of an edge
        assert vertex_gap < 3e-4 and face_gap == 0.0


def test_reference_marching_matches_the_ports():
    from giga_tpu_torch.geometry.native import marching_tetrahedra

    rng = np.random.default_rng(3)
    x = np.linspace(-1, 1, 12)
    field = (0.6 - np.sqrt(sum(a ** 2 for a in np.meshgrid(x, x, x, indexing="ij")))
             + 0.05 * rng.standard_normal((12, 12, 12)))
    padded = np.pad(field, 1, constant_values=-1e6)
    v_ref, f_ref = march(padded, 0.0)
    v_port, f_port = marching_tetrahedra(padded, 0.0)
    assert len(f_ref) == len(f_port) and len(v_ref) == len(v_port)
    np.testing.assert_allclose(np.unique(v_ref.round(9), axis=0),
                               np.unique(v_port.round(9), axis=0), atol=1e-12)
    gap = mesh_gaps((v_port - 1) / 11 * 2 - 1, f_port, field, 0.0, 2.0, -1e6)
    assert gap[0] < 1e-9 and gap[1] == 0.0
