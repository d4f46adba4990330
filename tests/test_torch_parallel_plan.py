"""The port's sharded planners (giga_tpu_torch/inference/planner.py with
``mesh``) against the JAX package's own sharded programs on CPU meshes of
the same shape (tests/conftest.py's 8 virtual devices), both on the shipped
checkpoint and ``chip_smoke.make_scenes``' analytic scenes:

  * dp batched serving on 2 ranks (module path; and with ``use_kernels``,
    the kernels' plain versions on the CPU) against JAX's
    ``build_batched_giga_planner_fn(mesh=make_mesh(2))`` and its shard_map
    path (``use_pallas=True``);
  * the sp planner on 2 ranks against JAX's ``build_sharded_giga_planner_fn``
    on ``make_mesh(2, axis="sp")``;
  * the composed dp x sp program on a 2 x 2 mesh of 4 ranks against JAX's on
    ``Mesh(devices[:4].reshape(2, 2), ("dp", "sp"))``.

Counts equal, scores within 1e-5, the sp planner's raw qual within 1e-5
(tests/test_sharded_planner.py's tolerances), positions within 1e-6 (the
port's lattice coordinates are correctly rounded, JAX's float32 linspace
within an ulp of them: chip_smoke.TOL_POS); every rank's result equal to
rank 0's. The ranks start once a group for the file (``torch_dist.run``,
its own timeouts).
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh as JMesh

import chip_smoke
import torch_dist
from giga_tpu.core.config import PlannerConfig as JPlannerConfig
from giga_tpu.inference import planner as jp
from giga_tpu.models.registry import get_network, load_params
from giga_tpu.parallel.mesh import make_mesh as jmake_mesh

CHECKPOINT = str(torch_dist.REPO / chip_smoke.CHECKPOINT)
TOL_SCORE = 1e-5
TOL_RAW = 1e-5
TOL_POS = chip_smoke.TOL_POS


@pytest.fixture(scope="module")
def scenes():
    return chip_smoke.make_scenes(4, seed=5)


@pytest.fixture(scope="module")
def jax_side():
    net, cfg = get_network("giga")
    return net, cfg, load_params(CHECKPOINT), JPlannerConfig(force_detection=True)


@pytest.fixture(scope="module")
def ranks2(scenes):
    return torch_dist.run(torch_dist.plan_dp_sp, 2, scenes=scenes, checkpoint=CHECKPOINT)


@pytest.fixture(scope="module")
def ranks4(scenes):
    return torch_dist.run(torch_dist.plan_composed, 4, scenes=scenes[:2],
                          checkpoint=CHECKPOINT)


def assert_candidates(got, ref):
    """GraspCandidates fields (scores, positions, rotations, widths, count),
    batched or single: counts equal, scores and positions within their
    tolerances."""
    ref = [np.asarray(x) for x in ref]
    counts = np.atleast_1d(ref[4])
    np.testing.assert_array_equal(np.atleast_1d(got[4]), counts)
    assert counts.sum() > 0
    for b, n in enumerate(counts):
        np.testing.assert_allclose(got[0].reshape(len(counts), -1)[b, :n],
                                   ref[0].reshape(len(counts), -1)[b, :n], atol=TOL_SCORE)
        np.testing.assert_allclose(got[1].reshape(len(counts), -1, 3)[b, :n],
                                   ref[1].reshape(len(counts), -1, 3)[b, :n], atol=TOL_POS,
                                   rtol=0)


@pytest.mark.parametrize("name,use_pallas", [("dp", False), ("dp_kernels", True)])
def test_dp_batched_serving_matches_jax(ranks2, jax_side, scenes, name, use_pallas):
    net, cfg, params, pcfg = jax_side
    fn = jp.build_batched_giga_planner_fn(net, cfg, pcfg, 0.3, mesh=jmake_mesh(2),
                                          use_pallas=use_pallas)
    ref, _ = jax.device_get(fn(params, scenes, scenes))
    for r in ranks2:
        assert_candidates(r[name], ref)
        for a, b in zip(r[name], ranks2[0][name]):
            np.testing.assert_array_equal(a, b)


def test_sp_planner_matches_jax(ranks2, jax_side, scenes):
    net, cfg, params, pcfg = jax_side
    fn = jp.build_sharded_giga_planner_fn(net, cfg, pcfg, 0.3, jmake_mesh(2, axis="sp"))
    ref, raw = jax.device_get(fn(params, scenes[0], scenes[0]))
    for r in ranks2:
        assert_candidates(r["sp"], ref)
        for a, b in zip(r["sp"], ranks2[0]["sp"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(r["sp_qual"], np.asarray(raw[0]), atol=TOL_RAW)
        np.testing.assert_array_equal(r["sp_qual"], ranks2[0]["sp_qual"])


def test_composed_dp_sp_matches_jax(ranks4, jax_side, scenes):
    net, cfg, params, pcfg = jax_side
    mesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
    fn = jp.build_batched_giga_planner_fn(net, cfg, pcfg, 0.3, mesh=mesh, sp_axis="sp")
    ref, _ = jax.device_get(fn(params, scenes[:2], scenes[:2]))
    for r in ranks4:
        assert_candidates(r["cands"], ref)
        for a, b in zip(r["cands"], ranks4[0]["cands"]):
            np.testing.assert_array_equal(a, b)
        assert r["kernels_refused"]
