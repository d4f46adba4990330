"""Checkpoint ensembles in the PyTorch port (inference/planner.py:
``stack_params``, ``build_ensemble_giga_planner_fn``, GIGAPlanner(params=
[...])), on the CPU: tests/test_ensemble.py's six cases on the port, then
the port's ensemble program against the JAX package's on the same two
seeded members (raw volumes within 2e-5, the same decisions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from giga_tpu.core.config import PlannerConfig as JPlannerConfig
from giga_tpu.inference.planner import build_ensemble_giga_planner_fn as jax_build_ensemble
from giga_tpu.inference.planner import stack_params as jax_stack_params
from giga_tpu.models.registry import get_network as jax_get_network
from giga_tpu_torch.core.config import PlannerConfig
from giga_tpu_torch.inference.planner import (
    GIGAPlanner,
    State,
    build_ensemble_giga_planner_fn,
    build_giga_planner_fn,
    stack_params,
)
from giga_tpu_torch.inference.serving import PlannerService
from giga_tpu_torch.models.conv_onet import GIGANet
from giga_tpu_torch.models.convert import flax_to_state_dict
from giga_tpu_torch.models.registry import get_network

TOL = 2e-5
PCFG = dict(force_detection=True, best=True)
# the seeded members' widths fall outside the default window: open it so
# that the comparison with JAX has candidates to hold equal
OPEN_WIDTHS = dict(min_width=-1.0, max_width=1.0)


@pytest.fixture(scope="module")
def two_checkpoints():
    """(flax params p0, p1 of the giga preset, seeded as tests/test_ensemble.py's)."""
    jnet, _ = jax_get_network("giga")
    tsdf, p = jnp.zeros((1, 40, 40, 40)), jnp.zeros((1, 4, 3))
    return (jax.device_get(jnet.init(jax.random.PRNGKey(0), tsdf, p, p)),
            jax.device_get(jnet.init(jax.random.PRNGKey(7), tsdf, p, p)))


@pytest.fixture(scope="module")
def scene_grid():
    return torch.from_numpy(np.random.RandomState(3).rand(40, 40, 40).astype(np.float32))


def _net(params):
    net, _ = get_network("giga")
    net.load_state_dict(flax_to_state_dict(params))
    return net.eval()


def _single(params):
    """The port's single-checkpoint program with its raw volumes."""
    net = _net(params)
    return build_giga_planner_fn(net, net.cfg, PlannerConfig(**PCFG), 0.3, use_kernels=True,
                                 return_raw=True)


def _ensemble(members, combine="mean", use_kernels=True, widths=None):
    states = [flax_to_state_dict(p) for p in members]
    net = GIGANet(get_network("giga")[1])
    return build_ensemble_giga_planner_fn(net, stack_params(states), net.cfg,
                                          PlannerConfig(**PCFG, **(widths or {})), 0.3, combine,
                                          use_kernels, return_raw=True)


def _raw(fn, grid):
    cands, raw = fn(grid, grid)
    return cands, [v.numpy() for v in raw]


class TestEnsemblePlanner:
    def test_duplicated_member_matches_single(self, two_checkpoints, scene_grid):
        p0, _ = two_checkpoints
        cands_s, raw_s = _raw(_single(p0), scene_grid)
        cands_e, raw_e = _raw(_ensemble([p0, p0]), scene_grid)
        for a, b in zip(raw_s, raw_e):
            np.testing.assert_allclose(a, b, atol=1e-6)
        n = int(cands_s.count)
        assert n == int(cands_e.count)
        np.testing.assert_array_equal(cands_s.positions[:n], cands_e.positions[:n])
        np.testing.assert_allclose(cands_s.scores[:n], cands_e.scores[:n], atol=1e-6)

    def test_raw_volumes_are_member_means(self, two_checkpoints, scene_grid):
        p0, p1 = two_checkpoints
        _, (q0, r0, w0) = _raw(_single(p0), scene_grid)
        _, (q1, r1, w1) = _raw(_single(p1), scene_grid)
        _, (qe, re, we) = _raw(_ensemble([p0, p1]), scene_grid)
        np.testing.assert_allclose(qe, (q0 + q1) / 2, atol=1e-5)
        np.testing.assert_allclose(we, (w0 + w1) / 2, atol=1e-4)
        sign = np.sign(np.sum(r1 * r0, axis=-1, keepdims=True))
        sign[sign == 0] = 1.0
        m = (r0 + sign * r1) / 2
        m = m / np.maximum(np.linalg.norm(m, axis=-1, keepdims=True), 1e-12)
        np.testing.assert_allclose(re, m, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(re, axis=-1), 1.0, atol=1e-5)

    def test_max_combine_duplicated_member_matches_single(self, two_checkpoints, scene_grid):
        p0, _ = two_checkpoints
        _, raw_s = _raw(_single(p0), scene_grid)
        _, raw_e = _raw(_ensemble([p0, p0], "max"), scene_grid)
        for a, b in zip(raw_s, raw_e):
            np.testing.assert_allclose(a, b, atol=1e-6)

    def test_max_combine_is_per_voxel_winner(self, two_checkpoints, scene_grid):
        p0, p1 = two_checkpoints
        _, (q0, r0, w0) = _raw(_single(p0), scene_grid)
        _, (q1, r1, w1) = _raw(_single(p1), scene_grid)
        _, (qe, re, we) = _raw(_ensemble([p0, p1], "max"), scene_grid)
        np.testing.assert_allclose(qe, np.maximum(q0, q1), atol=1e-6)
        win1 = q1 > q0
        np.testing.assert_allclose(we, np.where(win1, w1, w0), atol=1e-6)
        np.testing.assert_allclose(re, np.where(win1[..., None], r1, r0), atol=1e-6)

    def test_unknown_combine_raises(self, two_checkpoints):
        with pytest.raises(ValueError, match="combine"):
            _ensemble(list(two_checkpoints), "median")
        with pytest.raises(ValueError, match="combine"):
            GIGAPlanner(params=list(two_checkpoints), ensemble_combine="median", device="cpu")

    def test_planner_wrapper_accepts_param_list(self, two_checkpoints, scene_grid):
        net, cfg = get_network("giga")
        planner = GIGAPlanner(net=net, model_cfg=cfg, params=list(two_checkpoints),
                              rng=np.random.RandomState(0), device="cpu", **PCFG)
        grid = scene_grid.numpy()
        grasps, scores, toc = planner(State(tsdf=grid[None]))
        assert isinstance(grasps, list) and toc > 0 and len(grasps) > 0
        assert all(s1 >= s2 for s1, s2 in zip(scores, scores[1:]))
        with pytest.raises(NotImplementedError):
            planner.plan_batch(grid[None])
        with pytest.raises(NotImplementedError):
            PlannerService(planner)


@pytest.mark.parametrize("combine", ["mean", "max"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_ensemble_matches_jax(two_checkpoints, scene_grid, combine, use_kernels):
    """The port's ensemble program (K3's plain version, or the module
    decode) against the JAX package's on the same two members: raw volumes
    within 2e-5, the same candidates."""
    jnet, jcfg = jax_get_network("giga")
    jfn = jax_build_ensemble(jnet, jcfg, JPlannerConfig(**PCFG, **OPEN_WIDTHS), 0.3,
                             combine=combine)
    g = jnp.asarray(scene_grid.numpy())
    jcands, jraw = jax.device_get(jfn(jax_stack_params(list(two_checkpoints)), g, g))
    cands, raw = _raw(_ensemble(list(two_checkpoints), combine, use_kernels, OPEN_WIDTHS),
                      scene_grid)
    for a, b in zip(raw, jraw):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL)
    n = int(jcands.count)
    assert int(cands.count) == n > 0
    np.testing.assert_allclose(cands.positions[:n].numpy(), jcands.positions[:n], atol=1e-7)
    np.testing.assert_allclose(cands.scores[:n].numpy(), jcands.scores[:n], atol=TOL)
    np.testing.assert_allclose(cands.widths[:n].numpy(), jcands.widths[:n], atol=TOL)


def test_stack_params_matches_jax(two_checkpoints):
    stacked = stack_params([flax_to_state_dict(p) for p in two_checkpoints])
    jstacked = jax_stack_params(list(two_checkpoints))["params"]
    np.testing.assert_array_equal(stacked["decoder_aff.fc_p_kernel"].numpy(),
                                  np.asarray(jstacked["decoder_aff"]["fc_p_kernel"]))
    assert stacked["encoder.conv_in.weight"].shape[0] == 2
