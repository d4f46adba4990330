"""The kernels' shape predicates and the paths the planning programs choose
from them, on the CPU (the card's tests/test_torch_cuda.py holds each
predicate against its kernel's launch configuration).

Every preset the JAX package plans must plan in the port: K1 where it takes
the TSDF (float32 Y * ceil(Z / 4) <= 416, bf16 Z <= 48 and ceil(Y / 10) *
ceil(Z / 16) <= 12), K2/K3 where they take the trunk (hidden 32, 4
outputs; float32 n_blocks <= 15, bf16 n_blocks <= 22), the module paths
elsewhere. giga_wide (hidden 64) planned with the kernels' programs on the
CPU takes the module decode and equals the JAX package's plan.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from giga_tpu.core.config import PlannerConfig as JPlannerConfig
from giga_tpu.inference.planner import build_giga_planner_fn as jax_build_single
from giga_tpu.inference.planner import GIGAPlanner as JGIGAPlanner
from giga_tpu.inference.planner import State as JState
from giga_tpu.models.registry import get_network as jax_get_network
from giga_tpu_torch.core.config import PlannerConfig, get_config
from giga_tpu_torch.inference.planner import (
    GIGAPlanner,
    State,
    build_batched_giga_planner_fn,
    build_giga_planner_fn,
    program_paths,
)
from giga_tpu_torch.models.convert import flax_to_state_dict
from giga_tpu_torch.models.encoder import can_encode_fused
from giga_tpu_torch.models.registry import get_network
from giga_tpu_torch.ops.kernels.decoder import can_dense_decode, can_dense_decode_feats
from giga_tpu_torch.ops.kernels.stem import can_stem_pool

F32, BF16 = torch.float32, torch.bfloat16
PRESETS = ("giga", "giga_wide", "giga_geo")


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("reso", [32, 40, 48])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_stem_predicate_on_presets(preset, reso, dtype):
    """K1 takes every preset's channels (32 or 64) at plane resolution 32
    and 40, none at 48."""
    C = get_config(preset).encoder.c_dim
    assert can_stem_pool(64, reso, reso, reso, C, dtype) == (reso <= 40)
    enc = dataclasses.replace(get_config(preset).encoder, plane_resolution=reso)
    assert can_encode_fused(enc, (64, reso, reso, reso), dtype) == (reso <= 40)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("reso", [32, 40, 48])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_decode_predicates_on_presets(preset, reso, dtype):
    """K2-K5 take the hidden-32 presets (giga, giga_geo) at every lattice,
    never giga_wide's hidden 64."""
    dec = get_config(preset).decoder
    expect = dec.hidden_size == 32
    for point_major in (False, True):
        assert can_dense_decode(64, reso, 3, dec.hidden_size, 4, dec.n_blocks, dtype,
                                point_major) == expect
    for hybrid in (False, True):
        assert can_dense_decode_feats(64, reso, dec.c_dim, 3, dec.hidden_size, 4, dec.n_blocks,
                                      reso if hybrid else 40, hybrid, dtype) == expect


@pytest.mark.parametrize("nb,f32,bf16", [(1, True, True), (15, True, True), (16, False, True),
                                         (22, False, True), (23, False, False), (0, True, False)])
def test_decode_predicate_block_limits(nb, f32, bf16):
    """float32: the weights and 12 warps' activation tiles fit a block's
    shared memory up to 15 blocks; bf16: a slab shape fits up to 22 (NB 23
    raises on the card, test_bf16_kernel_raises_where_no_slab_fits), and a
    pyz fetch one step ahead needs one block."""
    assert can_dense_decode(64, 40, 3, 32, 4, nb, F32) == f32
    assert can_dense_decode(64, 40, 3, 32, 4, nb, BF16) == bf16
    assert can_dense_decode(1, 40, 3, 32, 4, nb, BF16, point_major=True) == bf16


def test_decode_predicate_modes():
    """The option sets each mode has: resident_bf16 is bf16's; K3 takes none."""
    assert can_dense_decode(8, 40, 3, 32, 4, 5, BF16, fold_b1=True, resident_bf16=True)
    assert not can_dense_decode(8, 40, 3, 32, 4, 5, F32, resident_bf16=True)
    assert not can_dense_decode(1, 40, 3, 32, 4, 5, F32, point_major=True, fold_b1=True)
    assert not can_dense_decode(1, 40, 3, 32, 1, 5, F32)
    assert not can_dense_decode(1, 40, 3, 32, 4, 5, torch.float16)


def test_feats_predicate_limits():
    assert can_dense_decode_feats(2, 40, 854, 8, 32, 4, 14, 1)
    assert not can_dense_decode_feats(2, 40, 855, 3, 32, 4, 5, 40)  # staged rows
    assert not can_dense_decode_feats(2, 40, 32, 9, 32, 4, 5, 40)  # projection threads
    assert not can_dense_decode_feats(2, 40, 32, 3, 32, 4, 15, 40)
    # bf16 at R = 40: the weights, the projections' fragments (K4 three planes,
    # K5 two), 2 slab stages and 15 warps' rings fit up to NB 14 (K4) and 18 (K5)
    assert can_dense_decode_feats(2, 40, 32, 3, 32, 4, 14, 40, dtype=BF16)
    assert not can_dense_decode_feats(2, 40, 32, 3, 32, 4, 15, 40, dtype=BF16)
    assert can_dense_decode_feats(2, 40, 32, 3, 32, 4, 18, 40, hybrid=True, dtype=BF16)
    assert not can_dense_decode_feats(2, 40, 32, 3, 32, 4, 19, 40, hybrid=True, dtype=BF16)
    # bf16 takes 32 channels only (one 64-byte TMA row), and an x-plane of at
    # most 256 rows (one TMA box)
    for hybrid in (False, True):
        for C in (8, 16, 31, 33, 64):
            assert not can_dense_decode_feats(2, 40, C, 3, 32, 4, 5, 40, hybrid, BF16)
        assert can_dense_decode_feats(2, 256, 32, 3, 32, 4, 5, 40, hybrid, BF16)
        assert not can_dense_decode_feats(2, 257, 32, 3, 32, 4, 5, 40, hybrid, BF16)
        assert not can_dense_decode_feats(2, 40, 32, 3, 32, 4, 5, 0, hybrid, BF16)
    assert not can_dense_decode_feats(2, 40, 32, 3, 32, 4, 5, 0)


@pytest.mark.parametrize("preset,reso,batched,single", [
    ("giga", 40, {"encode": "K1", "decode": "K2"}, {"encode": "module", "decode": "K3"}),
    ("giga_wide", 40, {"encode": "K1", "decode": "module"},
     {"encode": "module", "decode": "module"}),
    ("giga", 48, {"encode": "module", "decode": "K2"}, {"encode": "module", "decode": "K3"}),
])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_program_paths(preset, reso, batched, single, dtype):
    cfg = get_config(preset)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, plane_resolution=reso))
    pcfg = PlannerConfig()
    assert program_paths(cfg, pcfg, dtype, True, batched=True) == batched
    assert program_paths(cfg, pcfg, dtype, True, batched=False) == single
    assert program_paths(cfg, pcfg, dtype, False, batched=True) == {"encode": "module",
                                                                     "decode": "module"}


@pytest.fixture(scope="module")
def wide():
    """(flax net, flax params, port net) of the giga_wide preset with seeded weights."""
    jnet, _ = jax_get_network("giga_wide")
    t0, p0 = jnp.zeros((1, 40, 40, 40)), jnp.zeros((1, 1, 3))
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0), t0, p0, p0))
    net, _ = get_network("giga_wide")
    net.load_state_dict(flax_to_state_dict(params))
    return jnet, params, net.eval()


# the seeded giga_wide's widths lie outside the default window
WIDE_PLAN = dict(force_detection=True, best=True, min_width=-1.0, max_width=1.0, qual_th=0.5,
                 low_th=0.3)


def test_giga_wide_plans_with_the_kernel_programs_on_the_cpu(wide):
    """The kernels' programs (use_kernels) choose the module decode for
    giga_wide and equal the JAX package's plan, candidates within 2e-5 and
    the same positions; the batched program plans every scene as the
    single-scene one does."""
    jnet, params, net = wide
    scenes = chip_smoke.make_scenes(2)
    single = build_giga_planner_fn(net, net.cfg, PlannerConfig(**WIDE_PLAN), 0.3,
                                   use_kernels=True)
    batched = build_batched_giga_planner_fn(net, net.cfg, PlannerConfig(**WIDE_PLAN), 0.3,
                                            use_kernels=True)
    assert single.paths == {"encode": "module", "decode": "module"}
    assert batched.paths == {"encode": "K1", "decode": "module"}
    jfn = jax_build_single(jnet, jnet.cfg, JPlannerConfig(**WIDE_PLAN), 0.3)
    grids = torch.from_numpy(scenes)
    cb = batched(grids, grids)
    for i, g in enumerate(scenes):
        jc, _ = jax.device_get(jfn(params, jnp.asarray(g), jnp.asarray(g)))
        c = single(grids[i], grids[i])
        n = int(jc.count)
        assert int(c.count) == int(cb.count[i]) == n > 0
        np.testing.assert_allclose(c.positions[:n].numpy(), jc.positions[:n], atol=1e-7)
        np.testing.assert_allclose(c.scores[:n].numpy(), jc.scores[:n], atol=2e-5)
        np.testing.assert_allclose(c.widths[:n].numpy(), jc.widths[:n], atol=2e-5)
        np.testing.assert_allclose(cb.scores[i, :n].numpy(), jc.scores[:n], atol=2e-5)


def test_giga_wide_call_matches_jax_planner(wide):
    """GIGAPlanner(model_type="giga_wide").__call__ on the CPU equals the
    JAX package's GIGAPlanner.__call__ on the same weights."""
    jnet, params, _ = wide
    scene = chip_smoke.make_scenes(1)[0]
    kw = dict(force_detection=True, best=True, qual_th=0.5, low_th=0.3)
    jplanner = JGIGAPlanner(net=jnet, model_cfg=jnet.cfg, params=params, **kw)
    planner = GIGAPlanner(params=params, model_type="giga_wide", device="cpu", **kw)
    assert planner._ensure_fn().paths == {"encode": "module", "decode": "module"}
    jg, js, _ = jplanner(JState(tsdf=scene[None]))
    g, s, _ = planner(State(tsdf=scene[None]))
    assert len(g) == len(jg) > 0
    np.testing.assert_allclose(s, js, atol=2e-5)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a.pose.translation, b.pose.translation, atol=1e-6)
        np.testing.assert_allclose(a.width, b.width, atol=2e-5)
