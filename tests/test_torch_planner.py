"""The port's planning programs, GIGAPlanner and PlannerService, held
against the JAX package's ``build_batched_giga_planner_fn``,
``build_giga_planner_fn`` and ``GIGAPlanner`` (their XLA paths on the CPU)
on the same scenes and weights.

Candidates must agree in count and lattice positions, with scores, widths
and rotations within 1e-5; candidates are matched by position, so equal
scores in another order (ties) compare equal.
"""

import dataclasses
import threading
from concurrent.futures import CancelledError
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from giga_tpu.core import config as jcfg
from giga_tpu.inference.planner import GIGAPlanner as JGIGAPlanner
from giga_tpu.inference.planner import State as JState
from giga_tpu.inference.planner import build_batched_giga_planner_fn as jax_build
from giga_tpu.inference.planner import build_giga_planner_fn as jax_build_single
from giga_tpu.models.conv_onet import GIGANet as JGIGANet
from giga_tpu.models.registry import load_params
from giga_tpu_torch.core import config as tcfg
from giga_tpu_torch.inference.planner import (
    GIGAPlanner,
    State,
    build_batched_giga_planner_fn,
    build_giga_planner_fn,
    full_precision,
)
from giga_tpu_torch.inference.serving import PlannerService
from giga_tpu_torch.models.conv_onet import GIGANet
from giga_tpu_torch.models.convert import flax_to_state_dict
from giga_tpu_torch.models.registry import load_network

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
R_SMALL = 16
# the seeded small model predicts widths in [-0.33, -0.07]: open the width
# window so that its peaks survive the masking
SMALL_PLAN = dict(resolution=R_SMALL, max_grasps=16, low_th=0.05, qual_th=0.45,
                  min_width=-1.0, max_width=1.0)


def small_cfg(m):
    return m.GIGAConfig(
        encoder=m.EncoderConfig(c_dim=8, plane_resolution=R_SMALL,
                                unet=m.UNet2DConfig(depth=2, start_filts=8)),
        decoder=m.DecoderConfig(c_dim=8, hidden_size=8, n_blocks=2),
    )


@pytest.fixture(scope="module")
def small():
    """(flax net, flax params, port net) sharing seeded weights."""
    jnet = JGIGANet(small_cfg(jcfg))
    t0, p0 = jnp.zeros((1, R_SMALL, R_SMALL, R_SMALL)), jnp.zeros((1, 1, 3))
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0), t0, p0, p0))
    net = GIGANet(small_cfg(tcfg))
    net.load_state_dict(flax_to_state_dict(params))
    return jnet, params, net.eval()


@pytest.fixture(scope="module")
def small_scenes():
    noise = np.random.RandomState(3).rand(1, R_SMALL, R_SMALL, R_SMALL).astype(np.float32)
    return np.concatenate([chip_smoke.make_scenes(2, seed=5, resolution=R_SMALL), noise])


def _host(cands):
    return [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) for x in cands]


def assert_same_candidates(ref, got, R):
    ref, got = _host(ref), _host(got)
    np.testing.assert_array_equal(got[4], ref[4])
    for i, n in enumerate(ref[4]):
        def keyed(c):
            idx = np.rint((c[1][i, :n] + 0.5) * R).astype(int)
            return {tuple(k): j for j, k in enumerate(idx)}

        kr, kg = keyed(ref), keyed(got)
        assert set(kr) == set(kg) and len(kr) == n
        for key, jr in kr.items():
            jg = kg[key]
            for f in range(4):
                np.testing.assert_allclose(got[f][i][jg], ref[f][i][jr], atol=TOL)


@pytest.mark.parametrize("force,k", [(True, 16), (False, 16), (False, 2)])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_small_slice_matches_jax(small, small_scenes, force, k, use_kernels):
    """k = 16 (and 2) over 16^3 lattice points takes JAX's two-level
    top-k; at k = 2 the noise scene's 3 peaks are cut to 2."""
    jnet, params, net = small
    kw = dict(SMALL_PLAN, force_detection=force, max_grasps=k)
    jfn = jax_build(jnet, small_cfg(jcfg), jcfg.PlannerConfig(**kw), 0.3)
    with jax.default_matmul_precision("highest"):
        ref, _ = jax.device_get(jfn(params, jnp.asarray(small_scenes), jnp.asarray(small_scenes)))
    fn = build_batched_giga_planner_fn(net, small_cfg(tcfg), tcfg.PlannerConfig(**kw), 0.3,
                                       use_kernels=use_kernels)
    t = torch.from_numpy(small_scenes)
    got = fn(t, t)
    assert_same_candidates(ref, got, R_SMALL)
    assert int(got.count[2]) == min(k, 3) and int(got.count.min()) > 0


def test_giga_checkpoint_slice_matches_jax():
    """The giga preset at full width, the shipped checkpoint, R = 40, two
    chip_smoke scenes: the port's program (kernels' plain versions on the
    CPU) against the JAX package's."""
    scenes = chip_smoke.make_scenes(2, seed=11)
    params = load_params(REPO / chip_smoke.CHECKPOINT)
    jnet = JGIGANet(jcfg.giga())
    jfn = jax_build(jnet, jcfg.giga(), jcfg.PlannerConfig(**chip_smoke.PLANNER_KW), 0.3)
    with jax.default_matmul_precision("highest"):
        ref, _ = jax.device_get(jfn(params, jnp.asarray(scenes), jnp.asarray(scenes)))
    net, cfg = load_network(REPO / chip_smoke.CHECKPOINT)
    fn = build_batched_giga_planner_fn(net, cfg, tcfg.PlannerConfig(**chip_smoke.PLANNER_KW),
                                       0.3, use_kernels=True)
    t = torch.from_numpy(scenes)
    got = fn(t, t)
    assert_same_candidates(ref, got, 40)
    assert int(got.count.min()) > 0


@pytest.mark.parametrize("force", [True, False])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_single_scene_program_matches_jax(small, small_scenes, force, use_kernels):
    """The single-scene program (K3's plain version with use_kernels, the
    module path without) against JAX's build_giga_planner_fn, scene by
    scene; unbatched candidates, count a 0-d tensor."""
    jnet, params, net = small
    kw = dict(SMALL_PLAN, force_detection=force)
    jfn = jax_build_single(jnet, small_cfg(jcfg), jcfg.PlannerConfig(**kw), 0.3)
    fn = build_giga_planner_fn(net, small_cfg(tcfg), tcfg.PlannerConfig(**kw), 0.3,
                               use_kernels=use_kernels)
    for scene in small_scenes:
        ref, _ = jax.device_get(jfn(params, jnp.asarray(scene), jnp.asarray(scene)))
        t = torch.from_numpy(scene)
        got = fn(t, t)
        assert got.count.shape == () and int(got.count) > 0
        assert_same_candidates([np.asarray(x)[None] for x in ref], [x[None] for x in got],
                               R_SMALL)


def test_single_scene_program_rejects_batches(small, small_scenes):
    _, _, net = small
    fn = build_giga_planner_fn(net, small_cfg(tcfg), tcfg.PlannerConfig(**SMALL_PLAN), 0.3)
    t = torch.from_numpy(small_scenes)
    with pytest.raises(ValueError, match="TSDF"):
        fn(t, t[0])


@pytest.fixture(scope="module")
def giga_planners():
    """The shipped checkpoint in JAX's GIGAPlanner and the port's CPU one,
    chip_smoke's planner settings, best-first."""
    path = REPO / chip_smoke.CHECKPOINT
    jp = JGIGAPlanner(net=JGIGANet(jcfg.giga()), model_cfg=jcfg.giga(),
                      params=load_params(path), **chip_smoke.PLANNER_KW)
    net, cfg = load_network(path)
    tp = GIGAPlanner(net=net, model_cfg=cfg, device="cpu", **chip_smoke.PLANNER_KW)
    return jp, tp, chip_smoke.make_scenes(2, seed=17)


def _assert_grasps_match_jax(ref, got, atol=TOL):
    """Equal counts, equal positions in the same (best-first) order, and
    widths, rotations and scores within ``atol``."""
    (gr, sr), (gg, sg) = ref, got
    assert len(gg) == len(gr) > 0
    np.testing.assert_allclose(sg, sr, atol=atol)
    for a, b in zip(gg, gr):
        np.testing.assert_allclose(a.pose.translation, b.pose.translation, atol=1e-7)
        np.testing.assert_allclose(a.width, b.width, atol=atol)
        np.testing.assert_allclose(a.pose.rotation.as_quat(), b.pose.rotation.as_quat(),
                                   atol=atol)


def test_call_and_plan_stream_match_jax_planner(giga_planners):
    """__call__ (the single-scene program, K3's plain version on the CPU)
    and plan_stream on two R = 40 scenes with the shipped checkpoint, held
    against JAX's GIGAPlanner.__call__ and plan_stream."""
    jp, tp, scenes = giga_planners
    ref = [jp(JState(tsdf=s[None]))[:2] for s in scenes]
    for r, s in zip(ref, scenes):
        _assert_grasps_match_jax(r, tp(State(tsdf=s[None]))[:2])
    for r, g in zip(ref, tp.plan_stream(list(scenes))):
        _assert_grasps_match_jax(r, g)
    for r, g in zip(jp.plan_stream(list(scenes), list(scenes)),
                    tp.plan_stream(iter(scenes), list(scenes))):
        _assert_grasps_match_jax(r, g)


def test_plan_stream_matches_call(small, small_scenes):
    """plan_stream equals per-scene __call__, with and without process
    grids (here: an all-unobserved grid, which masks every grasp)."""
    single = _planner(small)
    stream = _planner(small).plan_stream(small_scenes)
    assert len(stream) == len(small_scenes)
    for scene, got in zip(small_scenes, stream):
        grasps, scores, _ = single(State(tsdf=scene))
        _assert_same_grasps(got, (grasps, scores))
    blank = np.zeros_like(small_scenes)
    assert all(len(g) == 0 for g, _ in _planner(small).plan_stream(small_scenes, blank))
    assert _planner(small).plan_stream([]) == []


def _planner(small, **kw):
    """A CPU GIGAPlanner over the small model, its width window opened
    (GIGAPlanner takes no width arguments) before the program is built."""
    _, _, net = small
    args = dict(SMALL_PLAN, force_detection=True, best=True, rng=np.random.RandomState(0))
    args.update(kw)
    window = {k: args.pop(k) for k in ("min_width", "max_width")}
    p = GIGAPlanner(net=net, model_cfg=small_cfg(tcfg), device="cpu", **args)
    p.planner_cfg = dataclasses.replace(p.planner_cfg, **window)
    return p


def _assert_same_grasps(a, b, atol=1e-6):
    (ga, sa), (gb, sb) = a, b
    assert len(ga) == len(gb)
    for x, y in zip(ga, gb):
        np.testing.assert_array_equal(x.pose.translation, y.pose.translation)
        np.testing.assert_allclose(x.pose.rotation.as_quat(), y.pose.rotation.as_quat(), atol=atol)
        np.testing.assert_allclose(x.width, y.width, atol=atol)
    np.testing.assert_allclose(sa, sb, atol=atol)


@pytest.mark.parametrize("best", [True, False])
def test_plan_batch_matches_call(small, small_scenes, best):
    """plan_batch and per-scene __call__ give equal grasp lists; with
    best=False both draw their permutations from the same RandomState."""
    batched = _planner(small, best=best).plan_batch(small_scenes)
    single = _planner(small, best=best)
    for i, scene in enumerate(small_scenes):
        grasps, scores, toc = single(State(tsdf=scene[None]))
        assert toc >= 0.0
        _assert_same_grasps(batched[i], (grasps, scores))
    assert sum(len(g) for g, _ in batched) > 0


def test_planner_probes(small):
    """All-zeros TSDF -> 0 grasps; NaN grid -> 0 grasps, no crash; wrong
    grid shape -> ValueError."""
    p = _planner(small)
    zeros = np.zeros((R_SMALL,) * 3, np.float32)
    assert len(p(State(tsdf=zeros))[0]) == 0
    assert len(p(State(tsdf=np.full_like(zeros, np.nan)))[0]) == 0
    with pytest.raises(ValueError):
        p.plan_batch(np.zeros((2, 8, 8, 8), np.float32))


def test_state_size_mismatch_raises(small):
    class Volume:
        size, voxel_size = 0.4, 0.4 / R_SMALL

        def get_grid(self):
            return np.zeros((1, R_SMALL, R_SMALL, R_SMALL), np.float32)

    with pytest.raises(ValueError, match="size"):
        _planner(small)(State(tsdf=Volume()))


def _served_equals_batch(planner, scenes, served):
    ref = planner.plan_batch(scenes)
    for a, b in zip(served, ref):
        _assert_same_grasps(a, b)


def test_service_matches_plan_batch(small, small_scenes):
    p = _planner(small)
    with PlannerService(p, batch_size=4, max_wait_ms=1.0) as svc:
        served = [f.result(timeout=120) for f in [svc.submit(t) for t in small_scenes]]
        stats = svc.stats()
    _served_equals_batch(p, small_scenes, served)
    assert stats["requests"] == len(small_scenes) and stats["errors"] == 0


def test_service_partial_batch_and_concurrency(small, small_scenes):
    """Requests from several threads, one at a time or many, all resolve
    with their own scene's result; padded slots do not leak."""
    p = _planner(small)
    results = {}
    with PlannerService(p, batch_size=4, max_wait_ms=1.0) as svc:
        assert len(svc.plan(small_scenes[1], timeout=120)[0]) == len(p.plan_batch(small_scenes[1:2])[0][0])

        def client(i):
            results[i] = svc.submit(small_scenes[i % 3]).result(timeout=120)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    ref = p.plan_batch(small_scenes)
    for i in range(6):
        _assert_same_grasps(results[i], ref[i % 3])


def test_service_lifecycle(small, small_scenes):
    """Bad shapes are refused at submit, close() is idempotent and drains,
    submit after close raises, a full queue raises."""
    p = _planner(small)
    svc = PlannerService(p, batch_size=2, max_wait_ms=1.0, queue_depth=64)
    with pytest.raises(ValueError):
        svc.submit(np.zeros((8, 8, 8), np.float32))
    futs = [svc.submit(s) for s in small_scenes]
    svc.close()
    svc.close()
    assert all(f.done() for f in futs)
    for f in futs:
        try:
            f.result(timeout=0)
        except CancelledError:
            pass
    with pytest.raises(RuntimeError):
        svc.submit(small_scenes[0])
    assert not svc._worker.is_alive()

    tiny = PlannerService(p, batch_size=2, max_wait_ms=50.0, queue_depth=1)
    try:
        with pytest.raises(RuntimeError, match="full"):
            for _ in range(50):
                tiny.submit(small_scenes[0])
    finally:
        tiny.close()


def test_planner_imports_nothing_from_serving():
    """The batched planners' host edge lives in planner.py: serving.py
    depends on it, never the reverse."""
    import ast

    tree = ast.parse((REPO / "giga_tpu_torch" / "inference" / "planner.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names += [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
    assert not [n for n in names if n.split(".")[-1] == "serving"]


def test_full_precision_scope_is_shared_and_restored():
    """TF32 stays off while any plan runs, even when another one ends, and
    the caller's flags come back after the last."""
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    prev = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        outer = full_precision()
        outer.__enter__()
        with full_precision():
            assert not any(f.allow_tf32 for f in flags)
        assert not any(f.allow_tf32 for f in flags)
        outer.__exit__(None, None, None)
        assert all(f.allow_tf32 for f in flags)
    finally:
        for f, v in zip(flags, prev):
            f.allow_tf32 = v
