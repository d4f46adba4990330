"""VGN in the PyTorch port (models/vgn.py, the VGN case of the weight
bridge and registry, and inference/planner.py's VGN programs and
VGNPlanner), on the CPU against the JAX package on the same seeded weights
(``jax_vgn_params``, chip_smoke's recipe) and scenes: VGNNet's outputs
within 2e-5 (README "Numerical fidelity"), the converter's exact round
trip, single and batched candidates equal to JAX's, batch equal to single
within 1e-6, the planners' grasps equal to JAX's VGNPlanner's, the bf16
plan held to the ``highest`` plan by tests/test_vgn_fast.py's four gates,
and the NMS window under ``visualize``.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.serialization import msgpack_serialize

import chip_smoke
from giga_tpu.core.config import PlannerConfig as JPlannerConfig
from giga_tpu.inference.planner import GIGAPlanner as JGIGAPlanner
from giga_tpu.inference.planner import State as JState
from giga_tpu.inference.planner import VGNPlanner as JVGNPlanner
from giga_tpu.inference.planner import build_batched_vgn_planner_fn as jax_batched
from giga_tpu.inference.planner import build_vgn_planner_fn as jax_single
from giga_tpu.models.registry import get_network as jax_get_network
from giga_tpu.models.torch_convert import convert_vgn_state_dict
from giga_tpu.models.vgn import fused_head_conv as jax_fused_head
from giga_tpu_torch.core.config import PlannerConfig, VGNConfig
from giga_tpu_torch.core.precision import full_precision, tf32_precision
from giga_tpu_torch.inference.planner import (
    GIGAPlanner,
    State,
    VGNPlanner,
    build_batched_vgn_planner_fn,
    build_vgn_planner_fn,
)
from giga_tpu_torch.models.convert import flax_to_state_dict, to_reference_state_dict
from giga_tpu_torch.models.registry import get_network, init_network, load_network
from giga_tpu_torch.models.vgn import VGNNet, fused_head_conv

TOL = 2e-5        # VGNNet's outputs (README "Numerical fidelity")
TOL_CAND = 1e-5   # candidates' scores, widths and rotations against JAX's
TOL_BATCH = 1e-6  # batched against single-scene candidates
N_SCENES = 4
REPO = Path(__file__).resolve().parents[1]
VOXEL = chip_smoke.SIZE / 40


def jax_vgn_params():
    """(JAX VGNNet, its seeded parameters): chip_smoke's VGN recipe."""
    net, _ = jax_get_network("vgn")
    params = jax.device_get(net.init(jax.random.PRNGKey(chip_smoke.VGN_SEED),
                                     jnp.zeros((1, 40, 40, 40), jnp.float32)))
    p = params["params"]
    qual = p["conv_qual"]["conv"]
    qual["kernel"] = qual["kernel"] * np.float32(chip_smoke.VGN_QUAL_SCALE)
    qual["bias"] = (qual["bias"] * np.float32(chip_smoke.VGN_QUAL_SCALE)
                    + np.float32(chip_smoke.VGN_QUAL_SHIFT))
    width = p["conv_width"]["conv"]
    width["bias"] = width["bias"] + np.float32(chip_smoke.VGN_WIDTH_SHIFT)
    return net, params


def planner_config(cls):
    kw = dict(chip_smoke.VGN_KW)
    return cls(qual_th=kw["qual_th"], force_detection=kw["force_detection"], best=kw["best"])


def jax_candidates(n: int = N_SCENES, scenes=None):
    """(scenes, JAX's highest single-scene candidates and raw qual per scene,
    JAX's highest batched candidates) on the first n chip_smoke scenes."""
    net, params = jax_vgn_params()
    scenes = chip_smoke.make_scenes(n) if scenes is None else scenes
    single = jax_single(net, planner_config(JPlannerConfig), chip_smoke.SIZE,
                        precision="highest")
    singles = [jax.device_get(single(params, jnp.asarray(g), jnp.asarray(g))) for g in scenes]
    batched = jax_batched(net, planner_config(JPlannerConfig), chip_smoke.SIZE,
                          precision="highest")
    batch = jax.device_get(batched(params, jnp.asarray(scenes), jnp.asarray(scenes)))
    return scenes, singles, batch


@pytest.fixture(scope="module")
def vgn():
    """(JAX net, flax params, the port's VGNNet with the same weights)."""
    jnet, params = jax_vgn_params()
    net, _ = get_network("vgn")
    net.load_state_dict(flax_to_state_dict(params))
    return jnet, params, net.eval()


@pytest.fixture(scope="module")
def jax_plans():
    return jax_candidates()


def _keyed(positions, n):
    return {tuple(np.rint(p).astype(int)): i for i, p in enumerate(np.asarray(positions)[:n])}


def assert_same_candidates(got, ref, tol=TOL_CAND):
    """One scene's candidates: equal counts and positions (lattice indices),
    scores, widths and rotations within ``tol``, matched by position."""
    n = int(ref.count)
    assert int(got.count) == n and n >= 1
    kg, kr = _keyed(got.positions, n), _keyed(ref.positions, n)
    assert set(kg) == set(kr) and len(kr) == n
    for key, i in kr.items():
        j = kg[key]
        for f in ("scores", "widths", "rotations"):
            np.testing.assert_allclose(np.asarray(getattr(got, f))[j],
                                       np.asarray(getattr(ref, f))[i], atol=tol, err_msg=f)


def _cands(c, i=None):
    """Host arrays of one scene's candidates (of scene i of a batch)."""
    fields = [np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t) for t in c]
    return type(c)(*(f if i is None else f[i] for f in fields))


def test_vgnnet_forward_matches_jax(vgn):
    jnet, params, net = vgn
    tsdf = np.random.RandomState(0).rand(2, 40, 40, 40).astype(np.float32)
    jq, jr, jw = jnet.apply(params, jnp.asarray(tsdf))
    with torch.no_grad():
        q, r, w = net(torch.from_numpy(tsdf))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=TOL)
    np.testing.assert_allclose(r.permute(0, 2, 3, 4, 1).numpy(), np.asarray(jr), atol=TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=TOL)
    # the trunk and the fused head, as the planning programs run them
    jx = jnet.apply(params, jnp.asarray(tsdf), method="trunk")
    with torch.no_grad():
        x = net.trunk(torch.from_numpy(tsdf))
        fused = fused_head_conv(net, x)
    np.testing.assert_allclose(x.permute(0, 2, 3, 4, 1).numpy(), np.asarray(jx), atol=TOL)
    for a, b in zip(fused, jax_fused_head(params["params"], jx)):
        a = a.permute(0, 2, 3, 4, 1) if a.ndim == 5 else a
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


def test_fused_head_equals_three_heads(vgn):
    _, _, net = vgn
    tsdf = torch.from_numpy(np.random.RandomState(1).rand(1, 16, 16, 16).astype(np.float32))
    with torch.no_grad():
        for a, b in zip(fused_head_conv(net, net.trunk(tsdf)), net(tsdf)):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_vgnnet_rejects_other_depths():
    with pytest.raises(ValueError):
        VGNNet(VGNConfig(encoder_filters=(16, 32)))


def test_weight_bridge_roundtrips_vgn(vgn):
    """flax -> port state -> reference names -> giga_tpu's own VGN converter
    gives back the flax arrays exactly; the port's names are the reference's."""
    _, params, net = vgn
    sd = to_reference_state_dict(net.state_dict())
    assert set(sd) == set(net.state_dict()) and "decoder.conv3.weight" in sd
    back = convert_vgn_state_dict(sd)
    for name, tree in params["params"].items():
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back["params"][name]["conv"][leaf], tree["conv"][leaf])
    assert tuple(net.encoder.conv1.weight.shape) == (16, 1, 5, 5, 5)
    assert tuple(net.conv_rot.weight.shape) == (4, 16, 5, 5, 5)


def test_registry_loads_vgn_checkpoints(vgn, tmp_path):
    """A ``*_vgn_*.msgpack`` file loads as a VGNNet by its name; init_network
    seeds the vgn preset reproducibly within torch's default bounds."""
    _, params, net = vgn
    path = tmp_path / "synthetic_vgn_seeded.msgpack"
    path.write_bytes(msgpack_serialize(params))
    loaded, cfg = load_network(path)
    assert isinstance(loaded, VGNNet) and isinstance(cfg, VGNConfig) and not loaded.training
    for k, v in net.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, atol=0, rtol=0)
    a, _ = init_network("vgn", seed=5)
    b, _ = init_network("vgn", seed=5)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(v, w, atol=0, rtol=0)
    bound = 1 / (1 * 5 ** 3) ** 0.5
    assert float(a.encoder.conv1.weight.detach().abs().max()) <= bound
    assert float(a.encoder.conv1.bias.detach().abs().max()) <= bound


def test_single_candidates_match_jax(vgn, jax_plans):
    _, _, net = vgn
    scenes, singles, _ = jax_plans
    plan = build_vgn_planner_fn(net, planner_config(PlannerConfig), chip_smoke.SIZE,
                                precision="highest", return_raw=True)
    for g, (ref, raw) in zip(scenes, singles):
        t = torch.from_numpy(g)
        cands, (qual, rot, width) = plan(t, t)
        assert_same_candidates(_cands(cands), ref)
        for a, b in zip((qual, rot, width), raw):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


def test_batched_candidates_match_jax_and_single(vgn, jax_plans):
    """The batched program equals JAX's batched program, and each scene
    equals the port's single-scene program (positions equal, values within
    1e-6: tests/test_vgn_fast.py::test_plan_batch_matches_single)."""
    _, _, net = vgn
    scenes, _, ref = jax_plans
    t = torch.from_numpy(scenes)
    cfg = planner_config(PlannerConfig)
    single = build_vgn_planner_fn(net, cfg, chip_smoke.SIZE, precision="highest")
    got = build_batched_vgn_planner_fn(net, cfg, chip_smoke.SIZE, precision="highest")(t, t)
    for i, g in enumerate(t):
        assert_same_candidates(_cands(got, i), _cands(ref, i))
        one = _cands(single(g, g))
        n = int(one.count)
        assert int(got.count[i]) == n
        np.testing.assert_array_equal(got.positions[i, :n].numpy(), one.positions[:n])
        for f in ("scores", "widths", "rotations"):
            np.testing.assert_allclose(getattr(got, f)[i, :n].numpy(), getattr(one, f)[:n],
                                       atol=TOL_BATCH)


def test_programs_check_shapes(vgn):
    _, _, net = vgn
    plan = build_vgn_planner_fn(net, planner_config(PlannerConfig), chip_smoke.SIZE)
    batched = build_batched_vgn_planner_fn(net, planner_config(PlannerConfig), chip_smoke.SIZE)
    g = torch.zeros(32, 32, 32)
    with pytest.raises(ValueError):
        plan(g, g)
    with pytest.raises(ValueError):
        batched(torch.zeros(2, 40, 40, 40), torch.zeros(1, 40, 40, 40))
    with pytest.raises(ValueError):  # bf16 is the net's dtype, not a scope
        build_vgn_planner_fn(net, planner_config(PlannerConfig), chip_smoke.SIZE,
                             precision="bf16")


def _grasp_rows(result):
    grasps, scores = result[:2]
    return [(g.pose.translation, g.pose.rotation.as_quat(), g.width, s)
            for g, s in zip(grasps, scores)]


def assert_same_grasps(got, ref, tol=TOL_CAND):
    """Two (grasps, scores, ...) results, best-first: equal positions,
    quaternions, widths and scores within ``tol``, matched by position."""
    a, b = _grasp_rows(got), _grasp_rows(ref)
    assert len(a) == len(b) and len(b) >= 1
    key = lambda rows: {tuple(np.rint(r[0] / VOXEL).astype(int)): r for r in rows}
    ka, kb = key(a), key(b)
    assert set(ka) == set(kb)
    for k, (pos, quat, width, score) in kb.items():
        p2, q2, w2, s2 = ka[k]
        np.testing.assert_allclose(p2, pos, atol=1e-6)
        np.testing.assert_allclose(q2, quat, atol=tol)
        assert abs(w2 - width) <= tol and abs(s2 - score) <= tol


def test_vgn_planner_matches_jax(vgn):
    """VGNPlanner.__call__ and plan_batch against JAX's VGNPlanner, at
    ``highest``; ``default`` on the CPU computes the same (TF32 is a CUDA
    setting)."""
    jnet, params, _ = vgn
    scenes = chip_smoke.make_scenes(2)
    kw = dict(params=params, **chip_smoke.VGN_KW)
    ref = JVGNPlanner(net=jnet, precision="highest", **kw)
    got = VGNPlanner(precision="highest", device="cpu", **kw)
    default = VGNPlanner(device="cpu", **kw)
    batch = got.plan_batch(scenes)
    ref_batch = ref.plan_batch(scenes)
    for i, g in enumerate(scenes):
        expect = ref(JState(tsdf=g[None]))
        assert_same_grasps(got(State(tsdf=g[None])), expect)
        assert_same_grasps(batch[i], ref_batch[i])
        assert_same_grasps(default(State(tsdf=g)), got(State(tsdf=g)), tol=0.0)


def test_vgn_planner_rejects_bad_options(vgn):
    _, params, net = vgn
    with pytest.raises(ValueError):
        VGNPlanner(params=params, precision="fp32", device="cpu")
    with pytest.raises(ValueError):
        VGNPlanner(net=copy.deepcopy(net), params=params, device="cpu")


def test_bf16_plan_passes_the_four_gates(vgn):
    """bf16 (a bf16 copy of the net) against ``highest`` by
    tests/test_vgn_fast.py's four decision gates, batched and single."""
    _, params, _ = vgn
    scenes = chip_smoke.make_scenes(N_SCENES)
    kw = dict(params=params, device="cpu", **chip_smoke.VGN_KW)
    hi = VGNPlanner(precision="highest", **kw).plan_batch(scenes)
    bf = VGNPlanner(precision="bf16", **kw)
    assert next(bf.net.parameters()).dtype == torch.bfloat16
    batch = bf.plan_batch(scenes)
    for got in (batch, [bf(State(tsdf=g))[:2] for g in scenes]):
        chip_smoke.bf16_gates(hi, got, VOXEL, "VGN bf16 vs highest",
                              overlap_mean=chip_smoke.VGN_OVERLAP_MEAN)


@pytest.mark.parametrize("visualize,window", [(False, 4), (True, 8)])
def test_nms_window_under_visualize(vgn, visualize, window):
    """Both planners widen the NMS window to 8 under visualize=True
    (tests/test_planner.py::TestNMSWindowRule), as JAX's do."""
    _, params, _ = vgn
    assert VGNPlanner(params=params, visualize=visualize,
                      device="cpu").planner_cfg.max_filter_size == window
    jnet, _ = jax_get_network("vgn")
    assert JVGNPlanner(net=jnet, params=params,
                       visualize=visualize).planner_cfg.max_filter_size == window
    path = REPO / chip_smoke.CHECKPOINT
    assert GIGAPlanner(path, visualize=visualize,
                       device="cpu").planner_cfg.max_filter_size == window
    assert JGIGAPlanner(path, visualize=visualize).planner_cfg.max_filter_size == window


def test_precision_scopes_restore_and_refuse_nesting():
    """TF32 flags are set for a scope and restored after it; a scope of the
    other setting inside one raises instead of waiting for itself."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with tf32_precision():
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        with tf32_precision():
            assert torch.backends.cudnn.allow_tf32
        with pytest.raises(RuntimeError):
            with full_precision():
                pass
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == saved
    with full_precision():
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == saved
