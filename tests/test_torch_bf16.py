"""bf16 serving of the PyTorch port, ``GIGAPlanner(precision="bf16")``, and
the bf16 modes of its kernels, held against the JAX package on the CPU.

The references are the programs the JAX planner runs on a TPU with
``precision="bf16"``: params and the network's TSDF cast to bf16, a float32
postprocess.
  * Batched (``plan_batch``; giga_tpu/inference/planner.py:276-347): the
    Pallas kernels K1 and K2 in their ``compute_dtype=bf16`` modes. On the
    CPU that program takes the XLA path, so the tests compose it from the
    JAX package's own functions with the Pallas kernels in interpret mode.
  * Single-scene (``__call__``, ``plan_stream``): ``GIGAPlanner`` builds it
    without ``use_pallas`` (planner.py:584-585, :76), so it decodes with
    the XLA ``decode_affordance_dense``, all in bf16 (its residual stream,
    sigmoid and quaternion norm too), on the TPU as on the CPU. The tests
    run that planner itself. The port's bf16 ``__call__`` runs K3's bf16
    mode instead (float32 sums, residual stream and heads), the counterpart
    of ``build_giga_planner_fn(use_pallas=True, dtype=bf16)``.

Tolerances: the kernels' bf16 plain versions against the Pallas kernels on
the same inputs keep at least 99.9 % of raw outputs within 1e-5 and every
output within 2e-2 * (1 + |ref|) (chip_smoke.check_bf16: a float32 sum in
another order may flip one bf16 rounding of an activation). The batched
program keeps raw qual within 2e-2 at most and 3e-3 at the median of the
JAX batched program (tests/test_pallas_kernel.py:91-92); the single-scene
program, a bf16 program of another design, within 4e-2 at most and 3e-3 at
the median of JAX's (chip_smoke.check_qual_bf16: each is within 2e-2 of
float32). Both pass tests/test_bf16_serving.py's four decision gates
(chip_smoke.bf16_gates).
"""

import contextlib
import copy
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from giga_tpu.core import config as jcfg
from giga_tpu.inference import dense_decode as jdd
from giga_tpu.inference import postprocess as jpp
from giga_tpu.inference.planner import GIGAPlanner as JGIGAPlanner
from giga_tpu.inference.planner import State as JState
from giga_tpu.inference.planner import _lattice_positions, _maybe_cast
from giga_tpu.models.conv_onet import GIGANet as JGIGANet
from giga_tpu.models.registry import get_network, load_params
from giga_tpu.ops.pallas import decoder_kernel as jdk
from giga_tpu.ops.pallas.stem_kernel import encode_planes_fused as jax_encode_fused
from giga_tpu.ops.pallas.stem_kernel import fused_stem_pool_batched
from giga_tpu_torch.core import config as tcfg
from giga_tpu_torch.inference import dense_decode as tdd
from giga_tpu_torch.inference.planner import GIGAPlanner, State, net_dtype
from giga_tpu_torch.inference.serving import PlannerService
from giga_tpu_torch.models.encoder import encode_planes_fused
from giga_tpu_torch.models.registry import load_network
from giga_tpu_torch.ops.kernels import decoder as tdk
from giga_tpu_torch.ops.kernels.stem import stem_pool_batched, stem_pool_plain
from test_torch_kernels import _feats_case, _jax_trunk, _torch

REPO = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
QUAL_MAX, QUAL_MEDIAN = 2e-2, 3e-3  # tests/test_pallas_kernel.py:91-92
VOXEL = chip_smoke.SIZE / chip_smoke.RESOLUTION


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (as float32)."""
    return torch.from_numpy(np.array(a, np.float32)).to(BF16).float().numpy()


# -- the kernels' bf16 plain versions against the Pallas kernels ---------------

@pytest.mark.parametrize("B,R,C", [(2, 8, 8), (1, 6, 16)])
def test_stem_bf16_plain_matches_pallas_interpret(B, R, C):
    """K1's bf16 mode: bf16 conv operands, float32 sums and means, planes
    rounded to bf16 (as encode_planes_fused casts them for the U-Net)."""
    rng = np.random.RandomState(60 + R)
    kernel = _bf16(rng.uniform(-0.5, 0.5, (3, 3, 3, 1, C)))  # flax DHWIO
    bias = _bf16(rng.uniform(-0.2, 0.2, C))
    tsdf = _bf16(rng.rand(B, R, R, R))
    ref = fused_stem_pool_batched(
        jnp.asarray(kernel, jnp.bfloat16), jnp.asarray(bias, jnp.bfloat16),
        jnp.asarray(tsdf, jnp.bfloat16), kernel_size=3, c_dim=C,
        compute_dtype=jnp.bfloat16, interpret=True)
    weight = torch.from_numpy(np.ascontiguousarray(kernel.transpose(4, 3, 0, 1, 2))).to(BF16)
    got = stem_pool_plain(weight, torch.from_numpy(bias).to(BF16),
                          torch.from_numpy(tsdf).to(BF16))
    for t in ref:
        assert got[t].dtype == BF16 and tuple(got[t].shape) == ref[t].shape
        chip_smoke.check_bf16(got[t], _bf16(np.asarray(ref[t])), f"K1 {t}")


def _decode_case(rng, R, nb, B=None, E=3, H=8, O=4):
    """bf16-valued inputs of K2 (B scenes) or K3 (B None): float32 numpy."""
    F = E * H

    def u(*shape):
        return _bf16(rng.uniform(-0.5, 0.5, shape))

    lead = (nb,) if B is None else (B, nb)
    d = {"px": u(R, F), "py": u(R, F), "pz": u(R, F),
         "pxz": u(*lead, R, R, F), "pxy": u(*lead, R, R, F), "pyz": u(*lead, R, R, F)}
    t = {"w0": u(nb, E, H, H), "b0": u(nb, E, H), "w1": u(nb, E, H, H), "b1": u(nb, E, H),
         "wout": u(E, H, O), "bout": u(E, O)}
    return d, t


def _torch_bf16(*dicts):
    return [torch.from_numpy(v).to(BF16) for d in dicts for v in d.values()]


@pytest.mark.parametrize("B,R,nb", [(2, 8, 2), (3, 6, 1)])
def test_decode_bf16_plain_matches_pallas_interpret(B, R, nb):
    """K2's bf16 mode: bf16 projections (the JAX kernel's ``proj_dtype``),
    bf16 dot operands, float32 sums, assembly and residual stream."""
    d, t = _decode_case(np.random.RandomState(70 + R), R, nb, B)
    jargs = [jnp.asarray(d[k], jnp.bfloat16 if k in ("pxz", "pxy", "pyz") else jnp.float32)
             for k in d]
    ref = np.array(jdk.fused_dense_decode_batched(
        *jargs, *_jax_trunk(t), n_blocks=nb, compute_dtype=jnp.bfloat16, interpret=True,
        transposed=True))
    got = tdk.dense_decode_plain(*_torch_bf16(d, t))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (B, 12, R ** 3)
    chip_smoke.check_bf16(got, ref, "K2 bf16 plain")
    # the float32 mode of the same bf16 values is another function
    assert not torch.equal(got, tdk.dense_decode_plain(*_torch_bf16(d, t),
                                                       compute_dtype=torch.float32))


@pytest.mark.parametrize("R,nb", [(8, 2), (5, 1)])
def test_fused_decode_bf16_plain_matches_pallas_interpret(R, nb):
    """K3's bf16 mode: float32 refs holding bf16 values in JAX, bf16 here."""
    d, t = _decode_case(np.random.RandomState(80 + R), R, nb)
    ref = np.array(jdk.fused_dense_decode(
        *(jnp.asarray(v) for v in d.values()), *_jax_trunk(t), n_blocks=nb,
        compute_dtype=jnp.bfloat16, interpret=True))
    got = tdk.fused_dense_decode_plain(*_torch_bf16(d, t))
    assert tuple(got.shape) == ref.shape == (R, R, R, 12)
    chip_smoke.check_bf16(got, ref, "K3 bf16 plain")


@pytest.mark.parametrize("B,R,C,nb,x_chunk", [(2, 8, 4, 2, 4), (1, 6, 8, 1, 6)])
def test_feats_decode_bf16_plain_matches_pallas_interpret(B, R, C, nb, x_chunk):
    """K4's bf16 mode: every input float32; the operands of the in-kernel
    projections and of the trunk's products rounded to bf16, float32 sums,
    projection rows, assembly and residual stream."""
    d, t = _feats_case(90 + R, B, R, C, nb)
    ref = np.asarray(jdk.fused_dense_decode_feats_batched(
        *(jnp.asarray(v) for v in d.values()), *_jax_trunk(t), n_blocks=nb, x_chunk=x_chunk,
        compute_dtype=jnp.bfloat16, interpret=True))
    got = tdk.dense_decode_feats_plain(*_torch(d), *_torch(t), compute_dtype=BF16)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (B, R, R, R, 12)
    chip_smoke.check_bf16(got, ref, "K4 bf16 plain")
    # the float32 mode on the same inputs is another function
    assert not torch.equal(got, tdk.dense_decode_feats_plain(*_torch(d), *_torch(t)))


@pytest.mark.parametrize("B,R,C,nb", [(2, 8, 4, 2), (1, 6, 8, 1)])
def test_hybrid_decode_bf16_plain_matches_pallas_interpret(B, R, C, nb):
    """K5's bf16 mode: pyz stored in bf16 and widened as it is added last,
    every other input float32; the xz/xy projections' and the trunk's
    operands rounded to bf16."""
    d, t = _feats_case(100 + R, B, R, C, nb)
    pyz = _bf16(np.random.RandomState(110 + R).uniform(-0.5, 0.5, (B, nb, R, R, 12)))
    args = [d["px"], d["py"], d["pz"], d["fxz"], d["fxy"], pyz, d["wxz"], d["wxy"]]
    ref = np.asarray(jdk.fused_dense_decode_hybrid_batched(
        *(jnp.asarray(v, jnp.bfloat16 if i == 5 else jnp.float32) for i, v in enumerate(args)),
        *_jax_trunk(t), n_blocks=nb, compute_dtype=jnp.bfloat16, interpret=True))
    targs = [torch.from_numpy(v) for v in args]
    targs[5] = targs[5].to(BF16)
    got = tdk.dense_decode_hybrid_plain(*targs, *_torch(t))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (B, R, R, R, 12)
    chip_smoke.check_bf16(got, ref, "K5 bf16 plain")


def test_prepare_projections_bf16_matches_jax():
    """The bf16 inputs of K2 and K3 equal the JAX package's: px/py/pz and
    the projections computed in bf16, the weights cast."""
    cfg = lambda m: m.GIGAConfig(  # noqa: E731
        encoder=m.EncoderConfig(c_dim=8, plane_resolution=8,
                                unet=m.UNet2DConfig(depth=2, start_filts=4)),
        decoder=m.DecoderConfig(c_dim=8, hidden_size=8, n_blocks=2))
    jnet = JGIGANet(cfg(jcfg))
    t0, p0 = jnp.zeros((1, 8, 8, 8)), jnp.zeros((1, 1, 3))
    params = jax.device_get(jnet.init(jax.random.PRNGKey(6), t0, p0, p0))
    jdec = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params["params"]["decoder_aff"])
    from giga_tpu_torch.models.conv_onet import GIGANet
    from giga_tpu_torch.models.convert import flax_to_state_dict

    net = GIGANet(cfg(tcfg))
    net.load_state_dict(flax_to_state_dict(params))
    dec = {k: v.detach() for k, v in net.decoder_aff.params().items()}
    rng = np.random.RandomState(13)
    feats = {k: _bf16(rng.randn(2, 8, 8, 8)) for k in ("xz", "xy", "yz")}
    coords = np.linspace(-0.5, 0.5 - 1.0 / 8, 8).astype(np.float32)
    ref = jdk.prepare_projections_batched(
        jdec, {k: jnp.asarray(v, jnp.bfloat16) for k, v in feats.items()}, jnp.asarray(coords),
        2, proj_dtype=jnp.bfloat16)
    got = tdk.prepare_projections_batched(dec, {k: torch.from_numpy(v) for k, v in feats.items()},
                                          torch.from_numpy(coords), 2, BF16)
    assert all(g.dtype == BF16 for g in got)
    for r, g in zip(ref[:6], got[:6]):
        r = np.asarray(r, np.float32)
        assert tuple(g.shape) == r.shape
        # each product rounds once to bf16 in both; the sum order may differ
        np.testing.assert_allclose(g.float().numpy(), r, rtol=2 ** -7, atol=1e-6)
        assert np.mean(g.float().numpy() == r) > 0.99
    single = tdk.prepare_projections(dec, {k: torch.from_numpy(v[0]) for k, v in feats.items()},
                                     torch.from_numpy(coords), 2, BF16)
    for s, g in zip(single[3:6], got[3:6]):
        assert torch.equal(s, g[0])


def test_lattice_sampling_bf16_matches_jax():
    """Sampling keeps the planes' dtype: bf16 planes, the interpolation
    matrix cast to bf16, each of the two products rounded to bf16."""
    rng = np.random.RandomState(15)
    planes = {k: _bf16(rng.randn(2, 8, 8, 8)) for k in ("xz", "xy", "yz")}
    coords = np.linspace(-0.5, 0.5 - 1.0 / 12, 12).astype(np.float32)
    ref = jdd.sample_planes_on_lattice_batched(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in planes.items()}, jnp.asarray(coords), 8, 0.0)
    got = tdd.sample_planes_on_lattice_batched(
        {k: torch.from_numpy(v).to(BF16) for k, v in planes.items()}, torch.from_numpy(coords),
        8, 0.0)
    for k in planes:
        r = np.asarray(ref[k], np.float32)
        assert got[k].dtype == BF16 and tuple(got[k].shape) == r.shape == (2, 12, 12, 8)
        np.testing.assert_allclose(got[k].float().numpy(), r, rtol=2 ** -7, atol=1e-6)
        assert np.mean(got[k].float().numpy() == r) > 0.99


def test_bf16_wrappers_on_cpu_take_the_plain_versions():
    """bf16 CPU tensors run the bf16 plain versions and launch nothing."""
    rng = np.random.RandomState(9)
    w = torch.from_numpy(rng.uniform(-0.5, 0.5, (8, 1, 3, 3, 3)).astype(np.float32)).to(BF16)
    b = torch.zeros(8, dtype=BF16)
    t = torch.from_numpy(rng.rand(1, 6, 6, 6).astype(np.float32)).to(BF16)
    d, tr = _decode_case(rng, 6, 1, B=1)
    args = _torch_bf16(d, tr)
    n = (stem_pool_batched.launches, tdk.dense_decode_batched.launches)
    got = stem_pool_batched(w, b, t)
    for k, v in stem_pool_plain(w, b, t).items():
        assert got[k].dtype == BF16 and torch.equal(got[k], v)
    assert torch.equal(tdk.dense_decode_batched(*args), tdk.dense_decode_plain(*args))
    assert (stem_pool_batched.launches, tdk.dense_decode_batched.launches) == n


# -- the programs against the JAX package's TPU bf16 programs ------------------

def jax_tpu_batched_program(model_cfg, planner_cfg, size, precision: str = "bf16",
                            fold_b1: bool = False, hidden_bf16: bool = False):
    """The JAX package's jitted TPU batched program (params, tsdfs,
    tsdf_process) -> (GraspCandidates, float32 raw (qual, rot, width)) in
    ``precision`` ("bf16", or "fp32" at the "highest" matmul precision) with
    its decode options ``pallas_fold_b1`` / ``pallas_hidden_bf16``
    (giga_tpu/inference/planner.py:276-347 as it runs on a TPU: K1 and K2
    Pallas, here in interpret mode); rot is (B, 4, R^3), as its transposed
    head write leaves it."""
    voxel = size / planner_cfg.resolution
    R, P = planner_cfg.resolution, model_cfg.encoder.plane_resolution
    nb, padding = model_cfg.decoder.n_blocks, model_cfg.decoder.padding
    bf16 = precision == "bf16"
    compute = jnp.bfloat16 if bf16 else jnp.float32

    @jax.jit
    def batched(params, tsdfs, proc):
        with contextlib.nullcontext() if bf16 else jax.default_matmul_precision("highest"):
            p, t = _maybe_cast(params["params"], tsdfs, jnp.bfloat16 if bf16 else None)
            planes = jax_encode_fused(p["encoder"], t, model_cfg.encoder, compute_dtype=compute,
                                      interpret=True)
            coords = jdd.lattice_coords(R)
            feats = jdd.sample_planes_on_lattice_batched(planes, coords, P, padding)
            raw = jdk.decode_affordance_dense_pallas_batched(
                p["decoder_aff"], feats, coords, nb, compute_dtype=compute, interpret=True,
                transposed=True, fold_b1=fold_b1, hidden_bf16=hidden_bf16)
            raw = tuple(x.astype(jnp.float32) for x in raw)
            q, r, w = raw
            masked = jpp.bound_quality(jpp.mask_quality(q, proc, w, planner_cfg), voxel,
                                       planner_cfg)
            return (jpp.select_grasps_batched(masked, r, w, _lattice_positions(coords),
                                              planner_cfg), raw)

    return batched


@functools.cache
def jax_tpu_reference(n_scenes: int, precision: str = "bf16", fold_b1: bool = False,
                      hidden_bf16: bool = False):
    """The JAX TPU batched program (``jax_tpu_batched_program``) on
    chip_smoke's first scenes with the shipped checkpoint: (scenes, (cands,
    raw))."""
    scenes = chip_smoke.make_scenes(n_scenes)
    params = load_params(REPO / chip_smoke.CHECKPOINT)
    batched = jax_tpu_batched_program(
        jcfg.giga(), jcfg.PlannerConfig(**chip_smoke.PLANNER_KW), chip_smoke.SIZE, precision,
        fold_b1, hidden_bf16)
    return scenes, jax.device_get(batched(params, jnp.asarray(scenes), jnp.asarray(scenes)))


@functools.cache
def jax_bf16_planner_reference(n_scenes: int):
    """JAX's ``GIGAPlanner(precision="bf16")`` on chip_smoke's first scenes
    with the shipped checkpoint: (scenes, per scene its single-scene
    program's (cands, float32 raw (qual, rot, width)), per scene its
    ``__call__``'s (grasps, scores))."""
    net, cfg = get_network("giga")
    planner = JGIGAPlanner(net=net, model_cfg=cfg, params=load_params(REPO / chip_smoke.CHECKPOINT),
                           precision="bf16", size=chip_smoke.SIZE, **chip_smoke.PLANNER_KW)
    scenes = chip_smoke.make_scenes(n_scenes)
    programs = [jax.device_get(planner._fn(planner.params, jnp.asarray(s), jnp.asarray(s)))
                for s in scenes]
    called = [planner(JState(tsdf=s[None]))[:2] for s in scenes]
    return scenes, programs, called


@pytest.fixture(scope="module")
def planners():
    """(fp32, bf16) port planners on the CPU with the shipped checkpoint."""
    kw = dict(size=chip_smoke.SIZE, device="cpu", **chip_smoke.PLANNER_KW)
    net, cfg = load_network(REPO / chip_smoke.CHECKPOINT)
    fp32 = GIGAPlanner(net=net, model_cfg=cfg, rng=np.random.RandomState(0), **kw)
    bf16 = GIGAPlanner(net=net, model_cfg=cfg, rng=np.random.RandomState(0), precision="bf16",
                       **kw)
    return fp32, bf16


def _grasps(planner, cands, i):
    from giga_tpu_torch.inference.postprocess import GraspCandidates

    return planner._to_grasps(GraspCandidates(*(np.asarray(x[i]) for x in cands)))


def _assert_raw_close(got, ref, rot_axis):
    """Raw volumes of two bf16 programs: qual within the bf16 gates, rot
    and width finite and of the same shape."""
    dq = np.abs(np.asarray(got[0]) - np.asarray(ref[0]))
    assert dq.max() <= QUAL_MAX and np.median(dq) <= QUAL_MEDIAN, (dq.max(), np.median(dq))
    for g, r in zip(got[1:], ref[1:]):
        assert g.shape == r.shape and np.isfinite(g).all()
    dr = np.abs(np.asarray(got[1]) - np.asarray(ref[1])).max(axis=rot_axis)
    assert np.median(dr) <= QUAL_MEDIAN


def test_bf16_batched_program_matches_jax_tpu_bf16(planners):
    """plan_batch in bf16 (K1 and K2's plain versions on the CPU) against
    the JAX TPU bf16 batched program: raw volumes and decisions."""
    _, bf16 = planners
    scenes, (ref_cands, ref_raw) = jax_tpu_reference(4)
    net, cfg = bf16.net, bf16.model_cfg
    t = torch.from_numpy(scenes)
    with torch.inference_mode():
        planes = encode_planes_fused(net.encoder, t.to(BF16))
        assert all(v.dtype == BF16 for v in planes.values())
        coords = tdd.lattice_coords(40)
        feats = tdd.sample_planes_on_lattice_batched(planes, coords, 40, 0.0)
        raw = tdk.decode_affordance_dense_kernel_batched(
            net.decoder_aff.params(), feats, coords, cfg.decoder.n_blocks, BF16)
    _assert_raw_close([v.numpy() for v in raw], ref_raw, rot_axis=1)
    got = bf16.plan_batch(scenes)
    ref = [_grasps(bf16, ref_cands, i) for i in range(len(scenes))]
    chip_smoke.bf16_gates(ref, got, VOXEL, "bf16 plan_batch vs JAX TPU bf16")


def test_bf16_single_scene_program_matches_jax_tpu_bf16(planners):
    """__call__ in bf16 (the module encoder in bf16, K3's bf16 plain
    version) against JAX's GIGAPlanner(precision="bf16") on the four golden
    scenes: its single-scene program's raw volumes (qual by
    chip_smoke.check_qual_bf16; rot and width finite, of its shapes), and
    its __call__'s grasps by the four gates, for __call__ and plan_stream;
    plan_stream equals per-scene calls."""
    _, bf16 = planners
    scenes, programs, ref = jax_bf16_planner_reference(4)
    net, cfg = bf16.net, bf16.model_cfg
    coords = tdd.lattice_coords(40)
    got = []
    for scene, (_, ref_raw) in zip(scenes, programs):
        with torch.inference_mode():
            tsdf = torch.from_numpy(scene)[None].to(BF16)
            planes = {k: v[0] for k, v in net.encode(tsdf).items()}
            feats = tdd.sample_planes_on_lattice(planes, coords, 40, 0.0)
            raw = tdk.decode_affordance_dense_kernel(net.decoder_aff.params(), feats, coords,
                                                     cfg.decoder.n_blocks, BF16)
        chip_smoke.check_qual_bf16(raw[0].numpy(), ref_raw[0], "bf16 __call__ raw qual")
        for g, r in zip(raw[1:], ref_raw[1:]):
            assert tuple(g.shape) == r.shape and bool(torch.isfinite(g).all())
        got.append(bf16(State(tsdf=scene[None]))[:2])
    chip_smoke.bf16_gates(ref, got, VOXEL, "bf16 __call__ vs JAX bf16 GIGAPlanner")
    streamed = bf16.plan_stream(scenes)
    chip_smoke.bf16_gates(ref, streamed, VOXEL, "bf16 plan_stream vs JAX bf16 GIGAPlanner")
    for (g1, s1), (g2, s2) in zip(streamed, got):
        np.testing.assert_array_equal(s1, s2)
        assert [g.pose.translation.tolist() for g in g1] == [g.pose.translation.tolist()
                                                            for g in g2]


def test_bf16_planner_against_fp32_planner(planners):
    """The port's bf16 plans against its fp32 plans on 16 scenes by the four
    gates, plan_batch and __call__ alike; PlannerService equals plan_batch."""
    fp32, bf16 = planners
    scenes = chip_smoke.make_scenes(16, seed=21)
    ref = fp32.plan_batch(scenes)
    got = bf16.plan_batch(scenes)
    assert sum(len(g) for g, _ in ref) >= 8 * len(scenes)
    chip_smoke.bf16_gates(ref, got, VOXEL, "bf16 vs fp32 plan_batch")
    called = [bf16(State(tsdf=s[None]))[:2] for s in scenes[:4]]
    chip_smoke.bf16_gates(ref[:4], called, VOXEL, "bf16 __call__ vs fp32 plan_batch")
    with PlannerService(bf16, batch_size=4, max_wait_ms=5.0) as svc:
        served = [f.result(timeout=120) for f in [svc.submit(s) for s in scenes[:4]]]
    for (g1, s1), (g2, s2) in zip(served, got[:4]):
        np.testing.assert_allclose(s1, s2, atol=1e-6)
        assert len(g1) == len(g2)


def test_bf16_planner_copies_the_net(planners):
    """precision='bf16' plans with a bf16 copy; the net handed in stays
    float32, and the fp32 planner's programs stay float32."""
    fp32, bf16 = planners
    assert net_dtype(bf16.net) == BF16 and net_dtype(fp32.net) == torch.float32
    assert bf16.net is not fp32.net
    with pytest.raises(ValueError):
        GIGAPlanner(net=copy.deepcopy(fp32.net), model_cfg=fp32.model_cfg, precision="fp16",
                    device="cpu")
