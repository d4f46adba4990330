"""K2's numeric options in the PyTorch port, held against the JAX package on
the CPU: ``fold_b1``, ``hidden_bf16`` and ``resident_bf16`` of
``fused_dense_decode_batched`` (giga_tpu/ops/pallas/decoder_kernel.py:282),
reached through ``prepare_projections_batched(fold_b1=)``,
``decode_affordance_dense_kernel_batched`` and the batched program's
``fold_b1`` / ``hidden_bf16`` / ``return_raw`` (the JAX package's
``pallas_fold_b1``, ``pallas_hidden_bf16`` and ``return_raw``), and the
``profile_batched`` script.

On the CPU the JAX package's batched program takes its XLA path and ignores
the decode options, so the programs are held against its TPU program
rebuilt from its own functions with the Pallas kernels in interpret mode
(tests/test_torch_bf16.py::jax_tpu_batched_program).

Tolerances: float32 outputs within 1e-5 (tests/test_pallas_kernel.py); the
bf16 modes by chip_smoke.check_bf16 (at least 99.9 % of outputs within
1e-5, all within 2e-2 * (1 + |ref|)); bf16 programs by the four decision
gates of tests/test_bf16_serving.py and raw qual within 2e-2 at most and
3e-3 at the median. ``hidden_bf16`` is bit-equal to the default bf16 mode
(ReLU commutes with rounding). ``resident_bf16``'s plain version matched the
interpret-mode kernel within 6e-8 on these inputs (share within 1e-5: 1.0),
and differs from the default bf16 mode by ~3e-2.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from giga_tpu.core import config as jcfg
from giga_tpu.inference.planner import build_batched_giga_planner_fn as jax_build
from giga_tpu.models.conv_onet import GIGANet as JGIGANet
from giga_tpu.ops.pallas import decoder_kernel as jdk
from giga_tpu_torch.core import config as tcfg
from giga_tpu_torch.inference.planner import GIGAPlanner, build_batched_giga_planner_fn
from giga_tpu_torch.models.conv_onet import GIGANet
from giga_tpu_torch.models.convert import flax_to_state_dict
from giga_tpu_torch.models.registry import load_network
from giga_tpu_torch.ops.kernels import decoder as tdk
from giga_tpu_torch.scripts import profile_batched

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from test_torch_bf16 import (  # noqa: E402
    QUAL_MAX, QUAL_MEDIAN, VOXEL, _decode_case, _torch_bf16, jax_tpu_reference)
from test_torch_kernels import _jax_trunk, _torch  # noqa: E402
from test_torch_planner import SMALL_PLAN, small, small_cfg, small_scenes  # noqa: E402, F401

TOL = 1e-5  # tests/test_pallas_kernel.py
BF16 = torch.bfloat16
SHAPES = [(2, 8, 3), (3, 6, 2)]  # (B, R, n_blocks)


def _pallas(d, t, nb, bf16, **options):
    """JAX's fused_dense_decode_batched in interpret mode, (O, rows) layout;
    in bf16 the projections bf16 and every other input float32 holding bf16
    values, as its bf16 program passes them."""
    args = [jnp.asarray(v, jnp.bfloat16 if bf16 and k in ("pxz", "pxy", "pyz") else jnp.float32)
            for k, v in d.items()]
    return np.asarray(jdk.fused_dense_decode_batched(
        *args, *_jax_trunk(t), n_blocks=nb, compute_dtype=jnp.bfloat16 if bf16 else jnp.float32,
        interpret=True, transposed=True, **options))


# -- the plain versions against the Pallas kernel -----------------------------

@pytest.mark.parametrize("B,R,nb", SHAPES)
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_fold_plain_matches_pallas_interpret(precision, B, R, nb):
    """fold_b1: every block but the last skips its b1 add; float32 within
    1e-5, bf16 by check_bf16. The fold is another function on these inputs
    (their b1 is not in pxz)."""
    d, t = _decode_case(np.random.RandomState(200 + R), R, nb, B)
    bf16 = precision == "bf16"
    ref = _pallas(d, t, nb, bf16, fold_b1=True)
    args = _torch_bf16(d, t) if bf16 else _torch(d) + _torch(t)
    got = tdk.dense_decode_plain(*args, fold_b1=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (B, 12, R ** 3)
    if bf16:
        chip_smoke.check_bf16(got, ref, "K2 bf16 fold plain")
    else:
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL)
    assert not torch.equal(got, tdk.dense_decode_plain(*args))


@pytest.mark.parametrize("fold_b1", [False, True])
def test_hidden_bf16_is_the_bf16_mode(fold_b1):
    """hidden_bf16 rounds the hidden stream before its ReLU, the bf16 mode
    rounds relu(hidden): bit-equal in JAX interpret mode, and the port's
    entry point takes the flag and gives the same bytes."""
    d, t = _decode_case(np.random.RandomState(210), 8, 3, 2)
    np.testing.assert_array_equal(_pallas(d, t, 3, True, fold_b1=fold_b1, hidden_bf16=True),
                                  _pallas(d, t, 3, True, fold_b1=fold_b1))
    jdec, tdec, jc, tc, jf, tf = _decoder(BF16)
    got = [tdk.decode_affordance_dense_kernel_batched(tdec, tf, tc, 3, BF16, fold_b1=fold_b1,
                                                      hidden_bf16=h) for h in (True, False)]
    assert all(torch.equal(a, b) for a, b in zip(*got))


@pytest.mark.parametrize("B,R,nb", SHAPES)
@pytest.mark.parametrize("fold_b1", [False, True])
def test_resident_plain_matches_pallas_interpret(fold_b1, B, R, nb):
    """resident_bf16: the residual stream rounded to bf16 after the block-0
    assembly, each plane add and each residual add; by check_bf16 against
    the interpret-mode kernel, and another function than the default bf16
    mode."""
    d, t = _decode_case(np.random.RandomState(220 + R), R, nb, B)
    ref = _pallas(d, t, nb, True, fold_b1=fold_b1, resident_bf16=True)
    got = tdk.dense_decode_plain(*_torch_bf16(d, t), fold_b1=fold_b1, resident_bf16=True)
    share, _, worst = chip_smoke.check_bf16(got, ref, "K2 bf16 resident plain")
    assert share == 1.0 and worst < 1e-6
    default = tdk.dense_decode_plain(*_torch_bf16(d, t), fold_b1=fold_b1)
    assert float((got - default).abs().max()) > 1e-3


def test_resident_is_a_bf16_option():
    """A float32 resident stream is refused (the JAX wrapper never asks for
    it); on the CPU as on the card, before anything runs."""
    d, t = _decode_case(np.random.RandomState(230), 6, 2, 1)
    args = _torch(d) + _torch(t)
    n = tdk.dense_decode_batched.launches
    with pytest.raises(ValueError, match="resident_bf16"):
        tdk.dense_decode_plain(*args, resident_bf16=True)
    with pytest.raises(ValueError, match="resident_bf16"):
        tdk.dense_decode_batched(*args, resident_bf16=True)
    assert tdk.dense_decode_batched.launches == n


def test_cpu_option_wrappers_launch_nothing():
    """K2's wrapper with options, handed CPU tensors, runs the plain version
    and counts no launch of any entry point."""
    d, t = _decode_case(np.random.RandomState(231), 6, 2, 1)
    before = (tdk.dense_decode_batched.launches, dict(tdk.dense_decode_batched.entry_launches))
    for args, fold, res in ((_torch(d) + _torch(t), True, False),
                            (_torch_bf16(d, t), True, False), (_torch_bf16(d, t), False, True),
                            (_torch_bf16(d, t), True, True)):
        assert torch.equal(tdk.dense_decode_batched(*args, fold_b1=fold, resident_bf16=res),
                           tdk.dense_decode_plain(*args, fold_b1=fold, resident_bf16=res))
    assert (tdk.dense_decode_batched.launches,
            dict(tdk.dense_decode_batched.entry_launches)) == before


def test_entry_point_names():
    """One entry point per mode and option set, as dense_decode.cu exports."""
    names = [tdk.dense_decode_entry(*m) for m in tdk.K2_MODES]
    assert names == ["dense_decode_f32", "dense_decode_f32_fold", "dense_decode_bf16",
                     "dense_decode_bf16_fold", "dense_decode_bf16_resident",
                     "dense_decode_bf16_resident_fold"]
    source = (REPO / "giga_tpu_torch" / "csrc" / "dense_decode.cu").read_text()
    assert all(f'extern "C" int {n}(' in source for n in names)


# -- inputs and entry point on a seeded decoder ---------------------------------

R_SMALL = 8


def _cfg(m):
    return m.GIGAConfig(
        encoder=m.EncoderConfig(c_dim=8, plane_resolution=R_SMALL,
                                unet=m.UNet2DConfig(depth=2, start_filts=4)),
        decoder=m.DecoderConfig(c_dim=8, hidden_size=8, n_blocks=3))


@functools.cache
def _decoder(dtype=torch.float32):
    """(JAX decoder params, port decoder params, JAX coords, port coords, JAX
    feats, port feats {t: (2, R, R, 8)}) in ``dtype``: ``net.init`` params,
    whose every fc_1 kernel, zeros at init, is drawn from a seed so that
    each block's second product counts."""
    jnet = JGIGANet(_cfg(jcfg))
    t0, p0 = jnp.zeros((1,) + (R_SMALL,) * 3), jnp.zeros((1, 1, 3))
    params = jax.device_get(jnet.init(jax.random.PRNGKey(7), t0, p0, p0))
    rng = np.random.RandomState(17)
    dec = params["params"]["decoder_aff"]
    for name in sorted(dec):
        if name.endswith("_fc1_kernel"):
            dec[name] = rng.uniform(-0.3, 0.3, dec[name].shape).astype(np.float32)
    net = GIGANet(_cfg(tcfg))
    net.load_state_dict(flax_to_state_dict(params))
    feats = {t: rng.randn(2, R_SMALL, R_SMALL, 8).astype(np.float32) for t in ("xz", "xy", "yz")}
    coords = np.linspace(-0.5, 0.5 - 1.0 / R_SMALL, R_SMALL).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    jdec = jax.tree.map(lambda a: jnp.asarray(a, jdt), dec)
    tdec = {k: v.detach().to(dtype) for k, v in net.decoder_aff.params().items()}
    return (jdec, tdec, jnp.asarray(coords), torch.from_numpy(coords),
            {t: jnp.asarray(v, jdt) for t, v in feats.items()},
            {t: torch.from_numpy(v).to(dtype) for t, v in feats.items()})


def test_decoder_has_biases_to_fold():
    """The seeded decoder's b1 are not zero, so folding them moves numbers."""
    _, tdec, *_ = _decoder()
    assert all(float(tdec[f"block{i}_fc1_bias"].abs().max()) > 0 for i in range(3))
    assert all(float(tdec[f"block{i}_fc1_kernel"].abs().max()) > 0 for i in range(3))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_prepare_projections_fold_matches_jax(dtype):
    """prepare_projections_batched(fold_b1=True) against the JAX package's:
    the fc_1 biases of blocks 0..n-2 in pxz of blocks 1..n-1, added to the
    fc_c bias in the params' dtype before the projection is. Float32 within
    1e-6; bf16 (each sum rounded to bf16, as in JAX) within a bf16 step,
    nearly all equal. pxy, pyz and block 0's pxz are the unfolded ones."""
    jdec, tdec, jc, tc, jf, tf = _decoder(dtype)
    bf16 = dtype == BF16
    ref = jdk.prepare_projections_batched(jdec, jf, jc, 3, fold_b1=True,
                                          proj_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    got = tdk.prepare_projections_batched(tdec, tf, tc, 3, dtype, fold_b1=True)
    plain = tdk.prepare_projections_batched(tdec, tf, tc, 3, dtype)
    for r, g in zip(ref[3:6], got[3:6]):
        r, g = np.asarray(r, np.float32), g.float().numpy()
        assert g.shape == r.shape
        if bf16:
            np.testing.assert_allclose(g, r, rtol=2 ** -7, atol=1e-6)
            assert np.mean(g == r) > 0.99
        else:
            np.testing.assert_allclose(g, r, atol=1e-6)
    assert torch.equal(got[3][:, 0], plain[3][:, 0]) and not torch.equal(got[3], plain[3])
    assert torch.equal(got[4], plain[4]) and torch.equal(got[5], plain[5])


CASES = {  # name: (dtype, options)
    "fp32 fold_b1": (torch.float32, dict(fold_b1=True)),
    "bf16 fold_b1": (BF16, dict(fold_b1=True)),
    "bf16 hidden_bf16": (BF16, dict(hidden_bf16=True)),
    "bf16 fold_b1 hidden_bf16": (BF16, dict(fold_b1=True, hidden_bf16=True)),
    "bf16 resident_bf16": (BF16, dict(resident_bf16=True)),
    "bf16 resident_bf16 fold_b1": (BF16, dict(resident_bf16=True, fold_b1=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_entry_point_options_match_pallas(case):
    """decode_affordance_dense_kernel_batched with each option on CPU tensors
    against decode_affordance_dense_pallas_batched (interpret mode,
    transposed): qual, rot (B, 4, R^3) and width, float32 within 1e-5, bf16
    by check_bf16."""
    dtype, options = CASES[case]
    jdec, tdec, jc, tc, jf, tf = _decoder(dtype)
    bf16 = dtype == BF16
    ref = jdk.decode_affordance_dense_pallas_batched(
        jdec, jf, jc, 3, compute_dtype=jnp.bfloat16 if bf16 else jnp.float32, interpret=True,
        transposed=True, **options)
    got = tdk.decode_affordance_dense_kernel_batched(tdec, tf, tc, 3, dtype, **options)
    for name, r, g in zip(("qual", "rot", "width"), ref, got):
        r = np.asarray(r, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        if bf16:
            chip_smoke.check_bf16(g, r, f"{case} {name}")
        else:
            np.testing.assert_allclose(g.numpy(), r, atol=TOL)


def test_float32_entry_point_ignores_bf16_options():
    """In float32, hidden_bf16 and resident_bf16 apply to nothing, as in the
    JAX wrapper: the volumes are the float32 mode's."""
    _, tdec, _, tc, _, tf = _decoder()
    ref = tdk.decode_affordance_dense_kernel_batched(tdec, tf, tc, 3)
    got = tdk.decode_affordance_dense_kernel_batched(tdec, tf, tc, 3, hidden_bf16=True,
                                                     resident_bf16=True)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


# -- the batched program with the options against the JAX TPU program ---------

@pytest.fixture(scope="module")
def giga_net():
    """The shipped checkpoint in the port, float32, on the CPU."""
    return load_network(REPO / chip_smoke.CHECKPOINT)


def _program(giga_net, precision, **options):
    net, cfg = giga_net
    planner = GIGAPlanner(net=net, model_cfg=cfg, size=chip_smoke.SIZE, device="cpu",
                          rng=np.random.RandomState(0), precision=precision,
                          **chip_smoke.PLANNER_KW)
    fn = build_batched_giga_planner_fn(planner.net, cfg, planner.planner_cfg, chip_smoke.SIZE,
                                       use_kernels=True, return_raw=True, **options)
    return planner, fn


def _host(cands):
    from giga_tpu_torch.inference.postprocess import GraspCandidates

    return GraspCandidates(*(np.asarray(t) for t in cands))


def test_fp32_fold_program_matches_jax_tpu_program(giga_net):
    """The batched program with fold_b1 on chip_smoke's 4 golden scenes
    against the JAX TPU fp32 program with pallas_fold_b1: equal counts and
    positions, scores, widths and rotations within 1e-5, raw qual within
    1e-5; and equal to the port's default program by the same measure."""
    scenes, (ref_cands, ref_raw) = jax_tpu_reference(4, "fp32", fold_b1=True)
    _, fn = _program(giga_net, "fp32", fold_b1=True)
    t = torch.from_numpy(scenes)
    with torch.inference_mode():
        cands, raw = fn(t, t)
    R = chip_smoke.RESOLUTION
    chip_smoke.compare_candidates(_host(cands), ref_cands, range(4), R, "fp32 fold vs JAX")
    np.testing.assert_allclose(raw[0].numpy(), ref_raw[0], atol=TOL)
    _, default = _program(giga_net, "fp32")
    with torch.inference_mode():
        chip_smoke.compare_candidates(_host(cands), _host(default(t, t)[0]), range(4), R,
                                      "fp32 fold vs default")


def test_bf16_fold_hidden_program_matches_jax_tpu_program(giga_net):
    """The bf16 batched program with fold_b1 and hidden_bf16 against the JAX
    TPU bf16 program with both: raw qual within 2e-2 / 3e-3, and the four
    decision gates."""
    scenes, (ref_cands, ref_raw) = jax_tpu_reference(4, "bf16", fold_b1=True, hidden_bf16=True)
    planner, fn = _program(giga_net, "bf16", fold_b1=True, hidden_bf16=True)
    t = torch.from_numpy(scenes)
    with torch.inference_mode():
        cands, raw = fn(t, t)
    dq = np.abs(raw[0].numpy() - ref_raw[0])
    assert dq.max() <= QUAL_MAX and np.median(dq) <= QUAL_MEDIAN, (dq.max(), np.median(dq))
    cands = _host(cands)
    got = [planner._to_grasps(type(cands)(*(x[i] for x in cands))) for i in range(4)]
    ref = [planner._to_grasps(type(cands)(*(np.asarray(x[i]) for x in ref_cands)))
           for i in range(4)]
    chip_smoke.bf16_gates(ref, got, VOXEL, "bf16 fold + hidden vs JAX TPU bf16 fold + hidden")


@pytest.mark.parametrize("use_kernels", [True, False])
def test_return_raw_leaves_the_candidates(small, small_scenes, use_kernels):
    """return_raw adds the float32 volumes the candidates came from, of the
    JAX package's shapes (rot (B, 4, R^3) on the kernels' path, as its
    transposed Pallas write; (B, R, R, R, 4) on the module path, as its XLA
    path), and leaves the candidates bit-equal."""
    jnet, params, net = small
    if use_kernels:
        # K2 takes hidden 32 only, so the small model's hidden 8 decodes on
        # the module path (the shape predicates): this case runs a seeded
        # copy of it at hidden 32
        net = GIGANet(dataclasses.replace(net.cfg, decoder=dataclasses.replace(
            net.cfg.decoder, hidden_size=32))).eval()
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for w in net.parameters():
                w.uniform_(-0.3, 0.3, generator=gen)
    cfg = net.cfg
    pcfg = tcfg.PlannerConfig(**SMALL_PLAN)
    t = torch.from_numpy(small_scenes)
    B, R = t.shape[0], pcfg.resolution
    plain = build_batched_giga_planner_fn(net, cfg, pcfg, 0.3, use_kernels=use_kernels)
    raw_fn = build_batched_giga_planner_fn(net, cfg, pcfg, 0.3, use_kernels=use_kernels,
                                           return_raw=True)
    assert raw_fn.paths["decode"] == ("K2" if use_kernels else "module")
    with torch.inference_mode():
        ref = plain(t, t)
        cands, raw = raw_fn(t, t)
    assert all(torch.equal(a, b) for a, b in zip(ref, cands))
    rot_shape = (B, 4, R ** 3) if use_kernels else (B, R, R, R, 4)
    assert [tuple(v.shape) for v in raw] == [(B, R, R, R), rot_shape, (B, R, R, R)]
    assert all(v.dtype == torch.float32 for v in raw)
    if not use_kernels:  # the JAX package's XLA path (what it runs on the CPU)
        jfn = jax_build(jnet, small_cfg(jcfg), jcfg.PlannerConfig(**SMALL_PLAN), 0.3,
                        return_raw=True)
        _, jraw = jax.device_get(jfn(params, jnp.asarray(small_scenes),
                                     jnp.asarray(small_scenes)))
        for g, r in zip(raw, jraw):
            assert tuple(g.shape) == r.shape and r.dtype == np.float32
            np.testing.assert_allclose(g.numpy(), r, atol=TOL)


# -- profile_batched ----------------------------------------------------------

def test_profile_batched_runs_on_the_cpu(capsys):
    """A tiny CPU run of the four prefixes at one scene in bf16 with both
    options: one line per stage, finite times."""
    assert profile_batched.main(["--device", "cpu", "--batch", "1", "--iters", "1",
                                 "--dtype", "bf16", "--fold-b1", "--hidden-bf16"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln[:12].strip() for ln in lines[2:]] == list(profile_batched.STAGES)
    assert all(np.isfinite(float(ln[12:].split()[0])) for ln in lines[2:])
    assert "fold_b1=True hidden_bf16=True" in lines[0]


def test_profile_batched_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_batched.main(["--batch", "1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err

