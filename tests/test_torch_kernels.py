"""Kernels K1 (stem + pool) and K2-K5 (dense-decode trunks) of the PyTorch port.

The kernels' plain versions are held against the JAX package's Pallas
kernels in interpret mode, on the same seeded inputs; the kernels' input
preparation and decode entry points against their JAX counterparts.
tests/test_torch_cuda.py holds the CUDA kernels against the plain
versions on the card.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

from giga_tpu.core import config as jcfg
from giga_tpu.models.conv_onet import GIGANet as JGIGANet
from giga_tpu.ops.pallas import decoder_kernel as jdk
from giga_tpu.ops.pallas.decoder_kernel import fused_dense_decode_batched
from giga_tpu.ops.pallas.stem_kernel import fused_stem_pool_batched
from giga_tpu_torch.core import config as tcfg
from giga_tpu_torch.models.conv_onet import GIGANet
from giga_tpu_torch.models.convert import flax_to_state_dict
from giga_tpu_torch.ops.kernels import decoder as tdk
from giga_tpu_torch.ops.kernels.decoder import (
    dense_decode_batched,
    dense_decode_plain,
    split_heads_transposed,
)
from giga_tpu_torch.ops.kernels.stem import stem_pool_batched, stem_pool_plain

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TOL_STEM = 2e-5    # tests/test_stem_kernel.py
TOL_KERNEL = 1e-5  # tests/test_pallas_kernel.py
BF16 = torch.bfloat16


def _stem_inputs(seed=0, B=2, R=8, C=4):
    rng = np.random.RandomState(seed)
    kernel = rng.uniform(-0.5, 0.5, (3, 3, 3, 1, C)).astype(np.float32)  # flax DHWIO
    bias = rng.uniform(-0.2, 0.2, C).astype(np.float32)
    tsdf = rng.rand(B, R, R, R).astype(np.float32)
    return kernel, bias, tsdf


def _torch_stem_weight(kernel):
    return torch.from_numpy(np.ascontiguousarray(kernel.transpose(4, 3, 0, 1, 2)))


@pytest.mark.parametrize("shape", [(2, 8, 4), (1, 6, 8)])
def test_stem_plain_matches_pallas_interpret(shape):
    B, R, C = shape
    kernel, bias, tsdf = _stem_inputs(B=B, R=R, C=C)
    ref = fused_stem_pool_batched(jnp.asarray(kernel), jnp.asarray(bias), jnp.asarray(tsdf),
                                  kernel_size=3, c_dim=C, interpret=True)
    got = stem_pool_plain(_torch_stem_weight(kernel), torch.from_numpy(bias),
                          torch.from_numpy(tsdf))
    assert set(ref) == set(got)
    for t in ref:
        assert tuple(got[t].shape) == ref[t].shape
        np.testing.assert_allclose(got[t].numpy(), np.asarray(ref[t]), atol=TOL_STEM)


def test_stem_plain_non_cubic_layout():
    """Planes keep row = second axis on a non-cubic volume:
    xz (B, Z, X, C), xy (B, Y, X, C), yz (B, Z, Y, C)."""
    rng = np.random.RandomState(1)
    tsdf = torch.from_numpy(rng.rand(1, 4, 5, 6).astype(np.float32))
    w = torch.from_numpy(rng.rand(4, 1, 3, 3, 3).astype(np.float32))
    got = stem_pool_plain(w, torch.zeros(4), tsdf)
    assert tuple(got["xz"].shape) == (1, 6, 4, 4)
    assert tuple(got["xy"].shape) == (1, 5, 4, 4)
    assert tuple(got["yz"].shape) == (1, 6, 5, 4)


def _decode_inputs(seed=0, B=2, R=8, E=3, H=4, O=4, nb=2):
    rng = np.random.RandomState(seed)
    F = E * H

    def u(*shape, s=0.5):
        return rng.uniform(-s, s, shape).astype(np.float32)

    return {
        "px": u(R, F), "py": u(R, F), "pz": u(R, F),
        "pxz": u(B, nb, R, R, F), "pxy": u(B, nb, R, R, F), "pyz": u(B, nb, R, R, F),
        "w0": u(nb, E, H, H), "b0": u(nb, E, H), "w1": u(nb, E, H, H), "b1": u(nb, E, H),
        "wout": u(E, H, O), "bout": u(E, O),
    }


def _block_diag(w):
    """(..., E, a, b) per-head weights -> (..., E*a, E*b) block-diagonal."""
    *lead, E, a, b = w.shape
    out = np.zeros((*lead, E * a, E * b), w.dtype)
    for e in range(E):
        out[..., e * a:(e + 1) * a, e * b:(e + 1) * b] = w[..., e, :, :]
    return out


def _pallas_decode(d, transposed):
    nb, E, H, _ = d["w0"].shape
    return fused_dense_decode_batched(
        jnp.asarray(d["px"]), jnp.asarray(d["py"]), jnp.asarray(d["pz"]),
        jnp.asarray(d["pxz"]), jnp.asarray(d["pxy"]), jnp.asarray(d["pyz"]),
        jnp.asarray(_block_diag(d["w0"])), jnp.asarray(d["b0"].reshape(nb, -1)),
        jnp.asarray(_block_diag(d["w1"])), jnp.asarray(d["b1"].reshape(nb, -1)),
        jnp.asarray(_block_diag(d["wout"][None])[0]), jnp.asarray(d["bout"].reshape(1, -1)),
        n_blocks=nb, interpret=True, transposed=transposed)


@pytest.mark.parametrize("transposed", [True, False])
def test_decode_plain_matches_pallas_interpret(transposed):
    """The per-head plain trunk equals JAX's fused trunk fed the
    block-diagonal packing of the same weights."""
    d = _decode_inputs()
    B, R = d["pxz"].shape[0], d["px"].shape[0]
    got = dense_decode_plain(*(torch.from_numpy(v) for v in d.values())).numpy()
    ref = np.asarray(_pallas_decode(d, transposed))
    if not transposed:
        ref = ref.reshape(B, R ** 3, -1).transpose(0, 2, 1)
    assert got.shape == ref.shape == (B, 12, R ** 3)
    np.testing.assert_allclose(got, ref, atol=TOL_KERNEL)


def test_split_heads_transposed_matches_jax():
    from giga_tpu.ops.pallas.decoder_kernel import _split_heads_transposed

    rng = np.random.RandomState(3)
    R = 4
    out = rng.randn(2, 12, R ** 3).astype(np.float32)
    dec = {"fc_p_kernel": np.zeros((3, 3, 8)), "fc_out_bias": np.zeros((3, 4))}
    ref = _split_heads_transposed(jnp.asarray(out), dec, R)
    got = split_heads_transposed(torch.from_numpy(out), 3, R)
    for r, g in zip(ref, got):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def test_cpu_tensors_take_the_plain_versions():
    """A kernel wrapper handed CPU tensors runs the plain version and
    launches nothing."""
    kernel, bias, tsdf = _stem_inputs()
    w, b, t = _torch_stem_weight(kernel), torch.from_numpy(bias), torch.from_numpy(tsdf)
    n1 = stem_pool_batched.launches
    got = stem_pool_batched(w, b, t)
    ref = stem_pool_plain(w, b, t)
    for k in ref:
        assert torch.equal(got[k], ref[k])
    d = [torch.from_numpy(v) for v in _decode_inputs(seed=1).values()]
    n2 = dense_decode_batched.launches
    assert torch.equal(dense_decode_batched(*d), dense_decode_plain(*d))
    assert (stem_pool_batched.launches, dense_decode_batched.launches) == (n1, n2)


# -- K3, K4, K5 ---------------------------------------------------------------

def _trunk_inputs(rng, E, H, O, nb):
    def u(*shape):
        return rng.uniform(-0.5, 0.5, shape).astype(np.float32)

    return {"w0": u(nb, E, H, H), "b0": u(nb, E, H), "w1": u(nb, E, H, H), "b1": u(nb, E, H),
            "wout": u(E, H, O), "bout": u(E, O)}


def _jax_trunk(t):
    """Per-head trunk weights -> the JAX kernels' fused block-diagonal ones."""
    nb = t["w0"].shape[0]
    return [jnp.asarray(a) for a in (
        _block_diag(t["w0"]), t["b0"].reshape(nb, -1), _block_diag(t["w1"]),
        t["b1"].reshape(nb, -1), _block_diag(t["wout"][None])[0], t["bout"].reshape(1, -1))]


def _torch(d):
    return [torch.from_numpy(v) for v in d.values()]


@pytest.mark.parametrize("R,nb", [(8, 2), (5, 1)])
def test_fused_decode_plain_matches_pallas_interpret(R, nb):
    """K3's plain version, one scene, [x, y, z, o] layout."""
    rng = np.random.RandomState(20 + R)
    E, H, O, F = 3, 4, 4, 12
    d = {"px": rng.uniform(-.5, .5, (R, F)), "py": rng.uniform(-.5, .5, (R, F)),
         "pz": rng.uniform(-.5, .5, (R, F))}
    for k in ("pxz", "pxy", "pyz"):
        d[k] = rng.uniform(-.5, .5, (nb, R, R, F))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    t = _trunk_inputs(rng, E, H, O, nb)
    ref = jdk.fused_dense_decode(*(jnp.asarray(v) for v in d.values()), *_jax_trunk(t),
                                 n_blocks=nb, interpret=True)
    got = tdk.fused_dense_decode_plain(*_torch(d), *_torch(t)).numpy()
    assert got.shape == ref.shape == (R, R, R, E * O)
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL_KERNEL)


def _feats_case(seed, B, R, C, nb, E=3, H=4, O=4):
    rng = np.random.RandomState(seed)
    F = E * H

    def u(*shape):
        return rng.uniform(-0.5, 0.5, shape).astype(np.float32)

    d = {"px": u(R, F), "py": u(R, F), "pz": u(R, F),
         "fxz": u(B, R, R, C), "fxy": u(B, R, R, C), "fyz": u(B, R, R, C),
         "wxz": u(nb, C, F), "wxy": u(nb, C, F), "wyz": u(nb, C, F), "bc": u(nb, F)}
    return d, _trunk_inputs(rng, E, H, O, nb)


@pytest.mark.parametrize("B,R,C,nb,x_chunk", [(2, 8, 4, 2, 4), (1, 6, 8, 1, 6)])
def test_feats_decode_plain_matches_pallas_interpret(B, R, C, nb, x_chunk):
    """K4's plain version: all three projections from raw features."""
    d, t = _feats_case(30 + R, B, R, C, nb)
    ref = jdk.fused_dense_decode_feats_batched(
        *(jnp.asarray(v) for v in d.values()), *_jax_trunk(t), n_blocks=nb,
        x_chunk=x_chunk, interpret=True)
    got = tdk.dense_decode_feats_plain(*_torch(d), *_torch(t)).numpy()
    assert got.shape == ref.shape == (B, R, R, R, 12)
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL_KERNEL)


@pytest.mark.parametrize("B,R,C,nb", [(2, 8, 4, 2), (1, 6, 8, 1)])
def test_hybrid_decode_plain_matches_pallas_interpret(B, R, C, nb):
    """K5's plain version: xz/xy projections from raw features, pyz given."""
    d, t = _feats_case(40 + R, B, R, C, nb)
    rng = np.random.RandomState(50 + R)
    pyz = rng.uniform(-0.5, 0.5, (B, nb, R, R, 12)).astype(np.float32)
    args = [d["px"], d["py"], d["pz"], d["fxz"], d["fxy"], pyz, d["wxz"], d["wxy"]]
    ref = jdk.fused_dense_decode_hybrid_batched(
        *(jnp.asarray(v) for v in args), *_jax_trunk(t), n_blocks=nb, interpret=True)
    got = tdk.dense_decode_hybrid_plain(*(torch.from_numpy(v) for v in args),
                                        *_torch(t)).numpy()
    assert got.shape == ref.shape == (B, R, R, R, 12)
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL_KERNEL)


def test_feats_decode_plain_independent_of_x_chunk():
    """The wrapper's x_chunk is a tile of the CUDA kernel only."""
    d, t = _feats_case(7, 1, 6, 4, 2)
    args = _torch(d) + _torch(t)
    ref = tdk.dense_decode_feats_batched(*args)
    for x_chunk in (1, 4, 100):
        assert torch.equal(tdk.dense_decode_feats_batched(*args, x_chunk=x_chunk), ref)


R_SMALL = 8


def _small_cfg(m):
    return m.GIGAConfig(
        encoder=m.EncoderConfig(c_dim=8, plane_resolution=R_SMALL,
                                unet=m.UNet2DConfig(depth=2, start_filts=4)),
        decoder=m.DecoderConfig(c_dim=8, hidden_size=8, n_blocks=2),
    )


@pytest.fixture(scope="module")
def small_decoder():
    """(flax decoder params, port decoder params, R_SMALL lattice coords,
    numpy lattice features {t: (2, R, R, C)}) from one seeded model."""
    jnet = JGIGANet(_small_cfg(jcfg))
    t0, p0 = jnp.zeros((1,) + (R_SMALL,) * 3), jnp.zeros((1, 1, 3))
    params = jax.device_get(jnet.init(jax.random.PRNGKey(4), t0, p0, p0))
    net = GIGANet(_small_cfg(tcfg))
    net.load_state_dict(flax_to_state_dict(params))
    rng = np.random.RandomState(12)
    feats = {t: rng.randn(2, R_SMALL, R_SMALL, 8).astype(np.float32)
             for t in ("xz", "xy", "yz")}
    coords = np.linspace(-0.5, 0.5 - 1.0 / R_SMALL, R_SMALL).astype(np.float32)
    jdec = jax.tree.map(jnp.asarray, params["params"]["decoder_aff"])
    return jdec, {k: v.detach() for k, v in net.decoder_aff.params().items()}, coords, feats


def _jfeats(feats, scene=None):
    return {t: jnp.asarray(v if scene is None else v[scene]) for t, v in feats.items()}


def _tfeats(feats, scene=None):
    return {t: torch.from_numpy(v if scene is None else v[scene]) for t, v in feats.items()}


def _fused_to_heads(w, E):
    """The JAX fused (nb, E*H, E*H) block-diagonal weights -> per head."""
    H = w.shape[-1] // E
    return np.stack([w[..., e * H:(e + 1) * H, e * H:(e + 1) * H] for e in range(E)], -3)


def _assert_same_inputs(ref, got, E, trunk_at):
    """JAX's fused kernel inputs against the port's, the trunk weights
    (from ``trunk_at`` on) compared per head."""
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    for r, g in zip(ref[:trunk_at], got[:trunk_at]):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=1e-6)
    nb = ref[trunk_at].shape[0]
    w0, b0, w1, b1, wout, bout = ref[trunk_at:]
    H, O = w0.shape[-1] // E, bout.size // E
    head_out = np.stack([wout[e * H:(e + 1) * H, e * O:(e + 1) * O] for e in range(E)])
    expect = [_fused_to_heads(w0, E), b0.reshape(nb, E, -1), _fused_to_heads(w1, E),
              b1.reshape(nb, E, -1), head_out, bout.reshape(E, -1)]
    for r, g in zip(expect, got[trunk_at:]):
        np.testing.assert_array_equal(g, r)


def test_prepare_projections_matches_jax(small_decoder):
    jdec, tdec, coords, feats = small_decoder
    ref = jdk.prepare_projections(jdec, _jfeats(feats, 0), jnp.asarray(coords), 2)
    got = tdk.prepare_projections(tdec, _tfeats(feats, 0), torch.from_numpy(coords), 2)
    _assert_same_inputs(ref, got, 3, trunk_at=6)


def test_prepare_feats_inputs_matches_jax(small_decoder):
    jdec, tdec, coords, feats = small_decoder
    ref = jdk.prepare_feats_inputs(jdec, _jfeats(feats), jnp.asarray(coords), 2)
    got = tdk.prepare_feats_inputs(tdec, _tfeats(feats), torch.from_numpy(coords), 2)
    _assert_same_inputs(ref, got, 3, trunk_at=10)


def test_prepare_hybrid_inputs_matches_jax(small_decoder):
    """The fc_c biases are folded into pyz, as in the JAX package."""
    jdec, tdec, coords, feats = small_decoder
    ref = jdk.prepare_hybrid_inputs(jdec, _jfeats(feats), jnp.asarray(coords), 2)
    got = tdk.prepare_hybrid_inputs(tdec, _tfeats(feats), torch.from_numpy(coords), 2)
    _assert_same_inputs(ref, got, 3, trunk_at=8)


def _assert_same_volumes(ref, got, atol=TOL_KERNEL):
    for r, g in zip(ref, got):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)


def test_decode_affordance_dense_kernel_matches_pallas(small_decoder):
    """K3's entry point, one scene: qual (R,R,R), rot (R,R,R,4), width."""
    jdec, tdec, coords, feats = small_decoder
    ref = jdk.decode_affordance_dense_pallas(jdec, _jfeats(feats, 1), jnp.asarray(coords), 2,
                                             interpret=True)
    got = tdk.decode_affordance_dense_kernel(tdec, _tfeats(feats, 1), torch.from_numpy(coords), 2)
    _assert_same_volumes(ref, got)


def test_decode_affordance_dense_kernel_feats_matches_pallas(small_decoder):
    """K4's entry point: qual (B,R,R,R), rot (B,R,R,R,4), width (B,R,R,R)."""
    jdec, tdec, coords, feats = small_decoder
    ref = jdk.decode_affordance_dense_pallas_feats_batched(
        jdec, _jfeats(feats), jnp.asarray(coords), 2, x_chunk=4, interpret=True)
    got = tdk.decode_affordance_dense_kernel_feats_batched(
        tdec, _tfeats(feats), torch.from_numpy(coords), 2)
    _assert_same_volumes(ref, got)


def test_decode_affordance_dense_kernel_hybrid_matches_pallas(small_decoder):
    """K5's entry point: qual (B,R,R,R), rot (B,R,R,R,4), width (B,R,R,R)."""
    jdec, tdec, coords, feats = small_decoder
    ref = jdk.decode_affordance_dense_pallas_hybrid_batched(
        jdec, _jfeats(feats), jnp.asarray(coords), 2, interpret=True)
    got = tdk.decode_affordance_dense_kernel_hybrid_batched(
        tdec, _tfeats(feats), torch.from_numpy(coords), 2)
    _assert_same_volumes(ref, got)


def test_split_heads_matches_jax():
    rng = np.random.RandomState(13)
    out = rng.randn(2, 3, 3, 3, 12).astype(np.float32)
    dec = {"fc_p_kernel": np.zeros((3, 3, 8)), "fc_out_bias": np.zeros((3, 4))}
    _assert_same_volumes(jdk._split_heads(jnp.asarray(out), dec),
                         tdk.split_heads(torch.from_numpy(out), 3), atol=1e-6)


def test_cpu_decode_wrappers_launch_nothing(small_decoder):
    """K3's, K4's and K5's wrappers handed CPU tensors run the plain
    versions and launch nothing."""
    _, tdec, coords, feats = small_decoder
    c = torch.from_numpy(coords)
    wrappers = (tdk.fused_dense_decode, tdk.dense_decode_feats_batched,
                tdk.dense_decode_hybrid_batched)
    before = [w.launches for w in wrappers]
    single = tdk.prepare_projections(tdec, _tfeats(feats, 0), c, 2)
    assert torch.equal(tdk.fused_dense_decode(*single), tdk.fused_dense_decode_plain(*single))
    fin = tdk.prepare_feats_inputs(tdec, _tfeats(feats), c, 2)
    assert torch.equal(tdk.dense_decode_feats_batched(*fin), tdk.dense_decode_feats_plain(*fin))
    hin = tdk.prepare_hybrid_inputs(tdec, _tfeats(feats), c, 2)
    assert torch.equal(tdk.dense_decode_hybrid_batched(*hin), tdk.dense_decode_hybrid_plain(*hin))
    assert [w.launches for w in wrappers] == before


# -- K4's and K5's bf16 modes through their inputs and entry points -------------

def _in_dtype(small_decoder, params_dtype: str):
    """small_decoder's params and features, as they are or cast to bf16 in
    both packages (the decode A/B's bf16 net and lattice features)."""
    jdec, tdec, coords, feats = small_decoder
    jf, tf = _jfeats(feats), _tfeats(feats)
    if params_dtype == "bfloat16":
        jdec = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jdec)
        tdec = {k: v.to(BF16) for k, v in tdec.items()}
        jf = {k: v.astype(jnp.bfloat16) for k, v in jf.items()}
        tf = {k: v.to(BF16) for k, v in tf.items()}
    return jdec, tdec, jnp.asarray(coords), torch.from_numpy(coords), jf, tf


@pytest.mark.parametrize("params_dtype", ["float32", "bfloat16"])
def test_prepare_hybrid_inputs_bf16_matches_jax(small_decoder, params_dtype):
    """prepare_hybrid_inputs(dtype=bf16): pyz rounded to bf16, equal to the
    JAX package's (``proj_dtype=bf16``); every other input float32 as in
    the float32 mode, computed in the params' dtype."""
    jdec, tdec, jc, tc, jf, tf = _in_dtype(small_decoder, params_dtype)
    ref = jdk.prepare_hybrid_inputs(jdec, jf, jc, 2, proj_dtype=jnp.bfloat16)
    got = tdk.prepare_hybrid_inputs(tdec, tf, tc, 2, BF16)
    assert got[5].dtype == BF16 and all(g.dtype == torch.float32 for g in got[:5] + got[6:])
    assert np.asarray(ref[5]).dtype == jnp.bfloat16
    assert torch.equal(got[5], torch.from_numpy(np.asarray(ref[5], np.float32)).to(BF16))
    _assert_same_inputs(ref[:5] + ref[6:], got[:5] + got[6:], 3, trunk_at=7)


@pytest.mark.parametrize("entry", ["feats", "hybrid"])
@pytest.mark.parametrize("params_dtype", ["float32", "bfloat16"])
def test_bf16_decode_entry_points_match_pallas(small_decoder, entry, params_dtype):
    """K4's and K5's entry points with compute_dtype=bf16 on CPU tensors
    (their bf16 plain versions) against the JAX package's with the Pallas
    kernels in interpret mode: qual, rot and width by check_bf16."""
    jdec, tdec, jc, tc, jf, tf = _in_dtype(small_decoder, params_dtype)
    if entry == "feats":
        ref = jdk.decode_affordance_dense_pallas_feats_batched(
            jdec, jf, jc, 2, compute_dtype=jnp.bfloat16, x_chunk=4, interpret=True)
        got = tdk.decode_affordance_dense_kernel_feats_batched(tdec, tf, tc, 2, compute_dtype=BF16)
    else:
        ref = jdk.decode_affordance_dense_pallas_hybrid_batched(
            jdec, jf, jc, 2, compute_dtype=jnp.bfloat16, interpret=True)
        got = tdk.decode_affordance_dense_kernel_hybrid_batched(tdec, tf, tc, 2,
                                                                compute_dtype=BF16)
    for name, r, g in zip(("qual", "rot", "width"), ref, got):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        chip_smoke.check_bf16(g, np.asarray(r), f"{entry} {name}")


def test_cpu_bf16_decode_wrappers_launch_nothing(small_decoder):
    """K4's and K5's wrappers in the bf16 mode handed CPU tensors run the
    bf16 plain versions and launch nothing."""
    _, tdec, coords, feats = small_decoder
    c = torch.from_numpy(coords)
    wrappers = (tdk.dense_decode_feats_batched, tdk.dense_decode_hybrid_batched)
    before = [w.launches for w in wrappers]
    fin = tdk.prepare_feats_inputs(tdec, _tfeats(feats), c, 2)
    assert torch.equal(tdk.dense_decode_feats_batched(*fin, compute_dtype=BF16),
                       tdk.dense_decode_feats_plain(*fin, compute_dtype=BF16))
    hin = tdk.prepare_hybrid_inputs(tdec, _tfeats(feats), c, 2, BF16)
    assert torch.equal(tdk.dense_decode_hybrid_batched(*hin), tdk.dense_decode_hybrid_plain(*hin))
    assert [w.launches for w in wrappers] == before
