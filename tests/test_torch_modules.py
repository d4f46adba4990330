"""Each module of the PyTorch port held against its JAX counterpart on the
same seeded inputs and weights (CPU, small shapes).

Tolerances: 2e-5 for forward passes through convolutions (README
"Numerical fidelity"), 1e-6 where both sides do the same few fp32
operations, exact where the result is boolean or an index.
"""

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax
import jax.numpy as jnp

from giga_tpu.core import config as jcfg
from giga_tpu.inference import dense_decode as jdd
from giga_tpu.inference import postprocess as jpp
from giga_tpu.models.conv_onet import GIGANet as JGIGANet
from giga_tpu.models.unet2d import UNet2D as JUNet2D
from giga_tpu.ops import filters as jfilters
from giga_tpu.ops import sampling as jsampling
from giga_tpu_torch.core import config as tcfg
from giga_tpu_torch.inference import dense_decode as tdd
from giga_tpu_torch.inference import postprocess as tpp
from giga_tpu_torch.models.conv_onet import GIGANet
from giga_tpu_torch.models.convert import flax_to_state_dict
from giga_tpu_torch.models.encoder import can_encode_fused, encode_planes_fused
from giga_tpu_torch.models.unet2d import UNet2D
from giga_tpu_torch.ops import filters as tfilters
from giga_tpu_torch.ops import sampling as tsampling

FWD = 2e-5


def small_cfg(m, reso=16):
    """The same small GIGA configuration from either package's config module."""
    return m.GIGAConfig(
        encoder=m.EncoderConfig(c_dim=8, plane_resolution=reso,
                                unet=m.UNet2DConfig(depth=2, start_filts=8)),
        decoder=m.DecoderConfig(c_dim=8, hidden_size=8, n_blocks=2),
    )


@pytest.fixture(scope="module")
def small_model():
    """(flax net, flax params, port net) sharing seeded weights."""
    jnet = JGIGANet(small_cfg(jcfg))
    t0 = jnp.zeros((1, 16, 16, 16))
    p0 = jnp.zeros((1, 1, 3))
    params = jax.device_get(jnet.init(jax.random.PRNGKey(1), t0, p0, p0))
    net = GIGANet(small_cfg(tcfg))
    net.load_state_dict(flax_to_state_dict(params))
    return jnet, params, net.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_unet2d_matches_flax():
    ucfg = jcfg.UNet2DConfig(depth=3, start_filts=4)
    jnet = JUNet2D(6, ucfg)
    x = np.random.RandomState(0).randn(2, 8, 8, 6).astype(np.float32)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(jnet.apply(params, jnp.asarray(x)))
    tree = {"encoder": {"conv_in": {"conv": {"kernel": np.zeros((3, 3, 3, 1, 6)),
                                             "bias": np.zeros(6)}},
                        "unet": params["params"]}}
    sd = {k[len("encoder.unet."):]: v for k, v in flax_to_state_dict(tree).items()
          if k.startswith("encoder.unet.")}
    net = UNet2D(6, tcfg.UNet2DConfig(depth=3, start_filts=4))
    net.load_state_dict(sd)
    with torch.no_grad():
        got = net(_t(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=FWD)


def test_encoder_matches_flax(small_model):
    jnet, params, net = small_model
    grids = np.random.RandomState(2).rand(2, 16, 16, 16).astype(np.float32)
    ref = jnet.apply(params, jnp.asarray(grids), method="encode")
    with torch.no_grad():
        got = net.encode(_t(grids))
        fused = encode_planes_fused(net.encoder, _t(grids))
    assert set(got) == set(ref) == set(fused)
    for t in ref:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(ref[t]), atol=FWD)
        np.testing.assert_allclose(fused[t].numpy(), np.asarray(ref[t]), atol=FWD)


def test_can_encode_fused_gates():
    cfg = tcfg.giga()
    assert can_encode_fused(cfg.encoder, (2, 40, 40, 40))
    assert not can_encode_fused(cfg.encoder, (2, 32, 32, 32))
    assert not can_encode_fused(tcfg.EncoderConfig(padding=0.1), (2, 40, 40, 40))


def test_normalize_coordinate_matches_jax():
    """Not a clamp: values in (1 - 1e-5, 1) pass through; >= 1 -> 1 - 1e-5."""
    vals = np.array([-0.7, -0.5, -1e-7, 0.0, 0.25, 0.49999, 0.499995, 0.5, 0.5 + 1e-6, 0.8],
                    np.float32)
    for padding in (0.0, 0.1):
        ref = np.asarray(jsampling.normalize_coordinate(jnp.asarray(vals), padding))
        got = tsampling.normalize_coordinate(_t(vals), padding).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("reso", [5, 16, 40])
def test_interp_matrix_matches_jax(reso):
    """Includes coords at and beyond the border, where i0 clips to reso - 2."""
    coords = np.concatenate([np.linspace(-0.6, 0.6, 37), [0.5, 0.5 - 1e-6, -0.5]])
    coords = coords.astype(np.float32)
    ref = np.asarray(jsampling.interp_matrix_1d(jnp.asarray(coords), reso))
    got = tsampling.interp_matrix_1d(_t(coords), reso).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-7)
    assert got[-3, reso - 1] > 0.99  # coordinate 0.5 lands on the last cell


def test_sample_plane_lattice_matches_jax():
    rng = np.random.RandomState(4)
    plane = rng.randn(10, 12, 3).astype(np.float32)
    rows = np.asarray(jsampling.interp_matrix_1d(jnp.linspace(-0.5, 0.4, 7), 10))
    cols = np.asarray(jsampling.interp_matrix_1d(jnp.linspace(-0.45, 0.5, 9), 12))
    ref = jsampling.sample_plane_lattice(jnp.asarray(plane), jnp.asarray(rows), jnp.asarray(cols))
    got = tsampling.sample_plane_lattice(_t(plane), _t(rows), _t(cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("R", [8, 16, 40, 60])
def test_lattice_coords_within_one_ulp(R):
    """Within one float32 ulp at the lattice's scale (|coord| <= 0.5): JAX
    interpolates between the endpoints, so its coordinate 0 may be 3e-8."""
    ref = np.asarray(jdd.lattice_coords(R))
    got = tdd.lattice_coords(R).numpy()
    assert got.dtype == np.float32
    assert np.all(np.abs(got - ref) <= np.spacing(np.float32(0.5)))


def test_lattice_sampling_batched_matches_jax():
    rng = np.random.RandomState(5)
    planes = {t: rng.randn(2, 10, 10, 4).astype(np.float32) for t in ("xz", "xy", "yz")}
    coords = jdd.lattice_coords(8)
    ref = jdd.sample_planes_on_lattice_batched(
        {t: jnp.asarray(v) for t, v in planes.items()}, coords, 10, 0.0)
    got = tdd.sample_planes_on_lattice_batched(
        {t: _t(v) for t, v in planes.items()}, _t(coords), 10, 0.0)
    for t in planes:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(ref[t]), atol=1e-6)


def test_fused_head_weights_match_jax(small_model):
    _, params, net = small_model
    dec = params["params"]["decoder_aff"]
    ref, e, h = jdd._fused_head_weights(jax.tree.map(jnp.asarray, dec), 2)
    got, e2, h2 = tdd._fused_head_weights(net.decoder_aff.params(), 2)
    assert (e, h) == (e2, h2) and set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k].detach().numpy(), np.asarray(ref[k]))


def test_dense_decode_batched_matches_jax(small_model):
    _, params, net = small_model
    rng = np.random.RandomState(6)
    feats = {t: rng.randn(2, 8, 8, 8).astype(np.float32) for t in ("xz", "xy", "yz")}
    coords = jdd.lattice_coords(8)
    dec = jax.tree.map(jnp.asarray, params["params"]["decoder_aff"])
    ref = jdd.decode_affordance_dense_batched(
        dec, {t: jnp.asarray(v) for t, v in feats.items()}, coords, 2)
    with torch.no_grad():
        got = net.decode_affordance_lattice({t: _t(v) for t, v in feats.items()}, _t(coords))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_gaussian_blur_matches_jax_and_scipy():
    vol = np.random.RandomState(7).rand(2, 9, 10, 11).astype(np.float32)
    ref = np.asarray(jfilters.gaussian_blur_3d(jnp.asarray(vol), 1.0))
    got = tfilters.gaussian_blur_3d(_t(vol), 1.0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    sp = scipy.ndimage.gaussian_filter(vol[0].astype(np.float64), 1.0, mode="nearest")
    np.testing.assert_allclose(got[0], sp, atol=1e-5)


def test_masked_binary_dilation_matches_jax_and_scipy():
    """6-connected structure, mask holds seed values outside it."""
    rng = np.random.RandomState(8)
    seed = rng.rand(2, 9, 9, 9) > 0.9
    mask = rng.rand(2, 9, 9, 9) > 0.3
    ref = np.asarray(jfilters.masked_binary_dilation(jnp.asarray(seed), jnp.asarray(mask), 2))
    got = tfilters.masked_binary_dilation(_t(seed), _t(mask), 2).numpy()
    np.testing.assert_array_equal(got, ref)
    sp = scipy.ndimage.binary_dilation(seed[0], iterations=2, mask=mask[0])
    np.testing.assert_array_equal(got[0], sp)


@pytest.mark.parametrize("size", [3, 4, 8])
def test_max_filter_matches_jax_and_scipy(size):
    """Even sizes span [-size//2, size - size//2 - 1] (size 4: [-2, +1])."""
    vol = np.random.RandomState(9).rand(2, 10, 9, 8).astype(np.float32)
    ref = np.asarray(jfilters.max_filter_3d(jnp.asarray(vol), size))
    got = tfilters.max_filter_3d(_t(vol), size).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[1], scipy.ndimage.maximum_filter(vol[1], size=size))


def _planner_cfgs(**kw):
    return jcfg.PlannerConfig(**kw), tcfg.PlannerConfig(**kw)


def test_mask_and_bound_quality_match_jax():
    rng = np.random.RandomState(10)
    qual = rng.rand(2, 12, 12, 12).astype(np.float32)
    tsdf = rng.rand(2, 12, 12, 12).astype(np.float32)
    tsdf[0, 3] = 0.0  # unobserved slab: neither inside nor outside
    width = rng.uniform(0.0, 0.3, (2, 12, 12, 12)).astype(np.float32)
    jc, tc = _planner_cfgs(resolution=12)
    ref = jpp.mask_quality(jnp.asarray(qual), jnp.asarray(tsdf), jnp.asarray(width), jc)
    got = tpp.mask_quality(_t(qual), _t(tsdf), _t(width), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    for voxel in (0.3 / 12, 0.3 / 40, 0.0075):
        rb = jpp.bound_quality(ref, voxel, jc)
        gb = tpp.bound_quality(got, voxel, tc)
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), atol=1e-6)
        np.testing.assert_array_equal(gb.numpy() == 0, np.asarray(rb) == 0)


def _assert_same_candidates(ref, got, tol=1e-6):
    """Equal counts and (position, score) sets; ties may reorder."""
    ref = [np.asarray(x) for x in ref]
    got = [np.asarray(x) for x in got]
    np.testing.assert_array_equal(got[4], ref[4])
    for i, n in enumerate(ref[4]):
        order_r = np.lexsort(ref[1][i, :n].T)
        order_g = np.lexsort(got[1][i, :n].T)
        for f in range(4):
            np.testing.assert_allclose(got[f][i, :n][order_g], ref[f][i, :n][order_r], atol=tol)


@pytest.mark.parametrize("force,transposed", [(True, True), (False, False), (True, False)])
def test_select_grasps_batched_matches_jax(force, transposed):
    """k = 16 over 16^3 voxels takes JAX's two-level top-k; the port's
    topk must pick the same set. Scene 1 has no voxel above qual_th, so
    force_detection keeps only its best."""
    rng = np.random.RandomState(11)
    R = 16
    qual = rng.rand(3, R, R, R).astype(np.float32)
    qual[1] *= 0.6
    rot = rng.randn(3, R, R, R, 4).astype(np.float32)
    width = rng.rand(3, R, R, R).astype(np.float32)
    coords = jdd.lattice_coords(R)
    pos = np.stack(np.meshgrid(*(np.asarray(coords),) * 3, indexing="ij"), -1)
    jc, tc = _planner_cfgs(resolution=R, max_grasps=16, force_detection=force,
                           low_th=0.3, qual_th=0.8)
    ref = jpp.select_grasps_batched(jnp.asarray(qual), jnp.asarray(rot), jnp.asarray(width),
                                    jnp.asarray(pos), jc)
    trot = _t(rot.reshape(3, -1, 4).transpose(0, 2, 1)) if transposed else _t(rot)
    got = tpp.select_grasps_batched(_t(qual), trot, _t(width), _t(pos), tc)
    _assert_same_candidates(ref, got)
    assert int(got.count[0]) == 16  # truncated at k
    assert int(got.count[1]) == (1 if force else 0)
