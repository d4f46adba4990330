"""Decoding at arbitrary points in the PyTorch port, held against the JAX
package on the same numpy-seeded inputs and weights (CPU, small shapes):
every function of ``ops/sampling.py``, ``StackedLocalDecoder.forward`` and
``query_planes`` with each sampler and both feature branches, GIGANet's
``forward``, ``decode_affordance``, ``decode_occupancy``, ``query_feature``
and ``grad_refine``, and ``decode_lattice_points``.

Tolerance 2e-5 (JAX at "highest" matmul precision, tests/conftest.py).
Query points include the box's faces (+-0.5), points beyond it, and the
(1 - 1e-5, 1) band of normalized coordinates that normalize_coordinate
passes through unchanged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from giga_tpu.core import config as jcfg
from giga_tpu.inference import dense_decode as jdd
from giga_tpu.models.conv_onet import GIGANet as JGIGANet
from giga_tpu.models.decoder import StackedLocalDecoder as JDecoder
from giga_tpu.models.decoder import query_planes as jquery_planes
from giga_tpu.ops import sampling as js
from giga_tpu_torch.core import config as tcfg
from giga_tpu_torch.inference import dense_decode as tdd
from giga_tpu_torch.models.conv_onet import GIGANet, normalize_quat
from giga_tpu_torch.models.convert import flax_to_state_dict
from giga_tpu_torch.models.decoder import StackedLocalDecoder, query_planes
from giga_tpu_torch.ops import sampling as ts

TOL = 2e-5
RESO = 8
SAMPLERS = ("gather", "mm", "mm_highest")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                                          else got, np.float64),
                               np.asarray(ref, np.float64), atol=tol, rtol=0)


def query_points(n: int, seed: int = 0) -> np.ndarray:
    """(n, 3) float32 points: uniform in the box, on its faces and corners,
    beyond it, and in the (1 - 1e-5, 1) band of normalized coordinates
    (p within 5e-6 below the face 0.5 * (1 + 1e-5))."""
    rng = np.random.RandomState(seed)
    p = rng.uniform(-0.5, 0.5, (n, 3))
    k = n // 8
    p[:k] = rng.choice([-0.5, 0.5], (k, 3))
    p[k:2 * k] = rng.uniform(-0.8, 0.8, (k, 3))
    p[2 * k:3 * k, rng.randint(3)] = 0.5 * (1 + 1e-5) - rng.uniform(0.0, 5e-6, k)
    p[3 * k:4 * k] = 0.5 - rng.uniform(0.0, 1e-5, (k, 3))
    return p.astype(np.float32)


def test_query_points_reach_the_band():
    u = js.normalize_coordinate(jnp.asarray(query_points(256)), 0.0)
    band = (u > 1 - 1e-5) & (u < 1)
    assert int(band.sum()) >= 16 and bool((u >= 0).all() and (u < 1).all())


# -- ops/sampling.py ------------------------------------------------------------

@pytest.mark.parametrize("padding", [0.0, 0.1])
@pytest.mark.parametrize("three_d", [False, True])
def test_normalize_coordinates(padding, three_d):
    p = query_points(512, 1)
    jf, tf = ((js.normalize_3d_coordinate, ts.normalize_3d_coordinate) if three_d
              else (js.normalize_coordinate, ts.normalize_coordinate))
    got, ref = tf(_t(p), padding), jf(jnp.asarray(p), padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("plane_type", ["xz", "xy", "yz"])
@pytest.mark.parametrize("hw", [(8, 8), (5, 9), (1, 6)])
def test_sample_plane(plane_type, hw):
    rng = np.random.RandomState(2)
    plane = rng.standard_normal(hw + (4,)).astype(np.float32)
    p = query_points(256, 3)
    _close(ts.sample_plane(_t(plane), _t(p), plane_type),
           js.sample_plane(jnp.asarray(plane), jnp.asarray(p), plane_type))


@pytest.mark.parametrize("chunk,precision", [(8192, None), (50, None), (64, "highest")])
def test_sample_plane_mm(chunk, precision):
    rng = np.random.RandomState(4)
    planes = {t: rng.standard_normal((RESO, RESO, 4)).astype(np.float32)
              for t in ("xz", "xy", "yz")}
    p = query_points(300, 5)
    jprec = jax.lax.Precision.HIGHEST if precision else None
    for t in planes:
        _close(ts.sample_plane_mm(_t(planes[t]), _t(p), t, 0.0, chunk, precision),
               js.sample_plane_mm(jnp.asarray(planes[t]), jnp.asarray(p), t, 0.0, chunk, jprec))
    _close(ts.sample_planes_concat_mm({t: _t(v) for t, v in planes.items()}, _t(p), 0.0, chunk,
                                      precision),
           js.sample_planes_concat_mm({t: jnp.asarray(v) for t, v in planes.items()},
                                      jnp.asarray(p), 0.0, chunk, jprec))
    # the gather form computes the same function
    _close(ts.sample_plane_mm(_t(planes["xz"]), _t(p), "xz", 0.0, chunk, precision),
           ts.sample_plane(_t(planes["xz"]), _t(p), "xz"))


@pytest.mark.parametrize("types", [("xz", "xy", "yz"), ("xy", "yz")])
def test_sample_planes_concat(types):
    rng = np.random.RandomState(6)
    planes = {t: rng.standard_normal((RESO, RESO, 3)).astype(np.float32) for t in types}
    p = query_points(128, 7)
    _close(ts.sample_planes_concat({t: _t(v) for t, v in planes.items()}, _t(p), 0.1),
           js.sample_planes_concat({t: jnp.asarray(v) for t, v in planes.items()},
                                   jnp.asarray(p), 0.1))


@pytest.mark.parametrize("dhw", [(6, 7, 8), (1, 5, 4)])
def test_sample_grid(dhw):
    rng = np.random.RandomState(8)
    grid = rng.standard_normal(dhw + (3,)).astype(np.float32)
    p = query_points(256, 9)
    _close(ts.sample_grid(_t(grid), _t(p)), js.sample_grid(jnp.asarray(grid), jnp.asarray(p)))


@pytest.mark.parametrize("plane_type", ["xz", "yz", "grid"])
def test_normalize_coord(plane_type):
    p = query_points(128, 10)
    vol = ([-0.3, -0.4, -0.2], [0.5, 0.3, 0.45])
    _close(ts.normalize_coord(_t(p), vol, plane_type),
           js.normalize_coord(jnp.asarray(p), vol, plane_type), 1e-6)


@pytest.mark.parametrize("num_freqs", [1, 10])
def test_positional_encoding_sincos(num_freqs):
    p = np.random.RandomState(11).rand(64, 3).astype(np.float32)
    got = ts.positional_encoding_sincos(_t(p), num_freqs)
    assert got.shape == (64, 6 * num_freqs)
    _close(got, js.positional_encoding_sincos(jnp.asarray(p), num_freqs))


@pytest.mark.parametrize("encoding", ["linear", "sin_cos"])
def test_map2local(encoding):
    p = query_points(128, 12)  # negative points too: remainder takes the divisor's sign
    _close(ts.map2local(_t(p), 0.1, encoding), js.map2local(jnp.asarray(p), 0.1, encoding))


@pytest.mark.parametrize("reso", [1, 2, 8])
def test_interp_matrix_1d(reso):
    c = query_points(64, 13)[:, 0]
    _close(ts.interp_matrix_1d(_t(c), reso), js.interp_matrix_1d(jnp.asarray(c), reso), 1e-6)


# -- the decoder and query_planes -------------------------------------------------

def decoder_cfg(m, sampler="gather", concat=True):
    return m.DecoderConfig(c_dim=8, hidden_size=8, n_blocks=2, sampler=sampler,
                           concat_feat=concat)


def _planes(rng, B, types=("xz", "xy", "yz")):
    return {t: rng.standard_normal((B, RESO, RESO, 8)).astype(np.float32) for t in types}


@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("concat", [True, False])
def test_decoder_forward(sampler, concat):
    rng = np.random.RandomState(14)
    planes = _planes(rng, 2)
    p = np.stack([query_points(96, 15), query_points(96, 16)])
    jdec = JDecoder(decoder_cfg(jcfg, sampler, concat), heads=3, out_dim=4)
    jplanes = {t: jnp.asarray(v) for t, v in planes.items()}
    params = jax.device_get(jdec.init(jax.random.PRNGKey(3), jplanes, jnp.asarray(p)))
    dec = StackedLocalDecoder(decoder_cfg(tcfg, sampler, concat))
    dec.load_state_dict({k: _t(v) for k, v in params["params"].items()})
    got = dec({t: _t(v) for t, v in planes.items()}, _t(p))
    ref = jdec.apply(params, jplanes, jnp.asarray(p))
    assert got.shape == (3, 2, 96, 4)
    _close(got, ref)
    feature = jquery_planes(jplanes, jnp.asarray(p), decoder_cfg(jcfg, sampler, concat))
    _close(dec({}, _t(p), feature=_t(feature)), ref)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_query_planes(sampler):
    rng = np.random.RandomState(17)
    planes = _planes(rng, 2)
    p = np.stack([query_points(64, 18), query_points(64, 19)])
    for concat in (True, False):
        got = query_planes({t: _t(v) for t, v in planes.items()}, _t(p),
                           decoder_cfg(tcfg, sampler, concat))
        ref = jquery_planes({t: jnp.asarray(v) for t, v in planes.items()}, jnp.asarray(p),
                            decoder_cfg(jcfg, sampler, concat))
        assert got.shape == ref.shape == (2, 64, 24 if concat else 8)
        _close(got, ref)


def test_query_planes_grid_sums():
    """A 'grid' takes the summed branch (trilinear samples) whatever concat_feat says."""
    rng = np.random.RandomState(20)
    grid = rng.standard_normal((2, 5, 6, 7, 8)).astype(np.float32)
    p = np.stack([query_points(64, 21), query_points(64, 22)])
    _close(query_planes({"grid": _t(grid)}, _t(p), decoder_cfg(tcfg)),
           jquery_planes({"grid": jnp.asarray(grid)}, jnp.asarray(p), decoder_cfg(jcfg)))


# -- GIGANet ----------------------------------------------------------------------

def small_cfg(m, sampler="gather", detach=False):
    return m.GIGAConfig(
        encoder=m.EncoderConfig(c_dim=8, plane_resolution=RESO,
                                unet=m.UNet2DConfig(depth=2, start_filts=8)),
        decoder=decoder_cfg(m, sampler), detach_tsdf=detach)


def small_nets(sampler="gather", detach=False, seed=0):
    """(flax net, flax params, port net) sharing seeded weights."""
    jnet = JGIGANet(small_cfg(jcfg, sampler, detach))
    t0, p0 = jnp.zeros((1, RESO, RESO, RESO)), jnp.zeros((1, 1, 3))
    params = jax.device_get(jnet.init(jax.random.PRNGKey(seed), t0, p0, p0))
    net = GIGANet(small_cfg(tcfg, sampler, detach))
    net.load_state_dict(flax_to_state_dict(params))
    return jnet, params, net.eval()


def scenes(B: int = 2, seed: int = 23):
    rng = np.random.RandomState(seed)
    tsdf = rng.rand(B, RESO, RESO, RESO).astype(np.float32)
    p = np.stack([query_points(80, seed + b) for b in range(B)])
    p_occ = np.stack([query_points(72, seed + 10 + b) for b in range(B)])
    return tsdf, p, p_occ


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_forward(sampler):
    jnet, params, net = small_nets(sampler)
    tsdf, p, p_occ = scenes()
    got = net(_t(tsdf), _t(p), _t(p_occ))
    ref = jnet.apply(params, jnp.asarray(tsdf), jnp.asarray(p), jnp.asarray(p_occ))
    assert sorted(got) == sorted(ref) == ["occ", "qual", "rot", "width"]
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape
        _close(got[k], ref[k])
    assert sorted(net(_t(tsdf), _t(p))) == ["qual", "rot", "width"]
    assert sorted(net(_t(tsdf), None, _t(p_occ))) == ["occ"]


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_decodes_and_query_feature(sampler):
    jnet, params, net = small_nets(sampler, seed=1)
    tsdf, p, p_occ = scenes(seed=31)
    jplanes = jnet.apply(params, jnp.asarray(tsdf), method=JGIGANet.encode)
    planes = net.encode(_t(tsdf))
    for t in jplanes:
        _close(planes[t], jplanes[t])
    jfeat = jnet.apply(params, jplanes, jnp.asarray(p), method=JGIGANet.query_feature)
    feat = net.query_feature(planes, _t(p))
    _close(feat, jfeat)
    for feature in (None, feat):
        ref = jnet.apply(params, jplanes, jnp.asarray(p),
                         None if feature is None else jfeat, method=JGIGANet.decode_affordance)
        for a, b in zip(net.decode_affordance(planes, _t(p), feature), ref):
            _close(a, b)
    _close(net.decode_occupancy(planes, _t(p_occ)),
           jnet.apply(params, jplanes, jnp.asarray(p_occ), method=JGIGANet.decode_occupancy))


def test_normalize_quat():
    q = np.random.RandomState(40).standard_normal((16, 4)).astype(np.float32)
    q[0] = 0.0
    from giga_tpu.models.conv_onet import normalize_quat as jnormalize

    _close(normalize_quat(_t(q)), jnormalize(jnp.asarray(q)), 1e-6)


@pytest.mark.parametrize("num_step,bound", [(1, 0.0125), (2, 0.0125), (3, 0.5)])
def test_grad_refine(num_step, bound):
    """lr 1e-2 moves the points visibly; the clamp holds them within the bound."""
    jnet, params, net = small_nets(seed=2)
    tsdf, p, _ = scenes(seed=41)
    args = (bound, 1e-2, num_step)
    ref = jnet.apply(params, jnp.asarray(tsdf), jnp.asarray(p), *args,
                     method=JGIGANet.grad_refine)
    with torch.inference_mode():
        got = net.grad_refine(_t(tsdf), _t(p), *args)
    for a, b in zip(got, ref):
        _close(a, b)
    moved = np.abs(np.asarray(ref[1]) - p)
    assert moved.max() > 1e-4 and moved.max() <= bound + 1e-6
    assert all(w.grad is None for w in net.parameters())
    assert all(w.requires_grad for w in net.parameters())


@pytest.mark.parametrize("detach", [True, False])
def test_occupancy_gradient_reaches_encoder_unless_detached(detach):
    """giga_detach: the occupancy loss sends no gradient into the encoder's
    weights, in both packages; without detach_tsdf it does."""
    jnet, params, net = small_nets(detach=detach, seed=3)
    tsdf, _, p_occ = scenes(seed=51)

    def jloss(prm):
        return jnet.apply(prm, jnp.asarray(tsdf), None, jnp.asarray(p_occ))["occ"].sum()

    jgrads = jax.grad(jloss)(params)["params"]["encoder"]
    jnorm = float(sum(jnp.abs(g).sum() for g in jax.tree.leaves(jgrads)))
    enc = list(net.encoder.parameters())
    grads = torch.autograd.grad(net(_t(tsdf), None, _t(p_occ))["occ"].sum(), enc,
                                allow_unused=True)
    norm = float(sum(g.abs().sum() for g in grads if g is not None))
    if detach:
        assert jnorm == 0.0 and norm == 0.0
    else:
        assert jnorm > 0.0 and norm > 0.0
        np.testing.assert_allclose(norm, jnorm, rtol=1e-3)


# -- decode_lattice_points --------------------------------------------------------

@pytest.mark.parametrize("dense", [False, True])
def test_decode_lattice_points(dense):
    rng = np.random.RandomState(60)
    R, n_blocks = 12, 2
    jdec = JDecoder(decoder_cfg(jcfg, concat=not dense), heads=3, out_dim=4)
    p0 = jnp.zeros((1, 1, 3))
    j0 = ({"grid": jnp.zeros((1, 4, 4, 4, 8))} if dense
          else {t: jnp.zeros((1, RESO, RESO, 8)) for t in ("xz", "xy", "yz")})
    dec = {k: np.asarray(v) for k, v in
           jax.device_get(jdec.init(jax.random.PRNGKey(5), j0, p0))["params"].items()}
    if dense:
        feats = {"dense": rng.standard_normal((R, R, R, 8)).astype(np.float32)}
    else:
        feats = {t: rng.standard_normal((R, R, 8)).astype(np.float32) for t in ("xz", "xy", "yz")}
    ix, iy, iz = (rng.randint(0, R, 200) for _ in range(3))
    coords = np.asarray(jdd.lattice_coords(R))
    ref = jdd.decode_lattice_points({k: jnp.asarray(v) for k, v in dec.items()},
                                    {t: jnp.asarray(v) for t, v in feats.items()},
                                    jnp.asarray(coords), jnp.asarray(ix), jnp.asarray(iy),
                                    jnp.asarray(iz), n_blocks)
    got = tdd.decode_lattice_points({k: _t(v) for k, v in dec.items()},
                                    {t: _t(v) for t, v in feats.items()}, _t(coords),
                                    _t(ix), _t(iy), _t(iz), n_blocks)
    assert got.shape == (3, 200, 4)
    _close(got, ref)
    if not dense:  # the lattice decode at the same indices
        full = tdd.decode_dense({k: _t(v) for k, v in dec.items()},
                                {t: _t(v) for t, v in feats.items()}, _t(coords), n_blocks)
        _close(got, full[:, ix, iy, iz])
