"""The port's point encoders and decoders (models/pointnet.py, the point
decoders of models/decoder.py, ResnetBlockFC) against the JAX package's on
the CPU, at JAX's own test sizes (tests/test_encoders.py,
tests/test_sliding_window.py): the same numpy-seeded inputs (clouds with
duplicated points among them) and the same weights (the port's
``seed_weights``, given to JAX through models/convert.py), JAX's side
jitted.

Forward outputs are held within 2e-5 * (1 + |b|) and each gradient leaf
within 1e-5 * (1 + max |g|). Where a GroupNorm enters (the grid branch's 3D
U-Net), JAX is evaluated in float64 (``jax.enable_x64``) instead: the
port's float64 within 1e-6 of it, the port's float32 within the bounds
above of it (``check_against_float64``). The crop encoder's grid-only
branch is held in tests/test_torch_crop.py (the grid crop model).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from giga_tpu.core.config import DecoderConfig as JDecoderConfig
from giga_tpu.core.config import EncoderConfig as JEncoderConfig
from giga_tpu.core.config import UNet3DConfig as JUNet3DConfig
from giga_tpu.models import decoder as jdec
from giga_tpu.models import pointnet as jpn
from giga_tpu.models.layers import ResnetBlockFC as JResnetBlockFC
from giga_tpu_torch.core.config import DecoderConfig, EncoderConfig, UNet3DConfig
from giga_tpu_torch.models import decoder as tdec
from giga_tpu_torch.models import pointnet as tpn
from giga_tpu_torch.models.layers import ResnetBlockFC
from giga_tpu_torch.models.registry import seed_weights
from torch_points import (
    close,
    close_grads,
    f64,
    jax_grads_as_port,
    port_grads,
    jax_fwd_grad,
    seeded,
    sum_sq,
    with_duplicates,
)

SMALL_U3 = dict(f_maps=8, num_levels=2, num_groups=2)
UNIT = 0.125  # the crop models' unit size here: see test_patch_local_pool_pointnet


def jax_run(module, variables, *args, x64: bool = False):
    """(outputs, gradients of the sum of squares) of ``module`` in JAX,
    jitted; in float64 with ``x64``."""
    if not x64:
        return jax_fwd_grad(module, variables, *args)
    with jax.enable_x64(True):
        return jax_fwd_grad(module, f64(variables), *(
            jax.tree.map(lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f"
                         else a, x) for x in args))


def check_against_float64(jm, tm, v, args, targs) -> dict:
    """A model with a GroupNorm: the port's float64 evaluation held to JAX's
    float64 within 1e-6 (the same function), the port's float32 within TOL
    * (1 + |b|) and TOL_GRAD * (1 + max |g|) of it. Returns the port's
    float32 outputs."""
    import copy

    ref64, g64 = jax_run(jm, v, *args, x64=True)
    g64 = jax_grads_as_port(g64)
    out = tm(*targs)
    grads = port_grads(tm, out)
    tm64 = copy.deepcopy(tm).double()
    out64 = tm64(*(a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                   for a in targs))
    close_grads(port_grads(tm64, out64), g64, 1e-6)
    for t in ref64:
        close(out64[t].detach(), ref64[t], 1e-6)
        print(f"{t}: the port's float32 {close(out[t], ref64[t]):.3g} * (1 + |b|) from float64")
    print(f"gradients: the port's float32 {close_grads(grads, g64):.3g} * (1 + max |g|) from "
          f"float64")
    return out


def clouds(seed: int, B: int, T: int, lo=-0.5, hi=0.5):
    rng = np.random.RandomState(seed)
    return with_duplicates(rng.uniform(lo, hi, (B, T, 3)).astype(np.float32), rng)


def test_resnet_block_fc_with_shortcut():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 7, 12).astype(np.float32)
    tb = seed_weights(ResnetBlockFC(12, 5))
    tree = {fc: {"kernel": getattr(tb, fc).weight.detach().numpy().T} for fc in
            ("fc_0", "fc_1", "shortcut")}
    for fc in ("fc_0", "fc_1"):
        tree[fc]["bias"] = getattr(tb, fc).bias.detach().numpy()
    close(tb(torch.from_numpy(x)), JResnetBlockFC(size_out=5).apply({"params": tree}, x))
    assert tb.shortcut is not None and ResnetBlockFC(8).shortcut is None
    assert not ResnetBlockFC(8).fc_1.weight.any()  # zero-initialized, as the reference's


def test_local_pool_pointnet():
    """tests/test_encoders.py's sizes: planes 16^2, hidden 8, 3 blocks, B=2,
    64 points, a quarter of them duplicates. Mean pooling (``pool_local``,
    which both encoders share) is held in test_patch_local_pool_pointnet."""
    cfg, jcfg = EncoderConfig(plane_resolution=16), JEncoderConfig(plane_resolution=16)
    p = clouds(0, 2, 64)
    jm = jpn.LocalPoolPointnet(jcfg, hidden_dim=8, n_blocks=3, scatter_type="max")
    tm = tpn.LocalPoolPointnet(cfg, hidden_dim=8, n_blocks=3, scatter_type="max")
    v = seeded(tm)
    ref, gref = jax_run(jm, v, p)
    out = tm(torch.from_numpy(p))
    assert list(out) == ["xz", "xy", "yz"]
    for t in out:
        close(out[t], ref[t])
    close_grads(port_grads(tm, out), jax_grads_as_port(gref))


def test_local_pool_pointnet_grid_branch_against_float64():
    """``use_grid``: max pooling through the planes' and an 8^3 grid's cells,
    the grid refined by a 2-level 3D U-Net (GroupNorm): held to JAX in
    float64."""
    cfg = EncoderConfig(plane_resolution=8, unet3d=UNet3DConfig(**SMALL_U3))
    jcfg = JEncoderConfig(plane_resolution=8, unet3d=JUNet3DConfig(**SMALL_U3))
    p = clouds(1, 2, 96)
    jm = jpn.LocalPoolPointnet(jcfg, hidden_dim=8, n_blocks=3, grid_resolution=8, use_grid=True)
    tm = tpn.LocalPoolPointnet(cfg, hidden_dim=8, n_blocks=3, grid_resolution=8,
                                    use_grid=True)
    v = seeded(tm)
    out = check_against_float64(jm, tm, v, (p,), (torch.from_numpy(p),))
    assert set(out) == {"xz", "xy", "yz", "grid"} and out["grid"].shape == (2, 8, 8, 8, 32)


def _patch_inputs(seed: int, reso: int, greso: int | None, B: int = 2, T: int = 32):
    rng = np.random.RandomState(seed)
    p = with_duplicates(rng.uniform(0, 1, (B, T, 3)).astype(np.float32), rng)
    index = {t: rng.randint(0, reso * reso, (B, T)).astype(np.int32) for t in ("xz", "xy", "yz")}
    if greso:
        index["grid"] = rng.randint(0, greso ** 3, (B, T)).astype(np.int32)
    return p, index


@pytest.mark.parametrize("pos_encoding,scatter_type", [("linear", "max"), ("sin_cos", "mean")])
def test_patch_local_pool_pointnet(pos_encoding, scatter_type):
    """tests/test_encoders.py::test_patch_variant's sizes: planes 8^2, hidden 8,
    2 blocks, caller-given cell indices; the unit size 1/8. At a unit size of
    0.1, jitted XLA divides ``map2local``'s remainder through the unit's
    reciprocal (an ulp off the quotient in 20 of these 192 coordinates),
    which sin_cos's top frequency, 512 pi, lifts to 1e-4 in the features;
    the port divides correctly rounded, as eager JAX does
    (tests/test_torch_decode_points.py::test_map2local holds that case). At
    a power of two both quotients are exact."""
    p, index = _patch_inputs(7, 8, None)
    jm = jpn.PatchLocalPoolPointnet(JEncoderConfig(plane_resolution=8), hidden_dim=8, n_blocks=2,
                                    scatter_type=scatter_type, pos_encoding=pos_encoding,
                                    unit_size=UNIT)
    tm = tpn.PatchLocalPoolPointnet(EncoderConfig(plane_resolution=8), hidden_dim=8,
                                         n_blocks=2, scatter_type=scatter_type,
                                         pos_encoding=pos_encoding, unit_size=UNIT)
    v = seeded(tm)
    ref, gref = jax_run(jm, v, p, index)
    out = tm(torch.from_numpy(p), {t: torch.from_numpy(i).long() for t, i in index.items()})
    for t in ("xz", "xy", "yz"):
        close(out[t], ref[t])
    close_grads(port_grads(tm, out), jax_grads_as_port(gref))


def _planes(seed: int, B: int, C: int, reso: int = 8, grid: bool = False):
    rng = np.random.RandomState(seed)
    planes = {t: rng.randn(B, reso, reso, C).astype(np.float32) for t in ("xz", "xy", "yz")}
    if grid:
        planes["grid"] = rng.randn(B, 6, 7, 5, C).astype(np.float32)
    return planes


@pytest.mark.parametrize("grid", [False, True])
def test_fc_decoder(grid):
    planes = _planes(2, 2, 32, grid=grid)
    p = clouds(3, 2, 40, -0.55, 0.55)
    jm = jdec.FCDecoder(JDecoderConfig())
    tm = tdec.FCDecoder(DecoderConfig())
    v = seeded(tm)
    ref, gref = jax_run(jm, v, planes, p)
    out = tm({t: torch.from_numpy(a) for t, a in planes.items()}, torch.from_numpy(p))
    assert out.shape == (2, 40)
    close(out, ref)
    close_grads(port_grads(tm, out), jax_grads_as_port(gref))


@pytest.mark.parametrize("pos_encoding,grid", [("linear", True), ("sin_cos", False)])
def test_patch_local_decoder(pos_encoding, grid):
    """tests/test_sliding_window.py::TestPatchDecoder's sizes (c_dim 96,
    8^2 planes), coordinates past [0, 1] at both ends to reach the clamps;
    the unit size 1/8, as in test_patch_local_pool_pointnet."""
    rng = np.random.RandomState(4)
    B, N = 2, 30
    p = rng.uniform(0, 1, (B, N, 3)).astype(np.float32)
    p_n = {t: rng.uniform(-0.1, 1.1, (B, N, 2)).astype(np.float32) for t in ("xz", "xy", "yz")}
    planes = _planes(5, B, 96, grid=grid)
    if grid:
        p_n["grid"] = rng.uniform(-0.1, 1.1, (B, N, 3)).astype(np.float32)
    jm = jdec.PatchLocalDecoder(JDecoderConfig(c_dim=96), pos_encoding=pos_encoding,
                                unit_size=UNIT)
    tm = tdec.PatchLocalDecoder(DecoderConfig(c_dim=96), pos_encoding=pos_encoding,
                                     unit_size=UNIT)
    v = seeded(tm)
    ref, gref = jax_run(jm, v, p, p_n, planes)
    out = tm(torch.from_numpy(p), {t: torch.from_numpy(a) for t, a in p_n.items()},
             {t: torch.from_numpy(a) for t, a in planes.items()})
    close(out, ref)
    close_grads(port_grads(tm, out), jax_grads_as_port(gref))


def test_local_point_decoder_chunked(monkeypatch):
    """tests/test_encoders.py's sizes (c_dim 16, 32 points), the queries
    decoded in chunks of 3 (the byte budget cut to 3 queries' differences):
    each query's softmax and weighted sum lie whole in its chunk, so the
    outputs equal the unchunked decode's up to the products' rounding
    (1e-6)."""
    rng = np.random.RandomState(0)
    pts = with_duplicates(rng.uniform(-0.5, 0.5, (2, 32, 3)).astype(np.float32), rng)
    feats = rng.randn(2, 32, 16).astype(np.float32)
    q = rng.uniform(-0.5, 0.5, (2, 7, 3)).astype(np.float32)
    jm = jdec.LocalPointDecoder(JDecoderConfig(c_dim=16, concat_feat=False))
    tm = tdec.LocalPointDecoder(DecoderConfig(c_dim=16, concat_feat=False))
    v = seeded(tm)
    ref, gref = jax_run(jm, v, pts, feats, q)
    with torch.no_grad():
        whole = tm(torch.from_numpy(pts), torch.from_numpy(feats), torch.from_numpy(q))
    monkeypatch.setattr(tdec, "POINT_DECODE_BYTES", 3 * 2 * 32 * 3 * 4)
    out = tm(torch.from_numpy(pts), torch.from_numpy(feats), torch.from_numpy(q))
    close(out, ref)
    close_grads(port_grads(tm, out), jax_grads_as_port(gref))
    close(whole, out.detach(), 1e-6)


@pytest.mark.parametrize("grid", [False, True])
def test_reference_state_dicts_round_trip_through_jax(grid):
    """The reference's names: a port encoder's (planes, or planes and a 3D
    U-Net) and PatchLocalDecoder's state dicts read by JAX's
    convert_pointnet_state_dict / convert_patch_decoder_state_dict give the
    port's own flax trees exactly, and the port's readers give its state
    back exactly."""
    from giga_tpu.models.torch_convert import (
        convert_patch_decoder_state_dict as jax_patch,
        convert_pointnet_state_dict as jax_pointnet,
    )
    from giga_tpu_torch.models.convert import (
        convert_patch_decoder_state_dict,
        convert_pointnet_state_dict,
        state_dict_to_flax,
        to_reference_state_dict,
    )

    cfg = EncoderConfig(plane_resolution=8, unet3d=UNet3DConfig(**SMALL_U3))
    enc = tpn.LocalPoolPointnet(cfg, hidden_dim=8, n_blocks=3, grid_resolution=8, use_grid=grid)
    dec = tdec.PatchLocalDecoder(DecoderConfig(n_blocks=3))
    for net, jax_reader, reader in ((enc, jax_pointnet, convert_pointnet_state_dict),
                                    (dec, jax_patch, convert_patch_decoder_state_dict)):
        seed_weights(net, 1)
        ref = to_reference_state_dict(net.state_dict())
        jtree, tree = jax_reader(ref, n_blocks=3), state_dict_to_flax(net.state_dict())
        assert jax.tree.structure(jtree) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)
        got = reader(ref, n_blocks=3)
        assert set(got) == set(net.state_dict())
        for k, t in net.state_dict().items():
            assert torch.equal(got[k], t), k
