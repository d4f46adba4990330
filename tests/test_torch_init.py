"""``reference_init`` (giga_tpu_torch/models/registry.py), the start of a
training run from scratch, against the JAX package's ``net.init`` on the
CPU, leaf by leaf under models/convert.py's names.

The two draw from different generators, so the test holds each leaf to
JAX's rule, not to its numbers:

* a leaf that is exactly 0 or exactly 1 in JAX (ResnetBlockFC's ``fc_1``
  kernels, the U-Net's and GlobalVoxelEncoder's biases, norm scales and
  biases) is exactly that in the port;
* a uniform leaf (torch's U(+-1/sqrt(fan_in)), its bound from the port's
  shape) has max |w| at most the bound (1e-6 relative) on both sides, and
  above 0.9 x the bound on both sides where it has at least 64 elements
  (0.9 ** 64 < 1e-3, so a smaller leaf may rightly stay below);
* a normal leaf (the U-Net's xavier-normal Conv2d weights,
  GlobalVoxelEncoder's lecun-normal ones: flax's truncated normals) of at
  least 256 elements has a standard deviation within 10 % of JAX's, and
  every normal leaf stays inside two of the truncated draw's deviations.

JAX's parameters depend only on module paths and channel widths, not on
the input's size, so each preset's JAX init runs on an 8^3 volume with its
plane and grid resolutions cut to 8 (test_reduced_init_is_the_full_one
holds that premise on giga_grid against the golden file's full-size init).
The crop model's case covers its patch encoder and patch decoder. The
point models' JAX inits run as one jitted program each (faster than op by
op for them; the presets share their ops, so theirs run op by op).
``seed_weights``, which the kernel and parity tests use, is unchanged: one
hash of its giga weights. The port's side runs on one torch thread.
"""

import dataclasses
import functools
import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from giga_tpu.core.config import DecoderConfig as JDecoderConfig
from giga_tpu.core.config import EncoderConfig as JEncoderConfig
from giga_tpu.core.config import GIGAConfig as JGIGAConfig
from giga_tpu.models import decoder as jdec
from giga_tpu.models import pointnet as jpn
from giga_tpu.models import pointnetpp as jpp
from giga_tpu.models.conv_onet import GIGANet as JGIGANet
from giga_tpu.models.crop import CropOccupancyNet as JCropOccupancyNet
from giga_tpu.models.encoder import GlobalVoxelEncoder as JGlobalVoxelEncoder
from giga_tpu.models.registry import get_network as jax_get_network
from giga_tpu.train.trainer import create_train_state as jax_create_train_state
from giga_tpu_torch.core.config import DecoderConfig, EncoderConfig
from giga_tpu_torch.models import decoder as tdec
from giga_tpu_torch.models import pointnet as tpn
from giga_tpu_torch.models import pointnetpp as tpp
from giga_tpu_torch.models.convert import flax_to_state_dict
from giga_tpu_torch.models.crop import CropOccupancyNet
from giga_tpu_torch.models.encoder import GlobalVoxelEncoder
from giga_tpu_torch.models.registry import get_network, reference_init, seed_weights
from torch_sim import one_torch_thread  # noqa: F401  (autouse)

import chip_smoke  # noqa: E402

PRESETS = ["giga", "giga_aff", "giga_geo", "giga_detach", "giga_wide", "giga_grid", "vgn"]
SEED_WEIGHTS_GIGA_SHA256 = "f826dc8b3926058fef0eedac9aff969eecee7c691e224b64d83129a582a9db93"
BOUND_RTOL = 1e-6  # float32 rounding of a uniform draw's bound
STD_RTOL = 0.10    # a normal leaf's std against JAX's
TRUNC = 2.0 / 0.87962566103423978  # flax's truncated normal: +-2 of the cut deviation's scale


def _is_normal(name: str, global_encoder: bool) -> bool:
    if global_encoder:
        return name.endswith(".weight")
    return (re.search(r"(^|\.)unet\.", name) is not None and ".upconv." not in name
            and name.endswith(".weight"))


def _fan_in(name: str, sd: dict) -> int:
    if name.endswith(("_kernel", "_bias")):  # a stacked (heads, fan_in, out) decoder leaf
        return sd[name.replace("_bias", "_kernel")].shape[1]
    weight = sd[name.rsplit(".", 1)[0] + ".weight"]
    return torch.nn.init._calculate_fan_in_and_fan_out(weight)[0]


def _fans(w: torch.Tensor) -> tuple:
    return torch.nn.init._calculate_fan_in_and_fan_out(w)


def check_rule(port: dict, ref: dict, global_encoder: bool = False) -> dict:
    """Every leaf of ``port`` (the port's state dict) under ``ref``'s rule
    (JAX's leaves under the same names); returns {rule: leaf count}."""
    assert sorted(port) == sorted(ref)
    counts = {"zero": 0, "one": 0, "uniform": 0, "normal": 0}
    for name, r in ref.items():
        got = port[name].detach().double().numpy()
        r = r.double().numpy()
        assert got.shape == r.shape, name
        if not r.any():
            assert not got.any(), name
            counts["zero"] += 1
        elif (r == 1).all():
            assert (got == 1).all(), name
            counts["one"] += 1
        elif _is_normal(name, global_encoder):
            w = port[name]
            fan_in, fan_out = _fans(w)
            var = 1.0 / fan_in if global_encoder else 2.0 / (fan_in + fan_out)
            for a in (got, r):
                assert np.abs(a).max() <= TRUNC * var ** 0.5 * (1 + BOUND_RTOL), name
            if r.size >= 256:
                assert abs(got.std() / r.std() - 1) <= STD_RTOL, (name, got.std(), r.std())
            counts["normal"] += 1
        else:
            bound = _fan_in(name, port) ** -0.5
            for a in (got, r):
                assert np.abs(a).max() <= bound * (1 + BOUND_RTOL), name
                if a.size >= 64:
                    assert np.abs(a).max() > 0.9 * bound, name
            assert got.any(), name
            counts["uniform"] += 1
    return counts


def _jax_small(net, cfg):
    """(net, cfg) at plane and grid resolution 8: the same parameters."""
    if not isinstance(cfg, JGIGAConfig):
        return net, cfg
    enc = dataclasses.replace(cfg.encoder, plane_resolution=8, grid_resolution=8)
    cfg = dataclasses.replace(cfg, encoder=enc)
    return JGIGANet(cfg), cfg


@functools.lru_cache(maxsize=None)
def jax_preset_init(name: str) -> dict:
    """JAX's ``create_train_state(..., PRNGKey(0))`` params of a preset, its
    plane and grid resolutions cut to 8 (the same parameters)."""
    net, cfg = _jax_small(*jax_get_network(name))
    return jax.device_get(jax_create_train_state(net, cfg, jax.random.PRNGKey(0),
                                                 tsdf_shape=(1, 8, 8, 8)).params)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_follows_jax_init(name):
    net, _ = get_network(name)
    reference_init(net, 0)
    counts = check_rule(net.state_dict(), flax_to_state_dict(jax_preset_init(name)))
    if name != "vgn":  # every GIGA preset zeroes its blocks' fc_1 kernels
        assert counts["zero"] >= 5
    if name not in ("vgn", "giga_grid"):  # the 2D U-Net's xavier convs
        assert counts["normal"] == 11
    assert counts["uniform"] > 0


def test_reduced_init_is_the_full_one():
    """giga_grid at resolution 8 gives the params that
    golden_plan_giga_grid.npz stores from JAX's ``net.init(PRNGKey(0))`` on
    a 40^3 volume (tests/test_torch_grid_golden.py keeps that file current)."""
    stored = np.load(Path(__file__).resolve().parents[1] / chip_smoke.GOLDEN_GRID)
    full = chip_smoke.flatten_params(chip_smoke.unflatten_params(
        {k: stored[k] for k in stored.files}))
    small = chip_smoke.flatten_params(jax_preset_init("giga_grid"))
    assert sorted(small) == sorted(full)
    for k, v in full.items():
        np.testing.assert_array_equal(small[k], v, err_msg=k)


def test_init_is_seeded():
    def draw(seed):
        return reference_init(tpn.LocalPoolPointnet(EncoderConfig(plane_resolution=16),
                                                    hidden_dim=8, n_blocks=3), seed).state_dict()

    a, b, c = draw(3), draw(3), draw(4)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert any(not torch.equal(a[k], c[k]) for k in a if a[k].any())


def _point_cases():
    rng = np.random.RandomState(0)
    B, T = 1, 16
    p = rng.uniform(-0.5, 0.5, (B, T, 3)).astype(np.float32)
    idx8 = {t: rng.randint(0, 64, (B, T)).astype(np.int32) for t in ("xz", "xy", "yz")}
    planes32 = {t: np.zeros((B, 8, 8, 32), np.float32) for t in ("xz", "xy", "yz")}
    planes96 = {t: np.zeros((B, 8, 8, 96), np.float32) for t in ("xz", "xy", "yz")}
    p_n = {t: rng.uniform(0, 1, (B, T, 2)).astype(np.float32) for t in ("xz", "xy", "yz")}
    feats = np.zeros((B, T, 16), np.float32)
    crop_enc = dict(c_dim=16, plane_resolution=8)
    return {
        "local_pool_pointnet": (
            lambda: jpn.LocalPoolPointnet(JEncoderConfig(plane_resolution=16), hidden_dim=8,
                                          n_blocks=3),
            lambda: tpn.LocalPoolPointnet(EncoderConfig(plane_resolution=16), hidden_dim=8,
                                          n_blocks=3), (p,)),
        "fc_decoder": (lambda: jdec.FCDecoder(JDecoderConfig()),
                       lambda: tdec.FCDecoder(DecoderConfig()), (planes32, p)),
        "local_point_decoder": (
            lambda: jdec.LocalPointDecoder(JDecoderConfig(c_dim=16, concat_feat=False)),
            lambda: tdec.LocalPointDecoder(DecoderConfig(c_dim=16, concat_feat=False)),
            (p, feats, p)),
        "pointnetpp": (lambda: jpp.PointNetPlusPlus(c_dim=16),
                       lambda: tpp.PointNetPlusPlus(c_dim=16),
                       (rng.uniform(-0.5, 0.5, (B, 64, 3)).astype(np.float32),)),
        "crop": (lambda: JCropOccupancyNet(JEncoderConfig(**crop_enc), hidden_dim=16, n_blocks=2,
                                           unit_size=0.05),
                 lambda: CropOccupancyNet(EncoderConfig(**crop_enc), hidden_dim=16, n_blocks=2,
                                          unit_size=0.05),
                 (p + 0.5, idx8, p + 0.5, p_n)),
    }


POINT_CASES = list(_point_cases())


@pytest.mark.parametrize("case", POINT_CASES)
def test_point_model_follows_jax_init(case):
    """The point and crop models of the JAX package that set an init
    (TorchDense, ResnetBlockFC, SharedMLP, their U-Nets), at
    tests/test_torch_pointnet.py's and test_torch_crop.py's sizes."""
    jax_ctor, port_ctor, args = _point_cases()[case]
    ref = jax.device_get(jax.jit(jax_ctor().init)(jax.random.PRNGKey(0), *args))
    net = reference_init(port_ctor(), 0)
    counts = check_rule(net.state_dict(), flax_to_state_dict(ref))
    assert counts["uniform"] > 0
    if case == "pointnetpp":  # running statistics start at flax's 0 and 1
        for name, buf in net.named_buffers():
            assert (buf == (1.0 if name.endswith("var") else 0.0)).all(), name


def test_global_voxel_encoder_follows_flax_defaults():
    x = jnp.zeros((1, 32, 32, 32), jnp.float32)
    ref = jax.device_get(JGlobalVoxelEncoder(c_dim=16).init(jax.random.PRNGKey(0), x))
    net = reference_init(GlobalVoxelEncoder(c_dim=16), 0)
    counts = check_rule(net.state_dict(), flax_to_state_dict(ref), global_encoder=True)
    assert counts == {"zero": 6, "one": 0, "uniform": 0, "normal": 6}


def test_seed_weights_is_unchanged():
    net, _ = get_network("giga")
    seed_weights(net, 0)
    h = hashlib.sha256()
    for k, v in net.state_dict().items():
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == SEED_WEIGHTS_GIGA_SHA256
