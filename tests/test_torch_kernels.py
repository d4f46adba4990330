"""Kernels K1 (stem + pool) and K2 (dense-decode trunk) of the PyTorch port.

The kernels' plain versions are held against the JAX package's Pallas
kernels in interpret mode, on the same seeded inputs.
tests/test_torch_cuda.py holds the CUDA kernels against the plain
versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from giga_tpu.ops.pallas.decoder_kernel import fused_dense_decode_batched
from giga_tpu.ops.pallas.stem_kernel import fused_stem_pool_batched
from giga_tpu_torch.ops.kernels.decoder import (
    dense_decode_batched,
    dense_decode_plain,
    split_heads_transposed,
)
from giga_tpu_torch.ops.kernels.stem import stem_pool_batched, stem_pool_plain

TOL_STEM = 2e-5    # tests/test_stem_kernel.py
TOL_KERNEL = 1e-5  # tests/test_pallas_kernel.py


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
