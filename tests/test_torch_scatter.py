"""The port's segment reductions (giga_tpu_torch/ops/scatter.py) against the
JAX package's (giga_tpu/ops/scatter.py) on the CPU, on numpy-seeded points
and features: cell indices equal, means and maxima within 1e-6, empty
segments 0. The boundary case is the encoder's: the voxel lattice points
(linspace(-0.5, 0.5, n), in jnp.linspace's float32 formula) of a 16^3
volume onto 8^2 planes and an 8^3 grid, and of the sizes around it, whose
points lie on or next to cell boundaries.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from giga_tpu.models.encoder import voxel_lattice_points as jax_lattice_points
from giga_tpu.ops import scatter as J
from giga_tpu_torch.models.encoder import voxel_lattice_points
from giga_tpu_torch.ops import scatter as T

TOL = 1e-6


def lattice(n: int):
    return voxel_lattice_points((n, n, n)).reshape(1, -1, 3)


@pytest.mark.parametrize("n", [8, 9, 15, 16, 17, 33, 40, 41])
@pytest.mark.parametrize("reso", [8, 16, 40])
@pytest.mark.parametrize("padding", [0.0, 0.1])
def test_lattice_indices_equal_jax(n, reso, padding):
    pts = lattice(n)
    jpts = jnp.asarray(jax_lattice_points((n, n, n)).reshape(1, -1, 3))
    # jnp.linspace's formula, which XLA's CPU build evaluates through a
    # reciprocal and an FMA: an ulp of 0.5 apart at most
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=6e-8, rtol=0)
    for t in ("xz", "xy", "yz"):
        np.testing.assert_array_equal(T.plane_index(pts, t, reso, padding).numpy(),
                                      np.asarray(J.plane_index(jpts, t, reso, padding)))
    np.testing.assert_array_equal(T.grid_index(pts, reso, padding).numpy(),
                                  np.asarray(J.grid_index(jpts, reso, padding)))


def _inputs(seed: int, B: int = 3, N: int = 500, C: int = 5, spread: float = 0.5):
    r = np.random.RandomState(seed)
    pts = r.uniform(-spread, spread, (B, N, 3)).astype(np.float32)
    feat = r.randn(B, N, C).astype(np.float32)
    return pts, feat


@pytest.mark.parametrize("plane", ["xz", "xy", "yz"])
def test_scatter_mean_planes_matches_jax(plane):
    pts, feat = _inputs(0)
    got = T.scatter_mean_planes(torch.from_numpy(pts), torch.from_numpy(feat), plane, 8)
    ref = np.asarray(J.scatter_mean_planes(jnp.asarray(pts), jnp.asarray(feat), plane, 8))
    assert got.shape == ref.shape == (3, 8, 8, 5)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


def test_scatter_mean_grid_matches_jax_on_the_boundary_lattice():
    """16^3 lattice points onto an 8^3 grid, features of each voxel."""
    pts = lattice(16).expand(2, -1, -1)
    feat = np.random.RandomState(1).randn(2, 16 ** 3, 4).astype(np.float32)
    got = T.scatter_mean_grid(pts, torch.from_numpy(feat), 8)
    ref = np.asarray(J.scatter_mean_grid(jnp.asarray(pts.numpy()), jnp.asarray(feat), 8))
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


def test_empty_segments_are_zero():
    """Points in a corner only: most segments empty, 0 in both reductions;
    a reached segment's maximum is its true maximum, also when negative."""
    pts, feat = _inputs(2, spread=0.2)
    feat = feat - 10.0  # every feature negative
    idx = J.plane_index(jnp.asarray(pts), "xy", 16)
    tidx = T.plane_index(torch.from_numpy(pts), "xy", 16)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    for name in ("segment_mean", "segment_max"):
        got = getattr(T, name)(torch.from_numpy(feat), tidx, 256).numpy()
        ref = np.stack([np.asarray(getattr(J, name)(jnp.asarray(f), i, 256))
                        for f, i in zip(feat, idx)])
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0, err_msg=name)
        reached = np.zeros((3, 256), bool)
        for b in range(3):
            reached[b, np.asarray(idx[b])] = True
        assert (~reached).any() and (got[~reached] == 0).all()
        assert (got[reached] < 0).all()


def test_segment_max_matches_jax_on_mixed_signs():
    pts, feat = _inputs(3)
    idx = T.grid_index(torch.from_numpy(pts), 4)
    got = T.segment_max(torch.from_numpy(feat), idx, 64).numpy()
    ref = np.stack([np.asarray(J.segment_max(jnp.asarray(f), jnp.asarray(i.numpy()), 64))
                    for f, i in zip(feat, idx)])
    np.testing.assert_array_equal(got, ref)
