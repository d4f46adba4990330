"""Shared helpers of the point-model parity tests (tests/test_torch_pointnet.py,
test_torch_pointnetpp.py, test_torch_crop.py): the port's seeded weights as
JAX variables (models/convert.py), JAX's outputs and gradients in one jit,
and the tolerances."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from giga_tpu_torch.models.convert import _point_state_dict, flax_to_state_dict, state_dict_to_flax
from giga_tpu_torch.models.registry import seed_weights

TOL = 2e-5       # forward: |a - b| <= TOL * (1 + |b|)
TOL_GRAD = 1e-5  # gradients: |a - b| <= TOL_GRAD * (1 + max |g|) of each leaf


def seeded(net: torch.nn.Module, seed: int = 0) -> dict:
    """The port's ``seed_weights`` of ``seed`` in ``net`` (every weight and
    bias uniform in +-1/sqrt(fan_in), so no gradient vanishes) -> the same
    weights as JAX variables ({"params"[, "batch_stats"]}, numpy)."""
    seed_weights(net, seed)
    return state_dict_to_flax(net.state_dict())


def jax_fwd_grad(module, variables: dict, *args, **kwargs):
    """(outputs, gradients of their sum of squares) of ``module.apply``, one jit."""
    def run(v, *a):
        def loss(p):
            out = module.apply({**v, "params": p}, *a, **kwargs)
            return sum_sq(out), out

        (_, out), g = jax.value_and_grad(loss, has_aux=True)(v["params"])
        return out, g

    return jax.device_get(jax.jit(run)(variables, *args))


def load(net: torch.nn.Module, variables: dict) -> torch.nn.Module:
    net.load_state_dict(flax_to_state_dict(variables))
    return net


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def close(got, ref, tol: float = TOL) -> float:
    """max |a - b| / (1 + |b|), asserted within ``tol``."""
    got, ref = (np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float64)
                for a in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float((np.abs(got - ref) / (1 + np.abs(ref))).max(initial=0.0))
    assert err <= tol, err
    return err


def sum_sq(out) -> "array":
    leaves = out.values() if isinstance(out, dict) else (out if isinstance(out, tuple) else [out])
    return sum(jnp.sum(v ** 2) if not isinstance(v, torch.Tensor) else torch.sum(v ** 2)
               for v in leaves)


def port_grads(net: torch.nn.Module, out) -> dict:
    net.zero_grad()
    sum_sq(out).backward()
    return {k: p.grad.detach().numpy() for k, p in net.named_parameters()}


def jax_grads_as_port(grads: dict, stats: dict | None = None) -> dict:
    """A JAX gradient tree under the port's state-dict names."""
    if stats:
        return {k: v for k, v in _point_state_dict(grads, stats).items()
                if not k.endswith(("running_mean", "running_var"))}
    return {k: v.numpy() for k, v in flax_to_state_dict(grads).items()}


def close_grads(got: dict, ref: dict, tol: float = TOL_GRAD, whole: bool = False) -> float:
    """Every leaf within ``tol`` * (1 + max |g|) of the reference's: its own
    max |g|, or with ``whole`` the largest of every leaf's."""
    assert set(got) == set(ref), set(got) ^ set(ref)
    worst = 0.0
    scale = max(float(np.abs(np.asarray(g, np.float64)).max()) for g in ref.values())
    for k, g in ref.items():
        g = np.asarray(g, np.float64)
        err = float(np.abs(np.asarray(got[k], np.float64) - g).max()
                    / (1 + (scale if whole else np.abs(g).max())))
        assert err <= tol, (k, err)
        worst = max(worst, err)
    return worst


def with_duplicates(pts: np.ndarray, rng: np.random.RandomState, share: float = 0.25):
    """``pts`` (B, T, 3) with a ``share`` of each cloud's points replaced by
    copies of others (a crop's resample with replacement)."""
    out = pts.copy()
    B, T, _ = pts.shape
    n = int(T * share)
    for b in range(B):
        dst = rng.choice(T, n, replace=False)
        out[b, dst] = pts[b, rng.randint(0, T, n)]
    return out
