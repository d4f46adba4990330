"""The port's PointNet++ (models/pointnetpp.py) against the JAX package's
(giga_tpu/models/pointnetpp.py) on the CPU, at tests/test_pointnetpp.py's
size (600 points, c_dim 16), JAX's side jitted.

Indices are held equal: farthest-point sampling, ball queries and the
3-nearest of feature propagation, on clouds with duplicated points (ties of
distance, which ``lax.top_k`` orders by the lower index and the port's
stable sort too). In eval mode the features are held within 2e-5 * (1 + |b|)
of JAX's float32 and each gradient leaf within 1e-5 * (1 + max |g|). In
train mode BatchNorm normalizes by the batch's statistics; SharedMLP's
train step (forward, gradients, running statistics) is held to JAX's in
float32 and float64 (``jax.enable_x64``), and the full network's train-mode
forward in float64 to JAX's float64 at phase 31's size through the golden
file (tests/test_torch_points_golden.py, within 1e-9). ``jax_fps_x64``
runs JAX's FPS under ``enable_x64`` for that golden.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from giga_tpu.models import pointnetpp as J
from giga_tpu_torch.models import pointnetpp as T
from torch_points import (
    close,
    close_grads,
    f64,
    jax_grads_as_port,
    load,
    port_grads,
    jax_fwd_grad,
    seeded,
    with_duplicates,
)

N = 600


@pytest.fixture(scope="module")
def cloud():
    """Two clouds of N points, a quarter of each duplicates of others."""
    rng = np.random.RandomState(2)
    return with_duplicates(rng.uniform(-0.5, 0.5, (2, N, 3)).astype(np.float32), rng)


@pytest.fixture(scope="module")
def variables():
    """The port's seeded weights as JAX variables, the running statistics
    drawn away from 0 and 1."""
    net = T.PointNetPlusPlus(c_dim=16)
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape) if name.endswith("var")
                                       else rng.uniform(-0.1, 0.1, buf.shape)))
    return seeded(net)


def port_net(variables) -> T.PointNetPlusPlus:
    return load(T.PointNetPlusPlus(c_dim=16), variables)


def test_square_distance(cloud):
    a, b = cloud[:, :50], cloud[:, 100:170]
    got = T.square_distance(torch.from_numpy(a), torch.from_numpy(b))
    close(got, jax.jit(J.square_distance)(a, b), 1e-6)


def test_farthest_point_sample_indices_equal(cloud):
    """The net's first level (512 of 600) and a clustered cloud whose
    duplicates tie the running distance."""
    fps = jax.jit(J.farthest_point_sample, static_argnums=1)
    np.testing.assert_array_equal(T.farthest_point_sample(torch.from_numpy(cloud), 512).numpy(),
                                  np.asarray(fps(cloud, 512)))
    rng = np.random.RandomState(1)
    two = np.concatenate([rng.uniform(0, 0.1, (64, 3)), rng.uniform(0.9, 1.0, (64, 3))])
    two = np.concatenate([two, two[:32]])[None].astype(np.float32)
    got = T.farthest_point_sample(torch.from_numpy(two), 40).numpy()
    np.testing.assert_array_equal(got, np.asarray(fps(two, 40)))
    assert len(set(got[0].tolist())) == 40


def test_ball_query_indices_equal(cloud):
    """Radius 0.2, 32 slots (the first level's) around FPS centroids, and
    around points that are themselves duplicated; tests/test_pointnetpp.py's
    radius case."""
    bq = jax.jit(J.ball_query, static_argnums=(0, 1))
    for radius, k, centers in ((0.2, 32, cloud[:, :64]), (0.4, 64, cloud[:, ::9])):
        got = T.ball_query(radius, k, torch.from_numpy(cloud), torch.from_numpy(centers)).numpy()
        np.testing.assert_array_equal(got, np.asarray(bq(radius, k, cloud, centers)))
    pts = np.array([[[0, 0, 0], [0.05, 0, 0], [1, 1, 1], [0.02, 0.02, 0], [0.05, 0, 0]]],
                   np.float32)
    got = T.ball_query(0.1, 5, torch.from_numpy(pts), torch.from_numpy(pts[:, :1])).numpy()
    np.testing.assert_array_equal(got, np.asarray(bq(0.1, 5, pts, pts[:, :1])))
    assert got[0, 0].tolist() == [0, 3, 1, 4, 0]


def test_nearest_k_breaks_ties_as_top_k():
    """lax.top_k's order, the lower index first among equals; torch.topk
    orders them otherwise."""
    x = np.array([[3, 1, 3, 2, 3, 1], [0, 0, 0, 0, 0, 0]], np.float32)
    vals, idx = T.nearest_k(torch.from_numpy(x), 4)
    jv, ji = jax.lax.top_k(x, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx[0].tolist() == [0, 2, 4, 3]


def test_three_nearest_of_feature_propagation(cloud):
    """FP's 3-nearest between the full cloud and its 128 FPS centroids,
    which are points of the cloud (d^2 = 0 by cancellation, and ties where
    they are duplicated)."""
    cent = np.take_along_axis(cloud, np.asarray(J.farthest_point_sample(cloud, 128))[..., None],
                              axis=1)
    d2 = jax.jit(J.square_distance)(cloud, cent)
    _, ref = jax.lax.top_k(-d2, 3)
    _, got = T.nearest_k(-T.square_distance(torch.from_numpy(cloud), torch.from_numpy(cent)), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_eval_forward_and_grad(cloud, variables):
    (_, ref), gref = jax_fwd_grad(J.PointNetPlusPlus(c_dim=16), variables, cloud)
    tm = port_net(variables).eval()
    xyz, out = tm(torch.from_numpy(cloud))
    assert out.shape == (2, N, 16) and torch.equal(xyz, torch.from_numpy(cloud))
    close(out, ref)
    close_grads(port_grads(tm, out), jax_grads_as_port(gref, variables["batch_stats"]))


def jax_fps_x64(xyz, npoint: int):
    """giga_tpu's ``farthest_point_sample`` with its scan carry typed so that
    it runs under ``jax.enable_x64`` (there argmax returns int64 where the
    carry starts int32); the same steps otherwise."""
    N = xyz.shape[1]

    def one(pts):
        def step(carry, _):
            dist, last = carry
            dist = jnp.minimum(dist, jnp.sum((pts - pts[last]) ** 2, axis=-1))
            nxt = jnp.argmax(dist).astype(jnp.int32)
            return (dist, nxt), nxt

        init = (jnp.full((N,), jnp.inf, xyz.dtype), jnp.asarray(0, jnp.int32))
        _, idx = jax.lax.scan(step, init, None, length=npoint - 1)
        return jnp.concatenate([jnp.zeros(1, jnp.int32), idx])

    return jax.vmap(one)(xyz)


def test_shared_mlp_train_step():
    """SharedMLP's train mode, its forward, its gradients and its running
    statistics, against flax's on a (4, 24, 6) batch: float32 within 2e-5 *
    (1 + |b|) and 1e-5 * (1 + max |g|) of JAX's float32, float64 within
    1e-9 of JAX's float64. max |g| is the largest of all leaves: a bias
    before a train-mode BatchNorm has a true gradient of 0 (the batch mean
    takes it out), which float32 leaves as rounding noise."""
    x = np.random.RandomState(6).randn(4, 24, 6).astype(np.float32)
    tm = T.SharedMLP(6, (16, 8))
    v = seeded_mlp(tm)
    jm = J.SharedMLP((16, 8))

    def step(v, x):
        def loss(p):
            out, upd = jm.apply({**v, "params": p}, x, True, mutable=["batch_stats"])
            return jnp.sum(out ** 2), (out, upd["batch_stats"])

        (_, (out, stats)), g = jax.value_and_grad(loss, has_aux=True)(v["params"])
        return out, g, stats

    refs = {torch.float32: jax.device_get(jax.jit(step)(v, x))}
    with jax.enable_x64(True):
        refs[torch.float64] = jax.device_get(jax.jit(step)(f64(v), f64(x)))
    for dtype, (tol, tol_g) in ((torch.float32, (2e-5, 1e-5)), (torch.float64, (1e-9, 1e-9))):
        out, g, stats = refs[dtype]
        m = T.SharedMLP(6, (16, 8)).to(dtype).train()
        m.load_state_dict({k: t.to(dtype) for k, t in tm.state_dict().items()})
        got = m(torch.from_numpy(x).to(dtype))
        close(got, out, tol)
        grads = port_grads(m, got)
        close_grads(grads, {k: v for k, v in mlp_state(g, stats).items() if k in grads}, tol_g,
                    whole=True)
        running = {k: v.numpy() for k, v in m.state_dict().items() if "running" in k}
        ref = mlp_state(g, stats)
        for k in running:
            close(running[k], ref[k], tol)


def seeded_mlp(m) -> dict:
    """The port's seed_weights in a SharedMLP, as flax variables."""
    from giga_tpu_torch.models.registry import seed_weights

    seed_weights(m, 2)
    sd = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    params, stats = {}, {}
    for i in range(m.n):
        params[f"conv{i}_kernel"] = sd[f"conv{i}.weight"].T.copy()
        params[f"conv{i}_bias"] = sd[f"conv{i}.bias"]
        params[f"bn{i}"] = {"scale": sd[f"bn{i}.weight"], "bias": sd[f"bn{i}.bias"]}
        stats[f"bn{i}"] = {"mean": sd[f"bn{i}.running_mean"], "var": sd[f"bn{i}.running_var"]}
    return {"params": params, "batch_stats": stats}


def mlp_state(params: dict, stats: dict) -> dict:
    """A flax SharedMLP tree (params or their gradients, and batch_stats)
    under the port's names."""
    out = {}
    for i in range(len(stats)):
        out[f"conv{i}.weight"] = np.asarray(params[f"conv{i}_kernel"]).T
        out[f"conv{i}.bias"] = np.asarray(params[f"conv{i}_bias"])
        out[f"bn{i}.weight"] = np.asarray(params[f"bn{i}"]["scale"])
        out[f"bn{i}.bias"] = np.asarray(params[f"bn{i}"]["bias"])
        out[f"bn{i}.running_mean"] = np.asarray(stats[f"bn{i}"]["mean"])
        out[f"bn{i}.running_var"] = np.asarray(stats[f"bn{i}"]["var"])
    return out


def _running(stats: dict) -> dict:
    """JAX batch_stats under the port's buffer names."""
    return {f"{layer}.mlp.{bn}.running_{'mean' if leaf == 'mean' else 'var'}": a
            for layer, tree in stats.items() for bn, leaves in tree["mlp"].items()
            for leaf, a in leaves.items()}


def test_batchnorm_running_statistics():
    """One train-mode step of a (4, 2) batch: flax's BatchNorm (momentum
    0.99, the biased variance) in float64 against the port's FlaxBatchNorm;
    torch's BatchNorm1d moves its running variance by the unbiased one."""
    import flax.linen as fnn

    x = np.random.RandomState(5).randn(4, 2)
    bn = fnn.BatchNorm(use_running_average=False)
    with jax.enable_x64(True):
        v = f64(bn.init(jax.random.PRNGKey(0), x))
        y, upd = bn.apply(v, x, mutable=["batch_stats"])
    port = T.FlaxBatchNorm(2).double().train()
    close(port(torch.from_numpy(x)).detach(), y, 1e-12)
    close(port.running_mean, upd["batch_stats"]["mean"], 1e-12)
    close(port.running_var, upd["batch_stats"]["var"], 1e-12)
    torch_bn = torch.nn.BatchNorm1d(2, momentum=0.01).double().train()
    torch_bn(torch.from_numpy(x))
    assert not torch.allclose(torch_bn.running_var, port.running_var, rtol=0, atol=1e-4)
