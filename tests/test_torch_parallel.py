"""The port's process groups and meshes (giga_tpu_torch/parallel/
distributed.py and mesh.py; counterparts of tests/test_distributed.py) and
its timing utilities (utils/benchmark.py, utils/profiling.py), on the CPU.

A 2-rank gloo group (spawned once for the file, ``torch_dist.basics``)
agrees on ranks and batch slices, shards, replicates, gathers and reduces;
a 3-rank group decodes the R=40 lattice with its x axis split 14/13/13 and
equals the unsharded decode and the JAX package's ``decode_dense`` (2e-5 *
(1 + |b|), tests/test_torch_decode_points.py's bound). Every group has its
own timeout (tests/torch_dist.py), so a lost rank fails a test instead of
hanging the run.
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_dist
from giga_tpu.inference import dense_decode as jdd
from giga_tpu_torch.models.convert import state_dict_to_flax
from giga_tpu_torch.models.registry import init_network
from giga_tpu_torch.parallel import distributed
from giga_tpu_torch.utils import benchmark, profiling

TOL_DECODE = 2e-5


@pytest.fixture(scope="module")
def basics():
    return torch_dist.run(torch_dist.basics, 2)


@pytest.fixture(scope="module")
def split():
    net, cfg = init_network("giga", seed=2)
    dec = {k[len("decoder_aff."):]: v.detach().numpy() for k, v in net.state_dict().items()
           if k.startswith("decoder_aff.")}
    rng = np.random.RandomState(0)
    feats = {t: rng.randn(40, 40, 32).astype(np.float32) for t in ("xz", "xy", "yz")}
    coords = np.linspace(-0.5, 0.5 - 1 / 40, 40).astype(np.float32)
    n_blocks = cfg.decoder.n_blocks
    out = torch_dist.run(torch_dist.x_split, 3, dec=dec, feats=feats, coords=coords,
                         n_blocks=n_blocks)
    jdec = state_dict_to_flax(net.state_dict())["params"]["decoder_aff"]
    ref = np.asarray(jdd.decode_dense(jdec, {t: jnp.asarray(v) for t, v in feats.items()},
                                      jnp.asarray(coords), n_blocks))
    return out, ref


def test_single_process_noop(monkeypatch):
    """No args + no launcher environment => documented no-op returning False."""
    for var in (*distributed._CLUSTER_ENV_VARS, "RANK", "WORLD_SIZE", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.process_count() == 1 and distributed.is_primary()
    assert distributed.global_batch_slice(8) == slice(0, 8)


def test_explicit_misconfig_raises():
    """An explicit group that cannot form fails loudly within its timeout,
    not degrading to a single-process run; so does a launcher environment
    that names no rank."""
    t0 = time.monotonic()
    with pytest.raises(Exception):
        distributed.initialize(coordinator_address="127.0.0.1:1", num_processes=2,
                               process_id=1, device="cpu", timeout=3)
    assert time.monotonic() - t0 < 60
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        distributed.initialize(num_processes=2, process_id=0, device="cpu")


def test_launcher_env_without_rank_raises(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(RuntimeError, match="names no rank"):
        distributed.initialize(device="cpu")


def test_local_device_is_the_card_unless_asked(monkeypatch):
    assert distributed.local_device("cpu") == torch.device("cpu")
    assert distributed.local_device("cuda:1") == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.local_device(None)


def test_ranks_and_batch_slices(basics):
    for rank, r in enumerate(basics):
        assert (r["rank"], r["count"], r["primary"], r["again"]) == (rank, 2, rank == 0, True)
        assert (r["mesh_rank"], r["mesh_size"]) == (rank, 2)
        assert r["slice"] == (4 * rank, 4 * rank + 4)
        assert r["errors"] == [True, True, True]


def test_shard_batch_and_replicate(basics):
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    for rank, r in enumerate(basics):
        np.testing.assert_array_equal(r["shard"]["x"], x[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(r["shard"]["t"], np.arange(4 * rank, 4 * rank + 4))
        assert r["shard_again"]
        np.testing.assert_array_equal(r["replicated"]["w"], np.zeros(3, np.float32))
        np.testing.assert_array_equal(r["replicated"]["i"], [0, 7])
        np.testing.assert_array_equal(r["replicated"]["v"], [0, 0])


def test_gather_batch_and_all_reduce(basics):
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r in basics:
        np.testing.assert_array_equal(r["gathered"]["a"], 2 * x)
        np.testing.assert_array_equal(r["gathered"]["n"], np.arange(8, dtype=np.int32))
        assert r["gathered"]["n"].dtype == np.int32
        np.testing.assert_array_equal(r["summed"][0], [3.0])
        np.testing.assert_array_equal(r["summed"][1], np.ones((2, 2)))


def test_uneven_x_split_over_three_ranks(split):
    """R=40 over 3 ranks (14, 13, 13): the gathered volume equals the
    unsharded decode on every rank, and JAX's decode_dense."""
    out, ref = split
    for r in out:
        np.testing.assert_array_equal(r["batched"], r["whole"])
        np.testing.assert_array_equal(r["single"], r["whole"][:, 0])
        np.testing.assert_array_equal(r["single"], out[0]["single"])
    err = np.abs(out[0]["single"] - ref) / (1 + np.abs(ref))
    assert err.max() <= TOL_DECODE, err.max()


def test_split_sizes_match_tensor_split():
    from giga_tpu_torch.parallel.mesh import split_sizes

    for n, parts in ((40, 3), (40, 8), (5, 4), (3, 3)):
        assert split_sizes(n, parts) == [len(c) for c in torch.tensor_split(torch.arange(n),
                                                                            parts)]


# ------------------------------------------------------------ timing utilities

def test_benchmark_protocols_on_the_cpu():
    """The protocols run on CPU tensors (host times there, never a device
    metric): positive per-call seconds and calls a second."""
    xs = [(torch.full((16, 16), float(i)),) for i in range(4)]
    fn = lambda x: {"s": x.sum(), "m": (x @ x, x + 1)}  # noqa: E731
    assert benchmark.true_latency(fn, xs, n_lo=1, n_hi=5, repeats=2) > 0
    assert benchmark.pipelined_throughput(fn, xs, n=6, repeats=2) > 0
    assert benchmark.pipelined_throughput_async(fn, xs, n=6, depth=2, repeats=2) > 0

    def chain(n, x):
        for _ in range(n):
            x = x + x.mean() * 1e-3
        return x

    assert benchmark.serial_chain_latency(chain, (torch.ones(8),), inner=4, repeats=2) > 0
    assert benchmark.dispatch_floor(repeats=1, device="cpu") > 0
    assert [t.shape for t in benchmark._leaves(fn(xs[0][0]))] == [(), (16, 16), (16, 16)]


def test_profiling_timer_stage_and_trace(tmp_path):
    timer = profiling.Timer()
    for _ in range(3):
        with timer.section("a"):
            torch.ones(4).sum()
    s = timer.summary()["a"]
    assert s["count"] == 3 and 0 <= s["min"] <= s["median"] <= s["max"]
    assert "a" in timer.report()
    timer.reset()
    assert timer.summary() == {}
    with profiling.stage("stage_a"):
        pass
    assert profiling.GLOBAL_TIMER.summary()["stage_a"]["count"] >= 1
    with profiling.device_trace(tmp_path / "trace") as prof:
        with profiling.annotate("span"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
    assert any(e.key == "span" for e in prof.key_averages())
