"""Data-parallel training in the port (giga_tpu_torch/train/trainer.py with
``mesh``, scripts/train.py ``--dp``) on 2 gloo ranks of the CPU, against
the JAX package's ``make_train_step(mesh=make_mesh(2))`` and
``make_eval_step(mesh=...)`` on the same seeded weights (``init_network``
through the weight bridge) and batches:

  * one dp fp32 step of giga: loss terms within 1e-5 * (1 + |b|)
    (tests/test_train.py:213-245), the all-reduced gradients leaf by leaf
    within 1e-5 * (1 + max |g|) of JAX's sharded gradient, params after the
    step within 5e-5 (tests/test_torch_train.py's bounds), bit-identical
    across ranks; the eval step's terms and counts after it;
  * one corpus step (replicated corpus, batch-sharded ``sel``);
  * ``Trainer(mesh=...)`` for one epoch of giga_aff: the history equal to a
    single-process Trainer's on the same data (1e-5), and only rank 0's
    files in the logdir;
  * ``python -m torch.distributed.run --nproc-per-node 2 -m
    giga_tpu_torch.scripts.train --dp --device cpu`` on a tiny dataset.

The ranks start once for the file (``torch_dist.run``, its own timeouts);
the launcher's run has a timeout of its own too.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import torch_dist
from giga_tpu.parallel import mesh as jmesh
from giga_tpu.train import corpus as jc
from giga_tpu.train import trainer as jt
from giga_tpu_torch.core.config import TrainConfig
from giga_tpu_torch.models.checkpoint import load_params
from giga_tpu_torch.models.convert import flax_to_state_dict
from giga_tpu_torch.models.registry import init_network
from giga_tpu_torch.train import data as tdata
from giga_tpu_torch.train import trainer as tt
from tests.test_torch_corpus import seeded_corpus
from tests.test_torch_train import jax_state
from tests.test_train import make_synthetic_dataset

TOL_LOSS = 1e-5
TOL_GRAD = 1e-5
TOL_PARAM = 5e-5
B, N = 4, 16
LAUNCH_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    make_synthetic_dataset(tmp / "proc", tmp / "raw", n_scenes=2, n_grasps=8)
    corpus = seeded_corpus(scenes=2, grasps=16, points=64)
    from giga_tpu_torch.train.corpus import CorpusSampler

    return {"batch": chip_smoke.train_batch(0, B, N), "corpus": corpus,
            "sel": CorpusSampler(corpus, [0, 1], batch=B, occ_sub=16, seed=0)(),
            "dataset": dict(root=tmp / "proc", raw_root=tmp / "raw", batch_size=2,
                            val_split=0.25, augment=False, num_point_occ=16),
            "tmp": tmp}


@pytest.fixture(scope="module")
def ranks(inputs):
    return torch_dist.run(torch_dist.train_dp, 2, batch=inputs["batch"],
                          corpus=inputs["corpus"], sel=inputs["sel"],
                          dataset=inputs["dataset"], logdir=str(inputs["tmp"] / "run"))


def jax_dp_step(batch, assemble=None, corpus=None):
    """JAX's dp step on make_mesh(2) from the port's seed-1 giga weights:
    (terms, params after, the sharded gradient or None, eval terms or None)."""
    net, _ = init_network("giga", seed=1)
    jnet, jcfg, state = jax_state("giga", net)
    mesh = jmesh.make_mesh(2)
    state = jmesh.replicate(mesh, state)
    if assemble is not None:
        step = jt.make_train_step(jnet, jcfg, mesh=mesh, assemble=assemble)
        state, terms = step(state, jmesh.replicate(mesh, jc.device_corpus(corpus)),
                            jmesh.shard_batch(mesh, batch))
        return jax.device_get(terms), jax.device_get(state.params), None, None
    sharded = jmesh.shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_fn = jt.make_loss_fn(jt._with_sampler(jnet, jcfg, "mm"), jcfg)
    with jax.default_matmul_precision("highest"):
        grads = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))(state.params, sharded)
    state, terms = jt.make_train_step(jnet, jcfg, mesh=mesh)(state, sharded)
    evals = jt.make_eval_step(jnet, jcfg, mesh=mesh)(state.params, sharded)
    return (jax.device_get(terms), jax.device_get(state.params), jax.device_get(grads),
            jax.device_get(evals))


def assert_terms(got, ref):
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = float(r)
        assert abs(float(got[k]) - r) <= TOL_LOSS * (1 + abs(r)), (k, got[k], r)


def assert_params(got, ref_tree):
    ref = flax_to_state_dict(ref_tree)
    worst = max(float(np.abs(got[k] - ref[k].numpy()).max()) for k in ref)
    assert worst <= TOL_PARAM, worst


@pytest.fixture(scope="module")
def jax_dp(inputs):
    return jax_dp_step(inputs["batch"])


def test_dp_train_step_matches_jax(ranks, jax_dp):
    terms, params, grads, _ = jax_dp
    ref = {k: v.numpy() for k, v in flax_to_state_dict(grads).items()}
    for r in ranks:
        assert_terms(r["terms"], terms)
        errs = {k: float(np.abs(r["grads"][k] - g).max() / (1 + np.abs(g).max()))
                for k, g in ref.items()}
        assert max(errs.values()) <= TOL_GRAD, sorted(errs.items(), key=lambda e: -e[1])[:3]
        assert_params(r["params"], params)
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v, err_msg=k)


def test_dp_eval_step_matches_jax(ranks, jax_dp):
    evals = jax_dp[3]
    for r in ranks:
        assert_terms(r["eval"], evals)
        for k in tt.COUNT_TERMS:
            assert float(r["eval"][k]) == float(evals[k]), k
    summary = tt.summarize_metrics([{k: float(v) for k, v in ranks[0]["eval"].items()}])
    assert {"accuracy", "precision", "recall"} <= summary.keys()


def test_dp_corpus_step_matches_jax(ranks, inputs):
    terms, params, _, _ = jax_dp_step(inputs["sel"], jc.assemble_batch, inputs["corpus"])
    for r in ranks:
        assert_terms(r["corpus_terms"], terms)
        assert_params(r["corpus_params"], params)


def test_trainer_with_mesh_matches_single_process(ranks, inputs):
    """Trainer(mesh=...).fit: the history of the single-process Trainer on
    the same loaders, params equal on both ranks, and the logdir holds rank
    0's files only (one event file, history, checkpoints)."""
    net, cfg = init_network("giga_aff", seed=0)
    trainer = tt.Trainer(net, cfg, TrainConfig(net="giga_aff"))
    state, history = trainer.fit(tt.create_train_state(net, device="cpu"),
                                 *tdata.create_train_val_loaders(**inputs["dataset"]),
                                 epochs=1, log=lambda *_: None)
    for r in ranks:
        (row,), (ref,) = r["history"], history
        for part in ("train", "val"):
            assert set(row[part]) == set(ref[part])
            for k, v in ref[part].items():
                assert abs(row[part][k] - v) <= TOL_LOSS * (1 + abs(v)), (part, k)
        worst = max(float(np.abs(r["fit_params"][k] - v.detach().numpy()).max())
                    for k, v in state.params.items())
        assert worst <= TOL_PARAM, worst
        assert r["logdir"] == ranks[0]["logdir"]
    files = ranks[0]["logdir"]
    assert sum(f.startswith("events.out.tfevents") for f in files) == 1, files
    assert {"history.jsonl", "giga_aff_last.msgpack", "giga_aff_best.msgpack"} <= set(files)
    rows = [json.loads(x) for x in (inputs["tmp"] / "run" / "history.jsonl").open()]
    assert [row["epoch"] for row in rows] == [1]
    for k, v in ranks[0]["fit_params"].items():
        np.testing.assert_array_equal(ranks[1]["fit_params"][k], v, err_msg=k)


def test_train_script_dp_under_torchrun(inputs):
    """scripts/train.py --dp under torch.distributed.run, 2 CPU ranks: it
    trains an epoch and rank 0 alone writes the logs and checkpoints."""
    d = inputs["dataset"]
    out = inputs["tmp"] / "script"
    env = dict(os.environ, PYTHONPATH=str(torch_dist.REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "giga_tpu_torch.scripts.train", "--dp", "--device", "cpu", "--net",
           "giga_aff", "--dataset", str(d["root"]), "--dataset_raw", str(d["raw_root"]),
           "--savedir", str(out), "--epochs", "1", "--batch-size", "2", "--workers", "0",
           "--val-split", "0.25"]
    proc = subprocess.run(cmd, cwd=torch_dist.REPO, env=env, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("data parallel over 2 processes") == 2
    assert proc.stdout.count("epoch 1") == 2
    files = sorted(os.listdir(out))
    assert sum(f.startswith("events.out.tfevents") for f in files) == 1, files
    assert (out / "giga_aff_last.msgpack").exists()
    saved = flax_to_state_dict(load_params(out / "giga_aff_last.msgpack"))
    assert all(torch.isfinite(v).all() for v in saved.values())
