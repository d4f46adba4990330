"""The device-resident corpus pipeline in the PyTorch port
(giga_tpu_torch/train/corpus.py), on the CPU against the JAX package:
``assemble_batch`` equal to JAX's for every quarter turn k, the sampler's
selections equal to JAX's for one seed, the shard round trip, corpus
train steps whose loss falls, and ``build_scene`` equal to JAX's array for
array.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from giga_tpu.train import corpus as jc
from giga_tpu_torch.models.registry import init_network
from giga_tpu_torch.train import corpus as tc
from giga_tpu_torch.train.trainer import create_train_state, make_train_step


def seeded_corpus(seed=0, scenes=3, grasps=10, points=50) -> dict:
    """A corpus in load_corpus's layout from seeded uniform arrays."""
    rng = np.random.RandomState(seed)
    return {"tsdf": rng.rand(scenes, 40, 40, 40).astype(np.float32),
            "occ_pts": rng.uniform(-0.5, 0.5, (scenes, points, 3)).astype(np.float32),
            "occ_lbl": (rng.rand(scenes, points) > 0.5).astype(np.float32),
            "grasp_pos": rng.uniform(-0.4, 0.4, (scenes, grasps, 3)).astype(np.float32),
            "grasp_rot": rng.randn(scenes, grasps, 2, 4).astype(np.float32),
            "grasp_width": rng.rand(scenes, grasps).astype(np.float32),
            "grasp_label": (rng.rand(scenes, grasps) > 0.7).astype(np.float32)}


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_assemble_batch_equals_jax(k):
    """Every array of the assembled batch equal to JAX's, with all samples
    turned by k quarter turns, and with mixed turns."""
    corpus = seeded_corpus()
    rng = np.random.RandomState(k)
    B = 6
    sel = {"scene": rng.randint(0, 3, B).astype(np.int32),
           "grasp": rng.randint(0, 10, B).astype(np.int32),
           "occ": rng.randint(0, 50, (B, 16)).astype(np.int32)}
    for rotk in (np.full(B, k, np.int32), ((np.arange(B) + k) % 4).astype(np.int32)):
        s = dict(sel, rotk=rotk)
        ref = jax.device_get(jc.assemble_batch(jc.device_corpus(corpus),
                                               {n: jnp.asarray(v) for n, v in s.items()}))
        got = tc.assemble_batch(tc.device_corpus(corpus, device="cpu"),
                                {n: torch.from_numpy(v) for n, v in s.items()})
        assert set(got) == set(ref)
        for n in ref:
            assert got[n].dtype == torch.float32 and got[n].shape == ref[n].shape, n
            np.testing.assert_array_equal(got[n].numpy(), np.asarray(ref[n]), err_msg=n)


def test_rot_volume_is_rot90():
    vol = torch.from_numpy(np.random.RandomState(0).rand(4, 6, 6, 3).astype(np.float32))
    got = tc._rot_volume(vol, torch.arange(4))
    for k in range(4):
        np.testing.assert_array_equal(got[k].numpy(), np.rot90(vol[k].numpy(), k, axes=(0, 1)))


def test_sampler_equals_jax():
    """One seed gives JAX's selections, draw after draw."""
    corpus = seeded_corpus(scenes=5, grasps=20)
    corpus["grasp_label"][1] = 0.0  # a scene without positives
    for augment in (True, False):
        ref = jc.CorpusSampler(corpus, [0, 1, 3, 4], batch=8, occ_sub=16, seed=7,
                               augment=augment)
        got = tc.CorpusSampler(corpus, [0, 1, 3, 4], batch=8, occ_sub=16, seed=7,
                               augment=augment)
        for _ in range(5):
            a, b = got(), ref()
            assert set(a) == set(b)
            for n in b:
                assert a[n].dtype == b[n].dtype
                np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_shard_roundtrip(tmp_path):
    """write_shard / load_corpus: shards stack back in order, and the port
    reads shards the JAX package wrote."""
    corpus = seeded_corpus(scenes=3)
    scenes = [{k: v[i] for k, v in corpus.items()} for i in range(3)]
    tc.write_shard(tmp_path / "shard_000.npz", scenes[:2])
    jc.write_shard(tmp_path / "shard_001.npz", scenes[2:])
    loaded = tc.load_corpus(tmp_path)
    assert set(loaded) == set(corpus)
    for k in corpus:
        np.testing.assert_array_equal(loaded[k], corpus[k])
    with pytest.raises(FileNotFoundError):
        tc.load_corpus(tmp_path / "missing")
    dev = tc.device_corpus(loaded, drop=("occ_lbl",), device="cpu")
    assert "occ_lbl" not in dev and dev["tsdf"].dtype == torch.float32


def test_corpus_train_step_learns():
    """make_train_step(..., assemble=assemble_batch): step(state, corpus,
    sel) from sampled index arrays; the loss falls."""
    corpus = seeded_corpus(scenes=2, grasps=16, points=256)
    net, cfg = init_network("giga", seed=0)
    state = create_train_state(net, lr=1e-3, device="cpu")
    step = make_train_step(net, cfg, assemble=tc.assemble_batch)
    dev = tc.device_corpus(corpus, device="cpu")
    sampler = tc.CorpusSampler(corpus, [0, 1], batch=4, occ_sub=32, seed=0)
    sel = sampler()
    losses = [float(step(state, dev, sel)[1]["loss_all"]) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


@pytest.mark.parametrize("seed", [0, 11])
def test_build_scene_equals_jax(seed):
    """One synthetic scene from the same RandomState: every array equal to
    the JAX package's, dtype and all (the grasp list padded alike)."""
    got = tc.build_scene(np.random.RandomState(seed), 0.3, 512, 16)
    ref = jc.build_scene(np.random.RandomState(seed), 0.3, 512, 16)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["tsdf"].shape == (40, 40, 40) and len(got["grasp_label"]) == 16
