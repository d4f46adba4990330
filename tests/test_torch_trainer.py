"""The training loop around the port's step (giga_tpu_torch/train/trainer.py
``Trainer``, train/checkpoint.py, train/soup.py, train/data.py, core/io.py,
utils/tensorboard.py and ``save_params``), on the CPU: fit, resume and
history in fp32 and bf16 (tests/test_trainer_loop.py's pattern), the saved
``.msgpack`` read by the JAX package's ``load_params`` bit for bit, the
state checkpoint round trip, the soup equal to the JAX package's on the
same pools, and the loaders' batches, with and without augmentation, equal
to the JAX package's on one temporary dataset (tests/test_train.py:86-121).
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from flax.serialization import msgpack_serialize

from giga_tpu.core import io as jio
from giga_tpu.models.registry import load_params as jax_load_params
from giga_tpu.train import data as jdata
from giga_tpu.train import soup as jsoup
from giga_tpu.utils.tensorboard import read_events
from giga_tpu_torch.core import io as tio
from giga_tpu_torch.core.config import TrainConfig
from giga_tpu_torch.core.perception import CameraIntrinsic
from giga_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from giga_tpu_torch.models.registry import init_network, load_network, save_network
from giga_tpu_torch.train import data as tdata
from giga_tpu_torch.train import soup as tsoup
from giga_tpu_torch.train.checkpoint import CheckpointManager
from giga_tpu_torch.train.trainer import Trainer, create_train_state, make_train_step
from tests.test_train import make_synthetic_dataset

import chip_smoke


def _loaders(tmp_path, module=tdata, **kw):
    root, raw = tmp_path / "proc", tmp_path / "raw"
    if not root.exists():
        make_synthetic_dataset(root, raw, n_scenes=2, n_grasps=8)
    args = dict(batch_size=4, val_split=0.25, augment=False, num_point_occ=16)
    return module.create_train_val_loaders(root, raw, **{**args, **kw})


def _opt_tensors(state):
    return list(state.params.values()) + state.tx.mu + state.tx.nu + [state.tx.count]


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_trainer_fit_checkpoints_and_resumes(tmp_path, dtype):
    """fit writes last and best .msgpack, history.jsonl, tensorboard scalars
    and the state checkpoint; a fresh Trainer resumes at epoch 3 with the
    params and Adam's moments restored exactly, and the history keeps the
    pre-resume epochs."""
    train_loader, val_loader = _loaders(tmp_path, val_split=0.5)
    net, cfg = init_network("giga_aff", seed=0)
    logdir = tmp_path / "run"
    trainer = Trainer(net, cfg, TrainConfig(net="giga_aff"), logdir=logdir, save_state=True,
                      dtype=dtype)
    state = create_train_state(net, device="cpu")
    state, history = trainer.fit(state, train_loader, val_loader, epochs=2, log=lambda *_: None)
    assert [row["epoch"] for row in history] == [1, 2]
    assert np.isfinite(history[-1]["train"]["loss_all"]) and "accuracy" in history[-1]["val"]
    for f in ("giga_aff_last.msgpack", "giga_aff_best.msgpack", "history.jsonl"):
        assert (logdir / f).exists(), f
    params = jax_load_params(logdir / "giga_aff_last.msgpack")
    saved = flax_to_state_dict(params)
    for k, v in state.params.items():
        assert saved[k].dtype == torch.float32
        assert torch.equal(saved[k], v.detach()), k
    events = read_events(next(logdir.glob("events.out.tfevents.*")))
    tags = {t for _, scalars in events for t in scalars}
    assert {"train/loss_all", "val/loss_all", "val/accuracy"} <= tags
    assert trainer.ckpt_mgr.epochs() == [1, 2]
    loaded, _ = load_network(logdir / "giga_aff_last.msgpack", "giga_aff")
    assert all(torch.equal(a, b.detach()) for a, b in
               zip(loaded.state_dict().values(), state.module.state_dict().values()))

    trainer2 = Trainer(net, cfg, TrainConfig(net="giga_aff"), logdir=logdir, save_state=True,
                       dtype=dtype)
    fresh = create_train_state(init_network("giga_aff", seed=42)[0], device="cpu")
    resumed = trainer2.try_resume(fresh)
    assert trainer2.start_epoch == 3 and resumed.step == state.step
    assert all(torch.equal(a, b) for a, b in zip(_opt_tensors(resumed), _opt_tensors(state)))
    state2, history2 = trainer2.fit(resumed, train_loader, val_loader, epochs=3,
                                    log=lambda *_: None)
    assert [row["epoch"] for row in history2] == [1, 2, 3]
    rows = [json.loads(line) for line in (logdir / "history.jsonl").open()]
    assert [row["epoch"] for row in rows] == [1, 2, 3]
    assert trainer2.ckpt_mgr.epochs() == [2, 3]


def test_trainer_geo_scores_by_occupancy(tmp_path):
    """giga_geo trains on occupancy only and is scored by occupancy accuracy."""
    train_loader, val_loader = _loaders(tmp_path, val_split=0.5)
    net, cfg = init_network("giga_geo", seed=0)
    trainer = Trainer(net, cfg, TrainConfig(net="giga_geo"), logdir=tmp_path / "geo")
    _, history = trainer.fit(create_train_state(net, device="cpu"), train_loader, val_loader,
                             epochs=1, log=lambda *_: None)
    assert set(history[0]["train"]) == {"loss_occ", "loss_all", "accuracy", "precision",
                                        "recall"}
    assert (tmp_path / "geo" / "giga_geo_best.msgpack").exists()


@pytest.mark.parametrize("name", ["giga", "giga_geo", "vgn"])
def test_save_params_is_flax_format(tmp_path, name):
    """save_network writes flax's bytes for the module's tree, which the JAX
    package's load_params reads back bit for bit."""
    net, _ = init_network(name, seed=5)
    path = tmp_path / "sub" / f"synthetic_{name}_x.msgpack"
    save_network(net, path)
    tree = state_dict_to_flax(net.state_dict())
    assert path.read_bytes() == msgpack_serialize(tree)
    back = flax_to_state_dict(jax_load_params(path))
    assert all(torch.equal(back[k], v) for k, v in net.state_dict().items())
    loaded, _ = load_network(path, name)
    assert all(torch.equal(a, b) for a, b in
               zip(loaded.state_dict().values(), net.state_dict().values()))


def test_checkpoint_manager_roundtrip(tmp_path):
    """Save three epochs with max_to_keep=2: the last two stay; restore
    returns the state, the metrics sidecar and the epoch, exactly."""
    net, cfg = init_network("giga_geo", seed=0)
    state = create_train_state(net, device="cpu")
    step = make_train_step(net, cfg)
    mgr = CheckpointManager(tmp_path / "state")
    assert mgr.latest_epoch() is None and mgr.restore(state) is None
    snaps = {}
    for epoch in (1, 2, 3):
        state, _ = step(state, chip_smoke.train_batch(epoch, 2, 8))
        mgr.save(epoch, state, {"loss_all": 0.5 / epoch, "best_score": -0.5})
        snaps[epoch] = [t.detach().clone() for t in _opt_tensors(state)]
    assert mgr.epochs() == [2, 3] and mgr.latest_epoch() == 3
    for epoch in (2, 3):
        fresh = create_train_state(init_network("giga_geo", seed=9)[0], device="cpu")
        restored, metrics, got_epoch = mgr.restore(fresh, epoch=None if epoch == 3 else epoch)
        assert got_epoch == epoch and restored.step == epoch
        assert metrics == {"loss_all": 0.5 / epoch, "best_score": -0.5}
        assert all(torch.equal(a, b) for a, b in zip(_opt_tensors(restored), snaps[epoch]))


def _score(params):
    return -float(((params["w"] - 3.0) ** 2).sum())


@pytest.mark.parametrize("leaf", ["numpy", "torch"])
def test_soup_equals_jax(leaf):
    """greedy_soup and uniform_average over state dicts give the JAX
    package's scores, members and averages on the same pools."""
    rng = np.random.RandomState(0)
    ws = [2.0, 4.0, 9.0, 3.5, 2.5]
    pools = []
    for w in ws:
        tree = {"w": np.full(3, w, np.float32), "b": {"c": rng.rand(2).astype(np.float32)}}
        pools.append((_score(tree), tree, f"w={w}"))
    conv = (lambda a: torch.from_numpy(a.copy())) if leaf == "torch" else (lambda a: a)
    tpool = [(s, {"w": conv(t["w"]), "b": {"c": conv(t["b"]["c"])}}, tag)
             for s, t, tag in pools]
    for k in (None, 2):
        s1, soup1, m1 = tsoup.greedy_soup(tpool, _score, k=k, verbose=None)
        s2, soup2, m2 = jsoup.greedy_soup(pools, _score, k=k, verbose=None)
        assert (s1, m1) == (s2, m2)
        np.testing.assert_array_equal(np.asarray(soup1["w"]), np.asarray(soup2["w"]))
        np.testing.assert_array_equal(np.asarray(soup1["b"]["c"]), np.asarray(soup2["b"]["c"]))
    avg1 = tsoup.uniform_average([t for _, t, _ in tpool])
    avg2 = jsoup.uniform_average([t for _, t, _ in pools])
    np.testing.assert_array_equal(np.asarray(avg1["b"]["c"]), np.asarray(avg2["b"]["c"]))
    assert isinstance(avg1["w"], torch.Tensor) == (leaf == "torch")


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_loader_batches_equal_jax(tmp_path, augment):
    """create_train_val_loaders of both packages on one dataset and seed:
    the same batches, array for array (occupancy shards, augmentation and
    shuffling draw from their RandomStates in the same order); the
    PrefetchLoader gives the Loader's batches."""
    got = _loaders(tmp_path, augment=augment)
    ref = _loaders(tmp_path, jdata, augment=augment)
    for g_loader, r_loader in zip(got, ref):
        assert len(g_loader) == len(r_loader)
        for epoch in range(2):
            for a, b in zip(g_loader, r_loader):
                assert set(a) == set(b)
                for k in b:
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    loader = _loaders(tmp_path, load_occ=False)[0]
    loader.shuffle = False
    sync = list(loader)
    pre = list(tdata.PrefetchLoader(loader, num_workers=3, prefetch=2))
    assert len(pre) == len(sync) > 0
    for a, b in zip(sync, pre):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _vgn_root(tmp_path):
    """A processed VGN root: voxel grids and a grasp table in voxel units."""
    rng = np.random.RandomState(1)
    root = tmp_path / "vgn"
    (root / "scenes").mkdir(parents=True)
    ids = ["s0", "s1"]
    for sid in ids:
        tio.write_voxel_grid(root, sid, rng.rand(1, 40, 40, 40).astype(np.float32))
    n = 8
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cols = {"scene_id": np.array([ids[i % 2] for i in range(n)]),
            **{c: q[:, i] for i, c in enumerate(("qx", "qy", "qz", "qw"))},
            **{c: rng.uniform(2, 37, n) for c in ("i", "j", "k")},
            "width": rng.uniform(1, 8, n), "label": rng.randint(0, 2, n)}
    tio.write_df(tio.GraspTable(cols), root)
    return root


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_vgn_loader_batches_equal_jax(tmp_path, augment):
    root = _vgn_root(tmp_path)
    got = tdata.create_vgn_train_val_loaders(root, 2, 0.25, augment, seed=3)
    ref = jdata.create_vgn_train_val_loaders(root, 2, 0.25, augment, seed=3)
    for g_loader, r_loader in zip(got, ref):
        batches = list(zip(g_loader, r_loader))
        assert batches
        for a, b in batches:
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_io_matches_jax(tmp_path):
    """The port's writers give the JAX package's files; read_df gives the
    values written (pandas' with its exact parser); write_df round-trips;
    read_grasp gives JAX's grasp."""
    from giga_tpu.core.grasp import Grasp as JGrasp
    from giga_tpu.core.perception import CameraIntrinsic as JCameraIntrinsic
    from giga_tpu.core.transform import Rotation as JRotation
    from giga_tpu.core.transform import Transform as JTransform
    from giga_tpu_torch.core.grasp import Grasp
    from giga_tpu_torch.core.transform import Rotation, Transform

    rng = np.random.RandomState(0)
    cam = (640, 480, 540.0, 540.0, 320.0, 240.0)
    a, b = tmp_path / "port", tmp_path / "jax"
    for d in (a, b):
        (d / "scenes").mkdir(parents=True)
        (d / "point_clouds").mkdir()
    tio.write_setup(a, 0.3, CameraIntrinsic(*cam), 0.08, 0.05)
    jio.write_setup(b, 0.3, JCameraIntrinsic(*cam), 0.08, 0.05)
    grid = rng.rand(1, 40, 40, 40).astype(np.float32)
    pc = rng.rand(10, 3)
    tio.write_voxel_grid(a, "s", grid)
    jio.write_voxel_grid(b, "s", grid)
    tio.write_point_cloud(a, "s", pc)
    jio.write_point_cloud(b, "s", pc)
    for i in range(5):
        q, t, w = Rotation.random(random_state=rng).as_quat(), rng.rand(3), rng.rand()
        tio.write_grasp(a, f"s{i}", Grasp(Transform(Rotation.from_quat(q), t), w), i % 2)
        jio.write_grasp(b, f"s{i}", JGrasp(JTransform(JRotation.from_quat(q), t), w), i % 2)
    for f in ("setup.json", "grasps.csv"):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    np.testing.assert_array_equal(tio.read_voxel_grid(a, "s"), jio.read_voxel_grid(b, "s"))
    np.testing.assert_array_equal(tio.read_point_cloud(a, "s"), pc)
    size, intr, width, depth = tio.read_setup(a)
    assert (size, intr.K.tolist(), width, depth) == (0.3, CameraIntrinsic(*cam).K.tolist(),
                                                     0.08, 0.05)
    df, pdf = tio.read_df(a), jio.read_df(b)
    exact = pd.read_csv(b / "grasps.csv", float_precision="round_trip")
    assert list(df.columns) == list(pdf.columns) and len(df) == len(pdf) == 5
    for c in pdf.columns:  # pandas' default parser is off by up to ~1e-16
        np.testing.assert_array_equal(df[c], exact[c].to_numpy(), err_msg=c)
        if df[c].dtype == np.float64:
            np.testing.assert_allclose(df[c], pdf[c].to_numpy(), rtol=0, atol=1e-15)
        else:
            np.testing.assert_array_equal(df[c], pdf[c].to_numpy(), err_msg=c)
    for i in range(5):
        sid, g, label = tio.read_grasp(df, i)
        jsid, jg, jlabel = jio.read_grasp(exact, i)
        assert (sid, label) == (jsid, jlabel) and g.width == jg.width
        np.testing.assert_array_equal(g.pose.as_matrix(), jg.pose.as_matrix())
    (tmp_path / "copy").mkdir()
    tio.write_df(df, tmp_path / "copy")
    back = tio.read_df(tmp_path / "copy")
    for c in df.columns:
        np.testing.assert_array_equal(back[c], df[c], err_msg=c)
