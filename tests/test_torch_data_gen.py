"""The port's data-generation chain against the JAX package's scripts, on
tests/test_data_chain.py's miniature fixture world (at half its grasps: two
scenes), on the CPU:

    generate_data_parallel.worker(rank=0) -> clean_balance_data
      -> construct_dataset_parallel -> save_occ_data_parallel
      -> giga_tpu_torch/scripts/train.py main() for one epoch
      -> a plan from the trained checkpoint.

Each package runs under its own copy of the kinematic pybullet double
(tests/torch_sim.py) with the same seeds, numpy's global generator seeded
the same before each step, and the same scene ids (uuid4 drawn from a
seeded generator), so every file can be held to its counterpart."""

import json
import pickle
import random
import shutil
import sys
import uuid
import zipfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from torch_sim import SIM_URDF_ROOT, double, one_torch_thread  # noqa: E402,F401

GENERATE = dict(scene="packed", object_set="cubes", num_grasps=12, grasps_per_scene=6,
                num_proc=1, save_scene=True, random=False, sim_gui=False, seed=11,
                urdf_root=str(SIM_URDF_ROOT))
OCC = dict(num_point_per_file=128, num_file=2, num_proc=1, uniform=False)


def run_chain(package, root: Path, monkeypatch):
    """Generate, clean_balance, construct and save_occ with ``package``'s
    scripts into root/raw and root/dataset, with a copy of the raw root as
    generated in root/generated; returns the three roots."""
    if package == "jax":
        from scripts.clean_balance_data import main as clean
        from scripts.construct_dataset_parallel import main as construct
        from scripts.generate_data_parallel import worker
        from scripts.save_occ_data_parallel import main as save_occ
        kw = {}
    else:
        from giga_tpu_torch.scripts.clean_balance_data import main as clean
        from giga_tpu_torch.scripts.construct_dataset_parallel import main as construct
        from giga_tpu_torch.scripts.generate_data_parallel import worker
        from giga_tpu_torch.scripts.save_occ_data_parallel import main as save_occ
        kw = {"device": "cpu"}
    ids = random.Random(0)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=ids.getrandbits(128), version=4))
    raw, dataset = root / "raw", root / "dataset"
    with double(package):
        worker(SimpleNamespace(root=raw, **GENERATE, **kw), rank=0)
    shutil.copytree(raw, root / "generated")
    np.random.seed(1)
    clean(SimpleNamespace(root=raw))
    construct(SimpleNamespace(raw=raw, dataset=dataset, num_proc=1, single_view=False,
                              add_noise="", **kw))
    np.random.seed(2)
    save_occ(SimpleNamespace(raw=str(raw), **OCC))
    return raw, dataset, root / "generated"


def npz_members(path: Path) -> dict:
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def assert_same_table(got_root: Path, ref_root: Path):
    """Two grasp tables: the same columns, scene ids and labels; the floats
    within 1e-14 relative or 1e-15 absolute (pandas' default parser reads a
    value up to ~1e-16 off, the port's reads it correctly rounded)."""
    from giga_tpu_torch.core import io

    got, ref = io.read_df(got_root), io.read_df(ref_root)
    assert list(got.columns) == list(ref.columns) and len(got) == len(ref)
    for c in ref.columns:
        if c in ("scene_id", "label"):
            np.testing.assert_array_equal(got[c], ref[c])
        else:
            np.testing.assert_allclose(got[c], ref[c], rtol=1e-14, atol=1e-15)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    root = tmp_path_factory.mktemp("chains")
    with pytest.MonkeyPatch.context() as mp:
        out = {p: run_chain(p, root / p, mp) for p in ("jax", "torch")}
    return out


def test_generate_matches_jax(chains):
    """generate_data_parallel.worker(rank 0): setup.json and grasps.csv
    byte-equal to JAX's, the same scene files with the same npz members
    (.npy bytes), the same mesh-pose lists; positives exist."""
    from giga_tpu_torch.core import io

    got, ref = chains["torch"][2], chains["jax"][2]
    for name in ("setup.json", "grasps.csv"):
        assert (got / name).read_bytes() == (ref / name).read_bytes(), name
    assert (io.read_df(got)["label"] == 1).any()
    for sub in ("scenes", "mesh_pose_list"):
        names = sorted(p.name for p in (got / sub).iterdir())
        assert names == sorted(p.name for p in (ref / sub).iterdir()) != []
        for n in names:
            if sub == "scenes":
                assert npz_members(got / sub / n) == npz_members(ref / sub / n)
            else:
                a, b = (np.load(r / sub / n, allow_pickle=True)["pc"] for r in (got, ref))
                assert len(a) == len(b)
                for (pa, sa, ma), (pb, sb, mb) in zip(a, b):
                    assert (pa, sa) == (pb, sb)
                    np.testing.assert_allclose(ma, mb, rtol=0, atol=1e-12)


def test_chain_matches_jax(chains):
    """clean_balance, construct and save_occ after the same generation:
    the same grasp tables (raw and in voxel units), the same scenes kept,
    40^3 grids within 1e-6, equal point clouds and occupancy shards."""
    (raw, dataset, _), (jraw, jdataset, _) = chains["torch"], chains["jax"]
    assert_same_table(raw, jraw)
    assert_same_table(dataset, jdataset)
    from giga_tpu_torch.core import io

    df = io.read_df(raw)
    assert (df["label"] == 1).sum() >= (df["label"] == 0).sum() >= 0 and len(df) >= 1
    assert {"i", "j", "k"} <= set(io.read_df(dataset).columns)
    scenes = sorted(p.name for p in (raw / "scenes").iterdir())
    assert scenes == sorted(p.name for p in (jraw / "scenes").iterdir()) != []
    for name in sorted(p.name for p in (jdataset / "scenes").iterdir()):
        grid, jgrid = (io.read_voxel_grid(d, name[:-4]) for d in (dataset, jdataset))
        assert grid.shape == (1, 40, 40, 40) and grid.max() > 0
        assert float(np.abs(grid - jgrid).max()) <= 1e-6
        np.testing.assert_array_equal(io.read_point_cloud(dataset, name[:-4]),
                                      io.read_point_cloud(jdataset, name[:-4]))
    shards = sorted(p.relative_to(jraw) for p in (jraw / "occ").rglob("*.npz"))
    assert shards == sorted(p.relative_to(raw) for p in (raw / "occ").rglob("*.npz")) != []
    for s in shards:
        got, ref = np.load(raw / s), np.load(jraw / s)
        assert got["points"].shape == (OCC["num_point_per_file"], 3)
        np.testing.assert_array_equal(got["points"], ref["points"])
        np.testing.assert_array_equal(got["occ"], ref["occ"])
    assert any(np.load(raw / s)["occ"].any() for s in shards)


def test_train_and_plan_on_the_port_dataset(chains, tmp_path):
    """The port's scripts/train.py main() for one epoch on the port's
    dataset (occupancy from its raw root), then GIGAPlanner from the
    checkpoint it wrote plans on one of the dataset's grids."""
    from giga_tpu_torch.core import io
    from giga_tpu_torch.inference.planner import GIGAPlanner, State
    from giga_tpu_torch.scripts import train

    raw, dataset, _ = chains["torch"]
    savedir = tmp_path / "giga"
    train.main(train.parser().parse_args(
        ["--net", "giga", "--dataset", str(dataset), "--dataset_raw", str(raw),
         "--logdir", str(tmp_path), "--savedir", str(savedir), "--epochs", "1",
         "--batch-size", "2", "--val-split", "0.25", "--workers", "0", "--device", "cpu"]))
    ckpts = sorted(savedir.glob("*.msgpack"))
    assert ckpts and (savedir / "history.jsonl").exists()
    assert json.loads((savedir / "history.jsonl").read_text().splitlines()[-1])
    grid = io.read_voxel_grid(dataset, next((dataset / "scenes").iterdir()).stem)
    planner = GIGAPlanner(ckpts[-1], "giga", force_detection=True, best=True,
                          rng=np.random.RandomState(0), device="cpu")
    grasps, scores, toc = planner(State(tsdf=grid))
    assert isinstance(grasps, list) and len(grasps) == len(scores) and toc > 0
    assert pickle.dumps(grasps)  # plain host objects
