"""The port's command-line scripts (giga_tpu_torch/scripts/): ``--help`` of
the GSR evaluation, the training CLIs, the data chain, the end-to-end
self-check and the root diagnostics' counterparts, as tests/test_scripts.py
checks the JAX package's; a tiny build_corpus -> train_corpus run on the
CPU, the corpus shards equal to those of the JAX package's build_corpus on
the same arguments and the checkpoint readable by the JAX package; and the
data-parallel flag raising with the trainer's text.
"""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
for path in (REPO, REPO / "scripts"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

CLIS = ["eval_synthetic_gsr", "build_corpus", "train", "train_corpus", "sim_grasp_multiple",
        "sim_grasp_save_scene", "render_rollouts", "generate_data_parallel",
        "clean_balance_data", "construct_dataset_parallel", "save_occ_data_parallel",
        "selfcheck_e2e", "profile_geo", "profile_postprocess", "profile_vgn", "measure_meshgen",
        "diag_meshgen128", "diagnose_meshgen256", "profile_meshgen256", "selfcheck_scale"]


@pytest.mark.parametrize("name", CLIS)
def test_cli_help(name):
    out = subprocess.run([sys.executable, "-m", f"giga_tpu_torch.scripts.{name}", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage" in out.stdout.lower()


def test_build_corpus_then_train_corpus_on_the_cpu(tmp_path, capsys):
    import build_corpus as jax_build_corpus

    from giga_tpu.models.registry import load_params as jax_load_params
    from giga_tpu_torch.scripts import build_corpus, train_corpus

    args = ["--n-scenes", "3", "--n-grasps", "8", "--n-occ", "64", "--shard-size", "2",
            "--seed", "5"]
    assert build_corpus.main(args + ["--out", str(tmp_path / "corpus")]) == 0
    jax_build_corpus.main(argparse.Namespace(
        n_scenes=3, n_grasps=8, n_occ=64, shard_size=2, size=0.3, seed=5, tag="",
        out=str(tmp_path / "jax_corpus")))
    shards = sorted((tmp_path / "corpus").glob("shard_*.npz"))
    assert [s.name for s in shards] == ["shard_000.npz", "shard_001.npz"]
    for s in shards:
        got, ref = np.load(s), np.load(tmp_path / "jax_corpus" / s.name)
        assert set(got.files) == set(ref.files)
        for k in ref.files:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{s.name} {k}")

    out = tmp_path / "ck.msgpack"
    train_args = train_corpus.parser().parse_args(
        ["--corpus", str(tmp_path / "corpus"), "--steps", "2", "--batch", "2",
         "--batch-occ", "16", "--log-every", "1", "--eval-every", "2", "--eval-scenes", "1",
         "--eval-reps", "1", "--soup-k", "2", "--val-frac", "0.34", "--out", str(out),
         "--device", "cpu"])
    assert train_corpus.main(train_args) == 0
    log = capsys.readouterr().out
    assert "step 2: oracle GSR" in log and "step 2: ema oracle GSR" in log
    assert "saved best params" in log
    params = jax_load_params(out)
    assert "encoder" in params["params"] and "decoder_aff" in params["params"]
    assert out.with_suffix(".history.jsonl").read_text().count("\n") == 1


def test_dp_flag_raises_the_trainers_text(tmp_path, monkeypatch):
    """--dp runs one process per card under a launcher; without one it
    raises the script's text naming torchrun (the dp run itself:
    tests/test_torch_parallel_train.py)."""
    from giga_tpu_torch.parallel import distributed
    from giga_tpu_torch.scripts import train

    for var in (*distributed._CLUSTER_ENV_VARS, "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    args = train.parser().parse_args(["--dataset", str(tmp_path), "--dp", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(args)
    assert "torchrun" in train.DP_LAUNCH
