"""The command's refusals: no result and a non-zero exit without a card,
for an unknown cell, and in a directory that holds only BENCHMARK.json and
portbench/ (no program to measure)."""

import shutil
import subprocess
import sys

import pytest
import torch

from portbench.tests.small import ROOT


def _run(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT, "--workload", "giga.plan_b64", "--seed", str(2 ** 33), "--seconds", "1",
               "--trace", "0")
    assert out.returncode == 3 and out.stdout == ""


def test_unknown_cell_no_result():
    out = _run(ROOT, "--workload", "nope", "--seed", "1", "--seconds", "1")
    assert out.returncode == 2 and out.stdout == ""


def test_benchmark_alone_has_nothing_to_measure(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from portbench import run as R\n"
            "b = R.read_json(R.ROOT / 'BENCHMARK.json')\n"
            "c, cfg, tr, wl = R.cell_files(b, 'giga.plan_b64')\n"
            "print(R.execute(c, cfg, tr, wl, [], 1, 1.0, False, 'cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "giga_tpu_torch" in out.stderr
