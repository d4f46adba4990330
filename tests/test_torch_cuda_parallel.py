"""Parallelism on the card (chip_smoke.py's phase 37 at small sizes):
giga_tpu_torch/parallel/dryrun.py's checks on spawned ranks, NCCL with one
rank a card and gloo with ranks sharing card 0.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_parallel.py -m cuda
"""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda
SMALL = dict(batch=8, train_batch=8, train_points=256, steps=2, timeout=600)


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the ranks run K1 and K2 on it")
    return torch.cuda.device_count()


def check_reports(reports, world: int, backend: str, device=None):
    assert [r["rank"] for r in reports] == list(range(world))
    for r in reports:
        assert r["backend"] == backend
        assert r["device"] == (device or f"cuda:{r['rank'] % torch.cuda.device_count()}")
        for prec in ("fp32", "bf16"):
            assert r["serve"][prec]["launches"] == {"stem_pool": 1, "dense_decode": 1}
            assert r["serve"][prec]["grasps"] > 0
        assert r["serve"]["module"]["launches"] == {"stem_pool": 0, "dense_decode": 0}
        assert r["train"]["step_ms"] > 0 and r["train"]["allreduce_ms"] > 0
        assert r["sp"]["grasps"] > 0
        assert ("dp_sp" in r) == (world >= 4)


def test_dryrun_nccl_one_rank_a_card(cards):
    """One rank a card over NCCL: dp serving (K1 + K2 on every rank), the
    dp train and eval steps, the sp planner, each against the
    single-process program."""
    from giga_tpu_torch.parallel.dryrun import dryrun_multichip

    scenes = chip_smoke.make_scenes(SMALL["batch"])
    check_reports(dryrun_multichip(cards, backend="nccl", scenes=scenes, **SMALL), cards,
                  "nccl")


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_gloo_ranks_share_card_zero(cards, world):
    """2 and 4 gloo ranks on card 0 (4: the 2 x 2 dp x sp mesh too)."""
    from giga_tpu_torch.parallel.dryrun import dryrun_multichip

    scenes = chip_smoke.make_scenes(SMALL["batch"])
    check_reports(dryrun_multichip(world, backend="gloo", device="cuda:0", scenes=scenes,
                                   **SMALL), world, "gloo", "cuda:0")
