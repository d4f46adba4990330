"""The GSR gate, giga_grid and the reference's .pt checkpoints on the card,
against the same calls on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_grid.py -m cuda
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from giga_tpu_torch.models.checkpoint import load_params  # noqa: E402
from giga_tpu_torch.models.convert import to_reference_state_dict  # noqa: E402
from giga_tpu_torch.models.registry import load_network  # noqa: E402
from giga_tpu_torch.ops import scatter  # noqa: E402
from giga_tpu_torch.ops.kernels import decoder as dk  # noqa: E402
from giga_tpu_torch.scripts.eval_synthetic_gsr import evaluate_planner, make_planner  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the programs under test run on it")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def grid_params():
    return chip_smoke.unflatten_params(np.load(REPO / chip_smoke.GOLDEN_GRID))


def test_gsr_protocol_on_the_card_equals_the_cpu(cuda_device):
    """Two scenes of the gate's protocol: the card's scored grasps and
    labels equal the CPU's, one K3 launch a scene."""
    params = load_params(REPO / chip_smoke.CHECKPOINT)
    rows = {}
    for device in ("cuda", "cpu"):
        record = []
        dk.fused_dense_decode.launches = 0
        evaluate_planner(make_planner("giga", params, device=device), 2, 5, 2000, record=record)
        rows[device] = chip_smoke.gsr_rows(record)
        if device == "cuda":
            assert dk.fused_dense_decode.launches == 2
    chip_smoke.compare_gsr_rows(rows["cuda"], rows["cpu"], "card vs CPU")


@pytest.mark.parametrize("segment", ["segment_mean", "segment_max"])
def test_scatter_on_the_card(cuda_device, segment):
    """The atomics of scatter_add_ / scatter_reduce_ against the CPU's
    ordered sums: within 1e-6 * (1 + max |b|)."""
    r = np.random.RandomState(0)
    pts = torch.from_numpy(r.uniform(-0.5, 0.5, (4, 20000, 3)).astype(np.float32))
    feat = torch.from_numpy(r.randn(4, 20000, 8).astype(np.float32))
    idx = scatter.grid_index(pts, 8)
    ref = getattr(scatter, segment)(feat, idx, 512)
    got = getattr(scatter, segment)(feat.cuda(), idx.cuda(), 512).cpu()
    assert float((got - ref).abs().max()) <= 1e-6 * (1 + float(ref.abs().max()))


def test_grid_batched_program_on_the_card(cuda_device, grid_params):
    """giga_grid's batched program on the card: the module path, no kernel
    of this package, the CPU's decisions."""
    scenes = chip_smoke.make_scenes(4)
    results = {}
    for device in ("cuda", "cpu"):
        planner = chip_smoke.grid_planner(grid_params, device)
        assert planner._ensure_batched_fn().paths == {"encode": "module", "decode": "module"}
        chip_smoke.zero_kernel_counts(all_five=True)
        results[device] = planner.plan_batch(scenes)
        assert not any(chip_smoke.kernel_counts(all_five=True).values())
    for i, (a, b) in enumerate(zip(results["cuda"], results["cpu"])):
        chip_smoke.compare_grasps(a, b, chip_smoke.SIZE / 40, f"scene {i}")


def test_pt_checkpoint_plans_as_the_flax_tree_on_the_card(cuda_device, tmp_path):
    params = load_params(REPO / chip_smoke.CHECKPOINT)
    planner = make_planner("giga", params, device="cuda")
    path = tmp_path / "smoke_giga_ref.pt"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in to_reference_state_dict(planner.net.state_dict()).items()}, path)
    net, _ = load_network(path)
    scenes = chip_smoke.make_scenes(4)
    got = chip_smoke.candidates_to_host_all(make_planner("giga", net=net, device="cuda"),
                                            scenes)
    ref = chip_smoke.candidates_to_host_all(planner, scenes)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
