"""The clutter-removal loop on the card, against the same calls on the CPU
and the JAX golden (chip_smoke.py's phases 34-35 at their sizes).

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_sim.py -m cuda
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
from torch_sim import SIM_URDF_ROOT, double  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the simulator fuses its scans on it")
    return "cuda"


@pytest.mark.parametrize("resolution", [40, 120])
def test_acquire_tsdf_on_the_card_matches_the_cpu(cuda_device, resolution):
    """ClutterRemovalSim(device="cuda").acquire_tsdf on a seeded pile, three
    views: the grid within 1e-6 of the CPU's, equal weights, equal clouds,
    and the timed span covers the card's work (a positive time)."""
    from giga_tpu_torch.sim.simulation import ClutterRemovalSim

    out = {}
    for d in (cuda_device, "cpu"):
        with double("torch"):
            sim = ClutterRemovalSim("pile", "blocks", seed=11, urdf_root=str(SIM_URDF_ROOT),
                                    device=d)
            sim.reset(3)
            tsdf, pc, timing = sim.acquire_tsdf(n=3, N=3, resolution=resolution)
            out[d] = tsdf.get_grid(), tsdf.weight.cpu().numpy(), pc, timing, tsdf.tsdf.device
    (grid, weight, pc, timing, where), (cgrid, cweight, cpc, _, _) = out[cuda_device], out["cpu"]
    assert where.type == "cuda" and timing > 0
    assert float(np.abs(grid - cgrid).max()) <= chip_smoke.TOL_TSDF
    np.testing.assert_array_equal(weight, cweight)
    np.testing.assert_array_equal(pc, cpc)


def test_clutter_run_on_the_card_matches_golden(cuda_device, tmp_path):
    """The golden's protocol through GIGAPlanner fp32 on the card: equal to
    the JAX golden run, one K3 launch per planning call and no launch of K1,
    K2, K4 or K5."""
    from giga_tpu_torch.experiments import clutter_removal
    from giga_tpu_torch.inference.planner import GIGAPlanner

    plan = chip_smoke.PlanRecorder(GIGAPlanner(REPO / chip_smoke.CHECKPOINT, "giga",
                                               **chip_smoke.CLUTTER_KW))
    chip_smoke.zero_kernel_counts(all_five=True)
    with double("torch"):
        got = chip_smoke.clutter_protocol(clutter_removal, plan, tmp_path)
    torch.cuda.synchronize()
    n = len(plan.results)
    assert chip_smoke.kernel_counts(all_five=True) == {"K1": 0, "K2": 0, "K3": n, "K4": 0,
                                                        "K5": 0}
    golden = dict(np.load(REPO / chip_smoke.GOLDEN_CLUTTER))
    chip_smoke.compare_clutter(got, golden, "card vs golden")


def test_data_chain_spawn_pool_on_the_card(cuda_device):
    """chip_smoke's phase 35: the data chain with two spawned processes a
    pool, fusing on the card, against the same chain on the CPU."""
    seconds = chip_smoke.chain_phase("card test", device=cuda_device)
    assert seconds["generate_run"] > 0
