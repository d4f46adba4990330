"""The GSR gate, giga_grid (its batched program on K6, the grid decode) and
the reference's .pt checkpoints on the card, against the same calls on the
CPU.

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
from giga_tpu_torch.core.precision import full_precision  # noqa: E402
from giga_tpu_torch.inference.dense_decode import (  # noqa: E402
    decode_dense_batched,
    lattice_coords,
    lattice_features_batched,
)
from giga_tpu_torch.inference.planner import GIGAPlanner  # noqa: E402
from giga_tpu_torch.ops.kernels import decoder as dk  # noqa: E402
from giga_tpu_torch.ops.kernels import grid_decode as gd  # noqa: E402
from giga_tpu_torch.utils import profiling  # noqa: E402
from giga_tpu_torch.scripts.eval_synthetic_gsr import evaluate_planner, make_planner  # noqa: E402

pytestmark = pytest.mark.cuda

# K6 against its plain version and against the module path: the trunk sums
# in another order than the module path's (the fc_p bias folded into px,
# per-head products against block-diagonal ones), a few ulps of a head
# (tests/test_torch_grid_decode.py); against the plain version, that
# version's matrix products' own order
TOL_K6 = 1e-5


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
    """giga_grid's batched program on the card: the module encode, K6 once a
    call, no other kernel of this package, the CPU's decisions (K6's plain
    version)."""
    scenes = chip_smoke.make_scenes(4)
    results = {}
    for device in ("cuda", "cpu"):
        planner = chip_smoke.grid_planner(grid_params, device)
        assert planner._ensure_batched_fn().paths == {"encode": "module", "decode": "K6"}
        chip_smoke.zero_kernel_counts(all_five=True)
        before = gd.grid_decode_batched.launches
        results[device] = planner.plan_batch(scenes)
        assert not any(chip_smoke.kernel_counts(all_five=True).values())
        assert gd.grid_decode_batched.launches - before == (device == "cuda")
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


@pytest.fixture(scope="module")
def grid_net_cuda(grid_params):
    if not torch.cuda.is_available():  # a module fixture is set up before cuda_device
        pytest.skip("needs an NVIDIA card: K6 has no CPU mode")
    return chip_smoke.grid_planner(grid_params, "cuda").net


@pytest.mark.parametrize("B", [1, 2, 64])
def test_k6_against_plain_and_module_path(cuda_device, grid_net_cuda, B):
    """K6 at R = 40 on the encoder's grids of B scenes: within TOL_K6 *
    (1 + |b|) of its plain version and of the module path, on the card."""
    net = grid_net_cuda
    coords = lattice_coords(40, cuda_device)
    tsdf = torch.from_numpy(chip_smoke.make_scenes(B)).to(cuda_device)
    with torch.inference_mode(), full_precision():
        grid = net.encode(tsdf)["grid"]
        inputs = gd.prepare_grid_inputs(net.decoder_aff.params(), grid, coords,
                                        net.cfg.decoder.padding, net.cfg.decoder.n_blocks)
        before = gd.grid_decode_batched.launches
        got = gd.grid_decode_batched(*inputs)
        assert gd.grid_decode_batched.launches == before + 1
        plain = gd.grid_decode_plain(*inputs)
        feats = lattice_features_batched({"grid": grid}, coords, net.cfg)
        module = decode_dense_batched(net.decoder_aff.params(), feats, coords,
                                      net.cfg.decoder.n_blocks)
        module = module.permute(1, 0, 5, 2, 3, 4).reshape(B, 12, -1)
        torch.cuda.synchronize()
    assert got.shape == (B, 12, 40 ** 3) and got.is_cuda
    for ref in (plain, module):
        assert float(((got - ref).abs() / (1 + ref.abs())).max()) <= TOL_K6


@pytest.mark.parametrize("n_blocks,C,error", [(7, 32, RuntimeError), (5, 16, ValueError)])
def test_k6_refused_launch_raises(cuda_device, grid_net_cuda, n_blocks, C, error):
    """A launch K6 refuses raises and counts nothing: 7 blocks outgrow a
    block's shared memory (the library refuses the launch); 16 channels are
    not the 32 it is built for (the wrapper refuses them)."""
    dec = grid_net_cuda.decoder_aff.params()
    dec = {**dec, **{f"fc_c{i}_{k}": dec[f"fc_c{i % 5}_{k}"] for i in range(5, n_blocks)
                     for k in ("kernel", "bias")},
           **{f"block{i}_{k}": dec[f"block{i % 5}_{k}"] for i in range(5, n_blocks)
              for k in ("fc0_kernel", "fc0_bias", "fc1_kernel", "fc1_bias")}}
    grid = torch.zeros(1, 8, 8, 8, 32, device=cuda_device)
    inputs = list(gd.prepare_grid_inputs(dec, grid, lattice_coords(8, cuda_device), 0.0, n_blocks))
    if C != 32:
        inputs[0] = inputs[0][..., :C].contiguous()
        inputs[6] = inputs[6][:, :C].contiguous()
    before = gd.grid_decode_batched.launches
    with pytest.raises(error):
        gd.grid_decode_batched(*inputs)
    assert gd.grid_decode_batched.launches == before


@pytest.mark.parametrize("model_type,k6", [("giga", 0), ("giga_grid", 1)])
def test_plan_batch_counts_k6(cuda_device, grid_params, model_type, k6):
    """plan_batch on the card: K6's counter moves by one a giga_grid call and
    not at all for giga, and ``planner.enqueue`` counts the same."""
    from torch.profiler import ProfilerActivity, profile

    if model_type == "giga_grid":
        planner = chip_smoke.grid_planner(grid_params, "cuda")
    else:
        net, _ = load_network(REPO / chip_smoke.CHECKPOINT)
        planner = GIGAPlanner(net=net, device="cuda", size=chip_smoke.SIZE, **chip_smoke.PLANNER_KW)
    scenes = chip_smoke.make_scenes(2)
    planner.plan_batch(scenes)
    before = gd.grid_decode_batched.launches
    profiling.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        planner.plan_batch(scenes)
    assert gd.grid_decode_batched.launches - before == k6
    (enqueue,) = [r for r in profiling.spans() if r.name == "planner.enqueue"]
    assert enqueue.counts["k6"] == k6
    assert enqueue.counts["k2"] == 1 - k6
