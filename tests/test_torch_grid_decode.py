"""K6, the grid decode (``ops/kernels/grid_decode.py``), on the CPU, where
its wrapper runs its plain version: against the module path (the trilinear
lattice features of ``sample_grid_lattice_batched``, then
``decode_dense_batched``'s dense branch), its shape predicate, and the
planning programs' choice of it.

Tolerance: TOL_K6 * (1 + |b|) on the raw heads. The sampled features are
the module path's bit for bit (the same taps and operations); the trunk
then sums in another order: the fc_p bias folded into px ((px + b) + py +
pz against ((px + py) + pz) + b), and each head's products on its own
32-wide weights where the module path multiplies the 96-wide block-diagonal
ones. The two float32 decodes differ by a few ulps of a head (printed:
~2e-6 at the published widths).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from giga_tpu_torch.core.config import PlannerConfig, get_config
from giga_tpu_torch.inference.dense_decode import (
    decode_affordance_dense_batched,
    decode_dense_batched,
    lattice_coords,
    lattice_features_batched,
)
from giga_tpu_torch.inference.planner import build_batched_giga_planner_fn, program_paths
from giga_tpu_torch.models.registry import get_network, seed_weights
from giga_tpu_torch.ops.kernels import grid_decode as gd
from giga_tpu_torch.ops.sampling import sample_grid_lattice_batched, sample_grid_taps_batched

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TOL_K6 = 1e-5
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(scope="module")
def grid_net():
    return seed_weights(get_network("giga_grid")[0], 0).eval()


def _grid(B: int, G: int, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).randn(B, G, G, G, 32).astype(np.float32))


def _module_raw(net, grid, coords) -> torch.Tensor:
    """The module path's raw heads (heads, B, R, R, R, O) as K6 lays them
    out: (B, heads*O, R^3)."""
    feats = lattice_features_batched({"grid": grid}, coords, net.cfg)
    out = decode_dense_batched(net.decoder_aff.params(), feats, coords, net.cfg.decoder.n_blocks)
    E, B, O = out.shape[0], out.shape[1], out.shape[-1]
    return out.permute(1, 0, 5, 2, 3, 4).reshape(B, E * O, -1)


def _rel(got, ref) -> float:
    return float(((got - ref).abs() / (1 + ref.abs())).max())


# the published widths (B=2 scenes, R = G = 40); ragged lattices (R = 7, 33)
# on a grid of another size (G = 40, 20, 9)
SHAPES = [(2, 40, 40), (1, 7, 40), (2, 33, 40), (1, 33, 20), (2, 7, 9)]


@pytest.mark.parametrize("B,R,G", SHAPES)
def test_plain_matches_module_path(grid_net, B, R, G):
    coords = lattice_coords(R)
    grid = _grid(B, G)
    with torch.no_grad():
        inputs = gd.prepare_grid_inputs(grid_net.decoder_aff.params(), grid, coords,
                                        grid_net.cfg.decoder.padding, grid_net.cfg.decoder.n_blocks)
        got = gd.grid_decode_plain(*inputs)
        ref = _module_raw(grid_net, grid, coords)
    assert got.shape == ref.shape == (B, 12, R ** 3) and got.dtype == F32
    rel = _rel(got, ref)
    print(f"K6's plain version against the module path, B={B} R={R} G={G}: "
          f"{rel:.3g} * (1 + |b|)")
    assert rel <= TOL_K6


@pytest.mark.parametrize("R,G", [(40, 40), (7, 40), (33, 20)])
def test_taps_sample_the_module_paths_features(R, G):
    """The wrapper's one set of taps, used on every axis, samples the
    module path's lattice features bit for bit."""
    coords = lattice_coords(R)
    grid = _grid(2, G, seed=1)
    taps, w = gd.lattice_taps(coords, G, 0.0)
    assert taps.dtype == torch.int32 and taps.shape == (2, R) and w.shape == (R,)
    assert int(taps.min()) >= 0 and int(taps.max()) <= G - 1
    t = (taps[0].long(), taps[1].long(), w)
    assert torch.equal(sample_grid_taps_batched(grid, t, t, t),
                       sample_grid_lattice_batched(grid, coords, 0.0))


def test_affordance_volumes_match_the_module_path(grid_net):
    """``decode_affordance_grid_kernel_batched``: qual and width (B, R, R, R)
    and rot (B, 4, R^3), K2's layout, against the module path's volumes."""
    B, R = 2, 40
    coords = lattice_coords(R)
    grid = _grid(B, 40, seed=2)
    with torch.no_grad():
        qual, rot, width = gd.decode_affordance_grid_kernel_batched(
            grid_net.decoder_aff.params(), grid, coords, 0.0, grid_net.cfg.decoder.n_blocks)
        feats = lattice_features_batched({"grid": grid}, coords, grid_net.cfg)
        rq, rr, rw = decode_affordance_dense_batched(grid_net.decoder_aff.params(), feats, coords)
    assert qual.shape == width.shape == (B, R, R, R) and rot.shape == (B, 4, R ** 3)
    for got, ref in ((qual, rq), (rot, rr.reshape(B, -1, 4).permute(0, 2, 1)), (width, rw)):
        assert _rel(got, ref) <= TOL_K6


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing(grid_net):
    inputs = gd.prepare_grid_inputs(grid_net.decoder_aff.params(), _grid(1, 9), lattice_coords(7),
                                    0.0, 5)
    before = gd.grid_decode_batched.launches
    with torch.no_grad():
        assert torch.equal(gd.grid_decode_batched(*inputs), gd.grid_decode_plain(*inputs))
    assert gd.grid_decode_batched.launches == before


def test_can_grid_decode_accepts():
    assert gd.can_grid_decode(64, 40, 40, 32, 3, 32, 4, 5)
    assert gd.can_grid_decode(1, 7, 40, 32, 3, 32, 4, 5)
    assert gd.can_grid_decode(1, 33, 20, 32, 1, 32, 4, 0)
    # the shared memory of 16 warps' buffers and the head's weights: NB <= 6
    assert gd.can_grid_decode(1, 40, 40, 32, 3, 32, 4, 6)
    # 32-bit point and grid offsets: R^3 and G^3 * C up to 2^31 - 1
    assert gd.can_grid_decode(1, 1290, 40, 32, 3, 32, 4, 5)
    assert gd.can_grid_decode(1, 40, 406, 32, 3, 32, 4, 5)


@pytest.mark.parametrize("args,dtype", [
    ((1, 40, 40, 32, 3, 32, 4, 5), BF16),        # float32 only
    ((1, 40, 40, 32, 3, 32, 4, 5), torch.float64),
    ((1, 40, 40, 16, 3, 32, 4, 5), F32),         # one channel a lane: C = 32
    ((1, 40, 40, 64, 3, 32, 4, 5), F32),
    ((1, 40, 40, 32, 3, 64, 4, 5), F32),         # the trunk's width
    ((1, 40, 40, 32, 3, 32, 1, 5), F32),         # four outputs a head
    ((1, 40, 40, 32, 3, 32, 4, 7), F32),         # shared memory
    ((1, 40, 40, 32, 3, 32, 4, -1), F32),
    ((0, 40, 40, 32, 3, 32, 4, 5), F32),
    ((1, 0, 40, 32, 3, 32, 4, 5), F32),
    ((1, 40, 0, 32, 3, 32, 4, 5), F32),
    ((1, 40, 40, 32, 0, 32, 4, 5), F32),
    ((1, 1291, 40, 32, 3, 32, 4, 5), F32),       # R^3 past 2^31 - 1
    ((1, 40, 407, 32, 3, 32, 4, 5), F32),        # G^3 * C past 2^31 - 1
])
def test_can_grid_decode_refuses(args, dtype):
    assert not gd.can_grid_decode(*args, dtype=dtype)


@pytest.mark.parametrize("dtype,batched,use_kernels,decode", [
    (F32, True, True, "K6"),
    (BF16, True, True, "module"),
    (F32, False, True, "module"),
    (F32, True, False, "module"),
])
def test_program_paths_for_giga_grid(dtype, batched, use_kernels, decode):
    cfg = get_config("giga_grid")
    assert program_paths(cfg, PlannerConfig(), dtype, use_kernels, batched) == {
        "encode": "module", "decode": decode}


@pytest.mark.parametrize("field,value", [("n_blocks", 7), ("c_dim", 16)])
def test_program_paths_keep_the_module_where_k6_refuses(field, value):
    cfg = get_config("giga_grid")
    if field == "c_dim":
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, c_dim=value),
                                  decoder=dataclasses.replace(cfg.decoder, c_dim=value))
    else:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, n_blocks=value))
    assert program_paths(cfg, PlannerConfig(), F32, True, True) == {
        "encode": "module", "decode": "module"}


def test_batched_program_on_k6_plans_as_the_module_program(grid_net):
    """The batched program on K6's plain version against the same program
    on the module path (``use_kernels=False``): equal grasp positions and
    counts, scores within TOL_K6."""
    pcfg = PlannerConfig(**chip_smoke.GRID_KW, min_width=chip_smoke.GRID_WIDTHS[0],
                         max_width=chip_smoke.GRID_WIDTHS[1])
    tsdf = torch.from_numpy(chip_smoke.make_scenes(2))
    fns = [build_batched_giga_planner_fn(grid_net, grid_net.cfg, pcfg, chip_smoke.SIZE,
                                         use_kernels=k) for k in (True, False)]
    assert [f.paths["decode"] for f in fns] == ["K6", "module"]
    got, ref = (f(tsdf, tsdf) for f in fns)
    np.testing.assert_array_equal(got.count.numpy(), ref.count.numpy())
    assert int(got.count.sum()) > 0
    for i, n in enumerate(ref.count.tolist()):
        np.testing.assert_array_equal(got.positions[i, :n].numpy(), ref.positions[i, :n].numpy())
        np.testing.assert_allclose(got.scores[i, :n].numpy(), ref.scores[i, :n].numpy(),
                                   atol=TOL_K6, rtol=0)
