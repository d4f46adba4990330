"""The giga_grid cell on the CPU: the grid reference (reference/giga_grid.py)
against the port's encoder and module decode on seeded weights, at the
published widths and at a tiny one; the judge on the port's grasp lists; a
whole run of the cell cut for the CPU, sound and with an altered answer;
the stored weights; the frozen counts by hand; and the stage readers, which
read nothing from a program without marks."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.drivers.plan_grid import mean_stage_ms, stage_seconds
from portbench.frozen import grid_work, work
from portbench.frozen.scenes import make_pool
from portbench.reference.giga import grid_points
from portbench.reference.giga_grid import GridReference
from portbench.reference.judge import plan_gaps
from portbench.reference.planner import lattice, plan
from portbench.tests.small import BENCH, ROOT, harness

CELL = "giga_grid.plan_b64"
WEIGHTS = ROOT / "checkpoints" / "seeded_giga_grid_0.msgpack"
TOL = 2e-5  # the port's forward tolerance: |a - b| <= TOL * (1 + |b|)


def _close(a, b, what):
    gap = ((a - b).abs() / (1 + b.abs())).max().item()
    assert gap <= TOL, (what, gap)


def _compare(path, model_type_or_cfg, scenes, R):
    """The reference's grid and affordance volumes against the port's
    ``net.encode`` and ``decode_affordance_lattice`` on the same weights."""
    from giga_tpu_torch.inference.dense_decode import lattice_coords, lattice_features_batched
    from giga_tpu_torch.models.registry import load_network

    net, cfg = load_network(path, "giga_grid") if isinstance(model_type_or_cfg, str) \
        else model_type_or_cfg
    grids = torch.from_numpy(scenes)
    coords = lattice_coords(R)
    with torch.no_grad():
        port = net.encode(grids)["grid"]
        feats = lattice_features_batched({"grid": port}, coords, cfg)
        q, r, w = (v.float() for v in net.decode_affordance_lattice(feats, coords))
    ref = GridReference(path, "cpu")
    grid = ref.encode(grids)
    _close(grid.permute(0, 2, 3, 4, 1), port, "grid")
    qr, rr, wr = ref.affordance(grid, grid_points(lattice(R, "cpu")).expand(len(scenes), -1, -1))
    _close(qr.reshape(q.shape), q, "qual")
    _close(rr.reshape(r.shape), r, "rot")
    _close(wr.reshape(w.shape), w, "width")


def test_reference_matches_the_port_at_the_published_widths():
    _compare(WEIGHTS, "giga_grid", make_pool(2 ** 33 + 11, 2, 40, 0.3)[0], 40)


def test_reference_matches_the_port_at_a_tiny_width(tmp_path):
    """Grid 8^3, f_maps 1 (levels of 1, 2 and 4 channels, decoder levels of
    6 and 3): channels below GroupNorm's 8 groups take one. (At f_maps 4 a
    decoder level has 12 channels, which 8 groups do not divide.)"""
    from giga_tpu_torch.core.config import UNet3DConfig, get_config
    from giga_tpu_torch.models.registry import get_network, save_network, seed_weights

    base = get_config("giga_grid")
    cfg = dataclasses.replace(base, encoder=dataclasses.replace(
        base.encoder, grid_resolution=8, plane_resolution=8, unet3d=UNet3DConfig(f_maps=1)))
    net = seed_weights(type(get_network("giga_grid")[0])(cfg), 0).eval()
    path = tmp_path / "seeded_giga_grid_0.msgpack"
    save_network(net, path)
    _compare(path, (net, cfg), make_pool(2 ** 33 + 12, 2, 8, 0.3)[0], 8)


def test_stored_weights_are_the_seeded_ones():
    from giga_tpu_torch.models.registry import get_network, load_network, seed_weights

    stored = load_network(WEIGHTS)[0].state_dict()
    seeded = seed_weights(get_network("giga_grid")[0], 0).state_dict()
    assert stored.keys() == seeded.keys()
    assert all(torch.equal(stored[k], seeded[k]) for k in seeded)


def _small_cell():
    cell, config, traffic, workload = harness.cell_files(BENCH, CELL)
    traffic.update(pool=4, batch_size=2, warmup_batches=1, sample=3)
    return cell, config, traffic, workload


def test_judge_passes_the_ports_grasp_lists():
    from portbench import plans

    _, config, _, _ = _small_cell()
    s = config["planner"]
    scenes = make_pool(2 ** 33 + 13, 3, 40, 0.3)[0]
    planner = plans.make_planner(config, "cpu", ROOT)
    assert planner._ensure_batched_fn().paths == {"encode": "module", "decode": "module"}
    served = planner.plan_batch(scenes)
    refs = plan(GridReference(WEIGHTS, "cpu"), scenes, s)
    for (grasps, scores), ref in zip(served, refs):
        assert len(grasps) >= 1
        score_gap, pose_gap = plan_gaps(plans.grasp_arrays(grasps, scores), ref, s)
        assert score_gap < 1e-5 and pose_gap < 1e-5


def _run(trace=False):
    cell, config, traffic, workload = _small_cell()
    metrics = harness.cell_metrics(BENCH, CELL, trace)
    return harness.execute(cell, config, traffic, workload, metrics, 2 ** 31 + 9, 3.0, trace,
                           "cpu")


def test_a_sound_run_of_the_cut_cell_is_correct():
    result = _run()
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"scenes_per_s", "setup_s"} <= set(result["metrics"])


def test_an_altered_grasp_list_is_not_correct(monkeypatch):
    from giga_tpu_torch.inference.planner import GIGAPlanner

    original = GIGAPlanner._to_grasps

    def altered(self, cands):
        grasps, scores = original(self, cands)
        return grasps, np.array(scores, dtype=float) - 0.01 * (np.arange(len(scores)) == 0)

    monkeypatch.setattr(GIGAPlanner, "_to_grasps", altered)
    assert not _run()["correct"]


def test_unet3d_count_by_hand():
    """30,433,280,000 operations a scene: by level 7.078 G (40^3: 32->32->32),
    1.327 G (20^3: 32->32->64), 0.664 G (10^3: 64->64->128), 7.078 G (20^3:
    192->64->64), 14.156 G (40^3: 96->32->32), 0.131 G (the 1x1 32->32);
    at B=64 1.948 TFLOP, 29.07 ms at 67 TFLOP/s, bound by operations."""
    def conv(n, cin, cout, taps=27):
        return 2 * taps * cin * cout * n

    by_level = [conv(40 ** 3, 32, 32) * 2, conv(20 ** 3, 32, 32) + conv(20 ** 3, 32, 64),
                conv(10 ** 3, 64, 64) + conv(10 ** 3, 64, 128),
                conv(20 ** 3, 192, 64) + conv(20 ** 3, 64, 64),
                conv(40 ** 3, 96, 32) + conv(40 ** 3, 32, 32), conv(40 ** 3, 32, 32, taps=1)]
    assert [round(x / 1e9, 3) for x in by_level] == [7.078, 1.327, 0.664, 7.078, 14.156, 0.131]
    assert grid_work.unet3d_flops(40, 32, 32, 3) == sum(by_level) == 30_433_280_000
    ms, by = work.bound(64 * grid_work.unet3d_flops(), 64 * grid_work.unet3d_bytes())
    assert (round(ms, 2), by) == (29.07, "operations")
    # one level of 2 channels on a 2^3 grid, by hand: two 3^3 convs and the 1x1
    assert grid_work.unet3d_flops(2, 2, 2, 1) == 8 * (2 * 27 * 4 * 2 + 2 * 4)
    assert grid_work.unet3d_bytes(2, 2, 2, 1) == 4 * (2 * (16 + 108 + 16) + (16 + 4 + 16))


def test_grid_decode_count_by_hand():
    """96,492 operations a lattice point: 480 for the 8-tap trilinear sample
    of 32 channels, and per head 224 (fc_p), 5 x 6,304 (fc_c 2,048 + 64,
    fc_0 and fc_1 4,096, biases and residual 96) and 260 (the head of 4)."""
    assert grid_work.grid_decode_point_flops() == 480 + 3 * (224 + 5 * 6304 + 260) == 96_492
    flops, nbytes = grid_work.grid_decode_work(64)
    assert flops == 64 * 40 ** 3 * 96_492
    assert round(work.bound(flops, nbytes)[0], 2) == 5.90
    assert grid_work.grid_plan_flops() == 110_592_000 + 30_433_280_000 + 40 ** 3 * 96_492


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_stage_readers_on_hand_made_marks():
    batches = [[(n, _Event(t)) for n, t in zip(["start", "encode", "features", "decode", "post"],
                                               times)]
               for times in ([0, 70, 72, 160, 165], [0, 74, 77, 167, 170])]
    run = SimpleNamespace(stage_s=stage_seconds(batches), traffic={"batch_size": 64},
                          config={"model": {"grid_resolution": 40, "c_dim": 32,
                                            "unet3d_f_maps": 32, "unet3d_num_levels": 3,
                                            "hidden_size": 32, "n_blocks": 5}},
                          settings={"resolution": 40})
    assert mean_stage_ms(run, ["encode"]) == pytest.approx(72.0)
    assert mean_stage_ms(run, ["features", "decode"]) == pytest.approx(91.5)
    read = {name: harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py").read
            for name in ("gridplan.encode_ms", "gridplan.decode_ms", "unet3d_roofline",
                         "grid_decode_roofline")}
    assert read["gridplan.encode_ms"](run) == pytest.approx(72.0)
    assert read["unet3d_roofline"](run) == pytest.approx(100 * 29.0706 / 72.0, rel=1e-4)
    assert read["grid_decode_roofline"](run) == pytest.approx(100 * 5.8990 / 91.5, rel=1e-4)
    empty = SimpleNamespace(stage_s={})  # a program without marks, as the parent's
    assert all(r(empty) is None for r in read.values())


def test_a_traced_cpu_run_leaves_out_what_only_the_card_reads():
    """On the CPU the program records no mark and the trace no device
    operation: only ``gridplan.mfu`` is read."""
    result = _run(trace=True)
    assert result["correct"]
    assert set(result["metrics"]) == {"gridplan.mfu"}
