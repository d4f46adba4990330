"""Model-quality gate of the shipped GIGA-Geo checkpoint through the port
(counterpart of tests/test_geo_gate.py): the port's
giga_tpu_torch/scripts/eval_synthetic_geometry.py on the CPU, at that gate's
protocol (4 scenes, seed 2000, one upsampling step: a 65^3 lattice, 50,000
evaluation points) and floors, and its metrics equal to the JAX script's
on the same scenes."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINT = ROOT / "checkpoints" / "synthetic_giga_geo.msgpack"

IOU_FLOOR = 0.82
FSCORE_FLOOR = 0.78
CHAMFER_L1_CEIL = 0.0075  # normalized units ([-0.5, 0.5]^3 frame)
PROTOCOL = dict(n_scenes=4, seed=2000, resolution0=32, upsampling_steps=1, n_eval_points=50000)


@pytest.fixture(scope="module")
def port_metrics():
    from giga_tpu_torch.scripts.eval_synthetic_geometry import evaluate_geo_checkpoint

    return evaluate_geo_checkpoint(CHECKPOINT, device="cpu", **PROTOCOL)


@pytest.mark.skipif(not CHECKPOINT.exists(), reason="shipped checkpoint missing")
def test_shipped_geo_checkpoint_reconstruction(port_metrics):
    out = port_metrics
    assert out["iou"] >= IOU_FLOOR, out
    assert out["f-score"] >= FSCORE_FLOOR, out
    assert out["chamfer-L1"] <= CHAMFER_L1_CEIL, out


@pytest.mark.skipif(not CHECKPOINT.exists(), reason="shipped checkpoint missing")
def test_metrics_match_jax_script(port_metrics):
    """The same scenes, samples and meshes up to float16 corner steps: IoU
    within 1e-3, the point-cloud metrics within 1e-4 of JAX's."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from eval_synthetic_geometry import evaluate_geo_checkpoint

    ref = evaluate_geo_checkpoint(str(CHECKPOINT), **PROTOCOL)
    assert port_metrics.keys() == ref.keys()
    assert abs(port_metrics["iou"] - ref["iou"]) <= 1e-3
    for k in ("f-score", "chamfer-L1", "completeness", "accuracy", "normals"):
        assert abs(port_metrics[k] - ref[k]) <= 1e-4, k


def test_cli_prints_metrics(capsys):
    """The CLI's arguments and its JSON, on the CPU at a tiny protocol."""
    import json

    from giga_tpu_torch.scripts import eval_synthetic_geometry as script

    script.main([str(CHECKPOINT), "--n-scenes", "1", "--resolution0", "8",
                 "--upsampling-steps", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert {"iou", "f-score", "chamfer-L1"} <= out.keys() and 0 < out["iou"] <= 1
