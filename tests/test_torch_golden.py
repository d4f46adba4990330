"""The JAX golden file that chip_smoke.py holds the card's plan against.

The card has no JAX, so ``giga_tpu_torch/testdata/golden_plan_giga.npz``
carries the JAX package's candidates for the first chip_smoke scenes,
planned on the CPU with the shipped checkpoint. This test regenerates them
and asserts the committed file is current. Rewrite the file with

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write
"""

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from giga_tpu.core.config import PlannerConfig  # noqa: E402
from giga_tpu.inference.planner import build_batched_giga_planner_fn  # noqa: E402
from giga_tpu.models.registry import get_network, load_params  # noqa: E402

N_SCENES = 4
FIELDS = ("scores", "positions", "rotations", "widths", "count")


def golden_arrays() -> dict:
    """The JAX package's candidates for the first N_SCENES chip_smoke scenes."""
    tsdf = chip_smoke.make_scenes(N_SCENES)
    net, cfg = get_network("giga")
    params = load_params(REPO / chip_smoke.CHECKPOINT)
    with jax.default_matmul_precision("highest"):
        fn = build_batched_giga_planner_fn(
            net, cfg, PlannerConfig(**chip_smoke.PLANNER_KW), chip_smoke.SIZE)
        cands, _ = jax.device_get(fn(params, jnp.asarray(tsdf), jnp.asarray(tsdf)))
    out = {f: np.asarray(getattr(cands, f)) for f in FIELDS}
    out["tsdf"] = tsdf
    return out


def test_golden_file_is_current():
    """Regenerated candidates equal the committed ones: same counts and
    positions, scores/widths/rotations within 1e-6 (the CPU XLA build may
    reassociate sums; the file is meant to be bit-stable in practice)."""
    stored = np.load(REPO / chip_smoke.GOLDEN)
    fresh = golden_arrays()
    np.testing.assert_array_equal(stored["count"], fresh["count"])
    np.testing.assert_allclose(stored["tsdf"], fresh["tsdf"], atol=1e-6)
    for i, n in enumerate(fresh["count"]):
        np.testing.assert_allclose(stored["positions"][i, :n], fresh["positions"][i, :n], atol=1e-7)
        for f in ("scores", "widths", "rotations"):
            np.testing.assert_allclose(stored[f][i, :n], fresh[f][i, :n], atol=1e-6)
    assert fresh["count"].sum() > 0


def test_golden_scenes_are_planner_tsdfs():
    """chip_smoke's analytic scenes follow the planner's TSDF convention:
    values in [0, 1], saturated far from surfaces, some voxels inside."""
    tsdf = chip_smoke.make_scenes(3)
    assert tsdf.shape == (3, 40, 40, 40) and tsdf.dtype == np.float32
    assert tsdf.min() == 0.0 and tsdf.max() == 1.0
    for s in tsdf:
        assert 0.0 < (s < 0.5).mean() < 0.2
    np.testing.assert_array_equal(chip_smoke.make_scenes(5)[:3], tsdf)


if __name__ == "__main__" and "--write" in sys.argv:
    np.savez_compressed(REPO / chip_smoke.GOLDEN, **golden_arrays())
    print("wrote", chip_smoke.GOLDEN)
