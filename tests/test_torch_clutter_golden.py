"""The JAX golden of chip_smoke.py's phase 34, kept current.

``giga_tpu_torch/testdata/golden_clutter_giga.npz`` holds the JAX package's
``clutter_removal.run`` over tests/fake_pybullet.py with
``GIGAPlanner(checkpoints/synthetic_giga_best.msgpack, "giga", best=True,
qual_th=0.9, out_th=0.1)`` in float32 on the fixture URDFs: pile, then
packed, 5 objects of the "blocks" set, one view, 2 rounds each, seed 0
(``chip_smoke.clutter_protocol``: per attempt its scene type, round,
objects on the table, grasp position, quaternion, width, score and label;
per run GSR, DR, aborts and each round's objects). Rewrite it with

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write clutter
"""

import sys
import tempfile
from pathlib import Path

import numpy as np

import jax

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from torch_sim import double  # noqa: E402

GOLDEN_KEYS = ("scene", "round", "objects", "position", "quaternion", "width", "score",
               "label", "gsr", "dr", "aborts", "round_objects")


def golden_clutter_arrays() -> dict:
    """The JAX package's run of the golden's protocol (float32, highest
    matmul precision)."""
    from giga_tpu.experiments import clutter_removal
    from giga_tpu.inference.planner import GIGAPlanner

    planner = GIGAPlanner(REPO / chip_smoke.CHECKPOINT, "giga", **chip_smoke.CLUTTER_KW)
    with tempfile.TemporaryDirectory() as tmp, double("jax"), \
            jax.default_matmul_precision("highest"):
        out = chip_smoke.clutter_protocol(clutter_removal, planner, Path(tmp))
    return {k: out[k] for k in GOLDEN_KEYS}


def test_clutter_golden_file_is_current():
    """JAX's run now equals the committed golden: attempts, labels, object
    counts, GSR/DR and aborts equal, positions, quaternions, scores and
    widths within the protocol's tolerances; at least 4 attempts."""
    golden = np.load(REPO / chip_smoke.GOLDEN_CLUTTER)
    assert set(golden.files) == set(GOLDEN_KEYS)
    assert len(golden["label"]) >= 4
    chip_smoke.compare_clutter(golden_clutter_arrays(), dict(golden), "JAX vs golden")
