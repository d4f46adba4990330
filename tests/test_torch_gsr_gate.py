"""The planner's quality gate through the port (counterpart of
tests/test_gsr_gate.py): the shipped GIGA checkpoint planned by the port's
``GIGAPlanner.__call__`` on the CPU, 16 seeded synthetic scenes x top-5 on
each of the seeds 2000 and 3000, scored by the port's geometric oracle, must
meet the JAX gate's floors; and every scored grasp, its pose and its oracle
label, must equal those of the JAX package's own script on the same seeds
(positions within 1e-6 m, quaternions up to sign within 1e-5, labels
equal).

``giga_tpu_torch/testdata/golden_gsr_giga.npz`` carries the JAX script's
grasps and labels to the card (chip_smoke.py phase 28); this file also
asserts that it is current. Rewrite it with

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write gsr
"""

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
for path in (REPO, REPO / "scripts"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import chip_smoke  # noqa: E402
import eval_synthetic_gsr as jax_script  # noqa: E402
from giga_tpu_torch.models.checkpoint import load_params  # noqa: E402
from giga_tpu_torch.scripts import eval_synthetic_gsr as port_script  # noqa: E402
from test_gsr_gate import GSR_FLOOR, MAX_MEDIAN_SURFACE_MM, MIN_CANDIDATES  # noqa: E402

CHECKPOINT = REPO / chip_smoke.CHECKPOINT


def jax_protocol(seed: int, n_scenes: int = chip_smoke.GSR_SCENES):
    """(the JAX script's summary, its scored grasps as golden arrays) on one
    seed: its ``evaluate_grasp`` wrapped to record each grasp it scores."""
    rows, scene = [], [-1]

    def counting(rng, size):
        scene[0] += 1
        return make_scene(rng, size)

    def recording(mesh, surf, pose, rng):
        out = evaluate(mesh, surf, pose, rng)
        rows.append((scene[0], pose.translation, pose.rotation.as_quat(), float(out[0])))
        return out

    make_scene, evaluate = jax_script.random_scene, jax_script.evaluate_grasp
    jax_script.random_scene, jax_script.evaluate_grasp = counting, recording
    try:
        out = jax_script.evaluate_checkpoint(str(CHECKPOINT), n_scenes=n_scenes,
                                             top_k=chip_smoke.GSR_TOP_K, seed=seed)
    finally:
        jax_script.random_scene, jax_script.evaluate_grasp = make_scene, evaluate
    return out, chip_smoke.gsr_rows(rows)


def golden_gsr_arrays() -> dict:
    """The JAX script's scored grasps and summaries for each gate seed,
    each under the prefix "s{seed}_"."""
    out = {}
    for seed in chip_smoke.GSR_SEEDS:
        summary, rows = jax_protocol(seed)
        out.update({f"s{seed}_{k}": v for k, v in rows.items()})
        out[f"s{seed}_summary"] = np.array([summary["gsr"], summary["mean_candidates"],
                                            summary["median_surface_dist_mm"]])
    return out


@pytest.fixture(scope="module")
def port_runs():
    """The port's protocol on the CPU for each gate seed: (summary, rows)."""
    planner = port_script.make_planner("giga", load_params(CHECKPOINT), device="cpu")
    runs = {}
    for seed in chip_smoke.GSR_SEEDS:
        rows = []
        planner.rng = np.random.RandomState(0)
        summary = port_script.evaluate_planner(planner, chip_smoke.GSR_SCENES,
                                               chip_smoke.GSR_TOP_K, seed, record=rows)
        runs[seed] = summary, chip_smoke.gsr_rows(rows)
    return runs


def test_port_protocol_meets_the_gate_floors(port_runs):
    outs = [summary for summary, _ in port_runs.values()]
    for out in outs:
        print(out)
        assert out["mean_candidates"] >= MIN_CANDIDATES, out
        assert out["median_surface_dist_mm"] <= MAX_MEDIAN_SURFACE_MM, out
    assert np.mean([o["gsr"] for o in outs]) >= GSR_FLOOR


def test_port_grasps_and_labels_equal_jax_script(port_runs):
    """Each seed: the JAX script's summary, and each scored grasp's pose and
    oracle label."""
    for seed, (summary, rows) in port_runs.items():
        jsummary, jrows = jax_protocol(seed)
        chip_smoke.compare_gsr_rows(rows, jrows, f"seed {seed}")
        assert summary["gsr"] == jsummary["gsr"]
        assert summary["mean_candidates"] == jsummary["mean_candidates"]
        assert abs(summary["median_surface_dist_mm"] - jsummary["median_surface_dist_mm"]) < 1e-3


def test_checkpoint_ensemble_and_bf16_run_the_protocol():
    """The script's other options on two scenes: a two-member ensemble of
    the same checkpoint equals the checkpoint alone; bf16 plans."""
    one = port_script.evaluate_checkpoint(str(CHECKPOINT), 2, seed=2000, device="cpu")
    two = port_script.evaluate_checkpoint([str(CHECKPOINT)] * 2, 2, seed=2000, device="cpu",
                                          ensemble_combine="max")
    assert one == two
    bf16 = port_script.evaluate_checkpoint(str(CHECKPOINT), 2, seed=2000, device="cpu",
                                           precision="bf16")
    assert bf16["n_grasps"] == one["n_grasps"] == 10


def test_gsr_golden_file_is_current():
    stored = np.load(REPO / chip_smoke.GOLDEN_GSR)
    fresh = golden_gsr_arrays()
    assert set(stored.files) == set(fresh)
    for seed in chip_smoke.GSR_SEEDS:
        chip_smoke.compare_gsr_rows({k: stored[f"s{seed}_{k}"] for k in ("scene", "position",
                                                                        "quat", "label")},
                                    {k: fresh[f"s{seed}_{k}"] for k in ("scene", "position",
                                                                       "quat", "label")},
                                    f"golden seed {seed}")
        np.testing.assert_allclose(stored[f"s{seed}_summary"], fresh[f"s{seed}_summary"],
                                   atol=1e-6)


def test_gsr_cli_help():
    import subprocess

    out = subprocess.run([sys.executable, "-m", "giga_tpu_torch.scripts.eval_synthetic_gsr",
                          "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--precision" in out.stdout and "--device" in out.stdout
