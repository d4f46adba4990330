"""The giga self-check at the scale the JAX package documents
(``--mode giga --steps 3000 --n-scenes 40 --n-grasps 160``,
selfcheck_scale.DOCUMENTED) through its golden file,
giga_tpu_torch/testdata/golden_selfcheck_giga.npz, written by the JAX
script (scripts/selfcheck_e2e.py) on the CPU:

* ``init/``: the JAX script's initial params (``create_train_state(...,
  PRNGKey(0))``), held here to JAX's ``net.init(PRNGKey(0))`` under
  ``jax.jit`` leaf by leaf, exactly;
* ``traj/``: the loss terms (selfcheck_scale.TERMS) and the non-finite
  skip of each of the run's first chip_smoke.SELFCHECK_GOLDEN_STEPS steps
  (phase 39 of chip_smoke.py holds the port's steps on the card to them);
* ``trained/``: the params after all 3000 steps, the step-by-step
  ``loss_all`` and skips of the whole run, ``apply_if_finite``'s
  ``total_notfinite``, and the script's ``check_planner`` on the held-out
  scene: its grasps (positions, quaternions, widths, scores), the oracle's
  labels of the top ``--top-k``, the GSR and the median surface distance.
  Here the port's CPU ``check_planner`` with those params returns JAX's
  grasps (``chip_smoke.compare_grasps``: the same count and lattice
  positions; positions, quaternions, widths and scores within
  chip_smoke.TOL_SCORE), the same labels and GSR, and surface distances
  and their median within that position bound.

Nothing here reruns JAX's 3000 steps or builds the documented grasp labels
(~42 s of host work): the trajectory is held on the card. Rewrite the file
with ``JAX_PLATFORMS=cpu python tests/test_torch_selfcheck_scale.py --write
[init traj trained]`` (``trained`` runs the JAX script's whole 3000 steps:
~32 min of training on a CPU of 8 cores). The port's side runs on one torch thread.
"""

import argparse
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

import chip_smoke  # noqa: E402
from giga_tpu_torch.scripts import selfcheck_e2e as tsc  # noqa: E402
from giga_tpu_torch.scripts import selfcheck_scale as ssc  # noqa: E402
from torch_sim import one_torch_thread  # noqa: E402, F401  (autouse)

_spec = importlib.util.spec_from_file_location("jax_selfcheck_e2e",
                                               REPO / "scripts" / "selfcheck_e2e.py")
jsc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jsc)

GOLDEN = REPO / ssc.GOLDEN
MAX_BYTES = 5_000_000


def documented_args(**over) -> argparse.Namespace:
    """The documented run's flags as both scripts parse them."""
    args = ssc.parser().parse_args(["--device", "cpu"])
    for k, v in over.items():
        setattr(args, k, v)
    return args


class _Stop(Exception):
    """Raised where the JAX script turns from training to evaluation."""


def jax_documented_run(steps: int, plan: bool) -> dict:
    """The JAX script's ``main`` at the documented scale for ``steps`` steps,
    its ``make_train_step`` wrapped to record each step's terms and skip; with ``plan`` its ``check_planner`` runs wrapped
    to record the grasps, the oracle's labels and the trained state, else
    the run stops where evaluation starts."""
    import giga_tpu.inference.planner as jplanner
    import giga_tpu.utils.synthetic_grasps as jgrasps

    rec = {"terms": {k: [] for k in ssc.TERMS}, "skipped": []}
    real_make, real_check = jsc.make_train_step, jsc.check_planner
    real_call, real_eval = jplanner.GIGAPlanner.__call__, jgrasps.evaluate_grasp

    def make(net, cfg):
        step = real_make(net, cfg)

        def wrapped(state, batch):
            state, terms = step(state, batch)
            for k in ssc.TERMS:
                rec["terms"][k].append(float(terms[k]))
            rec["skipped"].append(not bool(state.opt_state.last_finite))
            return state, terms

        return wrapped

    def call(self, *a, **k):
        rec["plan"] = out = real_call(self, *a, **k)
        return out

    def evaluate(*a, **k):
        out = real_eval(*a, **k)
        rec.setdefault("labels", []).append(out[0])
        return out

    def check(net, cfg, state, test_mesh, test_tsdf, size, args):
        if not plan:
            raise _Stop
        rec["params"] = jax.device_get(state.params)
        rec["total_notfinite"] = int(state.opt_state.total_notfinite)
        rec["mesh"] = test_mesh
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jplanner.GIGAPlanner, "__call__", call)
            mp.setattr(jgrasps, "evaluate_grasp", evaluate)
            rec["code"] = real_check(net, cfg, state, test_mesh, test_tsdf, size, args)
        return rec["code"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsc, "make_train_step", make)
        mp.setattr(jsc, "check_planner", check)
        try:
            jsc.main(documented_args(steps=steps))
        except _Stop:
            pass
    return rec


def golden_init() -> dict:
    """The JAX script's initial params for giga at seed 0."""
    from giga_tpu.models.registry import get_network as jax_get_network
    from giga_tpu.train.trainer import create_train_state

    args = documented_args()
    net, cfg = jax_get_network("giga")
    state = create_train_state(net, cfg, jax.random.PRNGKey(args.seed), lr=args.lr,
                               clip_norm=args.clip_norm, skip_nonfinite=True)
    return chip_smoke.flatten_params(jax.device_get(state.params), "init/")


def golden_traj() -> dict:
    """Each loss term and skip of the first SELFCHECK_GOLDEN_STEPS steps."""
    rec = jax_documented_run(chip_smoke.SELFCHECK_GOLDEN_STEPS, plan=False)
    out = {f"traj/{k}": np.asarray(v, np.float32) for k, v in rec["terms"].items()}
    out["traj/skipped"] = np.asarray(rec["skipped"], bool)
    return out


def oracle_distances(mesh, grasps, top_k: int) -> np.ndarray:
    """check_planner's surface distances of the top ``top_k`` grasps (its
    RandomState(123) surface sample; the oracle's labels draw after it)."""
    from scipy.spatial import cKDTree

    surf, _ = mesh.sample_surface(20000, rng=np.random.RandomState(123))
    tree = cKDTree(surf)
    return np.asarray([tree.query(g.pose.translation)[0] for g in grasps[:top_k]], np.float64)


def golden_trained() -> dict:
    """JAX's params after the documented run, its losses and skips, and its
    planner's result on the held-out scene."""
    args = documented_args()
    rec = jax_documented_run(args.steps, plan=True)
    out = chip_smoke.flatten_params(rec["params"], "trained/params/")
    out["trained/loss_all"] = np.asarray(rec["terms"]["loss_all"], np.float32)
    out["trained/skipped"] = np.asarray(rec["skipped"], bool)
    out["trained/total_notfinite"] = np.asarray(rec["total_notfinite"], np.int64)
    grasps, scores, _ = rec["plan"]
    out["trained/pos"] = np.asarray([g.pose.translation for g in grasps], np.float64).reshape(-1, 3)
    out["trained/quat"] = np.asarray([g.pose.rotation.as_quat() for g in grasps],
                                     np.float64).reshape(-1, 4)
    out["trained/width"] = np.asarray([g.width for g in grasps], np.float64)
    out["trained/score"] = np.asarray(scores, np.float64)
    labels = np.asarray(rec.get("labels", []), bool)
    dists = oracle_distances(rec["mesh"], grasps, args.top_k)
    out["trained/labels"] = labels
    out["trained/dists"] = dists
    out["trained/gsr"] = np.asarray(100.0 * labels.mean() if len(labels) else 0.0)
    out["trained/median_mm"] = np.asarray(np.median(dists) * 1e3 if len(dists) else np.inf)
    out["trained/code"] = np.asarray(rec["code"], np.int64)
    return out


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_golden_file_size():
    assert GOLDEN.stat().st_size < MAX_BYTES


def test_golden_init_equals_jax_init(golden):
    """init/ is JAX's ``net.init(PRNGKey(0))`` of giga, leaf by leaf."""
    import jax.numpy as jnp

    from giga_tpu.models.registry import get_network as jax_get_network

    net, cfg = jax_get_network("giga")
    tsdf = jnp.zeros((1, 40, 40, 40), jnp.float32)
    p = jnp.zeros((1, 1, 3), jnp.float32)
    params = jax.jit(net.init)(jax.random.PRNGKey(0), tsdf, p, p if cfg.decoder_tsdf else None)
    ref = chip_smoke.flatten_params(jax.device_get(params), "init/")
    assert sorted(ref) == sorted(k for k in golden.files if k.startswith("init/"))
    for k, v in ref.items():
        assert golden[k].dtype == v.dtype and golden[k].shape == v.shape, k
        np.testing.assert_array_equal(golden[k], v, err_msg=k)


def test_golden_loads_into_port(golden):
    """Both parameter sets load into the port's giga net by name and shape,
    and init/ is not trained/."""
    from giga_tpu_torch.models.registry import get_network

    net, _ = get_network("giga")
    sd = net.state_dict()
    for prefix in ("init/", "trained/params/"):
        got = ssc.golden_state_dict(golden, prefix)
        assert sorted(got) == sorted(sd)
        assert all(got[k].shape == sd[k].shape for k in sd)
    a, b = (ssc.golden_state_dict(golden, p) for p in ("init/", "trained/params/"))
    assert any(not np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)
    n = chip_smoke.SELFCHECK_GOLDEN_STEPS
    assert all(golden[f"traj/{k}"].shape == (n,) for k in ssc.TERMS)
    assert golden["traj/skipped"].shape == (n,) and golden["trained/skipped"].shape == (3000,)
    np.testing.assert_array_equal(golden["trained/loss_all"][:n], golden["traj/loss_all"])
    np.testing.assert_array_equal(golden["trained/skipped"][:n], golden["traj/skipped"])
    assert int(golden["trained/total_notfinite"]) == int(golden["trained/skipped"].sum())


def test_port_planner_on_jax_trained_params(golden):
    """The port's check_planner on the CPU with JAX's 3000-step params
    returns the JAX script's grasps on the held-out scene, the oracle's
    labels and GSR, and its surface distances and median (within the
    positions' bound: the port's positions lie ~6e-9 m from JAX's)."""
    from giga_tpu_torch.core.grasp import Grasp
    from giga_tpu_torch.core.transform import Rotation, Transform
    from giga_tpu_torch.models.registry import get_network

    args = documented_args()
    scenes, tsdfs, _, _ = tsc.build_dataset(args.n_scenes, tsc.SIZE, tsc.RESOLUTION,
                                            args.n_occ, args.seed)
    net, cfg = get_network("giga")
    net.load_state_dict(ssc.golden_state_dict(golden, "trained/params/"))
    ok, gate = tsc.check_planner(net, cfg, scenes[-1], tsdfs[-1], tsc.SIZE, args, "cpu")
    ref = ([Grasp(Transform(Rotation.from_quat(q), p), w) for p, q, w in
            zip(golden["trained/pos"], golden["trained/quat"], golden["trained/width"])],
           list(golden["trained/score"]))
    chip_smoke.compare_grasps(gate["plan"], ref, tsc.SIZE / tsc.RESOLUTION, "trained")
    np.testing.assert_array_equal(np.asarray(gate["labels"]), golden["trained/labels"])
    assert gate["gsr"] == float(golden["trained/gsr"])
    # a surface distance moves no farther than its grasp's position
    np.testing.assert_allclose(gate["dists"], golden["trained/dists"], rtol=0,
                               atol=chip_smoke.TOL_SCORE)
    assert abs(gate["median_mm"] - float(golden["trained/median_mm"])) <= chip_smoke.TOL_SCORE * 1e3
    assert ok == (int(golden["trained/code"]) == 0)


TINY = ["--device", "cpu", "--n-scenes", "3", "--n-occ", "256", "--n-grasps", "8",
        "--batch", "2", "--batch-occ", "64", "--steps", "3"]


@pytest.fixture(scope="module")
def tiny():
    """TINY's flags, data and a reference_init(net, 0) state dict."""
    from giga_tpu_torch.models.registry import get_network, reference_init

    args = ssc.parser().parse_args(TINY)
    scenes, tsdfs, occ_pts, occ_lbls = tsc.build_dataset(args.n_scenes, tsc.SIZE,
                                                         tsc.RESOLUTION, args.n_occ, args.seed)
    grasps = tsc.build_grasp_labels(scenes, tsc.SIZE, args.n_grasps, args.seed)
    net, _ = get_network("giga")
    reference_init(net, 0)
    return args, (tsdfs, occ_pts, occ_lbls, grasps), {k: v.clone() for k, v in
                                                      net.state_dict().items()}


@pytest.mark.parametrize("qual_bias", [None, 30.0])
def test_train_records_the_self_checks_steps(tiny, qual_bias):
    """selfcheck_scale.train records each step's terms of selfcheck_e2e's own
    loop and step (its qual hook changes nothing: the same terms and params
    as the plain step); with the qual head's bias at 30 every qual is
    exactly 1.0 (float32's sigmoid), every step's gradient is NaN, and each
    step is skipped, counted as saturated, and leaves the params as they
    were."""
    from giga_tpu_torch.models.registry import get_network
    from giga_tpu_torch.train.trainer import make_train_step

    args, data, sd = tiny
    if qual_bias is not None:
        sd = dict(sd, **{"decoder_aff.fc_out_bias": sd["decoder_aff.fc_out_bias"].clone()})
        sd["decoder_aff.fc_out_bias"][0, 0] = qual_bias
    runs = []
    for observed in (True, False):
        net, cfg = get_network("giga")
        net.load_state_dict(sd)
        if observed:
            state, rec, _ = ssc.train(net, cfg, data, args, "cpu", log=lambda m: None)
        else:
            state = tsc.make_state(net, args, "cpu")
            step = make_train_step(net, cfg)
            rec = {k: [] for k in ssc.TERMS}

            def plain(state, batch):
                state, terms = step(state, batch)
                for k in ssc.TERMS:
                    rec[k].append(float(terms[k]))
                return state, terms

            state, _ = tsc.train_loop(state, plain, data, args, log=lambda m: None)
        runs.append((rec, {k: v.detach().clone() for k, v in state.module.state_dict().items()},
                     int(state.tx.count)))
    (rec, params, count), (ref, ref_params, ref_count) = runs
    for k in ssc.TERMS:
        np.testing.assert_array_equal(rec[k], np.asarray(ref[k], np.float32), err_msg=k)
    assert count == ref_count
    for k in params:
        np.testing.assert_array_equal(params[k].numpy(), ref_params[k].numpy(), err_msg=k)
    if qual_bias is None:
        assert count == args.steps and not rec["skipped"].any() and not rec["saturated"].any()
    else:
        assert count == 0 and rec["skipped"].all() and rec["saturated"].all()
        for k in params:
            np.testing.assert_array_equal(params[k].numpy(), sd[k].numpy(), err_msg=k)


def test_train_records_a_skip_from_the_gradient_past_the_limit(tiny, monkeypatch):
    """A step counts as skipped when its gradient is not finite, as JAX's
    ``apply_if_finite`` records ``not last_finite``, even where the run of
    non-finite steps has passed the limit and the update is applied: with
    the limit at 1 and every qual at 1.0, step 1 is skipped and steps 2 and 3
    apply their NaN updates (the step count advances), and all three count
    as skipped."""
    from giga_tpu_torch.models.registry import get_network
    from giga_tpu_torch.train import trainer

    args, data, sd = tiny
    sd = dict(sd, **{"decoder_aff.fc_out_bias": sd["decoder_aff.fc_out_bias"].clone()})
    sd["decoder_aff.fc_out_bias"][0, 0] = 30.0
    monkeypatch.setattr(trainer, "MAX_CONSECUTIVE_ERRORS", 1)
    net, cfg = get_network("giga")
    net.load_state_dict(sd)
    state, rec, _ = ssc.train(net, cfg, data, args, "cpu", log=lambda m: None)
    assert int(state.tx.count) == args.steps - 1
    assert rec["skipped"].tolist() == [True] * args.steps


def test_phase_39_holds_each_step_to_its_own_bound():
    """chip_smoke's phase 39 check: the golden's own trajectory passes; a
    run whose terms move by 1e-4 at step 1 and not after it (TF32's size of
    error in one step) fails at step 1, though it lies far inside the bound
    of step 16; a run whose skips differ from JAX's fails."""
    golden = np.load(GOLDEN)
    ref = ssc.golden_traj(golden)
    n = chip_smoke.SELFCHECK_TRAJ_STEPS
    assert n <= chip_smoke.SELFCHECK_GOLDEN_STEPS == len(ref["loss_all"])
    skips = ref["skipped"][:n]
    chip_smoke.check_selfcheck_trajectory(ssc.envelope(ref, ref, n), skips, skips)
    moved = {k: v.copy() for k, v in ref.items()}
    moved["loss_occ"][0] += 1e-4 * (1 + abs(moved["loss_occ"][0]))
    env = ssc.envelope(moved, ref, n)
    assert env[-1] < chip_smoke.TOL_SELFCHECK_TRAJ[-1]
    with pytest.raises(AssertionError, match="at step 1:"):
        chip_smoke.check_selfcheck_trajectory(env, skips, skips)
    with pytest.raises(AssertionError, match="skipped steps"):
        chip_smoke.check_selfcheck_trajectory(ssc.envelope(ref, ref, n), ~skips, skips)


def test_saturated_qual_gives_nan_gradient_in_both_packages():
    """The lead the skips are read against: a qual of exactly 1.0 (float32
    sigmoid of 20) gives a NaN gradient through both packages' BCE, for a
    positive and a negative label alike."""
    import jax.numpy as jnp
    import torch

    from giga_tpu.train.loss import binary_cross_entropy as jax_bce
    from giga_tpu_torch.train.loss import binary_cross_entropy as torch_bce

    for label in (1.0, 0.0):
        g = jax.grad(lambda x: jax_bce(jax.nn.sigmoid(x), jnp.float32(label)))(jnp.float32(20.0))
        assert np.isnan(float(g)), label
        x = torch.tensor(20.0, requires_grad=True)
        torch_bce(torch.sigmoid(x), torch.tensor(label)).backward()
        assert torch.isnan(x.grad), label
        assert float(jax.nn.sigmoid(jnp.float32(20.0))) == float(torch.sigmoid(x.detach())) == 1.0


def test_cli_scores_every_held_out_scene(tiny, tmp_path, capsys, monkeypatch):
    """The CLI at TINY's size: a seeded run and JAX's trained weights, each
    scored on the held-out scene and one more, with its JSON line."""
    import json

    out = tmp_path / "runs.jsonl"
    monkeypatch.setattr(ssc, "EXTRA_SCENES", 1)
    assert ssc.main([*TINY, "--init", "seed:1", "--weights", "golden", "--out", str(out)]) == 0
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["run"] for r in lines] == ["init seed:1", "weights golden"]
    for r in lines:
        assert len(r["scenes"]) == 2 and 0 <= r["mean_gsr"] <= 100
    assert lines[0]["steps"] == 3 and lines[0]["skipped"] == 0
    text = capsys.readouterr().out
    assert "init seed:1: step 0: loss" in text and "over 2 scenes GSR mean" in text


def write(words) -> None:
    """Rewrite the parts of the golden file that ``words`` names, keeping
    the others."""
    parts = {"init": golden_init, "traj": golden_traj, "trained": golden_trained}
    new = {}
    for w in words or parts:
        new.update(parts[w]())
    old = dict(np.load(GOLDEN)) if GOLDEN.exists() else {}
    for w in words or parts:
        old = {k: v for k, v in old.items() if not k.startswith(w + "/")}
    np.savez_compressed(GOLDEN, **old, **new)
    print("wrote", GOLDEN.name, GOLDEN.stat().st_size, "bytes")


if __name__ == "__main__" and "--write" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    write(sys.argv[sys.argv.index("--write") + 1:])
