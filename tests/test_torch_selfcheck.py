"""The port's end-to-end learning self-check
(giga_tpu_torch/scripts/selfcheck_e2e.py) against the JAX script
(scripts/selfcheck_e2e.py) on the CPU.

* ``build_dataset`` and ``build_grasp_labels`` give the JAX script's
  scenes, TSDFs, occupancy samples and grasp arrays exactly (3 scenes, 256
  points, 8 grasps).
* The training loop, started from the params of the JAX script's own
  ``create_train_state(..., PRNGKey(0))`` carried across by convert.py,
  follows the JAX script's loop for 3 steps in geo and giga mode (B=2, 64
  points, the JAX step one ``jax.jit``): the same batches exactly; each
  step's loss within 1e-5 * (1 + |b|) (chip_smoke.TOL_TRAIN_LOSS); the
  params after the first step within chip_smoke.TOL_TRAIN_PARAM (5e-5)
  beyond Adam's first move of the two clipped gradients
  (``chip_smoke.adam_first_move``), and after the third within 5e-5, or
  within 2 * ADAM_STEP * lr a step where JAX's first clipped gradient lies
  within chip_smoke.TOL_TRAIN_GRAD * (1 + its leaf's max) of zero
  (``chip_smoke.undetermined``), as phase 26 holds the JAX golden.
* The CLI on the CPU (2 steps of B=2 x 64 points on 3 scenes of 256
  points): it prints SELFCHECK, exits 0 at ``--iou-threshold
  0`` and 1 at 1.01, and ``--save-params`` writes the trained weights as a
  file the JAX package's ``load_params`` reads back equal.

The port's side runs on one torch thread.
"""

import argparse
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from giga_tpu.models.registry import load_params as jax_load_params
from giga_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from giga_tpu_torch.models.registry import get_network
from giga_tpu_torch.scripts import selfcheck_e2e as tsc
from giga_tpu_torch.train.trainer import make_train_step
from torch_sim import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_selfcheck_e2e",
                                               REPO / "scripts" / "selfcheck_e2e.py")
jsc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jsc)

SMALL = dict(n_scenes=3, n_occ=256, n_grasps=8)
TRAIN = dict(SMALL, batch=2, batch_occ=64, steps=3, iou_threshold=0.5, gsr_threshold=30.0,
             planner_qual_th=0.8, top_k=10, seed=0, lr=2e-4, clip_norm=1.0, cosine_lr=False,
             save_params="")


class _Stop(Exception):
    """Raised where the JAX script turns from training to evaluation."""


def _arrays(mesh):
    return np.asarray(mesh.vertices), np.asarray(mesh.faces)


def test_dataset_and_grasp_labels_equal_jax(capsys):
    got = tsc.build_dataset(SMALL["n_scenes"], tsc.SIZE, 40, SMALL["n_occ"], 0)
    ref = jsc.build_dataset(SMALL["n_scenes"], 0.3, 40, SMALL["n_occ"], 0)
    for a, b in zip(got[0], ref[0]):
        for x, y in zip(_arrays(a), _arrays(b)):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    gl = tsc.build_grasp_labels(got[0], tsc.SIZE, SMALL["n_grasps"], 0)
    gr = jsc.build_grasp_labels(ref[0], 0.3, SMALL["n_grasps"], 0)
    for a, b in zip(gl, gr):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and "positive fraction" in out[0]


def _adam_mu(opt_state) -> dict:
    """The first moments of optax's adam inside ``opt_state``."""
    for leaf in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf.mu
    raise AssertionError("no adam state")


def jax_run(mode: str, monkeypatch) -> dict:
    """The JAX script's main at TRAIN's sizes, stopped where evaluation
    starts: its initial params, batches, terms, and params and adam mu
    after the first and the last step (host copies: its step donates)."""
    rec = {"batches": [], "terms": [], "params": [], "mu": None}
    real = jsc.make_train_step

    def make(net, cfg):
        step = real(net, cfg)

        def wrapped(state, batch):
            if not rec["params"]:
                rec["params"].append(jax.device_get(state.params))
            rec["batches"].append(jax.device_get(batch))
            state, terms = step(state, batch)
            rec["terms"].append(jax.device_get(terms))
            rec["params"].append(jax.device_get(state.params))
            if rec["mu"] is None:
                rec["mu"] = jax.device_get(_adam_mu(state.opt_state))
            return state, terms

        return wrapped

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(jsc, "make_train_step", make)
    monkeypatch.setattr(jsc, "MeshGenerator", stop)
    monkeypatch.setattr(jsc, "check_planner", stop)
    with pytest.raises(_Stop):
        jsc.main(argparse.Namespace(mode=mode, **TRAIN))
    return rec


def port_run(mode: str, params0: dict) -> dict:
    """The port's loop at TRAIN's sizes from ``params0`` (a flax tree)."""
    args = argparse.Namespace(mode=mode, device="cpu", **TRAIN)
    scenes, tsdfs, occ_pts, occ_lbls = tsc.build_dataset(
        args.n_scenes, tsc.SIZE, 40, args.n_occ, args.seed)
    grasps = (tsc.build_grasp_labels(scenes, tsc.SIZE, args.n_grasps, args.seed)
              if mode == "giga" else None)
    net, cfg = get_network("giga" if mode == "giga" else "giga_geo")
    net.load_state_dict(flax_to_state_dict(params0))
    state = tsc.make_state(net, args, "cpu")
    step = make_train_step(net, cfg)
    rec = {"batches": [], "terms": [], "params": [], "mu": None}

    def wrapped(state, batch):
        rec["batches"].append({k: np.copy(v) for k, v in batch.items()})
        state, terms = step(state, batch)
        rec["terms"].append({k: float(v) for k, v in terms.items()})
        rec["params"].append({k: v.detach().clone() for k, v in state.params.items()})
        if rec["mu"] is None:
            rec["mu"] = dict(zip(state.params, (m.clone() for m in state.tx.mu)))
        return state, terms

    state, losses = tsc.train_loop(state, wrapped, (tsdfs, occ_pts, occ_lbls, grasps), args,
                                   log=lambda m: None)
    assert sorted(losses) == [0, 2]
    return rec


@pytest.mark.parametrize("mode", ["geo", "giga"])
def test_training_loop_matches_jax(mode, monkeypatch):
    ref = jax_run(mode, monkeypatch)
    got = port_run(mode, ref["params"][0])
    assert len(got["batches"]) == len(ref["batches"]) == TRAIN["steps"]
    for a, b in zip(got["batches"], ref["batches"]):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b in zip(got["terms"], ref["terms"]):
        for k in ("loss_all", "loss_occ") + (("loss_qual",) if mode == "giga" else ()):
            ref_k = float(b[k])
            assert abs(a[k] - ref_k) <= chip_smoke.TOL_TRAIN_LOSS * (1 + abs(ref_k)), k

    b1 = 0.9  # Adam's first moment after one step is (1 - b1) * its gradient
    g_port = {k: v.numpy() / (1 - b1) for k, v in got["mu"].items()}
    g_jax = {k: v.numpy() / (1 - b1) for k, v in flax_to_state_dict(ref["mu"]).items()}
    first = flax_to_state_dict(ref["params"][1])
    last = flax_to_state_dict(ref["params"][-1])
    move = 2 * chip_smoke.ADAM_STEP * TRAIN["lr"] * TRAIN["steps"]
    for k in first:
        d1 = np.abs(got["params"][0][k].numpy().astype(np.float64) - first[k].numpy())
        assert (d1 - chip_smoke.adam_first_move(g_port[k], g_jax[k])).max() \
            <= chip_smoke.TOL_TRAIN_PARAM, k
        free = chip_smoke.undetermined(g_jax[k], np.abs(g_jax[k]).max())
        d3 = np.abs(got["params"][-1][k].numpy() - last[k].numpy())
        assert d3[~free].max(initial=0.0) <= chip_smoke.TOL_TRAIN_PARAM, k
        assert d3[free].max(initial=0.0) <= move, k


@pytest.mark.parametrize("threshold,code", [(0.0, 0), (1.01, 1)])
def test_cli_gate_and_saved_params(threshold, code, tmp_path, monkeypatch, capsys):
    seen = {}
    real = tsc.check_geometry

    def check(net, *a, **k):
        seen["state"] = {name: v.detach().clone() for name, v in net.state_dict().items()}
        return real(net, *a, **k)

    monkeypatch.setattr(tsc, "check_geometry", check)
    path = tmp_path / "selfcheck_geo.msgpack"
    args = tsc.parser().parse_args(
        ["--device", "cpu", "--steps", "2", "--n-scenes", "3", "--n-occ", "256", "--batch", "2",
         "--batch-occ", "64", "--iou-threshold", str(threshold), "--save-params", str(path)])
    assert tsc.main(args) == code
    out = capsys.readouterr().out
    assert f"SELFCHECK {'PASSED' if code == 0 else 'FAILED'}" in out
    assert "trained 2 steps" in out and "step 1: loss" in out
    saved = flax_to_state_dict(jax.device_get(jax_load_params(path)))
    assert sorted(saved) == sorted(seen["state"])
    for k, v in seen["state"].items():
        torch.testing.assert_close(saved[k], v, rtol=0, atol=0)
    assert state_dict_to_flax(seen["state"]).keys() == {"params"}
