"""GIGA training in the PyTorch port (giga_tpu_torch/train/loss.py and
trainer.py), on the CPU against the JAX package on the same seeded weights
(the port's ``init_network``, through the weight bridge) and batches: every
loss and metric within 1e-6 * (1 + |b|); one fp32 step of giga, giga_geo and VGN
against ``giga_tpu.train.trainer.make_train_step``: loss terms within 1e-5,
each gradient leaf within 1e-5 * (1 + max |g|), params after the step within
5e-5 (tests/test_train.py:171-177); the optimizer against optax's chain as
``create_train_state`` builds it (clip, skip of non-finite steps, the 101st
such step applied); the mm step against the gather step; the bf16 step's
gates (tests/test_train.py:179-211) with its forward in bf16; the eval step
and ``summarize_metrics``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from giga_tpu.models.registry import get_network as jax_get_network
from giga_tpu.train import loss as JL
from giga_tpu.train import trainer as jt
from giga_tpu_torch.core.precision import full_precision
from giga_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from giga_tpu_torch.models.registry import init_network
from giga_tpu_torch.train import loss as TL
from giga_tpu_torch.train import trainer as tt

B, N = 4, 16
TOL_LOSS_FN = 1e-6
TOL_LOSS = 1e-5
TOL_GRAD = 1e-5
TOL_PARAM = 5e-5


class _Preset:
    """A JAX network whose ``init`` returns given params, so that
    ``giga_tpu.train.trainer.create_train_state`` builds its optimizer around
    the port's seeded weights."""

    def __init__(self, net, params):
        self.net, self.params = net, params
        self.apply = net.apply

    def init(self, *args):
        return self.params


def jax_state(name, net, **kw):
    """(JAX network, config, JAX TrainState) on ``net``'s weights."""
    jnet, jcfg = jax_get_network(name)
    params = jax.tree.map(jnp.asarray, state_dict_to_flax(net.state_dict()))
    return jnet, jcfg, jt.create_train_state(_Preset(jnet, params), jcfg, None, **kw)


def batch(seed=0, vgn=False, b=B, n=N):
    return chip_smoke.train_batch(seed, b, n, vgn=vgn)


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def leaf_errors(got: dict, ref: dict) -> dict:
    """{leaf: max |a - b| / (1 + max |b|)} over the port's leaf names."""
    return {k: float((torch.as_tensor(got[k]).detach() - ref[k]).abs().max()
                     / (1.0 + ref[k].abs().max())) for k in ref}


def param_error(state, ref_params) -> float:
    ref = flax_to_state_dict(jax.device_get(ref_params))
    return max(float((state.params[k].detach() - ref[k]).abs().max()) for k in ref)


# --------------------------------------------------------------------- losses

def _loss_inputs():
    rng = np.random.RandomState(0)
    rot = rng.randn(8, 4).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    rots = rng.randn(8, 2, 4).astype(np.float32)
    rots /= np.linalg.norm(rots, axis=2, keepdims=True)
    qual = rng.uniform(0.01, 0.99, 8).astype(np.float32)
    qual[:2] = (0.0, 1.0)  # the -100 clamp on both logs
    return {"qual": qual, "label": rng.randint(0, 2, 8).astype(np.float32), "rot": rot,
            "rotations": rots, "width_pred": rng.rand(8).astype(np.float32),
            "width": rng.rand(8).astype(np.float32),
            "logits": (rng.randn(8, 16) * 30).astype(np.float32),
            "occ": rng.randint(0, 2, (8, 16)).astype(np.float32)}


LOSS_CALLS = {
    "binary_cross_entropy": lambda L, a: L.binary_cross_entropy(a["qual"], a["label"]),
    "bce_with_logits": lambda L, a: L.bce_with_logits(a["logits"], a["occ"]),
    "quat_loss": lambda L, a: L.quat_loss(a["rot"], a["rotations"][:, 0]),
    "rot_loss": lambda L, a: L.rot_loss(a["rot"], a["rotations"]),
    "width_loss": lambda L, a: L.width_loss(a["width_pred"], a["width"]),
    "occ_loss": lambda L, a: L.occ_loss(a["logits"], a["occ"]),
    "giga_loss": lambda L, a: L.giga_loss(
        {"qual": a["qual"], "rot": a["rot"], "width": a["width_pred"], "occ": a["logits"]},
        {"label": a["label"], "rotations": a["rotations"], "width": a["width"], "occ": a["occ"]}),
    "giga_loss_no_occ": lambda L, a: L.giga_loss(
        {"qual": a["qual"], "rot": a["rot"], "width": a["width_pred"]},
        {"label": a["label"], "rotations": a["rotations"], "width": a["width"]}),
    "occ_only_loss": lambda L, a: L.occ_only_loss({"occ": a["logits"]}, {"occ": a["occ"]}),
    "classification_metrics": lambda L, a: L.classification_metrics(a["qual"], a["label"]),
}


def _flat(out):
    if isinstance(out, tuple):
        return _flat(out[0]) + _flat(out[1])
    if isinstance(out, dict):
        return [(k, np.asarray(v, np.float32)) for k, v in sorted(out.items())]
    return [("", np.asarray(out, np.float32))]


@pytest.mark.parametrize("fn", sorted(LOSS_CALLS))
def test_loss_matches_jax(fn):
    """Every loss and metric of train/loss.py within 1e-6 * (1 + |JAX's|)."""
    a = _loss_inputs()
    got = _flat(LOSS_CALLS[fn](TL, {k: torch.from_numpy(v) for k, v in a.items()}))
    ref = _flat(LOSS_CALLS[fn](JL, {k: jnp.asarray(v) for k, v in a.items()}))
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (k, g), (_, r) in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=TOL_LOSS_FN, rtol=TOL_LOSS_FN,
                                   err_msg=f"{fn} {k}")
    assert all(np.isfinite(g).all() for _, g in got)


# ---------------------------------------------------------------- train step

@pytest.mark.parametrize("name", ["giga", "giga_geo", "vgn"])
def test_train_step_matches_jax(name):
    """One fp32 step (mm sampler, JAX's default) on the same weights and
    batch: loss terms, gradients leaf by leaf, params after the step."""
    net, cfg = init_network(name, seed=1)
    jnet, jcfg, jstate = jax_state(name, net)
    b = batch(vgn=name == "vgn")
    loss_fn = jt.make_loss_fn(jt._with_sampler(jnet, jcfg, "mm"), jcfg)
    with jax.default_matmul_precision("highest"):
        (_, (jterms, _)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jstate.params, jax_batch(b))
    jstate, jterms_step = jt.make_train_step(jnet, jcfg)(jstate, jax_batch(b))

    state = tt.create_train_state(net, device="cpu")
    (_, (terms, _)), grads = tt.make_value_and_grad(net, cfg)(state.params,
                                                               tt.to_device(b, "cpu"))
    state, terms_step = tt.make_train_step(net, cfg)(state, b)

    assert set(terms_step) == set(jterms_step)
    for k in jterms_step:
        ref = float(jterms_step[k])
        assert abs(float(terms_step[k]) - ref) <= TOL_LOSS * (1 + abs(ref)), k
        if k in jterms:
            assert abs(float(terms[k]) - float(jterms[k])) <= TOL_LOSS * (1 + abs(ref)), k
    errs = leaf_errors(dict(zip(state.params, grads)),
                       flax_to_state_dict(jax.device_get(jgrads)))
    assert max(errs.values()) <= TOL_GRAD, sorted(errs.items(), key=lambda e: -e[1])[:3]
    assert param_error(state, jstate.params) <= TOL_PARAM
    assert state.step == 1 and int(state.tx.count) == 1


def test_mm_step_matches_gather():
    """The default sampler='mm' step reproduces the cfg's gather step
    (tests/test_train.py:147-177): losses within 1e-5, params within 5e-5."""
    net, cfg = init_network("giga", seed=3)
    b = batch(3)
    out = {}
    for sampler in ("mm", None):
        state = tt.create_train_state(init_network("giga", seed=3)[0], device="cpu")
        state, terms = tt.make_train_step(net, cfg, sampler=sampler)(state, b)
        out[sampler] = state, terms
    assert abs(float(out["mm"][1]["loss_all"]) - float(out[None][1]["loss_all"])) <= 1e-5
    for k, v in out["mm"][0].params.items():
        np.testing.assert_allclose(v.detach().numpy(), out[None][0].params[k].detach().numpy(),
                                   atol=TOL_PARAM, rtol=0, err_msg=k)


def test_bf16_step_gates():
    """dtype=bf16: fp32 master params and optimizer state, the forward in
    bf16 (every conv and decoder product sees bf16 weights), loss within
    3e-2 of the fp32 step's, and the loss falls over three more steps
    (tests/test_train.py:179-211)."""
    net, cfg = init_network("giga", seed=0)
    b = batch(0)
    s32, t32 = tt.make_train_step(net, cfg)(
        tt.create_train_state(init_network("giga", seed=0)[0], device="cpu"), b)
    s16 = tt.create_train_state(net, device="cpu")
    seen = set()

    def record(module, args):
        if isinstance(module, (torch.nn.Conv3d, torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            seen.add((args[0].dtype, module.weight.dtype))

    step16 = tt.make_train_step(net, cfg, dtype=torch.bfloat16)
    hook = torch.nn.modules.module.register_module_forward_pre_hook(record)
    try:
        s16, t16 = step16(s16, b)
    finally:
        hook.remove()
    assert seen == {(torch.bfloat16, torch.bfloat16)}
    assert abs(float(t16["loss_all"]) - float(t32["loss_all"])) < 3e-2
    assert all(p.dtype == torch.float32 for p in s16.params.values())
    assert all(m.dtype == torch.float32 for m in s16.tx.mu + s16.tx.nu)
    losses = [float(step16(s16, b)[1]["loss_all"]) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_bf16_forward_casts_query_points():
    """The bf16 loss casts tsdf, pos and pos_occ (its decoder outputs are
    those of bf16 points), and its head outputs reach the loss in fp32."""
    net, cfg = init_network("giga", seed=0)
    loss_fn = tt.make_loss_fn(net, cfg, dtype=torch.bfloat16)
    b = tt.to_device(batch(0), "cpu")
    params = dict(net.named_parameters())
    _, (terms, out) = loss_fn(params, b)
    assert all(v.dtype == torch.float32 for v in {**terms, **out}.values())
    with torch.no_grad():
        bf = {k: v.to(torch.bfloat16) for k, v in params.items()}
        ref = torch.func.functional_call(net, bf, (b["tsdf"].to(torch.bfloat16),
                                                   b["pos"][:, None].to(torch.bfloat16),
                                                   b["pos_occ"].to(torch.bfloat16)))
    assert torch.equal(out["occ"], ref["occ"].float())


def test_steps_leave_tf32_flags():
    """The fp32 step's full_precision scope and the bf16 step leave the
    process-wide TF32 flags as they found them."""
    net, cfg = init_network("giga_geo", seed=0)
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    state = tt.create_train_state(net, device="cpu")
    for dtype in (None, torch.bfloat16):
        tt.make_train_step(net, cfg, dtype=dtype)(state, batch(0))
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == before


def test_eval_step_matches_jax():
    net, cfg = init_network("giga", seed=2)
    jnet, jcfg, jstate = jax_state("giga", net)
    b = batch(5)
    ref = jt.make_eval_step(jnet, jcfg)(jstate.params, jax_batch(b))
    got = tt.make_eval_step(net, cfg)(dict(net.named_parameters()), b)
    assert set(got) == set(ref)
    for k in ref:
        assert abs(float(got[k]) - float(ref[k])) <= TOL_LOSS * (1 + abs(float(ref[k]))), k
    assert not any(v.requires_grad for v in got.values())


def test_summarize_metrics_equal():
    rng = np.random.RandomState(0)
    accum = [{"loss_all": np.float32(rng.rand()), "loss_qual": np.float32(rng.rand()),
              "tp": np.float32(rng.randint(5)), "fp": np.float32(rng.randint(5)),
              "fn": np.float32(rng.randint(5)), "correct": np.float32(rng.randint(9)),
              "n": np.float32(8 if i < 3 else 3)} for i in range(4)]
    assert tt.summarize_metrics(accum) == jt.summarize_metrics(accum)
    no_n = [{k: v for k, v in a.items() if k.startswith("loss")} for a in accum]
    assert tt.summarize_metrics(no_n) == jt.summarize_metrics(no_n)
    assert tt.summarize_metrics([]) == {}
    terms = [{k: torch.tensor(float(v)) for k, v in a.items()} for a in accum]
    assert tt.summarize_metrics(tt.fetch_terms(terms)) == jt.summarize_metrics(accum)


# ----------------------------------------------------------------- optimizer

def _optax_chain(params, **kw):
    """The optax transformation ``create_train_state`` builds with ``kw``."""
    jnet, jcfg = jax_get_network("giga_geo")
    return jt.create_train_state(_Preset(jnet, params), jcfg, None, **kw).tx


@pytest.mark.parametrize("kw", [{}, {"clip_norm": 1.0}, {"clip_norm": 0.05},
                                {"clip_norm": 1.0, "skip_nonfinite": True}],
                         ids=["adam", "clip", "clip_active", "clip_skip"])
def test_adam_matches_optax(kw):
    """Adam (with clip and skip) against optax's chain as create_train_state
    builds it, within 1e-6 on every step. With skip_nonfinite the gradients
    of steps 3..103 are non-finite: steps 3..102 move nothing (params, both
    moments, the count), and the 101st in a row is applied, as
    apply_if_finite(max_consecutive_errors=100) applies it."""
    rng = np.random.RandomState(0)
    shapes = {"a": (7, 3), "b": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = _optax_chain(params, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in shapes]
    adam = tt.Adam(tp, **kw)
    skip = kw.get("skip_nonfinite", False)
    bad = set(range(3, 104)) if skip else set()
    for i in range(105 if skip else 8):
        g = {k: (rng.randn(*s) * 0.1).astype(np.float32) for k, s in shapes.items()}
        if i in bad:
            g["a"][0, 0] = np.inf if i % 2 else np.nan
        before = [t.clone() for t in tp] + [t.clone() for t in adam.mu + adam.nu]
        count = int(adam.count)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        adam.update(tp, [torch.from_numpy(g[k]) for k in shapes])
        for t, k in zip(tp, shapes):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0,
                                       equal_nan=True, err_msg=f"step {i}")
        after = tp + adam.mu + adam.nu
        unchanged = all(torch.equal(x, y) for x, y in zip(before, after))
        assert unchanged == (i in bad and i < 103), i
        assert int(adam.count) == count + (not unchanged), i
    if skip:
        assert int(adam.notfinite_count) == 0 and int(adam.count) == 5


def test_skip_nonfinite_step_preserves_state():
    """A poisoned batch leaves params, both moments and the step count as
    they were, and training resumes on the next finite batch
    (tests/test_train.py:248-)."""
    net, cfg = init_network("giga", seed=0)
    state = tt.create_train_state(net, clip_norm=1.0, skip_nonfinite=True, device="cpu")
    step = tt.make_train_step(net, cfg)
    b = batch(0, b=2)
    state, terms = step(state, b)
    assert np.isfinite(float(terms["loss_all"]))
    snap = [t.detach().clone() for t in list(state.params.values()) + state.tx.mu + state.tx.nu]
    bad = dict(b, tsdf=b["tsdf"].copy())
    bad["tsdf"][0, 0, 0, 0] = np.nan
    state, terms_bad = step(state, bad)
    assert not np.isfinite(float(terms_bad["loss_all"]))
    now = list(state.params.values()) + state.tx.mu + state.tx.nu
    assert all(torch.equal(a, b) for a, b in zip(snap, now))
    assert int(state.tx.count) == 1 and state.step == 2
    state, terms2 = step(state, b)
    assert np.isfinite(float(terms2["loss_all"])) and int(state.tx.count) == 2


def test_mesh_paths_wait():
    net, cfg = init_network("giga_geo", seed=0)
    for make in (tt.make_train_step, tt.make_eval_step):
        with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
            make(net, cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tt.Trainer(net, cfg, None, mesh=object())


def test_full_precision_nests_in_fp32_step():
    """The fp32 step runs under full_precision, and may be called from
    inside a caller's own full_precision scope."""
    net, cfg = init_network("giga_geo", seed=0)
    state = tt.create_train_state(net, device="cpu")
    with full_precision():
        _, terms = tt.make_train_step(net, cfg)(state, batch(1))
    assert np.isfinite(float(terms["loss_all"]))
