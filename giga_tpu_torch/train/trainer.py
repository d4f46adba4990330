"""Train step + training loop (counterpart of giga_tpu/train/trainer.py;
reference: scripts/train_giga*.py).

Optimizer: Adam(lr 2e-4), batch 32, 10 epochs by default. The JAX package
differentiates a pure loss of its parameter tree with ``jax.value_and_grad``;
here the loss runs the module through ``torch.func.functional_call`` on a
{name: tensor} dict of its parameters, and autograd takes the gradients of
those leaves. The step keeps everything on the device: the optimizer's
state, its step count and the returned loss terms are device tensors, and
nothing in a step waits for the card (``Trainer.fit`` fetches the terms once
an epoch). Checkpointing: params as flax ``.msgpack`` (last and best by
validation accuracy, like the reference's ignite ModelCheckpoint,
train_giga.py:97-117), plus params + optimizer state + epoch through
``train/checkpoint.py`` for resuming.

Data parallelism (``mesh=``, a ``parallel.mesh.Mesh``; one process per
card): every rank holds the same params and takes its shard of the global
batch (``shard_batch``). After the backward pass the ranks all-reduce the
gradients to their mean in ONE collective over one flat buffer (the step
is launch-bound; a reduction per leaf would add ~70 collectives a step),
before Adam's clip and non-finite skip, so every rank takes the same
decision and the params stay bit-identical across ranks. The loss terms
(batch means) are averaged over ranks and the classification counts summed,
in one more collective, so the step returns the global batch's terms on
every rank, as the JAX package's global program does. Mean-of-means equals
the global mean because the shards are equal (B must divide by the mesh
size). The gradient all-reduce is exact because no statistic crosses
samples on these paths: GroupNorm (models/unet3d.py) is per sample, and
PointNet++'s BatchNorm is not reached by ``make_loss_fn``. DDP is not
needed: the step takes gradients through ``torch.autograd.grad`` on a
params dict, not ``.backward()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from giga_tpu_torch.core.config import GIGAConfig, TrainConfig
from giga_tpu_torch.core.device import resolve_device, to_device
from giga_tpu_torch.core.precision import full_precision
from giga_tpu_torch.parallel import distributed
from giga_tpu_torch.train.loss import (
    binary_cross_entropy,
    classification_metrics,
    giga_loss,
    occ_only_loss,
    rot_loss,
)

# classification_metrics' counts: summed over ranks; every other term is a
# batch mean, averaged over ranks
COUNT_TERMS = ("tp", "fp", "fn", "correct", "n")
# optax.adam's defaults and apply_if_finite's limit as create_train_state sets it
B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 100


class Adam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8), optionally after
    ``optax.clip_by_global_norm(clip_norm)`` and inside
    ``optax.apply_if_finite(max_consecutive_errors=100)``, in optax's own
    arithmetic and order. optax's eps lies outside the square root, as
    torch.optim.Adam's does; this one is written out so that the skip of a
    non-finite step is a select on the device (no host sync) that leaves the
    params, both moments and the step count exactly as they were, and so that
    clipping scales by ``max_norm / norm`` as optax does (torch's
    ``clip_grad_norm_`` divides by ``norm + 1e-6``). Every state tensor lives
    on the params' device; the arithmetic runs as multi-tensor (``foreach``)
    kernels. ``lr`` is a number or, as an optax schedule, a function of the
    step count (a 0-d int32 device tensor, the count of steps applied before
    this one) that returns the rate as a 0-d tensor on the same device.
    """

    def __init__(self, params, lr: float = 2e-4, clip_norm: float | None = None,
                 skip_nonfinite: bool = False):
        params = list(params)
        self.lr, self.clip_norm, self.skip_nonfinite = lr, clip_norm, skip_nonfinite
        device = params[0].device
        self.mu = [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in params]
        self.nu = [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in params]
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=device)

    def _clip(self, grads):
        """optax.clip_by_global_norm: g where norm < max_norm, else
        (g / norm) * max_norm."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.clip_norm
        return [torch.where(keep, g, (g / norm) * self.clip_norm) for g in grads]

    @torch.no_grad()
    def update(self, params, grads) -> None:
        """One step on ``params`` (in place) from ``grads``."""
        params, grads = list(params), list(grads)
        if self.skip_nonfinite:
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            self.notfinite_count = torch.where(finite, torch.zeros_like(self.notfinite_count),
                                               self.notfinite_count + 1)
            apply = finite | (self.notfinite_count > MAX_CONSECUTIVE_ERRORS)
        if self.clip_norm is not None:
            grads = self._clip(grads)
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - B1), torch._foreach_mul(self.mu, B1))
        g2 = torch._foreach_mul(grads, grads)
        nu = torch._foreach_add(torch._foreach_mul(g2, 1 - B2), torch._foreach_mul(self.nu, B2))
        count = self.count + 1
        exponent = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full_like(exponent, B1), exponent)
        bc2 = 1 - torch.pow(torch.full_like(exponent, B2), exponent)
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), EPS)
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        step = torch._foreach_mul(torch._foreach_div(torch._foreach_div(mu, bc1), denom), -lr)
        new = torch._foreach_add(params, step)
        if self.skip_nonfinite:
            new = [torch.where(apply, a, b) for a, b in zip(new, params)]
            mu = [torch.where(apply, a, b) for a, b in zip(mu, self.mu)]
            nu = [torch.where(apply, a, b) for a, b in zip(nu, self.nu)]
            count = torch.where(apply, count, self.count)
        torch._foreach_copy_(params, new)
        self.mu, self.nu, self.count = list(mu), list(nu), count

    def state_dict(self) -> dict:
        return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count,
                "notfinite_count": self.notfinite_count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)
        self.count.copy_(state["count"])
        self.notfinite_count.copy_(state["notfinite_count"])


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """``optax.cosine_decay_schedule``: count -> init_value * ((1 - alpha) *
    0.5 * (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha), on
    the count's device (``Adam``'s schedule form)."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count.to(torch.float32), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


@dataclasses.dataclass
class TrainState:
    """The module (its parameters are the fp32 master weights), the
    optimizer and the number of steps taken."""

    module: nn.Module
    tx: Adam
    step: int = 0

    @property
    def params(self) -> dict:
        return dict(self.module.named_parameters())

    def apply_gradients(self, grads) -> "TrainState":
        self.tx.update(self.module.parameters(), grads)
        self.step += 1
        return self


def create_train_state(net: nn.Module, lr: float = 2e-4, clip_norm: float | None = None,
                       skip_nonfinite: bool = False, device=None) -> TrainState:
    """Train ``net`` from its current weights (a loaded checkpoint,
    ``init_network``'s seeded ones, or a JAX tree through ``convert.py``),
    moved to ``device`` (the card unless the caller asks for the CPU).

    ``clip_norm`` prepends global-norm gradient clipping to Adam, off by
    default (the reference trains with plain Adam). ``skip_nonfinite``
    skips steps with inf/NaN gradients instead of poisoning the params
    (clipping alone cannot save an inf gradient: 0 * inf = NaN inside the
    clip scale)."""
    net = net.to(resolve_device(device)).train().requires_grad_(True)
    return TrainState(net, Adam(net.parameters(), lr, clip_norm=clip_norm,
                                skip_nonfinite=skip_nonfinite))


def _cast_net_inputs(params, batch, dtype):
    """Mixed precision: cast params and NETWORK inputs to ``dtype``; targets
    (labels/rotations/widths/occ) stay fp32 so the loss reduces in fp32. The
    casts are differentiable, so gradients land in fp32 on the master leaves."""
    params = {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}
    batch = dict(batch)
    for k in ("tsdf", "pos", "pos_occ"):
        if batch.get(k) is not None:
            batch[k] = batch[k].to(dtype)
    return params, batch


def _out_f32(out: dict) -> dict:
    return {k: v.to(torch.float32) for k, v in out.items()}


def make_loss_fn(net, cfg, dtype=None) -> Callable:
    """Returns loss_fn(params, batch) -> (loss, (terms, outputs)), params a
    {name: tensor} dict of ``net``'s parameters.

    ``dtype=torch.bfloat16``: the forward pass runs in bf16 (GIGANet casts the
    TSDF to its parameters' dtype, which ``functional_call`` makes the bf16
    copies') but the head outputs are cast back to fp32 BEFORE any loss math:
    bf16's 8 mantissa bits saturate the probability-space BCE (a prob within
    ~2^-9 of 1 rounds to exactly 1, clamping log1p to -100 with zero
    gradient), so losses and targets stay fp32.
    """
    if not isinstance(cfg, GIGAConfig):
        return make_vgn_loss_fn(net, dtype)

    def loss_fn(params, batch):
        if dtype is not None:
            params, batch = _cast_net_inputs(params, batch, dtype)
        p = batch["pos"][:, None, :]  # (B, 1, 3)
        p_occ = batch.get("pos_occ")
        if cfg.tsdf_only:
            out = functional_call(net, params, (batch["tsdf"], None, p_occ))
            out = _out_f32({"occ": out["occ"]})
            loss, terms = occ_only_loss(out, batch)
        else:
            out = functional_call(net, params, (batch["tsdf"], p,
                                                p_occ if cfg.decoder_tsdf else None))
            out = {k: (v[:, 0] if k in ("qual", "width") else v) for k, v in out.items()}
            out["rot"] = out["rot"][:, 0]
            out = _out_f32(out)
            loss, terms = giga_loss(out, batch)
        return loss, (terms, out)

    return loss_fn


def make_vgn_loss_fn(net, dtype=None) -> Callable:
    """Dense VGN objective (reference: scripts/train_vgn.py:150-188): predict
    full volumes, select the labeled voxel, same composite loss but with
    unscaled width MSE (widths are in voxel units)."""

    def loss_fn(params, batch):
        if dtype is not None:
            params, batch = _cast_net_inputs(params, batch, dtype)
        qual, rot, width = (v.to(torch.float32)
                            for v in functional_call(net, params, (batch["tsdf"],)))
        idx = batch["index"].long()
        b = torch.arange(qual.shape[0], device=qual.device)
        i, j, k = idx[:, 0], idx[:, 1], idx[:, 2]
        q, w = qual[b, i, j, k], width[b, i, j, k]
        r = rot[b, :, i, j, k]  # VGNNet's rot is (B, 4, R, R, R)
        label = batch["label"]
        l_qual = binary_cross_entropy(q, label)
        l_rot = rot_loss(r, batch["rotations"])
        l_width = (w - batch["width"]) ** 2
        loss = (l_qual + label * (l_rot + 0.01 * l_width)).mean()
        terms = {"loss_qual": l_qual.mean(), "loss_rot": l_rot.mean(),
                 "loss_width": l_width.mean(), "loss_all": loss}
        return loss, (terms, {"qual": q, "rot": r, "width": w})

    return loss_fn


def _is_geo(cfg) -> bool:
    return isinstance(cfg, GIGAConfig) and cfg.tsdf_only


@torch.no_grad()
def _step_metrics(cfg, out, batch) -> dict:
    """Classification metrics: qual head for affordance models, occupancy
    accuracy for the geometry-only model (reference train_giga_geo selects
    the best checkpoint by occ_accuracy)."""
    if _is_geo(cfg):
        occ_prob = torch.sigmoid(out["occ"])
        return classification_metrics(occ_prob.reshape(-1), batch["occ"].reshape(-1))
    return classification_metrics(out["qual"], batch["label"])


def _with_sampler(net, cfg, sampler):
    """A module of ``net``'s class with ``DecoderConfig.sampler = sampler``,
    to run on ``net``'s parameters through ``functional_call``.

    Plane sampling is paramless, so parameters and optimizer states are
    interchangeable across samplers; the twin is built on the meta device
    and holds no weights. ``net`` itself for non-GIGA configs,
    ``sampler=None``, or when the cfg already matches."""
    if sampler is None or not isinstance(cfg, GIGAConfig):
        return net
    if getattr(cfg.decoder, "sampler", "gather") == sampler:
        return net
    cfg2 = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, sampler=sampler))
    with torch.device("meta"):
        return type(net)(cfg2)


def make_value_and_grad(net, cfg, dtype=None, sampler: Optional[str] = "mm") -> Callable:
    """fn(params, batch) -> ((loss, (terms, outputs)), grads): the counterpart
    of ``jax.value_and_grad(loss_fn, has_aux=True)`` that the train step
    runs, grads a tuple in ``params``' order. The fp32 form runs under
    ``full_precision`` (TF32 off), the JAX package's
    ``default_matmul_precision("highest")``; the bf16 form keeps the
    caller's TF32 setting, as JAX's bf16 step keeps the default precision."""
    loss_fn = make_loss_fn(_with_sampler(net, cfg, sampler), cfg, dtype=dtype)

    def value_and_grad(params, batch):
        scope = full_precision() if dtype is None else contextlib.nullcontext()
        with scope, torch.enable_grad():
            loss, (terms, out) = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, tuple(params.values()))
        detach = {k: v.detach() for k, v in terms.items()}
        return (loss.detach(), (detach, {k: v.detach() for k, v in out.items()})), grads

    return value_and_grad


def _reducer(mesh, axis: str):
    """(grads, terms) -> their means over the ranks along ``axis`` (counts
    summed): the identity without a mesh."""
    if mesh is None:
        return lambda grads, terms: (grads, terms)
    from giga_tpu_torch.parallel.mesh import all_reduce_sum

    n = mesh.size(axis)

    def reduce(grads, terms):
        grads = [g / n for g in all_reduce_sum(mesh, grads, axis)] if grads else grads
        keys = list(terms)
        summed = all_reduce_sum(mesh, [terms[k].to(torch.float32) for k in keys], axis)
        return grads, {k: v if k in COUNT_TERMS else v / n for k, v in zip(keys, summed)}

    return reduce


def _placer(mesh, axis: str):
    """batch, device -> the batch this rank computes on: its shard of the
    global batch with a mesh, else the whole batch uploaded in one copy."""
    if mesh is None:
        return to_device
    from giga_tpu_torch.parallel.mesh import shard_batch

    return lambda batch, device: shard_batch(mesh, batch, axis)


def make_train_step(net, cfg, mesh=None, axis: str = "dp", dtype=None,
                    assemble=None, sampler: Optional[str] = "mm") -> Callable:
    """step(state, batch) -> (state, terms): one Adam step, the state updated
    in place (the JAX step donates it), terms a dict of 0-d device tensors.

    ``sampler`` overrides the decoder's arbitrary-point plane sampling for
    the TRAINING step only (inference keeps each preset's shipped sampler).
    Training queries are arbitrary points (1 grasp + n_occ occupancy
    samples, reference train_giga.py:142-159), where the default 'gather'
    sampler pays 4 row-gathers a point forward and a scatter-add into the
    feature planes backward; 'mm' replaces both with dense matmuls. Pass
    ``sampler=None`` to keep the cfg's own sampler.

    ``dtype=torch.bfloat16`` selects mixed precision: master params,
    optimizer state and the update stay fp32; the forward/backward pass runs
    with bf16-cast params and inputs. Losses are reduced in fp32. Default
    (None) is fp32 with TF32 off.

    ``assemble``: optional ``(corpus, sel) -> batch`` hook. When given, the
    step has signature ``step(state, corpus, sel)`` and the batch is
    gathered and augmented on the device from the resident corpus
    (train/corpus.py); only the small ``sel`` index arrays are uploaded.

    A batch's numpy arrays are uploaded to the state's device in one copy
    (``to_device``); tensors already there are used as they are.

    ``mesh``: data parallelism over ``axis`` (module docstring): the batch
    is the global one (or this rank's ``shard_batch`` of it), the state is
    replicated, and the terms are the global batch's on every rank. With
    ``assemble`` the corpus is replicated (every rank holds it on its
    device) and ``sel`` is batch-sharded.
    """
    value_and_grad = make_value_and_grad(net, cfg, dtype, sampler)
    place, reduce = _placer(mesh, axis), _reducer(mesh, axis)

    def local_step(state: TrainState, batch):
        (loss, (terms, out)), grads = value_and_grad(state.params, batch)
        grads, terms = reduce(grads, {**terms, **_step_metrics(cfg, out, batch)})
        state.apply_gradients(grads)
        return state, terms

    if assemble is None:
        return lambda state, batch: local_step(state, place(batch, _device(state.module)))

    def corpus_step(state: TrainState, corpus: dict, sel):
        return local_step(state, assemble(corpus, place(sel, _device(state.module))))

    return corpus_step


def make_eval_step(net, cfg, mesh=None, axis: str = "dp",
                   sampler: Optional[str] = "mm") -> Callable:
    """step(params, batch) -> terms: the metrics pass, fp32 with TF32 off,
    no gradients. ``sampler`` as in make_train_step; ``mesh`` as there (the
    terms of the global batch on every rank)."""
    loss_fn = make_loss_fn(_with_sampler(net, cfg, sampler), cfg)
    place, reduce = _placer(mesh, axis), _reducer(mesh, axis)

    def step(params, batch):
        batch = place(batch, next(iter(params.values())).device)
        with full_precision(), torch.no_grad():
            loss, (terms, out) = loss_fn(params, batch)
            return reduce([], {**terms, **_step_metrics(cfg, out, batch)})[1]

    return step


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def summarize_metrics(accum: list[dict]) -> dict:
    """Average loss terms; derive accuracy/precision/recall from counts.

    Losses are averaged per SAMPLE when batch counts are available (each
    batch's mean loss weighted by its "n"); a plain per-batch mean would let
    a short last batch skew the epoch summary. Count-derived metrics are
    exact either way.
    """
    if not accum:
        return {}
    keys = accum[0].keys()
    tot = {k: float(np.sum([a[k] for a in accum])) for k in keys}
    n_batches = len(accum)
    if "n" in tot and tot["n"] > 0:
        out = {
            k: float(np.sum([a[k] * a["n"] for a in accum])) / tot["n"]
            for k in keys if k.startswith("loss")
        }
    else:
        out = {k: tot[k] / n_batches for k in keys if k.startswith("loss")}
    if "n" in tot and tot["n"] > 0:
        tp, fp, fn = tot.get("tp", 0), tot.get("fp", 0), tot.get("fn", 0)
        out["accuracy"] = tot["correct"] / tot["n"]
        out["precision"] = tp / max(tp + fp, 1e-9)
        out["recall"] = tp / max(tp + fn, 1e-9)
    return out


def fetch_terms(accum: list[dict]) -> list[dict]:
    """Device loss terms of many steps -> {name: np.float32} per step, in one
    copy to the host."""
    if not accum:
        return []
    keys = list(accum[0])
    flat = torch.stack([a[k].to(torch.float32) for a in accum for k in keys]).cpu().numpy()
    rows = flat.reshape(len(accum), len(keys))
    return [dict(zip(keys, row)) for row in rows]


@dataclasses.dataclass
class Trainer:
    """Epoch loop with validation, history and tensorboard logging, and
    last+best checkpointing. ``save_state`` also keeps params + optimizer
    state + epoch for ``try_resume`` (the JAX package's ``use_orbax``).

    With ``mesh`` every rank runs ``fit`` on the same global batches and
    keeps its shard (``_put``); the terms and so the logs agree on every
    rank. Only rank 0 writes tensorboard, the history and the checkpoints,
    and the ranks then wait for it (a barrier): the JAX single controller
    writes once, N ranks writing to one logdir would race. Every rank reads
    a checkpoint to resume."""

    net: object
    model_cfg: GIGAConfig
    train_cfg: TrainConfig
    mesh: object = None
    logdir: Optional[Path] = None
    save_state: bool = False
    dtype: object = None  # torch.bfloat16 -> mixed-precision train step

    def __post_init__(self):
        # eval stays fp32 so validation metrics are comparable across runs
        self.train_step = make_train_step(self.net, self.model_cfg, self.mesh, dtype=self.dtype)
        self.eval_step = make_eval_step(self.net, self.model_cfg, self.mesh)
        self.best_score = -np.inf
        self.ckpt_mgr = None
        self.start_epoch = 1
        self.tb_writer = None
        self.writes = self.mesh is None or distributed.is_primary()
        if self.logdir is not None:
            self.logdir = Path(self.logdir)
            self.logdir.mkdir(parents=True, exist_ok=True)
            from giga_tpu_torch.utils.tensorboard import SummaryWriter

            if self.writes:
                self.tb_writer = SummaryWriter(self.logdir)
            if self.save_state:
                from giga_tpu_torch.train.checkpoint import CheckpointManager

                self.ckpt_mgr = CheckpointManager(self.logdir / "state")

    def try_resume(self, state: TrainState) -> TrainState:
        """Resume from the latest saved state (params + optimizer + epoch)."""
        if self.ckpt_mgr is None:
            return state
        restored = self.ckpt_mgr.restore(state)
        if restored is None:
            return state
        state, metrics, epoch = restored
        self.start_epoch = epoch + 1
        self.best_score = metrics.get("best_score", -np.inf)
        print(f"resumed from epoch {epoch}")
        return state

    def _put(self, batch):
        """This rank's shard of a global batch with a mesh, else the batch."""
        if self.mesh is None:
            return batch
        from giga_tpu_torch.parallel.mesh import shard_batch

        return shard_batch(self.mesh, batch)

    def fit(self, state: TrainState, train_loader, val_loader, epochs: int, log=print):
        state = self.try_resume(state)
        history = self._load_history()
        for epoch in range(self.start_epoch, epochs + 1):
            t0 = time.time()
            # terms stay on the device: a host fetch a step would make every
            # step wait for the card; one fetch an epoch below
            accum = [self.train_step(state, self._put(batch))[1] for batch in train_loader]
            train_metrics = summarize_metrics(fetch_terms(accum))
            accum = [self.eval_step(state.params, self._put(batch)) for batch in val_loader]
            val_metrics = summarize_metrics(fetch_terms(accum))

            dt = time.time() - t0
            log(
                f"epoch {epoch} ({dt:.1f}s) "
                + " ".join(f"{k}={v:.4f}" for k, v in train_metrics.items())
                + " | val "
                + " ".join(f"{k}={v:.4f}" for k, v in val_metrics.items())
            )
            history.append({"epoch": epoch, "train": train_metrics, "val": val_metrics})

            if self.logdir is not None:
                if self.writes:
                    self._log_history(history)
                    self._log_tensorboard(epoch, train_metrics, val_metrics)
                    self._checkpoint(state, val_metrics, epoch)
                if self.mesh is not None:
                    distributed.barrier()
        if self.tb_writer is not None:
            self.tb_writer.close()  # guards double-close; releases the event file
        return state, history

    def _score(self, val_metrics):
        key = "accuracy" if "accuracy" in val_metrics else "loss_all"
        v = val_metrics.get(key, -np.inf)
        return v if key == "accuracy" else -v

    def _checkpoint(self, state: TrainState, val_metrics, epoch: int = 0):
        from giga_tpu_torch.models.registry import save_network

        name = getattr(self.model_cfg, "name", "model")
        save_network(state.module, self.logdir / f"{name}_last.msgpack")
        score = self._score(val_metrics)
        if score > self.best_score:
            self.best_score = score
            save_network(state.module, self.logdir / f"{name}_best.msgpack")
        if self.ckpt_mgr is not None:
            self.ckpt_mgr.save(epoch, state, {**val_metrics, "best_score": self.best_score})

    def _log_tensorboard(self, epoch, train_metrics, val_metrics):
        """TensorBoard scalar curves, same tags as the reference's
        SummaryWriter usage (reference scripts/train_giga.py:238-245)."""
        self.tb_writer.add_scalars({f"train/{k}": v for k, v in train_metrics.items()}, epoch)
        self.tb_writer.add_scalars({f"val/{k}": v for k, v in val_metrics.items()}, epoch)

    def _load_history(self):
        """Pre-resume epoch rows, so a resumed run's history.jsonl keeps its
        earlier curve instead of being truncated to post-resume epochs."""
        if self.logdir is None or self.start_epoch <= 1:
            return []
        path = self.logdir / "history.jsonl"
        if not path.exists():
            return []
        rows = [json.loads(line) for line in path.open() if line.strip()]
        return [r for r in rows if r.get("epoch", 0) < self.start_epoch]

    def _log_history(self, history):
        with (self.logdir / "history.jsonl").open("w") as f:
            for row in history:
                f.write(json.dumps(row) + "\n")
