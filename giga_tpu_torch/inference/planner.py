"""Grasp planners: TSDF in -> ranked grasps out, on the card
(counterpart of giga_tpu/inference/planner.py): ``GIGAPlanner`` and the
dense-CNN ``VGNPlanner``.

Two programs run encoding, the dense R^3 affordance decode, Gaussian
smoothing, surface masking, bounding, NMS and top-K; the host only turns the
top-K arrays into Grasp objects:
  * the single-scene program (``build_giga_planner_fn``), run by
    ``GIGAPlanner.__call__`` and ``plan_stream``; with ``use_kernels`` its
    decode runs kernel K3;
  * the batched program (``build_batched_giga_planner_fn``), run by
    ``plan_batch`` and PlannerService; with ``use_kernels`` it runs kernel
    K1 (stem + pool) and kernel K2 (dense-decode trunk);
  * the ensemble program (``build_ensemble_giga_planner_fn``), run by
    ``__call__`` and ``plan_stream`` of ``GIGAPlanner(params=[...])``: each
    member's single-scene encode and decode (K3), combined before one
    float32 postprocess.
Each program picks every stage's path when it is built, from the kernels'
shape predicates (``program_paths``): a kernel where it takes the shapes,
else the module path. The choice is ``plan.paths``; nothing gives way at
run time, and a kernel the predicate admits raises if its launch fails.
For CPU tensors the kernel wrappers run the kernels' plain versions.

Precision: the fp32 plan turns TF32 off for cuDNN convolutions and CUDA
matmuls while it runs (``full_precision``), the counterpart of the JAX
plan's ``default_matmul_precision("highest")`` pin. The flags are
process-wide; they are restored when the last running plan ends.

``GIGAPlanner(precision="bf16")`` serves the JAX package's bf16
configuration (its TPU program, ``_maybe_cast``): a bf16 copy of the net,
the network's TSDF input cast to bf16 inside the program, the kernels in
their bf16 modes (bf16 operands, float32 sums), and the heads, masking and
the rest of the postprocess in float32, still under ``full_precision``.
The program's precision is the net's parameter dtype.

VGN (``build_vgn_planner_fn``, ``build_batched_vgn_planner_fn``,
``VGNPlanner``): VGNNet's conv trunk and its three k=5 heads as one fused
6-channel conv (cuDNN on the card; no kernel of this package), then the
same postprocess with VGN's width window in voxel units and lattice indices
as positions. Its ``default`` precision runs the convs with TF32 on
(``tf32_precision``), the card's counterpart of the TPU's default matmul
pass that the JAX package's VGN plan runs at; ``highest`` runs them with
TF32 off; ``bf16`` runs a bf16 copy of the net. The postprocess always runs
in float32 under ``full_precision``.

With ``visualize=True`` both planners' ``__call__`` also returns the
scene mesh colored by the predicted grasp quality, with a gripper glyph per
grasp (``utils/visual.py``), and NMS takes a window of 8 voxels, as the
reference's does.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from giga_tpu_torch.core.config import GIGAConfig, PlannerConfig
from giga_tpu_torch.core.device import resolve_device
from giga_tpu_torch.core.grasp import Grasp
from giga_tpu_torch.core.precision import full_precision, tf32_precision
from giga_tpu_torch.core.transform import Rotation, Transform
from giga_tpu_torch.inference.dense_decode import (
    decode_affordance_dense,
    lattice_coords,
    sample_planes_on_lattice,
    sample_planes_on_lattice_batched,
)
from giga_tpu_torch.inference.postprocess import (
    GraspCandidates,
    bound_quality,
    mask_quality,
    select_grasps,
    select_grasps_batched,
)
from giga_tpu_torch.inference.serving import fetch_async
from giga_tpu_torch.models.conv_onet import GIGANet
from giga_tpu_torch.models.convert import flax_to_state_dict
from giga_tpu_torch.models.encoder import can_encode_fused, encode_planes_fused
from giga_tpu_torch.models.registry import get_network, load_network
from giga_tpu_torch.models.vgn import fused_head_conv
from giga_tpu_torch.ops.kernels.decoder import (
    can_dense_decode,
    decode_affordance_dense_kernel,
    decode_affordance_dense_kernel_batched,
)


class State(NamedTuple):
    """Planner input: a TSDF volume (``core.perception.TSDFVolume``, or any
    object with ``get_grid()``, ``size`` and ``voxel_size``) or a raw grid,
    plus optional extras."""

    tsdf: object
    pc: object = None
    tsdf_process: object = None


def lattice_positions(coords: torch.Tensor) -> torch.Tensor:
    x, y, z = torch.meshgrid(coords, coords, coords, indexing="ij")
    return torch.stack([x, y, z], dim=-1)


PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16}


def net_dtype(net) -> torch.dtype:
    """The dtype a program runs the network in: its parameters' dtype."""
    return next(net.parameters()).dtype


def voxel_indices(resolution: int, device) -> torch.Tensor:
    """(R,) float32 lattice indices 0 .. R-1: VGN's lattice coordinates."""
    return torch.arange(resolution, dtype=torch.float32, device=device)


class _Lattice:
    """The lattice coords (R,) and positions (R, R, R, 3), made once per
    device: a copy from host memory inside a program would wait for the
    card's queue. ``coords`` makes the (R,) coordinates on a device."""

    def __init__(self, resolution: int, coords=lattice_coords):
        self.resolution = resolution
        self._coords = coords
        self._by_device = {}

    def __call__(self, device):
        if device not in self._by_device:
            coords = self._coords(self.resolution, device)
            self._by_device[device] = (coords, lattice_positions(coords))
        return self._by_device[device]


def program_paths(model_cfg: GIGAConfig, planner_cfg: PlannerConfig, dtype: torch.dtype,
                  use_kernels: bool, batched: bool, fold_b1: bool = False) -> dict:
    """The path of each stage of a planning program, chosen from the
    kernels' shape predicates when the program is built: {"encode": "K1" or
    "module", "decode": "K2" (batched) or "K3" (single-scene) or "module"}.
    The single-scene programs encode with ``net.encode``, as the JAX
    package's do. A batch's size is not known at build time: the
    predicates are asked for one scene, and a batch a kernel cannot take
    (past 2^31 bf16 tiles) raises at its launch."""
    P, R = model_cfg.encoder.plane_resolution, planner_cfg.resolution
    dec = model_cfg.decoder
    paths = {"encode": "module", "decode": "module"}
    if not use_kernels:
        return paths
    if batched and can_encode_fused(model_cfg.encoder, (1, P, P, P), dtype):
        paths["encode"] = "K1"
    if can_dense_decode(1, R, 3, dec.hidden_size, 4, dec.n_blocks, dtype,
                        point_major=not batched, fold_b1=fold_b1 and batched):
        paths["decode"] = "K2" if batched else "K3"
    return paths


def _decode_single(dec: dict, feats: dict, coords: torch.Tensor, n_blocks: int,
                   dtype: torch.dtype, path: str):
    """One scene's float32 (qual, rot, width) on ``path``: K3 in the mode of
    ``dtype``, or the module path in ``dtype``, widened."""
    if path == "K3":
        return decode_affordance_dense_kernel(dec, feats, coords, n_blocks, dtype)
    return tuple(v.float() for v in decode_affordance_dense(dec, feats, coords, n_blocks))


def build_giga_planner_fn(net, model_cfg: GIGAConfig, planner_cfg: PlannerConfig,
                          size: float, use_kernels: bool = False, return_raw: bool = False):
    """Single-scene program: (tsdf (P,P,P), tsdf_process (R,R,R)) ->
    unbatched GraspCandidates (count a 0-d tensor), left on the tensors'
    device. It makes no synchronizing call once warm.

    It encodes with ``net.encode``, as the JAX package's single-scene
    program does. ``use_kernels`` decodes through K3 where K3 takes the
    shapes (``plan.paths``); the module path is the reference the kernel's
    program is checked against. A bf16 net runs the bf16 program: the TSDF
    cast to bf16 for the network, K3's bf16 mode, a float32 postprocess.
    ``return_raw`` makes the program return ``(cands, (qual, rot, width))``,
    the float32 volumes the candidates were selected from.

    In bf16 this is the counterpart of the JAX package's
    ``build_giga_planner_fn(use_pallas=True, dtype=bf16)``: K3's bf16 mode
    takes bf16 operands in its products but keeps their sums, the residual
    stream, the sigmoid and the quaternion norm in float32. JAX's
    ``GIGAPlanner(precision="bf16")`` builds its program without
    ``use_pallas``, so its ``__call__`` decodes with the XLA
    ``decode_affordance_dense``, all in bf16, on the TPU as on the CPU. The
    two bf16 programs are held together by tests/test_torch_bf16.py (raw
    qual within 4e-2 at most and 3e-3 at the median, and
    tests/test_bf16_serving.py's four decision gates) and on the card by
    chip_smoke.py against a golden file of JAX's ``__call__``.
    """
    voxel_size = size / planner_cfg.resolution
    R = planner_cfg.resolution
    P = model_cfg.encoder.plane_resolution
    n_blocks = model_cfg.decoder.n_blocks
    lattice = _Lattice(R)
    dtype = net_dtype(net)
    paths = program_paths(model_cfg, planner_cfg, dtype, use_kernels, batched=False)

    def plan(tsdf: torch.Tensor, tsdf_process: torch.Tensor) -> GraspCandidates:
        _check_single(tsdf, tsdf_process, P, R)
        coords, positions = lattice(tsdf.device)
        with torch.inference_mode(), full_precision():
            planes = {t: v[0] for t, v in net.encode(tsdf[None].to(dtype)).items()}
            feats = sample_planes_on_lattice(planes, coords, P, model_cfg.decoder.padding)
            qual, rot, width = _decode_single(net.decoder_aff.params(), feats, coords, n_blocks,
                                              dtype, paths["decode"])
            cands = _postprocess(qual, rot, width, tsdf_process, positions, voxel_size,
                                 planner_cfg)
            return (cands, (qual, rot, width)) if return_raw else cands

    plan.paths = paths
    return plan


def _check_single(tsdf: torch.Tensor, tsdf_process: torch.Tensor, P: int, R: int) -> None:
    if tuple(tsdf.shape) != (P, P, P):
        raise ValueError(f"expected a ({P}, {P}, {P}) TSDF grid, got {tuple(tsdf.shape)}")
    if tuple(tsdf_process.shape) != (R, R, R):
        raise ValueError(f"expected a ({R}, {R}, {R}) process grid, "
                         f"got {tuple(tsdf_process.shape)}")


def _postprocess(qual, rot, width, tsdf_process, positions, voxel_size: float,
                 planner_cfg: PlannerConfig) -> GraspCandidates:
    """One scene's float32 volumes -> its candidates: surface masking,
    bounding, NMS and top-K."""
    masked = mask_quality(qual, tsdf_process, width, planner_cfg)
    masked = bound_quality(masked, voxel_size, planner_cfg)
    return select_grasps(masked, rot, width, positions, planner_cfg)


def stack_params(states) -> dict:
    """Stack K members' state dicts ({name: tensor or array}, e.g. from
    ``flax_to_state_dict``) along a new leading ensemble axis: {name: (K, ...)}."""
    return {name: torch.stack([torch.as_tensor(sd[name]) for sd in states])
            for name in states[0]}


ENSEMBLE_COMBINES = ("mean", "max")


def combine_members(quals: torch.Tensor, rots: torch.Tensor, widths: torch.Tensor,
                    combine: str = "mean"):
    """K members' float32 volumes qual (K, ...), rot (K, ..., 4), width
    (K, ...) -> one (qual, rot, width).

    ``mean``: the mean probability; the quaternion mean with each voxel's
    quaternions sign-aligned to member 0's (q and -q are one rotation),
    renormalized; the mean width. ``max``: per voxel the largest quality,
    and rotation and width whole from the member that has it (the first
    such member on ties)."""
    if combine == "mean":
        sign = torch.sign(torch.sum(rots * rots[:1], dim=-1, keepdim=True))
        sign = torch.where(sign == 0, torch.ones_like(sign), sign)
        rot = (rots * sign).mean(dim=0)
        rot = rot / torch.clamp_min(torch.linalg.vector_norm(rot, dim=-1, keepdim=True), 1e-12)
        return quals.mean(dim=0), rot, widths.mean(dim=0)
    best = torch.argmax(quals, dim=0, keepdim=True)
    rot = torch.take_along_dim(rots, best[..., None], dim=0)[0]
    return quals.max(dim=0).values, rot, torch.take_along_dim(widths, best, dim=0)[0]


def build_ensemble_giga_planner_fn(net, stacked: dict, model_cfg: GIGAConfig,
                                   planner_cfg: PlannerConfig, size: float,
                                   combine: str = "mean", use_kernels: bool = False,
                                   return_raw: bool = False):
    """Ensemble-of-checkpoints program (counterpart of the JAX package's
    ``build_ensemble_giga_planner_fn``): (tsdf (P,P,P), tsdf_process
    (R,R,R)) -> unbatched GraspCandidates, ``return_raw`` as
    ``build_giga_planner_fn``'s.

    ``stacked`` holds the K members' parameters along a leading axis
    (``stack_params``) in the program's dtype; ``net`` is a GIGANet of the
    same configuration whose modules run each member's encoder with that
    member's parameters (``torch.func.functional_call``). Member by member
    the program encodes, samples the lattice and decodes it (K3 where K3
    takes the shapes, as ``build_giga_planner_fn``; so K launches a call),
    widens the volumes to float32, then combines them (``combine_members``)
    before the one float32 postprocess. A bf16 ``stacked`` runs each member
    in bf16, as the JAX package's ``dtype=bf16`` does."""
    if combine not in ENSEMBLE_COMBINES:
        raise ValueError(f"unknown ensemble combine {combine!r}")
    voxel_size = size / planner_cfg.resolution
    R = planner_cfg.resolution
    P = model_cfg.encoder.plane_resolution
    n_blocks = model_cfg.decoder.n_blocks
    lattice = _Lattice(R)
    dtype = stacked["decoder_aff.fc_p_kernel"].dtype
    paths = program_paths(model_cfg, planner_cfg, dtype, use_kernels, batched=False)
    K = stacked["decoder_aff.fc_p_kernel"].shape[0]

    def member(k: int, prefix: str) -> dict:
        # copies, not views: a kernel takes each weight 16-byte aligned
        return {n[len(prefix):]: v[k].clone() for n, v in stacked.items() if n.startswith(prefix)}

    members = [(member(k, "encoder."), member(k, "decoder_aff.")) for k in range(K)]

    def plan(tsdf: torch.Tensor, tsdf_process: torch.Tensor) -> GraspCandidates:
        _check_single(tsdf, tsdf_process, P, R)
        coords, positions = lattice(tsdf.device)
        with torch.inference_mode(), full_precision():
            x = tsdf[None].to(dtype)
            vols = []
            for enc, dec in members:
                planes = torch.func.functional_call(net.encoder, enc, (x,))
                feats = sample_planes_on_lattice({t: v[0] for t, v in planes.items()}, coords, P,
                                                 model_cfg.decoder.padding)
                vols.append(_decode_single(dec, feats, coords, n_blocks, dtype, paths["decode"]))
            qual, rot, width = combine_members(*(torch.stack(v) for v in zip(*vols)),
                                               combine=combine)
            cands = _postprocess(qual, rot, width, tsdf_process, positions, voxel_size,
                                 planner_cfg)
            return (cands, (qual, rot, width)) if return_raw else cands

    plan.paths = paths
    return plan


def build_batched_giga_planner_fn(net, model_cfg: GIGAConfig, planner_cfg: PlannerConfig,
                                  size: float, use_kernels: bool = False, fold_b1: bool = False,
                                  hidden_bf16: bool = False, return_raw: bool = False):
    """Batched serving program: (tsdfs (B,P,P,P), tsdf_process (B,R,R,R)) ->
    GraspCandidates with a leading batch axis, left on the tensors' device.

    P is the encoder's plane resolution, R the planner's lattice resolution.
    ``use_kernels`` runs K1 and K2 where they take the shapes
    (``plan.paths``); the module path (the counterpart of the JAX package's
    XLA path) is the reference the kernels' program is checked against. A bf16 net runs
    the bf16 program: the TSDFs cast to bf16 for the network, K1's and K2's
    bf16 modes, a float32 postprocess.

    ``fold_b1`` and ``hidden_bf16`` are the JAX package's ``pallas_fold_b1``
    and ``pallas_hidden_bf16``: K2's options (``hidden_bf16`` in bf16 only),
    applied on the kernels' path; the module path ignores them, as the
    JAX package's XLA path does. ``return_raw`` makes the program return
    ``(cands, (qual, rot, width))``, the float32 volumes the candidates were
    selected from, rot (B, 4, R^3) on the kernels' path and (B, R, R, R, 4)
    on the module path, as in the JAX package's Pallas and XLA paths. The
    candidates are the same either way. Without it the program returns the
    candidates alone, where the JAX package's returns ``(cands, None)``.
    """
    voxel_size = size / planner_cfg.resolution
    R = planner_cfg.resolution
    P = model_cfg.encoder.plane_resolution
    n_blocks = model_cfg.decoder.n_blocks
    lattice = _Lattice(R)
    dtype = net_dtype(net)
    paths = program_paths(model_cfg, planner_cfg, dtype, use_kernels, batched=True,
                          fold_b1=fold_b1)

    def plan(tsdfs: torch.Tensor, tsdf_process: torch.Tensor) -> GraspCandidates:
        if tsdfs.ndim != 4 or tuple(tsdfs.shape[1:]) != (P, P, P):
            raise ValueError(f"expected (B, {P}, {P}, {P}) TSDF grids, got {tuple(tsdfs.shape)}")
        if tuple(tsdf_process.shape) != (tsdfs.shape[0], R, R, R):
            raise ValueError(f"expected ({tsdfs.shape[0]}, {R}, {R}, {R}) process grids, "
                             f"got {tuple(tsdf_process.shape)}")
        coords, positions = lattice(tsdfs.device)
        with torch.inference_mode(), full_precision():
            if paths["encode"] == "K1":
                planes = encode_planes_fused(net.encoder, tsdfs.to(dtype))
            else:
                planes = net.encode(tsdfs.to(dtype))
            feats = sample_planes_on_lattice_batched(
                planes, coords, P, model_cfg.decoder.padding)
            if paths["decode"] == "K2":
                qual, rot, width = decode_affordance_dense_kernel_batched(
                    net.decoder_aff.params(), feats, coords, n_blocks, dtype, fold_b1=fold_b1,
                    hidden_bf16=hidden_bf16)
            else:
                qual, rot, width = (v.float() for v in
                                    net.decode_affordance_lattice(feats, coords))
            masked = mask_quality(qual, tsdf_process, width, planner_cfg)
            masked = bound_quality(masked, voxel_size, planner_cfg)
            cands = select_grasps_batched(masked, rot, width, positions, planner_cfg)
            return (cands, (qual, rot, width)) if return_raw else cands

    plan.paths = paths
    return plan


VGN_RESOLUTION = 40
VGN_WIDTHS = (1.33, 9.33)  # the reference VGN's width window, voxel units (detection.py:116-118)
VGN_PRECISIONS = ("default", "highest", "bf16")


def _vgn_scope(precision: str):
    """TF32 off for ``highest``, on for ``default`` (see the module docstring)."""
    return full_precision() if precision == "highest" else tf32_precision()


def _vgn_setup(planner_cfg: PlannerConfig, size: float, precision: str):
    """(planner config with VGN's width window, voxel size, lattice of
    indices) of a VGN program at ``precision``."""
    if precision not in ("default", "highest"):
        raise ValueError(f"precision must be 'default' or 'highest', got {precision!r}")
    cfg = dataclasses.replace(planner_cfg, min_width=VGN_WIDTHS[0], max_width=VGN_WIDTHS[1])
    return cfg, size / VGN_RESOLUTION, _Lattice(VGN_RESOLUTION, voxel_indices)


def build_vgn_planner_fn(net, planner_cfg: PlannerConfig, size: float,
                         precision: str = "default", return_raw: bool = False):
    """Single-scene VGN program (counterpart of the JAX package's
    ``build_vgn_planner_fn``): (tsdf (40,40,40), tsdf_process (40,40,40)) ->
    unbatched GraspCandidates, positions as lattice indices and widths in
    voxel units (reference detection.py), left on the tensors' device.

    The trunk and the fused head run in the net's dtype under ``precision``
    ("default": TF32 on; "highest": TF32 off); qual, rot and width are then
    cast to float32, and the postprocess runs in float32 with TF32 off.
    ``return_raw`` makes the program return ``(cands, (qual, rot, width))``,
    the float32 volumes, rot (40, 40, 40, 4).
    """
    cfg, voxel_size, lattice = _vgn_setup(planner_cfg, size, precision)
    dtype = net_dtype(net)
    R = VGN_RESOLUTION

    def plan(tsdf: torch.Tensor, tsdf_process: torch.Tensor) -> GraspCandidates:
        _check_single(tsdf, tsdf_process, R, R)
        _, positions = lattice(tsdf.device)
        with torch.inference_mode():
            with _vgn_scope(precision):
                x = net.trunk(tsdf[None].to(dtype))
                out = fused_head_conv(net, x)
            qual, rot, width = (v[0].float() for v in out)
            with full_precision():
                cands = _postprocess(qual, rot.reshape(4, -1), width, tsdf_process, positions,
                                     voxel_size, cfg)
            return (cands, (qual, rot.permute(1, 2, 3, 0), width)) if return_raw else cands

    return plan


def build_batched_vgn_planner_fn(net, planner_cfg: PlannerConfig, size: float,
                                 precision: str = "default"):
    """Batched VGN program (counterpart of the JAX package's
    ``build_batched_vgn_planner_fn``): (tsdfs (B,40,40,40), tsdf_process
    (B,40,40,40)) -> GraspCandidates with a leading batch axis, each scene's
    equal to ``build_vgn_planner_fn``'s. The trunk and fused head batch on
    the leading axis; qual and width are cast to float32 for the
    postprocess, and rot stays in the trunk's dtype until after the top-K
    gather, in the JAX program's order."""
    cfg, voxel_size, lattice = _vgn_setup(planner_cfg, size, precision)
    dtype = net_dtype(net)
    R = VGN_RESOLUTION

    def plan(tsdfs: torch.Tensor, tsdf_process: torch.Tensor) -> GraspCandidates:
        if tsdfs.ndim != 4 or tuple(tsdfs.shape[1:]) != (R, R, R):
            raise ValueError(f"expected (B, {R}, {R}, {R}) TSDF grids, got {tuple(tsdfs.shape)}")
        if tuple(tsdf_process.shape) != tuple(tsdfs.shape):
            raise ValueError(f"expected {tuple(tsdfs.shape)} process grids, "
                             f"got {tuple(tsdf_process.shape)}")
        _, positions = lattice(tsdfs.device)
        B = tsdfs.shape[0]
        with torch.inference_mode():
            with _vgn_scope(precision):
                qual, rot, width = fused_head_conv(net, net.trunk(tsdfs.to(dtype)))
            with full_precision():
                w32 = width.float()
                masked = mask_quality(qual.float(), tsdf_process, w32, cfg)
                masked = bound_quality(masked, voxel_size, cfg)
                return select_grasps_batched(masked, rot.reshape(B, 4, -1), w32, positions, cfg)

    return plan


def candidates_to_host(cands: GraspCandidates) -> GraspCandidates:
    """Fetch device candidates to numpy (the only wait on the card)."""
    return GraspCandidates(*(t.cpu().numpy() for t in cands))


def _as_batch(grids) -> np.ndarray:
    """Normalize (B, R, R, R) / (B, 1, R, R, R) / single (R, R, R) inputs to
    a float32 (B, R, R, R) array."""
    a = np.asarray(grids, np.float32)
    return a.reshape(-1, *a.shape[-3:])


def _is_volume(tsdf) -> bool:
    """A TSDF volume (``get_grid()``, ``size``, ``voxel_size``), not a grid."""
    return hasattr(tsdf, "get_grid")


def _get_grids(state: State, resolution: int, default_size: float):
    """Extract (tsdf_grid, process_grid, voxel_size, size) from a State whose
    ``tsdf`` (and ``tsdf_process``) is a TSDF volume or a grid array."""
    tsdf = state.tsdf
    if not _is_volume(tsdf):
        grid = np.asarray(tsdf)
        size = default_size
        voxel_size = size / resolution
        if state.tsdf_process is not None:
            tp = state.tsdf_process
            process_grid = tp.get_grid() if _is_volume(tp) else np.asarray(tp)
        else:
            process_grid = grid
    else:
        grid = tsdf.get_grid()
        size = tsdf.size
        tsdf_process = state.tsdf_process if state.tsdf_process is not None else tsdf
        voxel_size = tsdf_process.voxel_size
        process_grid = tsdf_process.get_grid()
    return np.squeeze(grid), np.squeeze(process_grid), voxel_size, size


def upload(grid, device: torch.device) -> torch.Tensor:
    """One (R, R, R) or (1, R, R, R) grid onto ``device``, through pinned
    memory without waiting for the card's queue."""
    a = np.asarray(grid, np.float32)
    t = torch.from_numpy(a.reshape(a.shape[-3:]))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _affordance_scene(raw, grasps, scores, scene_mesh, size: float, **aff_kwargs):
    """The scene mesh colored by the raw qual volume near its faces, with a
    gripper glyph per grasp (the JAX package's ``_affordance_scene``)."""
    from giga_tpu_torch.utils import visual

    qual, rot, width = (v.cpu().numpy() for v in raw)
    colored = visual.affordance_visual(qual, rot, scene_mesh, size, qual.shape[0], **aff_kwargs)
    return visual.compose_scene(colored, grasps, scores)


class GIGAPlanner:
    """VGNImplicit-equivalent host wrapper around the planning programs:
    ``__call__`` and ``plan_stream`` run the single-scene program (kernel
    K3 on the card), ``plan_batch`` and PlannerService the batched one (K1,
    K2). Both programs are built at first use, from the ``planner_cfg`` of
    that moment.

    __call__(state) -> (grasps, scores, toc): grasps in metric workspace
    coordinates, best-first when ``best`` else randomly permuted (reference:
    detection_implicit.py:62-76). ``device=None`` runs on the card and
    raises without one; pass ``device="cpu"`` to plan on the CPU.
    Weights come from ``model_path`` (.msgpack), a flax ``params`` tree, or
    a ready ``net``. ``precision="bf16"`` plans with a bf16 copy of the net,
    made once here (a ``net`` passed in is not changed), in both programs.

    ``visualize=True``: NMS takes a window of 8 voxels, and ``__call__(state,
    scene_mesh, aff_kwargs)`` returns ``(grasps, scores, toc, composed)``,
    ``composed`` the TriMesh of ``scene_mesh`` colored by the raw qual
    volume of the same program run (``utils.visual.affordance_visual``,
    ``aff_kwargs`` passed to it) with a gripper glyph per grasp.

    A list of flax ``params`` trees is a checkpoint ensemble (the JAX
    package's ``GIGAPlanner(params=[...])``): ``__call__`` and
    ``plan_stream`` run the ensemble program, its members combined by
    ``ensemble_combine`` ("mean" or "max"); the configuration is
    ``model_cfg``, else a passed ``net``'s, else ``model_type``'s.
    ``plan_batch`` and PlannerService raise NotImplementedError for an
    ensemble, as the JAX package's do.
    """

    def __init__(
        self,
        model_path=None,
        model_type: str = "giga",
        best: bool = False,
        force_detection: bool = False,
        qual_th: float = 0.9,
        out_th: float = 0.5,
        low_th: float = 0.5,
        resolution: int = 40,
        size: float = 0.3,
        max_grasps: int = 128,
        net=None,
        model_cfg=None,
        params=None,
        rng: Optional[np.random.RandomState] = None,
        visualize: bool = False,
        precision: str = "fp32",
        ensemble_combine: str = "mean",
        device=None,
    ):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
        self.ensemble = isinstance(params, (list, tuple))
        if self.ensemble and ensemble_combine not in ENSEMBLE_COMBINES:
            raise ValueError(f"unknown ensemble combine {ensemble_combine!r}")
        if net is not None and params is not None and not self.ensemble:
            raise ValueError("pass a loaded net or a params tree, not both")
        self.device = resolve_device(device)
        self.ensemble_combine = ensemble_combine
        self.stacked = None
        if self.ensemble:
            model_cfg = model_cfg or (net.cfg if net is not None else get_network(model_type)[1])
            states = [flax_to_state_dict(p) for p in params]
            net = GIGANet(model_cfg)
            net.load_state_dict(states[0])
            self.stacked = {k: v.to(self.device, PRECISIONS[precision])
                            for k, v in stack_params(states).items()}
        elif params is not None:
            net, model_cfg = get_network(model_type)
            net.load_state_dict(flax_to_state_dict(params))
        elif net is None:
            net, model_cfg = load_network(model_path, model_type)
        net = net.to(self.device).eval()
        if precision != "fp32":  # an ensemble's net is its own
            net = (net if self.ensemble else copy.deepcopy(net)).to(PRECISIONS[precision])
        self.net = net
        self.model_cfg = model_cfg if model_cfg is not None else net.cfg
        self.planner_cfg = PlannerConfig(
            resolution=resolution,
            qual_th=qual_th,
            out_th=out_th,
            low_th=low_th,
            force_detection=force_detection,
            best=best,
            max_grasps=max_grasps,
            # wider NMS when visualizing, like the reference
            # (detection_implicit.py:59 max_filter_size=8 if visualize)
            max_filter_size=8 if visualize else 4,
        )
        self.size = size
        self.rng = rng if rng is not None else np.random
        self.visualize = visualize
        self._fn = None
        self._vfn = None

    def _ensure_fn(self):
        """Build (once) the single-scene program of __call__ and plan_stream
        (the ensemble program for an ensemble); on the card its decode runs
        kernel K3 where K3 takes the shapes. With ``visualize`` it also
        returns the raw volumes."""
        if self._fn is None:
            if self.ensemble:
                self._fn = build_ensemble_giga_planner_fn(
                    self.net, self.stacked, self.model_cfg, self.planner_cfg, self.size,
                    combine=self.ensemble_combine, use_kernels=True, return_raw=self.visualize)
            else:
                self._fn = build_giga_planner_fn(
                    self.net, self.model_cfg, self.planner_cfg, self.size, use_kernels=True,
                    return_raw=self.visualize)
        return self._fn

    def _plan_single(self, grid: torch.Tensor, process_grid: torch.Tensor):
        """(candidates, raw volumes or None) of one scene's program run."""
        out = self._ensure_fn()(grid, process_grid)
        return out if self.visualize else (out, None)

    def _ensure_batched_fn(self):
        """Build (once) the batched program shared by plan_batch and
        PlannerService; on the card it runs kernels K1 and K2 where they
        take the shapes."""
        if self._vfn is None:
            if self.ensemble:
                raise NotImplementedError(
                    "batched serving of a checkpoint ensemble is not wired "
                    "up; plan scene-by-scene or serve the single best "
                    "checkpoint (ensembles cost K-fold compute)")
            self._vfn = build_batched_giga_planner_fn(
                self.net, self.model_cfg, self.planner_cfg, self.size, use_kernels=True)
        return self._vfn

    def _to_grasps(self, cands: GraspCandidates):
        return candidates_to_grasps(cands, scale=self.size, offset=0.5, width_scale=self.size,
                                    best=self.planner_cfg.best, rng=self.rng)

    def __call__(self, state: State, scene_mesh=None, aff_kwargs=None):
        grid, process_grid, _, size = _get_grids(state, self.planner_cfg.resolution, self.size)
        if abs(size - self.size) > 1e-9:
            # border margins and the metric width window derive from
            # self.size; a different state size would make them disagree
            raise ValueError(
                f"state TSDF size {size} != planner size {self.size}; "
                f"construct GIGAPlanner(size={size}) for this workspace"
            )
        self._ensure_fn()
        tic = time.time()
        cands, raw = self._plan_single(upload(grid, self.device),
                                       upload(process_grid, self.device))
        host = candidates_to_host(cands)
        toc = time.time() - tic
        grasps, scores = self._to_grasps(host)
        if self.visualize:
            composed = _affordance_scene(raw, grasps, scores, scene_mesh, size,
                                         **(aff_kwargs or {}))
            return grasps, scores, toc, composed
        return grasps, scores, toc

    def plan_stream(self, tsdf_grids, process_grids=None):
        """Plan a sequence of scenes one by one, hiding the fetch.

        Scene i's program is queued, and its candidates' copy to host memory
        queued behind it, before the host waits for scene i-1's copy; so the
        card runs scene i while the host builds scene i-1's Grasp objects.
        Results equal calling the planner per scene.

        Args:
            tsdf_grids: iterable of (R, R, R) or (1, R, R, R) grids.
            process_grids: optional sequence of the same length.
        Returns:
            list of (grasps, scores) per scene, in input order.
        """
        pending, out = deque(), []
        for i, grid in enumerate(tsdf_grids):
            g = upload(grid, self.device)
            p = g if process_grids is None else upload(process_grids[i], self.device)
            cands, _ = self._plan_single(g, p)
            pending.append(fetch_async(cands))
            if len(pending) > 1:
                out.append(self._collect(pending.popleft()))
        while pending:
            out.append(self._collect(pending.popleft()))
        return out

    def _collect(self, fetch):
        """Wait for one queued fetch (the only wait on the card) and build
        its Grasp objects."""
        cands, ready = fetch
        if ready is not None:
            ready.synchronize()
        return self._to_grasps(GraspCandidates(*(t.numpy() for t in cands)))

    def plan_batch(self, tsdf_grids, process_grids=None):
        """Plan a whole batch of scenes in one program.

        Args:
            tsdf_grids: (B, R, R, R) float32.
        Returns:
            list of (grasps, scores) per scene.
        """
        fn = self._ensure_batched_fn()
        grids = torch.from_numpy(_as_batch(tsdf_grids)).to(self.device)
        proc = grids if process_grids is None else torch.from_numpy(
            _as_batch(process_grids)).to(self.device)
        host = candidates_to_host(fn(grids, proc))
        return [self._to_grasps(GraspCandidates(*(x[i] for x in host)))
                for i in range(grids.shape[0])]


class VGNPlanner:
    """VGN-equivalent host wrapper (dense 3D CNN + the same postprocess;
    counterpart of the JAX package's ``VGNPlanner``): ``__call__`` runs the
    single-scene program, ``plan_batch`` the batched one, both built at
    first use.

    __call__(state) -> (grasps, scores, toc): grasps in metric workspace
    coordinates (lattice index x voxel size, reference detection.py:71),
    best-first when ``best`` else randomly permuted. It reads only
    ``state.tsdf`` (a 40^3 grid or TSDF volume, whose ``voxel_size`` then
    scales the grasps), as the reference does. ``precision``: "default"
    (convs with TF32 on the card), "highest" (TF32 off) or "bf16" (a bf16
    copy of the net, made once here). ``visualize=True`` as GIGAPlanner's.
    ``device=None`` runs on the card and raises without one; pass
    ``device="cpu"`` to plan on the CPU. Weights come from ``model_path``
    (.msgpack), a flax ``params`` tree, or a ready VGNNet ``net``.
    """

    def __init__(
        self,
        model_path=None,
        model_type: str = "vgn",
        best: bool = False,
        force_detection: bool = False,
        qual_th: float = 0.9,
        out_th: float = 0.5,
        size: float = 0.3,
        max_grasps: int = 128,
        net=None,
        params=None,
        rng: Optional[np.random.RandomState] = None,
        visualize: bool = False,
        precision: str = "default",
        device=None,
    ):
        if precision not in VGN_PRECISIONS:
            raise ValueError(f"precision must be one of {VGN_PRECISIONS}, got {precision!r}")
        if net is not None and params is not None:
            raise ValueError("pass a loaded net or a params tree, not both")
        self.device = resolve_device(device)
        if params is not None:
            net, _ = get_network(model_type)
            net.load_state_dict(flax_to_state_dict(params))
        elif net is None:
            net, _ = load_network(model_path, model_type)
        net = net.to(self.device).eval()
        if precision == "bf16":
            net = copy.deepcopy(net).to(torch.bfloat16)
        self.net = net
        self.precision = precision
        # the programs' TF32 scope; bf16 is the net's dtype
        self._scope = "highest" if precision == "highest" else "default"
        self.planner_cfg = PlannerConfig(
            qual_th=qual_th,
            out_th=out_th,
            force_detection=force_detection,
            best=best,
            max_grasps=max_grasps,
            # wider NMS when visualizing, like the reference
            # (detection.py:60 max_filter_size=8 if visualize)
            max_filter_size=8 if visualize else 4,
        )
        self.size = size
        self.rng = rng if rng is not None else np.random
        self.visualize = visualize
        self._fn = None
        self._vfn = None

    def _ensure_fn(self):
        """Build (once) the single-scene program of __call__."""
        if self._fn is None:
            self._fn = build_vgn_planner_fn(self.net, self.planner_cfg, self.size,
                                            precision=self._scope, return_raw=self.visualize)
        return self._fn

    def _ensure_batched_fn(self):
        """Build (once) the batched program of plan_batch."""
        if self._vfn is None:
            self._vfn = build_batched_vgn_planner_fn(self.net, self.planner_cfg, self.size,
                                                     precision=self._scope)
        return self._vfn

    def _to_grasps(self, cands: GraspCandidates, voxel_size: float):
        return candidates_to_grasps(cands, scale=voxel_size, offset=0.0, width_scale=voxel_size,
                                    best=self.planner_cfg.best, rng=self.rng)

    def __call__(self, state: State, scene_mesh=None, aff_kwargs=None):
        # a hi-res tsdf_process must neither mask the 40^3 volumes nor set
        # the voxel scale (reference detection.py:44-47)
        grid, _, _, _ = _get_grids(state, VGN_RESOLUTION, self.size)
        tsdf = state.tsdf
        voxel_size = tsdf.voxel_size if _is_volume(tsdf) else self.size / VGN_RESOLUTION
        fn = self._ensure_fn()
        tic = time.time()
        g = upload(grid, self.device)
        out = fn(g, g)
        cands, raw = out if self.visualize else (out, None)
        host = candidates_to_host(cands)
        toc = time.time() - tic
        grasps, scores = self._to_grasps(host, voxel_size)
        if self.visualize:
            composed = _affordance_scene(raw, grasps, scores, scene_mesh, self.size,
                                         **(aff_kwargs or {}))
            return grasps, scores, toc, composed
        return grasps, scores, toc

    def plan_batch(self, tsdf_grids, process_grids=None):
        """Plan a whole batch of VGN scenes in one program.

        Args:
            tsdf_grids: (B, 40, 40, 40) float32 ((B, 1, 40³) and a single
                grid are taken too).
        Returns:
            list of (grasps, scores) per scene, each equal to ``__call__``'s
            on a grid.
        """
        fn = self._ensure_batched_fn()
        grids = torch.from_numpy(_as_batch(tsdf_grids)).to(self.device)
        proc = grids if process_grids is None else torch.from_numpy(
            _as_batch(process_grids)).to(self.device)
        host = candidates_to_host(fn(grids, proc))
        voxel_size = self.size / VGN_RESOLUTION
        return [self._to_grasps(GraspCandidates(*(x[i] for x in host)), voxel_size)
                for i in range(grids.shape[0])]


def candidates_to_grasps(cands: GraspCandidates, scale, offset, width_scale, best, rng):
    """Top-K arrays -> ordered list of metric Grasp objects; metric position
    = (pos + offset) * scale: GIGA's (pos + 0.5) * size
    (detection_implicit.py:72), VGN's voxel index * voxel size
    (detection.py:71)."""
    count = int(cands.count)
    grasps, scores = [], []
    order = np.arange(count) if best else rng.permutation(count)
    for i in order:
        pos = (np.asarray(cands.positions[i], dtype=np.float64) + offset) * scale
        quat = np.asarray(cands.rotations[i], dtype=np.float64)
        width = float(cands.widths[i]) * width_scale
        grasps.append(Grasp(Transform(Rotation.from_quat(quat), pos), width))
        scores.append(float(cands.scores[i]))
    return grasps, np.asarray(scores)
