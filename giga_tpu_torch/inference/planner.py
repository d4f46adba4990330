"""GIGA grasp planner: TSDF in -> ranked grasps out, on the card
(counterpart of giga_tpu/inference/planner.py, GIGA batched path).

One batched program runs encoding, the dense R^3 affordance decode,
Gaussian smoothing, surface masking, bounding, NMS and top-K; the host only
turns the top-K arrays into Grasp objects. With ``use_kernels`` the program
runs kernel K1 (stem + pool) and kernel K2 (dense-decode trunk); for CPU
tensors their wrappers run the kernels' plain versions.

Precision: the fp32 plan turns TF32 off for cuDNN convolutions and CUDA
matmuls while it runs (``full_precision``), the counterpart of the JAX
plan's ``default_matmul_precision("highest")`` pin. The flags are
process-wide; they are restored when the last running plan ends.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from giga_tpu_torch.core.config import GIGAConfig, PlannerConfig
from giga_tpu_torch.core.grasp import Grasp
from giga_tpu_torch.core.transform import Rotation, Transform
from giga_tpu_torch.inference.dense_decode import (
    lattice_coords,
    sample_planes_on_lattice_batched,
)
from giga_tpu_torch.inference.postprocess import (
    GraspCandidates,
    bound_quality,
    mask_quality,
    select_grasps_batched,
)
from giga_tpu_torch.models.convert import flax_to_state_dict
from giga_tpu_torch.models.encoder import can_encode_fused, encode_planes_fused
from giga_tpu_torch.models.registry import get_network, load_network
from giga_tpu_torch.ops.kernels.decoder import decode_affordance_dense_kernel_batched


class State(NamedTuple):
    """Planner input: a TSDFVolume (or raw grid) + optional extras."""

    tsdf: object
    pc: object = None
    tsdf_process: object = None


class _FullPrecision:
    """TF32 off for cuDNN convolutions and CUDA matmuls while any plan runs.

    The two flags are process-wide, and plans may run in several threads at
    once (a PlannerService worker beside a direct ``plan_batch``), so the
    first entrant saves and clears them and the last one out restores them.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._users = 0
        self._saved = None

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._users == 0:
                self._saved = (torch.backends.cudnn.allow_tf32,
                               torch.backends.cuda.matmul.allow_tf32)
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
            self._users += 1
        try:
            yield
        finally:
            with self._lock:
                self._users -= 1
                if self._users == 0:
                    (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32) = self._saved


full_precision = _FullPrecision()


def resolve_device(device) -> torch.device:
    """``None`` means the card; without one that is an error, not the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to plan on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def lattice_positions(coords: torch.Tensor) -> torch.Tensor:
    x, y, z = torch.meshgrid(coords, coords, coords, indexing="ij")
    return torch.stack([x, y, z], dim=-1)


def build_batched_giga_planner_fn(net, model_cfg: GIGAConfig, planner_cfg: PlannerConfig,
                                  size: float, use_kernels: bool = False):
    """Batched serving program: (tsdfs (B,P,P,P), tsdf_process (B,R,R,R)) ->
    GraspCandidates with a leading batch axis, left on the tensors' device.

    P is the encoder's plane resolution, R the planner's lattice resolution.
    ``use_kernels`` runs K1 and K2; without it the program runs the module
    path (the counterpart of the JAX package's XLA path), which serves as
    the reference the kernels' program is checked against.
    """
    voxel_size = size / planner_cfg.resolution
    R = planner_cfg.resolution
    P = model_cfg.encoder.plane_resolution
    n_blocks = model_cfg.decoder.n_blocks
    lattice = {}  # device -> (coords, positions)

    def plan(tsdfs: torch.Tensor, tsdf_process: torch.Tensor) -> GraspCandidates:
        if tsdfs.ndim != 4 or tuple(tsdfs.shape[1:]) != (P, P, P):
            raise ValueError(f"expected (B, {P}, {P}, {P}) TSDF grids, got {tuple(tsdfs.shape)}")
        if tuple(tsdf_process.shape) != (tsdfs.shape[0], R, R, R):
            raise ValueError(f"expected ({tsdfs.shape[0]}, {R}, {R}, {R}) process grids, "
                             f"got {tuple(tsdf_process.shape)}")
        if tsdfs.device not in lattice:
            coords = lattice_coords(R, tsdfs.device)
            lattice[tsdfs.device] = (coords, lattice_positions(coords))
        coords, positions = lattice[tsdfs.device]
        with torch.inference_mode(), full_precision():
            if use_kernels and can_encode_fused(model_cfg.encoder, tsdfs.shape):
                planes = encode_planes_fused(net.encoder, tsdfs)
            else:
                planes = net.encode(tsdfs)
            feats = sample_planes_on_lattice_batched(
                planes, coords, P, model_cfg.decoder.padding)
            if use_kernels:
                qual, rot, width = decode_affordance_dense_kernel_batched(
                    net.decoder_aff.params(), feats, coords, n_blocks)
            else:
                qual, rot, width = net.decode_affordance_lattice(feats, coords)
            masked = mask_quality(qual, tsdf_process, width, planner_cfg)
            masked = bound_quality(masked, voxel_size, planner_cfg)
            return select_grasps_batched(masked, rot, width, positions, planner_cfg)

    return plan


def candidates_to_host(cands: GraspCandidates) -> GraspCandidates:
    """Fetch device candidates to numpy (the only wait on the card)."""
    return GraspCandidates(*(t.cpu().numpy() for t in cands))


def _as_batch(grids) -> np.ndarray:
    """Normalize (B, R, R, R) / (B, 1, R, R, R) / single (R, R, R) inputs to
    a float32 (B, R, R, R) array."""
    a = np.asarray(grids, np.float32)
    return a.reshape(-1, *a.shape[-3:])


def _get_grids(state: State, resolution: int, default_size: float):
    """Extract (tsdf_grid, process_grid, voxel_size, size) from a State."""
    tsdf = state.tsdf
    if isinstance(tsdf, np.ndarray):
        grid = tsdf
        size = default_size
        voxel_size = size / resolution
        if state.tsdf_process is not None:
            tp = state.tsdf_process
            process_grid = tp if isinstance(tp, np.ndarray) else tp.get_grid()
        else:
            process_grid = grid
    else:
        grid = tsdf.get_grid()
        size = tsdf.size
        tsdf_process = state.tsdf_process if state.tsdf_process is not None else tsdf
        voxel_size = tsdf_process.voxel_size
        process_grid = tsdf_process.get_grid()
    return np.squeeze(grid), np.squeeze(process_grid), voxel_size, size


class GIGAPlanner:
    """VGNImplicit-equivalent host wrapper around the batched program.

    __call__(state) -> (grasps, scores, toc): grasps in metric workspace
    coordinates, best-first when ``best`` else randomly permuted (reference:
    detection_implicit.py:62-76). ``device=None`` runs on the card and
    raises without one; pass ``device="cpu"`` to plan on the CPU.
    Weights come from ``model_path`` (.msgpack), a flax ``params`` tree, or
    a ready ``net``.
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
        device=None,
    ):
        if precision != "fp32":
            raise NotImplementedError(f"precision={precision!r}: only fp32 is ported")
        if isinstance(params, (list, tuple)):
            raise NotImplementedError("checkpoint ensembles are not ported")
        if visualize:
            raise NotImplementedError("affordance visualization is not ported")
        if net is not None and params is not None:
            raise ValueError("pass a loaded net or a params tree, not both")
        self.device = resolve_device(device)
        if params is not None:
            net, model_cfg = get_network(model_type)
            net.load_state_dict(flax_to_state_dict(params))
        elif net is None:
            net, model_cfg = load_network(model_path, model_type)
        self.net = net.to(self.device).eval()
        self.model_cfg = model_cfg if model_cfg is not None else net.cfg
        self.planner_cfg = PlannerConfig(
            resolution=resolution,
            qual_th=qual_th,
            out_th=out_th,
            low_th=low_th,
            force_detection=force_detection,
            best=best,
            max_grasps=max_grasps,
            max_filter_size=4,
        )
        self.size = size
        self.rng = rng if rng is not None else np.random
        self._vfn = None

    def _ensure_batched_fn(self):
        """Build (once) the batched program shared by __call__, plan_batch
        and PlannerService; on the card it runs kernels K1 and K2."""
        if self._vfn is None:
            self._vfn = build_batched_giga_planner_fn(
                self.net, self.model_cfg, self.planner_cfg, self.size, use_kernels=True)
        return self._vfn

    def _to_grasps(self, cands: GraspCandidates):
        return candidates_to_grasps(cands, scale=self.size, offset=0.5, width_scale=self.size,
                                    best=self.planner_cfg.best, rng=self.rng)

    def __call__(self, state: State):
        grid, process_grid, _, size = _get_grids(state, self.planner_cfg.resolution, self.size)
        if abs(size - self.size) > 1e-9:
            # border margins and the metric width window derive from
            # self.size; a different state size would make them disagree
            raise ValueError(
                f"state TSDF size {size} != planner size {self.size}; "
                f"construct GIGAPlanner(size={size}) for this workspace"
            )
        fn = self._ensure_batched_fn()
        tic = time.time()
        tsdf = torch.from_numpy(_as_batch(grid)).to(self.device)
        proc = torch.from_numpy(_as_batch(process_grid)).to(self.device)
        host = candidates_to_host(fn(tsdf, proc))
        toc = time.time() - tic
        grasps, scores = self._to_grasps(GraspCandidates(*(x[0] for x in host)))
        return grasps, scores, toc

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


def candidates_to_grasps(cands: GraspCandidates, scale, offset, width_scale, best, rng):
    """Top-K arrays -> ordered list of metric Grasp objects; metric position
    = (pos + offset) * scale (detection_implicit.py:72)."""
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
