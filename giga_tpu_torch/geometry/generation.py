"""Occupancy-to-mesh generation on the card (counterpart of
giga_tpu/geometry/generation.py; reference ConvONets/conv_onet/generation.py
Generator3D, the GIGA-relevant paths: dense or refined evaluation ->
iso-surface extraction -> unit-cube vertex mapping).

The occupancy field is decoded on the device by programs that end in a
compact surface band: the flat ids of the cells whose corners straddle the
threshold and their 8 corner values in float16, in static buffers, fetched
to the host in one copy and triangulated there by the native sparse
marching kernel (geometry/native.py):

  * the band program (``strategy="dense"``): the occupancy decoder on the
    whole (n, n, n) lattice (inference/dense_decode.py's lattice-factorized
    decode), rounded to float16, padded with -6e4 so the surface closes at
    the boundary, then the band; ``generate_meshes`` runs it on a batch;
  * the refine chain (``strategy="refine"``): a dense decode at
    ``resolution0`` only, then per level the straddling cells dilated by
    one (6-neighbourhood), a trilinear upsample, the fine lattice points
    touching active cells compacted and decoded at those points
    (``decode_lattice_points``) and scattered back, then the band of the
    final grid; in two budget tiers, single and batched.

Neither makes a synchronizing call: compaction is a prefix sum over the
mask and a scatter into a static buffer (``compact_mask``), so the one fetch
is the only wait. Its budgets, overflow rules and outputs are the JAX
package's: a band past ``band_cells`` falls back to the full-grid decode and
``extract_mesh``, a refine tier past its budgets to the next tier and then
to the host's hierarchical ``refine_grid``; ``stats`` records the path.
A grid model (giga_grid) samples its feature grid trilinearly on the
lattice (``lattice_features``), and under ``strategy="refine"`` refines on
the host's ``refine_grid``, scene by scene, as the JAX package does.

The band program's lattice decode (and the full-grid fallback's) runs
kernel K2 (ops/kernels/decoder.py's ``dense_decode_batched``, one launch a
program, batched or single) where the model has triplanes, the decode is
float32 and K2 takes the shapes (``can_dense_decode``), chosen once when
the generator is built (``band_decode``): the occupancy head's one output
is padded with exact zeros to the kernel's four, and channel 0 read back.
Otherwise, and in the refine chain, it decodes on the module path
(inference/dense_decode.py's PyTorch ops): a grid model (its features are
one dense volume), bf16 (the JAX package's meshing decode is XLA's, whose
bf16 numerics K2's bf16 mode does not share). On CPU tensors K2's wrapper
runs its plain version. The JAX package decodes its meshing lattice with
XLA throughout; K2 sums the same terms in another order (~1e-6 a logit).

Every program runs under ``full_precision`` (TF32 off), the counterpart of
the JAX package's float32 decode. ``precision="bf16"`` decodes with the
decoder's weights and the planes in bf16, as the JAX package does; the
encode and the postprocess stay float32.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from giga_tpu_torch.core.device import resolve_device, to_device
from giga_tpu_torch.core.precision import full_precision
from giga_tpu_torch.geometry.mesh import TriMesh
from giga_tpu_torch.geometry.native import (
    marching_tetrahedra,
    marching_tetrahedra_cells,
    simplify_mesh,
)
from giga_tpu_torch.geometry.refine import refine_grid
from giga_tpu_torch.inference.dense_decode import (
    decode_dense,
    decode_dense_batched,
    decode_lattice_points,
    lattice_features,
    lattice_features_batched,
)
from giga_tpu_torch.models.conv_onet import GIGANet
from giga_tpu_torch.models.convert import flax_to_state_dict
from giga_tpu_torch.ops.kernels.decoder import (
    KERNEL_O,
    can_dense_decode,
    dense_decode_batched,
    prepare_projections_batched,
)
from giga_tpu_torch.ops.sampling import linspace_f32
from giga_tpu_torch.utils.profiling import next_call, span

OUTSIDE = -6.0e4     # float16-safe "outside" fill of the band's boundary pad
GRID_OUTSIDE = -1e6  # extract_mesh's float64 boundary pad


def fetch(*tensors) -> list:
    """Copy the outputs of a program to the host in one wait: every copy is
    queued into pinned memory behind the program, then one event is waited
    on. Returns numpy arrays."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    if tensors[0].device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(tensors[0].device))
        ready.synchronize()
    return [h.numpy() for h in host]


def _mesh_counts(meshes) -> dict:
    """A ``meshgen.marching`` span's counts of a batch's meshes."""
    return {"meshes": len(meshes), "vertices": sum(len(m.vertices) for m in meshes),
            "faces": sum(len(m.faces) for m in meshes)}


def compact_mask(mask: torch.Tensor, k_half: int, k: int, sort: bool = False):
    """Flat indices of the True cells of a cubic 3D mask, without a sync:
    the outputs of the JAX package's ``compact_mask_anchored``, element for
    element, overflow included.

    Returns (idx (k,) int32 with 0 fill, count, anchor_count). The lattice
    is cut into 2x2x2 blocks (anchors); ``anchor_count`` counts the blocks
    holding a True cell, and the cells of the first ``k_half`` of those,
    taken anchor by anchor, each block's cells in (x, y, z) order, are the
    ones listed: ``count`` of them, the first k in ``idx``. They are all
    the True cells only if count <= k and anchor_count <= k_half; callers
    check both, so the port falls back on the same masks as JAX. With
    ``sort`` the listed ids ascend (``jnp.nonzero``'s order when complete).

    JAX compacts with ``jnp.nonzero(size=)``, twice. Here one prefix sum over
    the mask in anchor order ranks the listed cells, and one scatter puts
    each into a static buffer at its rank, every other cell into a slot of
    its own past the k kept (no two writes meet)."""
    P = mask.shape[0]
    ph = (P + 1) // 2
    e = 2 * ph - P
    dev = mask.device

    def blocks(t):  # (2ph)^3 -> (ph^3, 8): anchors in flat order, cells (x, y, z)-lex
        return t.reshape(ph, 2, ph, 2, ph, 2).permute(0, 2, 4, 1, 3, 5).reshape(ph ** 3, 8)

    cells = blocks(F.pad(mask.to(torch.uint8), (0, e, 0, e, 0, e)))
    anchors = (cells.sum(1, dtype=torch.int32) > 0).to(torch.int32)
    listed = cells.bool() & (torch.cumsum(anchors, 0, dtype=torch.int32) <= k_half)[:, None]
    listed = listed.reshape(-1)
    rank = torch.cumsum(listed, 0, dtype=torch.int32)
    count = rank[-1]
    ar = torch.arange(2 * ph, device=dev)
    flat = blocks(((ar[:, None, None] * P + ar[None, :, None]) * P
                   + ar[None, None, :]).to(torch.int32)).reshape(-1)
    N = flat.numel()
    target = torch.where(listed & (rank <= k), rank.long() - 1,
                         torch.arange(k, k + N, device=dev))
    buf = torch.zeros(k + N, dtype=torch.int32, device=dev)
    buf.scatter_(0, target, flat)
    idx = buf[:k]
    if sort:
        valid = torch.arange(k, device=dev) < count
        idx = torch.sort(torch.where(valid, idx, torch.iinfo(torch.int32).max)).values
        idx = torch.where(valid, idx, 0)
    return idx, count, anchors.sum(dtype=torch.int32)


def _fold_overflow(count: torch.Tensor, anchors: torch.Tensor, k: int) -> torch.Tensor:
    """Fold an anchor-budget overflow into the count (count undercounts then),
    so one ``count <= k`` test on the host judges both budgets."""
    return torch.maximum(count, torch.where(anchors > k // 2, k + 1, 0).to(count.dtype))


def straddle_cells(g: torch.Tensor, th: float) -> torch.Tensor:
    """(n-1)^3 bool: cells of an n^3 lattice whose corners straddle ``th``."""
    n = g.shape[0]
    ins = (g > th).to(torch.int32)
    s = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                v = ins[dx:n - 1 + dx, dy:n - 1 + dy, dz:n - 1 + dz]
                s = v if s is None else s + v
    return (s > 0) & (s < 8)


def dilate6(a: torch.Tensor) -> torch.Tensor:
    """Binary dilation by the 6-neighbourhood (scipy's ``binary_dilation``
    with its default structure, one iteration)."""
    n = a.shape[0]
    ap = F.pad(a.to(torch.uint8), (1, 1, 1, 1, 1, 1)) > 0
    d = a
    for ax in range(3):
        lo = [slice(1, n + 1)] * 3
        hi = [slice(1, n + 1)] * 3
        lo[ax] = slice(0, n)
        hi[ax] = slice(2, n + 2)
        d = d | ap[tuple(lo)] | ap[tuple(hi)]
    return d


def upsample_double(g: torch.Tensor) -> torch.Tensor:
    """Trilinear (m+1)^3 -> (2m+1)^3 lattice values, axis by axis in the
    order of geometry/refine.py's ``_upsample_double``."""
    for ax in range(3):
        a = g.movedim(ax, 0)
        mid = 0.5 * (a[:-1] + a[1:])
        body = torch.stack([a[:-1], mid], 1).reshape((-1,) + a.shape[1:])
        g = torch.cat([body, a[-1:]], 0).movedim(0, ax)
    return g


def touched_points(active: torch.Tensor) -> torch.Tensor:
    """(2m+1)^3 bool: the fine lattice points touching an active coarse cell
    of the (m, m, m) mask (cell c covers fine points 2c + {0, 1, 2}^3)."""
    m = active.shape[0]
    P = 2 * m + 1
    t = active.new_zeros((P + 2,) * 3)
    t[2:2 * m + 2:2, 2:2 * m + 2:2, 2:2 * m + 2:2] = active
    for ax in range(3):  # the 3x3x3 box is separable: 3 shifts along each axis
        sl = [slice(None)] * 3
        out = None
        for o in (0, 1, 2):
            sl[ax] = slice(2 - o, 2 - o + P)
            v = t[tuple(sl)]
            out = v if out is None else out | v
        pad = [0, 0, 0, 0, 0, 0]
        pad[2 * (2 - ax)] = 2
        t = F.pad(out.to(torch.uint8), pad) > 0
    return t[2:, 2:, 2:]


def emit_band(gp: torch.Tensor, k: int, th: float):
    """The surface band of a padded lattice ``gp`` ((n+2)^3): (cell ids (k,)
    int32 into its (n+1)^3 cells, ascending, 0 fill; corner values (k, 8)
    float16 in cube-corner order, bit 0 -> +x, 1 -> +y, 2 -> +z; count with
    the anchor overflow folded in)."""
    C = gp.shape[0] - 1
    idx, count, anchors = compact_mask(straddle_cells(gp, th), k // 2, k, sort=True)
    i = idx.long()
    x, y, z = i // (C * C), (i // C) % C, i % C
    vals = torch.stack([gp[x + (ci & 1), y + ((ci >> 1) & 1), z + ((ci >> 2) & 1)]
                        for ci in range(8)], dim=-1)
    return idx, vals.to(torch.float16), _fold_overflow(count, anchors, k)


def scatter_valid(g: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                  count: torch.Tensor) -> torch.Tensor:
    """g with g.flat[idx[j]] = vals[j] for the valid slots j < count only:
    the fill slots are sent past the end and dropped, so lattice point 0
    keeps its decoded value when it is itself a valid point."""
    n = g.numel()
    k = idx.shape[0]
    slot = torch.arange(k, device=g.device)
    target = torch.where(slot < count, idx.long(), n + slot)
    flat = torch.cat([g.reshape(-1), g.new_zeros(k)])
    flat.scatter_(0, target, vals.to(g.dtype))
    return flat[:n].view(g.shape)


class MeshGenerator:
    """Generates scene meshes from a GIGA model's occupancy decoder.

    Args:
        net: a GIGANet with an occupancy head (its weights are used unless
            ``params``, a flax tree as ``load_params`` gives, is passed).
        threshold: occupancy probability iso level (default 0.5 like the
            reference's log-odds transform at generation.py:110).
        resolution0 / upsampling_steps: base grid + refinement levels.
        points_batch_size: query chunk of ``eval_occ_logits``
            (generation.py:42).
        strategy: "dense", "refine", or "auto" (dense while the final
            lattice is at most 128 cells a side).
        precision: "fp32" or "bf16" (the decodes' weights and planes).
        device: where the programs run; None means the card.
    """

    def __init__(self, net, params=None, threshold: float = 0.5, resolution0: int = 32,
                 upsampling_steps: int = 2, points_batch_size: int = 100000,
                 padding: float = 0.0, simplify_nfaces: int | None = None,
                 refinement_step: int = 0, strategy: str = "auto",
                 precision: str = "fp32", device=None):
        self.device = resolve_device(device)
        if params is not None:
            net = GIGANet(net.cfg)
            net.load_state_dict(flax_to_state_dict(params))
        self.net = net.to(self.device).eval()
        self.cfg = net.cfg
        self.threshold = float(threshold)
        self.logit_th = float(np.log(self.threshold) - np.log(1.0 - self.threshold))
        self.resolution0 = resolution0
        self.upsampling_steps = upsampling_steps
        self.points_batch_size = points_batch_size
        self.padding = padding
        self.box_size = 1.0 + padding
        self.simplify_nfaces = simplify_nfaces
        self.refinement_step = refinement_step
        final_res = resolution0 * (2**upsampling_steps)
        if strategy == "auto":
            strategy = "dense" if final_res <= 128 else "refine"
        if strategy not in ("dense", "refine"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.strategy = strategy
        if precision not in ("fp32", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.compute_dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        self.band_cells = 49152  # static device->host band buffer (cells)
        # refine-chain budgets, the JAX package's: the finest level ~12x the
        # straddle-shell density seen at 128^3, 4x less a coarser level
        top_cells = min(65536, (final_res // 2 + 1) ** 3)
        self.refine_fine_cells = min(131072, 8 * top_cells)
        self.refine_point_cells = tuple(
            min((resolution0 * 2**lvl + 1) ** 3,
                max(32768, (12 * top_cells) >> (2 * (upsampling_steps - lvl))))
            for lvl in range(1, upsampling_steps + 1))
        # the half-budget tier first; the full tier only on its overflow
        self._refine_tiers = (
            [(self.refine_fine_cells // 2, tuple(k // 2 for k in self.refine_point_cells)),
             (self.refine_fine_cells, self.refine_point_cells)]
            if upsampling_steps >= 1 else [])
        self._planes = None
        self._coords = {}
        self._dec = {k: v.detach().to(self.compute_dtype)
                     for k, v in self.net.decoder_occ.params().items()}
        dec = self.cfg.decoder
        self.band_decode = (
            "K2" if ("grid" not in self.cfg.encoder.plane_types
                     and self.compute_dtype == torch.float32
                     and can_dense_decode(1, self.final_n, 1, dec.hidden_size, KERNEL_O,
                                          dec.n_blocks))
            else "module")
        if self.band_decode == "K2":  # the head's one output padded to K2's four
            pad = KERNEL_O - self._dec["fc_out_bias"].shape[-1]
            self._dec_k2 = {**self._dec,
                            "fc_out_kernel": F.pad(self._dec["fc_out_kernel"], (0, pad)),
                            "fc_out_bias": F.pad(self._dec["fc_out_bias"], (0, pad))}
        self.marks = None  # a list to record CUDA events at stage ends (profiling)
        self.batch_stats = []

    # ------------------------------------------------------------------ programs

    @property
    def final_n(self) -> int:
        return self.resolution0 * (2**self.upsampling_steps) + 1

    def coords(self, n: int) -> torch.Tensor:
        """(n,) float32 lattice coordinates on the device, made once."""
        if n not in self._coords:
            b = self.box_size / 2
            self._coords[n] = torch.from_numpy(linspace_f32(-b, b, n)).to(self.device)
        return self._coords[n]

    def _mark(self, name: str) -> None:
        if self.marks is not None and self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))

    def _cast(self, planes: dict) -> dict:
        return {t: v.to(self.compute_dtype) for t, v in planes.items()}

    def _lattice_feats(self, planes: dict, coords: torch.Tensor) -> dict:
        return lattice_features(planes, coords, self.cfg)

    @property
    def _device_refine(self) -> bool:
        """Whether the refine chain runs on the device: it has a tier, and
        the model has triplanes (the JAX package refines a grid model on
        the host)."""
        return bool(self._refine_tiers) and "grid" not in self.cfg.encoder.plane_types

    @property
    def decode_path(self) -> str:
        """The path of a scene's lattice decodes, as its stats record it:
        ``band_decode`` under ``strategy="dense"``, the module path in the
        refine chain."""
        return self.band_decode if self.strategy == "dense" else "module"

    def _decode_batched(self, planes: dict, coords: torch.Tensor) -> torch.Tensor:
        """The band program's decode: cast planes {t: (B, H, W, C)} -> float32
        occupancy logits (B, n, n, n) on the ``band_decode`` path."""
        n, n_blocks = coords.shape[0], self.cfg.decoder.n_blocks
        feats = lattice_features_batched(planes, coords, self.cfg)
        if self.band_decode == "K2":
            out = dense_decode_batched(*prepare_projections_batched(self._dec_k2, feats, coords,
                                                                    n_blocks))
            return out[:, 0].reshape(-1, n, n, n)
        return decode_dense_batched(self._dec, feats, coords, n_blocks)[0, ..., 0]

    def _dense_logits(self, planes: dict, n: int) -> torch.Tensor:
        """One scene's occupancy logits on the (n, n, n) lattice, float16."""
        return self._decode_batched(self._cast(planes), self.coords(n))[0].to(torch.float16)

    def dense_program(self, planes: dict) -> torch.Tensor:
        """The full-grid program: float16 logits on the final lattice."""
        with torch.no_grad(), full_precision():
            return self._dense_logits(planes, self.final_n)

    def band_program(self, planes: dict):
        """The band program: (cell ids (K,) int32, corner values (K, 8)
        float16, count) of the final lattice, K = ``band_cells``."""
        with torch.no_grad(), full_precision():
            g = F.pad(self._dense_logits(planes, self.final_n).float(), (1,) * 6,
                      value=OUTSIDE)
            out = emit_band(g, self.band_cells, self.logit_th)
            self._mark("band")
            return out

    def band_program_batched(self, grids: torch.Tensor):
        """The batched band program: (B, R, R, R) TSDFs -> per-scene (ids
        (B, K), values (B, K, 8), counts (B,)), encode included. The lattice
        decode is one K2 launch on the ``band_decode`` path, else the module
        path's ops. As in the JAX package, the threshold test reads the
        decode's own float32 values (not rounded to float16 first) and the
        corner values are rounded after."""
        with torch.no_grad(), full_precision():
            planes = self._cast(self.net.encode(grids.float()))
            self._mark("encode")
            logits = self._decode_batched(planes, self.coords(self.final_n))
            self._mark("decode")
            out = [emit_band(F.pad(g, (1,) * 6, value=OUTSIDE), self.band_cells, self.logit_th)
                   for g in logits]
            self._mark("band")
            return tuple(torch.stack(v) for v in zip(*out))

    def _chain(self, planes: dict, K_f: int, K_ps: tuple):
        """The refine chain of one scene on its cast planes {t: (H, W, C)}:
        (band ids, band values, band count, per-level point counts (S,))."""
        n_blocks = self.cfg.decoder.n_blocks
        coords0 = self.coords(self.resolution0 + 1)
        g = decode_dense(self._dec, self._lattice_feats(planes, coords0), coords0,
                         n_blocks)[0, ..., 0].float()
        self._mark("dense")
        counts_p = []
        for lvl in range(1, self.upsampling_steps + 1):
            K_p = K_ps[lvl - 1]
            active = dilate6(straddle_cells(g, self.logit_th))
            g = upsample_double(g)
            P = g.shape[0]
            pidx, count_p, anchors = compact_mask(touched_points(active), K_p // 2, K_p)
            counts_p.append(_fold_overflow(count_p, anchors, K_p))
            self._mark(f"mask{lvl}")
            i = pidx.long()
            coords = self.coords(P)
            vals = decode_lattice_points(self._dec, self._lattice_feats(planes, coords), coords,
                                         i // (P * P), (i // P) % P, i % P, n_blocks)[0, :, 0]
            g = scatter_valid(g, pidx, vals.float(), count_p)
            self._mark(f"level{lvl}")
        out = emit_band(F.pad(g, (1,) * 6, value=OUTSIDE), K_f, self.logit_th)
        self._mark("band")
        return (*out, torch.stack(counts_p))

    def refine_program(self, planes: dict, tier: int):
        """The refine chain at budget tier ``tier`` on encoded planes."""
        K_f, K_ps = self._refine_tiers[tier]
        with torch.no_grad(), full_precision():
            return self._chain(self._cast({t: v[0] for t, v in planes.items()}), K_f, K_ps)

    def refine_program_batched(self, grids: torch.Tensor, tier: int):
        """The refine chain of a batch of TSDFs, encode included: each
        output stacked over the scenes."""
        K_f, K_ps = self._refine_tiers[tier]
        with torch.no_grad(), full_precision():
            planes = self._cast(self.net.encode(grids.float()))
            self._mark("encode")
            out = [self._chain({t: v[b] for t, v in planes.items()}, K_f, K_ps)
                   for b in range(grids.shape[0])]
            return tuple(torch.stack(v) for v in zip(*out))

    # --------------------------------------------------------------- entry points

    def upload(self, grids: np.ndarray) -> torch.Tensor:
        """Host TSDF grids on the device, one pinned asynchronous copy."""
        return to_device({"g": np.ascontiguousarray(grids, np.float32)}, self.device)["g"]

    def encode(self, tsdf_grid: np.ndarray) -> dict:
        """(R, R, R) or (1, R, R, R) TSDF -> cached feature planes."""
        grid = np.squeeze(np.asarray(tsdf_grid, np.float32))
        with torch.no_grad():
            self._planes = self.net.encode(self.upload(grid[None]))
        self._mark("encode")
        return self._planes

    def eval_occ_logits(self, points: np.ndarray) -> np.ndarray:
        """(N, 3) points in [-0.5, 0.5] -> (N,) occupancy logits, decoded in
        chunks zero-padded to one size (``points_batch_size`` at most)."""
        if self._planes is None:
            raise RuntimeError("call encode() first")
        n = len(points)
        if n == 0:
            return np.zeros(0, np.float32)
        cs = min(self.points_batch_size, max(16384, 1 << int(np.ceil(np.log2(n)))))
        outs = []
        for s in range(0, n, cs):
            chunk = np.asarray(points[s:s + cs], np.float32)
            pad = cs - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, 3), np.float32)])
            with torch.no_grad():
                logits = self.net.decode_occupancy(self._planes, self.upload(chunk)[None])
            out = logits[0].cpu().numpy()
            outs.append(out[:cs - pad] if pad else out)
        return np.concatenate(outs)

    def generate_meshes(self, tsdf_grids: np.ndarray) -> list:
        """Batched reconstruction: (B, R, R, R) TSDFs -> list of B meshes.

        The same surface as ``generate_mesh`` per scene, the decode and band
        of the whole batch in one program and one fetch. The refine chain
        runs its half-budget tier on the batch; a scene past a budget falls
        back alone (past the band budget, or to the full tier). Each
        scene's stats are in ``batch_stats``.

        Traced (utils/profiling.py) as sibling spans of one call:
        ``meshgen.upload`` (``bytes``), ``meshgen.enqueue`` (the band or
        refine program's launches; ``k2``, its K2 launches), ``meshgen.fetch`` and
        ``meshgen.marching`` (the per-scene triangulation and any fallback;
        ``meshes``, ``vertices``, ``faces``, ``fallbacks``). A model refined
        on the host has the last alone."""
        grids = np.asarray(tsdf_grids, np.float32)
        if grids.ndim != 4:
            raise ValueError(f"expected (B, R, R, R) grids, got {grids.shape}")
        B = grids.shape[0]
        call = next_call()
        if self.strategy == "refine" and not self._device_refine:
            self.batch_stats = []
            meshes = []
            with span("meshgen.marching", call) as s:
                for g in grids:
                    mesh, stats = self.generate_mesh(g)
                    meshes.append(mesh)
                    self.batch_stats.append(stats)
                if s:
                    s.count(**_mesh_counts(meshes), fallbacks=B)
            return meshes
        with span("meshgen.upload", call, bytes=grids.nbytes):
            dev = self.upload(grids)
        refine = self.strategy == "refine"
        with span("meshgen.enqueue", call) as s:
            launched = dense_decode_batched.launches
            out = self.refine_program_batched(dev, 0) if refine else self.band_program_batched(dev)
            if s:
                s.count(k2=dense_decode_batched.launches - launched)
        with span("meshgen.fetch", call):
            ids, vals, counts, *counts_p = fetch(*out)
        if refine:
            K_f, K_ps = self._refine_tiers[0]
            counts_p = counts_p[0]
            fits = [int(counts[b]) <= K_f and all(int(c) <= k for c, k in zip(counts_p[b], K_ps))
                    for b in range(B)]
            fallback = {"_min_tier": 1}
            ok = [{"path": "refine (device)", "refine (device)": True, "refine tier": 0,
                   "refine cells (band/points-per-level)": (
                       int(counts[b]), tuple(int(c) for c in counts_p[b]))} for b in range(B)]
        else:
            fits = [int(counts[b]) <= self.band_cells for b in range(B)]
            fallback = {}
            ok = [{"path": "band"} for _ in range(B)]
        for stats in ok:
            stats["decode"] = self.decode_path
        meshes, self.batch_stats = [], []
        with span("meshgen.marching", call) as s:
            for b in range(B):
                if fits[b]:
                    cnt = int(counts[b])
                    stats = ok[b]
                    meshes.append(self._mesh_from_band(ids[b, :cnt], vals[b, :cnt], stats))
                else:  # past a budget: this scene alone, on the exact fallback
                    mesh, stats = self.generate_mesh(grids[b], **fallback)
                    meshes.append(mesh)
                self.batch_stats.append(stats)
            if s:
                s.count(**_mesh_counts(meshes), fallbacks=B - sum(fits))
        return meshes

    def generate_mesh(self, tsdf_grid: np.ndarray, return_stats: bool = True,
                      _min_tier: int = 0):
        """TSDF grid -> (mesh in [-0.5, 0.5]^3 coords[, stats dict]).

        ``_min_tier``: first refine-budget tier to attempt (the batched path
        passes 1 after the half tier already overflowed)."""
        stats = {"decode": self.decode_path}
        t0 = time.perf_counter()
        self.encode(tsdf_grid)
        stats["time (encode inputs)"] = time.perf_counter() - t0
        mesh = None
        if self.strategy == "dense":
            t0 = time.perf_counter()
            idx, vals, count = fetch(*self.band_program(self._planes))
            count = int(count)
            stats["time (eval points)"] = time.perf_counter() - t0
            if count <= self.band_cells:
                stats["path"] = "band"
                mesh = self._mesh_from_band(idx[:count], vals[:count], stats)
            else:  # band overflow: exact fallback through the full grid
                t0 = time.perf_counter()
                (grid,) = fetch(self.dense_program(self._planes))
                stats["time (eval points)"] += time.perf_counter() - t0
                stats["path"] = "full grid"
                mesh = self.extract_mesh(grid.astype(np.float64), stats)
        else:
            t0 = time.perf_counter()
            tiers = len(self._refine_tiers) if self._device_refine else 0
            for tier in range(_min_tier, tiers):
                K_f, K_ps = self._refine_tiers[tier]
                ids, vals, count_f, counts_p = fetch(*self.refine_program(self._planes, tier))
                if int(count_f) <= K_f and all(int(c) <= k for c, k in zip(counts_p, K_ps)):
                    stats["time (eval points)"] = time.perf_counter() - t0
                    stats["path"] = "refine (device)"
                    stats["refine (device)"] = True
                    stats["refine tier"] = tier
                    stats["refine cells (band/points-per-level)"] = (
                        int(count_f), tuple(int(c) for c in counts_p))
                    cf = int(count_f)
                    mesh = self._mesh_from_band(ids[:cf], vals[:cf], stats)
                    break
            if mesh is None:  # every tier past its budget: the exact host path
                t0 = time.perf_counter()

                def eval_fn(frac_points):
                    # fractions in [0, 1] -> box coords in [-box/2, box/2]
                    return self.eval_occ_logits(
                        self.box_size * (frac_points.astype(np.float32) - 0.5))

                grid = refine_grid(eval_fn, self.resolution0, self.upsampling_steps,
                                   self.logit_th)
                stats["time (eval points)"] = time.perf_counter() - t0
                stats["path"] = "refine (host)"
                mesh = self.extract_mesh(grid, stats)
        return (mesh, stats) if return_stats else mesh

    # ------------------------------------------------------------------- host side

    def _mesh_from_band(self, cell_ids, corner_vals, stats: dict) -> TriMesh:
        """Triangulate a band (padded-lattice cell ids + float16 corner
        values) with the sparse marching kernel."""
        t0 = time.perf_counter()
        n = self.final_n
        verts, faces = marching_tetrahedra_cells(
            cell_ids.astype(np.int64), corner_vals.astype(np.float64), (n + 2,) * 3,
            self.logit_th)
        stats["time (marching cubes)"] = time.perf_counter() - t0
        verts = (verts - 1.0) / (n - 1)  # undo padding, [0, 1]
        verts = self.box_size * (verts - 0.5)
        return self._postprocess(TriMesh(verts, faces), stats)

    def extract_mesh(self, value_grid: np.ndarray, stats: dict) -> TriMesh:
        """Triangulate a full (n, n, n) grid of logits, padded with -1e6 so
        the surface closes at the boundary."""
        t0 = time.perf_counter()
        padded = np.pad(value_grid, 1, mode="constant", constant_values=GRID_OUTSIDE)
        verts, faces = marching_tetrahedra(padded, self.logit_th)
        stats["time (marching cubes)"] = time.perf_counter() - t0
        n = value_grid.shape[0]
        verts = (verts - 1.0) / (n - 1)  # undo padding, [0, 1]
        verts = self.box_size * (verts - 0.5)
        return self._postprocess(TriMesh(verts, faces), stats)

    def _postprocess(self, mesh: TriMesh, stats: dict) -> TriMesh:
        if self.simplify_nfaces is not None and len(mesh.faces) > self.simplify_nfaces:
            t0 = time.perf_counter()
            mesh = TriMesh(*simplify_mesh(mesh, self.simplify_nfaces))
            stats["time (simplify)"] = time.perf_counter() - t0
        if self.refinement_step > 0 and len(mesh.vertices):
            t0 = time.perf_counter()
            mesh = self.refine_mesh(mesh, self.refinement_step)
            stats["time (refine)"] = time.perf_counter() - t0
        return mesh

    # ---------------------------------------------------- gradients of the field

    def _occ_logits(self, points: torch.Tensor) -> torch.Tensor:
        return self.net.decode_occupancy(self._planes, points[None])[0]

    def estimate_normals(self, vertices: np.ndarray) -> np.ndarray:
        """Outward unit normals from the occupancy-field gradient at the
        vertices (reference generation.py:430-455): n = -grad / |grad|."""
        if self._planes is None:
            raise RuntimeError("call encode() first")
        with torch.enable_grad():
            pts = torch.tensor(np.asarray(vertices, np.float32), device=self.device,
                               requires_grad=True)
            (g,) = torch.autograd.grad(self._occ_logits(pts).sum(), pts)
        g = g.cpu().numpy()
        return -g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)

    def refine_loss(self, verts: torch.Tensor, faces: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
        """The vertex-refinement loss (reference generation.py:457-519): the
        face points at barycentric ``weights`` (F, 3) pulled onto the
        decision boundary, the face normals onto the field's gradient."""
        tri = verts[faces]  # (F, 3, 3)
        pts = torch.einsum("fk,fkd->fd", weights, tri)
        logits = self._occ_logits(pts)
        loss_target = ((torch.sigmoid(logits) - 0.5) ** 2).mean()
        (grad,) = torch.autograd.grad(logits.sum(), pts, create_graph=True)
        n_pred = grad / (torch.linalg.vector_norm(grad, dim=-1, keepdim=True) + 1e-9)
        fn = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        fn = fn / (torch.linalg.vector_norm(fn, dim=-1, keepdim=True) + 1e-9)
        loss_normal = ((fn + n_pred) ** 2).sum(-1).mean()
        return loss_target + 0.01 * loss_normal

    def refine_step(self, verts: torch.Tensor, nu: torch.Tensor, faces: torch.Tensor,
                    weights: torch.Tensor, lr: float, decay: float = 0.9, eps: float = 1e-8):
        """One RMSprop step of the loss on the vertices -> (verts, nu): optax's
        ``rmsprop(lr)`` with its defaults (nu from 0, no bias correction, eps
        inside the root): nu = (1 - decay) g^2 + decay nu, v -= lr g / sqrt(nu + eps)."""
        with torch.enable_grad(), full_precision():
            v = verts.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.refine_loss(v, faces, weights), v)
        nu = (1 - decay) * (g * g) + decay * nu
        return verts - lr * (torch.rsqrt(nu + eps) * g), nu

    def refine_mesh(self, mesh: TriMesh, steps: int, lr: float = 1e-4, weights=None,
                    seed: int = 0) -> TriMesh:
        """Gradient-based vertex refinement by ``steps`` RMSprop steps.
        ``weights``: one (F, 3) array of barycentric face-sample weights a
        step; by default Dirichlet(1, 1, 1) draws (normalized exponentials)
        from a ``torch.Generator`` seeded with ``seed``."""
        faces = torch.as_tensor(np.asarray(mesh.faces, np.int64), device=self.device)
        v = torch.tensor(np.asarray(mesh.vertices, np.float32), device=self.device)
        nu = torch.zeros_like(v)
        gen = torch.Generator().manual_seed(seed)
        for s in range(steps):
            if weights is None:
                e = -torch.log1p(-torch.rand(len(mesh.faces), 3, generator=gen))
                w = e / e.sum(-1, keepdim=True)
            else:
                w = torch.tensor(np.asarray(weights[s], np.float32))
            v, nu = self.refine_step(v, nu, faces, w.to(self.device), lr)
        return TriMesh(v.cpu().numpy(), mesh.faces)
