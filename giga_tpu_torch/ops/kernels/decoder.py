"""Dense-decode kernels K2-K5 (csrc/dense_decode.cu, csrc/dense_decode_feats.cu),
with their input preparation and head splits.

Counterpart of giga_tpu/ops/pallas/decoder_kernel.py:
  * K2 ``dense_decode_batched``: ``fused_dense_decode_batched``, B scenes,
    from precomputed projections (``prepare_projections_batched``);
  * K3 ``fused_dense_decode``: ``fused_dense_decode``, one scene
    (``prepare_projections``, ``split_heads``);
  * K4 ``dense_decode_feats_batched``: ``fused_dense_decode_feats_batched``,
    all three fc_c projections formed by K4's own kernels from the raw
    lattice features (``prepare_feats_inputs``);
  * K5 ``dense_decode_hybrid_batched``: ``fused_dense_decode_hybrid_batched``,
    the xz/xy projections in-kernel, pyz precomputed with the fc_c biases
    folded in (``prepare_hybrid_inputs``).

The TPU kernels run the three heads as one fused trunk with block-diagonal
(F, F) weights, F = heads * hidden. Its off-diagonal blocks are exact
zeros, so here the trunk weights stay per head, (n_blocks, heads, H, H),
and each head runs as its own H-wide trunk: the same sums with a third of
the multiply-adds. Projection inputs and fc_c weight splits keep the fused
F-wide layout (head e owns columns e*H .. e*H + H - 1).

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version (``*_plain``) for CPU tensors; there is no other fallback.

Every kernel has two modes, float32 and the TPU kernels'
``compute_dtype=bf16``: the assembly, biases and residual stream float32,
and the operands of each product (the trunk's, and K4's and K5's in-kernel
projections) rounded to bf16 with float32 sums. K2 and K3 pick the mode by
their inputs' dtype: in bf16 every input is bf16 (K2's projections stored
in bf16), made by ``prepare_projections(_batched)(..., dtype=torch.bfloat16)``
as the JAX package's bf16 program makes them. K4 takes float32 inputs in
both modes and a ``compute_dtype``; K5 takes float32 inputs but for pyz,
which ``prepare_hybrid_inputs(..., dtype=torch.bfloat16)`` stores in bf16,
and its mode follows pyz's dtype.

K2 also takes the TPU kernel's numeric options (K3-K5 have none):
``fold_b1`` (``prepare_projections_batched(fold_b1=True)`` folds block i's
fc_1 bias into block i+1's pxz; every block but the last then skips its b1
add) in both modes, and ``resident_bf16`` (the residual stream held in
bf16, rounded after every add) in the bf16 mode. The third,
``hidden_bf16``, rounds the hidden stream to bf16 before its ReLU where the
bf16 mode rounds relu(hidden): ReLU commutes with rounding, so it is the
bf16 mode's own function and has no kernel of its own.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from giga_tpu_torch.ops.kernels import _build

# x-slabs one pass of K4 covers, unless the caller asks for another run
FEATS_X_CHUNK = 40


def _cat_out(w: torch.Tensor) -> torch.Tensor:
    """(heads, c, h) shared-input weights -> (c, heads*h)."""
    e, c, h = w.shape
    return w.permute(1, 0, 2).reshape(c, e * h)


def prepare_axis_terms(dec: dict, coords: torch.Tensor):
    """Separable fc_p terms px/py/pz (R, F), the fc_p bias folded into px."""
    w_p = _cat_out(dec["fc_p_kernel"])  # (3, F)
    coords = coords.to(w_p.dtype)
    px = coords[:, None] * w_p[0] + dec["fc_p_bias"].reshape(-1)
    py = coords[:, None] * w_p[1]
    pz = coords[:, None] * w_p[2]
    return px.contiguous(), py.contiguous(), pz.contiguous()


def _fc_c_splits(dec: dict, n_blocks: int):
    """Per-plane fc_c weight splits wxz/wxy/wyz (n_blocks, C, F) and the
    fc_c biases (n_blocks, F)."""
    c_dim = dec["fc_c0_kernel"].shape[1] // 3
    w = torch.stack([_cat_out(dec[f"fc_c{i}_kernel"]) for i in range(n_blocks)])
    bc = torch.stack([dec[f"fc_c{i}_bias"].reshape(-1) for i in range(n_blocks)])
    return (w[:, :c_dim].contiguous(), w[:, c_dim:2 * c_dim].contiguous(),
            w[:, 2 * c_dim:].contiguous(), bc.contiguous())


def _trunk_weights(dec: dict, n_blocks: int):
    """Per-head trunk weights w0 (n_blocks, heads, H, H), b0 (n_blocks,
    heads, H), w1, b1, and head weights wout (heads, H, O), bout (heads, O)."""
    def stack(name):
        return torch.stack([dec[f"block{i}_{name}"] for i in range(n_blocks)]).contiguous()

    return (stack("fc0_kernel"), stack("fc0_bias"), stack("fc1_kernel"), stack("fc1_bias"),
            dec["fc_out_kernel"].contiguous(), dec["fc_out_bias"].contiguous())


def _project(f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., C) lattice features @ (C, F) -> (..., F)."""
    return torch.einsum("...c,cf->...f", f, w)


def prepare_projections_batched(dec: dict, feats: dict, coords: torch.Tensor,
                                n_blocks: int = 5, dtype: torch.dtype = torch.float32,
                                fold_b1: bool = False):
    """feats {t: (B, R, R, C)} -> K2's inputs: px/py/pz (R, F); pxz/pxy/pyz
    (B, n_blocks, R, R, F), the fc_c bias in pxz; the per-head trunk and
    head weights (``_trunk_weights``).

    ``dtype=torch.bfloat16`` casts the weights and features to bf16 and
    computes every input in bf16, as the JAX package's bf16 program does:
    the coords too, each product rounded once, then the bias add rounded.

    ``fold_b1`` adds block i-1's fc_1 bias to block i's fc_c bias (i > 0)
    before that sum is added to pxz, in ``dtype`` as the JAX package does:
    in bf16 the folded bias is rounded once as a sum of biases and once in
    pxz. K2 then runs with ``fold_b1=True``."""
    if dtype != torch.float32:
        dec = {k: v.to(dtype) for k, v in dec.items()}
        feats = {t: v.to(dtype) for t, v in feats.items()}
    px, py, pz = prepare_axis_terms(dec, coords)
    wxz, wxy, wyz, bc = _fc_c_splits(dec, n_blocks)
    if fold_b1:
        b1 = torch.stack([dec[f"block{i}_fc1_bias"].reshape(-1) for i in range(n_blocks - 1)])
        bc = torch.cat([bc[:1], bc[1:] + b1])
    pxz = torch.stack([_project(feats["xz"], wxz[i]) + bc[i] for i in range(n_blocks)], 1)
    pxy = torch.stack([_project(feats["xy"], wxy[i]) for i in range(n_blocks)], 1)
    pyz = torch.stack([_project(feats["yz"], wyz[i]) for i in range(n_blocks)], 1)
    return (px, py, pz, pxz, pxy, pyz, *_trunk_weights(dec, n_blocks))


def prepare_projections(dec: dict, feats: dict, coords: torch.Tensor, n_blocks: int = 5,
                        dtype: torch.dtype = torch.float32):
    """Single-scene ``prepare_projections_batched``: feats {t: (R, R, C)} ->
    K3's inputs, pxz/pxy/pyz (n_blocks, R, R, F)."""
    inputs = prepare_projections_batched(dec, {t: v[None] for t, v in feats.items()},
                                         coords, n_blocks, dtype)
    return inputs[:3] + tuple(p[0] for p in inputs[3:6]) + inputs[6:]


def prepare_feats_inputs(dec: dict, feats: dict, coords: torch.Tensor, n_blocks: int = 5):
    """K4's inputs, all float32 whatever the dtype of ``dec`` and ``feats``
    (as the JAX package's ``_as_f32``): px/py/pz (R, F), computed in the
    params' dtype; the raw features fxz/fxy/fyz (B, R, R, C); wxz/wxy/wyz
    (n_blocks, C, F); bc (n_blocks, F); the per-head trunk and head
    weights."""
    px, py, pz = prepare_axis_terms(dec, coords)
    return tuple(t.float().contiguous() for t in (
        px, py, pz, *(feats[t] for t in ("xz", "xy", "yz")), *_fc_c_splits(dec, n_blocks),
        *_trunk_weights(dec, n_blocks)))


def prepare_hybrid_inputs(dec: dict, feats: dict, coords: torch.Tensor, n_blocks: int = 5,
                          dtype: torch.dtype = torch.float32):
    """K5's inputs: px/py/pz (R, F); fxz/fxy (B, R, R, C); pyz
    (B, n_blocks, R, R, F) with the fc_c biases folded in; wxz/wxy
    (n_blocks, C, F); the per-head trunk and head weights. Everything is
    computed in the dtype of ``dec`` and ``feats`` and returned float32 (as
    the JAX package's ``_as_f32``) but pyz, which is stored in ``dtype``
    (the JAX package's ``proj_dtype``: bf16 for K5's bf16 mode)."""
    px, py, pz = prepare_axis_terms(dec, coords)
    wxz, wxy, wyz, bc = _fc_c_splits(dec, n_blocks)
    pyz = torch.stack([_project(feats["yz"], wyz[i]) + bc[i] for i in range(n_blocks)], 1)
    out = tuple(t.float().contiguous() for t in (
        px, py, pz, feats["xz"], feats["xy"], pyz, wxz, wxy, *_trunk_weights(dec, n_blocks)))
    return out[:5] + (out[5].to(dtype),) + out[6:]


# -- plain versions -----------------------------------------------------------

def _operand(a: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """A product's operand in float32: as it is, or rounded to bf16 first
    (``compute_dtype`` bf16), so that the float32 product of two operands
    is exact and only the sums round, as in the TPU kernels' bf16 mode."""
    return a.float() if compute_dtype == torch.float32 else a.to(compute_dtype).float()


def _identity(a: torch.Tensor) -> torch.Tensor:
    return a


def _round_bf16(a: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bf16, as float32."""
    return a.to(torch.bfloat16).float()


def _trunk_plain(net, block_input, w0, b0, w1, b1, wout, bout,
                 compute_dtype: torch.dtype = torch.float32, fold_b1: bool = False,
                 residual=_identity):
    """The per-head trunk on a (..., F) float32 residual stream: block i
    first adds ``block_input(net, i)``'s plane terms, then runs its
    ResnetBlockFC. Returns (..., heads*O) float32. With ``compute_dtype``
    bf16 both operands of each product are rounded to bf16 (``_operand``).
    ``fold_b1`` drops the b1 add of every block but the last (its bias is
    in the next block's plane terms). ``residual`` rounds the residual
    add's two terms, dx and the sum (``_round_bf16``: K2's resident
    stream)."""
    def operand(a):
        return _operand(a, compute_dtype)

    n_blocks, E, H, _ = w0.shape
    lead = net.shape[:-1]
    w0, w1, wout = operand(w0), operand(w1), operand(wout)
    b0, b1, bout = b0.float(), b1.float(), bout.float()
    for i in range(n_blocks):
        net = block_input(net, i)
        heads = net.reshape(*lead, E, H)
        hid = torch.einsum("...ek,ekj->...ej", operand(torch.relu(heads)), w0[i]) + b0[i]
        dx = torch.einsum("...ek,ekj->...ej", operand(torch.relu(hid)), w1[i])
        if not fold_b1 or i == n_blocks - 1:
            dx = dx + b1[i]
        net = residual(net + residual(dx.reshape(*lead, E * H)))
    heads = net.reshape(*lead, E, H)
    out = torch.einsum("...ek,eko->...eo", operand(torch.relu(heads)), wout) + bout
    return out.reshape(*lead, -1)


def _lattice_start(px, py, pz, B: int):
    """(B, R, R, R, F) float32 block-0 input (px[x] + py[y]) + pz[z]."""
    px, py, pz = px.float(), py.float(), pz.float()
    R, F = px.shape
    net = (px[:, None, None, :] + py[None, :, None, :]) + pz[None, None, :, :]
    return net.expand(B, R, R, R, F)


def _check_resident(what: str, resident_bf16: bool, dtype: torch.dtype) -> None:
    if resident_bf16 and dtype != torch.bfloat16:
        raise ValueError(f"{what}: resident_bf16 holds the residual stream in bf16 and is a "
                         f"bf16 mode's option, not {dtype}'s")


def dense_decode_plain(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout,
                       compute_dtype: torch.dtype | None = None, fold_b1: bool = False,
                       resident_bf16: bool = False):
    """Plain PyTorch version of K2 on the same inputs -> (B, heads*O, R^3)
    float32, rows flattened as (x*R + y)*R + z. ``compute_dtype`` (float32
    or bfloat16) defaults to the projections' dtype.

    ``fold_b1``: every block but the last skips its b1 add (inputs from
    ``prepare_projections_batched(fold_b1=True)``). ``resident_bf16`` (bf16
    only) rounds the residual stream to bf16 where the TPU kernel holds it
    in bf16: after the block-0 assembly (px + py) + pz, after each plane
    add, and in each residual add net + bf16(dx) after dx and after the
    sum."""
    B, R = pxz.shape[0], px.shape[0]
    compute_dtype = compute_dtype or pxz.dtype
    _check_resident("dense_decode_plain", resident_bf16, compute_dtype)
    rnd = _round_bf16 if resident_bf16 else _identity
    pxz, pxy, pyz = pxz.float(), pxy.float(), pyz.float()

    def block_input(net, i):
        net = rnd(net + pxz[:, i][:, :, None, :, :])
        net = rnd(net + pxy[:, i][:, :, :, None, :])
        return rnd(net + pyz[:, i][:, None, :, :, :])

    out = _trunk_plain(rnd(_lattice_start(px, py, pz, B)), block_input, w0, b0, w1, b1, wout,
                       bout, compute_dtype, fold_b1, rnd)
    return out.reshape(B, R ** 3, -1).permute(0, 2, 1).contiguous()


def fused_dense_decode_plain(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout,
                             compute_dtype: torch.dtype | None = None):
    """Plain PyTorch version of K3: one scene, pxz/pxy/pyz (n_blocks, R, R, F)
    -> (R, R, R, heads*O) float32 indexed [x, y, z, o]. ``compute_dtype``
    defaults to the projections' dtype."""
    compute_dtype = compute_dtype or pxz.dtype
    pxz, pxy, pyz = pxz.float(), pxy.float(), pyz.float()

    def block_input(net, i):
        return net + pxz[i][:, None, :, :] + pxy[i][:, :, None, :] + pyz[i][None, :, :, :]

    return _trunk_plain(_lattice_start(px, py, pz, 1)[0], block_input,
                        w0, b0, w1, b1, wout, bout, compute_dtype)


def dense_decode_feats_plain(px, py, pz, fxz, fxy, fyz, wxz, wxy, wyz, bc,
                             w0, b0, w1, b1, wout, bout,
                             compute_dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of K4 -> (B, R, R, R, heads*O) float32: block i
    adds fxz @ wxz[i], fxy @ wxy[i], fyz @ wyz[i] and bc[i], in that order.
    With ``compute_dtype`` bf16 the projections' operands are rounded to
    bf16 too; their float32 rows are added as they are."""
    def project(f, w):
        return _project(_operand(f, compute_dtype), _operand(w, compute_dtype))

    def block_input(net, i):
        return (net + project(fxz, wxz[i])[:, :, None, :, :]
                + project(fxy, wxy[i])[:, :, :, None, :]
                + project(fyz, wyz[i])[:, None, :, :, :] + bc[i].float())

    return _trunk_plain(_lattice_start(px, py, pz, fxz.shape[0]), block_input,
                        w0, b0, w1, b1, wout, bout, compute_dtype)


def dense_decode_hybrid_plain(px, py, pz, fxz, fxy, pyz, wxz, wxy, w0, b0, w1, b1, wout, bout):
    """Plain PyTorch version of K5 -> (B, R, R, R, heads*O) float32: block i
    adds fxz @ wxz[i], fxy @ wxy[i] and pyz[:, i] (widened to float32), in
    that order, in the mode of pyz's dtype: bf16 rounds the operands of the
    projections and the trunk as ``dense_decode_feats_plain`` does."""
    compute_dtype = pyz.dtype

    def project(f, w):
        return _project(_operand(f, compute_dtype), _operand(w, compute_dtype))

    def block_input(net, i):
        return (net + project(fxz, wxz[i])[:, :, None, :, :]
                + project(fxy, wxy[i])[:, :, :, None, :] + pyz[:, i].float()[:, None, :, :, :])

    return _trunk_plain(_lattice_start(px, py, pz, fxz.shape[0]), block_input,
                        w0, b0, w1, b1, wout, bout, compute_dtype)


# -- kernel wrappers ----------------------------------------------------------

def _check(what: str, expect: dict, args, device, dtype=torch.float32) -> None:
    """Raise ValueError unless every tensor has its expected shape and is
    contiguous, 16-byte aligned ``dtype`` on ``device``."""
    for (name, shape), t in zip(expect.items(), args):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if (t.device != device or t.dtype != dtype or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} must be contiguous, 16-byte aligned "
                             f"{dtype} on {device}")


# K2's and K3's library entry points for each input dtype
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# K2's modes with their options: (dtype, fold_b1, resident_bf16)
K2_MODES = ((torch.float32, False, False), (torch.float32, True, False),
            (torch.bfloat16, False, False), (torch.bfloat16, True, False),
            (torch.bfloat16, False, True), (torch.bfloat16, True, True))


def _mode(what: str, dtype: torch.dtype) -> str:
    """The entry-point suffix of ``dtype``'s mode."""
    if dtype not in SUFFIX:
        raise ValueError(f"{what}: unsupported dtype {dtype}")
    return SUFFIX[dtype]


# csrc's design constants that fix the shapes K2-K5 take: the hidden width
# and outputs of a head (trunk.cuh); K2/K3's float32 warps a block and floats
# of a warp's activation tile (dense_decode.cu, trunk_tiled.cuh), the bf16
# mode's consumer warps, points of a warp tile, pyz ring and slab stages,
# bytes of a plane row, box alignment and rows of a TMA box at most
# (dense_decode.cu, rows_tma.cuh; K4/K5 bf16 take the same warps, tile,
# ring of 2 boxes and 2 slab stages in dense_decode_feats.cu); K4/K5's
# float32 projection rows a block, its threads at most and the padding of
# its staged rows, and the bf16 mode's feature channels (dense_decode_feats.cu);
# the shared bytes a block may use on sm_90
KERNEL_H, KERNEL_O = 32, 4
F32_WARPS, F32_ACT_FLOATS = 12, 32 * 68
BF_WARPS, BF_P, BF_PYZ_STAGES, BF_SLAB_STAGES = 15, 32, 2, 2
ROW_BYTES, ALIGN, BF_MAX_BOX = 64, 1024, 256
PROJ_ROWS, PROJ_MAX_THREADS, PROJ_S = 64, 512, 68
FEATS_BF16_C = 32
SMEM_LIMIT = 232448


def _align_up(n: int, a: int) -> int:
    return -(-n // a) * a


def _f32_weight_floats(n_blocks: int) -> int:
    """trunk::weight_floats: one head's float32 trunk weights."""
    return n_blocks * (2 * KERNEL_H * KERNEL_H + 2 * KERNEL_H) + KERNEL_H * KERNEL_O + KERNEL_O


# tc::FRAG_WORDS: 32-bit words of one (H, H) matrix's bf16 B fragments
_FRAG_WORDS = (KERNEL_H // 16) * (KERNEL_H // 8) * 64


def _bf16_weight_words(n_blocks: int) -> int:
    """tc::weight_words: one head's bf16 B fragments and float32 biases."""
    return (n_blocks * 2 * _FRAG_WORDS + (KERNEL_H // 16) * 64 + n_blocks * 2 * KERNEL_H
            + KERNEL_O)


def _bf16_layout_bytes(zc: int, yc: int, stages: int, n_blocks: int) -> int:
    """dense_decode.cu's ``BfLayout(shape, NB).bytes``."""
    ybox, zbox = _align_up(yc * ROW_BYTES, ALIGN), _align_up(zc * ROW_BYTES, ALIGN)
    slab = ALIGN + (n_blocks + 1) * (ybox + zbox)
    pyz = _align_up(_bf16_weight_words(n_blocks) * 4, ALIGN) + stages * slab
    bars = pyz + BF_WARPS * BF_PYZ_STAGES * BF_P * ROW_BYTES
    return bars + 8 * (2 * stages + BF_WARPS * BF_PYZ_STAGES) + ALIGN


def _feats_bf16_layout_bytes(R: int, n_blocks: int, hybrid: bool) -> int:
    """dense_decode_feats.cu's ``BfLayout(R, NB, k4).bytes``: the trunk's
    weights, the projections' bf16 B fragments (K4 three planes, K5 two) and
    K4's fc_c biases, then 2 slab stages of an x-plane's fxz and fxy boxes,
    15 warps' rings of 2 boxes of 32 rows, the mbarriers."""
    planes = 2 if hybrid else 3
    weights = (_bf16_weight_words(n_blocks) + planes * n_blocks * _FRAG_WORDS) * 4
    if not hybrid:
        weights += n_blocks * KERNEL_H * 4
    slab = 2 * _align_up(R * ROW_BYTES, ALIGN)
    ring = _align_up(weights, ALIGN) + BF_SLAB_STAGES * slab
    bars = ring + BF_WARPS * BF_PYZ_STAGES * BF_P * ROW_BYTES
    return bars + 8 * (2 * BF_SLAB_STAGES + BF_WARPS * BF_PYZ_STAGES) + ALIGN


def bf16_slab_shape(R: int, n_blocks: int):
    """K2/K3 bf16's slab shape, dense_decode.cu's ``bf16_shape``: (z-columns,
    y-lines, z-chunks, y-chunks, stages) of the first shape in its order of
    preference that fits a block's shared memory, or None."""
    zcs = [R] if R <= BF_MAX_BOX else []
    # z-chunks of whole tiles below R, the least padding past R first
    zcs += sorted((c for c in range(BF_MAX_BOX // BF_P * BF_P, BF_P - 1, -BF_P) if c < R),
                  key=lambda c: _align_up(R, c))
    for stages in range(BF_SLAB_STAGES, 0, -1):
        for zc in zcs:
            for cy in range(-(-R // BF_MAX_BOX), R + 1):
                yc = -(-R // cy)
                if -(-R // yc) != cy:
                    continue
                if _bf16_layout_bytes(zc, yc, stages, n_blocks) <= SMEM_LIMIT:
                    return zc, yc, -(-R // zc), cy, stages
    return None


def can_dense_decode(B: int, R: int, heads: int, H: int, O: int, n_blocks: int,
                     dtype: torch.dtype = torch.float32, point_major: bool = False,
                     fold_b1: bool = False, resident_bf16: bool = False) -> bool:
    """Whether K2 (K3 with ``point_major``) in the mode of ``dtype``, with
    K2's options, takes B scenes of an R^3 lattice, ``heads`` heads of hidden
    width H and O outputs, and ``n_blocks`` blocks: exactly the shapes
    ``dense_decode_launch_config`` accepts (the width the kernels are built
    for, ``dense_decode_hidden()`` / ``dense_decode_outputs()``; the modes
    that exist; the block's shared memory, in bf16 through the slab shape,
    which refuses n_blocks above ~22; int tile indices). Pure Python: it
    loads no library, so the CPU evaluates it as the card does."""
    if (min(B, R, heads) < 1 or n_blocks < 0 or H != KERNEL_H or O != KERNEL_O
            or (point_major and (fold_b1 or resident_bf16))):
        return False
    if dtype == torch.float32:
        shmem = (_f32_weight_floats(n_blocks) + F32_WARPS * F32_ACT_FLOATS) * 4
        return not resident_bf16 and shmem <= SMEM_LIMIT
    if dtype != torch.bfloat16 or n_blocks < BF_PYZ_STAGES - 1:
        return False
    shape = bf16_slab_shape(R, n_blocks)
    if shape is None:
        return False
    zc, yc, cz, cy, _ = shape
    return B * R * cy * cz * -(-yc * zc // BF_P) <= 0x7FFFFFFF


def can_dense_decode_feats(B: int, R: int, C: int, heads: int, H: int, O: int, n_blocks: int,
                           x_chunk: int = FEATS_X_CHUNK, hybrid: bool = False,
                           dtype: torch.dtype = torch.float32) -> bool:
    """Whether K4 (K5 with ``hybrid``) in the mode of ``dtype`` takes B
    scenes of an R^3 lattice, C feature channels, ``heads`` heads of hidden
    width H and O outputs, ``n_blocks`` blocks and passes of ``x_chunk``
    x-slabs: exactly the shapes ``dense_decode_feats_launch_config`` accepts
    (the width the kernels are built for; in float32 the projection kernel's
    threads and staged rows and the trunk's weights in shared memory; in
    bf16 C = 32 channels, an x-plane of R <= 256 rows in one TMA box, the
    layout's exact shared bytes and int tile indices). Pure Python."""
    F = heads * H
    if min(B, R, heads, C, x_chunk) < 1 or n_blocks < 0 or H != KERNEL_H or O != KERNEL_O:
        return False
    if dtype == torch.float32:
        trunk = (_f32_weight_floats(n_blocks) + F32_WARPS * F32_ACT_FLOATS
                 + n_blocks * KERNEL_H) * 4
        return (F % 4 == 0 and PROJ_ROWS // 8 * (F // 4) <= PROJ_MAX_THREADS
                and C * PROJ_S * 4 <= SMEM_LIMIT and trunk <= SMEM_LIMIT)
    if dtype != torch.bfloat16:
        return False
    return (C == FEATS_BF16_C and R <= BF_MAX_BOX
            and _feats_bf16_layout_bytes(R, n_blocks, hybrid) <= SMEM_LIMIT
            and B * R * -(-R * R // BF_P) <= 0x7FFFFFFF)


def _trunk_shapes(w0, wout):
    """(n_blocks, heads, H, O) of per-head trunk weights, checked against
    the width the kernels are built for."""
    n_blocks, E, H, _ = w0.shape
    O = wout.shape[-1]
    lib = _lib()
    if H != lib.dense_decode_hidden() or O != lib.dense_decode_outputs():
        raise ValueError(f"dense decode kernels are built for hidden {lib.dense_decode_hidden()} "
                         f"and {lib.dense_decode_outputs()} outputs per head, got {H} and {O}")
    return n_blocks, E, H, O


def _trunk_expect(n_blocks, E, H, O) -> dict:
    return {"w0": (n_blocks, E, H, H), "b0": (n_blocks, E, H), "w1": (n_blocks, E, H, H),
            "b1": (n_blocks, E, H), "wout": (E, H, O), "bout": (E, O)}


def _check_bf16_channels(what: str, C: int) -> None:
    if C != FEATS_BF16_C:
        raise ValueError(f"{what}: the bf16 mode takes {FEATS_BF16_C} feature channels "
                         f"(one 64-byte TMA row), got {C}")


def _device(what: str, t: torch.Tensor):
    """The tensor's device if it is a CUDA device, None for the CPU."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device


def dense_decode_batched(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout,
                         fold_b1: bool = False, resident_bf16: bool = False):
    """K2 trunk -> (B, heads*O, R^3) float32; the CUDA kernel for CUDA
    tensors, in the inputs' dtype's mode (all float32 or all bfloat16),
    with the options ``fold_b1`` and (bf16 only) ``resident_bf16`` as
    ``dense_decode_plain`` takes them. ``launches`` counts every launch,
    ``entry_launches`` each entry point's (one per mode and option set)."""
    args = (px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout)
    device = _device("dense_decode_batched", pxz)
    if device is None:
        return dense_decode_plain(*args, fold_b1=fold_b1, resident_bf16=resident_bf16)
    entry = dense_decode_entry(pxz.dtype, fold_b1, resident_bf16)
    R, F = px.shape
    B = pxz.shape[0]
    n_blocks, E, H, O = _trunk_shapes(w0, wout)
    plane = (B, n_blocks, R, R, E * H)
    _check("dense_decode_batched",
           {"px": (R, E * H), "py": (R, E * H), "pz": (R, E * H), "pxz": plane, "pxy": plane,
            "pyz": plane, **_trunk_expect(n_blocks, E, H, O)}, args, device, pxz.dtype)
    out = torch.empty((B, E * O, R ** 3), device=device, dtype=torch.float32)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(_lib(), entry)(*(t.data_ptr() for t in args), out.data_ptr(),
                                 B, R, E, n_blocks, stream)
    _build.check(err, entry)
    dense_decode_batched.launches += 1
    dense_decode_batched.entry_launches[entry] += 1
    return out


dense_decode_batched.launches = 0
dense_decode_batched.entry_launches = Counter()


def dense_decode_entry(dtype: torch.dtype, fold_b1: bool = False,
                       resident_bf16: bool = False) -> str:
    """The name of K2's entry point for a mode and its options, e.g.
    ``dense_decode_bf16_resident_fold``."""
    _check_resident("dense_decode_batched", resident_bf16, dtype)
    return ("dense_decode_" + _mode("dense_decode_batched", dtype)
            + "_resident" * resident_bf16 + "_fold" * fold_b1)


def fused_dense_decode(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout):
    """K3 trunk for one scene, pxz/pxy/pyz (n_blocks, R, R, F) ->
    (R, R, R, heads*O) float32 indexed [x, y, z, o]; the CUDA kernel for
    CUDA tensors, in the inputs' dtype's mode."""
    args = (px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout)
    device = _device("fused_dense_decode", pxz)
    if device is None:
        return fused_dense_decode_plain(*args)
    entry = "dense_decode_single_" + _mode("fused_dense_decode", pxz.dtype)
    R = px.shape[0]
    n_blocks, E, H, O = _trunk_shapes(w0, wout)
    plane = (n_blocks, R, R, E * H)
    _check("fused_dense_decode",
           {"px": (R, E * H), "py": (R, E * H), "pz": (R, E * H), "pxz": plane, "pxy": plane,
            "pyz": plane, **_trunk_expect(n_blocks, E, H, O)}, args, device, pxz.dtype)
    out = torch.empty((R, R, R, E * O), device=device, dtype=torch.float32)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(_lib(), entry)(*(t.data_ptr() for t in args), out.data_ptr(),
                                 R, E, n_blocks, stream)
    _build.check(err, entry)
    fused_dense_decode.launches += 1
    return out


fused_dense_decode.launches = 0


def dense_decode_feats_batched(px, py, pz, fxz, fxy, fyz, wxz, wxy, wyz, bc,
                               w0, b0, w1, b1, wout, bout, x_chunk: int = FEATS_X_CHUNK,
                               compute_dtype: torch.dtype = torch.float32):
    """K4 trunk from raw features -> (B, R, R, R, heads*O) float32, in
    ``compute_dtype``'s mode (every input float32 in both); the CUDA kernels
    for CUDA tensors. In float32 ``x_chunk`` is the run of x-slabs one pass
    of the kernels covers: the xz and xy projection rows of a pass are held
    in scratch of (B, n_blocks, x_chunk, R, heads*H) floats each (the
    outputs do not depend on it). The bf16 mode (C = 32 channels) runs in
    one pass whatever ``x_chunk`` (still at least 1) and writes no float32
    rows: its prologue rounds the three feature planes into a bf16
    workspace of (3, B, R, R, C)."""
    args = (px, py, pz, fxz, fxy, fyz, wxz, wxy, wyz, bc, w0, b0, w1, b1, wout, bout)
    device = _device("dense_decode_feats_batched", fxz)
    if device is None:
        return dense_decode_feats_plain(*args, compute_dtype=compute_dtype)
    entry = "dense_decode_feats_" + _mode("dense_decode_feats_batched", compute_dtype)
    R = px.shape[0]
    B, C = fxz.shape[0], fxz.shape[-1]
    n_blocks, E, H, O = _trunk_shapes(w0, wout)
    F = E * H
    if x_chunk < 1:
        raise ValueError(f"dense_decode_feats_batched: x_chunk must be >= 1, got {x_chunk}")
    _check("dense_decode_feats_batched",
           {"px": (R, F), "py": (R, F), "pz": (R, F), "fxz": (B, R, R, C), "fxy": (B, R, R, C),
            "fyz": (B, R, R, C), "wxz": (n_blocks, C, F), "wxy": (n_blocks, C, F),
            "wyz": (n_blocks, C, F), "bc": (n_blocks, F),
            **_trunk_expect(n_blocks, E, H, O)}, args, device)
    XR = min(x_chunk, R)
    out = torch.empty((B, R, R, R, E * O), device=device, dtype=torch.float32)
    if compute_dtype == torch.bfloat16:
        _check_bf16_channels("dense_decode_feats_batched", C)
        scratch = (torch.empty((3, B, R, R, C), device=device, dtype=torch.bfloat16),)
    else:
        # the projection rows: xz and xy for one pass of XR slabs, yz for all
        scratch = tuple(torch.empty((B, n_blocks, r, R, F), device=device, dtype=torch.float32)
                        for r in (XR, XR, R))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(_feats_lib(), entry)(*(t.data_ptr() for t in args), out.data_ptr(),
                                       *(t.data_ptr() for t in scratch),
                                       B, R, C, E, n_blocks, XR, stream)
    _build.check(err, entry)
    dense_decode_feats_batched.launches += 1
    return out


dense_decode_feats_batched.launches = 0


def dense_decode_hybrid_batched(px, py, pz, fxz, fxy, pyz, wxz, wxy, w0, b0, w1, b1, wout, bout):
    """K5 trunk, xz/xy rows projected in-kernel -> (B, R, R, R, heads*O)
    float32, in the mode of pyz's dtype (float32, or bf16 for the bf16
    mode; every other input float32); the CUDA kernels for CUDA tensors.
    In float32 the xz and xy rows of all x-slabs are held in scratch of
    (B, n_blocks, R, R, heads*H) floats each; the bf16 mode (C = 32
    channels) writes no float32 rows: its prologue rounds fxz and fxy into
    a bf16 workspace of (2, B, R, R, C)."""
    args = (px, py, pz, fxz, fxy, pyz, wxz, wxy, w0, b0, w1, b1, wout, bout)
    device = _device("dense_decode_hybrid_batched", fxz)
    if device is None:
        return dense_decode_hybrid_plain(*args)
    entry = "dense_decode_hybrid_" + _mode("dense_decode_hybrid_batched", pyz.dtype)
    R = px.shape[0]
    B, C = fxz.shape[0], fxz.shape[-1]
    n_blocks, E, H, O = _trunk_shapes(w0, wout)
    F = E * H
    _check("dense_decode_hybrid_batched",
           {"px": (R, F), "py": (R, F), "pz": (R, F), "fxz": (B, R, R, C), "fxy": (B, R, R, C)},
           args[:5], device)
    _check("dense_decode_hybrid_batched", {"pyz": (B, n_blocks, R, R, F)}, (pyz,), device,
           pyz.dtype)
    _check("dense_decode_hybrid_batched",
           {"wxz": (n_blocks, C, F), "wxy": (n_blocks, C, F), **_trunk_expect(n_blocks, E, H, O)},
           args[6:], device)
    out = torch.empty((B, R, R, R, E * O), device=device, dtype=torch.float32)
    if pyz.dtype == torch.bfloat16:
        _check_bf16_channels("dense_decode_hybrid_batched", C)
        scratch = (torch.empty((2, B, R, R, C), device=device, dtype=torch.bfloat16),)
    else:
        scratch = tuple(torch.empty((B, n_blocks, R, R, F), device=device, dtype=torch.float32)
                        for _ in range(2))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(_feats_lib(), entry)(*(t.data_ptr() for t in args), out.data_ptr(),
                                       *(t.data_ptr() for t in scratch), B, R, C, E, n_blocks,
                                       stream)
    _build.check(err, entry)
    dense_decode_hybrid_batched.launches += 1
    return out


dense_decode_hybrid_batched.launches = 0


# -- head splits and the decode entry points ----------------------------------

def split_heads(out: torch.Tensor, heads: int):
    """(..., R, R, R, heads*O) -> qual (..., R, R, R) sigmoid; rot
    (..., R, R, R, 4) unit-norm; width (..., R, R, R)."""
    parts = out.reshape(*out.shape[:-1], heads, out.shape[-1] // heads)
    qual = torch.sigmoid(parts[..., 0, 0])
    rot = parts[..., 1, :]
    rot = rot / torch.clamp_min(torch.linalg.vector_norm(rot, dim=-1, keepdim=True), 1e-12)
    width = parts[..., 2, 0]
    return qual, rot, width


def split_heads_transposed(out: torch.Tensor, heads: int, R: int):
    """(B, heads*O, R^3) -> qual (B, R, R, R) sigmoid; rot (B, 4, R^3)
    unit-norm, kept transposed (postprocess gathers its columns); width
    (B, R, R, R)."""
    B, HO, N = out.shape
    parts = out.reshape(B, heads, HO // heads, N)
    qual = torch.sigmoid(parts[:, 0, 0]).reshape(B, R, R, R)
    rot = parts[:, 1, :4]
    rot = rot / torch.clamp_min(torch.linalg.vector_norm(rot, dim=1, keepdim=True), 1e-12)
    width = parts[:, 2, 0].reshape(B, R, R, R)
    return qual, rot, width


def _heads(dec: dict) -> int:
    return dec["fc_p_kernel"].shape[0]


def decode_affordance_dense_kernel_batched(dec: dict, feats: dict, coords: torch.Tensor,
                                           n_blocks: int = 5,
                                           compute_dtype: torch.dtype = torch.float32,
                                           fold_b1: bool = False, hidden_bf16: bool = False,
                                           resident_bf16: bool = False):
    """Batched (qual, rot, width) through K2 in ``compute_dtype``'s mode:
    float32 qual (B,R,R,R), rot (B,4,R^3), width (B,R,R,R).

    The options of the JAX package's ``decode_affordance_dense_pallas_batched``:
    ``fold_b1`` in both modes; ``hidden_bf16`` and ``resident_bf16`` apply in
    bf16 only, as there. ``hidden_bf16`` is the bf16 mode's own function
    (ReLU commutes with its rounding), so it selects no other kernel."""
    del hidden_bf16  # the bf16 mode computes what it asks for
    inputs = prepare_projections_batched(dec, feats, coords, n_blocks, compute_dtype, fold_b1)
    out = dense_decode_batched(*inputs, fold_b1=fold_b1,
                               resident_bf16=resident_bf16 and compute_dtype == torch.bfloat16)
    return split_heads_transposed(out, _heads(dec), coords.shape[0])


def decode_affordance_dense_kernel(dec: dict, feats: dict, coords: torch.Tensor,
                                   n_blocks: int = 5, compute_dtype: torch.dtype = torch.float32):
    """Single-scene (qual, rot, width) through K3 in ``compute_dtype``'s
    mode, feats {t: (R, R, C)}: float32 qual (R,R,R), rot (R,R,R,4), width
    (R,R,R)."""
    out = fused_dense_decode(*prepare_projections(dec, feats, coords, n_blocks, compute_dtype))
    return split_heads(out, _heads(dec))


def decode_affordance_dense_kernel_feats_batched(dec: dict, feats: dict, coords: torch.Tensor,
                                                 n_blocks: int = 5, x_chunk: int = FEATS_X_CHUNK,
                                                 compute_dtype: torch.dtype = torch.float32):
    """Batched (qual, rot, width) through K4 in ``compute_dtype``'s mode:
    float32 qual (B,R,R,R), rot (B,R,R,R,4), width (B,R,R,R)."""
    inputs = prepare_feats_inputs(dec, feats, coords, n_blocks)
    out = dense_decode_feats_batched(*inputs, x_chunk=x_chunk, compute_dtype=compute_dtype)
    return split_heads(out, _heads(dec))


def decode_affordance_dense_kernel_hybrid_batched(dec: dict, feats: dict, coords: torch.Tensor,
                                                  n_blocks: int = 5,
                                                  compute_dtype: torch.dtype = torch.float32):
    """Batched (qual, rot, width) through K5 in ``compute_dtype``'s mode (pyz
    stored in it): float32 qual (B,R,R,R), rot (B,R,R,R,4), width
    (B,R,R,R)."""
    inputs = prepare_hybrid_inputs(dec, feats, coords, n_blocks, compute_dtype)
    return split_heads(dense_decode_hybrid_batched(*inputs), _heads(dec))


def dense_decode_launch_config(B: int, R: int, heads: int, n_blocks: int,
                               point_major: bool = False,
                               dtype: torch.dtype = torch.float32, fold_b1: bool = False,
                               resident_bf16: bool = False) -> dict:
    """The launch K2 (or K3, ``point_major``) makes for these shapes on the
    current card in ``dtype``'s mode, with K2's options: resident blocks per
    SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), SMs, grid (blocks
    per head x heads), threads and dynamic shared bytes per block, the warps
    of a block that take tiles, and in bf16 the stages of a warp's pyz ring
    and the slabs' stages and shape, z-columns x y-lines of an x-plane (0 in
    float32)."""
    entry = "dense_decode_config" if dtype == torch.float32 else "dense_decode_bf16_config"
    mode = int(point_major) + 2 * int(fold_b1) + 4 * int(resident_bf16)
    info = (ctypes.c_int * 11)()
    err = getattr(_lib(), entry)(mode, B, R, heads, n_blocks, info)
    _build.check(err, entry)
    return {"blocks_per_sm": info[0], "sms": info[1], "grid": (info[2], info[3]),
            "threads": info[4], "shared_bytes": info[5], "warps": info[6],
            "stages": info[7], "slab_stages": info[8], "slab": (info[9], info[10])}


def dense_decode_feats_launch_config(B: int, R: int, C: int, heads: int, n_blocks: int,
                                     x_chunk: int, hybrid: bool = False,
                                     dtype: torch.dtype = torch.float32) -> dict:
    """The launches K4 (or K5, ``hybrid``, which runs one pass: x_chunk R)
    makes for these shapes on the current card in ``dtype``'s mode: its
    trunk kernel's (bf16: its main kernel's) resident blocks per SM, SMs,
    grid (blocks per head x heads), threads and dynamic shared bytes per
    block, and the passes of x_chunk x-slabs (bf16: 1)."""
    mode = int(hybrid) + 2 * (_mode("dense_decode_feats_launch_config", dtype) == "bf16")
    info = (ctypes.c_int * 7)()
    err = _feats_lib().dense_decode_feats_config(mode, B, R, C, heads, n_blocks, x_chunk, info)
    _build.check(err, "dense_decode_feats_config")
    return {"blocks_per_sm": info[0], "sms": info[1], "grid": (info[2], info[3]),
            "threads": info[4], "shared_bytes": info[5], "passes": info[6]}


@functools.cache
def _lib() -> ctypes.CDLL:
    """K2/K3's library, built and loaded on first use, its C signatures bound."""
    lib = _build.load("dense_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    for dtype, fold, resident in K2_MODES:
        entry = getattr(lib, dense_decode_entry(dtype, fold, resident))
        entry.argtypes = [p] * 13 + [i, i, i, i, p]
        entry.restype = i
    for suffix in SUFFIX.values():
        getattr(lib, f"dense_decode_single_{suffix}").argtypes = [p] * 13 + [i, i, i, p]
        getattr(lib, f"dense_decode_single_{suffix}").restype = i
    for entry in ("dense_decode_config", "dense_decode_bf16_config"):
        getattr(lib, entry).argtypes = [i] * 5 + [ctypes.POINTER(i)]
        getattr(lib, entry).restype = i
    lib.dense_decode_hidden.argtypes = []
    lib.dense_decode_hidden.restype = i
    lib.dense_decode_outputs.argtypes = []
    lib.dense_decode_outputs.restype = i
    return lib


@functools.cache
def _feats_lib() -> ctypes.CDLL:
    """K4/K5's library, built and loaded on first use, its C signatures bound."""
    lib = _build.load("dense_decode_feats")
    p, i = ctypes.c_void_p, ctypes.c_int
    # the float32 entries take three (K4) or two (K5) scratch pointers, the
    # bf16 ones one workspace pointer
    for name, ptrs in (("dense_decode_feats_f32", 20), ("dense_decode_feats_bf16", 18)):
        getattr(lib, name).argtypes = [p] * ptrs + [i] * 6 + [p]
        getattr(lib, name).restype = i
    for name, ptrs in (("dense_decode_hybrid_f32", 17), ("dense_decode_hybrid_bf16", 16)):
        getattr(lib, name).argtypes = [p] * ptrs + [i] * 5 + [p]
        getattr(lib, name).restype = i
    lib.dense_decode_feats_config.argtypes = [i] * 7 + [ctypes.POINTER(i)]
    lib.dense_decode_feats_config.restype = i
    return lib
