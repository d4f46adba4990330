"""Kernel K2: dense-decode trunk (csrc/dense_decode.cu), with its input
preparation and head split.

Counterpart of giga_tpu/ops/pallas/decoder_kernel.py's batched path
(``prepare_projections_batched``, ``_prepare_axis_terms``,
``fused_dense_decode_batched``, ``_split_heads_transposed``).

The TPU kernel runs the three heads as one fused trunk with block-diagonal
(F, F) weights, F = heads * hidden. Its off-diagonal blocks are exact
zeros, so here the trunk weights stay per head, (n_blocks, heads, H, H),
and each head runs as its own H-wide trunk: the same sums with a third of
the multiply-adds. The projection inputs keep the fused F-wide layout
(head e owns columns e*H .. e*H + H - 1).

``dense_decode_batched`` launches the CUDA kernel for CUDA tensors and runs
``dense_decode_plain`` for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from giga_tpu_torch.ops.kernels import _build


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
    return px, py, pz


def prepare_projections_batched(dec: dict, feats: dict, coords: torch.Tensor,
                                n_blocks: int = 5):
    """feats {t: (B, R, R, C)} -> the kernel's inputs:
    px/py/pz (R, F); pxz/pxy/pyz (B, n_blocks, R, R, F), the fc_c bias in
    pxz; per-head trunk weights w0/w1 (n_blocks, heads, H, H), b0/b1
    (n_blocks, heads, H); head weights wout (heads, H, O), bout (heads, O)."""
    px, py, pz = prepare_axis_terms(dec, coords)
    c_dim = dec["fc_c0_kernel"].shape[1] // 3
    pxz, pxy, pyz = [], [], []
    for i in range(n_blocks):
        w_c = _cat_out(dec[f"fc_c{i}_kernel"])  # (3C, F)
        bias = dec[f"fc_c{i}_bias"].reshape(-1)
        pxz.append(torch.einsum("qabc,ch->qabh", feats["xz"], w_c[:c_dim]) + bias)
        pxy.append(torch.einsum("qabc,ch->qabh", feats["xy"], w_c[c_dim:2 * c_dim]))
        pyz.append(torch.einsum("qabc,ch->qabh", feats["yz"], w_c[2 * c_dim:]))

    def stack(name):
        return torch.stack([dec[f"block{i}_{name}"] for i in range(n_blocks)])

    return (
        px.contiguous(), py.contiguous(), pz.contiguous(),
        torch.stack(pxz, 1), torch.stack(pxy, 1), torch.stack(pyz, 1),
        stack("fc0_kernel").contiguous(), stack("fc0_bias").contiguous(),
        stack("fc1_kernel").contiguous(), stack("fc1_bias").contiguous(),
        dec["fc_out_kernel"].contiguous(), dec["fc_out_bias"].contiguous(),
    )


def dense_decode_plain(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout):
    """Plain PyTorch version of K2 on the same inputs -> (B, heads*O, R^3),
    rows flattened as (x*R + y)*R + z."""
    R, F = px.shape
    n_blocks, E, H, _ = w0.shape
    B = pxz.shape[0]
    net = (px[:, None, None, :] + py[None, :, None, :]) + pz[None, None, :, :]
    net = net.expand(B, R, R, R, F)
    for i in range(n_blocks):
        net = (net + pxz[:, i][:, :, None, :, :] + pxy[:, i][:, :, :, None, :]
               + pyz[:, i][:, None, :, :, :])
        heads = net.reshape(B, R, R, R, E, H)
        hid = torch.einsum("...ek,ekj->...ej", torch.relu(heads), w0[i]) + b0[i]
        dx = torch.einsum("...ek,ekj->...ej", torch.relu(hid), w1[i]) + b1[i]
        net = net + dx.reshape(B, R, R, R, F)
    heads = net.reshape(B, R, R, R, E, H)
    out = torch.einsum("...ek,eko->...eo", torch.relu(heads), wout) + bout
    return out.reshape(B, R ** 3, -1).permute(0, 2, 1).contiguous()


def dense_decode_batched(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout):
    """K2 trunk -> (B, heads*O, R^3); the CUDA kernel for CUDA tensors."""
    args = (px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout)
    device = pxz.device
    if device.type == "cpu":
        return dense_decode_plain(*args)
    if device.type != "cuda":
        raise ValueError(f"dense_decode_batched: unsupported device {device}")
    R, F = px.shape
    n_blocks, E, H, _ = w0.shape
    B = pxz.shape[0]
    O = wout.shape[-1]
    lib = _lib()
    if H != lib.dense_decode_hidden() or O != lib.dense_decode_outputs():
        raise ValueError(f"dense_decode_batched: kernel is built for hidden "
                         f"{lib.dense_decode_hidden()} and {lib.dense_decode_outputs()} "
                         f"outputs per head, got {H} and {O}")
    expect = {
        "px": (R, F), "py": (R, F), "pz": (R, F),
        "pxz": (B, n_blocks, R, R, F), "pxy": (B, n_blocks, R, R, F),
        "pyz": (B, n_blocks, R, R, F),
        "w0": (n_blocks, E, H, H), "b0": (n_blocks, E, H),
        "w1": (n_blocks, E, H, H), "b1": (n_blocks, E, H),
        "wout": (E, H, O), "bout": (E, O),
    }
    for (name, shape), t in zip(expect.items(), args):
        if tuple(t.shape) != shape:
            raise ValueError(f"dense_decode_batched: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if (t.device != device or t.dtype != torch.float32 or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"dense_decode_batched: {name} must be contiguous, "
                             f"16-byte aligned float32 on {device}")
    if F != E * H:
        raise ValueError(f"dense_decode_batched: F={F} != heads*hidden={E * H}")
    out = torch.empty((B, E * O, R ** 3), device=device, dtype=torch.float32)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.dense_decode_f32(*(t.data_ptr() for t in args), out.data_ptr(),
                               B, R, E, n_blocks, stream)
    _build.check(err, "dense_decode_f32")
    dense_decode_batched.launches += 1
    return out


dense_decode_batched.launches = 0


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


def decode_affordance_dense_kernel_batched(dec: dict, feats: dict, coords: torch.Tensor,
                                           n_blocks: int = 5):
    """Batched (qual, rot, width) through K2: qual (B,R,R,R), rot (B,4,R^3),
    width (B,R,R,R)."""
    inputs = prepare_projections_batched(dec, feats, coords, n_blocks)
    out = dense_decode_batched(*inputs)
    return split_heads_transposed(out, dec["fc_p_kernel"].shape[0], coords.shape[0])


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use, its C signatures bound."""
    lib = _build.load("dense_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dense_decode_f32.argtypes = [p] * 13 + [i, i, i, i, p]
    lib.dense_decode_f32.restype = i
    lib.dense_decode_hidden.argtypes = []
    lib.dense_decode_hidden.restype = i
    lib.dense_decode_outputs.argtypes = []
    lib.dense_decode_outputs.restype = i
    return lib
