"""Dense grasp-grid decoding with lattice factorization (counterpart of
giga_tpu/inference/dense_decode.py: the batched path and its unit-batch
single-scene wrappers).

The planner queries the affordance decoder at the full R^3 lattice. Each
triplane feature depends on two of the three coordinates, so sampling runs
on three R^2 lattices (two small matmuls per plane), and each block's fc_c
projection splits into three per-plane projections broadcast-added into the
R^3 hidden state. Only the ResnetBlockFC trunk runs on the full lattice.

``shard_constraint`` (the JAX package's ``with_sharding_constraint`` on
the hidden state) shards the lattice's x axis over a mesh axis: each rank
decodes its ``torch.tensor_split`` of the x rows (an uneven split works, as
GSPMD pads one) and the ranks all-gather the slabs in rank order, so the
full volume comes back on every rank. The plane features replicate (~600
KB), so no halo is needed.

These functions are the module path: the planner's programs run
``ops/kernels/decoder.py`` (K2 batched, K3 single-scene) on the card, and
the tests hold both against the JAX package. The grid variant's features
are one dense (R, R, R, C) volume, sampled trilinearly on the lattice
(``lattice_features``) and projected by each block's fc_c on the whole
lattice; it decodes on this module path alone. ``decode_lattice_points``
decodes at sparse lattice points.
"""

from __future__ import annotations

import numpy as np
import torch

from giga_tpu_torch.ops.sampling import interp_matrix_1d, sample_grid_lattice_batched


def lattice_coords(resolution: int, device=None) -> torch.Tensor:
    """Planner query coords linspace(-0.5, 0.5 - 1/R, R), correctly rounded
    to float32 (within 1 ulp of the JAX package's float32 linspace)."""
    c = np.linspace(-0.5, 0.5 - 1.0 / resolution, resolution).astype(np.float32)
    return torch.from_numpy(c).to(device)


def sample_planes_on_lattice_batched(planes: dict, coords: torch.Tensor, plane_reso: int,
                                     padding: float):
    """{t: (B, H, W, C)} -> {t: (B, R, R, C)} indexed
    [b, first_axis_query, second_axis_query, C]."""
    m = interp_matrix_1d(coords, plane_reso, padding)
    out = {}
    for t, plane in planes.items():
        m_t = m.to(plane.dtype)
        s = torch.einsum("rh,bhwc->brwc", m_t, plane)
        s = torch.einsum("qw,brwc->brqc", m_t, s)
        out[t] = s.permute(0, 2, 1, 3)  # [b, row, col] -> [b, first, second]
    return out


def sample_planes_on_lattice(planes: dict, coords: torch.Tensor, plane_reso: int,
                             padding: float):
    """One scene: {t: (H, W, C)} -> {t: (R, R, C)} indexed
    [first_axis_query, second_axis_query, C]."""
    out = sample_planes_on_lattice_batched({t: v[None] for t, v in planes.items()},
                                           coords, plane_reso, padding)
    return {t: v[0] for t, v in out.items()}


def lattice_features_batched(planes: dict, coords: torch.Tensor, model_cfg) -> dict:
    """The decoder's input features on the R^3 query lattice of B scenes
    (the JAX package's ``_lattice_features``, batched): triplanes
    {t: (B, H, W, C)} -> {t: (B, R, R, C)} by the factorized bilinear
    sampling; a grid {"grid": (B, D, H, W, C)} -> {"dense": (B, R, R, R, C)}
    by trilinear sampling at the lattice positions."""
    if "grid" in planes:
        return {"dense": sample_grid_lattice_batched(planes["grid"], coords,
                                                     model_cfg.decoder.padding)}
    return sample_planes_on_lattice_batched(planes, coords, model_cfg.encoder.plane_resolution,
                                            model_cfg.decoder.padding)


def lattice_features(planes: dict, coords: torch.Tensor, model_cfg) -> dict:
    """One scene's ``lattice_features_batched``: {t: (H, W, C)} or
    {"grid": (D, H, W, C)} -> {t: (R, R, C)} or {"dense": (R, R, R, C)}."""
    out = lattice_features_batched({t: v[None] for t, v in planes.items()}, coords, model_cfg)
    return {t: v[0] for t, v in out.items()}


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w in the promoted dtype of the two, as the JAX package's einsum
    promotes them: the grid variant's float32 lattice features (a bf16 grid
    sampled with float32 weights) against bf16 weights run in float32."""
    dtype = torch.promote_types(a.dtype, w.dtype)
    return a.to(dtype) @ w.to(dtype)


def _fused_head_weights(dec: dict, n_blocks: int):
    """Repack the stacked per-head decoder weights into one feature space
    F = heads*hidden: block-diagonal trunk weights, shared-input
    projections concatenated along the output axis."""
    e, _, h = dec["fc_p_kernel"].shape

    def cat_out(w):  # (e, c, h) -> (c, e*h)
        return torch.cat([w[i] for i in range(e)], dim=-1)

    def bd(w):  # (e, a, b) -> (e*a, e*b)
        return torch.block_diag(*[w[i] for i in range(e)])

    packed = {
        "fc_p_kernel": cat_out(dec["fc_p_kernel"]),
        "fc_p_bias": dec["fc_p_bias"].reshape(-1),
        "fc_out_kernel": bd(dec["fc_out_kernel"]),
        "fc_out_bias": dec["fc_out_bias"].reshape(-1),
    }
    for i in range(n_blocks):
        packed[f"fc_c{i}_kernel"] = cat_out(dec[f"fc_c{i}_kernel"])
        packed[f"fc_c{i}_bias"] = dec[f"fc_c{i}_bias"].reshape(-1)
        for fc in ("fc0", "fc1"):
            packed[f"block{i}_{fc}_kernel"] = bd(dec[f"block{i}_{fc}_kernel"])
            packed[f"block{i}_{fc}_bias"] = dec[f"block{i}_{fc}_bias"].reshape(-1)
    return packed, e, h


def _x_slab(shard_constraint, R: int):
    """(mesh, axis, sizes, lo, hi): this rank's x rows [lo, hi) of R under
    ``shard_constraint`` (a ``parallel.mesh.NamedSharding`` whose spec
    names the mesh axis of the (B, Rx, Ry, Rz, F) hidden state's x
    dimension), or None when x is whole on every rank."""
    spec = tuple(shard_constraint.spec) if shard_constraint is not None else ()
    axis = spec[1] if len(spec) > 1 else None
    if axis is None:
        return None
    from giga_tpu_torch.parallel.mesh import split_sizes

    mesh = shard_constraint.mesh
    sizes = split_sizes(R, mesh.size(axis))
    lo = sum(sizes[:mesh.rank(axis)])
    return mesh, axis, sizes, lo, lo + sizes[mesh.rank(axis)]


def decode_dense_batched(dec: dict, feats: dict, coords: torch.Tensor, n_blocks: int = 5,
                         shard_constraint=None):
    """Fused-head trunk on the lattice of B scenes.

    feats: {t: (B, R, R, C)}, or {"dense": (B, R, R, R, C)} for the grid
    variant. Returns (heads, B, R, R, R, out_dim).

    ``shard_constraint``: a ``parallel.mesh.NamedSharding`` of the (B, Rx,
    Ry, Rz, F) hidden state. Its x entry names the mesh axis the lattice's x
    rows are split over (see the module docstring); its batch entry says how
    the caller split the batch, which arrives here already as this rank's.
    """
    dense = feats.get("dense")
    R = coords.shape[0]
    slab = _x_slab(shard_constraint, R)
    lo, hi = (slab[3], slab[4]) if slab is not None else (0, R)
    if dense is None:
        c_dim = dec["fc_c0_kernel"].shape[1] // 3
        fxz, fxy, fyz = feats["xz"][:, lo:hi], feats["xy"][:, lo:hi], feats["yz"]
        B = fxz.shape[0]
    else:
        dense = dense[:, lo:hi]
        B = dense.shape[0]
    pk, heads, _ = _fused_head_weights(dec, n_blocks)
    coords = coords.to(pk["fc_p_kernel"].dtype)
    w_p = pk["fc_p_kernel"]
    px = coords[lo:hi, None] * w_p[0]
    py = coords[:, None] * w_p[1]
    pz = coords[:, None] * w_p[2]
    net = (px[None, :, None, None, :] + py[None, None, :, None, :]
           + pz[None, None, None, :, :] + pk["fc_p_bias"])
    net = net.expand((B,) + net.shape[1:])
    for i in range(n_blocks):
        w_c = pk[f"fc_c{i}_kernel"]
        if dense is not None:
            net = net + _mm(dense, w_c) + pk[f"fc_c{i}_bias"]
        else:
            pxz = torch.einsum("bxzc,ch->bxzh", fxz, w_c[:c_dim])
            pxy = torch.einsum("bxyc,ch->bxyh", fxy, w_c[c_dim:2 * c_dim])
            pyz = torch.einsum("byzc,ch->byzh", fyz, w_c[2 * c_dim:])
            net = (net + pxz[:, :, None, :, :] + pxy[:, :, :, None, :]
                   + pyz[:, None, :, :, :] + pk[f"fc_c{i}_bias"])
        hid = _mm(torch.relu(net), pk[f"block{i}_fc0_kernel"]) + pk[f"block{i}_fc0_bias"]
        dx = _mm(torch.relu(hid), pk[f"block{i}_fc1_kernel"]) + pk[f"block{i}_fc1_bias"]
        net = net + dx
    out = _mm(torch.relu(net), pk["fc_out_kernel"]) + pk["fc_out_bias"]
    o = dec["fc_out_bias"].shape[-1]
    out = out.reshape(B, hi - lo, R, R, heads, o).permute(4, 0, 1, 2, 3, 5)
    if slab is None:
        return out
    from giga_tpu_torch.parallel.mesh import all_gather_dim

    mesh, axis, sizes = slab[:3]
    return all_gather_dim(mesh, out, axis, dim=2, sizes=sizes)


def decode_dense(dec: dict, feats: dict, coords: torch.Tensor, n_blocks: int = 5,
                 shard_constraint=None):
    """One scene, a unit-batch wrapper over ``decode_dense_batched`` as in the
    JAX package: feats {t: (R, R, C)} -> (heads, R, R, R, out_dim).
    ``shard_constraint`` names the sharding of the (Rx, Ry, Rz, F) hidden
    state; an unsharded batch dimension is put before its spec."""
    if shard_constraint is not None:
        shard_constraint = type(shard_constraint)(shard_constraint.mesh,
                                                  (None, *shard_constraint.spec))
    out = decode_dense_batched(dec, {t: v[None] for t, v in feats.items()}, coords, n_blocks,
                               shard_constraint)
    return out[:, 0]


def decode_lattice_points(dec: dict, feats: dict, coords: torch.Tensor, ix: torch.Tensor,
                          iy: torch.Tensor, iz: torch.Tensor, n_blocks: int = 5) -> torch.Tensor:
    """The stacked decoder at sparse lattice points, index triples
    (ix, iy, iz) (N,) into ``coords``: the sparse counterpart of
    ``decode_dense`` for points on the query lattice too few for the whole
    R^3 volume, the workhorse of surface refinement in mesh generation.

    Each plane's features are gathered once as (N, C) rows from its lattice
    map (feats {t: (R, R, C)} from ``sample_planes_on_lattice``, or
    {'dense': (R, R, R, C)} for the grid variant), then the fused-head trunk
    runs on the (N, heads*hidden) matrix. Returns (heads, N, out_dim) raw
    outputs."""
    pk, heads, _ = _fused_head_weights(dec, n_blocks)
    coords = coords.to(pk["fc_p_kernel"].dtype)
    w_p = pk["fc_p_kernel"]  # (3, F)
    net = (coords[ix][:, None] * w_p[0] + coords[iy][:, None] * w_p[1]
           + coords[iz][:, None] * w_p[2] + pk["fc_p_bias"])
    dense = feats.get("dense")
    if dense is None:
        c_dim = dec["fc_c0_kernel"].shape[1] // 3
        rows = (feats["xz"][ix, iz], feats["xy"][ix, iy], feats["yz"][iy, iz])
    else:
        fd = dense[ix, iy, iz]
    for i in range(n_blocks):
        w_c = pk[f"fc_c{i}_kernel"]
        if dense is not None:
            net = net + _mm(fd, w_c) + pk[f"fc_c{i}_bias"]
        else:
            net = (net + rows[0] @ w_c[:c_dim] + rows[1] @ w_c[c_dim:2 * c_dim]
                   + rows[2] @ w_c[2 * c_dim:] + pk[f"fc_c{i}_bias"])
        hid = _mm(torch.relu(net), pk[f"block{i}_fc0_kernel"]) + pk[f"block{i}_fc0_bias"]
        dx = _mm(torch.relu(hid), pk[f"block{i}_fc1_kernel"]) + pk[f"block{i}_fc1_bias"]
        net = net + dx
    out = _mm(torch.relu(net), pk["fc_out_kernel"]) + pk["fc_out_bias"]  # (N, heads*o)
    o = dec["fc_out_bias"].shape[-1]
    return out.reshape(-1, heads, o).permute(1, 0, 2)


def _affordance(out: torch.Tensor):
    """(heads, ..., out_dim) raw heads -> qual sigmoid, rot unit-norm, width."""
    qual = torch.sigmoid(out[0, ..., 0])
    rot = out[1]
    rot = rot / torch.clamp_min(torch.linalg.vector_norm(rot, dim=-1, keepdim=True), 1e-12)
    width = out[2, ..., 0]
    return qual, rot, width


def decode_affordance_dense_batched(dec: dict, feats: dict, coords: torch.Tensor,
                                    n_blocks: int = 5, shard_constraint=None):
    """Batched (qual, rot, width): (B,R,R,R), (B,R,R,R,4), (B,R,R,R).
    ``shard_constraint`` as in ``decode_dense_batched``."""
    return _affordance(decode_dense_batched(dec, feats, coords, n_blocks, shard_constraint))


def decode_affordance_dense(dec: dict, feats: dict, coords: torch.Tensor, n_blocks: int = 5,
                            shard_constraint=None):
    """One scene's (qual, rot, width): (R,R,R), (R,R,R,4), (R,R,R).
    ``shard_constraint`` as in ``decode_dense``."""
    return _affordance(decode_dense(dec, feats, coords, n_blocks, shard_constraint))
