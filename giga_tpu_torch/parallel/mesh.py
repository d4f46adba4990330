"""Device mesh + sharding helpers (counterpart of giga_tpu/parallel/mesh.py
and of ``jax.sharding.Mesh``).

At GIGA's scale (~600k params) the decomposition is pure data parallelism:
parameters replicated, the batch sharded over a 1-D ``dp`` mesh. The dense
R^3 decode can also shard its lattice x axis over an ``sp`` axis: the decode
is a pure map over query points, and the plane features (3 x 40^2 x 32
floats ~ 600 KB) replicate, so no halo exchange is needed.

One process per card (``distributed.initialize``): a ``Mesh`` names the
axes of the process group as ``torch.distributed.device_mesh`` lays them
out, 1-D ``("dp",)`` / ``("sp",)`` or 2-D ``("dp", "sp")``. Where the JAX
package places a global array with a sharding, the port moves between the
global host view, which every rank holds, and this rank's shard on its
device: ``shard_batch`` takes the shard, ``gather_batch`` and
``all_gather_dim`` put the global result back together on every rank.
Every gather and reduction here is one collective over one flat buffer
(per dtype), in the list form of ``all_gather`` that NCCL and gloo both
take.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from giga_tpu_torch.core.device import to_device


class Mesh:
    """The process group's ranks laid out on named axes, one rank per
    device; ``shape`` (one size an axis) must multiply to the world size.
    ``device`` is this rank's device: the card made current by
    ``distributed.initialize`` unless the caller asks for the CPU."""

    def __init__(self, shape, axis_names, device=None):
        from torch.distributed.device_mesh import init_device_mesh

        if not dist.is_initialized():
            raise RuntimeError("no process group: call parallel.distributed.initialize first")
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} differ in length")
        if math.prod(shape) != dist.get_world_size():
            raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} ranks, the group "
                             f"has {dist.get_world_size()}: one process per device")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device available; pass device='cpu' to run on "
                                   "the CPU")
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = torch.device(device)
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.device_mesh = init_device_mesh(self.device.type, shape, mesh_dim_names=axis_names)

    def size(self, axis: str | None = None) -> int:
        """Ranks along ``axis`` (all ranks for None)."""
        return math.prod(self.shape.values()) if axis is None else self.shape[axis]

    def rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of the ranks that share every other coordinate."""
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


class NamedSharding(NamedTuple):
    """A sharding spec (``jax.sharding.NamedSharding(mesh, P(*spec))``): for
    each leading dimension of an array, the mesh axis it is split over, or
    None where it is whole on every rank."""

    mesh: Mesh
    spec: tuple = ()


class Shard(dict):
    """{name: tensor}: this rank's shard of a global batch, on its device.
    ``shard_batch`` passes one through unchanged, as ``jax.device_put`` of an
    array already placed with the same sharding is a no-op."""


def make_mesh(n_devices: int | None = None, axis: str = "dp", device=None) -> Mesh:
    """1-D mesh over the process group. ``n_devices`` must equal the world
    size: one process per card."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}) in a group of {world} processes: one "
                         f"process per device, so the mesh spans the world")
    return Mesh((world,), (axis,), device)


def batch_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Leading-axis sharding for batched arrays."""
    return NamedSharding(mesh, (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def split_sizes(n: int, parts: int) -> list[int]:
    """``torch.tensor_split``'s piece lengths: the first ``n % parts``
    pieces one longer (R=40 over 3 ranks: 14, 13, 13)."""
    return [n // parts + (i < n % parts) for i in range(parts)]


def shard_batch(mesh: Mesh, tree: dict, axis: str = "dp") -> Shard:
    """This rank's slice of the global host batch ({name: array or
    tensor}, batch axis first), on this rank's device: host arrays in one
    pinned copy (``to_device``), tensors moved as they are. The batch must
    divide by the mesh size along ``axis``, as in JAX."""
    if isinstance(tree, Shard):
        return tree
    n, r = mesh.size(axis), mesh.rank(axis)
    host, moved = {}, {}
    for k, v in tree.items():
        if v.shape[0] % n:
            raise ValueError(f"batch axis of {k!r} ({v.shape[0]}) not divisible by the "
                             f"{n} ranks of mesh axis {axis!r}")
        b = v.shape[0] // n
        if isinstance(v, torch.Tensor):
            moved[k] = v[r * b:(r + 1) * b].to(mesh.device, non_blocking=True)
        else:
            host[k] = np.asarray(v)[r * b:(r + 1) * b]
    moved.update(to_device(host, mesh.device))
    return Shard((k, moved[k]) for k in tree)


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def replicate(mesh: Mesh, tree: dict) -> dict:
    """{name: array or tensor} -> the same on this rank's device, every rank
    holding rank 0's values (one broadcast per dtype)."""
    local = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
             .to(mesh.device) for k, v in tree.items()}
    out = {}
    for dtype in dict.fromkeys(t.dtype for t in local.values()):
        keys = [k for k, t in local.items() if t.dtype == dtype]
        flat = _flat([local[k] for k in keys]).contiguous()
        dist.broadcast(flat, src=0)
        for k, piece in zip(keys, torch.split(flat, [local[k].numel() for k in keys])):
            out[k] = piece.view(local[k].shape)
    return {k: out[k] for k in tree}


def all_reduce_sum(mesh: Mesh, tensors, axis: str) -> list[torch.Tensor]:
    """Each tensor summed over the ranks along ``axis``, in one all-reduce
    of one flat buffer (the tensors share a dtype); new tensors."""
    tensors = list(tensors)
    flat = _flat(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return [p.view(t.shape) for p, t in
            zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def _gather_rows(mesh: Mesh, rows: torch.Tensor, axis: str) -> torch.Tensor:
    """(b, m) on every rank -> (n*b, m), rank-ordered along ``axis``."""
    rows = rows.contiguous()
    parts = [torch.empty_like(rows) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, rows, group=mesh.group(axis))
    return torch.cat(parts)


def gather_batch(mesh: Mesh, tree, axis: str = "dp"):
    """The global batch of a batch-sharded result on every rank: each leaf
    (b, ...) -> (n*b, ...), the shards in rank order along ``axis``. ``tree``
    is a dict or a (named) tuple of tensors on this rank's device; one
    all-gather per dtype, of the leaves packed side by side a row."""
    named = isinstance(tree, dict)
    keys = list(tree) if named else list(range(len(tree)))
    leaves = [tree[k] for k in keys]
    out = [None] * len(leaves)
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        idx = [i for i, t in enumerate(leaves) if t.dtype == dtype]
        b = leaves[idx[0]].shape[0]
        widths = [leaves[i][0].numel() for i in idx]
        rows = torch.cat([leaves[i].reshape(b, -1) for i in idx], dim=1)
        full = _gather_rows(mesh, rows, axis)
        for i, piece in zip(idx, torch.split(full, widths, dim=1)):
            out[i] = piece.reshape(full.shape[0], *leaves[i].shape[1:])
    if named:
        return dict(zip(keys, out))
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def all_gather_dim(mesh: Mesh, local: torch.Tensor, axis: str, dim: int,
                   sizes: list[int]) -> torch.Tensor:
    """Every rank's slab along ``dim`` (rank i holds ``sizes[i]`` rows) put
    back together in rank order on every rank. Slabs are padded to the
    longest, as GSPMD pads an uneven split, so the gather's pieces share a
    shape."""
    longest = max(sizes)
    pad = longest - local.shape[dim]
    if pad:
        shape = list(local.shape)
        shape[dim] = pad
        local = torch.cat([local, local.new_zeros(shape)], dim=dim)
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in sizes]
    dist.all_gather(parts, local, group=mesh.group(axis))
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)
