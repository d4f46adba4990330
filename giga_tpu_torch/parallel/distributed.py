"""Process-group initialization + cross-process utilities (counterpart of
giga_tpu/parallel/distributed.py).

The JAX package runs one controller per host that sees every chip; PyTorch's
idiom is one process per card, SPMD: every rank runs the same program on
its own device and the ranks meet in collectives. ``initialize()`` wires
``torch.distributed`` from explicit arguments or from a launcher's
environment (torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/
``MASTER_ADDR``, or SLURM's), selects this rank's card before anything
touches CUDA, and is a no-op for a single-process run.

Exercised by tests/test_torch_parallel.py: a 2-rank gloo group on the CPU
initializes, agrees on ranks and batch slices, and reduces across ranks.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# env vars that mean "a launcher configured a group for us"
_CLUSTER_ENV_VARS = ("MASTER_ADDR", "TORCHELASTIC_RUN_ID", "SLURM_JOB_ID")
DEFAULT_PORT = 29500
DEFAULT_TIMEOUT_S = 600.0


def _launcher_env() -> dict | None:
    """{address, world, rank, local_rank} from torchrun's or SLURM's
    variables, or None when neither configured a group."""
    env = os.environ
    if not any(v in env for v in _CLUSTER_ENV_VARS):
        return None
    if "RANK" in env and "WORLD_SIZE" in env:  # torchrun (or any env:// launcher)
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
    elif "SLURM_PROCID" in env:
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        local = int(env.get("SLURM_LOCALID", rank))
    else:
        raise RuntimeError("a cluster environment is set but names no rank: need RANK and "
                           "WORLD_SIZE (torchrun) or SLURM_PROCID and SLURM_NTASKS (SLURM)")
    host = env.get("MASTER_ADDR") or env.get("SLURM_LAUNCH_NODE_IPADDR")
    if host is None:
        raise RuntimeError("a cluster environment is set but names no coordinator: "
                           "set MASTER_ADDR")
    port = env.get("MASTER_PORT", str(DEFAULT_PORT))
    return {"address": f"{host}:{port}", "world": world, "rank": rank, "local_rank": local}


def local_device(device=None, local_rank: int | None = None) -> torch.device:
    """This rank's device: ``device`` as given when it names one (``"cpu"``,
    ``"cuda:0"``), else the card ``cuda:{local_rank % cards}`` (the local
    rank from the launcher, else the global rank). Without a card that is
    an error, not the CPU."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK",
                                        dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend: str | None = None, device=None,
               timeout: float = DEFAULT_TIMEOUT_S, **kwargs) -> bool:
    """Idempotent ``torch.distributed`` init. Returns True when running
    distributed.

    - With explicit args (or a launcher's environment), initialization errors
      PROPAGATE: a misconfigured group must fail loudly, not degrade to
      silent single-process training.
    - With no args and no launcher environment, this is a documented no-op
      so single-process scripts can call it unconditionally.

    ``coordinator_address`` is ``host:port`` (TCP rendezvous) or a URL
    (``tcp://...``, ``file://...``). ``device`` is this rank's device
    (``local_device``): the card by default, ``"cpu"`` for a CPU group. The
    backend is ``nccl`` on the card and ``gloo`` on the CPU unless given
    (``gloo`` also runs on CUDA tensors, through the host: the one way for
    several ranks to share one card, which NCCL refuses). With a card, its
    device is made current before the group is created. ``timeout`` (s)
    bounds the rendezvous and every collective, so a lost peer fails
    instead of hanging.
    """
    if dist.is_initialized():
        return True
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    env = _launcher_env()
    if not explicit and env is None:
        return False  # single-process run; nothing to wire
    env = env or {}
    address = coordinator_address or env.get("address")
    world = num_processes if num_processes is not None else env.get("world")
    rank = process_id if process_id is not None else env.get("rank")
    if address is None or world is None or rank is None:
        raise ValueError("initialize needs a coordinator address, the number of processes and "
                         f"this process's id (got {address!r}, {world!r}, {rank!r})")
    local = env.get("local_rank", rank)
    device = local_device(device, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    init_method = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(backend, init_method=init_method, world_size=int(world),
                            rank=int(rank), timeout=datetime.timedelta(seconds=timeout),
                            **kwargs)
    return True


def shutdown() -> None:
    """Destroy the process group, if any (each rank, at its end)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank (a no-op outside a group)."""
    if dist.is_initialized():
        dist.barrier()


def global_batch_slice(global_batch: int) -> slice:
    """This process's slice of a globally-sharded batch (per-process data loading)."""
    n = process_count()
    if global_batch % n:
        # silent truncation would drop the remainder rows from every epoch
        raise ValueError(f"global_batch {global_batch} not divisible by process_count {n}")
    per_rank = global_batch // n
    start = process_index() * per_rank
    return slice(start, start + per_rank)
