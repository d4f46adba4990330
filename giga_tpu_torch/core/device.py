"""Where the port's entry points run (the card unless the caller asks for
the CPU), and how host arrays get there."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card; without one that is an error, not the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def to_device(arrays: dict, device) -> dict:
    """{name: array} on ``device``: tensors already there as they are; numpy
    arrays (and host tensors) packed into one pinned host buffer and uploaded
    to the card in one asynchronous copy (no sync), or wrapped without a copy
    on the CPU."""
    device = torch.device(device)
    out, host = {}, {}
    for k, v in arrays.items():
        if isinstance(v, torch.Tensor) and v.device.type == device.type:
            out[k] = v
        else:
            host[k] = np.ascontiguousarray(v.numpy() if isinstance(v, torch.Tensor) else v)
    if host and device.type != "cuda":
        out.update((k, torch.from_numpy(v)) for k, v in host.items())
    elif host:
        offsets, total = {}, 0
        for k, v in host.items():
            offsets[k] = total
            total += -(-v.nbytes // 16) * 16
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        view = buf.numpy()
        for k, v in host.items():
            view[offsets[k]:offsets[k] + v.nbytes] = v.reshape(-1).view(np.uint8)
        dev = buf.to(device, non_blocking=True)
        for k, v in host.items():
            dtype = torch.from_numpy(v[:0]).dtype
            out[k] = dev[offsets[k]:offsets[k] + v.nbytes].view(dtype).view(v.shape)
    return {k: out[k] for k in arrays}
