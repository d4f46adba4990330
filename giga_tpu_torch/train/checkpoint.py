"""Full training-state persistence + resume (counterpart of
giga_tpu/train/checkpoint.py, which uses orbax).

Goes beyond the reference (torch state_dict of params only, no optimizer
state or mid-training resume: networks.py:21-35, train_giga.py:97-117):
saves params + optimizer state + step count + epoch, one ``torch.save``
file an epoch, keeping the last ``max_to_keep``, beside a
``metrics_{epoch}.json`` sidecar. Files are read back with
``torch.load(weights_only=True)``: tensors, lists, dicts and numbers only.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch


class CheckpointManager:
    """{params, optimizer state, step, epoch} per epoch under ``directory``."""

    def __init__(self, directory, max_to_keep: int = 2):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, epoch: int) -> Path:
        return self.directory / f"state_{epoch}.pt"

    def epochs(self) -> list[int]:
        return sorted(int(p.stem.split("_")[1]) for p in self.directory.glob("state_*.pt"))

    def save(self, epoch: int, state, metrics: Optional[dict] = None) -> None:
        host = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        opt = state.tx.state_dict()
        payload = {
            "params": {k: host(v) for k, v in state.module.state_dict().items()},
            "opt": {k: [host(t) for t in v] if isinstance(v, list) else host(v)
                    for k, v in opt.items()},
            "step": int(state.step),
            "epoch": int(epoch),
        }
        tmp = self._path(epoch).with_suffix(".tmp")
        torch.save(payload, tmp)
        tmp.replace(self._path(epoch))
        for old in self.epochs()[:-self.max_to_keep]:
            self._path(old).unlink()
        # metrics sidecar (variable keys, kept out of the state file)
        path = self.directory / f"metrics_{epoch}.json"
        path.write_text(json.dumps({k: float(v) for k, v in (metrics or {}).items()}))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, state_template, epoch: Optional[int] = None):
        """Load into ``state_template`` (its module and optimizer, in place);
        returns (state, metrics, epoch) or None if no checkpoint exists."""
        step = epoch if epoch is not None else self.latest_epoch()
        if step is None:
            return None
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        with torch.no_grad():
            for k, p in state_template.module.state_dict().items():
                p.copy_(payload["params"][k])
        state_template.tx.load_state_dict(payload["opt"])
        state_template.step = payload["step"]
        metrics_path = self.directory / f"metrics_{step}.json"
        metrics = json.loads(metrics_path.read_text()) if metrics_path.exists() else {}
        return state_template, metrics, payload["epoch"]
