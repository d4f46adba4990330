"""Model factory + checkpoint loading (counterpart of giga_tpu/models/registry.py).

``get_network(name)`` returns (module, config). ``load_network(path)`` reads
a flax ``.msgpack`` parameter file with the pure-Python reader and loads it
through the weight bridge. The model type is inferred from the filename
pattern ``{prefix}_{type}_...`` when not given.
"""

from __future__ import annotations

from pathlib import Path

from giga_tpu_torch.core.config import get_config
from giga_tpu_torch.models.checkpoint import load_params
from giga_tpu_torch.models.conv_onet import GIGANet
from giga_tpu_torch.models.convert import flax_to_state_dict


def get_network(name: str):
    """Build (GIGANet, config) for a preset name, weights zero until loaded."""
    cfg = get_config(name)
    return GIGANet(cfg), cfg


def infer_model_type(path) -> str:
    """Reference convention: model name is stem tokens [1:-1] (networks.py:29)."""
    return "_".join(Path(path).stem.split("_")[1:-1])


def load_network(path, model_type: str | None = None):
    """Load a ``.msgpack`` checkpoint -> (GIGANet in eval mode, config). The
    module is built in host memory; callers move it where it runs."""
    path = Path(path)
    if path.suffix != ".msgpack":
        raise NotImplementedError(f"only .msgpack checkpoints are supported, got {path}")
    net, cfg = get_network(model_type or infer_model_type(path))
    net.load_state_dict(flax_to_state_dict(load_params(path)))
    return net.eval(), cfg
