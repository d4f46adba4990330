"""Model factory + checkpoint loading (counterpart of giga_tpu/models/registry.py).

``get_network(name)`` returns (module, config). ``load_network(path)`` reads
a flax ``.msgpack`` parameter file with the pure-Python reader, or the
reference's own torch ``.pt`` checkpoint (a state dict or a whole module,
``torch.load(map_location="cpu", weights_only=True)``), and loads it
through the weight bridge. The model type is inferred from the filename
pattern ``{prefix}_{type}_...`` when not given; a ``vgn`` type builds a VGNNet,
every other preset a GIGANet. ``init_network(name, seed)`` gives a preset
seeded random weights without the JAX package. ``save_network`` writes a
module's weights as the flax ``.msgpack`` file the JAX package's
``load_params`` reads (``save_params`` writes a flax tree as it is).
"""

from __future__ import annotations

from pathlib import Path

import torch

from giga_tpu_torch.core.config import VGNConfig, get_config
from giga_tpu_torch.models.checkpoint import load_params, save_params
from giga_tpu_torch.models.conv_onet import GIGANet
from giga_tpu_torch.models.convert import (
    flax_to_state_dict,
    from_reference_state_dict,
    state_dict_to_flax,
)
from giga_tpu_torch.models.vgn import VGNNet


def get_network(name: str):
    """Build (GIGANet or VGNNet, config) for a preset name, weights
    PyTorch's default until loaded."""
    cfg = get_config(name)
    if isinstance(cfg, VGNConfig):
        return VGNNet(cfg), cfg
    return GIGANet(cfg), cfg


def infer_model_type(path) -> str:
    """Reference convention: model name is stem tokens [1:-1] (networks.py:29)."""
    return "_".join(Path(path).stem.split("_")[1:-1])


def load_reference_state_dict(path) -> dict:
    """A ``.pt`` file -> its state dict: ``torch.load`` on the CPU with
    ``weights_only=True``; a saved module gives its ``state_dict()``."""
    obj = torch.load(Path(path), map_location="cpu", weights_only=True)
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def load_network(path, model_type: str | None = None):
    """Load a ``.pt`` (the reference's names) or ``.msgpack`` (a flax tree)
    checkpoint -> (module in eval mode, config). The module is built in host
    memory; callers move it where it runs."""
    path = Path(path)
    net, cfg = get_network(model_type or infer_model_type(path))
    if path.suffix == ".pt":
        state = from_reference_state_dict(load_reference_state_dict(path),
                                          None if isinstance(cfg, VGNConfig) else cfg)
    else:
        state = flax_to_state_dict(load_params(path))
    net.load_state_dict(state)
    return net.eval(), cfg


def save_network(net: torch.nn.Module, path) -> None:
    """Write ``net``'s weights as a flax ``.msgpack`` parameter file."""
    save_params(state_dict_to_flax(net.state_dict()), path)


def seed_weights(net: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """``net`` with seeded random weights: every weight and bias uniform in
    +-1/sqrt(fan_in) of its layer (torch's default bound for Linear and
    Conv layers; a stacked decoder weight (heads, fan_in, out) and its bias
    take the weight's; a GroupNorm or BatchNorm keeps scale 1 and bias 0),
    drawn in parameter order from a ``torch.Generator`` seeded with
    ``seed``."""
    params = dict(net.named_parameters())
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name_, p in params.items():
            if name_.endswith(("_kernel", "_bias")):
                fan_in = params[name_.replace("_bias", "_kernel")].shape[1]
            else:
                weight = params[name_.rsplit(".", 1)[0] + ".weight"]
                if weight.ndim < 2:  # a norm layer keeps its scale 1 and bias 0
                    continue
                fan_in = torch.nn.init._calculate_fan_in_and_fan_out(weight)[0]
            p.uniform_(-fan_in ** -0.5, fan_in ** -0.5, generator=gen)
    return net


def init_network(name: str, seed: int = 0):
    """(module in eval mode, config) of a preset with seeded random weights
    (``seed_weights``), for presets that ship no checkpoint."""
    net, cfg = get_network(name)
    return seed_weights(net, seed).eval(), cfg
