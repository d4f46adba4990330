"""Model factory + checkpoint loading (counterpart of giga_tpu/models/registry.py).

``get_network(name)`` returns (module, config). ``load_network(path)`` reads
a flax ``.msgpack`` parameter file with the pure-Python reader, or the
reference's own torch ``.pt`` checkpoint (a state dict or a whole module,
``torch.load(map_location="cpu", weights_only=True)``), and loads it
through the weight bridge. The model type is inferred from the filename
pattern ``{prefix}_{type}_...`` when not given; a ``vgn`` type builds a VGNNet,
every other preset a GIGANet. ``init_network(name, seed)`` gives a preset
seeded random weights without the JAX package (``seed_weights``, for kernel
and parity tests); ``reference_init(net, seed)`` draws a module's weights by
the JAX package's ``net.init`` rules, the start of a training run from
scratch. ``save_network`` writes a
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


def _uniform(p: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    bound = fan_in ** -0.5
    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))


def _truncated_normal(p: torch.Tensor, variance: float, gen: torch.Generator) -> None:
    """flax's ``variance_scaling(..., "truncated_normal")``: a normal cut at
    two of its deviations, widened so the cut one has ``variance``."""
    std = variance ** 0.5 / 0.87962566103423978
    p.copy_(torch.nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std, -2 * std, 2 * std,
                                        generator=gen))


def reference_init(net: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """``net`` with the weights the JAX package's ``net.init`` draws, by its
    rules (the reference's torch initialization), for training from scratch.
    The draws come from a ``torch.Generator`` seeded with ``seed``, module by
    module in ``named_modules`` order, so they share JAX's distributions,
    not its numbers. The rules, from every initializer in
    ``giga_tpu/models/*.py``:

    * ``TorchDense`` (layers.py:48-55): kernel ``torch_weight_init``
      (layers.py:21, U(+-1/sqrt(fan_in))), bias ``torch_bias_init(fan_in)``
      (layers.py:28) -- every Linear of the point encoders (pointnet.py:71,
      77, 151, 157) and of the FC, patch and point decoders (decoder.py:113,
      181-185, 210-214);
    * ``ResnetBlockFC`` (layers.py:77): ``fc_1``'s kernel
      ``kernel_init=zeros``, so each block starts as the identity; its
      bias, ``fc_0`` and the bias-free ``shortcut`` (layers.py:82) are
      ``TorchDense``'s;
    * ``StackedLocalDecoder._stack_param`` (decoder.py:50-55): every stacked
      kernel and bias U(+-1/sqrt(fan_in)) of its kernel, ``zero=True`` for
      ``block{i}_fc1_kernel`` (decoder.py:78);
    * ``TorchConv`` (layers.py:117-137): ``xavier=True`` (layers.py:134,
      the U-Net's Conv2d at unet2d.py:41-42, 62-63, 85) gives
      ``xavier_normal_init`` (layers.py:25, glorot's truncated normal,
      variance 2 / (fan_in + fan_out)) and a zero bias; otherwise
      ``kernel_init`` or ``torch_weight_init`` and ``torch_bias_init``
      (VGN, vgn.py:43-52; the 3D U-Net's bias-free convs, unet3d.py:49, and
      its ``final_conv``, unet3d.py:104);
    * ``torch_conv`` (layers.py:87-105): ``torch_weight_init`` and a zero
      ``bias_init``; no module of ``giga_tpu/models`` builds one, so no
      parameter here takes it;
    * ``ConvTranspose2x2`` (layers.py:168-169): kernel and bias
      ``torch_bias_init(4 * features)``, torch's fan_in of the (I, O, 2, 2)
      layout;
    * ``ZBandedConvStem`` (layers.py:204-205): ``torch_weight_init`` and
      ``torch_bias_init(k**3)``;
    * PointNet++'s ``SharedMLP`` (pointnetpp.py:73-74): ``torch_weight_init``
      and ``torch_bias_init(fan_in)``;
    * ``GlobalVoxelEncoder`` (encoder.py:139-144): flax's ``nn.Conv`` and
      ``nn.Dense`` defaults, ``lecun_normal`` (truncated normal, variance
      1 / fan_in) and a zero bias;
    * GroupNorm (unet3d.py:48) and BatchNorm (pointnetpp.py:76): scale 1,
      bias 0 (a BatchNorm's running mean 0 and variance 1).
    """
    from giga_tpu_torch.models.decoder import StackedLocalDecoder
    from giga_tpu_torch.models.encoder import GlobalVoxelEncoder
    from giga_tpu_torch.models.layers import ResnetBlockFC
    from giga_tpu_torch.models.pointnetpp import FlaxBatchNorm
    from giga_tpu_torch.models.unet2d import UNet2D

    nn = torch.nn
    fan_in = lambda w: nn.init._calculate_fan_in_and_fan_out(w)[0]  # noqa: E731
    modules = list(net.modules())
    xavier = {id(c) for u in modules if isinstance(u, UNet2D)
              for c in u.modules() if type(c) is nn.Conv2d}
    lecun = {id(c) for g in modules if isinstance(g, GlobalVoxelEncoder)
             for c in g.modules() if isinstance(c, (nn.Conv3d, nn.Linear))}
    zero_weight = {id(b.fc_1) for b in modules if isinstance(b, ResnetBlockFC)}
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in modules:
            if isinstance(m, StackedLocalDecoder):
                for name, p in m.named_parameters(recurse=False):
                    if name.endswith("fc1_kernel"):
                        p.zero_()
                    else:
                        _uniform(p, getattr(m, name.replace("_bias", "_kernel")).shape[1], gen)
            elif isinstance(m, (nn.GroupNorm, FlaxBatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.modules.conv._ConvNd)):
                w, b = m.weight, m.bias
                if id(m) in xavier:
                    fan_out = nn.init._calculate_fan_in_and_fan_out(w)[1]
                    _truncated_normal(w, 2.0 / (fan_in(w) + fan_out), gen)
                elif id(m) in lecun:
                    _truncated_normal(w, 1.0 / fan_in(w), gen)
                elif id(m) in zero_weight:
                    w.zero_()
                else:
                    _uniform(w, fan_in(w), gen)
                if b is not None:
                    if id(m) in xavier or id(m) in lecun:
                        b.zero_()
                    else:
                        _uniform(b, fan_in(w), gen)
        for m in modules:
            if isinstance(m, FlaxBatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return net


def init_network(name: str, seed: int = 0):
    """(module in eval mode, config) of a preset with seeded random weights
    (``seed_weights``), for presets that ship no checkpoint. A training run
    from scratch starts from ``reference_init`` instead."""
    net, cfg = get_network(name)
    return seed_weights(net, seed).eval(), cfg
