"""Weight bridge: the JAX package's parameter tree -> this package's state.

Input is the flax tree as numpy arrays (``params`` or ``params["params"]``
from ``net.init`` or a loaded ``.msgpack`` checkpoint). Layouts inverted:

    Conv3d          (D, H, W, I, O)      -> (O, I, D, H, W)
    Conv2d          (H, W, I, O)         -> (O, I, H, W)
    ConvTranspose2x2 (C_in, 2, 2, C_out) -> ConvTranspose2d (I, O, kH, kW)

The encoder's state-dict names are the reference's (``encoder.conv_in``,
``encoder.unet.down_convs.{i}.conv1`` ...). The stacked decoders
(``decoder_aff``, ``decoder_occ``) stay stacked per head under their flax
names. ``to_reference_state_dict`` splits the heads back out into the
reference's per-head Linear names, the form the JAX package's own
``convert_giga_state_dict`` reads.

A VGN tree (``enc_conv1`` ... ``conv_width``) maps onto VGNNet, whose
names are already the reference's (``encoder.conv1``, ``decoder.conv1``,
``conv_qual`` ...): its kernels go (D, H, W, I, O) -> (O, I, D, H, W), and
``to_reference_state_dict`` returns its state unchanged, the form the JAX
package's ``convert_vgn_state_dict`` reads.

``state_dict_to_flax`` is the inverse of ``flax_to_state_dict``: a module's
state back to the flax tree ({"params": ...}) that the JAX package's
``load_params`` gives for a checkpoint of that model.
"""

from __future__ import annotations

import numpy as np
import torch

AFFORDANCE_HEADS = ("decoder_qual", "decoder_rot", "decoder_width")


def _f32(a) -> np.ndarray:
    return np.array(a, dtype=np.float32)  # a writable copy


def _conv3d(sd: dict, key: str, tree: dict) -> None:
    sd[key + ".weight"] = _f32(tree["conv"]["kernel"]).transpose(4, 3, 0, 1, 2)
    sd[key + ".bias"] = _f32(tree["conv"]["bias"])


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _vgn_state_dict(p: dict) -> dict:
    """Flax VGN param tree -> {name: torch.Tensor} for ``VGNNet.load_state_dict``."""
    sd = {}
    for i in (1, 2, 3):
        _conv3d(sd, f"encoder.conv{i}", p[f"enc_conv{i}"])
        _conv3d(sd, f"decoder.conv{i}", p[f"dec_conv{i}"])
    for head in ("conv_qual", "conv_rot", "conv_width"):
        _conv3d(sd, head, p[head])
    return _tensors(sd)


def flax_to_state_dict(params: dict) -> dict:
    """Flax GIGA or VGN param tree -> {name: torch.Tensor} for the module's
    ``load_state_dict``."""
    p = params.get("params", params)
    if "enc_conv1" in p:
        return _vgn_state_dict(p)
    enc = p["encoder"]
    if "unet" not in enc:
        raise NotImplementedError("only the triplane (U-Net) encoder is ported")
    sd = {}
    _conv3d(sd, "encoder.conv_in", enc["conv_in"])

    def conv2d(key, tree):
        sd[key + ".weight"] = _f32(tree["conv"]["kernel"]).transpose(3, 2, 0, 1)
        sd[key + ".bias"] = _f32(tree["conv"]["bias"])

    unet = enc["unet"]
    depth = sum(1 for k in unet if k.startswith("down"))
    for i in range(depth):
        for c in ("conv1", "conv2"):
            conv2d(f"encoder.unet.down_convs.{i}.{c}", unet[f"down{i}"][c])
    for i in range(depth - 1):
        up = unet[f"up{i}"]
        sd[f"encoder.unet.up_convs.{i}.upconv.weight"] = (
            _f32(up["upconv"]["kernel"]).transpose(0, 3, 1, 2))
        sd[f"encoder.unet.up_convs.{i}.upconv.bias"] = _f32(up["upconv"]["bias"])
        for c in ("conv1", "conv2"):
            conv2d(f"encoder.unet.up_convs.{i}.{c}", up[c])
    conv2d("encoder.unet.conv_final", unet["conv_final"])

    for dec in ("decoder_aff", "decoder_occ"):
        for name, arr in p.get(dec, {}).items():
            sd[f"{dec}.{name}"] = _f32(arr)
    return _tensors(sd)


def state_dict_to_flax(state: dict) -> dict:
    """{name: tensor} of a GIGANet or VGNNet -> the flax parameter tree
    {"params": ...} of numpy float32 arrays that ``flax_to_state_dict``
    maps back to the same state, value for value."""
    sd = {k: v.detach().cpu().numpy() for k, v in state.items()}
    p = {}

    def conv(tree: dict, key: str, order) -> None:
        tree["conv"] = {"kernel": np.ascontiguousarray(sd[key + ".weight"].transpose(order)),
                        "bias": sd[key + ".bias"]}

    if "conv_qual.weight" in sd:
        for i in (1, 2, 3):
            conv(p.setdefault(f"enc_conv{i}", {}), f"encoder.conv{i}", (2, 3, 4, 1, 0))
            conv(p.setdefault(f"dec_conv{i}", {}), f"decoder.conv{i}", (2, 3, 4, 1, 0))
        for head in ("conv_qual", "conv_rot", "conv_width"):
            conv(p.setdefault(head, {}), head, (2, 3, 4, 1, 0))
        return {"params": p}
    enc = p["encoder"] = {"conv_in": {}, "unet": {}}
    conv(enc["conv_in"], "encoder.conv_in", (2, 3, 4, 1, 0))
    unet = enc["unet"]
    depth = sum(1 for k in sd
                if k.startswith("encoder.unet.down_convs.") and k.endswith("conv1.weight"))
    for i in range(depth):
        down = unet[f"down{i}"] = {}
        for c in ("conv1", "conv2"):
            conv(down.setdefault(c, {}), f"encoder.unet.down_convs.{i}.{c}", (2, 3, 1, 0))
    for i in range(depth - 1):
        key = f"encoder.unet.up_convs.{i}"
        up = unet[f"up{i}"] = {"upconv": {
            "kernel": np.ascontiguousarray(sd[key + ".upconv.weight"].transpose(0, 2, 3, 1)),
            "bias": sd[key + ".upconv.bias"]}}
        for c in ("conv1", "conv2"):
            conv(up.setdefault(c, {}), f"{key}.{c}", (2, 3, 1, 0))
    conv(unet.setdefault("conv_final", {}), "encoder.unet.conv_final", (2, 3, 1, 0))
    for dec in ("decoder_aff", "decoder_occ"):
        leaves = {k.split(".", 1)[1]: v for k, v in sd.items() if k.startswith(dec + ".")}
        if leaves:
            p[dec] = leaves
    return {"params": p}


def to_reference_state_dict(state: dict) -> dict:
    """This package's state -> numpy arrays under the reference's names.

    Each stacked head becomes its own LocalDecoder (``decoder_qual.fc_p`` ...,
    torch Linear layout (out, in)); fc_out keeps the stacked out_dim, so
    converting back reproduces the stacked arrays exactly. A VGN state is
    under the reference's names already.
    """
    sd = {k: v.detach().cpu().numpy() for k, v in state.items()}
    if "conv_qual.weight" in sd:
        return sd
    out = {k: v for k, v in sd.items() if k.startswith("encoder.")}
    groups = {"decoder_aff": AFFORDANCE_HEADS, "decoder_occ": ("decoder_tsdf",)}
    for dec, names in groups.items():
        if f"{dec}.fc_p_kernel" not in sd:
            continue
        n_blocks = sum(1 for k in sd if k.startswith(f"{dec}.fc_c") and k.endswith("_kernel"))

        def linear(dst, src, h):
            out[dst + ".weight"] = sd[f"{dec}.{src}_kernel"][h].T
            out[dst + ".bias"] = sd[f"{dec}.{src}_bias"][h]

        for h, name in enumerate(names):
            linear(f"{name}.fc_p", "fc_p", h)
            linear(f"{name}.fc_out", "fc_out", h)
            for i in range(n_blocks):
                linear(f"{name}.fc_c.{i}", f"fc_c{i}", h)
                linear(f"{name}.blocks.{i}.fc_0", f"block{i}_fc0", h)
                linear(f"{name}.blocks.{i}.fc_1", f"block{i}_fc1", h)
    return out
