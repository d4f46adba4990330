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
"""

from __future__ import annotations

import numpy as np
import torch

AFFORDANCE_HEADS = ("decoder_qual", "decoder_rot", "decoder_width")


def _f32(a) -> np.ndarray:
    return np.array(a, dtype=np.float32)  # a writable copy


def flax_to_state_dict(params: dict) -> dict:
    """Flax GIGA param tree -> {name: torch.Tensor} for ``GIGANet.load_state_dict``."""
    p = params.get("params", params)
    enc = p["encoder"]
    if "unet" not in enc:
        raise NotImplementedError("only the triplane (U-Net) encoder is ported")
    sd = {}
    conv = enc["conv_in"]["conv"]
    sd["encoder.conv_in.weight"] = _f32(conv["kernel"]).transpose(4, 3, 0, 1, 2)
    sd["encoder.conv_in.bias"] = _f32(conv["bias"])

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
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def to_reference_state_dict(state: dict) -> dict:
    """This package's state -> numpy arrays under the reference's names.

    Each stacked head becomes its own LocalDecoder (``decoder_qual.fc_p`` ...,
    torch Linear layout (out, in)); fc_out keeps the stacked out_dim, so
    converting back reproduces the stacked arrays exactly.
    """
    sd = {k: v.detach().cpu().numpy() for k, v in state.items()}
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
