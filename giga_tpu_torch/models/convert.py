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

The grid encoder's 3D U-Net (``encoder.unet3d``) keeps the reference's
names too (``encoders.{i}.basic_module.SingleConv1.groupnorm`` ...): flax's
GroupNorm scale / bias are its weight / bias, its bias-free convs go
(D, H, W, I, O) -> (O, I, D, H, W). A ``GlobalVoxelEncoder`` tree
(``conv_in``, ``conv_0`` .. ``conv_3``, ``fc``) maps onto that module under
the reference's names; its FC rows go from flax's channels-last flatten to
torch's channel-major one.

``state_dict_to_flax`` is the inverse of ``flax_to_state_dict``: a module's
state back to the flax tree ({"params": ...}) that the JAX package's
``load_params`` gives for a checkpoint of that model.
``from_reference_state_dict`` reads the reference's own state dicts (a
``.pt`` checkpoint): the counterpart of the JAX package's
``convert_giga_state_dict`` / ``convert_vgn_state_dict`` /
``convert_global_voxel_encoder_state_dict``, onto this package's names.
"""

from __future__ import annotations

import re

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


UNET3D_CONVS = ("SingleConv1", "SingleConv2")
GLOBAL_CONVS = ("conv_in", "conv_0", "conv_1", "conv_2", "conv_3")


def _unet3d_levels(names) -> dict:
    """{"encoders": n, "decoders": n - 1} from flax names (``encoders_{i}``)
    or state-dict names (``encoder.unet3d.encoders.{i}...``)."""
    out = {}
    for kind in ("encoders", "decoders"):
        idx = {int(n.replace(".", "_").split(kind + "_")[1].split("_")[0])
               for n in names if kind + "_" in n.replace(".", "_")}
        out[kind] = max(idx) + 1 if idx else 0
    return out


def _unet3d_state_dict(sd: dict, prefix: str, tree: dict) -> None:
    """Flax UNet3D tree -> the reference's state-dict names under ``prefix``."""
    levels = _unet3d_levels(tree)
    for kind, n in levels.items():
        for i in range(n):
            for c in UNET3D_CONVS:
                t = tree[f"{kind}_{i}"][c]
                key = f"{prefix}.{kind}.{i}.basic_module.{c}"
                sd[key + ".groupnorm.weight"] = _f32(t["groupnorm"]["scale"])
                sd[key + ".groupnorm.bias"] = _f32(t["groupnorm"]["bias"])
                sd[key + ".conv.weight"] = _f32(t["conv"]["conv"]["kernel"]).transpose(4, 3, 0, 1, 2)
    _conv3d(sd, f"{prefix}.final_conv", tree["final_conv"])


def _unet3d_flax(sd: dict, prefix: str) -> dict:
    """The inverse of ``_unet3d_state_dict``."""
    tree = {}
    for kind, n in _unet3d_levels([k[len(prefix):] for k in sd if k.startswith(prefix)]).items():
        for i in range(n):
            level = tree[f"{kind}_{i}"] = {}
            for c in UNET3D_CONVS:
                key = f"{prefix}.{kind}.{i}.basic_module.{c}"
                level[c] = {
                    "groupnorm": {"scale": sd[key + ".groupnorm.weight"],
                                  "bias": sd[key + ".groupnorm.bias"]},
                    "conv": {"conv": {"kernel": np.ascontiguousarray(
                        sd[key + ".conv.weight"].transpose(2, 3, 4, 1, 0))}}}
    key = f"{prefix}.final_conv"
    tree["final_conv"] = {"conv": {
        "kernel": np.ascontiguousarray(sd[key + ".weight"].transpose(2, 3, 4, 1, 0)),
        "bias": sd[key + ".bias"]}}
    return tree


def _global_state_dict(p: dict) -> dict:
    """Flax GlobalVoxelEncoder tree -> {name: torch.Tensor}: the FC's rows,
    flax's (d, h, w, c)-major flatten of the 2^3 x 512 block, reordered to
    torch's (c, d, h, w)-major one."""
    sd = {}
    for name in GLOBAL_CONVS:
        sd[name + ".weight"] = _f32(p[name]["kernel"]).transpose(4, 3, 0, 1, 2)
        sd[name + ".bias"] = _f32(p[name]["bias"])
    w = _f32(p["fc"]["kernel"])  # (2*2*2*512, c_dim)
    c_dim = w.shape[1]
    sd["fc.weight"] = w.reshape(2, 2, 2, 512, c_dim).transpose(4, 3, 0, 1, 2).reshape(c_dim, -1)
    sd["fc.bias"] = _f32(p["fc"]["bias"])
    return _tensors(sd)


def _global_flax(sd: dict) -> dict:
    """The inverse of ``_global_state_dict``."""
    p = {name: {"kernel": np.ascontiguousarray(sd[name + ".weight"].transpose(2, 3, 4, 1, 0)),
                "bias": sd[name + ".bias"]} for name in GLOBAL_CONVS}
    w = sd["fc.weight"]  # (c_dim, 512*2*2*2), (c, d, h, w)-major
    c_dim = w.shape[0]
    p["fc"] = {"kernel": np.ascontiguousarray(
        w.reshape(c_dim, 512, 2, 2, 2).transpose(2, 3, 4, 1, 0).reshape(-1, c_dim)),
        "bias": sd["fc.bias"]}
    return {"params": p}


def flax_to_state_dict(params: dict) -> dict:
    """Flax GIGA (triplane or grid), VGN, GlobalVoxelEncoder or point-model
    param tree -> {name: torch.Tensor} for the module's ``load_state_dict``
    (a PointNet++'s ``batch_stats`` come from ``params["batch_stats"]``)."""
    p = params.get("params", params)
    if "enc_conv1" in p:
        return _vgn_state_dict(p)
    if "fc" in p and "conv_0" in p:
        return _global_state_dict(p)
    if _is_point_tree(p):
        return _tensors(_point_state_dict(p, params.get("batch_stats", {})))
    enc = p["encoder"]
    sd = {}
    _conv3d(sd, "encoder.conv_in", enc["conv_in"])
    if "unet3d" in enc:
        _unet3d_state_dict(sd, "encoder.unet3d", enc["unet3d"])
    else:
        _unet2d_state_dict(sd, enc["unet"])
    for dec in ("decoder_aff", "decoder_occ"):
        for name, arr in p.get(dec, {}).items():
            sd[f"{dec}.{name}"] = _f32(arr)
    return _tensors(sd)


def _unet2d_state_dict(sd: dict, unet: dict, prefix: str = "encoder.unet") -> None:
    def conv2d(key, tree):
        sd[key + ".weight"] = _f32(tree["conv"]["kernel"]).transpose(3, 2, 0, 1)
        sd[key + ".bias"] = _f32(tree["conv"]["bias"])

    depth = sum(1 for k in unet if k.startswith("down"))
    for i in range(depth):
        for c in ("conv1", "conv2"):
            conv2d(f"{prefix}.down_convs.{i}.{c}", unet[f"down{i}"][c])
    for i in range(depth - 1):
        up = unet[f"up{i}"]
        sd[f"{prefix}.up_convs.{i}.upconv.weight"] = (
            _f32(up["upconv"]["kernel"]).transpose(0, 3, 1, 2))
        sd[f"{prefix}.up_convs.{i}.upconv.bias"] = _f32(up["upconv"]["bias"])
        for c in ("conv1", "conv2"):
            conv2d(f"{prefix}.up_convs.{i}.{c}", up[c])
    conv2d(f"{prefix}.conv_final", unet["conv_final"])


def _unet2d_flax(sd: dict, prefix: str = "encoder.unet") -> dict:
    """The inverse of ``_unet2d_state_dict``."""
    def conv(key: str) -> dict:
        return {"conv": {"kernel": np.ascontiguousarray(sd[key + ".weight"].transpose(2, 3, 1, 0)),
                         "bias": sd[key + ".bias"]}}

    unet = {}
    depth = sum(1 for k in sd if k.startswith(prefix + ".down_convs.") and k.endswith("conv1.weight"))
    for i in range(depth):
        unet[f"down{i}"] = {c: conv(f"{prefix}.down_convs.{i}.{c}") for c in ("conv1", "conv2")}
    for i in range(depth - 1):
        key = f"{prefix}.up_convs.{i}"
        unet[f"up{i}"] = {"upconv": {
            "kernel": np.ascontiguousarray(sd[key + ".upconv.weight"].transpose(0, 2, 3, 1)),
            "bias": sd[key + ".upconv.bias"]}}
        unet[f"up{i}"].update({c: conv(f"{key}.{c}") for c in ("conv1", "conv2")})
    unet["conv_final"] = conv(f"{prefix}.conv_final")
    return unet


def state_dict_to_flax(state: dict) -> dict:
    """{name: tensor} of a GIGANet, VGNNet, GlobalVoxelEncoder or point model
    -> the flax variables {"params": ...} (and a PointNet++'s
    "batch_stats") of numpy float32 arrays that ``flax_to_state_dict`` maps
    back to the same state, value for value."""
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
    if "fc.weight" in sd and "conv_0.weight" in sd:
        return _global_flax(sd)
    if "encoder.conv_in.weight" not in sd:
        return _point_flax(sd)
    enc = p["encoder"] = {"conv_in": {}}
    conv(enc["conv_in"], "encoder.conv_in", (2, 3, 4, 1, 0))
    if "encoder.unet3d.final_conv.weight" in sd:
        enc["unet3d"] = _unet3d_flax(sd, "encoder.unet3d")
    else:
        enc["unet"] = _unet2d_flax(sd)
    for dec in ("decoder_aff", "decoder_occ"):
        leaves = {k.split(".", 1)[1]: v for k, v in sd.items() if k.startswith(dec + ".")}
        if leaves:
            p[dec] = leaves
    return {"params": p}


def to_reference_state_dict(state: dict) -> dict:
    """This package's state -> numpy arrays under the reference's names.

    Each stacked head becomes its own LocalDecoder (``decoder_qual.fc_p`` ...,
    torch Linear layout (out, in)); fc_out keeps the stacked out_dim, so
    converting back reproduces the stacked arrays exactly. The encoders
    (the 2D and the 3D U-Net) and a VGN or GlobalVoxelEncoder state are
    under the reference's names already.
    """
    sd = {k: v.detach().cpu().numpy() for k, v in state.items()}
    if not any(k.startswith("decoder_") for k in sd):
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


def _stacked_heads(sd: dict, names, n_blocks: int, out_dim: int) -> dict:
    """Per-head reference LocalDecoders -> one stacked decoder's leaves
    (Linear weights (out, in) -> kernels (heads, in, out)); each head's
    fc_out is zero-padded to ``out_dim`` (qual and width have one output)."""
    def stack(key, part):
        return np.stack([sd[f"{n}.{key}.{part}"].T if part == "weight"
                         else sd[f"{n}.{key}.{part}"] for n in names])

    dec = {"fc_p_kernel": stack("fc_p", "weight"), "fc_p_bias": stack("fc_p", "bias")}
    for i in range(n_blocks):
        for src, dst in ((f"fc_c.{i}", f"fc_c{i}"), (f"blocks.{i}.fc_0", f"block{i}_fc0"),
                         (f"blocks.{i}.fc_1", f"block{i}_fc1")):
            dec[dst + "_kernel"] = stack(src, "weight")
            dec[dst + "_bias"] = stack(src, "bias")
    hidden = dec["fc_p_kernel"].shape[-1]
    wk = np.zeros((len(names), hidden, out_dim), np.float32)
    bk = np.zeros((len(names), out_dim), np.float32)
    for h, n in enumerate(names):
        w, b = sd[f"{n}.fc_out.weight"], sd[f"{n}.fc_out.bias"]
        wk[h, :, :w.shape[0]] = w.T
        bk[h, :b.shape[0]] = b
    dec["fc_out_kernel"], dec["fc_out_bias"] = wk, bk
    return dec


def from_reference_state_dict(state: dict, cfg=None) -> dict:
    """A reference state dict ({name: tensor or array}, e.g. a ``.pt``
    checkpoint's) -> this package's {name: torch.Tensor} for the module of
    ``cfg`` (a GIGAConfig; None for a VGN or GlobalVoxelEncoder state, whose
    names are this package's already). The encoders' names are shared; the
    per-head decoders stack into ``decoder_aff`` (qual, rot, width) and
    ``decoder_occ`` (tsdf)."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)
          for k, v in state.items()}
    if cfg is None or not any(k.startswith("decoder_") for k in sd):
        return _tensors(sd)
    out = {k: v for k, v in sd.items() if k.startswith("encoder.")}
    n_blocks = cfg.decoder.n_blocks
    groups = []
    if cfg.has_affordance:
        groups.append(("decoder_aff", AFFORDANCE_HEADS, 4))
    if cfg.decoder_tsdf:
        groups.append(("decoder_occ", ("decoder_tsdf",), 1))
    for dec, names, out_dim in groups:
        for name, arr in _stacked_heads(sd, names, n_blocks, out_dim).items():
            out[f"{dec}.{name}"] = arr
    return _tensors(out)


# --- the point models (models/pointnet.py, pointnetpp.py, decoder.py, crop.py) -----------
#
# Their module names are the reference's: ``fc_pos``, ``blocks.{i}.fc_0``,
# ``fc_c`` (the encoders' single Linear) or ``fc_c.{i}`` (the decoders'),
# ``fc_p``, ``fc_out``, ``fc``, ``unet``, ``unet3d``, a crop model's
# ``encoder.`` / ``decoder.``. The flax names are ``block{i}`` and
# ``fc_c{i}``; a Linear's kernel (in, out) is the transpose of its weight.
# A PointNet++ SharedMLP's ``conv{i}`` is flax's ``conv{i}_kernel`` /
# ``conv{i}_bias`` leaves, its ``bn{i}`` weight / bias flax's scale / bias,
# its running mean / var flax's ``batch_stats`` mean / var.

_POINT_TOPS = ("fc_pos", "fc_p", "sa1")
_PP_LAYERS = ("sa1", "sa2", "sa3", "fp1", "fp2", "fp3")


def _is_point_tree(p: dict) -> bool:
    return (any(k in p for k in _POINT_TOPS) or ("fc" in p and "conv_0" not in p)
            or ("fc_pos" in p.get("encoder", {})))


def _point_state_dict(p: dict, stats: dict, prefix: str = "") -> dict:
    sd = {}

    def dense(key: str, tree: dict) -> None:
        sd[key + ".weight"] = _f32(tree["kernel"]).T
        if "bias" in tree:
            sd[key + ".bias"] = _f32(tree["bias"])

    for name, tree in p.items():
        key = prefix + name
        if name in ("encoder", "decoder"):
            sd.update(_point_state_dict(tree, stats.get(name, {}), key + "."))
        elif name == "unet":
            _unet2d_state_dict(sd, tree, key)
        elif name == "unet3d":
            _unet3d_state_dict(sd, key, tree)
        elif name in _PP_LAYERS:
            mlp, bn_stats = tree["mlp"], stats[name]["mlp"]
            for i in range(sum(1 for k in mlp if k.endswith("_kernel"))):
                m = f"{key}.mlp"
                sd[f"{m}.conv{i}.weight"] = _f32(mlp[f"conv{i}_kernel"]).T
                sd[f"{m}.conv{i}.bias"] = _f32(mlp[f"conv{i}_bias"])
                sd[f"{m}.bn{i}.weight"] = _f32(mlp[f"bn{i}"]["scale"])
                sd[f"{m}.bn{i}.bias"] = _f32(mlp[f"bn{i}"]["bias"])
                sd[f"{m}.bn{i}.running_mean"] = _f32(bn_stats[f"bn{i}"]["mean"])
                sd[f"{m}.bn{i}.running_var"] = _f32(bn_stats[f"bn{i}"]["var"])
        elif re.fullmatch(r"block\d+", name):
            for fc in ("fc_0", "fc_1", "shortcut"):
                if fc in tree:
                    dense(f"{prefix}blocks.{name[5:]}.{fc}", tree[fc])
        elif re.fullmatch(r"fc_c\d+", name):
            dense(f"{prefix}fc_c.{name[4:]}", tree)
        else:
            dense(key, tree)
    return sd


def _point_flax(sd: dict) -> dict:
    """The inverse of ``_point_state_dict``: {"params": ...} (+ "batch_stats")."""
    params, stats = {}, {}
    for prefix in ("encoder.", "decoder."):
        sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if sub:
            tree = _point_flax(sub)
            params[prefix[:-1]] = tree["params"]
    sd = {k: v for k, v in sd.items() if not k.startswith(("encoder.", "decoder."))}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] in ("unet", "unet3d"):
            continue
        if parts[0] in _PP_LAYERS:
            layer, (_, mod, leaf) = parts[0], parts[1:]
            mlp = params.setdefault(layer, {}).setdefault("mlp", {})
            if mod.startswith("conv"):
                mlp[f"{mod}_{'kernel' if leaf == 'weight' else 'bias'}"] = (
                    np.ascontiguousarray(v.T) if leaf == "weight" else v)
            elif leaf in ("running_mean", "running_var"):
                bn = stats.setdefault(layer, {}).setdefault("mlp", {}).setdefault(mod, {})
                bn["mean" if leaf == "running_mean" else "var"] = v
            else:
                mlp.setdefault(mod, {})["scale" if leaf == "weight" else "bias"] = v
            continue
        *path, leaf = parts
        if path[0] == "blocks":
            path = [f"block{path[1]}", *path[2:]]
        elif path[0] == "fc_c" and len(path) == 2:
            path = [f"fc_c{path[1]}"]
        node = params
        for name in path:
            node = node.setdefault(name, {})
        node["kernel" if leaf == "weight" else "bias"] = (
            np.ascontiguousarray(v.T) if leaf == "weight" else v)
    if any(k.startswith("unet.") for k in sd):
        params["unet"] = _unet2d_flax(sd, "unet")
    if any(k.startswith("unet3d.") for k in sd):
        params["unet3d"] = _unet3d_flax(sd, "unet3d")
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def _reference_keys(state: dict, keys) -> dict:
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)
          for k, v in state.items()}
    return _tensors({k: sd[k] for k in keys(sd)})


def convert_pointnet_state_dict(state: dict, n_blocks: int = 5) -> dict:
    """A reference LocalPoolPointnet (or PatchLocalPoolPointnet) state dict
    (pointnet.py:11-290) -> {name: torch.Tensor} for this package's module of
    the same names: fc_pos, ``n_blocks`` blocks, fc_c, and whichever of the
    2D (``unet``) and 3D (``unet3d``) U-Nets its keys hold, at the depth
    they hold (giga_tpu/models/torch_convert.py::convert_pointnet_state_dict)."""
    def keys(sd):
        out = [f"{n}.{w}" for n in ("fc_pos", "fc_c") for w in ("weight", "bias")]
        for i in range(n_blocks):
            out += [k for k in sd if k.startswith(f"blocks.{i}.")]
        return out + [k for k in sd if k.startswith(("unet.", "unet3d."))]

    return _reference_keys(state, keys)


def convert_patch_decoder_state_dict(state: dict, n_blocks: int = 5) -> dict:
    """A reference PatchLocalDecoder state dict (decoder.py:208-301) ->
    {name: torch.Tensor} for this package's module: fc_p, fc_out and
    ``n_blocks`` of fc_c and blocks
    (giga_tpu/models/torch_convert.py::convert_patch_decoder_state_dict)."""
    def keys(sd):
        out = [f"{n}.{w}" for n in ("fc_p", "fc_out") for w in ("weight", "bias")]
        for i in range(n_blocks):
            out += [f"fc_c.{i}.weight", f"fc_c.{i}.bias"]
            out += [k for k in sd if k.startswith(f"blocks.{i}.")]
        return out

    return _reference_keys(state, keys)
