"""Plain PyTorch reference of GIGA and GIGA-Geo's networks, in float32.

Written from the published model (Jiang et al., RSS 2021, GIGA's
``src/vgn/networks.py`` and the ConvONet voxel encoder and local decoder
it builds on), with no kernel, no lattice factorization and no batching
trick: a Conv3d stem and ReLU, the voxel features averaged onto the xz, xy
and yz planes (ConvONet's scatter-mean, which with padding 0 and the plane
resolution equal to the grid's puts voxel (x, y, z) in cell (z, x) of the
xz plane, and so on), one 2D U-Net shared by the three planes, then per
query point the three planes sampled by ``grid_sample`` (bilinear, border,
align_corners) at ConvONet's normalized coordinates, concatenated xz, xy,
yz, and each head's ResNet-FC stack. The affordance heads give qual
(sigmoid), rot (unit quaternion, xyzw) and width; the occupancy head gives
logits.

Weights are read from the flax ``.msgpack`` checkpoint by the benchmark's
frozen reader. Layouts: Conv3d kernels (D, H, W, I, O), Conv2d (H, W, I,
O), the U-Net's 2x2 transpose convs (I, 2, 2, O) with out[o, 2i+di, 2j+dj]
= sum_c in[c, i, j] W[c, di, dj, o]; a decoder's weights are stacked over
its heads, (heads, in, out), biases (heads, out).

Every computation runs with TF32 off unless ``tf32=True`` (the control).
This module imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench.frozen.msgpack import load_params

PLANES = ("xz", "xy", "yz")


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for cuDNN convolutions and CUDA matmuls, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class GigaReference:
    """The network of a GIGA checkpoint: ``encode`` and ``decode``."""

    def __init__(self, path, device, tf32: bool = False):
        tree = load_params(path)
        tree = tree.get("params", tree)
        self.device = torch.device(device)
        self.tf32 = tf32

        def t(a):
            return torch.from_numpy(np.array(a, np.float32)).to(self.device)

        enc = tree["encoder"]
        self.stem_w = t(np.transpose(enc["conv_in"]["conv"]["kernel"], (4, 3, 0, 1, 2)))
        self.stem_b = t(enc["conv_in"]["conv"]["bias"])
        unet = enc["unet"]
        self.depth = sum(1 for k in unet if k.startswith("down"))

        def conv(node):
            return t(np.transpose(node["conv"]["kernel"], (3, 2, 0, 1))), t(node["conv"]["bias"])

        self.down = [(conv(unet[f"down{i}"]["conv1"]), conv(unet[f"down{i}"]["conv2"]))
                     for i in range(self.depth)]
        self.up = []
        for i in range(self.depth - 1):
            u = unet[f"up{i}"]
            upw = t(np.transpose(u["upconv"]["kernel"], (0, 3, 1, 2)))
            self.up.append(((upw, t(u["upconv"]["bias"])), conv(u["conv1"]), conv(u["conv2"])))
        self.final = conv(unet["conv_final"])
        self.decoders = {name: {k: t(v) for k, v in tree[name].items()}
                         for name in ("decoder_aff", "decoder_occ") if name in tree}

    # -- encoder ---------------------------------------------------------------

    def encode(self, tsdf: torch.Tensor) -> dict:
        """(B, X, Y, Z) TSDF -> {plane: (B, C, rows, cols)} feature planes."""
        with torch.no_grad(), matmul_precision(self.tf32):
            feat = F.relu(F.conv3d(tsdf[:, None].float(), self.stem_w, self.stem_b, padding=1))
            # feat (B, C, X, Y, Z); a plane's rows are its second axis
            planes = {"xz": feat.mean(dim=3).transpose(2, 3),
                      "xy": feat.mean(dim=4).transpose(2, 3),
                      "yz": feat.mean(dim=2).transpose(2, 3)}
            B = tsdf.shape[0]
            refined = self.unet(torch.cat([planes[p] for p in PLANES], dim=0))
            return dict(zip(PLANES, torch.split(refined, B, dim=0)))

    def unet(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i, ((w1, b1), (w2, b2)) in enumerate(self.down):
            x = F.relu(F.conv2d(x, w1, b1, padding=1))
            x = F.relu(F.conv2d(x, w2, b2, padding=1))
            skips.append(x)
            if i < self.depth - 1:
                x = F.max_pool2d(x, 2, 2)
        for i, ((uw, ub), (w1, b1), (w2, b2)) in enumerate(self.up):
            x = F.conv_transpose2d(x, uw, ub, stride=2)
            x = torch.cat([x, skips[-(i + 2)]], dim=1)
            x = F.relu(F.conv2d(x, w1, b1, padding=1))
            x = F.relu(F.conv2d(x, w2, b2, padding=1))
        return F.conv2d(x, *self.final)

    # -- decoder ---------------------------------------------------------------

    def features(self, planes: dict, p: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) points in [-0.5, 0.5] -> (B, N, 3C) plane features."""
        axes = {"xz": (0, 2), "xy": (0, 1), "yz": (1, 2)}
        out = []
        for name in PLANES:
            a, b = axes[name]
            uv = torch.stack((p[..., a], p[..., b]), dim=-1) / (1 + 10e-6) + 0.5
            uv = torch.where(uv >= 1, torch.full_like(uv, 1 - 10e-6), uv)
            uv = torch.where(uv < 0, torch.zeros_like(uv), uv)
            s = F.grid_sample(planes[name], (2.0 * uv - 1.0)[:, :, None], mode="bilinear",
                              padding_mode="border", align_corners=True)  # (B, C, N, 1)
            out.append(s[..., 0].transpose(1, 2))
        return torch.cat(out, dim=-1)

    def decode(self, name: str, planes: dict, p: torch.Tensor) -> torch.Tensor:
        """Raw outputs (heads, B, N, out) of decoder ``name`` at (B, N, 3)."""
        w = self.decoders[name]
        n_blocks = sum(1 for k in w if k.startswith("fc_c") and k.endswith("_kernel"))
        with torch.no_grad(), matmul_precision(self.tf32):
            c = self.features(planes, p)
            heads = []
            for h in range(w["fc_p_kernel"].shape[0]):
                net = p @ w["fc_p_kernel"][h] + w["fc_p_bias"][h]
                for i in range(n_blocks):
                    net = net + c @ w[f"fc_c{i}_kernel"][h] + w[f"fc_c{i}_bias"][h]
                    hid = F.relu(net) @ w[f"block{i}_fc0_kernel"][h] + w[f"block{i}_fc0_bias"][h]
                    net = net + (F.relu(hid) @ w[f"block{i}_fc1_kernel"][h]
                                 + w[f"block{i}_fc1_bias"][h])
                heads.append(F.relu(net) @ w["fc_out_kernel"][h] + w["fc_out_bias"][h])
            return torch.stack(heads)

    def affordance(self, planes: dict, p: torch.Tensor):
        """qual (B, N), rot (B, N, 4) unit, width (B, N) at (B, N, 3) points."""
        out = self.decode("decoder_aff", planes, p)
        return torch.sigmoid(out[0, ..., 0]), F.normalize(out[1], dim=-1), out[2, ..., 0]

    def occupancy(self, planes: dict, p: torch.Tensor) -> torch.Tensor:
        """Occupancy logits (B, N) at (B, N, 3) points."""
        return self.decode("decoder_occ", planes, p)[0, ..., 0]


def grid_points(coords: torch.Tensor) -> torch.Tensor:
    """(n^3, 3) points of the lattice coords x coords x coords, x slowest."""
    x, y, z = torch.meshgrid(coords, coords, coords, indexing="ij")
    return torch.stack((x, y, z), dim=-1).reshape(-1, 3)
