"""Depth-sensor noise models (counterpart of giga_tpu/sim/noise.py;
reference src/vgn/utils/misc.py:7-69), drawn from numpy's global
generator as the reference's are:
    'dex'   a multiplicative gamma gain, and with probability ``gp_rate``
            low-resolution Gaussian-process noise resized bilinearly
    'trans' per-pixel translational jitter, then additive Gaussian
    'norm'  additive Gaussian
"""

from __future__ import annotations

import os
import random

import numpy as np


def set_random_seed(seed: int = 0) -> None:
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)


def apply_noise(img: np.ndarray, noise_type) -> np.ndarray:
    if noise_type == "dex":
        return apply_dex_noise(img)
    if noise_type == "trans":
        return apply_translational_noise(img)
    if noise_type == "norm":
        return apply_gaussian_noise(img)
    return img


def _bilinear_resize(img: np.ndarray, shape) -> np.ndarray:
    """skimage.transform.resize(order=1): an output pixel centre i maps to
    (i + 0.5) * h / H - 0.5 of the input."""
    h, w = img.shape
    H, W = shape
    yi = (np.arange(H) + 0.5) * (h / H) - 0.5
    xi = (np.arange(W) + 0.5) * (w / W) - 0.5
    y0 = np.clip(np.floor(yi).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xi).astype(int), 0, w - 1)
    y1, x1 = np.clip(y0 + 1, 0, h - 1), np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(yi - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xi - x0, 0.0, 1.0)[None, :]
    a, b = img[np.ix_(y0, x0)], img[np.ix_(y0, x1)]
    c, d = img[np.ix_(y1, x0)], img[np.ix_(y1, x1)]
    top, bot = a + (b - a) * wx, c + (d - c) * wx
    return top + (bot - top) * wy


def apply_dex_noise(img: np.ndarray, gamma_shape: float = 1000, gamma_scale: float = 0.001,
                    gp_sigma: float = 0.005, gp_scale: float = 4.0,
                    gp_rate: float = 0.5) -> np.ndarray:
    img = img * np.random.gamma(gamma_shape, gamma_scale)
    if np.random.rand() < gp_rate:
        h, w = img.shape[:2]
        gp = np.random.randn(int(h / gp_scale), int(w / gp_scale)) * gp_sigma
        img = img + _bilinear_resize(gp, (h, w))
    return img


def apply_translational_noise(img: np.ndarray, sigma_p: float = 1.0, sigma_d: float = 0.005):
    h, w = img.shape[:2]
    ww, hh = np.meshgrid(np.arange(w), np.arange(h))
    hh = np.clip(np.round(hh + np.random.randn(h, w) * sigma_p), 0, h - 1).astype(int)
    ww = np.clip(np.round(ww + np.random.randn(h, w) * sigma_p), 0, w - 1).astype(int)
    out = img[hh, ww]
    return out + np.random.randn(*out.shape) * sigma_d


def apply_gaussian_noise(img: np.ndarray, sigma: float = 0.005) -> np.ndarray:
    return img + np.random.randn(*img.shape) * sigma
