"""Reconstruction quality metrics for eval: PSNR and SSIM (counterpart of
``vqgan_tpu/losses/metrics.py``), over NHWC images in [0, 1] on any device.

SSIM follows Wang et al. 2004: 11×11 Gaussian window (σ=1.5), K1=0.01,
K2=0.03, computed per channel and averaged — the skimage/torchmetrics
default configuration.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the full batch."""
    mse = (a.float() - b.float()).square().mean()
    return 10.0 * torch.log10(max_val ** 2 / mse.clamp_min(1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
         window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean structural similarity over a batch of NHWC images in [0, max_val].

    Depthwise-convolves the Gaussian window per channel (VALID padding, like
    skimage's default) and averages the SSIM map over batch, space and
    channels. The window convs run in true fp32: ``blur(a*a) - mu_a**2``
    cancels catastrophically at TF32's 10-bit mantissa (negative "variances"
    larger than c2 push the map far outside [-1, 1]), so TF32 is turned off
    around them."""
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    c = a.shape[1]
    win = torch.from_numpy(_gaussian_window(window_size, sigma).astype(np.float32))
    kernel = win.to(a.device)[None, None].expand(c, 1, window_size, window_size).contiguous()

    def blur(x):
        return F.conv2d(x, kernel, groups=c)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        mu_a, mu_b = blur(a), blur(b)
        mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        # exact-math residual cancellation can still dip microscopically
        # below zero; clamp so the stabilized denominator never changes sign
        var_a = (blur(a * a) - mu_aa).clamp_min(0.0)
        var_b = (blur(b * b) - mu_bb).clamp_min(0.0)
        cov = blur(a * b) - mu_ab
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    ssim_map = ((2 * mu_ab + c1) * (2 * cov + c2)) / (
        (mu_aa + mu_bb + c1) * (var_a + var_b + c2))
    return ssim_map.mean()
