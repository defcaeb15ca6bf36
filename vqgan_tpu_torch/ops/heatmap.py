"""Blurriness heatmap, the mask of the masked-L1 recon loss (counterpart of
``vqgan_tpu/ops/heatmap.py``; reference vae_trainer.py:143-176).

Gray (the channel mean) → the 5×5 Laplacian → |·| → reflect pad 6 → the
separable 13-tap Gaussian (σ 2), rows then columns → min-max normalization
over the whole batch tensor → 1 − that → values below 0.8 set to 0 →
broadcast to 3 channels. Everything in fp32; the mask takes the images'
dtype and carries no gradient.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# reference vae_trainer.py:146-155
LAPLACIAN_5X5 = np.array(
    [
        [0, 1, 1, 1, 0],
        [1, 1, 1, 1, 1],
        [1, 1, -20, 1, 1],
        [1, 1, 1, 1, 1],
        [0, 1, 1, 1, 0],
    ],
    dtype=np.float32,
)
THRESHOLD = 0.8


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(ksize: int = 13, sigma: float = 2.0) -> np.ndarray:
    """torchvision's GaussianBlur tap: the sampled Gaussian, normalized."""
    x = np.arange(ksize, dtype=np.float32) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def normalized_blur(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) → (B, 1, H, W): the blurred edge response min-max
    normalized over the whole tensor, before the inversion and the
    threshold."""
    xf = images.detach().float()
    gray = xf.mean(dim=-1).unsqueeze(1)  # (B, 1, H, W)
    lap = torch.from_numpy(LAPLACIAN_5X5).to(gray.device).view(1, 1, 5, 5)
    edge = F.conv2d(gray, lap, padding=2).abs()
    g1 = torch.from_numpy(gaussian_kernel_1d()).to(gray.device)
    pad = (g1.numel() - 1) // 2
    blurred = F.pad(edge, (pad, pad, pad, pad), mode="reflect")
    blurred = F.conv2d(blurred, g1.view(1, 1, -1, 1))
    blurred = F.conv2d(blurred, g1.view(1, 1, 1, -1))
    mn, mx = blurred.min(), blurred.max()
    return (blurred - mn) / (mx - mn + 1e-8)


def blurriness_heatmap(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [-1, 1] → (B, H, W, 3) mask in [0, 1] of the images'
    dtype."""
    mask = 1.0 - normalized_blur(images)
    mask = torch.where(mask < THRESHOLD, torch.zeros_like(mask), mask)
    b, _, h, w = mask.shape
    return mask.permute(0, 2, 3, 1).expand(b, h, w, 3).to(images.dtype)
