"""Fréchet feature distance for reconstruction quality, an rFID proxy
(counterpart of ``vqgan_tpu/losses/fid.py``).

Canonical rFID uses InceptionV3-pool3 features; there are no Inception
weights here, so this fits the same Fréchet statistic over VGG16 tap
activations (spatially pooled), the LPIPS network's: a documented proxy,
comparable within a run, not to published Inception-based rFID numbers.

Fréchet distance between Gaussians fit to feature sets:
  ‖μ₁−μ₂‖² + tr(Σ₁+Σ₂−2·(Σ₁Σ₂)^{1/2})
The matrix square root is taken on the host with scipy (eval time only, a
small C×C matrix), as the JAX package does.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from vqgan_tpu_torch.losses.vgg import ScalingLayer, VGG16Features
from vqgan_tpu_torch.models.blocks import nchw


def make_feature_fn(vgg_state: Mapping[str, torch.Tensor], device: str | torch.device,
                    dtype: torch.dtype = torch.float32,
                    taps: Sequence[int] = (-1,)) -> Callable[[torch.Tensor], torch.Tensor]:
    """Returns fn: (B, H, W, 3) in [-1, 1] → (B, C) fp32 pooled VGG
    features, on ``device``. ``vgg_state`` is a ``VGG16Features`` state dict
    (the LPIPS network's, ``lpips.net.state_dict()``); the VGG computes in
    ``dtype``.

    ``taps`` selects which of the 5 tap activations (relu1_2 … relu5_3) are
    spatially pooled and concatenated: (-1,) is relu5_3 alone (C=512)."""
    with torch.device(device):
        vgg = VGG16Features(dtype)
        scale = ScalingLayer()
    vgg.load_state_dict(vgg_state, strict=True)
    vgg.to(memory_format=torch.channels_last).requires_grad_(False)
    taps = tuple(taps)

    @torch.no_grad()
    def features(x: torch.Tensor) -> torch.Tensor:
        acts = vgg(scale(nchw(x)))
        return torch.cat([acts[i].float().mean(dim=(2, 3)) for i in taps], dim=-1)

    return features


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6) -> float:
    """Fréchet distance between Gaussian fits of two feature sets (N, C)."""
    import scipy.linalg

    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    s1 = np.cov(feats_a, rowvar=False) + eps * np.eye(feats_a.shape[1])
    s2 = np.cov(feats_b, rowvar=False) + eps * np.eye(feats_b.shape[1])
    diff = mu1 - mu2
    # sqrtm's ``disp`` goes in SciPy 1.18; without it the same root comes back
    covmean = np.real(scipy.linalg.sqrtm(s1 @ s2))
    return float(diff @ diff + np.trace(s1 + s2 - 2.0 * covmean))
