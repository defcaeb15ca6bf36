"""Eval: reconstructions of held-out batches (counterpart of
``vqgan_tpu/train/evaluate.py``; reference vae_trainer.py:805-901).

encode (in bf16 when ``eval_bf16``, as the reference's autocast eval,
:821-822; GroupNorm stays fp32) → clamp → regularize (the Gaussian samples
with ε from a generator seeded 0, as the JAX eval's fixed ``PRNGKey(0)``; VQ
takes the nearest codes) → optional double-flip equivariance check (flip z
over both spatial axes, negate the last 4 latent channels; decode; flip the
output back — an identity check for a Z₂×Z₂-equivariant latent, :837-855)
→ decode → unnormalize → tile a 4×2 grid of D² crops.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from vqgan_tpu_torch.config import DTYPES, TrainConfig, VAEConfig
from vqgan_tpu_torch.models.ae import VAE
from vqgan_tpu_torch.models.quant import VectorQuantizer
from vqgan_tpu_torch.ops.resize import resize_area
from vqgan_tpu_torch.train.state import to_channels_last

EvalStep = Callable[..., tuple[torch.Tensor, torch.Tensor]]


def make_eval_step(cfg: TrainConfig, vae_cfg: VAEConfig, vae: nn.Module) -> EvalStep:
    """Returns ``eval_step(g_params, batch, eps=None) -> (recon, target)``.

    ``g_params`` maps ``vae``'s parameter names to tensors (its own
    ``named_parameters()``, or the Polyak average ``TrainState.g_ema``); they
    are copied into an eval model of the eval dtypes on ``vae``'s device.
    ``batch`` is (B, S, S, 3), uint8 (normalized on the device) or float in
    [-1, 1], on that device. ``eps``: the Gaussian latent's ε, (B, h, w,
    z_channels) in the eval encoder's dtype; by default drawn from a
    generator seeded 0 on the device, the same every call. Returns fp32
    (recon, target) in [0, 1] on the device, recon at the decoder's
    resolution and target at the batch's."""
    device = next(vae.parameters()).device
    if cfg.eval_bf16:
        # the reference's bf16-autocast eval (vae_trainer.py:821,841): bf16
        # compute for the encoder and the decoder, params unchanged
        vae_cfg = dataclasses.replace(vae_cfg, enc_dtype="bfloat16", dec_dtype="bfloat16")
    with torch.device(device):
        model = VAE(vae_cfg)
    to_channels_last(model)
    model.requires_grad_(False).eval()
    params = dict(model.named_parameters())
    enc_res = vae_cfg.resolution
    enc_dtype = DTYPES[vae_cfg.enc_dtype]
    quantized = isinstance(model.reg, VectorQuantizer)
    sampled = vae_cfg.reg_type == "gaussian"

    @torch.no_grad()
    def eval_step(g_params: Mapping[str, torch.Tensor], batch: torch.Tensor,
                  eps: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
        for name, p in params.items():
            p.copy_(g_params[name])
        if batch.dtype == torch.uint8:  # the loader's device_normalize mode
            batch = batch.float() / 127.5 - 1.0
        x = resize_area(batch, (enc_res, enc_res))
        z = model.encode(x)
        if cfg.do_clamp:
            z = z.clamp(-cfg.clamp_th, cfg.clamp_th)
        if quantized:
            z_s = model.reg.quantize(z)
        elif sampled:
            if eps is None:
                gen = torch.Generator(device=device).manual_seed(0)
                eps = torch.randn(z.shape[:-1] + (z.shape[-1] // 2,), generator=gen,
                                  device=device, dtype=enc_dtype)
            z_s = model.regularize(z, eps=eps)
        else:
            z_s = model.regularize(z)
        if cfg.flip_invariance:
            # flip both axes + negate the last 4 channels (vae_trainer.py:837-839)
            c = z_s.shape[-1]
            idx = torch.arange(c, device=device)
            sign = torch.where(idx >= c - 4, -1.0, 1.0).to(z_s.dtype)
            z_s = z_s.flip((1, 2)) * sign
        recon = model.decode(z_s).float()
        # unnormalize + clamp (vae_trainer.py:845-849)
        recon = (recon * 0.5 + 0.5).clamp(0.0, 1.0)
        target = (batch.float() * 0.5 + 0.5).clamp(0.0, 1.0)
        if cfg.flip_invariance:
            recon = recon.flip((1, 2))  # flip the output back (:852-855)
        return recon, target

    return eval_step


def tile_grid(images: np.ndarray, rows: int = 2, cols: int = 4, d: int = 256) -> np.ndarray:
    """Tile the first rows*cols images' top-left D² crops into one image
    (vae_trainer.py:869-890)."""
    n = min(len(images), rows * cols)
    grid = np.zeros((rows * d, cols * d, 3), np.float32)
    for idx in range(n):
        i, j = divmod(idx, cols)
        crop = images[idx][:d, :d]
        ph, pw = crop.shape[:2]
        grid[i * d: i * d + ph, j * d: j * d + pw] = crop
    return grid
