"""How far one training step's gradients move when the GroupNorm forward
changes by rounding alone, against the bounds of ``chip_smoke.py``'s phase 8
(one step on the CPU and on the card, gradients within 1e-2 of each
tensor's largest entry).

    python -m vqgan_tpu_torch.tools.cross_device_spread   # from the repo root

Runs phase 8's step (ch=64, ch_mult 1,2,4, 64 px, batch 2, fp32, GAN with
LPIPS, hinge + LeCam, D's lr 1e-8) three times on the CPU: with the plain
GroupNorm, then with its statistics summed in float64 (at most one ulp from
the plain version's), then with those statistics and the swish written as
t·(1/(1 + e^−t)) as the CUDA kernels write it. Each variant is held against
the first run by phase 8's own comparison (``compare_step_across_devices``),
which prints the share of its bound the worst tensor uses. A share above 1
from a change of rounding alone means the check cannot tell a new order of
sums in kernel #1 from a fault. Needs no card.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import chip_smoke
from vqgan_tpu_torch.ops import groupnorm_cuda
from vqgan_tpu_torch.ops.normalization import group_norm_fp32_forward


def float64_statistics(swish_formula: bool):
    """The plain forward with its mean and E[x²] summed in float64 and rounded
    to fp32 (and optionally the kernels' swish formula)."""
    def forward(x, weight, bias, num_groups=32, eps=1e-6, with_swish=False):
        b, c = x.shape[:2]
        xg = x.double().movedim(1, -1).reshape(b, -1, num_groups, c // num_groups)
        mean = xg.mean(dim=(1, 3))
        var = xg.square().mean(dim=(1, 3)) - mean.square()
        mean, rstd = mean.float(), torch.rsqrt(var + eps).float()
        cg = c // num_groups
        a = rstd.repeat_interleave(cg, dim=-1) * weight.float()
        bb = bias.float() - mean.repeat_interleave(cg, dim=-1) * a
        shape = (b,) + (1,) * (x.ndim - 2) + (c,)
        y = x.float().movedim(1, -1) * a.view(shape) + bb.view(shape)
        if with_swish:
            y = y * (1.0 / (1.0 + torch.exp(-y))) if swish_formula else y * torch.sigmoid(y)
        return y.to(x.dtype).movedim(-1, 1), mean, rstd
    return forward


def one_step() -> tuple:
    """Phase 8's step on the CPU: (metrics, {"G": ..., "D": ...} AdamW first
    moments, {})."""
    from vqgan_tpu_torch.config import TrainConfig, VAEConfig
    from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, init_discriminator_
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.models.ae import VAE
    from vqgan_tpu_torch.train.state import create_train_state
    from vqgan_tpu_torch.train.step import StepDraws, make_train_step

    vae_cfg = VAEConfig(resolution=64, ch=64, ch_mult=(1, 2, 4), num_res_blocks=2,
                        z_channels=16, enc_dtype="float32", dec_dtype="float32")
    cfg = TrainConfig(batch_size=2, image_size=64, max_steps=10_000, do_ganloss=True,
                      disc_type="hinge", use_lecam=True, do_clamp=True,
                      flip_invariance=True, learning_rate_disc=1e-8)
    sd_vae = chip_smoke._perturbed_state_dict(vae_cfg, seed=2)
    gen = torch.Generator().manual_seed(3)
    disc_ref = PatchDiscriminator()
    init_discriminator_(disc_ref, gen)
    with torch.no_grad():
        for k in range(1, 6):
            getattr(disc_ref, f"binary_classifier{k}")[-1].weight.normal_(0.0, 0.05,
                                                                          generator=gen)
    lpips_ref = LPIPS()
    init_lpips_(lpips_ref, gen)
    images = np.random.RandomState(3).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    vae, disc, lpips = VAE(vae_cfg), PatchDiscriminator(), LPIPS()
    vae.load_state_dict(sd_vae, strict=True)
    disc.load_state_dict(disc_ref.state_dict(), strict=True)
    lpips.load_state_dict(lpips_ref.state_dict(), strict=True)
    state = create_train_state(cfg, vae, disc, vae_cfg.ch)
    step = make_train_step(cfg, vae_cfg, vae, disc, lpips)
    draws = StepDraws(flip_in=True, flip_w=True, flip_h=False, crop_h=0, crop_w=0,
                      aug_lpips_w=False, aug_lpips_h=False, revive_idx=None)
    state, metrics = step(state, torch.from_numpy(images), 0, draws)
    moments = {side: {n: opt.state[p]["exp_avg"].clone() for n, p in model.named_parameters()
                      if p in opt.state}
               for side, model, opt in (("G", vae, state.g_opt), ("D", disc, state.d_opt))}
    return {k: float(v) for k, v in metrics.items()}, moments, {}


def main() -> int:
    torch.backends.cudnn.allow_tf32 = False
    reference = one_step()
    for name, forward in (("float64 statistics", float64_statistics(False)),
                          ("float64 statistics and the kernels' swish",
                           float64_statistics(True))):
        groupnorm_cuda.group_norm_fp32_forward = forward
        try:
            chip_smoke.compare_step_across_devices({"cpu": reference, "cuda": one_step()},
                                                   name, 2 * 2 * 16, 0)
            print(f"{name}: within phase 8's bounds", flush=True)
        except AssertionError as e:
            print(f"{name}: outside phase 8's bounds: {str(e)[:160]}", flush=True)
        finally:
            groupnorm_cuda.group_norm_fp32_forward = group_norm_fp32_forward
    return 0


if __name__ == "__main__":
    sys.exit(main())
