"""Reconstruction and latent regularization losses (counterpart of
``vqgan_tpu/losses/recon.py``; reference vae_trainer.py:179-217).

``recon_weight · recon + z_reg_weight · mean(z²)``, where the recon term is an
L1 between the 16× area-downsampled images (``do_pool``), or the L1 masked
by the target's blurriness heatmap (``ops/heatmap.py``), and is skipped
entirely when its weight is 0, the reference's default.
"""

from __future__ import annotations

import torch

from vqgan_tpu_torch.ops.heatmap import blurriness_heatmap
from vqgan_tpu_torch.ops.resize import area_downsample


def vae_loss_function(
    x: torch.Tensor,
    x_reconstructed: torch.Tensor,
    z: torch.Tensor,
    do_pool: bool = True,
    recon_weight: float = 0.0,
    z_reg_weight: float = 0.1,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """x, x_reconstructed: (B, H, W, 3); z: (B, h, w, C). Returns (loss,
    metrics under the reference's keys)."""
    zf = z.float()
    zloss = zf.square().mean()
    if recon_weight != 0.0:
        xr, xt = x_reconstructed.float(), x.float()
        if do_pool:  # area-downsample ×1/16, then L1 (vae_trainer.py:183-187)
            recon = (area_downsample(xr, 16) - area_downsample(xt, 16)).abs().mean()
        else:  # the blurriness-masked L1 (vae_trainer.py:189-196)
            recon = ((xr - xt) * blurriness_heatmap(xt)).abs().mean()
    else:
        recon = torch.zeros((), device=zf.device)
    loss = recon * recon_weight + zloss * z_reg_weight
    abs_z = zf.abs()
    metrics = {
        "recon_loss": recon,
        "kl_loss": zloss,
        "average_of_abs_z": abs_z.mean(),
        # population std (jnp.std has ddof 0; torch.std's default is 1)
        "std_of_abs_z": abs_z.std(correction=0),
        "average_of_logvar": torch.zeros((), device=zf.device),
        "std_of_logvar": torch.zeros((), device=zf.device),
    }
    return loss, metrics
