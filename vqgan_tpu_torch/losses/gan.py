"""GAN objectives: BCE / hinge discriminator and generator losses, LeCam
regularization and accuracy telemetry (counterpart of
``vqgan_tpu/losses/gan.py``; reference vae_trainer.py:63-90, 517-522,
639-655, 684-693). Every loss and metric is an fp32 0-d tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gan_disc_loss(
    real_preds: torch.Tensor, fake_preds: torch.Tensor, disc_type: str = "bce"
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Returns (0.5·(real_loss + fake_loss), metrics with the average
    logits and the accuracy)."""
    rp, fp = real_preds.float(), fake_preds.float()
    if disc_type == "bce":
        real_loss = F.binary_cross_entropy_with_logits(rp, torch.ones_like(rp))
        fake_loss = F.binary_cross_entropy_with_logits(fp, torch.zeros_like(fp))
    elif disc_type == "hinge":
        real_loss = F.relu(1.0 - rp).mean()
        fake_loss = F.relu(1.0 + fp).mean()
    else:
        raise ValueError(f"unknown disc_type {disc_type}")
    metrics = {
        "avg_real_logits": rp.mean(),
        "avg_fake_logits": fp.mean(),
        "disc_acc": disc_accuracy(rp, fp),
    }
    return 0.5 * (real_loss + fake_loss), metrics


def disc_accuracy(real_preds: torch.Tensor, fake_preds: torch.Tensor) -> torch.Tensor:
    """(count of real > 0 + count of fake < 0) / total."""
    correct = (real_preds > 0).sum() + (fake_preds < 0).sum()
    return correct.float() / (real_preds.numel() + fake_preds.numel())


def generator_gan_loss(fake_preds: torch.Tensor, disc_type: str = "bce") -> torch.Tensor:
    """BCE against ones, or −mean(fake) for hinge."""
    fp = fake_preds.float()
    if disc_type == "bce":
        return F.binary_cross_entropy_with_logits(fp, torch.ones_like(fp))
    if disc_type == "hinge":
        return -fp.mean()
    raise ValueError(f"unknown disc_type {disc_type}")


def update_lecam_anchors(
    anchor_real: torch.Tensor,
    anchor_fake: torch.Tensor,
    avg_real_logits: torch.Tensor,
    avg_fake_logits: torch.Tensor,
    beta: float = 0.9,
) -> tuple[torch.Tensor, torch.Tensor]:
    """EMA (β = 0.9) of the average logits."""
    new_real = beta * anchor_real + (1.0 - beta) * avg_real_logits
    new_fake = beta * anchor_fake + (1.0 - beta) * avg_fake_logits
    return new_real, new_fake


def lecam_penalty(
    real_preds: torch.Tensor,
    fake_preds: torch.Tensor,
    anchor_real: torch.Tensor,
    anchor_fake: torch.Tensor,
) -> torch.Tensor:
    """mean((real − ema_fake)²) + mean((fake − ema_real)²)."""
    rp, fp = real_preds.float(), fake_preds.float()
    return (rp - anchor_fake).square().mean() + (fp - anchor_real).square().mean()
