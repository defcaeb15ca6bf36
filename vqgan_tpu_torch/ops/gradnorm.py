"""Gradient-normalization loss balancing as a ``torch.autograd.Function``
(counterpart of ``vqgan_tpu/ops/gradnorm.py``).

The forward is the identity. The backward rescales the incoming gradient to
norm ``weight``: ``weight · g / (‖g‖ + 1e-8)`` in fp32, cast back to g's
dtype. The train step applies it to the reconstruction once per loss branch
(LPIPS, MSE, GAN), so each branch contributes a gradient of fixed scale
whatever its raw magnitude (reference vae_trainer.py:27-53).

Modes: ``shards == 1`` divides by the Frobenius norm of the whole gradient;
``shards > 1`` by the mean of the norms of ``shards`` contiguous equal blocks
of dim 0 (the reference's average of per-rank norms for a batch split that
way; ``TrainConfig.gradnorm_mode = "mean_shard_norm"``).
"""

from __future__ import annotations

import torch


class GradNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, shards):
        ctx.weight = weight
        ctx.shards = shards
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        gf = g.float()
        shards = ctx.shards
        if shards > 1:
            b = gf.shape[0]
            if b % shards:
                raise ValueError(f"gradnorm shards {shards} must divide the batch {b}")
            sq = gf.square().reshape(b, -1).sum(dim=1)  # per example
            norm = sq.reshape(shards, b // shards).sum(dim=1).sqrt().mean()
        else:
            norm = gf.square().sum().sqrt()
        out = (ctx.weight * gf / (norm + 1e-8)).to(g.dtype)
        return out, None, None


def gradnorm(
    x: torch.Tensor,
    weight: float = 1.0,
    axis_name: str | None = None,
    shards: int = 1,
) -> torch.Tensor:
    """Identity forward; the backward rescales the gradient to norm
    ``weight`` (see the module docstring). ``axis_name`` names a JAX mapped
    axis to average the norm over; a single-GPU step has none, so passing
    one raises."""
    if axis_name is not None:
        raise NotImplementedError(
            "gradnorm axis_name: averaging the norm across processes "
            "(DDP) is not ported yet (ROADMAP.md, Queue 1: multi-GPU)"
        )
    return GradNorm.apply(x, weight, shards)
