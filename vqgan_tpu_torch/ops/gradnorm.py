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

Across ranks (``axis_name``, a process group or ``"data"``, each rank
holding its rows of the global gradient) the norm is the global one: with
``global_norm`` the square root of the squared sums of every rank, else the
mean of every rank's block norms (JAX's ``lax.pmean`` of the per-rank norm),
each one ``all_reduce`` inside the backward. With a ``context`` group (the
3D job's clips split in T blocks over its ranks, or the 2D job's images in
H blocks) a rank holds a block of dim 1 of its rows' gradient: the global
norm sums every rank's squares as before, and a block's norm in
``mean_shard_norm`` spans its rows' whole T or H, so the ranks of the
context group add their squares of each block before the square root and
the mean over the data blocks (the ranks of one data index share its
blocks).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vqgan_tpu_torch.parallel.mesh import data_group, group_rank, group_size


class GradNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, shards, group, global_norm, context):
        ctx.weight = weight
        ctx.shards = shards
        ctx.group = group
        ctx.global_norm = global_norm
        ctx.context = context
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        gf = g.float()
        shards, group = ctx.shards, ctx.group
        if group is not None and ctx.global_norm:
            sq = gf.square().sum().reshape(1)
            dist.all_reduce(sq, group=group)
            norm = sq[0].sqrt()
        elif shards > 1 or group is not None:
            b = gf.shape[0]
            if b % shards:
                raise ValueError(f"gradnorm shards {shards} must divide the batch {b}")
            sq = gf.square().flatten(1).sum(dim=1)  # per example
            blocks = sq.reshape(shards, b // shards).sum(dim=1)  # squares per block
            if group is not None:
                # every data block's squares, each summed over the context
                # ranks that hold its frames: this rank's in its data slot
                n_ctx = group_size(ctx.context)
                index = group_rank(group) // n_ctx
                every = blocks.new_zeros(dist.get_world_size(group) // n_ctx * shards)
                every[index * shards:(index + 1) * shards] = blocks
                dist.all_reduce(every, group=group)
                blocks = every
            norm = blocks.sqrt().mean()
        else:
            norm = gf.square().sum().sqrt()
        out = (ctx.weight * gf / (norm + 1e-8)).to(g.dtype)
        return out, None, None, None, None, None


def gradnorm(
    x: torch.Tensor,
    weight: float = 1.0,
    axis_name=None,
    shards: int = 1,
    global_norm: bool = False,
    context=None,
) -> torch.Tensor:
    """Identity forward; the backward rescales the gradient to norm
    ``weight`` (see the module docstring). ``axis_name``: None for one
    process, else a process group or ``"data"`` (the current mesh's group),
    across which the norm is taken; ``global_norm`` then picks the
    Frobenius norm over every rank, else the mean of the ranks' norms.
    ``context``: the group of ranks that hold T blocks of this rank's clips
    or H blocks of its images (ranks of ``axis_name``'s group, context
    index fastest)."""
    group = None if axis_name is None else data_group(axis_name)
    return GradNorm.apply(x, weight, shards, group, global_norm, context)
