"""Plain PyTorch fp32 GroupNorm (+ optional fused swish), forward only.

The counterpart of ``vqgan_tpu/ops/normalization.py::_forward`` in the same
channel-coefficient form:

    mean, var = E[x], E[x²] − mean²      per (batch, group), in fp32
    rstd = rsqrt(var + eps)
    y = x · A_c + B_c ,  A = rstd·γ ,  B = β − mean·A
    y = y · sigmoid(y)                    when with_swish

cast back to the input's dtype. Channel c belongs to group c // (C / G), as
in torch's GroupNorm.

This is the reference the CUDA kernel (``ops/groupnorm_cuda.py``) is held
against, and the path a tensor on the CPU takes. It is not the model's GroupNorm
on the card: a CUDA tensor goes through the kernel.
"""

from __future__ import annotations

import torch


def group_norm_fp32(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    with_swish: bool = False,
) -> torch.Tensor:
    """GroupNorm(+swish) over x of shape (B, C, *spatial) with fp32
    statistics and arithmetic; returns x's dtype and memory layout (a
    channels_last input gives a channels_last output)."""
    b, c = x.shape[0], x.shape[1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    cg = c // num_groups
    xf = x.float().movedim(1, -1)  # (B, *spatial, C)
    xg = xf.reshape(b, -1, num_groups, cg)
    mean = xg.mean(dim=(1, 3))  # (B, G)
    var = xg.square().mean(dim=(1, 3)) - mean.square()
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(cg, dim=-1) * weight.float()  # (B, C)
    bb = bias.float() - mean.repeat_interleave(cg, dim=-1) * a
    shape = (b,) + (1,) * (x.ndim - 2) + (c,)
    y = xf * a.view(shape) + bb.view(shape)
    if with_swish:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).movedim(-1, 1)
