"""2D model blocks (counterpart of ``vqgan_tpu/models/blocks.py``).

Activations are (B, C, H, W) in ``torch.channels_last`` memory format, which is
physically NHWC: cuDNN's fast layout and the (B, H·W, C) view the GroupNorm
kernel reads. Params are fp32; each conv casts its input, weight and bias to
its compute dtype. Module and parameter names give the reference state-dict
keys (``conv1.weight``, ``norm1.weight``, ``nin_shortcut.bias``, ...).

Init follows the reference (``init_weights_``): torch's default Conv2d init
(U(±1/√fan_in)), ResnetBlock.conv2 normal with std 1e-4/out_ch, AttnBlock's
proj_out normal with std 0.2/√C, every bias zero, GroupNorm weight 1.

Rematerialization (``remat_call``; JAX ``blocks.py:43-66``): a module with a
remat policy runs its forward as a ``torch.utils.checkpoint`` region where
autograd records, so the backward recomputes what the region did not keep.
"full" keeps only the region's inputs; "conv" also keeps the output of every
``aten.convolution`` inside it (a selective-checkpoint policy), the convs
the JAX package tags saveable. The CUDA kernels' launches are not aten ops,
so no policy keeps their outputs: a recompute launches them again.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from vqgan_tpu_torch.models.quant import VectorQuantizer
from vqgan_tpu_torch.ops.attention import dense_attention, memory_efficient_attention
from vqgan_tpu_torch.ops.groupnorm_cuda import ContextGroupNorm, FusedGroupNorm
from vqgan_tpu_torch.ops.resize import nearest_upsample_2x


def nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, C, H, W) channels_last (a view when x is a
    contiguous NHWC tensor)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)  # x * sigmoid(x), reference ae.py:13-14


REMAT_POLICIES = ("full", "conv")


def remat_policy_of(remat: bool, policy: str) -> Optional[str]:
    """The policy a model's regions take: None without ``remat``; an unknown
    policy raises ValueError, as the JAX package's ``remat_with_policy``."""
    if not remat:
        return None
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}")
    return policy


def _save_convs(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn: Callable, policy: Optional[str], *args):
    """``fn(*args)``, as a rematerialized region under ``policy`` ("full" or
    "conv") where autograd records; a plain call without a policy or under
    ``no_grad``."""
    if policy is None or not torch.is_grad_enabled():
        return fn(*args)
    if policy == "conv":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _save_convs))
    return checkpoint(fn, *args, use_reentrant=False)


class FP32GroupNorm(nn.Module):
    """GroupNorm(32, eps=1e-6) computed in fp32 (reference ae.py:41-53), with
    the following swish fused when ``fused_swish``. Goes through the
    ``FusedGroupNorm`` autograd Function: a CUDA tensor runs the hand-written
    kernels forward and backward; a CPU tensor their plain versions. With a
    ``context`` process group (a clip's frames split over its ranks, set by
    ``TVAE``) the two-pass ``ContextGroupNorm``, whose statistics span every
    rank's frames."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6,
                 fused_swish: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.fused_swish = fused_swish
        self.context = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.context is not None:
            return ContextGroupNorm.apply(x, self.weight, self.bias, self.num_groups,
                                          self.eps, self.fused_swish, self.context)
        return FusedGroupNorm.apply(x, self.weight, self.bias, self.num_groups,
                                    self.eps, self.fused_swish)


class Conv2d(nn.Module):
    """A conv with fp32 params that computes in ``dtype``. ``init_std``:
    normal init with this std instead of torch's default; ``bias=False``: no
    bias parameter."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32,
                 init_std: float | None = None, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.init_std = init_std
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding)


def conv3x3(in_channels: int, out_channels: int, dtype: torch.dtype,
            **kw) -> Conv2d:
    return Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype, **kw)


def conv1x1(in_channels: int, out_channels: int, dtype: torch.dtype) -> Conv2d:
    return Conv2d(in_channels, out_channels, 1, dtype=dtype)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """The reference init scheme, drawn from ``generator`` in module order;
    a VQ codebook takes the JAX package's init (``init_codebook_``)."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            if m.init_std is None:
                # torch's Conv2d default: kaiming_uniform(a=√5) = U(±1/√fan_in)
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
            else:
                m.weight.normal_(0.0, m.init_std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, FP32GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, VectorQuantizer):
            m.init_codebook_(generator)


class ResnetBlock(nn.Module):
    """norm→swish→conv ×2 with ~identity start (reference ae.py:96-140);
    a region of its own under ``remat_policy``."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.remat_policy = remat_policy
        self.norm1 = FP32GroupNorm(in_channels, fused_swish=True)
        self.conv1 = conv3x3(in_channels, out_channels, dtype)
        self.norm2 = FP32GroupNorm(out_channels, fused_swish=True)
        # near-zero so the residual branch starts ≈ identity (ae.py:120-121)
        self.conv2 = conv3x3(out_channels, out_channels, dtype,
                             init_std=1e-4 / out_channels)
        self.nin_shortcut = (
            conv1x1(in_channels, out_channels, dtype)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return remat_call(self._forward, self.remat_policy, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-layer self-attention over the flattened spatial tokens
    (reference ae.py:56-93; JAX ``blocks.py:167-231``): GroupNorm without
    swish, a bias-free 1×1 qkv conv whose channels split into thirds (q, k,
    v) and each third into heads of ``head_dim``, attention with scale
    head_dim^-½, a bias-free 1×1 proj_out, residual add.

    ``attn_chunk`` > 0 and a token count above it: the memory-efficient path
    (kernel #3 on the card, the chunked plain version on the CPU), and the
    chunk must divide the token count, as in the JAX package. Else dense
    attention. ``attn_impl`` keeps the JAX values and has no other effect."""

    head_dim = 64  # the reference's, for every width

    def __init__(self, channels: int, dtype: torch.dtype, attn_chunk: int = 0,
                 attn_impl: str = "auto"):
        super().__init__()
        self.attn_chunk = attn_chunk
        self.attn_impl = attn_impl
        self.norm = FP32GroupNorm(channels)
        self.qkv = Conv2d(channels, 3 * channels, 1, dtype=dtype, bias=False)
        self.proj_out = Conv2d(channels, channels, 1, dtype=dtype, bias=False,
                               init_std=0.2 / math.sqrt(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = h * w
        qkv = self.qkv(self.norm(x))
        # channels_last qkv is physically (B, N, 3C): q, k, v are views
        q, k, v = qkv.permute(0, 2, 3, 1).reshape(
            b, n, 3, c // self.head_dim, self.head_dim).unbind(2)
        if self.attn_chunk and n > self.attn_chunk:
            if n % self.attn_chunk:
                raise ValueError(
                    f"attn_chunk {self.attn_chunk} must divide the mid-block token "
                    f"count {n} (= H·W after downsampling); pick a divisor of {n}")
            out = memory_efficient_attention(q, k, v, self.attn_chunk, self.attn_impl)
        else:
            out = dense_attention(q, k, v)
        return x + self.proj_out(nchw(out.reshape(b, h, w, c)))


class Downsample(nn.Module):
    """Stride-2 3×3 conv after an asymmetric (0, 1) pad of H and W — the FLUX
    convention (reference ae.py:143-154), not the conv's symmetric padding."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (0, 1, 0, 1))
        # a no-op where F.pad kept the layout; the convs and the GroupNorm
        # kernel downstream need channels_last
        return self.conv(x.contiguous(memory_format=torch.channels_last))


class Upsample(nn.Module):
    """Nearest 2× then 3×3 conv (reference ae.py:157-167), the direct form."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv = conv3x3(channels, channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))
