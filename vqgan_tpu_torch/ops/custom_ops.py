"""The kernels of the serving path as PyTorch operators: kernel #1's forward
(GroupNorm + swish), kernel #3's forward (attention) and kernel #4 (the
nearest-code search), registered with ``torch.library`` under the
``vqgan_tpu_torch`` namespace.

Each operator has three implementations, chosen by the dispatcher from its
inputs' device, never by a Python test in the caller:

    op                      CUDA: the hand kernel      CPU: the plain version
    gn_forward              groupnorm_cuda (#1)        group_norm_fp32_forward
    attention_forward       attention_cuda (#3 fwd)    chunked_attention_forward
    nearest_codes           vq_cuda (#4)               nearest_codes_plain

and a fake one, which gives the real output's shape, dtype and strides
without touching data, so ``torch.export`` traces through the operator with a
symbolic batch. Everything that reads a shape, a stride or an address into
Python (the checks, the plan, the launch counters ``groupnorm_cuda.launches``,
``attention_cuda.fwd_launches``, ``vq_cuda.nearest_launches``) happens inside
an implementation, when the operator runs; a traced graph holds the operator
call alone. An exported program therefore launches the kernels on the card,
runs the plain versions on the CPU, and counts its launches as the eager
model does. No implementation falls back to another: a CUDA tensor that a
kernel cannot take raises.

The model calls these operators (``FusedGroupNorm``, ``FlashAttention``, the
quantizer's search), and so do the wrappers ``group_norm_forward``,
``attention_forward`` and ``nearest_codes``: serving, training and an
exported program share one binding of each kernel. Importing this module
builds nothing; a kernel is built at its first launch
(``cuda_build.load_library``). The backward kernels (#2, #3's backward) and
kernels #5 and #6 are not on the serving path and stay plain function calls.
"""

from __future__ import annotations

import torch
from torch import Tensor

from vqgan_tpu_torch.ops import attention_cuda, groupnorm_cuda, vq_cuda
from vqgan_tpu_torch.ops.attention import chunked_attention_forward
from vqgan_tpu_torch.ops.normalization import group_norm_fp32_forward
from vqgan_tpu_torch.ops.vq import nearest_codes_plain

NAMESPACE = "vqgan_tpu_torch"


@torch.library.custom_op(f"{NAMESPACE}::gn_forward", mutates_args=(), device_types="cpu")
def gn_forward(x: Tensor, weight: Tensor, bias: Tensor, num_groups: int, eps: float,
               with_swish: bool) -> tuple[Tensor, Tensor]:
    """GroupNorm(+swish) forward with fp32 statistics: ``(y, stats)``, y in
    x's dtype and channels-last layout, stats the fp32 (B, 2, G) mean and
    rstd. x is a channels_last (B, C, H, W) or channels_last_3d (B, C, T, H,
    W) tensor of float32 or bfloat16."""
    groupnorm_cuda.check_inputs(x, weight, bias, num_groups)
    y, mean, rstd = group_norm_fp32_forward(x, weight, bias, num_groups, eps, with_swish)
    return y, torch.stack((mean, rstd), dim=1)


@gn_forward.register_kernel("cuda")
def _gn_forward_cuda(x, weight, bias, num_groups, eps, with_swish):
    groupnorm_cuda.check_inputs(x, weight, bias, num_groups)
    return groupnorm_cuda._launch_forward(x, weight, bias, num_groups, eps, with_swish, None)


@gn_forward.register_fake
def _gn_forward_fake(x, weight, bias, num_groups, eps, with_swish):
    # not the layout: under a symbolic batch, torch 2.11's fake convolution
    # gives an NCHW-strided output where the real one is channels-last, so a
    # traced input's strides say nothing; the implementations check what
    # arrives when the operator runs
    groupnorm_cuda.check_operands(x, weight, bias, num_groups)
    return (torch.empty_like(x, memory_format=groupnorm_cuda.channels_last_format(x)),
            x.new_empty((x.shape[0], 2, num_groups), dtype=torch.float32))


@torch.library.custom_op(f"{NAMESPACE}::attention_forward", mutates_args=(),
                         device_types="cpu")
def attention_forward(q: Tensor, k: Tensor, v: Tensor, chunk: int) -> tuple[Tensor, Tensor]:
    """Exact non-causal attention over (B, N, H, D), scale D^-½: ``(out,
    lse)``, out (B, N, H, D) contiguous in q's dtype, lse the fp32 (B, H, N)
    logsumexp of the scaled scores. q, k and v may be strided views (of one
    qkv tensor); on the CPU k/v are scanned in chunks of ``chunk`` tokens,
    which must divide N."""
    attention_cuda.check_inputs(q, k, v)
    out, lse = chunked_attention_forward(q, k, v, chunk)
    return out.contiguous(), lse


@attention_forward.register_kernel("cuda")
def _attention_forward_cuda(q, k, v, chunk):
    attention_cuda.check_inputs(q, k, v)
    return attention_cuda._launch_forward(q, k, v)


@attention_forward.register_fake
def _attention_forward_fake(q, k, v, chunk):
    attention_cuda.check_inputs(q, k, v)
    b, n, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, n), dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::nearest_codes", mutates_args=(), device_types="cpu")
def nearest_codes(flat: Tensor, codebook: Tensor) -> Tensor:
    """Nearest-code indices (N,) int32 of contiguous (N, D) fp32 tokens
    against a contiguous (K, D) fp32 codebook; the first index wins an exact
    tie. No gradient flows through the codes."""
    vq_cuda.check_nearest(flat, codebook)
    return nearest_codes_plain(flat, codebook)


@nearest_codes.register_kernel("cuda")
def _nearest_codes_cuda(flat, codebook):
    vq_cuda.check_nearest(flat, codebook)
    return vq_cuda._launch_nearest(flat, codebook)


@nearest_codes.register_fake
def _nearest_codes_fake(flat, codebook):
    vq_cuda.check_nearest(flat, codebook)
    return flat.new_empty(flat.shape[:1], dtype=torch.int32)
