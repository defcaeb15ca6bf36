"""Plain PyTorch fused-tap Conv3d, forward and backward: kernel #6's plain
versions (counterpart of ``vqgan_tpu/ops/pallas/conv3d.py::conv3d_ttap`` and
its custom VJP).

The function is the 3×3×3 stride-1 SAME conv of x (B, Ci, T, H, W) with a
weight (Co, Ci, 3, 3, 3), both in the compute dtype, with the Pallas
kernel's numerics: every one of the 27·Ci products of an output entry is
summed in fp32 and the entry is cast to x's dtype once; zero padding on T,
H and W. The backward is the custom VJP's (``conv3d.py:316-333``):

    dx = the same conv of dy with the weight flipped in (T, H, W) and Ci/Co
         transposed
    dk = the weight gradient of the direct conv

These are the references the CUDA kernel (``ops/conv3d_cuda.py``) is held
against, with TF32 off wherever they are compared, and the path a tensor on
the CPU takes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

U_FP32 = 2.0 ** -24  # fp32 unit roundoff
# standard deviations of a sum's rounding error that rounding_bound allows
BOUND_FACTOR = 4.0


def conv3d_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The forward: fp32 products and sums, one cast to x's dtype; returns
    channels_last_3d."""
    y = F.conv3d(x.float(), weight.float(), padding=1)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last_3d)


def flipped_weight(weight: torch.Tensor) -> torch.Tensor:
    """The weight whose conv of dy is dx: flipped in (T, H, W), Ci and Co
    swapped (a view)."""
    return weight.flip(2, 3, 4).transpose(0, 1)


def conv3d_input_grad_plain(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """dx for the incoming gradient dy (B, Co, T, H, W) of the forward."""
    return conv3d_plain(dy, flipped_weight(weight))


def conv3d_weight_grad(x: torch.Tensor, dy: torch.Tensor, weight_shape) -> torch.Tensor:
    """dk (Co, Ci, 3, 3, 3) in x's dtype: the weight gradient of the direct
    conv, as the JAX VJP leaves it to XLA's weight-gradient conv (a library
    call on either device: ``torch.nn.grad.conv3d_weight``)."""
    return torch.nn.grad.conv3d_weight(x, weight_shape, dy, padding=1)


def rounding_bound(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Per output entry, how far two fp32 evaluations of the forward on the
    same inputs may lie apart when they sum the K = 27·Ci products in other
    orders: 4·√K·2^-24 of Σ|terms|, the sum of the products'
    magnitudes (the conv of |x| with |weight|, in fp32). A sum of K terms in
    a fixed order is off by a random walk of K roundings, each at most u of
    a partial sum no larger than Σ|terms|: a standard deviation of at most
    √K·u/3 of Σ|terms| (terms of one sign; mixed signs give far less), and
    far below the worst case K·u. The factor 4 (``BOUND_FACTOR``) puts the
    bound at ~8 standard deviations of the difference of two such sums. A bf16
    output may lie one bf16 ulp further (2^-7 of the value); ``bound_share``
    adds it."""
    k = 27 * x.shape[1]
    terms = F.conv3d(x.float().abs(), weight.float().abs(), padding=1)
    return (BOUND_FACTOR * math.sqrt(k) * U_FP32) * terms


def bound_share(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor,
                weight: torch.Tensor) -> float:
    """The largest share of kernel #6's stated bound that ``got`` uses
    against ``want``, the plain version's output on the same inputs: the
    ``rounding_bound`` of x and weight plus 1e-7, plus one bf16 ulp (2^-7 of
    ``want``) where the output is bf16 and may round to either side. At most
    1 where the kernel agrees."""
    tol = rounding_bound(x, weight) + 1e-7
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    return float(((got.float() - want.float()).abs() / tol).max())
