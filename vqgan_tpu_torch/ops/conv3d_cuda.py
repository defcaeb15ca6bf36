"""Fused-tap 3×3×3 stride-1 SAME Conv3d: the binding of the hand-written CUDA
kernel for Hopper and the ``torch.autograd.Function`` around it.

Replaces ``vqgan_tpu/ops/pallas/conv3d.py::conv3d_ttap``: the Pallas TPU
kernel ``_conv3d_pallas`` and its custom VJP. The kernel is
``csrc/conv3d.cu``, built by ``nvcc`` for ``sm_90a`` at first use and bound
with ctypes; the source says what bounds it on an H100 and what the design
does about it.

Inputs are (B, Ci, T, H, W) tensors in ``torch.channels_last_3d`` memory
format, physically (B, T, H, W, Ci), and an OIDHW (Co, Ci, 3, 3, 3) weight
of the same dtype, fp32 or bf16. The wrapper repacks the weight into the
kernel's (27·Ci, Co) rows, zero-padded to whole tiles, and returns a
channels_last_3d output of x's dtype. A CUDA tensor launches the kernel, or
raises; a CPU tensor runs the plain version (``ops/conv3d.py``). There is no
fallback between the two.

``Conv3dTTap`` is the custom VJP's counterpart: dx is the same kernel on dy
with the flipped, Ci/Co-transposed weight, dk the weight gradient of the
direct conv (``torch.nn.grad.conv3d_weight``; the JAX package computes dk
outside its kernel too).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from vqgan_tpu_torch.ops.conv3d import (
    conv3d_input_grad_plain,
    conv3d_plain,
    conv3d_weight_grad,
    flipped_weight,
)
from vqgan_tpu_torch.ops.cuda_build import load_library, num_sms

# Kernel launches since the count was last set to 0: one per forward call
# (``launches``) or dx call (``bwd_launches``) that reached the CUDA kernel;
# calls on CPU tensors do not count.
launches = 0
bwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_K = 16  # rows of K per chunk (csrc/conv3d.cu kBK)
_THREADS = 256
_MIN_CHUNKS_PER_SPLIT = 4


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (built on the first call)."""
    lib = load_library("conv3d")
    lib.conv3d_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.conv3d_forward.restype = ctypes.c_int
    lib.conv3d_error_string.argtypes = [ctypes.c_int]
    lib.conv3d_error_string.restype = ctypes.c_char_p
    return lib


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is cut: ``block_n`` output channels a block (the kernel
    pairs 64 with 128 voxels and 16 with 512), the packed weight's
    ``n_chunks``·16 rows of ``n_pad``, and K in ``splits`` ranges of
    ``chunks_per_split`` chunks."""

    block_n: int
    n_pad: int
    n_chunks: int
    splits: int
    chunks_per_split: int


def launch_plan(m: int, ci: int, co: int, sms: int) -> LaunchPlan:
    """The plan for M = B·T·H·W voxels, Ci in and Co out on a card of
    ``sms`` SMs. Co <= 16 takes 16-channel tiles of 512 voxels, else
    64-channel tiles of 128. Where the tiles fill fewer than one block per
    SM, K is split so that there are about two, each split at least 4
    chunks long."""
    block_n = 16 if co <= 16 else 64
    block_m = _THREADS // (block_n // 4) * 8  # csrc/conv3d.cu's BM
    n_chunks = 27 * ci // BLOCK_K if ci % BLOCK_K == 0 else math.ceil(27 * ci / BLOCK_K)
    n_pad = math.ceil(co / block_n) * block_n
    tiles = math.ceil(m / block_m) * (n_pad // block_n)
    splits = 1
    if tiles < sms:
        splits = max(1, min(math.ceil(2 * sms / tiles), n_chunks // _MIN_CHUNKS_PER_SPLIT))
    per = math.ceil(n_chunks / splits)
    return LaunchPlan(block_n, n_pad, n_chunks, math.ceil(n_chunks / per), per)


def pack_weight(weight: torch.Tensor, plan: LaunchPlan) -> torch.Tensor:
    """OIDHW (Co, Ci, 3, 3, 3) → the kernel's (n_chunks·16, n_pad) rows in
    the weight's dtype: row tap·Ci + ci with tap = (dt·3 + dh)·3 + dw, column
    co, zeros past 27·Ci and past Co."""
    co, ci = weight.shape[:2]
    rows = weight.permute(2, 3, 4, 1, 0).reshape(27 * ci, co)
    packed = weight.new_zeros(plan.n_chunks * BLOCK_K, plan.n_pad)
    packed[:27 * ci, :co] = rows
    return packed


def _check(x: torch.Tensor, weight: torch.Tensor) -> None:
    if x.ndim != 5:
        raise ValueError(f"expected (B, C, T, H, W), got shape {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError(
            "conv3d_ttap needs a torch.channels_last_3d-contiguous input "
            "(physically (B, T, H, W, C)); convert it once where it is made")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"conv3d_ttap takes float32 or bfloat16, not {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3d_ttap runs on cpu or cuda, not {x.device}")
    if weight.ndim != 5 or tuple(weight.shape[1:]) != (x.shape[1], 3, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not (Co, {x.shape[1]}, 3, 3, 3)")
    if weight.dtype != x.dtype or weight.device != x.device:
        raise ValueError(f"weight {weight.dtype} on {weight.device} does not match the input "
                         f"{x.dtype} on {x.device}")


def _launch(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    b, ci, t, h, w = x.shape
    co = weight.shape[0]
    if ci % BLOCK_K == 0 and x.data_ptr() % 16:
        raise ValueError("conv3d_ttap needs a 16-byte aligned input")
    plan = launch_plan(b * t * h * w, ci, co, num_sms(x.device.index))
    packed = pack_weight(weight, plan)
    y = torch.empty((b, co, t, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last_3d)
    partial = None
    if plan.splits > 1:
        partial = torch.empty(plan.splits * y.numel(), dtype=torch.float32, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3d_forward(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(),
            None if partial is None else partial.data_ptr(),
            b, t, h, w, ci, co, plan.n_pad, plan.n_chunks, plan.splits,
            plan.chunks_per_split, plan.block_n, _DTYPE_CODES[x.dtype], stream)
    if err:
        raise RuntimeError(
            f"conv3d kernel launch failed: {lib.conv3d_error_string(err).decode()}")
    return y


def conv3d_forward(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The forward, outside autograd. A CUDA tensor launches kernel #6 (and
    counts it in ``launches``); a CPU tensor runs the plain version."""
    global launches
    _check(x, weight)
    if x.device.type == "cpu":
        return conv3d_plain(x, weight)
    y = _launch(x, weight)
    launches += 1
    return y


def conv3d_input_grad(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """dx for the incoming gradient dy (B, Co, T, H, W) of the forward with
    ``weight``: the same conv with the flipped, Ci/Co-transposed weight. A
    CUDA tensor launches kernel #6 (and counts it in ``bwd_launches``); a
    CPU tensor runs the plain version."""
    global bwd_launches
    w_t = flipped_weight(weight)
    _check(dy, w_t)
    if dy.device.type == "cpu":
        return conv3d_input_grad_plain(dy, weight)
    dx = _launch(dy, w_t)
    bwd_launches += 1
    return dx


class Conv3dTTap(torch.autograd.Function):
    """The fused-tap Conv3d with the kernel (CUDA) or the plain version
    (CPU); the counterpart of ``conv3d_ttap``'s custom VJP."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return conv3d_forward(x, weight)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        # a flip or a slice downstream can hand back another layout
        g = g.contiguous(memory_format=torch.channels_last_3d)
        dx = conv3d_input_grad(g, weight) if ctx.needs_input_grad[0] else None
        dk = conv3d_weight_grad(x, g, weight.shape) if ctx.needs_input_grad[1] else None
        return dx, dk


def conv3d_ttap(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The 3×3×3 stride-1 SAME conv of a channels_last_3d (B, Ci, T, H, W)
    tensor with an OIDHW weight of its dtype, every product summed in fp32,
    one cast; differentiable in x and the weight."""
    return Conv3dTTap.apply(x, weight)
