"""Fused fp32 GroupNorm (+ optional swish), forward and backward: the
hand-written CUDA kernels for Hopper, the ``torch.autograd.Function`` that
joins them, and the dispatch the model calls.

Replaces ``vqgan_tpu/ops/pallas/groupnorm.py``: the forward
``fused_group_norm`` (the Pallas TPU kernels ``_stats_kernel`` and
``_apply_kernel``) and the backward ``_pallas_gn_bwd`` (``_bwd_stats_kernel``
and ``_bwd_dx_kernel``), which ``_fused_gn_vjp`` joins. The kernels are
``csrc/groupnorm.cu``, built by ``nvcc`` for ``sm_90a`` at first use and bound
with ctypes.

What bounds them on an H100: device-memory bandwidth. The forward reads the
activation twice (statistics, then normalize) and writes it once; the backward
reads the activation and the incoming gradient twice (sums, then dx) and
writes dx once; about 3.35 TB/s on an H100 SXM, against a few flops per
element. Each pass moves 16 bytes per thread per access (4 fp32 or 8 bf16
channels), reads and writes each row contiguously over the channels-last
``(B, S, C)`` view, and sizes the grid to about four blocks per SM so that
enough loads are in flight. Between the passes, a small launch finishes the
cross-block reduction: it sums the per-tile partials in a fixed order, so
there are no atomics and the outputs are deterministic.

``FusedGroupNorm`` saves only the input in its own dtype, the (B, 2, G)
statistics the forward kernel wrote, and γ, β: no full-size fp32 tensor (the
JAX package's contract, ``vqgan_tpu/ops/normalization.py``). Its backward
recomputes ŷ from x.

``fused_group_norm`` takes (B, C, H, W) tensors in ``torch.channels_last``
memory format, which are physically (B, H·W, C), or (B, C, T, H, W) tensors
in ``torch.channels_last_3d``, physically (B, T·H·W, C), and is
differentiable. A
tensor on the CPU goes to the plain versions (``ops/normalization.py``); a
CUDA tensor launches the kernels, or raises. There is no fallback between the
two.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from vqgan_tpu_torch.ops.cuda_build import load_library, num_sms
from vqgan_tpu_torch.ops.normalization import (
    group_norm_fp32_backward,
    group_norm_fp32_forward,
)

# Kernel launches since the count was last set to 0: one per forward
# (``launches``) or backward (``bwd_launches``) call that reached the CUDA
# kernels; calls on CPU tensors do not count.
launches = 0
bwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_THREADS = 1024
_MAX_STATIC_SMEM = 48 * 1024  # bytes a block may take without opting in
_THREADS_TARGET = 256
_BLOCKS_PER_SM = 4


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (built on the first call)."""
    lib = load_library("groupnorm")
    lib.gn_forward.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    lib.gn_forward.restype = ctypes.c_int
    lib.gn_backward.argtypes = (
        [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 9
        + [ctypes.c_void_p]
    )
    lib.gn_backward.restype = ctypes.c_int
    lib.gn_error_string.argtypes = [ctypes.c_int]
    lib.gn_error_string.restype = ctypes.c_char_p
    return lib


def launch_geometry(
    batch: int, spatial: int, channels: int, element_size: int, num_sms: int
) -> tuple[int, int, int]:
    """(threads per block, rows per tile, tiles per batch image) for one call,
    forward or backward.

    A thread owns one 16-byte pack of channels; a block holds whole rows, so
    its width is a multiple of C / pack. Rows per tile is a multiple of the
    rows a block has in flight, chosen so the grid has about
    ``_BLOCKS_PER_SM`` blocks per SM. The backward's sums pass takes 2·C
    coefficients on top of the forward's shared memory, and its dx pass
    5·C."""
    pack = 16 // element_size
    if channels % pack:
        raise ValueError(f"channels {channels} must be a multiple of {pack}")
    packs = channels // pack
    if packs > _MAX_THREADS:
        raise ValueError(f"channels {channels} exceed the kernel's limit")
    rows_in_flight = max(1, _THREADS_TARGET // packs)
    threads = rows_in_flight * packs
    smem = max(2 * threads * pack + 2 * channels, 5 * channels) * 4
    if smem > _MAX_STATIC_SMEM:
        raise ValueError(f"channels {channels} exceed the kernel's shared memory")
    tiles_wanted = max(1, math.ceil(_BLOCKS_PER_SM * num_sms / batch))
    rows = math.ceil(spatial / tiles_wanted)
    rows_per_tile = math.ceil(rows / rows_in_flight) * rows_in_flight
    n_tiles = math.ceil(spatial / rows_per_tile)
    return threads, rows_per_tile, n_tiles


def channels_last_format(x: torch.Tensor) -> torch.memory_format:
    """The channels-last memory format of a 4-D or 5-D tensor."""
    if x.ndim == 4:
        return torch.channels_last
    if x.ndim == 5:
        return torch.channels_last_3d
    raise ValueError(f"expected (B, C, H, W) or (B, C, T, H, W), got shape {tuple(x.shape)}")


def _check(x, weight, bias, num_groups):
    if not x.is_contiguous(memory_format=channels_last_format(x)):
        raise ValueError(
            "fused_group_norm needs a torch.channels_last-contiguous input "
            "(channels_last_3d for 5-D; physically (B, ..., C)); convert it "
            "once where it is made"
        )
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_group_norm takes float32 or bfloat16, not {x.dtype}")
    c = x.shape[1]
    if c % num_groups or num_groups > _MAX_THREADS:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups} "
                         f"(at most {_MAX_THREADS} groups)")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32 or tuple(p.shape) != (c,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({c},) tensor")
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_group_norm runs on cpu or cuda, not {x.device}")


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err:
        raise RuntimeError(
            f"groupnorm {what} kernel launch failed: {lib.gn_error_string(err).decode()}"
        )


def group_norm_forward(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    with_swish: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward, outside autograd: ``(y, stats)``, y in x's dtype and
    channels-last layout, stats the fp32 (B, 2, G) mean and rstd. A CUDA tensor
    launches kernel #1 (and counts it in ``launches``); a CPU tensor runs
    the plain version."""
    _check(x, weight, bias, num_groups)
    if x.device.type == "cpu":
        y, mean, rstd = group_norm_fp32_forward(x, weight, bias, num_groups, eps,
                                                with_swish)
        return y, torch.stack((mean, rstd), dim=1)
    return _launch_forward(x, weight, bias, num_groups, eps, with_swish)


def _launch_forward(x, weight, bias, num_groups, eps, with_swish):
    global launches
    b, c = x.shape[:2]
    s = math.prod(x.shape[2:])
    if x.data_ptr() % 16:
        raise ValueError("fused_group_norm needs a 16-byte aligned input")
    threads, rows_per_tile, n_tiles = launch_geometry(
        b, s, c, x.element_size(), num_sms(x.device.index)
    )
    lib = library()
    y = torch.empty_like(x, memory_format=channels_last_format(x))
    partial = torch.empty((b, n_tiles, 2, num_groups), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((b, 2, num_groups), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gn_forward(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            partial.data_ptr(), stats.data_ptr(),
            b, s, c, num_groups, rows_per_tile, n_tiles, threads,
            eps, int(with_swish), _DTYPE_CODES[x.dtype], stream,
        )
    _raise_on(err, lib, "forward")
    launches += 1
    return y, stats


def group_norm_backward(
    x: torch.Tensor,
    g: torch.Tensor,
    stats: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    with_swish: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward, outside autograd: ``(dx, dγ, dβ)`` for the incoming
    gradient g at x, given the forward's (B, 2, G) stats. g must have x's
    shape, dtype and channels-last layout. A CUDA tensor launches kernel #2
    (and counts it in ``bwd_launches``); a CPU tensor runs the plain
    version."""
    _check(x, weight, bias, num_groups)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(
            f"gradient {tuple(g.shape)} {g.dtype} on {g.device} does not match "
            f"the input {tuple(x.shape)} {x.dtype} on {x.device}"
        )
    if not g.is_contiguous(memory_format=channels_last_format(x)):
        raise ValueError("the GroupNorm backward needs a channels_last-contiguous gradient")
    b = x.shape[0]
    if (stats.dtype != torch.float32 or tuple(stats.shape) != (b, 2, num_groups)
            or not stats.is_contiguous() or stats.device != x.device):
        raise ValueError(f"stats must be a contiguous float32 ({b}, 2, {num_groups}) "
                         f"tensor on {x.device}")
    if x.device.type == "cpu":
        return group_norm_fp32_backward(x, g, stats[:, 0], stats[:, 1], weight, bias,
                                        num_groups, with_swish)
    return _launch_backward(x, g, stats, weight, bias, num_groups, with_swish)


def _launch_backward(x, g, stats, weight, bias, num_groups, with_swish):
    global bwd_launches
    b, c = x.shape[:2]
    s = math.prod(x.shape[2:])
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("the GroupNorm backward needs 16-byte aligned x and gradient")
    threads, rows_per_tile, n_tiles = launch_geometry(
        b, s, c, x.element_size(), num_sms(x.device.index)
    )
    lib = library()
    dx = torch.empty_like(x, memory_format=channels_last_format(x))
    partial = torch.empty((b, n_tiles, 2, c), dtype=torch.float32, device=x.device)
    coef = torch.empty((b, 3, c), dtype=torch.float32, device=x.device)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gn_backward(
            x.data_ptr(), g.data_ptr(), stats.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), dx.data_ptr(), partial.data_ptr(), coef.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(),
            b, s, c, num_groups, rows_per_tile, n_tiles, threads,
            int(with_swish), _DTYPE_CODES[x.dtype], stream,
        )
    _raise_on(err, lib, "backward")
    bwd_launches += 1
    return dx, dgamma, dbeta


class FusedGroupNorm(torch.autograd.Function):
    """GroupNorm(+swish) with the kernels (CUDA) or the plain versions (CPU)
    forward and backward; the counterpart of ``_fused_gn_vjp``."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, with_swish):
        y, stats = group_norm_forward(x, weight, bias, num_groups, eps, with_swish)
        ctx.save_for_backward(x, stats, weight, bias)
        ctx.num_groups = num_groups
        ctx.with_swish = with_swish
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, stats, weight, bias = ctx.saved_tensors
        # a flip or a slice downstream can hand back another layout
        g = g.contiguous(memory_format=channels_last_format(g))
        dx, dgamma, dbeta = group_norm_backward(
            x, g, stats, weight, bias, ctx.num_groups, ctx.with_swish
        )
        return dx, dgamma, dbeta, None, None, None


def fused_group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    with_swish: bool = False,
) -> torch.Tensor:
    """GroupNorm(+swish) of a channels_last (B, C, H, W) or channels_last_3d
    (B, C, T, H, W) tensor with fp32 statistics and arithmetic; returns x's
    dtype and layout, and is differentiable in x, weight and bias."""
    return FusedGroupNorm.apply(x, weight, bias, num_groups, eps, with_swish)
