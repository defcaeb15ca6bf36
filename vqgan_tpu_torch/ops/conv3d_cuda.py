"""Fused-tap 3×3×3 stride-1 SAME Conv3d: the binding of the hand-written CUDA
kernels for Hopper and the ``torch.autograd.Function`` around them.

Replaces ``vqgan_tpu/ops/pallas/conv3d.py::conv3d_ttap``: the Pallas TPU
kernel ``_conv3d_pallas`` and its custom VJP. The kernels are
``csrc/conv3d.cu``, built by ``nvcc`` for ``sm_90a`` at first use and bound
with ctypes; the source says what bounds them on an H100 and what the
design does about it.

Inputs are (B, Ci, T, H, W) tensors in ``torch.channels_last_3d`` memory
format, physically (B, T, H, W, Ci), and an OIDHW (Co, Ci, 3, 3, 3) weight
of the same dtype, fp32 or bf16. The dtype alone picks the route: bf16 runs
the tensor-core kernel (bf16 ``mma.sync``, fp32 sums), fp32 the CUDA-core
FMA kernel (fp32 products, which no tensor-core type gives). The wrapper
repacks the weight into the route's rows, zero-padded to whole tiles, and
returns a channels_last_3d output of x's dtype. A CUDA tensor launches the
route's kernel, or raises; a CPU tensor runs the plain version
(``ops/conv3d.py``). There is no fallback between routes or to cuDNN.

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
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vqgan_tpu_torch.ops.conv3d import (
    conv3d_input_grad_plain,
    conv3d_plain,
    conv3d_weight_grad,
    flipped_weight,
)
from vqgan_tpu_torch.ops.cuda_build import load_library, num_sms

# Kernel launches since the count was last set to 0: one per forward call
# (``launches``) or dx call (``bwd_launches``) that reached a CUDA kernel,
# and the same calls by route: bf16 on the tensor cores (``tc_launches``),
# fp32 on the CUDA cores (``fma_launches``). Calls on CPU tensors do not
# count.
launches = 0
bwd_launches = 0
tc_launches = 0
fma_launches = 0

ROUTES = {torch.bfloat16: "tc", torch.float32: "fma"}
BLOCK_K = {"tc": 32, "fma": 16}  # rows of K a step (csrc/conv3d.cu kTcBK, kBK)
# the tensor-core kernel's tiles (csrc/conv3d.cu launch_tc_tile): (BM, BN)
TC_TILES = ((128, 128), (256, 64), (128, 64), (256, 16), (256, 8))
_THREADS = 256
_MIN_CHUNKS_PER_SPLIT = 4  # the fp32 route's shortest split, in steps of K
# The tensor-core route's split of K (tc_rule), fitted to tools/sweep_conv3d.py's
# times of every candidate at the path shapes on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md §6): the splits it tries, the blocks an SM holds at once
# (256 threads, at most 100 KB of shared memory each), the shortest split, and
# what one split's fp32 partials cost (written and summed again) per 128 x 128
# outputs, in steps of K of one block.
TC_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
TC_BLOCKS_PER_SM = 2
TC_MIN_STEPS_PER_SPLIT = 5
TC_PARTIAL_COST = 0.04


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (built on the first call)."""
    lib = load_library("conv3d")
    lib.conv3d_forward_fp32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                                        + [ctypes.c_void_p])
    lib.conv3d_forward_fp32.restype = ctypes.c_int
    lib.conv3d_forward_bf16.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                                        + [ctypes.c_void_p])
    lib.conv3d_forward_bf16.restype = ctypes.c_int
    lib.conv3d_pack_bf16.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                                     + [ctypes.c_int64] * 5 + [ctypes.c_void_p])
    lib.conv3d_pack_bf16.restype = ctypes.c_int
    lib.conv3d_error_string.argtypes = [ctypes.c_int]
    lib.conv3d_error_string.restype = ctypes.c_char_p
    return lib


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is cut: the ``route`` ("tc" bf16 tensor cores, "fma"
    fp32 CUDA cores), its ``tile`` (tc: an index of ``TC_TILES``; fma: -1),
    ``block_m`` voxels by ``block_n`` output channels a block, the packed
    weight's ``n_pad`` output channels and ``n_chunks`` steps of
    ``BLOCK_K[route]`` rows of K, and K in ``splits`` ranges of
    ``chunks_per_split`` steps."""

    route: str
    tile: int
    block_m: int
    block_n: int
    n_pad: int
    n_chunks: int
    splits: int
    chunks_per_split: int

    @property
    def block_k(self) -> int:
        return BLOCK_K[self.route]


def _split(n_chunks: int, splits: int) -> tuple[int, int]:
    """``splits`` ranges of whole steps with none empty: (splits, steps a
    range)."""
    per = math.ceil(n_chunks / max(1, min(splits, n_chunks)))
    return math.ceil(n_chunks / per), per


def tc_rule(m: int, ci: int, co: int, sms: int) -> tuple[int, int]:
    """(tile, splits) of the bf16 conv of M voxels, Ci in and Co out, on a
    card of ``sms`` SMs. The tile: the narrowest that covers Co (n8 for Co
    <= 8, n16 for Co <= 16, n64 for Co <= 64, else n128 at 128 voxels), for
    n64 the 256-voxel form unless Ci < 8 (the element gather) or its tiles
    number fewer than the SMs. The split: of ``TC_SPLITS``, the one whose
    waves of ``TC_BLOCKS_PER_SM`` blocks an SM times the steps of K a split
    takes, plus what its partials cost, are least (a last wave that is
    mostly empty costs as much as a full one); no split shorter than
    ``TC_MIN_STEPS_PER_SPLIT`` steps."""
    if co <= 8:
        tile = 4
    elif co <= 16:
        tile = 3
    elif co > 64:
        tile = 0
    else:
        tile = 2 if ci < 8 or math.ceil(m / 256) * math.ceil(co / 64) < sms else 1
    bm, bn = TC_TILES[tile]
    tiles = math.ceil(m / bm) * math.ceil(co / bn)
    n_chunks = math.ceil(27 * ci / BLOCK_K["tc"])
    best = None
    for s in TC_SPLITS:
        splits, per = _split(n_chunks, s)
        if splits > 1 and per < TC_MIN_STEPS_PER_SPLIT:
            break
        cost = math.ceil(tiles * splits / (TC_BLOCKS_PER_SM * sms)) * per
        if splits > 1:
            cost += TC_PARTIAL_COST * splits * tiles * bm * bn / 128 ** 2
        if best is None or cost < best[0]:
            best = (cost, splits)
    return tile, best[1]


@functools.cache
def launch_plan(m: int, ci: int, co: int, sms: int, dtype: torch.dtype) -> LaunchPlan:
    """The plan for M = B·T·H·W voxels, Ci in and Co out, in ``dtype``, on a
    card of ``sms`` SMs. bf16 takes the tensor-core route, cut by
    ``tc_rule``. fp32 takes the FMA route: Co <= 16 16-channel tiles of 512
    voxels, else 64-channel tiles of 128; where the tiles fill fewer than
    one block per SM, K is split so that there are about two, each split at
    least 4 chunks long."""
    route = ROUTES[dtype]
    if route == "tc":
        n_chunks = math.ceil(27 * ci / BLOCK_K["tc"])
        tile, splits = tc_rule(m, ci, co, sms)
        block_m, block_n = TC_TILES[tile]
    else:
        tile = -1
        block_n = 16 if co <= 16 else 64
        block_m = _THREADS // (block_n // 4) * 8  # csrc/conv3d.cu's BM
        bk = BLOCK_K["fma"]
        n_chunks = 27 * ci // bk if ci % bk == 0 else math.ceil(27 * ci / bk)
        tiles = math.ceil(m / block_m) * math.ceil(co / block_n)
        splits = 1
        if tiles < sms:
            splits = max(1, min(math.ceil(2 * sms / tiles), n_chunks // _MIN_CHUNKS_PER_SPLIT))
    n_pad = math.ceil(co / block_n) * block_n
    return LaunchPlan(route, tile, block_m, block_n, n_pad, n_chunks, *_split(n_chunks, splits))


def pack_weight(weight: torch.Tensor, plan: LaunchPlan) -> torch.Tensor:
    """OIDHW (Co, Ci, 3, 3, 3) → the route's packed weight in the weight's
    dtype, K row k = tap·Ci + ci with tap = (dt·3 + dh)·3 + dw, zeros past
    27·Ci and past Co. tc: (n_pad, n_chunks·32), K-contiguous per output
    channel, the rows ``csrc/conv3d.cu::conv3d_pack_kernel`` writes on the
    card (this is its plain version); fma: (n_chunks·16, n_pad), K-major,
    the fp32 route's packing."""
    co, ci = weight.shape[:2]
    k_pad = plan.n_chunks * plan.block_k
    # reshape copies an OIDHW weight but is a view of a channels_last_3d one:
    # the kernels read the rows' memory, so make them contiguous either way
    if plan.route == "tc":
        rows = weight.permute(0, 2, 3, 4, 1).reshape(co, 27 * ci).contiguous()  # [co][k]
        pad = (0, k_pad - 27 * ci, 0, plan.n_pad - co)
    else:
        rows = weight.permute(2, 3, 4, 1, 0).reshape(27 * ci, co).contiguous()  # [k][co]
        pad = (0, plan.n_pad - co, 0, k_pad - 27 * ci)
    return F.pad(rows, pad) if any(pad) else rows


def _check(x: torch.Tensor, weight: torch.Tensor, transpose: bool = False) -> None:
    """x (B, C, T, H, W) channels_last_3d and an OIDHW weight whose conv
    takes C channels: weight (Co, C, 3, 3, 3), or with ``transpose`` (the
    dx's flipped, Ci/Co-swapped weight) (C, Ci, 3, 3, 3)."""
    if x.ndim != 5:
        raise ValueError(f"expected (B, C, T, H, W), got shape {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError(
            "conv3d_ttap needs a torch.channels_last_3d-contiguous input "
            "(physically (B, T, H, W, C)); convert it once where it is made")
    if x.dtype not in ROUTES:
        raise TypeError(f"conv3d_ttap takes float32 or bfloat16, not {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3d_ttap runs on cpu or cuda, not {x.device}")
    want = (x.shape[1], "Ci") if transpose else ("Co", x.shape[1])
    if (weight.ndim != 5 or tuple(weight.shape[2:]) != (3, 3, 3)
            or weight.shape[int(not transpose)] != x.shape[1]):
        raise ValueError(f"weight {tuple(weight.shape)} is not ({want[0]}, {want[1]}, 3, 3, 3)")
    if weight.dtype != x.dtype or weight.device != x.device:
        raise ValueError(f"weight {weight.dtype} on {weight.device} does not match the input "
                         f"{x.dtype} on {x.device}")


def _launch(x: torch.Tensor, weight: torch.Tensor, plan: LaunchPlan | None = None,
            sums: bool = False, transpose: bool = False) -> torch.Tensor:
    """Launches ``plan`` (default: ``launch_plan``'s) on the card for the
    conv of x with the OIDHW ``weight`` (with ``transpose``: with its
    flipped, Ci/Co-swapped form, the dx) and counts the call by route.
    ``sums`` (bf16 only): return the fp32 sums before the cast, (splits, B,
    T, H, W, Co), instead of the output."""
    global tc_launches, fma_launches
    b, ci, t, h, w = x.shape
    co = weight.shape[1] if transpose else weight.shape[0]
    if plan is None:
        plan = launch_plan(b * t * h * w, ci, co, num_sms(x.device.index), x.dtype)
    vec = ci % (8 if plan.route == "tc" else BLOCK_K["fma"]) == 0
    if vec and x.data_ptr() % 16:
        raise ValueError("conv3d_ttap needs a 16-byte aligned input")
    y = torch.empty((b, co, t, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last_3d)
    partial = None
    if plan.splits > 1 or sums:
        partial = torch.empty((plan.splits, b, t, h, w, co), dtype=torch.float32,
                              device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.route == "tc":
            k_pad = plan.n_chunks * plan.block_k
            packed = torch.empty((plan.n_pad, k_pad), dtype=x.dtype, device=x.device)
            # the pack kernel reads the weight by its strides: OIDHW or
            # channels_last_3d (as the TVAE holds it) alike, with no copy
            err = lib.conv3d_pack_bf16(weight.data_ptr(), packed.data_ptr(), *weight.shape[:2],
                                       plan.n_pad, k_pad, int(transpose), *weight.stride(),
                                       stream)
            if not err:
                err = lib.conv3d_forward_bf16(
                    x.data_ptr(), packed.data_ptr(), y.data_ptr(),
                    None if partial is None else partial.data_ptr(), b, t, h, w, ci, co,
                    plan.n_pad, k_pad, plan.tile, plan.splits, plan.chunks_per_split, int(sums),
                    stream)
        else:
            packed = pack_weight(flipped_weight(weight) if transpose else weight, plan)
            err = lib.conv3d_forward_fp32(
                x.data_ptr(), packed.data_ptr(), y.data_ptr(),
                None if partial is None else partial.data_ptr(), b, t, h, w, ci, co,
                plan.n_pad, plan.n_chunks, plan.splits, plan.chunks_per_split, plan.block_n,
                stream)
    if err:
        raise RuntimeError(
            f"conv3d kernel launch failed: {lib.conv3d_error_string(err).decode()}")
    if plan.route == "tc":
        tc_launches += 1
    else:
        fma_launches += 1
    return partial if sums else y


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


def conv3d_forward_sums(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The bf16 forward's fp32 sums before the cast, (B, Co, T, H, W)
    channels_last_3d, added over its splits in split order: the tensor
    cores' accumulation, held against the fp32 plain version of the same
    bf16 inputs without a bf16 ulp. CUDA bf16 tensors only; counts in
    ``launches``."""
    global launches
    _check(x, weight)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError("conv3d_forward_sums takes bf16 tensors on the card")
    parts = _launch(x, weight, sums=True)
    launches += 1
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total.permute(0, 4, 1, 2, 3)


def conv3d_input_grad(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """dx for the incoming gradient dy (B, Co, T, H, W) of the forward with
    ``weight``: the same conv with the flipped, Ci/Co-transposed weight. A
    CUDA tensor launches kernel #6 (and counts it in ``bwd_launches``); a
    CPU tensor runs the plain version."""
    global bwd_launches
    _check(dy, weight, transpose=True)
    if dy.device.type == "cpu":
        return conv3d_input_grad_plain(dy, weight)
    dx = _launch(dy, weight, transpose=True)
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
