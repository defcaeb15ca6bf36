"""The vector-quantizer's nearest-code search and code statistics: the
hand-written CUDA kernels for Hopper, their binding, and the dispatch the
quantizer calls.

Replaces ``vqgan_tpu/ops/pallas/vq.py``: ``_nearest_codes_pallas`` (the
Pallas TPU kernel ``_nearest_kernel``) and ``_code_stats_pallas``
(``_stats_kernel``). The kernels are ``csrc/vq.cu``, built by ``nvcc`` for
``sm_90a`` at first use and bound with ctypes; the source says what bounds
each on an H100 and what the design does about it: the search is three TF32
products on the tensor cores (fp32-accurate by splitting each operand into
two TF32 halves), the statistics a group-by-code in two launches (each
tile's records sorted by code, then a block per 16 codes adding them up in
tile order).
Neither forms the (N, K) distance matrix or one-hot of the plain versions
(``ops/vq.py``), and neither uses atomics: both results are bitwise
repeatable.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel, or raises. There is no fallback between the two. The CUDA path takes
any N and any K >= 1 (the kernels mask the ragged edges), so the Pallas
package's 128-multiple rule (``supports_vq_kernel``) has no counterpart here.
Codes carry no gradient: both functions run under ``torch.no_grad()``.
The search goes through the operator ``vqgan_tpu_torch::nearest_codes``
(``ops/custom_ops.py``), which makes the device choice and which
``torch.export`` traces; the statistics are a plain call.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from vqgan_tpu_torch.ops.cuda_build import load_library, num_sms
from vqgan_tpu_torch.ops.vq import code_stats_plain

# Kernel launches since the count was last set to 0: one per call that
# reached the CUDA kernels; calls on CPU tensors do not count.
nearest_launches = 0
stats_launches = 0

MAX_DIM = 64  # the search keeps a z row of up to 64 floats in registers
# The kernels' geometry, which sizes the workspaces below (csrc/vq.cu; the
# library reports it too: vq_search_block_tokens, vq_stats_tile_tokens,
# vq_stats_merge_codes)
SEARCH_WARPS = 8
SEARCH_MIN_SPLIT_CODES = 64  # no codebook split of the search holds fewer codes
STATS_TILE = 256  # tokens a tile of the statistics holds: one block of launch 1
STATS_MERGE_CODES = 16  # codes a block of the statistics' merge owns
_BLOCKS_PER_SM = 2  # search blocks resident on an SM (~100 KB of shared memory each)


def padded_dim(d: int) -> int:
    """The search's width of a z row: D rounded up to 8, 16, 32 or 64."""
    return next(p for p in (8, 16, 32, 64) if d <= p)


def search_block_tokens(d: int) -> int:
    """Tokens a block of the search owns: its warps' 16-token m-tiles, as
    many a warp as its registers hold (4 at D <= 16, 2 at D <= 32, 1)."""
    return SEARCH_WARPS * 16 * {8: 4, 16: 4, 32: 2, 64: 1}[padded_dim(d)]


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (built on the first call)."""
    lib = load_library("vq")
    lib.vq_nearest_codes.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.vq_nearest_codes.restype = ctypes.c_int
    lib.vq_code_stats.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.vq_code_stats.restype = ctypes.c_int
    lib.vq_search_block_tokens.argtypes = [ctypes.c_int]
    lib.vq_search_block_tokens.restype = ctypes.c_int
    for name in ("vq_stats_tile_tokens", "vq_stats_merge_codes"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.vq_error_string.argtypes = [ctypes.c_int]
    lib.vq_error_string.restype = ctypes.c_char_p
    return lib


def nearest_launch_geometry(n: int, k: int, d: int, num_sms: int) -> tuple[int, int]:
    """(splits, codes per split) of the search: the codebook is cut into
    contiguous ranges, one per grid row, so that a small N still fills one
    wave of ``_BLOCKS_PER_SM`` blocks an SM, and no more than one. No range
    is much shorter than ``SEARCH_MIN_SPLIT_CODES``; every range but the last
    holds a whole number of 8-code mma tiles, and none is empty."""
    token_blocks = math.ceil(n / search_block_tokens(d))
    splits = max(1, _BLOCKS_PER_SM * num_sms // token_blocks)
    splits = min(splits, math.ceil(k / SEARCH_MIN_SPLIT_CODES))
    per = math.ceil(math.ceil(k / splits) / 8) * 8
    return math.ceil(k / per), per


def stats_tile_plan(n: int, k: int) -> tuple[int, int, int]:
    """(tiles, tokens a tile, index entries a tile) of the statistics: tile i
    holds tokens [i * STATS_TILE, (i + 1) * STATS_TILE) and writes at most
    STATS_TILE records, one per code it holds, sorted by code, and an index:
    for each block b of STATS_MERGE_CODES codes, its first record with a code
    >= b * STATS_MERGE_CODES (one entry more: the record count)."""
    return math.ceil(n / STATS_TILE), STATS_TILE, math.ceil(k / STATS_MERGE_CODES) + 1


def _check_device(t: torch.Tensor, name: str, like: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the VQ kernels run on cpu or cuda, not {t.device}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, z on {like.device}")


def _check_rows(flat: torch.Tensor, what: str) -> None:
    if flat.ndim != 2 or flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError(f"{what} must be a contiguous float32 (rows, D) tensor, got "
                         f"{flat.dtype} {tuple(flat.shape)}")
    if not 1 <= flat.shape[1] <= MAX_DIM:
        raise ValueError(f"{what} has D = {flat.shape[1]}; the kernels take 1 <= D <= {MAX_DIM}")


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err:
        raise RuntimeError(f"VQ {what} kernel launch failed: {lib.vq_error_string(err).decode()}")


def check_nearest(flat: torch.Tensor, codebook: torch.Tensor) -> None:
    """Raises unless z and the codebook are contiguous fp32 (N, D) and (K, D)
    tensors, 1 <= D <= ``MAX_DIM``, K >= 1, on one CPU or CUDA device."""
    _check_rows(flat, "z")
    _check_rows(codebook, "the codebook")
    _check_device(codebook, "the codebook", flat)
    if codebook.shape[1] != flat.shape[1] or codebook.shape[0] < 1:
        raise ValueError(f"codebook {tuple(codebook.shape)} does not match z "
                         f"{tuple(flat.shape)}")


@torch.no_grad()
def nearest_codes(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices (N,) int32 of (N, D) fp32 tokens against a (K, D)
    fp32 codebook; the first index wins an exact tie. Through the operator
    ``vqgan_tpu_torch::nearest_codes`` (``ops/custom_ops.py``): a CUDA tensor
    launches kernel #4 (and counts it in ``nearest_launches``), a CPU tensor
    runs the plain version."""
    return custom_ops.nearest_codes(flat, codebook)


def _launch_nearest(flat, codebook):
    global nearest_launches
    n, d = flat.shape
    k = codebook.shape[0]
    codes = torch.empty(n, dtype=torch.int32, device=flat.device)
    if n == 0:
        return codes
    splits, per = nearest_launch_geometry(n, k, d, num_sms(flat.device.index))
    part = splits if splits > 1 else 0
    part_dist = torch.empty((part, n), dtype=torch.float32, device=flat.device)
    part_idx = torch.empty((part, n), dtype=torch.int32, device=flat.device)
    # the codebook split into TF32 halves in the kernel's tile layout, and |E|^2
    n8 = math.ceil(k / 8)
    split = torch.empty(n8 * 16 * padded_dim(d), dtype=torch.float32, device=flat.device)
    e_sq = torch.empty(n8 * 8, dtype=torch.float32, device=flat.device)
    lib = library()
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = lib.vq_nearest_codes(
            flat.data_ptr(), codebook.data_ptr(), split.data_ptr(), e_sq.data_ptr(),
            part_dist.data_ptr(), part_idx.data_ptr(), codes.data_ptr(), n, k, d, splits, per,
            stream,
        )
    _raise_on(err, lib, "nearest-code")
    nearest_launches += 1
    return codes


@torch.no_grad()
def code_stats(
    codes: torch.Tensor, flat: torch.Tensor, codebook_size: int, *, with_sums: bool = False
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(counts, sums) over codes: counts[k] = |{n: codes[n] = k}| as fp32
    (K,); sums[k] = Σ_{codes[n]=k} flat[n] as fp32 (K, D) when ``with_sums``,
    else None. codes is (N,) int32, flat (N, D) fp32. A CUDA tensor launches
    kernel #5 (and counts it in ``stats_launches``); a CPU tensor runs the
    plain version."""
    _check_rows(flat, "z")
    _check_device(codes, "codes", flat)
    if (codes.dtype != torch.int32 or codes.ndim != 1 or not codes.is_contiguous()
            or codes.shape[0] != flat.shape[0]):
        raise ValueError(f"codes must be a contiguous int32 ({flat.shape[0]},) tensor, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if codebook_size < 1:
        raise ValueError(f"codebook_size must be >= 1, got {codebook_size}")
    if flat.device.type == "cpu":
        return code_stats_plain(codes, flat, codebook_size, with_sums)
    return _launch_stats(codes, flat, codebook_size, with_sums)


def _launch_stats(codes, flat, k, with_sums):
    global stats_launches
    n, d = flat.shape
    dev = flat.device
    tiles, tile, index = stats_tile_plan(n, k)
    rec_first = torch.empty(tiles * index, dtype=torch.int32, device=dev)
    rec_code = torch.empty(tiles * tile, dtype=torch.int32, device=dev)
    rec_count = torch.empty(tiles * tile, dtype=torch.int32, device=dev)
    rec_sum = torch.empty((tiles * tile if with_sums else 0, d), dtype=torch.float32,
                          device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    sums = torch.empty((k, d) if with_sums else (0, d), dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vq_code_stats(
            codes.data_ptr(), flat.data_ptr(), rec_code.data_ptr(), rec_count.data_ptr(),
            rec_sum.data_ptr(), rec_first.data_ptr(), counts.data_ptr(), sums.data_ptr(), n, k,
            d, int(with_sums), stream,
        )
    _raise_on(err, lib, "code-statistics")
    stats_launches += 1
    return counts, (sums if with_sums else None)


# the operator that the search goes through; it binds this module's launch
# and checks, so it is imported once they are defined
from vqgan_tpu_torch.ops import custom_ops  # noqa: E402
