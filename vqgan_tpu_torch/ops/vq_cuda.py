"""The vector-quantizer's nearest-code search and code statistics: the
hand-written CUDA kernels for Hopper, their binding, and the dispatch the
quantizer calls.

Replaces ``vqgan_tpu/ops/pallas/vq.py``: ``_nearest_codes_pallas`` (the
Pallas TPU kernel ``_nearest_kernel``) and ``_code_stats_pallas``
(``_stats_kernel``). The kernels are ``csrc/vq.cu``, built by ``nvcc`` for
``sm_90a`` at first use and bound with ctypes; the source says what bounds
each on an H100 and what the design does about it. Neither forms the (N, K)
distance matrix or one-hot of the plain versions (``ops/vq.py``).

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel, or raises. There is no fallback between the two. The CUDA path takes
any N and any K >= 1 (the kernels mask the ragged edges), so the Pallas
package's 128-multiple rule (``supports_vq_kernel``) has no counterpart here.
Codes carry no gradient: both functions run under ``torch.no_grad()``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from vqgan_tpu_torch.ops.cuda_build import load_library, num_sms
from vqgan_tpu_torch.ops.vq import code_stats_plain, nearest_codes_plain

# Kernel launches since the count was last set to 0: one per call that
# reached the CUDA kernels; calls on CPU tensors do not count.
nearest_launches = 0
stats_launches = 0

MAX_DIM = 64  # the kernels keep a z row of up to 64 floats in registers
NEAREST_THREADS = 256  # tokens per block of the search (csrc/vq.cu)
STATS_CODES = 128  # codes per block of the statistics
STATS_TILE = 128  # tokens per shared-memory tile of the statistics
_BLOCKS_PER_SM = 2  # search
_STATS_BLOCKS_PER_SM = 4


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (built on the first call)."""
    lib = load_library("vq")
    lib.vq_nearest_codes.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.vq_nearest_codes.restype = ctypes.c_int
    lib.vq_code_stats.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.vq_code_stats.restype = ctypes.c_int
    lib.vq_error_string.argtypes = [ctypes.c_int]
    lib.vq_error_string.restype = ctypes.c_char_p
    return lib


def nearest_launch_geometry(n: int, k: int, num_sms: int) -> tuple[int, int]:
    """(splits, codes per split) of the search: the codebook is cut into
    contiguous ranges, one per grid row, so that a small N still gives about
    ``_BLOCKS_PER_SM`` blocks per SM. No range is shorter than one block of
    tokens' worth of codes, and none is empty."""
    token_blocks = math.ceil(n / NEAREST_THREADS)
    splits = math.ceil(_BLOCKS_PER_SM * num_sms / token_blocks)
    splits = max(1, min(splits, math.ceil(k / NEAREST_THREADS)))
    per = math.ceil(k / splits)
    return math.ceil(k / per), per


def stats_launch_geometry(n: int, k: int, num_sms: int) -> tuple[int, int]:
    """(splits, tokens per split) of the statistics: the tokens are cut into
    contiguous ranges of whole tiles, one per grid row, so that the grid has
    about ``_STATS_BLOCKS_PER_SM`` blocks per SM and no code's chain of
    matches runs through all N tokens. None is empty."""
    code_blocks = math.ceil(k / STATS_CODES)
    splits = math.ceil(_STATS_BLOCKS_PER_SM * num_sms / code_blocks)
    splits = max(1, min(splits, math.ceil(n / STATS_TILE)))
    per = math.ceil(math.ceil(n / splits) / STATS_TILE) * STATS_TILE
    return (math.ceil(n / per) if n else 1), per


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


@torch.no_grad()
def nearest_codes(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices (N,) int32 of (N, D) fp32 tokens against a (K, D)
    fp32 codebook; the first index wins an exact tie. A CUDA tensor launches
    kernel #4 (and counts it in ``nearest_launches``); a CPU tensor runs the
    plain version."""
    _check_rows(flat, "z")
    _check_rows(codebook, "the codebook")
    _check_device(codebook, "the codebook", flat)
    if codebook.shape[1] != flat.shape[1] or codebook.shape[0] < 1:
        raise ValueError(f"codebook {tuple(codebook.shape)} does not match z "
                         f"{tuple(flat.shape)}")
    if flat.device.type == "cpu":
        return nearest_codes_plain(flat, codebook)
    return _launch_nearest(flat, codebook)


def _launch_nearest(flat, codebook):
    global nearest_launches
    n, d = flat.shape
    k = codebook.shape[0]
    codes = torch.empty(n, dtype=torch.int32, device=flat.device)
    if n == 0:
        return codes
    splits, per = nearest_launch_geometry(n, k, num_sms(flat.device.index))
    part = splits if splits > 1 else 0
    part_dist = torch.empty((part, n), dtype=torch.float32, device=flat.device)
    part_idx = torch.empty((part, n), dtype=torch.int32, device=flat.device)
    lib = library()
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = lib.vq_nearest_codes(
            flat.data_ptr(), codebook.data_ptr(), part_dist.data_ptr(), part_idx.data_ptr(),
            codes.data_ptr(), n, k, d, splits, per, stream,
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
    splits, per = stats_launch_geometry(n, k, num_sms(dev.index))
    part = splits if splits > 1 else 0
    part_counts = torch.empty((part, k), dtype=torch.int32, device=dev)
    part_sums = torch.empty((part if with_sums else 0, k, d), dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    sums = torch.empty((k, d) if with_sums else (0, d), dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vq_code_stats(
            codes.data_ptr(), flat.data_ptr(), part_counts.data_ptr(), part_sums.data_ptr(),
            counts.data_ptr(), sums.data_ptr(), n, k, d, int(with_sums), splits, per, stream,
        )
    _raise_on(err, lib, "code-statistics")
    stats_launches += 1
    return counts, (sums if with_sums else None)
