"""Exact non-causal attention, forward and backward: the binding of the
hand-written CUDA kernels for Hopper and the ``torch.autograd.Function`` that
joins them.

Replaces ``vqgan_tpu/ops/flash_attention.py::flash_attention_tpu``, which
wraps the Pallas TPU flash-attention kernel that ships with JAX (a forward
and the dK/dV and dQ backward passes). The kernels are ``csrc/attention.cu``,
built by ``nvcc`` for ``sm_90a`` at first use and bound with ctypes; the
source says what bounds them on an H100 and what the design does about it.

``FlashAttention`` saves q, k, v, the output and the fp32 (B, H, N)
logsumexp: the JAX residuals (``vqgan_tpu/ops/chunked_attention.py``), all
O(N·D). A CUDA tensor launches the kernels, or raises; a CPU tensor runs the
chunked plain versions (``ops/attention.py``), with k/v chunks of ``chunk``
tokens. There is no fallback between the two. The kernels take any N >= 1
and choose their own tiles, so ``chunk`` does not reach them. The forward
goes through the operator ``vqgan_tpu_torch::attention_forward``
(``ops/custom_ops.py``), which makes that choice by device and which
``torch.export`` traces; the backward is a plain call.

Inputs are (B, N, H, D), fp32 or bf16, all of one dtype and device. The
dtype alone picks the kernels' route (``route``): bf16 the tensor cores
(bf16 ``mma.sync`` fed by ``cp.async``), fp32 the CUDA cores' FMA. On the
card D is 16, 32, 64 or 128 (any other head_dim raises), the last stride 1
and the others multiples of 8 elements (bf16: 16-byte ``cp.async`` pieces)
or 4 (fp32: float4 loads), each tensor 16-byte aligned, so q, k and v may
be views of the qkv conv's channels-last output (token stride 3C, C a
multiple of 32). A view a route cannot take raises; nothing falls back to
the other route or to plain.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from vqgan_tpu_torch.ops.attention import chunked_attention_backward, chunked_attention_forward
from vqgan_tpu_torch.ops.cuda_build import load_library

# Kernel launches since the count was last set to 0: one per forward
# (``fwd_launches``) or backward (``bwd_launches``) call that reached the
# CUDA kernels, and the same calls by route: bf16 on the tensor cores
# (``tc_launches``), fp32 on the CUDA cores (``fma_launches``). Calls on CPU
# tensors do not count.
fwd_launches = 0
bwd_launches = 0
tc_launches = 0
fma_launches = 0

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.bfloat16: "tc", torch.float32: "fma"}
# what a stride must be a multiple of, in elements, by route: the tensor-core
# kernels copy 16-byte pieces of 8 bf16, the FMA kernels read float4
STRIDE_MULTIPLE = {"tc": 8, "fma": 4}
ALIGN_BYTES = 16
# the tensor-core route's tiles (csrc/attention.cu kTcRows, kTcStep<D>): a
# block owns 128 queries (keys in the dK/dV kernel), 16 a warp, and streams
# the other side in tiles of 64 rows, 32 at head_dim 128
TC_BLOCK_ROWS = 128
TC_STEP_ROWS = {16: 64, 32: 64, 64: 64, 128: 32}


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (built on the first call)."""
    lib = load_library("attention")
    lib.attn_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.attn_forward.restype = ctypes.c_int
    lib.attn_backward.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.attn_backward.restype = ctypes.c_int
    lib.attn_error_string.argtypes = [ctypes.c_int]
    lib.attn_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(q: torch.Tensor, *others: torch.Tensor) -> None:
    """Raises unless q is a (B, N, H, D) fp32 or bf16 tensor on the CPU or a
    CUDA device and every other tensor has its shape, dtype and device."""
    if q.ndim != 4:
        raise ValueError(f"attention takes (B, N, H, D) tensors, got shape {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention takes float32 or bfloat16, not {q.dtype}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention runs on cpu or cuda, not {q.device}")
    for t in others:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{tuple(t.shape)} {t.dtype} on {t.device} does not match q: "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")


def route(dtype: torch.dtype) -> str:
    """The kernels' route for a dtype: "tc" (bf16, tensor cores) or "fma"
    (fp32, CUDA cores)."""
    return ROUTES[dtype]


def _kernel_strides(*tensors: torch.Tensor) -> ctypes.Array:
    """The (batch, token, head) strides of each tensor, as the kernels take
    them; raises where the route's vector copies would not hold (a pure
    function of shapes, strides and addresses: it needs no card)."""
    head_dim = tensors[0].shape[-1]
    if head_dim not in HEAD_DIMS:
        raise NotImplementedError(
            f"the attention kernels take head_dim {', '.join(map(str, HEAD_DIMS))}, "
            f"not {head_dim}")
    if tensors[0].shape[0] * tensors[0].shape[2] > 65535:
        raise ValueError("the attention kernels take at most 65535 (batch, head) pairs")
    kind = route(tensors[0].dtype)
    multiple = STRIDE_MULTIPLE[kind]
    out = []
    for t in tensors:
        if (t.stride(3) != 1 or any(s % multiple for s in t.stride()[:3])
                or t.data_ptr() % ALIGN_BYTES):
            raise ValueError(
                f"the attention kernels' {kind} route ({t.dtype}) needs a unit last stride, "
                f"other strides that are multiples of {multiple} and {ALIGN_BYTES}-byte "
                f"alignment; got strides {t.stride()}")
        out.extend(t.stride()[:3])
    return (ctypes.c_int64 * len(out))(*out)


def _count_route(dtype: torch.dtype) -> None:
    global tc_launches, fma_launches
    if route(dtype) == "tc":
        tc_launches += 1
    else:
        fma_launches += 1


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err:
        raise RuntimeError(
            f"attention {what} kernel launch failed: {lib.attn_error_string(err).decode()}")


def _out_dtype(q: torch.Tensor, out_dtype: torch.dtype | None) -> torch.dtype:
    """The outputs' dtype: q's, or fp32 where asked (the ring's partials)."""
    if out_dtype is None or out_dtype == q.dtype:
        return q.dtype
    if out_dtype != torch.float32:
        raise TypeError(f"attention outputs are q's dtype or float32, not {out_dtype}")
    return out_dtype


def attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward, outside autograd: ``(out, lse)``, out (B, N, H, D)
    contiguous in q's dtype, lse the fp32 (B, H, N) logsumexp of the scaled
    scores, through the operator ``vqgan_tpu_torch::attention_forward``
    (``ops/custom_ops.py``): a CUDA tensor launches kernel #3's forward (and
    counts it in ``fwd_launches`` and on its route), a CPU tensor runs the
    plain version. ``out_dtype=torch.float32`` gives a bf16 call's out in
    fp32, uncast (the ring's partials); that call goes to the launch or the
    plain version directly, not through the operator."""
    if _out_dtype(q, out_dtype) == q.dtype:
        return custom_ops.attention_forward(q, k, v, chunk)
    check_inputs(q, k, v)
    if q.device.type == "cpu":
        return chunked_attention_forward(q, k, v, chunk, out_dtype=torch.float32)
    return _launch_forward(q, k, v, torch.float32)


def _launch_forward(q, k, v, out_dtype: torch.dtype | None = None):
    global fwd_launches
    b, n, h, d = q.shape
    out = torch.empty(q.shape, dtype=_out_dtype(q, out_dtype), device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    strides = _kernel_strides(q, k, v, out)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attn_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               lse.data_ptr(), ctypes.addressof(strides), b, h, n, d,
                               _DTYPE_CODES[q.dtype], _DTYPE_CODES[out.dtype], stream)
    _raise_on(err, lib, "forward")
    fwd_launches += 1
    _count_route(q.dtype)
    return out, lse


def attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    chunk: int,
    grad_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward, outside autograd: ``(dq, dk, dv)`` for the incoming
    gradient g of out, given the forward's out and lse. A CUDA tensor
    launches kernel #3's backward (delta, dK/dV, dQ; counted once in
    ``bwd_launches`` and once on its route); a CPU tensor runs the plain
    version. ``grad_dtype=torch.float32`` gives a bf16 call's gradients in
    fp32, uncast (the ring's per-step gradients)."""
    check_inputs(q, k, v, out, g)
    b, n, h, _ = q.shape
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, n)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 ({b}, {h}, {n}) tensor on {q.device}")
    grad_dtype = _out_dtype(q, grad_dtype)
    if q.device.type == "cpu":
        return chunked_attention_backward(q, k, v, out, lse, g, chunk, grad_dtype)
    return _launch_backward(q, k, v, out, lse, g, grad_dtype)


def _launch_backward(q, k, v, out, lse, g, grad_dtype: torch.dtype | None = None):
    global bwd_launches
    b, n, h, d = q.shape
    grads = [torch.empty(q.shape, dtype=_out_dtype(q, grad_dtype), device=q.device)
             for _ in range(3)]
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    strides = _kernel_strides(q, k, v, out, g, *grads)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attn_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in grads),
            ctypes.addressof(strides), b, h, n, d, _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[grads[0].dtype], stream)
    _raise_on(err, lib, "backward")
    bwd_launches += 1
    _count_route(q.dtype)
    return tuple(grads)


class FlashAttention(torch.autograd.Function):
    """Exact attention with the kernels (CUDA) or the chunked plain versions
    (CPU), forward and backward; the counterpart of the custom VJP of
    ``chunked_attention`` and of the Pallas kernel's."""

    @staticmethod
    def forward(ctx, q, k, v, chunk):
        out, lse = attention_forward(q, k, v, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.chunk = chunk
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, lse, g.contiguous(), ctx.chunk)
        return dq, dk, dv, None


# the operator that the forward goes through; it binds this module's launch
# and checks, so it is imported once they are defined
from vqgan_tpu_torch.ops import custom_ops  # noqa: E402
