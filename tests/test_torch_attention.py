"""The port's attention ops against the JAX package's, on the CPU.

The plain versions (``vqgan_tpu_torch/ops/attention.py``: the chunked
forward and backward, kernel #3's plain versions, and the dense path) are
held against ``vqgan_tpu/ops/chunked_attention.py``, against
``jax.nn.dot_product_attention`` and against the Pallas TPU flash kernel
that ``flash_attention_tpu`` wraps, run in interpret mode as
tests/test_ops.py runs it. Inputs are numpy draws from a seed; gradients
are the vector-Jacobian products for one numpy cotangent g.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.ops.chunked_attention import _forward, chunked_attention
from vqgan_tpu_torch.ops import attention_cuda
from vqgan_tpu_torch.ops.attention import (
    chunked_attention_backward,
    chunked_attention_forward,
    dense_attention,
    memory_efficient_attention,
)

# fp32: the same arithmetic in another summation order (tests/test_ops.py's
# bounds for the chunked path against dense)
RTOL_FWD, ATOL_FWD = 2e-5, 2e-6
RTOL_GRAD, ATOL_GRAD = 2e-4, 2e-5
# bf16 outputs: both sides compute in fp32 from the same bf16 inputs and round
# once at the end, so fp32 values on either side of a rounding boundary give
# one bf16 ulp, at most 2^-7 of the value
RTOL_BF16 = 2.0 ** -7
# bf16 against a reference that rounds elsewhere: the dense path's backward
# rounds dP and the cotangents of its casts to bf16 in other places than
# JAX's autodiff (measured: forward equal, gradients 0.0018 of each tensor's
# largest entry), and bf16 inputs against fp32 ones differ by the inputs'
# own rounding (measured 0.0055): 2^-6 of the largest entry
BF16_OF_MAX = 2.0 ** -6


def _draws(shape, seed, n_arrays=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n_arrays)]


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _np(t):
    return np.array(t.float().detach().numpy() if isinstance(t, torch.Tensor)
                    else jnp.asarray(t, jnp.float32))


def _close(got, ref, dtype, rtol, atol):
    got, ref = _np(got), _np(ref)
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got, ref, rtol=RTOL_BF16, atol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _jax_vjp(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, q, k, v)
    return out, vjp(g.astype(out.dtype))


DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["fp32", "bf16"]


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("d", [32, 64])
def test_chunked_matches_jax_chunked(d, dtype):
    """Forward (out, lse) and backward against the JAX chunked scan and its
    custom VJP: the same algorithm, fp32 throughout. The backward gets the
    JAX forward's residuals, so that both sides start from the same out: a
    bf16 out one ulp apart would move delta = Σ dO·O and with it dQ and dK."""
    q, k, v, g = _draws((2, 128, 2, d), seed=d)
    chunk = 32
    jq, jk, jv, jg = (_jax(a, dtype) for a in (q, k, v, g))
    ref, (rdq, rdk, rdv) = _jax_vjp(lambda *a: chunked_attention(*a, chunk), jq, jk, jv, jg)
    ref_out, ref_lse = _forward(jq, jk, jv, chunk)  # the custom VJP's residuals
    tq, tk, tv, tg = (_torch(a, dtype) for a in (q, k, v, g))
    out, lse = chunked_attention_forward(tq, tk, tv, chunk)
    assert out.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (2, 2, 128)
    _close(out, ref, dtype, RTOL_FWD, ATOL_FWD)
    # lse is O(log N) and the two sides' logits differ in summation order
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-6, atol=1e-5)
    grads = chunked_attention_backward(tq, tk, tv, _torch(_np(ref_out), dtype),
                                       torch.from_numpy(np.array(ref_lse)), tg, chunk)
    for got, want, t in zip(grads, (rdq, rdk, rdv), (tq, tk, tv)):
        assert got.dtype == t.dtype and got.shape == t.shape
        _close(got, want, dtype, RTOL_GRAD, ATOL_GRAD)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("d", [32, 64])
def test_dense_matches_jax_dot_product_attention(d, dtype):
    """``dense_attention`` and its autograd against jax.nn's XLA path: the
    logits in fp32, the probabilities cast to v's dtype before P·V."""
    q, k, v, g = _draws((2, 64, 2, d), seed=10 + d)
    jq, jk, jv, jg = (_jax(a, dtype) for a in (q, k, v, g))
    ref, ref_grads = _jax_vjp(jax.nn.dot_product_attention, jq, jk, jv, jg)
    tq, tk, tv = (_torch(a, dtype).requires_grad_() for a in (q, k, v))
    out = dense_attention(tq, tk, tv)
    assert out.dtype == dtype
    out.backward(_torch(g, dtype))
    pairs = [(out, ref)] + [(t.grad, r) for t, r in zip((tq, tk, tv), ref_grads)]
    for i, (got, want) in enumerate(pairs):
        if dtype == torch.float32:
            rtol, atol = (RTOL_FWD, ATOL_FWD) if i == 0 else (RTOL_GRAD, ATOL_GRAD)
            np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)
        else:
            err = np.abs(_np(got) - _np(want)).max()
            assert err <= BF16_OF_MAX * np.abs(_np(want)).max(), (i, err)


@pytest.mark.parametrize("d", [32, 64])
def test_chunked_matches_pallas_flash_kernel(d):
    """Against the Pallas TPU flash kernel that kernel #3 replaces, in
    interpret mode (N a multiple of 128): forward and gradients."""
    from jax.experimental.pallas import tpu as pltpu

    from vqgan_tpu.ops.flash_attention import flash_attention_tpu

    q, k, v, g = _draws((1, 256, 2, d), seed=20 + d)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    with pltpu.force_tpu_interpret_mode():
        ref, ref_grads = _jax_vjp(flash_attention_tpu, jq, jk, jv, jg)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = chunked_attention_forward(tq, tk, tv, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL_FWD, atol=ATOL_FWD)
    grads = chunked_attention_backward(tq, tk, tv, out, lse, tg, 64)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL_GRAD, atol=ATOL_GRAD)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_flash_function_on_cpu_matches_autograd_through_dense(dtype):
    """``FlashAttention`` on CPU tensors (the chunked plain versions) against
    autograd through ``dense_attention`` in fp32, on strided q/k/v views of
    one (B, N, 3, H, D) tensor as the AttnBlock hands them over; no kernel
    launch is counted."""
    qkv_np = _draws((2, 96, 3, 2, 64), seed=30, n_arrays=1)[0]
    g = _draws((2, 96, 2, 64), seed=31, n_arrays=1)[0]
    runs = {}
    for name in ("flash", "dense"):
        qkv = torch.from_numpy(qkv_np).to(dtype if name == "flash" else torch.float32)
        qkv.requires_grad_()
        q, k, v = qkv.unbind(2)
        attention_cuda.fwd_launches = attention_cuda.bwd_launches = 0
        if name == "flash":
            out = memory_efficient_attention(q, k, v, 32)
        else:
            out = dense_attention(q, k, v)
        out.backward(torch.from_numpy(g).to(out.dtype))
        assert (attention_cuda.fwd_launches, attention_cuda.bwd_launches) == (0, 0)
        runs[name] = (out, qkv.grad)
    for got, want in zip(runs["flash"], runs["dense"]):
        assert got.dtype == dtype
        if dtype == torch.float32:
            np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL_GRAD, atol=ATOL_GRAD)
        else:  # the bf16 inputs' own rounding, then fp32: within the bf16 bound
            err = np.abs(_np(got) - _np(want)).max()
            assert err <= BF16_OF_MAX * np.abs(_np(want)).max()


def test_wrappers_check_their_inputs():
    q = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="impl"):
        memory_efficient_attention(q, q, q, 32, impl="cuda")
    with pytest.raises(ValueError, match="divide"):
        chunked_attention_forward(q, q, q, 48)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attention_cuda.attention_forward(q.double(), q.double(), q.double(), 32)
    with pytest.raises(ValueError, match="does not match"):
        attention_cuda.attention_forward(q, q[:, :32], q, 32)
    out, lse = attention_cuda.attention_forward(q, q, q, 32)
    with pytest.raises(ValueError, match="lse"):
        attention_cuda.attention_backward(q, q, q, out, lse.double(), q, 32)
    # the plain versions take any head_dim; the kernels' check refuses 48
    assert attention_cuda.attention_forward(*[torch.zeros(1, 8, 1, 48)] * 3, 8)[0].shape[-1] == 48
    with pytest.raises(NotImplementedError, match="32 or 64"):
        attention_cuda._kernel_strides(torch.zeros(1, 8, 1, 48))
