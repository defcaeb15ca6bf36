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
@pytest.mark.parametrize("d", [16, 32, 64, 128])
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
    with pytest.raises(NotImplementedError, match="16, 32, 64, 128"):
        attention_cuda._kernel_strides(torch.zeros(1, 8, 1, 48))
    for d in (16, 32, 64, 128):  # the head_dims the kernels take
        attention_cuda._kernel_strides(torch.zeros(1, 8, 1, d))


# kernel #3's tensor-core route (csrc/attention.cu, bf16), emulated in torch in
# its order: blocks of TC_BLOCK_ROWS rows, tiles of TC_STEP_ROWS[d] streamed,
# ragged tiles zero-filled and masked to -inf, the online softmax per tile on
# exp2 with scale·log2(e) folded in, P and dS rounded to bf16 where the kernel
# rounds them. Against the plain versions and the JAX scan: each output within
# rounding_bounds (fp32 orders at ATTN_RTOL of Σ|terms|, 2^-9 more for the
# bf16 P and dS) plus one bf16 ulp of the value; lse within LSE_ATOL
ATTN_RTOL = 3e-5
LSE_ATOL = 1e-4
LOG2E = 1.4426950408889634


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tiles(t, rows):
    """(B, H, N, D) → [(row0, the rows [row0, row0 + rows) zero-padded to
    ``rows``)]: what the kernel's cp.async ring holds, src-size 0 past N."""
    n = t.shape[2]
    padded = torch.nn.functional.pad(t, (0, 0, 0, -n % rows))
    return [(r0, padded[:, :, r0:r0 + rows]) for r0 in range(0, n, rows)]


def _mask_past(s, c0, n):
    """Columns c0 + j at or past n → -inf (the kernel's mask_past)."""
    cols = c0 + torch.arange(s.shape[-1])
    return s.masked_fill(cols >= n, float("-inf"))


def tc_forward_emulated(q, k, v):
    """(out, lse) in the tensor-core forward's order."""
    b, n, h, d = q.shape
    scale = d ** -0.5
    sl = scale * LOG2E
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    out, lse = torch.empty(b, h, n, d), torch.empty(b, h, n)
    for q0, qb in _tiles(qf, attention_cuda.TC_BLOCK_ROWS):
        m = torch.full(qb.shape[:-1], float("-inf"))
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for (k0, kt), (_, vt) in zip(_tiles(kf, attention_cuda.TC_STEP_ROWS[d]),
                                     _tiles(vf, attention_cuda.TC_STEP_ROWS[d])):
            s = _mask_past(qb @ kt.transpose(-1, -2), k0, n)
            mx = torch.maximum(m, s.amax(-1))
            corr = torch.exp2((m - mx) * sl)
            p = torch.exp2(s * sl - (mx * sl)[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _bf16(p) @ vt
            m = mx
        rows = slice(q0, min(q0 + attention_cuda.TC_BLOCK_ROWS, n))
        valid = rows.stop - q0
        out[:, :, rows] = (acc / l[..., None])[:, :, :valid]
        lse[:, :, rows] = (m * scale + torch.log(l))[:, :, :valid]
    return out.transpose(1, 2).to(q.dtype), lse


def tc_backward_emulated(q, k, v, out, lse, g):
    """(dq, dk, dv) in the tensor-core backward's order: the dK/dV loop over
    query tiles per key block, the dQ loop over key tiles per query block."""
    b, n, h, d = q.shape
    scale = d ** -0.5
    sl = scale * LOG2E
    qf, kf, vf, gf = (t.float().transpose(1, 2) for t in (q, k, v, g))
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2)
    stats = torch.stack([lse, delta], -1)  # (B, H, N, 2): staged beside Q, dO
    blk, step = attention_cuda.TC_BLOCK_ROWS, attention_cuda.TC_STEP_ROWS[d]
    dq, dk, dv = (torch.empty(b, h, n, d) for _ in range(3))
    for (k0, kb), (_, vb) in zip(_tiles(kf, blk), _tiles(vf, blk)):
        dk_acc, dv_acc = torch.zeros_like(kb), torch.zeros_like(kb)
        for (q0, qt), (_, gt), (_, st) in zip(_tiles(qf, step), _tiles(gf, step),
                                               _tiles(stats, step)):
            pt = _mask_past(kb @ qt.transpose(-1, -2), q0, n)
            pt = torch.exp2(pt * sl - (st[..., 0] * LOG2E)[:, :, None])
            dv_acc += _bf16(pt) @ gt
            dpt = vb @ gt.transpose(-1, -2)
            dst = pt * (dpt - st[:, :, None, :, 1]) * scale
            dk_acc += _bf16(dst) @ qt
        rows = slice(k0, min(k0 + blk, n))
        dk[:, :, rows] = dk_acc[:, :, :rows.stop - k0]
        dv[:, :, rows] = dv_acc[:, :, :rows.stop - k0]
    for (q0, qb), (_, gb), (_, sb) in zip(_tiles(qf, blk), _tiles(gf, blk), _tiles(stats, blk)):
        dq_acc = torch.zeros_like(qb)
        for (k0, kt), (_, vt) in zip(_tiles(kf, step), _tiles(vf, step)):
            s = _mask_past(qb @ kt.transpose(-1, -2), k0, n)
            p = torch.exp2(s * sl - (sb[..., 0] * LOG2E)[..., None])
            dp = gb @ vt.transpose(-1, -2)
            ds = p * (dp - sb[..., 1, None]) * scale
            dq_acc += _bf16(ds) @ kt
        rows = slice(q0, min(q0 + blk, n))
        dq[:, :, rows] = dq_acc[:, :, :rows.stop - q0]
    return tuple(t.transpose(1, 2).to(x.dtype) for t, x in zip((dq, dk, dv), (q, k, v)))


def _within_bounds(got: dict, want: dict, bounds: dict) -> dict:
    """{name: the largest |got − want| / (bound + one bf16 ulp of want)}."""
    used = {}
    for name, g_ in got.items():
        w = want[name].float()
        tol = bounds[name] + 1e-7 + 2.0 ** -7 * w.abs()
        used[name] = float(((g_.float() - w).abs() / tol).max())
    return used


@pytest.mark.parametrize("n", [1, 65, 333])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_tensor_core_route_order_matches_plain_and_jax(d, n):
    """The emulated tensor-core route, forward and backward, bf16 inputs as
    views of one (B, N, 3, H, D) tensor, against the plain chunked versions
    and the JAX chunked scan and its custom VJP, within the bounds that the
    card holds the kernel to. The backwards all start from the plain
    forward's out and lse (the JAX one from its own, as its VJP does)."""
    from vqgan_tpu.ops.chunked_attention import _bwd_rule

    from vqgan_tpu_torch.ops.attention import rounding_bounds

    qkv_np = _draws((2, n, 3, 2, d), seed=40 + n + d, n_arrays=1)[0]
    g_np = _draws((2, n, 2, d), seed=41 + n + d, n_arrays=1)[0]
    qkv = _torch(qkv_np, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    g = _torch(g_np, torch.bfloat16)
    out, lse = tc_forward_emulated(q, k, v)
    ref_out, ref_lse = chunked_attention_forward(q, k, v, n)
    grads = dict(zip(("dq", "dk", "dv"), tc_backward_emulated(q, k, v, ref_out, ref_lse, g)))
    ref_grads = dict(zip(("dq", "dk", "dv"),
                         chunked_attention_backward(q, k, v, ref_out, ref_lse, g, n)))
    delta = (g.float() * ref_out.float()).sum(-1).transpose(1, 2)
    bounds = rounding_bounds(q, k, v, ref_lse, ATTN_RTOL, True, g, delta)
    assert out.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16 for t in grads.values())
    used = _within_bounds({"out": out, **grads}, {"out": ref_out, **ref_grads}, bounds)
    used["lse"] = float((lse - ref_lse).abs().max()) / LSE_ATOL
    assert all(u <= 1.0 for u in used.values()), ("plain", used)

    jq, jk, jv = (_jax(a, torch.bfloat16) for a in np.moveaxis(qkv_np, 2, 0))
    j_out, j_lse = _forward(jq, jk, jv, n)
    t_out = _torch(_np(j_out), torch.bfloat16)
    t_lse = torch.from_numpy(np.array(j_lse))
    j_grads = _bwd_rule(n, (jq, jk, jv, j_out, j_lse), _jax(g_np, torch.bfloat16))
    grads = dict(zip(("dq", "dk", "dv"), tc_backward_emulated(q, k, v, t_out, t_lse, g)))
    delta = (g.float() * t_out.float()).sum(-1).transpose(1, 2)
    bounds = rounding_bounds(q, k, v, t_lse, ATTN_RTOL, True, g, delta)
    want = {"out": t_out, **{key: torch.from_numpy(_np(a)) for key, a in
                              zip(("dq", "dk", "dv"), j_grads)}}
    used = _within_bounds({"out": out, **grads}, want, bounds)
    used["lse"] = float((lse - t_lse).abs().max()) / LSE_ATOL
    assert all(u <= 1.0 for u in used.values()), ("jax", used)


def test_route_and_stride_rule():
    """The dtype alone picks the route; each route's stride rule is checked
    on CPU tensors (a pure function: no card)."""
    assert attention_cuda.route(torch.bfloat16) == "tc"
    assert attention_cuda.route(torch.float32) == "fma"
    # the AttnBlock's views of a channels-last qkv: token stride 3C, C = H·D
    for dtype in (torch.bfloat16, torch.float32):
        for h, d in ((1, 32), (8, 32), (4, 64)):
            q, k, v = torch.zeros(2, 16, 3, h, d, dtype=dtype).unbind(2)
            strides = list(attention_cuda._kernel_strides(q, k, v))
            assert strides == [16 * 3 * h * d, 3 * h * d, d] * 3
    # head stride 68: a multiple of 4, not of 8
    for dtype, raises in ((torch.bfloat16, True), (torch.float32, False)):
        view = torch.zeros(2, 16, 2, 68, dtype=dtype)[..., :64]
        if raises:
            with pytest.raises(ValueError, match="tc route .* multiples of 8"):
                attention_cuda._kernel_strides(view)
        else:
            attention_cuda._kernel_strides(view)
    # 8 bytes off a 16-byte boundary: bf16 strides whole, the address not
    flat = torch.zeros(2 * 16 * 64 + 8, dtype=torch.bfloat16)
    base = flat[(-flat.data_ptr() // 2) % 8:]  # 16-byte aligned
    with pytest.raises(ValueError, match="16-byte"):
        attention_cuda._kernel_strides(base[4:4 + 2 * 16 * 64].view(2, 16, 1, 64))
    attention_cuda._kernel_strides(base[8:8 + 2 * 16 * 64].view(2, 16, 1, 64))
    with pytest.raises(ValueError, match="fma route .* multiples of 4"):
        attention_cuda._kernel_strides(torch.zeros(2, 16, 2, 65)[..., :64])
