"""The port's GroupNorm(+swish) backward against the JAX package's, on the
CPU.

The port's ``FusedGroupNorm`` autograd Function takes the plain backward
(``ops/normalization.py::group_norm_fp32_backward``) for CPU tensors. The JAX
side is ``jax.vjp`` of the Pallas ``_fused_gn_vjp`` in interpret mode (the
kernel the CUDA backward replaces) and of the XLA ``group_norm_fp32``.
Mirrors tests/test_pallas_kernels.py: group counts, swish, bf16 I/O, odd
spatial sizes. The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.ops.normalization import group_norm_fp32 as xla_group_norm
from vqgan_tpu.ops.pallas.groupnorm import _fused_gn_vjp
from vqgan_tpu_torch.ops import groupnorm_cuda
from vqgan_tpu_torch.ops.groupnorm_cuda import (
    backward_candidates,
    fused_group_norm,
    group_norm_backward,
    group_norm_forward,
)
from vqgan_tpu_torch.ops.normalization import group_norm_fp32, group_norm_fp32_backward

# fp32: only summation orders differ. Measured against both JAX forms: dx
# 1.4e-6 on |dx| < 6; dγ, dβ (sums of 60-128 terms) 9.5e-6. The bounds leave
# about 7x and 5x.
ATOL_DX_FP32 = 1e-5
ATOL_SUMS_FP32 = 5e-5
# bf16 against the Pallas form, which keeps dŷ in fp32 too: fp32 values a few
# ulps apart can round to neighbouring bf16 values, one bf16 ulp = 2^-7 of
# the value (measured: exactly one ulp, 2.4e-4 at |dx| ~ 0.05)
RTOL_BF16 = 2.0 ** -7
# bf16 against the XLA form, which rounds dŷ to bf16 (relative 2^-9) before
# its sums and its dx sweep:
#   dx: that error times the dx coefficient, then the final rounding; two bf16
#   ulps of the largest |dx| (measured 1.56e-2 = one ulp at |dx| in [2, 4))
#   dγ, dβ: each term off by at most 2^-9 of itself, so the sum by at most
#   2^-9 of Σ|terms| (measured 2-3e-3 of max|dγ|)
XLA_BF16_DX = 2.0 ** -6
XLA_BF16_SUMS = 2.0 ** -9


def _inputs(seed, shape, c, dtype):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 1.5 + 0.3).astype(np.float32)
    scale = (1.0 + 0.5 * rng.randn(c)).astype(np.float32)
    bias = (0.5 * rng.randn(c)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    # both sides see the same (bf16-rounded) values
    x = np.array(jnp.asarray(x, dtype), np.float32)
    g = np.array(jnp.asarray(g, dtype), np.float32)
    return x, scale, bias, g


def _port_grads(x, scale, bias, g, groups, swish, dtype):
    """NHWC numpy in; (dx NHWC, dγ, dβ) numpy out, through the Function."""
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2).requires_grad_()
    wt = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = fused_group_norm(xt, wt, bt, groups, 1e-6, swish)
    gt = torch.from_numpy(g).to(dtype).permute(0, 3, 1, 2)
    dx, dw, db = torch.autograd.grad(y, (xt, wt, bt), gt)
    assert dx.dtype == dtype and dx.is_contiguous(memory_format=torch.channels_last)
    assert dw.dtype == db.dtype == torch.float32
    return dx.permute(0, 2, 3, 1).float().numpy(), dw.numpy(), db.numpy()


def _jax_grads(fn, x, scale, bias, g, dtype):
    args = (jnp.asarray(x, dtype), jnp.asarray(scale), jnp.asarray(bias))
    _, vjp = jax.vjp(fn, *args)
    return [np.asarray(t, np.float32) for t in vjp(jnp.asarray(g, dtype))]


def _pallas(groups, swish):
    return lambda x, w, b: _fused_gn_vjp(x, w, b, groups, 1e-6, swish, True)


def _xla(groups, swish):
    return lambda x, w, b: xla_group_norm(x, w, b, groups, 1e-6, swish)


def _sum_magnitudes(x, g, groups):
    """Per-channel Σ|terms| of dβ and dγ for g (|dŷ| <= 1.1·|g| with swish)."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, groups, c // groups)
    mean = xg.mean(axis=(1, 3))
    rstd = 1.0 / np.sqrt(np.square(xg).mean(axis=(1, 3)) - mean ** 2 + 1e-6)
    m_c = np.repeat(mean, c // groups, axis=-1)[:, None, None, :]
    r_c = np.repeat(rstd, c // groups, axis=-1)[:, None, None, :]
    ga = 1.1 * np.abs(g)
    return (ga * np.abs(x - m_c) * r_c).sum(axis=(0, 1, 2)), ga.sum(axis=(0, 1, 2))


def _check_fp32(got, ref):
    np.testing.assert_allclose(got[0], ref[0], atol=ATOL_DX_FP32, rtol=0)
    np.testing.assert_allclose(got[1], ref[1], atol=ATOL_SUMS_FP32, rtol=0)
    np.testing.assert_allclose(got[2], ref[2], atol=ATOL_SUMS_FP32, rtol=0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("swish", [False, True], ids=["plain", "swish"])
@pytest.mark.parametrize("c,groups", [(64, 32), (256, 32), (128, 16)])
def test_backward_matches_pallas_and_xla(c, groups, swish, dtype):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x, scale, bias, g = _inputs(0, (2, 8, 8, c), c, jdt)
    got = _port_grads(x, scale, bias, g, groups, swish, tdt)
    pallas = _jax_grads(_pallas(groups, swish), x, scale, bias, g, jdt)
    xla = _jax_grads(_xla(groups, swish), x, scale, bias, g, jdt)
    if dtype == "fp32":
        _check_fp32(got, pallas)
        _check_fp32(got, xla)
        return
    np.testing.assert_allclose(got[0], pallas[0], atol=1e-6, rtol=RTOL_BF16)
    np.testing.assert_allclose(got[1], pallas[1], atol=ATOL_SUMS_FP32, rtol=0)
    np.testing.assert_allclose(got[2], pallas[2], atol=ATOL_SUMS_FP32, rtol=0)
    np.testing.assert_allclose(got[0], xla[0], rtol=0,
                               atol=XLA_BF16_DX * np.abs(xla[0]).max())
    t_gamma, t_beta = _sum_magnitudes(x, g, groups)
    assert (np.abs(got[1] - xla[1]) <= XLA_BF16_SUMS * t_gamma + 1e-5).all()
    assert (np.abs(got[2] - xla[2]) <= XLA_BF16_SUMS * t_beta + 1e-5).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_backward_odd_spatial(dtype):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x, scale, bias, g = _inputs(3, (1, 6, 10, 64), 64, jdt)
    got = _port_grads(x, scale, bias, g, 32, True, tdt)
    ref = _jax_grads(_pallas(32, True), x, scale, bias, g, jdt)
    if dtype == "fp32":
        _check_fp32(got, ref)
    else:
        np.testing.assert_allclose(got[0], ref[0], atol=1e-6, rtol=RTOL_BF16)
        np.testing.assert_allclose(got[1:], ref[1:], atol=ATOL_SUMS_FP32, rtol=0)


def test_non_channels_last_gradient():
    """A gradient in another layout (a flip or a permute downstream) gives the
    same result as the channels_last one."""
    x, scale, bias, g = _inputs(1, (2, 4, 6, 64), 64, jnp.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    y = fused_group_norm(xt, w, b, 32, 1e-6, True)
    g_cl = torch.from_numpy(g).permute(0, 3, 1, 2)
    g_nchw = g_cl.contiguous()
    assert not g_nchw.is_contiguous(memory_format=torch.channels_last)
    (ref,) = torch.autograd.grad(y, xt, g_cl, retain_graph=True)
    (got,) = torch.autograd.grad(y, xt, g_nchw, retain_graph=True)
    assert torch.equal(got, ref)
    # a flip downstream hands the Function a flipped-stride gradient
    wts = torch.from_numpy(g).permute(0, 3, 1, 2).flip(3)
    (got,) = torch.autograd.grad((y.flip(3) * wts).sum(), xt)
    assert torch.equal(got, ref)


def test_cpu_path_counts_no_launch():
    groupnorm_cuda.launches = groupnorm_cuda.bwd_launches = 0
    x, scale, bias, g = _inputs(4, (2, 4, 4, 64), 64, jnp.float32)
    _port_grads(x, scale, bias, g, 32, True, torch.float32)
    assert (groupnorm_cuda.launches, groupnorm_cuda.bwd_launches) == (0, 0)


@pytest.mark.parametrize("swish", [False, True], ids=["plain", "swish"])
def test_plain_backward_equals_autograd_of_plain_forward(swish):
    """fp32: the closed-form backward against torch autograd through the
    plain forward's ops; only rounding orders differ (measured 1e-6 on
    |dx| < 5 against float64 autograd)."""
    x, scale, bias, g = _inputs(5, (2, 8, 8, 128), 128, jnp.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    wt = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    gt = torch.from_numpy(g).permute(0, 3, 1, 2)
    y = group_norm_fp32(xt, wt, bt, 16, 1e-6, swish)
    ref = torch.autograd.grad(y, (xt, wt, bt), gt)
    xd, wd, bd = xt.detach(), wt.detach(), bt.detach()
    _, stats = group_norm_forward(xd, wd, bd, 16, 1e-6, swish)
    got = group_norm_fp32_backward(xd, gt, stats[:, 0], stats[:, 1], wd, bd, 16, swish)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5)


def test_saves_no_full_size_fp32_tensor():
    """The Function keeps x in its own dtype, the (B, 2, G) stats and γ, β:
    the JAX package's residual contract."""
    x, scale, bias, _ = _inputs(6, (2, 8, 8, 64), 64, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2).requires_grad_()
    y = fused_group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias), 32,
                         1e-6, True)
    saved = y.grad_fn.saved_tensors
    assert saved[0] is not None and saved[0].dtype == torch.bfloat16
    assert saved[0].data_ptr() == xt.data_ptr()
    full = xt.numel()
    assert all(t.numel() < full for t in saved[1:])
    assert tuple(saved[1].shape) == (2, 2, 32) and saved[1].dtype == torch.float32


def test_inference_mode_forward_records_nothing():
    x, scale, bias, _ = _inputs(7, (1, 4, 4, 64), 64, jnp.float32)
    with torch.inference_mode():
        y = fused_group_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                             torch.from_numpy(scale), torch.from_numpy(bias))
    assert y.grad_fn is None


def test_backward_rejects_what_the_kernel_does_not_take():
    x, scale, bias, g = _inputs(8, (2, 4, 4, 64), 64, jnp.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    _, stats = group_norm_forward(xt, w, b)
    gt = torch.from_numpy(g).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="channels_last"):
        group_norm_backward(xt, gt.contiguous(), stats, w, b)
    with pytest.raises(ValueError, match="does not match"):
        group_norm_backward(xt, gt.to(torch.bfloat16), stats, w, b)
    with pytest.raises(ValueError, match="stats"):
        group_norm_backward(xt, gt, stats[:, :, :16], w, b)


def _emulate_kernel(x, g, mean, rstd, weight, bias, groups, swish, plan):
    """``csrc/groupnorm.cu``'s ``gn_bwd_kernel`` in its order, fp32 torch on
    the CPU: per unit (a sample, a slice of ``plan.width`` channels), each
    block of the team (a range of rows times a column block) sums dŷ and
    dŷ·x over its rows per channel, then γ·S0 and γ·S1 per group over its
    channels in channel order (0 for a group it does not touch); the team's
    group sums in block order give m1, m2 and the coefficients (ca, cb, cc);
    dx = (dŷ·ca + x·cb) + cc. dγ, dβ: each channel's sums over the row
    blocks in order, then the batch in order. x, g: (B, C, H, W); returns
    (dx in x's dtype, dγ, dβ)."""
    b_, c = x.shape[:2]
    cg = c // groups
    xf = x.float().movedim(1, -1).reshape(b_, -1, c)
    gf = g.float().movedim(1, -1).reshape(b_, -1, c)
    s, w, n = xf.shape[1], plan.width, xf.shape[1] * cg
    gw, bwid, rpb = w // cg, plan.block_channels, plan.rows_per_block
    dx = torch.empty_like(xf)
    per_batch = torch.empty(b_, 2, c)
    for u in range(plan.units):
        b, sl = divmod(u, c // w)
        ch = torch.arange(sl * w, (sl + 1) * w)
        grp = ch // cg
        xs, gs = xf[b][:, ch], gf[b][:, ch]
        mu, r, gam = mean[b, grp], rstd[b, grp], weight[ch]
        if swish:
            a = r * gam
            y = xs * a + (bias[ch] - mu * a)
            sig = torch.sigmoid(y)
            dy = gs * sig * (1.0 + y * (1.0 - sig))
        else:
            dy = gs
        chan, tot = [], None
        for j in range(plan.team_blocks):
            rb, cb = divmod(j, plan.col_blocks)
            rows = slice(rb * rpb, min(s, (rb + 1) * rpb))
            lo, hi = cb * bwid, min(w, (cb + 1) * bwid)
            d, xv = dy[rows, lo:hi], xs[rows, lo:hi]
            sums = torch.stack([d.sum(0), (d * xv).sum(0)])  # (2, block channels)
            chan.append(sums)
            prods = gam[lo:hi] * sums
            part = torch.zeros(2, gw)
            for q in range(gw):
                for k in range(max(q * cg, lo), min((q + 1) * cg, hi)):
                    part[:, q] = part[:, q] + prods[:, k - lo]
            tot = part if tot is None else tot + part
        q = torch.arange(w) // cg
        m1 = tot[0][q] / n
        m2 = r * (tot[1][q] / n) - mu * r * (tot[0][q] / n)
        ca, cb_, cc = r * gam, -r * r * m2, mu * r * r * m2 - r * m1
        dx[b][:, ch] = (dy * ca + xs * cb_) + cc
        s01 = torch.empty(2, w)
        for cb in range(plan.col_blocks):
            lo, hi = cb * bwid, min(w, (cb + 1) * bwid)
            part = chan[cb]
            for rb in range(1, plan.team_blocks // plan.col_blocks):
                part = part + chan[rb * plan.col_blocks + cb]
            s01[:, lo:hi] = part
        per_batch[b, 0, ch] = r * (s01[1] - mu * s01[0])
        per_batch[b, 1, ch] = s01[0]
    dgamma, dbeta = per_batch[0, 0], per_batch[0, 1]
    for b in range(1, b_):
        dgamma, dbeta = dgamma + per_batch[b, 0], dbeta + per_batch[b, 1]
    dx = dx.to(x.dtype).reshape((b_,) + tuple(x.shape[2:]) + (c,)).movedim(-1, 1)
    return dx, dgamma, dbeta


def _many_block_plan(b, s, c, groups, element_size):
    """A valid plan with several units a team, several blocks a team and
    ragged rows: the kernel's order at its most general."""
    cands = [p for p, _ in backward_candidates(b, s, c, groups, element_size, 4,
                                               blocks_per_sm=2)
             if p.teams >= 2 and p.units > p.teams and p.team_blocks >= 3
             and p.team_blocks * p.rows_per_block > s]
    return max(cands, key=lambda p: (p.team_blocks, -p.width))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("swish", [False, True], ids=["plain", "swish"])
@pytest.mark.parametrize("shape,groups", [((2, 7, 9, 64), 32), ((3, 5, 13, 128), 16),
                                          ((2, 7, 9, 96), 32), ((3, 3, 7, 328), 1)],
                         ids=["C64-G32", "C128-G16", "C96-G32", "C328-G1"])
def test_kernel_order_matches_plain_and_pallas(shape, groups, swish, dtype):
    """The CUDA backward's summation order (emulated in torch with a plan of
    several units, teams of several blocks and ragged rows; at C = 96 a
    slice of 3 or 6 packs, no power of two; at 328 channels in one group,
    column blocks) against the plain backward and the Pallas backward in
    interpret mode, at the file's tolerances."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    c = shape[-1]
    x, scale, bias, g = _inputs(9, shape, c, jdt)
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    gt = torch.from_numpy(g).to(tdt).permute(0, 3, 1, 2)
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    _, stats = group_norm_forward(xt, w, b, groups, 1e-6, swish)
    plan = _many_block_plan(shape[0], shape[1] * shape[2], c, groups, xt.element_size())
    got = _emulate_kernel(xt, gt, stats[:, 0], stats[:, 1], w, b, groups, swish, plan)
    got = [got[0].permute(0, 2, 3, 1).float().numpy(), got[1].numpy(), got[2].numpy()]
    ref = group_norm_fp32_backward(xt, gt, stats[:, 0], stats[:, 1], w, b, groups, swish)
    ref = [ref[0].permute(0, 2, 3, 1).float().numpy(), ref[1].numpy(), ref[2].numpy()]
    pallas = _jax_grads(_pallas(groups, swish), x, scale, bias, g, jdt)
    for want in (ref, pallas):
        if dtype == "fp32":
            _check_fp32(got, want)
        else:
            np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=RTOL_BF16)
            np.testing.assert_allclose(got[1], want[1], atol=ATOL_SUMS_FP32, rtol=0)
            np.testing.assert_allclose(got[2], want[2], atol=ATOL_SUMS_FP32, rtol=0)
