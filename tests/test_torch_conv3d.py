"""Kernel #6's plain version and its autograd Function against the JAX
package's ``conv3d_ttap`` (the Pallas fused-tap Conv3d in interpret mode)
and its custom VJP, on the CPU; and the wrapper's launch plan, weight
packing and checks, which the card's kernel reads.

Layouts: the JAX side takes NDHWC clips and a DHWIO kernel; the port takes
(B, C, T, H, W) channels_last_3d and an OIDHW weight. The same numpy arrays
feed both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.ops.pallas.conv3d import _conv3d_pallas, conv3d_ttap
from vqgan_tpu_torch.ops import conv3d_cuda
from vqgan_tpu_torch.ops.conv3d import (
    bound_share,
    conv3d_plain,
    flipped_weight,
    rounding_bound,
)
from vqgan_tpu_torch.ops.conv3d_cuda import (
    Conv3dTTap,
    conv3d_forward,
    conv3d_input_grad,
    launch_plan,
    pack_weight,
)

# fp32: both sum the 27·Ci products in fp32 in other orders
# (tests/test_pallas_conv3d.py's bound against the direct XLA conv)
ATOL_FP32 = 2e-5
# bf16 inputs, fp32 sums on both sides, one rounding of the output to bf16
# each; test_pallas_conv3d.py's bound
ATOL_BF16 = 3e-2


def _data(b=2, t=5, h=8, w=8, ci=16, co=24, seed=0):
    """x NDHWC and the kernel DHWIO (scaled by 0.1, as test_pallas_conv3d.py)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, h, w, ci).astype(np.float32)
    k = (0.1 * rng.randn(3, 3, 3, ci, co)).astype(np.float32)
    return x, k


def _port(x, k, dtype=torch.float32):
    """Torch views of the numpy data: (B, Ci, T, H, W) channels_last_3d and
    the OIDHW weight."""
    xt = torch.from_numpy(x).to(dtype).permute(0, 4, 1, 2, 3)
    wt = torch.from_numpy(k).to(dtype).permute(4, 3, 0, 1, 2).contiguous()
    return xt, wt


def _ndhwc(t):
    return t.detach().float().permute(0, 2, 3, 4, 1).numpy()


@pytest.mark.parametrize("shape", [
    (2, 5, 8, 8, 16, 24),   # test_pallas_conv3d.py's default
    (1, 1, 8, 8, 8, 8),     # T = 1: every frame misses two taps
    (1, 2, 8, 8, 8, 8),
    (1, 3, 8, 8, 8, 8),
    (1, 3, 8, 8, 3, 8),     # the 3-channel conv_in
    (1, 3, 8, 8, 64, 64),   # lane-aligned Ci: the fat-K branch on the JAX side
], ids=["default", "T1", "T2", "T3", "Ci3", "Ci64"])
def test_plain_matches_conv3d_ttap_fp32(shape):
    b, t, h, w, ci, co = shape
    x, k = _data(b, t, h, w, ci, co, seed=t + ci)
    ref = np.asarray(conv3d_ttap(jnp.asarray(x), jnp.asarray(k), True))
    got = conv3d_forward(*_port(x, k))
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_allclose(_ndhwc(got), ref, atol=ATOL_FP32)


def test_plain_matches_conv3d_ttap_bf16():
    x, k = _data(seed=3)
    ref = conv3d_ttap(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), True)
    got = conv3d_forward(*_port(x, k, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_ndhwc(got), np.asarray(ref.astype(jnp.float32)), atol=ATOL_BF16)


@pytest.mark.parametrize("bh", [8, 16])
def test_plain_matches_the_multiband_pallas_kernel(bh):
    """The JAX kernel's forced small bands (halo rows through the narrow
    block specs) give the same function."""
    x, k = _data(1, 3, 32, 8, 8, 8, seed=bh)
    ref = np.asarray(_conv3d_pallas(jnp.asarray(x), jnp.asarray(k), True, bh=bh))
    np.testing.assert_allclose(_ndhwc(conv3d_forward(*_port(x, k))), ref, atol=ATOL_FP32)


def test_gradients_match_the_custom_vjp():
    """dx (the flipped, transposed conv) and dk (the weight gradient) through
    ``Conv3dTTap`` against ``jax.grad`` of ``conv3d_ttap``'s custom VJP."""
    x, k = _data(1, 4, 8, 8, 8, 16, seed=7)
    dy = np.random.RandomState(8).randn(1, 4, 8, 8, 16).astype(np.float32)

    def loss(x_, k_):
        return jnp.vdot(conv3d_ttap(x_, k_, True), jnp.asarray(dy))

    gx_ref, gk_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt, wt = _port(x, k)
    xt = xt.detach().requires_grad_()
    wt = wt.detach().requires_grad_()
    y = Conv3dTTap.apply(xt, wt)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(dy).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(_ndhwc(xt.grad), np.asarray(gx_ref), atol=ATOL_FP32)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 4, 1, 0).numpy(), np.asarray(gk_ref),
                               atol=ATOL_FP32)


def test_input_grad_is_the_flipped_transposed_conv():
    x, k = _data(1, 3, 6, 5, 8, 12, seed=9)
    dy = torch.randn(1, 12, 3, 6, 5, generator=torch.Generator().manual_seed(0))
    dy = dy.contiguous(memory_format=torch.channels_last_3d)
    _, wt = _port(x, k)
    dx = conv3d_input_grad(dy, wt)
    torch.testing.assert_close(dx, conv3d_plain(dy, flipped_weight(wt)), rtol=0, atol=0)
    assert flipped_weight(wt).shape == (8, 12, 3, 3, 3)
    xt = _port(x, k)[0].detach().requires_grad_()
    torch.nn.functional.conv3d(xt, wt, padding=1).backward(dy)
    torch.testing.assert_close(dx, xt.grad, atol=ATOL_FP32, rtol=0)


def test_cpu_calls_launch_nothing():
    conv3d_cuda.launches = conv3d_cuda.bwd_launches = 0
    x, k = _data(1, 2, 4, 4, 8, 8)
    xt, wt = _port(x, k)
    xt.requires_grad_()
    Conv3dTTap.apply(xt, wt).sum().backward()
    assert (conv3d_cuda.launches, conv3d_cuda.bwd_launches) == (0, 0)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    x, k = _data(1, 2, 4, 4, 8, 8)
    xt, wt = _port(x, k)
    with pytest.raises(ValueError, match="channels_last_3d"):
        conv3d_forward(xt.contiguous(), wt)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv3d_forward(xt.half(), wt.half())
    with pytest.raises(ValueError, match="not \\(Co, 8, 3, 3, 3\\)"):
        conv3d_forward(xt, wt[:, :4])
    with pytest.raises(ValueError, match="does not match"):
        conv3d_forward(xt, wt.bfloat16())


@pytest.mark.parametrize("m,ci,co,want", [
    # 16f/128px at batch 2: the 64-channel bulk fills the card with tiles
    (2 * 16 * 128 * 128, 64, 64, dict(block_n=64, n_chunks=108, splits=1)),
    # the decoder's conv_out: 16-channel tiles (of 512 voxels)
    (2 * 16 * 128 * 128, 64, 3, dict(block_n=16, n_pad=16, splits=1)),
    # the encoder's conv_in: Ci = 3 packs 81 rows of K into 6 chunks
    (2 * 16 * 128 * 128, 3, 64, dict(n_chunks=6, splits=1)),
    # the 2x16x16 mid block: 32 tiles on 132 SMs, K split 9 ways
    (2 * 2 * 16 * 16, 256, 256, dict(n_chunks=432, splits=9, chunks_per_split=48)),
    # the decoder's conv_in: at least 4 chunks a split
    (2 * 2 * 16 * 16, 16, 256, dict(n_chunks=27, splits=6, chunks_per_split=5)),
])
def test_launch_plan(m, ci, co, want):
    plan = launch_plan(m, ci, co, 132)
    for key, value in want.items():
        assert getattr(plan, key) == value, (key, plan)
    assert plan.n_pad % plan.block_n == 0 and plan.n_pad >= co
    assert plan.splits * plan.chunks_per_split >= plan.n_chunks
    assert (plan.splits - 1) * plan.chunks_per_split < plan.n_chunks  # no empty split


@pytest.mark.parametrize("ci,co", [(3, 8), (16, 20)])
def test_pack_weight_rows(ci, co):
    w = torch.randn(co, ci, 3, 3, 3, generator=torch.Generator().manual_seed(ci))
    plan = launch_plan(100, ci, co, 132)
    packed = pack_weight(w, plan)
    assert packed.shape == (plan.n_chunks * 16, plan.n_pad)
    for dt, dh, dw, c, o in [(0, 0, 0, 0, 0), (2, 1, 0, ci - 1, co - 1), (1, 2, 2, 1, 3)]:
        tap = (dt * 3 + dh) * 3 + dw
        assert packed[tap * ci + c, o] == w[o, c, dt, dh, dw]
    assert not packed[27 * ci:].any() and not packed[:, co:].any()


def test_rounding_bound_covers_an_fp64_reference():
    """The stated bound holds for the plain fp32 conv against fp64, with
    terms of one sign (the worst case for the bound's reasoning)."""
    x, k = _data(1, 3, 8, 8, 64, 16, seed=4)
    xt, wt = _port(np.abs(x), np.abs(k))
    ref = torch.nn.functional.conv3d(xt.double(), wt.double(), padding=1)
    err = (conv3d_plain(xt, wt).double() - ref).abs()
    assert bool((err <= rounding_bound(xt, wt).double()).all())


def test_bound_share_allows_one_bf16_ulp_and_no_more():
    """The card checks' share of the stated bound: 0 for equal outputs, at
    most 1 for a bf16 output one ulp from the reference, above 1 for an
    output off by more than the bound."""
    x, k = _data(1, 2, 6, 6, 16, 8, seed=5)
    xt, wt = _port(x, k)
    want = conv3d_plain(xt.bfloat16(), wt.bfloat16())
    assert bound_share(want, want, xt, wt) == 0.0
    one_ulp = (want.view(torch.int16) + 1).view(torch.bfloat16)  # one ulp farther from 0
    assert 0.0 < bound_share(one_ulp, want, xt, wt) <= 1.0
    y = conv3d_plain(xt, wt)
    off = y + 10 * rounding_bound(xt, wt) + 1e-6
    assert bound_share(off, y, xt, wt) > 1.0
