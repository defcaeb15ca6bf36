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
    """The fp32 route's plan (CUDA-core FMA kernel, 16-row chunks)."""
    plan = launch_plan(m, ci, co, 132, torch.float32)
    assert (plan.route, plan.tile, plan.block_k) == ("fma", -1, 16)
    for key, value in want.items():
        assert getattr(plan, key) == value, (key, plan)
    assert plan.n_pad % plan.block_n == 0 and plan.n_pad >= co
    assert plan.splits * plan.chunks_per_split >= plan.n_chunks
    assert (plan.splits - 1) * plan.chunks_per_split < plan.n_chunks  # no empty split


@pytest.mark.parametrize("ci,co", [(3, 8), (16, 20)])
def test_pack_weight_rows(ci, co):
    w = torch.randn(co, ci, 3, 3, 3, generator=torch.Generator().manual_seed(ci))
    plan = launch_plan(100, ci, co, 132, torch.float32)
    packed = pack_weight(w, plan)
    assert packed.shape == (plan.n_chunks * 16, plan.n_pad)
    for dt, dh, dw, c, o in [(0, 0, 0, 0, 0), (2, 1, 0, ci - 1, co - 1), (1, 2, 2, 1, 3)]:
        tap = (dt * 3 + dh) * 3 + dw
        assert packed[tap * ci + c, o] == w[o, c, dt, dh, dw]
    assert not packed[27 * ci:].any() and not packed[:, co:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_pack_weight_is_contiguous_for_either_weight_layout(dtype):
    """The kernels read the packed rows' memory: an OIDHW weight and the
    same weight in channels_last_3d (as the TVAE holds its 5-D weights)
    give the same contiguous rows, where no padding is needed too."""
    w = torch.randn(64, 64, 3, 3, 3, generator=torch.Generator().manual_seed(2)).to(dtype)
    plan = launch_plan(4096, 64, 64, 132, dtype)
    want = pack_weight(w, plan)
    got = pack_weight(w.contiguous(memory_format=torch.channels_last_3d), plan)
    assert want.is_contiguous() and got.is_contiguous()
    assert torch.equal(got, want)


# every Ci and Co of kernel #6's calls on the paths: the two clips' forward
# and dx (Ci and Co swapped) and the 3D training config's (z = 8)
PATH_CHANNELS = (3, 8, 16, 32, 64, 128, 256)
PATH_VOXELS = (2 * 2 * 16 * 16, 2 * 4 * 32 * 32, 2 * 8 * 64 * 64, 2 * 16 * 128 * 128,
               12 * 64 * 64, 24 * 128 * 128, 48 * 256 * 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("ci", PATH_CHANNELS)
def test_launch_plan_route_by_dtype(ci, dtype):
    """bf16 takes the tensor-core route, fp32 the FMA route, at every Ci/Co
    of the paths; each plan's tile covers Co, its splits cover K with none
    empty, and the tensor-core plan's tile is one the kernel has."""
    for co in PATH_CHANNELS:
        for m in PATH_VOXELS:
            plan = launch_plan(m, ci, co, 132, dtype)
            assert plan.route == ("tc" if dtype == torch.bfloat16 else "fma")
            assert plan.n_pad % plan.block_n == 0 and co <= plan.n_pad < co + plan.block_n
            assert plan.splits * plan.chunks_per_split >= plan.n_chunks
            assert (plan.splits - 1) * plan.chunks_per_split < plan.n_chunks
            assert plan.n_chunks * plan.block_k >= 27 * ci > (plan.n_chunks - 1) * plan.block_k
            if plan.route == "tc":
                assert (plan.block_m, plan.block_n) == conv3d_cuda.TC_TILES[plan.tile]
                assert plan.block_k == 32
                assert (plan.splits == 1
                        or plan.chunks_per_split >= conv3d_cuda.TC_MIN_STEPS_PER_SPLIT)
                # narrow Co takes a narrow tile: the conv_out's 3 channels n8
                assert plan.block_n <= max(8, 2 * co) or plan.block_n == 64
            else:
                assert plan.tile == -1 and plan.block_k == 16


@pytest.mark.parametrize("m,ci,co,tile", [
    (2 * 16 * 128 * 128, 64, 3, (256, 8)),     # conv_out: n8, 256 voxels
    (2 * 4 * 32 * 32, 256, 16, (256, 16)),     # the dx of the training conv_in
    (2 * 16 * 128 * 128, 3, 64, (128, 64)),    # conv_in: the element gather
    (2 * 16 * 128 * 128, 64, 64, (256, 64)),   # the 64-channel bulk
    (2 * 2 * 16 * 16, 256, 32, (128, 64)),     # 256-voxel n64 tiles < SMs
    (12 * 64 * 64, 256, 32, (256, 64)),
    (2 * 2 * 16 * 16, 16, 256, (128, 128)),
    (48 * 256 * 256, 128, 128, (128, 128)),
])
def test_tc_rule_tile_covers_co(m, ci, co, tile):
    """The tensor-core tile: the narrowest width that covers Co, 128 voxels
    where Ci < 8 or the 256-voxel n64 tiles would leave SMs idle."""
    plan = launch_plan(m, ci, co, 132, torch.bfloat16)
    assert (plan.block_m, plan.block_n) == tile


@pytest.mark.parametrize("m,ci,co,splits", [
    # the 2x16x16 mid level: 16 tiles on 132 SMs, K split 16 ways
    (2 * 2 * 16 * 16, 256, 256, 16),
    # Ci = 16: 14 steps of K, no split shorter than 5 steps
    (2 * 2 * 16 * 16, 16, 256, 3),
    # 4x32x32: 128 tiles, two a SM hold 264; split 2 fills them
    (2 * 4 * 32 * 32, 256, 256, 2),
    # the same tiles with 14 steps: a split would be shorter than 5 steps
    (2 * 4 * 32 * 32, 16, 256, 1),
    # 192 n64 tiles: 4 splits make 768 blocks, 2.9 waves of 264
    (12 * 64 * 64, 256, 32, 4),
    # a wave of tiles or more: K whole
    (2 * 8 * 64 * 64, 256, 256, 1),
    (48 * 256 * 256, 64, 3, 1),
])
def test_tc_rule_splits_k_by_waves(m, ci, co, splits):
    """The tensor-core split of K: the least waves of two blocks an SM times
    the steps a split takes, plus its partials' cost; at the path shapes
    these are the splits that tools/sweep_conv3d.py measured fastest."""
    plan = launch_plan(m, ci, co, 132, torch.bfloat16)
    assert plan.splits == splits, plan
    assert plan.splits == 1 or plan.chunks_per_split >= conv3d_cuda.TC_MIN_STEPS_PER_SPLIT


def test_tc_rule_follows_the_sm_count():
    """The split depends on the card's SM count: twice the SMs, at least as
    many splits; at a wave of tiles, none."""
    for m, ci, co in ((2 * 2 * 16 * 16, 256, 256), (2 * 4 * 32 * 32, 256, 128)):
        small, large = (conv3d_cuda.tc_rule(m, ci, co, sms) for sms in (66, 132))
        assert small[0] == large[0] and small[1] <= large[1]
    assert conv3d_cuda.tc_rule(2 * 4 * 32 * 32, 256, 256, 64)[1] == 1


def _emulate_tc(x, weight, plan):
    """The tensor-core kernel's arithmetic in torch: per block of
    ``plan.block_m`` voxels by ``plan.block_n`` channels, per step of 32 rows
    of K, the im2col tile gathered as the kernel's 16-byte pieces address it
    (row k = tap·Ci + ci; zero where the tap's source is outside the clip,
    past 27·Ci or past M) times the packed weight's (block_n, 32) slice,
    summed in fp32 per split and the splits added in split order. Returns
    fp32 (B, Co, T, H, W)."""
    b, ci, t, h, w = x.shape
    co = weight.shape[0]
    m_total = b * t * h * w
    packed = pack_weight(weight, plan).float()
    assert packed.shape == (plan.n_pad, plan.n_chunks * 32)
    xf = x.permute(0, 2, 3, 4, 1).reshape(m_total, ci).float()
    m_pad = -(-m_total // plan.block_m) * plan.block_m
    m = torch.arange(m_pad)
    vw, vh, vt = m % w, m // w % h, m // (w * h) % t
    parts = []
    for split in range(plan.splits):
        acc = torch.zeros(m_pad, plan.n_pad)
        first = split * plan.chunks_per_split
        for step in range(first, min(plan.n_chunks, first + plan.chunks_per_split)):
            tile_a = torch.zeros(m_pad, 32)
            for col in range(32):  # piece col // 8, element col % 8
                k = step * 32 + col
                tap, c = divmod(k, ci)
                dt, dh, dw = tap // 9, tap // 3 % 3, tap % 3
                ok = ((m < m_total) & (vt + dt - 1 >= 0) & (vt + dt - 1 < t)
                      & (vh + dh - 1 >= 0) & (vh + dh - 1 < h)
                      & (vw + dw - 1 >= 0) & (vw + dw - 1 < w)) & (k < 27 * ci)
                src = (m + ((dt - 1) * h + (dh - 1)) * w + (dw - 1)).clamp(0, m_total - 1)
                tile_a[:, col] = torch.where(ok, xf[src, c], 0.0)
            for n0 in range(0, plan.n_pad, plan.block_n):  # the column tiles
                acc[:, n0:n0 + plan.block_n] += (
                    tile_a @ packed[n0:n0 + plan.block_n, step * 32:step * 32 + 32].T)
        parts.append(acc)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total[:m_total, :co].reshape(b, t, h, w, co).permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("shape,splits", [
    ((1, 3, 3, 2, 8, 8), 1),     # Ci = Co = 3: 81 rows of K in 3 steps, an n8 tile
    ((1, 16, 24, 3, 5, 7), 1),   # Ci = 16: two taps a step, ragged H/W
    ((1, 8, 16, 2, 6, 6), 2),    # Ci = 8 (the training decoder's conv_in), K split
    ((2, 32, 3, 1, 4, 4), 3),    # T = 1, Co = 3, three splits
    ((1, 20, 12, 3, 9, 11), 1),  # Ci not a multiple of 8: the element gather
], ids=["ci3co3", "ci16", "ci8split", "t1co3", "ci20"])
def test_tc_packing_and_k_order_reproduce_the_conv(shape, splits):
    """The tensor-core route's packed weight, read in the kernel's K order
    and tile geometry, gives the plain version (fp32 sums of the bf16
    inputs, within ``bound_share``'s fp32 bound) and through it JAX
    ``conv3d_ttap`` in interpret mode."""
    b, ci, co, t, h, w = shape
    x, k = _data(b, t, h, w, ci, co, seed=ci + co)
    xb, wb = _port(x, k, torch.bfloat16)
    plan = launch_plan(b * t * h * w, ci, co, 132, torch.bfloat16)
    assert plan.route == "tc"
    n_chunks = plan.n_chunks
    per = -(-n_chunks // splits)
    plan = conv3d_cuda.LaunchPlan("tc", plan.tile, plan.block_m, plan.block_n, plan.n_pad,
                                  n_chunks, -(-n_chunks // per), per)
    got = _emulate_tc(xb, wb, plan)
    want = conv3d_plain(xb.float(), wb.float())
    assert bound_share(got, want, xb.float(), wb.float()) <= 1.0
    ref = conv3d_ttap(jnp.asarray(_ndhwc(xb)), jnp.asarray(wb.float().permute(2, 3, 4, 1, 0)
                                                          .numpy()), True)
    np.testing.assert_allclose(_ndhwc(got), np.asarray(ref), atol=ATOL_FP32)


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
