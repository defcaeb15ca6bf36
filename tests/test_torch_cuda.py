"""The CUDA kernels against their plain versions, and the paths through
them, on the card: GroupNorm forward and backward (with autograd; 4-D and
5-D input), the VQ nearest-code search and code statistics (with the VQ
pipeline and train step), attention forward and backward (with autograd, the
pipeline and the train step), the fused-tap Conv3d forward and dx (with
autograd, the TVAE clip pipeline and the 3D train steps), and the conv-tile
geometry probe's eight cases (with its entry point).

Marked ``cuda``; each test skips where torch sees no CUDA device. This file
imports no JAX, so the card's machine runs it without the JAX package's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from vqgan_tpu_torch.config import TVAEConfig, VAEConfig
from vqgan_tpu_torch.inference import TVAEPipeline, VAEPipeline
from vqgan_tpu_torch.models import tae
from vqgan_tpu_torch.models.ae import init_vae
from vqgan_tpu_torch.models.blocks import AttnBlock, Conv2d, FP32GroupNorm, init_weights_
from vqgan_tpu_torch.ops import attention_cuda, conv3d_cuda, groupnorm_cuda, vq_cuda
from vqgan_tpu_torch.ops.attention import (
    chunked_attention_backward,
    chunked_attention_forward,
    rounding_bounds,
)
from vqgan_tpu_torch.ops.conv3d import (
    bound_share,
    conv3d_input_grad_plain,
    conv3d_plain,
    flipped_weight,
)
from vqgan_tpu_torch.ops.normalization import (
    group_norm_fp32,
    group_norm_fp32_backward,
    group_norm_fp32_forward,
)
from vqgan_tpu_torch.ops.vq import code_stats_plain, nearest_codes_plain

from torch_parity import assert_codes_by_distance, distance_gap

pytestmark = pytest.mark.cuda

# fp32: the kernel and the plain version round every product and sum alike
# except the statistics' summation order: a few ulps of |y| < 8
ATOL_FP32 = 1e-5
# bf16 output: the fp32 values may straddle a rounding boundary, one bf16
# ulp, which is at most 2^-7 of the value
RTOL_BF16 = 2.0 ** -7
# backward dx: fp32 terms of size O(1) whose coefficients come from sums taken
# in another order differ by a few ulps before any rounding to bf16
ATOL_DX = 1e-5
# dγ, dβ: sums over B·H·W terms; a fixed-order fp32 sum of n terms is off by
# about √n·eps of the sum of their magnitudes, and the kernel's chains are a
# few hundred adds long: 1e-5 of Σ|terms| leaves a wide margin
SUM_RTOL = 1e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    b, c, h, w = shape
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32) * 1.5 + 0.3)
    x = x.to(device=device, dtype=dtype).permute(0, 3, 1, 2)
    scale = torch.from_numpy((1 + 0.5 * rng.randn(c)).astype(np.float32)).to(device)
    bias = torch.from_numpy((0.5 * rng.randn(c)).astype(np.float32)).to(device)
    return x, scale, bias


@pytest.mark.parametrize("swish", [False, True], ids=["plain", "swish"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,groups", [
    ((2, 64, 8, 8), 32),
    ((2, 128, 8, 8), 16),
    ((3, 256, 7, 9), 32),      # ragged last tile
    ((2, 512, 64, 64), 32),    # a flagship decoder shape at batch 2
    ((2, 96, 32, 32), 32),     # slices of 3 (bf16) or 6 (fp32) packs
    ((2, 192, 16, 16), 32),
    ((2, 48, 9, 7), 16),
    ((2, 328, 5, 6), 1),       # one group wider than a block: column blocks
])
def test_kernel_matches_plain(device, shape, groups, dtype, swish):
    x, scale, bias = _inputs(shape, dtype, device)
    groupnorm_cuda.launches = 0
    got = groupnorm_cuda.fused_group_norm(x, scale, bias, groups, 1e-6, swish)
    torch.cuda.synchronize()
    assert groupnorm_cuda.launches == 1
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = group_norm_fp32(x, scale, bias, groups, 1e-6, swish)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=ATOL_FP32, rtol=0)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-6,
                                   rtol=RTOL_BF16)


# (S, C) of the flagship reconstruct's GroupNorms, and the top levels of a
# VAE of width 96
FLAGSHIP_GN = [(65536, 256), (65536, 512), (16384, 1024), (16384, 512), (16384, 256),
               (4096, 1024), (4096, 512), (1024, 1024), (16384, 96), (4096, 192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,c", FLAGSHIP_GN, ids=lambda v: str(v))
def test_forward_kernel_is_deterministic(device, s, c, dtype):
    """Kernel #1 at the flagship shapes (batch 2) and at C = 96 and 192:
    within its bound of the plain version (y and the saved stats), one call
    counted once, two calls bitwise equal."""
    side = int(s ** 0.5)
    x, scale, bias = _inputs((2, c, side, side), dtype, device)
    groupnorm_cuda.launches = 0
    runs = [groupnorm_cuda.group_norm_forward(x, scale, bias, 32, 1e-6, True) for _ in range(2)]
    torch.cuda.synchronize()
    assert groupnorm_cuda.launches == 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    y, stats = runs[0]
    ref, mean, rstd = group_norm_fp32_forward(x, scale, bias, 32, 1e-6, True)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, atol=ATOL_FP32, rtol=0)
    else:
        torch.testing.assert_close(y.float(), ref.float(), atol=1e-6, rtol=RTOL_BF16)
    # the statistics: sums of S·C/G terms in another order
    torch.testing.assert_close(stats[:, 0], mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(stats[:, 1], rstd, atol=1e-5, rtol=1e-5)


def test_kernel_rejects_non_channels_last(device):
    x, scale, bias = _inputs((2, 64, 8, 8), torch.float32, device)
    with pytest.raises(ValueError, match="channels_last"):
        groupnorm_cuda.fused_group_norm(x.contiguous(), scale, bias)


def test_pipeline_goes_through_the_kernel(device):
    """Every GroupNorm of a reconstruct launches the kernel once, and the
    result matches the same weights on the CPU (plain version)."""
    cfg = VAEConfig(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                    z_channels=8, dec_dtype="float32")
    sd = init_vae(cfg, torch.Generator().manual_seed(0)).state_dict()
    gpu = VAEPipeline(cfg, sd, device=device)
    cpu = VAEPipeline(cfg, sd, device="cpu")
    n_gn = sum(isinstance(m, FP32GroupNorm) for m in gpu.model.modules())
    imgs = (np.random.RandomState(0).rand(2, 32, 32, 3) * 255).astype(np.uint8)
    groupnorm_cuda.launches = 0
    got = gpu.reconstruct(imgs)
    assert groupnorm_cuda.launches == n_gn
    np.testing.assert_allclose(got, cpu.reconstruct(imgs), atol=1e-4)


def test_flagship_artifact_equals_the_pipeline(device, tmp_path):
    """The serving artifact of the flagship config (``VAEConfig()``) traced
    and run on the card: encode and reconstruct within 1e-6 of
    ``VAEPipeline`` on the same weights, and kernel #1 launched 50 times a
    reconstruct, as the pipeline launches it."""
    from vqgan_tpu_torch.export import ExportedVAE, export_vae

    cfg = VAEConfig()
    sd = init_vae(cfg, torch.Generator().manual_seed(0)).state_dict()
    export_vae(cfg, sd, str(tmp_path), device=device)
    art = ExportedVAE.load(str(tmp_path))
    assert art.device.type == "cuda"
    pipe = VAEPipeline(cfg, sd, device=device)
    imgs = np.random.RandomState(0).randint(0, 256, (2, 256, 256, 3), np.uint8)
    assert float((art.encode(imgs) - pipe.encode(imgs)).abs().max()) <= 1e-6
    groupnorm_cuda.launches = 0
    got = art.reconstruct(imgs)
    launches, groupnorm_cuda.launches = groupnorm_cuda.launches, 0
    ref = pipe.reconstruct(imgs)
    assert launches == groupnorm_cuda.launches == 50
    assert np.abs(got - ref).max() <= 1e-6


def _sum_bounds(x, g, stats):
    """Per-channel Σ|terms| of dβ and dγ (an upper bound: |dŷ| <= 1.1·|g|
    for the swish derivative)."""
    ga = 1.1 * g.float().abs()
    mean_max = stats[:, 0].abs().max()
    rstd_max = stats[:, 1].max()
    dims = (0, *range(2, x.ndim))  # all but the channels
    t_beta = ga.sum(dim=dims)
    t_gamma = rstd_max * (ga * (x.float().abs() + mean_max)).sum(dim=dims)
    return t_gamma, t_beta


@pytest.mark.parametrize("swish", [False, True], ids=["plain", "swish"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,groups", [
    ((2, 64, 8, 8), 32),
    ((2, 128, 8, 8), 16),
    ((3, 256, 7, 9), 32),      # ragged last tile
    ((2, 512, 64, 64), 32),    # a flagship decoder shape at batch 2
    ((2, 96, 32, 32), 32),     # slices of 3 (bf16) or 6 (fp32) packs
    ((2, 192, 16, 16), 32),
    ((2, 48, 9, 7), 16),
    ((2, 328, 5, 6), 1),       # one group wider than a block: column blocks
])
def test_backward_kernel_matches_plain(device, shape, groups, dtype, swish):
    x, scale, bias = _inputs(shape, dtype, device)
    g = _inputs(shape, dtype, device, seed=1)[0]
    _, stats = groupnorm_cuda.group_norm_forward(x, scale, bias, groups, 1e-6, swish)
    groupnorm_cuda.bwd_launches = 0
    dx, dgamma, dbeta = groupnorm_cuda.group_norm_backward(
        x, g, stats, scale, bias, groups, swish)
    torch.cuda.synchronize()
    assert groupnorm_cuda.bwd_launches == 1
    assert dx.dtype == dtype and dx.is_contiguous(memory_format=torch.channels_last)
    ref_dx, ref_dgamma, ref_dbeta = group_norm_fp32_backward(
        x, g, stats[:, 0], stats[:, 1], scale, bias, groups, swish)
    if dtype == torch.float32:
        torch.testing.assert_close(dx, ref_dx, atol=ATOL_DX, rtol=0)
    else:
        torch.testing.assert_close(dx.float(), ref_dx.float(), atol=ATOL_DX,
                                   rtol=RTOL_BF16)
    t_gamma, t_beta = _sum_bounds(x, g, stats)
    assert bool(((dgamma - ref_dgamma).abs() <= SUM_RTOL * t_gamma + 1e-6).all())
    assert bool(((dbeta - ref_dbeta).abs() <= SUM_RTOL * t_beta + 1e-6).all())


def test_backward_kernel_is_one_deterministic_launch(device):
    """Kernel #2 is one cooperative launch a call, and two bf16 calls (the
    fp32 sums of every partial in a fixed order, integer barriers only) are
    bitwise equal."""
    x, scale, bias = _inputs((2, 512, 64, 64), torch.bfloat16, device)
    g = _inputs((2, 512, 64, 64), torch.bfloat16, device, seed=1)[0]
    _, stats = groupnorm_cuda.group_norm_forward(x, scale, bias, 32, 1e-6, True)
    groupnorm_cuda.bwd_launches = 0
    runs = [groupnorm_cuda.group_norm_backward(x, g, stats, scale, bias, 32, True)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert groupnorm_cuda.bwd_launches == 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_backward_kernel_raises_where_its_grid_cannot_be_resident(device):
    """A plan whose grid exceeds the blocks the card holds at once is
    refused by the cooperative launch; the wrapper raises and runs no other
    kernel."""
    x, scale, bias = _inputs((2, 64, 8, 8), torch.float32, device)
    g = _inputs((2, 64, 8, 8), torch.float32, device, seed=1)[0]
    _, stats = groupnorm_cuda.group_norm_forward(x, scale, bias)
    per_sm = groupnorm_cuda.backward_blocks_per_sm(device.index or 0, torch.float32, False)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    too_many = groupnorm_cuda.BackwardPlan(
        width=16, teams=4, team_blocks=per_sm * sms, rows_per_block=64, units=8,
        smem_bytes=groupnorm_cuda.backward_smem_bytes(4))
    groupnorm_cuda.bwd_launches = 0
    with pytest.raises(RuntimeError, match="cooperative launch"):
        groupnorm_cuda.group_norm_backward(x, g, stats, scale, bias, plan=too_many)
    torch.cuda.synchronize()
    assert groupnorm_cuda.bwd_launches == 0


def test_backward_kernel_rejects_non_channels_last_gradient(device):
    x, scale, bias = _inputs((2, 64, 8, 8), torch.float32, device)
    _, stats = groupnorm_cuda.group_norm_forward(x, scale, bias)
    with pytest.raises(ValueError, match="channels_last"):
        groupnorm_cuda.group_norm_backward(x, x.contiguous(), stats, scale, bias)


def test_autograd_reaches_the_conv_upstream(device):
    """On the card the GroupNorm output has a grad_fn, and a conv upstream of
    it gets the CPU's (plain) gradient, through one launch of each kernel."""
    grads = {}
    for dev in ("cpu", device):
        conv = Conv2d(8, 64, 3, padding=1)
        norm = FP32GroupNorm(64, fused_swish=True)
        init_weights_(conv, torch.Generator().manual_seed(0))
        with torch.no_grad():
            norm.weight.normal_(1.0, 0.2, generator=torch.Generator().manual_seed(1))
        conv.to(dev)
        norm.to(dev)
        x, _, _ = _inputs((2, 8, 16, 16), torch.float32, dev, seed=2)
        w = _inputs((2, 64, 16, 16), torch.float32, dev, seed=3)[0]
        groupnorm_cuda.launches = groupnorm_cuda.bwd_launches = 0
        y = norm(conv(x))
        assert y.grad_fn is not None
        (y * w).sum().backward()
        counts = (groupnorm_cuda.launches, groupnorm_cuda.bwd_launches)
        assert counts == ((0, 0) if dev == "cpu" else (1, 1))
        grads[dev] = [p.grad.cpu() for p in (conv.weight, conv.bias, norm.weight, norm.bias)]
    assert all(bool(gr.abs().max() > 0) for gr in grads[device])
    for got, ref in zip(grads[device], grads["cpu"]):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_tiny_train_step_goes_through_both_kernels(device):
    """A tiny GAN step on the card: every GroupNorm of the VAE launches the
    forward kernel once and the backward kernel once per step, and the
    step's losses match the same step on the CPU (plain versions)."""
    from vqgan_tpu_torch.config import TrainConfig
    from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, init_discriminator_
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.models.ae import VAE
    from vqgan_tpu_torch.train.state import create_train_state
    from vqgan_tpu_torch.train.step import StepDraws, make_train_step

    vae_cfg = VAEConfig(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                        z_channels=8, dec_dtype="float32")
    # D's lr 1e-8: AdamW's first step is ±lr·sign(grad), and where a gradient
    # is rounding noise the two devices would step apart before the G losses
    # read D (tests/test_torch_train_step.py)
    cfg = TrainConfig(max_steps=10, warmup_steps=2, do_ganloss=True, disc_type="hinge",
                      use_lecam=True, do_clamp=True, flip_invariance=True,
                      learning_rate_disc=1e-8)
    gen = torch.Generator().manual_seed(0)
    sd_vae = init_vae(vae_cfg, gen).state_dict()
    disc_ref, lpips_ref = PatchDiscriminator(), LPIPS()
    init_discriminator_(disc_ref, gen)
    init_lpips_(lpips_ref, gen)
    images = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (2, 32, 32, 3))
                              .astype(np.float32))
    draws = StepDraws(True, True, False, 0, 0, False, False)
    losses = {}
    for dev in ("cpu", device):
        with torch.device(dev):
            vae, disc, lpips = VAE(vae_cfg), PatchDiscriminator(), LPIPS()
        vae.load_state_dict(sd_vae)
        disc.load_state_dict(disc_ref.state_dict())
        lpips.load_state_dict(lpips_ref.state_dict())
        state = create_train_state(cfg, vae, disc, vae_cfg.ch)
        step = make_train_step(cfg, vae_cfg, vae, disc, lpips)
        n_gn = sum(isinstance(m, FP32GroupNorm) for m in vae.modules())
        groupnorm_cuda.launches = groupnorm_cuda.bwd_launches = 0
        state, metrics = step(state, images.to(dev), 0, draws)
        counts = (groupnorm_cuda.launches, groupnorm_cuda.bwd_launches)
        assert counts == ((0, 0) if dev == "cpu" else (n_gn, n_gn))
        losses[str(dev)] = {k: float(v) for k, v in metrics.items()}
        if dev != "cpu":  # drawn coins and offsets, on the device
            state, metrics = step(state, images.to(dev))
            assert all(np.isfinite(float(v)) for v in metrics.values())
    for k, v in losses["cpu"].items():
        if k != "gan/discriminator_accuracy":  # counts logits > 0
            np.testing.assert_allclose(losses["cuda"][k], v, rtol=1e-3, atol=1e-5, err_msg=k)


VQ_SHAPES = [(700, 256, 16), (512, 2048, 8), (64, 32, 4), (2048, 16384, 16), (5, 3, 20),
             (1024, 4096, 64)]


def _vq_data(n, k, d, device, seed=0):
    rng = np.random.RandomState(seed)
    z = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(device)
    cb = torch.from_numpy(rng.randn(k, d).astype(np.float32)).to(device)
    return z, cb


@pytest.mark.parametrize("n,k,d", VQ_SHAPES)
def test_vq_nearest_kernel_matches_plain(device, n, k, d):
    """Codes by distance: both searches round a D-term dot product in fp32,
    in other orders (torch_parity.distance_gap states the bound)."""
    z, cb = _vq_data(n, k, d, device)
    vq_cuda.nearest_launches = 0
    got = vq_cuda.nearest_codes(z, cb)
    torch.cuda.synchronize()
    assert vq_cuda.nearest_launches == 1
    assert got.dtype == torch.int32 and got.shape == (n,) and got.is_cuda
    ref = nearest_codes_plain(z, cb)
    assert_codes_by_distance(z.cpu().numpy(), cb.cpu().numpy(), got.cpu().numpy(),
                             ref.cpu().numpy())


@pytest.mark.parametrize("k", [256, 4096])
def test_vq_nearest_kernel_tie_prefers_first_index(device, k):
    """Every code duplicated, the copies in other tiles and splits: the first
    copy wins, exactly."""
    z, base = _vq_data(3000, k // 2, 4, device, seed=1)
    got = vq_cuda.nearest_codes(z, torch.cat([base, base]))
    ref = nearest_codes_plain(z, torch.cat([base, base]))
    assert torch.equal(got, ref) and int(got.max()) < k // 2


@pytest.mark.parametrize("with_sums", [False, True], ids=["counts", "sums"])
@pytest.mark.parametrize("n,k,d", VQ_SHAPES)
def test_vq_stats_kernel_matches_plain(device, n, k, d, with_sums):
    """Counts exactly; sums within 2·(m − 1)·2^-24 of Σ|terms| for a code of
    m tokens (two fp32 sums of the same terms in other orders)."""
    z, _ = _vq_data(n, k, d, device, seed=2)
    codes = torch.from_numpy(np.random.RandomState(3).randint(0, k, n).astype(np.int32))
    codes = codes.to(device)
    vq_cuda.stats_launches = 0
    counts, sums = vq_cuda.code_stats(codes, z, k, with_sums=with_sums)
    torch.cuda.synchronize()
    assert vq_cuda.stats_launches == 1
    ref_counts, ref_sums = code_stats_plain(codes, z, k, with_sums)
    assert torch.equal(counts, ref_counts) and float(counts.sum()) == n
    if not with_sums:
        assert sums is None
        return
    m = counts[:, None]
    abs_sums = code_stats_plain(codes, z.abs(), k, True)[1]
    bound = 2 * (m - 1).clamp_min(0) * 2.0 ** -24 * abs_sums + 1e-30
    assert bool(((sums - ref_sums).abs() <= bound).all())


@pytest.mark.parametrize("n,k", [(8192, 16384), (1000, 64)])
def test_vq_stats_kernel_collapsed_codebook(device, n, k):
    """Every token on one code: one thread's chain of matches runs through
    all of its split's tokens; the sum is still within the bound."""
    z, _ = _vq_data(n, k, 16, device, seed=4)
    codes = torch.full((n,), k - 1, dtype=torch.int32, device=device)
    counts, sums = vq_cuda.code_stats(codes, z, k, with_sums=True)
    ref_counts, ref_sums = code_stats_plain(codes, z, k, True)
    assert torch.equal(counts, ref_counts) and float(counts[k - 1]) == n
    bound = 2 * (n - 1) * 2.0 ** -24 * z.abs().sum(0)
    assert bool(((sums[k - 1] - ref_sums[k - 1]).abs() <= bound).all())
    assert float(sums[:k - 1].abs().max()) == 0.0


def _near_tie_codebook(k, d, seed):
    """k // 2 random codes, each followed by a twin that differs in the last
    one or two mantissa bits of every column."""
    rng = np.random.RandomState(seed)
    base = rng.randn(k // 2, d).astype(np.float32)
    bits = base.view(np.int32) + rng.choice([-2, -1, 1, 2], size=base.shape).astype(np.int32)
    return np.stack([base, bits.view(np.float32)], 1).reshape(k, d)


@pytest.mark.parametrize("n,k,d", [(8192, 16384, 16), (2048, 4096, 8), (1000, 512, 64),
                                   (700, 256, 4)])
def test_vq_nearest_kernel_near_tie_codebook(device, n, k, d):
    """Twin codes a few ulps apart: which twin wins is rounding, but every
    chosen code is within distance_gap's bound of the plain search's code,
    and of its pair."""
    cb = torch.from_numpy(_near_tie_codebook(k, d, seed=k + d)).to(device)
    z = torch.from_numpy(np.random.RandomState(n).randn(n, d).astype(np.float32)).to(device)
    got = vq_cuda.nearest_codes(z, cb).cpu().numpy()
    ref = nearest_codes_plain(z, cb).cpu().numpy()
    gap, tol = distance_gap(z.cpu().numpy(), cb.cpu().numpy(), got, ref)
    assert (np.abs(gap) <= tol).all(), (np.abs(gap).max(), tol[np.abs(gap).argmax()])
    assert (got // 2 == ref // 2).mean() >= 0.99


@pytest.mark.parametrize("n,k,d", [(8192, 16384, 16), (700, 256, 16), (1024, 4096, 64)])
def test_vq_nearest_kernel_is_bitwise_repeatable(device, n, k, d):
    """No atomics and fixed merge orders: two calls give the same codes."""
    z, cb = _vq_data(n, k, d, device, seed=5)
    assert torch.equal(vq_cuda.nearest_codes(z, cb), vq_cuda.nearest_codes(z, cb))


def _zipf_codes(n, k, device, seed):
    rng = np.random.RandomState(seed)
    codes = np.minimum(rng.zipf(1.3, n) - 1, k - 1).astype(np.int32)
    return torch.from_numpy(codes).to(device)


@pytest.mark.parametrize("n,k,d", [(8192, 16384, 16), (2000, 512, 8), (3000, 64, 64)])
def test_vq_stats_kernel_zipf_codes(device, n, k, d):
    """A few codes take most tokens (long runs in every tile): counts exact,
    sums within 2·(m − 1)·2^-24 of Σ|terms|."""
    z, _ = _vq_data(n, k, d, device, seed=6)
    codes = _zipf_codes(n, k, device, seed=7)
    vq_cuda.stats_launches = 0
    counts, sums = vq_cuda.code_stats(codes, z, k, with_sums=True)
    torch.cuda.synchronize()
    assert vq_cuda.stats_launches == 1
    ref_counts, ref_sums = code_stats_plain(codes, z, k, True)
    assert torch.equal(counts, ref_counts) and float(counts.sum()) == n
    abs_sums = code_stats_plain(codes, z.abs(), k, True)[1]
    bound = 2 * (counts[:, None] - 1).clamp_min(0) * 2.0 ** -24 * abs_sums + 1e-30
    assert bool(((sums - ref_sums).abs() <= bound).all())


@pytest.mark.parametrize("kind", ["random", "zipf", "collapsed"])
def test_vq_stats_kernel_is_bitwise_repeatable(device, kind):
    """No atomics, sums in token then tile order: two calls give the same
    counts and sums."""
    n, k, d = 8192, 16384, 16
    z, _ = _vq_data(n, k, d, device, seed=8)
    if kind == "random":
        codes = torch.from_numpy(np.random.RandomState(9).randint(0, k, n).astype(np.int32))
        codes = codes.to(device)
    elif kind == "zipf":
        codes = _zipf_codes(n, k, device, seed=9)
    else:
        codes = torch.full((n,), 3, dtype=torch.int32, device=device)
    first, second = (vq_cuda.code_stats(codes, z, k, with_sums=True) for _ in range(2))
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_vq_stats_kernel_skips_codes_out_of_range(device):
    """A code outside [0, K) is counted nowhere; N = 0 gives zeros."""
    n, k, d = 1000, 64, 16
    z, _ = _vq_data(n, k, d, device, seed=10)
    codes = torch.from_numpy(np.random.RandomState(11).randint(0, k, n).astype(np.int32))
    codes[::7], codes[3::11] = -1, k
    codes = codes.to(device)
    counts, sums = vq_cuda.code_stats(codes, z, k, with_sums=True)
    keep = (codes >= 0) & (codes < k)
    ref_counts, ref_sums = code_stats_plain(codes[keep], z[keep], k, True)
    assert torch.equal(counts, ref_counts)
    abs_sums = code_stats_plain(codes[keep], z[keep].abs(), k, True)[1]
    bound = 2 * (counts[:, None] - 1).clamp_min(0) * 2.0 ** -24 * abs_sums + 1e-30
    assert bool(((sums - ref_sums).abs() <= bound).all())
    empty = torch.zeros((0, d), device=device)
    counts, sums = vq_cuda.code_stats(torch.zeros(0, dtype=torch.int32, device=device), empty,
                                      k, with_sums=True)
    assert float(counts.abs().sum()) == 0 and float(sums.abs().sum()) == 0


def test_vq_geometry_matches_the_library(device):
    """The wrapper's mirror of the kernels' geometry (split planning, the
    workspaces' sizes) is what the built library reports."""
    lib = vq_cuda.library()
    for d in (1, 4, 8, 9, 16, 20, 32, 33, 64):
        assert lib.vq_search_block_tokens(d) == vq_cuda.search_block_tokens(d)
    assert lib.vq_stats_tile_tokens() == vq_cuda.STATS_TILE
    assert lib.vq_stats_merge_codes() == vq_cuda.STATS_MERGE_CODES


def test_vq_wrappers_raise_on_what_the_kernels_do_not_take(device):
    z, cb = _vq_data(64, 32, 8, device)
    codes = vq_cuda.nearest_codes(z, cb)
    for bad in (lambda: vq_cuda.nearest_codes(z.double(), cb),
                lambda: vq_cuda.nearest_codes(z, cb.cpu()),
                lambda: vq_cuda.nearest_codes(torch.zeros(8, 64, device=device).T, cb),
                lambda: vq_cuda.code_stats(codes.long(), z, 32),
                lambda: vq_cuda.code_stats(codes.cpu(), z, 32),
                lambda: vq_cuda.code_stats(codes, z[:, :4].contiguous().T, 32)):
        with pytest.raises(ValueError):
            bad()


def _tiny_vq_cfg(**kw):
    return VAEConfig(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
                     dec_dtype="float32", reg_type="vq", vq_codebook_size=256, **kw)


def test_vq_pipeline_goes_through_the_search_kernel(device):
    """One search launch per encode and no statistics; the CPU pipeline on the
    same weights picks the same codes up to near-ties."""
    cfg = _tiny_vq_cfg(vq_ema_decay=0.0)
    sd = init_vae(cfg, torch.Generator().manual_seed(0)).state_dict()
    gpu, cpu = VAEPipeline(cfg, sd, device=device), VAEPipeline(cfg, sd, device="cpu")
    imgs = (np.random.RandomState(0).rand(2, 32, 32, 3) * 255).astype(np.uint8)
    vq_cuda.nearest_launches = vq_cuda.stats_launches = 0
    z = gpu.encode(imgs)
    assert (vq_cuda.nearest_launches, vq_cuda.stats_launches) == (1, 0)
    cb = sd["reg.codebook"].numpy()
    codes = lambda lat: np.argmin(((lat.reshape(-1, 1, 8) - cb[None]) ** 2).sum(-1), 1)  # noqa: E731
    np.testing.assert_allclose(z.cpu().numpy().reshape(-1, 8), cb[codes(z.cpu().numpy())],
                               atol=1e-6)
    z_cpu = cpu.encode(imgs).numpy()
    assert (codes(z.cpu().numpy()) == codes(z_cpu)).mean() >= 0.99
    assert np.isfinite(gpu.decode(z)).all()


def test_tiny_vq_train_step_goes_through_both_vq_kernels(device):
    """A tiny VQ GAN step (EMA 0.9) on the card: one search and one
    statistics launch per step, the EMA counts move, and the losses match the
    same step on the CPU."""
    from vqgan_tpu_torch.config import TrainConfig
    from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, init_discriminator_
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.models.ae import VAE
    from vqgan_tpu_torch.train.state import create_train_state
    from vqgan_tpu_torch.train.step import StepDraws, make_train_step

    vae_cfg = _tiny_vq_cfg(vq_ema_decay=0.9, vq_revive_threshold=0.5)
    cfg = TrainConfig(max_steps=10, warmup_steps=2, do_ganloss=True, disc_type="hinge",
                      use_lecam=True, do_clamp=True, flip_invariance=True,
                      learning_rate_disc=1e-8)
    gen = torch.Generator().manual_seed(0)
    sd_vae = init_vae(vae_cfg, gen).state_dict()
    disc_ref, lpips_ref = PatchDiscriminator(), LPIPS()
    init_discriminator_(disc_ref, gen)
    init_lpips_(lpips_ref, gen)
    images = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (2, 32, 32, 3))
                              .astype(np.float32))
    idx = torch.from_numpy(np.random.RandomState(2).randint(0, 512, 256))
    losses, counts = {}, {}
    for dev in ("cpu", device):
        with torch.device(dev):
            vae, disc, lpips = VAE(vae_cfg), PatchDiscriminator(), LPIPS()
        vae.load_state_dict(sd_vae)
        disc.load_state_dict(disc_ref.state_dict())
        lpips.load_state_dict(lpips_ref.state_dict())
        state = create_train_state(cfg, vae, disc, vae_cfg.ch)
        step = make_train_step(cfg, vae_cfg, vae, disc, lpips)
        draws = StepDraws(True, True, False, 0, 0, False, False, idx.to(dev))
        vq_cuda.nearest_launches = vq_cuda.stats_launches = 0
        state, metrics = step(state, images.to(dev), 0, draws)
        launches = (vq_cuda.nearest_launches, vq_cuda.stats_launches)
        assert launches == ((0, 0) if dev == "cpu" else (1, 1))
        losses[str(dev)] = {k: float(v) for k, v in metrics.items()}
        counts[str(dev)] = state.vq_ema["counts"].cpu()
        assert not torch.equal(counts[str(dev)], torch.ones(256))
    for k, v in losses["cpu"].items():
        if k != "gan/discriminator_accuracy":  # counts logits > 0
            np.testing.assert_allclose(losses["cuda"][k], v, rtol=1e-3, atol=1e-5, err_msg=k)
    # one token on the other side of a near-tie moves two counts by 0.1
    assert float((counts["cuda"] - counts["cpu"]).abs().sum()) <= 0.2 + 1e-4


# attention, kernel vs plain on the same inputs: each output within
# ATTN_RTOL of its Σ|terms| for fp32 summation orders (plus 2^-9 of it where
# the kernel rounds P or dS to bf16, ops/attention.py::rounding_bounds), plus
# one bf16 ulp of the value for a bf16 output rounded on either side. lse:
# the logits' D-term sums in other orders, O(1e-6) of |S| <= ~10
ATTN_RTOL = 3e-5
LSE_ATOL = 1e-4
ATTN_SHAPES = [(2, 256, 2, 64), (2, 400, 2, 64), (1, 1, 1, 64), (2, 333, 3, 32), (1, 1024, 2, 32),
               (2, 333, 8, 16), (1, 1024, 8, 16), (2, 333, 2, 128), (1, 1024, 2, 128)]


def _attn_inputs(shape, dtype, device, seed=0):
    """q, k, v as views of one (B, N, 3, H, D) tensor, as the AttnBlock hands
    them over (token stride 3·H·D), and a gradient g of out."""
    b, n, h, d = shape
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(b, n, 3, h, d).astype(np.float32)).to(device, dtype)
    g = torch.from_numpy(rng.randn(b, n, h, d).astype(np.float32)).to(device, dtype)
    return (*qkv.unbind(2), g)


def attention_errors(q, k, v, g):
    """Kernel #3 against its plain versions on the same inputs, forward and
    backward (the backward of both from the plain forward's out and lse):
    {name: the largest |error| / its bound}, lse against LSE_ATOL."""
    n = q.shape[1]
    bf16 = q.dtype == torch.bfloat16
    out, lse = attention_cuda.attention_forward(q, k, v, n)
    ref_out, ref_lse = chunked_attention_forward(q, k, v, n)
    grads = attention_cuda.attention_backward(q, k, v, ref_out, ref_lse, g, n)
    ref_grads = chunked_attention_backward(q, k, v, ref_out, ref_lse, g, n)
    torch.cuda.synchronize()
    delta = (g.float() * ref_out.float()).sum(-1).transpose(1, 2)
    bounds = rounding_bounds(q, k, v, ref_lse, ATTN_RTOL, bf16, g, delta)
    used = {"lse": float((lse - ref_lse).abs().max()) / LSE_ATOL}
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref_out, *ref_grads)):
        assert got.dtype == q.dtype and got.shape == q.shape and got.is_contiguous()
        tol = bounds[name] + 1e-7
        if bf16:
            tol = tol + 2.0 ** -7 * want.float().abs()
        used[name] = float(((got.float() - want.float()).abs() / tol).max())
    return used


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_kernel_matches_plain(device, shape, dtype):
    """Forward (out, lse) and backward (dq, dk, dv) at head_dim 16, 32, 64
    and 128, fp32 and bf16, N a multiple of the 64-token tile, ragged, and
    1."""
    q, k, v, g = _attn_inputs(shape, dtype, device)
    attention_cuda.fwd_launches = attention_cuda.bwd_launches = 0
    attention_cuda.tc_launches = attention_cuda.fma_launches = 0
    used = attention_errors(q, k, v, g)
    assert (attention_cuda.fwd_launches, attention_cuda.bwd_launches) == (1, 1)
    # bf16 on the tensor cores, fp32 on the CUDA cores' FMA: both calls
    want = (2, 0) if dtype == torch.bfloat16 else (0, 2)
    assert (attention_cuda.tc_launches, attention_cuda.fma_launches) == want
    assert all(u <= 1.0 for u in used.values()), used


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_kernel_fp32_outputs_match_plain(device, shape):
    """bf16 inputs with fp32 outputs (the ring's partials): out, dq, dk, dv
    against the plain versions' fp32 sums before the cast, within the
    rounding bounds alone (no output is rounded to bf16); on the tensor
    cores."""
    q, k, v, g = _attn_inputs(shape, torch.bfloat16, device)
    n = q.shape[1]
    f32 = torch.float32
    attention_cuda.tc_launches = attention_cuda.fma_launches = 0
    out, lse = attention_cuda.attention_forward(q, k, v, n, out_dtype=f32)
    ref_out, ref_lse = chunked_attention_forward(q, k, v, n, out_dtype=f32)
    narrow, _ = chunked_attention_forward(q, k, v, n)
    grads = attention_cuda.attention_backward(q, k, v, narrow, ref_lse, g, n, grad_dtype=f32)
    ref_grads = chunked_attention_backward(q, k, v, narrow, ref_lse, g, n, grad_dtype=f32)
    torch.cuda.synchronize()
    assert (attention_cuda.tc_launches, attention_cuda.fma_launches) == (2, 0)
    delta = (g.float() * narrow.float()).sum(-1).transpose(1, 2)
    bounds = rounding_bounds(q, k, v, ref_lse, ATTN_RTOL, True, g, delta)
    assert float((lse - ref_lse).abs().max()) <= LSE_ATOL
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref_out, *ref_grads)):
        assert got.dtype == f32 and got.shape == q.shape and got.is_contiguous()
        used = float(((got - want).abs() / (bounds[name] + 1e-7)).max())
        assert used <= 1.0, (name, used)


def test_attention_kernel_is_deterministic(device):
    q, k, v, g = _attn_inputs((2, 333, 2, 64), torch.bfloat16, device)
    runs = []
    for _ in range(2):
        out, lse = attention_cuda.attention_forward(q, k, v, 333)
        runs.append((out, lse, *attention_cuda.attention_backward(q, k, v, out, lse, g, 333)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_attention_wrappers_raise_on_what_the_kernels_do_not_take(device):
    q48 = torch.zeros(1, 64, 2, 48, device=device)
    with pytest.raises(NotImplementedError, match="16, 32, 64, 128"):
        attention_cuda.attention_forward(q48, q48, q48, 64)
    odd = torch.zeros(2, 64, 2, 65, device=device)[..., :64]  # token stride 130
    with pytest.raises(ValueError, match="multiples of 4"):
        attention_cuda.attention_forward(odd, odd, odd, 64)
    q = torch.zeros(1, 64, 2, 64, device=device)
    with pytest.raises(ValueError, match="does not match"):
        attention_cuda.attention_forward(q, q.cpu(), q, 64)
    # bf16: head stride 68, a multiple of 4 but not of the 8 that the
    # tensor-core route's 16-byte copies need; raises, no fallback
    attention_cuda.tc_launches = attention_cuda.fma_launches = 0
    bad = torch.zeros(2, 64, 2, 68, device=device, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        attention_cuda.attention_forward(bad, bad, bad, 64)
    with pytest.raises(ValueError, match="16-byte"):
        off = torch.zeros(2 * 64 * 64 + 4, device=device, dtype=torch.bfloat16)[4:]
        attention_cuda.attention_forward(*[off.view(2, 64, 1, 64)] * 3, 64)
    assert (attention_cuda.tc_launches, attention_cuda.fma_launches) == (0, 0)


def test_attn_block_autograd_reaches_qkv_through_the_kernel(device):
    """On the card the AttnBlock's attention output has a grad_fn, and the
    qkv conv's weight (upstream of the kernel), proj_out's weight and the
    input get the CPU's (plain) gradients, through one launch of each
    kernel; fp32, TF32 off."""
    grads = {}
    for dev in ("cpu", device):
        block = AttnBlock(128, torch.float32, attn_chunk=64)
        gen = torch.Generator().manual_seed(0)
        init_weights_(block, gen)
        with torch.no_grad():
            block.norm.weight.normal_(1.0, 0.2, generator=gen)
            block.proj_out.weight.normal_(0.0, 0.05, generator=gen)
        block.to(dev)
        x = _inputs((2, 128, 16, 16), torch.float32, dev, seed=5)[0].detach().requires_grad_()
        w = _inputs((2, 128, 16, 16), torch.float32, dev, seed=6)[0]
        attention_cuda.fwd_launches = attention_cuda.bwd_launches = 0
        (block(x) * w).sum().backward()
        counts = (attention_cuda.fwd_launches, attention_cuda.bwd_launches)
        assert counts == ((0, 0) if dev == "cpu" else (1, 1))
        grads[dev] = [t.cpu() for t in (block.qkv.weight.grad, block.proj_out.weight.grad,
                                        x.grad)]
    assert all(bool(gr.abs().max() > 0) for gr in grads[device])
    for got, ref in zip(grads[device], grads["cpu"]):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def _tiny_attn_cfg(**kw):
    # mid block 16x16 = 256 tokens, 64 channels = one head of 64
    return VAEConfig(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
                     dec_dtype="float32", use_attn=True, attn_chunk=64, **kw)


def test_attn_pipeline_goes_through_the_attention_kernel(device):
    """One forward launch per encode and one per decode; every GroupNorm,
    the AttnBlocks' two among them, launches its kernel once; and the CPU's
    reconstruction."""
    cfg = _tiny_attn_cfg()
    sd = init_vae(cfg, torch.Generator().manual_seed(0)).state_dict()
    gpu, cpu = VAEPipeline(cfg, sd, device=device), VAEPipeline(cfg, sd, device="cpu")
    imgs = (np.random.RandomState(0).rand(2, 32, 32, 3) * 255).astype(np.uint8)
    assert sum(isinstance(m, AttnBlock) for m in gpu.model.modules()) == 2
    n_gn = sum(isinstance(m, FP32GroupNorm) for m in gpu.model.modules())
    attention_cuda.fwd_launches = attention_cuda.bwd_launches = groupnorm_cuda.launches = 0
    z = gpu.encode(imgs)
    enc = attention_cuda.fwd_launches
    rec = gpu.decode(z)
    assert (enc, attention_cuda.fwd_launches, attention_cuda.bwd_launches) == (1, 2, 0)
    assert groupnorm_cuda.launches == n_gn
    np.testing.assert_allclose(rec, cpu.reconstruct(imgs), atol=1e-4)


def test_tiny_attn_train_step_goes_through_the_attention_kernel(device):
    """A tiny GAN step with attention on the card: two forward and two
    backward attention launches (encoder and decoder), every GroupNorm once
    each way, and the CPU's losses."""
    from vqgan_tpu_torch.config import TrainConfig
    from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, init_discriminator_
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.models.ae import VAE
    from vqgan_tpu_torch.train.state import create_train_state
    from vqgan_tpu_torch.train.step import StepDraws, make_train_step

    vae_cfg = _tiny_attn_cfg()
    cfg = TrainConfig(max_steps=10, warmup_steps=2, do_ganloss=True, disc_type="hinge",
                      use_lecam=True, do_clamp=True, flip_invariance=True,
                      learning_rate_disc=1e-8)
    gen = torch.Generator().manual_seed(0)
    sd_vae = init_vae(vae_cfg, gen).state_dict()
    disc_ref, lpips_ref = PatchDiscriminator(), LPIPS()
    init_discriminator_(disc_ref, gen)
    init_lpips_(lpips_ref, gen)
    images = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (2, 32, 32, 3))
                              .astype(np.float32))
    losses = {}
    for dev in ("cpu", device):
        with torch.device(dev):
            vae, disc, lpips = VAE(vae_cfg), PatchDiscriminator(), LPIPS()
        vae.load_state_dict(sd_vae)
        disc.load_state_dict(disc_ref.state_dict())
        lpips.load_state_dict(lpips_ref.state_dict())
        state = create_train_state(cfg, vae, disc, vae_cfg.ch)
        step = make_train_step(cfg, vae_cfg, vae, disc, lpips)
        n_gn = sum(isinstance(m, FP32GroupNorm) for m in vae.modules())
        attention_cuda.fwd_launches = attention_cuda.bwd_launches = 0
        groupnorm_cuda.launches = groupnorm_cuda.bwd_launches = 0
        state, metrics = step(state, images.to(dev), 0, StepDraws(True, True, False, 0, 0,
                                                                  False, False))
        counts = (attention_cuda.fwd_launches, attention_cuda.bwd_launches,
                  groupnorm_cuda.launches, groupnorm_cuda.bwd_launches)
        assert counts == ((0, 0, 0, 0) if dev == "cpu" else (2, 2, n_gn, n_gn))
        losses[str(dev)] = {k: float(v) for k, v in metrics.items()}
    for k, v in losses["cpu"].items():
        if k != "gan/discriminator_accuracy":  # counts logits > 0
            np.testing.assert_allclose(losses["cuda"][k], v, rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 64, 4, 16, 12), (1, 256, 2, 8, 8)],
                         ids=["64ch", "256ch"])
def test_groupnorm_5d_forward_and_backward(device, shape, dtype):
    """(B, C, T, H, W) channels_last_3d, physically (B, T·H·W, C): the same
    kernels as 4-D input, against the plain versions (the 4-D tests'
    bounds)."""
    b, c, t, h, w = shape
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(b, t, h, w, c).astype(np.float32) * 1.5 + 0.3)
    x = x.to(device, dtype).permute(0, 4, 1, 2, 3)
    g = torch.from_numpy(rng.randn(b, t, h, w, c).astype(np.float32)).to(device, dtype)
    g = g.permute(0, 4, 1, 2, 3)
    scale = torch.from_numpy((1 + 0.5 * rng.randn(c)).astype(np.float32)).to(device)
    bias = torch.from_numpy((0.5 * rng.randn(c)).astype(np.float32)).to(device)
    groupnorm_cuda.launches = groupnorm_cuda.bwd_launches = 0
    y, stats = groupnorm_cuda.group_norm_forward(x, scale, bias, 32, 1e-6, True)
    dx, dw, db = groupnorm_cuda.group_norm_backward(x, g, stats, scale, bias, 32, True)
    torch.cuda.synchronize()
    assert (groupnorm_cuda.launches, groupnorm_cuda.bwd_launches) == (1, 1)
    assert y.is_contiguous(memory_format=torch.channels_last_3d)
    assert dx.is_contiguous(memory_format=torch.channels_last_3d)
    ref = group_norm_fp32(x, scale, bias, 32, 1e-6, True)
    rdx, rdw, rdb = group_norm_fp32_backward(x, g, stats[:, 0], stats[:, 1], scale, bias, 32,
                                             True)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, atol=ATOL_FP32, rtol=0)
        torch.testing.assert_close(dx, rdx, atol=ATOL_DX, rtol=0)
    else:
        torch.testing.assert_close(y.float(), ref.float(), atol=1e-6, rtol=RTOL_BF16)
        torch.testing.assert_close(dx.float(), rdx.float(), atol=ATOL_DX, rtol=RTOL_BF16)
    t_gamma, t_beta = _sum_bounds(x, g, stats)
    assert bool(((dw - rdw).abs() <= SUM_RTOL * t_gamma + 1e-6).all())
    assert bool(((db - rdb).abs() <= SUM_RTOL * t_beta + 1e-6).all())


# (B, Ci, Co, T, H, W): the 16f/128px path's channel pairs at reduced frames
# and sides, Ci = 3 (conv_in), Ci = 16 (decoder conv_in), Co = 3 and 32
# (conv_out), the split-K mid level, T = 1, and ragged H/W with Co % 4 != 0;
# the 3D training config's Ci = 8 and Co = 16 (z = 8); chip_smoke.py's edge
# cases: Ci = Co = 3, ragged H/W, Ci not a multiple of 8 or 16
CONV3D_SHAPES = [
    (2, 3, 64, 4, 16, 16), (2, 64, 64, 4, 16, 16), (1, 64, 128, 2, 8, 8),
    (1, 128, 128, 2, 8, 8), (1, 128, 256, 2, 8, 8), (1, 256, 256, 2, 16, 16),
    (1, 16, 256, 2, 16, 16), (1, 256, 32, 2, 16, 16), (2, 64, 3, 4, 16, 16),
    (1, 32, 48, 1, 7, 9), (1, 16, 20, 3, 5, 13),
    (2, 8, 256, 2, 8, 8), (2, 256, 16, 2, 8, 8), (1, 3, 3, 2, 8, 8), (1, 48, 40, 5, 37, 29),
    (1, 20, 12, 3, 9, 11),
]


def _conv3d_inputs(shape, dtype, device, seed=0):
    b, ci, co, t, h, w = shape
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, t, h, w, ci).astype(np.float32)).to(device, dtype)
    wt = torch.from_numpy((rng.randn(co, ci, 3, 3, 3) / np.sqrt(27 * ci)).astype(np.float32))
    return x.permute(0, 4, 1, 2, 3), wt.to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", CONV3D_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv3d_kernel_matches_plain(device, shape, dtype):
    """Forward and dx (the same kernel on the flipped, transposed weight)
    against the plain versions, one launch each."""
    x, w = _conv3d_inputs(shape, dtype, device)
    dy = _conv3d_inputs(shape[:1] + shape[2:3] + shape[1:2] + shape[3:], dtype, device, 1)[0]
    conv3d_cuda.launches = conv3d_cuda.bwd_launches = 0
    conv3d_cuda.tc_launches = conv3d_cuda.fma_launches = 0
    y = conv3d_cuda.conv3d_forward(x, w)
    dx = conv3d_cuda.conv3d_input_grad(dy, w)
    torch.cuda.synchronize()
    assert (conv3d_cuda.launches, conv3d_cuda.bwd_launches) == (1, 1)
    # the route by dtype: bf16 on the tensor cores, fp32 on the CUDA cores
    routes = (conv3d_cuda.tc_launches, conv3d_cuda.fma_launches)
    assert routes == ((2, 0) if dtype == torch.bfloat16 else (0, 2))
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last_3d)
    assert dx.shape == x.shape and dx.is_contiguous(memory_format=torch.channels_last_3d)
    assert bound_share(y, conv3d_plain(x, w), x, w) <= 1.0
    assert bound_share(dx, conv3d_input_grad_plain(dy, w), dy, flipped_weight(w)) <= 1.0
    # the TVAE holds its 5-D weights in channels_last_3d: the same outputs
    w_cl = w.contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(conv3d_cuda.conv3d_forward(x, w_cl), y)
    assert torch.equal(conv3d_cuda.conv3d_input_grad(dy, w_cl), dx)


def test_conv3d_kernel_is_deterministic(device):
    x, w = _conv3d_inputs((1, 256, 256, 2, 16, 16), torch.bfloat16, device)
    assert conv3d_cuda.launch_plan(512, 256, 256, 132, torch.bfloat16).splits > 1
    assert torch.equal(conv3d_cuda.conv3d_forward(x, w), conv3d_cuda.conv3d_forward(x, w))


@pytest.mark.parametrize("shape", [(1, 256, 256, 2, 16, 16), (2, 64, 64, 4, 16, 16),
                                   (1, 3, 64, 2, 8, 8), (2, 64, 3, 4, 16, 16),
                                   (2, 8, 256, 2, 8, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3d_tensor_core_sums_within_the_fp32_bound(device, shape):
    """The bf16 route's fp32 sums before the cast, against the fp32 plain
    version of the same bf16 inputs: the tensor cores' accumulation within
    ``rounding_bound`` alone, no bf16 ulp."""
    x, w = _conv3d_inputs(shape, torch.bfloat16, device)
    sums = conv3d_cuda.conv3d_forward_sums(x, w)
    assert sums.dtype == torch.float32 and sums.shape == (shape[0], shape[2], *shape[3:])
    assert bound_share(sums, conv3d_plain(x.float(), w.float()), x.float(), w.float()) <= 1.0


@pytest.mark.parametrize("tile", range(len(conv3d_cuda.TC_TILES)))
def test_conv3d_every_tensor_core_tile_matches_plain(device, tile):
    """Each tile the kernel has, at one split and three, vectorised (Ci = 64)
    and element-gathered (Ci = 20) im2col, against the plain version."""
    bm, bn = conv3d_cuda.TC_TILES[tile]
    for ci, co in ((64, 24), (20, 40)):
        x, w = _conv3d_inputs((1, ci, co, 3, 9, 13), torch.bfloat16, device, seed=tile)
        n_chunks = -(-27 * ci // 32)
        for s in (1, 3):
            splits, per = conv3d_cuda._split(n_chunks, s)
            plan = conv3d_cuda.LaunchPlan("tc", tile, bm, bn, -(-co // bn) * bn, n_chunks,
                                          splits, per)
            y = conv3d_cuda._launch(x, w, plan)
            assert bound_share(y, conv3d_plain(x, w), x, w) <= 1.0, (ci, co, s)


@pytest.mark.parametrize("layout", ["oidhw", "channels_last_3d"])
@pytest.mark.parametrize("ci,co", [(16, 256), (3, 64), (256, 3), (20, 12)])
def test_conv3d_pack_kernel_matches_pack_weight(device, ci, co, layout):
    """The card's weight rows equal ``pack_weight``'s, bit for bit: the
    forward's from the weight, the dx's from the flipped, transposed one,
    read by the weight's strides from an OIDHW or a channels_last_3d
    weight."""
    w = _conv3d_inputs((1, ci, co, 1, 1, 1), torch.bfloat16, device)[1]
    if layout == "channels_last_3d":
        w = w.contiguous(memory_format=torch.channels_last_3d)
    lib = conv3d_cuda.library()
    for transpose, (i, o) in ((0, (ci, co)), (1, (co, ci))):
        plan = conv3d_cuda.launch_plan(4096, i, o, 132, torch.bfloat16)
        ref = conv3d_cuda.pack_weight(flipped_weight(w) if transpose else w, plan)
        got = torch.full_like(ref, float("nan"))
        stream = torch.cuda.current_stream().cuda_stream
        assert lib.conv3d_pack_bf16(w.data_ptr(), got.data_ptr(), co, ci, *ref.shape,
                                    transpose, *w.stride(), stream) == 0
        assert torch.equal(got, ref)


def test_conv3d_bf16_without_the_kernel_raises(device, monkeypatch):
    """A bf16 call on the card whose tensor-core kernel cannot be built
    raises: no fallback to the FMA kernel or to cuDNN."""
    x, w = _conv3d_inputs((1, 16, 16, 2, 4, 4), torch.bfloat16, device)

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(conv3d_cuda, "library", no_library)
    conv3d_cuda.tc_launches = conv3d_cuda.fma_launches = 0
    with pytest.raises(RuntimeError, match="nvcc not found"):
        conv3d_cuda.conv3d_forward(x, w)
    assert (conv3d_cuda.tc_launches, conv3d_cuda.fma_launches) == (0, 0)


def test_conv3d_wrapper_raises_on_what_the_kernel_does_not_take(device):
    x, w = _conv3d_inputs((1, 16, 16, 2, 4, 4), torch.float32, device)
    with pytest.raises(ValueError, match="channels_last_3d"):
        conv3d_cuda.conv3d_forward(x.contiguous(), w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv3d_cuda.conv3d_forward(x.half(), w.half())
    with pytest.raises(ValueError, match="does not match"):
        conv3d_cuda.conv3d_forward(x, w.cpu())
    flat = torch.zeros(1 + x.numel(), device=device)[1:]  # 4-byte aligned, not 16
    misaligned = flat.view(1, 2, 4, 4, 16).permute(0, 4, 1, 2, 3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        conv3d_cuda.conv3d_forward(misaligned, w)


def test_conv3d_autograd_on_the_card(device):
    """Through ``Conv3dTTap`` on the card the output has a grad_fn; dx (one
    kernel launch) and dk (the weight gradient) match the CPU's plain
    gradients; fp32, TF32 off."""
    grads = {}
    for dev in ("cpu", device):
        x, w = _conv3d_inputs((1, 64, 32, 3, 8, 10), torch.float32, dev, seed=3)
        x = x.detach().requires_grad_()
        w = w.detach().requires_grad_()
        conv3d_cuda.launches = conv3d_cuda.bwd_launches = 0
        y = conv3d_cuda.conv3d_ttap(x, w)
        assert y.grad_fn is not None
        g = _conv3d_inputs((1, 32, 64, 3, 8, 10), torch.float32, dev, seed=4)[0]
        y.backward(g)
        counts = (conv3d_cuda.launches, conv3d_cuda.bwd_launches)
        assert counts == ((0, 0) if dev == "cpu" else (1, 1))
        grads[str(dev)] = [x.grad.cpu(), w.grad.cpu()]
    for got, ref in zip(grads["cuda"], grads["cpu"]):
        assert bool(got.abs().max() > 0)
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def _tiny_tvae_cfg(**kw):
    # mid block 2x8x8 = 128 tokens of 256 channels: 8 heads of 32, a head
    # dim kernel #3 takes; a chunk of 64 takes its memory-efficient path
    return TVAEConfig(resolution=16, ch=32, ch_mult=(1, 8), num_res_blocks=1, z_channels=8,
                      compute_dtype="float32", attn_chunk=64, **kw)


def test_tvae_pipeline_goes_through_the_kernels(device):
    """"auto" on the card: every stride-1 3x3x3 conv launches kernel #6 once
    (10 per encode, 15 per decode at this depth), every GroupNorm kernel #1,
    each mid block's attention kernel #3; and the CPU's reconstruction."""
    cfg = _tiny_tvae_cfg()
    sd = tae.init_tvae(cfg, torch.Generator().manual_seed(0)).state_dict()
    gpu, cpu = TVAEPipeline(cfg, sd, device=device), TVAEPipeline(cfg, sd, device="cpu")
    clips = (np.random.RandomState(0).rand(2, 4, 16, 16, 3) * 255).astype(np.uint8)
    n_gn = sum(isinstance(m, FP32GroupNorm) for m in gpu.model.modules())
    conv3d_cuda.launches = attention_cuda.fwd_launches = groupnorm_cuda.launches = 0
    z = gpu.encode(clips)
    enc = (conv3d_cuda.launches, attention_cuda.fwd_launches)
    rec = gpu.decode(z)
    assert enc == (10, 1)
    assert (conv3d_cuda.launches, attention_cuda.fwd_launches) == (25, 2)
    assert groupnorm_cuda.launches == n_gn
    np.testing.assert_allclose(rec, cpu.reconstruct(clips), atol=1e-4)


# the conv-tile geometry probe (kernel #7): each case against its plain
# version at the JAX tool's rtol = atol = 2e-2, and far inside it (A-G: the
# same fp32 products summed in another order; H: exact bf16 products, fp32
# sums)
@pytest.mark.parametrize("letter", "ABCDEFGH")
def test_geometry_probe_case_matches_plain(device, letter):
    from vqgan_tpu_torch.ops import geometry_probe_cuda
    from vqgan_tpu_torch.ops.geometry_probe import ATOL, CASES, RTOL, make_inputs

    case = next(c for c in CASES if c.letter == letter)
    inputs = make_inputs()
    a, b = (torch.from_numpy(inputs[k]).to(device) for k in case.inputs)
    before = geometry_probe_cuda.launches
    got = geometry_probe_cuda.probe_case(case, a, b)
    ref = case.plain(a, b)
    torch.cuda.synchronize()
    assert geometry_probe_cuda.launches == before + 1
    assert got.shape == case.out_shape and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
    attrs = geometry_probe_cuda.attributes(case)
    assert attrs["num_regs"] > 0 and attrs["shared_bytes"] > 0
    # the grid spreads the case's tiles (SPLITS): a cluster of blocks per tile
    # where K is split, else a block per column slice
    from vqgan_tpu_torch.ops.geometry_probe import SPLITS

    kind, split = SPLITS[letter]
    blocks, cluster = geometry_probe_cuda.grid(case)
    assert blocks % split == 0 and cluster == (split if kind == "k" else 1)


def test_geometry_probe_entry_point_builds_and_passes_every_case(device):
    from vqgan_tpu_torch.ops import geometry_probe_cuda
    from vqgan_tpu_torch.tools.probe_conv3d_geometry import run_probe

    geometry_probe_cuda.launches = 0
    results = run_probe(iters=2, log=lambda line: None)
    assert [r.case.letter for r in results] == list("ABCDEFGH")
    assert all(r.built and r.ok and r.ms > 0 for r in results)
    assert geometry_probe_cuda.launches == 8 * (1 + 3 + 2)


def _tiny_3d_runs(device, gan):
    """One 3D step (recon-only, or GAN with gaussian + frame D and 3 of 4
    frames) on the CPU and on the card from the same weights, clips and
    draws, at _tiny_tvae_cfg (kernels #6 forward and dx, #1/#2 on 5-D input,
    #3 forward and backward at head dim 32): metrics, G's first moments, and
    the card's launches."""
    from vqgan_tpu_torch.config import TrainConfig
    from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, init_discriminator_
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.train.state import create_train_state
    from vqgan_tpu_torch.train.step3d import (
        Step3DDraws,
        make_train_step_3d,
        make_train_step_3d_gan,
    )

    cfg_t = _tiny_tvae_cfg()
    cfg = TrainConfig(max_steps=10, warmup_steps=2, learning_rate_disc=1e-8, do_ganloss=gan,
                      disc_type="hinge", use_lecam=True, video_loss_frames=3)
    gen = torch.Generator().manual_seed(0)
    sd = tae.init_tvae(cfg_t, gen).state_dict()
    disc_ref, lpips_ref = PatchDiscriminator(), LPIPS()
    init_discriminator_(disc_ref, gen)
    init_lpips_(lpips_ref, gen)
    rng = np.random.RandomState(1)
    clips = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 16, 16, 3)).astype(np.float32))
    eps = torch.from_numpy(rng.randn(2, 2, 8, 8, 8).astype(np.float32))
    out = {}
    for dev in ("cpu", device):
        model = tae.TVAE(cfg_t).to(dev)
        model.load_state_dict(sd)
        conv3d_cuda.launches = conv3d_cuda.bwd_launches = 0
        attention_cuda.fwd_launches = attention_cuda.bwd_launches = 0
        draws = Step3DDraws(eps=eps.to(dev), frame_u=0.5)
        if gan:
            with torch.device(dev):
                disc, lpips = PatchDiscriminator(), LPIPS()
            disc.load_state_dict(disc_ref.state_dict())
            lpips.load_state_dict(lpips_ref.state_dict())
            state = create_train_state(cfg, model, disc, cfg_t.ch)
            step = make_train_step_3d_gan(cfg, cfg_t, model, disc, lpips)
        else:
            state = create_train_state(cfg, model, None, cfg_t.ch, recon_only=True)
            step = make_train_step_3d(cfg, cfg_t, model)
        state, metrics = step(state, clips.to(dev), draws)
        out[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                         {n: state.g_opt.state[p]["exp_avg"].cpu()
                          for n, p in model.named_parameters()},
                         (conv3d_cuda.launches, conv3d_cuda.bwd_launches,
                          attention_cuda.fwd_launches, attention_cuda.bwd_launches))
    return out["cpu"], out["cuda"]


@pytest.mark.parametrize("gan", [False, True], ids=["recon-only", "gan"])
def test_tiny_3d_step_on_the_card_matches_cpu(device, gan):
    """25 Conv3d launches and 24 dx (every conv but the encoder's conv_in),
    2 + 2 attention launches on the card; losses within the CPU-vs-card
    bounds of a training step (chip_smoke.py phase 8: 8e-3 relative + 8e-4),
    G's first moments within 1e-2 of each tensor's largest entry + 1e-6 of
    the largest."""
    (m_cpu, g_cpu, l_cpu), (m_gpu, g_gpu, l_gpu) = _tiny_3d_runs(device, gan)
    assert l_cpu == (0, 0, 0, 0) and l_gpu == (25, 24, 2, 2)
    assert set(m_cpu) == set(m_gpu)
    for k, v in m_cpu.items():
        if k != "gan/discriminator_accuracy":  # counts logits > 0
            np.testing.assert_allclose(m_gpu[k], v, rtol=8e-3, atol=8e-4, err_msg=k)
    floor = 1e-6 * max(float(t.abs().max()) for t in g_cpu.values())
    for n, r in g_cpu.items():
        assert float((g_gpu[n] - r).abs().max()) <= 1e-2 * float(r.abs().max()) + floor, n


def _job_cfg(tmp_path, max_steps, **kw):
    from vqgan_tpu_torch.config import TrainConfig

    return TrainConfig(synthetic_data=True, batch_size=2, image_size=64, max_steps=max_steps,
                       num_epochs=1, evaluate_every_n_steps=0, use_wandb=False, log_every=1,
                       ckpt_dir=str(tmp_path), run_name="c", do_ganloss=True,
                       disc_type="hinge", use_lecam=True, do_clamp=True, warmup_steps=1,
                       **kw)


def _same_tensors(a, b) -> int:
    """Asserts every tensor of two ``state_dict_of`` trees bitwise equal;
    returns how many there are."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
        return 1
    if isinstance(a, dict):
        assert set(a) == set(b)
        return sum(_same_tensors(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        return sum(_same_tensors(x, y) for x, y in zip(a, b))
    return 0


@pytest.mark.parametrize("reg_type", ["gaussian", "vq"])
def test_trainer_on_the_card_launches_and_resumes(device, tmp_path, reg_type):
    """A 2-step ``Trainer`` at ch=64 on the card (the training job's entry
    under the CLI): every GroupNorm runs its kernels once forward and once
    backward a step, VQ one search and one statistics launch a step; a
    second Trainer restores step 2 with every tensor of the state, the CUDA
    generator's state included, bitwise the one the first ended with (and
    saved), then trains 2 more steps with finite losses."""
    from vqgan_tpu_torch.train.checkpoint import state_dict_of
    from vqgan_tpu_torch.train.trainer import Trainer

    vae_cfg = VAEConfig(resolution=32, ch=64, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
                        reg_type=reg_type, vq_codebook_size=512)
    groupnorm_cuda.launches = groupnorm_cuda.bwd_launches = 0
    vq_cuda.nearest_launches = vq_cuda.stats_launches = 0
    first = Trainer(_job_cfg(tmp_path, 2), vae_cfg)
    assert first.device.type == "cuda"
    first.train()
    n_gn = sum(isinstance(m, FP32GroupNorm) for m in first.vae.modules())
    assert (groupnorm_cuda.launches, groupnorm_cuda.bwd_launches) == (2 * n_gn, 2 * n_gn)
    vq_steps = 2 if reg_type == "vq" else 0
    assert (vq_cuda.nearest_launches, vq_cuda.stats_launches) == (vq_steps, vq_steps)
    assert all(p.is_cuda for p in first.vae.parameters())
    assert first.state.generator.device.type == "cuda"
    live = state_dict_of(first.state)
    del first

    second = Trainer(_job_cfg(tmp_path, 4), vae_cfg)
    assert second.state.step == 2
    assert _same_tensors(state_dict_of(second.state), live) > 0
    second.train()
    assert second.state.step == 4
    lines = [json.loads(x) for x in open(tmp_path / "c" / "metrics_c.jsonl") if x.strip()]
    losses = [ln for ln in lines if "overall_vae_loss" in ln]
    assert [ln["step"] for ln in losses] == [0, 1, 2, 3]
    assert all(np.isfinite(v) for ln in losses for v in ln.values())


def test_trainer_resume_on_the_card_is_bitwise(device, tmp_path, monkeypatch):
    """On indexed data (a PNG tar shard; sample-exact resume) 4 straight
    steps on the card equal 2 steps, a resume and 2 more, bit for bit: G,
    D, both AdamW states, LeCam, the EMA and the CUDA generator, which
    drew the Gaussian latent's ε. cuDNN is held to its deterministic
    algorithms, so that the two runs differ only where the resume would."""
    import tarfile

    from vqgan_tpu_torch.train.checkpoint import state_dict_of
    from vqgan_tpu_torch.train.trainer import Trainer
    from vqgan_tpu_torch.utils.logging import write_png

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    rng = np.random.RandomState(1)
    shard = str(tmp_path / "00000.tar")
    with tarfile.open(shard, "w") as tf:
        for i in range(10):
            png = str(tmp_path / f"{i}.png")
            write_png(png, rng.randint(0, 256, (80, 96, 3)).astype(np.uint8))
            tf.add(png, arcname=f"{i:03d}.png")
    vae_cfg = VAEConfig(resolution=32, ch=64, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
                        reg_type="gaussian")
    kw = dict(synthetic_data=False, dataset_url=shard, num_workers=1, ema_decay=0.5,
              flip_invariance=True)

    def cfg(run, max_steps):
        return dataclasses.replace(_job_cfg(tmp_path, max_steps), run_name=run, **kw)

    straight = Trainer(cfg("a", 4), vae_cfg)
    straight.train()
    Trainer(cfg("b", 2), vae_cfg).train()
    resumed = Trainer(cfg("b", 4), vae_cfg)
    assert resumed.state.step == 2
    resumed.train()
    assert _same_tensors(state_dict_of(resumed.state), state_dict_of(straight.state)) > 0
    losses = []
    for r in ("a", "b"):
        lines = map(json.loads, open(tmp_path / r / f"metrics_{r}.jsonl"))
        losses.append([ln["overall_vae_loss"] for ln in lines if "overall_vae_loss" in ln])
    assert len(losses[0]) == 4 and losses[0] == losses[1]
