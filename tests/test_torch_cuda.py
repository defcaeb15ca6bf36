"""The CUDA GroupNorm kernel against its plain version, on the card.

Marked ``cuda``; each test skips where torch sees no CUDA device. This file
imports no JAX, so the card's machine runs it without the JAX package's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vqgan_tpu_torch.config import VAEConfig
from vqgan_tpu_torch.inference import VAEPipeline
from vqgan_tpu_torch.models.ae import init_vae
from vqgan_tpu_torch.models.blocks import FP32GroupNorm
from vqgan_tpu_torch.ops import groupnorm_cuda
from vqgan_tpu_torch.ops.normalization import group_norm_fp32

pytestmark = pytest.mark.cuda

# fp32: the kernel and the plain version round every product and sum alike
# except the statistics' summation order: a few ulps of |y| < 8
ATOL_FP32 = 1e-5
# bf16 output: the fp32 values may straddle a rounding boundary, one bf16
# ulp, which is at most 2^-7 of the value
RTOL_BF16 = 2.0 ** -7


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
