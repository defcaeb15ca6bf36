"""The port's GroupNorm(+swish) against the JAX package's, on the CPU.

The port's wrapper (``vqgan_tpu_torch.ops.groupnorm_cuda.fused_group_norm``)
takes its plain version for CPU tensors; the JAX side is the XLA form
(``group_norm_fp32``) and the Pallas kernel in interpret mode. Mirrors
tests/test_pallas_kernels.py. The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.ops.normalization import group_norm_fp32 as jax_group_norm
from vqgan_tpu.ops.pallas.groupnorm import fused_group_norm as pallas_group_norm
from vqgan_tpu_torch.ops import groupnorm_cuda
from vqgan_tpu_torch.ops.groupnorm_cuda import fused_group_norm, launch_geometry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fp32 on both sides: only the summation order of the statistics differs, a
# few ulps of O(1) values (the repo's Pallas-vs-XLA test uses the same bound)
ATOL_FP32 = 2e-6
# bf16 output: one bf16 ulp at |y| < 8 is 2^-5; the JAX bf16 test's bound
ATOL_BF16 = 0.05


def _inputs(seed, shape, c):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32) * 1.5 + 0.3
    scale = (1.0 + 0.5 * rng.randn(c)).astype(np.float32)
    bias = (0.5 * rng.randn(c)).astype(np.float32)
    return x, scale, bias


def _port(x_nhwc, scale, bias, g, swish, dtype=torch.float32):
    # an NHWC array seen as NCHW is channels_last without a copy
    x = torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)
    y = fused_group_norm(x, torch.from_numpy(scale), torch.from_numpy(bias),
                         g, 1e-6, with_swish=swish)
    assert y.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last)
    return y.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("swish", [False, True], ids=["plain", "swish"])
@pytest.mark.parametrize("c,g", [(64, 32), (256, 32), (128, 16)])
def test_plain_gn_matches_jax(c, g, swish):
    x, scale, bias = _inputs(0, (2, 8, 8, c), c)
    args = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), g)
    xla = jax_group_norm(*args, with_swish=swish)
    pallas = pallas_group_norm(*args, with_swish=swish, interpret=True)
    got = _port(x, scale, bias, g, swish)
    np.testing.assert_allclose(got, np.asarray(xla), atol=ATOL_FP32)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL_FP32)


@pytest.mark.parametrize("swish", [False, True], ids=["plain", "swish"])
def test_plain_gn_bf16_io(swish):
    x, scale, bias = _inputs(2, (2, 8, 8, 64), 64)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = pallas_group_norm(xb, jnp.asarray(scale), jnp.asarray(bias), 32,
                            with_swish=swish, interpret=True)
    # both sides see the same bf16-rounded input
    got = _port(np.asarray(xb, np.float32), scale, bias, 32, swish,
                dtype=torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=ATOL_BF16)


def test_plain_gn_odd_spatial():
    x, scale, bias = _inputs(3, (1, 6, 10, 64), 64)
    ref = pallas_group_norm(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias), 32, with_swish=True,
                            interpret=True)
    got = _port(x, scale, bias, 32, True)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_FP32)


def test_cpu_tensor_does_not_count_a_launch():
    groupnorm_cuda.launches = 0
    x, scale, bias = _inputs(4, (2, 4, 4, 64), 64)
    _port(x, scale, bias, 32, True)
    assert groupnorm_cuda.launches == 0


def test_rejects_what_the_kernel_does_not_take():
    w, b = torch.ones(64), torch.zeros(64)
    nchw = torch.randn(2, 64, 4, 4)  # contiguous NCHW, not channels_last
    with pytest.raises(ValueError, match="channels_last"):
        fused_group_norm(nchw, w, b)
    cl = nchw.contiguous(memory_format=torch.channels_last)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_group_norm(cl.half(), w, b)
    with pytest.raises(ValueError, match="divisible"):
        fused_group_norm(cl, w, b, num_groups=24)
    with pytest.raises(ValueError, match="weight"):
        fused_group_norm(cl, w.double(), b)


@pytest.mark.parametrize("dtype_size", [4, 2], ids=["fp32", "bf16"])
def test_launch_geometry_covers_flagship_shapes(dtype_size):
    """Every GroupNorm shape of a flagship reconstruct, at batch 1, 2 and 8,
    gets a geometry the kernel accepts: whole rows per block, at most 1024
    threads and 48 KB of shared memory, tiles that cover S exactly once."""
    shapes = [(65536, 256), (16384, 256), (16384, 512), (4096, 512),
              (4096, 1024), (1024, 1024), (16384, 1024), (65536, 512),
              (60, 64)]
    pack = 16 // dtype_size
    for b in (1, 2, 8):
        for s, c in shapes:
            threads, rows, n_tiles = launch_geometry(b, s, c, dtype_size, 132)
            packs = c // pack
            assert threads % packs == 0 and threads <= 1024
            assert 2 * threads * pack * 4 <= 48 * 1024
            assert rows % (threads // packs) == 0
            assert (n_tiles - 1) * rows < s <= n_tiles * rows


def test_import_builds_nothing(tmp_path):
    """Importing the kernel module needs no nvcc and loads no library."""
    code = (
        "import vqgan_tpu_torch.ops.groupnorm_cuda as m\n"
        "assert m.library.cache_info().currsize == 0\n"
    )
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: asking for the library raises; nothing falls back."""
    from vqgan_tpu_torch.ops import cuda_build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_HOME", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load_library("groupnorm")
