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
from vqgan_tpu_torch.ops.groupnorm_cuda import (
    fused_group_norm,
    group_norm_forward,
    launch_geometry,
)
from vqgan_tpu_torch.ops.normalization import group_norm_fp32_forward

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


def _fma32(a, b, c):
    """fp32 a·b + c rounded once, as the card's fused multiply-add (through
    float64, where the product of two fp32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _emulate_forward(x, weight, bias, groups, eps, swish, num_sms):
    """``csrc/groupnorm.cu``'s forward (``gn_stats_kernel``,
    ``gn_finalize_kernel``, ``gn_apply_kernel``) in its order, fp32 torch on
    the CPU: per tile of ``launch_geometry``'s, thread (r, pack)
    sums rows r, r + R, ... of the tile in order (Σx, and Σx² by fused
    multiply-adds), then per group over the rows in flight and the group's
    channels in order; per group, lane l sums tiles l, l + lanes, ... in
    order, then the lanes in order; mean = s1/n, var = s2/n − mean² (fused),
    rstd = rsqrt(var + eps); A = rstd·γ, B = β − mean·A; y = x·A + B, with
    the swish t·(1/(1 + e^−t)). x: (B, C, ...) channels-last; returns (y in
    x's dtype and layout, the (B, 2, G) stats)."""
    b_, c = x.shape[:2]
    cg = c // groups
    xf = x.float().movedim(1, -1).reshape(b_, -1, c)
    s = xf.shape[1]
    threads, rpt, n_tiles = launch_geometry(b_, s, c, x.element_size(), num_sms)
    pack = 16 // x.element_size()
    rows_in_flight = threads // (c // pack)
    lanes = min(1024 // groups, n_tiles)
    n = float(s * cg)
    y = torch.empty_like(xf)
    stats = torch.empty(b_, 2, groups)
    for b in range(b_):
        partial = torch.zeros(n_tiles, 2, groups)
        for t in range(n_tiles):
            rows = xf[b, t * rpt:min(s, (t + 1) * rpt)]
            s1 = torch.zeros(rows_in_flight, c)
            s2 = torch.zeros(rows_in_flight, c)
            for i in range(0, rows.shape[0], rows_in_flight):
                chunk = rows[i:i + rows_in_flight]
                k = chunk.shape[0]
                s1[:k] = s1[:k] + chunk
                s2[:k] = _fma32(chunk, chunk, s2[:k])
            for rr in range(rows_in_flight):
                for j in range(cg):
                    partial[t, 0] = partial[t, 0] + s1[rr, j::cg]
                    partial[t, 1] = partial[t, 1] + s2[rr, j::cg]
        lane_sums = torch.zeros(lanes, 2, groups)
        for lane in range(lanes):
            for t in range(lane, n_tiles, lanes):
                lane_sums[lane] = lane_sums[lane] + partial[t]
        tot = lane_sums[0]
        for lane in range(1, lanes):
            tot = tot + lane_sums[lane]
        mean = tot[0] / n
        var = _fma32(-mean, mean, tot[1] / n)
        rstd = torch.rsqrt(var + eps)
        stats[b, 0], stats[b, 1] = mean, rstd
        grp = torch.arange(c) // cg
        a = rstd[grp] * weight
        bb = bias - mean[grp] * a
        t_ = xf[b] * a + bb
        if swish:
            t_ = t_ * (1.0 / (1.0 + torch.exp(-t_)))
        y[b] = t_
    y = y.to(x.dtype).reshape((b_,) + tuple(x.shape[2:]) + (c,)).movedim(-1, 1)
    return y, stats


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("swish", [False, True], ids=["plain", "swish"])
@pytest.mark.parametrize("spatial,c,groups", [
    ((5, 13), 96, 32),        # 4-D
    ((3, 4, 5), 192, 32),     # 5-D
    ((3, 7), 328, 1),         # one group of 41 bf16 packs
], ids=["C96-4d", "C192-5d", "C328-G1"])
def test_kernel_order_matches_plain_and_pallas(spatial, c, groups, swish, dtype):
    """Kernel #1's summation order and roundings (emulated in torch with
    several tiles a sample, ragged, and several lanes) against the plain
    forward and the Pallas forward in interpret mode: y within ATOL_FP32
    (fp32), or one bf16 ulp of plain and ATOL_BF16 of Pallas (bf16 output),
    the stats within fp32 summation orders (1e-5)."""
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    x, scale, bias = _inputs(11, (2, *spatial, c), c)
    x = np.asarray(torch.from_numpy(x).to(tdt).float())  # both sides see the same values
    xt = torch.from_numpy(x).to(tdt).movedim(-1, 1)
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    s = int(np.prod(spatial))
    _, _, n_tiles = launch_geometry(2, s, c, xt.element_size(), 4)
    assert n_tiles > 1
    got, stats = _emulate_forward(xt, w, b, groups, 1e-6, swish, 4)
    assert got.dtype == tdt and got.is_contiguous(memory_format=torch.channels_last
                                                  if len(spatial) == 2 else torch.channels_last_3d)
    ref, mean, rstd = group_norm_fp32_forward(xt, w, b, groups, 1e-6, swish)
    _, port_stats = group_norm_forward(xt, w, b, groups, 1e-6, swish)
    pallas = pallas_group_norm(jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32),
                               jnp.asarray(scale), jnp.asarray(bias), groups,
                               with_swish=swish, interpret=True)
    got_nhwc = got.movedim(1, -1).float().numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(got_nhwc, ref.movedim(1, -1).numpy(), atol=ATOL_FP32, rtol=0)
        np.testing.assert_allclose(got_nhwc, np.asarray(pallas), atol=ATOL_FP32, rtol=0)
    else:
        # the plain version rounds alike: one bf16 ulp where the fp32 values
        # straddle a rounding boundary
        np.testing.assert_allclose(got_nhwc, ref.movedim(1, -1).float().numpy(), atol=1e-6,
                                   rtol=2.0 ** -7)
        np.testing.assert_allclose(got_nhwc, np.asarray(pallas, np.float32), atol=ATOL_BF16)
    for want in (torch.stack((mean, rstd), 1), port_stats):
        np.testing.assert_allclose(stats.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
