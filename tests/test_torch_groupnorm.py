"""The port's GroupNorm(+swish) against the JAX package's, on the CPU.

The port's wrapper (``vqgan_tpu_torch.ops.groupnorm_cuda.fused_group_norm``)
takes its plain version for CPU tensors; the JAX side is the XLA form
(``group_norm_fp32``) and the Pallas kernel in interpret mode. Mirrors
tests/test_pallas_kernels.py. The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py.
"""

import dataclasses
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
    FWD_CLUSTERS,
    FWD_THREADS,
    MAX_SMEM_PER_BLOCK,
    SM_SMEM_BYTES,
    forward_plan,
    forward_smem_bytes,
    fused_group_norm,
    group_norm_forward,
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
def test_forward_plan_covers_flagship_shapes(dtype_size):
    """Every GroupNorm shape of a flagship reconstruct, at batch 1, 2 and 8,
    gets a forward plan the kernel takes: units of whole groups and packs
    that cover C, at most ``FWD_THREADS`` packs a row, a cluster of
    ``FWD_CLUSTERS`` whose blocks cover S exactly once, shared memory within
    a block's limit and one or two blocks an SM."""
    shapes = [(65536, 256), (16384, 256), (16384, 512), (4096, 512),
              (4096, 1024), (1024, 1024), (16384, 1024), (65536, 512),
              (60, 64)]
    pack = 16 // dtype_size
    for b in (1, 2, 8):
        for s, c in shapes:
            plan = forward_plan(b, s, c, 32, dtype_size)
            packs = plan.width // pack
            assert c % plan.width == 0 and plan.width % (c // 32) == 0 and plan.width % pack == 0
            assert packs <= FWD_THREADS and plan.units == b * c // plan.width
            assert plan.cluster in FWD_CLUSTERS
            assert (plan.cluster - 1) * plan.rows_per_block < s <= plan.cluster * plan.rows_per_block
            assert 0 < plan.held_rows(s, dtype_size) <= s
            assert plan.smem_bytes == forward_smem_bytes(plan.width, plan.width // (c // 32),
                                                         dtype_size, plan.slots, plan.cluster,
                                                         plan.halves)
            assert plan.smem_bytes <= MAX_SMEM_PER_BLOCK
            assert plan.blocks_per_sm in (1, 2)
            assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= SM_SMEM_BYTES


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


def _seq_sums(rows):
    """Σx and Σx² (fused multiply-adds) of rows (m, R, W) over m in order."""
    s1 = torch.zeros(rows.shape[1:])
    s2 = torch.zeros(rows.shape[1:])
    for v in rows:
        s1 = s1 + v
        s2 = _fma32(v, v, s2)
    return s1, s2


def _emulate_forward(x, weight, bias, groups, eps, swish, plan):
    """``csrc/groupnorm.cu``'s ``gn_fwd_kernel`` in its order, fp32 torch on
    the CPU, for ``plan``: per unit (a sample, a slice of ``plan.width``
    channels), block r of its cluster takes rows [r·rpb, (r + 1)·rpb);
    thread (rl, pack) sums rows rl, rl + R, ... of the block in rounds of
    ``plan.slots`` rows, in order within a round (Σx, and Σx² by fused
    multiply-adds), the rounds' sums added in order; the block sums each
    channel over its threads' rows in flight, then each group over its
    channels in order; the cluster adds its blocks' group sums in rank
    order; mean = s1/n, var = s2/n − mean² (fused), rstd = rsqrt(var + eps);
    A = rstd·γ, B = β − mean·A; y = x·A + B, with the swish t·(1/(1 +
    e^−t)). x: (B, C, ...) channels-last; returns (y in x's dtype and
    layout, the (B, 2, G) stats)."""
    b_, c = x.shape[:2]
    cg = c // groups
    xf = x.float().movedim(1, -1).reshape(b_, -1, c)
    s = xf.shape[1]
    w = plan.width
    rows_in_flight = plan.rows_in_flight(x.element_size())
    rpb, n, gw = plan.rows_per_block, float(s * cg), w // cg
    y = torch.empty_like(xf)
    stats = torch.empty(b_, 2, groups)
    for u in range(plan.units):
        b, sl = divmod(u, c // w)
        ch = torch.arange(sl * w, (sl + 1) * w)
        tot = None
        for r in range(plan.cluster):
            rows = xf[b, r * rpb:min(s, (r + 1) * rpb)][:, ch]
            m = -(-rows.shape[0] // rows_in_flight)  # rows a thread takes, at most
            pad = torch.zeros(m * rows_in_flight, w)
            pad[:rows.shape[0]] = rows
            per_thread = pad.reshape(m, rows_in_flight, w)  # [i][rl]: row rl + i·R
            t1, t2 = torch.zeros(rows_in_flight, w), torch.zeros(rows_in_flight, w)
            for i0 in range(0, m, plan.slots):  # zero rows add nothing
                c1, c2 = _seq_sums(per_thread[i0:i0 + plan.slots])
                t1, t2 = t1 + c1, t2 + c2
            chan1, chan2 = t1[0], t2[0]
            for rl in range(1, rows_in_flight):
                chan1, chan2 = chan1 + t1[rl], chan2 + t2[rl]
            part = torch.zeros(2, gw)
            for q in range(gw):
                for k in range(q * cg, (q + 1) * cg):
                    part[0, q] = part[0, q] + chan1[k]
                    part[1, q] = part[1, q] + chan2[k]
            tot = part if tot is None else tot + part
        mean = tot[0] / n
        var = _fma32(-mean, mean, tot[1] / n)
        rstd = torch.rsqrt(var + eps)
        g0 = sl * gw
        stats[b, 0, g0:g0 + gw], stats[b, 1, g0:g0 + gw] = mean, rstd
        q = torch.arange(w) // cg
        a = rstd[q] * weight[ch]
        bb = bias[ch] - mean[q] * a
        t_ = xf[b][:, ch] * a + bb
        if swish:
            t_ = t_ * (1.0 / (1.0 + torch.exp(-t_)))
        y[b][:, ch] = t_
    y = y.to(x.dtype).reshape((b_,) + tuple(x.shape[2:]) + (c,)).movedim(-1, 1)
    return y, stats


def _many_block_plan(b, s, c, groups, element_size):
    """A plan with several units, clusters of several blocks (one of them
    ragged), and threads that take their rows in several rounds of one pack:
    the kernel's order at its most general."""
    plan = forward_plan(b, s, c, groups, element_size)
    rows = -(-s // 3)
    return dataclasses.replace(plan, cluster=3, rows_per_block=rows, slots=1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("swish", [False, True], ids=["plain", "swish"])
@pytest.mark.parametrize("spatial,c,groups", [
    ((5, 13), 96, 32),        # 4-D
    ((3, 4, 5), 192, 32),     # 5-D
    ((3, 7), 328, 1),         # one group of 41 bf16 packs
], ids=["C96-4d", "C192-5d", "C328-G1"])
def test_kernel_order_matches_plain_and_pallas(spatial, c, groups, swish, dtype):
    """Kernel #1's summation order and roundings (emulated in torch: units,
    clusters of three blocks, one ragged, rounds of held rows, the fold in
    block order) against the plain forward and the Pallas
    forward in interpret mode: y within ATOL_FP32 (fp32), or one bf16 ulp
    of plain and ATOL_BF16 of Pallas (bf16 output), the stats within fp32
    summation orders (1e-5)."""
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    x, scale, bias = _inputs(11, (2, *spatial, c), c)
    x = np.asarray(torch.from_numpy(x).to(tdt).float())  # both sides see the same values
    xt = torch.from_numpy(x).to(tdt).movedim(-1, 1)
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    s = int(np.prod(spatial))
    plan = _many_block_plan(2, s, c, groups, xt.element_size())
    assert plan.units > 1 or c == 328
    got, stats = _emulate_forward(xt, w, b, groups, 1e-6, swish, plan)
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
