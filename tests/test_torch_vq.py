"""The VQ kernels' plain versions and their dispatch (``vqgan_tpu_torch/ops/
vq.py``, ``ops/vq_cuda.py``) against the JAX package's
``vqgan_tpu/ops/pallas/vq.py``, on the CPU.

The JAX side runs both of its implementations: the XLA formulation and the
Pallas kernels in interpret mode (as tests/test_pallas_vq.py runs them). The
Pallas search drops ‖z‖², so at a near-tie it may pick another code than a
search that keeps it: codes are compared by distance
(``torch_parity.assert_codes_by_distance``), except where every code is
duplicated and the first copy must win exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.ops.pallas.vq import code_stats as jax_code_stats
from vqgan_tpu.ops.pallas.vq import nearest_codes as jax_nearest_codes
from vqgan_tpu_torch.ops import vq_cuda
from vqgan_tpu_torch.ops.vq import code_stats_plain, nearest_codes_plain

from torch_parity import assert_codes_by_distance

# (N, K, D): a ragged N against the Pallas kernel's 512-token tile; a codebook
# of two 1,024-code Pallas tiles; a K that is no multiple of 128 (XLA only on
# the JAX side: the Pallas kernel refuses it)
CASES = [(700, 256, 16, "xla"), (700, 256, 16, "pallas"), (512, 2048, 8, "xla"),
         (512, 2048, 8, "pallas"), (64, 32, 4, "xla")]
CASE_IDS = [f"n{n}-k{k}-d{d}-{impl}" for n, k, d, impl in CASES]


def _data(n, k, d, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32), rng.randn(k, d).astype(np.float32)


def _sum_bound(codes, z, k):
    """Per code, the most two fp32 sums of its m matched rows can differ by
    in any summation order: 2·(m − 1)·2^-24 of Σ|terms|, plus a denormal
    floor."""
    counts = np.bincount(codes, minlength=k)[:, None]
    abs_sums = np.zeros((k, z.shape[1]))
    np.add.at(abs_sums, codes, np.abs(z).astype(np.float64))
    return 2 * np.maximum(counts - 1, 0) * 2.0 ** -24 * abs_sums + 1e-30


@pytest.mark.parametrize("n,k,d,impl", CASES, ids=CASE_IDS)
def test_nearest_codes_plain_matches_jax(n, k, d, impl):
    z, cb = _data(n, k, d, seed=n + k)
    ref = np.asarray(jax_nearest_codes(jnp.asarray(z), jnp.asarray(cb), impl=impl))
    got = nearest_codes_plain(torch.from_numpy(z), torch.from_numpy(cb))
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert_codes_by_distance(z, cb, got.numpy(), ref)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_nearest_codes_tie_prefers_first_index(impl):
    """Every code duplicated (tests/test_pallas_vq.py:52-61): the first copy
    wins, exactly, as ``jnp.argmin`` and the Pallas merge do."""
    z = np.random.RandomState(0).randn(64, 4).astype(np.float32)
    base = np.random.RandomState(1).randn(128, 4).astype(np.float32)
    cb = np.concatenate([base, base])
    ref = np.asarray(jax_nearest_codes(jnp.asarray(z), jnp.asarray(cb), impl=impl))
    got = vq_cuda.nearest_codes(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.max() < 128


@pytest.mark.parametrize("with_sums", [False, True], ids=["counts", "sums"])
@pytest.mark.parametrize("n,k,d,impl", CASES, ids=CASE_IDS)
def test_code_stats_plain_matches_jax(n, k, d, impl, with_sums):
    z, _ = _data(n, k, d, seed=n)
    codes = np.random.RandomState(k).randint(0, k, n).astype(np.int32)
    ref_counts, ref_sums = jax_code_stats(jnp.asarray(codes), jnp.asarray(z), k,
                                          with_sums=with_sums, impl=impl)
    counts, sums = code_stats_plain(torch.from_numpy(codes), torch.from_numpy(z), k, with_sums)
    assert counts.dtype == torch.float32 and counts.shape == (k,)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    assert float(counts.sum()) == n
    if not with_sums:
        assert sums is None and ref_sums is None
        return
    assert sums.dtype == torch.float32 and sums.shape == (k, d)
    err = np.abs(sums.numpy().astype(np.float64) - np.asarray(ref_sums, np.float64))
    assert (err <= _sum_bound(codes, z, k)).all(), err.max()


def test_wrappers_take_the_plain_versions_on_the_cpu():
    z, cb = _data(300, 64, 16, seed=3)
    zt, cbt = torch.from_numpy(z), torch.from_numpy(cb)
    vq_cuda.nearest_launches = vq_cuda.stats_launches = 0
    codes = vq_cuda.nearest_codes(zt.requires_grad_(), cbt)
    counts, sums = vq_cuda.code_stats(codes, zt, 64, with_sums=True)
    assert (vq_cuda.nearest_launches, vq_cuda.stats_launches) == (0, 0)
    assert not codes.requires_grad and not sums.requires_grad  # under no_grad
    np.testing.assert_array_equal(codes.numpy(), nearest_codes_plain(zt, cbt).numpy())
    ref_counts, ref_sums = code_stats_plain(codes, zt, 64, True)
    assert torch.equal(counts, ref_counts) and torch.equal(sums, ref_sums)
    assert vq_cuda.code_stats(codes, zt, 64)[1] is None


def _bad_inputs():
    z = torch.zeros(8, 4)
    cb = torch.zeros(16, 4)
    codes = torch.zeros(8, dtype=torch.int32)
    return {
        "z_float64": (lambda: vq_cuda.nearest_codes(z.double(), cb)),
        "codebook_bf16": (lambda: vq_cuda.nearest_codes(z, cb.bfloat16())),
        "z_not_contiguous": (lambda: vq_cuda.nearest_codes(torch.zeros(4, 8).T, cb)),
        "dim_mismatch": (lambda: vq_cuda.nearest_codes(z, torch.zeros(16, 5))),
        "dim_too_wide": (lambda: vq_cuda.nearest_codes(torch.zeros(8, 65), torch.zeros(4, 65))),
        "z_on_meta": (lambda: vq_cuda.nearest_codes(z.to("meta"), cb.to("meta"))),
        "codes_int64": (lambda: vq_cuda.code_stats(codes.long(), z, 16)),
        "codes_length": (lambda: vq_cuda.code_stats(codes[:4], z, 16)),
        "stats_z_float64": (lambda: vq_cuda.code_stats(codes, z.double(), 16)),
        "empty_codebook": (lambda: vq_cuda.code_stats(codes, z, 0)),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrappers_raise_on_what_the_kernels_do_not_take(case):
    with pytest.raises(ValueError):
        _bad_inputs()[case]()


@pytest.mark.parametrize("n,k", [(8192, 16384), (2048, 16384), (700, 256), (512, 2048),
                                 (64, 32), (1, 1), (100_000, 300)])
def test_nearest_launch_geometry_covers_the_codebook(n, k):
    """Every code lies in exactly one non-empty split; a small N gets more
    splits, up to one 256-code range per split."""
    splits, per = vq_cuda.nearest_launch_geometry(n, k, num_sms=132)
    assert splits >= 1 and (splits - 1) * per < k <= splits * per
    token_blocks = -(-n // vq_cuda.NEAREST_THREADS)
    assert splits * token_blocks >= min(264, token_blocks * -(-k // 256))
    assert splits <= max(1, -(-k // 256))


@pytest.mark.parametrize("n,k", [(8192, 16384), (2048, 16384), (700, 256), (512, 2048),
                                 (64, 32), (0, 8), (1, 1), (100_000, 300)])
def test_stats_launch_geometry_covers_the_tokens(n, k):
    """Every token lies in exactly one non-empty range of whole tiles; the
    grid has about four blocks per SM where N allows it (at least two: ranges
    are rounded up to whole tiles)."""
    splits, per = vq_cuda.stats_launch_geometry(n, k, num_sms=132)
    assert splits >= 1 and per % vq_cuda.STATS_TILE == 0
    assert (splits - 1) * per < max(n, 1) and n <= splits * per
    code_blocks = -(-k // vq_cuda.STATS_CODES)
    assert splits * code_blocks >= min(2 * 132, code_blocks * -(-n // vq_cuda.STATS_TILE))
