"""The VQ kernels' plain versions and their dispatch (``vqgan_tpu_torch/ops/
vq.py``, ``ops/vq_cuda.py``) against the JAX package's
``vqgan_tpu/ops/pallas/vq.py``, on the CPU.

The JAX side runs both of its implementations: the XLA formulation and the
Pallas kernels in interpret mode (as tests/test_pallas_vq.py runs them). The
Pallas search drops ‖z‖², so at a near-tie it may pick another code than a
search that keeps it: codes are compared by distance
(``torch_parity.assert_codes_by_distance``), except where every code is
duplicated and the first copy must win exactly.

The CUDA kernels cannot run here, so their arithmetic is emulated in torch
in their order: the search as three TF32 products (each operand split into
two halves rounded to nearest, ties away, by bit masking) summed in fp32 from
|E|^2, each lane's strictly-smaller running minimum and the lexicographic
merges of lanes and codebook splits; the statistics as sorted per-tile
records summed in token order, merged per code in tile order. The kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqgan_tpu.ops.pallas.vq import code_stats as jax_code_stats
from vqgan_tpu.ops.pallas.vq import nearest_codes as jax_nearest_codes
from vqgan_tpu_torch.ops import vq_cuda
from vqgan_tpu_torch.ops.vq import code_stats_plain, nearest_codes_plain

from torch_parity import assert_codes_by_distance, distance_gap

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


@pytest.mark.parametrize("n,k,d", [(8192, 16384, 16), (2048, 16384, 16), (700, 256, 16),
                                   (512, 2048, 8), (64, 32, 4), (1, 1, 64), (100_000, 300, 32)])
def test_nearest_launch_geometry_covers_the_codebook(n, k, d):
    """Every code lies in exactly one non-empty split; the grid fills at
    most one wave of two blocks an SM unless the tokens alone need more; no
    more splits than 64-code ranges; every split but the last a whole number
    of 8-code mma tiles."""
    splits, per = vq_cuda.nearest_launch_geometry(n, k, d, num_sms=132)
    assert splits >= 1 and (splits - 1) * per < k <= splits * per
    assert per % 8 == 0
    token_blocks = -(-n // vq_cuda.search_block_tokens(d))
    most = -(-k // vq_cuda.SEARCH_MIN_SPLIT_CODES)
    assert splits * token_blocks <= max(264, token_blocks) and splits <= most
    if token_blocks < 264 and splits < most and per > 8:
        # as many splits as one wave takes: ranges 8 codes shorter would need more
        assert -(-k // (per - 8)) > 264 // token_blocks


@pytest.mark.parametrize("n,k", [(0, 8), (1, 1), (255, 16), (256, 17), (257, 4096),
                                 (700, 256), (2048, 16384), (8192, 16384), (100_000, 300)])
def test_stats_tile_plan_covers_the_tokens(n, k):
    """Every token lies in exactly one tile; no tile's records (one per code
    it holds) exceed its capacity; the index has an entry per 16-code block
    and one for the record count."""
    tiles, tile, index = vq_cuda.stats_tile_plan(n, k)
    assert tile == vq_cuda.STATS_TILE and tiles * tile >= n > (tiles - 1) * tile
    assert (index - 1) * vq_cuda.STATS_MERGE_CODES >= k > (index - 2) * vq_cuda.STATS_MERGE_CODES
    owner = np.arange(n) // tile
    assert np.array_equal(np.bincount(owner, minlength=tiles), np.minimum(
        tile, n - np.arange(tiles) * tile))
    codes = np.arange(n, dtype=np.int32) % k
    records = [np.unique(codes[i * tile:(i + 1) * tile]).size for i in range(tiles)]
    assert all(r <= tile for r in records) and sum(records) >= min(n, 1)


# ---- kernel #4's arithmetic, emulated -----------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernel rounds it (cvt.rna.tf32, the 13 low
    bits cleared): to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _smaller(d, i, od, oi):
    """(d, i) or (od, oi), whichever is lexicographically smaller."""
    take = (od < d) | ((od == d) & (oi < i))
    return torch.where(take, od, d), torch.where(take, oi, i)


def emulate_search_distances(z: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """The (N, K) distances |E|^2 + (-2E).z as kernel #4 computes them: z and
    -2E zero-padded to DP columns and split into TF32 halves, |E|^2 in fp32
    FMAs in column order, then z_small.E_big, z_big.E_small and z_big.E_big
    over the k8 steps added to it, each product exact in fp32 and each add
    rounded to fp32."""
    d = z.shape[1]
    dp = vq_cuda.padded_dim(d)
    zp, ep = F.pad(z, (0, dp - d)), F.pad(-2.0 * cb, (0, dp - d))
    z_big, e_big = _tf32(zp), _tf32(ep)
    z_small, e_small = _tf32(zp - z_big), _tf32(ep - e_big)
    for x, big, small in ((zp, z_big, z_small), (ep, e_big, e_small)):
        assert bool(((x - big - small).abs() <= 2.0 ** -22 * x.abs()).all())
    esq = torch.zeros(cb.shape[0], dtype=torch.float32)
    for c in range(d):  # fmaf(v, v, s): one rounding of the exact v*v + s
        v = cb[:, c].double()
        esq = (v * v + esq.double()).float()
    acc = esq[None, :].expand(z.shape[0], -1).clone()
    for a, b in ((z_small, e_big), (z_big, e_small), (z_big, e_big)):
        for i in range(dp):
            acc = acc + a[:, i:i + 1] * b[None, :, i]
    return acc


def emulate_search(z: torch.Tensor, cb: torch.Tensor, num_sms: int = 132) -> torch.Tensor:
    """Kernel #4's codes from the emulated distances, by its tie rule: per
    codebook split (``nearest_launch_geometry``), lane t of a row visits
    columns 8j + 2t and 8j + 2t + 1 in ascending order and keeps a strictly
    smaller distance, starting from (inf, the split's first code); the four
    lanes merge lexicographically (xor 1, then xor 2), then the splits in
    order."""
    n, d = z.shape
    k = cb.shape[0]
    dist = emulate_search_distances(z, cb)
    splits, per = vq_cuda.nearest_launch_geometry(n, k, d, num_sms)
    best, best_k = None, None
    for sp in range(splits):
        k0, k1 = sp * per, min(k, (sp + 1) * per)
        width = -(-(k1 - k0) // 8) * 8
        part = F.pad(dist[:, k0:k1], (0, width - (k1 - k0)), value=float("inf"))
        cols = torch.arange(k0, k0 + width)
        # (n, lane t, the lane's columns in visiting order)
        lanes = part.view(n, -1, 4, 2).permute(0, 2, 1, 3).reshape(n, 4, -1)
        lane_cols = cols.view(-1, 4, 2).permute(1, 0, 2).reshape(4, -1)
        pos = lanes.argmin(-1)  # the first of equal minima: strictly smaller replaces
        lane_d = lanes.gather(-1, pos[..., None])[..., 0]
        lane_k = torch.where(lane_d < float("inf"), lane_cols[torch.arange(4), pos],
                             torch.full_like(pos, k0))
        for off in (1, 2):
            partner = torch.arange(4) ^ off
            lane_d, lane_k = _smaller(lane_d, lane_k, lane_d[:, partner], lane_k[:, partner])
        assert bool((lane_d == lane_d[:, :1]).all()) and bool((lane_k == lane_k[:, :1]).all())
        if best is None:
            best, best_k = lane_d[:, 0], lane_k[:, 0]
        else:
            best, best_k = _smaller(best, best_k, lane_d[:, 0], lane_k[:, 0])
    # the merges keep the first index among the exact minima
    first = dist.argmin(-1)
    assert torch.equal(best_k, first), (best_k != first).sum()
    return best_k.to(torch.int32)


SEARCH_CASES = [(700, 256, 16, "xla"), (700, 256, 16, "pallas"), (512, 2048, 8, "pallas"),
                (64, 32, 4, "xla"), (5, 3, 20, "xla"), (300, 1, 16, "xla"),
                (1000, 384, 64, "pallas"), (4096, 2048, 16, "xla")]


@pytest.mark.parametrize("n,k,d,impl", SEARCH_CASES,
                         ids=[f"n{n}-k{k}-d{d}-{i}" for n, k, d, i in SEARCH_CASES])
def test_search_emulation_matches_plain_and_jax(n, k, d, impl):
    """The kernel's three-product TF32 search picks codes within
    distance_gap's fp32 bound of the plain search and of the JAX search
    (XLA, or the Pallas kernel in interpret mode); the (4096, 2048) case
    runs 16 codebook splits at 132 SMs."""
    z, cb = _data(n, k, d, seed=n + k + d)
    got = emulate_search(torch.from_numpy(z), torch.from_numpy(cb))
    assert got.dtype == torch.int32 and got.shape == (n,) and int(got.max()) < k
    plain = nearest_codes_plain(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    assert_codes_by_distance(z, cb, got.numpy(), plain)
    ref = np.asarray(jax_nearest_codes(jnp.asarray(z), jnp.asarray(cb), impl=impl))
    assert_codes_by_distance(z, cb, got.numpy(), ref)


def _near_tie_codebook(k, d, seed):
    """k // 2 random codes, each followed by a twin that differs in the last
    one or two mantissa bits of every column."""
    rng = np.random.RandomState(seed)
    base = rng.randn(k // 2, d).astype(np.float32)
    bits = base.view(np.int32) + rng.choice([-2, -1, 1, 2], size=base.shape).astype(np.int32)
    return np.stack([base, bits.view(np.float32)], 1).reshape(k, d)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("n,k,d", [(2000, 512, 16), (600, 256, 4), (500, 128, 64)])
def test_search_emulation_near_tie_codebook(n, k, d, impl):
    """Twin codes a few ulps apart: which twin wins is rounding, but the
    chosen code is within distance_gap's bound and of the plain and JAX
    searches' pair."""
    cb = _near_tie_codebook(k, d, seed=k + d)
    z = np.random.RandomState(n).randn(n, d).astype(np.float32)
    got = emulate_search(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    plain = nearest_codes_plain(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    ref = np.asarray(jax_nearest_codes(jnp.asarray(z), jnp.asarray(cb), impl=impl))
    for other in (plain, ref):
        gap, tol = distance_gap(z, cb, got, other)
        assert (np.abs(gap) <= tol).all(), (np.abs(gap).max(), tol[np.abs(gap).argmax()])
        assert (got // 2 == other // 2).mean() >= 0.99


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("n,k,d", [(3000, 256, 4), (1000, 4096, 16)])
def test_search_emulation_duplicated_codebook_first_copy_wins(n, k, d, impl):
    """Every code twice, the copies in other n8 tiles, shared-memory tiles
    and splits: an exact copy computes the same distance, and the first copy
    wins, exactly as the plain and JAX searches pick."""
    z, base = _data(n, k // 2, d, seed=7)
    cb = np.concatenate([base, base])
    got = emulate_search(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    assert got.max() < k // 2
    np.testing.assert_array_equal(
        got, nearest_codes_plain(torch.from_numpy(z), torch.from_numpy(cb)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jax_nearest_codes(jnp.asarray(z), jnp.asarray(cb), impl=impl)))


# ---- kernel #5's orders, emulated ----------------------------------------


def emulate_stats(codes: np.ndarray, z: np.ndarray, k: int, with_sums: bool):
    """Kernel #5 in numpy, in its orders: per tile of ``stats_tile_plan``,
    the in-range codes sorted by (code, index in tile), one record per run
    of equal codes (its count and its z rows summed in token order, fp32),
    and the index of each 16-code block's first record; then per block of
    16 codes, each tile's window of records from the index, added to its
    codes in tile order. Returns (counts fp32 (K,), sums fp32 (K, D) or
    None)."""
    n, d = z.shape
    tiles, tile, index = vq_cuda.stats_tile_plan(n, k)
    width = vq_cuda.STATS_MERGE_CODES
    records = []
    for ti in range(tiles):
        c = codes[ti * tile:(ti + 1) * tile].astype(np.int64)
        zt = z[ti * tile:(ti + 1) * tile]
        valid = (c >= 0) & (c < k)
        order = np.argsort(np.where(valid, c, k), kind="stable")[:int(valid.sum())]
        run_codes = c[order]
        starts = np.flatnonzero(np.r_[True, run_codes[1:] != run_codes[:-1]]) if order.size \
            else np.zeros(0, np.int64)
        ends = np.r_[starts[1:], order.size].astype(np.int64)
        rec_code, rec_count = run_codes[starts], ends - starts
        assert rec_code.size <= tile and (np.diff(rec_code) > 0).all()
        first = np.searchsorted(rec_code, np.arange(index) * width)  # lower bounds
        acc = np.zeros((rec_code.size, d), np.float32)
        for j in range(int(rec_count.max(initial=0))):  # in token order
            live = rec_count > j
            acc[live] += zt[order[starts[live] + j]]
        records.append((rec_code, rec_count, acc, first))
    counts = np.zeros(k, np.int64)
    sums = np.zeros((k, d), np.float32)
    for b in range(index - 1):
        for rec_code, rec_count, acc, first in records:  # in tile order
            window = slice(first[b], first[b + 1])
            assert len(rec_code[window]) <= width
            assert ((rec_code[window] >= b * width) & (rec_code[window] < (b + 1) * width)).all()
            counts[rec_code[window]] += rec_count[window]  # distinct codes in a window
            sums[rec_code[window]] += acc[window]
    return counts.astype(np.float32), (sums if with_sums else None)


def _stats_codes(kind, n, k, seed):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.randint(0, k, n).astype(np.int32)
    if kind == "zipf":  # a few codes take most tokens
        return np.minimum(rng.zipf(1.3, n) - 1, k - 1).astype(np.int32)
    if kind == "collapsed":
        return np.full(n, k - 1, np.int32)
    assert kind == "out of range"  # counted nowhere
    c = rng.randint(0, k, n).astype(np.int32)
    c[::7], c[3::11], c[5::13] = -1, k, 10 * k
    return c


STATS_CASES = [("random", 700, 256, 16, "pallas"), ("random", 2600, 384, 8, "xla"),
               ("zipf", 2000, 512, 8, "pallas"), ("zipf", 3000, 64, 64, "xla"),
               ("collapsed", 1000, 128, 16, "pallas"), ("collapsed", 600, 1, 4, "xla"),
               ("random", 0, 8, 4, "xla"), ("random", 300, 1, 16, "xla"),
               ("out of range", 900, 128, 16, "pallas"), ("out of range", 300, 32, 4, "xla")]


@pytest.mark.parametrize("with_sums", [False, True], ids=["counts", "sums"])
@pytest.mark.parametrize("kind,n,k,d,impl", STATS_CASES,
                         ids=[f"{c.replace(' ', '_')}-n{n}-k{k}-d{d}-{i}"
                              for c, n, k, d, i in STATS_CASES])
def test_stats_emulation_matches_plain_and_jax(kind, n, k, d, impl, with_sums):
    """Counts exact; sums within 2·(m − 1)·2^-24 of Σ|terms| of the plain
    version (on the in-range tokens) and of the JAX statistics."""
    z, _ = _data(n, 1, d, seed=n + d)
    codes = _stats_codes(kind, n, k, seed=k)
    counts, sums = emulate_stats(codes, z, k, with_sums)
    keep = (codes >= 0) & (codes < k)
    p_counts, p_sums = code_stats_plain(torch.from_numpy(codes[keep]),
                                        torch.from_numpy(z[keep]), k, with_sums)
    j_counts, j_sums = jax_code_stats(jnp.asarray(codes), jnp.asarray(z), k,
                                      with_sums=with_sums, impl=impl)
    np.testing.assert_array_equal(counts, p_counts.numpy())
    np.testing.assert_array_equal(counts, np.asarray(j_counts))
    assert counts.sum() == keep.sum()
    if not with_sums:
        assert sums is None
        return
    bound = _sum_bound(codes[keep], z[keep], k)
    for ref in (p_sums.numpy(), np.asarray(j_sums)):
        err = np.abs(sums.astype(np.float64) - ref.astype(np.float64))
        assert (err <= bound).all(), err.max()
    assert (sums[counts == 0] == 0).all()
