// The vector-quantizer's nearest-code search and per-code statistics, for
// Hopper (sm_90a): kernels #4 and #5 of the port.
//
// Replaces the Pallas TPU kernels of vqgan_tpu/ops/pallas/vq.py:
//   _nearest_codes_pallas (_nearest_kernel): codes[n] = argmin_k dist(n, k)
//   _code_stats_pallas (_stats_kernel): counts[k], and sums[k][:] on request
// Both hold the whole codebook in VMEM and sweep it on the MXU, the search
// with a running (min, argmin), the statistics as a mask^T @ z contraction.
// Neither kernel here writes the (N, K) distance matrix or one-hot that a
// library formulation does (512 MB in fp32 at N = 8192 tokens, K = 16384
// codes).
//
// Nearest-code search: dist(n, k) = |E_k|^2 + (-2 E_k) . z_n, the Pallas
// kernel's formula (|z_n|^2 is dropped: the argmin does not depend on it),
// on the tensor cores. Three launches on the caller's stream:
//
//   vq_split_codebook_kernel  splits the codebook once per call: -2E (exact:
//                     a power of two) into two TF32 halves, zero-padded to DP
//                     = 8, 16, 32 or 64 columns and to a whole 8-code mma
//                     tile, in the order the search's lanes read them (one
//                     16-byte load a lane per 128 floats: no bank conflict),
//                     and |E|^2 in fp32 FMAs in column order.
//   vq_search_kernel  grid (ceil(N / block tokens), splits), 8 warps. A warp
//                     owns MT m-tiles of 16 tokens (MT = 4 at D <= 16, 2 at
//                     D <= 32, 1 at D <= 64); their z rows, zero-padded to DP
//                     columns (the padding adds exact zeros), are split once
//                     into TF32 A fragments of mma.sync.m16n8k8 and stay in
//                     registers. A block owns one contiguous range of the
//                     codebook and streams its split halves and |E|^2 in tiles
//                     of 4096 / DP codes through a 3-stage ring of 16-byte
//                     cp.async copies, one __syncthreads a tile. A thread
//                     keeps, for each of its two rows of each m-tile, a
//                     running (distance, index) on the accumulators, and
//                     replaces it only on a strictly smaller distance while it
//                     visits its columns in ascending order. The 4 lanes of a
//                     row then merge by (distance, index) compared
//                     lexicographically, so the smaller index wins an equal
//                     distance. With one split the warp writes the codes; else
//                     its range's (distance, index) to part_dist / part_idx.
//   vq_merge_kernel   only when splits > 1: a warp per token folds the
//                     splits, again lexicographically. The result is the first
//                     index among the exact minima, bitwise the same from run
//                     to run.
// The ragged token edge and the ragged codebook range are masked in the
// kernel: any N, any K >= 1, D <= 64.
//
// Precision: fp32-accurate by three TF32 products. Each operand x is split
// as big = cvt.rna.tf32(x), small = cvt.rna.tf32(x - big) (x - big is exact
// in fp32); |x - big - small| <= 2^-11 |x - big| <= 2^-22 |x|. The dot is
// z_small.E_big + z_big.E_small + z_big.E_big, the small products first
// (CUTLASS's OpMultiplyAddFastF32 order), into fp32 accumulators that start
// at |E|^2; each product of two TF32 halves (11 x 11 significant bits) is
// exact in fp32. Against tests/torch_parity.py::distance_gap, whose check
// allows each distance 2(D + 2) u (|z|^2 + |E|^2), u = 2^-24:
//   - the split drops z_s E_s and the two residuals: at most 3 * 2^-22 =
//     12 u of each |z_i (2 E_i)|, so 12 u * 2 sum|z_i E_i| <= 12 u (|z|^2 +
//     |E|^2): a third of the allowance at D = 16, half at D = 8, all of it
//     at D = 4;
//   - |E|^2 in D fp32 FMAs: at most D u |E|^2, as in the plain search;
//   - the accumulation: 3 * DP / 8 mma steps, each adding to a running sum
//     of magnitude at most |E|^2 + 2 sum|z_i E_i| <= 2 |E|^2 + |z|^2. Hopper
//     does not promise that an mma rounds its fp32 sum to nearest (published
//     measurements of earlier tensor cores show truncation after aligning to
//     the largest term), so no a priori bound is claimed for this part: at
//     one ulp a step it is 6 * 2 u (2 |E|^2 + |z|^2) at D = 16 and the
//     three parts could reach the allowance in the worst alignment.
// The card decides: chip_smoke.py phase 9 and tests/test_torch_cuda.py hold
// every chosen code within distance_gap's unchanged bound of the plain
// search's code, near-tie codebooks included, and an exact duplicate of a
// code computes bitwise the same distance, so the first copy wins.
//
// Bound: operations. 2*N*K*D flops (4.3 GFLOP at the flagship shapes) are one
// fp32 product: 0.064 ms at 67 TFLOP/s on the CUDA cores. The three TF32
// products are 3*2*N*K*D operations at 495 TFLOP/s: 0.026 ms. Beside them the
// epilogue spends a compare and two selects on each of the N*K distances
// (134 M at the flagship), on the same issue slots as the mma. The bytes (z,
// the codebook, the codes) are ~1.6 MB. The splits exist so that a small N
// still fills one wave of the 132 SMs (two blocks an SM: ~100 KB of shared
// memory each); each block reads its range of the split codebook (2.2 MB in
// all at the flagship shapes) from L2 once per 512 tokens at D = 16.
//
// Code statistics: a group-by-code in O(N), two launches, no atomics.
//
//   vq_tile_records_kernel  one block of 256 threads per tile of 256 tokens.
//                           It sorts the keys (code, index in tile) in
//                           registers and shared memory (bitonic: shuffles
//                           for strides < 32, shared memory above); the keys
//                           are unique, so the order cannot depend on the
//                           sort. A code outside [0, K) sorts last and is
//                           counted nowhere. The runs of equal codes become
//                           the tile's records, sorted by code: (code, count)
//                           and, with sums, the run's z rows summed in token
//                           order, one thread per (run, column), from a copy
//                           of the tile's z rows in shared memory (cp.async,
//                           overlapping the sort). Last, an index: for each
//                           block of 16 codes, the tile's first record of a
//                           code in or past it.
//   vq_code_merge_kernel    one block per 16 codes, a thread per (code,
//                           column). For each chunk of 32 tiles it reads each
//                           tile's records of its codes from the index (at
//                           most 16: a tile holds a code once), files them in
//                           a slot table (tile, code) -> record, and a warp's
//                           ballot turns each code's column of the table into
//                           a bit mask of the tiles that hold it. A thread
//                           then visits those tiles in order, eight at a time
//                           with their loads in flight, and adds the count and
//                           its column of the sum. It writes every code's
//                           count and sum, zeros where no tile holds it, so
//                           nothing is cleared beforehand.
// Every sum runs in token order within a tile and in tile order across
// tiles: bitwise repeatable; a sum of m rows is still off by at most (m - 1)
// u of sum|terms| in any order. Work: O(N log 256) for the records, O(N + K
// * tiles / 16) for the merge. A collapsed codebook (every token on one
// code) costs one 256-long chain per column per tile, then one chain of
// `tiles` adds. Bound: bytes. The function moves ~1.7 MB (codes, z, counts
// and sums), about 0.5 us at 3.35 TB/s; two dependent launches, the sort's
// barriers and the merge's rounds of loads set the time.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"  // cp.async

namespace {

constexpr int kSearchWarps = 8;
constexpr int kSearchThreads = 32 * kSearchWarps;
constexpr int kSearchTileFloats = 4096;  // codebook floats a tile: 4096 / DP codes
constexpr int kSearchStages = 3;         // tiles in the cp.async ring
constexpr int kSplitThreads = 256;
constexpr int kSplitMergeThreads = 256;  // 8 tokens a block, a warp each
constexpr int kStatsTile = 256;          // tokens per tile of the statistics
constexpr int kMergeCodes = 16;          // codes per block of the statistics' merge
constexpr int kMergeChunk = 32;          // tiles whose records a merge block stages at once
constexpr int kMergeBatch = 8;           // tiles whose loads a merge thread has in flight

template <int DP>
struct SearchShape {
  static constexpr int kSteps = DP / 8;  // k8 steps of one dot product
  static constexpr int kMTiles = DP <= 16 ? 4 : (DP == 32 ? 2 : 1);
  static constexpr int kBlockTokens = kSearchWarps * kMTiles * 16;
  static constexpr int kTileCodes = kSearchTileFloats / DP;
  static constexpr int kLaneFloats = DP / 2;  // B floats a lane reads per n8 tile
  static constexpr int kSplitFloats = kTileCodes * 2 * DP;      // a tile's split codes
  static constexpr int kStageFloats = kSplitFloats + kTileCodes;  // and their |E|^2
  static constexpr size_t kSmemBytes =
      static_cast<size_t>(kSearchStages * kStageFloats) * sizeof(float);
};

// x rounded to TF32 (10 stored mantissa bits, to nearest, ties away from
// zero), as an fp32 value with the 13 low bits clear.
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// d = a * b + c on a 16 x 8 x 8 tile, TF32 operands, fp32 accumulators.
// Fragments (PTX ISA), lane = 4*g + t: A a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); B b0 (k = t, n = g), b1 (t+4, g); C/D c0 (g, 2t), c1
// (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], float b0,
                                         float b1, float c0, float c1, float c2, float c3) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)), "f"(c0), "f"(c1), "f"(c2), "f"(c3));
}

// (d, i) replaces (best, best_i) when it is lexicographically smaller.
__device__ __forceinline__ void take_smaller(float& best, int& best_i, float d, int i) {
  if (d < best || (d == best && i < best_i)) {
    best = d;
    best_i = i;
  }
}

// Offset, in a codebook split into n8 tiles, of code r's column c: big half
// (small = false) or small half. Code r = 8j + g and column c = t + 4q go to
// lane 4g + t of n8 tile j, floats q (big) and DP/4 + q (small) of the
// lane's DP/2, stored as 16-byte chunks: chunk v of every lane, then chunk
// v + 1. A warp reads a tile with one 16-byte load a lane per chunk.
template <int DP>
__device__ __forceinline__ int split_offset(int r, int c, bool small) {
  const int f = (small ? DP / 4 : 0) + (c >> 2);
  return (r >> 3) * (16 * DP) + (f >> 2) * 128 + ((r & 7) * 4 + (c & 3)) * 4 + (f & 3);
}

// The codebook split once per call: -2E into TF32 halves in the search's tile
// layout (split_offset), padded with zeros to DP columns and to a whole n8
// tile of codes, and |E|^2 in fp32 FMAs in column order. One thread per
// (code, padded column).
template <int DP>
__global__ void __launch_bounds__(kSplitThreads)
    vq_split_codebook_kernel(const float* __restrict__ cb, float* __restrict__ split,
                             float* __restrict__ esq, int K, int D) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kSplitThreads + threadIdx.x;
  const int r = static_cast<int>(i / DP), c = static_cast<int>(i % DP);
  if (r >= (K + 7) / 8 * 8) return;
  const float x = r < K && c < D ? -2.f * cb[static_cast<int64_t>(r) * D + c] : 0.f;  // exact
  const float big = tf32_round(x);
  split[split_offset<DP>(r, c, false)] = big;
  split[split_offset<DP>(r, c, true)] = tf32_round(x - big);
  if (c == 0) {
    float s = 0.f;
    for (int d = 0; r < K && d < D; ++d) {
      const float v = cb[static_cast<int64_t>(r) * D + d];
      s = fmaf(v, v, s);
    }
    esq[r] = s;
  }
}

template <int DP>
__global__ void __launch_bounds__(kSearchThreads, 2)
    vq_search_kernel(const float* __restrict__ z, const float* __restrict__ split,
                     const float* __restrict__ esq, float* __restrict__ part_dist,
                     int* __restrict__ part_idx, int* __restrict__ codes, int N, int K, int D,
                     int codes_per_split) {
  using S = SearchShape<DP>;
  constexpr int KS = S::kSteps, MT = S::kMTiles, TK = S::kTileCodes, LF = S::kLaneFloats;
  extern __shared__ float4 search_smem[];
  float* ring = reinterpret_cast<float*>(search_smem);  // [stage][split codes, |E|^2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k_begin = blockIdx.y * codes_per_split;  // a multiple of 8
  const int k_end = min(K, k_begin + codes_per_split);
  const int n_tiles = (k_end - k_begin + TK - 1) / TK;
  const int tok0 = blockIdx.x * S::kBlockTokens + warp * MT * 16;
  const bool active = tok0 < N;  // warp-uniform

  auto tile_count = [&](int i) { return min(TK, k_end - (k_begin + i * TK)); };
  // tile i's whole n8 tiles of split codes and their |E|^2, 16 bytes a copy
  auto copy_tile = [&](int i) {
    if (i < n_tiles) {
      const int k0 = k_begin + i * TK, codes8 = (tile_count(i) + 7) / 8 * 8;
      float* dst = ring + (i % kSearchStages) * S::kStageFloats;
      const float* src = split + static_cast<int64_t>(k0 / 8) * (16 * DP);
      const int split_chunks = codes8 * 2 * DP / 4;
      for (int v = tid; v < split_chunks + codes8 / 4; v += kSearchThreads) {
        const bool e = v >= split_chunks;
        cp_async16(smem_addr(e ? dst + S::kSplitFloats + (v - split_chunks) * 4 : dst + v * 4),
                   e ? esq + k0 + (v - split_chunks) * 4 : src + v * 4, 16);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kSearchStages - 1; ++i) copy_tile(i);

  // the warp's z rows, split into TF32 A fragments once
  uint32_t a_big[MT][KS][4], a_small[MT][KS][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = tok0 + 16 * m + g;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int c0 = 8 * s + t;
      const int rows[4] = {r0, r0 + 8, r0, r0 + 8};
      const int cols[4] = {c0, c0, c0 + 4, c0 + 4};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float x = (rows[u] < N && cols[u] < D)
                            ? z[static_cast<int64_t>(rows[u]) * D + cols[u]] : 0.f;
        const float big = tf32_round(x);
        a_big[m][s][u] = __float_as_uint(big);
        a_small[m][s][u] = __float_as_uint(tf32_round(x - big));
      }
    }
  }
  float best[MT][2];
  int best_k[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    best[m][0] = best[m][1] = INFINITY;
    best_k[m][0] = best_k[m][1] = k_begin;
  }

  // one n8 tile of codes against the warp's m-tiles; `limit` masks the
  // columns past the range's end (masked only)
  auto sweep_n8 = [&](const float* tile, const float* es, int col, auto masked, int limit) {
    float bf[LF];  // big halves at q, small halves at DP/4 + q
#pragma unroll
    for (int v = 0; v < LF / 4; ++v) {
      const float4 x = *reinterpret_cast<const float4*>(tile + v * 128);
      bf[4 * v] = x.x;
      bf[4 * v + 1] = x.y;
      bf[4 * v + 2] = x.z;
      bf[4 * v + 3] = x.w;
    }
    const float2 e = *reinterpret_cast<const float2*>(es);
    float acc[MT][4];
    // z_small . E_big, z_big . E_small, then z_big . E_big, each over the k8
    // steps (product p: step p % KS); the first starts from |E|^2
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      mma_tf32(acc[m], a_small[m][0], bf[0], bf[1], e.x, e.y, e.x, e.y);
    }
#pragma unroll
    for (int p = 1; p < 3 * KS; ++p) {
      const int s = p % KS, q = (p < KS || p >= 2 * KS ? 0 : DP / 4) + 2 * s;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_tf32(acc[m], p < KS ? a_small[m][s] : a_big[m][s], bf[q], bf[q + 1], acc[m][0],
                 acc[m][1], acc[m][2], acc[m][3]);
      }
    }
    const bool ok0 = !decltype(masked)::value || 2 * t < limit;
    const bool ok1 = !decltype(masked)::value || 2 * t + 1 < limit;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        if (ok0 && acc[m][2 * h] < best[m][h]) {
          best[m][h] = acc[m][2 * h];
          best_k[m][h] = col;
        }
        if (ok1 && acc[m][2 * h + 1] < best[m][h]) {
          best[m][h] = acc[m][2 * h + 1];
          best_k[m][h] = col + 1;
        }
      }
    }
  };

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kSearchStages - 2>();
    __syncthreads();  // tile i landed; the stage tile i + 2 takes is consumed
    copy_tile(i + kSearchStages - 1);
    if (active) {
      const int k0 = k_begin + i * TK;
      const int count = tile_count(i);
      const float* stage = ring + (i % kSearchStages) * S::kStageFloats;
      const float* tile = stage + lane * 4;
      const float* es = stage + S::kSplitFloats + 2 * t;
      const int full = count >> 3;
#pragma unroll 1
      for (int j = 0; j < full; ++j) {
        sweep_n8(tile + j * 16 * DP, es + 8 * j, k0 + 8 * j + 2 * t, std::false_type{}, 8);
      }
      if (count & 7) {
        sweep_n8(tile + full * 16 * DP, es + 8 * full, k0 + 8 * full + 2 * t,
                 std::true_type{}, count & 7);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float b = best[m][h];
      int bk = best_k[m][h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
        take_smaller(b, bk, __shfl_xor_sync(0xffffffffu, b, off),
                     __shfl_xor_sync(0xffffffffu, bk, off));
      }
      const int n = tok0 + 16 * m + 8 * h + g;
      if (t == 0 && n < N) {
        if (gridDim.y == 1) {
          codes[n] = bk;
        } else {
          part_dist[static_cast<int64_t>(blockIdx.y) * N + n] = b;
          part_idx[static_cast<int64_t>(blockIdx.y) * N + n] = bk;
        }
      }
    }
  }
}

// One warp a token: lane l takes splits l, l + 32, ...; the lanes then merge
// by shuffles. A lexicographic minimum does not depend on the order.
__global__ void __launch_bounds__(kSplitMergeThreads)
    vq_merge_kernel(const float* __restrict__ part_dist, const int* __restrict__ part_idx,
                    int* __restrict__ codes, int N, int splits) {
  const int n = (blockIdx.x * kSplitMergeThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (n >= N) return;  // warp-uniform
  float best = INFINITY;
  int best_k = INT_MAX;  // loses to every split's (distance, index)
  for (int s = lane; s < splits; s += 32) {
    take_smaller(best, best_k, part_dist[static_cast<int64_t>(s) * N + n],
                 part_idx[static_cast<int64_t>(s) * N + n]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    take_smaller(best, best_k, __shfl_xor_sync(0xffffffffu, best, off),
                 __shfl_xor_sync(0xffffffffu, best_k, off));
  }
  if (lane == 0) codes[n] = best_k;
}

template <bool kSums>
__global__ void __launch_bounds__(kStatsTile)
    vq_tile_records_kernel(const int* __restrict__ codes, const float* __restrict__ z,
                           int* __restrict__ rec_code, int* __restrict__ rec_count,
                           float* __restrict__ rec_sum, int* __restrict__ rec_first, int N,
                           int K, int D) {
  using Key = unsigned long long;
  __shared__ Key keys[kStatsTile];
  __shared__ int run_start[kStatsTile + 1], run_code[kStatsTile];
  __shared__ int warp_runs[kStatsTile / 32], warp_valid[kStatsTile / 32];
  extern __shared__ float4 records_smem[];
  float* zt = reinterpret_cast<float*>(records_smem);  // [kStatsTile][D], with sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kStatsTile;
  const int m = min(kStatsTile, N - n0);
  if (kSums) {  // the tile's z rows land while the keys sort
    const float* src = z + static_cast<int64_t>(n0) * D;
    for (int e = tid; e < m * D; e += kStatsTile) cp_async4(smem_addr(zt + e), src + e, 4);
    cp_async_commit();
  }
  const int c = tid < m ? codes[n0 + tid] : -1;
  const bool valid = static_cast<unsigned>(c) < static_cast<unsigned>(K);
  Key key = (static_cast<Key>(valid ? static_cast<unsigned>(c) : 0xffffffffu) << 32) |
            static_cast<unsigned>(tid);
  // bitonic sort, ascending: the thread at position tid keeps the smaller of
  // the pair when its half of the pair and its sequence's direction agree
  for (int size = 2; size <= kStatsTile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      Key other;
      if (stride >= 32) {
        keys[tid] = key;
        __syncthreads();
        other = keys[tid ^ stride];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(0xffffffffu, key, stride);
      }
      const bool keep_min = ((tid & stride) == 0) == ((tid & size) == 0);
      key = keep_min ? (other < key ? other : key) : (other > key ? other : key);
    }
  }
  const unsigned code = static_cast<unsigned>(key >> 32);
  const bool in_range = code != 0xffffffffu;
  keys[tid] = key;
  __syncthreads();
  const bool starts = in_range && (tid == 0 || static_cast<unsigned>(keys[tid - 1] >> 32) != code);
  const unsigned starts_mask = __ballot_sync(0xffffffffu, starts);
  const unsigned valid_mask = __ballot_sync(0xffffffffu, in_range);
  if (lane == 0) {
    warp_runs[warp] = __popc(starts_mask);
    warp_valid[warp] = __popc(valid_mask);
  }
  __syncthreads();
  int before = 0, runs = 0, in_tile = 0;
#pragma unroll
  for (int w = 0; w < kStatsTile / 32; ++w) {
    before += w < warp ? warp_runs[w] : 0;
    runs += warp_runs[w];
    in_tile += warp_valid[w];
  }
  if (starts) run_start[before + __popc(starts_mask & ((1u << lane) - 1u))] = tid;
  if (tid == 0) run_start[runs] = in_tile;  // the in-range keys sort first
  __syncthreads();
  const int64_t rec0 = static_cast<int64_t>(blockIdx.x) * kStatsTile;
  if (tid < runs) {
    run_code[tid] = static_cast<int>(keys[run_start[tid]] >> 32);
    rec_code[rec0 + tid] = run_code[tid];
    rec_count[rec0 + tid] = run_start[tid + 1] - run_start[tid];
  }
  __syncthreads();
  // the merge's index: for each block b of kMergeCodes codes, the first record
  // whose code is >= b * kMergeCodes (runs for b = the number of blocks). A
  // thread takes a contiguous range of blocks: one binary search, then a walk.
  const int blocks = (K + kMergeCodes - 1) / kMergeCodes;
  const int per_thread = blocks / kStatsTile + 1;
  const int b_begin = tid * per_thread, b_end = min(blocks + 1, b_begin + per_thread);
  if (b_begin < b_end) {
    int* first = rec_first + static_cast<int64_t>(blockIdx.x) * (blocks + 1);
    int pos = 0;
    const int64_t lo_code = static_cast<int64_t>(b_begin) * kMergeCodes;
#pragma unroll
    for (int step = kStatsTile / 2; step > 0; step >>= 1) {
      if (pos + step <= runs && run_code[pos + step - 1] < lo_code) pos += step;
    }
    for (int b = b_begin; b < b_end; ++b) {
      while (pos < runs && run_code[pos] < static_cast<int64_t>(b) * kMergeCodes) ++pos;
      first[b] = pos;
    }
  }
  if (kSums) {
    cp_async_wait<0>();
    __syncthreads();
    const int per_pass = kStatsTile / D;
    if (tid < per_pass * D) {
      const int col = tid % D;
      for (int r = tid / D; r < runs; r += per_pass) {
        float acc = 0.f;
        for (int p = run_start[r]; p < run_start[r + 1]; ++p) {
          acc += zt[static_cast<int>(keys[p] & 0xffffffffu) * D + col];  // token order
        }
        rec_sum[(rec0 + r) * D + col] = acc;
      }
    }
  }
}

// One block per kMergeCodes codes, a thread per (code, column) with sums
// (kMergeCodes * D threads, at least a warp), per code without. For each
// chunk of 32 tiles the block reads, from the index, each tile's window of
// records of its codes (at most kMergeCodes: a tile holds a code once) and
// files them in a slot table, slot[tile][code] = record or -1; a warp's
// ballot then turns a code's column of the table into a bit mask of the
// tiles that hold it, and its threads visit those tiles in order,
// kMergeBatch at a time with their loads in flight.
template <bool kSums>
__global__ void __launch_bounds__(kMergeCodes * 64)
    vq_code_merge_kernel(const int* __restrict__ rec_code, const int* __restrict__ rec_count,
                         const float* __restrict__ rec_sum, const int* __restrict__ rec_first,
                         float* __restrict__ counts, float* __restrict__ sums, int K, int D,
                         int tiles) {
  __shared__ int lo_s[kMergeChunk], n_s[kMergeChunk];
  __shared__ int slot[kMergeChunk * kMergeCodes];
  __shared__ unsigned hit_mask[kMergeCodes];
  const int cols = kSums ? D : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const int blocks = (K + kMergeCodes - 1) / kMergeCodes;
  const int k0 = blockIdx.x * kMergeCodes;
  const int c = tid / cols, col = tid % cols, k = k0 + c;
  const bool owner = c < kMergeCodes && k < K;
  int count = 0;
  float acc = 0.f;
  for (int t0 = 0; t0 < tiles; t0 += kMergeChunk) {
    const int nt = min(kMergeChunk, tiles - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < nt; i += threads) {
      const int* first = rec_first + static_cast<int64_t>(t0 + i) * (blocks + 1) + blockIdx.x;
      lo_s[i] = first[0];
      n_s[i] = first[1] - first[0];
    }
    for (int i = tid; i < nt * kMergeCodes; i += threads) slot[i] = -1;
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < nt * kMergeCodes; i += threads) {
      const int t = i / kMergeCodes, j = i % kMergeCodes;
      if (j < n_s[t]) {
        const int r = lo_s[t] + j;
        slot[t * kMergeCodes + rec_code[static_cast<int64_t>(t0 + t) * kStatsTile + r] - k0] = r;
      }
    }
    __syncthreads();
    for (int cc = warp; cc < kMergeCodes; cc += warps) {
      const bool held = lane < nt && slot[lane * kMergeCodes + cc] >= 0;
      const unsigned bits = __ballot_sync(0xffffffffu, held);
      if (lane == 0) hit_mask[cc] = bits;
    }
    __syncthreads();
    if (!owner) continue;
    unsigned bits = hit_mask[c];
    while (bits) {
      int64_t rec[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {  // the next tiles that hold code k, in order
        rec[u] = -1;
        if (bits) {
          const int t = __ffs(bits) - 1;
          bits &= bits - 1;
          rec[u] = static_cast<int64_t>(t0 + t) * kStatsTile + slot[t * kMergeCodes + c];
        }
      }
      int n[kMergeBatch];
      float v[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {  // independent loads
        n[u] = rec[u] >= 0 && col == 0 ? __ldg(rec_count + rec[u]) : 0;
        v[u] = kSums && rec[u] >= 0 ? __ldg(rec_sum + rec[u] * D + col) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {  // in tile order
        if (rec[u] >= 0) {
          count += n[u];
          acc += v[u];
        }
      }
    }
  }
  if (!owner) return;
  if (col == 0) counts[k] = static_cast<float>(count);
  if (kSums) sums[static_cast<int64_t>(k) * D + col] = acc;
}

template <int DP>
cudaError_t launch_search(const float* z, const float* cb, float* split, float* esq,
                          float* part_dist, int* part_idx, int* codes, int N, int K, int D,
                          int splits, int codes_per_split, cudaStream_t stream) {
  using S = SearchShape<DP>;
  const int64_t split_threads = static_cast<int64_t>(K + 7) / 8 * 8 * DP;
  vq_split_codebook_kernel<DP><<<static_cast<int>((split_threads + kSplitThreads - 1) /
                                                  kSplitThreads),
                                 kSplitThreads, 0, stream>>>(cb, split, esq, K, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(vq_search_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kSmemBytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(vq_search_kernel<DP>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + S::kBlockTokens - 1) / S::kBlockTokens, splits);
  vq_search_kernel<DP><<<grid, kSearchThreads, S::kSmemBytes, stream>>>(
      z, split, esq, part_dist, part_idx, codes, N, K, D, codes_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int blocks = static_cast<int>((static_cast<int64_t>(N) * 32 + kSplitMergeThreads - 1) /
                                      kSplitMergeThreads);
  vq_merge_kernel<<<blocks, kSplitMergeThreads, 0, stream>>>(part_dist, part_idx, codes, N,
                                                            splits);
  return cudaGetLastError();
}

cudaError_t launch_stats(const int* codes, const float* z, int* rec_code, int* rec_count,
                         float* rec_sum, int* rec_first, float* counts, float* sums, int N, int K,
                         int D, int with_sums, cudaStream_t stream) {
  const int tiles = (N + kStatsTile - 1) / kStatsTile;
  cudaError_t err = cudaSuccess;
  if (tiles > 0) {
    if (with_sums) {
      const int smem = kStatsTile * D * static_cast<int>(sizeof(float));
      err = cudaFuncSetAttribute(vq_tile_records_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      vq_tile_records_kernel<true><<<tiles, kStatsTile, smem, stream>>>(
          codes, z, rec_code, rec_count, rec_sum, rec_first, N, K, D);
    } else {
      vq_tile_records_kernel<false><<<tiles, kStatsTile, 0, stream>>>(
          codes, z, rec_code, rec_count, rec_sum, rec_first, N, K, D);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int blocks = (K + kMergeCodes - 1) / kMergeCodes;
  if (with_sums) {  // whole warps: the ballots take every lane
    vq_code_merge_kernel<true><<<blocks, (kMergeCodes * D + 31) / 32 * 32, 0, stream>>>(
        rec_code, rec_count, rec_sum, rec_first, counts, sums, K, D, tiles);
  } else {
    vq_code_merge_kernel<false><<<blocks, 32, 0, stream>>>(
        rec_code, rec_count, rec_sum, rec_first, counts, sums, K, D, tiles);
  }
  return cudaGetLastError();
}

// Calls f with std::integral_constant<int, DP>, DP the padded width of a z
// row: D rounded up to 8, 16, 32 or 64 (the caller checks D <= 64).
template <typename F>
cudaError_t with_padded_dim(int D, F&& f) {
  if (D <= 8) return f(std::integral_constant<int, 8>{});
  if (D <= 16) return f(std::integral_constant<int, 16>{});
  if (D <= 32) return f(std::integral_constant<int, 32>{});
  return f(std::integral_constant<int, 64>{});
}

}  // namespace

extern "C" {

// codes[N] (int32) = nearest code of each row of z[N][D] among cb[K][D]
// (fp32, row-major, contiguous). split holds ceil(K / 8) * 16 * DP floats
// and esq ceil(K / 8) * 8 (DP = D rounded up to 8, 16, 32 or 64): the
// codebook split once per call. The codebook is cut into `splits` ranges of
// codes_per_split (a multiple of 8); with more than one, part_dist / part_idx
// hold splits * N entries. Returns a cudaError_t.
int vq_nearest_codes(const float* z, const float* cb, float* split, float* esq, float* part_dist,
                     int* part_idx, int* codes, int N, int K, int D, int splits,
                     int codes_per_split, void* stream) {
  if (N < 1 || K < 1 || D < 1 || D > 64 || splits < 1 || codes_per_split < 8 ||
      codes_per_split % 8 != 0 || static_cast<int64_t>(splits - 1) * codes_per_split >= K ||
      static_cast<int64_t>(splits) * codes_per_split < K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(with_padded_dim(D, [&](auto dp) {
    return launch_search<decltype(dp)::value>(z, cb, split, esq, part_dist, part_idx, codes, N,
                                              K, D, splits, codes_per_split,
                                              static_cast<cudaStream_t>(stream));
  }));
}

// counts[K] (fp32) and, when with_sums, sums[K][D] (fp32) over codes[N]
// (int32) and z[N][D] (fp32). With T = ceil(N / 256) tiles: rec_code and
// rec_count hold T * 256 int32 records, rec_sum as many rows of D floats
// (with sums), rec_first T * (ceil(K / 16) + 1) int32. A code outside [0, K)
// is counted nowhere. Returns a cudaError_t.
int vq_code_stats(const int* codes, const float* z, int* rec_code, int* rec_count,
                  float* rec_sum, int* rec_first, float* counts, float* sums, int N, int K,
                  int D, int with_sums, void* stream) {
  if (N < 0 || K < 1 || D < 1 || D > 64) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_stats(codes, z, rec_code, rec_count, rec_sum, rec_first,
                                       counts, sums, N, K, D, with_sums,
                                       static_cast<cudaStream_t>(stream)));
}

// The geometry the wrapper mirrors to size the workspaces (ops/vq_cuda.py):
// tokens a search block owns at width D, tokens a statistics tile holds,
// codes a block of the statistics' merge owns.
int vq_search_block_tokens(int D) {
  if (D <= 8) return SearchShape<8>::kBlockTokens;
  if (D <= 16) return SearchShape<16>::kBlockTokens;
  if (D <= 32) return SearchShape<32>::kBlockTokens;
  return SearchShape<64>::kBlockTokens;
}

int vq_stats_tile_tokens() { return kStatsTile; }

int vq_stats_merge_codes() { return kMergeCodes; }

const char* vq_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
