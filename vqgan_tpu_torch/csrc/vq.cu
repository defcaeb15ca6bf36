// The vector-quantizer's nearest-code search and per-code statistics, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vqgan_tpu/ops/pallas/vq.py:
//   _nearest_codes_pallas (_nearest_kernel): codes[n] = argmin_k dist(n, k)
//   _code_stats_pallas (_stats_kernel): counts[k], and sums[k][:] on request
// Neither writes the (N, K) distance matrix or one-hot that a library
// formulation does (512 MB in fp32 at N = 8192 tokens, K = 16384 codes).
//
// Nearest-code search: dist(n, k) = |E_k|^2 + (-2 E_k) . z_n, the Pallas
// kernel's formula (|z_n|^2 is dropped: the argmin does not depend on it),
// in fp32 FMAs on the CUDA cores. TF32 tensor cores would round z and E to
// 10 mantissa bits and move the argmin. Two launches on the caller's stream:
//
//   vq_nearest_kernel  grid (ceil(N / 256), splits). A thread owns one token,
//                      its z row in registers (zero-padded to DP = 4, 8, 16,
//                      32 or 64 columns: the padding adds exact zeros). A
//                      block owns one contiguous range of the codebook and
//                      streams it through shared memory in tiles of up to
//                      1,024 codes (64 KB at D = 16), computing each tile's
//                      |E|^2 as it lands. Every thread of a warp reads the
//                      same code at the same time, so the shared-memory reads
//                      are broadcasts. Each thread keeps a running (min,
//                      argmin) in registers and replaces it only on a strictly
//                      smaller distance, so the first index wins an exact tie.
//                      With one split it writes the codes; else its range's
//                      (min, argmin) to part_dist / part_idx [split][N].
//   vq_merge_kernel    grid (ceil(N / 256)), only when splits > 1. Folds the
//                      splits in ascending order, again on a strictly smaller
//                      distance: the first index still wins a tie.
// The ragged token edge and the ragged last tile are masked in the kernel: any
// N, any K >= 1, D <= 64.
//
// Bound: fp32 operations. 2*N*K*D flops (4.3 GFLOP at the flagship shapes)
// against 67 TFLOP/s on an H100 SXM, about 0.064 ms; the bytes (z, the
// codebook, the codes) are ~1.6 MB. The splits exist so that a small N still
// fills the 132 SMs; the codebook range of a block is read from L2 once per
// 256 tokens. A thread spends D/4 broadcast loads, one |E|^2 load, a compare
// and two selects on D FMAs; tiling several tokens per thread would cut that
// overhead and is left for later work.
//
// Code statistics: two launches.
//
//   vq_stats_kernel        grid (ceil(K / 128), splits). A thread owns one code;
//                          a block owns 128 codes and one contiguous range of
//                          tokens. It streams its range in token order through
//                          shared memory, 128 tokens a tile: their codes (read
//                          back as int4 broadcasts) and, with sums, their z rows.
//                          On a match the thread counts the token and adds its
//                          z row from shared memory into registers. That is
//                          the Pallas kernel's mask sweep without the one-hot:
//                          N*K integer compares, ~134 M at the flagship shapes.
//                          With one split it writes counts and sums; else its
//                          range's integer counts and fp32 sums as partials.
//   vq_stats_merge_kernel  only when splits > 1. Adds the partials over the
//                          splits in ascending order.
// Every sum runs in token order within a split and in split order across
// them: deterministic, no atomics. The z rows come from shared memory, so a
// code that many tokens share (a collapsing codebook sends them all to a few)
// costs ~25 cycles per token of its split, not a device-memory round trip;
// the splits cut that chain and fill the SMs. Bound: latency and launch. The
// function moves ~1.7 MB (codes, z, counts and sums), about 0.5 us at
// 3.35 TB/s; each block reads its z range again from L2 (64 MB in all at the
// flagship shapes, spread over the SMs), and the compare sweep sets the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNearestThreads = 256;
constexpr int kMaxTileCodes = 1024;
constexpr int kTileFloats = 16384;  // 64 KB of codebook per tile
constexpr int kStatsThreads = 128;
constexpr int kStatsTile = 128;  // tokens per shared-memory tile

template <int DP>
__host__ __device__ constexpr int tile_codes() {
  return kTileFloats / DP < kMaxTileCodes ? kTileFloats / DP : kMaxTileCodes;
}

template <int DP>
__global__ void __launch_bounds__(kNearestThreads)
    vq_nearest_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                      float* __restrict__ part_dist, int* __restrict__ part_idx,
                      int* __restrict__ codes, int N, int K, int D, int codes_per_split) {
  constexpr int TK = tile_codes<DP>();
  extern __shared__ float4 smem4[];
  float* e_tile = reinterpret_cast<float*>(smem4);  // [TK][DP]
  float* e_sq = e_tile + TK * DP;                   // [TK]

  const int n = blockIdx.x * kNearestThreads + threadIdx.x;
  const int split = blockIdx.y;
  const int k_begin = split * codes_per_split;
  const int k_end = min(K, k_begin + codes_per_split);

  float zr[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    zr[d] = (n < N && d < D) ? z[static_cast<int64_t>(n) * D + d] : 0.f;
  }
  if (D < DP) {  // the padding columns are never written by a tile load
    for (int i = threadIdx.x; i < TK * DP; i += kNearestThreads) e_tile[i] = 0.f;
  }

  float best = INFINITY;
  int best_k = k_begin;
  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    const int count = min(TK, k_end - k0);
    __syncthreads();  // the previous tile is consumed (and the padding zeroed)
    const float* src = cb + static_cast<int64_t>(k0) * D;
    for (int i = threadIdx.x; i < count * D; i += kNearestThreads) {
      const int r = i / D;
      e_tile[r * DP + (i - r * D)] = src[i];
    }
    __syncthreads();
    for (int r = threadIdx.x; r < count; r += kNearestThreads) {
      float s = 0.f;
      for (int c = 0; c < D; ++c) {
        const float v = e_tile[r * DP + c];
        s = fmaf(v, v, s);
      }
      e_sq[r] = s;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < count; ++r) {
      const float4* e4 = reinterpret_cast<const float4*>(e_tile + r * DP);
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < DP / 4; ++q) {
        const float4 e = e4[q];
        dot = fmaf(zr[4 * q + 0], e.x, dot);
        dot = fmaf(zr[4 * q + 1], e.y, dot);
        dot = fmaf(zr[4 * q + 2], e.z, dot);
        dot = fmaf(zr[4 * q + 3], e.w, dot);
      }
      // |E|^2 + (-2 E) . z, one rounding: -2 * dot is exact
      const float dist = fmaf(-2.f, dot, e_sq[r]);
      if (dist < best) {
        best = dist;
        best_k = k0 + r;
      }
    }
  }
  if (n < N) {
    if (gridDim.y == 1) {
      codes[n] = best_k;
    } else {
      part_dist[static_cast<int64_t>(split) * N + n] = best;
      part_idx[static_cast<int64_t>(split) * N + n] = best_k;
    }
  }
}

__global__ void vq_merge_kernel(const float* __restrict__ part_dist,
                                const int* __restrict__ part_idx, int* __restrict__ codes, int N,
                                int splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float best = part_dist[n];
  int best_k = part_idx[n];
  for (int s = 1; s < splits; ++s) {
    const float d = part_dist[static_cast<int64_t>(s) * N + n];
    if (d < best) {
      best = d;
      best_k = part_idx[static_cast<int64_t>(s) * N + n];
    }
  }
  codes[n] = best_k;
}

template <int DP, bool kSums>
__global__ void __launch_bounds__(kStatsThreads)
    vq_stats_kernel(const int* __restrict__ codes, const float* __restrict__ z,
                    int* __restrict__ part_counts, float* __restrict__ part_sums,
                    float* __restrict__ counts, float* __restrict__ sums, int N, int K, int D,
                    int tokens_per_split) {
  __shared__ int4 code4[kStatsTile / 4];
  __shared__ __align__(16) float ztile[kSums ? kStatsTile * DP : 4];  // [token][DP]
  const int k = blockIdx.x * kStatsThreads + threadIdx.x;
  const int split = blockIdx.y;
  const int n_begin = split * tokens_per_split;
  const int n_end = min(N, n_begin + tokens_per_split);

  int count = 0;
  float acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) acc[d] = 0.f;

  for (int n0 = n_begin; n0 < n_end; n0 += kStatsTile) {
    const int m = min(kStatsTile, n_end - n0);
    __syncthreads();  // the previous tile is consumed
    int* code_fill = reinterpret_cast<int*>(code4);
    for (int i = threadIdx.x; i < kStatsTile; i += kStatsThreads) {
      code_fill[i] = i < m ? codes[n0 + i] : -1;  // -1 matches no code
    }
    if (kSums) {
      const float* src = z + static_cast<int64_t>(n0) * D;
      for (int i = threadIdx.x; i < m * D; i += kStatsThreads) {
        const int r = i / D;
        ztile[r * DP + (i - r * D)] = src[i];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < kStatsTile / 4; ++q) {
      const int4 c = code4[q];
      const int cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (cs[j] == k) {
          ++count;
          if (kSums) {
            // columns D..DP-1 of the tile are never written and never stored
            const float4* row = reinterpret_cast<const float4*>(ztile + (4 * q + j) * DP);
#pragma unroll
            for (int d4 = 0; d4 < DP / 4; ++d4) {
              const float4 v = row[d4];
              acc[4 * d4 + 0] += v.x;
              acc[4 * d4 + 1] += v.y;
              acc[4 * d4 + 2] += v.z;
              acc[4 * d4 + 3] += v.w;
            }
          }
        }
      }
    }
  }
  if (k >= K) return;
  if (gridDim.y == 1) {
    counts[k] = static_cast<float>(count);
  } else {
    part_counts[static_cast<int64_t>(split) * K + k] = count;
  }
  if (kSums) {
    float* out = gridDim.y == 1 ? sums + static_cast<int64_t>(k) * D
                                : part_sums + (static_cast<int64_t>(split) * K + k) * D;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      if (d < D) out[d] = acc[d];
    }
  }
}

template <bool kSums>
__global__ void vq_stats_merge_kernel(const int* __restrict__ part_counts,
                                      const float* __restrict__ part_sums,
                                      float* __restrict__ counts, float* __restrict__ sums,
                                      int K, int D, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < K) {
    int c = 0;
    for (int s = 0; s < splits; ++s) c += part_counts[s * static_cast<int64_t>(K) + i];
    counts[i] = static_cast<float>(c);
  }
  const int64_t kd = static_cast<int64_t>(K) * D;
  if (kSums && i < kd) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s) a += part_sums[s * kd + i];
    sums[i] = a;
  }
}

template <int DP>
cudaError_t launch_nearest(const float* z, const float* cb, float* part_dist, int* part_idx,
                           int* codes, int N, int K, int D, int splits, int codes_per_split,
                           cudaStream_t stream) {
  constexpr int TK = tile_codes<DP>();
  const size_t smem = static_cast<size_t>(TK) * (DP + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      vq_nearest_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kNearestThreads - 1) / kNearestThreads, splits);
  vq_nearest_kernel<DP><<<grid, kNearestThreads, smem, stream>>>(
      z, cb, part_dist, part_idx, codes, N, K, D, codes_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  vq_merge_kernel<<<(N + 255) / 256, 256, 0, stream>>>(part_dist, part_idx, codes, N, splits);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_stats(const int* codes, const float* z, int* part_counts, float* part_sums,
                         float* counts, float* sums, int N, int K, int D, int with_sums,
                         int splits, int tokens_per_split, cudaStream_t stream) {
  const dim3 grid((K + kStatsThreads - 1) / kStatsThreads, splits);
  if (with_sums) {
    vq_stats_kernel<DP, true><<<grid, kStatsThreads, 0, stream>>>(
        codes, z, part_counts, part_sums, counts, sums, N, K, D, tokens_per_split);
  } else {
    vq_stats_kernel<DP, false><<<grid, kStatsThreads, 0, stream>>>(
        codes, z, part_counts, part_sums, counts, sums, N, K, D, tokens_per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t items = with_sums ? static_cast<int64_t>(K) * D : K;
  const int blocks = static_cast<int>((items + 255) / 256);
  if (with_sums) {
    vq_stats_merge_kernel<true><<<blocks, 256, 0, stream>>>(part_counts, part_sums, counts,
                                                            sums, K, D, splits);
  } else {
    vq_stats_merge_kernel<false><<<blocks, 256, 0, stream>>>(part_counts, part_sums, counts,
                                                             sums, K, D, splits);
  }
  return cudaGetLastError();
}

// Calls f with std::integral_constant<int, DP>, DP the register width of a
// z row: D rounded up to 4, 8, 16, 32 or 64 (the caller checks D <= 64).
template <typename F>
cudaError_t with_padded_dim(int D, F&& f) {
  if (D <= 4) return f(std::integral_constant<int, 4>{});
  if (D <= 8) return f(std::integral_constant<int, 8>{});
  if (D <= 16) return f(std::integral_constant<int, 16>{});
  if (D <= 32) return f(std::integral_constant<int, 32>{});
  return f(std::integral_constant<int, 64>{});
}

}  // namespace

extern "C" {

// codes[N] (int32) = nearest code of each row of z[N][D] among cb[K][D]
// (fp32, row-major, contiguous). part_dist / part_idx hold splits * N
// entries (unused when splits == 1). Returns a cudaError_t.
int vq_nearest_codes(const float* z, const float* cb, float* part_dist, int* part_idx,
                     int* codes, int N, int K, int D, int splits, int codes_per_split,
                     void* stream) {
  if (N < 1 || K < 1 || D < 1 || D > 64 || splits < 1 ||
      static_cast<int64_t>(splits) * codes_per_split < K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(with_padded_dim(D, [&](auto dp) {
    return launch_nearest<decltype(dp)::value>(z, cb, part_dist, part_idx, codes, N, K, D,
                                               splits, codes_per_split,
                                               static_cast<cudaStream_t>(stream));
  }));
}

// counts[K] (fp32) and, when with_sums, sums[K][D] (fp32) over codes[N]
// (int32) and z[N][D] (fp32). The tokens are cut into `splits` ranges of
// tokens_per_split; with more than one, part_counts[splits][K] (int32) and,
// with sums, part_sums[splits][K][D] (fp32) hold the partials. A code outside
// [0, K) is counted nowhere. Returns a cudaError_t.
int vq_code_stats(const int* codes, const float* z, int* part_counts, float* part_sums,
                  float* counts, float* sums, int N, int K, int D, int with_sums, int splits,
                  int tokens_per_split, void* stream) {
  if (N < 0 || K < 1 || D < 1 || D > 64 || splits < 1 || tokens_per_split < 0 ||
      static_cast<int64_t>(splits) * tokens_per_split < N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(with_padded_dim(D, [&](auto dp) {
    return launch_stats<decltype(dp)::value>(codes, z, part_counts, part_sums, counts, sums, N,
                                             K, D, with_sums, splits, tokens_per_split,
                                             static_cast<cudaStream_t>(stream));
  }));
}

const char* vq_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
