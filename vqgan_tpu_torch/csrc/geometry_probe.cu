// The conv-tile geometry probe for Hopper (sm_90a): kernel #7 of the port.
//
// Replaces the Pallas TPU probe tools/probe_mosaic_geometry.py::_run (its
// pallas_call, l.52): eight candidate dot geometries (A-H) of a fat conv
// tile, each compile-tested in a minimal kernel and held against numpy at
// rtol = atol = 2e-2. The TPU question was which of them Mosaic lowers onto
// the 128x128 MXU; the question here is which tile geometry builds for the
// H100 (nvcc/ptxas accept it), at what registers and spills, and whether it
// computes the case's function. Each case below is one __global__ that
// computes exactly the JAX case's function on the JAX case's shapes
// (ops/geometry_probe.py holds the table and the plain versions).
//
// A-G keep fp32 precision, as the JAX cases' Precision.HIGHEST does: every
// product is an fp32 FMA on the CUDA cores, every sum fp32. H is the
// prototype of kernel #6's tensor-core inner loop: bf16 mma.sync m16n8k16
// with fp32 accumulation, an implicit im2col over the 9 (dh, dw) windows of
// a halo strip in shared memory.
//
// Each case keeps its block's tile geometry; the grid spreads the same work
// over more blocks, since a case on 8-32 blocks of 132 SMs waits on the
// latency of its few warps (it lost to torch.matmul of the same product on
// every case, by device time). A, B, C and H split K across the blocks of a
// thread-block cluster, each block keeping its tile and staging for its K
// range, and sum the partial tiles in rank order through distributed shared
// memory (the fixed-order second stage). D-G split the output columns: each
// block stages the whole concatenated K tile or the whole strip, as before,
// for a quarter of the columns.
//
//   A  fat-N flat: a block owns 32 rows by all 192 columns of
//      x (256,64) @ w3 (64,192); each thread holds 1 row by 24 columns
//      (c, c+8, ..., c+184) and sums the three 64-column slices in registers;
//      the 4 blocks of a cluster take one 16-deep K chunk each.
//   B  rank-3 rhs: the same tile as three N=64 passes, one per middle index
//      of w3 (64,3,64), each loaded x value feeding all three; K as A.
//   C  multi-contraction: K=64 chunks (x9[j], w9[j]) through shared memory
//      into one accumulator; the 9 blocks of a cluster take one chunk each.
//   D  sublane concat: the two (256,64) slabs staged K-major (transposed)
//      as one K=128 A tile, sA[k][m], then (128,16) of w: 16 rows by a
//      quarter of the 64 columns a block, 1 column a thread.
//   E  lane concat: the same K=128 tile staged row-major, the two slabs side
//      by side, sA[m][k]; columns as D.
//   F  shifted windows: one (34,64) strip row of xs in shared memory, both
//      windows (columns j and j+2) read from it in place; a quarter of the
//      64 output columns a block, 2 a thread.
//   G  F with each window first copied to its own (32,64) tile; an eighth
//      of the columns a block, 1 a thread.
//   H  the full 9-window bf16 im2col of a (34,130,64) strip: a block owns
//      one output row (128 pixels by 64 channels); its three input rows and
//      the weight, for its 16 of the 64 input channels, sit in shared memory
//      as bf16; each of 8 warps owns 16 pixels by 64 channels, 8 m16n8k16
//      accumulators, and walks its K = 9*16 in 9 steps of 16 (one tap); the 4
//      blocks of a cluster take the 4 channel quarters.
//
// Bound on an H100 SXM: these are microsecond kernels. A-G move 176-512 KB
// for 6-19 MFLOP: at 67 TFLOP/s of fp32 FMA and 3.35 TB/s both bounds are
// under 0.3 us, so latency sets the pace. H moves 2.3 MB for 302 MFLOP of
// bf16: bytes bound it (0.7 us) against 0.3 us of tensor cores.
//
// Build one case alone with -DGEOMETRY_PROBE_CASE=<0..7> (the probe's entry
// point does, to say which case ptxas rejects when the whole file fails).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GEOMETRY_PROBE_CASE
#define GEOMETRY_PROBE_CASE -1  // every case
#endif
#define CASE_ON(i) (GEOMETRY_PROBE_CASE < 0 || GEOMETRY_PROBE_CASE == (i))

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int M = 256, K = 64, CO = 64;
constexpr int SH = 32, SW = 34;             // F, G: the strip; output width SW - 2
constexpr int BH = 32, WF = 128, CI = 64;   // H: output rows, width, channels
constexpr int kNotBuilt = 100000;           // error code: the case is not in this build
// blocks of a cluster that split K (A, B, C, H; 1: no cluster), and the
// column splits of D-G
constexpr int kSplit[8] = {4, 4, 9, 4, 4, 4, 8, 4};
constexpr bool kClusterK[8] = {true, true, true, false, false, false, false, true};
constexpr int kTiles[8] = {M / 32, M / 32, M / 32, M / 16, M / 16, SH, SH, BH};

// The blocks of a cluster each hold a partial of one output tile of kN
// floats in `part`; block r of the cluster writes the elements e with
// (e / kThreads) % S == r, summing the S partials in rank order. kN is a
// compile-time constant so that every read of the other blocks' shared
// memory is issued before the first one returns.
template <int S, int kN>
__device__ __forceinline__ void cluster_sum(float* part, float* __restrict__ dst) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int r = static_cast<int>(cluster.block_rank());
  constexpr int kIters = (kN + S * kThreads - 1) / (S * kThreads);
  float acc[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) acc[it] = 0.f;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const float* src = cluster.map_shared_rank(part, q);
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int e = (it * S + r) * kThreads + threadIdx.x;
      if (e < kN) acc[it] += src[e];
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = (it * S + r) * kThreads + threadIdx.x;
    if (e < kN) dst[e] = acc[it];
  }
  cluster.sync();  // no block leaves while another reads its partial
}

#if CASE_ON(0)
// A: 8 tiles of 32 rows; the cluster's 4 blocks take the 4 K chunks of 16.
__global__ void __launch_bounds__(kThreads) probe_a(const float* __restrict__ x,
                                                    const float* __restrict__ w,
                                                    float* __restrict__ out) {
  __shared__ float sx[32][17];
  __shared__ float sw[16][3 * CO];
  __shared__ float part[32 * CO];
  const int tid = threadIdx.x, row = tid >> 3, c = tid & 7;
  const int m0 = blockIdx.x / kSplit[0] * 32, k0 = blockIdx.x % kSplit[0] * 16;
  float acc[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) acc[i] = 0.f;
  for (int i = tid; i < 32 * 16; i += kThreads)
    sx[i >> 4][i & 15] = x[(m0 + (i >> 4)) * K + k0 + (i & 15)];
  for (int i = tid; i < 16 * 3 * CO; i += kThreads)
    sw[i / (3 * CO)][i % (3 * CO)] = w[(k0 + i / (3 * CO)) * 3 * CO + i % (3 * CO)];
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const float a = sx[row][kk];
#pragma unroll
    for (int i = 0; i < 24; ++i) acc[i] = fmaf(a, sw[kk][c + 8 * i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[row * CO + c + 8 * i] = acc[i] + acc[i + 8] + acc[i + 16];
  cluster_sum<kSplit[0], 32 * CO>(part, out + m0 * CO);
}
#endif

#if CASE_ON(1)
// B: 8 tiles of 32 rows, K as A; per k one x value, three passes over w3[k][p].
__global__ void __launch_bounds__(kThreads) probe_b(const float* __restrict__ x,
                                                    const float* __restrict__ w3,
                                                    float* __restrict__ out) {
  __shared__ float sx[32][17];
  __shared__ float sw[16][3][CO];
  __shared__ float part[32 * CO];
  const int tid = threadIdx.x, row = tid >> 3, c = tid & 7;
  const int m0 = blockIdx.x / kSplit[1] * 32, k0 = blockIdx.x % kSplit[1] * 16;
  float acc[3][8];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[p][i] = 0.f;
  for (int i = tid; i < 32 * 16; i += kThreads)
    sx[i >> 4][i & 15] = x[(m0 + (i >> 4)) * K + k0 + (i & 15)];
  for (int i = tid; i < 16 * 3 * CO; i += kThreads) {
    const int kk = i / (3 * CO), p = (i / CO) % 3, o = i % CO;
    sw[kk][p][o] = w3[((k0 + kk) * 3 + p) * CO + o];
  }
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const float a = sx[row][kk];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[p][i] = fmaf(a, sw[kk][p][c + 8 * i], acc[p][i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[row * CO + c + 8 * i] = acc[0][i] + acc[1][i] + acc[2][i];
  cluster_sum<kSplit[1], 32 * CO>(part, out + m0 * CO);
}
#endif

#if CASE_ON(2)
// C: 8 tiles of 32 rows; the cluster's 9 blocks take the (x9[j], w9[j]) chunks.
__global__ void __launch_bounds__(kThreads) probe_c(const float* __restrict__ x9,
                                                    const float* __restrict__ w9,
                                                    float* __restrict__ out) {
  __shared__ float sx[32][K + 1];
  __shared__ float sw[K][CO];
  __shared__ float part[32 * CO];
  const int tid = threadIdx.x, row = tid >> 3, c = tid & 7;
  const int m0 = blockIdx.x / kSplit[2] * 32, j = blockIdx.x % kSplit[2];
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int i = tid; i < 32 * K; i += kThreads)
    sx[i / K][i % K] = x9[(j * M + m0 + i / K) * K + i % K];
  for (int i = tid; i < K * CO; i += kThreads) sw[i / CO][i % CO] = w9[j * K * CO + i];
  __syncthreads();
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float a = sx[row][k];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(a, sw[k][c + 8 * i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[row * CO + c + 8 * i] = acc[i];
  cluster_sum<kSplit[2], 32 * CO>(part, out + m0 * CO);
}
#endif

#if CASE_ON(3) || CASE_ON(4)
// D and E: 16 tiles of 16 rows by a quarter of the columns; the K = 128 A
// tile of both slabs and the (128, 16) weight columns in shared memory;
// each thread 1 row by 1 column.
template <bool kKMajor>
__device__ __forceinline__ void concat_tile(const float* __restrict__ x2,
                                            const float* __restrict__ w,
                                            float* __restrict__ out) {
  constexpr int kCols = CO / 4;
  __shared__ float sa[kKMajor ? 2 * K : 16][kKMajor ? 16 + 1 : 2 * K + 1];
  __shared__ float sw[2 * K][kCols];
  const int tid = threadIdx.x, row = tid >> 4, c = tid & 15;
  const int m0 = blockIdx.x / 4 * 16, n0 = blockIdx.x % 4 * kCols;
  for (int i = tid; i < 2 * 16 * K; i += kThreads) {
    const int s = i / (16 * K), m = (i / K) % 16, k = i % K;  // slab, row, column
    const float v = x2[(s * M + m0 + m) * K + k];
    if constexpr (kKMajor) {
      sa[s * K + k][m] = v;  // (x2[0].T ; x2[1].T): (2K, 16)
    } else {
      sa[m][s * K + k] = v;  // (x2[0] | x2[1]): (16, 2K)
    }
  }
  for (int i = tid; i < 2 * K * kCols; i += kThreads)
    sw[i / kCols][i % kCols] = w[(i / kCols) * CO + n0 + i % kCols];
  __syncthreads();
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < 2 * K; ++k) {
    float a;
    if constexpr (kKMajor) {
      a = sa[k][row];
    } else {
      a = sa[row][k];
    }
    acc = fmaf(a, sw[k][c], acc);
  }
  out[(m0 + row) * CO + n0 + c] = acc;
}
#endif

#if CASE_ON(3)
__global__ void __launch_bounds__(kThreads) probe_d(const float* __restrict__ x2,
                                                    const float* __restrict__ w,
                                                    float* __restrict__ out) {
  concat_tile<true>(x2, w, out);
}
#endif

#if CASE_ON(4)
__global__ void __launch_bounds__(kThreads) probe_e(const float* __restrict__ x2,
                                                    const float* __restrict__ w,
                                                    float* __restrict__ out) {
  concat_tile<false>(x2, w, out);
}
#endif

#if CASE_ON(5)
// F: 32 strip rows by a quarter of the columns; both windows read in place.
__global__ void __launch_bounds__(kThreads) probe_f(const float* __restrict__ xs,
                                                    const float* __restrict__ w,
                                                    float* __restrict__ out) {
  constexpr int kCols = CO / 4;
  __shared__ float sx[SW][K + 1];
  __shared__ float sw[2 * K][kCols];
  const int tid = threadIdx.x, j = tid >> 3, c = tid & 7;
  const int h = blockIdx.x / 4, n0 = blockIdx.x % 4 * kCols;
  for (int i = tid; i < SW * K; i += kThreads) sx[i / K][i % K] = xs[h * SW * K + i];
  for (int i = tid; i < 2 * K * kCols; i += kThreads)
    sw[i / kCols][i % kCols] = w[(i / kCols) * CO + n0 + i % kCols];
  __syncthreads();
  float acc[2] = {0.f, 0.f};
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float a = sx[j][k], b = sx[j + 2][k];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[i] = fmaf(a, sw[k][c + 8 * i], acc[i]);
      acc[i] = fmaf(b, sw[K + k][c + 8 * i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) out[(h * (SW - 2) + j) * CO + n0 + c + 8 * i] = acc[i];
}
#endif

#if CASE_ON(6)
// G: as F, with each window copied out of the strip into its own tile, and
// the weight columns staged in two halves, one per window; an eighth of the
// columns a block, 1 a thread (its three staging round trips in turn are
// its critical path, so it takes more blocks than F).
__global__ void __launch_bounds__(kThreads) probe_g(const float* __restrict__ xs,
                                                    const float* __restrict__ w,
                                                    float* __restrict__ out) {
  constexpr int kCols = CO / kSplit[6];
  __shared__ float sx[SW][K];
  __shared__ float wa[SW - 2][K + 1];
  __shared__ float wb[SW - 2][K + 1];
  __shared__ float sw[K][kCols];
  const int tid = threadIdx.x, j = tid >> 3, c = tid & 7;
  const int h = blockIdx.x / kSplit[6], n0 = blockIdx.x % kSplit[6] * kCols;
  for (int i = tid; i < SW * K; i += kThreads) sx[i / K][i % K] = xs[h * SW * K + i];
  __syncthreads();
  for (int i = tid; i < (SW - 2) * K; i += kThreads) {
    wa[i / K][i % K] = sx[i / K][i % K];
    wb[i / K][i % K] = sx[i / K + 2][i % K];
  }
  float acc = 0.f;
  for (int half = 0; half < 2; ++half) {
    __syncthreads();
    for (int i = tid; i < K * kCols; i += kThreads)
      sw[i / kCols][i % kCols] = w[(half * K + i / kCols) * CO + n0 + i % kCols];
    __syncthreads();
    const float(*win)[K + 1] = half ? wb : wa;
#pragma unroll 8
    for (int k = 0; k < K; ++k) acc = fmaf(win[j][k], sw[k][c], acc);
  }
  out[(h * (SW - 2) + j) * CO + n0 + c] = acc;
}
#endif

#if CASE_ON(7)
constexpr int kHCi = CI / kSplit[7];      // input channels a block takes: 16
constexpr int kXStride = kHCi + 8;        // bf16 per strip pixel in shared memory
constexpr int kWStride = 9 * kHCi + 8;    // bf16 per weight column (one n)
constexpr size_t kHSmemBytes =
    (size_t(3) * (WF + 2) * kXStride + size_t(CO) * kWStride) * sizeof(__nv_bfloat16) +
    size_t(WF) * CO * sizeof(float);      // the partial tile

__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// H: 32 output rows; the cluster's 4 blocks take the 4 quarters of the input
// channels; 8 warps of 16 pixels by 64 channels.
// Fragments of mma.m16n8k16 (PTX ISA): lane = 4*g + t; A (16x16, row major)
// holds rows g and g+8, columns 2t, 2t+1 and 2t+8, 2t+9; B (16x8, K by N)
// rows 2t, 2t+1 and 2t+8, 2t+9 of column g; C rows g, g+8, columns 2t, 2t+1.
__global__ void __launch_bounds__(kThreads) probe_h(const float* __restrict__ xh,
                                                    const float* __restrict__ wh,
                                                    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);  // [3][WF+2][kXStride]
  __nv_bfloat16* sw = sx + 3 * (WF + 2) * kXStride;             // [CO][kWStride], K-contiguous
  float* part = reinterpret_cast<float*>(sw + CO * kWStride);   // [WF][CO]
  const int tid = threadIdx.x;
  const int h = blockIdx.x / kSplit[7], ci0 = blockIdx.x % kSplit[7] * kHCi;
#pragma unroll 8
  for (int i = tid; i < 3 * (WF + 2) * kHCi; i += kThreads) {
    const int dh = i / ((WF + 2) * kHCi), col = (i / kHCi) % (WF + 2), ci = i % kHCi;
    sx[(dh * (WF + 2) + col) * kXStride + ci] =
        __float2bfloat16_rn(xh[((h + dh) * (WF + 2) + col) * CI + ci0 + ci]);
  }
#pragma unroll 12
  for (int i = tid; i < 9 * kHCi * CO; i += kThreads) {
    const int k = i / CO, n = i % CO;  // k = tap * kHCi + ci
    sw[n * kWStride + k] = __float2bfloat16_rn(wh[((k / kHCi) * CI + ci0 + k % kHCi) * CO + n]);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;  // this warp's first output pixel of the row
  float acc[CO / 8][4];
#pragma unroll
  for (int nt = 0; nt < CO / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3, dw = tap % 3;
    // im2col row m of window (dh, dw) is strip pixel (dh, m + dw)
    const __nv_bfloat16* lo = sx + (dh * (WF + 2) + m0 + g + dw) * kXStride + 2 * t;
    const __nv_bfloat16* hi = lo + 8 * kXStride;
    const uint32_t a0 = pair(lo), a1 = pair(hi), a2 = pair(lo + 8), a3 = pair(hi + 8);
#pragma unroll
    for (int nt = 0; nt < CO / 8; ++nt) {
      const __nv_bfloat16* bp = sw + (nt * 8 + g) * kWStride + tap * kHCi + 2 * t;
      const uint32_t b0 = pair(bp), b1 = pair(bp + 8);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[nt][0]), "+f"(acc[nt][1]), "+f"(acc[nt][2]), "+f"(acc[nt][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  const int r0 = m0 + g;
#pragma unroll
  for (int nt = 0; nt < CO / 8; ++nt) {
    const int n = nt * 8 + 2 * t;
    part[r0 * CO + n] = acc[nt][0];
    part[r0 * CO + n + 1] = acc[nt][1];
    part[(r0 + 8) * CO + n] = acc[nt][2];
    part[(r0 + 8) * CO + n + 1] = acc[nt][3];
  }
  cluster_sum<kSplit[7], WF * CO>(part, out + h * WF * CO);
}
#endif

// The kernel of each case; nullptr where it is not built.
const void* kernel_of(int which) {
  switch (which) {
#if CASE_ON(0)
    case 0: return reinterpret_cast<const void*>(probe_a);
#endif
#if CASE_ON(1)
    case 1: return reinterpret_cast<const void*>(probe_b);
#endif
#if CASE_ON(2)
    case 2: return reinterpret_cast<const void*>(probe_c);
#endif
#if CASE_ON(3)
    case 3: return reinterpret_cast<const void*>(probe_d);
#endif
#if CASE_ON(4)
    case 4: return reinterpret_cast<const void*>(probe_e);
#endif
#if CASE_ON(5)
    case 5: return reinterpret_cast<const void*>(probe_f);
#endif
#if CASE_ON(6)
    case 6: return reinterpret_cast<const void*>(probe_g);
#endif
#if CASE_ON(7)
    case 7: return reinterpret_cast<const void*>(probe_h);
#endif
    default: return nullptr;
  }
}

}  // namespace

// Allows case H its dynamic shared memory (above the 48 KB default) and case
// C its cluster of 9 blocks (above the portable 8) on the current device; the
// library's loader calls it once. Returns 0 or a cudaError_t.
extern "C" int geometry_probe_setup() {
  cudaError_t err = cudaSuccess;
#if CASE_ON(2)
  err = cudaFuncSetAttribute(kernel_of(2), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
#endif
#if CASE_ON(7)
  err = cudaFuncSetAttribute(kernel_of(7), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kHSmemBytes));
#endif
  return static_cast<int>(err);
}

// The blocks of case `which`'s grid, and of each cluster (1: none).
extern "C" int geometry_probe_grid(int which, int* blocks, int* cluster) {
  if (which < 0 || which > 7) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = kTiles[which] * kSplit[which];
  *cluster = kClusterK[which] ? kSplit[which] : 1;
  return 0;
}

// Launches case `which` (0..7 for A..H) on `stream`: out = f(a, b), fp32
// buffers of the case's shapes; the K-split cases as clusters of their
// split. Returns 0, a cudaError_t, or kNotBuilt.
extern "C" int geometry_probe_run(int which, const float* a, const float* b, float* out,
                                  cudaStream_t stream) {
  const void* fn = kernel_of(which);
  if (fn == nullptr) return kNotBuilt;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kTiles[which] * kSplit[which]);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
#if CASE_ON(7)
  if (which == 7) cfg.dynamicSmemBytes = kHSmemBytes;
#endif
  cudaLaunchAttribute attr[1];
  if (kClusterK[which]) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kSplit[which];
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  void* args[] = {&a, &b, &out};
  cudaError_t err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch: clear it, or the next launch reports it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// cudaFuncGetAttributes of case `which`: registers per thread, local memory
// per thread in bytes (spills and local arrays), static and dynamic shared
// memory of its launch in bytes. Returns 0, a cudaError_t, or kNotBuilt.
extern "C" int geometry_probe_attributes(int which, int* num_regs, int* local_bytes,
                                         int* shared_bytes) {
  const void* fn = kernel_of(which);
  if (fn == nullptr) return kNotBuilt;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
#if CASE_ON(7)
  if (which == 7) *shared_bytes += static_cast<int>(kHSmemBytes);
#endif
  return 0;
}

extern "C" const char* geometry_probe_error_string(int err) {
  return err == kNotBuilt ? "the case is not built into this library"
                          : cudaGetErrorString(static_cast<cudaError_t>(err));
}
