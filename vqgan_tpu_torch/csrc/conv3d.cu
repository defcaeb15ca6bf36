// 3x3x3 stride-1 SAME Conv3d over channels-last video tensors, for Hopper
// (sm_90a): kernel #6 of the port.
//
// Replaces the Pallas TPU kernel vqgan_tpu/ops/pallas/conv3d.py::
// _conv3d_pallas (its _kernel), behind conv3d_ttap: the fused-tap Conv3d of
// the 3D video VAE. Every one of the 27*Ci products of an output entry is
// summed in fp32 and the entry is cast and written once, as the Pallas
// kernel does; zero SAME padding on T, H and W. The backward's dx is this
// same kernel on the flipped, Ci/Co-transposed weight (ops/conv3d_cuda.py).
//
// Layout: x is (B, T, H, W, Ci) and y (B, T, H, W, Co), contiguous (the
// memory of a channels_last_3d (B, C, T, H, W) tensor). Both routes are an
// implicit GEMM: M = B*T*H*W output voxels, N = Co, K = 27*Ci in tap-major
// order, row k = tap*Ci + ci with tap = (dt*3 + dh)*3 + dw. The Pallas
// kernel's band and halo blocking exists for the TPU's VMEM and BlockSpec
// granularity; here a block owns BM consecutive voxels of the flattened
// (b, t, h, w) order (a run along W, wrapping into the next rows) by BN
// output channels. The source voxel of tap (dt, dh, dw) is m + (dt-1)*H*W +
// (dh-1)*W + (dw-1), read only where t+dt-1, h+dh-1 and w+dw-1 lie inside
// the clip: that test is the zero padding, and gives the clip-boundary
// semantics for which the Pallas kernel clamps and masks its frame index.
// The wrapper picks the route by dtype alone:
//
// bf16: conv3d_tc_kernel, on the tensor cores. bf16 mma.sync m16n8k16 with
//   fp32 accumulators (a bf16 x bf16 product is exact in fp32, so every
//   product and sum of the contract is fp32), operands by ldmatrix.x4 from
//   shared memory. K is walked in steps of 32 rows: four 16-byte pieces of
//   8 channels a voxel, each one cp.async.cg of the implicit im2col matrix
//   (channels innermost make (voxel, tap, 8 channels) contiguous); where the
//   tap's source lies outside the clip, or past 27*Ci, the copy has a
//   src-size of 0 and writes zeros, so the padding costs no branch on the
//   data. Ci not a multiple of 8 (the 3-channel conv_in, Ci = 3: K = 81
//   padded to 96) gathers its (tap, ci) elements one by one into the same
//   tile; the mma loop is the same. conv3d_pack_kernel packs the OIDHW
//   weight into (n_pad, k_pad) rows, K-contiguous per output channel, zero
//   past 27*Ci and past Co (for dx, flipped and Ci/Co-transposed on the
//   way), in one launch; the rows come by cp.async too, and ldmatrix
//   without .trans gives the col-major B fragments. A ring of 4 stages in dynamic shared
//   memory keeps 3 steps in flight, one __syncthreads a step; rows are
//   padded by 8 bf16 (80 bytes), so each 8-row ldmatrix phase hits all 32
//   banks. The epilogue casts once to bf16 into shared memory and writes
//   16-byte stores. Tiles (8 warps each; launch_plan picks by Co):
//     BM x BN = 128 x 128, warps 2 x 4 of 64 x 32   Co >= 128
//               256 x 64,  warps 4 x 2 of 64 x 32   Co = 64, 32 at large M
//               128 x 64,  warps 4 x 2 of 32 x 32   Co <= 64 at small M or Ci < 8
//               256 x 16,  warps 8 x 1 of 32 x 16   Co = 16 (dx of conv_in)
//               256 x 8,   warps 8 x 1 of 32 x 8    Co <= 8 (conv_out, Co = 3)
//   n8/n16 tiles keep the narrow conv_out from wasting 61 of 64 columns.
//
// fp32: conv3d_kernel, fp32 FMA on the CUDA cores (67 TFLOP/s on an H100
//   SXM), the route of the parity checks: no tensor-core type multiplies
//   fp32 operands exactly. 256 threads in a (BM/8) x (BN/4) grid, 8 voxels
//   by 4 channels of accumulators each; chunks of 16 rows of K in shared
//   memory, the next chunk's global loads in flight while this one is
//   summed; 16 consecutive (tap, ci) rows a chunk where Ci is not a
//   multiple of 16. BN 64 (BM 128), or 16 (BM 512) for Co <= 16.
//
// Split K (both routes): where the tiles fill too few blocks for 132 SMs
// (the 16x16 and 32x32 levels), K is cut into `splits` ranges whose fp32
// sums go to `partial`, and conv3d_reduce_kernel adds them in split order
// and casts once. No atomics; every output entry is summed in a fixed
// order: deterministic. ops/conv3d_cuda.py::tc_rule picks the tensor-core
// tile by Co and the split by waves: the fewest waves of two blocks an SM
// times the steps of K a split takes, plus what the partials cost, a rule
// fitted to times measured on an H100 (tools/sweep_conv3d.py).
//
// Bound: operations at Ci >= 64. A conv does 2*27*Ci*Co flops per voxel: at
// Ci = Co = 64 that is 221 kflop against 256 bytes of bf16 in and out, 864
// flop/byte, above the H100's ~295 for bf16 tensor cores (989 TFLOP/s).
// Bytes at Ci = 3 and Co = 3: 6 bytes read and 128 written, or 128 read and
// 6 written, per voxel for 10 kflop. What the im2col costs beyond the bound:
// each voxel's channels are fetched once per tap (27 times, from L2), and
// mma.sync reaches about two thirds of the rate that wgmma fed by TMA does.
//
// Measured, the launch alone (tools/sweep_conv3d.py on an H100 SXM at 700
// W): 240-260 TFLOP/s on the 128 x 128 tile at Ci, Co >= 128 and 64 x 64
// levels or larger, 205-225 on the 256 x 64 tile at Co = 64; 200-220 at the
// 32 x 32 levels with K split 2-4 ways, 130 at the 2 x 16 x 16 mid level
// with K split 16 ways (one split there runs 5x slower: 32 blocks for 132
// SMs); 25 useful TFLOP/s at Ci = 3 (the element gather) and 13 at Co = 3
// (the n8 tile re-reads the 64 input channels for each of 27 taps from L2,
// ~20x its byte bound). With Ci a multiple of 8 the 128 x 128 and 256 x 64
// tiles use 124 registers and no spills, so two blocks of 8 warps, each
// with its 80 or 100 KB ring, share an SM: the two blocks an SM that
// ops/conv3d_cuda.py::tc_rule counts its waves in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // rows of K per chunk
constexpr int kTM = 8;   // voxels per thread
constexpr int kTN = 4;   // output channels per thread

struct Geometry {
  int T, H, W, Ci, Co;
  int n_pad;             // row stride of the packed weight
  int n_chunks;          // chunks of kBK rows of K
  int chunks_per_split;  // chunks of one split of K
  int n_tiles;           // column tiles: n_pad / BN
  int64_t M;             // B*T*H*W
};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Eight consecutive input channels of one voxel, as loaded from device memory,
// so that the load stays in flight while the previous chunk is summed.
struct Pack8 {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = *reinterpret_cast<const float4*>(p);
    hi = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() { lo = hi = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void widen(float (&v)[8]) const {
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  }
};

// Writes 4 consecutive outputs as one 16-byte store, for Co a multiple of 4.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Whether voxel (t, h, w) has a source inside the clip for tap (dt, dh, dw).
__device__ __forceinline__ bool inside(int dt, int dh, int dw, int t, int h, int w, int T, int H,
                                       int W) {
  const int ts = t + dt - 1, hs = h + dh - 1, ws = w + dw - 1;
  return ts >= 0 && ts < T && hs >= 0 && hs < H && ws >= 0 && ws < W;
}

__device__ __forceinline__ bool tap_inside(int tap, int t, int h, int w, const Geometry& g) {
  return inside(tap / 9, (tap / 3) % 3, tap % 3, t, h, w, g.T, g.H, g.W);
}

// The flat voxel offset of tap (dt, dh, dw).
__device__ __forceinline__ int64_t delta_of(int dt, int dh, int dw, int H, int W) {
  return (static_cast<int64_t>(dt - 1) * H + (dh - 1)) * W + (dw - 1);
}

__device__ __forceinline__ int64_t tap_delta(int tap, const Geometry& g) {
  return delta_of(tap / 9, (tap / 3) % 3, tap % 3, g.H, g.W);
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core FMA route.

// kVec: Ci is a multiple of 16, a chunk is one tap and 16 channels, loaded
// as 16-byte vectors. Else a chunk is 16 consecutive rows k of K, each with
// its own (tap, ci), loaded one element at a time.
template <int BN, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    conv3d_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                  float* __restrict__ y, float* __restrict__ partial, Geometry g) {
  constexpr int kCols = BN / kTN;             // thread columns
  constexpr int BM = kThreads / kCols * kTM;  // voxels per block: 128 or 512
  constexpr int kSlots = BM * 2 / kThreads;   // 8-channel slots a thread loads
  constexpr int kWElems = kBK * BN / kThreads;
  __shared__ __align__(16) float As[kBK][BM];  // [k][voxel]
  __shared__ __align__(16) float Bs[kBK][BN];  // [k][channel]

  const int tid = threadIdx.x;
  const int64_t tile = blockIdx.x;
  const int n0 = static_cast<int>(tile % g.n_tiles) * BN;
  const int64_t m0 = tile / g.n_tiles * BM;
  const int c_begin = blockIdx.y * g.chunks_per_split;
  const int c_end = min(g.n_chunks, c_begin + g.chunks_per_split);

  // slot s = tid + r*256 holds channels [8*(s / BM), +8) of voxel s % BM:
  // a warp's 32 slots are 32 consecutive voxels
  int64_t vm[kSlots];
  int vt[kSlots], vh[kSlots], vw[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    const int64_t m = m0 + (tid + r * kThreads) % BM;
    vm[r] = m < g.M ? m : -1;
    vw[r] = static_cast<int>(m % g.W);
    vh[r] = static_cast<int>(m / g.W % g.H);
    vt[r] = static_cast<int>(m / (static_cast<int64_t>(g.W) * g.H) % g.T);
  }

  Pack8 ap[kSlots];       // kVec: the next chunk's input, as loaded
  float as[kSlots][8];    // !kVec: the same, element by element
  float wv[kWElems];      // the next chunk's weight elements
  const int w_row = tid * kWElems / BN, w_col = tid * kWElems % BN;

  auto load = [&](int c) {
    if constexpr (kVec) {
      const int chunks_per_tap = g.Ci / kBK;
      const int tap = c / chunks_per_tap;
      const int ci0 = (c - tap * chunks_per_tap) * kBK;
      const int64_t delta = tap_delta(tap, g);
#pragma unroll
      for (int r = 0; r < kSlots; ++r) {
        const int part = (tid + r * kThreads) / BM;
        if (vm[r] >= 0 && tap_inside(tap, vt[r], vh[r], vw[r], g)) {
          ap[r].load(x + (vm[r] + delta) * g.Ci + ci0 + part * 8);
        } else {
          ap[r].zero();
        }
      }
    } else {
      const int k_total = 27 * g.Ci;
#pragma unroll
      for (int r = 0; r < kSlots; ++r) {
        const int part = (tid + r * kThreads) / BM;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = c * kBK + part * 8 + j;
          const int tap = k / g.Ci, ci = k - tap * g.Ci;
          as[r][j] = 0.f;
          if (k < k_total && vm[r] >= 0 && tap_inside(tap, vt[r], vh[r], vw[r], g)) {
            as[r][j] = x[(vm[r] + tap_delta(tap, g)) * g.Ci + ci];
          }
        }
      }
    }
    const float* src = wp + (static_cast<int64_t>(c) * kBK + w_row) * g.n_pad + n0 + w_col;
#pragma unroll
    for (int e = 0; e < kWElems; ++e) wv[e] = src[e];
  };

  auto store = [&]() {
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
      const int s = tid + r * kThreads;
      float v[8];
      if constexpr (kVec) {
        ap[r].widen(v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = as[r][j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) As[(s / BM) * 8 + j][s % BM] = v[j];
    }
#pragma unroll
    for (int e = 0; e < kWElems; ++e) Bs[w_row][w_col + e] = wv[e];
  };

  const int tx = tid % kCols, ty = tid / kCols;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }

  // iteration c stores chunk c - 1 (loaded by iteration c - 1), starts the
  // loads of chunk c, then sums chunk c - 1: one call site of each lambda
  for (int c = c_begin; c <= c_end; ++c) {
    if (c > c_begin) {
      __syncthreads();  // chunk c - 2 is summed
      store();
      __syncthreads();
    }
    if (c < c_end) load(c);
    if (c == c_begin) continue;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * kTM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
  }

  const int n = n0 + tx * kTN;
  if (n >= g.Co) return;
  const bool whole = gridDim.y == 1;
  float* part_out = partial + static_cast<int64_t>(blockIdx.y) * g.M * g.Co;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t m = m0 + ty * kTM + i;
    if (m >= g.M) break;
    const int64_t o = m * g.Co + n;
    if (whole && g.Co % 4 == 0) {
      store4(y + o, acc[i]);
      continue;
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      if (n + j >= g.Co) break;
      if (whole) {
        y[o + j] = acc[i][j];
      } else {
        part_out[o + j] = acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core route.

constexpr int kTcBK = 32;          // rows of K a step: 4 pieces of 8 channels
constexpr int kPieces = kTcBK / 8;  // 16-byte pieces a row
constexpr int kRow = kTcBK + 8;     // bf16 a shared-memory row: 80 bytes
constexpr int kStages = 4;

struct TcGeometry {
  int T, H, W, Ci, Co;
  int k_total;          // 27 * Ci
  int k_pad;            // row length of the packed weight: n_steps * 32
  int n_steps;          // steps of 32 rows of K
  int steps_per_split;  // steps of one split of K
  int n_tiles;          // column tiles: n_pad / BN
  int sums_only;        // write the fp32 sums to partial even at one split
  int64_t M;            // B*T*H*W
};

template <int BM, int BN>
constexpr size_t tc_smem_bytes() {
  return static_cast<size_t>(kStages) * (BM + BN) * kRow * sizeof(__nv_bfloat16);
}

// kVec: Ci is a multiple of 8, so every 8-channel piece of a row of the
// im2col matrix is one tap's 16 contiguous bytes. Else each element of a
// piece has its own (tap, ci) and is loaded alone.
template <int BM, int BN, int WARPS_M, int WARPS_N, bool kVec>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    conv3d_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ partial, TcGeometry g) {
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's tile
  constexpr int MT = WM / 16, NT8 = WN / 8;            // its m16 and n8 tiles
  constexpr int kAPer = BM * kPieces / NT;             // A pieces a thread copies
  constexpr int kBPieces = BN * kPieces;
  constexpr int kBPer = (kBPieces + NT - 1) / NT;
  constexpr int kAStage = BM * kRow, kBStage = BN * kRow;  // bf16 a stage
  static_assert(BM * kPieces % NT == 0 && WM % 16 == 0 && WN % 8 == 0, "tile");
  static_assert(NT8 == 1 || NT8 % 2 == 0, "B fragments come in pairs of n8 tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [stage][BM][kRow]
  __nv_bfloat16* Bs = As + kStages * kAStage;                   // [stage][BN][kRow]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tile = blockIdx.x;
  const int n0 = static_cast<int>(tile % g.n_tiles) * BN;
  const int64_t m0 = tile / g.n_tiles * BM;
  const int s_begin = blockIdx.y * g.steps_per_split;
  const int n_steps = min(g.n_steps, s_begin + g.steps_per_split) - s_begin;

  // this thread's A pieces: rows tid/4 + j*NT/4, piece tid%4 of each
  const int a_piece = tid % kPieces;
  int64_t am[kAPer];
  int at[kAPer], ah[kAPer], aw[kAPer];
#pragma unroll
  for (int j = 0; j < kAPer; ++j) {
    const int64_t m = m0 + tid / kPieces + j * (NT / kPieces);
    am[j] = m < g.M ? m : -1;
    aw[j] = static_cast<int>(m % g.W);
    ah[j] = static_cast<int>(m / g.W % g.H);
    at[j] = static_cast<int>(m / (static_cast<int64_t>(g.W) * g.H) % g.T);
  }

  auto load_stage = [&](int stage, int step) {
    const int k0 = step * kTcBK;
    __nv_bfloat16* a_s = As + stage * kAStage;
    if constexpr (kVec) {
      const int k = k0 + a_piece * 8;
      const int tap = k / g.Ci;
      const int ci = k - tap * g.Ci;
      const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
      const int64_t delta = delta_of(dt, dh, dw, g.H, g.W);
      const bool k_in = k < g.k_total;
#pragma unroll
      for (int j = 0; j < kAPer; ++j) {
        const int row = tid / kPieces + j * (NT / kPieces);
        const bool ok = k_in && am[j] >= 0 &&
                        inside(dt, dh, dw, at[j], ah[j], aw[j], g.T, g.H, g.W);
        const __nv_bfloat16* src = ok ? x + (am[j] + delta) * g.Ci + ci : x;
        cp_async16(smem_addr(a_s + row * kRow + a_piece * 8), src, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kAPer; ++j) {
        const int row = tid / kPieces + j * (NT / kPieces);
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = k0 + a_piece * 8 + e;
          const int tap = k / g.Ci, ci = k - tap * g.Ci;
          const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
          v[e] = __float2bfloat16_rn(0.f);
          if (k < g.k_total && am[j] >= 0 &&
              inside(dt, dh, dw, at[j], ah[j], aw[j], g.T, g.H, g.W)) {
            v[e] = x[(am[j] + delta_of(dt, dh, dw, g.H, g.W)) * g.Ci + ci];
          }
        }
        *reinterpret_cast<uint4*>(a_s + row * kRow + a_piece * 8) =
            *reinterpret_cast<const uint4*>(v);
      }
    }
    __nv_bfloat16* b_s = Bs + stage * kBStage;
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int idx = tid + j * NT;
      if (kBPieces % NT == 0 || idx < kBPieces) {
        const int n = idx / kPieces, piece = idx % kPieces;
        const __nv_bfloat16* src = wp + static_cast<int64_t>(n0 + n) * g.k_pad + k0 + piece * 8;
        cp_async16(smem_addr(b_s + n * kRow + piece * 8), src, 16);
      }
    }
  };

  const int wm0 = (warp % WARPS_M) * WM, wn0 = (warp / WARPS_M) * WN;
  float acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    }
  }

  // lane l addresses row l%16 of an m16 tile at column 8*(l/16) (A, x4:
  // rows 0-7 / 8-15 by columns 0-7 / 8-15), and row l%8 of n8 tile
  // 2p + l/16 at column 8*((l/8)%2) (B, x4: b0, b1 of two n8 tiles)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane >> 4) * 8 + (lane & 7), b_col = ((lane >> 3) & 1) * 8;

  auto compute = [&](int stage) {
    const __nv_bfloat16* a_s = As + stage * kAStage;
    const __nv_bfloat16* b_s = Bs + stage * kBStage;
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      uint32_t a[MT][4], b[NT8][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        ldmatrix_x4(a[i], smem_addr(a_s + (wm0 + i * 16 + a_row) * kRow + kk + a_col));
      }
      if constexpr (NT8 == 1) {
        ldmatrix_x2(b[0], smem_addr(b_s + (wn0 + (lane & 7)) * kRow + kk + b_col));
      } else {
#pragma unroll
        for (int p = 0; p < NT8 / 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4(r, smem_addr(b_s + (wn0 + p * 16 + b_row) * kRow + kk + b_col));
          b[2 * p][0] = r[0], b[2 * p][1] = r[1];
          b[2 * p + 1][0] = r[2], b[2 * p + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT8; ++j) mma_bf16(acc[i][j], a[i], b[j]);
      }
    }
  };

  // step i waits for its stage, starts the copies of step i + 3 into the
  // stage step i - 1 used (every warp is past it: the barrier), then sums
  // step i. An empty group keeps the count of groups in flight at 3.
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_steps) load_stage(i, s_begin + i);
    cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = i + kStages - 1;
    if (next < n_steps) load_stage(next % kStages, s_begin + next);
    cp_async_commit();
    compute(i % kStages);
  }
  cp_async_wait<0>();

  const int gr = lane >> 2, gc = 2 * (lane & 3);
  if (gridDim.y > 1 || g.sums_only) {
    // fp32 sums of this split, for conv3d_reduce_kernel
    float* out = partial + static_cast<int64_t>(blockIdx.y) * g.M * g.Co;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int n = n0 + wn0 + j * 8 + gc;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int64_t m = m0 + wm0 + i * 16 + gr + half * 8;
          if (m >= g.M || n >= g.Co) continue;
          const float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
          float* p = out + m * g.Co + n;
          if (g.Co % 2 == 0) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (n + 1 < g.Co) p[1] = v1;
          }
        }
      }
    }
    return;
  }

  // one cast to bf16, through shared memory, then 16-byte stores
  constexpr int kCRow = BN + 8;
  static_assert(BM * kCRow <= kStages * (kAStage + kBStage), "C tile fits the ring");
  __syncthreads();  // every warp is done with the ring
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm0 + i * 16 + gr + half * 8;
        *reinterpret_cast<__nv_bfloat162*>(cs + row * kCRow + wn0 + j * 8 + gc) =
            __floats2bfloat162_rn(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
  __syncthreads();
  constexpr int kOutPieces = BM * (BN / 8);
  for (int idx = tid; idx < kOutPieces; idx += NT) {
    const int row = idx / (BN / 8), piece = idx % (BN / 8);
    const int64_t m = m0 + row;
    const int n = n0 + piece * 8;
    if (m >= g.M || n >= g.Co) continue;
    const __nv_bfloat16* src = cs + row * kCRow + piece * 8;
    __nv_bfloat16* dst = y + m * g.Co + n;
    if (g.Co % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < g.Co; ++e) dst[e] = src[e];
    }
  }
}

// The tensor-core kernel's weight rows from an OIDHW (A, B, 3, 3, 3) weight
// of element strides s (any layout: OIDHW, channels_last_3d, a view):
// packed[n][k] for n < n_pad, k < k_pad, zero past the conv's Co and 27*Ci.
// Forward (transpose 0): Co = A, Ci = B, packed[n][tap*B + c] =
// w[n][c][tap]. dx (transpose 1), the conv with the flipped, Ci/Co-swapped
// weight: Co = B, Ci = A, packed[n][tap*A + c] = w[c][n][26 - tap].
struct PackStrides {
  int64_t s[5];
};

__global__ void conv3d_pack_kernel(const __nv_bfloat16* __restrict__ w,
                                   __nv_bfloat16* __restrict__ packed, int A, int B, int n_pad,
                                   int k_pad, int transpose, PackStrides st) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(n_pad) * k_pad) return;
  const int n = static_cast<int>(i / k_pad), k = static_cast<int>(i % k_pad);
  const int co = transpose ? B : A, ci = transpose ? A : B;
  __nv_bfloat16 v = __float2bfloat16_rn(0.f);
  if (n < co && k < 27 * ci) {
    const int c = k % ci, tap = transpose ? 26 - k / ci : k / ci;
    const int a = transpose ? c : n, b = transpose ? n : c;
    v = w[a * st.s[0] + b * st.s[1] + (tap / 9) * st.s[2] + (tap / 3 % 3) * st.s[3] +
          (tap % 3) * st.s[4]];
  }
  packed[i] = v;
}

template <typename T>
__global__ void conv3d_reduce_kernel(const float* __restrict__ partial, T* __restrict__ y,
                                     int64_t count, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = partial[i];
  for (int p = 1; p < splits; ++p) s += partial[p * count + i];
  y[i] = from_float<T>(s);
}

template <typename T>
cudaError_t reduce(const float* partial, void* y, int64_t count, int splits,
                   cudaStream_t stream) {
  conv3d_reduce_kernel<T><<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
      partial, static_cast<T*>(y), count, splits);
  return cudaGetLastError();
}

template <int BN, bool kVec>
cudaError_t launch(const void* x, const void* wp, void* y, float* partial, const Geometry& g,
                   int splits, cudaStream_t stream) {
  constexpr int BM = kThreads / (BN / kTN) * kTM;
  const int64_t tiles = (g.M + BM - 1) / BM * g.n_tiles;
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(tiles), splits);
  conv3d_kernel<BN, kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wp), static_cast<float*>(y),
      partial, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return reduce<float>(partial, y, g.M * g.Co, splits, stream);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool kVec>
cudaError_t launch_tc(const void* x, const void* wp, void* y, float* partial,
                      const TcGeometry& g, int splits, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<BM, BN>();
  const auto kernel = conv3d_tc_kernel<BM, BN, WARPS_M, WARPS_N, kVec>;
  if (g.n_tiles * BN < g.Co) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (g.M + BM - 1) / BM * g.n_tiles;
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(tiles), splits);
  kernel<<<grid, WARPS_M * WARPS_N * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wp),
      static_cast<__nv_bfloat16*>(y), partial, g);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1 || g.sums_only) return err;
  return reduce<__nv_bfloat16>(partial, y, g.M * g.Co, splits, stream);
}

template <bool kVec>
cudaError_t launch_tc_tile(int tile, const void* x, const void* wp, void* y, float* partial,
                           const TcGeometry& g, int splits, cudaStream_t stream) {
  switch (tile) {
    case 0: return launch_tc<128, 128, 2, 4, kVec>(x, wp, y, partial, g, splits, stream);
    case 1: return launch_tc<256, 64, 4, 2, kVec>(x, wp, y, partial, g, splits, stream);
    case 2: return launch_tc<128, 64, 4, 2, kVec>(x, wp, y, partial, g, splits, stream);
    case 3: return launch_tc<256, 16, 8, 1, kVec>(x, wp, y, partial, g, splits, stream);
    case 4: return launch_tc<256, 8, 8, 1, kVec>(x, wp, y, partial, g, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kTileN[] = {128, 64, 64, 16, 8};

}  // namespace

extern "C" {

// fp32: y (B, T, H, W, Co) = the 3x3x3 stride-1 SAME conv of x (B, T, H, W,
// Ci) with the packed weight wp: n_chunks*16 rows k of n_pad columns co,
// zero past 27*Ci and past Co. block_n is 16 or 64; n_chunks must be
// 27*Ci/16 when Ci is a multiple of 16, else ceil(27*Ci/16). With splits > 1,
// partial holds splits*B*T*H*W*Co floats. x 16-byte aligned where Ci is a
// multiple of 16; y 16-byte aligned. Returns a cudaError_t.
int conv3d_forward_fp32(const void* x, const void* wp, void* y, float* partial, int B, int T,
                        int H, int W, int Ci, int Co, int n_pad, int n_chunks, int splits,
                        int chunks_per_split, int block_n, void* stream) {
  const int want_chunks = Ci % kBK == 0 ? 27 * Ci / kBK : (27 * Ci + kBK - 1) / kBK;
  if (B < 1 || T < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 || (block_n != 16 && block_n != 64) ||
      n_pad < Co || n_pad % block_n || n_chunks != want_chunks || splits < 1 ||
      chunks_per_split < 1 || static_cast<int64_t>(splits) * chunks_per_split < n_chunks ||
      splits > 65535 || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g;
  g.T = T, g.H = H, g.W = W, g.Ci = Ci, g.Co = Co;
  g.n_pad = n_pad, g.n_chunks = n_chunks, g.chunks_per_split = chunks_per_split;
  g.n_tiles = n_pad / block_n;
  g.M = static_cast<int64_t>(B) * T * H * W;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = Ci % kBK == 0;
  cudaError_t err;
  if (block_n == 64) {
    err = vec ? launch<64, true>(x, wp, y, partial, g, splits, st)
              : launch<64, false>(x, wp, y, partial, g, splits, st);
  } else {
    err = vec ? launch<16, true>(x, wp, y, partial, g, splits, st)
              : launch<16, false>(x, wp, y, partial, g, splits, st);
  }
  return static_cast<int>(err);
}

// bf16: the same conv on the tensor cores. wp is (n_pad, k_pad) bf16, row co
// holding k = tap*Ci + ci, zero past 27*Ci and past Co; k_pad =
// 32*ceil(27*Ci/32), n_pad a multiple of the tile's BN (tile 0-5: BN 128,
// 64, 64, 128, 16, 8). With splits > 1 or sums_only, partial holds
// splits*B*T*H*W*Co floats; with sums_only the fp32 sums of each split go
// there and y is not written. x and wp 16-byte aligned. Returns a
// cudaError_t.
int conv3d_forward_bf16(const void* x, const void* wp, void* y, float* partial, int B, int T,
                        int H, int W, int Ci, int Co, int n_pad, int k_pad, int tile, int splits,
                        int steps_per_split, int sums_only, void* stream) {
  const int n_steps = (27 * Ci + kTcBK - 1) / kTcBK;
  if (B < 1 || T < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 || tile < 0 || tile > 5 ||
      n_pad < Co || n_pad % kTileN[tile] || k_pad != n_steps * kTcBK || splits < 1 ||
      steps_per_split < 1 || static_cast<int64_t>(splits) * steps_per_split < n_steps ||
      splits > 65535 || ((splits > 1 || sums_only) && partial == nullptr) ||
      (Ci % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16) ||
      reinterpret_cast<uintptr_t>(wp) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TcGeometry g;
  g.T = T, g.H = H, g.W = W, g.Ci = Ci, g.Co = Co;
  g.k_total = 27 * Ci, g.k_pad = k_pad, g.n_steps = n_steps;
  g.steps_per_split = steps_per_split;
  g.n_tiles = n_pad / kTileN[tile];
  g.sums_only = sums_only;
  g.M = static_cast<int64_t>(B) * T * H * W;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      Ci % 8 == 0 ? launch_tc_tile<true>(tile, x, wp, y, partial, g, splits, st)
                  : launch_tc_tile<false>(tile, x, wp, y, partial, g, splits, st);
  return static_cast<int>(err);
}

// bf16: wp (n_pad, k_pad) for conv3d_forward_bf16 from the OIDHW weight w
// (A, B, 3, 3, 3) of element strides s0..s4: the forward's rows (transpose
// 0) or the dx's (transpose 1: the flipped weight with Ci and Co swapped).
// Returns a cudaError_t.
int conv3d_pack_bf16(const void* w, void* wp, int A, int B, int n_pad, int k_pad, int transpose,
                     int64_t s0, int64_t s1, int64_t s2, int64_t s3, int64_t s4, void* stream) {
  const int co = transpose ? B : A, ci = transpose ? A : B;
  if (A < 1 || B < 1 || n_pad < co || k_pad < 27 * ci || (transpose != 0 && transpose != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t count = static_cast<int64_t>(n_pad) * k_pad;
  conv3d_pack_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wp), A, B, n_pad, k_pad,
      transpose, PackStrides{{s0, s1, s2, s3, s4}});
  return static_cast<int>(cudaGetLastError());
}

const char* conv3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
