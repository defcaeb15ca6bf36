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
// memory of a channels_last_3d (B, C, T, H, W) tensor). The weight is packed
// by the caller into (n_chunks * 16, n_pad) rows of the compute type: row
// k = tap*Ci + ci with tap = (dt*3 + dh)*3 + dw, column co, zero past 27*Ci
// and past Co. fp32 or bf16 in and out; every product is an fp32 FMA on the
// CUDA cores (bf16 is widened on its way into shared memory), every sum fp32.
//
// It is an implicit GEMM: M = B*T*H*W output voxels, N = Co, K = 27*Ci. The
// Pallas kernel's band and halo blocking exists for the TPU's VMEM and
// BlockSpec granularity; here a block owns BM consecutive voxels of the
// flattened (b, t, h, w) order (a run along W, wrapping into the next rows)
// by BN output channels, and walks K in chunks of 16:
//
//   conv3d_kernel  grid (tiles, splits); 256 threads in a (BM/8) x (BN/4)
//                  grid, each owning 8 voxels by 4 channels of fp32
//                  accumulators. Per chunk the block gathers a 16 x BM slice
//                  of the implicit im2col matrix (one tap, 16 input channels
//                  of every voxel; where Ci is not a multiple of 16, as the
//                  3-channel conv_in, 16 consecutive (tap, ci) rows) and a
//                  16 x BN slice of the weight into shared memory, the next
//                  chunk's global loads in flight while this one is summed.
//                  The source voxel of tap (dt, dh, dw) is m + (dt-1)*H*W +
//                  (dh-1)*W + (dw-1), read only where t+dt-1, h+dh-1 and
//                  w+dw-1 lie inside the clip: the bounds checks are the
//                  zero padding, and give the clip-boundary semantics for
//                  which the Pallas kernel clamps and masks its frame index.
//                  BN is 64 (BM 128), or 16 (BM 512) for Co <= 16, so that the
//                  3-channel conv_out does not waste 61 of 64 columns.
//   conv3d_reduce_kernel  only with splits > 1: where the tiles alone fill
//                  less than one block per SM (the 16x16-frame levels), K is
//                  cut into `splits` ranges whose fp32 sums go to `partial`;
//                  this kernel adds them in split order and casts once.
// No atomics; every output entry is summed in a fixed order: deterministic.
//
// Bound: operations at the Ci >= 64 levels, bytes at Ci = 3. A conv does
// 2*27*Ci*Co flops per voxel: at Ci = Co = 64 that is 221 kflop against 256
// bytes of bf16 in and out, 864 flop/byte, far above the H100's ~295 of the
// bf16 tensor cores and ~20 of fp32 FMA. This kernel runs on the CUDA cores'
// fp32 FMA pipes (67 TFLOP/s on an H100 SXM): a thread spends three 16-byte
// shared-memory reads on 32 FMAs, so the FMA pipes and not shared memory set
// its pace, 15x below the bf16 tensor-core bound. The tensor cores (bf16
// mma.sync, then wgmma fed by TMA) are left for the change that redesigns it.
// At Ci = 3 the kernel reads 6 bytes and writes 128 per voxel for 10 kflop:
// bytes bound it, and the padded 16-row chunk wastes 13 of 16 rows there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// Eight consecutive input channels of one voxel, as loaded from device memory;
// widened to fp32 only when stored to shared memory, so that the load stays in
// flight while the previous chunk is summed.
template <typename T>
struct Pack8;

template <>
struct Pack8<float> {
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

template <>
struct Pack8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  // a bf16 is the high half of the fp32 with the same bits: exact
  __device__ __forceinline__ void widen(float (&v)[8]) const {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Writes 4 consecutive outputs; vec: one 16-byte (fp32) or 8-byte (bf16)
// store, for Co a multiple of 4.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&a);
  raw.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The (dt, dh, dw) of a tap index and whether voxel (t, h, w) has a source
// inside the clip for it.
__device__ __forceinline__ bool tap_inside(int tap, int t, int h, int w, const Geometry& g) {
  const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
  const int ts = t + dt - 1, hs = h + dh - 1, ws = w + dw - 1;
  return ts >= 0 && ts < g.T && hs >= 0 && hs < g.H && ws >= 0 && ws < g.W;
}

__device__ __forceinline__ int64_t tap_delta(int tap, const Geometry& g) {
  const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
  return (static_cast<int64_t>(dt - 1) * g.H + (dh - 1)) * g.W + (dw - 1);
}

// kVec: Ci is a multiple of 16, a chunk is one tap and 16 channels, loaded
// as 16-byte vectors. Else a chunk is 16 consecutive rows k of K, each with
// its own (tap, ci), loaded one element at a time.
template <typename T, int BN, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    conv3d_kernel(const T* __restrict__ x, const T* __restrict__ wp, T* __restrict__ y,
                  float* __restrict__ partial, Geometry g) {
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

  Pack8<T> ap[kSlots];    // kVec: the next chunk's input, as loaded
  float as[kSlots][8];    // !kVec: the same, element by element
  T wv[kWElems];          // the next chunk's weight elements
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
            as[r][j] = to_float(x[(vm[r] + tap_delta(tap, g)) * g.Ci + ci]);
          }
        }
      }
    }
    const T* src = wp + (static_cast<int64_t>(c) * kBK + w_row) * g.n_pad + n0 + w_col;
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
    for (int e = 0; e < kWElems; ++e) Bs[w_row][w_col + e] = to_float(wv[e]);
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
        y[o + j] = from_float<T>(acc[i][j]);
      } else {
        part_out[o + j] = acc[i][j];
      }
    }
  }
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

template <typename T, int BN, bool kVec>
cudaError_t launch(const void* x, const void* wp, void* y, float* partial, const Geometry& g,
                   int splits, cudaStream_t stream) {
  constexpr int BM = kThreads / (BN / kTN) * kTM;
  const int64_t tiles = (g.M + BM - 1) / BM * g.n_tiles;
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(tiles), splits);
  conv3d_kernel<T, BN, kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wp), static_cast<T*>(y), partial, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t count = g.M * g.Co;
  conv3d_reduce_kernel<T><<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
      partial, static_cast<T*>(y), count, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* wp, void* y, float* partial,
                         const Geometry& g, int block_n, int splits, cudaStream_t stream) {
  const bool vec = g.Ci % kBK == 0;
  if (block_n == 64) {
    return vec ? launch<T, 64, true>(x, wp, y, partial, g, splits, stream)
               : launch<T, 64, false>(x, wp, y, partial, g, splits, stream);
  }
  return vec ? launch<T, 16, true>(x, wp, y, partial, g, splits, stream)
             : launch<T, 16, false>(x, wp, y, partial, g, splits, stream);
}

}  // namespace

extern "C" {

// y (B, T, H, W, Co) = the 3x3x3 stride-1 SAME conv of x (B, T, H, W, Ci)
// with the packed weight wp (n_chunks*16 rows of n_pad, see above). block_n
// is 16 or 64; n_chunks must be 27*Ci/16 when Ci is a multiple of 16, else
// ceil(27*Ci/16). With splits > 1, partial holds splits*B*T*H*W*Co floats.
// x 16-byte aligned where Ci is a multiple of 16; y 16-byte aligned.
// dtype 0 = fp32, 1 = bf16. Returns a cudaError_t.
int conv3d_forward(const void* x, const void* wp, void* y, float* partial, int B, int T, int H,
                   int W, int Ci, int Co, int n_pad, int n_chunks, int splits,
                   int chunks_per_split, int block_n, int dtype, void* stream) {
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
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch_typed<float>(x, wp, y, partial, g, block_n, splits, st);
  if (dtype == 1) err = launch_typed<__nv_bfloat16>(x, wp, y, partial, g, block_n, splits, st);
  return static_cast<int>(err);
}

const char* conv3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
