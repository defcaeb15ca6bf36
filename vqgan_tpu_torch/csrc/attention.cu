// Exact non-causal attention over (B, N, H, D) tensors, forward and backward,
// for Hopper (sm_90a): kernel #3 of the port.
//
// Replaces the Pallas TPU flash-attention kernel that
// vqgan_tpu/ops/flash_attention.py::flash_attention_tpu wraps
// (jax/experimental/pallas/ops/tpu/flash_attention.py: the forward
// _flash_attention_kernel and the backward _flash_attention_dkv_kernel and
// _flash_attention_dq_kernel). Scale D^-1/2, softmax statistics in fp32, O(N*D)
// residuals: the output and the per-query logsumexp (lse); no N x N matrix
// reaches device memory. For bf16 the kernels round where the Pallas kernel
// casts: P to v's type before P.V and to dO's before dV, dS to the input type
// before dK and dQ; l is summed from the unrounded fp32 P.
//
// Layout: q, k, v, the output and the gradients are (B, N, H, D) with any
// strides whose last is 1 and whose others are multiples of 4 elements (fp32)
// or 8 (bf16), 16-byte aligned, so q, k and v can be views of the qkv conv's
// channels-last output (token stride 3C). lse and delta are fp32 (B, H, N).
// The output (the forward's out, the backward's dq, dk and dv) has the
// inputs' type, or fp32 for bf16 inputs where the caller asks (ring
// attention, ops/ring_attention.py, sums each ring step's partial in fp32
// and casts once at the end, as the JAX ring does): the same accumulators,
// stored without the cast.
// The backward is three launches: delta = sum_d dO*O per row (from O as
// stored), a dK/dV kernel (one key tile per block, looping over query tiles)
// and a dQ kernel (one query tile per block, looping over key tiles). Every
// output entry is summed in a fixed order: no atomics, deterministic. The
// ragged last tile is masked (any N >= 1). D is a template parameter: 16, 32,
// 64 or 128. The dtype alone picks the route:
//
// bf16: the tensor cores (attn_*_tc_kernel). bf16 mma.sync m16n8k16 with
//   fp32 accumulators (csrc/mma.cuh); a bf16 x bf16 product is exact in fp32,
//   so every product and sum of the contract is fp32. A block of 8 warps owns
//   128 rows (queries, or keys for dK/dV), 16 a warp; the warp loads its
//   rows' fragments once by ldmatrix and keeps them in registers (at D = 128
//   it reloads them from the staged rows at each k16 step: AFrags) while
//   tiles of 64 rows (32 at D = 128) of the other side stream through a 3-stage ring of
//   cp.async.cg 16-byte copies (two in flight, one __syncthreads a step), as
//   bf16 in rows padded by 8 (48, 80, 144 or 272 bytes) so that each 8-row
//   ldmatrix phase hits all 32 banks. Rows past N are zero-filled by src-size 0 and
//   their scores masked to -inf. A score tile stays in the fp32 accumulators:
//   the online softmax runs on them (a row's max combined across the 4 lanes
//   that share it by __shfl_xor_sync; each lane keeps its part of the row sum
//   until the end), the exponent is exp2 with scale*log2(e) folded into one
//   FMA (lse is still written as the natural log, m*scale + log l), and P is
//   rounded to bf16 in registers and used directly as the A operand of P.V:
//   the accumulator layout of two adjacent n8 tiles is the A layout of one
//   k16 step. The second operand of P.V (and of dV, dK, dQ) comes by
//   ldmatrix.trans from the row-major tile. dK/dV per query tile: S^T = K.Q^T,
//   P^T = exp(S^T - lse), dV += P^T.dO, dP^T = V.dO^T, dS^T = P^T (dP^T -
//   delta) scale, dK += dS^T.Q; dQ per key tile: S, P, dP = dO.V^T, dS, dQ +=
//   dS.K, with P and dS passed from accumulator to operand in registers.
//
// fp32: the CUDA cores (attn_fwd_kernel, attn_bwd_dkv_kernel,
//   attn_bwd_dq_kernel), the route of the parity checks: no tensor-core type
//   multiplies fp32 operands exactly. 64 queries by 64 keys a tile; a block
//   has 256 threads in a 16 x 16 grid (ty, tx); in a 64 x 64 score tile a
//   thread owns rows ty*4 + i and columns tx + 16*j (i, j < 4), and in a 64 x
//   D product tile rows ty*4 + i and columns tx*(D/16) + j. Tiles sit in
//   shared memory as fp32 rows padded by 4 floats, so that the float4 reads
//   of a score tile's columns fall on 8 distinct bank groups and a row's 16
//   threads read one address. Every product is an fp32 FMA; P and dS take a
//   trip through shared memory.
//
// Bound: operations, and at D = 32 the exponentials. The forward does
// 4*B*H*N^2*D flops (two products) and B*H*N^2 exps; the backward 14*B*H*N^2*D
// flops (seven products: the dK/dV and dQ kernels each recompute S and dP,
// the price of no atomics; an atomic design needs 10) and 2*B*H*N^2 exps. At
// the flagship mid block (B = 8, N = 1024, H = 16, D = 64) that is 34.4 and
// 120 GFLOP: 0.035 and 0.12 ms at 989 TFLOP/s of bf16 tensor cores (0.51 and
// 1.8 ms at 67 TFLOP/s of fp32 FMA). The SFU takes 16 exps a clock per SM,
// some 3.9e12 a second: 128 flops of a D = 32 head per exp against the tensor
// cores' ~250 per SFU op, so at D = 32 (the TVAE's long clip, N = 49152:
// 1.9e10 exps a call, ~5 ms) the exps, not the products, set the floor. The
// bytes are ~17 MB per tensor in bf16 at the flagship, some 5 us each at
// 3.35 TB/s. What the bf16 design costs beyond that: mma.sync reaches about
// two thirds of the rate of wgmma fed by TMA; each warp reads every streamed
// tile from shared memory once per product (one ldmatrix.x4 per two mma);
// the softmax's FMA, max and sum run on the fp32 pipes beside the SFU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kTile = 64;      // queries per q tile, keys per k tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of padding per shared-memory row
constexpr int kLdp = kTile + kPad;

struct Strides {
  int64_t b, n, h;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The FMA kernels below are instantiated for fp32 only (bf16 takes the
// tensor-core route), where these casts are the identity.
template <typename T>
__device__ __forceinline__ T cast_to(float x);
template <>
__device__ __forceinline__ float cast_to<float>(float x) {
  return x;
}

// x rounded to T's precision (the Pallas kernel's casts before a product)
template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) {
  return x;
}

__device__ __forceinline__ int64_t offset(const Strides& s, int b, int row, int h) {
  return b * s.b + row * s.n + h * s.h;
}

// Rows [row0, row0 + 64) of the (b, h) slice into a 64 x (D + 4) fp32 tile;
// rows at or past n read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          const Strides& s, int b, int h, int row0, int n) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < kTile * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = load4(src + offset(s, b, row0 + r, h) + c);
    *reinterpret_cast<float4*>(dst + r * (D + kPad) + c) = val;
  }
}

// acc[i][j] += sum_d a[ty*4 + i][d] * b[tx + 16*j][d], d ascending: a score
// tile from two 64 x D tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int kLd = D + kPad;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * kLd + d);
      av[i][0] = t.x, av[i][1] = t.y, av[i][2] = t.z, av[i][3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
      bv[j][0] = t.x, bv[j][1] = t.y, bv[j][2] = t.z, bv[j][3] = t.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i][e], bv[j][e], acc[i][j]);
      }
    }
  }
}

// acc[i][j] += sum_c p[ty*4 + i][c] * m[c][tx*(D/16) + j], c ascending over
// the 64 columns of a score tile p (64 x 68) and the rows of a 64 x D tile m.
template <int D>
__device__ __forceinline__ void tile_mul(float (&acc)[4][D / 16], const float* p, const float* m,
                                         int ty, int tx) {
  constexpr int kLd = D + kPad, kCols = D / 16;
#pragma unroll 4
  for (int c = 0; c < kTile; c += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(p + (ty * 4 + i) * kLdp + c);
      pv[i][0] = t.x, pv[i][1] = t.y, pv[i][2] = t.z, pv[i][3] = t.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float mv[kCols];
      const float* row = m + (c + e) * kLd + tx * kCols;
      if constexpr (kCols % 4 == 0) {
#pragma unroll
        for (int v = 0; v < kCols; v += 4) {
          const float4 t = *reinterpret_cast<const float4*>(row + v);
          mv[v] = t.x, mv[v + 1] = t.y, mv[v + 2] = t.z, mv[v + 3] = t.w;
        }
      } else if constexpr (kCols == 2) {
        const float2 t = *reinterpret_cast<const float2*>(row);
        mv[0] = t.x, mv[1] = t.y;
      } else {
        mv[0] = row[0];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(pv[i][e], mv[j], acc[i][j]);
      }
    }
  }
}

// Reductions over the 16 threads (tx) that share a row: one half-warp.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows ty*4 + i, columns tx*(D/16) + j of a 64 x D accumulator into rows
// [row0, row0 + 64) of the (b, h) slice of dst, each divided by div[i]
// (pass 1 for none); rows at or past n are not written.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const Strides& s, int b, int h,
                                           int row0, int n, const float (&acc)[4][D / 16],
                                           const float (&div)[4], int ty, int tx) {
  constexpr int kCols = D / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= n) continue;
    T* out = dst + offset(s, b, row, h) + tx * kCols;
#pragma unroll
    for (int j = 0; j < kCols; ++j) out[j] = cast_to<T>(acc[i][j] / div[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk,
                    Strides sv, Strides so, int heads, int n, float scale) {
  constexpr int kLd = D + kPad, kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* ps = vs + kTile * kLd;  // 64 x 68
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;

  load_tile<T, D>(qs, q, sq, b, h, q0, n);
  float acc[4][kCols] = {};
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the last tile's ks, vs and ps are read
    load_tile<T, D>(ks, k, sk, b, h, k0, n);
    load_tile<T, D>(vs, v, sv, b, h, k0, n);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + tx + 16 * j < n ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile has a key below n, so m_new is finite
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);  // 0 at the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * 4 + i) * kLdp + tx + 16 * j] = round_as<T>(p);
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    tile_mul<D>(acc, ps, vs, ty, tx);
  }
  store_rows<T, D>(o, so, b, h, q0, n, acc, l, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < n) lse[static_cast<int64_t>(blockIdx.y) * n + row] = m[i] + logf(l[i]);
    }
  }
}

// delta[bh][row] = sum_d g * o over D/4 threads of 4 columns each.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                          float* __restrict__ delta, Strides so, Strides sg, int heads, int n,
                          int64_t rows) {
  constexpr int kLanes = D / 4;
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kLanes;
  const int c = (threadIdx.x % kLanes) * 4;
  float sum = 0.f;
  if (r < rows) {
    const int row = static_cast<int>(r % n);
    const int bh = static_cast<int>(r / n);
    const int b = bh / heads, h = bh % heads;
    const float4 a = load4(o + offset(so, b, row, h) + c);
    const float4 e = load4(g + offset(sg, b, row, h) + c);
    sum = a.x * e.x + a.y * e.y + a.z * e.z + a.w * e.w;
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (r < rows && threadIdx.x % kLanes == 0) delta[r] = sum;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk,
                        Strides sv, Strides sg, Strides sdk, Strides sdv, int heads, int n,
                        float scale) {
  constexpr int kLd = D + kPad, kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTile * kLd;
  float* qs = vs + kTile * kLd;
  float* gs = qs + kTile * kLd;
  float* pts = gs + kTile * kLd;  // P^T, 64 keys x 68
  float* dsts = pts + kTile * kLdp;  // dS^T
  float* lse_s = dsts + kTile * kLdp;
  float* delta_s = lse_s + kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int64_t stat0 = static_cast<int64_t>(blockIdx.y) * n;

  load_tile<T, D>(ks, k, sk, b, h, k0, n);
  load_tile<T, D>(vs, v, sv, b, h, k0, n);
  float dk_acc[4][kCols] = {}, dv_acc[4][kCols] = {};

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // the last q tile's qs, gs, pts and dsts are read
    load_tile<T, D>(qs, q, sq, b, h, q0, n);
    load_tile<T, D>(gs, g, sg, b, h, q0, n);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < n ? lse[stat0 + row] : 0.f;
      delta_s[threadIdx.x] = row < n ? delta[stat0 + row] : 0.f;
    }
    __syncthreads();
    float st[4][4] = {}, dpt[4][4] = {};
    tile_dot<D>(st, ks, qs, ty, tx);   // keys ty*4 + i, queries tx + 16*j
    tile_dot<D>(dpt, vs, gs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p = q0 + col < n ? expf(st[i][j] * scale - lse_s[col]) : 0.f;
        const float ds = p * (dpt[i][j] - delta_s[col]) * scale;
        pts[(ty * 4 + i) * kLdp + col] = round_as<T>(p);
        dsts[(ty * 4 + i) * kLdp + col] = round_as<T>(ds);
      }
    }
    __syncthreads();
    tile_mul<D>(dv_acc, pts, gs, ty, tx);
    tile_mul<D>(dk_acc, dsts, qs, ty, tx);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, D>(dk, sdk, b, h, k0, n, dk_acc, one, ty, tx);
  store_rows<T, D>(dv, sdv, b, h, k0, n, dv_acc, one, ty, tx);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ g, const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq, Strides sq,
                       Strides sk, Strides sv, Strides sg, Strides sdq, int heads, int n,
                       float scale) {
  constexpr int kLd = D + kPad, kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* gs = qs + kTile * kLd;
  float* ks = gs + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* dss = vs + kTile * kLd;  // dS, 64 queries x 68
  float* lse_s = dss + kTile * kLdp;
  float* delta_s = lse_s + kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int64_t stat0 = static_cast<int64_t>(blockIdx.y) * n;

  load_tile<T, D>(qs, q, sq, b, h, q0, n);
  load_tile<T, D>(gs, g, sg, b, h, q0, n);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < n ? lse[stat0 + row] : 0.f;
    delta_s[threadIdx.x] = row < n ? delta[stat0 + row] : 0.f;
  }
  float dq_acc[4][kCols] = {};

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the last k tile's ks, vs and dss are read
    load_tile<T, D>(ks, k, sk, b, h, k0, n);
    load_tile<T, D>(vs, v, sv, b, h, k0, n);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, qs, ks, ty, tx);  // queries ty*4 + i, keys tx + 16*j
    tile_dot<D>(dp, gs, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p = k0 + col < n ? expf(s[i][j] * scale - lse_s[row]) : 0.f;
        dss[row * kLdp + col] = round_as<T>(p * (dp[i][j] - delta_s[row]) * scale);
      }
    }
    __syncthreads();
    tile_mul<D>(dq_acc, dss, ks, ty, tx);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, D>(dq, sdq, b, h, q0, n, dq_acc, one, ty, tx);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core route.

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = kTcWarps * 16;  // rows a block owns: 16 a warp
// rows of a tile streamed through the ring: 64, or 32 at D = 128, where a
// warp's score tiles beside its 16 x D accumulators would exceed 255
// registers (the dK/dV kernel holds two accumulators and two score tiles)
template <int D>
constexpr int kTcStep = D > 64 ? 32 : 64;
constexpr int kTcStages = 3;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (one MUFU.EX2); subnormal results flush to 0, -inf gives 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + ROWS) of the (b, h) slice into a ROWS x (D + 8) bf16
// tile, one cp.async of 16 bytes per 8 elements; rows at or past n are
// zero-filled (src-size 0).
template <int D, int ROWS>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* __restrict__ src,
                                          const Strides& s, int b, int h, int row0, int n) {
  constexpr int kPieces = D / 8, kLd = D + 8, kTotal = ROWS * kPieces;
  static_assert(kTotal % kTcThreads == 0 || kTotal < kTcThreads, "whole pieces a thread");
#pragma unroll
  for (int j = 0; j < (kTotal + kTcThreads - 1) / kTcThreads; ++j) {
    const int i = threadIdx.x + j * kTcThreads;
    if (kTotal < kTcThreads && i >= kTotal) break;
    const int r = i / kPieces, c = (i % kPieces) * 8;
    const bool ok = row0 + r < n;
    cp_async16(smem_addr(dst + r * kLd + c), ok ? src + offset(s, b, row0 + r, h) + c : src,
               ok ? 16 : 0);
  }
}

// The A fragments of rows [r0, r0 + 16) of a staged tile, one per k16 step
// of D: lane l addresses row l%16 at column 8*(l/16).
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* tile, int r0,
                                       int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(a[kk], smem_addr(tile + (r0 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8));
  }
}

// A warp's 16 rows of a staged tile as the A operand of mma_abt: at D <= 64
// the fragments of every k16 step sit in registers for the whole kernel; at
// D = 128 they would crowd out the accumulators, so each step's fragment is
// loaded from the tile again (one ldmatrix.x4 per k16 step and product).
template <int D>
struct AFrags {
  static constexpr bool kRegs = D <= 64;
  uint32_t f[kRegs ? D / 16 : 1][4];
  const bf16* tile;
  int r0;
  __device__ __forceinline__ AFrags(const bf16* t, int rows0, int lane) : tile(t), r0(rows0) {
    if constexpr (kRegs) load_a<D>(f, t, rows0, lane);
  }
  __device__ __forceinline__ void at(int kk, uint32_t (&a)[4], int lane) const {
    if constexpr (kRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = f[kk][e];
    } else {
      ldmatrix_x4(a, smem_addr(tile + (r0 + (lane & 15)) * (D + 8) + kk * 16 + (lane >> 4) * 8));
    }
  }
};

// acc[j] += a . tile^T for columns 8j..8j+7 (j < NT): a warp's 16 rows (A
// fragments over D) against the 8 NT rows of a streamed tile, summed over D.
// B by ldmatrix without .trans: lane l addresses row l%8 of n8 tile 2p + l/16
// at column 8*((l/8)%2), giving b0, b1 of two n8 tiles.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const AFrags<D>& a,
                                        const bf16* tile, int lane) {
  constexpr int kLd = D + 8;
  const int row = (lane >> 4) * 8 + (lane & 7), col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    a.at(kk, af, lane);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t r[4];
      ldmatrix_x4(r, smem_addr(tile + (p * 16 + row) * kLd + kk * 16 + col));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16(acc[2 * p], af, b0);
      mma_bf16(acc[2 * p + 1], af, b1);
    }
  }
}

// acc[j] += p . tile for columns 8j..8j+7 of D: a warp's 16 x 8 NT fp32
// accumulators p, rounded to bf16 in registers as the A operand (n8 tiles 2kk
// and 2kk+1 are the A fragment of k16 step kk), against a streamed 8 NT x D
// tile, summed over its 8 NT rows. B by ldmatrix.trans: lane l addresses row
// 16kk + l%8 + 8*((l/8)%2) at column 16dp + 8*(l/16).
template <int D, int NT>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4], const float (&p)[NT][4],
                                       const bf16* tile, int lane) {
  constexpr int kLd = D + 8;
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, smem_addr(tile + (kk * 16 + row) * kLd + dp * 16 + col));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16(acc[2 * dp], a, b0);
      mma_bf16(acc[2 * dp + 1], a, b1);
    }
  }
}

// Entries of a 16 x 64 score tile whose column c0 + 8j + 2t + e lies at or
// past n become -inf, so that their exponential is 0.
template <int NT>
__device__ __forceinline__ void mask_past(float (&s)[NT][4], int c0, int n, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c0 + 8 * j + 2 * t + (c & 1) >= n) s[j][c] = -INFINITY;
    }
  }
}

// Rows r0 + g and r0 + g + 8 of a warp's 16 x D accumulator, divided by
// div[0] and div[1], as pairs of TO (bf16, or fp32 for the ring's partials)
// into the (b, h) slice of dst; rows at or past n are not written.
template <int D, typename TO>
__device__ __forceinline__ void store_acc(TO* __restrict__ dst, const Strides& s, int b, int h,
                                          int r0, int n, const float (&acc)[D / 8][4],
                                          const float (&div)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= n) continue;
    TO* out = dst + offset(s, b, row, h) + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x = acc[j][2 * half] / div[half], y = acc[j][2 * half + 1] / div[half];
      if constexpr (std::is_same_v<TO, float>) {
        *reinterpret_cast<float2*>(out + 8 * j) = make_float2(x, y);
      } else {
        *reinterpret_cast<uint32_t*>(out + 8 * j) = pack_bf16(x, y);
      }
    }
  }
}

// The ring, for every tensor-core kernel: the block's own rows are copied
// with step 0 and steps 0 and 1 are in flight before the loop; step i waits
// for its stage, starts the copies of step i + 2 into the stage that step i -
// 1 used (every warp is past it: the barrier), then computes on step i. An
// empty group keeps the count of groups in flight at 2.
template <typename LoadStep>
__device__ __forceinline__ void ring_prologue(int steps, LoadStep load_step) {
#pragma unroll
  for (int i = 0; i < kTcStages - 1; ++i) {
    if (i < steps) load_step(i);
    cp_async_commit();
  }
  cp_async_wait<kTcStages - 2>();
  __syncthreads();
}

template <typename LoadStep>
__device__ __forceinline__ void ring_step(int i, int steps, LoadStep load_step) {
  cp_async_wait<kTcStages - 2>();
  __syncthreads();
  if (i + kTcStages - 1 < steps) load_step(i + kTcStages - 1);
  cp_async_commit();
}

// Two blocks an SM, except at D = 128, whose tiles take more than half an
// SM's shared memory (its registers may then grow to 255).
template <int D, typename TO>
__global__ void __launch_bounds__(kTcThreads, D > 64 ? 1 : 2)
    attn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, TO* __restrict__ o, float* __restrict__ lse,
                       Strides sq, Strides sk, Strides sv, Strides so, int heads, int n,
                       float scale) {
  constexpr int kStep = kTcStep<D>, kNt = kStep / 8;
  constexpr int kLd = D + 8, kStage = 2 * kStep * kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // kTcRows x kLd
  bf16* ring = qs + kTcRows * kLd;           // [stage][K then V, 64 x kLd each]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int q0 = blockIdx.x * kTcRows;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int steps = (n + kStep - 1) / kStep;
  const float sl = scale * kLog2e;

  auto load_step = [&](int i) {
    bf16* st = ring + (i % kTcStages) * kStage;
    copy_tile<D, kStep>(st, k, sk, b, h, i * kStep, n);
    copy_tile<D, kStep>(st + kStep * kLd, v, sv, b, h, i * kStep, n);
  };
  copy_tile<D, kTcRows>(qs, q, sq, b, h, q0, n);
  ring_prologue(steps, load_step);
  const AFrags<D> qf(qs, warp * 16, lane);

  float acc[D / 8][4] = {};
  // rows g and g+8: the running max of the raw scores, and this lane's part
  // of the running sum (the 4 lanes of a row are added at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int i = 0; i < steps; ++i) {
    ring_step(i, steps, load_step);
    const bf16* ks = ring + (i % kTcStages) * kStage;
    float s[kNt][4] = {};
    mma_abt<D>(s, qf, ks, lane);
    if ((i + 1) * kStep > n) mask_past(s, i * kStep, n, t);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
    }
    float corr[2], base[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile has a key below n, so mx is finite; corr is 0 at the first
      corr[r] = exp2_approx((m[r] - mx[r]) * sl);
      base[r] = mx[r] * sl;
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = exp2_approx(fmaf(s[j][c], sl, -base[c >> 1]));
        sum[c >> 1] += s[j][c];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] *= corr[c >> 1];
    }
    mma_pv<D>(acc, s, ks + kStep * kLd, lane);  // O += P.V
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int r0 = q0 + warp * 16;
  store_acc<D, TO>(o, so, b, h, r0, n, acc, l, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + (lane >> 2) + 8 * r;
      if (row < n) lse[static_cast<int64_t>(blockIdx.y) * n + row] = m[r] * scale + logf(l[r]);
    }
  }
}

template <int D, typename TO>
__global__ void __launch_bounds__(kTcThreads)
    attn_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       TO* __restrict__ dk, TO* __restrict__ dv, Strides sq, Strides sk,
                       Strides sv, Strides sg, Strides sdk, Strides sdv, int heads, int n,
                       float scale) {
  constexpr int kStep = kTcStep<D>, kNt = kStep / 8;
  constexpr int kLd = D + 8, kTile = kStep * kLd;
  constexpr int kStageBytes = 2 * kTile * sizeof(bf16) + 2 * kStep * sizeof(float);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // kTcRows x kLd
  bf16* vs = ks + kTcRows * kLd;
  // [stage]: Q and dO (64 x kLd bf16 each), then lse and delta (64 fp32 each)
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + kTcRows * kLd);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int k0 = blockIdx.x * kTcRows;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int64_t stat0 = static_cast<int64_t>(blockIdx.y) * n;
  const int steps = (n + kStep - 1) / kStep;
  const float sl = scale * kLog2e;

  auto load_step = [&](int i) {
    bf16* qt = reinterpret_cast<bf16*>(ring + (i % kTcStages) * kStageBytes);
    copy_tile<D, kStep>(qt, q, sq, b, h, i * kStep, n);
    copy_tile<D, kStep>(qt + kTile, g, sg, b, h, i * kStep, n);
    if (threadIdx.x < 2 * kStep) {
      float* stats = reinterpret_cast<float*>(qt + 2 * kTile);
      const int row = i * kStep + threadIdx.x % kStep;
      const float* src = threadIdx.x < kStep ? lse : delta;
      const bool ok = row < n;
      cp_async4(smem_addr(stats + threadIdx.x), ok ? src + stat0 + row : src, ok ? 4 : 0);
    }
  };
  copy_tile<D, kTcRows>(ks, k, sk, b, h, k0, n);
  copy_tile<D, kTcRows>(vs, v, sv, b, h, k0, n);
  ring_prologue(steps, load_step);
  const AFrags<D> kf(ks, warp * 16, lane), vf(vs, warp * 16, lane);

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  for (int i = 0; i < steps; ++i) {
    ring_step(i, steps, load_step);
    const bf16* qt = reinterpret_cast<const bf16*>(ring + (i % kTcStages) * kStageBytes);
    const bf16* gt = qt + kTile;
    const float* lse_s = reinterpret_cast<const float*>(qt + 2 * kTile);
    const float* delta_s = lse_s + kStep;
    // P^T: keys (rows g, g+8) by queries 8j + 2t + e of this step
    float pt[kNt][4] = {};
    mma_abt<D>(pt, kf, qt, lane);
    if ((i + 1) * kStep > n) mask_past(pt, i * kStep, n, t);
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + 2 * t + (c & 1);
        pt[j][c] = exp2_approx(fmaf(pt[j][c], sl, -lse_s[col] * kLog2e));
      }
    }
    mma_pv<D>(dv_acc, pt, gt, lane);  // dV += P^T.dO
    float dpt[kNt][4] = {};
    mma_abt<D>(dpt, vf, gt, lane);  // dP^T = V.dO^T
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + 2 * t + (c & 1);
        pt[j][c] = pt[j][c] * (dpt[j][c] - delta_s[col]) * scale;  // dS^T
      }
    }
    mma_pv<D>(dk_acc, pt, qt, lane);  // dK += dS^T.Q
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_acc<D, TO>(dk, sdk, b, h, k0 + warp * 16, n, dk_acc, one, lane);
  store_acc<D, TO>(dv, sdv, b, h, k0 + warp * 16, n, dv_acc, one, lane);
}

template <int D, typename TO>
__global__ void __launch_bounds__(kTcThreads)
    attn_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      TO* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sg,
                      Strides sdq, int heads, int n, float scale) {
  constexpr int kStep = kTcStep<D>, kNt = kStep / 8;
  constexpr int kLd = D + 8, kStage = 2 * kStep * kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // kTcRows x kLd
  bf16* gs = qs + kTcRows * kLd;
  bf16* ring = gs + kTcRows * kLd;  // [stage][K then V, 64 x kLd each]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int q0 = blockIdx.x * kTcRows;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int64_t stat0 = static_cast<int64_t>(blockIdx.y) * n;
  const int steps = (n + kStep - 1) / kStep;
  const float sl = scale * kLog2e;

  auto load_step = [&](int i) {
    bf16* st = ring + (i % kTcStages) * kStage;
    copy_tile<D, kStep>(st, k, sk, b, h, i * kStep, n);
    copy_tile<D, kStep>(st + kStep * kLd, v, sv, b, h, i * kStep, n);
  };
  copy_tile<D, kTcRows>(qs, q, sq, b, h, q0, n);
  copy_tile<D, kTcRows>(gs, g, sg, b, h, q0, n);
  ring_prologue(steps, load_step);
  // rows g and g+8: lse in base 2, delta
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    lse2[r] = row < n ? lse[stat0 + row] * kLog2e : 0.f;
    dl[r] = row < n ? delta[stat0 + row] : 0.f;
  }
  const AFrags<D> qf(qs, warp * 16, lane), gf(gs, warp * 16, lane);

  float dq_acc[D / 8][4] = {};
  for (int i = 0; i < steps; ++i) {
    ring_step(i, steps, load_step);
    const bf16* kt = ring + (i % kTcStages) * kStage;
    const bf16* vt = kt + kStep * kLd;
    float s[kNt][4] = {};
    mma_abt<D>(s, qf, kt, lane);
    if ((i + 1) * kStep > n) mask_past(s, i * kStep, n, t);
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = exp2_approx(fmaf(s[j][c], sl, -lse2[c >> 1]));
    }
    float dp[kNt][4] = {};
    mma_abt<D>(dp, gf, vt, lane);  // dP = dO.V^T
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = s[j][c] * (dp[j][c] - dl[c >> 1]) * scale;  // dS
    }
    mma_pv<D>(dq_acc, s, kt, lane);  // dQ += dS.K
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_acc<D, TO>(dq, sdq, b, h, q0 + warp * 16, n, dq_acc, one, lane);
}

template <int D>
constexpr size_t tc_fwd_smem() {
  constexpr int kStep = kTcStep<D>;
  return static_cast<size_t>(kTcRows + kTcStages * 2 * kStep) * (D + 8) * sizeof(bf16);
}
template <int D>
constexpr size_t tc_dkv_smem() {
  constexpr int kStep = kTcStep<D>;
  return 2 * kTcRows * (D + 8) * sizeof(bf16) +
         kTcStages * (2 * kStep * (D + 8) * sizeof(bf16) + 2 * kStep * sizeof(float));
}
template <int D>
constexpr size_t tc_dq_smem() {
  constexpr int kStep = kTcStep<D>;
  return static_cast<size_t>(2 * kTcRows + kTcStages * 2 * kStep) * (D + 8) * sizeof(bf16);
}

// ---------------------------------------------------------------------------
// Launches.

template <int D>
constexpr size_t fwd_smem() {
  return (3 * kTile * (D + kPad) + kTile * kLdp) * sizeof(float);
}
template <int D>
constexpr size_t dkv_smem() {
  return (4 * kTile * (D + kPad) + 2 * kTile * kLdp + 2 * kTile) * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return (4 * kTile * (D + kPad) + kTile * kLdp + 2 * kTile) * sizeof(float);
}

// Above 48 KB a block's shared memory must be opted into, per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

Strides strides_at(const int64_t* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

// The dtype picks the route: bf16 the tensor-core kernels, fp32 the FMA ones.
// TO is the type of the output (the forward's out, the backward's dq, dk,
// dv): T, or fp32 for bf16 inputs (the ring's partials, summed in fp32
// across ring steps and cast once).
template <typename T, typename TO, int D>
cudaError_t launch_forward(const void* q, const void* k, const void* v, void* o, float* lse,
                           const int64_t* s, int batch, int heads, int n, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v);
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16>) {
    auto kernel = attn_fwd_tc_kernel<D, TO>;
    if ((err = allow_smem(kernel, tc_fwd_smem<D>())) != cudaSuccess) return err;
    const dim3 grid((n + kTcRows - 1) / kTcRows, batch * heads);
    kernel<<<grid, kTcThreads, tc_fwd_smem<D>(), stream>>>(
        tq, tk, tv, static_cast<TO*>(o), lse, strides_at(s, 0), strides_at(s, 1),
        strides_at(s, 2), strides_at(s, 3), heads, n, scale);
  } else {
    auto kernel = attn_fwd_kernel<T, D>;
    if ((err = allow_smem(kernel, fwd_smem<D>())) != cudaSuccess) return err;
    const dim3 grid((n + kTile - 1) / kTile, batch * heads);
    kernel<<<grid, kThreads, fwd_smem<D>(), stream>>>(
        tq, tk, tv, static_cast<T*>(o), lse, strides_at(s, 0), strides_at(s, 1),
        strides_at(s, 2), strides_at(s, 3), heads, n, scale);
  }
  return cudaGetLastError();
}

template <typename T, typename TO, int D>
cudaError_t launch_backward(const void* q, const void* k, const void* v, const void* o,
                            const void* g, const float* lse, float* delta, void* dq, void* dk,
                            void* dv, const int64_t* s, int batch, int heads, int n,
                            cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *tg = static_cast<const T*>(g);
  const int64_t rows = static_cast<int64_t>(batch) * heads * n;
  const int64_t delta_blocks = (rows * (D / 4) + kThreads - 1) / kThreads;
  attn_bwd_delta_kernel<T, D><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o), tg, delta, strides_at(s, 3), strides_at(s, 4), heads, n, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if constexpr (std::is_same_v<T, bf16>) {
    const dim3 grid((n + kTcRows - 1) / kTcRows, batch * heads);
    auto dkv = attn_bwd_dkv_tc_kernel<D, TO>;
    if ((err = allow_smem(dkv, tc_dkv_smem<D>())) != cudaSuccess) return err;
    dkv<<<grid, kTcThreads, tc_dkv_smem<D>(), stream>>>(
        tq, tk, tv, tg, lse, delta, static_cast<TO*>(dk), static_cast<TO*>(dv), strides_at(s, 0),
        strides_at(s, 1), strides_at(s, 2), strides_at(s, 4), strides_at(s, 6),
        strides_at(s, 7), heads, n, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    auto dqk = attn_bwd_dq_tc_kernel<D, TO>;
    if ((err = allow_smem(dqk, tc_dq_smem<D>())) != cudaSuccess) return err;
    dqk<<<grid, kTcThreads, tc_dq_smem<D>(), stream>>>(
        tq, tk, tv, tg, lse, delta, static_cast<TO*>(dq), strides_at(s, 0), strides_at(s, 1),
        strides_at(s, 2), strides_at(s, 4), strides_at(s, 5), heads, n, scale);
  } else {
    const dim3 grid((n + kTile - 1) / kTile, batch * heads);
    auto dkv = attn_bwd_dkv_kernel<T, D>;
    if ((err = allow_smem(dkv, dkv_smem<D>())) != cudaSuccess) return err;
    dkv<<<grid, kThreads, dkv_smem<D>(), stream>>>(
        tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), strides_at(s, 0),
        strides_at(s, 1), strides_at(s, 2), strides_at(s, 4), strides_at(s, 6),
        strides_at(s, 7), heads, n, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    auto dqk = attn_bwd_dq_kernel<T, D>;
    if ((err = allow_smem(dqk, dq_smem<D>())) != cudaSuccess) return err;
    dqk<<<grid, kThreads, dq_smem<D>(), stream>>>(
        tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), strides_at(s, 0), strides_at(s, 1),
        strides_at(s, 2), strides_at(s, 4), strides_at(s, 5), heads, n, scale);
  }
  return cudaGetLastError();
}

bool valid(int batch, int heads, int n) {
  return batch >= 1 && heads >= 1 && n >= 1 && static_cast<int64_t>(batch) * heads <= 65535;
}

// go(T{}, TO{}, std::integral_constant<int, D>{}) for dtype 0 (fp32) or 1
// (bf16), out_dtype 0 (fp32) or the dtype, and head_dim D of 16, 32, 64 or
// 128; cudaErrorInvalidValue for any other.
template <typename Go>
cudaError_t by_type_and_dim(int dtype, int out_dtype, int head_dim, Go go) {
  auto by_dim = [&](auto t, auto to) -> cudaError_t {
    switch (head_dim) {
      case 16: return go(t, to, std::integral_constant<int, 16>{});
      case 32: return go(t, to, std::integral_constant<int, 32>{});
      case 64: return go(t, to, std::integral_constant<int, 64>{});
      case 128: return go(t, to, std::integral_constant<int, 128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0 && out_dtype == 0) return by_dim(float{}, float{});
  if (dtype == 1 && out_dtype == 1) return by_dim(bf16{}, bf16{});
  if (dtype == 1 && out_dtype == 0) return by_dim(bf16{}, float{});
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out and lse (fp32, B x H x N contiguous) of softmax(Q.K^T / sqrt(D)).V.
// strides: 3 int64 (batch, token, head) for each of q, k, v, out, in that
// order. dtype 0 = fp32, 1 = bf16, of q, k and v; out_dtype that of out: the
// dtype, or 0 (fp32) for bf16 inputs; head_dim 16, 32, 64 or 128. Returns a
// cudaError_t.
int attn_forward(const void* q, const void* k, const void* v, void* out, float* lse,
                 const int64_t* strides, int batch, int heads, int n, int head_dim, int dtype,
                 int out_dtype, void* stream) {
  if (!valid(batch, heads, n)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto t, auto to, auto d) {
    using T = decltype(t);
    using TO = decltype(to);
    return launch_forward<T, TO, decltype(d)::value>(q, k, v, out, lse, strides, batch, heads,
                                                     n, st);
  };
  return static_cast<int>(by_type_and_dim(dtype, out_dtype, head_dim, go));
}

// dq, dk, dv of the forward above for the incoming gradient g of out; delta
// is fp32 scratch of B x H x N. strides: 3 int64 for each of q, k, v, out,
// g, dq, dk, dv, in that order. out and g are of dtype; grad_dtype is that
// of dq, dk and dv: the dtype, or 0 (fp32) for bf16 inputs. Returns a
// cudaError_t.
int attn_backward(const void* q, const void* k, const void* v, const void* out, const void* g,
                  const float* lse, float* delta, void* dq, void* dk, void* dv,
                  const int64_t* strides, int batch, int heads, int n, int head_dim, int dtype,
                  int grad_dtype, void* stream) {
  if (!valid(batch, heads, n)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto t, auto to, auto d) {
    using T = decltype(t);
    using TO = decltype(to);
    return launch_backward<T, TO, decltype(d)::value>(q, k, v, out, g, lse, delta, dq, dk, dv,
                                                      strides, batch, heads, n, st);
  };
  return static_cast<int>(by_type_and_dim(dtype, grad_dtype, head_dim, go));
}

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
