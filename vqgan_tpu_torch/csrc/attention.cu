// Exact non-causal attention over (B, N, H, D) tensors, forward and backward,
// for Hopper (sm_90a): kernel #3 of the port.
//
// Replaces the Pallas TPU flash-attention kernel that
// vqgan_tpu/ops/flash_attention.py::flash_attention_tpu wraps
// (jax/experimental/pallas/ops/tpu/flash_attention.py: the forward
// _flash_attention_kernel and the backward _flash_attention_dkv_kernel and
// _flash_attention_dq_kernel). Scale D^-1/2, softmax statistics in fp32, O(N*D)
// residuals: the output and the per-query logsumexp (lse); no N x N matrix
// reaches device memory.
//
// Layout: q, k, v, the output and the gradients are (B, N, H, D) with any
// strides whose last is 1 and whose others are multiples of 4 elements, so
// q, k and v can be views of the qkv conv's channels-last output (token
// stride 3C). lse and delta are fp32 (B, H, N). fp32 or bf16 I/O; every
// product is an fp32 FMA on the CUDA cores, every sum fp32. For bf16 the
// kernels round where the Pallas kernel casts: P to v's type before P.V and
// to dO's before dV, dS to the input type before dK and dQ.
//
// Tiles: 64 queries by 64 keys. A block has 256 threads in a 16 x 16 grid
// (ty, tx); in a 64 x 64 score tile a thread owns rows ty*4 + i and columns
// tx + 16*j (i, j < 4), and in a 64 x D product tile rows ty*4 + i and
// columns tx*(D/16) + j. Tiles sit in shared memory as fp32 rows padded by 4
// floats, so that the float4 reads of a score tile's columns fall on 8
// distinct bank groups and a row's 16 threads read one address.
//
//   attn_fwd_kernel        grid (ceil(N / 64), B*H). Stages its q tile, then
//                          streams k/v tiles through shared memory: S = Q.K^T
//                          * scale, a running (max, sum) per row with the
//                          rescale of the O accumulator (online softmax), P
//                          written to shared memory, O += P.V. Writes O in
//                          the input type and lse = max + log(sum).
//   attn_bwd_delta_kernel  delta = sum_d dO*O per row, from O as stored.
//   attn_bwd_dkv_kernel    grid (ceil(N / 64), B*H): one k tile per block,
//                          looping over q tiles. Recomputes S^T = K.Q^T and
//                          P^T = exp(S^T - lse), dP^T = V.dO^T, dS^T = P^T *
//                          (dP^T - delta) * scale; dV += P^T.dO, dK += dS^T.Q.
//   attn_bwd_dq_kernel     grid (ceil(N / 64), B*H): one q tile per block,
//                          looping over k tiles. Recomputes S, P, dP, dS;
//                          dQ += dS.K.
// Every output entry is summed by one thread in a fixed order: no atomics,
// deterministic. The ragged last tile is masked (any N >= 1). D is a template
// parameter: 32 or 64.
//
// Bound: operations. The forward does 4*B*H*N^2*D flops (two products), the
// backward 14 (seven products: the dK/dV and dQ kernels each recompute S and
// dP, the price of no atomics; an atomic design needs 10). At the flagship
// mid block (B = 8, N = 1024, H = 16, D = 64) that is 34.4 and 120 GFLOP
// against 67 TFLOP/s of fp32 FMA on an H100 SXM, about 0.51 and 1.8 ms; the
// bytes are ~17 MB per tensor in bf16, some 5 us each at 3.35 TB/s. A thread
// spends two 16-byte shared-memory reads on every 16 FMAs of a product, so
// the FMA pipes, not shared memory, set the pace. The tensor cores (bf16
// mma, or wgmma with TMA-fed tiles) are the next step; they are left for a
// later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T>
__device__ __forceinline__ T cast_to(float x);
template <>
__device__ __forceinline__ float cast_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 cast_to<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision (the Pallas kernel's casts before a product)
template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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
      if constexpr (kCols == 4) {
        const float4 t = *reinterpret_cast<const float4*>(row);
        mv[0] = t.x, mv[1] = t.y, mv[2] = t.z, mv[3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(row);
        mv[0] = t.x, mv[1] = t.y;
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

template <typename T, int D>
cudaError_t launch_forward(const void* q, const void* k, const void* v, void* o, float* lse,
                           const int64_t* s, int batch, int heads, int n, cudaStream_t stream) {
  auto kernel = attn_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, kThreads, fwd_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, strides_at(s, 0), strides_at(s, 1), strides_at(s, 2),
      strides_at(s, 3), heads, n, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T, int D>
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

  const dim3 grid((n + kTile - 1) / kTile, batch * heads);
  auto dkv = attn_bwd_dkv_kernel<T, D>;
  if ((err = allow_smem(dkv, dkv_smem<D>())) != cudaSuccess) return err;
  dkv<<<grid, kThreads, dkv_smem<D>(), stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), strides_at(s, 0),
      strides_at(s, 1), strides_at(s, 2), strides_at(s, 4), strides_at(s, 6), strides_at(s, 7),
      heads, n, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto dqk = attn_bwd_dq_kernel<T, D>;
  if ((err = allow_smem(dqk, dq_smem<D>())) != cudaSuccess) return err;
  dqk<<<grid, kThreads, dq_smem<D>(), stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), strides_at(s, 0), strides_at(s, 1),
      strides_at(s, 2), strides_at(s, 4), strides_at(s, 5), heads, n, scale);
  return cudaGetLastError();
}

bool valid(int batch, int heads, int n) {
  return batch >= 1 && heads >= 1 && n >= 1 && static_cast<int64_t>(batch) * heads <= 65535;
}

}  // namespace

extern "C" {

// out and lse (fp32, B x H x N contiguous) of softmax(Q.K^T / sqrt(D)).V.
// strides: 3 int64 (batch, token, head) for each of q, k, v, out, in that
// order. dtype 0 = fp32, 1 = bf16; head_dim 32 or 64. Returns a cudaError_t.
int attn_forward(const void* q, const void* k, const void* v, void* out, float* lse,
                 const int64_t* strides, int batch, int heads, int n, int head_dim, int dtype,
                 void* stream) {
  if (!valid(batch, heads, n)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64)
    err = launch_forward<float, 64>(q, k, v, out, lse, strides, batch, heads, n, st);
  else if (dtype == 0 && head_dim == 32)
    err = launch_forward<float, 32>(q, k, v, out, lse, strides, batch, heads, n, st);
  else if (dtype == 1 && head_dim == 64)
    err = launch_forward<__nv_bfloat16, 64>(q, k, v, out, lse, strides, batch, heads, n, st);
  else if (dtype == 1 && head_dim == 32)
    err = launch_forward<__nv_bfloat16, 32>(q, k, v, out, lse, strides, batch, heads, n, st);
  return static_cast<int>(err);
}

// dq, dk, dv of the forward above for the incoming gradient g of out; delta
// is fp32 scratch of B x H x N. strides: 3 int64 for each of q, k, v, out,
// g, dq, dk, dv, in that order. Returns a cudaError_t.
int attn_backward(const void* q, const void* k, const void* v, const void* out, const void* g,
                  const float* lse, float* delta, void* dq, void* dk, void* dv,
                  const int64_t* strides, int batch, int heads, int n, int head_dim, int dtype,
                  void* stream) {
  if (!valid(batch, heads, n)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64)
    err = launch_backward<float, 64>(q, k, v, out, g, lse, delta, dq, dk, dv, strides, batch,
                                     heads, n, st);
  else if (dtype == 0 && head_dim == 32)
    err = launch_backward<float, 32>(q, k, v, out, g, lse, delta, dq, dk, dv, strides, batch,
                                     heads, n, st);
  else if (dtype == 1 && head_dim == 64)
    err = launch_backward<__nv_bfloat16, 64>(q, k, v, out, g, lse, delta, dq, dk, dv, strides,
                                             batch, heads, n, st);
  else if (dtype == 1 && head_dim == 32)
    err = launch_backward<__nv_bfloat16, 32>(q, k, v, out, g, lse, delta, dq, dk, dv, strides,
                                             batch, heads, n, st);
  return static_cast<int>(err);
}

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
