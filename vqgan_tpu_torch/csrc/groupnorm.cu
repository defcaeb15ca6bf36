// Fused fp32 GroupNorm (+ optional swish), forward and backward, over
// channels-last activations, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vqgan_tpu/ops/pallas/groupnorm.py:
// fused_group_norm (_stats_kernel and _apply_kernel, plus the XLA glue between
// them that turns the partial sums into mean and rstd), and _pallas_gn_bwd
// (_bwd_stats_kernel and _bwd_dx_kernel, plus the XLA glue that turns their
// sums into dgamma, dbeta and the dx coefficients).
//
// The activation is read as x[B][S][C] (NCHW in torch.channels_last memory
// format is physically NHWC). Groups are torch's: channel c is in group
// c / (C / G). The forward is three launches on the caller's stream:
//
//   gn_stats_kernel     grid (n_tiles, B). A block reads rows_per_tile
//                       contiguous rows of C channels, accumulates per-channel
//                       sum(x) and sum(x^2) in fp32, folds them to its groups
//                       in a fixed order and writes partial[b][tile][2][G].
//   gn_finalize_kernel  grid (B). Sums a batch's partials over tiles in a
//                       fixed order; mean = s1/n, var = s2/n - mean^2 (the reference's
//                       E[x^2] - mu^2 form), rstd = rsqrt(var + eps);
//                       writes stats[b][2][G].
//   gn_apply_kernel     grid (n_tiles, B). Builds the per-channel coefficients
//                       A = rstd*gamma, B = beta - mean*A in shared memory, then
//                       writes y = x*A + B (optionally y*sigmoid(y)) in the
//                       input's dtype.
//
// The backward is three launches too. It takes x, the incoming gradient g
// (same layout and dtype) and the forward's stats, and recomputes
// yhat = x*A + B instead of reading a saved fp32 activation:
//
//   gn_bwd_stats_kernel     grid (n_tiles, B). dyhat = g (or, with swish,
//                           g*s*(1 + yhat*(1 - s)), s = sigmoid(yhat), in fp32);
//                           per-channel sums of dyhat and dyhat*x over the tile's
//                           rows, written to partial[b][tile][2][C].
//   gn_bwd_finalize_kernel  grid (G). A block owns one group's channels over all
//                           batches: sums the partials over tiles in a fixed
//                           order (S0, S1 per batch and channel), folds them over
//                           the group (m1, m2), writes the dx coefficients
//                           coef[b][3][C] = (ca, cb, cc) and, summed over the
//                           batch in order, dgamma and dbeta.
//   gn_bwd_dx_kernel        grid (n_tiles, B). Recomputes dyhat and writes
//                           dx = dyhat*ca + x*cb + cc in the input's dtype.
//
// Every sum runs in a fixed order, so the results are deterministic (no
// atomics).
//
// Bound: device-memory bandwidth. The forward reads the activation twice and
// writes it once; the backward reads x and g twice and writes dx once; each
// against a few flops per element (about 3.35 TB/s on an H100 SXM). So every
// thread moves 16 bytes per load and store (4 fp32 or 8 bf16 channels),
// neighbouring threads touch neighbouring addresses, and the wrapper sizes
// the grid to keep several blocks resident on every SM. The partials, stats
// and coefficients are small (B * n_tiles * 2C floats at most).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;  // 16 bytes
  __device__ static void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;  // 16 bytes
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);  // round to nearest even
    }
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// Thread t of a block owns the channel pack t % (C / N) of the rows
// t / (C / N), t / (C / N) + R, ... where R = blockDim.x / (C / N).

template <typename T>
__global__ void gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                                int S, int C, int G, int rows_per_tile) {
  constexpr int N = Pack<T>::N;
  const int packs = C / N;
  const int R = blockDim.x / packs;
  const int pack = threadIdx.x % packs;
  const int r = threadIdx.x / packs;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(tile) * rows_per_tile;
  const int64_t row_end = row0 + rows_per_tile < S ? row0 + rows_per_tile : S;
  const T* xb = x + static_cast<int64_t>(b) * S * C + pack * N;

  float s1[N], s2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s1[i] = 0.f;
    s2[i] = 0.f;
  }
#pragma unroll 4
  for (int64_t row = row0 + r; row < row_end; row += R) {
    float v[N];
    Pack<T>::load(xb + row * C, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s1[i] += v[i];
      s2[i] += v[i] * v[i];
    }
  }

  extern __shared__ float sh[];  // [2][R][C]
  float* sh1 = sh;
  float* sh2 = sh + R * C;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sh1[r * C + pack * N + i] = s1[i];
    sh2[r * C + pack * N + i] = s2[i];
  }
  __syncthreads();

  const int cg = C / G;
  float* out = partial + (static_cast<int64_t>(b) * gridDim.x + tile) * 2 * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int rr = 0; rr < R; ++rr) {
      for (int c = g * cg; c < (g + 1) * cg; ++c) {
        a += sh1[rr * C + c];
        q += sh2[rr * C + c];
      }
    }
    out[g] = a;
    out[G + g] = q;
  }
}

// blockDim.x = G * lanes: lane l of group g sums tiles l, l + lanes, ...;
// lane 0 then adds the lanes' sums in lane order.
__global__ void gn_finalize_kernel(const float* __restrict__ partial, float* __restrict__ stats,
                                   int n_tiles, int G, float n, float eps) {
  const int b = blockIdx.x;
  const int lanes = blockDim.x / G;
  const int g = threadIdx.x % G;
  const int lane = threadIdx.x / G;
  const float* p = partial + static_cast<int64_t>(b) * n_tiles * 2 * G;
  float a = 0.f, q = 0.f;
#pragma unroll 4
  for (int t = lane; t < n_tiles; t += lanes) {
    a += p[t * 2 * G + g];
    q += p[t * 2 * G + G + g];
  }
  extern __shared__ float sh[];  // [2][lanes][G]
  sh[lane * G + g] = a;
  sh[(lanes + lane) * G + g] = q;
  __syncthreads();
  if (lane == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int l = 0; l < lanes; ++l) {
      s1 += sh[l * G + g];
      s2 += sh[(lanes + l) * G + g];
    }
    const float mean = s1 / n;
    const float var = s2 / n - mean * mean;
    stats[b * 2 * G + g] = mean;
    stats[b * 2 * G + G + g] = rsqrtf(var + eps);
  }
}

// The per-channel coefficients of batch b: A = rstd*gamma into sh[0, C),
// B = beta - mean*A into sh[C, 2C). The caller synchronises the block after.
__device__ void affine_coeffs(const float* __restrict__ stats, const float* __restrict__ gamma,
                              const float* __restrict__ beta, float* sh, int b, int C, int G) {
  const int cg = C / G;
  const float* st = stats + b * 2 * G;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    // the plain version's roundings: one product, then one product and one
    // difference, each rounded (no fused multiply-add)
    const float a = __fmul_rn(st[G + g], gamma[c]);
    sh[c] = a;
    sh[C + c] = __fsub_rn(beta[c], __fmul_rn(st[g], a));
  }
}

template <typename T>
__global__ void gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                                const float* __restrict__ gamma, const float* __restrict__ beta,
                                T* __restrict__ y, int S, int C, int G, int rows_per_tile,
                                int with_swish) {
  constexpr int N = Pack<T>::N;
  const int packs = C / N;
  const int R = blockDim.x / packs;
  const int pack = threadIdx.x % packs;
  const int r = threadIdx.x / packs;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;

  extern __shared__ float sh[];  // [2][C]: A then B
  affine_coeffs(stats, gamma, beta, sh, b, C, G);
  __syncthreads();

  float ca[N], cb[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ca[i] = sh[pack * N + i];
    cb[i] = sh[C + pack * N + i];
  }

  const int64_t row0 = static_cast<int64_t>(tile) * rows_per_tile;
  const int64_t row_end = row0 + rows_per_tile < S ? row0 + rows_per_tile : S;
  const int64_t base = static_cast<int64_t>(b) * S * C + pack * N;
#pragma unroll 4
  for (int64_t row = row0 + r; row < row_end; row += R) {
    float v[N];
    Pack<T>::load(x + base + row * C, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float t = __fadd_rn(__fmul_rn(v[i], ca[i]), cb[i]);
      if (with_swish) {
        t = __fmul_rn(t, 1.f / (1.f + expf(-t)));
      }
      v[i] = t;
    }
    Pack<T>::store(y + base + row * C, v);
  }
}

template <typename T>
int launch(const void* x, const float* gamma, const float* beta, void* y, float* partial,
           float* stats, int B, int S, int C, int G, int rows_per_tile, int n_tiles,
           int threads, float eps, int with_swish, cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  const int R = threads / (C / N);
  const dim3 grid(n_tiles, B);

  gn_stats_kernel<T><<<grid, threads, 2 * R * C * sizeof(float), stream>>>(
      static_cast<const T*>(x), partial, S, C, G, rows_per_tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  int lanes = 1024 / G;  // the caller keeps G <= 1024
  if (lanes > n_tiles) lanes = n_tiles;
  gn_finalize_kernel<<<B, G * lanes, 2 * G * lanes * sizeof(float), stream>>>(
      partial, stats, n_tiles, G, static_cast<float>(static_cast<int64_t>(S) * (C / G)), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  gn_apply_kernel<T><<<grid, threads, 2 * C * sizeof(float), stream>>>(
      static_cast<const T*>(x), stats, gamma, beta, static_cast<T*>(y), S, C, G, rows_per_tile,
      with_swish);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// dL/dyhat from the incoming gradient, with yhat = x*a + b recomputed with
// the forward's roundings; fp32 throughout (the Pallas backward's form).
__device__ __forceinline__ float d_yhat(float x, float g, float a, float b, int with_swish) {
  if (!with_swish) return g;
  const float y = __fadd_rn(__fmul_rn(x, a), b);
  const float s = 1.f / (1.f + expf(-y));
  // g * s * (1 + y * (1 - s)), each operation rounded like the plain version's
  return __fmul_rn(__fmul_rn(g, s), __fadd_rn(1.f, __fmul_rn(y, __fsub_rn(1.f, s))));
}

template <typename T>
__global__ void gn_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                    const float* __restrict__ stats,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta, float* __restrict__ partial,
                                    int S, int C, int G, int rows_per_tile, int with_swish) {
  constexpr int N = Pack<T>::N;
  const int packs = C / N;
  const int R = blockDim.x / packs;
  const int pack = threadIdx.x % packs;
  const int r = threadIdx.x / packs;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;

  extern __shared__ float sh[];  // [2][C] A and B, then [2][R][C] the rows' sums
  affine_coeffs(stats, gamma, beta, sh, b, C, G);
  __syncthreads();
  float ca[N], cb[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ca[i] = sh[pack * N + i];
    cb[i] = sh[C + pack * N + i];
  }

  const int64_t row0 = static_cast<int64_t>(tile) * rows_per_tile;
  const int64_t row_end = row0 + rows_per_tile < S ? row0 + rows_per_tile : S;
  const int64_t base = static_cast<int64_t>(b) * S * C + pack * N;
  float s0[N], s1[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s0[i] = 0.f;
    s1[i] = 0.f;
  }
#pragma unroll 4
  for (int64_t row = row0 + r; row < row_end; row += R) {
    float xv[N], gv[N];
    Pack<T>::load(x + base + row * C, xv);
    Pack<T>::load(g + base + row * C, gv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float dy = d_yhat(xv[i], gv[i], ca[i], cb[i], with_swish);
      s0[i] += dy;
      s1[i] += dy * xv[i];
    }
  }

  float* red0 = sh + 2 * C;
  float* red1 = red0 + R * C;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    red0[r * C + pack * N + i] = s0[i];
    red1[r * C + pack * N + i] = s1[i];
  }
  __syncthreads();

  float* out = partial + (static_cast<int64_t>(b) * gridDim.x + tile) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int rr = 0; rr < R; ++rr) {
      a += red0[rr * C + c];
      q += red1[rr * C + c];
    }
    out[c] = a;
    out[C + c] = q;
  }
}

// grid (G), blockDim.x = cg * lanes (cg = C / G): thread (lane, k) owns
// channel c = g*cg + k; lane l sums tiles l, l + lanes, ...; lane 0 adds the
// lanes' sums in lane order, thread 0 folds the group's channels in order.
__global__ void gn_bwd_finalize_kernel(const float* __restrict__ partial,
                                       const float* __restrict__ stats,
                                       const float* __restrict__ gamma,
                                       float* __restrict__ coef, float* __restrict__ dgamma,
                                       float* __restrict__ dbeta, int B, int n_tiles, int C,
                                       int G, float n) {
  const int grp = blockIdx.x;
  const int cg = C / G;
  const int lanes = blockDim.x / cg;
  const int k = threadIdx.x % cg;
  const int lane = threadIdx.x / cg;
  const int c = grp * cg + k;
  const float gam = gamma[c];

  extern __shared__ float sh[];  // [2][lanes][cg] sums, [2][cg] gamma*S, [2] m1 m2
  float* red0 = sh;
  float* red1 = red0 + lanes * cg;
  float* gs0 = red1 + lanes * cg;
  float* gs1 = gs0 + cg;
  float* m = gs1 + cg;

  float dg = 0.f, db = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = partial + static_cast<int64_t>(b) * n_tiles * 2 * C;
    float a = 0.f, q = 0.f;
#pragma unroll 4
    for (int t = lane; t < n_tiles; t += lanes) {
      a += p[static_cast<int64_t>(t) * 2 * C + c];
      q += p[static_cast<int64_t>(t) * 2 * C + C + c];
    }
    red0[lane * cg + k] = a;
    red1[lane * cg + k] = q;
    __syncthreads();
    float s0 = 0.f, s1 = 0.f;  // meaningful in lane 0
    if (lane == 0) {
      for (int l = 0; l < lanes; ++l) {
        s0 += red0[l * cg + k];
        s1 += red1[l * cg + k];
      }
      gs0[k] = gam * s0;
      gs1[k] = gam * s1;
    }
    __syncthreads();
    const float mean = stats[b * 2 * G + grp];
    const float rstd = stats[b * 2 * G + G + grp];
    if (threadIdx.x == 0) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < cg; ++j) {
        a0 += gs0[j];
        a1 += gs1[j];
      }
      m[0] = a0 / n;
      m[1] = rstd * (a1 / n) - mean * rstd * (a0 / n);
    }
    __syncthreads();
    if (lane == 0) {
      const float m1 = m[0], m2 = m[1];
      dg += rstd * (s1 - mean * s0);
      db += s0;
      float* cf = coef + static_cast<int64_t>(b) * 3 * C;
      cf[c] = rstd * gam;
      cf[C + c] = -rstd * rstd * m2;
      cf[2 * C + c] = mean * rstd * rstd * m2 - rstd * m1;
    }
    __syncthreads();  // red0, red1 and m are written again for the next batch
  }
  if (lane == 0) {
    dgamma[c] = dg;
    dbeta[c] = db;
  }
}

template <typename T>
__global__ void gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                 const float* __restrict__ stats, const float* __restrict__ gamma,
                                 const float* __restrict__ beta, const float* __restrict__ coef,
                                 T* __restrict__ dx, int S, int C, int G, int rows_per_tile,
                                 int with_swish) {
  constexpr int N = Pack<T>::N;
  const int packs = C / N;
  const int R = blockDim.x / packs;
  const int pack = threadIdx.x % packs;
  const int r = threadIdx.x / packs;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;

  extern __shared__ float sh[];  // [5][C]: A, B, ca, cb, cc
  affine_coeffs(stats, gamma, beta, sh, b, C, G);
  const float* cf = coef + static_cast<int64_t>(b) * 3 * C;
  for (int c = threadIdx.x; c < 3 * C; c += blockDim.x) {
    sh[2 * C + c] = cf[c];
  }
  __syncthreads();
  float a[N], bb[N], ka[N], kb[N], kc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = pack * N + i;
    a[i] = sh[c];
    bb[i] = sh[C + c];
    ka[i] = sh[2 * C + c];
    kb[i] = sh[3 * C + c];
    kc[i] = sh[4 * C + c];
  }

  const int64_t row0 = static_cast<int64_t>(tile) * rows_per_tile;
  const int64_t row_end = row0 + rows_per_tile < S ? row0 + rows_per_tile : S;
  const int64_t base = static_cast<int64_t>(b) * S * C + pack * N;
#pragma unroll 4
  for (int64_t row = row0 + r; row < row_end; row += R) {
    float xv[N], gv[N];
    Pack<T>::load(x + base + row * C, xv);
    Pack<T>::load(g + base + row * C, gv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float dy = d_yhat(xv[i], gv[i], a[i], bb[i], with_swish);
      // the plain version's order: (dy*ca + x*cb) + cc, each rounded
      gv[i] = __fadd_rn(__fadd_rn(__fmul_rn(dy, ka[i]), __fmul_rn(xv[i], kb[i])), kc[i]);
    }
    Pack<T>::store(dx + base + row * C, gv);
  }
}

template <typename T>
int launch_backward(const void* x, const void* g, const float* stats, const float* gamma,
                    const float* beta, void* dx, float* partial, float* coef, float* dgamma,
                    float* dbeta, int B, int S, int C, int G, int rows_per_tile, int n_tiles,
                    int threads, int with_swish, cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  const int R = threads / (C / N);
  const dim3 grid(n_tiles, B);

  gn_bwd_stats_kernel<T><<<grid, threads, (2 * C + 2 * R * C) * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), stats, gamma, beta, partial, S, C, G,
      rows_per_tile, with_swish);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int cg = C / G;
  int lanes = 512 / cg;  // the caller keeps cg <= 1024
  if (lanes < 1) lanes = 1;
  if (lanes > n_tiles) lanes = n_tiles;
  gn_bwd_finalize_kernel<<<G, cg * lanes, (2 * lanes * cg + 2 * cg + 2) * sizeof(float),
                           stream>>>(
      partial, stats, gamma, coef, dgamma, dbeta, B, n_tiles, C, G,
      static_cast<float>(static_cast<int64_t>(S) * cg));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  gn_bwd_dx_kernel<T><<<grid, threads, 5 * C * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), stats, gamma, beta, coef,
      static_cast<T*>(dx), S, C, G, rows_per_tile, with_swish);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y). gamma, beta: fp32 (C,).
// partial: fp32 (B, n_tiles, 2, G) scratch; stats: fp32 (B, 2, G) (mean, rstd).
// The caller checks shapes, alignment and the launch geometry; returns the
// cudaError_t of the first failed launch, or 0.
int gn_forward(const void* x, const void* gamma, const void* beta, void* y, void* partial,
               void* stats, int B, int S, int C, int G, int rows_per_tile, int n_tiles,
               int threads, float eps, int with_swish, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* p = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
  if (dtype == 0) {
    return launch<float>(x, g, bt, y, p, st, B, S, C, G, rows_per_tile, n_tiles, threads, eps,
                         with_swish, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, g, bt, y, p, st, B, S, C, G, rows_per_tile, n_tiles, threads,
                                 eps, with_swish, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16 (x, g and dx). stats: the forward's fp32
// (B, 2, G); gamma, beta: fp32 (C,). partial: fp32 (B, n_tiles, 2, C) scratch;
// coef: fp32 (B, 3, C) scratch; dgamma, dbeta: fp32 (C,). The caller checks
// shapes, alignment and the launch geometry; returns the cudaError_t of the
// first failed launch, or 0.
int gn_backward(const void* x, const void* g, const void* stats, const void* gamma,
                const void* beta, void* dx, void* partial, void* coef, void* dgamma,
                void* dbeta, int B, int S, int C, int G, int rows_per_tile, int n_tiles,
                int threads, int with_swish, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* p = static_cast<float*>(partial);
  float* cf = static_cast<float*>(coef);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  if (dtype == 0) {
    return launch_backward<float>(x, g, st, gm, bt, dx, p, cf, dg, db, B, S, C, G, rows_per_tile,
                                  n_tiles, threads, with_swish, s);
  }
  if (dtype == 1) {
    return launch_backward<__nv_bfloat16>(x, g, st, gm, bt, dx, p, cf, dg, db, B, S, C, G,
                                          rows_per_tile, n_tiles, threads, with_swish, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
