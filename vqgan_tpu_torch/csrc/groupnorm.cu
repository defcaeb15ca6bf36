// Fused fp32 GroupNorm (+ optional swish), forward and backward, over
// channels-last activations, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vqgan_tpu/ops/pallas/groupnorm.py:
// fused_group_norm (_stats_kernel and _apply_kernel, plus the XLA glue between
// them that turns the partial sums into mean and rstd), and _pallas_gn_bwd
// (_bwd_stats_kernel and _bwd_dx_kernel, plus the XLA glue that turns their
// sums into dgamma, dbeta and the dx coefficients), in one launch.
//
// The activation is read as x[B][S][C] (NCHW in torch.channels_last memory
// format is physically NHWC). Groups are torch's: channel c is in group
// c / (C / G).
//
// The forward is one launch of thread-block clusters (gn_fwd_kernel). It walks
// the call in units, as the backward does: one sample b and a slice of whole
// groups over all S rows (the wrapper's plan, ops/groupnorm_cuda.py::
// forward_plan, takes the slice from the backward's rule). As many clusters
// of 1-16 blocks as the device holds at once each take a unit at a time;
// block r of a cluster takes the r-th range of the unit's rows:
//   1. each thread loads its rows into its own slots of shared memory by
//      cp.async, in rounds of up to `slots` 16-byte packs (most plans: one
//      round, the whole unit on chip), and sums x and x^2 (fused
//      multiply-adds) in order; the block's channel sums and group sums in a
//      fixed order into its own shared memory;
//   2. barrier.cluster; every block reads the cluster's group sums through
//      distributed shared memory and adds them in block rank order, itself,
//      so that every block holds the same mean = s1/n, var = s2/n - mean^2
//      (the reference's E[x^2] - mu^2 form), rstd = rsqrt(var + eps); the
//      unit's first block writes them to stats[b][2][G];
//   3. A = rstd*gamma, B = beta - mean*A per channel; y = x*A + B
//      (optionally y*sigmoid(y)) in the input's dtype, from the slots (the
//      rounds before the last loaded again, from L2); as the last round's
//      slots free, the next unit's first round loads into them.
// x is read from device memory once and y written once. No grid-wide
// barrier, no float atomics: the result is deterministic.
//
// The backward is one persistent cooperative launch that walks the call in
// units: one sample b and a slice of whole groups over all S rows. The
// blocks of a team share a unit: each takes a range of its rows (and, where
// the slice is wider than kBwdMaxSlicePacks 16-byte packs, a column block of it),
// forms its partial sums in a fixed order, writes them to device memory and
// arrives at the team's counter (one integer barrier a unit); after it every
// block folds the team's partials in block order itself. The wrapper's plan
// (ops/groupnorm_cuda.py::backward_plan) picks the slice, the teams and the
// route:
//   on-chip  a block's rows of a unit sit in shared memory (16-byte
//            cp.async into per-thread slots), so x and g cross device memory
//            once, and the next unit's loads are in flight across the
//            barrier (x double-buffered);
//   re-read  (the kReread instances) a block streams its rows in chunks for
//            the sums and again after the barrier, for units that would fit
//            on chip only as narrow row slices (the 3D steps' 262,144-row
//            calls at C = 64 and 128) or not at all.
// gn_bwd_kernel takes x, the incoming gradient g (same layout and dtype) and
// the forward's stats, recomputes yhat = x*A + B instead of reading a saved
// fp32 activation, and keeps dyhat in registers:
//   dyhat = g (or, with swish, g*s*(1 + yhat*(1 - s)), s = sigmoid(yhat), in
//   fp32), computed once per element; per-channel S0 = Σ dyhat and
//   S1 = Σ dyhat*x over the block's rows; the block's partials to device
//   memory; the barrier, after which every block sums the team's per-group
//   partials in block order into m1, m2 and the dx coefficients (ca, cb, cc),
//   while the next unit's x and g are already in flight; then dx = dyhat*ca +
//   x*cb + cc from the chip in the input's dtype. dgamma and dbeta are summed
//   over the batch in order at the end.
//
// Every float sum runs in a fixed order, so the results are deterministic;
// the only atomics are the barriers' integer counters, which the launch
// function zeroes on the stream before the kernel (a CUDA graph captures
// both).
//
// Bound: device-memory bandwidth. The forward reads the activation once
// (and the rounds a cluster cannot hold again, from L2) and writes it once;
// the backward reads x and g once and writes dx once; each against a few
// flops per element (about 3.35 TB/s on an H100 SXM). So every thread moves
// 16 bytes per load and store (4 fp32 or 8 bf16 channels), neighbouring
// threads touch neighbouring addresses; the forward keeps one or two blocks
// of 256 threads on every SM, as its shared memory allows; the backward holds
// two blocks of 256 threads on every SM, each with 96 KB of x and g slots
// and 64 (bf16) or 32 (fp32) dyhat registers a thread, so that one block's
// arithmetic and barriers overlap the other's loads. The partials, stats
// and coefficients are small (a few floats per channel and block).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"  // cp.async

namespace {

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;  // 16 bytes
  __device__ static void unpack(const uint4& q, float* v) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  __device__ static void load(const float* p, float* v) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<uint4*>(p) = pack(v);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;  // 16 bytes
  __device__ static void unpack(const uint4& q, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);  // round to nearest even
    }
    return q;
  }
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint4*>(p) = pack(v);
  }
};

// ---------------------------------------------------------------------------
// backward: one persistent cooperative launch
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdBlocksPerSm = 2;  // two blocks interleave their phases on an SM
constexpr int kBwdPacks = 8;     // 16-byte packs of a unit's x, g a backward thread holds
constexpr int kBwdMaxSlicePacks = 40;  // 16-byte packs of a block's row slice, at most

// The sums' scratch in floats: the shared-memory row sums of the widest
// slice, one s0 (or s1) row per row in flight plus one row of results.
template <int N>
constexpr int kRedFloats = (kBwdThreads + kBwdMaxSlicePacks) * N;

// The backward wrapper's plan (ops/groupnorm_cuda.py::backward_plan).
struct Plan {
  int B, S, C, G;
  int width;           // channels of a unit's slice: whole groups
  int team_blocks;     // blocks that share a unit
  int teams;           // teams walk units team, team + teams, ...
  int rows_per_block;  // of a unit's S rows
  int col_blocks;      // column blocks a unit's slice is split over
  int block_width;     // channels of a column block (the last may be narrower)
  float n;             // S * C / G, the elements of a group
};

// A block's part of every unit: rows [row0, row_end) and channels [boff,
// boff + bw) of the unit's slice. Thread t owns the channel pack cp = t % pw
// of rows rl, rl + rows_in_flight, ... where rl = t / pw; the threads past
// rows_in_flight * pw (where pw does not divide the block) sit idle in the
// loads and take no part in the sums.
struct Part {
  int team, j, boff, bw, pw, rows_in_flight, cp, rl, row0, row_end, slices, units, cg, gw;
  bool active;
  __device__ Part(const Plan& p, int N) {
    team = blockIdx.x / p.team_blocks;
    j = blockIdx.x % p.team_blocks;
    boff = (j % p.col_blocks) * p.block_width;
    bw = min(p.block_width, p.width - boff);
    pw = bw / N;
    rows_in_flight = kBwdThreads / pw;
    cp = threadIdx.x % pw;
    rl = threadIdx.x / pw;
    active = rl < rows_in_flight;
    row0 = (j / p.col_blocks) * p.rows_per_block;
    row_end = min(p.S, row0 + p.rows_per_block);
    slices = p.C / p.width;
    units = p.B * slices;
    cg = p.C / p.G;
    gw = p.width / cg;
  }
};

// The words of the sync counters, rounded up to 16 bytes.
inline int sync_words(int teams) { return (teams + 2 + 3) / 4 * 4; }

__device__ __forceinline__ void compiler_fence() { asm volatile("" ::: "memory"); }

#ifdef GN_BWD_TRACE
// A diagnostic build's phase clock: thread 0 of each block stamps the global
// timer at the phase boundaries of each unit, trace[block][seq][phase].
__device__ long long* g_trace;
constexpr int kTracePhases = 6, kTraceUnits = 64;
#define TRACE(phase)                                                                   \
  if (threadIdx.x == 0 && g_trace != nullptr && seq < kTraceUnits) {                    \
    long long t;                                                                       \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                              \
    g_trace[(static_cast<int64_t>(blockIdx.x) * kTraceUnits + seq) * kTracePhases + (phase)] = t; \
  }
#else
#define TRACE(phase)
#endif

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Thread 0 of every block adds the block to `counter` and waits until it
// reaches `target`; the block's writes before the call are visible to every
// block after it. The caller synchronises the block after.
__device__ __forceinline__ void arrive_and_wait(int* counter, int target) {
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1);
    while (ld_acquire(counter) < target) __nanosleep(16);
    __threadfence();
  }
}

// Sums each of V chains of R values val(r, v) in a fixed order into red[v]:
// lane l of a chain (L lanes: at most 16, and L * V <= cap floats of red)
// adds rows l, l + L, ... in order into red[l * V + v], then thread v adds
// the lanes' sums in lane order. Every thread of the block calls it; it
// begins and ends with __syncthreads.
template <typename Val>
__device__ __forceinline__ void ordered_sums(float* red, int R, int V, int cap, Val val) {
  int lanes = kBwdThreads / V;
  if (lanes > 16) lanes = 16;
  if (lanes > R) lanes = R;
  if (lanes > cap / V) lanes = cap / V;
  if (lanes < 1) lanes = 1;
  __syncthreads();
  for (int task = threadIdx.x; task < lanes * V; task += kBwdThreads) {
    const int l = task / V, v = task % V;
    float acc = 0.f;
#pragma unroll 8
    for (int r = l; r < R; r += lanes) acc += val(r, v);
    red[l * V + v] = acc;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < V; v += kBwdThreads) {
    float acc = red[v];
    for (int l = 1; l < lanes; ++l) acc += red[l * V + v];
    red[v] = acc;
  }
  __syncthreads();
}

// The block's sums of each thread's per-channel partials s0[N], s1[N] over
// its rows, into red[0, bw) and red[bw, 2 bw), in a fixed order. Where a
// row's pw packs are a power of two up to 16, the lanes of a warp that share
// a channel pack add their rows by a xor butterfly (every lane gets the same
// sum), then the warps are added in order; otherwise each row's s0 goes
// through shared memory and is added in row order, then each row's s1. red
// (kRedFloats<N>, or forward_red_floats) must be free; every thread calls
// it; it ends with __syncthreads. Q: the backward's Part or the forward's
// FwdPart (a block of kBwdThreads threads either way).
template <int N, typename Q>
__device__ __forceinline__ void block_channel_sums(float* red, float (&s0)[N], float (&s1)[N],
                                                   const Q& q) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bw = q.bw, V = 2 * bw;
  if (q.pw <= 16 && (q.pw & (q.pw - 1)) == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      for (int off = q.pw; off < 32; off <<= 1) {
        s0[n] += __shfl_xor_sync(0xffffffffu, s0[n], off);
        s1[n] += __shfl_xor_sync(0xffffffffu, s1[n], off);
      }
    }
    if (lane < q.pw) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        red[warp * V + q.cp * N + n] = s0[n];
        red[warp * V + bw + q.cp * N + n] = s1[n];
      }
    }
    __syncthreads();
    // V <= 32 * N <= kBwdThreads: one chain a thread; thread v alone reads
    // red[v] and writes it
    for (int v = tid; v < V; v += kBwdThreads) {
      float sum = red[v];
      for (int k = 1; k < kBwdThreads / 32; ++k) sum += red[k * V + v];
      red[v] = sum;
    }
  } else {
    // rows_in_flight * bw <= kBwdThreads * N: row r of the s0 pass at red[r *
    // bw], of the s1 pass at red[bw + r * bw]; each column's sum replaces
    // its row 0, which only its own thread reads
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      float* rows = red + pass * bw;
      if (q.active) {
#pragma unroll
        for (int n = 0; n < N; ++n) rows[q.rl * bw + q.cp * N + n] = pass ? s1[n] : s0[n];
      }
      __syncthreads();
#pragma unroll 1
      for (int v = tid; v < bw; v += kBwdThreads) {
        float sum = rows[v];
        for (int r = 1; r < q.rows_in_flight; ++r) sum += rows[r * bw + v];
        rows[v] = sum;
      }
      __syncthreads();
    }
    return;
  }
  __syncthreads();
}

// Group q (< 2 gw: the gw groups of the unit's Σ0 terms, then of its Σ1
// terms) of the block's per-channel sums in red[0, 2 bw): the sum, in
// channel order, over the block's channels that fall in the group (0 where
// none do).
template <typename Q>
__device__ __forceinline__ float block_group_sum(const float* red, int q, const Q& p) {
  const int half = q >= p.gw, g = half ? q - p.gw : q;
  const int lo = max(g * p.cg - p.boff, 0), hi = min((g + 1) * p.cg - p.boff, p.bw);
  float acc = 0.f;
  for (int k = lo; k < hi; ++k) acc += red[half * p.bw + k];
  return acc;
}

struct BwdArgs {
  const void* x;
  const void* g;
  const float* stats;  // (B, 2, G): mean, rstd
  const float* gamma;
  const float* beta;
  void* dx;
  float* dgamma;         // (C,)
  float* dbeta;          // (C,)
  int* sync;             // [teams] arrivals, then two end-of-call counters
  float* group_partial;  // [units][team_blocks][2][gw]: a block's Σγ·S0, Σγ·S1
  float* chan_partial;   // [units][team_blocks][2][width]: a block's S0, S1
  float* per_batch;      // [B][2][C]: r·(S1 − μ·S0) and S0 of each (b, c)
  Plan p;
};

// dL/dyhat from the incoming gradient, with yhat = x*a + b recomputed with
// the forward's roundings; fp32 throughout (the Pallas backward's form). The
// sigmoid takes the fast exp and division (a few ulps; the card's checks hold
// dx within one bf16 ulp, or ATOL_DX in fp32, of the plain version).
__device__ __forceinline__ float d_yhat(float x, float g, float a, float b) {
  const float y = __fadd_rn(__fmul_rn(x, a), b);
  const float s = __fdividef(1.f, 1.f + __expf(-y));
  // g * s * (1 + y * (1 - s)), each operation rounded like the plain version's
  return __fmul_rn(__fmul_rn(g, s), __fadd_rn(1.f, __fmul_rn(y, __fsub_rn(1.f, s))));
}

// Thread t owns the channel pack cp of its rows (Part), kBwdPacks of them a
// chunk, and keeps a unit's on chip: x and g in its own shared-memory slots
// (x double-buffered), dyhat in registers. The block's channels' parameters
// (the swish's A, B; gamma, mean, rstd) are fetched a unit ahead and staged
// in shared memory. Per unit:
//   1. wait for its x and g (cp.async), start the next unit's x and fetch
//      its parameters;
//   2. dyhat once per element, per-channel S0 = Σ dyhat and S1 = Σ dyhat·x;
//      start the next unit's g into the freed slots;
//   3. the block's S0, S1 (block_channel_sums) and, per group, Σ γ·S0 and
//      Σ γ·S1 to device memory; arrive at the team's counter and wait for
//      the team (one integer barrier);
//   4. every block sums the team's group partials in block order and forms
//      m1, m2 and the dx coefficients (ca, cb, cc) of its channels, the
//      finalize of the Pallas backward; dx = (dyhat·ca + x·cb) + cc from the
//      slots and the registers.
// With kReread a block streams its rows of a unit in chunks of kBwdPacks
// packs a thread through the same slots, once for step 2 and again after the
// barrier for dx, dyhat computed in each pass.
// dgamma and dbeta need the per-channel sums only, so they wait for the end:
// after a grid barrier each block sums the channel partials of some (unit,
// column block) pairs in block order, and after another, block 0 sums them
// over the batch in order.
template <typename T, bool kSwish, bool kReread>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm) gn_bwd_kernel(const BwdArgs a) {
  constexpr int N = Pack<T>::N;
  constexpr int kMaxWidth = kBwdMaxSlicePacks * N;
  constexpr int kRed = kRedFloats<N>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* xs = reinterpret_cast<uint4*>(smem);  // [2][kBwdPacks][kBwdThreads]
  uint4* gs = xs + 2 * kBwdPacks * kBwdThreads;   // [kBwdPacks][kBwdThreads]
  float* red = reinterpret_cast<float*>(gs + kBwdPacks * kBwdThreads);  // [kRed]
  float* prm = red + kRed;  // [5][kMaxWidth]: A, B, gamma, mean, rstd; then A, B, ca, cb, cc

  const Plan& P = a.p;
  const Part q(P, N);
  const int tid = threadIdx.x;
  const int w = P.width, V = 2 * w;
  // a chunk: kBwdPacks * rows_in_flight rows of the block's, held on chip at
  // once (the on-chip route's unit has one)
  const int chunk_rows = kBwdPacks * q.rows_in_flight;
  const int chunks = (max(q.row_end - q.row0, 0) + chunk_rows - 1) / chunk_rows;
  const int stride = q.rows_in_flight * P.C;  // elements between a thread's rows
  int* arrivals = a.sync + q.team;
  int* done = a.sync + P.teams;
  const T* xg = static_cast<const T*>(a.x);
  const T* gg = static_cast<const T*>(a.g);
  T* dxg = static_cast<T*>(a.dx);

  // this thread's packs of chunk k: rows row0 + k * chunk_rows + rl +
  // i * rows_in_flight, i < packs_in(k)
  auto packs_in = [&](int k) {
    const int left = q.row_end - q.row0 - k * chunk_rows - q.rl;
    return !q.active || left <= 0
               ? 0
               : min(kBwdPacks, (left + q.rows_in_flight - 1) / q.rows_in_flight);
  };
  auto base_of = [&](int u, int k) -> int64_t {
    const int b = u / q.slices, c0 = (u % q.slices) * w + q.boff;
    return (static_cast<int64_t>(b) * P.S + q.row0 + k * chunk_rows + q.rl) * P.C + c0 +
           q.cp * N;
  };
  // cp.async of the thread's packs of chunk k of unit u into its slots
  // (zeros past its rows)
  auto load = [&](const T* src, uint4* dst, int u, int k) {
    const T* p = src + base_of(u, k);
    const int n = packs_in(k);
#pragma unroll
    for (int i = 0; i < kBwdPacks; ++i) {
      const bool ok = i < n;
      cp_async16(smem_addr(dst + i * kBwdThreads + tid), ok ? p + i * stride : src, ok ? 16 : 0);
    }
  };
  // the parameters of the block's channel tid of unit u, fetched into
  // registers, then staged with those of its channels past kBwdThreads (the
  // caller synchronises the block after)
  float f_gam = 0.f, f_beta = 0.f, f_mean = 0.f, f_rstd = 0.f;
  auto params_of = [&](int u, int v, float& gam, float& beta, float& mean, float& rstd) {
    const int b = u / q.slices, c = (u % q.slices) * w + q.boff + v;
    gam = __ldg(a.gamma + c);
    beta = __ldg(a.beta + c);
    mean = __ldg(a.stats + b * 2 * P.G + c / q.cg);
    rstd = __ldg(a.stats + b * 2 * P.G + P.G + c / q.cg);
  };
  auto fetch = [&](int u) {
    if (tid < q.bw && u < q.units) params_of(u, tid, f_gam, f_beta, f_mean, f_rstd);
  };
  auto stage_one = [&](int v, float gam, float beta, float mean, float rstd) {
    // the forward's roundings
    const float A = __fmul_rn(rstd, gam);
    prm[v] = A;
    prm[kMaxWidth + v] = __fsub_rn(beta, __fmul_rn(mean, A));
    prm[2 * kMaxWidth + v] = gam;
    prm[3 * kMaxWidth + v] = mean;
    prm[4 * kMaxWidth + v] = rstd;
  };
  auto stage = [&](int u) {
    if (tid < q.bw) stage_one(tid, f_gam, f_beta, f_mean, f_rstd);
#pragma unroll 1
    for (int v = tid + kBwdThreads; v < q.bw && u < q.units; v += kBwdThreads) {
      float gam, beta, mean, rstd;
      params_of(u, v, gam, beta, mean, rstd);
      stage_one(v, gam, beta, mean, rstd);
    }
  };
  // dyhat of one element of the thread's channel pack
  auto dyhat = [&](float x, float g, int n) {
    if constexpr (kSwish) {
      return d_yhat(x, g, prm[q.cp * N + n], prm[kMaxWidth + q.cp * N + n]);
    }
    return g;
  };

  int u = q.team, seq = 0;
  if constexpr (!kReread) {
    if (u < q.units) {
      load(xg, xs, u, 0);
      load(gg, gs, u, 0);
    }
    cp_async_commit();
  }
  fetch(u);
  stage(u);
  __syncthreads();
  for (; u < q.units; u += P.teams, ++seq) {
    const int next = u + P.teams;
    const uint4* xcur = xs + (seq & 1) * kBwdPacks * kBwdThreads;
    // 2. dyhat and the thread's per-channel sums
    float dy[kReread ? 1 : kBwdPacks][N], s0[N], s1[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      s0[n] = 0.f;
      s1[n] = 0.f;
    }
    if constexpr (!kReread) {
      // on chip: the unit's one chunk arrived while the last unit finished;
      // dyhat stays in registers for dx
      TRACE(0);
      cp_async_wait<0>();
      compiler_fence();
      TRACE(1);
      if (next < q.units) load(xg, xs + ((seq + 1) & 1) * kBwdPacks * kBwdThreads, next, 0);
      cp_async_commit();
      fetch(next);
#pragma unroll
      for (int i = 0; i < kBwdPacks; ++i) {
        float xv[N], gv[N];
        Pack<T>::load(reinterpret_cast<const T*>(xcur + i * kBwdThreads + tid), xv);
        Pack<T>::load(reinterpret_cast<const T*>(gs + i * kBwdThreads + tid), gv);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          // a slot past the rows holds zeros: dyhat 0 adds nothing
          const float d = dyhat(xv[n], gv[n], n);
          dy[i][n] = d;
          s0[n] += d;
          s1[n] += d * xv[n];
        }
      }
      compiler_fence();
      TRACE(2);
      if (next < q.units) load(gg, gs, next, 0);
      cp_async_commit();
    } else {
      // re-read: stream the block's rows chunk by chunk for the sums
      fetch(next);
      for (int k = 0; k < chunks; ++k) {
        load(xg, xs, u, k);
        load(gg, gs, u, k);
        cp_async_commit();
        cp_async_wait<0>();
        compiler_fence();
#pragma unroll
        for (int i = 0; i < kBwdPacks; ++i) {
          float xv[N], gv[N];
          Pack<T>::load(reinterpret_cast<const T*>(xs + i * kBwdThreads + tid), xv);
          Pack<T>::load(reinterpret_cast<const T*>(gs + i * kBwdThreads + tid), gv);
#pragma unroll
          for (int n = 0; n < N; ++n) {
            const float d = dyhat(xv[n], gv[n], n);
            s0[n] += d;
            s1[n] += d * xv[n];
          }
        }
        compiler_fence();
      }
    }

    // 3. the block's sums per channel and per group, the team's barrier
    block_channel_sums<N>(red, s0, s1, q);
    float* chan = a.chan_partial + (static_cast<int64_t>(u) * P.team_blocks + q.j) * V;
#pragma unroll 1
    for (int v = tid; v < 2 * q.bw; v += kBwdThreads) {
      const float sum = red[v];
      const int cl = v < q.bw ? q.boff + v : w + q.boff + (v - q.bw);
      chan[cl] = sum;
      red[v] = __fmul_rn(prm[2 * kMaxWidth + (v < q.bw ? v : v - q.bw)], sum);  // γ·S
    }
    __syncthreads();
    float* grp = a.group_partial + (static_cast<int64_t>(u) * P.team_blocks + q.j) * 2 * q.gw;
#pragma unroll 1
    for (int g = tid; g < 2 * q.gw; g += kBwdThreads) grp[g] = block_group_sum(red, g, q);
    __syncthreads();
    TRACE(3);
    arrive_and_wait(arrivals, (seq + 1) * P.team_blocks);
    TRACE(4);

    // 4. the team's group sums in block order, the coefficients, dx
    const float* team_grp = a.group_partial + static_cast<int64_t>(u) * P.team_blocks * 2 * q.gw;
    ordered_sums(red, P.team_blocks, 2 * q.gw, kRed,
                 [&](int r, int v) { return __ldcg(team_grp + r * 2 * q.gw + v); });
    // (ca, cb, cc) take the places of (gamma, mean, rstd), each thread its
    // own channel's; A and B stay for the re-read route's second dyhat
#pragma unroll 1
    for (int v = tid; v < q.bw; v += kBwdThreads) {
      const int g = (q.boff + v) / q.cg;
      const float gam = prm[2 * kMaxWidth + v];
      const float mean = prm[3 * kMaxWidth + v], rstd = prm[4 * kMaxWidth + v];
      const float m1 = red[g] / P.n;
      const float m2 = rstd * (red[q.gw + g] / P.n) - mean * rstd * (red[g] / P.n);
      prm[2 * kMaxWidth + v] = rstd * gam;
      prm[3 * kMaxWidth + v] = -rstd * rstd * m2;
      prm[4 * kMaxWidth + v] = mean * rstd * rstd * m2 - rstd * m1;
    }
    __syncthreads();
    float ka[N], kb[N], kc[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      ka[n] = prm[2 * kMaxWidth + q.cp * N + n];
      kb[n] = prm[3 * kMaxWidth + q.cp * N + n];
      kc[n] = prm[4 * kMaxWidth + q.cp * N + n];
    }
    TRACE(5);
    __syncthreads();  // prm takes the next unit's parameters below
    if constexpr (!kReread) {
      T* out = dxg + base_of(u, 0);
      const int n_valid = packs_in(0);
#pragma unroll
      for (int i = 0; i < kBwdPacks; ++i) {
        if (i >= n_valid) break;
        float xv[N], o[N];
        Pack<T>::load(reinterpret_cast<const T*>(xcur + i * kBwdThreads + tid), xv);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          // the plain version's order: (dy*ca + x*cb) + cc, each rounded
          o[n] = __fadd_rn(__fadd_rn(__fmul_rn(dy[i][n], ka[n]), __fmul_rn(xv[n], kb[n])), kc[n]);
        }
        Pack<T>::store(out + i * stride, o);
      }
    } else {
      // re-read: the same chunks again, dyhat again, then dx
      for (int k = 0; k < chunks; ++k) {
        load(xg, xs, u, k);
        load(gg, gs, u, k);
        cp_async_commit();
        cp_async_wait<0>();
        compiler_fence();
        T* out = dxg + base_of(u, k);
        const int n_valid = packs_in(k);
#pragma unroll
        for (int i = 0; i < kBwdPacks; ++i) {
          if (i >= n_valid) break;
          float xv[N], gv[N], o[N];
          Pack<T>::load(reinterpret_cast<const T*>(xs + i * kBwdThreads + tid), xv);
          Pack<T>::load(reinterpret_cast<const T*>(gs + i * kBwdThreads + tid), gv);
#pragma unroll
          for (int n = 0; n < N; ++n) {
            const float d = dyhat(xv[n], gv[n], n);
            o[n] = __fadd_rn(__fadd_rn(__fmul_rn(d, ka[n]), __fmul_rn(xv[n], kb[n])), kc[n]);
          }
          Pack<T>::store(out + i * stride, o);
        }
        compiler_fence();
      }
      __syncthreads();  // every thread's dyhat has read A, B before they change
    }
    compiler_fence();
    stage(next);
    __syncthreads();
  }

  // dgamma and dbeta: each (unit, column block)'s channel partials in row
  // block order, then the batch in order
  __syncthreads();
  arrive_and_wait(done, gridDim.x);
  const int row_blocks = P.team_blocks / P.col_blocks;
  for (int pi = blockIdx.x; pi < q.units * P.col_blocks; pi += gridDim.x) {
    const int uu = pi / P.col_blocks, cb = pi % P.col_blocks;
    const int coff = cb * P.block_width, cw = min(P.block_width, w - coff);
    const float* chan = a.chan_partial + static_cast<int64_t>(uu) * P.team_blocks * V;
    ordered_sums(red, row_blocks, 2 * cw, kRed, [&](int r, int v) {
      return __ldcg(chan + (r * P.col_blocks + cb) * V + (v < cw ? coff + v : w + coff + v - cw));
    });
    const int b = uu / q.slices, c0 = (uu % q.slices) * w + coff;
    const float* st = a.stats + b * 2 * P.G;
    float* pb = a.per_batch + static_cast<int64_t>(b) * 2 * P.C;
    for (int cl = tid; cl < cw; cl += kBwdThreads) {
      const int c = c0 + cl;
      const float mean = st[c / q.cg], rstd = st[P.G + c / q.cg];
      pb[c] = rstd * (red[cw + cl] - mean * red[cl]);
      pb[P.C + c] = red[cl];
    }
  }
  __syncthreads();
  if (blockIdx.x != 0) {
    if (tid == 0) {
      __threadfence();
      atomicAdd(done + 1, 1);
    }
    return;
  }
  arrive_and_wait(done + 1, gridDim.x);
  __syncthreads();
  for (int c = tid; c < P.C; c += kBwdThreads) {
    float dg = 0.f, db = 0.f;
    for (int b = 0; b < P.B; ++b) {
      dg += __ldcg(a.per_batch + static_cast<int64_t>(b) * 2 * P.C + c);
      db += __ldcg(a.per_batch + static_cast<int64_t>(b) * 2 * P.C + P.C + c);
    }
    a.dgamma[c] = dg;
    a.dbeta[c] = db;
  }
}

// ---------------------------------------------------------------------------
// forward: one launch of thread-block clusters
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = kBwdThreads;  // block_channel_sums serves both
constexpr int kFwdMaxCluster = 16;        // blocks of a cluster (above 8: non-portable)

// The forward wrapper's plan (ops/groupnorm_cuda.py::forward_plan).
struct FwdPlan {
  int B, S, C, G;
  int width;           // channels of a unit's slice: whole groups, whole packs
  int rows_per_block;  // of a unit's S rows, block r of its cluster takes the r-th range
  int slots;           // 16-byte packs of its rows a thread holds in shared memory
  int halves;          // 2: the slots twice over, rounds loading while others are used
  float n;             // S * C / G, the elements of a group
  float eps;
};

// The floats of a forward block's sums' scratch (block_channel_sums): eight
// warps' rows of the two sums where a row's packs are a power of two up to 16,
// else a row of each in flight plus one.
__host__ __device__ constexpr int forward_red_floats(int width, int packs) {
  return (packs <= 16 && (packs & (packs - 1)) == 0) ? 16 * width
                                                     : (kFwdThreads / packs + 1) * width;
}

// A block's part of its unit: rows [row0, row_end) and all `width` channels
// of the unit's slice. Thread t owns the channel pack cp = t % pw of rows rl,
// rl + rows_in_flight, ... (rl = t / pw); the threads past rows_in_flight *
// pw sit idle (the fields block_channel_sums and block_group_sum read).
struct FwdPart {
  int bw, pw, rows_in_flight, cp, rl, row0, row_end, cg, gw, boff;
  bool active;
  __device__ FwdPart(const FwdPlan& p, int N, int rank) {
    bw = p.width;
    pw = bw / N;
    rows_in_flight = kFwdThreads / pw;
    cp = threadIdx.x % pw;
    rl = threadIdx.x / pw;
    active = rl < rows_in_flight;
    row0 = min(p.S, rank * p.rows_per_block);
    row_end = min(p.S, row0 + p.rows_per_block);
    cg = p.C / p.G;
    gw = p.width / cg;
    boff = 0;
  }
};

struct FwdArgs {
  const void* x;
  const float* gamma;
  const float* beta;
  void* y;
  float* stats;  // (B, 2, G): mean, rstd
  FwdPlan p;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// ŷ = x*A + B with the plain version's roundings (one product, one sum), and
// with the swish ŷ*sigmoid(ŷ), the sigmoid by the fast exp and division as in
// the backward (a few ulps; the card's checks hold y within one bf16 ulp, or
// ATOL_FP32 in fp32, of the plain version).
template <bool kSwish>
__device__ __forceinline__ float affine(float x, float a, float b) {
  const float t = __fadd_rn(__fmul_rn(x, a), b);
  if constexpr (kSwish) return __fmul_rn(t, __fdividef(1.f, 1.f + __expf(-t)));
  return t;
}

#ifdef GN_FWD_TRACE
// A diagnostic build's phase clock: thread 0 of each block stamps the global
// timer at the phase boundaries of each of its units,
// trace[block][unit][phase]: the unit's start, its first round arrived, its
// group sums written, past the cluster barrier, its coefficients ready, its
// rows of y written.
__device__ long long* g_fwd_trace;
constexpr int kFwdTracePhases = 6, kFwdTraceUnits = 16;
#define FTRACE(k, phase)                                                               \
  if (threadIdx.x == 0 && g_fwd_trace != nullptr && (k) < kFwdTraceUnits) {            \
    long long t;                                                                       \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                              \
    g_fwd_trace[(static_cast<int64_t>(blockIdx.x) * kFwdTraceUnits + (k)) *            \
                    kFwdTracePhases + (phase)] = t;                                    \
  }
#else
#define FTRACE(k, phase)
#endif

// A persistent cluster walks the units cluster, cluster + clusters, ...
// (clusters = gridDim.x / cluster size, as many as the device holds at once);
// block r of it takes the r-th range of each unit's rows. A thread takes its
// rows of a unit in rounds of up to `slots` 16-byte packs, each round one
// batch of cp.async into its own slots of shared memory (so every thread has
// a round in flight, not a few registers' worth); round r lives in half r % 2
// of its slots, so that the next round loads while this one is used:
//   pass 1: each round is summed while the next one loads (Σx, and Σx² by
//           fused multiply-adds, in order within a round; the rounds' sums
//           added in order); the last two rounds stay on chip;
//   the block's and the cluster's sums, the fold, the coefficients;
//   pass 2: y of the last two rounds, then of the rounds before them, each
//           loaded again while the one after it is written (from L2: the
//           plan keeps the units in flight within it). As a thread frees
//           each slot of round 0, it starts the next unit's round 0 into it,
//           so that unit's reads overlap this one's writes.
// Most plans hold a unit in one or two rounds. Shared memory: the slots
// [halves][slots][kFwdThreads] of 16 bytes (one half where a round holds a
// thread's rows), the sums' scratch (forward_red_floats),
// the block's group sums [2][2][gw] (read by the whole cluster; two, so that
// a block never writes the ones another may still read), the cluster's
// group sums [cluster size][2][gw] and the coefficients [2][width].
template <typename T, bool kSwish>
__global__ void __launch_bounds__(kFwdThreads, 2) gn_fwd_kernel(const FwdArgs a) {
  namespace cgr = cooperative_groups;
  constexpr int N = Pack<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdPlan& P = a.p;
  cgr::cluster_group cluster = cgr::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const FwdPart q(P, N, rank);
  const int tid = threadIdx.x, R = q.rows_in_flight, W = P.width;
  uint4* xs = reinterpret_cast<uint4*>(smem) + tid;  // this thread's slots, kFwdThreads apart
  float* red = reinterpret_cast<float*>(reinterpret_cast<uint4*>(smem) +
                                        P.halves * P.slots * kFwdThreads);
  float* gparts = red + forward_red_floats(W, q.pw);
  float* remote = gparts + 4 * q.gw;
  float* coef = remote + K * 2 * q.gw;

  const int slices = P.C / W, units = P.B * slices, clusters = gridDim.x / K;
  const int64_t stride = static_cast<int64_t>(R) * P.C;  // elements between a thread's rows
  const int left = q.row_end - q.row0 - q.rl;
  const int mine = q.active && left > 0 ? (left + R - 1) / R : 0;  // the thread's rows
  const int rounds = (mine + P.slots - 1) / P.slots;
  // this thread's first row of unit u
  auto offset = [&](int u) -> int64_t {
    const int b = u / slices, c0 = (u % slices) * W;
    return (static_cast<int64_t>(b) * P.S + q.row0 + q.rl) * P.C + c0 + q.cp * N;
  };
  auto round_rows = [&](int k) { return min(P.slots, mine - k * P.slots); };
  // this thread's slots of round k
  auto half = [&](int k) { return xs + (k & 1) * P.slots * kFwdThreads; };
  // round k of the rows at src into its half of the slots (one cp.async group)
  auto load_round = [&](const T* src, int k) {
    const int n = round_rows(k);
    uint4* dst = half(k);
    src += static_cast<int64_t>(k) * P.slots * stride;
    for (int i = 0; i < n; ++i) cp_async16(smem_addr(dst + i * kFwdThreads), src + i * stride, 16);
    cp_async_commit();
  };

  int u = blockIdx.x / K;
  if (u < units) load_round(static_cast<const T*>(a.x) + offset(u), 0);
  for (int k = 0; u < units; ++k, u += clusters) {
    float* gpart = gparts + (k & 1) * 2 * q.gw;
    const T* xg = static_cast<const T*>(a.x) + offset(u);
    T* yg = static_cast<T*>(a.y) + offset(u);
    const int b = u / slices, c0 = (u % slices) * W;
    const T* xnext = u + clusters < units ? static_cast<const T*>(a.x) + offset(u + clusters)
                                          : nullptr;
    FTRACE(k, 0);
    // 1. every round summed in turn while the next one loads (into the half
    // the round before this one has left); round 0 is already on its way
    float s1[N], s2[N];
#pragma unroll
    for (int n = 0; n < N; ++n) s1[n] = s2[n] = 0.f;
    for (int r = 0; r < rounds; ++r) {
      if (r + 1 < rounds) {
        load_round(xg, r + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      compiler_fence();
      if (r == 0) FTRACE(k, 1);
      float c1[N], c2[N];
#pragma unroll
      for (int n = 0; n < N; ++n) c1[n] = c2[n] = 0.f;
      const int n_rows = round_rows(r);
      const uint4* h = half(r);
      for (int i = 0; i < n_rows; ++i) {
        float v[N];
        Pack<T>::unpack(h[i * kFwdThreads], v);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          c1[n] += v[n];
          c2[n] = __fmaf_rn(v[n], v[n], c2[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < N; ++n) {
        s1[n] += c1[n];
        s2[n] += c2[n];
      }
    }
    block_channel_sums<N>(red, s1, s2, q);
    for (int g = tid; g < 2 * q.gw; g += kFwdThreads) gpart[g] = block_group_sum(red, g, q);
    FTRACE(k, 2);

    // 2. the cluster's group sums, every block's read at once, then summed in
    // rank order. Every block has read the other copy's sums (the last
    // unit's) before it arrives here, so the next unit may write them
    cluster_arrive();
    cluster_wait();
    FTRACE(k, 3);
    for (int e = tid; e < K * 2 * q.gw; e += kFwdThreads) {
      remote[e] = cluster.map_shared_rank(gpart, e / (2 * q.gw))[e % (2 * q.gw)];
    }
    __syncthreads();
    for (int g = tid; g < q.gw; g += kFwdThreads) {
      float t1 = 0.f, t2 = 0.f;
      for (int r = 0; r < K; ++r) {
        t1 += remote[r * 2 * q.gw + g];
        t2 += remote[r * 2 * q.gw + q.gw + g];
      }
      const float mean = t1 / P.n;
      const float var = __fmaf_rn(-mean, mean, t2 / P.n);
      const float rstd = rsqrtf(var + P.eps);
      red[g] = mean;
      red[q.gw + g] = rstd;
      if (rank == 0) {
        const int gg = c0 / q.cg + g;
        a.stats[b * 2 * P.G + gg] = mean;
        a.stats[b * 2 * P.G + P.G + gg] = rstd;
      }
    }
    __syncthreads();
    for (int c = tid; c < W; c += kFwdThreads) {
      const int g = c / q.cg;
      // the plain version's roundings: one product, then one product and one
      // difference, each rounded (no fused multiply-add)
      const float A = __fmul_rn(red[q.gw + g], __ldg(a.gamma + c0 + c));
      coef[c] = A;
      coef[W + c] = __fsub_rn(__ldg(a.beta + c0 + c), __fmul_rn(red[g], A));
    }
    __syncthreads();
    FTRACE(k, 4);

    // 3. y of the two rounds on chip, then of the ones before them, the last
    // first, each loaded while the round after it is written (into the half
    // that round has left); round 0's slots take the next unit's round 0 as
    // they free
    float ca[N], cb[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      ca[n] = coef[q.cp * N + n];
      cb[n] = coef[W + q.cp * N + n];
    }
    for (int r = rounds - 1; r >= 0; --r) {
      const bool load_prev = r >= 1 && r - 1 < rounds - 2;
      if (load_prev) load_round(xg, r - 1);
      if (r < rounds - 2) {  // loaded while round r + 1 was written
        if (load_prev) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        compiler_fence();
      }
      const int n_rows = round_rows(r);
      uint4* h = half(r);
      T* out = yg + static_cast<int64_t>(r) * P.slots * stride;
      const bool refill = r == 0 && xnext != nullptr;
#pragma unroll 4
      for (int i = 0; i < n_rows; ++i) {
        float v[N];
        Pack<T>::unpack(h[i * kFwdThreads], v);
#pragma unroll
        for (int n = 0; n < N; ++n) v[n] = affine<kSwish>(v[n], ca[n], cb[n]);
        *reinterpret_cast<uint4*>(out + i * stride) = Pack<T>::pack(v);
        if (refill) cp_async16(smem_addr(h + i * kFwdThreads), xnext + i * stride, 16);
      }
    }
    cp_async_commit();  // the next unit's round 0 (an empty group where there is none)
    FTRACE(k, 5);
  }
  cp_async_wait<0>();
  // no block leaves while another reads its group sums
  cluster_arrive();
  cluster_wait();
}

template <typename T>
const void* forward_kernel_of(int with_swish) {
  return with_swish ? reinterpret_cast<const void*>(gn_fwd_kernel<T, true>)
                    : reinterpret_cast<const void*>(gn_fwd_kernel<T, false>);
}

const void* forward_kernel(int dtype, int with_swish) {
  if (dtype == 0) return forward_kernel_of<float>(with_swish);
  if (dtype == 1) return forward_kernel_of<__nv_bfloat16>(with_swish);
  return nullptr;
}

cudaLaunchConfig_t forward_config(int clusters, int cluster, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
const void* backward_kernel_of(int with_swish, int reread) {
  if (reread) {
    return with_swish ? reinterpret_cast<const void*>(gn_bwd_kernel<T, true, true>)
                      : reinterpret_cast<const void*>(gn_bwd_kernel<T, false, true>);
  }
  return with_swish ? reinterpret_cast<const void*>(gn_bwd_kernel<T, true, false>)
                    : reinterpret_cast<const void*>(gn_bwd_kernel<T, false, false>);
}

const void* backward_kernel(int dtype, int with_swish, int reread) {
  if (dtype == 0) return backward_kernel_of<float>(with_swish, reread);
  if (dtype == 1) return backward_kernel_of<__nv_bfloat16>(with_swish, reread);
  return nullptr;
}

// ---------------------------------------------------------------------------
// the two-pass form (a GroupNorm over a clip whose frames are split over the
// ranks of a context group): the per-(b, group) sums of this rank's rows,
// then, after the caller sums them across the ranks, the normalisation; and
// backward the same seam. The structure of the Pallas kernels themselves
// (groupnorm.py:112 partial sums, :131 normalise; :218 backward sums, :244
// dx), which the one-launch kernels above fuse away. Each is one launch:
//   gn_ctx_sums_kernel   grid (splits, B): a block sums its rows' x and x^2
//                        (the backward's partial: dyhat and dyhat*xhat) per
//                        channel, in order, then per group; the last block
//                        to finish folds every block's partials in block
//                        order (an integer counter, as the backward's
//                        barrier; no float atomics);
//   gn_ctx_apply_kernel  grid (blocks, B): y = x*A + B (+ swish) from the
//                        given stats; the dx kernel likewise from the summed
//                        backward terms.
// Bound: device-memory bandwidth, as the one-launch kernels: the sums read x
// (and g) once, the apply pass reads them again and writes y (dx) once, so
// the two-pass form moves one more read of the activation than the fused one.
// Thread t of a block owns channel pack lane = t % lanes of rows slot, slot +
// rows_par, ... where lanes = min(C / N, 256), rows_par = 256 / lanes.
// ---------------------------------------------------------------------------

constexpr int kCtxThreads = 256;

struct CtxArgs {
  const void* x;
  const void* g;          // the incoming gradient (backward), or null
  const float* stats;     // (B, 2, G) mean, rstd (apply, backward)
  const float* gsums;     // (B, 2, G) summed Σγ·dyhat, Σγ·dyhat·xhat (dx)
  const float* gamma;
  const float* beta;
  void* y;                // y or dx
  float* out;             // the sums kernel's result: (B, 2, G); backward also dgamma, dbeta (2, C)
  float* partial;         // [B * splits][2][G] (forward) or [B * splits][2][C] (backward)
  int* counter;           // zeroed by the launch function
  int B, S, C, G, splits;
  float n;                // the elements of a group over every rank (dx)
};

// Rows [r0, r1) of sample b: each thread's V-channel sums of f(x, g, c) over
// its rows, for the packs lane, lane + lanes, ...; the block's per-channel
// sums into chan[2][C] in slot order. Every thread calls it.
template <typename T, typename F>
__device__ void ctx_channel_sums(const CtxArgs& a, int b, int r0, int r1, float* red,
                                 float* chan, F f) {
  constexpr int N = Pack<T>::N;
  const int P = a.C / N;
  const int lanes = min(P, kCtxThreads);
  const int rows_par = kCtxThreads / lanes;
  const int lane = threadIdx.x % lanes, slot = threadIdx.x / lanes;
  const T* x = static_cast<const T*>(a.x) + static_cast<int64_t>(b) * a.S * a.C;
  const T* g = a.g == nullptr ? nullptr
                              : static_cast<const T*>(a.g) + static_cast<int64_t>(b) * a.S * a.C;
  for (int pc = 0; pc < P; pc += lanes) {
    const int p = pc + lane;
    float s0[N], s1[N];
#pragma unroll
    for (int i = 0; i < N; ++i) s0[i] = s1[i] = 0.f;
    if (slot < rows_par && p < P) {
      for (int r = r0 + slot; r < r1; r += rows_par) {
        const int64_t off = static_cast<int64_t>(r) * a.C + p * N;
        float xv[N], gv[N];
        Pack<T>::load(x + off, xv);
        if (g != nullptr) Pack<T>::load(g + off, gv);
#pragma unroll
        for (int i = 0; i < N; ++i) f(xv[i], g != nullptr ? gv[i] : 0.f, p * N + i, s0[i], s1[i]);
      }
    }
    if (slot < rows_par) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        red[(slot * lanes + lane) * N + i] = s0[i];
        red[(kCtxThreads + slot * lanes + lane) * N + i] = s1[i];
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < lanes * N; j += kCtxThreads) {
      const int c = pc * N + j;
      if (c < a.C) {
        float t0 = 0.f, t1 = 0.f;
        for (int s = 0; s < rows_par; ++s) {
          t0 += red[s * lanes * N + j];
          t1 += red[(kCtxThreads * N) + s * lanes * N + j];
        }
        chan[c] = t0;
        chan[a.C + c] = t1;
      }
    }
    __syncthreads();
  }
}

// The last block of the grid to arrive (an integer counter) returns true;
// every block's writes before the call are visible to it.
__device__ __forceinline__ bool ctx_last_block(int* counter, int blocks) {
  __shared__ bool last;
  __threadfence();  // this thread's partials, before the block arrives
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == blocks - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  return last;
}

// Forward sums: out[b][0][g] = Σ x, out[b][1][g] = Σ x^2 over this rank's
// rows of group g, fp32.
template <typename T>
__global__ void __launch_bounds__(kCtxThreads) gn_ctx_sums_kernel(const CtxArgs a) {
  extern __shared__ float ctx_smem[];
  constexpr int N = Pack<T>::N;
  float* red = ctx_smem;                          // [2][256][N]
  float* chan = ctx_smem + 2 * kCtxThreads * N;   // [2][C]
  const int b = blockIdx.y, split = blockIdx.x;
  const int rows = (a.S + a.splits - 1) / a.splits;
  const int r0 = min(a.S, split * rows), r1 = min(a.S, r0 + rows);
  ctx_channel_sums<T>(a, b, r0, r1, red, chan,
                      [](float x, float, int, float& s0, float& s1) {
                        s0 += x;
                        s1 = fmaf(x, x, s1);
                      });
  const int cg = a.C / a.G;
  float* mine = a.partial + (static_cast<int64_t>(b) * a.splits + split) * 2 * a.G;
  for (int j = threadIdx.x; j < 2 * a.G; j += kCtxThreads) {
    const int which = j / a.G, grp = j % a.G;
    float t = 0.f;
    for (int c = grp * cg; c < (grp + 1) * cg; ++c) t += chan[which * a.C + c];
    mine[j] = t;
  }
  if (!ctx_last_block(a.counter, a.B * a.splits)) return;
  for (int j = threadIdx.x; j < a.B * 2 * a.G; j += kCtxThreads) {
    const int bb = j / (2 * a.G), k = j % (2 * a.G);
    float t = 0.f;
    for (int s = 0; s < a.splits; ++s) t += a.partial[(static_cast<int64_t>(bb) * a.splits + s) * 2 * a.G + k];
    a.out[j] = t;
  }
}

// Per channel of sample b: A = rstd*gamma, B = beta - mean*A (the forward's
// roundings) into coef[2][C].
__device__ void ctx_affine(const CtxArgs& a, int b, float* coef) {
  const int cg = a.C / a.G;
  for (int c = threadIdx.x; c < a.C; c += kCtxThreads) {
    const float mean = a.stats[(b * 2) * a.G + c / cg];
    const float rstd = a.stats[(b * 2 + 1) * a.G + c / cg];
    const float A = __fmul_rn(rstd, a.gamma[c]);
    coef[c] = A;
    coef[a.C + c] = __fsub_rn(a.beta[c], __fmul_rn(mean, A));
  }
  __syncthreads();
}

template <typename T, bool kSwish>
__global__ void __launch_bounds__(kCtxThreads) gn_ctx_apply_kernel(const CtxArgs a) {
  extern __shared__ float ctx_smem[];
  float* coef = ctx_smem;  // [2][C]
  constexpr int N = Pack<T>::N;
  const int b = blockIdx.y;
  ctx_affine(a, b, coef);
  const int P = a.C / N;
  const int64_t packs = static_cast<int64_t>(a.S) * P;
  const T* x = static_cast<const T*>(a.x) + static_cast<int64_t>(b) * a.S * a.C;
  T* y = static_cast<T*>(a.y) + static_cast<int64_t>(b) * a.S * a.C;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kCtxThreads) + threadIdx.x; i < packs;
       i += static_cast<int64_t>(gridDim.x) * kCtxThreads) {
    const int c0 = static_cast<int>(i % P) * N;
    float v[N];
    Pack<T>::load(x + i * N, v);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = affine<kSwish>(v[k], coef[c0 + k], coef[a.C + c0 + k]);
    Pack<T>::store(y + i * N, v);
  }
}

// Backward sums: per (b, group) Σ γ·dyhat and Σ γ·dyhat·xhat over this
// rank's rows into out[b][2][G], and this rank's dgamma = Σ_b Σ dyhat·xhat,
// dbeta = Σ_b Σ dyhat into out + B*2*G (2, C).
template <typename T, bool kSwish>
__global__ void __launch_bounds__(kCtxThreads) gn_ctx_bwd_sums_kernel(const CtxArgs a) {
  extern __shared__ float ctx_smem[];
  constexpr int N = Pack<T>::N;
  float* red = ctx_smem;                          // [2][256][N]
  float* chan = ctx_smem + 2 * kCtxThreads * N;   // [2][C]
  float* coef = chan + 2 * a.C;               // [2][C]: A, B
  float* norm = coef + 2 * a.C;               // [2][C]: mean, rstd of the channel's group
  const int b = blockIdx.y, split = blockIdx.x;
  ctx_affine(a, b, coef);
  const int cg = a.C / a.G;
  for (int c = threadIdx.x; c < a.C; c += kCtxThreads) {
    norm[c] = a.stats[(b * 2) * a.G + c / cg];
    norm[a.C + c] = a.stats[(b * 2 + 1) * a.G + c / cg];
  }
  __syncthreads();
  const int rows = (a.S + a.splits - 1) / a.splits;
  const int r0 = min(a.S, split * rows), r1 = min(a.S, r0 + rows);
  const int C = a.C;
  ctx_channel_sums<T>(a, b, r0, r1, red, chan,
                      [coef, norm, C](float x, float g, int c, float& s0, float& s1) {
                        const float dy = kSwish ? d_yhat(x, g, coef[c], coef[C + c]) : g;
                        const float xhat = __fmul_rn(__fsub_rn(x, norm[c]), norm[C + c]);
                        s0 += dy;
                        s1 = fmaf(dy, xhat, s1);
                      });
  float* mine = a.partial + (static_cast<int64_t>(b) * a.splits + split) * 2 * a.C;
  for (int j = threadIdx.x; j < 2 * a.C; j += kCtxThreads) mine[j] = chan[j];
  if (!ctx_last_block(a.counter, a.B * a.splits)) return;
  // the last block: per (b, c) the splits in order, then per group, and
  // dgamma, dbeta over b in order
  float* dgamma = a.out + a.B * 2 * a.G;
  for (int c = threadIdx.x; c < a.C; c += kCtxThreads) dgamma[c] = dgamma[a.C + c] = 0.f;
  for (int bb = 0; bb < a.B; ++bb) {
    __syncthreads();
    for (int c = threadIdx.x; c < a.C; c += kCtxThreads) {
      float t0 = 0.f, t1 = 0.f;
      for (int s = 0; s < a.splits; ++s) {
        const float* p = a.partial + (static_cast<int64_t>(bb) * a.splits + s) * 2 * a.C;
        t0 += p[c];
        t1 += p[a.C + c];
      }
      chan[c] = t0;
      chan[a.C + c] = t1;
      dgamma[a.C + c] += t0;  // dbeta
      dgamma[c] += t1;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * a.G; j += kCtxThreads) {
      const int which = j / a.G, grp = j % a.G;
      float t = 0.f;
      for (int c = grp * cg; c < (grp + 1) * cg; ++c) {
        t = fmaf(a.gamma[c], chan[which * a.C + c], t);
      }
      a.out[bb * 2 * a.G + j] = t;
    }
  }
}

// dx = dyhat*ca + x*cb + cc with ca = r*gamma, cb = -r^2*m2, cc = mean*r^2*m2
// - r*m1, m1 = Σγ·dyhat / n, m2 = Σγ·dyhat·xhat / n from the summed gsums.
template <typename T, bool kSwish>
__global__ void __launch_bounds__(kCtxThreads) gn_ctx_dx_kernel(const CtxArgs a) {
  extern __shared__ float ctx_smem[];
  float* coef = ctx_smem;  // [5][C]: A, B, ca, cb, cc
  constexpr int N = Pack<T>::N;
  const int b = blockIdx.y;
  ctx_affine(a, b, coef);
  const int cg = a.C / a.G;
  for (int c = threadIdx.x; c < a.C; c += kCtxThreads) {
    const int grp = c / cg;
    const float mean = a.stats[(b * 2) * a.G + grp];
    const float r = a.stats[(b * 2 + 1) * a.G + grp];
    const float m1 = a.gsums[(b * 2) * a.G + grp] / a.n;
    const float m2 = a.gsums[(b * 2 + 1) * a.G + grp] / a.n;
    const float r2m2 = r * r * m2;
    coef[2 * a.C + c] = r * a.gamma[c];
    coef[3 * a.C + c] = -r2m2;
    coef[4 * a.C + c] = mean * r2m2 - r * m1;
  }
  __syncthreads();
  const int P = a.C / N;
  const int64_t packs = static_cast<int64_t>(a.S) * P;
  const int64_t base = static_cast<int64_t>(b) * a.S * a.C;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* g = static_cast<const T*>(a.g) + base;
  T* dx = static_cast<T*>(a.y) + base;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kCtxThreads) + threadIdx.x; i < packs;
       i += static_cast<int64_t>(gridDim.x) * kCtxThreads) {
    const int c0 = static_cast<int>(i % P) * N;
    float xv[N], gv[N];
    Pack<T>::load(x + i * N, xv);
    Pack<T>::load(g + i * N, gv);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int c = c0 + k;
      const float dy = kSwish ? d_yhat(xv[k], gv[k], coef[c], coef[a.C + c]) : gv[k];
      gv[k] = fmaf(dy, coef[2 * a.C + c], fmaf(xv[k], coef[3 * a.C + c], coef[4 * a.C + c]));
    }
    Pack<T>::store(dx + i * N, gv);
  }
}

template <typename T>
const void* ctx_kernel_of(int kind, int with_swish) {
  switch (kind) {
    case 0: return reinterpret_cast<const void*>(gn_ctx_sums_kernel<T>);
    case 1: return with_swish ? reinterpret_cast<const void*>(gn_ctx_apply_kernel<T, true>)
                              : reinterpret_cast<const void*>(gn_ctx_apply_kernel<T, false>);
    case 2: return with_swish ? reinterpret_cast<const void*>(gn_ctx_bwd_sums_kernel<T, true>)
                              : reinterpret_cast<const void*>(gn_ctx_bwd_sums_kernel<T, false>);
    case 3: return with_swish ? reinterpret_cast<const void*>(gn_ctx_dx_kernel<T, true>)
                              : reinterpret_cast<const void*>(gn_ctx_dx_kernel<T, false>);
  }
  return nullptr;
}

const void* ctx_kernel(int kind, int dtype, int with_swish) {
  if (dtype == 0) return ctx_kernel_of<float>(kind, with_swish);
  if (dtype == 1) return ctx_kernel_of<__nv_bfloat16>(kind, with_swish);
  return nullptr;
}

}  // namespace

extern "C" {

// The backward's constants, for the wrapper to check its plans against.
void gn_backward_limits(int* threads, int* packs, int* slice_packs) {
  *threads = kBwdThreads;
  *packs = kBwdPacks;
  *slice_packs = kBwdMaxSlicePacks;
}

// Allows the forward kernels `smem` bytes of dynamic shared memory and
// clusters of up to kFwdMaxCluster blocks (above the portable 8) on the
// current device; the wrapper calls it once a device. Returns 0 or a
// cudaError_t.
int gn_forward_setup(int smem) {
  for (int dtype = 0; dtype < 2; ++dtype) {
    for (int swish = 0; swish < 2; ++swish) {
      const void* fn = forward_kernel(dtype, swish);
      cudaError_t err =
          cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
      // all of the SM's 228 KB as shared memory, so that two blocks fit
      err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

// How many clusters of `cluster` blocks with `smem` bytes each the device
// holds at once (cudaOccupancyMaxActiveClusters; 0: the launch cannot run).
// Returns 0 or a cudaError_t.
int gn_forward_max_clusters(int dtype, int with_swish, int cluster, int smem, int* count) {
  const void* fn = forward_kernel(dtype, with_swish);
  if (fn == nullptr || cluster < 1 || cluster > kFwdMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = forward_config(1, cluster, smem, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(count, fn, &cfg));
}

// dtype: 0 = float32, 1 = bfloat16 (x and y). gamma, beta: fp32 (C,);
// stats: fp32 (B, 2, G) (mean, rstd). The plan (width, cluster,
// rows_per_block, slots, halves) and smem come from the wrapper, which checks shapes
// and alignment and that `clusters` clusters of `cluster` blocks (at most
// the units, B * C / width) fit on the device at once. One launch on
// `stream`. Returns 0 or the cudaError_t.
int gn_forward(const void* x, const void* gamma, const void* beta, void* y, void* stats, int B,
               int S, int C, int G, int width, int cluster, int clusters, int rows_per_block,
               int slots, int halves, int smem, float eps, int with_swish, int dtype,
               void* stream) {
  FwdArgs a;
  a.x = x;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.y = y;
  a.stats = static_cast<float*>(stats);
  a.p = FwdPlan{B, S, C, G, width, rows_per_block, slots, halves,
                static_cast<float>(static_cast<int64_t>(S) * (C / G)), eps};
  const void* fn = forward_kernel(dtype, with_swish);
  if (fn == nullptr || cluster < 1 || cluster > kFwdMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      forward_config(clusters, cluster, smem, static_cast<cudaStream_t>(stream), attr);
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch: clear it, or the next launch reports it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward block's threads and the largest cluster, for the wrapper to
// check its plans against.
void gn_forward_limits(int* threads, int* max_cluster) {
  *threads = kFwdThreads;
  *max_cluster = kFwdMaxCluster;
}

// Allows the backward kernel of (dtype, with_swish, reread) `smem` bytes of
// dynamic shared memory and writes how many of its blocks one SM holds at
// once (the cooperative launch's grid must not exceed that times the SMs).
// Returns 0 or a cudaError_t.
int gn_backward_occupancy(int dtype, int with_swish, int reread, int smem, int* blocks_per_sm) {
  const void* fn = backward_kernel(dtype, with_swish, reread);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kBwdThreads, smem));
}

// dtype: 0 = float32, 1 = bfloat16 (x, g and dx). stats: the forward's fp32
// (B, 2, G); gamma, beta: fp32 (C,); dgamma_dbeta: fp32 (2, C). workspace:
// fp32 words, the sync counters (sync_words(teams)), then the group partials
// (units * team_blocks * 2 * groups of a slice), the channel partials
// (units * team_blocks * 2 * width) and the per-batch terms (B * 2 * C),
// units = B * C / width. The plan (width, team_blocks, teams,
// rows_per_block, col_blocks, block_width; reread 0 holds a block's rows of
// a unit on chip, 1 streams them twice) and smem come from the wrapper,
// which checks shapes and alignment. Zeroes the counters and makes one
// cooperative launch of teams * team_blocks blocks on `stream`, which fails
// (and runs nothing) if they cannot all be resident at once. Returns 0 or
// the cudaError_t.
int gn_backward(const void* x, const void* g, const void* stats, const void* gamma,
                const void* beta, void* dx, void* dgamma_dbeta, void* workspace, int B, int S,
                int C, int G, int width, int team_blocks, int teams, int rows_per_block,
                int col_blocks, int block_width, int reread, int smem, int with_swish, int dtype,
                void* stream) {
  BwdArgs a;
  a.x = x;
  a.g = g;
  a.stats = static_cast<const float*>(stats);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.dx = dx;
  a.dgamma = static_cast<float*>(dgamma_dbeta);
  a.dbeta = a.dgamma + C;
  a.sync = static_cast<int*>(workspace);
  const int64_t units = static_cast<int64_t>(B) * (C / width);
  a.group_partial = static_cast<float*>(workspace) + sync_words(teams);
  a.chan_partial = a.group_partial + units * team_blocks * 2 * (width / (C / G));
  a.per_batch = a.chan_partial + units * team_blocks * 2 * width;
  a.p = Plan{B, S, C, G, width, team_blocks, teams, rows_per_block, col_blocks, block_width,
              static_cast<float>(static_cast<int64_t>(S) * (C / G))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fn = backward_kernel(dtype, with_swish, reread);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(a.sync, 0, sync_words(teams) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(teams * team_blocks), dim3(kBwdThreads), args,
                                    static_cast<size_t>(smem), s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch: clear it, or the next launch reports it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef GN_FWD_TRACE
int gn_forward_trace(void* buffer) {
  long long* p = static_cast<long long*>(buffer);
  return static_cast<int>(cudaMemcpyToSymbol(g_fwd_trace, &p, sizeof(p)));
}
#endif

#ifdef GN_BWD_TRACE
int gn_backward_trace(void* buffer) {
  long long* p = static_cast<long long*>(buffer);
  return static_cast<int>(cudaMemcpyToSymbol(g_trace, &p, sizeof(p)));
}
#endif

// The two-pass form's sums (gn_ctx_sums_kernel, backward = 0: out (B, 2, G)
// Σx, Σx^2; gn_ctx_bwd_sums_kernel, backward = 1: out (B, 2, G) Σγ·dyhat,
// Σγ·dyhat·xhat, then (2, C) dgamma, dbeta), over `splits` row ranges of
// each sample. workspace: 4 int words (the counter, zeroed here), then the
// blocks' partials, B * splits * 2 * (G forward, C backward) floats. g,
// stats, gamma, beta: the backward's (null forward). One launch on `stream`.
// Returns 0 or the cudaError_t.
int gn_ctx_sums(const void* x, const void* g, const void* stats, const void* gamma,
                const void* beta, void* out, void* workspace, int B, int S, int C, int G,
                int splits, int backward, int with_swish, int dtype, void* stream) {
  CtxArgs a = {};
  a.x = x;
  a.g = g;
  a.stats = static_cast<const float*>(stats);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.out = static_cast<float*>(out);
  a.counter = static_cast<int*>(workspace);
  a.partial = static_cast<float*>(workspace) + 4;
  a.B = B;
  a.S = S;
  a.C = C;
  a.G = G;
  a.splits = splits;
  const void* fn = ctx_kernel(backward ? 2 : 0, dtype, with_swish);
  if (fn == nullptr || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int pack = dtype == 0 ? 4 : 8;
  const size_t smem = (2 * kCtxThreads * pack + (backward ? 6 : 2) * C) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(a.counter, 0, 4 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, dim3(splits, B), dim3(kCtxThreads), args, smem, s);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The two-pass form's second pass: backward = 0, y = x*A + B (+ swish) from
// stats (B, 2, G) mean, rstd (gn_ctx_apply_kernel); backward = 1, dx from x,
// g, stats and the summed gsums (B, 2, G) over n elements a group
// (gn_ctx_dx_kernel). `blocks` blocks a sample. One launch on `stream`.
// Returns 0 or the cudaError_t.
int gn_ctx_apply(const void* x, const void* g, const void* stats, const void* gsums,
                 const void* gamma, const void* beta, void* y, int B, int S, int C, int G,
                 int blocks, float n, int backward, int with_swish, int dtype, void* stream) {
  CtxArgs a = {};
  a.x = x;
  a.g = g;
  a.stats = static_cast<const float*>(stats);
  a.gsums = static_cast<const float*>(gsums);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.y = y;
  a.B = B;
  a.S = S;
  a.C = C;
  a.G = G;
  a.n = n;
  const void* fn = ctx_kernel(backward ? 3 : 1, dtype, with_swish);
  if (fn == nullptr || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (backward ? 5 : 2) * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, dim3(blocks, B), dim3(kCtxThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
