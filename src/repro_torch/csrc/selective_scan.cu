// Mamba-1 selective scan for Hopper (sm_90a):
//   h_t = h_{t-1} * exp(dt_t * a) + (dt_t * u_t) (x) b_t       (N, D) state
//   y_t = sum_n h_t[n] * c_t[n] + d_skip * u_t
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan/kernel.py
// (selective_scan_fwd, body _scan_kernel).  Layouts as there, all contiguous:
// u, dt (B, L, D) and b, c (B, L, N) in float32 or bfloat16; a (N, D) float32
// (negative); d_skip (1, D) float32; out y (B, L, D) in u's type and h_final
// (B, N, D) float32.  All arithmetic is float32; y is rounded to its type
// once.  Offsets are 64-bit (B * L * D passes 2^31 at 32 x 32k tokens of
// d_inner 8192) and the grid is flat in x.
//
// What changes from the TPU.  There the grid (B, L / block_l) runs in order
// and h waits in VMEM scratch between grid steps.  Here blocks run in no
// order, so the loop over the sequence lives inside the block, and each
// (batch row, channel d) pair walks t = 0 .. L-1 itself (any L; no padding).
//
// What bounds it: operations, not bytes.  At the serving shape (B 4, L 2048,
// D 8192, N 16, bf16) u, dt and y are 3 x 134 MB, 0.12 ms at 3.35 TB/s, but
// the recurrence needs B * L * D * N = 1.07e9 exponentials, and the special
// function unit of an H100 SM retires 16 a clock: on 132 SMs at 1.98 GHz
// that is 0.26 ms.  Each exponential is one ex2.approx.ftz (one MUFU.EX2) of
// dt * (a * log2 e): exp2f without fast math adds a range test and two
// multiplies around it for results below 2^-126, which flush to 0 here (a
// state's factor below 2^-126 moves it by less than 2^-126 of itself).  The
// pre-scaled a and the product add a relative error of about |dt * a| *
// 2^-23 to each factor exp(dt * a), so the kernel agrees with a float32
// exp() reference to ~1e-6 of the magnitudes it sums.
//
// The layout.  One thread owns one (batch row, channel d) pair and keeps
// h[0..N) and a[0..N, d] in registers; neighbouring threads take
// neighbouring d, so the loads of u, dt and the stores of y coalesce.  Per
// step it computes exactly the expressions of the earlier one-thread body
// (h = h e + du b, then y = sum_n h c in n order, then + d_skip u), so the
// outputs do not move: a layout that split the states over 4 lanes and
// summed y by shuffles was as exact by the kernel's tolerance, but changed
// which bfloat16 values round where, and 64 layers of falcon-mamba-7b
// amplified that past the serving check's tolerance (PERF.md).  That body
// lost its time to waiting, not to too few warps: it staged b and c with a
// loop of dependent 2-byte loads and used each chunk's u and dt right
// after loading them.  Here, per chunk of kChunk steps:
//   - u and dt of the next chunk are loaded into registers before the
//     current chunk computes and kept as loaded (bfloat16 widened only at
//     its step), so nothing waits on them;
//   - b and c (every channel of the row reads the same values) of the next
//     chunk are loaded by 16-byte loads into registers, then, after the
//     current chunk, widened into the other half of a double buffer in
//     shared memory; one __syncthreads a chunk.  The 16-byte blocks are
//     those that overlap the chunk's elements, so b and c may start at any
//     element: a block never leaves the 16-byte aligned memory that holds
//     one of its elements;
//   - whole chunks run with no test of the step count.
// Under grad the wrapper calls the kCkpt instance (selective_scan_ckpt_*),
// which also writes the state before every chunk for the backward (the
// last section of this file); the serve instances are the code without it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 64;      // channels per block: 512 blocks at B 4, D 8192
constexpr int kChunk = 16;        // timesteps staged per round
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 2^x by the SFU alone (ex2.approx.ftz: relative error below 2^-22; a
// result below 2^-126 flushes to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The 16-byte blocks that hold elements [e0, e0 + count) of p: block k
// starts at element first + k * kPer of them (first <= 0).
template <typename T>
struct Blocks {
  static constexpr int kPer = 16 / sizeof(T);
  const uint4* base;
  int first, n;
  __device__ __forceinline__ Blocks(const T* p, int64_t e0, int count) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p + e0);
    first = -static_cast<int>((addr & 15) / sizeof(T));
    base = reinterpret_cast<const uint4*>(addr & ~uintptr_t{15});
    n = count > 0 ? (count - first + kPer - 1) / kPer : 0;
  }
};

// One step's u and dt of a channel, kept as loaded and widened to float32
// only at the step, so that nothing waits on the loads before then.
template <typename T>
struct StepIn {
  T u, dt;
  __device__ __forceinline__ float fu() const { return to_f32(u); }
  __device__ __forceinline__ float fdt() const { return to_f32(dt); }
};

// Block k of batch row bi owns channels [k * kThreads, (k + 1) * kThreads);
// thread i channel k * kThreads + i, with all N of its states.
template <typename T, int N, bool kCkpt>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ a,
                      const float* __restrict__ d_skip, T* __restrict__ y,
                      float* __restrict__ h_final, float* __restrict__ ckpt,
                      int64_t L, int64_t D, uint32_t blocks_per_row) {
  constexpr int kPer = Blocks<T>::kPer;
  // 16-byte blocks of b and c a thread stages a chunk (at most 2 (K N /
  // kPer + 1) for the two)
  constexpr int kPre = (2 * (kChunk * N / kPer + 1) + kThreads - 1) /
                       kThreads;
  __shared__ __align__(16) float sbc[2][kChunk][2 * N];   // [buf][step][b, c]
  const uint32_t bi = blockIdx.x / blocks_per_row;
  const int tid = threadIdx.x;
  const int64_t d =
      static_cast<int64_t>(blockIdx.x - bi * blocks_per_row) * kThreads + tid;
  const bool active = d < D;
  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = active ? a[n * D + d] * kLog2e : 0.f;
    h[n] = 0.f;
  }
  const float ds = active ? d_skip[d] : 0.f;
  const int64_t row0 = static_cast<int64_t>(bi) * L;   // (bi, t = 0)

  StepIn<T> next[kChunk];          // the next chunk's u, dt
  uint4 pre[kPre];                 // its blocks of b and c
  auto load = [&](int64_t t0) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int64_t t = t0 + j;
      next[j].u = next[j].dt = from_f32<T>(0.f);
      if (active && t < L) {
        next[j].u = u[(row0 + t) * D + d];
        next[j].dt = dt[(row0 + t) * D + d];
      }
    }
    const int count = static_cast<int>(L - t0 < kChunk ? L - t0 : kChunk) * N;
    const Blocks<T> b(bm, (row0 + t0) * N, count);
    const Blocks<T> c(cm, (row0 + t0) * N, count);
#pragma unroll
    for (int p = 0; p < kPre; ++p) {
      const int k = tid + p * kThreads;
      if (k < b.n) {
        pre[p] = b.base[k];
      } else if (k - b.n < c.n) {
        pre[p] = c.base[k - b.n];
      }
    }
  };
  // the blocks into buffer buf, widened to float32
  auto stage = [&](int buf, int64_t t0) {
    const int count = static_cast<int>(L - t0 < kChunk ? L - t0 : kChunk) * N;
    const Blocks<T> b(bm, (row0 + t0) * N, count);
    const Blocks<T> c(cm, (row0 + t0) * N, count);
#pragma unroll
    for (int p = 0; p < kPre; ++p) {
      const int k = tid + p * kThreads;
      const bool is_b = k < b.n;
      if (!is_b && k - b.n >= c.n) continue;
      const int e0 = is_b ? b.first + k * kPer : c.first + (k - b.n) * kPer;
      const T* x = reinterpret_cast<const T*>(&pre[p]);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = e0 + i;          // element (step e / N, state e % N)
        if (e >= 0 && e < count) {
          sbc[buf][e / N][(is_b ? 0 : N) + e % N] = to_f32(x[i]);
        }
      }
    }
  };

  if (L > 0) {
    load(0);
    stage(0, 0);
  }
  __syncthreads();
  int buf = 0;
  for (int64_t t0 = 0; t0 < L; t0 += kChunk, buf ^= 1) {
    if constexpr (kCkpt) {         // the state before step t0, for backward
      if (active) {
        const int64_t row = (static_cast<int64_t>(bi) * ((L + kChunk - 1) /
                             kChunk) + t0 / kChunk) * N;
#pragma unroll
        for (int n = 0; n < N; ++n) ckpt[(row + n) * D + d] = h[n];
      }
    }
    StepIn<T> in[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) in[j] = next[j];
    const bool more = t0 + kChunk < L;
    if (more) load(t0 + kChunk);             // in flight while this computes
    const int steps = static_cast<int>(L - t0 < kChunk ? L - t0 : kChunk);
    // kFull: a whole chunk, with no test of steps; the last chunk of a row
    // may be partial
    auto compute = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        if (!kFull && s >= steps) break;
        const float uu = in[s].fu(), dd = in[s].fdt();
        const float du = dd * uu;
        const float* bs = &sbc[buf][s][0];
        const float* cs = bs + N;
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = h[n] * fast_exp2(dd * a2[n]) + du * bs[n];
          acc += h[n] * cs[n];
        }
        if (active) {
          y[(row0 + t0 + s) * D + d] = from_f32<T>(acc + ds * uu);
        }
      }
    };
    if (steps == kChunk) {
      compute(std::true_type());
    } else {
      compute(std::false_type());
    }
    if (more) stage(buf ^ 1, t0 + kChunk);
    __syncthreads();               // the next chunk reads what stage wrote
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h_final[(static_cast<int64_t>(bi) * N + n) * D + d] = h[n];
    }
  }
}

// -- backward ------------------------------------------------------------------
//
// Replaces no TPU kernel: the JAX package trains falcon-mamba-7b through
// lax.scan over _scan_step (src/repro/models/ssm.py), whose gradient XLA
// derives; the Pallas scan has no backward either.  From the forward's
// state cotangent g_t (g_{L-1} = dy_{L-1} C_{L-1} + dh_final, or without
// dh_final) walking t from L-1 down to 0:
//   g_t     = dy_t C_t + g_{t+1} dA_{t+1},   dA_t = exp(dt_t a)
//   dC_t    = sum_d dy_t h_t             dB_t  = sum_d g_t dt_t u_t
//   du_t    = dy_t D + dt_t sum_n g_t B_t
//   ddt_t   = sum_n g_t (u_t B_t + h_{t-1} a dA_t)
//   da      = sum_{b,t} g_t h_{t-1} dt_t dA_t      dD = sum_{b,t} dy_t u_t
// du, ddt, dB, dC come back in u's type, rounded once; da and dD float32.
//
// The state history.  Walking back needs h_{t-1} at every step; kept whole
// it is B L N D float32 (8.6 GB at falcon-mamba-7b's training shape B 4, L
// 4096, D 8192, N 16).  So the forward instance that runs under grad
// (kCkpt) writes the state before each chunk of kChunk steps, (B, L /
// kChunk, N, D) float32 (537 MB there), and the backward, chunk by chunk
// from the last, rebuilds the chunk's kChunk states from that checkpoint
// into shared memory ([step][n][thread]: neighbouring threads on
// neighbouring words, 64 KB a CTA at N 16) with the forward's own
// expressions (fast_exp2 of dt * (a log2 e), h = h e + du b, in the same
// order), so the gradient is taken at the states the forward had; then
// walks the chunk in reverse.  One thread a (batch row, channel), as in
// the forward; it keeps a, a log2 e, g, h and da's sum (N each) in
// registers.  At the start of a chunk it loads the chunk's u, dt and dy
// (3 x 16 values) and the checkpoint with every load in flight at once, so
// no step waits on memory.
//
// Sums over channels.  dB_t and dC_t sum over D.  Each warp sums its 32
// channels' 2N values of a step by a reduce-scatter of shuffles (31
// shuffles at N 16: after the level at lane distance o each lane keeps
// the half of its values that its lane bit o names, so lane l ends with
// value l >> (5 - log2 2N) summed over the warp), the CTA's two warps are
// added in shared memory, and each CTA writes its partial sums to a
// float32 workspace (B, L, CTAs a row, 2N); a second launch
// (selective_scan_bwd_sum) adds the CTAs' partials in CTA order, and da's
// and dD's per-row sums over the batch in row order.  No float atomics:
// the gradient is the same bits on every run.
//
// What bounds it: operations, as the forward: the rebuild and the walk
// each take B L D N exponentials (2 B L D N on the SFU, 16 a clock an SM),
// beside ~12 float32 operations an element on the CUDA cores.

constexpr int kBwdThreads = kThreads;     // channels a CTA, one a thread

// v[0..M) summed over the warp, reduce-scattered: returns, in lane l, the
// sum of value l >> (5 - log2 M) (every lane of a group of 32 / M holds it).
// One level a call, at lane distance Off, so every index is a constant.
template <int M, int Off = 16>
__device__ __forceinline__ float warp_reduce_scatter(const float (&v)[M],
                                                     int lane) {
  if constexpr (M == 1) {
    float x = v[0];
#pragma unroll
    for (int o = Off; o > 0; o >>= 1) {
      x += __shfl_xor_sync(0xffffffffu, x, o);
    }
    return x;
  } else {
    constexpr int H = M / 2;
    const bool upper = (lane & Off) != 0;
    float w[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[i + H];
      const float keep = upper ? v[i + H] : v[i];
      w[i] = keep + __shfl_xor_sync(0xffffffffu, send, Off);
    }
    return warp_reduce_scatter<H, Off / 2>(w, lane);
  }
}

// Block k of batch row bi owns channels [k * kBwdThreads, (k + 1) *
// kBwdThreads), as in the forward.  hist: the chunk's states before each
// step, [kChunk][N][kBwdThreads] (dynamic shared memory).
template <typename T, int N>
__global__ void __launch_bounds__(kBwdThreads)
selective_scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                          const T* __restrict__ bm, const T* __restrict__ cm,
                          const float* __restrict__ a,
                          const float* __restrict__ d_skip,
                          const T* __restrict__ dy,
                          const float* __restrict__ dh_final,
                          const float* __restrict__ ckpt,
                          T* __restrict__ du, T* __restrict__ ddt,
                          float* __restrict__ part_bc,
                          float* __restrict__ part_a,
                          float* __restrict__ part_d, int64_t L, int64_t D,
                          uint32_t blocks_per_row) {
  constexpr int M = 2 * N;                 // dB's and dC's values a step
  constexpr int kGroup = 32 / M;           // lanes that hold one sum
  constexpr int kWarps = kBwdThreads / 32;
  extern __shared__ float hist[];
  __shared__ float sbc[kChunk][M];         // [step][b, c], float32
  __shared__ float red[kWarps][kChunk][M];  // each warp's sums of a step
  const uint32_t bi = blockIdx.x / blocks_per_row;
  const uint32_t blk = blockIdx.x - bi * blocks_per_row;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t d = static_cast<int64_t>(blk) * kBwdThreads + tid;
  const bool active = d < D;
  float an[N], a2[N], g[N], da_acc[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    an[n] = active ? a[n * D + d] : 0.f;
    a2[n] = an[n] * kLog2e;                // the forward's a2
    g[n] = active && dh_final != nullptr
               ? dh_final[(static_cast<int64_t>(bi) * N + n) * D + d]
               : 0.f;
    da_acc[n] = 0.f;
  }
  const float ds = active ? d_skip[d] : 0.f;
  float dd_acc = 0.f;
  const int64_t row0 = static_cast<int64_t>(bi) * L;   // (bi, t = 0)
  const int64_t n_ckpt = (L + kChunk - 1) / kChunk;
  for (int64_t c = n_ckpt - 1; c >= 0; --c) {
    const int64_t t0 = c * kChunk;
    const int steps = static_cast<int>(L - t0 < kChunk ? L - t0 : kChunk);
    // the chunk's u, dt, dy and checkpoint into registers, every load in
    // flight at once (none waits for a step), across the barrier and the
    // staging of b and c
    float cu[kChunk], cdt[kChunk], cdy[kChunk];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const bool in = active && s < steps;
      const int64_t off = (row0 + t0 + s) * D + d;
      cu[s] = in ? to_f32(u[off]) : 0.f;
      cdt[s] = in ? to_f32(dt[off]) : 0.f;
      cdy[s] = in ? to_f32(dy[off]) : 0.f;
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[n] = active ? ckpt[((static_cast<int64_t>(bi) * n_ckpt + c) * N + n)
                           * D + d]
                    : 0.f;
    }
    __syncthreads();                       // the last chunk's readers
    for (int e = tid; e < steps * M; e += kBwdThreads) {
      const int s = e / M, j = e % M;
      sbc[s][j] = to_f32((j < N ? bm : cm)[(row0 + t0 + s) * N + j % N]);
    }
    __syncthreads();
    // rebuild the chunk's states from its checkpoint, as the forward
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      if (s >= steps) break;
      const float uu = cu[s], dd = cdt[s];
      const float du_ = dd * uu;
      const float* bs = &sbc[s][0];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        hist[(s * N + n) * kBwdThreads + tid] = h[n];
        h[n] = h[n] * fast_exp2(dd * a2[n]) + du_ * bs[n];
      }
    }
    // walk it back: h holds h_t, hist[s] h_{t-1}
#pragma unroll
    for (int s = kChunk - 1; s >= 0; --s) {
      if (s >= steps) continue;
      const int64_t off = (row0 + t0 + s) * D + d;
      const float uu = cu[s], dd = cdt[s], gy = cdy[s];
      const float du_ = dd * uu;
      const float* bs = &sbc[s][0];
      const float* cs = bs + N;
      float v[M];                          // this channel's dB_t, dC_t terms
      float acc_u = 0.f, acc_t = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float hp = hist[(s * N + n) * kBwdThreads + tid];
        const float e = fast_exp2(dd * a2[n]);
        const float gn = fmaf(gy, cs[n], g[n]);
        v[n] = gn * du_;
        v[N + n] = gy * h[n];
        acc_u = fmaf(gn, bs[n], acc_u);
        acc_t = fmaf(gn, fmaf(uu, bs[n], hp * an[n] * e), acc_t);
        da_acc[n] = fmaf(gn * hp, dd * e, da_acc[n]);
        g[n] = gn * e;
        h[n] = hp;
      }
      if (active) {
        du[off] = from_f32<T>(fmaf(gy, ds, dd * acc_u));
        ddt[off] = from_f32<T>(acc_t);
      }
      dd_acc = fmaf(gy, uu, dd_acc);
      const float r = warp_reduce_scatter<M>(v, lane);
      if (lane % kGroup == 0) red[warp][s][lane / kGroup] = r;
    }
    __syncthreads();
    for (int e = tid; e < steps * M; e += kBwdThreads) {
      const int s = e / M, j = e % M;
      float x = red[0][s][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) x += red[w][s][j];
      part_bc[((row0 + t0 + s) * blocks_per_row + blk) * M + j] = x;
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      part_a[(static_cast<int64_t>(bi) * N + n) * D + d] = da_acc[n];
    }
    part_d[static_cast<int64_t>(bi) * D + d] = dd_acc;
  }
}

// dB, dC: each (row, t, j) the sum of the CTAs' partials in CTA order; da,
// dD: the batch rows' sums in row order
template <typename T, int N>
__global__ void __launch_bounds__(256)
selective_scan_bwd_sum(const float* __restrict__ part_bc,
                       const float* __restrict__ part_a,
                       const float* __restrict__ part_d, T* __restrict__ db,
                       T* __restrict__ dc, float* __restrict__ da,
                       float* __restrict__ dd, int64_t B, int64_t L,
                       int64_t D, uint32_t blocks_per_row) {
  constexpr int M = 2 * N;
  const int64_t n_bc = B * L * M, n_a = N * D;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
       i < n_bc + n_a + D; i += static_cast<int64_t>(gridDim.x) * 256) {
    if (i < n_bc) {
      const int64_t step = i / M;
      const int j = static_cast<int>(i % M);
      const float* p = part_bc + step * blocks_per_row * M + j;
      float x = 0.f;
      for (uint32_t k = 0; k < blocks_per_row; ++k) x += p[k * M];
      (j < N ? db : dc)[step * N + j % N] = from_f32<T>(x);
    } else if (i < n_bc + n_a) {
      const int64_t e = i - n_bc;           // n * D + d
      float x = 0.f;
      for (int64_t b = 0; b < B; ++b) x += part_a[b * n_a + e];
      da[e] = x;
    } else {
      const int64_t e = i - n_bc - n_a;
      float x = 0.f;
      for (int64_t b = 0; b < B; ++b) x += part_d[b * D + e];
      dd[e] = x;
    }
  }
}

// The forward, with the states checkpointed (ckpt not null) or not.
template <typename T, int N>
int launch_fwd(const T* u, const T* dt, const T* b, const T* c,
               const float* a, const float* d_skip, T* y, float* h_final,
               float* ckpt, int64_t L, int64_t D, uint32_t bpr, dim3 grid,
               cudaStream_t s) {
  if (ckpt != nullptr) {
    selective_scan_kernel<T, N, true><<<grid, kThreads, 0, s>>>(
        u, dt, b, c, a, d_skip, y, h_final, ckpt, L, D, bpr);
  } else {
    selective_scan_kernel<T, N, false><<<grid, kThreads, 0, s>>>(
        u, dt, b, c, a, d_skip, y, h_final, nullptr, L, D, bpr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* dt, const void* b, const void* c,
           const void* a, const void* d_skip, void* y, void* h_final,
           void* ckpt, int64_t B, int64_t L, int64_t D, int64_t N,
           void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (L < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bpr = (D + kThreads - 1) / kThreads;
  if (B * bpr > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(B * bpr));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* tu = static_cast<const T*>(u);
  const T* tdt = static_cast<const T*>(dt);
  const T* tb = static_cast<const T*>(b);
  const T* tc = static_cast<const T*>(c);
  const float* fa = static_cast<const float*>(a);
  const float* fd = static_cast<const float*>(d_skip);
  T* ty = static_cast<T*>(y);
  float* fh = static_cast<float*>(h_final);
  float* fc = static_cast<float*>(ckpt);
  const uint32_t ubpr = static_cast<uint32_t>(bpr);
  switch (N) {
    case 4:
      return launch_fwd<T, 4>(tu, tdt, tb, tc, fa, fd, ty, fh, fc, L, D, ubpr,
                              grid, s);
    case 8:
      return launch_fwd<T, 8>(tu, tdt, tb, tc, fa, fd, ty, fh, fc, L, D, ubpr,
                              grid, s);
    case 16:
      return launch_fwd<T, 16>(tu, tdt, tb, tc, fa, fd, ty, fh, fc, L, D,
                               ubpr, grid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

struct BwdArgs {
  const void *u, *dt, *b, *c, *a, *d_skip, *dy, *dh_final, *ckpt;
  void *du, *ddt, *db, *dc, *da, *dd, *part_bc, *part_a, *part_d;
};

template <typename T, int N>
int launch_bwd_n(const BwdArgs& p, int64_t B, int64_t L, int64_t D,
                 int64_t bpr, cudaStream_t s) {
  constexpr int smem = kChunk * N * kBwdThreads * 4;   // hist
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<T, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t ubpr = static_cast<uint32_t>(bpr);
  selective_scan_bwd_kernel<T, N>
      <<<static_cast<unsigned>(B * bpr), kBwdThreads, smem, s>>>(
          static_cast<const T*>(p.u), static_cast<const T*>(p.dt),
          static_cast<const T*>(p.b), static_cast<const T*>(p.c),
          static_cast<const float*>(p.a), static_cast<const float*>(p.d_skip),
          static_cast<const T*>(p.dy), static_cast<const float*>(p.dh_final),
          static_cast<const float*>(p.ckpt), static_cast<T*>(p.du),
          static_cast<T*>(p.ddt), static_cast<float*>(p.part_bc),
          static_cast<float*>(p.part_a), static_cast<float*>(p.part_d), L, D,
          ubpr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = B * L * 2 * N + N * D + D;
  const int64_t blocks = (total + 255) / 256;
  selective_scan_bwd_sum<T, N><<<static_cast<unsigned>(
                                     blocks < 132 * 8 ? blocks : 132 * 8),
                                 256, 0, s>>>(
      static_cast<const float*>(p.part_bc),
      static_cast<const float*>(p.part_a),
      static_cast<const float*>(p.part_d), static_cast<T*>(p.db),
      static_cast<T*>(p.dc), static_cast<float*>(p.da),
      static_cast<float*>(p.dd), B, L, D, ubpr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const BwdArgs& p, int64_t B, int64_t L, int64_t D, int64_t N,
               void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (L < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bpr = (D + kBwdThreads - 1) / kBwdThreads;
  if (B * bpr > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4:
      return launch_bwd_n<T, 4>(p, B, L, D, bpr, s);
    case 8:
      return launch_bwd_n<T, 8>(p, B, L, D, bpr, s);
    case 16:
      return launch_bwd_n<T, 16>(p, B, L, D, bpr, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Each returns the cudaError_t of its launches (0 on success).
extern "C" int selective_scan_f32(const void* u, const void* dt, const void* b,
                                  const void* c, const void* a,
                                  const void* d_skip, void* y, void* h_final,
                                  int64_t B, int64_t L, int64_t D, int64_t N,
                                  void* stream) {
  return launch<float>(u, dt, b, c, a, d_skip, y, h_final, nullptr, B, L, D,
                       N, stream);
}

extern "C" int selective_scan_bf16(const void* u, const void* dt,
                                   const void* b, const void* c, const void* a,
                                   const void* d_skip, void* y, void* h_final,
                                   int64_t B, int64_t L, int64_t D, int64_t N,
                                   void* stream) {
  return launch<__nv_bfloat16>(u, dt, b, c, a, d_skip, y, h_final, nullptr, B,
                               L, D, N, stream);
}

// The forward that also writes ckpt (B, ceil(L / 16), N, D) float32: the
// state before every 16th step, for the backward.
extern "C" int selective_scan_ckpt_f32(const void* u, const void* dt,
                                       const void* b, const void* c,
                                       const void* a, const void* d_skip,
                                       void* y, void* h_final, void* ckpt,
                                       int64_t B, int64_t L, int64_t D,
                                       int64_t N, void* stream) {
  return launch<float>(u, dt, b, c, a, d_skip, y, h_final, ckpt, B, L, D, N,
                       stream);
}

extern "C" int selective_scan_ckpt_bf16(const void* u, const void* dt,
                                        const void* b, const void* c,
                                        const void* a, const void* d_skip,
                                        void* y, void* h_final, void* ckpt,
                                        int64_t B, int64_t L, int64_t D,
                                        int64_t N, void* stream) {
  return launch<__nv_bfloat16>(u, dt, b, c, a, d_skip, y, h_final, ckpt, B,
                               L, D, N, stream);
}

// The backward: du, ddt (B, L, D) and db, dc (B, L, N) in u's type, da (N,
// D) and dd (1, D) float32, from the forward's inputs, dy (B, L, D) in u's
// type, dh_final (B, N, D) float32 or null (no cotangent) and the
// forward's ckpt; part_bc (B, L, ceil(D / 64), 2N), part_a (B, N, D) and
// part_d (B, D) are float32 workspaces.
extern "C" int selective_scan_bwd_f32(const void* u, const void* dt,
                                      const void* b, const void* c,
                                      const void* a, const void* d_skip,
                                      const void* dy, const void* dh_final,
                                      const void* ckpt, void* du, void* ddt,
                                      void* db, void* dc, void* da, void* dd,
                                      void* part_bc, void* part_a,
                                      void* part_d, int64_t B, int64_t L,
                                      int64_t D, int64_t N, void* stream) {
  const BwdArgs p{u,  dt,  b,  c,  a,  d_skip, dy,      dh_final, ckpt,
                  du, ddt, db, dc, da, dd,     part_bc, part_a,   part_d};
  return launch_bwd<float>(p, B, L, D, N, stream);
}

extern "C" int selective_scan_bwd_bf16(const void* u, const void* dt,
                                       const void* b, const void* c,
                                       const void* a, const void* d_skip,
                                       const void* dy, const void* dh_final,
                                       const void* ckpt, void* du, void* ddt,
                                       void* db, void* dc, void* da, void* dd,
                                       void* part_bc, void* part_a,
                                       void* part_d, int64_t B, int64_t L,
                                       int64_t D, int64_t N, void* stream) {
  const BwdArgs p{u,  dt,  b,  c,  a,  d_skip, dy,      dh_final, ckpt,
                  du, ddt, db, dc, da, dd,     part_bc, part_a,   part_d};
  return launch_bwd<__nv_bfloat16>(p, B, L, D, N, stream);
}
