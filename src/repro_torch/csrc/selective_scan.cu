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
// which also writes the state before every kCkptSteps-th step for the
// backward (the last section of this file); the serve instances are the
// code without it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 64;      // channels per block: 512 blocks at B 4, D 8192
constexpr int kChunk = 16;        // timesteps staged per round
constexpr int kCkptSteps = 8;     // steps between checkpoints (ops.CHUNK)
static_assert(kChunk % kCkptSteps == 0, "whole checkpoint intervals a chunk");
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
        if constexpr (kCkpt) {     // the state before step t0 + s, for backward
          if (s % kCkptSteps == 0 && active) {
            const int64_t n_ckpt = (L + kCkptSteps - 1) / kCkptSteps;
            const int64_t row =
                (static_cast<int64_t>(bi) * n_ckpt + (t0 + s) / kCkptSteps) * N;
#pragma unroll
            for (int n = 0; n < N; ++n) ckpt[(row + n) * D + d] = h[n];
          }
        }
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
//   ddt_t   = u_t sum_n g_t B_t + sum_n a g_t h_{t-1} dA_t
//   da      = sum_{b,t} g_t h_{t-1} dt_t dA_t      dD = sum_{b,t} dy_t u_t
// du, ddt, dB, dC come back in u's type, rounded once; da and dD float32.
//
// The state history.  Walking back needs h_{t-1} at every step; kept whole
// it is B L N D float32 (8.6 GB at falcon-mamba-7b's training shape B 4, L
// 4096, D 8192, N 16).  So the forward instance that runs under grad
// (kCkpt) writes the state before every kCkptSteps-th step, (B, L / 8, N,
// D) float32 (1.07 GB there), and the backward, chunk by chunk from the
// last, rebuilds the chunk's 8 states from that checkpoint with the
// forward's own expressions (fast_exp2 of dt * (a log2 e), h = h e + du b,
// in the same order), so the gradient is taken at the states the forward
// had; then walks the chunk in reverse.
//
// What bounds it: the B L D N exponentials of dA on the SFU (16 a clock an
// SM: 0.51 ms at the training shape), beside ~15 float32 operations an
// element (one channel, state and step) on the CUDA cores, which issue
// them at 4 warp instructions a clock an SM.  The design keeps the
// schedulers fed (PERF.md has what each choice gave on the card):
//   - every CTA resident at once.  A thread holds 4 states of 2 channels,
//     8 elements; the N / 4 threads that share a channel's states are
//     neighbouring lanes, and a CTA of 16 N threads covers 128 channels.
//     At N 16 that is 256 threads, 256 CTAs at the training shape, two an
//     SM (16 warps) in one wave.  The chunk's history, 8 steps of a
//     thread's 8 states, lives in shared memory (64 KB a CTA at N 16);
//   - the walk takes dA of the chunk's last kKeepSteps steps from the
//     rebuild (registers) and the others again, by the same expression:
//     keeping all 8 took 64 registers and spilled, and ran slower;
//   - u, dt and dy are staged once a channel, b and c once a CTA, into
//     shared memory as float32 (dt, dt u, dy, u); the next chunk's inputs
//     and checkpoint come by cp.async while this chunk computes (or, for
//     operands not 16-byte aligned, by loads in flight across the pass);
//   - the sums over channels leave the step's path.  A thread sums its two
//     channels' dB_t and dC_t terms in registers (fused into the
//     multiplies) and writes them over its own history slot of step t;
//     after the chunk, the CTA adds its 64 pairs' partials of each (t, n)
//     through shared memory.  du_t and ddt_t, sums over a channel's
//     states, are added across its lanes by shuffles.  A second launch
//     (selective_scan_bwd_sum) adds the CTAs' partials in CTA order, and
//     da's and dD's per-row sums in row order.  No float atomics: the
//     gradient is the same bits on every run.

constexpr int kBwdChannels = 128;  // channels a backward CTA (ops.CTA_CHANNELS)
constexpr int kKeepSteps = 4;      // steps whose dA the walk keeps (rebuild)
constexpr float kLn2 = 0.6931471805599453f;

// The backward's layout at state size N: thread tid = pair P + slice holds
// states [4 slice, 4 slice + 4) of its CTA's channels 2 pair and 2 pair + 1
// (q 0 and 1).  Shared memory, in order: hist [K][2][kHistRow] float4, the
// states of channel q before each step, then that step's dB (q 0) and dC
// (q 1) partials over the thread's two channels; sin [K][C] float4 (dt,
// dt u, dy, u); ruc [K][2][kRucRow] float2, channel q's du and ddt; sbc
// [K][2N] float (b, c); with kAsync the next chunk's inputs as they come
// by cp.async: u, dt, dy [K][C] T, b, c [K][N] T and the checkpoint [N][C]
// float32.
template <typename T, int N, bool kAsync>
struct BwdLayout {
  static constexpr int K = kCkptSteps;
  static constexpr int C = kBwdChannels;
  static constexpr int M = 2 * N;           // dB's and dC's values a step
  static constexpr int P = N / 4;           // threads a channel's states span
  static constexpr int kPairs = C / 2;
  static constexpr int kThreads = kPairs * P;
  // (step, channel) slots of a chunk a thread stages, and the channels
  // among them (2 at N 4, else 1: a thread keeps its channels' dD sums)
  static constexpr int kStage = K * C / kThreads;
  static constexpr int kStageCh = kThreads < C ? C / kThreads : 1;
  // + 4: q 1's partials on the other half of the banks from q 0's
  static constexpr int kHistRow = kThreads + 4;
  static constexpr int kRucRow = kPairs + 4;
  static constexpr size_t kHistBytes = size_t{K} * 2 * kHistRow * 16;
  static constexpr size_t kSinBytes = size_t{K} * C * 16;
  static constexpr size_t kRucBytes = size_t{K} * 2 * kRucRow * 8;
  static constexpr size_t kSbcBytes = size_t{K} * M * 4;
  static constexpr size_t kRawBytes =
      kAsync ? (3 * K * C + 2 * K * N) * sizeof(T) + size_t{N} * C * 4 : 0;
  static constexpr size_t kSmem =
      kHistBytes + kSinBytes + kRucBytes + kSbcBytes + kRawBytes;
};

// Two neighbouring values, rounded each to T, by one store (p aligned to
// two of T).
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// 16 bytes from global to shared memory, asynchronously (src_bytes 0:
// zeros, nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(on ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Staging slot k of thread tid: (step s, channel ch) of the chunk.
template <int kT, int C>
__device__ __forceinline__ void stage_slot(int tid, int k, int& s, int& ch) {
  if constexpr (kT >= C) {
    s = tid / C + k * (kT / C);
    ch = tid % C;
  } else {
    s = k / (C / kT);
    ch = tid + k % (C / kT) * kT;
  }
}

// Block k of batch row bi owns channels [k * 128, (k + 1) * 128).  kAsync
// (D a multiple of 16 / sizeof(T), 2N values of b and c a whole number of
// 16-byte blocks, every input 16-byte aligned): the next chunk's inputs
// come by cp.async, in flight across the whole chunk; else by loads into
// registers, in flight across the chunk's pass.
template <typename T, int N, bool kAsync>
__global__ void __launch_bounds__(BwdLayout<T, N, kAsync>::kThreads, 2)
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
  using Lay = BwdLayout<T, N, kAsync>;
  constexpr int K = Lay::K, C = Lay::C, M = Lay::M, P = Lay::P;
  constexpr int kT = Lay::kThreads, kPairs = Lay::kPairs;
  constexpr int kHistRow = Lay::kHistRow, kRucRow = Lay::kRucRow;
  constexpr int kStage = Lay::kStage, kStageCh = Lay::kStageCh;
  constexpr int kKeep = kKeepSteps < K ? kKeepSteps : K;
  extern __shared__ float4 smem[];
  float4* hist = smem;
  float4* sin4 = reinterpret_cast<float4*>(
      reinterpret_cast<char*>(smem) + Lay::kHistBytes);
  float2* ruc = reinterpret_cast<float2*>(
      reinterpret_cast<char*>(sin4) + Lay::kSinBytes);
  float* sbc = reinterpret_cast<float*>(
      reinterpret_cast<char*>(ruc) + Lay::kRucBytes);
  const float4* sbc4 = reinterpret_cast<const float4*>(sbc);
  // kAsync: the next chunk's inputs as they arrive
  T* raw = reinterpret_cast<T*>(reinterpret_cast<char*>(sbc) + Lay::kSbcBytes);
  float* cks = reinterpret_cast<float*>(raw + 3 * K * C + 2 * K * N);
  const uint32_t bi = blockIdx.x / blocks_per_row;
  const uint32_t blk = blockIdx.x - bi * blocks_per_row;
  const int tid = threadIdx.x, slice = tid % P, pair = tid / P;
  const int64_t d0 = static_cast<int64_t>(blk) * C + 2 * pair;
  const int64_t row0 = static_cast<int64_t>(bi) * L;   // (bi, t = 0)
  const int iD = static_cast<int>(D);      // D K < 2^31 (launch_bwd)
  // channels of this CTA that exist: C, or fewer in a row's last CTA
  const int64_t left = D - static_cast<int64_t>(blk) * C;
  const int live = left < C ? static_cast<int>(left) : C;
  // dy D, du's term outside the sum over states, joins the shares of the
  // lane of slice 0
  float a2[2][4], g[2][4], da[2][4], h[2][4], ds[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int64_t d = d0 + q;
    const bool on = 2 * pair + q < live;
    ds[q] = on && slice == 0 ? d_skip[d] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t n = 4 * slice + i;
      a2[q][i] = on ? a[n * D + d] * kLog2e : 0.f;       // the forward's a2
      g[q][i] = on && dh_final != nullptr
                    ? dh_final[(static_cast<int64_t>(bi) * N + n) * D + d]
                    : 0.f;
      da[q][i] = 0.f;
    }
  }
  float pdd[kStageCh];                     // dD of the channels it stages
#pragma unroll
  for (int k = 0; k < kStageCh; ++k) pdd[k] = 0.f;
  const int64_t n_ckpt = (L + K - 1) / K;
  // without kAsync, a chunk's inputs as loaded (widened to float32 only
  // when staged, so that nothing waits on the loads before then): u, dt,
  // dy of the thread's kStage slots, one value of b or c; its checkpoint
  // into h
  T ru[kStage], rdt[kStage], rdy[kStage], rbc;
  auto load = [&](int64_t c) {
    const int64_t t0 = c * K;
    const int steps = static_cast<int>(L - t0 < K ? L - t0 : K);
    // 32-bit offsets within the chunk from (bi, t0, this CTA's first
    // channel), and from this thread's states of the checkpoint
    const int64_t base = (row0 + t0) * D + static_cast<int64_t>(blk) * C;
    const float* ck = ckpt + ((static_cast<int64_t>(bi) * n_ckpt + c) * N +
                              4 * slice) * D + d0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[q][i] = 2 * pair + q < live ? ck[i * iD + q] : 0.f;
      }
    }
    const T* uc = u + base;
    const T* dtc = dt + base;
    const T* dyc = dy + base;
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      int s, ch;
      stage_slot<kT, C>(tid, k, s, ch);
      const bool in = s < steps && ch < live;
      const int off = s * iD + ch;
      ru[k] = in ? uc[off] : from_f32<T>(0.f);
      rdt[k] = in ? dtc[off] : from_f32<T>(0.f);
      rdy[k] = in ? dyc[off] : from_f32<T>(0.f);
    }
    static_assert(K * M == kT, "one value of b or c a thread");
    const int s = tid / M, j = tid % M;
    rbc = s < steps ? (j < N ? bm : cm)[(row0 + t0) * N + s * N + j % N]
                    : from_f32<T>(0.f);
  };
  // with kAsync, the chunk's 16-byte blocks into raw and cks: rows of u,
  // dt, dy (the CTA's channels), of b and c, of the checkpoint; a block
  // past the chunk's steps or the row's channels is zeros
  auto fetch = [&](int64_t c) {
    if constexpr (kAsync) {
      constexpr int E = 16 / sizeof(T);      // elements a block
      constexpr int kRow = C / E;            // blocks a (step, array) row
      constexpr int kBcRow = N / E;          // blocks of b (or c) a step
      const int64_t t0 = c * K;
      const int steps = static_cast<int>(L - t0 < K ? L - t0 : K);
      const int64_t base = (row0 + t0) * D + static_cast<int64_t>(blk) * C;
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        const T* src = (w == 0 ? u : w == 1 ? dt : dy) + base;
#pragma unroll
        for (int k = 0; k < (K * kRow + kT - 1) / kT; ++k) {
          const int o = tid + k * kT, s = o / kRow, col = o % kRow * E;
          if (K * kRow % kT == 0 || o < K * kRow) {
            const bool on = s < steps && col < live;
            cp_async16(raw + (w * K + s) * C + col,
                       on ? src + s * iD + col : src, on);
          }
        }
      }
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const T* src = (w == 0 ? bm : cm) + (row0 + t0) * N;
#pragma unroll
        for (int k = 0; k < (K * kBcRow + kT - 1) / kT; ++k) {
          const int o = tid + k * kT;
          if (K * kBcRow % kT == 0 || o < K * kBcRow) {
            const bool on = o / kBcRow < steps;
            cp_async16(raw + 3 * K * C + w * K * N + o * E,
                       on ? src + o * E : src, on);
          }
        }
      }
      const float* ck = ckpt +
                        (static_cast<int64_t>(bi) * n_ckpt + c) * N * D +
                        static_cast<int64_t>(blk) * C;
#pragma unroll
      for (int k = 0; k < (N * C / 4 + kT - 1) / kT; ++k) {
        const int o = tid + k * kT, n = o / (C / 4), col = o % (C / 4) * 4;
        if (N * C / 4 % kT == 0 || o < N * C / 4) {
          const bool on = col < live;
          cp_async16(cks + n * C + col, on ? ck + n * iD + col : ck, on);
        }
      }
    }
  };
  if (n_ckpt > 0) {
    if constexpr (kAsync) {
      fetch(n_ckpt - 1);
    } else {
      load(n_ckpt - 1);
    }
  }
  for (int64_t c = n_ckpt - 1; c >= 0; --c) {
    const int64_t t0 = c * K;
    const int steps = static_cast<int>(L - t0 < K ? L - t0 : K);
    // stage the chunk (the last walk is done with sin and sbc, the last
    // pass reads only hist and ruc): u, dt, dy once a channel, as float32
    // (dt u as the forward's du); b and c once a CTA
    if constexpr (kAsync) {
      cp_async_wait_all();
      __syncthreads();                     // every thread's blocks are in
      const int s = tid / M, j = tid % M;
      sbc[tid] = to_f32(raw[3 * K * C + (j / N * K + s) * N + j % N]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          h[q][i] = cks[(4 * slice + i) * C + 2 * pair + q];
        }
      }
    } else {
      sbc[tid] = to_f32(rbc);
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      int s, ch;
      stage_slot<kT, C>(tid, k, s, ch);
      float uu, dd, gy;
      if constexpr (kAsync) {
        uu = to_f32(raw[s * C + ch]);
        dd = to_f32(raw[(K + s) * C + ch]);
        gy = to_f32(raw[(2 * K + s) * C + ch]);
      } else {
        uu = to_f32(ru[k]);
        dd = to_f32(rdt[k]);
        gy = to_f32(rdy[k]);
      }
      sin4[s * C + ch] = make_float4(dd, dd * uu, gy, uu);
      pdd[k % kStageCh] = fmaf(gy, uu, pdd[k % kStageCh]);
    }
    __syncthreads();                       // and the last pass is done
    if constexpr (kAsync) {
      if (c > 0) fetch(c - 1);             // in flight across the chunk
    }
    // rebuild the chunk's states from its checkpoint, as the forward: h
    // before step s into hist[s], dA of the last kKeep steps into eh
    float eh[kKeep > 0 ? kKeep : 1][2][4];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s >= steps) break;
      const float4 in0 = sin4[s * C + 2 * pair];
      const float4 in1 = sin4[s * C + 2 * pair + 1];
      const float4 bq = sbc4[s * (M / 4) + slice];
      const float bs[4] = {bq.x, bq.y, bq.z, bq.w};
      float4* hs = hist + s * 2 * kHistRow + tid;
      hs[0] = make_float4(h[0][0], h[0][1], h[0][2], h[0][3]);
      hs[kHistRow] = make_float4(h[1][0], h[1][1], h[1][2], h[1][3]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float dd = q ? in1.x : in0.x, du_ = q ? in1.y : in0.y;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = fast_exp2(dd * a2[q][i]);
          if (s >= K - kKeep) eh[s - (K - kKeep)][q][i] = e;
          h[q][i] = h[q][i] * e + du_ * bs[i];
        }
      }
    }
    // walk it back: h holds h_t, hist[s] h_{t-1}
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = K - 1 - j;
      if (s >= steps) continue;
      const float4 in0 = sin4[s * C + 2 * pair];
      const float4 in1 = sin4[s * C + 2 * pair + 1];
      const float4 bq = sbc4[s * (M / 4) + slice];
      const float4 cq = sbc4[s * (M / 4) + N / 4 + slice];
      const float bs[4] = {bq.x, bq.y, bq.z, bq.w};
      const float cs[4] = {cq.x, cq.y, cq.z, cq.w};
      float4* hs = hist + s * 2 * kHistRow + tid;
      const float4 hp0 = hs[0], hp1 = hs[kHistRow];
      float pb[4], pc[4], au[2], at[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 in = q ? in1 : in0;         // dt, dt u, dy, u
        const float4 hq = q ? hp1 : hp0;
        const float hp[4] = {hq.x, hq.y, hq.z, hq.w};
        au[q] = at[q] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = s >= K - kKeep ? eh[s - (K - kKeep)][q][i]
                                         : fast_exp2(in.x * a2[q][i]);
          const float gn = fmaf(in.z, cs[i], g[q][i]);
          pb[i] = q ? fmaf(gn, in.y, pb[i]) : gn * in.y;
          pc[i] = q ? fmaf(in.z, h[q][i], pc[i]) : in.z * h[q][i];
          au[q] = fmaf(gn, bs[i], au[q]);
          g[q][i] = gn * e;                      // g_{t-1}'s carried part
          const float w = g[q][i] * hp[i];       // g_t dA_t h_{t-1}
          at[q] = fmaf(a2[q][i], w, at[q]);
          da[q][i] = fmaf(in.x, w, da[q][i]);
          h[q][i] = hp[i];
        }
      }
      hs[0] = make_float4(pb[0], pb[1], pb[2], pb[3]);
      hs[kHistRow] = make_float4(pc[0], pc[1], pc[2], pc[3]);
      // this lane's shares of du_t and ddt_t, channel by channel
      const float pu0 = fmaf(in0.z, ds[0], in0.x * au[0]);
      const float pu1 = fmaf(in1.z, ds[1], in1.x * au[1]);
      const float pt0 = fmaf(in0.w, au[0], kLn2 * at[0]);
      const float pt1 = fmaf(in1.w, au[1], kLn2 * at[1]);
      float2* rs = ruc + s * 2 * kRucRow + pair;
      if constexpr (P == 1) {
        rs[0] = make_float2(pu0, pt0);
        rs[kRucRow] = make_float2(pu1, pt1);
      } else {
        // lanes slice and slice ^ 1 (one pair): the even one adds channel
        // 0's shares, the odd one channel 1's; then (N 16) lanes slice and
        // slice ^ 2 add theirs, and slices 0 and 1 hold the sums
        const bool odd = slice & 1;
        float ku = (odd ? pu1 : pu0) +
                   __shfl_xor_sync(0xffffffffu, odd ? pu0 : pu1, 1);
        float kt = (odd ? pt1 : pt0) +
                   __shfl_xor_sync(0xffffffffu, odd ? pt0 : pt1, 1);
        if constexpr (P == 4) {
          ku += __shfl_xor_sync(0xffffffffu, ku, 2);
          kt += __shfl_xor_sync(0xffffffffu, kt, 2);
        }
        if (slice < 2) rs[slice * kRucRow] = make_float2(ku, kt);
      }
    }
    __syncthreads();                       // the chunk's partials are in
    if constexpr (!kAsync) {
      if (c > 0) load(c - 1);              // in flight across the pass
    }
    // dB_t, dC_t: each (t, j) the sum of the 64 pairs' partials.  Four
    // lanes (lane bits 2 and 3: pq) take the 4 states [4 sl, 4 sl + 4) of
    // b or c (bc) at step s, each lane a quarter of the pairs (p = pq mod
    // 4, in pair order, as two interleaved sums; the 8 lanes of a quarter
    // warp on 8 different bank groups), then add their four sums by a
    // reduce-scatter of shuffles, after which lane pq holds state 4 sl +
    // pq.  The order is fixed: the same bits on every run.
    {
      const int grp = (tid & 3) | (tid >> 4) << 2, pq = tid >> 2 & 3;
      const int s = grp / (2 * P), bc = grp / P % 2, sl = grp % P;
      const float4* src = hist + (s * 2 + bc) * kHistRow + pq * P + sl;
      float4 x0 = src[0], x1 = src[4 * P];  // pairs pq, 4 + pq
#pragma unroll
      for (int j = 2; j < kPairs / 4; j += 2) {   // pairs 4 j + pq, ...
        const float4 y0 = src[j * 4 * P], y1 = src[(j + 1) * 4 * P];
        x0.x += y0.x; x0.y += y0.y; x0.z += y0.z; x0.w += y0.w;
        x1.x += y1.x; x1.y += y1.y; x1.z += y1.z; x1.w += y1.w;
      }
      const float v[4] = {x0.x + x1.x, x0.y + x1.y, x0.z + x1.z,
                          x0.w + x1.w};
      // lanes pq and pq ^ 2: the lower keeps states 0, 1, the upper 2, 3
      const bool hi2 = pq & 2, hi1 = pq & 1;
      const float k0 = (hi2 ? v[2] : v[0]) +
                       __shfl_xor_sync(0xffffffffu, hi2 ? v[0] : v[2], 8);
      const float k1 = (hi2 ? v[3] : v[1]) +
                       __shfl_xor_sync(0xffffffffu, hi2 ? v[1] : v[3], 8);
      const float r = (hi1 ? k1 : k0) +
                      __shfl_xor_sync(0xffffffffu, hi1 ? k0 : k1, 4);
      if (s < steps) {
        part_bc[((row0 + t0 + s) * blocks_per_row + blk) * M + bc * N +
                4 * sl + pq] = r;
      }
    }
    // du_t, ddt_t: the sums the lanes left in ruc; with kAsync (D even) a
    // pair's two channels by one store
    const int64_t base = (row0 + t0) * D + static_cast<int64_t>(blk) * C;
    if constexpr (kAsync) {
#pragma unroll
      for (int k = 0; k < K * kPairs / kT; ++k) {
        const int o = tid + k * kT, s = o / kPairs, pr = o % kPairs;
        if (s < steps && 2 * pr < live) {
          const float2 x0 = ruc[s * 2 * kRucRow + pr];
          const float2 x1 = ruc[(s * 2 + 1) * kRucRow + pr];
          store2(du + base + s * iD + 2 * pr, x0.x, x1.x);
          store2(ddt + base + s * iD + 2 * pr, x0.y, x1.y);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        int s, ch;
        stage_slot<kT, C>(tid, k, s, ch);
        if (s < steps && ch < live) {
          const float2 x = ruc[(s * 2 + ch % 2) * kRucRow + ch / 2];
          du[base + s * iD + ch] = from_f32<T>(x.x);
          ddt[base + s * iD + ch] = from_f32<T>(x.y);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (2 * pair + q < live) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part_a[(static_cast<int64_t>(bi) * N + 4 * slice + i) * D + d0 + q] =
            da[q][i];
      }
    }
  }
  // dD: the staged channels' sums (at N 16 two threads a channel, added
  // in thread order)
  if constexpr (kT > C) {
    __syncthreads();
    float* red = reinterpret_cast<float*>(sin4);
    red[tid] = pdd[0];
    __syncthreads();
    if (tid < live) {
      float x = red[tid];
#pragma unroll
      for (int k = 1; k < kT / C; ++k) x += red[tid + k * C];
      part_d[static_cast<int64_t>(bi) * D + blk * C + tid] = x;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kStageCh; ++k) {
      int s, ch;
      stage_slot<kT, C>(tid, k, s, ch);
      if (ch < live) {
        part_d[static_cast<int64_t>(bi) * D + blk * C + ch] = pdd[k];
      }
    }
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

// The async instance exists where 2N values of b, c fill whole 16-byte
// blocks.
template <typename T, int N>
constexpr bool kHasAsync = N * sizeof(T) % 16 == 0;

// The backward kernel's shared memory above 48 KB, and the carveout that
// lets two CTAs of it share an SM at N 16.
template <typename T, int N, bool kAsync>
cudaError_t prepare_bwd() {
  const auto kernel = selective_scan_bwd_kernel<T, N, kAsync>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(BwdLayout<T, N, kAsync>::kSmem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int N, bool kAsync>
cudaError_t launch_walk(const BwdArgs& p, int64_t B, int64_t L, int64_t D,
                        int64_t bpr, cudaStream_t s) {
  using Lay = BwdLayout<T, N, kAsync>;
  const cudaError_t err = prepare_bwd<T, N, kAsync>();
  if (err != cudaSuccess) return err;
  selective_scan_bwd_kernel<T, N, kAsync>
      <<<static_cast<unsigned>(B * bpr), Lay::kThreads, Lay::kSmem, s>>>(
      static_cast<const T*>(p.u), static_cast<const T*>(p.dt),
      static_cast<const T*>(p.b), static_cast<const T*>(p.c),
      static_cast<const float*>(p.a), static_cast<const float*>(p.d_skip),
      static_cast<const T*>(p.dy), static_cast<const float*>(p.dh_final),
      static_cast<const float*>(p.ckpt), static_cast<T*>(p.du),
      static_cast<T*>(p.ddt), static_cast<float*>(p.part_bc),
      static_cast<float*>(p.part_a), static_cast<float*>(p.part_d), L, D,
      static_cast<uint32_t>(bpr));
  return cudaGetLastError();
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <typename T, int N>
int launch_bwd_n(const BwdArgs& p, int64_t B, int64_t L, int64_t D,
                 int64_t bpr, cudaStream_t s) {
  cudaError_t err;
  if constexpr (kHasAsync<T, N>) {
    const bool async = D % (16 / sizeof(T)) == 0 && aligned16(p.u) &&
                       aligned16(p.dt) && aligned16(p.dy) &&
                       aligned16(p.b) && aligned16(p.c) && aligned16(p.ckpt);
    err = async ? launch_walk<T, N, true>(p, B, L, D, bpr, s)
                : launch_walk<T, N, false>(p, B, L, D, bpr, s);
  } else {
    err = launch_walk<T, N, false>(p, B, L, D, bpr, s);
  }
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
      static_cast<float*>(p.dd), B, L, D, static_cast<uint32_t>(bpr));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const BwdArgs& p, int64_t B, int64_t L, int64_t D, int64_t N,
               void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (L < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bpr = (D + kBwdChannels - 1) / kBwdChannels;
  if (B * bpr > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  // a chunk's offsets are 32-bit: D kCkptSteps < 2^31
  if (D > INT_MAX / kCkptSteps) return static_cast<int>(cudaErrorInvalidValue);
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

// out[0..7): registers a thread, local memory a thread (bytes: spills),
// threads a CTA, dynamic shared memory a CTA (bytes), CTAs an SM can hold
// (the occupancy calculator), channels a CTA, and whether this is the
// async instance: the one aligned operands take.
template <typename T, int N>
int bwd_attrs_n(int* out) {
  constexpr bool kAsync = kHasAsync<T, N>;
  using Lay = BwdLayout<T, N, kAsync>;
  const auto kernel = selective_scan_bwd_kernel<T, N, kAsync>;
  cudaError_t err = prepare_bwd<T, N, kAsync>();
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  int ctas = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, kernel, Lay::kThreads, Lay::kSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = Lay::kThreads;
  out[3] = static_cast<int>(Lay::kSmem);
  out[4] = ctas;
  out[5] = Lay::C;
  out[6] = kAsync;
  return 0;
}

template <typename T>
int bwd_attrs(int64_t N, int* out) {
  switch (N) {
    case 4:
      return bwd_attrs_n<T, 4>(out);
    case 8:
      return bwd_attrs_n<T, 8>(out);
    case 16:
      return bwd_attrs_n<T, 16>(out);
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

// The forward that also writes ckpt (B, ceil(L / 8), N, D) float32: the
// state before every 8th step, for the backward.
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
// forward's ckpt; part_bc (B, L, ceil(D / 128), 2N), part_a (B, N, D) and
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

// The backward kernel's resources at state size N (bf16 nonzero: the
// bfloat16 instance), into int out[7] as bwd_attrs_n lists them; a query,
// not a launch.
extern "C" int selective_scan_bwd_attrs(int64_t N, int64_t bf16, void* out) {
  int* o = static_cast<int*>(out);
  return bf16 ? bwd_attrs<__nv_bfloat16>(N, o) : bwd_attrs<float>(N, o);
}
