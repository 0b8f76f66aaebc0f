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
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ a,
                      const float* __restrict__ d_skip, T* __restrict__ y,
                      float* __restrict__ h_final, int64_t L, int64_t D,
                      uint32_t blocks_per_row) {
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

template <typename T>
int launch(const void* u, const void* dt, const void* b, const void* c,
           const void* a, const void* d_skip, void* y, void* h_final,
           int64_t B, int64_t L, int64_t D, int64_t N, void* stream) {
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
  const uint32_t ubpr = static_cast<uint32_t>(bpr);
  switch (N) {
    case 4:
      selective_scan_kernel<T, 4><<<grid, kThreads, 0, s>>>(
          tu, tdt, tb, tc, fa, fd, ty, fh, L, D, ubpr);
      break;
    case 8:
      selective_scan_kernel<T, 8><<<grid, kThreads, 0, s>>>(
          tu, tdt, tb, tc, fa, fd, ty, fh, L, D, ubpr);
      break;
    case 16:
      selective_scan_kernel<T, 16><<<grid, kThreads, 0, s>>>(
          tu, tdt, tb, tc, fa, fd, ty, fh, L, D, ubpr);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success).
extern "C" int selective_scan_f32(const void* u, const void* dt, const void* b,
                                  const void* c, const void* a,
                                  const void* d_skip, void* y, void* h_final,
                                  int64_t B, int64_t L, int64_t D, int64_t N,
                                  void* stream) {
  return launch<float>(u, dt, b, c, a, d_skip, y, h_final, B, L, D, N, stream);
}

extern "C" int selective_scan_bf16(const void* u, const void* dt,
                                   const void* b, const void* c, const void* a,
                                   const void* d_skip, void* y, void* h_final,
                                   int64_t B, int64_t L, int64_t D, int64_t N,
                                   void* stream) {
  return launch<__nv_bfloat16>(u, dt, b, c, a, d_skip, y, h_final, B, L, D, N,
                               stream);
}
