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
// order, so the loop over the sequence lives inside the block: one thread
// owns one (batch row, channel d) pair, keeps h[0..N) and a[0..N, d] in
// registers, and walks t = 0 .. L-1 (any L; no padding).  Neighbouring
// threads take neighbouring d, so the loads of u, dt and the stores of y
// coalesce.  Per chunk of kChunk timesteps the block stages b and c of its
// batch row in shared memory (every channel of the row reads the same
// values) and loads its chunk of u and dt into registers in one go, so the
// loads of a chunk are in flight together.
//
// What bounds it: operations, not bytes.  At the serving shape (B 4, L 2048,
// D 8192, N 16, bf16) u, dt and y are 3 x 134 MB, 0.12 ms at 3.35 TB/s, but
// the recurrence needs B * L * D * N = 1.07e9 exponentials, and the special
// function unit of an H100 SM retires 16 a clock: on 132 SMs at 1.98 GHz
// that is 0.26 ms.  Each exponential is one exp2f (one SFU instruction) of
// dt * (a * log2 e); the pre-scaled a and the product add a relative error
// of about |dt * a| * 2^-23 to each factor exp(dt * a), so the kernel agrees
// with a float32 exp() reference to ~1e-6 of the magnitudes it sums.
//
// Known limit, left for a later change: at B = 4, one thread per channel is
// 32,768 threads, about 8 warps per SM, and the loop over L is latency-bound
// at that occupancy.  Remedies: split N over 2-4 threads per channel with a
// __shfl_xor_sync reduction for y, or a chunked scan over L.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 64;      // channels per block: 512 blocks at B 4, D 8192
constexpr int kChunk = 32;        // timesteps staged per round
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

// Block k of batch row bi owns channels [k * kThreads, (k + 1) * kThreads).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ a,
                      const float* __restrict__ d_skip, T* __restrict__ y,
                      float* __restrict__ h_final, int64_t L, int64_t D,
                      uint32_t blocks_per_row) {
  __shared__ __align__(16) float sb[kChunk][N];
  __shared__ __align__(16) float sc[kChunk][N];
  const uint32_t bi = blockIdx.x / blocks_per_row;
  const int64_t d =
      static_cast<int64_t>(blockIdx.x - bi * blocks_per_row) * kThreads +
      threadIdx.x;
  const bool active = d < D;
  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = active ? a[n * D + d] * kLog2e : 0.f;
    h[n] = 0.f;
  }
  const float ds = active ? d_skip[d] : 0.f;
  const int64_t row0 = static_cast<int64_t>(bi) * L;   // (bi, t = 0)

  for (int64_t t0 = 0; t0 < L; t0 += kChunk) {
    const int steps = static_cast<int>(L - t0 < kChunk ? L - t0 : kChunk);
    float uu[kChunk], dd[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      uu[j] = 0.f;
      dd[j] = 0.f;
      if (active && j < steps) {
        const int64_t off = (row0 + t0 + j) * D + d;
        uu[j] = to_f32(u[off]);
        dd[j] = to_f32(dt[off]);
      }
    }
    const T* bt = bm + (row0 + t0) * N;
    const T* ct = cm + (row0 + t0) * N;
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      (&sb[0][0])[i] = to_f32(bt[i]);
      (&sc[0][0])[i] = to_f32(ct[i]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < steps) {
        const float du = dd[j] * uu[j];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = h[n] * exp2f(dd[j] * a2[n]) + du * sb[j][n];
          acc += h[n] * sc[j][n];
        }
        if (active) {
          y[(row0 + t0 + j) * D + d] = from_f32<T>(acc + ds * uu[j]);
        }
      }
    }
    __syncthreads();               // the next chunk overwrites sb, sc
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
