// Batched row scatter for Hopper (sm_90a), in place into dst (B, V, D).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/scatter_rows/kernel.py:
//   * scatter_store_rows_f32 <- scatter_store_rows_kernel (last-write-wins
//     store through a one-hot MXU contraction)
//   * scatter_add_rows_f32   <- scatter_add_rows_kernel   (sum-scatter through
//     a one-hot MXU contraction)
//
// Layouts: dst (B, V, D) float32, idx (B, N) int32, keep (B, N) bool (one
// byte), vals (B, N, D) float32, all contiguous.  Lanes whose index lies
// outside [0, V) (the planner's INT32_MAX, a negative value) are dropped.
// Offsets are 64-bit; grids are flat in x.
//
// Both kernels write in place into the dst they are given, the way the JAX
// engine donates its dst buffer (repro/core/engine.py): the caller hands in
// a fresh zeroed dst for every timed run.
//
// Store.  The TPU kernel copies dst and overwrites the covered rows through
// a one-hot contraction, because the TPU has no scatter hardware.  Here each
// surviving lane stores its row directly.  The host keep mask guarantees at
// most one kept in-range write per row, so no two threads write the same
// address and the result is bit-identical to the reference by construction.
// The kernel reads keep itself and drops `!keep || idx outside [0, V)`
// lanes, so one launch per bucket does what the reference does with a
// where() and a kernel.
//
// Add.  One float atomicAdd per element into the zeroed dst, which equals
// the reference's `dst + sum` up to the order of the additions (atomics
// reorder them from run to run).
//
// What bounds them: bytes, (index + keep + rows read + rows written) /
// 3.35 TB/s, with neighbouring threads on neighbouring lanes (D = 1) or
// columns (wide D) and float4 stores where D % 4 == 0.  Add mode with heavy
// duplication is bound instead by the atomic throughput on the few hot
// addresses: LULESH-S3 (delta 0) sends every lane of the pattern into 16
// rows, and those atomics serialise in L2.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T, bool kUnitD>
__global__ void __launch_bounds__(kThreads)
scatter_store_rows_kernel(T* __restrict__ dst, const int32_t* __restrict__ idx,
                          const uint8_t* __restrict__ keep,
                          const T* __restrict__ vals, int64_t N, int64_t V,
                          int64_t Dv, uint32_t blocks_per_pattern) {
  const uint32_t b = blockIdx.x / blocks_per_pattern;
  const int64_t e =
      static_cast<int64_t>(blockIdx.x - b * blocks_per_pattern) * kThreads +
      threadIdx.x;
  if (e >= N * Dv) return;
  int64_t n = e, d = 0;
  if (!kUnitD) {
    n = e / Dv;
    d = e - n * Dv;
  }
  const int64_t lane = static_cast<int64_t>(b) * N + n;
  if (!__ldg(keep + lane)) return;
  const int32_t row = __ldg(idx + lane);
  if (row < 0 || row >= V) return;
  dst[(static_cast<int64_t>(b) * V + row) * Dv + d] = __ldg(vals + lane * Dv + d);
}

template <bool kUnitD>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(float* __restrict__ dst,
                        const int32_t* __restrict__ idx,
                        const float* __restrict__ vals, int64_t N, int64_t V,
                        int64_t D, uint32_t blocks_per_pattern) {
  const uint32_t b = blockIdx.x / blocks_per_pattern;
  const int64_t e =
      static_cast<int64_t>(blockIdx.x - b * blocks_per_pattern) * kThreads +
      threadIdx.x;
  if (e >= N * D) return;
  int64_t n = e, d = 0;
  if (!kUnitD) {
    n = e / D;
    d = e - n * D;
  }
  const int64_t lane = static_cast<int64_t>(b) * N + n;
  const int32_t row = __ldg(idx + lane);
  if (row < 0 || row >= V) return;
  atomicAdd(dst + (static_cast<int64_t>(b) * V + row) * D + d,
            __ldg(vals + lane * D + d));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success).
extern "C" int scatter_store_rows_f32(void* dst, const void* idx,
                                      const void* keep, const void* vals,
                                      int64_t B, int64_t N, int64_t V,
                                      int64_t D, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  const bool vec = D % 4 == 0 && aligned16(dst) && aligned16(vals);
  const int64_t Dv = vec ? D / 4 : D;
  const int64_t bpp = (N * Dv + kThreads - 1) / kThreads;
  if (B * bpp > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(B * bpp));
  if (vec) {
    scatter_store_rows_kernel<float4, false><<<grid, kThreads, 0, s>>>(
        static_cast<float4*>(dst), ix, kp, static_cast<const float4*>(vals), N,
        V, Dv, static_cast<uint32_t>(bpp));
  } else if (D == 1) {
    scatter_store_rows_kernel<float, true><<<grid, kThreads, 0, s>>>(
        static_cast<float*>(dst), ix, kp, static_cast<const float*>(vals), N,
        V, Dv, static_cast<uint32_t>(bpp));
  } else {
    scatter_store_rows_kernel<float, false><<<grid, kThreads, 0, s>>>(
        static_cast<float*>(dst), ix, kp, static_cast<const float*>(vals), N,
        V, Dv, static_cast<uint32_t>(bpp));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scatter_add_rows_f32(void* dst, const void* idx,
                                    const void* vals, int64_t B, int64_t N,
                                    int64_t V, int64_t D, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const int64_t bpp = (N * D + kThreads - 1) / kThreads;
  if (B * bpp > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(B * bpp));
  if (D == 1) {
    scatter_add_rows_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<float*>(dst), ix, static_cast<const float*>(vals), N, V, D,
        static_cast<uint32_t>(bpp));
  } else {
    scatter_add_rows_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<float*>(dst), ix, static_cast<const float*>(vals), N, V, D,
        static_cast<uint32_t>(bpp));
  }
  return static_cast<int>(cudaGetLastError());
}
