// Batched row gather for Hopper (sm_90a): out[b, n, :] = table[b, idx[b, n], :].
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/gather_rows/kernel.py:
//   * gather_rows_f32      <- gather_rows_dma  (table in HBM, row DMAs driven by
//                                               scalar-prefetched indices)
//   * gather_rows_smem_f32 <- gather_rows_vmem (each pattern's table staged
//                                               whole on chip)
//
// Layouts: table (B, V, D) float32, idx (B, N) int32, out (B, N, D) float32,
// all contiguous.  An index outside [0, V) reads as 0 (the kernel never
// reads outside the table).  Offsets are 64-bit: B * V * D passes 2^31 at
// full size once D > 1.  Grids are flat in x (y and z cap at 65,535).
//
// What bounds it: bytes.  Each lane reads its 4-byte index and one D-float
// row and writes one D-float row, so the least time is
// (index + rows read + rows written) / 3.35 TB/s.  With D = 1 (the paper's
// scalar element, the default) a "row" is 4 bytes, so the TPU's row-sized
// DMAs have no place here: every thread loads its own index and moves one
// element, neighbouring threads take neighbouring lanes (n) when D = 1 and
// neighbouring columns (d) when D is wide, so stores coalesce and the
// random reads of the table are the only scattered traffic.  When D % 4 == 0
// a thread moves a float4 (16 bytes, the widest single load).
//
// The shared-memory regime stages one pattern's whole (V, D) table in
// dynamic shared memory (at most 227 KB = 232,448 bytes a block), then
// gathers a run of lanes from it, so the scattered reads hit shared memory
// instead of L2/HBM.  Every CTA restages the table; the wrapper
// (kernels/gather_rows/ops.py) picks the lanes per CTA so that restaging
// stays bounded, and picks this regime only where the table fits.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemThreads = 1024;
constexpr int64_t kMaxSmemBytes = 232448;     // 227 KB per block (H100)
constexpr int64_t kDefaultSmemBytes = 48 * 1024;

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero_of<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// One thread per output element in units of T (Dv = D / (sizeof(T) / 4)).
// Block k of pattern b covers elements [k * kThreads, (k + 1) * kThreads)
// of that pattern's (N, Dv) output, d fastest.
template <typename T, bool kUnitD>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                   T* __restrict__ out, int64_t N, int64_t V, int64_t Dv,
                   uint32_t blocks_per_pattern) {
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
  const int32_t row = __ldg(idx + lane);
  T v = zero_of<T>();
  if (row >= 0 && row < V) {
    v = __ldg(table + (static_cast<int64_t>(b) * V + row) * Dv + d);
  }
  out[lane * Dv + d] = v;
}

// One CTA per (pattern b, run of lanes_per_cta lanes): stage pattern b's
// table, then gather the run from shared memory.
template <typename T>
__global__ void __launch_bounds__(kSmemThreads)
gather_rows_smem_kernel(const T* __restrict__ table,
                        const int32_t* __restrict__ idx, T* __restrict__ out,
                        int64_t N, int64_t V, int64_t Dv,
                        int64_t lanes_per_cta, uint32_t ctas_per_pattern) {
  extern __shared__ float4 smem_raw[];          // float4: 16-byte aligned
  T* s = reinterpret_cast<T*>(smem_raw);
  const uint32_t b = blockIdx.x / ctas_per_pattern;
  const int64_t c = blockIdx.x - b * ctas_per_pattern;
  const int64_t table_len = V * Dv;
  const T* tb = table + static_cast<int64_t>(b) * table_len;
  for (int64_t i = threadIdx.x; i < table_len; i += kSmemThreads) {
    s[i] = __ldg(tb + i);
  }
  __syncthreads();
  const int64_t n0 = c * lanes_per_cta;
  const int64_t n1 = (n0 + lanes_per_cta < N) ? n0 + lanes_per_cta : N;
  const int32_t* ib = idx + static_cast<int64_t>(b) * N;
  T* ob = out + static_cast<int64_t>(b) * N * Dv;
  for (int64_t e = n0 * Dv + threadIdx.x; e < n1 * Dv; e += kSmemThreads) {
    const int64_t n = e / Dv;
    const int64_t d = e - n * Dv;
    const int32_t row = __ldg(ib + n);
    ob[e] = (row >= 0 && row < V) ? s[row * Dv + d] : zero_of<T>();
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int gather_rows_f32(const void* table, const void* idx, void* out,
                               int64_t B, int64_t N, int64_t V, int64_t D,
                               void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const bool vec = D % 4 == 0 && aligned16(table) && aligned16(out);
  const int64_t Dv = vec ? D / 4 : D;
  const int64_t bpp = (N * Dv + kThreads - 1) / kThreads;
  if (B * bpp > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(B * bpp));
  if (vec) {
    gather_rows_kernel<float4, false><<<grid, kThreads, 0, s>>>(
        static_cast<const float4*>(table), ix, static_cast<float4*>(out), N, V,
        Dv, static_cast<uint32_t>(bpp));
  } else if (D == 1) {
    gather_rows_kernel<float, true><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(table), ix, static_cast<float*>(out), N, V,
        Dv, static_cast<uint32_t>(bpp));
  } else {
    gather_rows_kernel<float, false><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(table), ix, static_cast<float*>(out), N, V,
        Dv, static_cast<uint32_t>(bpp));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_rows_smem_f32(const void* table, const void* idx,
                                    void* out, int64_t B, int64_t N, int64_t V,
                                    int64_t D, int64_t lanes_per_cta,
                                    void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  const int64_t bytes = V * D * static_cast<int64_t>(sizeof(float));
  if (V <= 0 || bytes > kMaxSmemBytes || lanes_per_cta <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const bool vec = D % 4 == 0 && aligned16(table) && aligned16(out);
  const int64_t Dv = vec ? D / 4 : D;
  const int64_t ctas = (N + lanes_per_cta - 1) / lanes_per_cta;
  if (B * ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(B * ctas));
  cudaError_t err = cudaSuccess;
  if (vec) {
    if (bytes > kDefaultSmemBytes) {
      err = cudaFuncSetAttribute(gather_rows_smem_kernel<float4>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    gather_rows_smem_kernel<float4><<<grid, kSmemThreads, bytes, s>>>(
        static_cast<const float4*>(table), ix, static_cast<float4*>(out), N, V,
        Dv, lanes_per_cta, static_cast<uint32_t>(ctas));
  } else {
    if (bytes > kDefaultSmemBytes) {
      err = cudaFuncSetAttribute(gather_rows_smem_kernel<float>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    gather_rows_smem_kernel<float><<<grid, kSmemThreads, bytes, s>>>(
        static_cast<const float*>(table), ix, static_cast<float*>(out), N, V,
        Dv, lanes_per_cta, static_cast<uint32_t>(ctas));
  }
  return static_cast<int>(cudaGetLastError());
}
