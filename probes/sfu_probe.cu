// What rate the H100's special function unit gives ex2.approx.ftz.f32
// (MUFU.EX2), the instruction the selective scan spends its exponentials on.
// Each thread runs K independent chains for ITERS steps:
//   way 0: x = ex2(x * c)                    (FMUL, MUFU.EX2)
//   way 1: h = h * ex2(d * a) + d            (the scan's step: FMUL, MUFU.EX2,
//                                             FFMA; d changes every step)
// and writes its sum, so nothing is dead.  Built and timed by sfu_probe.py.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int K, int WAY>
__global__ void __launch_bounds__(256) probe(float* out, int iters, float c) {
  float x[K], a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x[k] = 0.25f + 0.01f * (threadIdx.x + k);
    a[k] = -0.5f - 0.03f * k;
  }
  float d = c;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (WAY == 0) {
        x[k] = ex2(x[k] * c);
      } else {
        x[k] = fmaf(x[k], ex2(d * a[k]), d);
      }
    }
    d += 1e-7f;
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) s += x[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int K>
int run(float* out, int64_t blocks, int iters, int64_t way, cudaStream_t s) {
  if (way == 0) {
    probe<K, 0><<<static_cast<unsigned>(blocks), 256, 0, s>>>(out, iters, 0.999f);
  } else {
    probe<K, 1><<<static_cast<unsigned>(blocks), 256, 0, s>>>(out, iters, 0.999f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: blocks x 256 floats.  Returns the cudaError_t of the launch.
extern "C" int sfu_probe(void* out, int64_t blocks, int64_t iters, int64_t k,
                         int64_t way, void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int it = static_cast<int>(iters);
  switch (k) {
    case 1: return run<1>(o, blocks, it, way, s);
    case 4: return run<4>(o, blocks, it, way, s);
    case 8: return run<8>(o, blocks, it, way, s);
    case 16: return run<16>(o, blocks, it, way, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
