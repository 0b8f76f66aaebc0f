// Helpers shared by the row-gather and row-scatter kernels (gather_rows.cu,
// scatter_rows.cu): magic-number division (paged_decode.cu's page lookup
// too), the range test of a lane's row, and the host's alignment and card
// queries.  Each source that includes this file compiles its own copy
// (everything here is internal to it).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Division by a fixed d through one high multiply and a shift (the
// round-up method of Granlund and Montgomery, as CUTLASS's FastDivmod):
// exact for every dividend below 2^31 (32-bit) or 2^63 (64-bit).
template <typename I>
struct FastDiv;

template <>
struct FastDiv<uint32_t> {
  uint32_t d, m, s;
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return d == 1 ? n : __umulhi(n, m) >> s;
  }
};

template <>
struct FastDiv<uint64_t> {
  uint64_t d, m;
  uint32_t s;
  __device__ __forceinline__ uint64_t div(uint64_t n) const {
    return d == 1 ? n : __umul64hi(n, m) >> s;
  }
};

int ceil_log2(uint64_t x) {
  int l = 0;
  while (l < 64 && (uint64_t{1} << l) < x) ++l;
  return l;
}

FastDiv<uint32_t> make_div32(uint32_t d) {
  FastDiv<uint32_t> f{d, 0, 0};
  if (d > 1) {
    const int p = 31 + ceil_log2(d);
    f.m = static_cast<uint32_t>(((uint64_t{1} << p) + d - 1) / d);
    f.s = static_cast<uint32_t>(p - 32);
  }
  return f;
}

FastDiv<uint64_t> make_div64(uint64_t d) {
  FastDiv<uint64_t> f{d, 0, 0};
  if (d > 1) {
    const int p = 63 + ceil_log2(d);
    using u128 = unsigned __int128;
    f.m = static_cast<uint64_t>(((u128{1} << p) + d - 1) / d);
    f.s = static_cast<uint32_t>(p - 64);
  }
  return f;
}

inline FastDiv<uint32_t> make_div(uint32_t d) { return make_div32(d); }
inline FastDiv<uint64_t> make_div(uint64_t d) { return make_div64(d); }

template <typename I>
__device__ __forceinline__ bool in_table(int32_t row, I V) {
  return row >= 0 && static_cast<I>(row) < V;
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Threads the current card holds at once (SMs x threads an SM), asked of
// the runtime: the rule a global gather or store takes when its caller
// leaves `vecs` at 0 (below this many threads at the deep setting, one
// vector or element a thread, so that a small one spreads its lanes over
// every SM instead of a few).  The wrappers choose `vecs` themselves from
// the same two numbers (kernels/autotune.py).
cudaError_t card_threads(int64_t* threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&per_sm,
                                 cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  }
  *threads = int64_t{sms} * per_sm;
  return err;
}

// Whether a launch of `work` vectors or elements takes the deep instance
// (`per` of them a thread): as `vecs` says, or for vecs = 0 the rule of the
// note at card_threads, from the card's threads.
cudaError_t deep_for(int64_t vecs, int64_t work, int per, bool* deep) {
  if (vecs != 0) {
    *deep = vecs > 1;
    return cudaSuccess;
  }
  int64_t full = 0;
  const cudaError_t err = card_threads(&full);
  *deep = work >= full * per;
  return err;
}

bool in_phase(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) ^ reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// The 32-bit instances: every flat lane, element and table offset < 2^31.
bool fits32(int64_t B, int64_t N, int64_t V, int64_t D) {
  const int64_t lim = int64_t{1} << 31;
  return N <= lim / B / D && V <= lim / B / D && B * N * D < lim &&
         B * V * D < lim;
}

}  // namespace
