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

// A 16-byte vector of lanes of element E (the gathers' and the store's D = 1
// paths): 4 floats, or 8 16-bit words.  A gather or a store moves bits, so
// one instance on uint16_t serves bfloat16 and float16 alike.  Its lanes'
// indices are kLanes / 4 int4 loads.
template <typename E>
struct Vec16;

template <>
struct Vec16<float> {
  using T = float4;
  static constexpr int kLanes = 4;
  __device__ __forceinline__ static float4 pack(const float (&e)[4]) {
    return make_float4(e[0], e[1], e[2], e[3]);
  }
  __device__ __forceinline__ static float lane(const float4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
};

template <>
struct Vec16<uint16_t> {
  using T = uint4;
  static constexpr int kLanes = 8;
  __device__ __forceinline__ static uint32_t two(uint16_t lo, uint16_t hi) {
    return uint32_t{lo} | (uint32_t{hi} << 16);
  }
  __device__ __forceinline__ static uint4 pack(const uint16_t (&e)[8]) {
    return make_uint4(two(e[0], e[1]), two(e[2], e[3]), two(e[4], e[5]),
                      two(e[6], e[7]));
  }
  __device__ __forceinline__ static uint16_t lane(const uint4& v, int k) {
    const uint32_t w = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
    return static_cast<uint16_t>(w >> (16 * (k & 1)));
  }
};

// Lane m of an int4 (m constant after unrolling).
__device__ __forceinline__ int32_t int4_lane(const int4& r, int m) {
  return m == 0 ? r.x : m == 1 ? r.y : m == 2 ? r.z : r.w;
}

// Where a D = 1 run of E lanes starts its 16-byte vectors: the lanes before
// out's (or vals') first 16-byte boundary, written to *head; true when idx
// is 16-byte aligned at that lane too (idx and out "in phase"), so every
// vector of kLanes lanes after the head reads whole int4s of indices.
template <typename E>
bool d1_phase(const void* idx, const void* out, int64_t* head) {
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  *head = static_cast<int64_t>(((16 - (o & 15)) & 15) / sizeof(E));
  return o % sizeof(E) == 0 &&
         aligned16(static_cast<const int32_t*>(idx) + *head);
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
