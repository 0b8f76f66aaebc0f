// Batched row gather for Hopper (sm_90a): out[b, n, :] = table[b, idx[b, n], :].
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/gather_rows/kernel.py:
//   * gather_rows_f32      <- gather_rows_dma  (table in HBM, row DMAs driven by
//                                               scalar-prefetched indices)
//   * gather_rows_smem_f32 <- gather_rows_vmem (each pattern's table staged
//                                               whole on chip)
//
// Layouts: table (B, V, D) float32, idx (B, N) int32, out (B, N, D) float32,
// all contiguous, at any 4-byte alignment.  An index outside [0, V) reads as
// 0 (the kernels never read outside the table).  Grids are flat in x.  Each
// kernel has a 32-bit instance, taken when B * N * D and B * V * D are below
// 2^31, and a 64-bit one; a lane's pattern (lane / N) and row (element / D)
// come from magic-number division (FastDiv), never from a hardware divide.
//
// What bounds both: bytes.  Each lane reads its 4-byte index and one D-float
// row and writes one D-float row, so the least time is (index + rows read +
// rows written) / 3.35 TB/s.  With D = 1 (the paper's scalar element, the
// default) a "row" is 4 bytes: the TPU's row-sized DMAs have no place here.
//
// The global kernel.  A lane's table read depends on its index load, so a
// thread that moves one lane at a time keeps 4 bytes in flight in each of two
// serialised round trips; HBM3 at ~0.7 us of loaded latency needs ~20 KB in
// flight per SM (Little's law).  So each thread takes 16 lanes (D = 1): it
// loads their indices as four 16-byte vectors (streaming, __ldcs), issues all
// 16 table reads (__ldg, so small tables stay in L1/L2) before using any, and
// stores the run as four 16-byte vectors (evict-first, __stcs), so neither
// stream pushes the table out of L2.  Neighbouring threads take neighbouring
// vectors, so every warp instruction covers 512 contiguous bytes.  The
// vectors need idx and out at the same address mod 16; the lanes before the
// first aligned vector and after the last are scalar.  Where idx and out are
// out of phase, or D > 1, a thread takes 8 elements (a float4 where D % 4 ==
// 0 and table and out are 16-byte aligned, else a float), again with every
// load issued before any is used.  A gather too small to fill the card that
// way (fewer threads than the card holds at once, 132 x 2048 on an H100 SXM)
// takes one vector or element a thread instead: it is bound by latency, and
// more threads put more SMs on it.
//
// The shared-memory kernel stages one pattern's whole (V, D) table (at most
// 227 KB = 232,448 bytes a block) in shared memory and gathers from there, so
// the scattered reads hit shared memory instead of L2/HBM.  Its CTAs run in
// clusters of 8, one pattern a cluster: after the mbarriers are initialised
// and the cluster has met, each CTA bulk-copies 1/8 of the table's 16-byte
// aligned interior with the TMA, multicast to all 8 CTAs, so one L2 read
// feeds 8 shared memories; the <= 3 floats before and after the interior
// take plain loads (a pattern's table starts unaligned when V * D is odd).
// Each CTA loads its first indices while the copies fly, waits on its
// mbarrier (which expects the whole interior), gathers as the global kernel
// does, and meets the cluster again before it exits.  A table of exactly
// 232,448 bytes leaves no room for the mbarrier: its last floats stay in
// global memory and are read from there.  The wrapper
// (kernels/gather_rows/ops.py) picks the lanes per CTA, and picks this
// regime only where the table fits.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>

namespace {

constexpr int kThreads = 256;              // global kernels
constexpr int kVecs = 4;                   // D = 1: 16-byte vectors a thread
constexpr int kElems = 8;                  // D > 1: elements a thread
constexpr int kSmemThreads = 1024;
constexpr int kSmemVecs = 4;               // per thread per chunk
constexpr int kSmemElems = 4;
constexpr int kCluster = 8;                // CTAs a cluster (portable maximum)
constexpr int64_t kMaxSmemBytes = 232448;  // 227 KB per block (H100)
constexpr uint32_t kBarBytes = 16;         // the mbarrier, padded to 16 bytes
constexpr uint32_t kMaxCopy = 1u << 16;    // bytes a bulk copy

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

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero_of<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename I>
__device__ __forceinline__ bool in_table(int32_t row, I V) {
  return row >= 0 && static_cast<I>(row) < V;
}

// -- the global kernels -------------------------------------------------------

// One lane of a D = 1 gather from global memory.
template <typename I>
__device__ __forceinline__ float global_lane(const float* __restrict__ table,
                                             int32_t row, I lane, I V,
                                             const FastDiv<I>& by_n) {
  return in_table(row, V) ? __ldg(table + by_n.div(lane) * V + row) : 0.f;
}

// D = 1 with idx and out in phase.  The flat lanes [0, total) are a scalar
// head (< 4 lanes, up to the first 16-byte boundary of idx), nv vectors of 4
// lanes and a scalar tail (< 4).  Block k takes vectors [k, k + 1) * 256 *
// V4; thread t vectors k * 256 * V4 + j * 256 + t, j < V4.
template <typename I, int V4>
__global__ void __launch_bounds__(kThreads)
gather_d1_vec_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ idx, float* __restrict__ out,
                     I total, I head, I nv, I V, FastDiv<I> by_n) {
  const I v0 = static_cast<I>(blockIdx.x) * (kThreads * V4) + threadIdx.x;
  const int4* iv = reinterpret_cast<const int4*>(idx + head);
  float4* ov = reinterpret_cast<float4*>(out + head);
  int4 r[V4];
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const I v = v0 + j * kThreads;
    r[j] = v < nv ? __ldcs(iv + v) : make_int4(-1, -1, -1, -1);
  }
  float4 x[V4];
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const I l = head + (v0 + j * kThreads) * 4;
    x[j].x = global_lane(table, r[j].x, l, V, by_n);
    x[j].y = global_lane(table, r[j].y, l + 1, V, by_n);
    x[j].z = global_lane(table, r[j].z, l + 2, V, by_n);
    x[j].w = global_lane(table, r[j].w, l + 3, V, by_n);
  }
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const I v = v0 + j * kThreads;
    if (v < nv) __stcs(ov + v, x[j]);
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) {      // head, then tail
    const I l = threadIdx.x < 4 ? static_cast<I>(threadIdx.x)
                                : head + nv * 4 + (threadIdx.x - 4);
    if (threadIdx.x < 4 ? l < head : l < total) {
      __stcs(out + l, global_lane(table, __ldcs(idx + l), l, V, by_n));
    }
  }
}

// Any D and alignment: T is float4 (D % 4 == 0, table and out 16-byte
// aligned) or float; Dv = D in units of T.  Block k takes the flat elements
// [k, k + 1) * 256 * E of the (B * N, Dv) output; thread t elements
// k * 256 * E + j * 256 + t, j < E.
template <typename T, typename I, int E>
__global__ void __launch_bounds__(kThreads)
gather_elems_kernel(const T* __restrict__ table,
                    const int32_t* __restrict__ idx, T* __restrict__ out,
                    I total, I V, I Dv, FastDiv<I> by_dv, FastDiv<I> by_n) {
  const I e0 = static_cast<I>(blockIdx.x) * (kThreads * E) + threadIdx.x;
  I lane[E];
  int32_t row[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const I e = e0 + j * kThreads;
    lane[j] = by_dv.div(e);
    row[j] = -1;
    if (e < total) {                 // an index read once streams past L1
      row[j] = Dv == 1 ? __ldcs(idx + lane[j]) : __ldg(idx + lane[j]);
    }
  }
  T x[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const I e = e0 + j * kThreads;
    const I d = e - lane[j] * Dv;
    x[j] = in_table(row[j], V)
               ? __ldg(table + (by_n.div(lane[j]) * V + row[j]) * Dv + d)
               : zero_of<T>();
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const I e = e0 + j * kThreads;
    if (e < total) __stcs(out + e, x[j]);
  }
}

// -- the shared-memory kernel -------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of parity ``parity`` to complete.  A phase that never
// completes (a copy that faulted, a miscounted barrier) traps after 4 s, so
// the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives and waits.  The arrive
// is relaxed: the one write a peer must see first, the mbarrier's init, is
// already released to the cluster by fence.mbarrier_init, and the wait
// acquires.  The release form also orders every earlier memory operation,
// which costs more on the H100 than the rest of a small table's staging.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A 1-D bulk copy global -> shared, to the same offset in every CTA of
// ``mask``, each completing ``bytes`` on its own mbarrier at ``bar``.
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
}

// A pattern's table as staged: its first ``staged`` floats at ``s`` (shared
// memory), the rest read from global memory at ``g``.
template <typename T, typename I>
struct Staged {
  const T* s;
  const T* g;
  I staged;                        // in units of T
  __device__ __forceinline__ T at(I i) const {
    return i < staged ? s[i] : __ldg(g + i);
  }
};

// One CTA per (pattern b, run of lanes_per_cta lanes); ctas_per_pattern is
// a multiple of the cluster size, so a cluster serves one pattern.
// kVecD1: D = 1 with idx and out in phase (16-byte index loads and stores);
// otherwise elements of type T (float4 when D % 4 == 0 and the table and out
// are 16-byte aligned, which puts every pattern's table in phase 0).
template <typename T, bool kVecD1, typename I>
__global__ void __launch_bounds__(kSmemThreads)
gather_rows_smem_kernel(const float* __restrict__ table,
                        const int32_t* __restrict__ idx,
                        float* __restrict__ out, I N, I V, I D,
                        I lanes_per_cta, uint32_t ctas_per_pattern,
                        uint32_t smem_bytes, FastDiv<I> by_dv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t tid = threadIdx.x;
  const uint32_t b = blockIdx.x / ctas_per_pattern;
  const I c = blockIdx.x - b * ctas_per_pattern;
  const I vd = V * D;
  const float* tb = table + static_cast<I>(b) * vd;

  // Where the table lands: at the same address mod 16 as in global memory,
  // so that its 16-byte aligned interior can be bulk-copied.
  const uint32_t phase = static_cast<uint32_t>(
      reinterpret_cast<uintptr_t>(tb) & 15);
  float* s = reinterpret_cast<float*>(smem + kBarBytes + phase);
  const uint32_t cap = (smem_bytes - kBarBytes - phase) / 4;
  const uint32_t staged = vd < cap ? static_cast<uint32_t>(vd) : cap;
  const uint32_t head = min(staged, ((16 - phase) & 15) / 4);
  const uint32_t body = (staged - head) / 4 * 16;      // bytes, bulk-copied
  const uint32_t tail0 = head + body / 4;
  const uint32_t bar = smem_u32(smem);

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();                  // every CTA's mbarrier is ready
  if (tid == 0) {
    mbar_expect_tx(bar, body);     // the whole interior, from all 8 CTAs
    const uint32_t share = (body / 16 + kCluster - 1) / kCluster * 16;
    uint32_t lo = cluster_ctarank() * share;
    const uint32_t hi = min(body, lo + share);
    const char* src = reinterpret_cast<const char*>(tb + head);
    const uint32_t dst = smem_u32(s + head);
    for (; lo < hi; lo += kMaxCopy) {
      bulk_copy_multicast(dst + lo, src + lo, min(kMaxCopy, hi - lo), bar,
                          static_cast<uint16_t>((1u << kCluster) - 1));
    }
  }
  if (tid < head) {
    s[tid] = __ldg(tb + tid);
  } else if (tid >= 4 && tid - 4 < staged - tail0) {
    s[tail0 + tid - 4] = __ldg(tb + tail0 + tid - 4);
  }

  const I n0 = c * lanes_per_cta;
  const I n1 = n0 + lanes_per_cta < N ? n0 + lanes_per_cta : N;
  const I base = static_cast<I>(b) * N;        // the pattern's first lane
  if constexpr (kVecD1) {
    // Lanes [f0, f1) of the flat (B * N) idx and out: a scalar head up to
    // idx's first 16-byte boundary, nv vectors, a scalar tail.
    const I f0 = base + n0;
    const I f1 = base + (n1 > n0 ? n1 : n0);
    const uint32_t mis = static_cast<uint32_t>(
        (reinterpret_cast<uintptr_t>(idx + f0) & 15) / 4);
    I h = (4 - mis) & 3;
    h = h < f1 - f0 ? h : f1 - f0;
    const I nv = (f1 - f0 - h) / 4;
    const int4* iv = reinterpret_cast<const int4*>(idx + f0 + h);
    float4* ov = reinterpret_cast<float4*>(out + f0 + h);
    const Staged<float, I> tab{s, tb, staged};
    constexpr I kChunk = kSmemThreads * kSmemVecs;
    int4 r[kSmemVecs];
    auto load = [&](I cv) {
#pragma unroll
      for (int j = 0; j < kSmemVecs; ++j) {
        const I v = cv + j * kSmemThreads + tid;
        r[j] = v < nv ? __ldcs(iv + v) : make_int4(-1, -1, -1, -1);
      }
    };
    load(0);                       // in flight while the table arrives
    // this thread's head or tail lane, if it has one
    const bool has_edge =
        tid < h || (tid >= 4 && tid - 4 < f1 - f0 - h - 4 * nv);
    const I edge_lane = tid < h ? f0 + tid : f0 + h + 4 * nv + (tid - 4);
    const int32_t edge = has_edge ? __ldcs(idx + edge_lane) : -1;
    __syncthreads();               // head and tail floats of the table
    mbar_wait(bar, 0);
    for (I cv = 0; cv < nv; cv += kChunk) {
      float4 x[kSmemVecs];
#pragma unroll
      for (int j = 0; j < kSmemVecs; ++j) {
        x[j].x = in_table(r[j].x, V) ? tab.at(r[j].x) : 0.f;
        x[j].y = in_table(r[j].y, V) ? tab.at(r[j].y) : 0.f;
        x[j].z = in_table(r[j].z, V) ? tab.at(r[j].z) : 0.f;
        x[j].w = in_table(r[j].w, V) ? tab.at(r[j].w) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kSmemVecs; ++j) {
        const I v = cv + j * kSmemThreads + tid;
        if (v < nv) __stcs(ov + v, x[j]);
      }
      if (cv + kChunk < nv) load(cv + kChunk);
    }
    if (has_edge) {
      __stcs(out + edge_lane, in_table(edge, V) ? tab.at(edge) : 0.f);
    }
  } else {
    // Elements [n0 * Dv, n1 * Dv) of pattern b's (N, Dv) output.
    constexpr I kUnit = sizeof(T) / sizeof(float);
    const I dv = D / kUnit;
    const I e_lo = n0 * dv;
    const I e_hi = (n1 > n0 ? n1 : n0) * dv;
    const int32_t* ib = idx + base;
    T* ob = reinterpret_cast<T*>(out) + base * dv;
    const Staged<T, I> tab{reinterpret_cast<const T*>(s),
                           reinterpret_cast<const T*>(tb), staged / kUnit};
    constexpr I kChunk = kSmemThreads * kSmemElems;
    I lane[kSmemElems];
    int32_t row[kSmemElems];
    auto load = [&](I ce) {
#pragma unroll
      for (int j = 0; j < kSmemElems; ++j) {
        const I e = ce + j * kSmemThreads + tid;
        lane[j] = by_dv.div(e);
        row[j] = -1;
        if (e < e_hi) {
          row[j] = dv == 1 ? __ldcs(ib + lane[j]) : __ldg(ib + lane[j]);
        }
      }
    };
    load(e_lo);
    __syncthreads();
    mbar_wait(bar, 0);
    for (I ce = e_lo; ce < e_hi; ce += kChunk) {
      T x[kSmemElems];
#pragma unroll
      for (int j = 0; j < kSmemElems; ++j) {
        const I e = ce + j * kSmemThreads + tid;
        x[j] = in_table(row[j], V)
                   ? tab.at(static_cast<I>(row[j]) * dv + (e - lane[j] * dv))
                   : zero_of<T>();
      }
#pragma unroll
      for (int j = 0; j < kSmemElems; ++j) {
        const I e = ce + j * kSmemThreads + tid;
        if (e < e_hi) __stcs(ob + e, x[j]);
      }
      if (ce + kChunk < e_hi) load(ce + kChunk);
    }
  }
  cluster_sync();                  // no CTA leaves while its cluster copies
}

// -- host side ------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Threads the current card holds at once (SMs x threads an SM), asked of
// the runtime: below this many threads at the deep setting, a global gather
// takes one vector (or element) a thread, so that a small gather spreads its
// lanes over every SM instead of a few.
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

bool in_phase(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) ^ reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

template <typename I, int V4>
void launch_d1_vec(const float* table, const int32_t* idx, float* out,
                   I total, I head, I nv, I V, FastDiv<I> by_n, int64_t blocks,
                   cudaStream_t s) {
  gather_d1_vec_kernel<I, V4><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(table, idx, out, total, head, nv, V,
                                     by_n);
}

template <typename T, typename I, int E>
void launch_elems(const void* table, const int32_t* idx, void* out, I elems,
                  I V, I dv, I N, cudaStream_t s) {
  const int64_t blocks = (static_cast<int64_t>(elems) + kThreads * E - 1) /
                         (kThreads * E);
  gather_elems_kernel<T, I, E><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(
      static_cast<const T*>(table), idx, static_cast<T*>(out), elems, V, dv,
      make_div(dv), make_div(N));
}

template <typename I>
int launch_global(const void* table, const int32_t* idx, void* out, int64_t B,
                  int64_t N, int64_t V, int64_t D, cudaStream_t s) {
  const I total = static_cast<I>(B * N);
  int64_t full = 0;
  const cudaError_t err = card_threads(&full);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (D == 1 && in_phase(idx, out)) {
    const I mis = static_cast<I>((reinterpret_cast<uintptr_t>(idx) & 15) / 4);
    const I head = (4 - mis) % 4 < total ? (4 - mis) % 4 : total;
    const I nv = (total - head) / 4;
    const bool deep = static_cast<int64_t>(nv) >= full * kVecs;
    const int64_t per_block = kThreads * (deep ? kVecs : 1);
    const int64_t blocks = (static_cast<int64_t>(nv) + per_block - 1) /
                           per_block;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    const auto launch = deep ? &launch_d1_vec<I, kVecs> : &launch_d1_vec<I, 1>;
    launch(static_cast<const float*>(table), idx, static_cast<float*>(out),
           total, head, nv, static_cast<I>(V), make_div(static_cast<I>(N)),
           blocks > 0 ? blocks : 1, s);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = D % 4 == 0 && aligned16(table) && aligned16(out);
  const I dv = static_cast<I>(vec ? D / 4 : D);
  const I elems = total * dv;
  if ((static_cast<int64_t>(elems) + kThreads - 1) / kThreads > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const bool deep = static_cast<int64_t>(elems) >= full * kElems;
  const I v = static_cast<I>(V), n = static_cast<I>(N);
  if (vec) {
    (deep ? &launch_elems<float4, I, kElems> : &launch_elems<float4, I, 1>)(
        table, idx, out, elems, v, dv, n, s);
  } else {
    (deep ? &launch_elems<float, I, kElems> : &launch_elems<float, I, 1>)(
        table, idx, out, elems, v, dv, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
using SmemKernel = void (*)(const float*, const int32_t*, float*, I, I, I, I,
                            uint32_t, uint32_t, FastDiv<I>);

// The instance a launch takes: D = 1 with idx and out in phase, then float4
// rows, then floats.
template <typename I>
SmemKernel<I> smem_kernel(bool vec_d1, bool vec4) {
  if (vec_d1) return gather_rows_smem_kernel<float, true, I>;
  if (vec4) return gather_rows_smem_kernel<float4, false, I>;
  return gather_rows_smem_kernel<float, false, I>;
}

uint32_t smem_bytes_for(int64_t table_bytes) {
  const int64_t want = kBarBytes + 16 + (table_bytes + 15) / 16 * 16;
  return static_cast<uint32_t>(want < kMaxSmemBytes ? want : kMaxSmemBytes);
}

cudaLaunchConfig_t smem_config(unsigned grid, uint32_t bytes, cudaStream_t s,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kSmemThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once per (device, instance): allow the full 227 KB of dynamic shared
// memory.  Then the clusters that fit at once for ``bytes``, asked of the
// runtime once per (device, instance, bytes) and remembered.
cudaError_t smem_clusters(const void* kernel, uint32_t bytes, int* clusters) {
  static std::mutex mu;
  static std::set<std::pair<int, const void*>> ready;
  static std::map<std::tuple<int, const void*, uint32_t>, int> fit;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, kernel, bytes);
  const auto it = fit.find(key);
  if (it != fit.end()) {
    *clusters = it->second;
    return cudaSuccess;
  }
  if (!ready.count({dev, kernel})) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmemBytes));
    if (err != cudaSuccess) return err;
    ready.insert({dev, kernel});
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = smem_config(kCluster, bytes, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  fit[key] = *clusters;
  return cudaSuccess;
}

template <typename I>
int launch_smem(const void* table, const int32_t* idx, void* out, int64_t B,
                int64_t N, int64_t V, int64_t D, int64_t lanes_per_cta,
                cudaStream_t s) {
  const bool vec_d1 = D == 1 && in_phase(idx, out);
  const bool vec4 = !vec_d1 && D % 4 == 0 && aligned16(table) &&
                    aligned16(out);
  const SmemKernel<I> kernel = smem_kernel<I>(vec_d1, vec4);
  const uint32_t bytes = smem_bytes_for(V * D * 4);
  int clusters = 0;
  cudaError_t err = smem_clusters(reinterpret_cast<const void*>(kernel), bytes,
                                  &clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int64_t runs = (N + lanes_per_cta - 1) / lanes_per_cta;
  const int64_t ctas = (runs + kCluster - 1) / kCluster * kCluster;
  if (B * ctas > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const I dv = static_cast<I>(vec4 ? D / 4 : D);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      smem_config(static_cast<unsigned>(B * ctas), bytes, s, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(table), idx,
                           static_cast<float*>(out), static_cast<I>(N),
                           static_cast<I>(V), static_cast<I>(D),
                           static_cast<I>(lanes_per_cta),
                           static_cast<uint32_t>(ctas), bytes, make_div(dv));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The 32-bit instances: every flat lane, element and table offset < 2^31.
bool fits32(int64_t B, int64_t N, int64_t V, int64_t D) {
  const int64_t lim = int64_t{1} << 31;
  return N <= lim / B / D && V <= lim / B / D && B * N * D < lim &&
         B * V * D < lim;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int gather_rows_f32(const void* table, const void* idx, void* out,
                               int64_t B, int64_t N, int64_t V, int64_t D,
                               void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  if (V < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  return fits32(B, N, V, D)
             ? launch_global<uint32_t>(table, ix, out, B, N, V, D, s)
             : launch_global<uint64_t>(table, ix, out, B, N, V, D, s);
}

// Returns the cudaError_t of the launch (0 on success); refuses a table over
// 227 KB, and a launch for which no cluster of 8 fits on the card.
extern "C" int gather_rows_smem_f32(const void* table, const void* idx,
                                    void* out, int64_t B, int64_t N, int64_t V,
                                    int64_t D, int64_t lanes_per_cta,
                                    void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  if (V <= 0 || V * D * 4 > kMaxSmemBytes || lanes_per_cta <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  return fits32(B, N, V, D)
             ? launch_smem<uint32_t>(table, ix, out, B, N, V, D,
                                     lanes_per_cta, s)
             : launch_smem<uint64_t>(table, ix, out, B, N, V, D,
                                     lanes_per_cta, s);
}

// Writes to *clusters how many clusters of 8 CTAs of the shared-memory
// kernel fit on the current card at once for a (V, D) table (16-byte
// aligned operands); returns the cudaError_t of the query.
extern "C" int gather_rows_smem_clusters(int64_t V, int64_t D,
                                         void* clusters) {
  if (V <= 0 || D <= 0 || V * D * 4 > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = smem_kernel<uint32_t>(D == 1, D % 4 == 0);
  return static_cast<int>(smem_clusters(reinterpret_cast<const void*>(kernel),
                                        smem_bytes_for(V * D * 4),
                                        static_cast<int*>(clusters)));
}
