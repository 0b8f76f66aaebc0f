// Batched row scatter for Hopper (sm_90a), in place into dst (B, V, D).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/scatter_rows/kernel.py:
//   * scatter_store_rows_f32, _b16 <- scatter_store_rows_kernel (last-write-
//     wins store through a one-hot MXU contraction)
//   * scatter_store_rows_cov_f32, _b16 <- scatter_store_rows_kernel(
//     with_cov=True) (the same store, plus the (B, V) int32 coverage map of
//     the rows it wrote, from the same launch: the lane-sharded store
//     combine's ballot)
//   * scatter_add_rows_f32, _bf16, _f16 <- scatter_add_rows_kernel (sum-
//     scatter through a one-hot MXU contraction)
//
// Layouts: dst (B, V, D), idx (B, N) int32, keep (B, N) bool (one byte), vals
// (B, N, D), all contiguous; the store takes them at any alignment of their
// type.  dst and vals are float32 for the _f32 entries; the stores' _b16
// entries take any 2-byte element (bfloat16, float16), since a store moves
// bits; the add has one instance a type, bfloat16 and float16, each adding
// in its own type (no round trip through float32).  Lanes whose index lies
// outside [0, V) (the planner's INT32_MAX, a negative value) are dropped.
// Grids are flat in x.
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
// where() and a kernel.  Like the gathers (gather_rows.cu), it has a 32-bit
// instance, taken when B * N * D and B * V * D are below 2^31, and a 64-bit
// one, and finds a lane's pattern by magic-number division (common.cuh).
//
// What held the store back: one element a thread, with a dependent chain of
// three round trips (load keep, branch; load idx, branch; load vals, store),
// so a thread had ~9 bytes in flight where HBM3 needs ~20 KB in flight per
// SM.  So, for D = 1 with keep, idx and vals in phase (where a lane's byte
// of keep is 4-byte aligned, its idx and vals words are 16-byte aligned),
// the store takes the global gather's design (gather_rows.cu): each thread
// takes 16 lanes as four vectors of 4, the warp's 32 threads on
// neighbouring vectors, and loads their keep as four 4-byte words, their idx
// as four int4 and their vals as four float4, all issued before any is used,
// so every warp instruction reads 128 contiguous bytes of keep and 512 of
// idx or vals.  Then it stores each kept, in-range lane at its row: a vector whose
// 4 lanes are kept, of one pattern, on consecutive rows, the first 16-byte
// aligned in dst, goes as one float4 store (the CLI's contiguous pattern is
// all such vectors); any other lane goes alone.  At 2 bytes a vector is 8
// lanes (Vec16, common.cuh): two 4-byte words of keep, two int4 of idx and
// one 16-byte vector of vals, stored as one 16-byte vector where its 8 lanes
// are kept on consecutive rows.  A vector that straddles two
// patterns finds each lane's pattern; the < 4 lanes before keep's first
// 4-byte boundary and after the last whole vector are stored lane by lane
// by block 0.  A store too small to fill the card that way (fewer vectors
// than 4 x the threads the card holds, 132 x 2048 on an H100 SXM) takes one
// vector a thread: it is bound by latency, and more threads put more SMs on
// it.  Everything else (D > 1, operands out of phase) takes 8 elements a
// thread, a 16-byte vector where D is a multiple of its lanes and dst and
// vals are 16-byte aligned, else one element, again with every load issued
// before any store.  Which of
// the two instances runs is the wrapper's choice (`vecs`,
// kernels/autotune.py); 0 leaves it to the rule above.  (A first
// version gave each thread 16 consecutive lanes, keep as one 16-byte load:
// each warp instruction then read 16 bytes of every 64, and it reached 76%
// of the byte bound against this layout's 90% on an NVIDIA H100 80GB HBM3
// at 700 W; PERF.md.)
//
// Add.  One atomicAdd per element into the zeroed dst, in the element's own
// type (float, or the native __nv_bfloat16 and __half atomics of sm_90,
// which round each sum to 16 bits), which equals the reference's
// `dst + sum` up to the order of the additions (atomics reorder them from
// run to run).  Offsets are 64-bit.  A lane whose payload is +0.0 or -0.0
// (at 16 bits: its magnitude bits are 0) is skipped before its index is
// read: x + (-0.0) = x, and
// x + (+0.0) = x unless x is -0.0, which a zeroed dst never holds (no sum
// that starts at +0.0 is -0.0), so the result is unchanged.  The planner's
// padding lanes and scratch patterns all carry +0.0 onto one scratch row
// (plan._host_members), and their atomics used to serialise there: 2^27
// of them took 237.7 ms in a batch-split CLI add on an NVIDIA H100 80GB
// HBM3 at 700 W, against 0.81 ms unplaced (PERF.md).
//
// Coverage.  The store with coverage also writes cov[b, row] = 1 (cov is
// (B, V) int32, zeroed by the caller) for each lane it stores, in the same
// pass and on the same lane test, so cov marks exactly the rows the store
// wrote.  A row has at most one writer, so no atomics: a vector row store
// marks its 4 (8) rows with one (two) int4 where that is 16-byte aligned in
// cov, else with one int a row; the element kernel marks a lane's row with
// its first element.
// Both store entry points are instances of one template (kCov), so the
// store without coverage compiles to the code it had before.
//
// What bounds them: bytes, (index + keep + rows read + rows written) /
// 3.35 TB/s, and for the coverage 4 bytes a written row more.  Add mode with
// heavy duplication is bound instead by the atomic throughput on the few hot
// addresses: LULESH-S3 (delta 0) sends every lane of the pattern into 16
// rows, and those atomics serialise in L2, at 16 bits as at 32.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;          // D = 1 in phase: 16-byte vectors a thread
constexpr int kElems = 8;         // otherwise: elements a thread (deep)

// D = 1 with keep, idx and vals in phase, elements E (float, or a 16-bit
// word); L = Vec16<E>::kLanes lanes a 16-byte vector, Q = L / 4.  The flat
// lanes [0, total) are a head (< L lanes, up to vals' first 16-byte
// boundary), nv vectors of L lanes and a tail (< L).  Block k takes vectors
// [k, k + 1) * 256 * V4; thread t vectors k * 256 * V4 + j * 256 + t, j <
// V4, so each warp instruction reads 128 contiguous bytes of keep and 512
// of idx and vals (at 2 bytes, every other 16 bytes of keep and idx, whose
// Q loads a vector cover them all).
template <typename E, typename I, int V4, bool kCov>
__global__ void __launch_bounds__(kThreads)
store_d1_vec_kernel(E* __restrict__ dst, const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ keep,
                    const E* __restrict__ vals, int32_t* __restrict__ cov,
                    I total, I head, I nv, I V, FastDiv<I> by_n) {
  using Vec = Vec16<E>;
  constexpr int L = Vec::kLanes, Q = L / 4;
  const I v0 = static_cast<I>(blockIdx.x) * (kThreads * V4) + threadIdx.x;
  const unsigned int* kv =
      reinterpret_cast<const unsigned int*>(keep + head);
  const int4* iv = reinterpret_cast<const int4*>(idx + head);
  const typename Vec::T* xv =
      reinterpret_cast<const typename Vec::T*>(vals + head);
  uint32_t kw[V4][Q];              // keep bytes of a vector's lanes
  int4 r[V4][Q];
  typename Vec::T x[V4];
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const I v = v0 + j * kThreads;
#pragma unroll
    for (int q = 0; q < Q; ++q) kw[j][q] = v < nv ? __ldcs(kv + v * Q + q) : 0u;
  }
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const I v = v0 + j * kThreads;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      r[j][q] = v < nv ? __ldcs(iv + v * Q + q) : make_int4(-1, -1, -1, -1);
    }
  }
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const I v = v0 + j * kThreads;
    if (v < nv) x[j] = __ldcs(xv + v);
  }
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    bool any = false;
#pragma unroll
    for (int q = 0; q < Q; ++q) any |= kw[j][q] != 0;
    if (!any) continue;            // no lane kept (or past the last vector)
    const I l = head + (v0 + j * kThreads) * L;
    const I b = by_n.div(l);
    const bool one = b == by_n.div(l + (L - 1));   // all lanes in pattern b
    E* const rows = dst + b * V;
    int32_t row[L];
    bool k[L];
#pragma unroll
    for (int m = 0; m < L; ++m) {
      row[m] = int4_lane(r[j][m / 4], m % 4);
      k[m] = ((kw[j][m / 4] >> (8 * (m % 4))) & 0xff) != 0;
    }
    const int32_t q0 = row[0];
    bool whole = one && in_table(q0, V) && in_table(row[L - 1], V);
#pragma unroll
    for (int m = 0; m < L; ++m) {
      whole = whole && k[m] && int64_t{row[m]} - q0 == m;
    }
    if (whole && aligned16(rows + q0)) {
      __stcs(reinterpret_cast<typename Vec::T*>(rows + q0), x[j]);
      if (kCov) {
        int32_t* const c = cov + b * V + q0;
        if (aligned16(c)) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            reinterpret_cast<int4*>(c)[q] = make_int4(1, 1, 1, 1);
          }
        } else {
#pragma unroll
          for (int m = 0; m < L; ++m) c[m] = 1;
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < L; ++m) {
        if (k[m] && in_table(row[m], V)) {
          const I base = (one ? b : by_n.div(l + m)) * V;
          dst[base + row[m]] = Vec::lane(x[j], m);
          if (kCov) cov[base + row[m]] = 1;
        }
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 2 * L) {  // head, then tail
    const I l = threadIdx.x < L ? static_cast<I>(threadIdx.x)
                                : head + nv * L + (threadIdx.x - L);
    if (threadIdx.x < L ? l < head : l < total) {
      const int32_t row = idx[l];
      if (keep[l] && in_table(row, V)) {
        const I base = by_n.div(l) * V;
        dst[base + row] = vals[l];
        if (kCov) cov[base + row] = 1;
      }
    }
  }
}

// Any D and alignment: T is a 16-byte vector (float4 or uint4, where D is a
// multiple of its lanes and dst and vals are 16-byte aligned) or one element
// (float or uint16_t); Dv = D in units of T.  Block k takes the flat elements
// [k, k + 1) * 256 * E of the (B * N, Dv) vals; thread t elements
// k * 256 * E + j * 256 + t, j < E.
template <typename T, typename I, int E, bool kCov>
__global__ void __launch_bounds__(kThreads)
store_elems_kernel(T* __restrict__ dst, const int32_t* __restrict__ idx,
                   const uint8_t* __restrict__ keep,
                   const T* __restrict__ vals, int32_t* __restrict__ cov,
                   I total, I V, I Dv, FastDiv<I> by_dv, FastDiv<I> by_n) {
  const I e0 = static_cast<I>(blockIdx.x) * (kThreads * E) + threadIdx.x;
  I lane[E];
  int32_t row[E];
  bool kept[E];
  T x[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const I e = e0 + j * kThreads;
    lane[j] = by_dv.div(e);
    row[j] = -1;
    kept[j] = false;
    if (e < total) {               // a lane read once streams past L1
      kept[j] = (Dv == 1 ? __ldcs(keep + lane[j]) : __ldg(keep + lane[j]));
      row[j] = Dv == 1 ? __ldcs(idx + lane[j]) : __ldg(idx + lane[j]);
      x[j] = __ldcs(vals + e);
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const I e = e0 + j * kThreads;
    if (kept[j] && in_table(row[j], V)) {
      const I r = by_n.div(lane[j]) * V + row[j];
      const I d = e - lane[j] * Dv;
      dst[r * Dv + d] = x[j];
      if (kCov && d == 0) cov[r] = 1;
    }
  }
}

// A payload of the add and whether it is +-0.0 (adds nothing to a zeroed
// dst, see the note): floats compare; a 16-bit value is read as its bits.
__device__ __forceinline__ float add_load(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 add_load(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ __half add_load(const __half* p) {
  return __ushort_as_half(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ bool add_nothing(float x) { return x == 0.f; }
__device__ __forceinline__ bool add_nothing(__nv_bfloat16 x) {
  return (__bfloat16_as_ushort(x) & 0x7fff) == 0;
}
__device__ __forceinline__ bool add_nothing(__half x) {
  return (__half_as_ushort(x) & 0x7fff) == 0;
}

template <typename T, bool kUnitD>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(T* __restrict__ dst,
                        const int32_t* __restrict__ idx,
                        const T* __restrict__ vals, int64_t N, int64_t V,
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
  const T x = add_load(vals + lane * D + d);
  if (add_nothing(x)) return;      // +-0.0 adds nothing (see the note)
  const int32_t row = __ldg(idx + lane);
  if (row < 0 || row >= V) return;
  atomicAdd(dst + (static_cast<int64_t>(b) * V + row) * D + d, x);
}

// keep, idx and vals in phase: at the lane where vals reaches a 16-byte
// boundary (written to *head), idx does too and keep is 4-byte aligned.
template <typename E>
bool store_in_phase(const void* idx, const void* keep, const void* vals,
                    int64_t* head) {
  return d1_phase<E>(idx, vals, head) &&
         ((reinterpret_cast<uintptr_t>(keep) + *head) & 3) == 0;
}

template <typename E, typename I, int V4, bool kCov>
void launch_d1_vec(E* dst, const int32_t* idx, const uint8_t* keep,
                   const E* vals, int32_t* cov, I total, I h, I V,
                   FastDiv<I> by_n, cudaStream_t s) {
  constexpr int L = Vec16<E>::kLanes;
  const I head = h < total ? h : total;
  const I nv = (total - head) / L;
  const int64_t per_block = kThreads * V4;
  const int64_t blocks = (static_cast<int64_t>(nv) + per_block - 1) /
                         per_block;
  store_d1_vec_kernel<E, I, V4, kCov>
      <<<static_cast<unsigned>(blocks > 0 ? blocks : 1), kThreads, 0, s>>>(
          dst, idx, keep, vals, cov, total, head, nv, V, by_n);
}

template <typename T, typename I, int E, bool kCov>
void launch_elems(void* dst, const int32_t* idx, const uint8_t* keep,
                  const void* vals, int32_t* cov, I elems, I V, I dv, I N,
                  cudaStream_t s) {
  const int64_t blocks = (static_cast<int64_t>(elems) + kThreads * E - 1) /
                         (kThreads * E);
  store_elems_kernel<T, I, E, kCov>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<T*>(dst), idx, keep, static_cast<const T*>(vals), cov,
          elems, V, dv, make_div(dv), make_div(N));
}

// E: float (the _f32 entries) or uint16_t (the _b16 entries).
template <typename E, typename I, bool kCov>
int launch_store(void* dst, const int32_t* idx, const uint8_t* keep,
                 const void* vals, int32_t* cov, int64_t B, int64_t N,
                 int64_t V, int64_t D, int64_t vecs, cudaStream_t s) {
  using Vec = Vec16<E>;
  constexpr int L = Vec::kLanes;
  const I total = static_cast<I>(B * N);
  bool deep = false;
  int64_t h = 0;
  if (D == 1 && store_in_phase<E>(idx, keep, vals, &h)) {
    if (static_cast<int64_t>(total) / (L * kThreads) > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const cudaError_t err =
        deep_for(vecs, static_cast<int64_t>(total) / L, kVecs, &deep);
    if (err != cudaSuccess) return static_cast<int>(err);
    (deep ? &launch_d1_vec<E, I, kVecs, kCov>
          : &launch_d1_vec<E, I, 1, kCov>)(
        static_cast<E*>(dst), idx, keep, static_cast<const E*>(vals), cov,
        total, static_cast<I>(h), static_cast<I>(V),
        make_div(static_cast<I>(N)), s);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = D % L == 0 && aligned16(dst) && aligned16(vals);
  const I dv = static_cast<I>(vec ? D / L : D);
  const I elems = total * dv;
  if ((static_cast<int64_t>(elems) + kThreads - 1) / kThreads > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaError_t err = deep_for(vecs, elems, kElems, &deep);
  if (err != cudaSuccess) return static_cast<int>(err);
  const I v = static_cast<I>(V), n = static_cast<I>(N);
  using T = typename Vec::T;
  if (vec) {
    (deep ? &launch_elems<T, I, kElems, kCov>
          : &launch_elems<T, I, 1, kCov>)(dst, idx, keep, vals, cov, elems,
                                          v, dv, n, s);
  } else {
    (deep ? &launch_elems<E, I, kElems, kCov>
          : &launch_elems<E, I, 1, kCov>)(dst, idx, keep, vals, cov, elems,
                                          v, dv, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename E, bool kCov>
int store_entry(void* dst, const void* idx, const void* keep,
                const void* vals, void* cov, int64_t B, int64_t N, int64_t V,
                int64_t D, int64_t vecs, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  if (V < 0 || !(vecs == 0 || vecs == 1 || vecs == kVecs || vecs == kElems)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  int32_t* cv = static_cast<int32_t*>(cov);
  return fits32(B, N, V, D)
             ? launch_store<E, uint32_t, kCov>(dst, ix, kp, vals, cv, B, N, V,
                                               D, vecs, s)
             : launch_store<E, uint64_t, kCov>(dst, ix, kp, vals, cv, B, N, V,
                                               D, vecs, s);
}

// T: float, __nv_bfloat16 or __half.
template <typename T>
int add_entry(void* dst, const void* idx, const void* vals, int64_t B,
              int64_t N, int64_t V, int64_t D, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const int64_t bpp = (N * D + kThreads - 1) / kThreads;
  if (B * bpp > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(B * bpp));
  if (D == 1) {
    scatter_add_rows_kernel<T, true><<<grid, kThreads, 0, s>>>(
        static_cast<T*>(dst), ix, static_cast<const T*>(vals), N, V, D,
        static_cast<uint32_t>(bpp));
  } else {
    scatter_add_rows_kernel<T, false><<<grid, kThreads, 0, s>>>(
        static_cast<T*>(dst), ix, static_cast<const T*>(vals), N, V, D,
        static_cast<uint32_t>(bpp));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All return the cudaError_t of the launch (0 on success).  The stores'
// vecs: loads in flight a thread, 1, kVecs (4) or kElems (8; either deep
// value takes the deep instance of the path the operands take), or 0 for
// the card rule (common.cuh card_threads).
extern "C" int scatter_store_rows_f32(void* dst, const void* idx,
                                      const void* keep, const void* vals,
                                      int64_t B, int64_t N, int64_t V,
                                      int64_t D, int64_t vecs, void* stream) {
  return store_entry<float, false>(dst, idx, keep, vals, nullptr, B, N, V, D,
                                   vecs, stream);
}

// The same store on rows of any 2-byte element (bfloat16, float16).
extern "C" int scatter_store_rows_b16(void* dst, const void* idx,
                                      const void* keep, const void* vals,
                                      int64_t B, int64_t N, int64_t V,
                                      int64_t D, int64_t vecs, void* stream) {
  return store_entry<uint16_t, false>(dst, idx, keep, vals, nullptr, B, N, V,
                                      D, vecs, stream);
}

// cov: (B, V) int32, zeroed by the caller; 1 where this call stored a row.
extern "C" int scatter_store_rows_cov_f32(void* dst, const void* idx,
                                          const void* keep, const void* vals,
                                          void* cov, int64_t B, int64_t N,
                                          int64_t V, int64_t D, int64_t vecs,
                                          void* stream) {
  return store_entry<float, true>(dst, idx, keep, vals, cov, B, N, V, D, vecs,
                                  stream);
}

extern "C" int scatter_store_rows_cov_b16(void* dst, const void* idx,
                                          const void* keep, const void* vals,
                                          void* cov, int64_t B, int64_t N,
                                          int64_t V, int64_t D, int64_t vecs,
                                          void* stream) {
  return store_entry<uint16_t, true>(dst, idx, keep, vals, cov, B, N, V, D,
                                     vecs, stream);
}

extern "C" int scatter_add_rows_f32(void* dst, const void* idx,
                                    const void* vals, int64_t B, int64_t N,
                                    int64_t V, int64_t D, void* stream) {
  return add_entry<float>(dst, idx, vals, B, N, V, D, stream);
}

extern "C" int scatter_add_rows_bf16(void* dst, const void* idx,
                                     const void* vals, int64_t B, int64_t N,
                                     int64_t V, int64_t D, void* stream) {
  return add_entry<__nv_bfloat16>(dst, idx, vals, B, N, V, D, stream);
}

extern "C" int scatter_add_rows_f16(void* dst, const void* idx,
                                    const void* vals, int64_t B, int64_t N,
                                    int64_t V, int64_t D, void* stream) {
  return add_entry<__half>(dst, idx, vals, B, N, V, D, stream);
}
