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
//     scatter through a one-hot MXU contraction), by a streaming route or
//     a shared-memory route for hot rows
//
// Layouts: dst (B, V, D), idx (B, N) int32, keep (B, N) bool (one byte), vals
// (B, N, D), all contiguous; the store takes them at any alignment of their
// type.  dst and vals are float32 for the _f32 entries; the stores' _b16
// entries take any 2-byte element (bfloat16, float16), since a store moves
// bits; the add has one instance a type, bfloat16 and float16, each adding
// in its own type on the streaming route (no round trip through float32)
// and in float32 shared memory on the hot-row route.  Lanes whose index lies
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
// Add.  Sums into a dst the caller zeroed, in the element's own type for
// float32, and at 16 bits by reductions that round each sum to 16 bits, so
// the result equals the reference's `dst + sum` up to the order of the
// additions (atomics reorder them from run to run).  Offsets are 64-bit;
// lanes out of range are dropped.  A lane whose payload is +0.0 or -0.0
// (at 16 bits: its magnitude bits are 0) is skipped before its index is
// read: x + (-0.0) = x, and x + (+0.0) = x unless x is -0.0, which a
// zeroed dst never holds (no sum that starts at +0.0 is -0.0), so the
// result is unchanged.  The planner's padding lanes and scratch patterns
// all carry +0.0 onto one scratch row (plan._host_members), whose atomics
// once serialised there (237.7 ms against 0.81 ms for 2^27 lanes, on an
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
//
// What held the 16-bit add back: it issued one scalar atomicAdd on
// __nv_bfloat16 or __half a lane, and the card's L2 adds 16-bit floats
// natively only in packed pairs and, from sm_90, 16-byte vectors, so
// ptxas lowered each to a loop of a load, an HADD2 and an ATOM.E.CAS on
// the 4-byte word that holds the element, retried until no other lane
// had changed the word.  On unique rows neighbouring lanes share words,
// so every lane paid a read and a CAS (33% of the byte bound, as slow as
// index_add_); on LULESH-S3's 16 hot rows the retries grew without bound,
// ~870 ns a lane at 2^18 lanes and more (PERF.md; float32's add is one
// native REDG.E.ADD.F32).  So the add has two routes, chosen by the
// wrapper (`smem`, kernels/autotune.py) and passed here as `ctas`:
//
//   * Streaming (ctas = 0).  float32 keeps its one atomicAdd an element.
//     At 16 bits no element whose word lies wholly inside dst takes a
//     scalar atomic: with D = 1 and idx and vals in phase each thread takes
//     16-byte vectors of 8 lanes, as the store does, and a vector whose 8
//     lanes are of one pattern, in range, on consecutive rows, the first
//     16-byte aligned in dst, is one `red.global.add.noftz.v4.bf16x2` (or
//     .f16x2: REDG.E.ADD.BF16x8 / F16x8); every other lane is a packed
//     `red...bf16x2` on its word, with the thread's next lane where that
//     one lands on the word's other half and +0.0 there otherwise.  D > 1
//     goes by chunks of a row: a 16-byte vector reduction where D is a
//     multiple of 8 and dst and vals are 16-byte aligned, a packed one where
//     D is even and both are 4-byte aligned, else one element at a time as
//     above.  Adding +0.0 to the other half is exact for the reason the
//     +-0.0 skip is: dst was zeroed, so that half holds no -0.0.  Only an
//     element whose word straddles dst's first or last byte (a view at an
//     odd element offset) takes the scalar atomic, and only the kEnds
//     instances, launched for such a view, hold it: the SASS of the others
//     has no ATOM.E.CAS.
//   * Hot rows (ctas > 0).  Where a pattern's V x D accumulators fit in a
//     block's shared memory and its lanes are many times V x D (LULESH-S3:
//     2^25 lanes onto 16 rows), a (B, ctas) grid sums each pattern's lanes
//     into float32 copies of its rows in shared memory, one copy a thread
//     for V x D <= 32 (no atomics: a float atomic on shared memory is an
//     ATOMS.CAST.SPIN loop on sm_90) and one a block by shared atomics
//     above, then flushes each element whose sum is not zero once, by the
//     packed reduction (a float atomic for float32).  A row then takes at
//     most min(ctas, K - 1) roundings to 16 bits in a lane's path, not K
//     (ref.hot_row_rounds), and K - 1 float32 ones.
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
// 3.35 TB/s, and for the coverage 4 bytes a written row more.  An add on
// the streaming route with heavy duplication is bound instead by the L2's
// reductions on the few hot addresses, which serialise; the hot-row route
// reads each lane once and writes V x D elements a block.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

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

// -- the add ------------------------------------------------------------------

// An element type of the add, and its payload's bits: float, or the 16-bit
// word of a bfloat16 or float16.  The 16-bit types add through the L2's
// packed reduction on the aligned 4-byte word that holds an element
// (red2), the 16-byte vector reduction of sm_90 (red8), and, only where a
// word would straddle dst's first or last byte, the scalar atomic (one).
template <typename T>
struct AddType;

template <>
struct AddType<float> {
  using Bits = float;
  __device__ __forceinline__ static float to_float(float x) { return x; }
};

template <>
struct AddType<__nv_bfloat16> {
  using Bits = uint16_t;
  __device__ __forceinline__ static float to_float(uint16_t b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  __device__ __forceinline__ static uint16_t from_float(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  __device__ __forceinline__ static void red2(uint32_t* w, uint32_t x) {
    asm volatile("red.global.add.noftz.bf16x2 [%0], %1;"
                 :: "l"(w), "r"(x) : "memory");
  }
  __device__ __forceinline__ static void red8(uint4* p, const uint4& x) {
    asm volatile("red.global.add.noftz.v4.bf16x2 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
                 : "memory");
  }
  __device__ __forceinline__ static void one(uint16_t* p, uint16_t b) {
    atomicAdd(reinterpret_cast<__nv_bfloat16*>(p), __ushort_as_bfloat16(b));
  }
};

template <>
struct AddType<__half> {
  using Bits = uint16_t;
  __device__ __forceinline__ static float to_float(uint16_t b) {
    return __half2float(__ushort_as_half(b));
  }
  __device__ __forceinline__ static uint16_t from_float(float f) {
    return __half_as_ushort(__float2half_rn(f));
  }
  __device__ __forceinline__ static void red2(uint32_t* w, uint32_t x) {
    asm volatile("red.global.add.noftz.f16x2 [%0], %1;"
                 :: "l"(w), "r"(x) : "memory");
  }
  __device__ __forceinline__ static void red8(uint4* p, const uint4& x) {
    asm volatile("red.global.add.noftz.v4.f16x2 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
                 : "memory");
  }
  __device__ __forceinline__ static void one(uint16_t* p, uint16_t b) {
    atomicAdd(reinterpret_cast<__half*>(p), __ushort_as_half(b));
  }
};

// Whether a payload adds nothing to a zeroed dst (+-0.0, see the note):
// floats compare; a 16-bit value's magnitude bits are 0.
__device__ __forceinline__ bool nothing(float x) { return x == 0.f; }
__device__ __forceinline__ bool nothing(uint16_t b) {
  return (b & 0x7fff) == 0;
}

// Whether lanes 4q .. 4q + 3 of a 16-byte vector of payloads add anything
// (q constant after unrolling): their indices are read only then.
__device__ __forceinline__ bool quad_adds(const float4& x, int) {
  return x.x != 0.f || x.y != 0.f || x.z != 0.f || x.w != 0.f;
}
__device__ __forceinline__ bool quad_adds(const uint4& x, int q) {
  return ((q == 0 ? x.x | x.y : x.z | x.w) & 0x7fff7fffu) != 0;
}

__device__ __forceinline__ bool low_half(const uint16_t* p) {
  return (reinterpret_cast<uintptr_t>(p) & 2) == 0;
}

// dst[o] += b (dst holds `size` elements, b's type T): the packed
// reduction on the aligned word that holds dst[o], +0.0 in its other half;
// the scalar atomic only where that word straddles dst's first or last
// byte (a view that starts or ends at an odd element offset), which only
// the kEnds instances, launched for such a dst (`straddles`), compile.
template <typename T, bool kEnds, typename I>
__device__ __forceinline__ void add_half(uint16_t* dst, I o, uint16_t b,
                                         I size) {
  const bool lo = low_half(dst + o);
  if (kEnds && (lo ? o + 1 == size : o == 0)) {
    AddType<T>::one(dst + o, b);
    return;
  }
  AddType<T>::red2(reinterpret_cast<uint32_t*>(
                       reinterpret_cast<uintptr_t>(dst + o) & ~uintptr_t{3}),
                   lo ? uint32_t{b} : uint32_t{b} << 16);
}

// Whether a 16-bit dst of `size` elements has a word straddling its first
// or last byte (it starts or ends at a word's high half).
bool straddles(const void* dst, int64_t size) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  return ((a & 2) | ((a + 2 * static_cast<uintptr_t>(size)) & 2)) != 0;
}

// dst[o] += lo and dst[o + 1] += hi where dst + o is a word's low half: one
// packed reduction.
template <typename T, typename I>
__device__ __forceinline__ void add_pair(uint16_t* dst, I o, uint16_t lo,
                                         uint16_t hi) {
  AddType<T>::red2(reinterpret_cast<uint32_t*>(dst + o),
                   uint32_t{lo} | (uint32_t{hi} << 16));
}

// Streaming, D = 1 with idx and vals in phase, 16-bit T: L = 8 lanes a
// 16-byte vector, the flat lanes a head (< L, up to vals' first 16-byte
// boundary), nv vectors and a tail (< L), as the store's
// store_d1_vec_kernel; thread t of block k takes vectors k * 256 * V4 +
// j * 256 + t, j < V4.  Every payload load is issued first, then the index
// loads of each quad of lanes with a payload other than +-0.0, then the
// reductions: a vector whose 8 lanes are of one pattern, in range, on
// consecutive rows, the first 16-byte aligned in dst, is one 16-byte
// vector reduction (the CLI pattern is all such vectors); any other lane
// goes alone, a packed reduction on its word, with the next lane where
// that one lands on the word's other half.
template <typename T, typename I, int V4, bool kEnds>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_d1_vec_kernel(uint16_t* __restrict__ dst,
                               const int32_t* __restrict__ idx,
                               const uint16_t* __restrict__ vals, I total,
                               I head, I nv, I V, I size, FastDiv<I> by_n) {
  using Vec = Vec16<uint16_t>;
  constexpr int L = Vec::kLanes, Q = L / 4;
  const I v0 = static_cast<I>(blockIdx.x) * (kThreads * V4) + threadIdx.x;
  const int4* iv = reinterpret_cast<const int4*>(idx + head);
  const uint4* xv = reinterpret_cast<const uint4*>(vals + head);
  uint4 x[V4];
  int4 r[V4][Q];
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const I v = v0 + j * kThreads;
    x[j] = v < nv ? __ldcs(xv + v) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const I v = v0 + j * kThreads;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      r[j][q] = quad_adds(x[j], q) ? __ldcs(iv + v * Q + q)
                                   : make_int4(-1, -1, -1, -1);
    }
  }
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    bool any = false;
#pragma unroll
    for (int q = 0; q < Q; ++q) any |= quad_adds(x[j], q);
    if (!any) continue;            // nothing to add (or past the last vector)
    const I l = head + (v0 + j * kThreads) * L;
    const I b = by_n.div(l);
    const bool one = b == by_n.div(l + (L - 1));   // all lanes in pattern b
    int32_t row[L];
#pragma unroll
    for (int m = 0; m < L; ++m) row[m] = int4_lane(r[j][m / 4], m % 4);
    const int32_t q0 = row[0];
    bool whole = one && in_table(q0, V) && in_table(row[L - 1], V);
#pragma unroll
    for (int m = 0; m < L; ++m) whole = whole && int64_t{row[m]} - q0 == m;
    if (whole && aligned16(dst + b * V + q0)) {
      AddType<T>::red8(reinterpret_cast<uint4*>(dst + b * V + q0), x[j]);
      continue;
    }
    uint16_t e[L];
    I o[L];
    bool go[L], pair[L];
#pragma unroll
    for (int m = 0; m < L; ++m) {
      e[m] = Vec::lane(x[j], m);
      go[m] = !nothing(e[m]) && in_table(row[m], V);
      o[m] = go[m] ? (one ? b : by_n.div(l + m)) * V + row[m] : I{0};
    }
#pragma unroll
    for (int m = 0; m < L; ++m) {
      const int n = (m + 1) % L;   // the next lane (m < L - 1)
      pair[m] = m + 1 < L && go[m] && go[n] && o[n] == o[m] + 1 &&
                low_half(dst + o[m]);
    }
#pragma unroll
    for (int m = 0; m < L; ++m) {
      if (!go[m] || (m > 0 && pair[(m + L - 1) % L])) continue;
      if (pair[m]) {
        add_pair<T>(dst, o[m], e[m], e[(m + 1) % L]);
      } else {
        add_half<T, kEnds>(dst, o[m], e[m], size);
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 2 * L) {  // head, then tail
    const I l = threadIdx.x < L ? static_cast<I>(threadIdx.x)
                                : head + nv * L + (threadIdx.x - L);
    if (threadIdx.x < L ? l < head : l < total) {
      const uint16_t e = vals[l];
      if (!nothing(e)) {           // +-0.0 adds nothing: its index unread
        const int32_t row = idx[l];
        if (in_table(row, V)) {
          add_half<T, kEnds>(dst, by_n.div(l) * V + row, e, size);
        }
      }
    }
  }
}

// A chunk of P 16-bit elements of one lane's row: a 16-byte vector (P = 8),
// a word (P = 2) or one element.
template <int P>
struct Chunk;
template <>
struct Chunk<8> {
  using T = uint4;
  __device__ static bool adds(const uint4& x) {
    return ((x.x | x.y | x.z | x.w) & 0x7fff7fffu) != 0;
  }
};
template <>
struct Chunk<2> {
  using T = uint32_t;
  __device__ static bool adds(uint32_t x) { return (x & 0x7fff7fffu) != 0; }
};
template <>
struct Chunk<1> {
  using T = uint16_t;
  __device__ static bool adds(uint16_t x) { return !nothing(x); }
};

// Streaming, any D and alignment, 16-bit T: the flat (B * N, D / P) chunks
// of vals, thread t of block k chunks k * 256 * E + j * 256 + t, j < E;
// payloads first, then the indices of chunks that add anything, then one
// reduction a chunk: P = 8 where D is a multiple of 8 and dst and vals
// are 16-byte aligned (a vector reduction), P = 2 where D is even and both
// are 4-byte aligned (a packed one on both halves), else P = 1 (add_half).
template <typename T, typename I, int P, int E, bool kEnds>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_elems_kernel(uint16_t* __restrict__ dst,
                              const int32_t* __restrict__ idx,
                              const uint16_t* __restrict__ vals, I chunks,
                              I V, I D, I size, FastDiv<I> by_dc,
                              FastDiv<I> by_n) {
  using C = typename Chunk<P>::T;
  const I c0 = static_cast<I>(blockIdx.x) * (kThreads * E) + threadIdx.x;
  C x[E];
  int32_t row[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const I c = c0 + j * kThreads;
    x[j] = c < chunks ? __ldcs(reinterpret_cast<const C*>(vals) + c) : C{};
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const I c = c0 + j * kThreads;
    row[j] = c < chunks && Chunk<P>::adds(x[j])
                 ? (D == P ? __ldcs(idx + c) : __ldg(idx + by_dc.div(c)))
                 : -1;
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (!in_table(row[j], V)) continue;
    const I c = c0 + j * kThreads;
    const I lane = by_dc.div(c);
    const I o = (by_n.div(lane) * V + row[j]) * D + (c - lane * (D / P)) * P;
    if constexpr (P == 8) {
      AddType<T>::red8(reinterpret_cast<uint4*>(dst + o), x[j]);
    } else if constexpr (P == 2) {
      AddType<T>::red2(reinterpret_cast<uint32_t*>(dst + o), x[j]);
    } else {
      add_half<T, kEnds>(dst, o, x[j], size);
    }
  }
}

// float32, streaming: one atomicAdd an element (float's L2 reduction is
// native); its payload read first and its index only where it adds.
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
  const float x = __ldg(vals + lane * D + d);
  if (nothing(x)) return;          // +-0.0 adds nothing (see the note)
  const int32_t row = __ldg(idx + lane);
  if (row < 0 || row >= V) return;
  atomicAdd(dst + (static_cast<int64_t>(b) * V + row) * D + d, x);
}

// Hot rows: block (b, c) of a (B, ctas) grid sums lanes of pattern b into
// float32 accumulators for the pattern's V x D elements in shared memory
// (kPrivate: one copy a thread, for V * D <= kHotPrivate, so no two
// threads share an address and no atomic is needed; else one copy a
// block, by shared-memory atomics), then flushes each element whose sum is
// not zero into dst once.  Its lanes: thread t takes the pattern's 16-byte
// vectors (kVec: D = 1, idx and vals in phase) or elements c * 256 + t +
// j * ctas * 256, kHotLoads a round, payloads first, then the indices of
// those that add anything; the < 2 x 8 lanes at the pattern's ends
// outside its whole vectors go one at a time, by block c = 0.
constexpr int kHotPrivate = 32;
constexpr int kHotLoads = 4;
constexpr int64_t kHotSmemMax = 232448;   // 227 KB, a block's most

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s /= 2) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// float: each sum that is not zero, by one float atomic.
template <typename T, bool>
__device__ __forceinline__ void hot_flush(float* dst, const float* tot,
                                          int64_t g0, int64_t vd, int64_t) {
  for (int64_t s = threadIdx.x; s < vd; s += kThreads) {
    if (tot[s] != 0.f) atomicAdd(dst + g0 + s, tot[s]);
  }
}

// 16 bits: the block's elements dst[g0, g0 + vd) word by word, each sum
// rounded once to T: a word whose two halves both add is one packed
// reduction, a word with one is add_half's.
template <typename T, bool kEnds>
__device__ __forceinline__ void hot_flush(uint16_t* dst, const float* tot,
                                          int64_t g0, int64_t vd,
                                          int64_t size) {
  using A = AddType<T>;
  const int64_t h0 = low_half(dst + g0) ? 0 : 1;   // starts at a high half
  const int64_t words = (h0 + vd + 1) / 2;
  for (int64_t w = threadIdx.x; w < words; w += kThreads) {
    const int64_t s = 2 * w - h0;  // the word's low half, element s
    const uint16_t lo = s >= 0 ? A::from_float(tot[s]) : uint16_t{0};
    const uint16_t hi = s + 1 < vd ? A::from_float(tot[s + 1]) : uint16_t{0};
    if (!nothing(lo) && !nothing(hi)) {
      add_pair<T>(dst, g0 + s, lo, hi);
    } else if (!nothing(lo)) {
      add_half<T, kEnds>(dst, g0 + s, lo, size);
    } else if (!nothing(hi)) {
      add_half<T, kEnds>(dst, g0 + s + 1, hi, size);
    }
  }
}

template <typename T, bool kPrivate, bool kVec, bool kEnds>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_hot_kernel(typename AddType<T>::Bits* __restrict__ dst,
                            const int32_t* __restrict__ idx,
                            const typename AddType<T>::Bits* __restrict__ vals,
                            int64_t N, int64_t V, int64_t D, int64_t head,
                            uint32_t ctas) {
  using Bits = typename AddType<T>::Bits;
  using Vec = Vec16<Bits>;
  constexpr int L = Vec::kLanes, Q = L / 4;
  extern __shared__ float acc[];
  const int64_t vd = V * D;
  const uint32_t b = blockIdx.x / ctas;
  const int64_t c = blockIdx.x - b * ctas;
  const int tid = threadIdx.x;
  float* const tot = kPrivate ? acc + vd * kThreads : acc;
  for (int64_t s = tid; s < (kPrivate ? vd * kThreads : vd); s += kThreads) {
    acc[s] = 0.f;
  }
  __syncthreads();
  auto put = [&](int32_t row, int64_t d, Bits x) {
    const int64_t s = row * D + d;
    if (kPrivate) {
      acc[s * kThreads + tid] += AddType<T>::to_float(x);
    } else {
      atomicAdd(acc + s, AddType<T>::to_float(x));
    }
  };
  const int64_t lo = int64_t{b} * N, hi = lo + N;   // the pattern's lanes
  const int64_t stride = int64_t{ctas} * kThreads;
  if (kVec) {
    // whole vectors [k0, k1) of the flat lanes' (head + k L ..)
    const int64_t k0 = lo <= head ? 0 : (lo - head + L - 1) / L;
    const int64_t k1 = hi < head + k0 * L ? k0 : (hi - head) / L;
    const typename Vec::T* xv = reinterpret_cast<const typename Vec::T*>(vals + head);
    const int4* iv = reinterpret_cast<const int4*>(idx + head);
    for (int64_t k = k0 + c * kThreads + tid; k < k1;
         k += stride * kHotLoads) {
      typename Vec::T x[kHotLoads];
      int4 r[kHotLoads][Q];
#pragma unroll
      for (int j = 0; j < kHotLoads; ++j) {
        const int64_t kk = k + j * stride;
        x[j] = kk < k1 ? __ldcs(xv + kk) : typename Vec::T{};
      }
#pragma unroll
      for (int j = 0; j < kHotLoads; ++j) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          r[j][q] = quad_adds(x[j], q)
                        ? __ldcs(iv + (k + j * stride) * Q + q)
                        : make_int4(-1, -1, -1, -1);
        }
      }
#pragma unroll
      for (int j = 0; j < kHotLoads; ++j) {
#pragma unroll
        for (int m = 0; m < L; ++m) {
          const int32_t row = int4_lane(r[j][m / 4], m % 4);
          const Bits e = Vec::lane(x[j], m);
          if (!nothing(e) && in_table(row, V)) put(row, 0, e);
        }
      }
    }
    // the lanes outside whole vectors, < 2L: [lo, a) and [t, hi)
    const int64_t a = k1 > k0 ? head + k0 * L : hi;
    const int64_t t = k1 > k0 ? head + k1 * L : hi;
    if (c == 0 && tid < 2 * L) {
      const int64_t l = tid < a - lo ? lo + tid : t + (tid - (a - lo));
      if (l < hi) {
        const Bits e = vals[l];
        if (!nothing(e)) {
          const int32_t row = idx[l];
          if (in_table(row, V)) put(row, 0, e);
        }
      }
    }
  } else {
    const Bits* xs = vals + lo * D;
    const int32_t* is = idx + lo;
    const int64_t n = N * D;
    for (int64_t e0 = c * kThreads + tid; e0 < n; e0 += stride * kHotLoads) {
      Bits x[kHotLoads];
      int32_t row[kHotLoads];
#pragma unroll
      for (int j = 0; j < kHotLoads; ++j) {
        const int64_t e = e0 + j * stride;
        x[j] = e < n ? __ldcs(xs + e) : Bits{};
      }
#pragma unroll
      for (int j = 0; j < kHotLoads; ++j) {
        const int64_t e = e0 + j * stride;
        row[j] = e < n && !nothing(x[j]) ? __ldg(is + e / D) : -1;
      }
#pragma unroll
      for (int j = 0; j < kHotLoads; ++j) {
        const int64_t e = e0 + j * stride;
        if (in_table(row[j], V)) put(row[j], e - (e / D) * D, x[j]);
      }
    }
  }
  __syncthreads();
  if (kPrivate) {                  // each warp sums its elements' copies
    const int warp = tid / 32, lane = tid % 32;
    for (int64_t s = warp; s < vd; s += kThreads / 32) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kThreads / 32; ++j) {
        sum += acc[s * kThreads + lane + 32 * j];
      }
      sum = warp_sum(sum);
      if (lane == 0) tot[s] = sum;
    }
    __syncthreads();
  }
  hot_flush<T, kEnds>(dst, tot, int64_t{b} * vd, vd,
                      int64_t{gridDim.x / ctas} * vd);
}

// One of the hot kernel's four instances, launched with `bytes` of shared
// memory (above 48 KB only once the kernel allows it).
template <typename T, bool kPrivate, bool kVec, bool kEnds>
int launch_hot_instance(void* dst, const int32_t* idx, const void* vals,
                        int64_t B, int64_t N, int64_t V, int64_t D,
                        int64_t head, int64_t ctas, int64_t bytes,
                        cudaStream_t s) {
  using Bits = typename AddType<T>::Bits;
  auto* kernel = &scatter_add_rows_hot_kernel<T, kPrivate, kVec, kEnds>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(B * ctas), kThreads, bytes, s>>>(
      static_cast<Bits*>(dst), idx, static_cast<const Bits*>(vals), N, V, D,
      head, static_cast<uint32_t>(ctas));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hot(void* dst, const int32_t* idx, const void* vals, int64_t B,
               int64_t N, int64_t V, int64_t D, int64_t ctas,
               cudaStream_t s) {
  using Bits = typename AddType<T>::Bits;
  const int64_t vd = V * D;
  const bool priv = vd <= kHotPrivate;
  const int64_t bytes = 4 * (priv ? vd * (kThreads + 1) : vd);
  if (V == 0 || vd > kHotSmemMax / 4 || bytes > kHotSmemMax ||
      ctas > INT_MAX / B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t head = 0;
  const bool vec = D == 1 && d1_phase<Bits>(idx, vals, &head);
  if constexpr (!std::is_same_v<T, float>) {
    if (straddles(dst, B * vd)) {
      return (priv ? (vec ? &launch_hot_instance<T, true, true, true>
                          : &launch_hot_instance<T, true, false, true>)
                   : (vec ? &launch_hot_instance<T, false, true, true>
                          : &launch_hot_instance<T, false, false, true>))(
          dst, idx, vals, B, N, V, D, head, ctas, bytes, s);
    }
  }
  return (priv ? (vec ? &launch_hot_instance<T, true, true, false>
                      : &launch_hot_instance<T, true, false, false>)
               : (vec ? &launch_hot_instance<T, false, true, false>
                      : &launch_hot_instance<T, false, false, false>))(
      dst, idx, vals, B, N, V, D, head, ctas, bytes, s);
}

// float32's streaming route: one atomicAdd an element.
int launch_stream_f32(void* dst, const int32_t* idx, const void* vals,
                      int64_t B, int64_t N, int64_t V, int64_t D,
                      cudaStream_t s) {
  const int64_t bpp = (N * D + kThreads - 1) / kThreads;
  if (B * bpp > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(B * bpp));
  float* d = static_cast<float*>(dst);
  const float* x = static_cast<const float*>(vals);
  if (D == 1) {
    scatter_add_rows_kernel<true><<<grid, kThreads, 0, s>>>(
        d, idx, x, N, V, D, static_cast<uint32_t>(bpp));
  } else {
    scatter_add_rows_kernel<false><<<grid, kThreads, 0, s>>>(
        d, idx, x, N, V, D, static_cast<uint32_t>(bpp));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I, int V4, bool kEnds>
void launch_add_d1_vec(uint16_t* dst, const int32_t* idx,
                       const uint16_t* vals, I total, I h, I V, I size,
                       FastDiv<I> by_n, cudaStream_t s) {
  constexpr int L = Vec16<uint16_t>::kLanes;
  const I head = h < total ? h : total;
  const I nv = (total - head) / L;
  const int64_t per_block = kThreads * V4;
  const int64_t blocks = (static_cast<int64_t>(nv) + per_block - 1) /
                         per_block;
  scatter_add_rows_d1_vec_kernel<T, I, V4, kEnds>
      <<<static_cast<unsigned>(blocks > 0 ? blocks : 1), kThreads, 0, s>>>(
          dst, idx, vals, total, head, nv, V, size, by_n);
}

template <typename T, typename I, int P, int E, bool kEnds>
void launch_add_elems(uint16_t* dst, const int32_t* idx,
                      const uint16_t* vals, I chunks, I V, I D, I size, I N,
                      cudaStream_t s) {
  const int64_t blocks = (static_cast<int64_t>(chunks) + kThreads * E - 1) /
                         (kThreads * E);
  scatter_add_rows_elems_kernel<T, I, P, E, kEnds>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          dst, idx, vals, chunks, V, D, size, make_div(D / P), make_div(N));
}

template <typename T, typename I, int P, bool kEnds>
int launch_add_chunks(uint16_t* dst, const int32_t* idx,
                      const uint16_t* vals, I total, I V, I D, I size, I N,
                      cudaStream_t s) {
  const I chunks = total * (D / P);
  if ((static_cast<int64_t>(chunks) + kThreads - 1) / kThreads > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  bool deep = false;
  const cudaError_t err = deep_for(0, chunks, kElems, &deep);
  if (err != cudaSuccess) return static_cast<int>(err);
  (deep ? &launch_add_elems<T, I, P, kElems, kEnds>
        : &launch_add_elems<T, I, P, 1, kEnds>)(dst, idx, vals, chunks, V, D,
                                                size, N, s);
  return static_cast<int>(cudaGetLastError());
}

// The 16-bit streaming route.
template <typename T, typename I>
int launch_stream_b16(void* dst_, const int32_t* idx, const void* vals_,
                      int64_t B, int64_t N, int64_t V, int64_t D,
                      cudaStream_t s) {
  uint16_t* dst = static_cast<uint16_t*>(dst_);
  const uint16_t* vals = static_cast<const uint16_t*>(vals_);
  constexpr int L = Vec16<uint16_t>::kLanes;
  const I total = static_cast<I>(B * N), size = static_cast<I>(B * V * D);
  int64_t h = 0;
  if (D == 1 && d1_phase<uint16_t>(idx, vals, &h)) {
    if (static_cast<int64_t>(total) / (L * kThreads) > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    bool deep = false;
    const cudaError_t err =
        deep_for(0, static_cast<int64_t>(total) / L, kVecs, &deep);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto* launch =
        straddles(dst, size)
            ? (deep ? &launch_add_d1_vec<T, I, kVecs, true>
                    : &launch_add_d1_vec<T, I, 1, true>)
            : (deep ? &launch_add_d1_vec<T, I, kVecs, false>
                    : &launch_add_d1_vec<T, I, 1, false>);
    launch(dst, idx, vals, total, static_cast<I>(h), static_cast<I>(V), size,
           make_div(static_cast<I>(N)), s);
    return static_cast<int>(cudaGetLastError());
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) |
                      reinterpret_cast<uintptr_t>(vals);
  const I v = static_cast<I>(V), d = static_cast<I>(D),
          n = static_cast<I>(N);
  if (D % 8 == 0 && (a & 15) == 0) {
    return launch_add_chunks<T, I, 8, false>(dst, idx, vals, total, v, d,
                                             size, n, s);
  }
  if (D % 2 == 0 && (a & 3) == 0) {
    return launch_add_chunks<T, I, 2, false>(dst, idx, vals, total, v, d,
                                             size, n, s);
  }
  return (straddles(dst, size) ? &launch_add_chunks<T, I, 1, true>
                               : &launch_add_chunks<T, I, 1, false>)(
      dst, idx, vals, total, v, d, size, n, s);
}

// T: float, __nv_bfloat16 or __half; ctas: 0 for the streaming route, else
// the hot route's blocks a pattern.
template <typename T>
int add_entry(void* dst, const void* idx, const void* vals, int64_t B,
              int64_t N, int64_t V, int64_t D, int64_t ctas, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  if (V < 0 || ctas < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  if (ctas > 0) return launch_hot<T>(dst, ix, vals, B, N, V, D, ctas, s);
  if constexpr (std::is_same_v<T, float>) {
    return launch_stream_f32(dst, ix, vals, B, N, V, D, s);
  } else {
    return fits32(B, N, V, D)
               ? launch_stream_b16<T, uint32_t>(dst, ix, vals, B, N, V, D, s)
               : launch_stream_b16<T, uint64_t>(dst, ix, vals, B, N, V, D, s);
  }
}

}  // namespace

// All return the cudaError_t of the launch (0 on success).  The stores'
// vecs: loads in flight a thread, 1, kVecs (4) or kElems (8; either deep
// value takes the deep instance of the path the operands take), or 0 for
// the card rule (common.cuh card_threads).  The adds' ctas: 0 for the
// streaming route, else the hot-row route's blocks a pattern (its V x D
// float32 accumulators must fit in 227 KB, one copy a thread up to 32;
// else cudaErrorInvalidValue, before any launch).
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
                                    int64_t V, int64_t D, int64_t ctas,
                                    void* stream) {
  return add_entry<float>(dst, idx, vals, B, N, V, D, ctas, stream);
}

extern "C" int scatter_add_rows_bf16(void* dst, const void* idx,
                                     const void* vals, int64_t B, int64_t N,
                                     int64_t V, int64_t D, int64_t ctas,
                                     void* stream) {
  return add_entry<__nv_bfloat16>(dst, idx, vals, B, N, V, D, ctas, stream);
}

extern "C" int scatter_add_rows_f16(void* dst, const void* idx,
                                    const void* vals, int64_t B, int64_t N,
                                    int64_t V, int64_t D, int64_t ctas,
                                    void* stream) {
  return add_entry<__half>(dst, idx, vals, B, N, V, D, ctas, stream);
}
