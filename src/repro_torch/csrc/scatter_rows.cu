// Batched row scatter for Hopper (sm_90a), in place into dst (B, V, D).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/scatter_rows/kernel.py:
//   * scatter_store_rows_f32 <- scatter_store_rows_kernel (last-write-wins
//     store through a one-hot MXU contraction)
//   * scatter_store_rows_cov_f32 <- scatter_store_rows_kernel(with_cov=True)
//     (the same store, plus the (B, V) int32 coverage map of the rows it
//     wrote, from the same launch: the lane-sharded store combine's ballot)
//   * scatter_add_rows_f32   <- scatter_add_rows_kernel   (sum-scatter through
//     a one-hot MXU contraction)
//
// Layouts: dst (B, V, D) float32, idx (B, N) int32, keep (B, N) bool (one
// byte), vals (B, N, D) float32, all contiguous; the store takes them at any
// alignment of their type.  Lanes whose index lies outside [0, V) (the
// planner's INT32_MAX, a negative value) are dropped.  Grids are flat in x.
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
// all such vectors); any other lane goes alone.  A vector that straddles two
// patterns finds each lane's pattern; the < 4 lanes before keep's first
// 4-byte boundary and after the last whole vector are stored lane by lane
// by block 0.  A store too small to fill the card that way (fewer vectors
// than 4 x the threads the card holds, 132 x 2048 on an H100 SXM) takes one
// vector a thread: it is bound by latency, and more threads put more SMs on
// it.  Everything else (D > 1, operands out of phase) takes 8 elements a
// thread, a float4 where D % 4 == 0 and dst and vals are 16-byte aligned,
// else a float, again with every load issued before any store.  Which of
// the two instances runs is the wrapper's choice (`vecs`,
// kernels/autotune.py); 0 leaves it to the rule above.  (A first
// version gave each thread 16 consecutive lanes, keep as one 16-byte load:
// each warp instruction then read 16 bytes of every 64, and it reached 76%
// of the byte bound against this layout's 90% on an NVIDIA H100 80GB HBM3
// at 700 W; PERF.md.)
//
// Add.  One float atomicAdd per element into the zeroed dst, which equals
// the reference's `dst + sum` up to the order of the additions (atomics
// reorder them from run to run).  Offsets are 64-bit.  A lane whose payload
// is +0.0 or -0.0 is skipped before its index is read: x + (-0.0) = x, and
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
// wrote.  A row has at most one writer, so no atomics: a float4 row store
// marks its 4 rows with one int4 where that is 16-byte aligned in cov, else
// with 4 ints; the element kernel marks a lane's row with its first element.
// Both store entry points are instances of one template (kCov), so the
// store without coverage compiles to the code it had before.
//
// What bounds them: bytes, (index + keep + rows read + rows written) /
// 3.35 TB/s, and for the coverage 4 bytes a written row more.  Add mode with heavy duplication is bound instead by the atomic
// throughput on the few hot addresses: LULESH-S3 (delta 0) sends every lane
// of the pattern into 16 rows, and those atomics serialise in L2.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;          // D = 1 in phase: 4-lane vectors a thread
constexpr int kElems = 8;         // otherwise: elements a thread (deep)

// D = 1 with keep, idx and vals in phase.  The flat lanes [0, total) are a
// head (< 4 lanes, up to keep's first 4-byte boundary), nv vectors of 4
// lanes and a tail (< 4).  Block k takes vectors [k, k + 1) * 256 * V4;
// thread t vectors k * 256 * V4 + j * 256 + t, j < V4, so each warp
// instruction reads 128 contiguous bytes of keep and 512 of idx and vals.
template <typename I, int V4, bool kCov>
__global__ void __launch_bounds__(kThreads)
store_d1_vec_kernel(float* __restrict__ dst, const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ keep,
                    const float* __restrict__ vals, int32_t* __restrict__ cov,
                    I total, I head, I nv, I V, FastDiv<I> by_n) {
  const I v0 = static_cast<I>(blockIdx.x) * (kThreads * V4) + threadIdx.x;
  const unsigned int* kv =
      reinterpret_cast<const unsigned int*>(keep + head);
  const int4* iv = reinterpret_cast<const int4*>(idx + head);
  const float4* xv = reinterpret_cast<const float4*>(vals + head);
  uint32_t kw[V4];                 // keep bytes of a vector's 4 lanes
  int4 r[V4];
  float4 x[V4];
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const I v = v0 + j * kThreads;
    kw[j] = v < nv ? __ldcs(kv + v) : 0u;
  }
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const I v = v0 + j * kThreads;
    r[j] = v < nv ? __ldcs(iv + v) : make_int4(-1, -1, -1, -1);
  }
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const I v = v0 + j * kThreads;
    if (v < nv) x[j] = __ldcs(xv + v);
  }
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    if (kw[j] == 0) continue;      // no lane kept (or past the last vector)
    const I l = head + (v0 + j * kThreads) * 4;
    const I b = by_n.div(l);
    const bool one = b == by_n.div(l + 3);       // all 4 lanes in pattern b
    float* const rows = dst + b * V;
    const uint32_t k0 = kw[j] & 0xff, k1 = (kw[j] >> 8) & 0xff,
                   k2 = (kw[j] >> 16) & 0xff, k3 = kw[j] >> 24;
    const int32_t q = r[j].x;
    if (one && k0 && k1 && k2 && k3 && in_table(q, V) &&
        in_table(r[j].w, V) && int64_t{r[j].y} - q == 1 &&
        int64_t{r[j].z} - q == 2 && int64_t{r[j].w} - q == 3 &&
        aligned16(rows + q)) {
      __stcs(reinterpret_cast<float4*>(rows + q), x[j]);
      if (kCov) {
        int32_t* const c = cov + b * V + q;
        if (aligned16(c)) {
          *reinterpret_cast<int4*>(c) = make_int4(1, 1, 1, 1);
        } else {
          c[0] = c[1] = c[2] = c[3] = 1;
        }
      }
    } else {
      auto put = [&](uint32_t k, int32_t row, float val, I lane) {
        if (k != 0 && in_table(row, V)) {
          const I base = (one ? b : by_n.div(lane)) * V;
          dst[base + row] = val;
          if (kCov) cov[base + row] = 1;
        }
      };
      put(k0, r[j].x, x[j].x, l);
      put(k1, r[j].y, x[j].y, l + 1);
      put(k2, r[j].z, x[j].z, l + 2);
      put(k3, r[j].w, x[j].w, l + 3);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) {      // head, then tail
    const I l = threadIdx.x < 4 ? static_cast<I>(threadIdx.x)
                                : head + nv * 4 + (threadIdx.x - 4);
    if (threadIdx.x < 4 ? l < head : l < total) {
      const int32_t row = idx[l];
      if (keep[l] && in_table(row, V)) {
        const I base = by_n.div(l) * V;
        dst[base + row] = vals[l];
        if (kCov) cov[base + row] = 1;
      }
    }
  }
}

// Any D and alignment: T is float4 (D % 4 == 0, dst and vals 16-byte
// aligned) or float; Dv = D in units of T.  Block k takes the flat elements
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
  if (x == 0.f) return;            // +-0.0 adds nothing (see the note)
  const int32_t row = __ldg(idx + lane);
  if (row < 0 || row >= V) return;
  atomicAdd(dst + (static_cast<int64_t>(b) * V + row) * D + d, x);
}

// keep, idx and vals in phase: where a lane's keep byte is 4-byte aligned,
// its idx and vals words are 16-byte aligned.
bool store_in_phase(const void* idx, const void* keep, const void* vals) {
  const uintptr_t i = reinterpret_cast<uintptr_t>(idx);
  const uintptr_t k = reinterpret_cast<uintptr_t>(keep);
  return in_phase(idx, vals) && (i & 3) == 0 && (((i >> 2) - k) & 3) == 0;
}

template <typename I, int V4, bool kCov>
void launch_d1_vec(float* dst, const int32_t* idx, const uint8_t* keep,
                   const float* vals, int32_t* cov, I total, I V,
                   FastDiv<I> by_n, cudaStream_t s) {
  const I mis = static_cast<I>(reinterpret_cast<uintptr_t>(keep) & 3);
  const I head = (4 - mis) % 4 < total ? (4 - mis) % 4 : total;
  const I nv = (total - head) / 4;
  const int64_t per_block = kThreads * V4;
  const int64_t blocks = (static_cast<int64_t>(nv) + per_block - 1) /
                         per_block;
  store_d1_vec_kernel<I, V4, kCov>
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

template <typename I, bool kCov>
int launch_store(void* dst, const int32_t* idx, const uint8_t* keep,
                 const void* vals, int32_t* cov, int64_t B, int64_t N,
                 int64_t V, int64_t D, int64_t vecs, cudaStream_t s) {
  const I total = static_cast<I>(B * N);
  bool deep = false;
  if (D == 1 && store_in_phase(idx, keep, vals)) {
    if (static_cast<int64_t>(total) / (4 * kThreads) > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const cudaError_t err =
        deep_for(vecs, static_cast<int64_t>(total) / 4, kVecs, &deep);
    if (err != cudaSuccess) return static_cast<int>(err);
    (deep ? &launch_d1_vec<I, kVecs, kCov> : &launch_d1_vec<I, 1, kCov>)(
        static_cast<float*>(dst), idx, keep, static_cast<const float*>(vals),
        cov, total, static_cast<I>(V), make_div(static_cast<I>(N)), s);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = D % 4 == 0 && aligned16(dst) && aligned16(vals);
  const I dv = static_cast<I>(vec ? D / 4 : D);
  const I elems = total * dv;
  if ((static_cast<int64_t>(elems) + kThreads - 1) / kThreads > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaError_t err = deep_for(vecs, elems, kElems, &deep);
  if (err != cudaSuccess) return static_cast<int>(err);
  const I v = static_cast<I>(V), n = static_cast<I>(N);
  if (vec) {
    (deep ? &launch_elems<float4, I, kElems, kCov>
          : &launch_elems<float4, I, 1, kCov>)(dst, idx, keep, vals, cov,
                                               elems, v, dv, n, s);
  } else {
    (deep ? &launch_elems<float, I, kElems, kCov>
          : &launch_elems<float, I, 1, kCov>)(dst, idx, keep, vals, cov,
                                              elems, v, dv, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kCov>
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
             ? launch_store<uint32_t, kCov>(dst, ix, kp, vals, cv, B, N, V, D,
                                            vecs, s)
             : launch_store<uint64_t, kCov>(dst, ix, kp, vals, cv, B, N, V, D,
                                            vecs, s);
}

}  // namespace

// All three return the cudaError_t of the launch (0 on success).  The
// stores' vecs: loads in flight a thread, 1, kVecs (4) or kElems (8; either
// deep value takes the deep instance of the path the operands take), or 0
// for the card rule (common.cuh card_threads).
extern "C" int scatter_store_rows_f32(void* dst, const void* idx,
                                      const void* keep, const void* vals,
                                      int64_t B, int64_t N, int64_t V,
                                      int64_t D, int64_t vecs, void* stream) {
  return store_entry<false>(dst, idx, keep, vals, nullptr, B, N, V, D, vecs,
                            stream);
}

// cov: (B, V) int32, zeroed by the caller; 1 where this call stored a row.
extern "C" int scatter_store_rows_cov_f32(void* dst, const void* idx,
                                          const void* keep, const void* vals,
                                          void* cov, int64_t B, int64_t N,
                                          int64_t V, int64_t D, int64_t vecs,
                                          void* stream) {
  return store_entry<true>(dst, idx, keep, vals, cov, B, N, V, D, vecs,
                           stream);
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
