// GQA decode attention over a paged KV pool, for Hopper (sm_90a):
//   out[b, h, g] = softmax_t(q[b, h, g] . K[b, h, t] * scale) . V[b, h, t]
//   over t < lengths[b], where position t of row b lives in page
//   page_table[b, t / page] of the pool, at offset t % page.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode/kernel.py
// (paged_decode_kernel, body _decode_kernel).  Layouts as there, contiguous:
// q (B, KVH, G, DH); k_pages, v_pages (KVH, P, page, DH); page_table
// (B, pages_per_seq) int32; lengths (B,) int32; out (B, KVH, G, DH).  q, the
// pages and out are all float32 or all bfloat16; the arithmetic is float32
// and the output is rounded once, after dividing by max(l, 1e-30).  Any page
// size (pages_per_seq * page < 2^31); repeated pages in a table are fine
// (the pool is only read).  A table entry outside [0, P) is clamped into it,
// so that no index reads outside the pool (the plain version raises on one).
// lengths are clamped to [0, pages_per_seq * page].  A row of length 0 gets
// what the reference's -1e30 mask gives it: uniform weights over all
// pages_per_seq * page positions of its pages, so every query head the mean
// of their V rows.
//
// Two options, gemma2's, both uniform across a launch.  softcap > 0 caps
// each scaled score: x = tanh(s scale / softcap) softcap (tanhf, then
// log2(e) folded in, as flash_attention.cu does).  window > 0
// keeps only the positions t >= length - window of a row, the keys the
// JAX package's ring buffer of window slots holds after the write at
// position length - 1.  With a window a row's CTAs split not its
// pages_per_seq table entries but the span = ceil((window - 1) / page) + 1
// entries that window consecutive positions can touch, starting at the
// window's first page (moved back to pages_per_seq - span where the span
// would pass the table's end), and the first page's positions before the
// window are left out: the host sizes the split by the span, so at gemma2's
// decode (window 4096, page 16, 8224 positions) the local layers' CTAs read
// 257 pages a row, not 514.  A row of length 0 ignores the window (its
// splits cut all pages_per_seq entries, as without one).  A launch with
// either option runs an instance compiled with them (kOpts); one without
// runs an instance that has none of their code: in one set of instances
// the option code made the bf16 G = 4, DH = 128 instance spill (160 bytes)
// and llama3-8b's decode, which takes neither, 9% slower on an H100.
// G, the query heads per KV head, is 1, 2, 4, 8 or 16 at DH 64 and 128,
// 12 and 6 at DH 128 without the options (starcoder2-15b's 48 / 4,
// internvl2-26b's 48 / 8), and 16 at DH 256 (recurrentgemma-9b's MQA,
// launch_dh256: two groups of 8 heads, each its own CTAs over the same
// pages, in the one kOpts instance a dtype): Layout and reduce_dots pad a
// G that is no power of two to the next one (16 lanes' worth of dot sums
// for 12 heads, 8 for 6), and leave the others' code as it was.  G 8 at
// DH 112 (kimi-k2-1t-a32b's 64 / 8, launch_dh112; one instance a dtype,
// without the options) pads the columns the same way: 16
// lanes a position hold 8 columns each over kDP = 128, so the last two
// lanes (with zero q) load, add and keep nothing, and a stage holds the
// whole passes that fit (32 bf16 or 16 f32 positions), its copies in a
// loop whose last round is guarded (448 16-byte pieces over 128 threads).
//
// What bounds it: bytes.  At the llama3-8b decode (B 4, KVH 8, G 4, DH 128,
// page 16, 130 pages a row, length 2080, bf16) K and V are 4 x 8 x 2080 x
// 128 x 2 B x 2 = 34.1 MB: 10.2 us at 3.35 TB/s.  The scores and P V are
// ~136 MFLOP, far below the CUDA cores' rate, so the kernel has to keep
// every SM pulling bytes.  The TPU grid (B, KVH, pages_per_seq) walks one
// (row, head)'s pages in order with (m, l, acc) in VMEM scratch; here that
// order would leave B x KVH = 32 CTAs on 132 SMs.  Three things fix it:
//
//   * The split ("flash-decoding").  The grid is (splits x KVH, B): split s
//     of a (row, head) takes table entries [s pps / S, (s + 1) pps / S), so
//     every page lies in exactly one split.  The host picks S in closed form
//     (kernels/paged_decode/ops.py paged_splits: kCtasPerSm CTAs an SM in one
//     wave, 1 where B x KVH fills the card); at the shape above S = 12, 384
//     CTAs of 10-11 pages.  The host does not read the lengths: a split whose
//     pages all lie past the length copies nothing and reports an empty
//     partial (m = -1e30, l = 0, acc = 0).
//   * The ring.  For one head a page of K (or V) is one contiguous block, so
//     a stage of kStageBytes holds kRows consecutive positions of K and of V,
//     brought in by 16-byte cp.async copies (each thread finds its rows'
//     pages through the table; stage 0's entries, q and the length are read
//     at once) into kStages slots: kStages - 1 stages (32 KB) are in flight
//     while one is computed, about 96 KB an SM at kCtasPerSm CTAs, well past
//     the ~25 KB that 3.35 TB/s x ~1 us asks of an SM.  A thread owns one
//     position of a pass and kE = DH / kTpr columns of it, with q's matching
//     columns in registers: the kTpr lanes of a position read its K row in
//     consecutive 16-byte pieces (no bank conflicts), sum their dot products
//     by shuffles (reduce_dots), and fold the position into their own (l,
//     acc) with weights p = 2^(x - m).  m is one per warp and query head and
//     moves only when a score passes it by more than kSlack (a warp vote), so
//     acc is seldom rescaled.  scale * log2(e) is folded into the scores.
//   * The merge, in the same launch.  A CTA combines its slots' (m, l, acc)
//     through shared memory, four columns a thread.  With one split it
//     writes out; otherwise it writes its partial to the float32 workspace
//     and counts itself in on its (row, head)'s counter with an
//     acquire-release add; the CTA that arrives last reads the S partials
//     (through L2, all of one batch in flight at once), merges them,
//     divides, rounds once, writes out, and sets the counter back to 0, so
//     the next call on the stream finds it zero without a memset.  Empty
//     partials use m = -1e30, never -inf, so the merge never forms -inf -
//     (-inf); a row of length 0 counts every position of its pages with x =
//     -1e30 in every split (l = the split's positions, acc = their V sum),
//     and the same merge gives the reference's mean.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;               // ring slots
constexpr int kStageBytes = 16384;       // K and V rows of one slot
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kCtasPerSm = 3;            // registers (<= 168) and 3 x 48 KB
constexpr int kMaxSplits = 128;          // the merge's weights fit the ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;
// A warp's m moves only when a score passes it by more than this (log2
// units), so weights stay <= 2^kSlack and acc is rarely rescaled; the
// merge divides it out like any other m.
constexpr float kSlack = 8.f;

// The least power of two >= n (n >= 1).
__host__ __device__ constexpr int pow2_ceil(int n) {
  return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2);
}

// The thread layout of one (T, G, DH) instance.  kTpr lanes share a
// position (8, 16 or 32, so that G x kE <= 64 query values sit in
// registers; G x DH / 64 rounded up to a power of two, which a G that is
// not one, such as 12, needs for kE to divide DH); each holds kE of its
// columns, kVecE at a time.  kE is DH / kTpr rounded up to a power of two,
// so kTpr x kE = kDP columns are held; where kDP > DH (DH 112: 7 -> 8
// columns, 128 in all) the pieces at or past DH belong to no column, and a
// lane skips them (kPadded).  A stage holds the whole passes that fit, and
// where its 16-byte pieces do not divide over the threads the copy loop's
// last round is guarded (kCopyTail).
template <typename T, int G, int DH>
struct Layout {
  static constexpr int kTprWant = pow2_ceil(G * DH / 64);
  static constexpr int kTpr = kTprWant < 8 ? 8 : (kTprWant > 32 ? 32 : kTprWant);
  static constexpr int kE = pow2_ceil((DH + kTpr - 1) / kTpr);
  static constexpr int kDP = kE * kTpr;
  static constexpr bool kPadded = kDP != DH;
  static constexpr int kVecE = kE * static_cast<int>(sizeof(T)) < 16
                                   ? kE : 16 / static_cast<int>(sizeof(T));
  static constexpr int kLoads = kE / kVecE;
  static constexpr int kSlots = kThreads / kTpr;      // positions a pass
  static constexpr int kRowBytes = DH * static_cast<int>(sizeof(T));
  static constexpr int kRows =                        // a stage
      kStageBytes / (2 * kRowBytes) / kSlots * kSlots;
  static constexpr int kPasses = kRows / kSlots;
  static constexpr int kChunks = kRowBytes / 16;      // 16-byte pieces a row
  static constexpr int kCopies =                      // K (and V)
      (kRows * kChunks + kThreads - 1) / kThreads;
  static constexpr bool kCopyTail = kCopies * kThreads != kRows * kChunks;
  static_assert(kLoads * kVecE == kE && DH % kVecE == 0 && DH <= kDP,
                "columns");
  static_assert(kPasses >= 1 && kChunks * 16 == kRowBytes, "passes");
  // the slots' acc, l and the warps' m, then reused by the merge
  static_assert((kSlots * G * (DH + 1) + kWarps * G) * 4 <= kSmemBytes,
                "combine scratch");
  static_assert(3 * kMaxSplits * G * 4 + G * 4 <= kSmemBytes, "merge scratch");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int BYTES> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };

// N elements of T from p (aligned to their size together) as float32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float* out) {
  using V = typename Vec<N * sizeof(T)>::type;
  const V raw = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; -inf and -1e30 give 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}


__device__ __forceinline__ void fma4(float4& o, float f, const float4& x) {
  o.x = fmaf(x.x, f, o.x);
  o.y = fmaf(x.y, f, o.y);
  o.z = fmaf(x.z, f, o.z);
  o.w = fmaf(x.w, f, o.w);
}

// o / den, rounded once, to four consecutive outputs
__device__ __forceinline__ void store4(float* p, float4 o, float den) {
  *reinterpret_cast<float4*>(p) =
      make_float4(o.x / den, o.y / den, o.z / den, o.w / den);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 o,
                                       float den) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(o.x / den, o.y / den);
  __nv_bfloat162 hi = __floats2bfloat162_rn(o.z / den, o.w / den);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// atom.add with acquire-release order at GPU scope: the CTA's writes (seen
// by this thread through a barrier) land before the count, and this
// thread's later reads see what the other CTAs wrote before theirs.
__device__ __forceinline__ unsigned atomic_add_acq_rel(unsigned* p,
                                                       unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// No "memory" clobber: the copy is ordered by the wait and barrier that
// follow it, so the compiler may hoist the table reads of later copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The kTpr lanes of a position hold partial dots x[G] over their columns;
// leave the whole dots in every one of them.  The heads are padded with
// zero dots to GP, the least power of two >= G (GP = G where G is one).
// The first log2(GP) xor steps halve the sums a lane keeps (it sends the
// other half), the rest add its one sum over the remaining lanes, so lane
// sl holds head sl / (kTpr / GP); then each real head's sum is read from
// its lane: GP - 1 + log2(kTpr / GP) + G shuffles where a butterfly per
// head takes G log2(kTpr) (at G 12 and kTpr 32: 28, not 60).
template <int G, int kTpr>
__device__ __forceinline__ void reduce_dots(float (&x)[G], int lane, int sl) {
  constexpr int GP = pow2_ceil(G);
  static_assert(GP <= kTpr, "a lane a padded head");
  float v[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) v[g] = g < G ? x[g] : 0.f;
#pragma unroll
  for (int k = 0; (GP >> k) > 1; ++k) {
    const int off = kTpr >> (k + 1), half = GP >> (k + 1);
    const bool low = (sl & off) == 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = low ? v[half + j] : v[j];
      const float keep = low ? v[j] : v[half + j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (int off = kTpr / GP / 2; off > 0; off >>= 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  }
  const int base = lane & ~(kTpr - 1);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    x[g] = __shfl_sync(0xffffffffu, v[0], base + g * (kTpr / GP));
  }
}

template <typename T, int G, int DH, bool kOpts>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ ws, unsigned* __restrict__ counters,
                    int kvh, int hg, int64_t P, int page,
                    FastDiv<uint32_t> page_div, int pps, int splits,
                    float scale_log2, float cap_in, float cap_out, int window,
                    int span) {
  using L = Layout<T, G, DH>;
  constexpr int kTpr = L::kTpr, kE = L::kE, kVecE = L::kVecE;
  constexpr int kRows = L::kRows, kSlots = L::kSlots;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = tid / kTpr, sl = tid % kTpr;
  // h: the head (a group of G query heads; kvh = KV heads x hg groups)
  const int split = static_cast<int>(blockIdx.x % splits);
  const int h = static_cast<int>(blockIdx.x / splits);
  const int64_t b = blockIdx.y;
  const int64_t bh = b * kvh + h;

  const int cap = pps * page;
  auto clamp_len = [&](int v) { return v < 0 ? 0 : (v > cap ? cap : v); };
  // the row's split range: span table entries from e0 (all pps from 0
  // without a window), positions from w_lo on.  With a window the range
  // needs the length; without one its load is left until after stage 0's
  // table entries and q are on their way, as it always was.
  int len = 0, e0 = 0, w_lo = 0, n_span = pps;
  if (kOpts && window > 0) {
    len = clamp_len(lengths[b]);
    if (len > 0) {
      w_lo = max(0, len - window);
      n_span = span;
      e0 = min(static_cast<int>(page_div.div(static_cast<uint32_t>(w_lo))),
               pps - span);
    }
  }
  // this split's positions [t_lo, t_top): its pages, past the window's
  // start; then [t_lo, t_end), up to the length (all of them for a row of
  // length 0)
  const int p_lo = e0 + static_cast<int>(int64_t{split} * n_span / splits);
  const int p_hi =
      e0 + static_cast<int>(int64_t{split + 1} * n_span / splits);
  const int t_lo = max(p_lo * page, w_lo), t_top = p_hi * page;
  const int* trow = page_table + b * pps;
  // the table entries of stage st's rows that this thread copies (the
  // split's last page stands in for rows past it)
  auto lookup = [&](int st, int (&pi)[L::kCopies], int (&phys)[L::kCopies]) {
#pragma unroll
    for (int i = 0; i < L::kCopies; ++i) {
      const int t = t_lo + st * kRows + (tid + i * kThreads) / L::kChunks;
      pi[i] = static_cast<int>(
          page_div.div(static_cast<uint32_t>(t < t_top ? t : t_top - 1)));
      phys[i] = __ldg(trow + pi[i]);
    }
  };
  // read at once: stage 0's table entries, q's columns and the length
  int pi[L::kCopies], phys[L::kCopies];
  lookup(0, pi, phys);
  float qr[G][kE];                 // q's columns of this thread
  const T* qb = q + bh * G * DH;
  // whether piece j of this lane's columns lies inside the head (always,
  // unless the columns are padded)
  auto live = [&](int j) {
    return !L::kPadded || (j * kTpr + sl) * kVecE < DH;
  };
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < L::kLoads; ++j) {
      if (live(j)) {
        load_f32<T, kVecE>(qb + g * DH + (j * kTpr + sl) * kVecE,
                           &qr[g][j * kVecE]);
      } else {
#pragma unroll
        for (int i = 0; i < kVecE; ++i) qr[g][j * kVecE + i] = 0.f;
      }
    }
  }
  if (!kOpts || window == 0) len = clamp_len(lengths[b]);
  const bool zero = len == 0;
  const int t_end = min(t_top, zero ? cap : len);

  float m[G], l[G], acc[G][kE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kMasked;                // the warp's running max (log2 domain)
    l[g] = 0.f;                    // this slot's sum of weights
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
  }

  if (t_end > t_lo) {
    const int64_t head = static_cast<int64_t>(h / hg) * P * page * DH;
    const T* kh = k_pages + head;
    const T* vh = v_pages + head;
    T* ring = reinterpret_cast<T*>(smem);
    const int n_stages = (t_end - t_lo + kRows - 1) / kRows;

    // stage st's rows of K (none for a row of length 0) and V into its
    // slot: this thread's kCopies 16-byte pieces of each, through the
    // table entries pi, phys that lookup(st) read
    auto copy_stage = [&](int st) {
      T* ks = ring + (st % kStages) * (2 * kRows * DH);
      T* vs = ks + kRows * DH;
#pragma unroll
      for (int i = 0; i < L::kCopies; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / L::kChunks, col = c % L::kChunks;
        const int t = t_lo + st * kRows + r;
        if (t < t_end && (!L::kCopyTail || c < kRows * L::kChunks)) {
          const int64_t pg = phys[i] < 0 ? 0 : (phys[i] >= P ? P - 1 : phys[i]);
          const int64_t src = (pg * page + (t - pi[i] * page)) * DH +
                              col * (16 / sizeof(T));
          const int dst = r * DH + col * static_cast<int>(16 / sizeof(T));
          if (!zero) cp_async16(ks + dst, kh + src);
          cp_async16(vs + dst, vh + src);
        }
      }
    };

    copy_stage(0);
    cp_async_commit();
#pragma unroll
    for (int st = 1; st < kStages - 1; ++st) {
      if (st < n_stages) {
        lookup(st, pi, phys);
        copy_stage(st);
      }
      cp_async_commit();
    }
    for (int st = 0; st < n_stages; ++st) {
      cp_async_wait<kStages - 2>();    // this thread's copies of stage st
      __syncthreads();                 // everyone's; slot st - 1 is free
      if (st + kStages - 1 < n_stages) {
        lookup(st + kStages - 1, pi, phys);
        copy_stage(st + kStages - 1);
      }
      cp_async_commit();
      const T* ks = ring + (st % kStages) * (2 * kRows * DH);
      const T* vs = ks + kRows * DH;
#pragma unroll
      for (int pass = 0; pass < L::kPasses; ++pass) {
        const int r = pass * kSlots + slot;
        const bool valid = t_lo + st * kRows + r < t_end;
        float x[G];
#pragma unroll
        for (int g = 0; g < G; ++g) x[g] = 0.f;
        if (valid && !zero) {
#pragma unroll
          for (int j = 0; j < L::kLoads; ++j) {
            if (!live(j)) continue;
            float kx[kVecE];
            load_f32<T, kVecE>(ks + r * DH + (j * kTpr + sl) * kVecE, kx);
#pragma unroll
            for (int g = 0; g < G; ++g) {
#pragma unroll
              for (int i = 0; i < kVecE; ++i) {
                x[g] = fmaf(qr[g][j * kVecE + i], kx[i], x[g]);
              }
            }
          }
        }
        reduce_dots<G, kTpr>(x, lane, sl);
        if (kOpts && cap_in > 0.f) {   // uniform: a softcapped launch
#pragma unroll
          for (int g = 0; g < G; ++g) x[g] = tanhf(x[g] * cap_in) * cap_out;
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) x[g] *= scale_log2;
        }
        bool over = false;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          x[g] = !valid ? -INFINITY : (zero ? kMasked : x[g]);
          over |= x[g] > m[g] + kSlack;
        }
        if (__any_sync(0xffffffffu, over)) {   // rare once m has settled
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float mx = x[g];
#pragma unroll
            for (int off = kTpr; off < 32; off <<= 1) {
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            }
            const float m_new = fmaxf(m[g], mx);
            const float corr = ex2(m[g] - m_new);
            m[g] = m_new;
            l[g] *= corr;
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[g][e] *= corr;
          }
        }
        float p[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          p[g] = ex2(x[g] - m[g]);
          l[g] += p[g];
        }
        if (valid) {
#pragma unroll
          for (int j = 0; j < L::kLoads; ++j) {
            if (!live(j)) continue;
            float vx[kVecE];
            load_f32<T, kVecE>(vs + r * DH + (j * kTpr + sl) * kVecE, vx);
#pragma unroll
            for (int g = 0; g < G; ++g) {
#pragma unroll
              for (int i = 0; i < kVecE; ++i) {
                acc[g][j * kVecE + i] =
                    fmaf(p[g], vx[i], acc[g][j * kVecE + i]);
              }
            }
          }
        }
      }
    }
    cp_async_wait<0>();                // only empty groups remain
  }

  // combine the slots: red (kSlots, G, DH) acc, red_l (kSlots, G) l,
  // red_m (kWarps, G) m, in the ring's space
  float* red = reinterpret_cast<float*>(smem);
  float* red_l = red + kSlots * G * DH;
  float* red_m = red_l + kSlots * G;
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < L::kLoads; ++j) {
      if (!live(j)) continue;
#pragma unroll
      for (int i = 0; i < kVecE; ++i) {
        red[(slot * G + g) * DH + (j * kTpr + sl) * kVecE + i] =
            acc[g][j * kVecE + i];
      }
    }
    if (sl == 0) red_l[slot * G + g] = l[g];
    if (lane == 0) red_m[warp * G + g] = m[g];
  }
  __syncthreads();
  constexpr int kSlotsPerWarp = 32 / kTpr;
  // the workspace: every split's acc (B KVH, splits, G, DH), then its (m, l)
  // (B KVH, splits, G, 2)
  const int64_t ml_base = int64_t{gridDim.y} * kvh * splits * G * DH;
  const int64_t part = bh * splits + split;
  T* ob = out + bh * G * DH;
  // four consecutive columns a thread
  for (int v = tid; v < G * DH / 4; v += kThreads) {
    const int g = 4 * v / DH, d = 4 * v % DH;
    float mm = kMasked, f[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red_m[w * G + g]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) f[w] = ex2(red_m[w * G + g] - mm);
    float ls = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const float fs = f[s / kSlotsPerWarp];
      ls = fmaf(red_l[s * G + g], fs, ls);
      fma4(o, fs, *reinterpret_cast<const float4*>(&red[(s * G + g) * DH + d]));
    }
    if (splits == 1) {
      store4(ob + 4 * v, o, fmaxf(ls, 1e-30f));
    } else {
      reinterpret_cast<float4*>(ws + part * G * DH)[v] = o;
      if (d == 0) {
        ws[ml_base + (part * G + g) * 2] = mm;
        ws[ml_base + (part * G + g) * 2 + 1] = ls;
      }
    }
  }
  if (splits == 1) return;

  // count this split in; the last one merges.  Thread 0's acquire-release
  // add orders the CTA's partial (seen through the barrier) before its
  // count, and the count before the merge's reads of the other partials.
  __syncthreads();
  if (tid == 0) {
    s_last = atomic_add_acq_rel(counters + bh, 1u) ==
             static_cast<unsigned>(splits - 1);
  }
  __syncthreads();
  if (!s_last) return;
  // the merge: this thread's kV4 groups of four outputs of (G, DH), the
  // partials' acc of kBatch splits at a time in registers (one batch at the
  // shape above), the first batch's loads in flight while the weights are
  // worked out
  constexpr int kV4 = (G * DH / 4 + kThreads - 1) / kThreads;
  constexpr int kBatch = kV4 >= 16 ? 1 : 16 / kV4;
  float* wm = reinterpret_cast<float*>(smem);    // (splits, G): m
  float* wl = wm + splits * G;                    // (splits, G): l
  float* wgt = wl + splits * G;                   // (splits, G): weight
  float* lsum = wgt + splits * G;                 // (G,)
  const float4* part_acc =
      reinterpret_cast<const float4*>(ws + bh * splits * G * DH);
  const float* part_ml = ws + ml_base + bh * splits * G * 2;
  float4 a[kBatch][kV4];
  auto load_batch = [&](int s0) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
#pragma unroll
      for (int k = 0; k < kV4; ++k) {
        const int v = tid + k * kThreads;
        a[u][k] = s0 + u < splits && v < G * DH / 4
                      ? __ldcg(part_acc + (s0 + u) * (G * DH / 4) + v)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  load_batch(0);
  for (int i = tid; i < splits * G; i += kThreads) {
    wm[i] = __ldcg(part_ml + 2 * i);
    wl[i] = __ldcg(part_ml + 2 * i + 1);
  }
  __syncthreads();
  // each (split, head) its weight 2^(m - M), M the head's max over splits
  for (int i = tid; i < splits * G; i += kThreads) {
    float mm = kMasked;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) mm = fmaxf(mm, wm[s * G + i % G]);
    wgt[i] = ex2(wm[i] - mm);
  }
  __syncthreads();
  if (tid < G) {
    float ls = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      ls = fmaf(wl[s * G + tid], wgt[s * G + tid], ls);
    }
    lsum[tid] = ls;
  }
  __syncthreads();
  float4 o[kV4];
#pragma unroll
  for (int k = 0; k < kV4; ++k) o[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0;;) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (s0 + u < splits) {
#pragma unroll
        for (int k = 0; k < kV4; ++k) {
          const int v = tid + k * kThreads;
          fma4(o[k], wgt[(s0 + u) * G + (v < G * DH / 4 ? 4 * v / DH : 0)],
               a[u][k]);
        }
      }
    }
    s0 += kBatch;
    if (s0 >= splits) break;
    load_batch(s0);
  }
#pragma unroll
  for (int k = 0; k < kV4; ++k) {
    const int v = tid + k * kThreads;
    if (v < G * DH / 4) {
      store4(ob + 4 * v, o[k], fmaxf(lsum[4 * v / DH], 1e-30f));
    }
  }
  if (tid == 0) counters[bh] = 0u;     // every split is in: ready for the next call
}

// Dynamic shared memory of 48 KB beside the static (past the default) and
// the carveout that lets kCtasPerSm CTAs share an SM, set once per device
// for each instance.
template <typename T, int G, int DH, bool kOpts>
cudaError_t configure() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(paged_decode_kernel<T, G, DH, kOpts>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(paged_decode_kernel<T, G, DH, kOpts>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* table;
  const int* lengths;
  void* out;
  float* ws;
  unsigned* counters;
  int64_t B, KVH, P, page, pps, splits;
  float scale, softcap;
  int64_t window;
  cudaStream_t stream;
};

// The table entries a row's CTAs split: pps, or with a window the pages
// that window consecutive positions can touch (kernels/paged_decode/ref.py
// window_pages).
int64_t span_of(const Args& a) {
  if (a.window <= 0) return a.pps;
  const int64_t n = (a.window - 1 + a.page - 1) / a.page + 1;
  return n < a.pps ? n : a.pps;
}

// hg: groups of G query heads a KV head (the launch's heads per KV head
// over G), each its own CTAs, workspace and counter.
template <typename T, int G, int DH, bool kOpts>
int launch_instance(const Args& a, int hg = 1) {
  const cudaError_t err = configure<T, G, DH, kOpts>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.splits * a.KVH * hg),
                  static_cast<unsigned>(a.B));
  paged_decode_kernel<T, G, DH, kOpts>
      <<<grid, kThreads, kSmemBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.table, a.lengths, static_cast<T*>(a.out),
      a.ws, a.counters, static_cast<int>(a.KVH * hg), static_cast<int>(hg),
      a.P, static_cast<int>(a.page),
      make_div32(static_cast<uint32_t>(a.page)),
      static_cast<int>(a.pps), static_cast<int>(a.splits), a.scale * kLog2e,
      a.softcap > 0.f ? a.scale / a.softcap : 0.f, a.softcap * kLog2e,
      static_cast<int>(a.window), static_cast<int>(span_of(a)));
  return static_cast<int>(cudaGetLastError());
}

// An instance with the options (kOpts) serves a launch that takes a softcap
// or a window; one without them, whose code has neither, every other.
template <typename T, int G>
int launch_g(const Args& a, int64_t DH) {
  const bool opts = a.softcap > 0.f || a.window > 0;
  switch (DH) {
    case 64: return opts ? launch_instance<T, G, 64, true>(a)
                         : launch_instance<T, G, 64, false>(a);
    case 128: return opts ? launch_instance<T, G, 128, true>(a)
                          : launch_instance<T, G, 128, false>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// G 12 (starcoder2-15b's 48 query heads over 4 KV heads) and G 6
// (internvl2-26b's 48 over 8) have one instance a type each, at DH 128
// without the options: the one a served config launches (the wrapper
// refuses the others before it gets here).  Neither is a power of two:
// Layout rounds G x DH / 64 up (G 6: 16 lanes a position, 8 columns each)
// and reduce_dots pads the heads to 8 or 16.
template <typename T, int G>
int launch_dh128_only(const Args& a, int64_t DH) {
  if (DH != 128 || a.softcap > 0.f || a.window > 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_instance<T, G, 128, false>(a);
}

// DH 256 (recurrentgemma-9b's G 16) has one instance a dtype, with the
// options, which serves launches without them too: Layout<T, 16, 256>
// would hold 128 q and 128 acc floats a thread and 65,792 bytes of combine
// scratch, so the 16 heads run as 2 groups of 8 (64 + 64 floats, 32,896
// bytes), each group's CTAs reading the same pages.
template <typename T>
int launch_dh256(const Args& a, int64_t G) {
  if (G != 16) return static_cast<int>(cudaErrorInvalidValue);
  return launch_instance<T, 8, 256, true>(a, 2);
}

// DH 112 (kimi-k2-1t-a32b's G 8) has one instance a dtype, without the
// options: the one a served config launches.
template <typename T>
int launch_dh112(const Args& a, int64_t G) {
  if (G != 8 || a.softcap > 0.f || a.window > 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_instance<T, 8, 112, false>(a);
}

template <typename T>
int launch(const Args& a, int64_t G, int64_t DH) {
  if (a.B <= 0 || a.KVH <= 0) return 0;
  if (a.P < 1 || a.page < 1 || a.pps < 1 || a.pps * a.page > INT_MAX ||
      a.B > 65535 || a.splits < 1 || a.splits > span_of(a) ||
      a.window < 0 || a.window > INT_MAX || !(a.softcap >= 0.f) ||
      a.splits > kMaxSplits || a.splits * a.KVH > INT_MAX ||
      (a.splits > 1 && (a.ws == nullptr || a.counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (DH == 256) return launch_dh256<T>(a, G);
  if (DH == 112) return launch_dh112<T>(a, G);
  switch (G) {
    case 1: return launch_g<T, 1>(a, DH);
    case 2: return launch_g<T, 2>(a, DH);
    case 4: return launch_g<T, 4>(a, DH);
    case 6: return launch_dh128_only<T, 6>(a, DH);
    case 8: return launch_g<T, 8>(a, DH);
    case 12: return launch_dh128_only<T, 12>(a, DH);
    case 16: return launch_g<T, 16>(a, DH);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success).  softcap and
// window are 0 when off; splits lies in [1, min(span, 128)], span the
// table entries a row's window touches (pages_per_seq without one).
// workspace holds B * KVH * splits * G * (DH + 2) floats and counters B *
// KVH * groups zeros, groups 2 at DH 256 and 1 elsewhere (both unused, and
// may be null, when splits is 1); the kernel leaves the counters zero, and
// calls that share them must be ordered (one stream).
extern "C" int paged_decode_f32(const void* q, const void* k_pages,
                                const void* v_pages, const void* page_table,
                                const void* lengths, void* out,
                                void* workspace, void* counters, int64_t B,
                                int64_t KVH, int64_t G, int64_t P,
                                int64_t page, int64_t pps, int64_t DH,
                                int64_t splits, float scale, float softcap,
                                int64_t window, void* stream) {
  const Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
               static_cast<const int*>(lengths), out,
               static_cast<float*>(workspace),
               static_cast<unsigned*>(counters), B, KVH, P, page, pps,
               splits, scale, softcap, window,
               static_cast<cudaStream_t>(stream)};
  return launch<float>(a, G, DH);
}

extern "C" int paged_decode_bf16(const void* q, const void* k_pages,
                                 const void* v_pages, const void* page_table,
                                 const void* lengths, void* out,
                                 void* workspace, void* counters, int64_t B,
                                 int64_t KVH, int64_t G, int64_t P,
                                 int64_t page, int64_t pps, int64_t DH,
                                 int64_t splits, float scale, float softcap,
                                 int64_t window, void* stream) {
  const Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
               static_cast<const int*>(lengths), out,
               static_cast<float*>(workspace),
               static_cast<unsigned*>(counters), B, KVH, P, page, pps,
               splits, scale, softcap, window,
               static_cast<cudaStream_t>(stream)};
  return launch<__nv_bfloat16>(a, G, DH);
}
