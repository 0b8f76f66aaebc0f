// GQA flash attention, forward, for Hopper (sm_90a):
//   out[b, h, g, i] = softmax_j(mask(cap(q[b, h, g, i] . k[b, h, j] * scale)))
//                     . v[b, h, j]
//
// Both entries replace the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (flash_attention_fwd, body
// _flash_kernel).  Layouts as there, contiguous: q (B, KVH, G, S, DH), k and
// v (B, KVH, T, DH), out (B, KVH, G, S, DH), all float32
// (flash_attention_f32) or all bfloat16 (flash_attention_bf16).  The mask
// keeps key j for query i where (causal) j <= i and (window > 0) i - j <
// window; masked scores are -1e30 as there, and cap(x) = tanh(x / softcap)
// * softcap when softcap > 0.  m and l are float32; the output is divided by
// max(l, 1e-30) and rounded once.  Offsets are 64-bit.
//
// What changes from the TPU.  There the grid (B, KVH, S / bq, T / bk) runs
// in order and (m, l, acc) wait in VMEM scratch across the kv steps.  Here
// one CTA owns one (q tile, kv head, batch row) and loops over the key tiles
// itself, with m, l and its share of the output accumulator in registers.
// A CTA takes all G query heads of its KV head: its rows are G heads x
// (rows / G) positions, so every K/V tile in shared memory serves all of
// them; when G does not divide the rows, the last rows % G rows hold no
// query and are never stored.  Any S and T run: key positions >= T weigh
// 0, query rows >= S are not stored, with no block-multiple rule.  Key
// tiles that the mask empties for every row of the CTA are skipped (with
// causal, tiles past the last query; with a window, tiles wholly before q0
// - window): the function is unchanged and the causal work halves.  The
// causal CTAs with most tiles start first.  A query row that the window leaves no
// key (i >= T + window - 1) gets what the reference's -1e30 mask gives it:
// uniform weights over all T keys, so the mean of V.  A CTA that holds such
// rows sums V's columns once after its loop (mean_of_v) and stores the mean
// in those rows; every other CTA only tests for them.
//
// What bounds it: operations.  At the llama3-8b prefill (B 4, KVH 8, G 4,
// S = T = 2048, DH 128, bf16, causal) the two products are 2 x 2 x 4 x 32 x
// 2048^2 x 128 / 2 = 1.37e11 FLOP, 0.139 ms at the 989 TFLOP/s of dense
// bf16 tensor cores; q, k, v and out are 168 MB, 0.050 ms at 3.35 TB/s.
// For float32 the same shape's bound is the CUDA cores' 67 TFLOP/s of FMA,
// 2.05 ms.
//
// flash_attention_bf16: bf16 wgmma fed by a TMA ring (FlashAttention-3's
// shape, without its ping-pong of warpgroups or persistent CTAs).  A CTA is
// two consumer warpgroups (64 query rows each, 128 in all) and one producer
// warp; one CTA an SM (~165 registers a thread).  What it does about the
// three limits of the CUDA-core body it replaced:
//   1. Tensor cores.  S = Q K^T is wgmma m64n128k16 with Q and K both read
//      from shared memory (both K-major: dh is contiguous), DH / 16 k-steps.
//      P is rounded to bf16 in registers, where the f32 accumulator
//      fragment of S, packed in pairs, is the register-A fragment of
//      O += P V (wgmma m64nDHk16); V is B from shared memory, MN-major
//      (dh contiguous), through the transpose bit that 16-bit types allow.
//   2. Asynchronous loads.  The producer warp issues TMA copies
//      (cp.async.bulk.tensor) of Q and of a ring of kTcStages K/V tiles of
//      kTcBK keys, which complete on "full" mbarriers; each consumer warp
//      hands a stage back on its "empty" mbarrier once its products have
//      read it.  No thread widens or moves a K/V element, and the loop has
//      no __syncthreads.
//   3. bf16 in shared memory.  Tiles stay bf16, 128B-swizzled as TMA writes
//      them and wgmma reads them: at DH 128, 32 KB of Q and 2 x 64 KB of
//      K/V (160 KB).  The CTA holds 128 rows (G x 128 / G), so the 2048-key
//      causal row of the llama3-8b shape is 16 tile steps of 128 keys, not
//      64 of 32.
//   Softmax runs on the accumulator fragment in the log2 domain: scale and
//   log2(e) fold into one multiply, fused with subtracting the row max
//   (fmaf), then ex2.approx; masks per element only in a tile that the
//   diagonal, a window's edge or the ragged T edge cuts, where a masked
//   score is -inf (a row that has met no key yet keeps m = -inf, weight 0;
//   a row that sees a key meets it, so the result is the reference's -1e30
//   mask, and a row that sees none takes the mean of V); row max and sum reduced over the 4 lanes of a
//   quad; the rescale of O skipped when no row's maximum moved.  Rounding
//   each weight p to bf16 before P V moves the output by up to 2^-9 of
//   sum p|v| / sum p (l sums the float32 weights): chip_smoke.py's bound
//   for this kernel carries that term.
//   What it does not yet do, and where its time goes: within a warpgroup
//   the softmax waits for S and P V waits for the softmax; the two
//   warpgroups are not made to alternate (FlashAttention-3's ping-pong),
//   so they tend to multiply, and then exponentiate, at the same time.
// Where trouble hides (each checked against the plain version on the card,
// a single 64 x 64 tile first):
//   - TMA descriptors come from cuTensorMapEncodeTiled, which lives in
//     libcuda, and the library links no -lcuda: the runtime's entry-point
//     query hands it out, and the three maps are encoded on the host at
//     every call (pointers change) and passed as __grid_constant__
//     CUtensorMap.  A 128B swizzle caps a box's inner extent at 128 bytes,
//     so a DH 128 tile is two 64-column boxes.
//     Q is a 3-d box (64, rows / G, G) over (DH, S, B KVH G): it lands as
//     the G-stacked rows; K and V are 3-d boxes over (DH, T, B KVH), so
//     keys past T arrive as zeros, never as the next head's.
//   - wgmma descriptors: 128B swizzle (layout 1), 1024-byte 8-row groups
//     (SBO); a k16 step of a K-major operand advances the start address by
//     32 bytes inside the swizzled row; V's second 64-column box is the
//     MN-direction stride (LBO) of the transposed B.  Every box starts on a
//     1024-byte boundary, so the base offset is 0.
//   - Ordering: wgmma.fence before each batch of products (after the
//     softmax or the rescale wrote their registers), commit_group and
//     wait_group 0 before the registers are read, an empty asm on each
//     register so the compiler moves no access across them, and
//     fence.proxy.async before a stage goes back to the producer.  Keeping
//     the previous P V in flight across the next S made ptxas serialise
//     every wgmma; keeping Q in registers as S's A operand let ptxas reuse
//     those registers inside the loop (wrong results): both were dropped.
//   - Fragment layout: thread t of a consumer warpgroup holds rows
//     16 (t / 32) + (t % 32) / 4 and that + 8, columns 8 j + 2 (t % 4) + {0,
//     1}; a row r is head r / (128 / G), position q0 + r % (128 / G).
//   - Build time: two template instances (DH 64, 128), beside the float32
//     body's two.
//
// flash_attention_f32 keeps the CUDA-core body: each thread owns 4 rows x 4
// keys of a 64 x 32 score tile and 4 rows x DH/8 columns of the output; Q,
// K and P are staged transposed, so each step of either product reads two
// float4 from shared memory for 16 FMAs.  The tensor-core alternative is
// TF32, which keeps ~10 bits of the mantissa and would break the float32
// account of the tolerance the port holds it to; serving runs in bf16.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;

// -- float32: CUDA cores ------------------------------------------------------

constexpr int kThreads = 128;     // 16 row groups x 8 key/column groups
constexpr int kRows = 64;         // query rows per CTA: G heads x 64 / G
constexpr int kBK = 32;           // keys per tile
constexpr int kPtStride = kRows + 4;   // P^T rows, padded, 16-byte aligned

template <int DH>
struct Smem {
  float qt[DH][kRows];            // Q^T of the CTA's rows
  float kt[DH][kBK];              // K^T of the tile
  float v[kBK][DH];               // V of the tile
  float pt[kBK][kPtStride];       // P^T of the tile
};

__device__ __forceinline__ void load4(const float* __restrict__ p, float* x) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x;
  x[1] = r.y;
  x[2] = r.z;
  x[3] = r.w;
}

// mean[c] = the mean over the T keys of column c of one head's V (T, DH),
// for the CTA's threads tid = 0 .. threads - 1; the caller synchronises.
template <int DH, typename T>
__device__ void mean_of_v(const T* __restrict__ vb, int64_t T_len,
                          float* mean, int tid, int threads) {
  for (int c = tid; c < DH; c += threads) {
    float sum = 0.f;
    for (int64_t t = 0; t < T_len; ++t) {
      sum += static_cast<float>(vb[t * DH + c]);
    }
    mean[c] = sum / static_cast<float>(T_len);
  }
}

// Whether query position i sees no key: the window's first key, i - window
// + 1, lies past the last key, T - 1 (with or without causal).
__device__ __forceinline__ bool sees_no_key(int64_t i, int64_t T_len,
                                            int64_t window) {
  return window > 0 && i - window >= T_len - 1;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int kvh, int G, int64_t S, int64_t T_len, int bq,
                       float scale, int causal, int64_t window,
                       float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);
  constexpr int kChunks = DH / 4;               // 16-byte loads per row
  constexpr int kCols = DH / 32;                // float4 output columns
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int64_t q0 = (static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x) * bq;
  const int64_t q_last = (q0 + bq < S ? q0 + bq : S) - 1;
  const int rows = G * bq;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * kvh + blockIdx.y;
  const float* qb = q + bh * G * S * DH;  // q[b, h, g, s] at (g S + s) DH
  const float* kb = k + bh * T_len * DH;
  const float* vb = v + bh * T_len * DH;

  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c % kRows, dc = c / kRows;
    const int64_t pos = q0 + r % bq;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows && pos < S) load4(qb + ((r / bq) * S + pos) * DH + dc * 4, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) sm.qt[dc * 4 + i][r] = x[i];
  }

  int64_t qpos[4];
  float m[4], l[4], o[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q0 + (ty * 4 + i) % bq;
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * kCols; ++j) o[i][j] = 0.f;
  }

  int64_t k_begin = 0;
  if (window > 0) {
    k_begin = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
    k_begin -= k_begin % kBK;
  }
  const int64_t k_end = causal ? (T_len < q_last + 1 ? T_len : q_last + 1)
                               : T_len;
  for (int64_t k0 = k_begin; k0 < k_end; k0 += kBK) {
    // K^T: neighbouring threads take neighbouring keys (conflict-free stores)
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int kk = c % kBK, dc = c / kBK;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + kk < T_len) load4(kb + (k0 + kk) * DH + dc * 4, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) sm.kt[dc * 4 + i][kk] = x[i];
    }
    // V: neighbouring threads take neighbouring 16 bytes of a row
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int kk = c / kChunks, dc = c % kChunks;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + kk < T_len) {
        x = *reinterpret_cast<const float4*>(vb + (k0 + kk) * DH + dc * 4);
      }
      *reinterpret_cast<float4*>(&sm.v[kk][dc * 4]) = x;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.qt[d][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.kt[d][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kpos = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (kpos >= T_len) {
          x = -INFINITY;                  // past the keys: weight 0
        } else if ((causal && kpos > qpos[i]) ||
                   (window > 0 && qpos[i] - kpos >= window)) {
          x = kMasked;
        }
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      // the 8 threads of a row group are lanes differing in bits 0-2
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 4));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = exp2f((m[i] - m_new) * kLog2e);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f((s[i][j] - m_new) * kLog2e);
        rsum += p;
        sm.pt[tx * 4 + j][ty * 4 + i] = p;
      }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 4);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * kCols; ++j) o[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&sm.pt[kk][ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float4 w =
            *reinterpret_cast<const float4*>(&sm.v[kk][tx * 4 + 32 * cc]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][cc * 4 + 0] = fmaf(pv[i], w.x, o[i][cc * 4 + 0]);
          o[i][cc * 4 + 1] = fmaf(pv[i], w.y, o[i][cc * 4 + 1]);
          o[i][cc * 4 + 2] = fmaf(pv[i], w.z, o[i][cc * 4 + 2]);
          o[i][cc * 4 + 3] = fmaf(pv[i], w.w, o[i][cc * 4 + 3]);
        }
      }
    }
    __syncthreads();                 // the next tile overwrites kt, v, pt
  }

  // rows with no key: P^T is free after the loop's last __syncthreads
  const bool any_empty = sees_no_key(q_last, T_len, window);
  float* mean = &sm.pt[0][0];
  if (any_empty) {
    mean_of_v<DH>(vb, T_len, mean, tid, kThreads);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows || qpos[i] >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const bool empty = any_empty && sees_no_key(qpos[i], T_len, window);
    float* orow = out + ((bh * G + r / bq) * S + qpos[i]) * DH;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int c = tx * 4 + 32 * cc;
      *reinterpret_cast<float4*>(orow + c) =
          empty ? *reinterpret_cast<const float4*>(mean + c)
                : make_float4(o[i][cc * 4 + 0] / denom,
                              o[i][cc * 4 + 1] / denom,
                              o[i][cc * 4 + 2] / denom,
                              o[i][cc * 4 + 3] / denom);
    }
  }
}

template <int DH>
int launch_f32(const float* q, const float* k, const float* v, float* out,
               int64_t B, int64_t KVH, int64_t G, int64_t S, int64_t T_len,
               float scale, int causal, int64_t window, float softcap,
               cudaStream_t s) {
  const int bq = static_cast<int>(kRows / G);
  const int64_t n_qt = (S + bq - 1) / bq;
  if (n_qt > INT_MAX || KVH > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = sizeof(Smem<DH>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_qt), static_cast<unsigned>(KVH),
                  static_cast<unsigned>(B));
  flash_attention_kernel<DH><<<grid, kThreads, smem, s>>>(
      q, k, v, out, static_cast<int>(KVH), static_cast<int>(G), S, T_len, bq,
      scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// -- bfloat16: wgmma fed by a TMA ring ----------------------------------------

constexpr int kTcConsumers = 2;            // consumer warpgroups, 64 rows each
constexpr int kTcRows = 64 * kTcConsumers;
constexpr int kTcThreads = 128 * kTcConsumers + 32;   // + one producer warp
constexpr int kTcBK = 128;                 // keys per tile
constexpr int kTcStages = 2;               // K/V tiles in flight
constexpr int kSwizzleRow = 128;           // bytes of a 128B-swizzled row
constexpr int kBoxCols = kSwizzleRow / 2;  // bf16 columns per box

// Byte offsets in the (1024-aligned) dynamic shared memory.
template <int DH>
struct TcLayout {
  static constexpr int kBoxes = DH / kBoxCols;
  static constexpr int kQBox = kTcRows * kSwizzleRow;
  static constexpr int kKVBox = kTcBK * kSwizzleRow;
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kStage = 2 * kBoxes * kKVBox;    // K boxes, V boxes
  static constexpr int kBars = kQ + kTcStages * kStage;
  // Q's barrier, then kTcStages "full", then kTcStages "empty"; then the
  // mean of V (DH floats) for rows that see no key
  static constexpr int kMean = kBars + 8 * (1 + 2 * kTcStages);
  static constexpr int kBytes = kMean + 4 * DH + 1024;
};

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
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

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

// A shared-memory matrix descriptor for a 128B-swizzled operand: 8-row
// groups 1024 bytes apart (SBO); ``lbo`` is the stride between 64-column
// boxes of an MN-major operand (unused for K-major ones).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accesses of r across a wgmma boundary.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define ACC8(d, i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32(d) ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
#define ACC64(d) ACC32(d), ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
#define REGS32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define REGS64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128 f32) = (accumulate ? d : 0) + A B, A and B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N f32) += A B, A in registers (a[0..3]), B MN-major in shared
// memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x by the SFU alone (ex2.approx.ftz: relative error below 2^-22, no
// range fix-up; a result below 2^-126 flushes to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// score_mul = scale log2(e); with a softcap, x = tanh(s cap_in) cap_out
// with cap_in = scale / softcap and cap_out = softcap log2(e).  Scores live
// in the log2 domain: p = exp2(x - m).
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, int kvh, int G,
                          int S, int T_len, int bq, float score_mul,
                          float cap_in, float cap_out, int causal,
                          int window) {
  using L = TcLayout<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1024 B
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kTcStages;
  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int q_last = min(q0 + bq, S) - 1;
  const int used = G * bq;                        // rows that hold a query
  const int bh = blockIdx.z * kvh + blockIdx.y;
  int k_begin = 0;
  if (window > 0) {
    k_begin = max(q0 - window + 1, 0);
    k_begin -= k_begin % kTcBK;
  }
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;
  const int n_tiles = (k_end - k_begin + kTcBK - 1) / kTcBK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * kTcConsumers);   // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // rows used..kTcRows of Q take no copy: zero them (wgmma reads them)
  unsigned char* smem = smem_raw + (base - raw);
  const int zero_chunks = (kTcRows - used) * (kSwizzleRow / 16);
  for (int c = tid; c < L::kBoxes * zero_chunks; c += kTcThreads) {
    *reinterpret_cast<uint4*>(smem + (c / zero_chunks) * L::kQBox +
                              used * kSwizzleRow + (c % zero_chunks) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (tid >= 128 * kTcConsumers) {                // the producer warp
    if (tid == 128 * kTcConsumers) {
      mbar_expect_tx(bar_q, L::kBoxes * used * kSwizzleRow);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_3d(base + c * L::kQBox, &tm_q, bar_q, c * kBoxCols, q0,
                    bh * G);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kTcStages;
        const uint32_t stage = base + L::kQ + s * L::kStage;
        if (it >= kTcStages) {
          mbar_wait(bar_empty + 8 * s, ((it / kTcStages) & 1) ^ 1);
        }
        mbar_expect_tx(bar_full + 8 * s, L::kStage);
        const int k0 = k_begin + it * kTcBK;
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_3d(stage + c * L::kKVBox, &tm_k, bar_full + 8 * s,
                      c * kBoxCols, k0, bh);
          tma_load_3d(stage + (L::kBoxes + c) * L::kKVBox, &tm_v,
                      bar_full + 8 * s, c * kBoxCols, k0, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg holds rows 64 wg .. 64 wg + 63
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int quad = lane & 3;
  int row[2], qpos[2];
  row[0] = 64 * wg + 16 * warp + (lane >> 2);
  row[1] = row[0] + 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = q0 + row[i] % bq;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DH / 2];
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) o[j] = 0.f;
  const uint32_t q_wg = base + 64 * wg * kSwizzleRow;
  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kTcStages;
    const int k0 = k_begin + it * kTcBK;
    const uint32_t k_s = base + L::kQ + s * L::kStage;
    const uint32_t v_s = k_s + L::kBoxes * L::kKVBox;
    mbar_wait(bar_full + 8 * s, (it / kTcStages) & 1);
    __syncwarp();

    // S = Q K^T: DH / 16 k-steps, 32 bytes apart inside a swizzled row; the
    // first overwrites sc
    float sc[kTcBK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kQBox + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * L::kKVBox + (kk % 4) * 32;
      wgmma_ss(sc, sw128_desc(q_wg + off, 16), sw128_desc(k_s + koff, 16),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // sc[4 j + e]: row row[e / 2], key k0 + 8 j + 2 quad + e % 2
    const bool need_mask = k0 + kTcBK > T_len ||
                           (causal && k0 + kTcBK - 1 > q0) ||
                           (window > 0 && q0 + bq - 1 - k0 >= window);
    // scores in the log2 domain are u mul: u = s and mul = scale log2(e),
    // or, with a softcap, u = tanh(s cap_in) cap_out and mul = 1
    float mul = score_mul;
    if (cap_in > 0.f) {
#pragma unroll
      for (int j = 0; j < kTcBK / 2; ++j) {
        sc[j] = tanhf(sc[j] * cap_in) * cap_out;
      }
      mul = 1.f;
    }
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kTcBK / 2; ++j) {
        const int i = (j >> 1) & 1;
        const int kpos = k0 + (j >> 2) * 8 + 2 * quad + (j & 1);
        if (kpos >= T_len || (causal && kpos > qpos[i]) ||
            (window > 0 && qpos[i] - kpos >= window)) {
          sc[j] = -INFINITY;
        }
      }
    }
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTcBK / 2; ++j) {
      tmax[(j >> 1) & 1] = fmaxf(tmax[(j >> 1) & 1], sc[j]);
    }
    float corr[2], neg_m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i] * mul);
      // a row that has met no key yet keeps m = -inf: weight 0, corr 1
      const bool none = m_new == -INFINITY;
      corr[i] = none ? 1.f : fast_exp2(m[i] - m_new);
      neg_m[i] = none ? 0.f : -m_new;
      m[i] = m_new;
      l[i] *= corr[i];                  // this thread's share of the row sum
    }
    uint32_t pa[kTcBK / 4];             // P as kTcBK / 16 A fragments
#pragma unroll
    for (int j = 0; j < kTcBK / 2; j += 2) {
      const int i = (j >> 1) & 1;
      const float p0 = fast_exp2(fmaf(sc[j], mul, neg_m[i]));
      const float p1 = fast_exp2(fmaf(sc[j + 1], mul, neg_m[i]));
      l[i] += p0 + p1;
      pa[j / 2] = pack_bf16(p0, p1);
    }
    // once the row maxima settle, corr is 1: skip the rescale (warp-uniform)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) o[j] *= corr[(j >> 1) & 1];
    }

    // O += P V: kTcBK / 16 k-steps of 16 keys, 2048 bytes apart
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kTcBK / 16; ++kb) {
      wgmma_rs(o, pa + 4 * kb,
               sw128_desc(v_s + kb * 16 * kSwizzleRow, L::kKVBox));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // rows with no key: the consumer warpgroups (not the producer warp, which
  // has left) sum V once and meet at named barrier 1
  const bool any_empty = sees_no_key(q_last, T_len, window);
  const float* mean = reinterpret_cast<const float*>(smem + L::kMean);
  if (any_empty) {
    mean_of_v<DH>(v + static_cast<int64_t>(bh) * T_len * DH, T_len,
                  reinterpret_cast<float*>(smem + L::kMean), tid,
                  128 * kTcConsumers);
    asm volatile("bar.sync 1, %0;" :: "n"(128 * kTcConsumers) : "memory");
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int g = row[i] / bq;
    if (g >= G || qpos[i] >= S) continue;
    // times the reciprocal of max(l, 1e-30): within a float32 ulp of the
    // division, before the one rounding to bf16
    const float inv = __frcp_rn(fmaxf(l[i], 1e-30f));
    const bool empty = any_empty && sees_no_key(qpos[i], T_len, window);
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(bh) * G + g) * S + qpos[i]) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      *reinterpret_cast<__nv_bfloat162*>(orow + c) =
          empty ? __floats2bfloat162_rn(mean[c], mean[c + 1])
                : __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                        o[4 * j + 2 * i + 1] * inv);
    }
  }
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A bf16 tensor (d0 innermost, d1, d2), read in 128B-swizzled boxes of
// (64, b1, b2).
bool encode_3d(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* map,
               const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
               uint32_t b1, uint32_t b2) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};      // bytes
  const cuuint32_t box[3] = {kBoxCols, b1, b2};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int64_t B, int64_t KVH, int64_t G, int64_t S, int64_t T_len,
                float scale, int causal, int64_t window, float softcap,
                cudaStream_t s) {
  if (S > INT_MAX || T_len > INT_MAX || B * KVH * G > INT_MAX ||
      KVH > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int bq = static_cast<int>(kTcRows / G);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_3d(encode, &tm_q, q, DH, S, B * KVH * G, bq, G) ||
      !encode_3d(encode, &tm_k, k, DH, T_len, B * KVH, kTcBK, 1) ||
      !encode_3d(encode, &tm_v, v, DH, T_len, B * KVH, kTcBK, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = TcLayout<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + bq - 1) / bq),
                  static_cast<unsigned>(KVH), static_cast<unsigned>(B));
  const int win = window < INT_MAX ? static_cast<int>(window) : INT_MAX;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  flash_attention_tc_kernel<DH><<<grid, kTcThreads, smem, s>>>(
      tm_q, tm_k, tm_v, static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out),
      static_cast<int>(KVH), static_cast<int>(G), static_cast<int>(S),
      static_cast<int>(T_len), bq, scale * kLog2e, cap_in, softcap * kLog2e,
      causal, win);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int64_t G, int64_t T_len, int64_t window) {
  return G < 1 || G > kRows || T_len < 1 || window < 0;
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int64_t B, int64_t KVH,
                                   int64_t G, int64_t S, int64_t T,
                                   int64_t DH, float scale, int causal,
                                   int64_t window, float softcap,
                                   void* stream) {
  if (B <= 0 || KVH <= 0 || S <= 0) return 0;
  if (bad_args(G, T, window)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  float* to = static_cast<float*>(out);
  switch (DH) {
    case 64:
      return launch_f32<64>(tq, tk, tv, to, B, KVH, G, S, T, scale, causal,
                            window, softcap, s);
    case 128:
      return launch_f32<128>(tq, tk, tv, to, B, KVH, G, S, T, scale, causal,
                             window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int64_t B,
                                    int64_t KVH, int64_t G, int64_t S,
                                    int64_t T, int64_t DH, float scale,
                                    int causal, int64_t window, float softcap,
                                    void* stream) {
  if (B <= 0 || KVH <= 0 || S <= 0) return 0;
  if (bad_args(G, T, window)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 64:
      return launch_bf16<64>(q, k, v, out, B, KVH, G, S, T, scale, causal,
                             window, softcap, s);
    case 128:
      return launch_bf16<128>(q, k, v, out, B, KVH, G, S, T, scale, causal,
                              window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
