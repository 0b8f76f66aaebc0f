// GQA flash attention, forward and backward, for Hopper (sm_90a):
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
// Given an lse pointer, each body's instance with kLse (built at DH 64, 128
// and 256 only, for training; the template flag leaves the serve instances'
// code as it was) also writes every query row's log-sum-exp of its masked,
// scaled scores, in natural units, float32, (B, KVH, G, S): the row max
// plus the log of the row sum, which the backward (the last section of
// this file) needs.
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
//      kBK keys, which complete on "full" mbarriers; each consumer warp
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
//   - Build time: four template instances (DH 64, 112, 128, 256), beside
//     the float32 body's four.
//   DH 256 (recurrentgemma-9b: MQA, G 16, so a CTA holds 8 positions of
//   the 16 heads).  A tile is 64 keys (TcLayout::kBK), not 128: 64 KB of Q
//   and 2 x 64 KB of K/V stages, ~194 KB in all.  S = Q K^T is wgmma
//   m64n64k16 over 16 k-steps; O += P V is m64n256k16 over the four
//   64-column boxes of V, at the uniform stride (LBO) of one box, 4 k-steps
//   a tile.  O is 128 floats a thread, so registers (at most 224 a thread
//   at 288 threads, one CTA an SM) are what this instance risks: the
//   build prints ptxas's count and spills.
//   DH 112 (kimi-k2-1t-a32b: GQA, G 8).  The tile stays DH 128's: the
//   tensor maps' inner dimension is 112 (224-byte rows, a multiple of 16
//   bytes), so TMA fills columns 112-127 of the second 64-column box with
//   zeros, and expect_tx counts the whole box, as for keys past T.  S = Q
//   K^T takes DH / 16 = 7 k-steps (the zero columns would add nothing);
//   O += P V runs at the padded width kDP = 128 (m64n128k16, V's two
//   boxes), its columns 112-127 stay 0 and are never stored, and the
//   rescale, the epilogue and mean_of_v touch only the 112 real ones.  A
//   native m64n112k16 P V would do 14% fewer products (not tried).
//
// flash_attention_f32 keeps the CUDA-core body: each thread owns 4 rows x 4
// keys of a 64 x 32 score tile and 4 rows x DH/8 columns of the output; Q,
// K and P are staged transposed, so each step of either product reads two
// float4 from shared memory for 16 FMAs.  At DH 112 (no multiple of 32)
// the eight column groups hold 4 float4 columns each over 128, and those
// at or past DH (the last column of groups 4-7) are neither computed nor
// stored.  The tensor-core alternative is
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

template <int DH, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int kvh, int G, int64_t S,
                       int64_t T_len, int bq, float scale, int causal,
                       int64_t window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);
  static_assert(DH % 16 == 0, "DH: whole 16-column pieces");
  constexpr int kChunks = DH / 4;               // 16-byte loads per row
  constexpr int kCols = (DH + 31) / 32;         // float4 output columns
  constexpr bool kRagged = DH % 32 != 0;        // the last one partly past DH
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
        if (kRagged && cc == kCols - 1 && tx * 4 + 32 * cc >= DH) continue;
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
    if (kLse && tx == 0) {
      lse[(bh * G + r / bq) * S + qpos[i]] =
          empty ? kMasked : m[i] + logf(l[i]);
    }
    float* orow = out + ((bh * G + r / bq) * S + qpos[i]) * DH;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int c = tx * 4 + 32 * cc;
      if (kRagged && cc == kCols - 1 && c >= DH) continue;
      *reinterpret_cast<float4*>(orow + c) =
          empty ? *reinterpret_cast<const float4*>(mean + c)
                : make_float4(o[i][cc * 4 + 0] / denom,
                              o[i][cc * 4 + 1] / denom,
                              o[i][cc * 4 + 2] / denom,
                              o[i][cc * 4 + 3] / denom);
    }
  }
}

template <int DH, bool kLse = false>
int launch_f32(const float* q, const float* k, const float* v, float* out,
               float* lse, int64_t B, int64_t KVH, int64_t G, int64_t S,
               int64_t T_len, float scale, int causal, int64_t window,
               float softcap, cudaStream_t s) {
  const int bq = static_cast<int>(kRows / G);
  const int64_t n_qt = (S + bq - 1) / bq;
  if (n_qt > INT_MAX || KVH > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = sizeof(Smem<DH>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DH, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_qt), static_cast<unsigned>(KVH),
                  static_cast<unsigned>(B));
  flash_attention_kernel<DH, kLse><<<grid, kThreads, smem, s>>>(
      q, k, v, out, lse, static_cast<int>(KVH), static_cast<int>(G), S,
      T_len, bq, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// -- bfloat16: wgmma fed by a TMA ring ----------------------------------------

constexpr int kTcConsumers = 2;            // consumer warpgroups, 64 rows each
constexpr int kTcRows = 64 * kTcConsumers;
constexpr int kTcThreads = 128 * kTcConsumers + 32;   // + one producer warp
constexpr int kTcStages = 2;               // K/V tiles in flight
constexpr int kSwizzleRow = 128;           // bytes of a 128B-swizzled row
constexpr int kBoxCols = kSwizzleRow / 2;  // bf16 columns per box

// Keys a tile, and byte offsets in the (1024-aligned) dynamic shared
// memory.  128 keys a tile at DH 64, 112 and 128; 64 at DH 256, where 128
// would need 64 KB of Q and 2 x 128 KB of K/V stages, past the 227 KB a
// block may take (64 keys: 64 + 2 x 64 KB).  A row is kBoxes 64-column
// boxes, the last zero-filled past DH (DH 112: two boxes, 128 columns).
template <int DH>
struct TcLayout {
  static_assert(DH % 16 == 0 && DH <= 256,
                "DH: whole k16 steps, at most the widest wgmma");
  static constexpr int kBK = DH > 128 ? 64 : 128;
  static constexpr int kBoxes = (DH + kBoxCols - 1) / kBoxCols;
  static constexpr int kDP = kBoxes * kBoxCols;   // P V's (padded) width
  static constexpr int kQBox = kTcRows * kSwizzleRow;
  static constexpr int kKVBox = kBK * kSwizzleRow;
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
#define ACC128(d)                                                       \
  ACC64(d), ACC8(d, 64), ACC8(d, 72), ACC8(d, 80), ACC8(d, 88),          \
      ACC8(d, 96), ACC8(d, 104), ACC8(d, 112), ACC8(d, 120)
#define REGS64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

#define REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

// d (64 x N f32) = (accumulate ? d : 0) + A B, A and B K-major in shared
// memory: N 64 (a 64-key tile, DH 256) or 128.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
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
// memory (the transpose bit): N = kDP, 64, 128 or 256 (the widest wgmma
// takes).
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
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REGS128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : ACC128(d)
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
template <int DH, bool kLse>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int kvh, int G,
                          int S, int T_len, int bq, float score_mul,
                          float cap_in, float cap_out, int causal,
                          int window) {
  using L = TcLayout<DH>;
  constexpr int kBK = L::kBK;
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
    k_begin -= k_begin % kBK;
  }
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

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
        const int k0 = k_begin + it * kBK;
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
  float o[L::kDP / 2];             // columns past DH stay 0
#pragma unroll
  for (int j = 0; j < L::kDP / 2; ++j) o[j] = 0.f;
  const uint32_t q_wg = base + 64 * wg * kSwizzleRow;
  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kTcStages;
    const int k0 = k_begin + it * kBK;
    const uint32_t k_s = base + L::kQ + s * L::kStage;
    const uint32_t v_s = k_s + L::kBoxes * L::kKVBox;
    mbar_wait(bar_full + 8 * s, (it / kTcStages) & 1);
    __syncwarp();

    // S = Q K^T: DH / 16 k-steps, 32 bytes apart inside a swizzled row (at
    // DH 112 the second box's zero columns are not multiplied); the first
    // overwrites sc
    float sc[kBK / 2];
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
    const bool need_mask = k0 + kBK > T_len ||
                           (causal && k0 + kBK - 1 > q0) ||
                           (window > 0 && q0 + bq - 1 - k0 >= window);
    // scores in the log2 domain are u mul: u = s and mul = scale log2(e),
    // or, with a softcap, u = tanh(s cap_in) cap_out and mul = 1
    float mul = score_mul;
    if (cap_in > 0.f) {
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) {
        sc[j] = tanhf(sc[j] * cap_in) * cap_out;
      }
      mul = 1.f;
    }
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) {
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
    for (int j = 0; j < kBK / 2; ++j) {
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
    uint32_t pa[kBK / 4];               // P as kBK / 16 A fragments
#pragma unroll
    for (int j = 0; j < kBK / 2; j += 2) {
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

    // O += P V: kBK / 16 k-steps of 16 keys, 2048 bytes apart
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kBK / 16; ++kb) {
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
    if (kLse && quad == 0) {       // m is in log2 units: back to natural
      lse[(static_cast<int64_t>(bh) * G + g) * S + qpos[i]] =
          empty || m[i] == -INFINITY ? kMasked
                                     : (m[i] + log2f(l[i])) / kLog2e;
    }
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

template <int DH, bool kLse = false>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int64_t B, int64_t KVH, int64_t G, int64_t S,
                int64_t T_len, float scale, int causal, int64_t window,
                float softcap, cudaStream_t s) {
  if (S > INT_MAX || T_len > INT_MAX || B * KVH * G > INT_MAX ||
      KVH > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int bq = static_cast<int>(kTcRows / G);
  constexpr int bk = TcLayout<DH>::kBK;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_3d(encode, &tm_q, q, DH, S, B * KVH * G, bq, G) ||
      !encode_3d(encode, &tm_k, k, DH, T_len, B * KVH, bk, 1) ||
      !encode_3d(encode, &tm_v, v, DH, T_len, B * KVH, bk, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = TcLayout<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<DH, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + bq - 1) / bq),
                  static_cast<unsigned>(KVH), static_cast<unsigned>(B));
  const int win = window < INT_MAX ? static_cast<int>(window) : INT_MAX;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  flash_attention_tc_kernel<DH, kLse><<<grid, kTcThreads, smem, s>>>(
      tm_q, tm_k, tm_v, static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse,
      static_cast<int>(KVH), static_cast<int>(G), static_cast<int>(S),
      static_cast<int>(T_len), bq, scale * kLog2e, cap_in, softcap * kLog2e,
      causal, win);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int64_t G, int64_t T_len, int64_t window) {
  return G < 1 || G > kRows || T_len < 1 || window < 0;
}

// -- backward: dQ, dK, dV ----------------------------------------------------
//
// Replaces no TPU kernel: the JAX package's custom_vjp (_bwd in
// src/repro/kernels/flash_attention/ops.py) recomputes its backward
// through the reference.  FlashAttention-2's equations, from q, k, v, out,
// dout and the forward's row log-sum-exp lse (natural units of the scaled
// score): D = rowsum(dout out), P = exp(scale S - lse) (0 where masked),
// dP = dO V^T, dS = P (dP - D); dV = P^T dO, dK = scale dS^T Q, dQ = scale
// dS K.  Built at DH 64, 128 and 256 (bfloat16 at 256: window, no softcap).
// With a softcap c the scores are capped,
// s = tanh(x scale / c) c, P is formed from them, and the chain rule through
// the cap multiplies dS by 1 - (s / c)^2 before dQ and dK take it.  With a
// window, keys with i - j >= window are masked as in the forward, and the
// loops skip the tiles that the window empties.  A query row that the window
// leaves no key (i >= T + window - 1, only where S > T) took the mean of V
// in the forward, as the reference's -1e30 scores give it: those scores are
// constants, so such a row adds dO / T to every key's dV and nothing to dQ
// or dK; the passes that sum dV add it once after their loops
// (keyless_dv), and P = 0 there inside them (its lse is -1e30, so exp(s -
// lse) would be 1: the mask, not the formula, decides).  The plain,
// windowed and softcapped variants are template instances (kExt for the
// CUDA-core passes; kCap, kWin for the wgmma pass), so the plain instances'
// code is the same as without the options.
//
// What bounds it: operations.  The function is five products of the
// forward's size (Q K^T, dO V^T, P^T dO, dS^T Q, dS K: 2.5 x the forward's
// two); at the llama3-8b training shape (B 4, KVH 8, G 4, S = T = 4096, DH
// 128, causal) 1.4e12 FLOP, 1.39 ms on bf16 tensor cores.
//
// float32, on the CUDA cores, in three launches on the caller's stream:
//   1. flash_attention_bwd_delta: D[row] = sum_d dout[row, d] out[row, d]
//      in float32, one warp a row.
//   2. flash_attention_bwd_dkdv: one CTA a tile of kBwdKeys keys of one
//      (batch row, KV head), K and V held in shared memory as float32, dK
//      and dV summed in registers.  It walks the G query heads that share
//      the KV head and, for each, the query tiles that can see its keys
//      (with causal, the tiles from its first key on): S, P, dP, dS; dV +=
//      P^T dO, dK += dS^T Q.  Every dK and dV element is summed by one
//      thread, over G too, so there are no atomics and the sums do not
//      depend on timing.
//   3. flash_attention_bwd_dq: one CTA a tile of kBwdRows query rows of one
//      head: the same S, P, dP and dS over the key tiles the rows see,
//      then dQ += dS K.
// dQ and dK take the scale at the end; all three are rounded once to the
// inputs' type.  Tiles are float32 in shared memory and each product runs
// as float32 FMAs from it (a thread 4 x 4 scores from 16 float4 loads a
// 4-column step; 4 keys x 8 columns of dK and dV from 8 scalar and 4
// float4 loads a query row), seven products in all (pass 3 recomputes Q
// K^T and dO V^T), so the CUDA cores' 67 TFLOP/s and shared memory's
// bandwidth bound it.  At DH 256 a tile is 32 rows and 32 keys (BwdTile).
// bfloat16 runs one wgmma pass instead: at DH 64 and 128 split by keys, at
// DH 256 by products (their own sections below).

constexpr int kBwdThreads = 256;     // 16 x 16 threads
constexpr int kBwdRows = 64;         // query rows a tile (DH <= 128)
constexpr int kBwdKeys = 64;         // keys a tile (DH <= 128)
constexpr int kBwdPad = 4;           // floats after each row of a tile

// A tile's query rows and keys: 64 of each up to DH 128; at DH 256 four
// float32 tiles of 64 rows would be 266 KB, so 32 of each (146 KB), each
// thread of the 16 x 16 then taking 2 rows (keys) where it took 4.
template <int DH>
struct BwdTile {
  static constexpr int kRows = DH > 128 ? 32 : kBwdRows;
  static constexpr int kKeys = DH > 128 ? 32 : kBwdKeys;
  static constexpr int kJ = kRows / 16;         // a thread's rows, keys
  static constexpr int kPStride = kKeys + 16;   // P / dS rows: no conflicts
};

template <int DH>
struct BwdSmem {
  static constexpr int kRows = BwdTile<DH>::kRows;
  static constexpr int kKeys = BwdTile<DH>::kKeys;
  float a[kRows][DH + kBwdPad];        // Q of the tile's rows
  float b[kRows][DH + kBwdPad];        // dO of the tile's rows
  float k[kKeys][DH + kBwdPad];        // K of the key tile
  float v[kKeys][DH + kBwdPad];        // V of the key tile
  float p[kRows][BwdTile<DH>::kPStride];    // P (pass 2)
  float ds[kRows][BwdTile<DH>::kPStride];   // dS
  float lse[kRows];
  float d[kRows];
};

__device__ __forceinline__ void load4_f32(const float* p, float* x) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x;
  x[1] = r.y;
  x[2] = r.z;
  x[3] = r.w;
}
__device__ __forceinline__ void load4_f32(const __nv_bfloat16* p, float* x) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&r.y));
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = hi.x;
  x[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// rows row0 .. row0 + BwdTile<DH>::kRows - 1 of a (n_rows, DH) matrix into a
// float32 tile; rows past n_rows are zeros
template <int DH, typename T>
__device__ void load_tile(float (*dst)[DH + kBwdPad], const T* src,
                          int64_t row0, int64_t n_rows, int tid) {
  for (int c = tid; c < BwdTile<DH>::kRows * (DH / 4); c += kBwdThreads) {
    const int r = c / (DH / 4), c4 = (c % (DH / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n_rows) load4_f32(src + (row0 + r) * DH + c4, x);
    store4(&dst[r][c4], x);
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// The mask and the softcap of a backward instance: with kExt a window (> 0:
// keys with i - j < window) and a softcap (> 0: cap_in = scale / softcap,
// cap_out = softcap log2(e)), read at run time; without, neither.
struct BwdOpts {
  int64_t window;
  float cap_in, cap_out;
};

// dS (and, with kStoreP, P) of the tile's rows q0.. against keys k0.. into
// shared memory, from a, b, k, v, lse and d already there.  Thread (ty, tx)
// takes rows ty + 16 i and keys tx + 16 j (neighbouring threads on
// neighbouring rows of k and v: conflict-free float4 loads).  With a
// softcap, P = exp2(tanh(s cap_in) cap_out - lse log2(e)) and dS takes the
// cap's derivative, 1 - tanh^2, before it is stored.
template <int DH, bool kStoreP, bool kExt>
__device__ void tile_ds(BwdSmem<DH>& sm, int64_t q0, int64_t k0, int64_t S,
                        int64_t T_len, float score_mul, int causal,
                        const BwdOpts& opt, int tid) {
  constexpr int kJ = BwdTile<DH>::kJ;
  const int ty = tid >> 4, tx = tid & 15;
  float s[kJ][kJ], dp[kJ][kJ];
#pragma unroll
  for (int i = 0; i < kJ; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 qa[kJ], oa[kJ];
#pragma unroll
    for (int i = 0; i < kJ; ++i) {
      qa[i] = *reinterpret_cast<const float4*>(&sm.a[ty + 16 * i][d]);
      oa[i] = *reinterpret_cast<const float4*>(&sm.b[ty + 16 * i][d]);
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float4 kb = *reinterpret_cast<const float4*>(&sm.k[tx + 16 * j][d]);
      const float4 vb = *reinterpret_cast<const float4*>(&sm.v[tx + 16 * j][d]);
#pragma unroll
      for (int i = 0; i < kJ; ++i) {
        s[i][j] += dot4(qa[i], kb);
        dp[i][j] += dot4(oa[i], vb);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kJ; ++i) {
    const int r = ty + 16 * i;
    const int64_t qpos = q0 + r;
    const float lse2 = sm.lse[r] * kLog2e, dr = sm.d[r];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int c = tx + 16 * j;
      const int64_t kpos = k0 + c;
      bool keep = qpos < S && kpos < T_len && (!causal || kpos <= qpos);
      float x = fmaf(s[i][j], score_mul, -lse2), fac = 1.f;
      if (kExt) {
        keep = keep && (opt.window <= 0 || qpos - kpos < opt.window);
        if (opt.cap_in > 0.f) {
          const float t = tanhf(s[i][j] * opt.cap_in);
          x = fmaf(t, opt.cap_out, -lse2);
          fac = 1.f - t * t;
        }
      }
      const float p = keep ? exp2f(x) : 0.f;
      if (kStoreP) sm.p[r][c] = p;
      sm.ds[r][c] = p * (dp[i][j] - dr) * fac;
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kBwdThreads)
flash_attention_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
          float* __restrict__ delta, float* __restrict__ zero,
          int64_t n_rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kBwdThreads / 32) +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  float acc = 0.f;
  for (int c = lane * 4; c < DH; c += 128) {
    float o[4], g[4];
    load4_f32(out + row * DH + c, o);
    load4_f32(dout + row * DH + c, g);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc = fmaf(o[e], g[e], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) delta[row] = acc;
  if (zero != nullptr) {                   // the row of a float32 workspace
    for (int c = lane * 4; c < DH; c += 128) {
      *reinterpret_cast<float4*>(zero + row * DH + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Whether some query row of S sees no key of T under the window (rows from
// T + window - 1 on): the reference gives such a row P = 1 / T over every
// key (its -1e30 scores are constants), so dV += dO / T, dQ and dK nothing.
__host__ __device__ __forceinline__ bool has_keyless_rows(int64_t S,
                                                          int64_t T_len,
                                                          int64_t window) {
  return window > 0 && S - 1 >= T_len + window - 1;
}

// sum[c] = the sum over the G heads of one (batch row, KV head) and over
// the rows that see no key of dout's column c, over T (the dV that every
// key gets from those rows); the caller synchronises
template <int DH, typename T>
__device__ void keyless_dv(const T* __restrict__ dout, int64_t head0, int G,
                           int64_t S, int64_t T_len, int64_t window,
                           float* sum, int tid, int threads) {
  for (int c = tid; c < DH; c += threads) {
    float acc = 0.f;
    for (int g = 0; g < G; ++g) {
      const T* rows = dout + (head0 + g) * S * DH;
      for (int64_t i = T_len + window - 1; i < S; ++i) {
        acc += static_cast<float>(rows[i * DH + c]);
      }
    }
    sum[c] = acc / static_cast<float>(T_len);
  }
}

// grid (key tiles, KVH, B)
template <typename T, int DH, bool kExt>
__global__ void __launch_bounds__(kBwdThreads)
flash_attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dk, T* __restrict__ dv, int kvh, int G, int64_t S,
         int64_t T_len, float scale, float score_mul, int causal,
         BwdOpts opt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<DH>& sm = *reinterpret_cast<BwdSmem<DH>*>(smem_raw);
  constexpr int kC = DH / 64;                 // float4 column groups a thread
  constexpr int kJ = BwdTile<DH>::kJ, kRows = BwdTile<DH>::kRows;
  constexpr int kKeys = BwdTile<DH>::kKeys;
  const int tid = threadIdx.x;
  const int ky = tid >> 4, dx = tid & 15;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kKeys;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * kvh + blockIdx.y;
  load_tile<DH>(sm.k, k + bh * T_len * DH, k0, T_len, tid);
  load_tile<DH>(sm.v, v + bh * T_len * DH, k0, T_len, tid);
  float acc_k[kJ][4 * kC], acc_v[kJ][4 * kC];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4 * kC; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
  // with causal, query tiles before the key tile see none of its keys; with
  // a window, rows past its last key + window - 1 none either
  const int64_t q_begin = causal ? k0 - k0 % kRows : 0;
  int64_t q_end = S;
  if (kExt && opt.window > 0) {
    const int64_t k_hi = (k0 + kKeys < T_len ? k0 + kKeys : T_len) - 1;
    q_end = k_hi + opt.window < S ? k_hi + opt.window : S;
  }
  for (int g = 0; g < G; ++g) {
    const int64_t head = bh * G + g;          // rows of q, dout, lse, delta
    for (int64_t q0 = q_begin; q0 < q_end; q0 += kRows) {
      __syncthreads();                        // the last tile's readers
      load_tile<DH>(sm.a, q + head * S * DH, q0, S, tid);
      load_tile<DH>(sm.b, dout + head * S * DH, q0, S, tid);
      if (tid < kRows) {
        const bool in = q0 + tid < S;
        sm.lse[tid] = in ? lse[head * S + q0 + tid] : 0.f;
        sm.d[tid] = in ? delta[head * S + q0 + tid] : 0.f;
      }
      __syncthreads();
      tile_ds<DH, true, kExt>(sm, q0, k0, S, T_len, score_mul, causal, opt,
                              tid);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys ky + 16 j, columns dx 4 + 64 c
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) {
        float pj[kJ], sj[kJ];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          pj[j] = sm.p[r][ky + 16 * j];
          sj[j] = sm.ds[r][ky + 16 * j];
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float4 o4 =
              *reinterpret_cast<const float4*>(&sm.b[r][dx * 4 + 64 * c]);
          const float4 q4 =
              *reinterpret_cast<const float4*>(&sm.a[r][dx * 4 + 64 * c]);
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            acc_v[j][4 * c + 0] = fmaf(pj[j], o4.x, acc_v[j][4 * c + 0]);
            acc_v[j][4 * c + 1] = fmaf(pj[j], o4.y, acc_v[j][4 * c + 1]);
            acc_v[j][4 * c + 2] = fmaf(pj[j], o4.z, acc_v[j][4 * c + 2]);
            acc_v[j][4 * c + 3] = fmaf(pj[j], o4.w, acc_v[j][4 * c + 3]);
            acc_k[j][4 * c + 0] = fmaf(sj[j], q4.x, acc_k[j][4 * c + 0]);
            acc_k[j][4 * c + 1] = fmaf(sj[j], q4.y, acc_k[j][4 * c + 1]);
            acc_k[j][4 * c + 2] = fmaf(sj[j], q4.z, acc_k[j][4 * c + 2]);
            acc_k[j][4 * c + 3] = fmaf(sj[j], q4.w, acc_k[j][4 * c + 3]);
          }
        }
      }
    }
  }
  if (kExt && has_keyless_rows(S, T_len, opt.window)) {
    __syncthreads();                          // the last tile's readers
    float* sum = &sm.p[0][0];                 // P is free: DH floats
    keyless_dv<DH>(dout, bh * G, G, S, T_len, opt.window, sum, tid,
                   kBwdThreads);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc_v[j][4 * c + e] += sum[dx * 4 + 64 * c + e];
        }
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int64_t kpos = k0 + ky + 16 * j;
    if (kpos >= T_len) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float xk[4], xv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xk[e] = acc_k[j][4 * c + e] * scale;
        xv[e] = acc_v[j][4 * c + e];
      }
      const int64_t off = (bh * T_len + kpos) * DH + dx * 4 + 64 * c;
      store4(dk + off, xk);
      store4(dv + off, xv);
    }
  }
}

// grid (query tiles, KVH G, B)
template <typename T, int DH, bool kExt>
__global__ void __launch_bounds__(kBwdThreads)
flash_attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       T* __restrict__ dq, int kvh, int G, int64_t S, int64_t T_len,
       float scale, float score_mul, int causal, BwdOpts opt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<DH>& sm = *reinterpret_cast<BwdSmem<DH>*>(smem_raw);
  constexpr int kC = DH / 64;
  constexpr int kJ = BwdTile<DH>::kJ, kRows = BwdTile<DH>::kRows;
  constexpr int kKeys = BwdTile<DH>::kKeys;
  const int tid = threadIdx.x;
  const int qy = tid >> 4, dx = tid & 15;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t head = static_cast<int64_t>(blockIdx.z) * kvh * G +
                       blockIdx.y;            // (b, h, g) of the query rows
  const int64_t bh = head / G;
  load_tile<DH>(sm.a, q + head * S * DH, q0, S, tid);
  load_tile<DH>(sm.b, dout + head * S * DH, q0, S, tid);
  if (tid < kRows) {
    const bool in = q0 + tid < S;
    sm.lse[tid] = in ? lse[head * S + q0 + tid] : 0.f;
    sm.d[tid] = in ? delta[head * S + q0 + tid] : 0.f;
  }
  float acc[kJ][4 * kC];
#pragma unroll
  for (int i = 0; i < kJ; ++i)
#pragma unroll
    for (int e = 0; e < 4 * kC; ++e) acc[i][e] = 0.f;
  const int64_t q_last = (q0 + kRows < S ? q0 + kRows : S) - 1;
  const int64_t k_end = causal ? (T_len < q_last + 1 ? T_len : q_last + 1)
                               : T_len;
  // with a window, key tiles wholly before q0 - window + 1 are seen by no row
  int64_t k_begin = 0;
  if (kExt && opt.window > 0) {
    k_begin = q0 - opt.window + 1 > 0 ? q0 - opt.window + 1 : 0;
    k_begin -= k_begin % kKeys;
  }
  for (int64_t k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();                          // the last tile's readers
    load_tile<DH>(sm.k, k + bh * T_len * DH, k0, T_len, tid);
    load_tile<DH>(sm.v, v + bh * T_len * DH, k0, T_len, tid);
    __syncthreads();
    tile_ds<DH, false, kExt>(sm, q0, k0, S, T_len, score_mul, causal, opt,
                             tid);
    __syncthreads();
    // dQ += dS K: rows qy + 16 i, columns dx 4 + 64 c
#pragma unroll 4
    for (int c2 = 0; c2 < kKeys; ++c2) {
      float si[kJ];
#pragma unroll
      for (int i = 0; i < kJ; ++i) si[i] = sm.ds[qy + 16 * i][c2];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float4 k4 =
            *reinterpret_cast<const float4*>(&sm.k[c2][dx * 4 + 64 * c]);
#pragma unroll
        for (int i = 0; i < kJ; ++i) {
          acc[i][4 * c + 0] = fmaf(si[i], k4.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(si[i], k4.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(si[i], k4.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(si[i], k4.w, acc[i][4 * c + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kJ; ++i) {
    const int64_t qpos = q0 + qy + 16 * i;
    if (qpos >= S) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = acc[i][4 * c + e] * scale;
      store4(dq + (head * S + qpos) * DH + dx * 4 + 64 * c, x);
    }
  }
}

// -- backward, bfloat16: one wgmma pass fed by TMA ---------------------------
//
// FlashAttention-3's backward (Shah et al., 2024, section 3 and appendix B),
// cut to DH 64 and 128 (DH 256: the next section), in three launches
// (described at DH 128):
//   1. flash_attention_bwd_delta (above): D, and zeros in dq_acc, a float32
//      workspace of dQ (B, KVH, G, S, 128) that the wrapper allocates.
//   2. flash_attention_bwd_wgmma: one CTA a tile of kBwdKeysTc = 128 keys of
//      one (batch row, KV head), two warpgroups of 64 keys each.  The CTA
//      walks the G query heads that share the KV head and the query tiles of
//      kBwdRowsTc = 64 rows that can see its keys (with causal, from the tile
//      that holds its first key on), and sums dK and dV over all of them in
//      registers, with no atomics.  Each warpgroup, over its 64 keys and a
//      step's 64 rows:
//        S^T = K Q^T, then dP^T = V dO^T  (wgmma m64n64k16, A and B K-major
//                                          in shared memory, 8 k-steps each,
//                                          two commit groups: P^T is formed
//                                          while dP^T is in flight);
//        P^T = exp2(S^T scale log2(e) - lse log2(e)), masked only in a tile
//        that the diagonal or the ragged T edge cuts, and dS^T = P^T (dP^T
//        - D), in the accumulator registers; each rounded to bf16 once;
//        dS^T to shared memory (128B-swizzled, a row a key), then, after
//        named barrier 1 over both warpgroups, one commit group of
//          dV += P^T dO   (wgmma m64n128k16: P^T packed from the
//                          accumulator as the register A, dO as MN-major B
//                          through the transpose bit, as the forward's P V),
//          dK += dS^T Q   (m64n128k16: the warpgroup's rows of dS^T as
//                          K-major A, Q as MN-major B),
//          dQ = dS K      (m64n64k16 over the 128 keys of both warpgroups,
//                          for the warpgroup's 64 of dQ's 128 columns: A
//                          and B both MN-major);
//        dQ's 64 x 64 float32 block to shared memory, 128B-swizzled, and one
//        thread of the warpgroup adds it into dq_acc by two TMA reduce-adds
//        (cp.reduce.async.bulk.tensor, boxes of 32 columns x 64 rows over
//        (128, S, B KVH G): rows past S are dropped); it waits for their
//        reads of the block one step later, before the block is written
//        again (named barriers 2 and 3).
//      Five products, none recomputed.  Warp 0 copies K and V once and keeps
//      a ring of kBwdStages (Q, dO) tiles: Q and dO by TMA (the forward's
//      encode_3d maps, 3-d boxes over (DH, S, B KVH G), so rows past S
//      arrive as zeros; K and V over (DH, T, B KVH)), the step's 64 rows of
//      lse and D by cp.async (float32 rows of S are 16-byte aligned only
//      where S % 4 == 0, so not by TMA; rows past S zero-filled), all on the
//      stage's "full" mbarrier (33 arrivals: the expect_tx and the warp's 32
//      lanes' cp.async).  A stage is refilled once all eight warps have
//      arrived on its "empty" mbarrier.  A row past S has Q = dO = lse = D =
//      0, so it adds nothing to dK or dV, and its dQ is dropped.
//   3. flash_attention_bwd_dq_round: dq = bf16(dq_acc scale).
// Order: the CTAs of one (batch row, KV head) are consecutive, and every CTA
// walks the query tiles from the last down, the G heads inner, so the CTAs
// that run together read the same Q and dO tiles and add into the same dQ
// rows at about the same time: both stay in L2 (at the llama3-8b training
// shape each CTA reads 32 KB of Q and dO a step and adds 32 KB of dQ, 4.4
// GB each in all).  Shared memory: K and V 64 KB, two (Q, dO) stages 64
// KB, two dS^T tiles 32 KB (dS^T alternates between them, so a warpgroup
// that runs ahead never overwrites the tile the other still multiplies),
// dQ's two blocks 32 KB, the rows' lse and D: ~194 KB, one CTA an SM.
// Registers: a thread holds dK and dV (64 + 64 floats), S^T and dP^T (32 +
// 32), P^T packed (16 words) and dQ's block (32, in S^T's registers),
// within the 255 registers that 256 threads allow, with no spill (the
// build prints ptxas's count).
// Where it leaves FlashAttention-3's split, each choice measured on the
// card (probes/flash_bwd_probe.py): no producer warpgroup and no
// setmaxnreg: at 384 threads ptxas allocated the consumers no more than
// ~208 registers whatever setmaxnreg asked, spilled ~520 bytes and
// serialised every wgmma (8.0 ms at the training shape); dK's A is dS^T
// from shared memory, not registers (16 registers fewer); dQ is added by
// TMA reduce-adds of whole tiles, not by red.global.add.v2.f32 from
// registers (those reductions took 4.4 of the 8.0 ms); a third stage did
// not help; nor did freeing the two warpgroups of each other (each its own
// keys' share of dQ, no barrier 1).
// Ordering as the forward's: wgmma.fence before each batch, wait_group
// before the registers are read, fence_regs, fence.proxy.async after
// generic stores that the async proxy (wgmma, TMA) reads and before a stage
// goes back.  Rounding: P and dS are rounded to bf16 once before they enter
// the products that sum them (2^-9 a term); S, dP and every sum stay
// float32.  dQ's float32 sums arrive by L2 reductions in an order that
// changes from run to run; dK and dV are each summed by one thread in a
// fixed order.
// What bounds it: operations (1.37e12 FLOP at the llama3-8b training shape,
// 1.39 ms).  What it does not yet do: the two warpgroups run in step (each
// step's exponentials leave the tensor cores idle; FA3 ping-pongs them),
// and no CTA is persistent.
// The options (template flags, so llama's instance <128, false, false> is
// the code without them):
//   - kWin: a key tile walks only the query tiles its window reaches (rows
//     up to its last key + window - 1), and masks a step only where the
//     diagonal, the window's edge or the ragged T edge cuts it.  After the
//     loop, rows that see no key add dO / T to dV (keyless_dv, through the
//     dQ blocks' shared memory, once both warpgroups' adds have read them).
//   - kCap: while dP^T is in flight, S^T becomes t = tanh(S^T cap_in), the
//     forward's accurate tanhf; then P^T = exp2(t cap_out - lse log2(e))
//     and dS^T = P^T (dP^T - D) (1 - t^2) in the accumulator registers,
//     before its bf16 rounding.  t lives in S^T's registers: no more are
//     live than without the cap.
//   - DH 64 (whisper-base): a row of a Q, dO, K or V tile is one 128-byte
//     swizzle row; S^T and dP^T take 4 k-steps, dV and dK are m64n64k16,
//     and dQ's 64 columns are summed by each warpgroup over its own 64 keys
//     (both add into the same dQ rows); shared memory ~130 KB.

constexpr int kBwdKeysTc = 128;            // keys a CTA: 64 a warpgroup
constexpr int kBwdRowsTc = 64;             // query rows a step
constexpr int kBwdStages = 2;              // (Q, dO) tiles in flight
constexpr int kBwdTcThreads = 2 * 128;     // two warpgroups, 64 keys each
constexpr int kDqBoxCols = kSwizzleRow / 4;   // float32 columns a dQ box

template <int DH>
struct BwdTcLayout {                       // byte offsets from a 1024 boundary
  static_assert(DH == 64 || DH == 128, "DH: one or two 64-column boxes");
  static constexpr int kBoxes = DH / kBoxCols;
  static constexpr int kKVBox = kBwdKeysTc * kSwizzleRow;   // 64 columns
  static constexpr int kRowBox = kBwdRowsTc * kSwizzleRow;
  static constexpr int kK = 0;                              // kBoxes boxes
  static constexpr int kV = kBoxes * kKVBox;
  static constexpr int kStage0 = 2 * kBoxes * kKVBox;
  static constexpr int kStage = 2 * kBoxes * kRowBox;       // Q, then dO
  static constexpr int kDS = kStage0 + kBwdStages * kStage;
  static constexpr int kDSTile = kBwdKeysTc * kSwizzleRow;  // dS^T, MN-major
  static constexpr int kDQ = kDS + 2 * kDSTile;   // a warpgroup: two boxes
  static constexpr int kDQBlock = 2 * kRowBox;
  static constexpr int kRowVals = kDQ + 2 * kDQBlock;       // lse2, D a stage
  static constexpr int kBars = kRowVals + kBwdStages * 2 * kBwdRowsTc * 4;
  // K/V's barrier, then kBwdStages "full", then kBwdStages "empty"
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kBwdStages) + 1024;
};

__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" :: "r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void sts_f1(uint32_t addr, float a) {
  asm volatile("st.shared.f32 [%0], %1;" :: "r"(addr), "f"(a) : "memory");
}
__device__ __forceinline__ void sts_f2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};"
               :: "r"(addr), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void sts_f4(uint32_t addr, float a, float b,
                                       float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}
__device__ __forceinline__ float4 lds_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// d (64 x 64 f32) = (accumulate ? d : 0) + A B, A and B both MN-major in
// shared memory (the transpose bits)
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N f32) += A B, A K-major and B MN-major in shared memory: N 64
// (DH 64) or 128
__device__ __forceinline__ void wgmma_ss_bt(float (&d)[32], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_ss_bt(float (&d)[64], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : ACC64(d)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map,
                                                  uint32_t src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

// cp.async of 4 bytes, zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Stage s of the ring gets step (head, q0): Q and dO by TMA from lane 0,
// the rows' lse and D by cp.async from every lane of the calling warp; all
// complete on full[s].  Rows past S arrive as zeros (Q, dO, lse, D alike).
template <int DH>
__device__ __forceinline__ void bwd_load_step(
    const CUtensorMap* tm_q, const CUtensorMap* tm_do, const float* lse,
    const float* delta, uint32_t stage, uint32_t rows, uint32_t full,
    int head, int q0, int S, int lane) {
  using L = BwdTcLayout<DH>;
  if (lane == 0) {
    mbar_expect_tx(full, L::kStage);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_3d(stage + c * L::kRowBox, tm_q, full, c * kBoxCols, q0, head);
      tma_load_3d(stage + (L::kBoxes + c) * L::kRowBox, tm_do, full,
                  c * kBoxCols, q0, head);
    }
  }
  for (int r = lane; r < kBwdRowsTc; r += 32) {
    const int pos = q0 + r < S ? q0 + r : S - 1;   // an address in bounds
    const int64_t at = static_cast<int64_t>(head) * S + pos;
    cp_async4(rows + 4 * r, lse + at, q0 + r < S);
    cp_async4(rows + 4 * (kBwdRowsTc + r), delta + at, q0 + r < S);
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(full) : "memory");
}

// grid: (B KVH) x key tiles, the key tile fastest.  kCap: a softcap
// (cap_in = scale / softcap, cap_out = softcap log2(e)); kWin: a window.
template <int DH, bool kCap, bool kWin>
__global__ void __launch_bounds__(kBwdTcThreads, 1)
flash_attention_bwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dq,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const __nv_bfloat16* __restrict__ dout,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int G, int S,
                          int T_len, float scale, float score_mul,
                          int causal, float cap_in, float cap_out,
                          int window) {
  using L = BwdTcLayout<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1024 B
  const uint32_t bar_kv = base + L::kBars;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * kBwdStages;
  const int tid = threadIdx.x;
  const int n_kt = (T_len + kBwdKeysTc - 1) / kBwdKeysTc;
  const int bh = blockIdx.x / n_kt;
  const int k0 = blockIdx.x % n_kt * kBwdKeysTc;
  // with causal, query tiles before the key tile see none of its keys; with
  // a window, rows past its last key + window - 1 none either; the steps
  // run from the last query tile down, the G heads inner
  const int q_first = causal ? k0 : 0;
  int q_lim = S - 1;
  if (kWin) {
    const int64_t row_hi = static_cast<int64_t>(min(k0 + kBwdKeysTc, T_len)) +
                           window - 2;          // last key + window - 1
    q_lim = row_hi < S - 1 ? static_cast<int>(row_hi) : S - 1;
  }
  const int q_last = q_lim / kBwdRowsTc * kBwdRowsTc;
  const int n_items = q_first <= q_lim
                          ? G * ((q_last - q_first) / kBwdRowsTc + 1) : 0;
  const int wg = tid >> 7;
  const bool loader = tid < 32;                // warp 0 refills the ring
  const bool dq_lead = (tid & 127) == 0;       // the warpgroup's dQ adds

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(bar_full + 8 * s, 1 + 32);
      mbar_init(bar_empty + 8 * s, 8);          // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the loader's next step: (head bh G + g_ld, q0_ld)
  int g_ld = 0, q0_ld = q_last;
  if (loader && n_items > 0) {
    if (tid == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kBoxes * L::kKVBox);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_3d(base + L::kK + c * L::kKVBox, &tm_k, bar_kv,
                    c * kBoxCols, k0, bh);
        tma_load_3d(base + L::kV + c * L::kKVBox, &tm_v, bar_kv,
                    c * kBoxCols, k0, bh);
      }
    }
    for (int it = 0; it < kBwdStages && it < n_items; ++it) {
      bwd_load_step<DH>(&tm_q, &tm_do, lse, delta,
                        base + L::kStage0 + it * L::kStage,
                        base + L::kRowVals + it * 2 * kBwdRowsTc * 4,
                        bar_full + 8 * it, bh * G + g_ld, q0_ld, S, tid);
      if (++g_ld == G) {
        g_ld = 0;
        q0_ld -= kBwdRowsTc;
      }
    }
  }

  // warpgroup wg holds keys k0 + 64 wg .. + 63
  const int warp = (tid >> 5) & 3, lane = tid & 31, quad = lane & 3;
  const int sw = lane >> 2;                    // a row's 128B-swizzle phase
  const int key_lo = 64 * wg + 16 * warp + sw;         // and key_lo + 8
  float acc_dk[DH / 2], acc_dv[DH / 2];
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) acc_dk[j] = acc_dv[j] = 0.f;
  const uint32_t k_wg = base + L::kK + 64 * wg * kSwizzleRow;
  const uint32_t v_wg = base + L::kV + 64 * wg * kSwizzleRow;
  // dQ's product: at DH 128 the warpgroup's 64 of dQ's columns over both
  // warpgroups' 128 keys (K's box wg); at DH 64 all 64 columns over its own
  // 64 keys (each warpgroup adds its share of dQ)
  constexpr int kDqKeys = DH == 128 ? kBwdKeysTc : 64;
  const int dq_key0 = DH == 128 ? 0 : 64 * wg;
  const int dq_col0 = DH == 128 ? 64 * wg : 0;
  const uint32_t k_cols = base + L::kK + (DH == 128 ? wg * L::kKVBox : 0) +
                          dq_key0 * kSwizzleRow;
  const uint32_t dq_s = base + L::kDQ + wg * L::kDQBlock;
  const bool edge = k0 + 64 * wg + 64 > T_len;
  if (n_items > 0) mbar_wait(bar_kv, 0);
  int g = 0, q0 = q_last;
  for (int it = 0; it < n_items; ++it) {
    const int s = it % kBwdStages;
    const uint32_t q_s = base + L::kStage0 + s * L::kStage;
    const uint32_t do_s = q_s + L::kBoxes * L::kRowBox;
    const uint32_t ds_s = base + L::kDS + (it & 1) * L::kDSTile;
    // this thread's query rows' lse at rv + 32 j, D at rv + 256 + 32 j:
    // rows 8 j + 2 quad, + 1
    const uint32_t rv = base + L::kRowVals + s * 2 * kBwdRowsTc * 4 + 8 * quad;
    mbar_wait(bar_full + 8 * s, (it / kBwdStages) & 1);
    __syncwarp();

    // S^T = K Q^T, then dP^T = V dO^T: DH / 16 k-steps of 16 columns, 32
    // bytes apart inside a swizzled row; the first of each overwrites st, dpt
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * L::kKVBox + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * L::kRowBox + (kk % 4) * 32;
      wgmma_ss(st, sw128_desc(k_wg + a_off, 16), sw128_desc(q_s + b_off, 16),
               kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * L::kKVBox + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * L::kRowBox + (kk % 4) * 32;
      wgmma_ss(dpt, sw128_desc(v_wg + a_off, 16),
               sw128_desc(do_s + b_off, 16), kk > 0);
    }
    wgmma_commit();

    // st[4 j + 2 i + e]: key k0 + key_lo + 8 i, query row q0 + 8 j + 2 quad
    // + e; while dP^T is in flight, P^T in its place, or with a softcap
    // tanh(S^T cap_in), from which P^T and the cap's derivative follow
    wgmma_wait<1>();
    fence_regs(st);
    const bool need_mask =
        edge || (causal && k0 + 64 * wg + 63 > q0) ||
        (kWin && q0 + kBwdRowsTc - 1 - (k0 + 64 * wg) >= window);
    auto masked = [&](int x) {
      const int kpos = k0 + key_lo + 8 * ((x >> 1) & 1);
      const int qpos = q0 + 8 * (x >> 2) + 2 * quad + (x & 1);
      return kpos >= T_len || (causal && kpos > qpos) ||
             (kWin && qpos - kpos >= window);
    };
    if (kCap) {
#pragma unroll
      for (int x = 0; x < 32; ++x) st[x] = tanhf(st[x] * cap_in);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = lds_f2(rv + 32 * j);
#pragma unroll
        for (int x = 4 * j; x < 4 * j + 4; ++x) {
          st[x] = fast_exp2(fmaf(st[x], score_mul,
                                 ((x & 1) ? l.y : l.x) * -kLog2e));
          if (need_mask && masked(x)) st[x] = 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dpt);
    uint32_t pa[16];                    // P^T as 4 A fragments
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dd = lds_f2(rv + 4 * kBwdRowsTc + 32 * j);
      float2 l;
      if (kCap) l = lds_f2(rv + 32 * j);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = 4 * j + 2 * i;
        float p[2], fac[2] = {1.f, 1.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = st[x + e];
          if (kCap) {           // dS^T takes d cap / d s = 1 - tanh^2
            const float t = st[x + e];
            p[e] = fast_exp2(fmaf(t, cap_out, (e ? l.y : l.x) * -kLog2e));
            if (need_mask && masked(x + e)) p[e] = 0.f;
            fac[e] = 1.f - t * t;
          }
        }
        pa[2 * j + i] = pack_bf16(p[0], p[1]);
        dpt[x] = p[0] * (dpt[x] - dd.x) * fac[0];
        dpt[x + 1] = p[1] * (dpt[x + 1] - dd.y) * fac[1];
      }
    }

    // dS^T to shared memory as bf16, 128B-swizzled: row = key, 64 query
    // rows of 2 bytes a row (chunk j of 16 bytes holds query rows 8 j .. 8 j
    // + 7); rows key_lo and key_lo + 8 share the swizzle phase sw.  K-major,
    // the warpgroup's rows are dK's A; MN-major, dQ's
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t off = (key_lo + 8 * i) * kSwizzleRow + 4 * quad;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t at = off + ((j ^ sw) << 4);
        const int x = 4 * j + 2 * i;
        sts_u32(ds_s + at, pack_bf16(dpt[x], dpt[x + 1]));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" :: "n"(256) : "memory");

    // dV += P^T dO (P^T from registers), dK += dS^T Q: 4 k-steps of 16
    // query rows, 32 bytes apart in a row of dS^T, 2048 bytes apart in dO
    // and Q (B MN-major, its 64-column boxes kRowBox apart)
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      wgmma_rs(acc_dv, pa + 4 * kb,
               sw128_desc(do_s + kb * 16 * kSwizzleRow, L::kRowBox));
    }
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      wgmma_ss_bt(acc_dk,
                  sw128_desc(ds_s + 64 * wg * kSwizzleRow + kb * 32, 16),
                  sw128_desc(q_s + kb * 16 * kSwizzleRow, L::kRowBox));
    }

    // dQ (64 rows x 64 columns) = dS K: kDqKeys / 16 k-steps of 16 keys,
    // 2048 bytes apart in dS^T and in K; the three products are one commit
    // group.  dQ takes st's registers (P^T is packed by now): one home for
    // both
    float (&dq)[32] = st;
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk) {
      wgmma_ss_mn(dq,
                  sw128_desc(ds_s + (dq_key0 + kk * 16) * kSwizzleRow,
                             L::kDSTile),
                  sw128_desc(k_cols + kk * 16 * kSwizzleRow, L::kKVBox),
                  kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    fence_regs(pa);
    fence_regs(dq);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    // once every warp is done with stage s, the loader refills it
    if (loader && it + kBwdStages < n_items) {
      mbar_wait(bar_empty + 8 * s, (it / kBwdStages) & 1);
      bwd_load_step<DH>(&tm_q, &tm_do, lse, delta, q_s,
                        base + L::kRowVals + s * 2 * kBwdRowsTc * 4,
                        bar_full + 8 * s, bh * G + g_ld, q0_ld, S, lane);
      if (++g_ld == G) {
        g_ld = 0;
        q0_ld -= kBwdRowsTc;
      }
    }

    // dq[4 j + 2 i + e]: query row 16 warp + sw + 8 i of the tile, column
    // 8 j + 2 quad + e of the block's 64: box j / 4, 16-byte chunk
    // 2 (j % 4) + quad / 2 of the row, swizzled
    if (dq_lead) {                      // the last step's adds have read it
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    asm volatile("bar.sync %0, %1;" :: "r"(2 + wg), "n"(128) : "memory");
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t row = dq_s + (16 * warp + sw + 8 * i) * kSwizzleRow +
                           8 * (quad & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sts_f2(row + (j >> 2) * L::kRowBox +
                   (((2 * (j & 3) + (quad >> 1)) ^ sw) << 4),
               dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, %1;" :: "r"(2 + wg), "n"(128) : "memory");
    if (dq_lead) {
      for (int b = 0; b < 2; ++b) {
        tma_reduce_add_3d(&tm_dq, dq_s + b * L::kRowBox,
                          dq_col0 + b * kDqBoxCols, q0, bh * G + g);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (++g == G) {
      g = 0;
      q0 -= kBwdRowsTc;
    }
  }
  if (dq_lead) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");

  // rows that see no key give every key dO / T: summed into the dQ blocks'
  // shared memory once both warpgroups' adds have read them
  if (kWin && has_keyless_rows(S, T_len, window)) {
    float* sum = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kDQ);
    asm volatile("bar.sync 1, %0;" :: "n"(256) : "memory");
    keyless_dv<DH>(dout, static_cast<int64_t>(bh) * G, G, S, T_len, window,
                   sum, tid, kBwdTcThreads);
    asm volatile("bar.sync 1, %0;" :: "n"(256) : "memory");
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc_dv[4 * j + 2 * i] += sum[8 * j + 2 * quad];
        acc_dv[4 * j + 2 * i + 1] += sum[8 * j + 2 * quad + 1];
      }
    }
  }

  // acc_dk[4 j + 2 i + e], acc_dv likewise: key k0 + key_lo + 8 i, column
  // 8 j + 2 quad + e
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = k0 + key_lo + 8 * i;
    if (kpos >= T_len) continue;
    const int64_t off = (static_cast<int64_t>(bh) * T_len + kpos) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + c) =
          __floats2bfloat162_rn(acc_dk[4 * j + 2 * i] * scale,
                                acc_dk[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + c) =
          __floats2bfloat162_rn(acc_dv[4 * j + 2 * i],
                                acc_dv[4 * j + 2 * i + 1]);
    }
  }
}

// dq = bf16(acc scale), four values a thread and step
__global__ void __launch_bounds__(256)
flash_attention_bwd_dq_round(const float* __restrict__ acc,
                             __nv_bfloat16* __restrict__ dq, int64_t n4,
                             float scale) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * 256) {
    const float4 x = reinterpret_cast<const float4*>(acc)[i];
    reinterpret_cast<uint2*>(dq)[i] =
        make_uint2(pack_bf16(x.x * scale, x.y * scale),
                   pack_bf16(x.z * scale, x.w * scale));
  }
}

// dQ's float32 workspace (DH, S, heads), reduced into in 128B-swizzled
// boxes of (32, rows, 1)
bool encode_dq_acc(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* map,
                   void* ptr, uint64_t dh, uint64_t S, uint64_t heads,
                   uint32_t rows) {
  const cuuint64_t dims[3] = {dh, S, heads};
  const cuuint64_t strides[2] = {dh * 4, dh * S * 4};        // bytes
  const cuuint32_t box[3] = {kDqBoxCols, rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// -- backward, bfloat16 at DH 256: one wgmma pass fed by TMA ----------------
//
// recurrentgemma-9b's local attention (DH 256, MQA at G 16, window 2048, no
// softcap) trains through flash_attention_bwd_dh256, launched as the pass
// above is (the delta pass zeroes dq_acc first, flash_attention_bwd_dq_round
// rounds it after).  The pass above does not fit DH 256: at 128 keys a CTA
// and 64 a warpgroup a thread would hold 256 floats of dK and dV, and K and
// V (64 KB at 64 keys) beside a 64-row (Q, dO) stage (64 KB) and dS^T leave
// no room for a second stage.  So the work is split by product, not by key:
//   - A CTA takes kB256Keys = 64 keys of one (batch row, KV head) and has two
//     warpgroups (256 threads, one CTA an SM; no producer warp and no
//     setmaxnreg: at more than 256 threads ptxas caps the registers below
//     what a thread holds here).  Warpgroup 0 owns dV and warpgroup 1 owns
//     dK, 64 keys x 256 columns each (128 floats a thread), summed over the
//     G heads and the query rows in a fixed order, with no atomics.
//   - A step is kB256Rows = R = 64 query rows of one head:
//       wg 0: S^T = K Q^T (wgmma m64nRk16, 16 k-steps, A and B K-major);
//             P^T = exp2(S^T scale log2(e) - lse log2(e)), masked only in a
//             step that the diagonal, the window's edge or the ragged T edge
//             cuts; P^T to shared memory as float32 for wg 1 (named barrier
//             kBarP); then dV += P^T dO (m64n256k16: P^T rounded to bf16 as
//             the register A, dO MN-major B through the transpose bit).
//       wg 1: dP^T = V dO^T (as S^T); once P^T is in, dS^T = P^T (dP^T - D)
//             in the accumulator registers, rounded to bf16 once: the
//             register A of dK += dS^T Q (m64n256k16), and, swizzled in
//             shared memory (a 2R-byte row a key), B of dQ's product (named
//             barrier kBarDs over both warpgroups).
//       both: dQ^T = K^T dS^T for the warpgroup's 128 of dQ's 256 columns,
//             swapped so that M is 64 columns and N the step's R rows (two
//             m64nRk16 products over the 64 keys, K's box as MN-major A,
//             dS^T as MN-major B); each block to shared memory as float32,
//             128B-swizzled, and one thread of the warpgroup adds it into
//             dq_acc by four TMA reduce-adds (boxes of 32 columns x R rows
//             over (256, S, B KVH G): rows past S are dropped); it waits for
//             their reads of the block one step later, before the block is
//             written again (named barriers 3 + wg).
//     Five products, none recomputed.  The first products of a step, S^T
//     and dP^T, are the same code with other operands, so both warpgroups
//     run them at once; while wg 0 exponentiates, wg 1's dP^T is still on
//     the tensor cores, and while wg 1 forms dS^T, wg 0's dV is.
//   - The ring: kB256Stages stages of R rows, each a Q part (Q, lse) and a
//     dO part (dO, D) with "full" and "empty" mbarriers of their own, so
//     that each part is refilled as soon as its last reader is done: Q is
//     read by S^T and dK, dO by dP^T and dV; wg 0 hands Q back after S^T
//     and dO back after dV, wg 1 dO back after dS^T and Q back after dK.
//     The last reader refills (b256_load_part: the tile by TMA, the rows'
//     lse or D by cp.async): warp 3 dO once dV is done, warp 7 Q once dK
//     is; warp 7 also copies K and V once (64 KB).  Not warps 0 and 4,
//     whose lane 0 adds the warpgroup's dQ.
//   - The walk (B256Walk): the G heads outer, the query rows inner, from the
//     CTA's first row up, so the ~132 resident CTAs read the Q and dO rows
//     of one head, ~10 MB at the training shape (B 2, KVH 1, G 16, S = T =
//     8192, window 2048), which L2 holds, and add into the same dQ rows.
//     CTAs are ordered key tile first, (batch row, KV head) inner: with
//     causal, the CTAs with the most rows start first.
// Shared memory at R 64 and one stage: K and V 64 KB, the stage 64 KB, P^T
// 16 KB (float32), dS^T 8 KB, dQ's blocks 64 KB (32 KB a warpgroup), the
// rows' lse and D: ~218 KB, one CTA an SM.  Registers: a thread holds dV
// or dK (128 floats), S^T or dP^T (32), P^T or dS^T packed (16) and dQ's
// two blocks (64): ptxas allocates ~240 of the 255 that 256 threads allow,
// with no spill (the build prints the count).  Each choice was timed on the
// card against its alternatives (probes/flash_bwd_probe.py --shape rg;
// PERF.md): 32-row steps with two or three stages, heads inner, (batch
// row, KV head) first, refills from the warps that add dQ, and split
// slots (Q's two, dO's one; dQ unswapped, added a warp at a time) were
// each slower.
// What bounds it: operations (1.20e12 FLOP of the five products over the
// pairs that the mask keeps at the training shape, 1.22 ms at 989 TFLOP/s).
// What costs beyond them: shared memory, ~490 KB a step against 2,560
// tensor cycles: S^T and dP^T read a K or V tile beside each Q or dO tile
// (m64n64, 128 KB), dQ's float32 blocks cross it twice (the stores, the
// TMA's reads; 128 KB), the other products' operands, P^T and the TMA's
// fills the rest; and L2 carries each Q and dO row to the ~33 CTAs whose
// keys it sees and each CTA's dQ adds (~17 GB at this shape).
// The contract is the pass above's: kWin's mask i - j < window with causal,
// ragged S and T (rows past S have Q = dO = lse = D = 0 and add nothing,
// keys past T are masked and not stored), rows that see no key add dO / T
// to dV after the walk (keyless_dv), P and dS rounded to bf16 once, S, dP
// and every sum float32; dQ's sums arrive by L2 reductions in an order that
// changes from run to run.  No softcap (no config caps its scores here).

constexpr int kB256Keys = 64;            // keys a CTA
constexpr int kB256Rows = 64;            // query rows a step (R)
constexpr int kB256Stages = 1;           // (Q, dO) stages in flight
constexpr bool kB256HeadsOuter = true;   // the walk: heads outer, rows inner
constexpr int kBarP = 1, kBarDs = 2;     // named barriers; 3 + wg: dQ's

struct B256Layout {                      // byte offsets from a 1024 boundary
  static constexpr int kRows = kB256Rows;
  static constexpr int kBoxes = 256 / kBoxCols;              // 64 columns
  static constexpr int kKVBox = kB256Keys * kSwizzleRow;
  static constexpr int kRowBox = kRows * kSwizzleRow;         // also dQ's
  static constexpr int kPart = kBoxes * kRowBox;              // Q or dO
  static constexpr int kK = 0;
  static constexpr int kV = kBoxes * kKVBox;
  static constexpr int kStage0 = 2 * kBoxes * kKVBox;
  static constexpr int kStage = 2 * kPart;                    // Q, then dO
  static constexpr int kPT = kStage0 + kB256Stages * kStage;  // float32
  static constexpr int kDsRow = 2 * kRows;       // dS^T: bytes a key, also
  static constexpr int kDS = kPT + kB256Keys * kRows * 4;   // its swizzle
  static constexpr int kDQ = kDS + kB256Keys * kDsRow;   // 4 boxes a wg
  static constexpr int kDQBlock = 4 * kRowBox;
  static constexpr int kRowVals = kDQ + 2 * kDQBlock;   // lse, D a stage
  static constexpr int kBars = kRowVals + kB256Stages * 2 * kRows * 4;
  // K/V's barrier, then a stage's Q "full", dO "full", Q "empty" and dO
  // "empty", stage by stage
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kB256Stages) + 1024;
  // R 32 (the probe's r32 variants, which add the m64n32 products) or 64
  static_assert(kRows == 32 || kRows == 64, "R: one m64nR product a step");
  static_assert(kBytes <= 232448, "past the 227 KB a block may take");
};

// A descriptor of dS^T as an MN-major operand: a row (one key) of
// kRowBytes (64 or 128), swizzled at that width, 8-row groups 8 kRowBytes
// apart; one swizzle atom across (R columns), so the leading offset, the
// stride between atoms, is never read.
template <int kRowBytes>
__device__ __forceinline__ uint64_t ds_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kRowBytes) << 16) |
         (static_cast<uint64_t>(8 * kRowBytes >> 4) << 32) |
         (static_cast<uint64_t>(kRowBytes == 128 ? 1 : 2) << 62);
}

// The CTA's steps: (head g, rows q0 .. q0 + R - 1)
struct B256Walk {
  int g, q0;
  __device__ B256Walk(int q_first, int q_last)
      : g(0), q0(kB256HeadsOuter ? q_first : q_last) {}
  __device__ void next(int G, int q_first, int q_last) {
    if (kB256HeadsOuter) {
      q0 += kB256Rows;
      if (q0 > q_last) {
        q0 = q_first;
        ++g;
      }
    } else if (++g == G) {
      g = 0;
      q0 -= kB256Rows;
    }
  }
};

// A part of a stage, Q with the rows' lse or dO with their D, for step
// (head, q0): the tile by TMA from lane 0, the R rows' values by cp.async
// from every lane of the calling warp; both complete on ``full``.  Rows
// past S arrive as zeros.
__device__ __forceinline__ void b256_load_part(const CUtensorMap* tm,
                                               const float* vals,
                                               uint32_t tile, uint32_t rows,
                                               uint32_t full, int head,
                                               int q0, int S, int lane) {
  using L = B256Layout;
  if (lane == 0) {
    mbar_expect_tx(full, L::kPart);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_3d(tile + c * L::kRowBox, tm, full, c * kBoxCols, q0, head);
    }
  }
  for (int r = lane; r < L::kRows; r += 32) {
    const int pos = q0 + r < S ? q0 + r : S - 1;   // an address in bounds
    cp_async4(rows + 4 * r, vals + static_cast<int64_t>(head) * S + pos,
              q0 + r < S);
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(full) : "memory");
}

// grid: key tiles x (B KVH), (B KVH) fastest.  The arguments are the pass
// above's (cap_in and cap_out unread).
template <bool kCap, bool kWin>
__global__ void __launch_bounds__(kBwdTcThreads, 1)
flash_attention_bwd_dh256(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dq,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const __nv_bfloat16* __restrict__ dout,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int G, int S,
                          int T_len, float scale, float score_mul,
                          int causal, float cap_in, float cap_out,
                          int window) {
  static_assert(!kCap, "no softcap at DH 256");
  using L = B256Layout;
  constexpr int R = kB256Rows, NS = kB256Stages, DH = 256;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1024 B
  const uint32_t bar_kv = base + L::kBars;
  // stage s's barriers: bars(s) + 0 Q full, + 8 dO full, + 16 Q empty,
  // + 24 dO empty
  const uint32_t bars = bar_kv + 8;
  const int tid = threadIdx.x;
  const int n_bh = gridDim.x / ((T_len + kB256Keys - 1) / kB256Keys);
  const int bh = blockIdx.x % n_bh;
  const int k0 = blockIdx.x / n_bh * kB256Keys;
  // with causal, rows before the key tile see none of its keys; with a
  // window, rows past its last key + window - 1 none either
  const int q_first = causal ? k0 : 0;
  int q_lim = S - 1;
  if (kWin) {
    const int64_t row_hi = static_cast<int64_t>(min(k0 + kB256Keys, T_len)) +
                           window - 2;          // last key + window - 1
    q_lim = row_hi < S - 1 ? static_cast<int>(row_hi) : S - 1;
  }
  const int q_last = q_lim / R * R;
  const int n_items = q_first <= q_lim ? G * ((q_last - q_first) / R + 1) : 0;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, quad = lane & 3;
  // warp 3 refills dO's parts, warp 7 Q's (and copies K and V)
  const bool loader = warp == 3;
  const bool dq_lead = (tid & 127) == 0;       // the warpgroup's dQ adds
  const CUtensorMap* tm_ld = wg == 0 ? &tm_do : &tm_q;
  const float* vals_ld = wg == 0 ? delta : lse;
  const int part = wg == 0 ? L::kPart : 0;           // dO's, Q's tile
  const int part_vals = wg == 0 ? R : 0;              // D's, lse's rows
  const int part_bar = wg == 0 ? 8 : 0;               // dO's, Q's "full"

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bars + 32 * s, 1 + 32);         // Q full: tx, 32 cp.async
      mbar_init(bars + 32 * s + 8, 1 + 32);     // dO full
      mbar_init(bars + 32 * s + 16, 8);         // Q empty: one per warp
      mbar_init(bars + 32 * s + 24, 8);         // dO empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  B256Walk ld(q_first, q_last);                // the loader's next step
  if (loader && n_items > 0) {
    if (wg == 1 && lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kBoxes * L::kKVBox);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_3d(base + L::kK + c * L::kKVBox, &tm_k, bar_kv,
                    c * kBoxCols, k0, bh);
        tma_load_3d(base + L::kV + c * L::kKVBox, &tm_v, bar_kv,
                    c * kBoxCols, k0, bh);
      }
    }
    for (int it = 0; it < NS && it < n_items; ++it) {
      b256_load_part(tm_ld, vals_ld, base + L::kStage0 + it * L::kStage + part,
                     base + L::kRowVals + it * 2 * R * 4 + 4 * part_vals,
                     bars + 32 * it + part_bar, bh * G + ld.g, ld.q0, S,
                     lane);
      ld.next(G, q_first, q_last);
    }
  }

  // acc[4 j + 2 i + e]: dV (wg 0) or dK (wg 1) of key k0 + key_lo + 8 i,
  // column 8 j + 2 quad + e
  const int key_lo = 16 * warp + (lane >> 2);
  float acc[DH / 2];
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) acc[j] = 0.f;
  const uint32_t kv_wg = base + (wg == 0 ? L::kK : L::kV);   // K or V
  const uint32_t pt = base + L::kPT + 16 * (tid & 127);   // + 2048 a float4
  const uint32_t ds = base + L::kDS;
  const uint32_t dq_s = base + L::kDQ + wg * L::kDQBlock;
  // the swizzle phase of dS^T's rows key_lo and key_lo + 8
  const int ds_sw = (key_lo * L::kDsRow >> 7) & (L::kDsRow / 16 - 1);
  const bool edge = k0 + kB256Keys > T_len;
  if (n_items > 0) mbar_wait(bar_kv, 0);
  B256Walk w(q_first, q_last);
  for (int it = 0; it < n_items; ++it) {
    const int s = it % NS;
    const uint32_t par = (it / NS) & 1;
    const uint32_t q_s = base + L::kStage0 + s * L::kStage;
    const uint32_t do_s = q_s + L::kPart;
    const uint32_t bar_s = bars + 32 * s;
    // this thread's query rows' lse at rv + 32 j, D at rv + 4 R + 32 j:
    // rows 8 j + 2 quad, + 1
    const uint32_t rv = base + L::kRowVals + s * 2 * R * 4 + 8 * quad;
    // wg 0 starts on Q, wg 1 on dO
    mbar_wait(bar_s + 8 * wg, par);
    __syncwarp();

    // wg 0: S^T = K Q^T, wg 1: dP^T = V dO^T; 16 k-steps of 16 columns, 32
    // bytes apart inside a swizzled row.  sp[4 j + 2 i + e]: key k0 +
    // key_lo + 8 i, query row q0 + 8 j + 2 quad + e
    float sp[R / 2];
    const uint32_t b_s = wg == 0 ? q_s : do_s;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * L::kKVBox + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * L::kRowBox + (kk % 4) * 32;
      wgmma_ss(sp, sw128_desc(kv_wg + a_off, 16), sw128_desc(b_s + b_off, 16),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sp);

    uint32_t pk[R / 4];                 // P^T (wg 0) or dS^T (wg 1), bf16
    if (wg == 0) {
      const bool need_mask =
          edge || (causal && k0 + kB256Keys - 1 > w.q0) ||
          (kWin && w.q0 + R - 1 - k0 >= window);
      auto masked = [&](int x) {
        const int kpos = k0 + key_lo + 8 * ((x >> 1) & 1);
        const int qpos = w.q0 + 8 * (x >> 2) + 2 * quad + (x & 1);
        return kpos >= T_len || (causal && kpos > qpos) ||
               (kWin && qpos - kpos >= window);
      };
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        const float2 l = lds_f2(rv + 32 * j);
#pragma unroll
        for (int x = 4 * j; x < 4 * j + 4; ++x) {
          sp[x] = fast_exp2(fmaf(sp[x], score_mul,
                                 ((x & 1) ? l.y : l.x) * -kLog2e));
          if (need_mask && masked(x)) sp[x] = 0.f;
        }
        sts_f4(pt + 2048 * j, sp[4 * j], sp[4 * j + 1], sp[4 * j + 2],
               sp[4 * j + 3]);
      }
      asm volatile("bar.arrive %0, %1;" :: "n"(kBarP), "n"(256) : "memory");
    } else {
      asm volatile("bar.sync %0, %1;" :: "n"(kBarP), "n"(256) : "memory");
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        const float4 p = lds_f4(pt + 2048 * j);
        const float2 dd = lds_f2(rv + 4 * R + 32 * j);
        sp[4 * j] = p.x * (sp[4 * j] - dd.x);
        sp[4 * j + 1] = p.y * (sp[4 * j + 1] - dd.y);
        sp[4 * j + 2] = p.z * (sp[4 * j + 2] - dd.x);
        sp[4 * j + 3] = p.w * (sp[4 * j + 3] - dd.y);
      }
    }
    // wg 0 is done with Q and lse, wg 1 with dO and D
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_s + 16 + 8 * wg);
#pragma unroll
    for (int x = 0; x < R / 2; x += 2) pk[x / 2] = pack_bf16(sp[x], sp[x + 1]);
    if (wg == 1) {
      // dS^T to shared memory: row = key, query row r at byte 2 r (chunk j
      // of 16 bytes: rows 8 j .. 8 j + 7), the chunk swizzled by ds_sw
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t row = ds + (key_lo + 8 * i) * L::kDsRow + 4 * quad;
#pragma unroll
        for (int j = 0; j < R / 8; ++j) {
          sts_u32(row + ((j ^ ds_sw) << 4), pk[2 * j + i]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }

    // wg 0: dV += P^T dO, wg 1: dK += dS^T Q: R / 16 k-steps of 16 query
    // rows, 2048 bytes apart in dO and Q (B MN-major, its four 64-column
    // boxes kRowBox apart); each waits for the other's part
    mbar_wait(bar_s + 8 - 8 * wg, par);
    const uint32_t b2 = wg == 0 ? do_s : q_s;
    fence_regs(acc);
    fence_regs(pk);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < R / 16; ++kb) {
      wgmma_rs(acc, pk + 4 * kb,
               sw128_desc(b2 + kb * 16 * kSwizzleRow, L::kRowBox));
    }
    wgmma_commit();
    asm volatile("bar.sync %0, %1;" :: "n"(kBarDs), "n"(256) : "memory");

    // dQ^T (64 columns x R rows) = K^T dS^T for the warpgroup's boxes 2 wg
    // and 2 wg + 1 of K: 4 k-steps of 16 keys, 2048 bytes apart in K and 16
    // rows of dS^T apart in dS^T.  dq256[c][4 j + 2 i + e]: column 128 wg +
    // 64 c + key_lo + 8 i, query row q0 + 8 j + 2 quad + e
    float dq256[2][R / 2];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int kk = 0; kk < kB256Keys / 16; ++kk) {
        wgmma_ss_mn(dq256[c],
                    sw128_desc(base + L::kK + (2 * wg + c) * L::kKVBox +
                                   kk * 16 * kSwizzleRow, L::kKVBox),
                    ds_desc<L::kDsRow>(ds + kk * 16 * L::kDsRow), kk > 0);
      }
    }
    wgmma_commit();
    // once dV (dK) has read its part, the warp hands it back; the last
    // reader refills it for the step NS on
    wgmma_wait<1>();
    fence_regs(acc);
    fence_regs(pk);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_s + 24 - 8 * wg);
    if (loader && it + NS < n_items) {
      mbar_wait(bar_s + 24 - 8 * wg, par);
      b256_load_part(tm_ld, vals_ld, q_s + part, rv - 8 * quad + 4 * part_vals,
                     bar_s + part_bar, bh * G + ld.g, ld.q0, S, lane);
      ld.next(G, q_first, q_last);
    }
    wgmma_wait<0>();
    fence_regs(dq256[0]);
    fence_regs(dq256[1]);

    // dQ's four boxes of 32 columns x R rows, float32, 128B-swizzled: the
    // column's 16-byte chunk of the row XOR the row's phase r % 8
    if (dq_lead) {                      // the last step's adds have read it
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    asm volatile("bar.sync %0, %1;" :: "r"(3 + wg), "n"(128) : "memory");
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = key_lo + 8 * i;               // of the 64
        const uint32_t box = dq_s + (2 * c + col / 32) * L::kRowBox;
#pragma unroll
        for (int x = 2 * i; x < R / 2; x += 4) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 8 * (x >> 2) + 2 * quad + e;
            sts_f1(box + r * kSwizzleRow +
                       ((((col % 32) >> 2) ^ (r & 7)) << 4) + 4 * (col & 3),
                   dq256[c][x + e]);
          }
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, %1;" :: "r"(3 + wg), "n"(128) : "memory");
    if (dq_lead) {
      for (int b = 0; b < 4; ++b) {
        tma_reduce_add_3d(&tm_dq, dq_s + b * L::kRowBox,
                          128 * wg + 32 * b, w.q0, bh * G + w.g);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    w.next(G, q_first, q_last);
  }
  if (dq_lead) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");

  // rows that see no key give every key dO / T: summed into P^T's shared
  // memory once both warpgroups are past their last step
  if (kWin && has_keyless_rows(S, T_len, window)) {
    float* sum = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kPT);
    asm volatile("bar.sync 1, %0;" :: "n"(256) : "memory");
    keyless_dv<DH>(dout, static_cast<int64_t>(bh) * G, G, S, T_len, window,
                   sum, tid, kBwdTcThreads);
    asm volatile("bar.sync 1, %0;" :: "n"(256) : "memory");
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[4 * j + 2 * i] += sum[8 * j + 2 * quad];
          acc[4 * j + 2 * i + 1] += sum[8 * j + 2 * quad + 1];
        }
      }
    }
  }

  __nv_bfloat16* out = wg == 0 ? dv : dk;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = k0 + key_lo + 8 * i;
    if (kpos >= T_len) continue;
    const int64_t off = (static_cast<int64_t>(bh) * T_len + kpos) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + off + 8 * j + 2 * quad) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * mul,
                                acc[4 * j + 2 * i + 1] * mul);
    }
  }
}

template <int DH, bool kCap, bool kWin>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    void* dq, void* dk, void* dv, float* delta, float* dq_acc,
                    int64_t B, int64_t KVH, int64_t G, int64_t S,
                    int64_t T_len, float scale, int causal, int64_t window,
                    float softcap, cudaStream_t s) {
  constexpr bool kWide = DH == 256;            // its own pass (above)
  constexpr int kKeys = kWide ? kB256Keys : kBwdKeysTc;
  constexpr int kRows = kWide ? kB256Rows : kBwdRowsTc;
  const int64_t n_rows = B * KVH * G * S;
  const int64_t rows_a_cta = kBwdThreads / 32;
  const int64_t k_tiles = (T_len + kKeys - 1) / kKeys;
  if (S > INT_MAX || T_len > INT_MAX || B * KVH * G > INT_MAX ||
      k_tiles * B * KVH > INT_MAX ||
      (n_rows + rows_a_cta - 1) / rows_a_cta > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  if (!encode_3d(encode, &tm_q, q, DH, S, B * KVH * G, kRows, 1) ||
      !encode_3d(encode, &tm_do, dout, DH, S, B * KVH * G, kRows, 1) ||
      !encode_3d(encode, &tm_k, k, DH, T_len, B * KVH, kKeys, 1) ||
      !encode_3d(encode, &tm_v, v, DH, T_len, B * KVH, kKeys, 1) ||
      !encode_dq_acc(encode, &tm_dq, dq_acc, DH, S, B * KVH * G, kRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_attention_bwd_delta<__nv_bfloat16, DH>
      <<<static_cast<unsigned>((n_rows + rows_a_cta - 1) / rows_a_cta),
         kBwdThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(o),
                              static_cast<const __nv_bfloat16*>(dout), delta,
                              dq_acc, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int win = window < INT_MAX ? static_cast<int>(window) : INT_MAX;
  auto pass = [&](auto kernel, int smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<static_cast<unsigned>(k_tiles * B * KVH), kBwdTcThreads, smem,
             s>>>(tm_q, tm_k, tm_v, tm_do, tm_dq, lse, delta,
                  static_cast<const __nv_bfloat16*>(dout),
                  static_cast<__nv_bfloat16*>(dk),
                  static_cast<__nv_bfloat16*>(dv), static_cast<int>(G),
                  static_cast<int>(S), static_cast<int>(T_len), scale,
                  scale * kLog2e, causal,
                  softcap > 0.f ? scale / softcap : 0.f, softcap * kLog2e,
                  win);
    return cudaGetLastError();
  };
  if constexpr (kWide) {
    err = pass(flash_attention_bwd_dh256<kCap, kWin>, B256Layout::kBytes);
  } else {
    err = pass(flash_attention_bwd_wgmma<DH, kCap, kWin>,
               BwdTcLayout<DH>::kBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n4 = n_rows * DH / 4;
  const int64_t blocks = (n4 + 255) / 256;
  flash_attention_bwd_dq_round<<<static_cast<unsigned>(
                                     blocks < 132 * 16 ? blocks : 132 * 16),
                                 256, 0, s>>>(
      dq_acc, static_cast<__nv_bfloat16*>(dq), n4, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH, bool kExt>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dq, void* dk,
               void* dv, float* delta, int64_t B, int64_t KVH, int64_t G,
               int64_t S, int64_t T_len, float scale, int causal,
               const BwdOpts& opt, cudaStream_t s) {
  const int64_t n_rows = B * KVH * G * S;
  constexpr int kRows = BwdTile<DH>::kRows, kKeys = BwdTile<DH>::kKeys;
  const int64_t q_tiles = (S + kRows - 1) / kRows;
  const int64_t k_tiles = (T_len + kKeys - 1) / kKeys;
  const int64_t rows_a_cta = kBwdThreads / 32;
  if (q_tiles > INT_MAX || k_tiles > INT_MAX || KVH * G > 65535 ||
      B > 65535 || (n_rows + rows_a_cta - 1) / rows_a_cta > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const unsigned delta_ctas =
      static_cast<unsigned>((n_rows + rows_a_cta - 1) / rows_a_cta);
  flash_attention_bwd_delta<T, DH><<<delta_ctas, kBwdThreads, 0, s>>>(
      static_cast<const T*>(o), tdo, delta, nullptr, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float score_mul = scale * kLog2e;
  const int smem = static_cast<int>(sizeof(BwdSmem<DH>));
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv<T, DH, kExt>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dkdv<T, DH, kExt><<<dim3(static_cast<unsigned>(k_tiles),
                                               static_cast<unsigned>(KVH),
                                               static_cast<unsigned>(B)),
                                          kBwdThreads, smem, s>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<int>(KVH), static_cast<int>(G), S, T_len, scale, score_mul,
      causal, opt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_attention_bwd_dq<T, DH, kExt>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dq<T, DH, kExt><<<dim3(static_cast<unsigned>(q_tiles),
                                             static_cast<unsigned>(KVH * G),
                                             static_cast<unsigned>(B)),
                                        kBwdThreads, smem, s>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq),
      static_cast<int>(KVH), static_cast<int>(G), S, T_len, scale, score_mul,
      causal, opt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The forward entries return the cudaError_t of the launch (0 on success).
// lse, when not null, receives each query row's log-sum-exp (B, KVH, G, S)
// in float32 (only DH 64, 128 and 256 write it; another DH with lse is
// refused).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int64_t B,
                                   int64_t KVH, int64_t G, int64_t S,
                                   int64_t T, int64_t DH, float scale,
                                   int causal, int64_t window, float softcap,
                                   void* stream) {
  if (B <= 0 || KVH <= 0 || S <= 0) return 0;
  if (bad_args(G, T, window)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  float* to = static_cast<float*>(out);
  float* tl = static_cast<float*>(lse);
  if (tl != nullptr) {
    if (DH == 64) {
      return launch_f32<64, true>(tq, tk, tv, to, tl, B, KVH, G, S, T, scale,
                                  causal, window, softcap, s);
    }
    if (DH == 256) {
      return launch_f32<256, true>(tq, tk, tv, to, tl, B, KVH, G, S, T,
                                   scale, causal, window, softcap, s);
    }
    if (DH != 128) return static_cast<int>(cudaErrorInvalidValue);
    return launch_f32<128, true>(tq, tk, tv, to, tl, B, KVH, G, S, T, scale,
                                 causal, window, softcap, s);
  }
  switch (DH) {
    case 64:
      return launch_f32<64>(tq, tk, tv, to, tl, B, KVH, G, S, T, scale,
                            causal, window, softcap, s);
    case 112:
      return launch_f32<112>(tq, tk, tv, to, tl, B, KVH, G, S, T, scale,
                             causal, window, softcap, s);
    case 128:
      return launch_f32<128>(tq, tk, tv, to, tl, B, KVH, G, S, T, scale,
                             causal, window, softcap, s);
    case 256:
      return launch_f32<256>(tq, tk, tv, to, tl, B, KVH, G, S, T, scale,
                             causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int64_t B, int64_t KVH, int64_t G,
                                    int64_t S, int64_t T, int64_t DH,
                                    float scale, int causal, int64_t window,
                                    float softcap, void* stream) {
  if (B <= 0 || KVH <= 0 || S <= 0) return 0;
  if (bad_args(G, T, window)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tl = static_cast<float*>(lse);
  if (tl != nullptr) {
    if (DH == 64) {
      return launch_bf16<64, true>(q, k, v, out, tl, B, KVH, G, S, T, scale,
                                   causal, window, softcap, s);
    }
    if (DH == 256) {
      return launch_bf16<256, true>(q, k, v, out, tl, B, KVH, G, S, T, scale,
                                    causal, window, softcap, s);
    }
    if (DH != 128) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16<128, true>(q, k, v, out, tl, B, KVH, G, S, T, scale,
                                  causal, window, softcap, s);
  }
  switch (DH) {
    case 64:
      return launch_bf16<64>(q, k, v, out, tl, B, KVH, G, S, T, scale,
                             causal, window, softcap, s);
    case 112:
      return launch_bf16<112>(q, k, v, out, tl, B, KVH, G, S, T, scale,
                              causal, window, softcap, s);
    case 128:
      return launch_bf16<128>(q, k, v, out, tl, B, KVH, G, S, T, scale,
                              causal, window, softcap, s);
    case 256:
      return launch_bf16<256>(q, k, v, out, tl, B, KVH, G, S, T, scale,
                              causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward: dq (as q), dk and dv (as k) from q, k, v, out, dout and the
// forward's lse (of the same causal, window and softcap), with delta a
// float32 scratch of B KVH G S and (bfloat16 only; null for float32)
// dq_acc a float32 scratch of B KVH G S DH; DH 64, 128 or 256
// (bfloat16 at 256: no softcap).  Returns the first failing launch's
// cudaError_t (0 on success).
namespace {

template <typename E, int DH>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float* delta, int64_t B,
                   int64_t KVH, int64_t G, int64_t S, int64_t T, float scale,
                   int causal, int64_t window, float softcap,
                   cudaStream_t s) {
  const BwdOpts opt{window, softcap > 0.f ? scale / softcap : 0.f,
                    softcap * kLog2e};
  if (window > 0 || softcap > 0.f) {
    return launch_bwd<E, DH, true>(q, k, v, out, dout, lse, dq, dk, dv,
                                   delta, B, KVH, G, S, T, scale, causal, opt,
                                   s);
  }
  return launch_bwd<E, DH, false>(q, k, v, out, dout, lse, dq, dk, dv, delta,
                                  B, KVH, G, S, T, scale, causal, opt, s);
}

template <int DH>
int launch_bwd_bf16_opts(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const float* lse,
                         void* dq, void* dk, void* dv, float* delta,
                         float* dq_acc, int64_t B, int64_t KVH, int64_t G,
                         int64_t S, int64_t T, float scale, int causal,
                         int64_t window, float softcap, cudaStream_t s) {
  const bool cap = softcap > 0.f, win = window > 0;
  auto run = [&](auto launch) {
    return launch(q, k, v, out, dout, lse, dq, dk, dv, delta, dq_acc, B, KVH,
                  G, S, T, scale, causal, window, softcap, s);
  };
  if (cap && win) return run(launch_bwd_bf16<DH, true, true>);
  if (cap) return run(launch_bwd_bf16<DH, true, false>);
  if (win) return run(launch_bwd_bf16<DH, false, true>);
  return run(launch_bwd_bf16<DH, false, false>);
}

}  // namespace

extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
                                       const void* v, const void* out,
                                       const void* dout, const void* lse,
                                       void* dq, void* dk, void* dv,
                                       void* delta, void* dq_acc, int64_t B,
                                       int64_t KVH, int64_t G, int64_t S,
                                       int64_t T, int64_t DH, float scale,
                                       int causal, int64_t window,
                                       float softcap, void* stream) {
  if (B <= 0 || KVH <= 0 || S <= 0) return 0;
  if (G < 1 || T < 1 || window < 0 || (DH != 64 && DH != 128 && DH != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto run = [&](auto launch) {
    return launch(q, k, v, out, dout, static_cast<const float*>(lse), dq, dk,
                  dv, static_cast<float*>(delta), B, KVH, G, S, T, scale,
                  causal, window, softcap, static_cast<cudaStream_t>(stream));
  };
  if (DH == 256) return run(launch_bwd_f32<float, 256>);
  return DH == 64 ? run(launch_bwd_f32<float, 64>)
                  : run(launch_bwd_f32<float, 128>);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* out,
                                        const void* dout, const void* lse,
                                        void* dq, void* dk, void* dv,
                                        void* delta, void* dq_acc, int64_t B,
                                        int64_t KVH, int64_t G, int64_t S,
                                        int64_t T, int64_t DH, float scale,
                                        int causal, int64_t window,
                                        float softcap, void* stream) {
  if (B <= 0 || KVH <= 0 || S <= 0) return 0;
  if (G < 1 || T < 1 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((DH != 64 && DH != 128 && DH != 256) || dq_acc == nullptr ||
      (DH == 256 && softcap > 0.f)) {     // no softcap instance at DH 256
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto run = [&](auto launch) {
    return launch(q, k, v, out, dout, static_cast<const float*>(lse), dq, dk,
                  dv, static_cast<float*>(delta), static_cast<float*>(dq_acc),
                  B, KVH, G, S, T, scale, causal, window, softcap,
                  static_cast<cudaStream_t>(stream));
  };
  if (DH == 256) {
    return window > 0 ? run(launch_bwd_bf16<256, false, true>)
                      : run(launch_bwd_bf16<256, false, false>);
  }
  return DH == 64 ? run(launch_bwd_bf16_opts<64>)
                  : run(launch_bwd_bf16_opts<128>);
}

namespace {

// out[0..8): registers a thread, local memory a thread (bytes: spills),
// threads a CTA, dynamic shared memory a CTA (bytes), CTAs an SM can hold
// (the occupancy calculator), (Q, dO) stages, query rows a step, keys a CTA
template <class K>
int pass_attrs(K kernel, int smem, int stages, int rows, int keys,
               int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  int ctas = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        kBwdTcThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[8] = {fa.numRegs, static_cast<int>(fa.localSizeBytes),
                       kBwdTcThreads, smem, ctas, stages, rows, keys};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace

// The bfloat16 backward pass's resources at head size DH (64, 128 or 256),
// without a softcap, with a window where window > 0, into int out[8] as
// pass_attrs lists them; a query, not a launch.
extern "C" int flash_attention_bwd_attrs(int64_t DH, int64_t window,
                                         void* out) {
  int* o = static_cast<int*>(out);
  const bool win = window > 0;
  switch (DH) {
    case 64:
      return win ? pass_attrs(flash_attention_bwd_wgmma<64, false, true>,
                              BwdTcLayout<64>::kBytes, kBwdStages, kBwdRowsTc,
                              kBwdKeysTc, o)
                 : pass_attrs(flash_attention_bwd_wgmma<64, false, false>,
                              BwdTcLayout<64>::kBytes, kBwdStages, kBwdRowsTc,
                              kBwdKeysTc, o);
    case 128:
      return win ? pass_attrs(flash_attention_bwd_wgmma<128, false, true>,
                              BwdTcLayout<128>::kBytes, kBwdStages,
                              kBwdRowsTc, kBwdKeysTc, o)
                 : pass_attrs(flash_attention_bwd_wgmma<128, false, false>,
                              BwdTcLayout<128>::kBytes, kBwdStages,
                              kBwdRowsTc, kBwdKeysTc, o);
    case 256:
      return win ? pass_attrs(flash_attention_bwd_dh256<false, true>,
                              B256Layout::kBytes, kB256Stages, kB256Rows,
                              kB256Keys, o)
                 : pass_attrs(flash_attention_bwd_dh256<false, false>,
                              B256Layout::kBytes, kB256Stages, kB256Rows,
                              kB256Keys, o);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
