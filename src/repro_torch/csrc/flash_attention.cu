// GQA flash attention, forward, for Hopper (sm_90a):
//   out[b, h, g, i] = softmax_j(mask(cap(q[b, h, g, i] . k[b, h, j] * scale)))
//                     . v[b, h, j]
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, body _flash_kernel).  Layouts as there, contiguous:
// q (B, KVH, G, S, DH), k and v (B, KVH, T, DH), out (B, KVH, G, S, DH), all
// float32 or all bfloat16.  The mask keeps key j for query i where (causal)
// j <= i and (window > 0) i - j < window; masked scores are -1e30 as there,
// and cap(x) = tanh(x / softcap) * softcap when softcap > 0.  The arithmetic
// is float32 (the TPU kernel upcasts too); the output is rounded once, after
// dividing by max(l, 1e-30).  Offsets are 64-bit.
//
// What changes from the TPU.  There the grid (B, KVH, S / bq, T / bk) runs
// in order and (m, l, acc) wait in VMEM scratch across the kv steps.  Here
// one CTA owns one (q tile, kv head, batch row) and loops over the key tiles
// itself, with m, l and its share of the output accumulator in registers.
// A CTA takes all G query heads of its KV head: its 64 rows are G heads x
// (64 / G) positions (16 at G = 4), so every K/V tile staged in shared
// memory serves all of them.  Any S and T run: the ragged edges are masked
// here (key positions >= T score -inf, query rows >= S are not stored), with
// no block-multiple rule.  Key tiles that the mask empties for every row of
// the CTA are skipped (with causal, tiles past the last query; with a
// window, tiles wholly before q0 - window): the function is unchanged and
// the causal work halves.  The causal CTAs with most tiles start first.
//
// The products.  Each thread owns 4 rows x 4 keys of the 64 x 32 score tile
// and 4 rows x DH/8 columns of the output; Q and K are staged transposed
// (Q^T, K^T) and P transposed, so each step of either product reads two
// float4 from shared memory for 16 FMAs.  All of it is float32 on the CUDA
// cores: no tensor cores yet.
//
// What bounds it: operations.  At the llama3-8b prefill (B 4, KVH 8, G 4,
// S = T = 2048, DH 128, bf16, causal) the two products are 2 x 2 x 4 x 32 x
// 2048^2 x 128 / 2 = 1.37e11 FLOP, 0.139 ms at the 989 TFLOP/s of dense
// bf16 tensor cores; q, k, v and out are 168 MB, 0.050 ms at 3.35 TB/s.
// This kernel runs on the CUDA cores (67 TFLOP/s of float32 FMA at best),
// so it sits one to two orders of magnitude above that bound.  The remedy,
// left for a later change: bf16 wgmma with a TMA ring of K/V tiles and warp
// specialisation (FlashAttention-3's shape).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;     // 16 row groups x 8 key/column groups
constexpr int kRows = 64;         // query rows per CTA: G heads x 64 / G
constexpr int kBK = 32;           // keys per tile
constexpr int kPtStride = kRows + 4;   // P^T rows, padded, 16-byte aligned
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

template <typename T, int N>
__device__ __forceinline__ void store_f32(T* __restrict__ p, const float* x) {
  using V = typename Vec<N * sizeof(T)>::type;
  V raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = from_f32<T>(x[i]);
  *reinterpret_cast<V*>(p) = raw;
}

template <int DH>
struct Smem {
  float qt[DH][kRows];            // Q^T of the CTA's rows
  float kt[DH][kBK];              // K^T of the tile
  float v[kBK][DH];               // V of the tile
  float pt[kBK][kPtStride];       // P^T of the tile
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int kvh,
                       int G, int64_t S, int64_t T_len, int bq, float scale,
                       int causal, int64_t window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);
  constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int kChunks = DH / kVec;            // 16-byte loads per row
  constexpr int kCols = DH / 32;                // float4 output columns
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int64_t q0 = (static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x) * bq;
  const int64_t q_last = (q0 + bq < S ? q0 + bq : S) - 1;
  const int rows = G * bq;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * kvh + blockIdx.y;
  const T* qb = q + bh * G * S * DH;             // q[b, h, g, s] at (g S + s) DH
  const T* kb = k + bh * T_len * DH;
  const T* vb = v + bh * T_len * DH;

  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c % kRows, dc = c / kRows;
    const int64_t pos = q0 + r % bq;
    float x[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) x[i] = 0.f;
    if (r < rows && pos < S) {
      load_f32<T, kVec>(qb + ((r / bq) * S + pos) * DH + dc * kVec, x);
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) sm.qt[dc * kVec + i][r] = x[i];
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
      float x[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
      if (k0 + kk < T_len) {
        load_f32<T, kVec>(kb + (k0 + kk) * DH + dc * kVec, x);
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) sm.kt[dc * kVec + i][kk] = x[i];
    }
    // V: neighbouring threads take neighbouring 16 bytes of a row
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int kk = c / kChunks, dc = c % kChunks;
      float x[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
      if (k0 + kk < T_len) {
        load_f32<T, kVec>(vb + (k0 + kk) * DH + dc * kVec, x);
      }
#pragma unroll
      for (int i = 0; i < kVec; i += 4) {
        *reinterpret_cast<float4*>(&sm.v[kk][dc * kVec + i]) =
            make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
      }
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows || qpos[i] >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + ((bh * G + r / bq) * S + qpos[i]) * DH;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = o[i][cc * 4 + e] / denom;
      store_f32<T, 4>(orow + tx * 4 + 32 * cc, y);
    }
  }
}

template <typename T, int DH>
int launch_dh(const T* q, const T* k, const T* v, T* out, int64_t B,
              int64_t KVH, int64_t G, int64_t S, int64_t T_len, float scale,
              int causal, int64_t window, float softcap, cudaStream_t s) {
  const int bq = static_cast<int>(kRows / G);
  const int64_t n_qt = (S + bq - 1) / bq;
  if (n_qt > INT_MAX || KVH > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = sizeof(Smem<DH>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_qt), static_cast<unsigned>(KVH),
                  static_cast<unsigned>(B));
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, s>>>(
      q, k, v, out, static_cast<int>(KVH), static_cast<int>(G), S, T_len, bq,
      scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B,
           int64_t KVH, int64_t G, int64_t S, int64_t T_len, int64_t DH,
           float scale, int causal, int64_t window, float softcap,
           void* stream) {
  if (B <= 0 || KVH <= 0 || S <= 0) return 0;
  if (G < 1 || G > kRows || T_len < 1 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  T* to = static_cast<T*>(out);
  switch (DH) {
    case 64:
      return launch_dh<T, 64>(tq, tk, tv, to, B, KVH, G, S, T_len, scale,
                              causal, window, softcap, s);
    case 128:
      return launch_dh<T, 128>(tq, tk, tv, to, B, KVH, G, S, T_len, scale,
                               causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int64_t B, int64_t KVH,
                                   int64_t G, int64_t S, int64_t T,
                                   int64_t DH, float scale, int causal,
                                   int64_t window, float softcap,
                                   void* stream) {
  return launch<float>(q, k, v, out, B, KVH, G, S, T, DH, scale, causal,
                       window, softcap, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int64_t B,
                                    int64_t KVH, int64_t G, int64_t S,
                                    int64_t T, int64_t DH, float scale,
                                    int causal, int64_t window, float softcap,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, KVH, G, S, T, DH, scale,
                               causal, window, softcap, stream);
}
