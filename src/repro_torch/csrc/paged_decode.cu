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
// size; repeated pages in a table are fine (the pool is only read).  A table
// entry outside [0, P) is clamped into it, so that no index reads outside the
// pool (the plain version raises on one).  lengths are clamped to
// [0, pages_per_seq * page]; a row of length 0 gives zeros.
//
// What changes from the TPU.  There the page table is scalar-prefetched and
// drives the K/V BlockSpecs of a grid (B, KVH, pages_per_seq) that visits
// every page in order, with (m, l, acc) in VMEM scratch.  Here one CTA owns
// one (batch row, kv head) and reads its table row and length itself.  Its
// 8 warps split the positions: warp w takes the 32-position chunks w, w + 8,
// ... up to ceil(length / 32), so pages wholly past the length are never
// read.  In a chunk, lane t owns position t: it finds its page through the
// table, reads its K row with 16-byte loads (64 columns in flight at once)
// and scores it against the G query heads, which the CTA staged in shared
// memory.  The chunk's softmax update takes warp shuffles, and for P V each
// lane owns DH / 32 columns and walks the chunk's positions, reading V rows
// whose addresses and weights it takes by shuffle from their owners.  Each
// warp keeps its own (m, l, acc) in registers; the 8 are merged at the end
// through shared memory.
//
// What bounds it: bytes.  At the llama3-8b decode (B 4, KVH 8, G 4, DH 128,
// length ~2080, page 16, bf16) K and V are 4 x 8 x 2080 x 128 x 2 B x 2 =
// 34 MB: 0.010 ms at 3.35 TB/s.  The grid is B x KVH = 32 CTAs on 132 SMs,
// so each CTA must pull ~1 MB through one SM.  The remedy, left for a later
// change: split each row's pages over several CTAs (flash-decoding) and
// merge their (m, l, acc) in a second pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
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
template <> struct Vec<4> { using type = unsigned int; };

// N elements of T from p (aligned to their size together) as float32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float* out) {
  using V = typename Vec<N * sizeof(T)>::type;
  const V raw = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
}

template <typename T, int G, int DH>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int kvh, int64_t P, int page, int pps, float scale) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int kDpl = DH / 32;          // output columns per lane
  __shared__ __align__(16) float qs[G][DH];
  __shared__ float red_acc[kWarps][DH];
  __shared__ float red_ml[kWarps][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.y;
  const int64_t bh = b * kvh + blockIdx.x;
  const T* qb = q + bh * G * DH;
  for (int i = threadIdx.x; i < G * DH; i += kWarps * 32) {
    qs[i / DH][i % DH] = to_f32(qb[i]);
  }
  __syncthreads();

  const int64_t cap = static_cast<int64_t>(pps) * page;
  int64_t len = lengths[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int* trow = page_table + b * pps;
  const int64_t head = static_cast<int64_t>(blockIdx.x) * P * page * DH;
  const T* kh = k_pages + head;
  const T* vh = v_pages + head;

  float m[G], l[G], acc[G][kDpl];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kMasked;
    l[g] = 0.f;                      // this lane's share of the sum
#pragma unroll
    for (int e = 0; e < kDpl; ++e) acc[g][e] = 0.f;
  }

  const int64_t n_chunks = (len + 31) / 32;
  for (int64_t c = warp; c < n_chunks; c += kWarps) {
    const int64_t t = c * 32 + lane;
    const bool valid = t < len;
    int64_t row = 0;                 // offset of position t's K/V row
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (valid) {
      int64_t phys = trow[t / page];
      phys = phys < 0 ? 0 : (phys >= P ? P - 1 : phys);
      row = (phys * page + t % page) * DH;
      // 64 columns at a time: 4-8 loads in flight, 64 registers
#pragma unroll
      for (int d0 = 0; d0 < DH; d0 += 64) {
        float kx[64];
#pragma unroll
        for (int d = 0; d < 64; d += kVec) {
          load_f32<T, kVec>(kh + row + d0 + d, kx + d);
        }
#pragma unroll
        for (int d = 0; d < 64; d += 4) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 qv =
                *reinterpret_cast<const float4*>(&qs[g][d0 + d]);
            s[g] = fmaf(qv.x, kx[d], s[g]);
            s[g] = fmaf(qv.y, kx[d + 1], s[g]);
            s[g] = fmaf(qv.z, kx[d + 2], s[g]);
            s[g] = fmaf(qv.w, kx[d + 3], s[g]);
          }
        }
      }
    }
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float x = valid ? s[g] * scale : -INFINITY;
      float cmax = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
      }
      const float m_new = fmaxf(m[g], cmax);
      const float corr = exp2f((m[g] - m_new) * kLog2e);
      p[g] = exp2f((x - m_new) * kLog2e);
      l[g] = l[g] * corr + p[g];
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < kDpl; ++e) acc[g][e] *= corr;
    }
    const int n_valid =
        static_cast<int>(len - c * 32 < 32 ? len - c * 32 : 32);
    for (int tt = 0; tt < n_valid; ++tt) {
      const long long rt =
          __shfl_sync(0xffffffffu, static_cast<long long>(row), tt);
      float vx[kDpl];
      load_f32<T, kDpl>(vh + rt + lane * kDpl, vx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pg = __shfl_sync(0xffffffffu, p[g], tt);
#pragma unroll
        for (int e = 0; e < kDpl; ++e) acc[g][e] = fmaf(pg, vx[e], acc[g][e]);
      }
    }
  }

  // merge the warps' (m, l, acc), one query head at a time
  T* ob = out + bh * G * DH;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float lg = l[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lg += __shfl_xor_sync(0xffffffffu, lg, off);
    }
#pragma unroll
    for (int e = 0; e < kDpl; ++e) red_acc[warp][lane * kDpl + e] = acc[g][e];
    if (lane == 0) {
      red_ml[warp][0] = m[g];
      red_ml[warp][1] = lg;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < DH; d += kWarps * 32) {
      float mx = kMasked;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_ml[w][0]);
      float lsum = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = exp2f((red_ml[w][0] - mx) * kLog2e);
        lsum = fmaf(red_ml[w][1], f, lsum);
        o = fmaf(red_acc[w][d], f, o);
      }
      ob[g * DH + d] = from_f32<T>(o / fmaxf(lsum, 1e-30f));
    }
    __syncthreads();                 // the next head overwrites red_*
  }
}

template <typename T, int G>
int launch_g(const T* q, const T* kp, const T* vp, const int* table,
             const int* lengths, T* out, int64_t B, int64_t KVH, int64_t P,
             int64_t page, int64_t pps, int64_t DH, float scale,
             cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(KVH), static_cast<unsigned>(B));
  switch (DH) {
    case 64:
      paged_decode_kernel<T, G, 64><<<grid, kWarps * 32, 0, s>>>(
          q, kp, vp, table, lengths, out, static_cast<int>(KVH), P,
          static_cast<int>(page), static_cast<int>(pps), scale);
      break;
    case 128:
      paged_decode_kernel<T, G, 128><<<grid, kWarps * 32, 0, s>>>(
          q, kp, vp, table, lengths, out, static_cast<int>(KVH), P,
          static_cast<int>(page), static_cast<int>(pps), scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* lengths, void* out, int64_t B,
           int64_t KVH, int64_t G, int64_t P, int64_t page, int64_t pps,
           int64_t DH, float scale, void* stream) {
  if (B <= 0 || KVH <= 0) return 0;
  if (P < 1 || page < 1 || pps < 1 || page > INT32_MAX || pps > INT32_MAX ||
      KVH > INT32_MAX || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k_pages);
  const T* tv = static_cast<const T*>(v_pages);
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  T* to = static_cast<T*>(out);
  switch (G) {
    case 1:
      return launch_g<T, 1>(tq, tk, tv, pt, ln, to, B, KVH, P, page, pps, DH,
                            scale, s);
    case 2:
      return launch_g<T, 2>(tq, tk, tv, pt, ln, to, B, KVH, P, page, pps, DH,
                            scale, s);
    case 4:
      return launch_g<T, 4>(tq, tk, tv, pt, ln, to, B, KVH, P, page, pps, DH,
                            scale, s);
    case 8:
      return launch_g<T, 8>(tq, tk, tv, pt, ln, to, B, KVH, P, page, pps, DH,
                            scale, s);
    case 16:
      return launch_g<T, 16>(tq, tk, tv, pt, ln, to, B, KVH, P, page, pps, DH,
                             scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success).
extern "C" int paged_decode_f32(const void* q, const void* k_pages,
                                const void* v_pages, const void* page_table,
                                const void* lengths, void* out, int64_t B,
                                int64_t KVH, int64_t G, int64_t P,
                                int64_t page, int64_t pps, int64_t DH,
                                float scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, page_table, lengths, out, B, KVH,
                       G, P, page, pps, DH, scale, stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* k_pages,
                                 const void* v_pages, const void* page_table,
                                 const void* lengths, void* out, int64_t B,
                                 int64_t KVH, int64_t G, int64_t P,
                                 int64_t page, int64_t pps, int64_t DH,
                                 float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, lengths, out,
                               B, KVH, G, P, page, pps, DH, scale, stream);
}
