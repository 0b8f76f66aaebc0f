// The RG-LRU linear recurrence for Hopper (sm_90a):
//   h_t = a_t * h_{t-1} + beta_t * gx_t,   t = 0 .. S-1, from h_{-1} = h0
//
// Replaces no TPU kernel.  The JAX package runs this recurrence
// (src/repro/models/rglru.py, _step under lax.scan in rglru_apply and
// rglru_decode) as one loop on the device in plain jnp; no PyTorch call
// computes a linear recurrence, and a loop of torch ops would launch
// several kernels a step (26 layers x 8,192 steps a recurrentgemma-9b
// prefill).  Layouts, all float32 and contiguous: a, beta, gx (B, S, W);
// h0 (B, W); out hs (B, S, W), every h_t, and h_last (B, W), h_{S-1} (h0
// when S = 0).  Offsets are 64-bit.
//
// The order is part of the contract: each step is
//   h = fma(a_t, h, beta_t * gx_t)
// with the product beta_t gx_t rounded first and a_t h fused into the add,
// written with __fmul_rn and __fmaf_rn so that nvcc's own contraction
// cannot choose another form.  It is what the JAX scan computes on the CPU
// (tests/test_torch_recurrentgemma.py holds the plain version to it bit
// for bit), and what kernels/rglru_scan/ref.py computes.  Prefill and
// decode (S = 1) run the same launch, so they share one arithmetic.
//
// What bounds it: bytes.  At recurrentgemma-9b's prefill (B 2, S 8192, W
// 4096) a, beta, gx and hs are 4 x 268 MB, 0.32 ms at 3.35 TB/s; the
// recurrence is 2 flops an element.  Each (batch row, channel) walks its S
// steps in order (no chunked or associative scan: that would reorder the
// sums), one thread a channel, neighbouring threads on neighbouring
// channels so that every load and store coalesces.  That leaves only B x W
// = 8,192 threads, two warps an SM, so the bytes in flight come from
// instruction-level parallelism: a, beta and gx do not depend on h, and a
// thread loads the next kU steps of all three into registers (a ring of
// two chunks) before it computes the current chunk, kU x 12 bytes a thread
// in flight (3 MB over the card at kU = 32).  Loads and stores carry the
// streaming hint: every byte is touched once.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;     // 64 channels a CTA: B x W / 64 CTAs
constexpr int kU = 32;           // steps a chunk; two chunks in registers

struct Chunk {
  float a[kU], b[kU], g[kU];
};

// Steps t0 .. t0 + n - 1 (n <= kU) of one channel; the rest left zero.
__device__ __forceinline__ void load_chunk(Chunk& c, const float* a,
                                           const float* beta, const float* gx,
                                           int64_t W, int64_t off, int n) {
#pragma unroll
  for (int j = 0; j < kU; ++j) {
    const bool in = j < n;
    const int64_t o = off + j * W;
    c.a[j] = in ? __ldcs(a + o) : 0.f;
    c.b[j] = in ? __ldcs(beta + o) : 0.f;
    c.g[j] = in ? __ldcs(gx + o) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ beta,
                  const float* __restrict__ gx, const float* __restrict__ h0,
                  float* __restrict__ hs, float* __restrict__ h_last,
                  int64_t S, int64_t W) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= W) return;
  const int64_t b = blockIdx.y;
  const int64_t base = b * S * W + w;
  float h = h0[b * W + w];
  Chunk cur, next;
  load_chunk(cur, a, beta, gx, W, base, S < kU ? static_cast<int>(S) : kU);
  for (int64_t t0 = 0; t0 < S; t0 += kU) {
    const int64_t t1 = t0 + kU;
    const int64_t left = S - t1;
    load_chunk(next, a, beta, gx, W, base + t1 * W,
               left <= 0 ? 0 : (left < kU ? static_cast<int>(left) : kU));
    const int n = S - t0 < kU ? static_cast<int>(S - t0) : kU;
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      if (j < n) {
        h = __fmaf_rn(cur.a[j], h, __fmul_rn(cur.b[j], cur.g[j]));
        __stcs(hs + base + (t0 + j) * W, h);
      }
    }
    cur = next;
  }
  h_last[b * W + w] = h;
}

// -- backward ------------------------------------------------------------------
//
// Replaces no TPU kernel either: the JAX package differentiates its
// lax.scan over _step.  With g_t the cotangent of h_t, each thread owns
// one (batch row, channel) and walks t from S-1 down to 0:
//   g_t = fma(a_{t+1}, g_{t+1}, dhs_t)    (g_S = dh_last, a_S = 1: g_{S-1} =
//                                          dhs_{S-1} + dh_last, one rounding)
//   da_t = g_t h_{t-1}   (h_{-1} = h0, else the forward's saved hs)
//   dbeta_t = g_t gx_t,  dgx_t = g_t beta_t,  dh0 = a_0 g_0
// with __fmaf_rn and __fmul_rn, so that kernels/rglru_scan/ref.py
// (rglru_scan_bwd_ref, fma_f32 where this has fmaf) gives the same bits.
// What bounds it: bytes, five float32 reads (a, beta, gx, hs, dhs) and
// three writes an element (2.1 GB, 0.64 ms at 3.35 TB/s at the training
// shape (2, 8192, 4096)).  As the forward, a thread loads the next kUB
// steps of all five (walking back) into registers before it computes the
// current ones; five arrays of two chunks are 160 registers, so a chunk
// is 16 steps here.

constexpr int kUB = 16;          // steps a chunk of the backward

struct BwdChunk {
  float a[kUB], b[kUB], g[kUB], hp[kUB], dh[kUB];
};

// Steps t0 .. t0 + n - 1 (n <= kUB) of one channel, h_{t-1} beside each
// (h0 at t = 0); the rest left zero.  off is the channel's element of step
// t0 (read only where a step is in).
__device__ __forceinline__ void load_bwd_chunk(
    BwdChunk& c, const float* a, const float* beta, const float* gx,
    const float* hs, const float* dhs, float h0, int64_t W, int64_t off,
    int64_t t0, int n) {
#pragma unroll
  for (int j = 0; j < kUB; ++j) {
    const bool in = j < n;
    const int64_t o = off + j * W;
    c.a[j] = in ? __ldcs(a + o) : 0.f;
    c.b[j] = in ? __ldcs(beta + o) : 0.f;
    c.g[j] = in ? __ldcs(gx + o) : 0.f;
    c.dh[j] = in ? __ldcs(dhs + o) : 0.f;
    c.hp[j] = in && t0 + j > 0 ? __ldcs(hs + o - W) : h0;
  }
}

// The chunks run from the last down; within one, the steps from the last
// down (j = kUB - 1 - i, so that every index is a constant once unrolled).
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const float* __restrict__ a,
                      const float* __restrict__ beta,
                      const float* __restrict__ gx,
                      const float* __restrict__ h0,
                      const float* __restrict__ hs,
                      const float* __restrict__ dhs,
                      const float* __restrict__ dh_last,
                      float* __restrict__ da, float* __restrict__ dbeta,
                      float* __restrict__ dgx, float* __restrict__ dh0,
                      int64_t S, int64_t W) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= W) return;
  const int64_t b = blockIdx.y;
  const int64_t base = b * S * W + w;
  const float h0v = h0[b * W + w];
  float g = dh_last != nullptr ? dh_last[b * W + w] : 0.f;
  float a_next = 1.f;
  int64_t t0 = (S + kUB - 1) / kUB * kUB - kUB;     // the last chunk's start
  BwdChunk cur, next;
  load_bwd_chunk(cur, a, beta, gx, hs, dhs, h0v, W, base + t0 * W, t0,
                 t0 >= 0 ? static_cast<int>(S - t0) : 0);
  for (; t0 >= 0; t0 -= kUB) {
    load_bwd_chunk(next, a, beta, gx, hs, dhs, h0v, W,
                   base + (t0 - kUB) * W, t0 - kUB, t0 > 0 ? kUB : 0);
    const int n = S - t0 < kUB ? static_cast<int>(S - t0) : kUB;
#pragma unroll
    for (int i = 0; i < kUB; ++i) {
      const int j = kUB - 1 - i;
      if (j < n) {
        g = __fmaf_rn(a_next, g, cur.dh[j]);
        const int64_t o = base + (t0 + j) * W;
        __stcs(da + o, __fmul_rn(g, cur.hp[j]));
        __stcs(dbeta + o, __fmul_rn(g, cur.g[j]));
        __stcs(dgx + o, __fmul_rn(g, cur.b[j]));
        a_next = cur.a[j];
      }
    }
    cur = next;
  }
  dh0[b * W + w] = __fmul_rn(a_next, g);
}

bool bad_grid(int64_t B, int64_t S, int64_t W) {
  return S < 0 || B > 65535 || (W + kThreads - 1) / kThreads > 0x7fffffff;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int rglru_scan_f32(const void* a, const void* beta, const void* gx,
                              const void* h0, void* hs, void* h_last,
                              int64_t B, int64_t S, int64_t W, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (bad_grid(B, S, W)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(beta),
      static_cast<const float*>(gx), static_cast<const float*>(h0),
      static_cast<float*>(hs), static_cast<float*>(h_last), S, W);
  return static_cast<int>(cudaGetLastError());
}

// The backward: da, dbeta, dgx (B, S, W) and dh0 (B, W) from the forward's
// inputs, its hs, dhs (B, S, W) and dh_last (B, W) or null (no cotangent),
// all float32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int rglru_scan_bwd_f32(const void* a, const void* beta,
                                  const void* gx, const void* h0,
                                  const void* hs, const void* dhs,
                                  const void* dh_last, void* da, void* dbeta,
                                  void* dgx, void* dh0, int64_t B, int64_t S,
                                  int64_t W, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (bad_grid(B, S, W)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  rglru_scan_bwd_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(beta),
      static_cast<const float*>(gx), static_cast<const float*>(h0),
      static_cast<const float*>(hs), static_cast<const float*>(dhs),
      static_cast<const float*>(dh_last), static_cast<float*>(da),
      static_cast<float*>(dbeta), static_cast<float*>(dgx),
      static_cast<float*>(dh0), S, W);
  return static_cast<int>(cudaGetLastError());
}
