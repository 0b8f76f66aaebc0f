// -- backward, bfloat16 at DH 256: split Q and dO slots, a probe variant ---
//
// Not built by the port: probes/flash_bwd_probe.py --shape rg puts this in
// place of the DH-256 section of csrc/flash_attention.cu (variant split)
// to time it against the pass kept there.  The same two warpgroups split by
// product (wg 0: S^T, P^T, dV; wg 1: dP^T, dS^T, dK), the same walk, but:
//   - Q (with the rows' lse) and dO (with their D) have slots of their own:
//     kB256QStages = 2 for Q, which the first product of a step reads, so
//     it is fetched a step ahead, and kB256DoStages = 1 for dO; warp 3 of
//     wg 0 refills dO once dV is done, warp 3 of wg 1 Q once dK is.
//   - dQ = dS K unswapped (M = the step's 64 rows, two m64n64 products a
//     warpgroup over its 128 columns, dS^T and K's box both MN-major); each
//     warp stages its 16 rows of a 64-column block in a 4 KB buffer of its
//     own, as two boxes of 32 columns x 16 rows, and its lane 0 adds them
//     into dq_acc by two TMA reduce-adds: no barrier beyond the warp.
// Shared memory: K and V 64 KB, two Q slots 64 KB, a dO slot 32 KB, P^T
// 16 KB, dS^T 8 KB, the warps' dQ buffers 32 KB, the rows' lse and D:
// ~218 KB.

constexpr int kB256Keys = 64;            // keys a CTA
constexpr int kB256Rows = 64;            // query rows a step (R)
constexpr int kB256QStages = 2;          // Q slots (a step ahead)
constexpr int kB256DoStages = 1;         // dO slots
constexpr int kB256DqRows = 16;          // a warp's rows of dQ
constexpr int kB256DqBufs = 1;           // its staging buffers (4 KB each)
constexpr int kB256Stages = kB256QStages;  // (the resources query's)
constexpr bool kB256HeadsOuter = true;   // the walk: heads outer, rows inner
constexpr int kBarP = 1, kBarDs = 2;     // named barriers

struct B256Layout {                      // byte offsets from a 1024 boundary
  static constexpr int kRows = kB256Rows;
  static constexpr int kBoxes = 256 / kBoxCols;              // 64 columns
  static constexpr int kKVBox = kB256Keys * kSwizzleRow;
  static constexpr int kRowBox = kRows * kSwizzleRow;         // also dQ's
  static constexpr int kPart = kBoxes * kRowBox;              // Q or dO
  static constexpr int kK = 0;
  static constexpr int kV = kBoxes * kKVBox;
  static constexpr int kQ0 = 2 * kBoxes * kKVBox;             // Q slots
  static constexpr int kDO0 = kQ0 + kB256QStages * kPart;     // dO slots
  static constexpr int kPT = kDO0 + kB256DoStages * kPart;    // float32
  static constexpr int kDS = kPT + kB256Keys * kRows * 4;     // dS^T
  static constexpr int kDQ = kDS + kB256Keys * kSwizzleRow;   // a warp's:
  static constexpr int kDqBox = kB256DqRows * kSwizzleRow;    // 2 boxes a
  static constexpr int kDqBuf = 2 * kDqBox;                   // buffer
  static constexpr int kLse = kDQ + 8 * kB256DqBufs * kDqBuf;  // a Q slot
  static constexpr int kD = kLse + kB256QStages * kRows * 4;   // a dO slot
  static constexpr int kBars = kD + kB256DoStages * kRows * 4;
  // K/V's barrier, then each Q slot's "full" and "empty", then each dO
  // slot's
  static constexpr int kBytes =
      kBars + 8 * (1 + 2 * (kB256QStages + kB256DoStages)) + 1024;
  static_assert(kRows == 64, "R: the M of dQ's products");
  static_assert(kBytes <= 232448, "past the 227 KB a block may take");
};

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
  constexpr int R = kB256Rows, NQ = kB256QStages, ND = kB256DoStages;
  constexpr int DH = 256;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1024 B
  const uint32_t bar_kv = base + L::kBars;
  // Q slot s's "full" at bar_q + 16 s, its "empty" 8 bytes on; dO's alike
  const uint32_t bar_q = bar_kv + 8;
  const uint32_t bar_do = bar_q + 16 * NQ;
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
  // warp 3 of wg 0 refills the dO slots, warp 3 of wg 1 the Q slots (and
  // copies K and V once)
  const bool loader = warp == 3;
  const CUtensorMap* tm_ld = wg == 0 ? &tm_do : &tm_q;
  const float* vals_ld = wg == 0 ? delta : lse;
  const int n_ld = wg == 0 ? ND : NQ;                  // the loader's slots
  const uint32_t tile_ld = base + (wg == 0 ? L::kDO0 : L::kQ0);
  const uint32_t vals_ld_s = base + (wg == 0 ? L::kD : L::kLse);
  const uint32_t bar_ld = wg == 0 ? bar_do : bar_q;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < NQ + ND; ++s) {
      mbar_init(bar_q + 16 * s, 1 + 32);        // full: tx, 32 cp.async
      mbar_init(bar_q + 16 * s + 8, 8);         // empty: one per warp
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
    for (int it = 0; it < n_ld && it < n_items; ++it) {
      b256_load_part(tm_ld, vals_ld, tile_ld + it * L::kPart,
                     vals_ld_s + it * R * 4, bar_ld + 16 * it, bh * G + ld.g,
                     ld.q0, S, lane);
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
  const uint32_t dq_w = base + L::kDQ + (tid >> 5) * kB256DqBufs * L::kDqBuf;
  // the 128B-swizzle phase of dS^T's rows key_lo and key_lo + 8, and of
  // the rows this thread stages of dQ
  const int sw = lane >> 2;
  const bool edge = k0 + kB256Keys > T_len;
  if (n_items > 0) mbar_wait(bar_kv, 0);
  B256Walk w(q_first, q_last);
  for (int it = 0; it < n_items; ++it) {
    const int sq = it % NQ, sd = it % ND;
    const uint32_t pq = (it / NQ) & 1, pd = (it / ND) & 1;
    const uint32_t q_s = base + L::kQ0 + sq * L::kPart;
    const uint32_t do_s = base + L::kDO0 + sd * L::kPart;
    const uint32_t full_q = bar_q + 16 * sq, full_do = bar_do + 16 * sd;
    // this thread's query rows' lse at lse_s + 32 j, D at d_s + 32 j: rows
    // 8 j + 2 quad, + 1
    const uint32_t lse_s = base + L::kLse + sq * R * 4 + 8 * quad;
    const uint32_t d_s = base + L::kD + sd * R * 4 + 8 * quad;
    // wg 0 starts on Q, wg 1 on dO
    if (wg == 0) {
      mbar_wait(full_q, pq);
    } else {
      mbar_wait(full_do, pd);
    }
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
        const float2 l = lds_f2(lse_s + 32 * j);
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
        const float2 dd = lds_f2(d_s + 32 * j);
        sp[4 * j] = p.x * (sp[4 * j] - dd.x);
        sp[4 * j + 1] = p.y * (sp[4 * j + 1] - dd.y);
        sp[4 * j + 2] = p.z * (sp[4 * j + 2] - dd.x);
        sp[4 * j + 3] = p.w * (sp[4 * j + 3] - dd.y);
      }
    }
    // wg 0 is done with Q and lse, wg 1 with dO and D
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive((wg == 0 ? full_q : full_do) + 8);
#pragma unroll
    for (int x = 0; x < R / 2; x += 2) pk[x / 2] = pack_bf16(sp[x], sp[x + 1]);
    if (wg == 1) {
      // dS^T to shared memory, 128B-swizzled: row = key, query row r at
      // byte 2 r (chunk j of 16 bytes: rows 8 j .. 8 j + 7)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t row = ds + (key_lo + 8 * i) * kSwizzleRow + 4 * quad;
#pragma unroll
        for (int j = 0; j < R / 8; ++j) {
          sts_u32(row + ((j ^ sw) << 4), pk[2 * j + i]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }

    // wg 0: dV += P^T dO, wg 1: dK += dS^T Q: R / 16 k-steps of 16 query
    // rows, 2048 bytes apart in dO and Q (B MN-major, its four 64-column
    // boxes kRowBox apart); each waits for the other's part
    if (wg == 0) {
      mbar_wait(full_do, pd);
    } else {
      mbar_wait(full_q, pq);
    }
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

    // dQ (R rows x 64 columns) = dS K for the warpgroup's boxes 2 wg and
    // 2 wg + 1 of K: 4 k-steps of 16 keys, 2048 bytes apart in dS^T (A,
    // MN-major) and in K (B, MN-major), a commit group each.  dq256[c][4 j
    // + 2 i + e]: query row q0 + key_lo + 8 i, column 128 wg + 64 c + 8 j +
    // 2 quad + e
    float dq256[2][32];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int kk = 0; kk < kB256Keys / 16; ++kk) {
        wgmma_ss_mn(dq256[c],
                    sw128_desc(ds + kk * 16 * kSwizzleRow, L::kRowBox),
                    sw128_desc(base + L::kK + (2 * wg + c) * L::kKVBox +
                                   kk * 16 * kSwizzleRow, L::kKVBox),
                    kk > 0);
      }
      wgmma_commit();
    }
    // once dV (dK) has read its part, the warp hands it back; the loader
    // refills it for the step n_ld on
    wgmma_wait<2>();
    fence_regs(acc);
    fence_regs(pk);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    const uint32_t full_ld = wg == 0 ? full_do : full_q;
    if (lane == 0) mbar_arrive(full_ld + 8);
    if (loader && it + n_ld < n_items) {
      mbar_wait(full_ld + 8, wg == 0 ? pd : pq);
      b256_load_part(tm_ld, vals_ld, wg == 0 ? do_s : q_s,
                     (wg == 0 ? d_s : lse_s) - 8 * quad, full_ld,
                     bh * G + ld.g, ld.q0, S, lane);
      ld.next(G, q_first, q_last);
    }

    // dQ goes out a warp at a time: each warp stages its 16 rows of a
    // 64-column block in a buffer of its own, as two boxes of 32 columns x
    // 16 rows (float32, 128B-swizzled: a row's 16-byte chunk XOR the row's
    // phase), and its lane 0 adds them into dq_acc by two TMA reduce-adds;
    // no barrier beyond the warp.  The first block is staged while the
    // second's product is still on the tensor cores.
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c == 0) {
        wgmma_wait<1>();
        fence_regs(dq256[0]);
      } else {
        wgmma_wait<0>();
        fence_regs(dq256[1]);
      }
      const uint32_t buf = dq_w + (2 * it + c) % kB256DqBufs * L::kDqBuf;
      if (lane == 0) {              // its adds of kB256DqBufs blocks ago
        asm volatile("cp.async.bulk.wait_group.read %0;"
                     :: "n"(kB256DqBufs - 1) : "memory");
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t row = buf + (sw + 8 * i) * kSwizzleRow + 8 * (quad & 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sts_f2(row + (j >> 2) * L::kDqBox +
                     (((2 * (j & 3) + (quad >> 1)) ^ sw) << 4),
                 dq256[c][4 * j + 2 * i], dq256[c][4 * j + 2 * i + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        for (int h = 0; h < 2; ++h) {
          tma_reduce_add_3d(&tm_dq, buf + h * L::kDqBox,
                            128 * wg + 64 * c + 32 * h, w.q0 + 16 * warp,
                            bh * G + w.g);
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
    w.next(G, q_first, q_last);
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");

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
