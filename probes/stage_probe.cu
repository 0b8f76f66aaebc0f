// Probe: what staging a table in shared memory costs on the card, by way.
// Built and run by probes/stage_probe.py; not part of the port.
//
// Each CTA of 1,024 threads stages the same `bytes` of a table into its
// shared memory, then exits:
//   way 0  nothing (the launch floor)
//   way 1  plain 16-byte loads by all threads (what gather_rows_smem did
//          before its clusters, with 4-byte loads)
//   way 2  one TMA bulk copy into the CTA's own shared memory
//   way 3  clusters of `cluster` CTAs: each bulk-copies 1/cluster of the
//          table, multicast to the whole cluster, with release/acquire
//          cluster barriers before the copies and before exit
//   way 4  as 3 with relaxed arrives (gather_rows_smem's barriers)
//   way 5  as 4 without the barrier before exit
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_phase0(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar) : "memory");
  }
}

__device__ __forceinline__ void cluster_barrier(bool relaxed) {
  if (relaxed) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
}

__global__ void __launch_bounds__(1024)
stage_kernel(const float* table, uint32_t bytes, int way, int cluster,
             float* sink) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bar = smem_u32(smem);
  unsigned char* s = smem + 16;
  if (way == 0) return;
  if (way == 1) {
    const int4* g = reinterpret_cast<const int4*>(table);
    int4* d = reinterpret_cast<int4*>(s);
    for (uint32_t i = threadIdx.x; i < bytes / 16; i += 1024) d[i] = __ldg(g + i);
    __syncthreads();
  } else {
    const bool multicast = way >= 3;
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (multicast) cluster_barrier(way >= 4); else __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"(bytes) : "memory");
      uint32_t rank = 0;
      asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
      const uint32_t share =
          multicast ? (bytes / 16 + cluster - 1) / cluster * 16 : bytes;
      const uint32_t lo = multicast ? rank * share : 0;
      const uint32_t n = min(bytes, lo + share) - min(bytes, lo);
      const char* src = reinterpret_cast<const char*>(table) + lo;
      if (n > 0 && multicast) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            ".multicast::cluster [%0], [%1], %2, [%3], %4;"
            :: "r"(smem_u32(s) + lo), "l"(src), "r"(n), "r"(bar),
               "h"(static_cast<uint16_t>((1u << cluster) - 1)) : "memory");
      } else if (n > 0) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];"
            :: "r"(smem_u32(s)), "l"(src), "r"(n), "r"(bar) : "memory");
      }
    }
    wait_phase0(bar);
    if (way == 3 || way == 4) cluster_barrier(way == 4);
  }
  if (threadIdx.x == 0) sink[blockIdx.x] = reinterpret_cast<float*>(s)[0];
}

}  // namespace

// Returns the cudaError_t of the launch.
extern "C" int stage_probe(const void* table, int64_t bytes, int64_t way,
                           int64_t cluster, int64_t grid, void* sink,
                           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes) + 16;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, stage_kernel, static_cast<const float*>(table),
                           static_cast<uint32_t>(bytes), static_cast<int>(way),
                           static_cast<int>(cluster), static_cast<float*>(sink));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
