// Thread-block-cluster plumbing of the subnet-group megakernels (mega.cu,
// fp32; qmega.cu, integer codes): a persistent cluster launch, the two
// halves of a cluster barrier, and the halo rows a block pushes into its
// neighbours' shared memory.
//
// Layout they share: each patch belongs to one cluster, each block of the
// cluster owns a strip of `rows` consecutive rows, and a depthwise layer
// reads, besides its strip, one halo row above and one below it: the last
// row of the block above and the first row of the block below, which those
// blocks push as bulk copies that complete on the receiver's mbarrier
// (push_halo_bulk).
//
// The BSConv band walker (bsconv.cu) uses the bulk copies alone: its staged
// output rows leave shared memory for device memory as bulk stores.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace essr {

namespace cg = cooperative_groups;

// The two halves of a cluster barrier: every thread of the cluster
// alternates them, arrive first. Between the two a block may work on what no
// other block touches. arrive has release semantics (a fence at GPU scope),
// arrive_relaxed none: it suits an arrive that only says "I have read",
// every value read having been consumed before it issues. wait has acquire
// semantics.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// An mbarrier in shared memory, and bulk copies from this block's shared
// memory into another block's that complete on that block's mbarrier: the
// receiver learns that the bytes have landed by waiting on its own barrier,
// with no fence at GPU scope and no cluster barrier.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// The shared::cluster address of `p`'s counterpart in block `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(d) : "r"(shared_addr(p)), "r"(rank));
  return d;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(count)
               : "memory");
}
// Makes initialised mbarriers visible to the cluster (before a cluster barrier).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of bulk copies in this phase.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(shared_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}\n" ::"r"(shared_addr(bar)), "r"(parity)
      : "memory");
}
// Orders this thread's earlier shared-memory writes before later bulk copies
// that read them (the copies run in the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// `bytes` (a multiple of 16) from my shared memory at `src` to the
// shared::cluster address `dst`, completing on the mbarrier at `bar` (in
// dst's block); the caller commits.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, int bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(shared_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A depthwise layer's halo rows as two bulk copies, issued by one thread:
// my first row into the `bot` of rank - 1, my last into the `top` of rank +
// 1 when that block's strip lies inside the patch (a neighbour's halo rows
// lie at the same offsets of its shared memory as mine), each completing on
// the receiver's `bar`. The halo rows no neighbour fills are not touched: the
// caller zeroes them once. The receiver expects halo_bytes(...) a phase;
// the sender waits for its copies to have read their rows
// (bulk_wait_read) before it writes those rows again.
__device__ __forceinline__ void push_halo_bulk(const char* first, const char* last, char* top,
                                               char* bot, uint64_t* bar, int rank, int cs,
                                               int r0, int rows, int H, int row_bytes) {
  if (rank > 0)
    bulk_copy(cluster_addr(bot, rank - 1), first, row_bytes, cluster_addr(bar, rank - 1));
  if (rank + 1 < cs && r0 + rows < H)
    bulk_copy(cluster_addr(top, rank + 1), last, row_bytes, cluster_addr(bar, rank + 1));
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Bulk copies from this block's shared memory to device memory, in the
// issuing thread's bulk groups: `bytes` (a multiple of 16, both addresses on
// 16 bytes) from `src` to `dst`. The threads that wrote `src` fence it
// (fence_proxy_async) before a block barrier, after which one thread issues
// the copies and commits them (bulk_commit); before `src` is written again,
// that thread waits until at most N of its groups still read their sources
// (bulk_wait_read_n<N>), then the block barriers. Before the block exits it
// waits for every group to complete (bulk_wait_all).
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   __cvta_generic_to_global(dst)),
               "r"(shared_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read_n() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Bytes of halo rows a block receives a layer under push_halo_bulk: from
// rank - 1 when my strip lies inside the patch, from rank + 1 when its does.
__device__ __forceinline__ unsigned halo_bytes(int rank, int cs, int r0, int rows, int H,
                                               int row_bytes) {
  return (unsigned)row_bytes * ((rank > 0 && r0 < H) + (rank + 1 < cs && r0 + rows < H));
}

// Launch configuration of a cluster kernel taking one argument struct:
// clusters of `cluster` blocks along x, `smem` bytes of dynamic shared
// memory per block. cfg points at attr, so every use sets that pointer
// first (the struct may be copied).
template <class Args>
struct ClusterLaunch {
  void (*kernel)(Args);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(void (*k)(Args), size_t smem, int cluster, int threads, cudaStream_t stream)
      : kernel(k), cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.numAttrs = 1;
  }
  // Clusters resident on the card at once (0: none fits). Clusters of more
  // than 8 blocks (the portable limit; the H100 takes 16) are allowed.
  cudaError_t max_clusters(int* n) {
    cfg.attrs = attr;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
    if (e != cudaSuccess) return e;
    if (attr[0].val.clusterDim.x > 8 &&
        (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
            cudaSuccess)
      return e;
    return cudaOccupancyMaxActiveClusters(n, (const void*)kernel, &cfg);
  }
  // A persistent grid of as many clusters as the card holds at once (at
  // most N; each walks patches). Returns the launch's CUDA error;
  // cudaErrorLaunchOutOfResources when no cluster of this shape fits.
  int launch(const Args& a, int N) {
    int clusters = 0;
    cudaError_t e = max_clusters(&clusters);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    cfg.gridDim = dim3((N < clusters ? N : clusters) * attr[0].val.clusterDim.x);
    e = cudaLaunchKernelEx(&cfg, kernel, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  // The clusters `launch` keeps resident (0 when none fits or the query fails).
  int resident() {
    int n = 0;
    return max_clusters(&n) == cudaSuccess ? n : 0;
  }
};

}  // namespace essr
