// Thread-block-cluster plumbing of the subnet-group megakernels (mega.cu,
// fp32; qmega.cu, integer codes): a persistent cluster launch, and mega.cu's
// halo-row exchange over distributed shared memory (qmega.cu pushes its halo
// rows instead, push_halo).
//
// Layout they share: each patch belongs to one cluster, each block of the
// cluster owns a strip of `rows` consecutive rows, and a depthwise layer's
// input sits in a block's buffer A with one halo row above (row 0) and one
// below (row rows + 1) its interior rows 1..rows.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace essr {

namespace cg = cooperative_groups;

template <class V>
__device__ __forceinline__ void copy_halo(const V* top_src, const V* bot_src, V* top, V* bot,
                                          int n) {
  const V zero{};
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    if (i < n)
      top[i] = top_src ? top_src[i] : zero;
    else
      bot[i - n] = bot_src ? bot_src[i - n] : zero;
  }
}

// Fill the halo rows of A (`row_bytes` each: fp32 rows or code rows alike,
// a multiple of 4) from the neighbours' strips: the row above is the last
// interior row of the block of rank - 1, the row below the first interior
// row of the block of rank + 1; zero at the patch border and past H. The
// cluster barrier first makes every block's interior rows visible; blocks
// whose strip lies past H (`active` false) keep the barrier and copy
// nothing.
__device__ __forceinline__ void exchange(cg::cluster_group& cl, unsigned char* A, int rank,
                                         int cs, int r0, int rows, int H, int row_bytes,
                                         bool active) {
  cl.sync();
  if (!active) return;
  const bool has_top = rank > 0 && r0 - 1 < H;
  const bool has_bot = rank + 1 < cs && r0 + rows < H;
  const unsigned char* ts =
      has_top ? cl.map_shared_rank(A, rank - 1) + (size_t)rows * row_bytes : nullptr;
  const unsigned char* bs = has_bot ? cl.map_shared_rank(A, rank + 1) + row_bytes : nullptr;
  unsigned char* top = A;
  unsigned char* bot = A + (size_t)(rows + 1) * row_bytes;
  if (row_bytes % 16 == 0)
    copy_halo(reinterpret_cast<const uint4*>(ts), reinterpret_cast<const uint4*>(bs),
              reinterpret_cast<uint4*>(top), reinterpret_cast<uint4*>(bot), row_bytes / 16);
  else
    copy_halo(reinterpret_cast<const uint32_t*>(ts), reinterpret_cast<const uint32_t*>(bs),
              reinterpret_cast<uint32_t*>(top), reinterpret_cast<uint32_t*>(bot),
              row_bytes / 4);
  __syncthreads();
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
  // Clusters resident on the card at once (0: none fits).
  cudaError_t max_clusters(int* n) {
    cfg.attrs = attr;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
    if (e != cudaSuccess) return e;
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
