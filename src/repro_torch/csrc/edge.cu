// Edge score (the paper's edge-threshold unit): per patch, BT.601 luma ->
// 4-neighbour Laplacian on the interior (VALID) -> |.| clamped to [0, 255]
// -> one mean. x: (N, h, w, 3) fp32 in [0, 1] -> (N,) fp32 scores.
//
// Replaces the TPU kernel repro/kernels/edge.py::edge_score_fused
// (edge_kernel at edge.py:20, pallas_call at :43).
//
// What bounds it: the bytes it reads. Each pixel is read once (12 bytes)
// and takes ~12 flops, far below the card's ridge: 2,304 32x32 patches (one
// 1080p frame's extract) are 28.3 MB, 0.0085 ms at 3.35 TB/s on an H100 SXM.
//
// Design: one block per patch in a grid-stride loop. The block computes the
// patch's luma into shared memory (h*w floats), then each thread takes
// interior pixels, forms the Laplacian with rounded ops in the plain
// version's order ((up + left) + (-4 * centre), then + right, then + down;
// core/edge_score.py::laplacian_response), and keeps a running sum; a warp
// shuffle then a shared-memory step reduce the block's sums, and the mean
// is that sum over the interior pixel count. The mean's order of summation
// differs from the plain version's, so scores agree to rounding, not bit for
// bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float luma(const float* px) {
  // (65.481 r + 128.553 g + 24.966 b) + 16, left to right, as rgb_to_luma
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(65.481f, px[0]), __fmul_rn(128.553f, px[1])),
                            __fmul_rn(24.966f, px[2]));
  return __fadd_rn(y, 16.0f);
}

__global__ void __launch_bounds__(THREADS) edge_kernel(const float* __restrict__ x,
                                                       float* __restrict__ out, int N, int h,
                                                       int w) {
  extern __shared__ float L[];   // h * w luma
  __shared__ float warp_sums[THREADS / 32];
  const int hw = h * w, iw = w - 2, interior = (h - 2) * iw;
  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const float* img = x + (size_t)n * hw * 3;
    __syncthreads();   // the previous patch's luma and sums are consumed
    for (int i = threadIdx.x; i < hw; i += blockDim.x) L[i] = luma(img + 3 * (size_t)i);
    __syncthreads();
    float s = 0.f;
    for (int q = threadIdx.x; q < interior; q += blockDim.x) {
      const int i = q / iw + 1, j = q - (q / iw) * iw + 1;
      const float* c = L + i * w + j;
      float y = __fadd_rn(__fadd_rn(c[-w], c[-1]), __fmul_rn(-4.0f, c[0]));
      y = __fadd_rn(__fadd_rn(y, c[1]), c[w]);
      s = __fadd_rn(s, fminf(fabsf(y), 255.0f));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int k = 0; k < (int)(blockDim.x >> 5); ++k) t += warp_sums[k];
      out[n] = t / (float)interior;
    }
  }
}

}  // namespace

// Dynamic shared memory of one block for an h x w patch, in bytes.
extern "C" long long edge_smem_bytes(int h, int w) { return (long long)h * w * sizeof(float); }

// Scores of N patches on `stream`: one block per patch, as many blocks as
// are resident at once. Returns the launch's CUDA error.
extern "C" int edge_forward(const float* x, float* out, int N, int h, int w, void* stream) {
  const size_t smem = (size_t)h * w * sizeof(float);
  int grid = 0;
  cudaError_t e = essr::resident_grid(edge_kernel, THREADS, smem, N, &grid);
  if (e != cudaSuccess) return (int)e;
  edge_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(x, out, N, h, w);
  return (int)cudaGetLastError();
}
