// Shared device helpers of the fp32 ESSR layer-group kernels (bsconv.cu,
// sfb.cu, dsconv.cu).
//
// Layout: activations NHWC fp32, one 2-D map per patch; weights row-major as
// the reference keeps them (pointwise (Cin, Cout), depthwise (3, 3, C)).
// Every kernel tiles each patch into TILE x TILE output pixels. A block
// stages the tile plus the halo its 3x3 depthwise layers need into shared
// memory, runs the whole layer group there, and writes only the group's
// output: intermediates never touch device memory. Channels are padded to a
// multiple of 4 in shared memory (zeros), so a thread owns 4 channels as one
// float4.
//
// Arithmetic is fp32 FFMA on the CUDA cores (no TF32): parity with the
// reference is held at rtol 1e-4 / atol 1e-5.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <map>
#include <mutex>
#include <tuple>

namespace essr {

constexpr int TILE = 8;     // output tile edge, pixels

__host__ __device__ inline int round4(int c) { return (c + 3) & ~3; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 relu4(float4 a) {
  return make_float4(fmaxf(a.x, 0.f), fmaxf(a.y, 0.f), fmaxf(a.z, 0.f), fmaxf(a.w, 0.f));
}

// Channels co..co+3 of one pixel to device memory, dropping the padding.
__device__ __forceinline__ void store4(float* pixel, int co, int C, float4 v) {
  if (co + 3 < C) {
    pixel[co] = v.x; pixel[co + 1] = v.y; pixel[co + 2] = v.z; pixel[co + 3] = v.w;
  } else {
    if (co < C) pixel[co] = v.x;
    if (co + 1 < C) pixel[co + 1] = v.y;
    if (co + 2 < C) pixel[co + 2] = v.z;
  }
}

// A rectangle of one patch: origin (oy, ox) in patch pixels (may lie
// outside the patch), RH x RW pixels stored row-major. The extent is a
// compile-time constant, so pixel -> (row, column) is a multiply-shift,
// not a runtime integer division.
template <int RH, int RW>
struct Region {
  int oy, ox;
  __device__ __forceinline__ bool inside(int p, int H, int W) const {
    const int y = oy + p / RW, x = ox + p % RW;
    return y >= 0 && y < H && x >= 0 && x < W;
  }
};

// dst[p * cp + c] = x[n, y, x, c] over region r; zero outside the patch
// (the SAME zero padding) and in the padded channels c >= C. Threads walk
// (pixel, channel) with the channel fastest, stepping both without division.
template <int RH, int RW>
__device__ __forceinline__ void load_region(const float* __restrict__ x, int n, int H, int W,
                                            int C, Region<RH, RW> r, int cp, float* dst) {
  const float* img = x + (size_t)n * H * W * C;
  const int step_p = blockDim.x / cp, step_c = blockDim.x - step_p * cp;
  int p = threadIdx.x / cp, c = threadIdx.x - p * cp;
  while (p < RH * RW) {
    const int y = r.oy + p / RW, xx = r.ox + p % RW;
    float v = 0.f;
    if (c < C && y >= 0 && y < H && xx >= 0 && xx < W)
      v = __ldg(img + ((size_t)y * W + xx) * C + c);
    dst[p * cp + c] = v;
    p += step_p;
    c += step_c;
    if (c >= cp) {
      c -= cp;
      ++p;
    }
  }
}

// dst (kp x cop) = w (K x Co, row-major), zero-padded.
__device__ __forceinline__ void stage_matrix(const float* __restrict__ w, int K, int Co,
                                             int kp, int cop, float* dst) {
  for (int i = threadIdx.x; i < kp * cop; i += blockDim.x) {
    const int k = i / cop, c = i - k * cop;
    dst[i] = (k < K && c < Co) ? __ldg(w + (size_t)k * Co + c) : 0.f;
  }
}

// Pointwise (1x1) over P pixels held in shared memory, P % 4 == 0:
//   acc(p, co..co+3) = sum_ci in[p * cpin + ci] * w[ci * cpout + co]
// then epi(p, co, acc); the epilogue adds the bias. Each thread owns 4
// output channels of 4 pixels (p, p + P/4, p + P/2, p + 3P/4): strided
// pixels put the lanes of a warp on different banks.
template <class Epi>
__device__ __forceinline__ void pointwise(const float* __restrict__ in, int cpin,
                                          const float* __restrict__ w, int cpout, int P,
                                          Epi epi) {
  const int ng = cpout >> 2, npg = P >> 2;
  const int pstride = npg * cpin;
  for (int item = threadIdx.x; item < ng * npg; item += blockDim.x) {
    const int g = item % ng, pg = item / ng;
    const float* i0 = in + pg * cpin;
    float4 acc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int ci = 0; ci < cpin; ++ci) {
      const float4 wv = ld4(w + ci * cpout + 4 * g);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = i0[k * pstride + ci];
        acc[k].x = fmaf(v, wv.x, acc[k].x);
        acc[k].y = fmaf(v, wv.y, acc[k].y);
        acc[k].z = fmaf(v, wv.z, acc[k].z);
        acc[k].w = fmaf(v, wv.w, acc[k].w);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) epi(pg + k * npg, 4 * g, acc[k]);
  }
}

// 3x3 depthwise from an input region RWI = RWO + 2 pixels wide to RHO x RWO
// outputs: output (i, j) reads input (i + dy, j + dx).
//   acc(q, co..co+3) = sum_{dy,dx} in[...] * w9[(dy * 3 + dx) * cp + co]
// in (dy, dx) raster order, then epi(q, co, acc); the epilogue adds the bias.
template <int RWI, int RHO, int RWO, class Epi>
__device__ __forceinline__ void depthwise(const float* __restrict__ in,
                                          const float* __restrict__ w9, int cp, Epi epi) {
  const int ng = cp >> 2;
  for (int item = threadIdx.x; item < ng * RHO * RWO; item += blockDim.x) {
    const int g = item % ng, q = item / ng;
    const int i = q / RWO, j = q % RWO;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4 v = ld4(in + ((i + dy) * RWI + j + dx) * cp + 4 * g);
        const float4 wv = ld4(w9 + (dy * 3 + dx) * cp + 4 * g);
        acc.x = fmaf(v.x, wv.x, acc.x);
        acc.y = fmaf(v.y, wv.y, acc.y);
        acc.z = fmaf(v.z, wv.z, acc.z);
        acc.w = fmaf(v.w, wv.w, acc.w);
      }
    }
    epi(q, 4 * g, acc);
  }
}

// Blocks for a grid-stride loop over `tiles`: as many as can be resident
// on the card at once (weights are staged once per block, not per tile).
// The SM count and the occupancy query run once per (kernel, threads,
// shared memory, device), under a lock, and the resident count is cached:
// on an H100 host they took ~0.7 us of the ~6 us a launch of a ~5 us kernel
// costs the host. The dynamic shared-memory attribute is still
// set on every launch that takes dynamic shared memory, as before (the band
// walkers' blocks_per_sm diagnostics set the same attribute to their own
// sizes, so a cached value could be stale), and never for one that takes
// none (quantize). Host side only: the grid, and so every kernel's output,
// is what the uncached queries gave.
template <class Kernel>
inline cudaError_t resident_grid(Kernel k, int threads, size_t smem, long long tiles,
                                 int* grid) {
  cudaError_t e;
  if (smem > 0 &&
      (e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t, int>, long long> resident;
  std::lock_guard<std::mutex> lock(mu);
  long long& cap = resident[std::make_tuple((const void*)k, threads, smem, dev)];
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, smem)) !=
        cudaSuccess)
      return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cap = (long long)per_sm * sms;
  }
  *grid = (int)(tiles < cap ? tiles : cap);
  return cudaSuccess;
}

}  // namespace essr

extern "C" const char* essr_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
