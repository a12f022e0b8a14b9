// Edge score (the paper's edge-threshold unit): per patch, BT.601 luma ->
// 4-neighbour Laplacian on the interior (VALID) -> |.| clamped to [0, 255]
// -> one mean. x: (N, h, w, 3) fp32 in [0, 1] -> (N,) fp32 scores. The
// "cuda" serving path scores every frame's patches with it
// (core/pipeline.py).
//
// Replaces the TPU kernel repro/kernels/edge.py::edge_score_fused
// (edge_kernel at edge.py:20, pallas_call at :43).
//
// What bounds it: the bytes it reads. Each pixel is read once (12 bytes)
// and takes ~12 flops, far below the card's ridge: 2,304 32x32 patches (one
// 1080p frame's extract) are 28.3 MB, 0.0085 ms at 3.35 TB/s on an H100 SXM.
//
// Design: one warp per patch, WARPS patches a block, no shared memory, no
// block barrier and no per-pixel integer division. The lanes sit on
// columns (lane l on columns x0 + l + 32k, k < K: K = 1 for a patch up to
// 32 wide, up to 4 for 128; a wider patch is walked in strips of 32K
// columns that overlap by 2). The warp walks the rows with a three-row
// window of luma in registers (up, mid, down), R rows' loads in flight at
// once (16 rows of a 32-wide patch: two rounds a patch). The walk has no
// branch, so a round's loads all issue before any of its arithmetic: a walk
// that branched per row waited on each row's loads in turn and took 1.6x
// the one-block-a-patch kernel's device time. Each lane forms its luma from
// three 4-byte loads, so a warp's loads of a row are one contiguous
// 384-byte run per k. Horizontal neighbours come by __shfl_sync (lane 31
// hands its column-group k - 1 value to lane 0 and lane 0 its k + 1 value to
// lane 31, so columns continue across groups). The Laplacian keeps the plain
// version's rounded order
// ((up + left) + (-4 * centre), then + right, then + down;
// core/edge_score.py::laplacian_response); each lane keeps a running sum,
// a warp shuffle reduces it, and the mean is that sum over the interior
// pixel count. The mean's order of summation differs from the plain
// version's, so scores agree to rounding, not bit for bit.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;            // patches a block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float luma(const float (&px)[3]) {
  // (65.481 r + 128.553 g + 24.966 b) + 16, left to right, as rgb_to_luma
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(65.481f, px[0]), __fmul_rn(128.553f, px[1])),
                            __fmul_rn(24.966f, px[2]));
  return __fadd_rn(y, 16.0f);
}

// The raw RGB of one row at this lane's K columns of the strip at x0, a
// column past the patch's width clamped onto its last (such a column only
// feeds the right neighbour of column w - 1, which is not interior).
template <int K>
__device__ __forceinline__ void load_row(const float* row, int x0, int w, int lane,
                                         float (&px)[K][3]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = min(x0 + lane + 32 * k, w - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) px[k][c] = __ldg(row + 3 * j + c);
  }
}

// Adds |Laplacian| clamped to 255 of row `mid` at this lane's interior
// columns of the strip to s where `row_ok`; every lane takes part in the
// shuffles, and the add is a select, so the row walk has no branch.
template <int K>
__device__ __forceinline__ float add_row(const float (&up)[K], const float (&mid)[K],
                                         const float (&down)[K], int x0, int w, int lane,
                                         bool row_ok, float s) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float to_right = (lane == 31 && k > 0) ? mid[k - 1] : mid[k];
    const float to_left = (lane == 0 && k + 1 < K) ? mid[k + 1] : mid[k];
    const float left = __shfl_sync(FULL, to_right, (lane + 31) & 31);
    const float right = __shfl_sync(FULL, to_left, (lane + 1) & 31);
    const int j = x0 + lane + 32 * k;
    float y = __fadd_rn(__fadd_rn(up[k], left), __fmul_rn(-4.0f, mid[k]));
    y = __fadd_rn(__fadd_rn(y, right), down[k]);
    const float t = __fadd_rn(s, fminf(fabsf(y), 255.0f));
    // columns x0 + 1 .. x0 + 32K - 2 of the strip, inside the interior
    s = (row_ok && (lane > 0 || k > 0) && (lane < 31 || k + 1 < K) && j <= w - 2) ? t : s;
  }
  return s;
}

template <int K>
__global__ void __launch_bounds__(THREADS) edge_kernel(const float* __restrict__ x,
                                                       float* __restrict__ out, int N, int h,
                                                       int w) {
  constexpr int R = K == 1 ? 16 : K == 2 ? 8 : 4;   // rows' loads in flight
  constexpr int SPAN = 32 * K;
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;   // a whole warp: no barrier waits on it
  const size_t rs = (size_t)w * 3;
  const float* img = x + (size_t)n * h * rs;
  float s = 0.f;
  for (int x0 = 0; x0 + 2 < w; x0 += SPAN - 2) {
    float up[K] = {}, mid[K] = {};
    for (int i = 0; i < h; i += R) {
      // every load of R rows issued before any is used (a row past the
      // patch clamped onto its last, its Laplacian never added)
      float px[R][K][3];
#pragma unroll
      for (int r = 0; r < R; ++r) load_row<K>(img + min(i + r, h - 1) * rs, x0, w, lane, px[r]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float down[K];
#pragma unroll
        for (int k = 0; k < K; ++k) down[k] = luma(px[r][k]);
        s = add_row<K>(up, mid, down, x0, w, lane, i + r >= 2 && i + r < h, s);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          up[k] = mid[k];
          mid[k] = down[k];
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(FULL, s, off);
  if (lane == 0) out[n] = s / (float)((h - 2) * (w - 2));
}

template <int K>
int edge_launch(const float* x, float* out, int N, int h, int w, void* stream) {
  const int grid = (N + WARPS - 1) / WARPS;
  edge_kernel<K><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, out, N, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// Scores of N patches on `stream`: one warp a patch, WARPS patches a block,
// ceil(N / WARPS) blocks. Returns the launch's CUDA error.
extern "C" int edge_forward(const float* x, float* out, int N, int h, int w, void* stream) {
  if (w <= 32) return edge_launch<1>(x, out, N, h, w, stream);
  if (w <= 64) return edge_launch<2>(x, out, N, h, w, stream);
  if (w <= 96) return edge_launch<3>(x, out, N, h, w, stream);
  return edge_launch<4>(x, out, N, h, w, stream);
}
