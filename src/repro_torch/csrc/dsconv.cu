// Fused DSConv: 3x3 SAME depthwise + bias -> 1x1 pointwise + bias -> optional
// ReLU, NHWC fp32, Cin -> Cout channels.
//
// Replaces the TPU kernel repro/kernels/dsconv.py::dsconv_fused
// (dsconv_kernel, pallas_call at dsconv.py:47).
//
// What bounds it: ESSR's reconstruction layer, C -> 3*s^2 channels (54 -> 48
// at x4). 2*(9*C + C*Cout) flops per pixel against 4*(C + Cout) bytes: bound
// by the bytes it moves (about 128 us for 1024 C54 patches at x4 on an H100
// SXM at 3.35 TB/s).
//
// Design: one block per 8x8 output tile at a time (grid-stride over tiles,
// weights staged once per block). The block loads the 10x10 input tile (a
// 1-px halo, zero off the patch: the depthwise's SAME padding applies to
// the input here), runs the depthwise into an 8x8 shared-memory tile, and
// the pointwise writes the output tile once to device memory.
#include "common.cuh"

using namespace essr;

namespace {

constexpr int THREADS = 256;
constexpr int R1 = TILE + 2;

struct Args {
  const float *x, *dw, *dwb, *pw, *pwb;
  float* out;
  int N, H, W, Cin, Cout, relu;
};

size_t smem_floats(int cpi, int cpo) {
  return (size_t)R1 * R1 * cpi + (size_t)TILE * TILE * cpi + (size_t)cpi * cpo + 9 * cpi +
         cpi + cpo;
}

__global__ void __launch_bounds__(THREADS) dsconv_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int H = a.H, W = a.W;
  const int cpi = round4(a.Cin), cpo = round4(a.Cout);
  float* X = sm;                          // R1*R1 x cpi
  float* D = X + R1 * R1 * cpi;           // TILE*TILE x cpi
  float* Wm = D + TILE * TILE * cpi;      // cpi x cpo
  float* Dw = Wm + cpi * cpo;             // 9 x cpi
  float* dwb = Dw + 9 * cpi;              // cpi
  float* pwb = dwb + cpi;                 // cpo

  stage_matrix(a.pw, a.Cin, a.Cout, cpi, cpo, Wm);
  stage_matrix(a.dw, 9, a.Cin, 9, cpi, Dw);
  stage_matrix(a.dwb, 1, a.Cin, 1, cpi, dwb);
  stage_matrix(a.pwb, 1, a.Cout, 1, cpo, pwb);

  const int ty = (H + TILE - 1) / TILE, tx = (W + TILE - 1) / TILE;
  const long long tiles = (long long)a.N * ty * tx;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n = (int)(t / (ty * tx));
    const int r = (int)(t % (ty * tx));
    const int y0 = (r / tx) * TILE, x0 = (r % tx) * TILE;
    __syncthreads();
    load_region(a.x, n, H, W, a.Cin, Region<R1, R1>{y0 - 1, x0 - 1}, cpi, X);
    __syncthreads();
    depthwise<R1, TILE, TILE>(X, Dw, cpi, [&](int q, int co, float4 v) {
      st4(D + q * cpi + co, add4(v, ld4(dwb + co)));
    });
    __syncthreads();
    pointwise(D, cpi, Wm, cpo, TILE * TILE, [&](int p, int co, float4 v) {
      const int y = y0 + p / TILE, xx = x0 + p % TILE;
      if (y >= H || xx >= W) return;
      float4 o = add4(v, ld4(pwb + co));
      if (a.relu) o = relu4(o);
      store4(a.out + (((size_t)n * H + y) * W + xx) * a.Cout, co, a.Cout, o);
    });
  }
}

}  // namespace

extern "C" int dsconv_forward(const float* x, const float* dw, const float* dwb,
                              const float* pw, const float* pwb, float* out, int N, int H,
                              int W, int Cin, int Cout, int relu, void* stream) {
  const Args a{x, dw, dwb, pw, pwb, out, N, H, W, Cin, Cout, relu};
  const size_t smem = smem_floats(round4(Cin), round4(Cout)) * sizeof(float);
  const long long tiles = (long long)N * ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  int grid = 0;
  cudaError_t e = resident_grid(dsconv_kernel, THREADS, smem, tiles, &grid);
  if (e != cudaSuccess) return (int)e;
  dsconv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
