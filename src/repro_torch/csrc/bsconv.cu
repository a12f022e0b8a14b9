// Fused BSConv: 1x1 pointwise + bias -> 3x3 SAME depthwise + bias -> optional
// ReLU, NHWC fp32.
//
// Replaces the TPU kernel repro/kernels/bsconv.py::bsconv_fused
// (bsconv_kernel, pallas_call at bsconv.py:76).
//
// What bounds it: on the main path it is ESSR's first layer, 3 -> C (C 54 or
// 27) channels over 32x32 patches. It does 2*(3+9)*C flops per pixel and
// writes 4*C bytes per pixel, so it is bound by the bytes it writes (about
// 71 us for 1024 C54 patches on an H100 SXM at 3.35 TB/s).
//
// Design: one block per 8x8 output tile at a time (grid-stride over tiles,
// weights staged once per block). The block loads the 10x10 input tile (a
// 1-px halo), computes the pointwise output on all 100 pixels in shared
// memory, and zeroes it where the pixel lies outside the patch: the
// depthwise's SAME padding applies to the pointwise OUTPUT, bias included,
// so a halo pixel off the patch must read 0, not pw(0) + b. The depthwise
// then writes the 8x8 tile straight to device memory.
#include "common.cuh"

using namespace essr;

namespace {

constexpr int THREADS = 256;
constexpr int R1 = TILE + 2;     // input tile edge (1-px halo)

struct Args {
  const float *x, *pw, *pwb, *dw, *dwb;
  float* out;
  int N, H, W, Cin, Cout, relu;
};

size_t smem_floats(int cpi, int cpo) {
  return (size_t)R1 * R1 * cpi + (size_t)R1 * R1 * cpo + (size_t)cpi * cpo + 9 * cpo + 2 * cpo;
}

__global__ void __launch_bounds__(THREADS) bsconv_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int H = a.H, W = a.W;
  const int cpi = round4(a.Cin), cpo = round4(a.Cout);
  float* X = sm;                          // R1*R1 x cpi
  float* P = X + R1 * R1 * cpi;           // R1*R1 x cpo
  float* Wm = P + R1 * R1 * cpo;          // cpi x cpo
  float* Dw = Wm + cpi * cpo;             // 9 x cpo
  float* bias = Dw + 9 * cpo;             // [pw_b | dw_b], cpo each

  stage_matrix(a.pw, a.Cin, a.Cout, cpi, cpo, Wm);
  stage_matrix(a.dw, 9, a.Cout, 9, cpo, Dw);
  stage_matrix(a.pwb, 1, a.Cout, 1, cpo, bias);
  stage_matrix(a.dwb, 1, a.Cout, 1, cpo, bias + cpo);

  const int ty = (H + TILE - 1) / TILE, tx = (W + TILE - 1) / TILE;
  const long long tiles = (long long)a.N * ty * tx;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n = (int)(t / (ty * tx));
    const int r = (int)(t % (ty * tx));
    const int y0 = (r / tx) * TILE, x0 = (r % tx) * TILE;
    const Region<R1, R1> r1{y0 - 1, x0 - 1};
    __syncthreads();
    load_region(a.x, n, H, W, a.Cin, r1, cpi, X);
    __syncthreads();
    pointwise(X, cpi, Wm, cpo, R1 * R1, [&](int p, int co, float4 v) {
      st4(P + p * cpo + co,
          r1.inside(p, H, W) ? add4(v, ld4(bias + co)) : make_float4(0.f, 0.f, 0.f, 0.f));
    });
    __syncthreads();
    depthwise<R1, TILE, TILE>(P, Dw, cpo, [&](int q, int co, float4 v) {
      const int y = y0 + q / TILE, xx = x0 + q % TILE;
      if (y >= H || xx >= W) return;
      float4 o = add4(v, ld4(bias + cpo + co));
      if (a.relu) o = relu4(o);
      store4(a.out + (((size_t)n * H + y) * W + xx) * a.Cout, co, a.Cout, o);
    });
  }
}

}  // namespace

extern "C" int bsconv_forward(const float* x, const float* pw, const float* pwb,
                              const float* dw, const float* dwb, float* out, int N, int H,
                              int W, int Cin, int Cout, int relu, void* stream) {
  const Args a{x, pw, pwb, dw, dwb, out, N, H, W, Cin, Cout, relu};
  const size_t smem = smem_floats(round4(Cin), round4(Cout)) * sizeof(float);
  const long long tiles = (long long)N * ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  int grid = 0;
  cudaError_t e = resident_grid(bsconv_kernel, THREADS, smem, tiles, &grid);
  if (e != cudaSuccess) return (int)e;
  bsconv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
