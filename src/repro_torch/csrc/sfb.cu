// Fused whole SFB: relu(BSConv) -> relu(BSConv) -> + x -> 1x1 + bias -> ReLU,
// NHWC fp32, C -> C channels.
//
// Replaces the TPU kernel repro/kernels/sfb.py::sfb_fused (sfb_kernel,
// pallas_call at sfb.py:57).
//
// What bounds it: three C x C pointwise layers and two depthwise layers,
// 2*(3*C*C + 18*C) flops per pixel against 8*C bytes in and out. At C54
// that is about 20 GFLOP for 1024 32x32 patches, bound by the card's fp32
// (non-tensor) rate: about 304 us on an H100 SXM at 67 TFLOP/s.
//
// Design: one block per 8x8 output tile at a time (grid-stride over tiles,
// the three weight matrices staged once per block). Two 3x3 depthwise
// layers need a 2-px halo, so the block loads the 12x12 input tile and runs
// the chain in shared memory, shrinking the region by one pixel per
// depthwise: pw1 on 12x12 -> dw1 on 10x10 -> pw2 on 10x10 -> dw2 on 8x8
// (+ the shortcut x) -> fuse on 8x8, written once to device memory. The
// padding of each depthwise applies to its pointwise's OUTPUT, so pw1 and
// pw2 results are zeroed on pixels off the patch. Three buffers are reused
// along the chain: X (12x12 input, kept for the shortcut), A (pw1, then
// pw2), B (dw1, then dw2 + x). At C54 the block holds ~127 KB of shared
// memory, one block per SM; the halo recompute costs 1.6x the minimal flops.
#include "common.cuh"

using namespace essr;

namespace {

constexpr int THREADS = 512;
constexpr int R0 = TILE + 4;     // input tile edge (2-px halo)
constexpr int R1 = TILE + 2;

struct Args {
  const float *x, *b1pw, *b1pwb, *b1dw, *b1dwb, *b2pw, *b2pwb, *b2dw, *b2dwb, *fuse, *fuseb;
  float* out;
  int N, H, W, C;
};

size_t smem_floats(int cp) {
  return 2 * (size_t)R0 * R0 * cp + (size_t)R1 * R1 * cp + 3 * (size_t)cp * cp + 18 * cp +
         5 * cp;
}

__global__ void __launch_bounds__(THREADS) sfb_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int H = a.H, W = a.W, C = a.C, cp = round4(a.C);
  float* X = sm;                        // R0*R0 x cp
  float* A = X + R0 * R0 * cp;          // R0*R0 x cp
  float* B = A + R0 * R0 * cp;          // R1*R1 x cp
  float* W1 = B + R1 * R1 * cp;         // cp x cp each
  float* W2 = W1 + cp * cp;
  float* WF = W2 + cp * cp;
  float* D1 = WF + cp * cp;             // 9 x cp each
  float* D2 = D1 + 9 * cp;
  float* bias = D2 + 9 * cp;            // [b1pw | b1dw | b2pw | b2dw | fuse], cp each

  stage_matrix(a.b1pw, C, C, cp, cp, W1);
  stage_matrix(a.b2pw, C, C, cp, cp, W2);
  stage_matrix(a.fuse, C, C, cp, cp, WF);
  stage_matrix(a.b1dw, 9, C, 9, cp, D1);
  stage_matrix(a.b2dw, 9, C, 9, cp, D2);
  stage_matrix(a.b1pwb, 1, C, 1, cp, bias);
  stage_matrix(a.b1dwb, 1, C, 1, cp, bias + cp);
  stage_matrix(a.b2pwb, 1, C, 1, cp, bias + 2 * cp);
  stage_matrix(a.b2dwb, 1, C, 1, cp, bias + 3 * cp);
  stage_matrix(a.fuseb, 1, C, 1, cp, bias + 4 * cp);

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int ty = (H + TILE - 1) / TILE, tx = (W + TILE - 1) / TILE;
  const long long tiles = (long long)a.N * ty * tx;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n = (int)(t / (ty * tx));
    const int r = (int)(t % (ty * tx));
    const int y0 = (r / tx) * TILE, x0 = (r % tx) * TILE;
    const Region<R0, R0> r0{y0 - 2, x0 - 2};
    const Region<R1, R1> r1{y0 - 1, x0 - 1};
    __syncthreads();
    load_region(a.x, n, H, W, C, r0, cp, X);
    __syncthreads();
    // A = pw1(X) + b on 12x12, zero off the patch
    pointwise(X, cp, W1, cp, R0 * R0, [&](int p, int co, float4 v) {
      st4(A + p * cp + co, r0.inside(p, H, W) ? add4(v, ld4(bias + co)) : zero);
    });
    __syncthreads();
    // B = relu(dw1(A) + b) on 10x10
    depthwise<R0, R1, R1>(A, D1, cp, [&](int q, int co, float4 v) {
      st4(B + q * cp + co, relu4(add4(v, ld4(bias + cp + co))));
    });
    __syncthreads();
    // A = pw2(B) + b on 10x10, zero off the patch
    pointwise(B, cp, W2, cp, R1 * R1, [&](int p, int co, float4 v) {
      st4(A + p * cp + co, r1.inside(p, H, W) ? add4(v, ld4(bias + 2 * cp + co)) : zero);
    });
    __syncthreads();
    // B = relu(dw2(A) + b) + x on the 8x8 tile
    depthwise<R1, TILE, TILE>(A, D2, cp, [&](int q, int co, float4 v) {
      const int i = q / TILE, j = q % TILE;
      const float4 xv = ld4(X + ((i + 2) * R0 + j + 2) * cp + co);
      st4(B + q * cp + co, add4(relu4(add4(v, ld4(bias + 3 * cp + co))), xv));
    });
    __syncthreads();
    // out = relu(fuse(B) + b)
    pointwise(B, cp, WF, cp, TILE * TILE, [&](int p, int co, float4 v) {
      const int y = y0 + p / TILE, xx = x0 + p % TILE;
      if (y >= H || xx >= W) return;
      store4(a.out + (((size_t)n * H + y) * W + xx) * C, co, C,
             relu4(add4(v, ld4(bias + 4 * cp + co))));
    });
  }
}

}  // namespace

extern "C" int sfb_forward(const float* x, const float* b1pw, const float* b1pwb,
                           const float* b1dw, const float* b1dwb, const float* b2pw,
                           const float* b2pwb, const float* b2dw, const float* b2dwb,
                           const float* fuse, const float* fuseb, float* out, int N, int H,
                           int W, int C, void* stream) {
  const Args a{x, b1pw, b1pwb, b1dw, b1dwb, b2pw, b2pwb, b2dw, b2dwb, fuse, fuseb, out,
               N, H, W, C};
  const size_t smem = smem_floats(round4(C)) * sizeof(float);
  const long long tiles = (long long)N * ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  int grid = 0;
  cudaError_t e = resident_grid(sfb_kernel, THREADS, smem, tiles, &grid);
  if (e != cudaSuccess) return (int)e;
  sfb_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
