// Integer-domain quantized ESSR kernels (PAMS serving path, paper Sec.
// IV-H): quantize and qBSConv, NHWC, with the lattice codes between groups
// as int8_t ("int8") or int32_t ("fxp10"). Each C entry takes an int `bits`:
// 8 picks int8_t codes, anything wider int32_t. The chain's other two
// kernels are band walkers of their own: qSFB in qsfb.cu, qDSConv in
// dsconv.cu (the DSConv walker's codes datapath).
//
// Replaces the TPU kernels of repro/kernels/qconv.py: quantize_fused
// (pallas_call at qconv.py:156) and qbsconv_fused (:187).
//
// Arithmetic contract: bit for bit the plain versions in
// repro_torch/kernels/ref.py (quantize_ref, qbsconv_ref). Every rounded fp
// step, the integer dots and the staged layout of the code weights live in
// qmath.cuh, shared with the quantized megakernel (qmega.cu); see there for
// the order of every fp op.
//
// What bounds them, at N = 1024 C54 32x32 patches (x4) on an H100 SXM
// (3.35 TB/s, 1,979 TOPS int8 dense, each rounded fp32 operation one
// instruction at 33.5 T a second); int8 / fxp10 codes move 1 / 4 bytes each:
//   quantize  the bytes it moves: 15.7 / 25.2 MB, 0.0047 / 0.0075 ms;
//   qBSConv   (first layer, 3 -> 54) int8: its 1.36 G rounded fp32
//             operations (dequant, depthwise, requantize), 0.041 ms; fxp10:
//             the bytes of its output codes, 0.071 ms.
// These kernels keep the dots on the CUDA cores (no int8 mma yet).
//
// Design, simple and right first (speed is later work): as the fp kernels
// (bsconv.cu), a block works on one 8x8 output tile at a time in a
// grid-stride loop, with the group's weights staged once per block and the
// depthwise halo recomputed in shared memory (10x10 -> 8x8; the codes and fp
// maps of a tile never leave it). Channels pad to multiples of 4 with zero
// codes and zero weights. Every pointwise result off the patch is 0, bias
// included, before a depthwise layer (the SAME padding of the dequantized
// map). A thread's integer dot covers 4 output channels of one pixel, with
// one 16-byte shared-memory load of their weights per step (int8: per 4
// input channels, as 4-byte __dp4a words; int32: per input channel).
#include <stdint.h>

#include "common.cuh"
#include "qmath.cuh"

using namespace essr;

namespace {

constexpr int R1 = TILE + 2;     // 1-px halo

// dst[p * cp + c] = codes of x[n] over the RH x RW region at (oy, ox); zero
// off the patch and in the padded channels c >= C.
template <class T>
__device__ __forceinline__ void load_codes(const T* __restrict__ x, int n, int H, int W, int C,
                                           int oy, int ox, int RH, int RW, int cp, T* dst) {
  const T* img = x + (size_t)n * H * W * C;
  for (int i = threadIdx.x; i < RH * RW * cp; i += blockDim.x) {
    const int p = i / cp, c = i - p * cp;
    const int y = oy + p / RW, xx = ox + p % RW;
    T v = 0;
    if (c < C && y >= 0 && y < H && xx >= 0 && xx < W) v = img[((size_t)y * W + xx) * C + c];
    dst[i] = v;
  }
}

// P[p * cpo + co] = dequant(X[p] . w(:, co)) over the R x R region r; 0 off
// the patch (bias included).
template <int R, class T>
__device__ __forceinline__ void pointwise_dequant(const T* X, int cpi, const T* Wq, int cpo,
                                                  const float* scale, const float* bias,
                                                  Region<R, R> r, int H, int W, float* P) {
  const int ng = cpo >> 2;
  for (int item = threadIdx.x; item < R * R * ng; item += blockDim.x) {
    const int g = item % ng, p = item / ng;
    float* dst = P + p * cpo + 4 * g;
    if (!r.inside(p, H, W)) {
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[k] = 0.f;
      continue;
    }
    int acc[4];
    dot4(X + p * cpi, Wq, cpi, cpo, 4 * g, acc);
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[k] = dequant(acc[k], scale[4 * g + k], bias[4 * g + k]);
  }
}

// 3x3 depthwise of channel c at output (i, j) from an input region RWI
// pixels wide: taps in (dy, dx) raster order from 0, then + bias.
template <int RWI>
__device__ __forceinline__ float depthwise_at(const float* in, const float* w9, int cp, int i,
                                              int j, int c, float bias) {
  float d = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      d = mul_add_rn(d, in[((i + dy) * RWI + j + dx) * cp + c], w9[(dy * 3 + dx) * cp + c]);
  return __fadd_rn(d, bias);
}

// ---------------------------------------------------------------------------
// quantize: one thread per element, grid-stride
// ---------------------------------------------------------------------------

template <class T>
__global__ void __launch_bounds__(256) quantize_kernel(const float* __restrict__ x,
                                                       const float* __restrict__ qc,
                                                       T* __restrict__ out, int n) {
  const float a = qc[0], s = qc[1];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    out[i] = requant<T>(__ldg(x + i), a, s);
}

// ---------------------------------------------------------------------------
// qBSConv: integer 1x1 -> dequant + bias -> fp 3x3 depthwise + bias ->
// optional ReLU -> requantize; 10x10 input tile for an 8x8 output tile
// ---------------------------------------------------------------------------

template <class T>
struct QBArgs {
  const T* x;
  const T* pwq;
  const float *pws, *pwb, *dw, *dwb, *qc;
  T* out;
  int N, H, W, Cin, Cout, relu;
};

template <class T>
size_t qbsconv_smem(int cpi, int cpo) {
  return sizeof(float) * ((size_t)R1 * R1 * cpo + 12 * cpo) +
         sizeof(T) * ((size_t)R1 * R1 * cpi + (size_t)cpi * cpo);
}

template <class T>
__global__ void __launch_bounds__(256) qbsconv_kernel(QBArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, W = a.W, Cout = a.Cout;
  const int cpi = round4(a.Cin), cpo = round4(a.Cout);
  float* P = reinterpret_cast<float*>(smem);   // R1*R1 x cpo
  float* Dw = P + R1 * R1 * cpo;               // 9 x cpo
  float* sc = Dw + 9 * cpo;                    // [pw scale | pw bias | dw bias], cpo each
  T* X = reinterpret_cast<T*>(sc + 3 * cpo);   // R1*R1 x cpi codes
  T* Wq = X + R1 * R1 * cpi;                   // cpi x cpo codes

  stage_codes(a.pwq, a.Cin, Cout, cpi, cpo, Wq);
  stage_matrix(a.dw, 9, Cout, 9, cpo, Dw);
  stage_matrix(a.pws, 1, Cout, 1, cpo, sc);
  stage_matrix(a.pwb, 1, Cout, 1, cpo, sc + cpo);
  stage_matrix(a.dwb, 1, Cout, 1, cpo, sc + 2 * cpo);
  const float ao = a.qc[0], so = a.qc[1];

  const int ty = (H + TILE - 1) / TILE, tx = (W + TILE - 1) / TILE;
  const long long tiles = (long long)a.N * ty * tx;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n = (int)(t / (ty * tx));
    const int r = (int)(t % (ty * tx));
    const int y0 = (r / tx) * TILE, x0 = (r % tx) * TILE;
    __syncthreads();
    load_codes(a.x, n, H, W, a.Cin, y0 - 1, x0 - 1, R1, R1, cpi, X);
    __syncthreads();
    pointwise_dequant<R1>(X, cpi, Wq, cpo, sc, sc + cpo, Region<R1, R1>{y0 - 1, x0 - 1}, H, W,
                          P);
    __syncthreads();
    for (int item = threadIdx.x; item < TILE * TILE * Cout; item += blockDim.x) {
      const int c = item % Cout, q = item / Cout;
      const int i = q / TILE, j = q % TILE;
      const int y = y0 + i, xx = x0 + j;
      if (y >= H || xx >= W) continue;
      float d = depthwise_at<R1>(P, Dw, cpo, i, j, c, sc[2 * cpo + c]);
      if (a.relu) d = fmaxf(d, 0.f);
      a.out[(((size_t)n * H + y) * W + xx) * Cout + c] = requant<T>(d, ao, so);
    }
  }
}

// ---------------------------------------------------------------------------
// qDSConv: exact int32 3x3 depthwise on the codes -> dequant + bias -> fp
// 1x1 as an ordered sum over input channels -> + bias -> requantize
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <class K, class A>
int launch(K kernel, int threads, size_t smem, long long work, const A& args, void* stream) {
  int grid = 0;
  cudaError_t e = resident_grid(kernel, threads, smem, work, &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

long long tiles_of(int N, int H, int W) {
  return (long long)N * ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
}

template <class T>
int quantize_launch(const float* x, const float* qc, T* out, int n, void* stream) {
  int grid = 0;
  cudaError_t e = resident_grid(quantize_kernel<T>, 256, 0, (n + 255) / 256, &grid);
  if (e != cudaSuccess) return (int)e;
  quantize_kernel<T><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, qc, out, n);
  return (int)cudaGetLastError();
}

template <class T>
int qbsconv_launch(const QBArgs<T>& a, void* stream) {
  return launch(qbsconv_kernel<T>, 256, qbsconv_smem<T>(round4(a.Cin), round4(a.Cout)),
                tiles_of(a.N, a.H, a.W), a, stream);
}

}  // namespace

// Dynamic shared memory of one block, in bytes: kernel 0 qBSConv (cin ->
// cout); qSFB (1) lives in qsfb.cu, qDSConv (2) in dsconv.cu.
extern "C" long long qconv_smem_bytes(int kernel, int cin, int cout, int bits) {
  const int cpi = round4(cin), cpo = round4(cout);
  const bool b8 = bits <= 8;
  switch (kernel) {
    case 0: return (long long)(b8 ? qbsconv_smem<int8_t>(cpi, cpo) : qbsconv_smem<int32_t>(cpi, cpo));
    default: return -1;
  }
}

extern "C" int quantize_forward(const float* x, const float* qc, void* out, int n, int bits,
                                void* stream) {
  if (bits <= 8) return quantize_launch(x, qc, static_cast<int8_t*>(out), n, stream);
  return quantize_launch(x, qc, static_cast<int32_t*>(out), n, stream);
}

extern "C" int qbsconv_forward(const void* x, const void* pwq, const float* pws,
                               const float* pwb, const float* dw, const float* dwb,
                               const float* qc, void* out, int N, int H, int W, int Cin,
                               int Cout, int relu, int bits, void* stream) {
  if (bits <= 8)
    return qbsconv_launch(QBArgs<int8_t>{static_cast<const int8_t*>(x),
                                         static_cast<const int8_t*>(pwq), pws, pwb, dw, dwb, qc,
                                         static_cast<int8_t*>(out), N, H, W, Cin, Cout, relu},
                          stream);
  return qbsconv_launch(QBArgs<int32_t>{static_cast<const int32_t*>(x),
                                        static_cast<const int32_t*>(pwq), pws, pwb, dw, dwb, qc,
                                        static_cast<int32_t*>(out), N, H, W, Cin, Cout, relu},
                        stream);
}
