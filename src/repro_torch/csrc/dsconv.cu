// The reconstruction layer, DSConv, in its two datapaths, as one band walker:
//   fp32  (dsconv_forward):  3x3 SAME depthwise + bias -> 1x1 Cin -> Cout +
//         bias -> optional ReLU, NHWC fp32;
//   codes (qdsconv_forward): exact int32 3x3 on the lattice codes (zero off
//         the patch) -> dequant + bias -> fp 1x1 with fake-quant weights as
//         an ordered sum over input channels -> + bias -> requantize, NHWC
//         int8_t ("int8", bits <= 8) or int32_t ("fxp10") codes.
//
// Replaces the TPU kernels repro/kernels/dsconv.py::dsconv_fused (:34,
// pallas_call at :47) and repro/kernels/qconv.py::qdsconv_fused (:270,
// pallas_call at :282).
//
// What bounds it, at N = 1024 C54 32x32 patches (x4, 54 -> 48) on an H100
// SXM (3.35 TB/s; 67 TFLOP/s fp32, i.e. 33.5 T FFMA a second; every
// __fmul_rn / __fadd_rn one instruction at the same 33.5 T a second; each
// __fdiv_rn 10 instructions, its fast path as cuobjdump -sass shows it on
// sm_90a, scripts/torch_bsconv_ab.py --sass):
//   fp32: its bytes, 4 * (54 + 48) a pixel in and out, 427.8 MB, 0.1277 ms
//         (its 2.72 G FFMA take 0.081 ms);
//   int8: its rounded fp32 operations, the 1x1's 2 * 54 * 48 a pixel, the
//         dequant, biases and clips, and 48 divisions a pixel at 10: 6.20 G,
//         0.185 ms (its bytes, 106.9 MB, 0.032 ms);
//   fxp10: the same 0.185 ms of instructions (bytes 0.1277 ms).
//
// Arithmetic contract, bit for bit:
// - fp32: the order of the 8x8-tile kernel this replaces, so the output is
//   torch.equal to it and mega.cu stays torch.equal to the layer chain: each
//   depthwise output is its 9 taps as fmaf in (dy, dx) raster order from 0
//   (0 off the patch), then + bias; each pointwise output one fmaf chain over
//   input channels ascending from 0, then + bias.
// - codes: kernels/ref.py::qdsconv_ref with qmath.cuh's rounded steps:
//   dequant (float(acc) * scale) + bias; the 1x1 as mul_add_rn over input
//   channels 0..C-1 from 0; + bias; requant with its __fdiv_rn.
//   Padded channels add exact zeros.
//
// Design: a band walker (csrc/sfb.cu's shape), sized by
// kernels/dsconv.py::dsconv_report.
// - A work item is one column band of one patch, at most BAND output pixels
//   wide: a patch up to BAND wide is one band, a wider one (80x80 and up)
//   is cut into bands that read a 1-px column halo. A persistent grid walks
//   the items; each block stages the weights once.
// - The block walks its band top to bottom, S output rows a step, over a
//   ring of S + 2 input rows: each input pixel is read from device memory
//   once. A ring row is the band's input row as it lies in device memory
//   (w1 x Cin contiguous elements), copied by cp.async in the widest unit
//   its alignment allows (16 bytes where the rows start on 16 bytes: every
//   row of a 32-px C54 patch does; a C54 fp32 pixel is 216 bytes, so no
//   per-pixel 16-byte copy or TMA tile could address it). The next step's
//   rows are in flight while this step's pointwise runs: they go into the
//   slots of the rows the depthwise has just consumed.
// - The depthwise (one thread per channel group of 4, pair of adjacent
//   columns and row segment, a 3x4 register window sliding down its rows)
//   writes its output to D at a pixel stride of C (padded to 8) + 4 floats.
// - The pointwise gives a thread 4 pixels x 8 output channels: per 4 input
//   channels 4 loads of 16 bytes of D (bank-free at that stride) and 8 of
//   weights (a warp shares its channel group: the weight loads broadcast),
//   the next 4 channels' loads in flight during this step's multiply-adds.
// - Its output is staged in shared memory, unpadded (w x Cout elements a
//   row), and leaves as contiguous runs of whole band rows: neighbouring
//   lanes store neighbouring words (the tile kernel stored 4 channels a
//   thread at a 192-byte pixel stride).
// - 256 threads a block, two blocks an SM (128 registers a thread); the
//   report takes the rows a step that keep the most output rows resident
//   on an SM (C54 fp32 and fxp10: 4 rows, 110,176 B; int8: 8 rows).
// - Measured (scripts/torch_dsconv_ab.py; NVIDIA H100 80GB HBM3, 700.00 W):
//   at N = 1024 32x32 0.76x the 8x8-tile kernel's time at C54 fp32 and 0.80x
//   at C27; qDSConv 0.60x (int8) and 0.76x (fxp10) at C54. By probe at C54
//   fp32 the 1x1 takes ~0.19 ms and the depthwise ~0.16 ms of ~0.47: short
//   latency-bound stages between block barriers. A ring of 2S + 2 rows (the
//   next rows' copies issued at a step's start) fit one block an SM and ran
//   1.3x slower; a ring of padded pixels (8-byte copies a pixel, aligned
//   16-byte loads) ran no faster at C54 and 1.25x slower at C27, whose
//   108-byte pixels take 4-byte copies.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "qmath.cuh"
#include "qmma.cuh"

using namespace essr;

namespace {

constexpr int MAX_THREADS = 256;
constexpr int BAND = 32;           // widest output band, pixels

// The launch's layout (the same sums as kernels/dsconv.py::dsconv_report).
// sz: bytes of an input and of an output element (fp32 and int32: 4, int8: 1).
struct Shape {
  int cin, cout;
  int cp4, cp8, cpo8;   // Cin to 4 (the dot depth) and to 8; Cout to 8
  int dst;              // floats of one pixel of D
  int bands, bw, rw1;   // column bands, their output width, input columns of a ring row
  int S, M;             // output rows a step; ring rows
  int srow, orow;       // bytes of a ring row and of a staged output row
  __host__ __device__ Shape(int W, int Cin, int Cout, int sz, int rows) {
    cin = Cin;
    cout = Cout;
    cp4 = round4(Cin);
    cp8 = up(Cin, 8);
    cpo8 = up(Cout, 8);
    dst = cp8 + 4;
    const int b0 = (W + BAND - 1) / BAND;
    bw = (W + b0 - 1) / b0;
    bands = (W + bw - 1) / bw;
    rw1 = imin(W, bw + 2);
    S = rows;
    M = rows + 2;
    srow = up(rw1 * Cin * sz, 16);
    orow = up(bw * Cout * sz, 16);
  }
  // ring | D | O (staged output) | taps (9 x cp8, fp32 or int32 codes) |
  // depthwise scale, bias (cp8 each) | 1x1 (cp4 x cpo8) | its bias (cpo8)
  __host__ __device__ size_t smem_bytes() const {
    return (size_t)M * srow + (size_t)S * bw * dst * 4 + (size_t)S * orow +
           4 * ((size_t)11 * cp8 + (size_t)cp4 * cpo8 + cpo8);
  }
};

// One work item: output columns [bx0, bx1) of patch n, input columns
// [c1, c1 + w1) (the 1-px halo, clipped to the patch).
struct Band {
  int n, bx0, bx1, c1, w1;
  __device__ Band(long long t, const Shape& s, int W) {
    n = (int)(t / s.bands);
    bx0 = (int)(t % s.bands) * s.bw;
    bx1 = imin(W, bx0 + s.bw);
    c1 = imax(0, bx0 - 1);
    w1 = imin(W, bx1 + 1) - c1;
  }
};

template <class T>
struct Args {
  const T* x;
  const void* dw;                            // (3,3,Cin): fp32 taps, or int32 codes
  const float *dws, *dwb, *pw, *pwb, *qc;    // dws, qc: the codes' path only
  T* out;
  int N, H, W, Cin, Cout, relu, rows;
};

// Input rows [r0, r1) of band b on their way into ring slots r % M, each one
// contiguous span of w1 x Cin elements as it lies in device memory, in the
// widest unit its alignment allows (16 bytes where the rows start on 16
// bytes: every row of a 32-px patch does); the caller commits. Byte copies
// (rows not 4-byte aligned: int8 codes at odd widths) are plain loads.
template <class T>
__device__ __forceinline__ void prefetch_rows(const Args<T>& a, const Shape& s, const Band& b,
                                              int r0, int r1, char* ring) {
  if (r1 <= r0) return;
  const size_t stride = (size_t)a.W * a.Cin * sizeof(T);
  const int len = b.w1 * a.Cin * (int)sizeof(T);
  const char* src0 =
      reinterpret_cast<const char*>(a.x + (((size_t)b.n * a.H + r0) * a.W + b.c1) * a.Cin);
  const int unit = copy_unit(src0, stride, len), per = len / unit;
  for (int i = threadIdx.x; i < (r1 - r0) * per; i += blockDim.x) {
    const int q = i / per, k = i - q * per;
    const char* src = src0 + q * stride + (size_t)k * unit;
    char* dst = ring + (size_t)((r0 + q) % s.M) * s.srow + (size_t)k * unit;
    if (unit == 16)
      cp_async16(dst, src);
    else if (unit == 8)
      cp_async8(dst, src);
    else if (unit == 4)
      cp_async4(dst, src);
    else
      *dst = *src;
  }
}

// Channels c0..c0+3 of one input pixel (cin elements at px, as it lies in
// device memory), 0 past cin: 16 bytes a load where the pixel allows, else
// 8 or 4 bytes (a C54 fp32 pixel is 216 bytes, 8-byte aligned; int8 C54
// codes 54 bytes).
__device__ __forceinline__ float4 ld_px4(const float* px, int c0, int cin) {
  if (c0 + 3 < cin) {
    if ((cin & 3) == 0) return ld4(px + c0);
    if ((cin & 1) == 0) {
      const float2 u = *reinterpret_cast<const float2*>(px + c0);
      const float2 v = *reinterpret_cast<const float2*>(px + c0 + 2);
      return make_float4(u.x, u.y, v.x, v.y);
    }
    return make_float4(px[c0], px[c0 + 1], px[c0 + 2], px[c0 + 3]);
  }
  return make_float4(c0 < cin ? px[c0] : 0.f, c0 + 1 < cin ? px[c0 + 1] : 0.f,
                     c0 + 2 < cin ? px[c0 + 2] : 0.f, 0.f);
}
__device__ __forceinline__ int4 ld_px4(const int32_t* px, int c0, int cin) {
  if (c0 + 3 < cin) {
    if ((cin & 3) == 0) return *reinterpret_cast<const int4*>(px + c0);
    if ((cin & 1) == 0) {
      const int2 u = *reinterpret_cast<const int2*>(px + c0);
      const int2 v = *reinterpret_cast<const int2*>(px + c0 + 2);
      return make_int4(u.x, u.y, v.x, v.y);
    }
    return make_int4(px[c0], px[c0 + 1], px[c0 + 2], px[c0 + 3]);
  }
  return make_int4(c0 < cin ? px[c0] : 0, c0 + 1 < cin ? px[c0 + 1] : 0,
                   c0 + 2 < cin ? px[c0 + 2] : 0, 0);
}
__device__ __forceinline__ int4 ld_px4(const int8_t* px, int c0, int cin) {
  if (c0 + 3 < cin) {
    if ((cin & 3) == 0) {
      const char4 u = *reinterpret_cast<const char4*>(px + c0);
      return make_int4(u.x, u.y, u.z, u.w);
    }
    return make_int4(px[c0], px[c0 + 1], px[c0 + 2], px[c0 + 3]);
  }
  return make_int4(c0 < cin ? px[c0] : 0, c0 + 1 < cin ? px[c0 + 1] : 0,
                   c0 + 2 < cin ? px[c0 + 2] : 0, 0);
}

__device__ __forceinline__ void tap4(float4& s, float4 v, float4 w) {
  s.x = fmaf(v.x, w.x, s.x);
  s.y = fmaf(v.y, w.y, s.y);
  s.z = fmaf(v.z, w.z, s.z);
  s.w = fmaf(v.w, w.w, s.w);
}
__device__ __forceinline__ void tap4(int4& s, int4 v, int4 w) {
  s.x += v.x * w.x;
  s.y += v.y * w.y;
  s.z += v.z * w.z;
  s.w += v.w * w.w;
}

// 3x3 depthwise of output rows [y0, y1) x columns [bx0, bx1) of band b from
// the ring: output (r, c) reads input (r + dy - 1, c + dx - 1), 0 off the
// patch; V = float4 (fp32 taps, fmaf) or int4 (int32 code taps, exact); the
// sums in (dy, dx) raster order from 0, then epi(i, j, c0, acc) with
// i = r - y0, j = c - bx0. One thread per (channel group of 4, pair of
// adjacent columns, row segment) keeps the nine taps and a 3x4 window of
// inputs in registers and slides it down its rows: each input is loaded
// once per thread, and the two columns' sums are independent chains.
template <class V, class T, class Epi>
__device__ __forceinline__ void depthwise_rows(const char* ring, const Shape& s, const Band& b,
                                               int H, int W, const V* w9, int y0, int y1,
                                               Epi epi) {
  const int cin = s.cin, ng = s.cp4 >> 2, w3 = b.bx1 - b.bx0, pairs = (w3 + 1) >> 1;
  const int R = y1 - y0;
  const int segs = imax(1, imin(R, (int)blockDim.x / (ng * pairs)));
  const int seg_rows = (R + segs - 1) / segs;
  const V zero{};
  for (int item = threadIdx.x; item < ng * pairs * segs; item += blockDim.x) {
    const int g = item % ng, rest = item / ng;
    const int jp = rest % pairs, i0 = (rest / pairs) * seg_rows, i1 = imin(R, i0 + seg_rows);
    if (i0 >= i1) continue;
    const int j = 2 * jp, c = b.bx0 + j;       // this thread's columns: c and c + 1
    const bool two = j + 1 < w3;
    const bool ok0 = c > 0, ok2 = c + 1 < W, ok3 = two && c + 2 < W;
    const int x1 = (c - b.c1) * cin, c0 = 4 * g;
    int r = y0 + i0 - 1;
    auto row = [&](V& v0, V& v1, V& v2, V& v3) {
      if (r < 0 || r >= H) {
        v0 = v1 = v2 = v3 = zero;
      } else {
        const T* p = reinterpret_cast<const T*>(ring + (size_t)(r % s.M) * s.srow) + x1;
        v0 = ok0 ? ld_px4(p - cin, c0, cin) : zero;
        v1 = ld_px4(p, c0, cin);
        v2 = ok2 ? ld_px4(p + cin, c0, cin) : zero;
        v3 = ok3 ? ld_px4(p + 2 * cin, c0, cin) : zero;
      }
      ++r;
    };
    V t[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = w9[k * (s.cp8 >> 2) + g];
    V a0, a1, a2, a3, b0, b1, b2, b3;
    row(a0, a1, a2, a3);
    row(b0, b1, b2, b3);
    for (int i = i0; i < i1; ++i) {
      V c0v, c1v, c2v, c3v;
      row(c0v, c1v, c2v, c3v);
      V s0 = zero, s1 = zero;
      tap4(s0, a0, t[0]); tap4(s1, a1, t[0]);
      tap4(s0, a1, t[1]); tap4(s1, a2, t[1]);
      tap4(s0, a2, t[2]); tap4(s1, a3, t[2]);
      tap4(s0, b0, t[3]); tap4(s1, b1, t[3]);
      tap4(s0, b1, t[4]); tap4(s1, b2, t[4]);
      tap4(s0, b2, t[5]); tap4(s1, b3, t[5]);
      tap4(s0, c0v, t[6]); tap4(s1, c1v, t[6]);
      tap4(s0, c1v, t[7]); tap4(s1, c2v, t[7]);
      tap4(s0, c2v, t[8]); tap4(s1, c3v, t[8]);
      epi(i, j, c0, s0);
      if (two) epi(i, j + 1, c0, s1);
      a0 = b0; a1 = b1; a2 = b2; a3 = b3;
      b0 = c0v; b1 = c1v; b2 = c2v; b3 = c3v;
    }
  }
}

__device__ __forceinline__ float lane(float4 v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}
// acc += v * w, per channel: fp32 one fmaf; codes two rounded ops (mul_add_rn).
template <bool Q>
__device__ __forceinline__ void mac4(float4& acc, float v, float4 w) {
  if constexpr (Q) {
    acc.x = mul_add_rn(acc.x, v, w.x);
    acc.y = mul_add_rn(acc.y, v, w.y);
    acc.z = mul_add_rn(acc.z, v, w.z);
    acc.w = mul_add_rn(acc.w, v, w.w);
  } else {
    acc.x = fmaf(v, w.x, acc.x);
    acc.y = fmaf(v, w.y, acc.y);
    acc.z = fmaf(v, w.z, acc.z);
    acc.w = fmaf(v, w.w, acc.w);
  }
}

// Pointwise (1x1) over the P pixels of D (pixel p at row p / w, column
// p % w; rows of len pixels, st floats a pixel), cpin input channels (a
// multiple of 4) -> cpout output channels (a multiple of 8):
//   acc(p, co..co+7) = sum_{ci < cpin} D(p)[ci] * w[ci * cpout + co], ci ascending from 0
// then epi(p, co, acc[0..3], acc[4..7]); the epilogue adds the bias. A thread
// owns 8 output channels of 4 pixels (pg, pg + P/4, ...); consecutive threads
// take consecutive pixels of one channel group. The loads of the next 4 input
// channels are issued before the multiply-adds of the current 4.
template <bool Q, class Epi>
__device__ __forceinline__ void pointwise8(const float* D, int len, int w, int st,
                                           const float* __restrict__ wt, int cpin, int cpout,
                                           int P, Epi epi) {
  const int ng = cpout >> 3, npg = (P + 3) >> 2;
  for (int item = threadIdx.x; item < ng * npg; item += blockDim.x) {
    const int g = item / npg, pg = item - g * npg;
    const float* src[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = pg + k * npg < P ? pg + k * npg : pg;
      const int i = p / w;
      src[k] = D + ((size_t)i * len + p - i * w) * st;
    }
    float4 acc[4][2];
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k][0] = acc[k][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* wg = wt + 8 * g;
    float4 v[4], wq[4][2];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = ld4(src[k]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      wq[u][0] = ld4(wg + u * cpout);
      wq[u][1] = ld4(wg + u * cpout + 4);
    }
    for (int ci = 0; ci < cpin; ci += 4) {
      const int cn = ci + 4 < cpin ? ci + 4 : ci;
      float4 vn[4], wn[4][2];
#pragma unroll
      for (int k = 0; k < 4; ++k) vn[k] = ld4(src[k] + cn);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        wn[u][0] = ld4(wg + (cn + u) * cpout);
        wn[u][1] = ld4(wg + (cn + u) * cpout + 4);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          mac4<Q>(acc[k][0], lane(v[k], u), wq[u][0]);
          mac4<Q>(acc[k][1], lane(v[k], u), wq[u][1]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = vn[k];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        wq[u][0] = wn[u][0];
        wq[u][1] = wn[u][1];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (pg + k * npg < P) epi(pg + k * npg, 8 * g, acc[k][0], acc[k][1]);
  }
}

// Staged output rows [0, R) of a step (w3 x Cout elements each, O rows of
// orow bytes) to device memory from pixel `first` on: each row one
// contiguous span, in the widest unit the destination allows.
template <class T>
__device__ __forceinline__ void store_rows(const char* O, const Shape& s, T* out, size_t first,
                                           int W, int R, int w3) {
  const size_t stride = (size_t)W * s.cout * sizeof(T);
  const int len = w3 * s.cout * (int)sizeof(T);
  char* dst0 = reinterpret_cast<char*>(out + first * s.cout);
  const int unit = copy_unit(dst0, stride, len), per = len / unit;
  for (int k = threadIdx.x; k < R * per; k += blockDim.x) {
    const int i = k / per, u = k - i * per;
    const char* src = O + (size_t)i * s.orow + (size_t)u * unit;
    char* dst = dst0 + i * stride + (size_t)u * unit;
    if (unit == 16)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else if (unit == 8)
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    else if (unit == 4)
      *reinterpret_cast<unsigned*>(dst) = *reinterpret_cast<const unsigned*>(src);
    else
      *dst = *src;
  }
}

// Q: the codes' datapath (T = int8_t / int32_t); else fp32 (T = float).
template <bool Q, class T>
__global__ void __launch_bounds__(MAX_THREADS, 2) dsconv_kernel(Args<T> a) {
  using V = typename std::conditional<Q, int4, float4>::type;
  extern __shared__ __align__(16) unsigned char sm[];
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const Shape s(W, Cin, Cout, (int)sizeof(T), a.rows);
  const int S = s.S;
  char* ring = reinterpret_cast<char*>(sm);                        // M rows of srow bytes
  float* D = reinterpret_cast<float*>(ring + (size_t)s.M * s.srow);  // S x bw pixels
  char* O = reinterpret_cast<char*>(D + (size_t)S * s.bw * s.dst);   // S rows of orow bytes
  float* taps = reinterpret_cast<float*>(O + (size_t)S * s.orow);    // 9 x cp8
  float* dws = taps + 9 * s.cp8;
  float* dwb = dws + s.cp8;
  float* PW = dwb + s.cp8;                                         // cp4 x cpo8
  float* pwb = PW + s.cp4 * s.cpo8;

  if constexpr (Q) {
    stage_codes(static_cast<const int32_t*>(a.dw), 9, Cin, 9, s.cp8,
                reinterpret_cast<int32_t*>(taps));
    stage_matrix(a.dws, 1, Cin, 1, s.cp8, dws);
  } else {
    stage_matrix(static_cast<const float*>(a.dw), 9, Cin, 9, s.cp8, taps);
  }
  stage_matrix(a.dwb, 1, Cin, 1, s.cp8, dwb);
  stage_matrix(a.pw, Cin, Cout, s.cp4, s.cpo8, PW);
  stage_matrix(a.pwb, 1, Cout, 1, s.cpo8, pwb);
  float ao = 0.f, so = 1.f;
  if constexpr (Q) {
    ao = __ldg(a.qc);
    so = __ldg(a.qc + 1);
  }

  const long long items = (long long)a.N * s.bands;
  if (blockIdx.x < items) prefetch_rows(a, s, Band(blockIdx.x, s, W), 0, imin(H, S + 1), ring);
  cp_commit();
  for (long long t = blockIdx.x; t < items; t += gridDim.x) {
    const Band b(t, s, W);
    const int w3 = b.bx1 - b.bx0;
    for (int y0 = 0; y0 < H; y0 += S) {
      const int y1 = imin(H, y0 + S), R = y1 - y0;
      cp_wait_all();
      __syncthreads();     // the rows have landed; O of the last step has left
      depthwise_rows<V, T>(ring, s, b, H, W, reinterpret_cast<const V*>(taps), y0, y1,
                           [&](int i, int j, int c0, V acc) {
                             float4 v;
                             if constexpr (Q)
                               v = make_float4(dequant(acc.x, dws[c0], dwb[c0]),
                                               dequant(acc.y, dws[c0 + 1], dwb[c0 + 1]),
                                               dequant(acc.z, dws[c0 + 2], dwb[c0 + 2]),
                                               dequant(acc.w, dws[c0 + 3], dwb[c0 + 3]));
                             else
                               v = add4(acc, ld4(dwb + c0));
                             st4(D + ((size_t)i * s.bw + j) * s.dst + c0, v);
                           });
      __syncthreads();
      // the next step's input rows (or the next item's first rows) into the
      // slots the depthwise has consumed; they land during the pointwise
      if (y1 < H)
        prefetch_rows(a, s, b, y1 + 1, imin(H, y1 + 1 + S), ring);
      else if (t + gridDim.x < items)
        prefetch_rows(a, s, Band(t + gridDim.x, s, W), 0, imin(H, S + 1), ring);
      cp_commit();
      pointwise8<Q>(D, s.bw, w3, s.dst, PW, s.cp4, s.cpo8, R * w3,
                    [&](int p, int co, float4 lo, float4 hi) {
                      const int i = p / w3, j = p - i * w3;
                      T* px = reinterpret_cast<T*>(O + (size_t)i * s.orow) + (size_t)j * Cout;
                      if constexpr (Q) {
                        const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
                        for (int e = 0; e < 8; ++e)
                          if (co + e < Cout)
                            px[co + e] = requant<T>(__fadd_rn(v[e], pwb[co + e]), ao, so);
                      } else {
                        lo = add4(lo, ld4(pwb + co));
                        hi = add4(hi, ld4(pwb + co + 4));
                        if (a.relu) {
                          lo = relu4(lo);
                          hi = relu4(hi);
                        }
                        if ((Cout & 3) == 0) {
                          if (co < Cout) st4(px + co, lo);
                          if (co + 4 < Cout) st4(px + co + 4, hi);
                        } else {
                          store4(px, co, Cout, lo);
                          store4(px, co + 4, Cout, hi);
                        }
                      }
                    });
      __syncthreads();
      store_rows(O, s, a.out, ((size_t)b.n * H + y0) * W + b.bx0, W, R, w3);
    }
  }
  cp_wait_all();
}

template <bool Q, class T>
int launch(const Args<T>& a, int threads, void* stream) {
  if (a.rows < 1 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || a.Cin < 1 ||
      a.Cin > 64 || a.Cout < 1 || a.Cout > 64)
    return (int)cudaErrorInvalidValue;
  const Shape s(a.W, a.Cin, a.Cout, (int)sizeof(T), a.rows);
  const size_t smem = s.smem_bytes();
  int grid = 0;
  cudaError_t e = resident_grid(dsconv_kernel<Q, T>, threads, smem, (long long)a.N * s.bands,
                                &grid);
  if (e != cudaSuccess) return (int)e;
  dsconv_kernel<Q, T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <class K>
int blocks_per_sm(K kernel, size_t smem, int threads) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
      cudaSuccess)
    return 0;
  return per_sm;
}

}  // namespace

// Dynamic shared memory of one block, in bytes (kernels/dsconv.py::
// dsconv_report states the same); bits 0 for fp32, 1..8 for int8 codes,
// wider for int32 codes.
extern "C" long long dsconv_smem_bytes(int W, int Cin, int Cout, int bits, int rows) {
  const int sz = bits > 0 && bits <= 8 ? 1 : 4;
  return (long long)Shape(W, Cin, Cout, sz, rows).smem_bytes();
}

// Blocks of `threads` that one SM holds at once for that shape (0 when the
// query fails), for the sizing report.
extern "C" int dsconv_blocks_per_sm(int W, int Cin, int Cout, int bits, int rows, int threads) {
  const int sz = bits > 0 && bits <= 8 ? 1 : 4;
  const size_t smem = Shape(W, Cin, Cout, sz, rows).smem_bytes();
  if (bits == 0) return blocks_per_sm(dsconv_kernel<false, float>, smem, threads);
  if (bits <= 8) return blocks_per_sm(dsconv_kernel<true, int8_t>, smem, threads);
  return blocks_per_sm(dsconv_kernel<true, int32_t>, smem, threads);
}

extern "C" int dsconv_forward(const float* x, const float* dw, const float* dwb,
                              const float* pw, const float* pwb, float* out, int N, int H,
                              int W, int Cin, int Cout, int relu, int rows, int threads,
                              void* stream) {
  const Args<float> a{x, dw, nullptr, dwb, pw, pwb, nullptr, out, N, H, W, Cin, Cout, relu, rows};
  return launch<false>(a, threads, stream);
}

extern "C" int qdsconv_forward(const void* x, const int32_t* dwq, const float* dws,
                               const float* dwb, const float* pw, const float* pwb,
                               const float* qc, void* out, int N, int H, int W, int Cin,
                               int Cout, int bits, int rows, int threads, void* stream) {
  if (bits <= 8)
    return launch<true>(Args<int8_t>{static_cast<const int8_t*>(x), dwq, dws, dwb, pw, pwb, qc,
                                     static_cast<int8_t*>(out), N, H, W, Cin, Cout, 0, rows},
                        threads, stream);
  return launch<true>(Args<int32_t>{static_cast<const int32_t*>(x), dwq, dws, dwb, pw, pwb, qc,
                                    static_cast<int32_t*>(out), N, H, W, Cin, Cout, 0, rows},
                      threads, stream);
}
