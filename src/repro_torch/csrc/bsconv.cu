// The first layer, BSConv, in its two datapaths, as one band walker:
//   fp32  (bsconv_forward):  1x1 Cin -> Cout + bias -> 3x3 SAME depthwise on
//         the 1x1's output + bias -> optional ReLU, NHWC fp32;
//   codes (qbsconv_forward): exact integer 1x1 on the lattice codes ->
//         dequant + bias -> fp 3x3 with fake-quant weights + bias -> optional
//         ReLU -> requantize, NHWC int8_t ("int8", bits <= 8) or int32_t
//         ("fxp10") codes.
//
// Replaces the TPU kernels repro/kernels/bsconv.py::bsconv_fused (:57,
// pallas_call at :76) and repro/kernels/qconv.py::qbsconv_fused (:175,
// pallas_call at :187).
//
// What bounds it, at N = 1024 C54 32x32 patches (the first layer, 3 -> 54)
// on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32, i.e. 33.5 T FFMA a second;
// every __fmul_rn / __fadd_rn one instruction at the same 33.5 T a second;
// each __fdiv_rn 10 instructions: its fast path as cuobjdump -sass shows it
// on sm_90a, BSSY, MUFU.RCP, FCHK, 5 FFMA, BRA, BSYNC, from
// scripts/torch_bsconv_ab.py --sass):
//   fp32: its bytes, 4 * (3 + 54) a pixel in and out, 239.1 MB, 0.0714 ms
//         (its 0.68 G FFMA take 0.020 ms);
//   int8: its rounded fp32 operations, 24 an output code (dequant, the
//         depthwise, bias, clip, divide) with the divide priced at 10:
//         1.359 G + 9 x 56.6 M = 1.869 G instructions, 0.0558 ms (its bytes,
//         59.8 MB, 0.018 ms);
//   fxp10: its bytes, 0.0714 ms (the same 0.0558 ms of instructions).
//
// Arithmetic contract, bit for bit:
// - fp32: the order of the 8x8-tile kernel this replaces, so the output is
//   torch.equal to it and mega.cu (whose first layer sums in this order)
//   stays torch.equal to the layer chain: each pointwise output is one fmaf
//   chain over input channels ascending from 0, then + bias, and 0 off the
//   patch (the depthwise's SAME padding applies to the 1x1's OUTPUT, bias
//   included); each depthwise output its 9 taps as fmaf in (dy, dx) raster
//   order from 0, then + bias, then the optional ReLU.
// - codes: kernels/ref.py::qbsconv_ref with qmath.cuh's rounded steps: an
//   exact integer dot (__dp4a for int8, int32 multiply-add for fxp10);
//   dequant (float(acc) * scale) + bias, 0 off the patch; the depthwise as
//   mul_add_rn in raster order from 0, then __fadd_rn bias; the optional
//   ReLU; requant with its __fdiv_rn (skipped where the ReLU gave 0,
//   relu_requant: bit-equal). Padded channels add exact zeros.
//
// Design: csrc/dsconv.cu's band walker turned around (1x1 first, depthwise
// second), sized by kernels/bsconv.py::bsconv_report.
// - A work item is one column band of one patch, at most BAND output pixels
//   wide: a patch up to BAND wide is one band, a wider one (80x80 and up) is
//   cut into bands that read a 1-px column halo. A persistent grid walks the
//   items; each block stages the weights once.
// - The block walks its band top to bottom, S output rows a step. The
//   step's new input rows (S + 1 on the first step, then S) sit in a ring of
//   S + 1 rows, each the band's input row as it lies in device memory
//   (w1 x Cin contiguous elements), copied by cp.async in the widest unit
//   its alignment allows; the next step's rows are copied while this step's
//   depthwise runs.
// - The 1x1 runs once per input pixel: its output rows go to a ring of S + 2
//   rows (the two rows above a step are the last step's), at a pixel stride
//   of 4q floats (q >= Cout / 4 groups, q chosen so that the depthwise's
//   lanes fall on distinct banks). Rows off the patch are never computed:
//   the depthwise reads them as 0. A thread owns one group of 4 output
//   channels and walks pixels; at Cin <= 4 it keeps that group's weights in
//   registers (4 FFMA an output at Cin = 3), at wider Cin it reads them from
//   shared memory.
// - The depthwise gives a thread one group of 4 channels and two adjacent
//   columns: it keeps its 9 taps in registers and slides a 3x4 window of
//   16-byte loads down its rows, so each output row reads one new row.
// - The step's output is staged in shared memory unpadded (bw x Cout
//   elements a row, two buffers) and leaves, where its runs allow (16-byte
//   aligned, a multiple of 16 bytes), by bulk asynchronous copies issued at
//   the next step's start (a full 32-px band is one run of S rows; the copy
//   of the buffer two steps back has read it before it is rewritten);
//   elsewhere neighbouring lanes store neighbouring words.
// - 256 threads a block, two blocks an SM (128 registers a thread), two
//   block barriers a step.
// - Measured (scripts/torch_bsconv_ab.py; NVIDIA H100 80GB HBM3, 700.00 W;
//   N = 1024 32x32, 3 -> C, mean of 20 queued launches, four calls): C54
//   fp32 0.173–0.177 ms against the 8x8-tile kernel's 0.279–0.284 (0.62x),
//   int8 0.236–0.239 against 0.451–0.454 (0.52x), fxp10 0.265–0.268 against
//   0.496–0.503 (0.53x); at C27 0.60x / 0.54x / 0.51x. By probe at C54 fp32
//   the walk with neither stage (copies, barriers, stores) takes 0.097 ms,
//   either stage alone adds little to it (no 1x1 0.128, no depthwise 0.102),
//   both together 0.08 ms; the codes' depthwise is 0.17 of int8's 0.24 ms.
//   Bulk stores beat the threads' stores by 0.01–0.03 ms; the copy wait costs
//   nothing.
//   The next row's loads held in registers ahead of the taps (8–56 bytes of
//   spills), an unrolled row loop (spills) and a pipeline with one barrier a
//   step (step k's depthwise beside step k + 1's 1x1, rings of 2S + 2 rows;
//   124 bytes of spills) all ran slower.
#include <stdint.h>

#include <type_traits>

#include "cluster.cuh"
#include "common.cuh"
#include "qmath.cuh"
#include "qmma.cuh"

using namespace essr;

namespace {

constexpr int MAX_THREADS = 256;
constexpr int BAND = 32;           // widest output band, pixels

// The launch's layout (the same sums as kernels/bsconv.py::bsconv_report).
// sz: bytes of an input and of an output element (fp32 and int32: 4, int8: 1).
struct Shape {
  int cin, cout, sz;
  int cp4, cpo4, ng;    // Cin and Cout to 4; groups of 4 output channels
  int pst;              // floats of one pixel of the 1x1's ring
  int bands, bw, rw1;   // column bands, their output width, input columns of a row
  int S;                // output rows a step
  int srow, orow;       // bytes of an input row and of a staged output row
  __host__ __device__ Shape(int W, int Cin, int Cout, int elem, int rows) {
    cin = Cin;
    cout = Cout;
    sz = elem;
    cp4 = round4(Cin);
    cpo4 = round4(Cout);
    ng = cpo4 >> 2;
    // 2q = ng (mod 8) for even ng, ng + 1 for odd: the 8 lanes of a 16-byte
    // load phase of the depthwise (channel group fastest, then column pairs)
    // fall on distinct banks, but for one lane at odd ng
    int q = ng;
    while ((q & 3) != ((up(ng, 2) >> 1) & 3)) ++q;
    pst = 4 * q;
    const int b0 = (W + BAND - 1) / BAND;
    bw = (W + b0 - 1) / b0;
    bands = (W + bw - 1) / bw;
    rw1 = imin(W, bw + 2);
    S = rows;
    srow = up(rw1 * Cin * sz, 16);
    orow = up(bw * Cout * sz, 16);
  }
  // input ring (S + 1 rows) | 1x1 ring (S + 2 rows of rw1 pixels) | two
  // staged outputs (S rows each) | taps (9 x cpo4) | 1x1 scale (codes),
  // 1x1 bias, depthwise bias (cpo4 each) | 1x1 weights (cp4 x cpo4 elements)
  __host__ __device__ size_t smem_bytes() const {
    return (size_t)(S + 1) * srow + (size_t)(S + 2) * rw1 * pst * 4 + (size_t)2 * S * orow +
           (size_t)48 * cpo4 + (size_t)cp4 * cpo4 * sz;
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
  const T* pw;                               // (Cin,Cout): fp32, or codes
  const float *pws, *pwb, *dw, *dwb, *qc;    // pws, qc: the codes' path only
  T* out;
  int N, H, W, Cin, Cout, relu, rows;
};

// Input rows [r0, r1) of band b into ring slots 0.., each one contiguous
// span of w1 x Cin elements as it lies in device memory, in the widest unit
// its alignment allows; the caller commits. Byte copies (int8 codes at
// widths that leave rows off 4 bytes) are plain loads.
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
    char* dst = ring + (size_t)q * s.srow + (size_t)k * unit;
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
// device memory), 0 past cin, in the widest loads the pixel allows; int8
// codes as one word of 4 bytes (the operand of __dp4a).
__device__ __forceinline__ float4 ld_in(const float* px, int c0, int cin) {
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
__device__ __forceinline__ int4 ld_in(const int32_t* px, int c0, int cin) {
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
__device__ __forceinline__ int ld_in(const int8_t* px, int c0, int cin) {
  if (c0 + 3 < cin && (cin & 3) == 0) return *reinterpret_cast<const int*>(px + c0);
  unsigned w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (c0 + k < cin) w |= (unsigned)(unsigned char)px[c0 + k] << (8 * k);
  return (int)w;
}

__device__ __forceinline__ void fma4(float4& a, float v, float4 w) {
  a.x = fmaf(v, w.x, a.x);
  a.y = fmaf(v, w.y, a.y);
  a.z = fmaf(v, w.z, a.z);
  a.w = fmaf(v, w.w, a.w);
}
__device__ __forceinline__ void imad4(int4& a, int v, int4 w) {
  a.x += v * w.x;
  a.y += v * w.y;
  a.z += v * w.z;
  a.w += v * w.w;
}

// The 1x1 of one datapath for one group of 4 output channels: Acc its sums,
// Wt the weights of 4 input channels c0..c0+3 for them (as stage_matrix /
// stage_codes lay them out), step() adds those input channels of one pixel.
template <class T>
struct Pw;
template <>
struct Pw<float> {
  using Acc = float4;
  struct Wt {
    float4 w[4];
  };
  static __device__ __forceinline__ Wt load(const float* pw, int cpo, int c0, int g) {
    Wt r;
#pragma unroll
    for (int u = 0; u < 4; ++u) r.w[u] = ld4(pw + (size_t)(c0 + u) * cpo + 4 * g);
    return r;
  }
  static __device__ __forceinline__ void step(Acc& a, const float* px, int c0, int cin,
                                              const Wt& w) {
    const float4 x = ld_in(px, c0, cin);
    fma4(a, x.x, w.w[0]);
    fma4(a, x.y, w.w[1]);
    fma4(a, x.z, w.w[2]);
    fma4(a, x.w, w.w[3]);
  }
};
template <>
struct Pw<int32_t> {
  using Acc = int4;
  struct Wt {
    int4 w[4];
  };
  static __device__ __forceinline__ Wt load(const int32_t* pw, int cpo, int c0, int g) {
    Wt r;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      r.w[u] = *reinterpret_cast<const int4*>(pw + (size_t)(c0 + u) * cpo + 4 * g);
    return r;
  }
  static __device__ __forceinline__ void step(Acc& a, const int32_t* px, int c0, int cin,
                                              const Wt& w) {
    const int4 x = ld_in(px, c0, cin);
    imad4(a, x.x, w.w[0]);
    imad4(a, x.y, w.w[1]);
    imad4(a, x.z, w.w[2]);
    imad4(a, x.w, w.w[3]);
  }
};
template <>
struct Pw<int8_t> {
  using Acc = int4;
  struct Wt {
    int4 w;     // one __dp4a word (input channels c0..c0+3) per output channel
  };
  static __device__ __forceinline__ Wt load(const int8_t* pw, int cpo, int c0, int g) {
    return {*reinterpret_cast<const int4*>(pw + 4 * ((size_t)(c0 >> 2) * cpo + 4 * g))};
  }
  static __device__ __forceinline__ void step(Acc& a, const int8_t* px, int c0, int cin,
                                              const Wt& w) {
    const int x = ld_in(px, c0, cin);
    a.x = __dp4a(x, w.w.x, a.x);
    a.y = __dp4a(x, w.w.y, a.y);
    a.z = __dp4a(x, w.w.z, a.z);
    a.w = __dp4a(x, w.w.w, a.w);
  }
};

// Ring row i and column j of pixel (i, j) moved on by k pixels of rows w1
// wide (no division: k and w1 keep the loop short).
__device__ __forceinline__ void advance(int& i, int& j, int k, int w1) {
  j += k;
  while (j >= w1) {
    j -= w1;
    ++i;
  }
}

// The 1x1 over the P input pixels of the ring (pixel p at slot p / w1,
// column p % w1), Cin -> the padded Cout: a thread owns one group g of 4
// output channels and walks pixels l, l + lanes, ..., two at a time; its
// sums run over input channels ascending from 0, then epi(i, j, 4 g, acc).
// KC = 4: Cin <= 4, the group's weights held in registers; KC = 0: any Cin,
// the weights read from shared memory per pixel.
template <class T, int KC, class Epi>
__device__ __forceinline__ void pointwise_rows(const char* ring, const Shape& s, int w1,
                                               const T* pw, int P, Epi epi) {
  using Op = Pw<T>;
  const int ng = s.ng, lanes = (int)blockDim.x / ng;
  const int g = threadIdx.x % ng, l = threadIdx.x / ng;
  if (l >= lanes) return;
  typename Op::Wt wr{};
  if constexpr (KC > 0) wr = Op::load(pw, s.cpo4, 0, g);
  int i = 0, j = 0;
  advance(i, j, l, w1);
  for (int p = l; p < P; p += 2 * lanes) {
    int i2 = i, j2 = j;
    advance(i2, j2, lanes, w1);
    const bool two = p + lanes < P;
    const T* pa = reinterpret_cast<const T*>(ring + (size_t)i * s.srow) + (size_t)j * s.cin;
    const T* pb = two ? reinterpret_cast<const T*>(ring + (size_t)i2 * s.srow) +
                            (size_t)j2 * s.cin
                      : pa;
    typename Op::Acc a{}, b{};
    if constexpr (KC > 0) {
      Op::step(a, pa, 0, s.cin, wr);
      Op::step(b, pb, 0, s.cin, wr);
    } else {
      for (int c0 = 0; c0 < s.cp4; c0 += 4) {
        const typename Op::Wt w = Op::load(pw, s.cpo4, c0, g);
        Op::step(a, pa, c0, s.cin, w);
        Op::step(b, pb, c0, s.cin, w);
      }
    }
    epi(i, j, 4 * g, a);
    if (two) epi(i2, j2, 4 * g, b);
    i = i2;
    j = j2;
    advance(i, j, lanes, w1);
  }
}

// One depthwise tap on 4 channels: fp32 one fmaf each; codes two rounded
// ops each (qmma.cuh's mac4, mul_add_rn).
template <bool Q>
__device__ __forceinline__ void tap4(float4& s, float4 v, float4 w) {
  if constexpr (Q) {
    mac4(s, v, w);
  } else {
    s.x = fmaf(v.x, w.x, s.x);
    s.y = fmaf(v.y, w.y, s.y);
    s.z = fmaf(v.z, w.z, s.z);
    s.w = fmaf(v.w, w.w, s.w);
  }
}

// 3x3 depthwise of output rows [y0, y1) x columns [bx0, bx1) of band b from
// the 1x1's ring P (row r in slot r % (S + 2), rw1 pixels of pst floats):
// output (r, c) reads P (r + dy - 1, c + dx - 1), 0 off the patch; the sums
// in (dy, dx) raster order from 0, then epi(i, j, c0, acc) with i = r - y0,
// j = c - bx0. One thread per (channel group of 4, pair of adjacent
// columns, row segment) keeps the nine taps and a 3x4 window of inputs in
// registers and slides it down its rows: each input is loaded once per
// thread, and the two columns' sums are independent chains.
template <bool Q, class Epi>
__device__ __forceinline__ void depthwise_rows(const float* P, const Shape& s, const Band& b,
                                               int H, int W, const float4* w9, int y0, int y1,
                                               Epi epi) {
  const int ng = s.ng, w3 = b.bx1 - b.bx0, pairs = (w3 + 1) >> 1, R = y1 - y0;
  const int segs = imax(1, imin(R, (int)blockDim.x / (ng * pairs)));
  const int seg_rows = (R + segs - 1) / segs;
  const int M = s.S + 2, rowf = s.rw1 * s.pst, st = s.pst;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int item = threadIdx.x; item < ng * pairs * segs; item += blockDim.x) {
    const int g = item % ng, rest = item / ng;
    const int jp = rest % pairs, i0 = (rest / pairs) * seg_rows, i1 = imin(R, i0 + seg_rows);
    if (i0 >= i1) continue;
    const int j = 2 * jp, c = b.bx0 + j;       // this thread's columns: c and c + 1
    const bool two = j + 1 < w3;
    const bool ok0 = c > 0, ok2 = c + 1 < W, ok3 = two && c + 2 < W;
    const int x1 = (c - b.c1) * st + 4 * g;
    int r = y0 + i0 - 1, slot = r < 0 ? M - 1 : r % M;   // row r's slot, kept as r moves
    auto row = [&](float4& v0, float4& v1, float4& v2, float4& v3) {
      if (r < 0 || r >= H) {
        v0 = v1 = v2 = v3 = zero;
      } else {
        const float* p = P + (size_t)slot * rowf + x1;
        v0 = ok0 ? ld4(p - st) : zero;
        v1 = ld4(p);
        v2 = ok2 ? ld4(p + st) : zero;
        v3 = ok3 ? ld4(p + 2 * st) : zero;
      }
      ++r;
      slot = slot + 1 == M ? 0 : slot + 1;
    };
    float4 t[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = w9[k * ng + g];
    float4 a0, a1, a2, a3, b0, b1, b2, b3;
    row(a0, a1, a2, a3);
    row(b0, b1, b2, b3);
    for (int i = i0; i < i1; ++i) {
      float4 c0v, c1v, c2v, c3v;
      row(c0v, c1v, c2v, c3v);
      float4 s0 = zero, s1 = zero;
      tap4<Q>(s0, a0, t[0]); tap4<Q>(s1, a1, t[0]);
      tap4<Q>(s0, a1, t[1]); tap4<Q>(s1, a2, t[1]);
      tap4<Q>(s0, a2, t[2]); tap4<Q>(s1, a3, t[2]);
      tap4<Q>(s0, b0, t[3]); tap4<Q>(s1, b1, t[3]);
      tap4<Q>(s0, b1, t[4]); tap4<Q>(s1, b2, t[4]);
      tap4<Q>(s0, b2, t[5]); tap4<Q>(s1, b3, t[5]);
      tap4<Q>(s0, c0v, t[6]); tap4<Q>(s1, c1v, t[6]);
      tap4<Q>(s0, c1v, t[7]); tap4<Q>(s1, c2v, t[7]);
      tap4<Q>(s0, c2v, t[8]); tap4<Q>(s1, c3v, t[8]);
      epi(i, j, 4 * g, s0);
      if (two) epi(i, j + 1, 4 * g, s1);
      a0 = b0; a1 = b1; a2 = b2; a3 = b3;
      b0 = c0v; b1 = c1v; b2 = c2v; b3 = c3v;
    }
  }
}

// Channels c0..c0+3 of one staged output pixel (C elements at px), dropping
// the padding, in the widest stores the pixel's alignment allows.
__device__ __forceinline__ void put4(float* px, int c0, int C, float4 v) {
  if (c0 + 3 < C && (C & 3) == 0) {
    st4(px + c0, v);
  } else if (c0 + 3 < C && (C & 1) == 0) {
    *reinterpret_cast<float2*>(px + c0) = make_float2(v.x, v.y);
    *reinterpret_cast<float2*>(px + c0 + 2) = make_float2(v.z, v.w);
  } else {
    store4(px, c0, C, v);
  }
}
__device__ __forceinline__ void put4(int32_t* px, int c0, int C, int4 v) {
  if (c0 + 3 < C && (C & 3) == 0) {
    *reinterpret_cast<int4*>(px + c0) = v;
  } else if (c0 + 3 < C && (C & 1) == 0) {
    *reinterpret_cast<int2*>(px + c0) = make_int2(v.x, v.y);
    *reinterpret_cast<int2*>(px + c0 + 2) = make_int2(v.z, v.w);
  } else {
    if (c0 < C) px[c0] = v.x;
    if (c0 + 1 < C) px[c0 + 1] = v.y;
    if (c0 + 2 < C) px[c0 + 2] = v.z;
    if (c0 + 3 < C) px[c0 + 3] = v.w;
  }
}
__device__ __forceinline__ void put4(int8_t* px, int c0, int C, int4 v) {
  if (c0 + 3 < C && (C & 3) == 0) {
    *reinterpret_cast<char4*>(px + c0) = make_char4(v.x, v.y, v.z, v.w);
  } else if (c0 + 3 < C && (C & 1) == 0) {
    *reinterpret_cast<char2*>(px + c0) = make_char2(v.x, v.y);
    *reinterpret_cast<char2*>(px + c0 + 2) = make_char2(v.z, v.w);
  } else {
    if (c0 < C) px[c0] = (int8_t)v.x;
    if (c0 + 1 < C) px[c0 + 1] = (int8_t)v.y;
    if (c0 + 2 < C) px[c0 + 2] = (int8_t)v.z;
    if (c0 + 3 < C) px[c0 + 3] = (int8_t)v.w;
  }
}

// Staged output rows [0, R) (w3 x Cout elements each, rows of orow bytes at
// O) to device memory from pixel `first` on, each row one contiguous span.
// Where every span starts on 16 bytes and is a multiple of 16 bytes, thread
// 0 issues them as bulk copies (one for all R rows when the band spans the
// patch) and commits; else the block stores them, neighbouring lanes on
// neighbouring words.
template <class T>
__device__ __forceinline__ void store_rows(const char* O, const Shape& s, T* out, size_t first,
                                           int W, int R, int w3) {
  const size_t stride = (size_t)W * s.cout * sizeof(T);
  const int len = w3 * s.cout * (int)sizeof(T);
  char* dst0 = reinterpret_cast<char*>(out + first * s.cout);
  if (((reinterpret_cast<size_t>(dst0) | stride | (size_t)len) & 15) == 0) {
    if (threadIdx.x == 0) {
      if (stride == (size_t)len && s.orow == len)
        bulk_store(dst0, O, R * len);
      else
        for (int i = 0; i < R; ++i) bulk_store(dst0 + i * stride, O + (size_t)i * s.orow, len);
      bulk_commit();
    }
    return;
  }
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

// T = float: fp32; int8_t / int32_t: the codes' datapath. KC: see
// pointwise_rows.
template <class T, int KC>
__global__ void __launch_bounds__(MAX_THREADS, 2) bsconv_kernel(Args<T> a) {
  constexpr bool Q = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char sm[];
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const Shape s(W, Cin, Cout, (int)sizeof(T), a.rows);
  const int S = s.S, M = S + 2, rowf = s.rw1 * s.pst;
  char* ring = reinterpret_cast<char*>(sm);                             // S + 1 input rows
  float* P = reinterpret_cast<float*>(ring + (size_t)(S + 1) * s.srow);  // M rows of rowf
  char* O = reinterpret_cast<char*>(P + (size_t)M * rowf);               // 2 x S rows of orow
  float* taps = reinterpret_cast<float*>(O + (size_t)2 * S * s.orow);    // 9 x cpo4
  float* pws = taps + 9 * s.cpo4;
  float* pwb = pws + s.cpo4;
  float* dwb = pwb + s.cpo4;
  T* PW = reinterpret_cast<T*>(dwb + s.cpo4);                           // cp4 x cpo4

  if constexpr (Q) {
    stage_codes(a.pw, Cin, Cout, s.cp4, s.cpo4, PW);
    stage_matrix(a.pws, 1, Cout, 1, s.cpo4, pws);
  } else {
    stage_matrix(a.pw, Cin, Cout, s.cp4, s.cpo4, PW);
  }
  stage_matrix(a.pwb, 1, Cout, 1, s.cpo4, pwb);
  stage_matrix(a.dw, 9, Cout, 9, s.cpo4, taps);
  stage_matrix(a.dwb, 1, Cout, 1, s.cpo4, dwb);
  float ao = 0.f, so = 1.f;
  if constexpr (Q) {
    ao = __ldg(a.qc);
    so = __ldg(a.qc + 1);
  }

  const long long items = (long long)a.N * s.bands;
  if (blockIdx.x < items) prefetch_rows(a, s, Band(blockIdx.x, s, W), 0, imin(H, S + 1), ring);
  cp_commit();
  // the last step's staged output, stored at the next step's start
  int pend = -1, pend_R = 0, pend_w3 = 0, buf = 0;
  size_t pend_first = 0;
  for (long long t = blockIdx.x; t < items; t += gridDim.x) {
    const Band b(t, s, W);
    const int w3 = b.bx1 - b.bx0;
    for (int y0 = 0; y0 < H; y0 += S) {
      const int y1 = imin(H, y0 + S);
      const int p0 = y0 == 0 ? 0 : y0 + 1, p1 = imin(H, y0 + S + 1);   // new 1x1 rows
      const int s0 = p0 % M;                                              // row p0's slot
      cp_wait_all();
      __syncthreads();     // the rows have landed; the last step's output is staged
      if (pend >= 0) store_rows(O + (size_t)pend * S * s.orow, s, a.out, pend_first, W, pend_R,
                                pend_w3);
      if (threadIdx.x == 0) bulk_wait_read_n<1>();   // O[buf] has been read
      pointwise_rows<T, KC>(ring, s, b.w1, PW, (p1 - p0) * b.w1,
                            [&](int i, int j, int c0, typename Pw<T>::Acc acc) {
                              float4 v;
                              if constexpr (Q)
                                v = make_float4(dequant(acc.x, pws[c0], pwb[c0]),
                                                dequant(acc.y, pws[c0 + 1], pwb[c0 + 1]),
                                                dequant(acc.z, pws[c0 + 2], pwb[c0 + 2]),
                                                dequant(acc.w, pws[c0 + 3], pwb[c0 + 3]));
                              else
                                v = add4(acc, ld4(pwb + c0));
                              const int slot = s0 + i < M ? s0 + i : s0 + i - M;
                              st4(P + (size_t)slot * rowf + j * s.pst + c0, v);
                            });
      __syncthreads();
      // the next step's input rows (or the next item's first rows) into the
      // ring the 1x1 has consumed; they land during the depthwise
      if (y1 < H)
        prefetch_rows(a, s, b, y1 + 1, imin(H, y1 + S + 1), ring);
      else if (t + gridDim.x < items)
        prefetch_rows(a, s, Band(t + gridDim.x, s, W), 0, imin(H, S + 1), ring);
      cp_commit();
      char* Ob = O + (size_t)buf * S * s.orow;
      depthwise_rows<Q>(P, s, b, H, W, reinterpret_cast<const float4*>(taps), y0, y1,
                        [&](int i, int j, int c0, float4 acc) {
                          T* px = reinterpret_cast<T*>(Ob + (size_t)i * s.orow) +
                                  (size_t)j * Cout;
                          if constexpr (Q) {
                            const float d[4] = {__fadd_rn(acc.x, dwb[c0]),
                                                __fadd_rn(acc.y, dwb[c0 + 1]),
                                                __fadd_rn(acc.z, dwb[c0 + 2]),
                                                __fadd_rn(acc.w, dwb[c0 + 3])};
                            // padded channels are dropped, and never divided: a 0
                            // dividend takes __fdiv_rn's slow path
                            int q[4];
#pragma unroll
                            for (int e = 0; e < 4; ++e)
                              q[e] = c0 + e >= Cout ? 0
                                     : a.relu    ? relu_requant<T>(d[e], ao, so)
                                                 : (int)requant<T>(d[e], ao, so);
                            put4(px, c0, Cout, make_int4(q[0], q[1], q[2], q[3]));
                          } else {
                            float4 o = add4(acc, ld4(dwb + c0));
                            if (a.relu) o = relu4(o);
                            put4(px, c0, Cout, o);
                          }
                        });
      fence_proxy_async();   // the staged rows, before a bulk copy reads them
      pend = buf;
      pend_R = y1 - y0;
      pend_w3 = w3;
      pend_first = ((size_t)b.n * H + y0) * W + b.bx0;
      buf ^= 1;
    }
  }
  cp_wait_all();
  __syncthreads();
  if (pend >= 0) store_rows(O + (size_t)pend * S * s.orow, s, a.out, pend_first, W, pend_R, pend_w3);
  if (threadIdx.x == 0) bulk_wait_all();
}

template <class T, int KC>
int launch_kc(const Args<T>& a, int threads, void* stream) {
  const Shape s(a.W, a.Cin, a.Cout, (int)sizeof(T), a.rows);
  const size_t smem = s.smem_bytes();
  int grid = 0;
  cudaError_t e = resident_grid(bsconv_kernel<T, KC>, threads, smem, (long long)a.N * s.bands,
                                &grid);
  if (e != cudaSuccess) return (int)e;
  bsconv_kernel<T, KC><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <class T>
int launch(const Args<T>& a, int threads, void* stream) {
  if (a.rows < 1 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || a.Cin < 1 ||
      a.Cin > 64 || a.Cout < 1 || a.Cout > 64)
    return (int)cudaErrorInvalidValue;
  return a.Cin <= 4 ? launch_kc<T, 4>(a, threads, stream) : launch_kc<T, 0>(a, threads, stream);
}

template <class T>
int blocks_per_sm(int Cin, size_t smem, int threads) {
  auto kernel = Cin <= 4 ? &bsconv_kernel<T, 4> : &bsconv_kernel<T, 0>;
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

// Dynamic shared memory of one block, in bytes (kernels/bsconv.py::
// bsconv_report states the same); bits 0 for fp32, 1..8 for int8 codes,
// wider for int32 codes.
extern "C" long long bsconv_smem_bytes(int W, int Cin, int Cout, int bits, int rows) {
  const int sz = bits > 0 && bits <= 8 ? 1 : 4;
  return (long long)Shape(W, Cin, Cout, sz, rows).smem_bytes();
}

// Blocks of `threads` that one SM holds at once for that shape (0 when the
// query fails), for the sizing report.
extern "C" int bsconv_blocks_per_sm(int W, int Cin, int Cout, int bits, int rows, int threads) {
  const int sz = bits > 0 && bits <= 8 ? 1 : 4;
  const size_t smem = Shape(W, Cin, Cout, sz, rows).smem_bytes();
  if (bits == 0) return blocks_per_sm<float>(Cin, smem, threads);
  if (bits <= 8) return blocks_per_sm<int8_t>(Cin, smem, threads);
  return blocks_per_sm<int32_t>(Cin, smem, threads);
}

extern "C" int bsconv_forward(const float* x, const float* pw, const float* pwb,
                              const float* dw, const float* dwb, float* out, int N, int H,
                              int W, int Cin, int Cout, int relu, int rows, int threads,
                              void* stream) {
  const Args<float> a{x, pw, nullptr, pwb, dw, dwb, nullptr, out, N, H, W, Cin, Cout, relu, rows};
  return launch(a, threads, stream);
}

extern "C" int qbsconv_forward(const void* x, const void* pwq, const float* pws,
                               const float* pwb, const float* dw, const float* dwb,
                               const float* qc, void* out, int N, int H, int W, int Cin,
                               int Cout, int relu, int bits, int rows, int threads,
                               void* stream) {
  if (bits <= 8)
    return launch(Args<int8_t>{static_cast<const int8_t*>(x), static_cast<const int8_t*>(pwq),
                               pws, pwb, dw, dwb, qc, static_cast<int8_t*>(out), N, H, W, Cin,
                               Cout, relu, rows},
                  threads, stream);
  return launch(Args<int32_t>{static_cast<const int32_t*>(x), static_cast<const int32_t*>(pwq),
                              pws, pwb, dw, dwb, qc, static_cast<int32_t*>(out), N, H, W, Cin,
                              Cout, relu, rows},
                threads, stream);
}
