// Fused quantized SFB on the PAMS lattice (paper Sec. IV-H): qBSConv (ReLU,
// site b1) -> qBSConv (ReLU, site b2) -> the fuse 1x1 over both lattices,
// ReLU, requantize (site out); NHWC codes, int8_t ("int8") or int32_t
// ("fxp10"), C -> C channels. The C entry takes an int `bits`: 8 picks
// int8_t codes, anything wider int32_t.
//
// Replaces the TPU kernel repro/kernels/qconv.py::qsfb_fused (pallas_call at
// qconv.py:241; its math is _qsfb_math, qconv.py:102-119).
//
// Arithmetic contract: bit for bit kernels/ref.py::qsfb_ref. The four 1x1s
// are integer dots, exact in any order, so they run on the tensor cores in
// the order the tiles take. Everything after a dot is qmath.cuh's, in the
// plain version's order: dequant; the depthwise taps as mul_add_rn in (dy, dx)
// raster order from 0, then + bias; fuse_combine; requant (whose __fdiv_rn
// stays a division).
//
// The dots, their exactness bound and relu_requant are qmma.cuh's, shared
// with the quantized megakernel (qmega.cu): int8 on mma.sync m16n8k32 s8,
// fxp10 on m16n8k8 TF32 over codes held as floats.
//
// What bounds it, at N = 1024 C54 32x32 patches (x4) on an H100 SXM (3.35
// TB/s; 1,979 TOPS int8 and 495 TFLOP/s TF32 on the tensor cores, and each
// rounded fp32 operation one instruction at 33.5 T a second): its
// operations, 24.5 G integer operations of dots (0.012 ms int8, 0.050 ms at
// the TF32 rate) and 3.3 G rounded fp32 operations of dequant, depthwise,
// combine and requantize (0.098 ms): 0.110 / 0.147 ms, against its bytes,
// codes in and out once (int8 113 MB, 0.034 ms; fxp10 453 MB, 0.135 ms).
//
// Design: a band walker, sized by kernels/qconv.py::qsfb_report.
// - A work item is one column band of one patch, at most BAND output pixels
//   wide: a patch up to BAND wide is one band with no column halo, a wider
//   one is cut into bands that recompute a 2-px column halo. A persistent
//   grid walks the items; each block stages the weights once.
// - The block walks its band top to bottom, S output rows a step, and keeps
//   what the next step's depthwise layers read again in shared-memory rings
//   of S + 2 rows: the input codes (also the fuse's shortcut operand), pw1
//   and pw2 (fp32). Each stage runs once per pixel, so a band of the whole
//   patch width does 4.0 pixel-dots per output pixel (the 8x8 tiles this
//   replaces did 5.81) and each requantize division once per pixel; the
//   division is skipped where the ReLU gave 0 (relu_requant, bit-equal).
// - SAME padding applies to each dequantized pointwise OUTPUT, bias
//   included: rows and columns off the patch are never computed and the
//   depthwise reads them as 0.
// - The next step's input rows are copied with cp.async while the step
//   computes. int8: an int8 C54 pixel is 54 bytes, only 2-byte aligned, but a
//   32-px patch row is 1,728 = 108 x 16 bytes, contiguous, so whole rows go
//   by 16-byte copies into a staging ring and are repacked into the padded
//   operand layout. fxp10: a pixel is 216 bytes, so its codes go by 8-byte
//   copies straight into the padded layout of an X ring of 2S + 2 rows (the
//   S + 2 in use and the S in flight) and become floats in place.
// - An operand pixel takes an odd multiple of 16 bytes and an fp32 ring pixel
//   8 or 24 floats modulo 32, so ldmatrix rows and the epilogues' float2
//   stores fall on distinct banks.
// - The fuse writes its output codes unpadded into pw1-ring slots that dw1
//   has consumed; each output row then leaves as one contiguous span.
// - One block of 16 warps a SM (512 threads, 128 registers; the rings fill
//   the shared memory: 8 rows a step int8, 3 fxp10 at C54). The depthwise
//   taps are read from shared memory where used: in registers they spilled.
// - Measured (scripts/torch_qsfb_ab.py; NVIDIA H100 80GB HBM3, 700.00 W):
//   at N = 1024 32x32 C54 0.39x the 8x8-tile kernel's time in int8, 0.36x in
//   fxp10. An fp32 FFMA variant of the fxp10 dots (the same tiles, exact by
//   the same bound) ran 1.5x slower than the TF32 mma.sync, so it is not used.
#include <stdint.h>

#include "common.cuh"
#include "qmath.cuh"
#include "qmma.cuh"

using namespace essr;

namespace {

constexpr int MAX_THREADS = 512;
constexpr int BAND = 32;           // widest output band, pixels

// The launch's layout (the same sums as kernels/qconv.py::qsfb_report).
struct Shape {
  int sz;             // bytes of a code in device memory: 1 (int8) or 4 (fxp10)
  int cp8, kp;        // output channels padded to 8; dot depth (int8: to 32, fxp10: to 8)
  int ast;            // bytes of one operand pixel in shared memory, an odd multiple of 16
  int pst;            // floats of one pixel of the fp32 rings
  int bands, bw;      // column bands and their output width
  int rw1, rw2;       // row widths of the x / pw1 rings and of the pw2 ring / Y
  int S, M;           // output rows a step; ring rows
  int xr;             // X ring rows: M, and for fxp10 also the S rows in flight
  int srow;           // bytes of one staged input row (int8)
  __host__ __device__ Shape(int W, int C, int code_bytes, int rows) {
    sz = code_bytes;
    cp8 = up(C, 8);
    kp = up(C, sz == 1 ? 32 : 8);
    ast = operand_stride(kp * sz);
    pst = cp8 % 16 == 0 ? cp8 + 8 : cp8;
    const int b0 = (W + BAND - 1) / BAND;
    bw = (W + b0 - 1) / b0;
    bands = (W + bw - 1) / bw;
    rw1 = imin(W, bw + 4);
    rw2 = imin(W, bw + 2);
    S = rows;
    M = rows + 2;
    xr = sz == 1 ? M : 2 * rows + 2;
    srow = up(rw1 * C * sz, 16);
  }
  // regions, in this order: X ring | staging | pw1 ring | pw2 ring | Y | 3 x WT | D1, D2, vectors
  __host__ __device__ size_t x_bytes() const { return (size_t)xr * rw1 * ast; }
  __host__ __device__ size_t stage_bytes() const { return sz == 1 ? (size_t)M * srow : 0; }
  __host__ __device__ size_t p1_bytes() const { return (size_t)M * rw1 * pst * 4; }
  __host__ __device__ size_t p2_bytes() const { return (size_t)M * rw2 * pst * 4; }
  __host__ __device__ size_t y_bytes() const { return (size_t)(S + 1) * rw2 * ast; }
  __host__ __device__ size_t w_bytes() const { return (size_t)cp8 * ast; }
  __host__ __device__ size_t smem_bytes() const {
    return x_bytes() + stage_bytes() + p1_bytes() + p2_bytes() + y_bytes() + 3 * w_bytes() +
           (size_t)27 * cp8 * 4;
  }
};

// One work item: output columns [bx0, bx1) of patch n; the x / pw1 region
// [c1, c1 + w1) and the dw1 / pw2 region [c2, c2 + w2), both clipped to the patch.
struct Band {
  int n, bx0, bx1, c1, w1, c2, w2;
  __device__ Band(long long t, const Shape& s, int W) {
    n = (int)(t / s.bands);
    bx0 = (int)(t % s.bands) * s.bw;
    bx1 = imin(W, bx0 + s.bw);
    c1 = imax(0, bx0 - 2);
    w1 = imin(W, bx1 + 2) - c1;
    c2 = imax(0, bx0 - 1);
    w2 = imin(W, bx1 + 1) - c2;
  }
};

template <class T>
struct Args {
  const T* x;
  const T* w1;
  const float *s1, *pb1, *dw1, *db1;
  const T* w2;
  const float *s2, *pb2, *dw2, *db2;
  const T* wf;
  const float *fsy, *fsx, *fb, *qc;
  T* out;
  int N, H, W, C, rows;
};

// 3x3 depthwise to rows [r0, r0 + R) x columns [oc, oc + w) of the patch
// from the fp32 map `src` (m rows of `len` pixels, columns from c_src, pst
// floats a pixel; rows at or past H and below 0 read as 0): output (r, c)
// reads src (r + dy - 1, c + dx - 1), 0 off the patch; the nine taps as
// mul_add_rn in (dy, dx) raster order from 0, then epi(i, j, co, acc) with
// i = r - r0, j = c - oc; the epilogue adds the bias. One thread per (channel
// group of 4, pair of adjacent columns, row segment) slides a 3x4 window of
// inputs down its rows in registers; the taps are read from shared memory
// where used (in registers they spill).
template <class Epi>
__device__ __forceinline__ void depthwise(const float* src, int c_src, int len, int m, int pst,
                                          const float* __restrict__ w9, int cp8, int H, int W,
                                          int r0, int R, int oc, int w, Epi epi) {
  if (R <= 0) return;
  const int ng = cp8 >> 2, pairs = (w + 1) >> 1;
  const int segs = imax(1, imin(R, (int)blockDim.x / (ng * pairs)));
  const int seg_rows = (R + segs - 1) / segs;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int item = threadIdx.x; item < ng * pairs * segs; item += blockDim.x) {
    const int g = item % ng, rest = item / ng;
    const int jp = rest % pairs, i0 = (rest / pairs) * seg_rows, i1 = imin(R, i0 + seg_rows);
    if (i0 >= i1) continue;
    const int j = 2 * jp, c = oc + j;          // this thread's columns: c and c + 1
    const bool two = j + 1 < w;
    const bool ok0 = c > 0, ok2 = c + 1 < W, ok3 = two && c + 2 < W;
    const float* col = src + (c - c_src) * pst + 4 * g;
    int r = r0 + i0 - 1, slot = r < 0 ? m - 1 : r % m;
    auto row = [&](float4& v0, float4& v1, float4& v2, float4& v3) {
      if (r < 0 || r >= H) {
        v0 = v1 = v2 = v3 = zero;
      } else {
        const float* p = col + slot * len * pst;
        v0 = ok0 ? ld4(p - pst) : zero;
        v1 = ld4(p);
        v2 = ok2 ? ld4(p + pst) : zero;
        v3 = ok3 ? ld4(p + 2 * pst) : zero;
      }
      ++r;
      slot = slot + 1 == m ? 0 : slot + 1;
    };
    const float* tap = w9 + 4 * g;     // read where used: registers hold the window
    float4 a0, a1, a2, a3, b0, b1, b2, b3;
    row(a0, a1, a2, a3);
    row(b0, b1, b2, b3);
    for (int i = i0; i < i1; ++i) {
      float4 c0, c1, c2, c3;
      row(c0, c1, c2, c3);
      float4 s0 = zero, s1 = zero;
      mac4(s0, a0, ld4(tap + 0 * cp8)); mac4(s1, a1, ld4(tap + 0 * cp8));
      mac4(s0, a1, ld4(tap + 1 * cp8)); mac4(s1, a2, ld4(tap + 1 * cp8));
      mac4(s0, a2, ld4(tap + 2 * cp8)); mac4(s1, a3, ld4(tap + 2 * cp8));
      mac4(s0, b0, ld4(tap + 3 * cp8)); mac4(s1, b1, ld4(tap + 3 * cp8));
      mac4(s0, b1, ld4(tap + 4 * cp8)); mac4(s1, b2, ld4(tap + 4 * cp8));
      mac4(s0, b2, ld4(tap + 5 * cp8)); mac4(s1, b3, ld4(tap + 5 * cp8));
      mac4(s0, c0, ld4(tap + 6 * cp8)); mac4(s1, c1, ld4(tap + 6 * cp8));
      mac4(s0, c1, ld4(tap + 7 * cp8)); mac4(s1, c2, ld4(tap + 7 * cp8));
      mac4(s0, c2, ld4(tap + 8 * cp8)); mac4(s1, c3, ld4(tap + 8 * cp8));
      epi(i, j, 4 * g, s0);
      if (two) epi(i, j + 1, 4 * g, s1);
      a0 = b0; a1 = b1; a2 = b2; a3 = b3;
      b0 = c0; b1 = c1; b2 = c2; b3 = c3;
    }
  }
}

// Code weights w (C x C, row-major [ci][co]) transposed into WT: a row of ast
// bytes per output channel co < cp8, holding ci = 0..kp-1, zero-padded.
template <class T>
__device__ __forceinline__ void stage_weights(const T* __restrict__ w, int C, const Shape& s,
                                              char* WT) {
  using Op = typename Dot<T>::Op;
  const int units = s.kp >> 2;
  for (int i = threadIdx.x; i < s.cp8 * units; i += blockDim.x) {
    const int co = i / units, u = i - co * units;
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * u + e;
      v[e] = (k < C && co < C) ? (int)__ldg(w + (size_t)k * C + co) : 0;
    }
    Dot<T>::put4(WT + (size_t)co * s.ast + 4 * u * sizeof(Op), v);
  }
}

// Input rows [r0, r1) that have landed, into the dot layout (kp channels a
// pixel, zero past C) in X-ring slots (xb + r) % xr. int8 repacks the staged
// rows (w1 pixels of C codes each, unpadded); fxp10 turns the codes that
// prefetch_rows copied into place into floats.
template <class T>
__device__ __forceinline__ void ready_rows(const char* stg, char* X, const Shape& s, int C, int w1,
                                           int r0, int r1, int xb) {
  using Op = typename Dot<T>::Op;
  const int units = s.kp >> 2, per_row = w1 * units;
  for (int i = threadIdx.x; i < (r1 - r0) * per_row; i += blockDim.x) {
    const int q = i / per_row, rest = i - q * per_row;
    const int j = rest / units, u = rest - j * units;
    char* dst = X + ((size_t)((xb + r0 + q) % s.xr) * s.rw1 + j) * s.ast + 4 * u * sizeof(Op);
    int v[4];
    if constexpr (sizeof(T) == 1) {
      const T* src = reinterpret_cast<const T*>(stg + (size_t)((r0 + q) % s.M) * s.srow) + j * C;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = 4 * u + e < C ? (int)src[4 * u + e] : 0;
    } else {
      const int4 c = *reinterpret_cast<const int4*>(dst);
      v[0] = c.x, v[1] = c.y, v[2] = c.z, v[3] = c.w;
    }
    Dot<T>::put4(dst, v);
  }
}

// Input rows [r0, r1) of band b on their way in, as cp.async copies; the
// caller commits. int8: each row one contiguous span of w1 x C codes into
// the staging ring (slot r % M), 16 bytes a copy where the rows allow (byte
// copies where they are not 4-byte aligned). fxp10: each pixel's codes
// straight into the X ring's dot layout (slot (xb + r) % xr), 8 bytes a copy
// (4 where C is odd); its padded channels stay 0.
template <class T>
__device__ __forceinline__ void prefetch_rows(const Args<T>& a, const Shape& s, const Band& b,
                                              int r0, int r1, char* stg, char* X, int xb) {
  if (r1 <= r0) return;
  if constexpr (sizeof(T) == 4) {
    const T* src0 = a.x + (((size_t)b.n * a.H + r0) * a.W + b.c1) * a.C;
    const int unit = (a.C % 2 == 0 && (reinterpret_cast<size_t>(src0) & 7) == 0) ? 2 : 1;
    const int per = a.C / unit, per_row = b.w1 * per;
    for (int i = threadIdx.x; i < (r1 - r0) * per_row; i += blockDim.x) {
      const int q = i / per_row, rest = i - q * per_row;
      const int j = rest / per, k = (rest - j * per) * unit;
      const char* src = reinterpret_cast<const char*>(src0 + ((size_t)q * a.W + j) * a.C + k);
      char* dst = X + ((size_t)((xb + r0 + q) % s.xr) * s.rw1 + j) * s.ast + 4 * k;
      if (unit == 2)
        cp_async8(dst, src);
      else
        cp_async4(dst, src);
    }
    return;
  }
  const size_t stride = (size_t)a.W * a.C * sizeof(T);
  const int len = b.w1 * a.C * (int)sizeof(T);
  const char* src0 =
      reinterpret_cast<const char*>(a.x + (((size_t)b.n * a.H + r0) * a.W + b.c1) * a.C);
  const int unit = copy_unit(src0, stride, len), per = len / unit;
  for (int i = threadIdx.x; i < (r1 - r0) * per; i += blockDim.x) {
    const int q = i / per, k = i - q * per;
    const char* src = src0 + q * stride + (size_t)k * unit;
    char* dst = stg + (size_t)((r0 + q) % s.M) * s.srow + (size_t)k * unit;
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

// Output rows [y0, y1) of band b, staged as w3 x C codes a row in pw1-ring
// slots, to device memory: each row one contiguous span.
template <class T>
__device__ __forceinline__ void store_rows(const Args<T>& a, const Shape& s, const Band& b,
                                           int y0, int y1, const char* P1) {
  const size_t stride = (size_t)a.W * a.C * sizeof(T), slot = (size_t)s.rw1 * s.pst * 4;
  const int len = (b.bx1 - b.bx0) * a.C * (int)sizeof(T);
  char* dst0 = reinterpret_cast<char*>(a.out + (((size_t)b.n * a.H + y0) * a.W + b.bx0) * a.C);
  const int unit = copy_unit(dst0, stride, len), per = len / unit;
  for (int i = threadIdx.x; i < (y1 - y0) * per; i += blockDim.x) {
    const int q = i / per, k = i - q * per;
    const char* src = P1 + ((y0 + q) % s.M) * slot + (size_t)k * unit;
    char* dst = dst0 + q * stride + (size_t)k * unit;
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

template <class T>
__global__ void __launch_bounds__(MAX_THREADS) qsfb_kernel(Args<T> a) {
  using Op = typename Dot<T>::Op;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, W = a.W, C = a.C;
  const Shape s(W, C, (int)sizeof(T), a.rows);
  const int cp8 = s.cp8, M = s.M;
  char* X = reinterpret_cast<char*>(smem);    // M x rw1 operand pixels: input codes
  char* STG = X + s.x_bytes();                // M staged input rows
  float* P1 = reinterpret_cast<float*>(STG + s.stage_bytes());           // pw1 ring, M x rw1
  float* P2 = reinterpret_cast<float*>(reinterpret_cast<char*>(P1) + s.p1_bytes());  // M x rw2
  char* Y = reinterpret_cast<char*>(P2) + s.p2_bytes();  // (S + 1) x rw2: b1, then b2 codes
  char* W1 = Y + s.y_bytes();                 // transposed code weights, cp8 rows each
  char* W2 = W1 + s.w_bytes();
  char* WF = W2 + s.w_bytes();
  float* D1 = reinterpret_cast<float*>(WF + s.w_bytes());   // 9 x cp8 each
  float* D2 = D1 + 9 * cp8;
  float* v = D2 + 9 * cp8;    // [s1 | pb1 | db1 | s2 | pb2 | db2 | fsy | fsx | fb], cp8 each

  stage_weights(a.w1, C, s, W1);
  stage_weights(a.w2, C, s, W2);
  stage_weights(a.wf, C, s, WF);
  stage_matrix(a.dw1, 9, C, 9, cp8, D1);
  stage_matrix(a.dw2, 9, C, 9, cp8, D2);
  const float* vecs[9] = {a.s1, a.pb1, a.db1, a.s2, a.pb2, a.db2, a.fsy, a.fsx, a.fb};
#pragma unroll
  for (int k = 0; k < 9; ++k) stage_matrix(vecs[k], 1, C, 1, cp8, v + k * cp8);
  // the depthwise layers write Y's channels < cp8 and the fxp10 copies X's
  // channels < C: the padding beyond them stays 0
  for (int i = threadIdx.x; i < (int)(s.y_bytes() / 4); i += blockDim.x)
    reinterpret_cast<unsigned*>(Y)[i] = 0u;
  for (int i = threadIdx.x; i < (int)(s.x_bytes() / 4); i += blockDim.x)
    reinterpret_cast<unsigned*>(X)[i] = 0u;
  float qc[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) qc[k] = a.qc[k];
  __syncthreads();

  const size_t p1_slot = (size_t)s.rw1 * s.pst * 4;     // bytes of one pw1-ring row
  const long long items = (long long)a.N * s.bands;
  if (blockIdx.x < items)
    prefetch_rows(a, s, Band(blockIdx.x, s, W), 0, imin(H, s.S + 2), STG, X, 0);
  cp_commit();
  // input row r of the current item sits in X-ring slot (xb + r) % xr; the
  // next item's rows follow on, so the two never share a slot in flight
  int xb = 0;
  for (long long t = blockIdx.x; t < items; t += gridDim.x, xb = (xb + H) % s.xr) {
    const Band b(t, s, W);
    const int w3 = b.bx1 - b.bx0;
    for (int y0 = 0; y0 < H; y0 += s.S) {
      const int y1 = imin(H, y0 + s.S);
      const int p0 = y0 == 0 ? 0 : y0 + 2, p1 = imin(H, y1 + 2);   // new input rows
      const int d0 = y0 == 0 ? 0 : y0 + 1, d1 = imin(H, y1 + 1);   // new dw1 / pw2 rows
      cp_wait_all();
      __syncthreads();
      ready_rows<T>(STG, X, s, C, b.w1, p0, p1, xb);
      __syncthreads();
      // the next step's input rows, or the next item's first rows, land
      // while this step computes
      if (y1 < H)
        prefetch_rows(a, s, b, y1 + 2, imin(H, y1 + 2 + s.S), STG, X, xb);
      else if (t + gridDim.x < items)
        prefetch_rows(a, s, Band(t + gridDim.x, s, W), 0, imin(H, s.S + 2), STG, X,
                      (xb + H) % s.xr);
      cp_commit();
      // pw1 = dequant(x . w1) on the new input rows -> pw1 ring
      if (p1 > p0) {
        const Map in[1] = {{X, xb + p0, b.w1, s.rw1, s.xr, 0, s.ast}};
        const Map out{reinterpret_cast<char*>(P1), p0, b.w1, s.rw1, M, 0, s.pst * 4};
        dot_stage<T, 1>(in, (p1 - p0) * b.w1, W1, s, [&](int p) { return out.at(p); },
                        [&](char* d, int co, const int (&acc)[1][2]) {
                          float* o = reinterpret_cast<float*>(d) + co;
                          o[0] = dequant(acc[0][0], v[co], v[cp8 + co]);
                          o[1] = dequant(acc[0][1], v[co + 1], v[cp8 + co + 1]);
                        });
      }
      __syncthreads();
      // b1 codes = requant(relu(dw1(pw1) + b)) on rows [d0, d1) x the pw2 region -> Y
      depthwise(P1, b.c1, s.rw1, M, s.pst, D1, cp8, H, W, d0, d1 - d0, b.c2, b.w2,
                [&](int i, int j, int co, float4 acc) {
                  const float4 bias = ld4(v + 2 * cp8 + co);
                  const int c4[4] = {
                      relu_requant<T>(__fadd_rn(acc.x, bias.x), qc[0], qc[1]),
                      relu_requant<T>(__fadd_rn(acc.y, bias.y), qc[0], qc[1]),
                      relu_requant<T>(__fadd_rn(acc.z, bias.z), qc[0], qc[1]),
                      relu_requant<T>(__fadd_rn(acc.w, bias.w), qc[0], qc[1])};
                  Dot<T>::put4(Y + ((size_t)i * s.rw2 + j) * s.ast + co * sizeof(Op), c4);
                });
      __syncthreads();
      // pw2 = dequant(b1 . w2) -> pw2 ring rows [d0, d1)
      if (d1 > d0) {
        const Map in[1] = {{Y, 0, b.w2, s.rw2, FLAT, 0, s.ast}};
        const Map out{reinterpret_cast<char*>(P2), d0, b.w2, s.rw2, M, 0, s.pst * 4};
        dot_stage<T, 1>(in, (d1 - d0) * b.w2, W2, s, [&](int p) { return out.at(p); },
                        [&](char* d, int co, const int (&acc)[1][2]) {
                          float* o = reinterpret_cast<float*>(d) + co;
                          o[0] = dequant(acc[0][0], v[3 * cp8 + co], v[4 * cp8 + co]);
                          o[1] = dequant(acc[0][1], v[3 * cp8 + co + 1], v[4 * cp8 + co + 1]);
                        });
      }
      __syncthreads();
      // b2 codes = requant(relu(dw2(pw2) + b)) on the output rows -> Y (b1 consumed)
      depthwise(P2, b.c2, s.rw2, M, s.pst, D2, cp8, H, W, y0, y1 - y0, b.bx0, w3,
                [&](int i, int j, int co, float4 acc) {
                  const float4 bias = ld4(v + 5 * cp8 + co);
                  const int c4[4] = {
                      relu_requant<T>(__fadd_rn(acc.x, bias.x), qc[2], qc[3]),
                      relu_requant<T>(__fadd_rn(acc.y, bias.y), qc[2], qc[3]),
                      relu_requant<T>(__fadd_rn(acc.z, bias.z), qc[2], qc[3]),
                      relu_requant<T>(__fadd_rn(acc.w, bias.w), qc[2], qc[3])};
                  Dot<T>::put4(Y + ((size_t)i * s.rw2 + j) * s.ast + co * sizeof(Op), c4);
                });
      __syncthreads();
      // out = requant(relu(((b2 . wf) * sy + (x . wf) * sx) + b)), staged
      // unpadded (w3 x C codes a row) in the pw1-ring slots of rows [y0, y1),
      // which dw1 has consumed
      {
        const Map in[2] = {{Y, 0, w3, s.rw2, FLAT, 0, s.ast},
                           {X, xb + y0, w3, s.rw1, s.xr, b.bx0 - b.c1, s.ast}};
        char* stage = reinterpret_cast<char*>(P1);
        dot_stage<T, 2>(in, (y1 - y0) * w3, WF, s,
                        [&](int p) {
                          const int i = p / w3, j = p - i * w3;
                          return stage + ((y0 + i) % M) * p1_slot + (size_t)j * C * sizeof(T);
                        },
                        [&](char* d, int co, const int (&acc)[2][2]) {
                          T* o = reinterpret_cast<T*>(d);
#pragma unroll
                          for (int e = 0; e < 2; ++e) {
                            const int c = co + e;
                            if (c < C)
                              o[c] = (T)relu_requant<T>(
                                  fuse_combine(acc[0][e], acc[1][e], v[6 * cp8 + c],
                                               v[7 * cp8 + c], v[8 * cp8 + c]),
                                  qc[4], qc[5]);
                          }
                        });
      }
      __syncthreads();
      store_rows(a, s, b, y0, y1, reinterpret_cast<const char*>(P1));
    }
  }
  cp_wait_all();
}

template <class T>
int qsfb_launch(const Args<T>& a, int threads, void* stream) {
  if (a.rows < 1 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || a.C < 1 ||
      a.C > NTMAX * 8)
    return (int)cudaErrorInvalidValue;
  const Shape s(a.W, a.C, (int)sizeof(T), a.rows);
  const size_t smem = s.smem_bytes();
  int grid = 0;
  cudaError_t e = resident_grid(qsfb_kernel<T>, threads, smem, (long long)a.N * s.bands, &grid);
  if (e != cudaSuccess) return (int)e;
  qsfb_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <class T>
int blocks_per_sm(int W, int C, int rows, int threads) {
  const size_t smem = Shape(W, C, (int)sizeof(T), rows).smem_bytes();
  if (cudaFuncSetAttribute(qsfb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qsfb_kernel<T>, threads, smem) !=
      cudaSuccess)
    return 0;
  return per_sm;
}

}  // namespace

// Dynamic shared memory of one block for a patch `W` wide, `C` channels,
// codes of `bits`, `rows` output rows a step (kernels/qconv.py::qsfb_report
// states the same).
extern "C" long long qsfb_smem_bytes(int W, int C, int bits, int rows) {
  return (long long)Shape(W, C, bits <= 8 ? 1 : 4, rows).smem_bytes();
}

// Blocks of `threads` that one SM holds at once for that shape (0 when the
// query fails), for the sizing report.
extern "C" int qsfb_blocks_per_sm(int W, int C, int bits, int rows, int threads) {
  return bits <= 8 ? blocks_per_sm<int8_t>(W, C, rows, threads)
                   : blocks_per_sm<int32_t>(W, C, rows, threads);
}

extern "C" int qsfb_forward(const void* x, const void* b1pwq, const float* b1s,
                            const float* b1pwb, const float* b1dw, const float* b1dwb,
                            const void* b2pwq, const float* b2s, const float* b2pwb,
                            const float* b2dw, const float* b2dwb, const void* fuseq,
                            const float* fsy, const float* fsx, const float* fuseb,
                            const float* qc, void* out, int N, int H, int W, int C, int bits,
                            int rows, int threads, void* stream) {
  if (bits <= 8)
    return qsfb_launch(
        Args<int8_t>{static_cast<const int8_t*>(x), static_cast<const int8_t*>(b1pwq), b1s,
                     b1pwb, b1dw, b1dwb, static_cast<const int8_t*>(b2pwq), b2s, b2pwb, b2dw,
                     b2dwb, static_cast<const int8_t*>(fuseq), fsy, fsx, fuseb, qc,
                     static_cast<int8_t*>(out), N, H, W, C, rows},
        threads, stream);
  return qsfb_launch(
      Args<int32_t>{static_cast<const int32_t*>(x), static_cast<const int32_t*>(b1pwq), b1s,
                    b1pwb, b1dw, b1dwb, static_cast<const int32_t*>(b2pwq), b2s, b2pwb, b2dw,
                    b2dwb, static_cast<const int32_t*>(fuseq), fsy, fsx, fuseb, qc,
                    static_cast<int32_t*>(out), N, H, W, C, rows},
      threads, stream);
}
