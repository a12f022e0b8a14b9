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
// Design: a band walker, sized by kernels/sfb.py::sfb_report.
// - A work item is one column band of one patch, at most BAND output pixels
//   wide. A patch up to BAND wide is one band with no column halo; a wider
//   one is cut into bands that recompute a 2-px column halo. A persistent
//   grid walks the items; each block stages the weights once.
// - The block walks its band from top to bottom, S output rows a step, and
//   keeps the rows that the next step's depthwise layers read again in
//   shared-memory rings of S + 2 rows (the paper's line buffers): x (the
//   input, also the shortcut), pw1 and pw2. A pointwise pixel is computed
//   once per band, so a band of the whole patch width computes 3.0
//   pointwise pixels per output pixel (the 8x8 tiles this replaces computed
//   4.81). One buffer of S + 1 rows holds dw1's output, then dw2's + x.
// - SAME padding applies to each pointwise OUTPUT (bias included): rows and
//   columns off the patch are never computed or stored, and the depthwise
//   reads them as 0.
// - The input rows of the next step (or of the block's next item) are
//   copied with cp.async while the fuse layer of this step runs: they go to
//   the x-ring slots whose shortcut rows dw2 has just consumed. The copies
//   are 8 bytes (4 when C is odd): at C54 a pixel is 216 B, not a multiple
//   of 16, so neither a TMA tensor map nor a 16-byte cp.async can address
//   it. Only pixels on the patch are copied, so no copy zero-fills; the
//   padded channels of the ring are zeroed once.
// - The fuse layer's output is staged unpadded in the pw1-ring slots that
//   dw1 has consumed, then written out a band row at a time (w x C
//   contiguous floats), so neighbouring lanes store neighbouring words:
//   storing each thread's 8 channels of 4 pixels straight to device memory
//   cost 0.34 ms more at N = 1024 C54.
// - Each pointwise thread owns 4 pixels x 8 output channels (2 loads of 16
//   bytes of weights and 1 of inputs per 32 FFMA, amortised over 4 input
//   channels, the next 4 channels' loads in flight during these FFMA); a
//   warp shares its channel group, so weight loads broadcast. Pixels sit at
//   a stride of C (padded to 8) + 4 floats, so the lanes' 16-byte loads fall
//   on distinct banks. Each depthwise thread owns 4 channels of two adjacent
//   columns and slides a 3x4 window down its rows in registers (mega.cu's
//   column window, widened).
// - The arithmetic is in the same order as the 8x8-tile kernel it replaces,
//   so its output is bit-identical: each pointwise output is one fmaf chain
//   over input channels ascending from 0, then + bias; each depthwise sums
//   its 9 taps in (dy, dx) raster order from 0, then + bias.
// - Measured (scripts/torch_sfb_ab.py; NVIDIA H100 80GB HBM3, 700.00 W): at
//   N = 1024 32x32 it takes 0.49x the 8x8-tile kernel's time at C54, 0.71x
//   at C27. A 3xTF32 mma.sync.m16n8k8 pointwise (operands split with
//   cvt.rna, fp32 accumulators) held rtol 1e-4 / atol 1e-5 but ran 1.56x
//   slower than this FFMA version, so it is not used.
#include "common.cuh"

using namespace essr;

namespace {

constexpr int MAX_THREADS = 256;
constexpr int BAND = 32;         // widest output band, pixels

__host__ __device__ inline int round8(int c) { return (c + 7) & ~7; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The launch's layout (the same sums as kernels/sfb.py::sfb_report).
struct Shape {
  int cp4, cp8, stride;   // channels padded to 4 (dot depth) and 8 (outputs); pixel stride
  int bands, bw;          // column bands and their output width
  int rw1, rw2;           // row widths of the x / pw1 rings and of the pw2 ring / D
  int S, M;               // output rows per step; ring rows
  __host__ __device__ Shape(int W, int C, int rows) {
    cp4 = round4(C);
    cp8 = round8(C);
    stride = cp8 + 4;
    const int b0 = (W + BAND - 1) / BAND;
    bw = (W + b0 - 1) / b0;
    bands = (W + bw - 1) / bw;
    rw1 = imin(W, bw + 4);
    rw2 = imin(W, bw + 2);
    S = rows;
    M = rows + 2;
  }
  __host__ __device__ size_t smem_floats() const {
    return (size_t)stride * (2 * M * rw1 + M * rw2 + (S + 1) * rw2) + 3 * cp8 * cp8 + 23 * cp8;
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

struct Args {
  const float *x, *b1pw, *b1pwb, *b1dw, *b1dwb, *b2pw, *b2pwb, *b2dw, *b2dwb, *fuse, *fuseb;
  float* out;
  int N, H, W, C, rows;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float lane(float4 v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}
__device__ __forceinline__ void fma4(float4& acc, float v, float4 w) {
  acc.x = fmaf(v, w.x, acc.x);
  acc.y = fmaf(v, w.y, acc.y);
  acc.z = fmaf(v, w.z, acc.z);
  acc.w = fmaf(v, w.w, acc.w);
}
__device__ __forceinline__ void fma4(float4& acc, float4 v, float4 w) {
  acc.x = fmaf(v.x, w.x, acc.x);
  acc.y = fmaf(v.y, w.y, acc.y);
  acc.z = fmaf(v.z, w.z, acc.z);
  acc.w = fmaf(v.w, w.w, acc.w);
}

// Pixel p of a stage of rows [r0, ...) and width w, in a buffer whose rows
// are `len` pixels: ring slot (r0 + p / w) % m (m = 1 << 30 for a plain
// buffer whose row 0 is r0), column p % w.
struct Rows {
  float* buf;
  int r0, w, len, m, stride;
  __device__ __forceinline__ float* at(int p) const {
    const int i = p / w, j = p - i * w;
    return buf + (((r0 + i) % m) * len + j) * stride;
  }
};

// Pointwise (1x1) over the P pixels of `in`, C -> C:
//   acc(p, co..co+7) = sum_{ci < cpin} in(p)[ci] * w[ci * cpout + co], ci ascending
// then epi(p, co, acc[0..3], acc[4..7]); the epilogue adds the bias. A thread
// owns 8 output channels of 4 pixels (pg, pg + P/4, ...); consecutive threads
// take consecutive pixels of one channel group. The loads of the next 4 input
// channels are issued before the FFMA of the current 4.
template <class Epi>
__device__ __forceinline__ void pointwise8(const Rows& in, const float* __restrict__ w,
                                           int cpin, int cpout, int P, Epi epi) {
  const int ng = cpout >> 3, npg = (P + 3) >> 2;
  for (int item = threadIdx.x; item < ng * npg; item += blockDim.x) {
    const int g = item / npg, pg = item - g * npg;
    const float* src[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) src[k] = in.at(pg + k * npg < P ? pg + k * npg : pg);
    float4 acc[4][2];
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k][0] = acc[k][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* wg = w + 8 * g;
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
          fma4(acc[k][0], lane(v[k], u), wq[u][0]);
          fma4(acc[k][1], lane(v[k], u), wq[u][1]);
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

// 3x3 depthwise to rows [r0, r0 + R) x columns [oc, oc + w) of the patch
// from the ring `src` (m rows of `len` pixels, columns from c_src): output
// (r, c) reads src (r + dy - 1, c + dx - 1), 0 off the patch. acc in (dy, dx)
// raster order from 0, then epi(i, j, co, acc) with i = r - r0, j = c - oc;
// the epilogue adds the bias. One thread per (channel group of 4, pair of
// adjacent columns, row segment) keeps the nine taps and a 3x4 window of
// inputs in registers and slides it down its rows: each input is loaded once
// per thread, and the two columns' sums are independent chains.
template <class Epi>
__device__ __forceinline__ void depthwise_window(const float* src, int c_src, int len, int m,
                                                 int stride, const float* __restrict__ w9,
                                                 int cp8, int H, int W, int r0, int R, int oc,
                                                 int w, Epi epi) {
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
    const float* col = src + (c - c_src) * stride + 4 * g;
    int r = r0 + i0 - 1, slot = r < 0 ? m - 1 : r % m;
    auto row = [&](float4& v0, float4& v1, float4& v2, float4& v3) {
      if (r < 0 || r >= H) {
        v0 = v1 = v2 = v3 = zero;
      } else {
        const float* p = col + slot * len * stride;
        v0 = ok0 ? ld4(p - stride) : zero;
        v1 = ld4(p);
        v2 = ok2 ? ld4(p + stride) : zero;
        v3 = ok3 ? ld4(p + 2 * stride) : zero;
      }
      ++r;
      slot = slot + 1 == m ? 0 : slot + 1;
    };
    float4 t[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = ld4(w9 + k * cp8 + 4 * g);
    float4 a0, a1, a2, a3, b0, b1, b2, b3;
    row(a0, a1, a2, a3);
    row(b0, b1, b2, b3);
    for (int i = i0; i < i1; ++i) {
      float4 c0, c1, c2, c3;
      row(c0, c1, c2, c3);
      float4 s0 = zero, s1 = zero;
      fma4(s0, a0, t[0]); fma4(s1, a1, t[0]);
      fma4(s0, a1, t[1]); fma4(s1, a2, t[1]);
      fma4(s0, a2, t[2]); fma4(s1, a3, t[2]);
      fma4(s0, b0, t[3]); fma4(s1, b1, t[3]);
      fma4(s0, b1, t[4]); fma4(s1, b2, t[4]);
      fma4(s0, b2, t[5]); fma4(s1, b3, t[5]);
      fma4(s0, c0, t[6]); fma4(s1, c1, t[6]);
      fma4(s0, c1, t[7]); fma4(s1, c2, t[7]);
      fma4(s0, c2, t[8]); fma4(s1, c3, t[8]);
      epi(i, j, 4 * g, s0);
      if (two) epi(i, j + 1, 4 * g, s1);
      a0 = b0; a1 = b1; a2 = b2; a3 = b3;
      b0 = c0; b1 = c1; b2 = c2; b3 = c3;
    }
  }
}

// Input rows [r0, r1) of band b into the x ring (slot r % M), channels < C,
// as cp.async copies; the caller commits.
__device__ __forceinline__ void prefetch_rows(const Args& a, const Shape& s, const Band& b,
                                              int r0, int r1, bool pairs, float* X) {
  if (r1 <= r0) return;
  const int C = a.C, per = pairs ? C / 2 : C, unit = pairs ? 2 : 1;
  const int step_q = blockDim.x / per, step_k = blockDim.x - step_q * per;
  const int q0 = threadIdx.x / per, k0 = threadIdx.x - q0 * per;
  const float* src = a.x + (((size_t)b.n * a.H + r0) * a.W + b.c1) * C;
  int slot = r0 % s.M;
  for (int r = r0; r < r1; ++r, src += (size_t)a.W * C) {
    float* dst = X + slot * s.rw1 * s.stride;
    for (int j = q0, k = k0; j < b.w1;) {
      if (pairs)
        cp_async8(dst + j * s.stride + 2 * k, src + j * C + 2 * k);
      else
        cp_async4(dst + j * s.stride + k, src + j * C + k);
      k += step_k;
      j += step_q;
      if (k >= per) {
        k -= per;
        ++j;
      }
    }
    slot = slot + 1 == s.M ? 0 : slot + 1;
  }
}

__global__ void __launch_bounds__(MAX_THREADS) sfb_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int H = a.H, W = a.W, C = a.C;
  const Shape s(W, C, a.rows);
  const int cp4 = s.cp4, cp8 = s.cp8, st = s.stride, M = s.M, S = s.S;
  float* X = sm;                              // x ring, M x rw1 pixels
  float* A = X + M * s.rw1 * st;              // pw1 ring, M x rw1
  float* B = A + M * s.rw1 * st;              // pw2 ring, M x rw2
  float* D = B + M * s.rw2 * st;              // (S + 1) x rw2: dw1, then dw2 + x
  float* W1 = D + (S + 1) * s.rw2 * st;       // cp8 x cp8 each
  float* W2 = W1 + cp8 * cp8;
  float* WF = W2 + cp8 * cp8;
  float* D1 = WF + cp8 * cp8;                 // 9 x cp8 each
  float* D2 = D1 + 9 * cp8;
  float* bias = D2 + 9 * cp8;                 // [b1pw | b1dw | b2pw | b2dw | fuse], cp8 each

  stage_matrix(a.b1pw, C, C, cp8, cp8, W1);
  stage_matrix(a.b2pw, C, C, cp8, cp8, W2);
  stage_matrix(a.fuse, C, C, cp8, cp8, WF);
  stage_matrix(a.b1dw, 9, C, 9, cp8, D1);
  stage_matrix(a.b2dw, 9, C, 9, cp8, D2);
  stage_matrix(a.b1pwb, 1, C, 1, cp8, bias);
  stage_matrix(a.b1dwb, 1, C, 1, cp8, bias + cp8);
  stage_matrix(a.b2pwb, 1, C, 1, cp8, bias + 2 * cp8);
  stage_matrix(a.b2dwb, 1, C, 1, cp8, bias + 3 * cp8);
  stage_matrix(a.fuseb, 1, C, 1, cp8, bias + 4 * cp8);
  // the copies write channels < C only, so the padding stays 0
  for (int i = threadIdx.x; i < M * s.rw1 * st; i += blockDim.x) X[i] = 0.f;
  __syncthreads();

  const bool pairs = (C % 2 == 0) && ((reinterpret_cast<size_t>(a.x) & 7) == 0);
  const bool out_pairs = (C % 2 == 0) && ((reinterpret_cast<size_t>(a.out) & 7) == 0);
  const long long items = (long long)a.N * s.bands;
  constexpr int FLAT = 1 << 30;               // Rows.m of a buffer that is not a ring
  if (blockIdx.x < items) prefetch_rows(a, s, Band(blockIdx.x, s, W), 0, imin(H, S + 2), pairs, X);
  cp_commit();
  for (long long t = blockIdx.x; t < items; t += gridDim.x) {
    const Band b(t, s, W);
    const int w3 = b.bx1 - b.bx0;
    float* img = a.out + (size_t)b.n * H * W * C;
    for (int y0 = 0; y0 < H; y0 += S) {
      const int y1 = imin(H, y0 + S);
      cp_wait_all();
      __syncthreads();
      // pw1 on the new input rows [p0, p1) -> pw1 ring
      const int p0 = y0 == 0 ? 0 : y0 + 2, p1 = imin(H, y1 + 2);
      if (p1 > p0) {
        const Rows out{A, p0, b.w1, s.rw1, M, st};
        pointwise8(Rows{X, p0, b.w1, s.rw1, M, st}, W1, cp4, cp8, (p1 - p0) * b.w1,
                   [&](int p, int co, float4 lo, float4 hi) {
                     float* d = out.at(p) + co;
                     st4(d, add4(lo, ld4(bias + co)));
                     st4(d + 4, add4(hi, ld4(bias + co + 4)));
                   });
      }
      __syncthreads();
      // dw1 on rows [d0, d1) -> D
      const int d0 = y0 == 0 ? 0 : y0 + 1, d1 = imin(H, y1 + 1);
      depthwise_window(A, b.c1, s.rw1, M, st, D1, cp8, H, W, d0, d1 - d0, b.c2, b.w2,
                       [&](int i, int j, int co, float4 v) {
                         st4(D + (i * s.rw2 + j) * st + co, relu4(add4(v, ld4(bias + cp8 + co))));
                       });
      __syncthreads();
      // pw2 on D -> pw2 ring rows [d0, d1)
      {
        const Rows out{B, d0, b.w2, s.rw2, M, st};
        pointwise8(Rows{D, 0, b.w2, s.rw2, FLAT, st}, W2, cp4, cp8, (d1 - d0) * b.w2,
                   [&](int p, int co, float4 lo, float4 hi) {
                     float* d = out.at(p) + co;
                     st4(d, add4(lo, ld4(bias + 2 * cp8 + co)));
                     st4(d + 4, add4(hi, ld4(bias + 2 * cp8 + co + 4)));
                   });
      }
      __syncthreads();
      // dw2 on the output rows [y0, y1), + the shortcut x -> D
      depthwise_window(B, b.c2, s.rw2, M, st, D2, cp8, H, W, y0, y1 - y0, b.bx0, w3,
                       [&](int i, int j, int co, float4 v) {
                         const float4 xv =
                             ld4(X + (((y0 + i) % M) * s.rw1 + b.bx0 - b.c1 + j) * st + co);
                         st4(D + (i * s.rw2 + j) * st + co,
                             add4(relu4(add4(v, ld4(bias + 3 * cp8 + co))), xv));
                       });
      __syncthreads();
      // the next step's input rows, or the next item's first rows, into the
      // slots of the shortcut rows just consumed; they land during the fuse
      if (y1 < H)
        prefetch_rows(a, s, b, y1 + 2, imin(H, y1 + 2 + S), pairs, X);
      else if (t + gridDim.x < items)
        prefetch_rows(a, s, Band(t + gridDim.x, s, W), 0, imin(H, S + 2), pairs, X);
      cp_commit();
      // relu(fuse(D) + b), staged unpadded (w3 x C floats a row) in the pw1
      // ring slots of rows [y0, y1), which dw1 has consumed
      const Rows out{A, y0, w3, s.rw1, M, st};
      pointwise8(Rows{D, 0, w3, s.rw2, FLAT, st}, WF, cp4, cp8, (y1 - y0) * w3,
                 [&](int p, int co, float4 lo, float4 hi) {
                   const int i = p / w3, j = p - i * w3;
                   float* px = out.at(i * w3) + j * C;
                   store4(px, co, C, relu4(add4(lo, ld4(bias + 4 * cp8 + co))));
                   store4(px, co + 4, C, relu4(add4(hi, ld4(bias + 4 * cp8 + co + 4))));
                 });
      __syncthreads();
      // each output row of the band is w3 x C contiguous floats: coalesced stores
      for (int i = 0; i < y1 - y0; ++i) {
        const float* row = out.at(i * w3);
        float* dst = img + ((size_t)(y0 + i) * W + b.bx0) * C;
        if (out_pairs) {
          for (int k = threadIdx.x; k < w3 * C / 2; k += blockDim.x)
            reinterpret_cast<float2*>(dst)[k] = reinterpret_cast<const float2*>(row)[k];
        } else {
          for (int k = threadIdx.x; k < w3 * C; k += blockDim.x) dst[k] = row[k];
        }
      }
    }
  }
  cp_wait_all();
}

}  // namespace

// Dynamic shared memory of one block for a patch `W` wide, `C` channels,
// `rows` output rows a step (kernels/sfb.py::sfb_report states the same).
extern "C" long long sfb_smem_bytes(int W, int C, int rows) {
  return (long long)(Shape(W, C, rows).smem_floats() * sizeof(float));
}

// Blocks of `threads` that one SM holds at once for that shape (0 when the
// query fails), for the sizing report.
extern "C" int sfb_blocks_per_sm(int W, int C, int rows, int threads) {
  const size_t smem = Shape(W, C, rows).smem_floats() * sizeof(float);
  if (cudaFuncSetAttribute(sfb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sfb_kernel, threads, smem) !=
      cudaSuccess)
    return 0;
  return per_sm;
}

extern "C" int sfb_forward(const float* x, const float* b1pw, const float* b1pwb,
                           const float* b1dw, const float* b1dwb, const float* b2pw,
                           const float* b2pwb, const float* b2dw, const float* b2dwb,
                           const float* fuse, const float* fuseb, float* out, int N, int H,
                           int W, int C, int rows, int threads, void* stream) {
  const Args a{x, b1pw, b1pwb, b1dw, b1dwb, b2pw, b2pwb, b2dw, b2dwb, fuse, fuseb, out,
               N, H, W, C, rows};
  const Shape s(W, C, rows);
  if (rows < 1 || threads < 32 || threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = s.smem_floats() * sizeof(float);
  int grid = 0;
  cudaError_t e = resident_grid(sfb_kernel, threads, smem, (long long)N * s.bands, &grid);
  if (e != cudaSuccess) return (int)e;
  sfb_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
