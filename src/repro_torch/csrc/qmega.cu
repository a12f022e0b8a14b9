// Quantized subnet-group megakernel (PAMS lattice x group fusion): for a
// batch of fp32 NHWC patches, quantize once at the input site, run qBSConv ->
// n_sfb x qSFB -> qDSConv with each patch's codes in shared memory from entry
// to exit, and write the recon site's codes. The one dequant
// (codes * s_recon) and the pixel shuffle run outside, as in the TPU kernel.
// Templated on the code type: int8_t for "int8", int32_t for "fxp10".
//
// Replaces the TPU kernel repro/kernels/megakernel.py::essr_forward_qmegakernel
// (pallas_call at megakernel.py:393, body _qmega_kernel at :320), with the
// same site constants in the same order (its `consts`, :388-392).
//
// Arithmetic contract: bit for bit the chain of the per-layer integer kernels
// (qconv.cu, qsfb.cu) and their plain versions (kernels/ref.py::qmega_ref).
// Every rounded fp step comes from qmath.cuh, in the plain version's order:
// dequant; the depthwise taps as mul_add_rn in (dy, dx) raster order from 0,
// then + bias; fuse_combine; the recon's fp 1x1 as an ordered sum over
// channels 0..C-1 from 0; requant's division. Only the integer dots change
// their order, because they are exact.
//
// The 1x1 dots (the first layer's, and the four of each qSFB, the fuse's two
// included) run on the tensor cores through qmma.cuh, the pieces qsfb.cu uses:
// int8 on mma.sync m16n8k32 s8, fxp10 on m16n8k8 TF32 over codes held as
// floats (exact while |code| <= 511 and K <= 64: every sum below 2^24). The
// first layer's depth (Cin = 3) pads with zero codes to one k-step. The
// recon's int32 3x3 and its fp 1x1 stay on the CUDA cores.
//
// What bounds it: at C54 x4 the chain does per LR pixel 58,968 integer MACs
// (3*54 for the first 1x1, 5 x 4 x 54^2 for the qSFBs' 1x1s, the fuse's two
// dots included, 9*54 for the int32 depthwise) and ~22,400 fp32 operations
// (quantize, dequant, depthwise, combine, requantize, the recon 1x1 54 ->
// 48), against 12 bytes in and 48 codes out. So it is bound by operations:
// for 1024 32x32 patches 123.7 G integer operations and 23.5 GFLOP fp32;
// on an H100 SXM at the data sheet's rates (int8 on the tensor cores at
// 1,979 TOPS, fxp10 on the TF32 tensor cores at 495 TFLOP/s, fp32 at 67
// TFLOP/s) 0.41 ms for int8 and 0.60 ms for fxp10, against 0.02 / 0.06 ms
// of device-memory traffic.
//
// Design: csrc/mega.cu's cluster layout. Each patch belongs to one
// thread-block cluster (launched persistent: a cluster walks patches), and
// each block of the cluster owns a strip of `rows` consecutive rows. The
// cluster takes 4 blocks where a block's strip fits in shared memory, else 8
// (kernels/megakernel.py::qgroup_report; C54 32x32: 4 x 8 rows int8, 8 x 4
// rows fxp10): taller strips pay fewer barriers a row and the card holds 30
// clusters of 4 against 15 of 8. A block holds, for its strip:
//   A0, A1  fp32 maps, a pointwise output (dequantized, + bias) with one halo
//           row above and one below; the fuse stages its output codes in the
//           one dw2 has read; in qDSConv A[k] holds the feature CODES with
//           their halo rows and the interior rows of A[k^1] the dequantized
//           depthwise output
//   F       the running feature codes in the dot operand layout (kp codes a
//           pixel, an odd multiple of 16 bytes), also the qSFB shortcut
//   Y       the codes of b1, then of b2; on entry the quantized input
//   WFIRST, WRECON  the first layer's and the recon's packed weights, staged
//           once per block
//   WSFB    one qSFB's packed weights: b1 | b2 | fuse
// Two kinds of halo: the fp 3x3 of each qBSConv group reads its neighbours'
// fp32 pointwise outputs (0 on pixels off the patch and on rows past H,
// bias included: the SAME padding of the dequantized map); the int32 3x3 of
// qDSConv reads its neighbours' codes (0 off the patch). Before each of the
// 2*n_sfb + 2 depthwise layers a block pushes its first and last interior
// rows into its neighbours' halo rows over distributed shared memory (stores
// need not wait, as loads would) and the cluster meets at one barrier. The
// layers alternate between A0 and A1, and a neighbour writes only the halo
// rows of the map of the layer at hand, so between two barriers a block may
// reuse the other map, and the interior of this one, as it likes. Blocks
// whose strip lies wholly past H compute nothing but keep the barriers. The
// fp depthwise walks four columns a thread (depthwise_quad); the division of
// requantize is skipped where the ReLU gave 0 (relu_requant, bit-equal).
//
// Weight staging overlaps the compute: WSFB's three parts roll. Once b1's
// depthwise has read the last of b1, the next qSFB's b1 (the next patch's
// first qSFB after the last) is on its way into the same bytes by cp.async,
// and so on for b2 and the fuse; each part is waited for just before its
// 1x1. Three copy groups are in flight at any time.
//
// Measured (scripts/torch_qmega_ab.py, chip_smoke.py; NVIDIA H100 80GB
// HBM3, 700.00 W): at N = 1024 C54 32x32 0.55x the CUDA-core kernel it
// replaces in int8 and 0.36x in fxp10, at or below the per-layer kernel
// chain of the same run in both. The requantize divisions, the depthwise and
// the halo barriers take most of what is left (PERF.md).
//
// Weights arrive packed once per (tree, width, pack, device) in the TPU
// kernel's operand order (_flat_q_operands; kernels/megakernel.py::
// pack_qweights): each 1x1's code weights as the dots' B operand (a row of
// `ast` bytes per output channel, fxp10 codes as fp32), output channels
// zero-padded to multiples of 8; fp vectors and matrices zero-padded
// likewise; every operand a multiple of 16 bytes. The site constants (clip,
// step pairs of `_act_points`) come as one small fp32 array.
#include <stdint.h>

#include "cluster.cuh"
#include "common.cuh"
#include "qmath.cuh"
#include "qmma.cuh"

using namespace essr;

namespace {

constexpr int MAX_THREADS = 512;

struct Args {
  const float* x;
  const unsigned char* w;
  const float* qc;
  void* out;
  int N, H, W, Cin, C, Cout, n_sfb, rows;
};

// The shape of one 1x1 for dot_stage: code bytes, output channels padded to
// 8, dot depth in codes, bytes of a weight row.
struct DotShape {
  int sz, cp8, kp, ast;
};

// The launch's layout (the same sums as kernels/megakernel.py::QWeightLayout
// and _qsizing). Byte sizes of the packed groups: first = pw (cp8 rows of
// ast1) | scale | pwb | dw (9) | dwb; one qBSConv of a qSFB (bs) the same
// with rows of ast; fuse = fq (cp8 rows of ast) | fsy | fsx | fb; recon =
// dwq (9, int32) | dws | dwb | pw_fq (cp8 x cpo) | pwb (cpo).
struct QShape {
  int sz;              // bytes of a code in device memory: 1 (int8) or 4 (fxp10)
  int cp8, cpo;        // channels padded to 8; output channels padded to 4
  int kp, ast;         // dot depth of a C-channel operand, bytes of its weight rows
  int kp1, ast1;       // the same for the first 1x1's Cin-channel input
  int ost;             // bytes of one operand pixel in F and Y
  int pst;             // floats of one pixel of the fp32 maps
  int first, bs, fuse, sfb, recon;
  int rows, W, P;      // rows of a strip, patch width, pixels of a strip
  __host__ __device__ QShape(int Cin, int C, int Cout, int code_bytes, int rows_, int W_) {
    sz = code_bytes;
    cp8 = up(C, 8);
    cpo = round4(Cout);
    kp = up(C, sz == 1 ? 32 : 8);
    ast = operand_stride(kp * sz);
    kp1 = up(Cin, sz == 1 ? 32 : 8);
    ast1 = operand_stride(kp1 * sz);
    ost = imax(ast, ast1);
    pst = cp8 % 16 == 0 ? cp8 + 8 : cp8;
    first = cp8 * ast1 + 48 * cp8;
    bs = cp8 * ast + 48 * cp8;
    fuse = cp8 * ast + 12 * cp8;
    sfb = 2 * bs + fuse;
    recon = 44 * cp8 + 4 * cp8 * cpo + 4 * cpo;
    rows = rows_;
    W = W_;
    P = rows * W;
  }
  // an A map: the strip with its halo rows (fp32), or the fuse's output codes
  __host__ __device__ size_t a_bytes() const {
    const size_t m = (size_t)(rows + 2) * W * pst * 4, z = (size_t)P * ost;
    return m > z ? m : z;
  }
  __host__ __device__ size_t op_bytes() const { return (size_t)P * ost; }
  // regions, in this order: A0 | A1 | F | Y | WFIRST | WRECON | WSFB
  __host__ __device__ size_t smem_bytes(int n_sfb) const {
    return 2 * a_bytes() + 2 * op_bytes() + first + recon + (n_sfb > 0 ? sfb : 0);
  }
};

// One qBSConv group's operands in shared memory: code weights as B rows,
// scale, bias, depthwise (9 x cp8), depthwise bias.
struct QBS {
  const char* pw;
  const float *scale, *pwb, *dw, *dwb;
  __device__ QBS(const char* p, int rows_bytes, int cp8)
      : pw(p), scale(reinterpret_cast<const float*>(p + rows_bytes)), pwb(scale + cp8),
        dw(pwb + cp8), dwb(dw + 9 * cp8) {}
};

// dst[0, bytes) = src[0, bytes) by 16-byte cp.async; the caller commits.
__device__ __forceinline__ void fetch(const unsigned char* src, int bytes, char* dst) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    cp_async16(dst + 16 * i, reinterpret_cast<const char*>(src) + 16 * i);
}

// Integer 1x1 over the strip's first `valid` pixels of operand buffer X into
// the interior rows of the fp32 map A: dequant(X[p] . w) + bias; the interior
// pixels from `valid` to P (rows past H) get 0, the SAME padding of the
// dequantized map.
template <class T>
__device__ __forceinline__ void pointwise_mma(const char* X, const QShape& s, const DotShape& d,
                                              const QBS& w, int valid, char* A) {
  char* interior = A + (size_t)s.W * s.pst * 4;
  const Map in[1] = {{const_cast<char*>(X), 0, s.W, s.W, FLAT, 0, s.ost}};
  const int pbytes = s.pst * 4;
  dot_stage<T, 1, 4>(in, valid, w.pw, d, [&](int p) { return interior + (size_t)p * pbytes; },
                  [&](char* dst, int co, const int (&acc)[1][2]) {
                    *reinterpret_cast<float2*>(dst + 4 * co) =
                        make_float2(dequant(acc[0][0], w.scale[co], w.pwb[co]),
                                    dequant(acc[0][1], w.scale[co + 1], w.pwb[co + 1]));
                  });
  float4* tail = reinterpret_cast<float4*>(interior + (size_t)valid * pbytes);
  for (int i = threadIdx.x; i < (s.P - valid) * pbytes / 16; i += blockDim.x)
    tail[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// fp 3x3 depthwise from the map A (rows + 2 rows of W pixels, pst floats a
// pixel, the halo rows included) to the strip's first R rows: output (i, j)
// reads A (i + dy, j + dx - 1), columns off the patch read 0; the nine taps
// as mul_add_rn in (dy, dx) raster order from 0, then epi(i, j, co, acc); the
// epilogue adds the bias. One thread per (channel group of 4, four adjacent
// columns, row) reads each of its three input rows once (six pixels) and
// keeps the four outputs' sums: 6.75 shared-memory loads an output, against
// 8.5 for qsfb.cu's column-pair window at two rows a thread.
template <class Epi>
__device__ __forceinline__ void depthwise_quad(const float* A, int pst,
                                               const float* __restrict__ w9, int cp8, int W,
                                               int R, Epi epi) {
  const int ng = cp8 >> 2, quads = (W + 3) >> 2;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int item = threadIdx.x; item < ng * quads * R; item += blockDim.x) {
    const int g = item % ng, rest = item / ng;
    const int jq = rest % quads, i = rest / quads;
    const int j0 = 4 * jq;
    const float* tap = w9 + 4 * g;
    float4 sum[4] = {zero, zero, zero, zero};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* row = A + (size_t)(i + dy) * W * pst + 4 * g;
      float4 v[6];
#pragma unroll
      for (int e = 0; e < 6; ++e) {
        const int c = j0 - 1 + e;
        v[e] = c >= 0 && c < W ? ld4(row + c * pst) : zero;
      }
      const float4 w0 = ld4(tap + 3 * dy * cp8), w1 = ld4(tap + (3 * dy + 1) * cp8),
                   w2 = ld4(tap + (3 * dy + 2) * cp8);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        mac4(sum[q], v[q], w0);
        mac4(sum[q], v[q + 1], w1);
        mac4(sum[q], v[q + 2], w2);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (j0 + q < W) epi(i, j0 + q, 4 * g, sum[q]);
  }
}

// fp 3x3 depthwise of the map A on the strip's first `vrows` rows, + bias,
// ReLU where asked, requantized to codes in the operand buffer out.
template <class T, bool RELU>
__device__ __forceinline__ void depthwise_q(const char* A, const QShape& s, const QBS& w,
                                            int vrows, float ao, float so, char* out) {
  using Op = typename Dot<T>::Op;
  depthwise_quad(reinterpret_cast<const float*>(A), s.pst, w.dw, s.cp8, s.W, vrows,
                 [&](int i, int j, int co, float4 acc) {
                     const float4 b = ld4(w.dwb + co);
                     const float v[4] = {__fadd_rn(acc.x, b.x), __fadd_rn(acc.y, b.y),
                                         __fadd_rn(acc.z, b.z), __fadd_rn(acc.w, b.w)};
                     int c4[4];
#pragma unroll
                     for (int e = 0; e < 4; ++e)
                       c4[e] = RELU ? relu_requant<T>(v[e], ao, so) : (int)requant<T>(v[e], ao, so);
                     Dot<T>::put4(out + ((size_t)i * s.W + j) * s.ost + co * sizeof(Op), c4);
                   });
}

template <class T>
__global__ void __launch_bounds__(MAX_THREADS, 1) qmega_kernel(Args a) {
  using Op = typename Dot<T>::Op;
  extern __shared__ __align__(16) unsigned char sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), cs = (int)cl.num_blocks();
  const int H = a.H, W = a.W, rows = a.rows;
  const QShape s(a.Cin, a.C, a.Cout, (int)sizeof(T), rows, W);
  const int cp8 = s.cp8, cpo = s.cpo, P = s.P;
  const DotShape d1{s.sz, cp8, s.kp1, s.ast1}, dc{s.sz, cp8, s.kp, s.ast};
  const int r0 = rank * rows;
  const int vrows = imax(0, imin(H - r0, rows));
  const int valid = vrows * W;                         // strip pixels inside
  const bool active = valid > 0;
  const int frow = W * s.pst * (int)sizeof(float);     // bytes of one fp32 map row
  const int crow = W * cp8 * (int)sizeof(T);           // bytes of one code row
  const float* qc = a.qc;

  char* A[2] = {reinterpret_cast<char*>(sm), reinterpret_cast<char*>(sm) + s.a_bytes()};
  char* F = A[1] + s.a_bytes();
  char* Y = F + s.op_bytes();
  char* WFIRST = Y + s.op_bytes();
  char* WRECON = WFIRST + s.first;
  char* WSFB = WRECON + s.recon;
  const QBS wfirst(WFIRST, cp8 * s.ast1, cp8);
  const QBS b1(WSFB, cp8 * s.ast, cp8), b2(WSFB + s.bs, cp8 * s.ast, cp8);
  const char* wf = WSFB + 2 * s.bs;
  const float* fsy = reinterpret_cast<const float*>(wf + cp8 * s.ast);
  const float* fsx = fsy + cp8;
  const float* fb = fsx + cp8;

  // the first layer's and the recon's weights once; the first qSFB's three
  // parts as three copy groups (empty without qSFBs), so that three groups
  // are always in flight from here on
  const unsigned char* wsfb0 = a.w + s.first;
  const size_t recon_off = s.first + (size_t)a.n_sfb * s.sfb;
  fetch(a.w, s.first, WFIRST);
  fetch(a.w + recon_off, s.recon, WRECON);
  cp_commit();
  const int part_off[3] = {0, s.bs, 2 * s.bs}, part_len[3] = {s.bs, s.bs, s.fuse};
  // part j of qSFB i into its bytes of WSFB
  auto prefetch = [&](int j, int i) {
    if (a.n_sfb > 0) fetch(wsfb0 + (size_t)i * s.sfb + part_off[j], part_len[j], WSFB + part_off[j]);
    cp_commit();
  };
  for (int j = 0; j < 3; ++j) prefetch(j, 0);
  // the operand padding (channels past cp8, the first layer's past Cin) is
  // never written again: it stays 0
  for (int i = threadIdx.x; i < (int)(2 * s.op_bytes() / 16); i += blockDim.x)
    reinterpret_cast<uint4*>(F)[i] = make_uint4(0u, 0u, 0u, 0u);
  cp_wait<3>();

  int k = 0;
  for (int n = blockIdx.x / cs; n < a.N; n += gridDim.x / cs) {
    const size_t strip = ((size_t)n * H + r0) * W;   // first pixel of the strip

    // quantize x (site "in") -> qBSConv Cin -> C, no ReLU (site "first"), into F
    __syncthreads();
    if (active) {
      const float ai = __ldg(qc), si = __ldg(qc + 1);
      const float* xs = a.x + strip * a.Cin;
      const int units = s.kp1 >> 2;
      for (int i = threadIdx.x; i < valid * units; i += blockDim.x) {
        const int p = i / units, u = i - p * units;
        int v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * u + e;
          v[e] = c < a.Cin ? (int)requant<T>(__ldg(xs + (size_t)p * a.Cin + c), ai, si) : 0;
        }
        Dot<T>::put4(Y + (size_t)p * s.ost + 4 * u * sizeof(Op), v);
      }
      __syncthreads();
      pointwise_mma<T>(Y, s, d1, wfirst, valid, A[k]);
    }
    push_halo(cl, A[k], rank, cs, r0, rows, H, frow, active);
    if (active) depthwise_q<T, false>(A[k], s, wfirst, vrows, __ldg(qc + 2), __ldg(qc + 3), F);
    k ^= 1;

    // each qSFB: qBSConv (relu, site b1) -> qBSConv (relu, site b2) -> fuse
    // ((wf . y2) * sy + (wf . x) * sx) + b -> ReLU -> requantize (site out).
    // Copy groups in flight at its start: b1, b2, fuse of this qSFB.
    for (int sfb = 0; sfb < a.n_sfb; ++sfb) {
      const float* sq = qc + 4 + 6 * sfb;
      const int next = sfb + 1 < a.n_sfb ? sfb + 1 : 0;
      cp_wait<2>();                                   // b1 has landed
      __syncthreads();
      if (active) pointwise_mma<T>(F, s, dc, b1, valid, A[k]);
      push_halo(cl, A[k], rank, cs, r0, rows, H, frow, active);
      if (active) depthwise_q<T, true>(A[k], s, b1, vrows, __ldg(sq), __ldg(sq + 1), Y);
      cp_wait<1>();                                   // b2 has landed
      __syncthreads();
      prefetch(0, next);                              // b1 is read: the next b1 in flight
      k ^= 1;
      if (active) pointwise_mma<T>(Y, s, dc, b2, valid, A[k]);
      push_halo(cl, A[k], rank, cs, r0, rows, H, frow, active);
      if (active) depthwise_q<T, true>(A[k], s, b2, vrows, __ldg(sq + 2), __ldg(sq + 3), Y);
      cp_wait<1>();                                   // the fuse has landed
      __syncthreads();
      prefetch(1, next);
      // the fuse's output codes go to A[k], which dw2 has read and no
      // neighbour writes before the next barrier; then back into F, once
      // every dot has read F
      char* Z = A[k];
      if (active) {
        const float ao = __ldg(sq + 4), so = __ldg(sq + 5);
        const Map in[2] = {{Y, 0, W, W, FLAT, 0, s.ost}, {F, 0, W, W, FLAT, 0, s.ost}};
        dot_stage<T, 2, 4>(in, valid, wf, dc, [&](int p) { return Z + (size_t)p * s.ost; },
                           [&](char* dst, int co, const int (&acc)[2][2]) {
                             Op* o = reinterpret_cast<Op*>(dst);
#pragma unroll
                             for (int e = 0; e < 2; ++e) {
                               const int c = co + e;
                               o[c] = Dot<T>::op(relu_requant<T>(
                                   fuse_combine(acc[0][e], acc[1][e], fsy[c], fsx[c], fb[c]), ao,
                                   so));
                             }
                           });
      }
      __syncthreads();
      prefetch(2, next);
      if (active)
        for (int i = threadIdx.x; i < valid * s.ost / 16; i += blockDim.x)
          reinterpret_cast<uint4*>(F)[i] = reinterpret_cast<const uint4*>(Z)[i];
      k ^= 1;
    }

    // qDSConv: exact int32 3x3 on the codes -> dequant + bias -> fp 1x1 as
    // an ordered sum over input channels -> + bias -> requantize (site
    // recon), codes to device memory
    const int32_t* dwq = reinterpret_cast<const int32_t*>(WRECON);
    const float* dws = reinterpret_cast<const float*>(dwq + 9 * cp8);
    const float* dwb = dws + cp8;
    const float* pw = dwb + cp8;
    const float* pwb = pw + cp8 * cpo;
    T* Ac = reinterpret_cast<T*>(A[k]);
    const int ng = cp8 >> 2;
    __syncthreads();
    if (active)       // the codes of 4 channels a step
      for (int i = threadIdx.x; i < P * ng; i += blockDim.x) {
        const int p = i / ng, c = 4 * (i - p * ng);
        T* dst = Ac + (size_t)(W + p) * cp8 + c;
        const char* src = F + (size_t)p * s.ost + c * sizeof(Op);
        if constexpr (sizeof(T) == 1) {
          *reinterpret_cast<unsigned*>(dst) = p < valid ? *reinterpret_cast<const unsigned*>(src)
                                                        : 0u;
        } else {
          const float4 v = p < valid ? *reinterpret_cast<const float4*>(src)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<int4*>(dst) = make_int4(__float2int_rn(v.x), __float2int_rn(v.y),
                                                    __float2int_rn(v.z), __float2int_rn(v.w));
        }
      }
    push_halo(cl, A[k], rank, cs, r0, rows, H, crow, active);
    if (active) {
      // valid x cp8, in the interior rows of A[k^1]: the next patch's first
      // layer may push into its halo rows meanwhile
      float* D = reinterpret_cast<float*>(A[k ^ 1] + frow);
      for (int item = threadIdx.x; item < valid * ng; item += blockDim.x) {   // 4 channels
        const int c = 4 * (item % ng), q = item / ng;
        const int i = q / W, j = q - i * W;
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int jj = j + dx - 1;
            if (jj < 0 || jj >= W) continue;
            const T* v = Ac + (size_t)((i + dy) * W + jj) * cp8 + c;
            const int4 wv = *reinterpret_cast<const int4*>(dwq + (dy * 3 + dx) * cp8 + c);
            int x[4];
            if constexpr (sizeof(T) == 1) {
              const char4 b = *reinterpret_cast<const char4*>(v);
              x[0] = b.x, x[1] = b.y, x[2] = b.z, x[3] = b.w;
            } else {
              const int4 b = *reinterpret_cast<const int4*>(v);
              x[0] = b.x, x[1] = b.y, x[2] = b.z, x[3] = b.w;
            }
            acc[0] += x[0] * wv.x;
            acc[1] += x[1] * wv.y;
            acc[2] += x[2] * wv.z;
            acc[3] += x[3] * wv.w;
          }
        st4(D + (size_t)q * cp8 + c,
            make_float4(dequant(acc[0], dws[c], dwb[c]), dequant(acc[1], dws[c + 1], dwb[c + 1]),
                        dequant(acc[2], dws[c + 2], dwb[c + 2]),
                        dequant(acc[3], dws[c + 3], dwb[c + 3])));
      }
      __syncthreads();
      const float ao = __ldg(qc + 4 + 6 * a.n_sfb), so = __ldg(qc + 5 + 6 * a.n_sfb);
      T* os = static_cast<T*>(a.out) + strip * a.Cout;
      // 4 output channels of the 4 pixels p, p + pp/4, p + pp/2, p + 3pp/4
      const int pp = round4(valid), npg = pp >> 2, ngo = cpo >> 2;
      for (int item = threadIdx.x; item < ngo * npg; item += blockDim.x) {
        const int g = item % ngo, pg = item / ngo;
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
        for (int ci = 0; ci < a.C; ++ci) {
          const float4 wv = ld4(pw + ci * cpo + 4 * g);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float dv = D[(pg + r * npg) * cp8 + ci];
            acc[r][0] = mul_add_rn(acc[r][0], dv, wv.x);
            acc[r][1] = mul_add_rn(acc[r][1], dv, wv.y);
            acc[r][2] = mul_add_rn(acc[r][2], dv, wv.z);
            acc[r][3] = mul_add_rn(acc[r][3], dv, wv.w);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = pg + r * npg;
          if (p >= valid) continue;
          T* px = os + (size_t)p * a.Cout;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int co = 4 * g + j;
            if (co < a.Cout) px[co] = requant<T>(__fadd_rn(acc[r][j], pwb[co]), ao, so);
          }
        }
      }
    }
    k ^= 1;
  }
  cp_wait_all();
  cl.sync();   // no block leaves while a neighbour may still read its shared memory
}

template <class T>
ClusterLaunch<Args> launcher(int W, int Cin, int C, int Cout, int n_sfb, int rows, int cluster,
                             int threads, cudaStream_t stream) {
  return ClusterLaunch<Args>(
      qmega_kernel<T>, QShape(Cin, C, Cout, (int)sizeof(T), rows, W).smem_bytes(n_sfb), cluster,
      threads, stream);
}

}  // namespace

// Runs the chain on `stream` as a persistent grid of as many clusters as the
// card holds at once (at most N): x (N,H,W,Cin) fp32 -> out (N,H,W,Cout)
// codes, int8 for bits <= 8 else int32. Returns the launch's CUDA error;
// cudaErrorInvalidValue for a width past the dots' 64 channels,
// cudaErrorLaunchOutOfResources when no cluster of this shape fits the card.
extern "C" int qmega_forward(const float* x, const void* w, const float* qc, void* out, int N,
                             int H, int W, int Cin, int C, int Cout, int n_sfb, int rows,
                             int cluster, int threads, int bits, void* stream) {
  if (C < 1 || C > NTMAX * 8 || Cin < 1 || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{x, static_cast<const unsigned char*>(w), qc, out, N, H, W, Cin, C, Cout,
               n_sfb, rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits <= 8)
    return launcher<int8_t>(W, Cin, C, Cout, n_sfb, rows, cluster, threads, s).launch(a, N);
  return launcher<int32_t>(W, Cin, C, Cout, n_sfb, rows, cluster, threads, s).launch(a, N);
}

// Dynamic shared memory of one block, in bytes (the sizing report's check).
extern "C" long long qmega_smem_bytes(int W, int Cin, int C, int Cout, int n_sfb, int rows,
                                      int bits) {
  return (long long)QShape(Cin, C, Cout, bits <= 8 ? 1 : 4, rows, W).smem_bytes(n_sfb);
}

// The clusters qmega_forward keeps resident for this shape (0 when none
// fits or the query fails), for the sizing report.
extern "C" int qmega_resident_clusters(int W, int Cin, int C, int Cout, int n_sfb, int rows,
                                       int cluster, int threads, int bits) {
  if (bits <= 8)
    return launcher<int8_t>(W, Cin, C, Cout, n_sfb, rows, cluster, threads, nullptr).resident();
  return launcher<int32_t>(W, Cin, C, Cout, n_sfb, rows, cluster, threads, nullptr).resident();
}
