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
// (qconv.cu, qsfb.cu, dsconv.cu) and their plain versions
// (kernels/ref.py::qmega_ref). Every rounded fp step comes from qmath.cuh, in
// the plain version's order: dequant; the depthwise taps as mul_add_rn in
// (dy, dx) raster order from 0, then + bias; fuse_combine; the recon's fp 1x1
// as an ordered sum over channels 0..C-1 from 0; requant's division. Only the
// integer dots change their order, because they are exact.
//
// The 1x1 dots (the first layer's, and the four of each qSFB, the fuse's two
// included) run on the tensor cores through qmma.cuh: int8 on mma.sync
// m16n8k32 s8, fxp10 on m16n8k16 f16 over codes held as fp16 (exact while
// |code| <= 511 and K <= 64: every integer up to 2^11 is an fp16, every sum
// below 2^24; qmma.cuh's Dot<__half>). The first layer's depth (Cin = 3)
// pads with zero codes to one k-step. The recon's int32 3x3 and its fp 1x1
// stay on the CUDA cores.
//
// What bounds it: at C54 x4 the chain does per LR pixel 58,968 integer MACs
// (3*54 for the first 1x1, 5 x 4 x 54^2 for the qSFBs' 1x1s, the fuse's two
// dots included, 9*54 for the int32 depthwise) and 22,449 rounded fp32
// operations (quantize, dequant, depthwise, combine, requantize, the recon 1x1
// 54 -> 48), against 12 bytes in and 48 codes out. So it is bound by
// operations: for 1024 32x32 patches 123.7 G integer operations and 23.5 G
// rounded fp32 operations; on an H100 SXM at the data sheet's rates (int8 on
// the tensor cores at 1,979 TOPS, fxp10's dots at the fp16 rate of 989
// TFLOP/s, each rounded fp32 operation one instruction at 33.5 T a second)
// 0.76 ms for int8 and 0.83 ms for fxp10, against 0.02 / 0.06 ms of
// device-memory traffic.
//
// Design: csrc/mega.cu's cluster layout. Each patch belongs to one
// thread-block cluster (launched persistent: a cluster walks patches), and
// each block of the cluster owns a strip of `rows` consecutive rows. The
// cluster takes 4 blocks where a block's strip fits in shared memory, else 8,
// else 16 (kernels/megakernel.py::qgroup_report): taller strips pay fewer
// barriers a row, and the card holds more small clusters. Every patch of
// Table I fits at C27 and C54 in both modes (64x64 C54: 16 blocks of 4 rows).
// A block holds, for its strip:
//   A       one fp32 map: a pointwise output (dequantized, + bias), rows past
//           H zero; the fuse stages its output codes here once dw2 has read
//           it, and the recon its dequantized depthwise output
//   HT, HB  the halo rows above and below the strip, which the neighbours
//           fill: fp32 rows of A, or the recon's code rows of F
//   F       the running feature codes in the dot operand layout (kp codes a
//           pixel, an odd multiple of 16 bytes), also the qSFB shortcut
//   Y       the codes of b1, then of b2; on entry the quantized input
//   ring    two slots of packed weights, one layer (a qBSConv group, a fuse
//           or the recon) each: the next layer's weights arrive by cp.async
//           into the other slot while this one runs
// Halos are mega.cu's: before each of the 2 * n_sfb + 2 depthwise layers one
// thread of a block sends its first and last rows of the layer's input into
// its neighbours' HB and HT as two bulk copies (cp.async.bulk, shared::cta
// to shared::cluster), each completing on an mbarrier of the receiver, which
// expects its halo bytes and waits on its own barrier. One pair of halo rows
// serves every layer, so a block must not overwrite a neighbour's halo row
// before the neighbour has read it: a block arrives (relaxed: every value it
// read has been consumed) on a cluster barrier once its depthwise has read
// the halo rows, and waits on it just before its next push. Nothing else is
// written remotely, and a block writes a row it has sent only after its copy
// has read it (bulk_wait_read). The whole depthwise of a layer runs after
// its halo rows have landed: no row is computed between the barrier's two
// halves. The depthwise's SAME padding applies to the dequantized map, bias
// included: rows past H and halos at the patch border read 0. Blocks whose
// strip lies wholly past H keep the barriers. The fp depthwise walks four
// columns a thread (depthwise_quad); the division of requantize is skipped
// where the ReLU gave 0 (relu_requant, bit-equal).
//
// Measured (scripts/torch_qmega_ab.py; NVIDIA H100 80GB HBM3, 700.00 W): at
// N = 1024 32x32 C54 0.95x the time of the layout it replaces (two fp32 maps
// with halo rows pushed by remote stores under a full cluster barrier, the
// weights of a whole qSFB staged together) in int8 and 0.82x in fxp10 (4 x
// 8-row clusters instead of 8 x 4, fp16 dots); 1.00x / 1.02x at C27.
//
// Weights arrive packed once per (tree, width, pack, device) in the TPU
// kernel's operand order (_flat_q_operands; kernels/megakernel.py::
// pack_qweights): each 1x1's code weights as the dots' B operand (a row of
// `ast` bytes per output channel, fxp10 codes as fp16), output channels
// zero-padded to multiples of 8; fp vectors and matrices zero-padded
// likewise; every operand a multiple of 16 bytes. The site constants (clip,
// step pairs of `_act_points`) come as one small fp32 array.
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "cluster.cuh"
#include "common.cuh"
#include "qmath.cuh"
#include "qmma.cuh"

using namespace essr;

namespace {

constexpr int MAX_THREADS = 512;

// The dots' operand type of a code type: int8 codes, fxp10 codes as fp16.
template <class T>
using OpOf = typename std::conditional<sizeof(T) == 1, int8_t, __half>::type;

struct Args {
  const float* x;
  const unsigned char* w;
  const float* qc;
  void* out;
  int N, H, W, Cin, C, Cout, n_sfb, rows;
};

// The shape of one 1x1 for dot_stage: operand code bytes, output channels
// padded to 8, dot depth in codes, bytes of a weight row.
struct DotShape {
  int sz, cp8, kp, ast;
};

// The launch's layout (the same sums as kernels/megakernel.py::QWeightLayout
// and _qsizing). Byte sizes of the packed groups: first = pw (cp8 rows of
// ast1) | scale | pwb | dw (9) | dwb; one qBSConv of a qSFB (bs) the same
// with rows of ast; fuse = fq (cp8 rows of ast) | fsy | fsx | fb; recon =
// dwq (9, int32) | dws | dwb | pw_fq (cp8 x cpo) | pwb (cpo).
struct QShape {
  int sz;              // bytes of a dot operand code: 1 (int8) or 2 (fxp10, fp16)
  int cp8, cpo;        // channels padded to 8; output channels padded to 4
  int kp, ast;         // dot depth of a C-channel operand, bytes of its weight rows
  int kp1, ast1;       // the same for the first 1x1's Cin-channel input
  int ost;             // bytes of one operand pixel in F and Y
  int pst;             // floats of one pixel of the fp32 map
  int first, bs, fuse, sfb, recon, slot;
  int rows, W, P;      // rows of a strip, patch width, pixels of a strip
  __host__ __device__ QShape(int Cin, int C, int Cout, int op_bytes, int n_sfb, int rows_,
                             int W_) {
    sz = op_bytes;
    cp8 = up(C, 8);
    cpo = round4(Cout);
    kp = up(C, 32 / sz);
    ast = operand_stride(kp * sz);
    kp1 = up(Cin, 32 / sz);
    ast1 = operand_stride(kp1 * sz);
    ost = imax(ast, ast1);
    pst = cp8 % 16 == 0 ? cp8 + 8 : cp8;
    first = cp8 * ast1 + 48 * cp8;
    bs = cp8 * ast + 48 * cp8;
    fuse = cp8 * ast + 12 * cp8;
    sfb = 2 * bs + fuse;
    recon = 44 * cp8 + 4 * cp8 * cpo + 4 * cpo;
    slot = imax(imax(first, recon), n_sfb > 0 ? imax(bs, fuse) : 0);
    rows = rows_;
    W = W_;
    P = rows * W;
  }
  __host__ __device__ int frow() const { return W * pst * 4; }   // bytes of an fp32 map row
  __host__ __device__ int crow() const { return W * ost; }       // bytes of a code row of F
  // A: the fp32 map, or the fuse's output codes
  __host__ __device__ size_t a_bytes() const {
    const size_t m = (size_t)P * pst * 4, z = (size_t)P * ost;
    return m > z ? m : z;
  }
  __host__ __device__ size_t op_bytes() const { return (size_t)P * ost; }
  // regions, in this order: A | HT | HB | F | Y | ring (2 slots) | mbarrier (16)
  __host__ __device__ size_t smem_bytes() const {
    return a_bytes() + 2 * (size_t)imax(frow(), crow()) + 2 * op_bytes() + 2 * (size_t)slot + 16;
  }
  // Piece q of a patch's walk (the first layer, per qSFB b1, b2, fuse, then
  // the recon): its byte offset in the packed buffer and its length.
  __device__ void piece(int q, int n_sfb, int& off, int& len) const {
    if (q == 0) {
      off = 0;
      len = first;
    } else if (q <= 3 * n_sfb) {
      const int i = (q - 1) / 3, u = (q - 1) % 3;
      off = first + i * sfb + u * bs;
      len = u < 2 ? bs : fuse;
    } else {
      off = first + n_sfb * sfb;
      len = recon;
    }
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

// Integer 1x1 over the strip's first `valid` pixels of operand buffer X into
// the fp32 map A: dequant(X[p] . w) + bias; the pixels from `valid` to P
// (rows past H) get 0, the SAME padding of the dequantized map.
template <class O>
__device__ __forceinline__ void pointwise_mma(const char* X, const QShape& s, const DotShape& d,
                                              const QBS& w, int valid, char* A) {
  const Map in[1] = {{const_cast<char*>(X), 0, s.W, s.W, FLAT, 0, s.ost}};
  const int pbytes = s.pst * 4;
  dot_stage<O, 1, 4>(in, valid, w.pw, d, [&](int p) { return A + (size_t)p * pbytes; },
                     [&](char* dst, int co, const int (&acc)[1][2]) {
                       *reinterpret_cast<float2*>(dst + 4 * co) =
                           make_float2(dequant(acc[0][0], w.scale[co], w.pwb[co]),
                                       dequant(acc[0][1], w.scale[co + 1], w.pwb[co + 1]));
                     });
  float4* tail = reinterpret_cast<float4*>(A + (size_t)valid * pbytes);
  for (int i = threadIdx.x; i < (s.P - valid) * pbytes / 16; i += blockDim.x)
    tail[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Row r of a layer's input around the strip: the halo row HT above (r = -1),
// the strip's row r of `in` (row_bytes each) for r < vrows, nothing (zeros)
// for rows past H, the halo row HB below (r = rows).
__device__ __forceinline__ const char* strip_row(const char* in, const char* HT, const char* HB,
                                                 int r, int vrows, int rows, int row_bytes) {
  return r < 0 ? HT : r < vrows ? in + (size_t)r * row_bytes : r == rows ? HB : nullptr;
}

// fp 3x3 depthwise from the map A (rows of W pixels, pst floats a pixel,
// halo rows HT and HB) to the strip's first vrows rows: output (i, j) reads
// row i + dy - 1, column j + dx - 1; columns off the patch and rows past H
// read 0; the nine taps as mul_add_rn in (dy, dx) raster order from 0, then
// epi(i, j, co, acc); the epilogue adds the bias. One thread per (channel
// group of 4, four adjacent columns, row) reads each of its three input rows
// once (six pixels) and keeps the four outputs' sums.
template <class Epi>
__device__ __forceinline__ void depthwise_quad(const char* A, const char* HT, const char* HB,
                                               const QShape& s, const float* __restrict__ w9,
                                               int vrows, Epi epi) {
  const int W = s.W, pst = s.pst, cp8 = s.cp8, ng = cp8 >> 2, quads = (W + 3) >> 2;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int item = threadIdx.x; item < ng * quads * vrows; item += blockDim.x) {
    const int g = item % ng, rest = item / ng;
    const int jq = rest % quads, i = rest / quads;
    const int j0 = 4 * jq;
    const float* tap = w9 + 4 * g;
    float4 sum[4] = {zero, zero, zero, zero};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* row = reinterpret_cast<const float*>(
          strip_row(A, HT, HB, i + dy - 1, vrows, s.rows, s.frow()));
      float4 v[6];
#pragma unroll
      for (int e = 0; e < 6; ++e) {
        const int c = j0 - 1 + e;
        v[e] = row != nullptr && c >= 0 && c < W ? ld4(row + c * pst + 4 * g) : zero;
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
__device__ __forceinline__ void depthwise_q(const char* A, const char* HT, const char* HB,
                                            const QShape& s, const QBS& w, int vrows, float ao,
                                            float so, char* out) {
  using O = OpOf<T>;
  depthwise_quad(A, HT, HB, s, w.dw, vrows, [&](int i, int j, int co, float4 acc) {
    const float4 b = ld4(w.dwb + co);
    const float v[4] = {__fadd_rn(acc.x, b.x), __fadd_rn(acc.y, b.y), __fadd_rn(acc.z, b.z),
                        __fadd_rn(acc.w, b.w)};
    int c4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c4[e] = RELU ? relu_requant<T>(v[e], ao, so) : (int)requant<T>(v[e], ao, so);
    Dot<O>::put4(out + ((size_t)i * s.W + j) * s.ost + co * sizeof(O), c4);
  });
}

// Codes c..c+3 of one operand pixel as ints.
__device__ __forceinline__ int4 codes4(const char* px, int c, int8_t) {
  const char4 b = *reinterpret_cast<const char4*>(px + c);
  return make_int4(b.x, b.y, b.z, b.w);
}
__device__ __forceinline__ int4 codes4(const char* px, int c, __half) {
  const __half2* h = reinterpret_cast<const __half2*>(px + 2 * c);
  return make_int4(__half2int_rn(__low2half(h[0])), __half2int_rn(__high2half(h[0])),
                   __half2int_rn(__low2half(h[1])), __half2int_rn(__high2half(h[1])));
}

template <class T>
__global__ void __launch_bounds__(MAX_THREADS, 1) qmega_kernel(Args a) {
  using O = OpOf<T>;
  extern __shared__ __align__(16) unsigned char sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), cs = (int)cl.num_blocks();
  const int H = a.H, W = a.W, rows = a.rows;
  const QShape s(a.Cin, a.C, a.Cout, (int)sizeof(O), a.n_sfb, rows, W);
  const int cp8 = s.cp8, cpo = s.cpo, P = s.P;
  const DotShape d1{s.sz, cp8, s.kp1, s.ast1}, dc{s.sz, cp8, s.kp, s.ast};
  const int r0 = rank * rows;
  const int vrows = imax(0, imin(H - r0, rows));
  const int valid = vrows * W;                         // strip pixels inside
  const bool active = valid > 0;
  const int hrow = imax(s.frow(), s.crow());
  const float* qc = a.qc;

  char* A = reinterpret_cast<char*>(sm);
  char* HT = A + s.a_bytes();
  char* HB = HT + hrow;
  char* F = HB + hrow;
  char* Y = F + s.op_bytes();
  char* ring = Y + s.op_bytes();
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 2 * (size_t)s.slot);   // halo rows landed
  unsigned parity = 0;

  // piece j of this block's walk (patch j / np, piece j % np) goes to slot j & 1
  const int np = 2 + 3 * a.n_sfb;
  const int n0 = blockIdx.x / cs, dn = gridDim.x / cs;
  const long long total = n0 < a.N ? ((long long)(a.N - 1 - n0) / dn + 1) * np : 0;
  long long j = 0;
  auto fetch = [&](long long q) {
    if (q < total) {
      int off, len;
      s.piece((int)(q % np), a.n_sfb, off, len);
      char* dst = ring + (q & 1) * (size_t)s.slot;
      const char* src = reinterpret_cast<const char*>(a.w) + off;
      for (int i = threadIdx.x; i < len / 16; i += blockDim.x)
        cp_async16(dst + 16 * i, src + 16 * i);
    }
    cp_commit();
  };
  // the next layer's weights: wait for them, then (the barrier has freed
  // the other slot) start the copy of the layer after it
  auto next = [&]() -> const char* {
    cp_wait_all();
    __syncthreads();
    fetch(j + 1);
    return ring + (j++ & 1) * (size_t)s.slot;
  };
  // a depthwise layer on the strip rows `in` (row_bytes each): push its halo
  // rows once every block has read the last layer's, wait for mine to land,
  // run, and say that my halo rows are read
  auto depthwise_layer = [&](const char* in, int row_bytes, auto run) {
    fence_proxy_async();                       // `in`'s rows, for the bulk copies
    __syncthreads();
    if (threadIdx.x == 0) mbar_arrive_expect(bar, halo_bytes(rank, cs, r0, rows, H, row_bytes));
    cluster_wait();
    if (active && threadIdx.x == 0)
      push_halo_bulk(in, in + (size_t)(rows - 1) * row_bytes, HT, HB, bar, rank, cs, r0, rows, H,
                     row_bytes);
    mbar_wait(bar, parity);
    parity ^= 1;
    if (active) run();
    if (threadIdx.x == 0) bulk_wait_read();    // before `in` is written again
    cluster_arrive_relaxed();
  };

  // the halo rows no neighbour fills read 0 (the patch border, rows past H);
  // the operand padding (channels past cp8, the first layer's past Cin) is
  // never written again: it stays 0
  for (int i = threadIdx.x; i < 2 * hrow / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(HT)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < (int)(2 * s.op_bytes() / 16); i += blockDim.x)
    reinterpret_cast<uint4*>(F)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  fetch(0);
  cluster_arrive();                            // matched by the wait before the first push

  for (int n = n0; n < a.N; n += dn) {
    const size_t strip = ((size_t)n * H + r0) * W;   // first pixel of the strip

    // quantize x (site "in") -> qBSConv Cin -> C, no ReLU (site "first"), into F
    {
      const char* w = next();
      const QBS wfirst(w, cp8 * s.ast1, cp8);
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
          Dot<O>::put4(Y + (size_t)p * s.ost + 4 * u * sizeof(O), v);
        }
      }
      __syncthreads();
      if (active) pointwise_mma<O>(Y, s, d1, wfirst, valid, A);
      depthwise_layer(A, s.frow(), [&] {
        depthwise_q<T, false>(A, HT, HB, s, wfirst, vrows, __ldg(qc + 2), __ldg(qc + 3), F);
      });
    }

    // each qSFB: qBSConv (relu, site b1) -> qBSConv (relu, site b2) -> fuse
    // ((wf . y2) * sy + (wf . x) * sx) + b -> ReLU -> requantize (site out).
    for (int sfb = 0; sfb < a.n_sfb; ++sfb) {
      const float* sq = qc + 4 + 6 * sfb;
      {
        const QBS b1(next(), cp8 * s.ast, cp8);
        if (active) pointwise_mma<O>(F, s, dc, b1, valid, A);
        depthwise_layer(A, s.frow(), [&] {
          depthwise_q<T, true>(A, HT, HB, s, b1, vrows, __ldg(sq), __ldg(sq + 1), Y);
        });
      }
      {
        const QBS b2(next(), cp8 * s.ast, cp8);
        if (active) pointwise_mma<O>(Y, s, dc, b2, valid, A);
        depthwise_layer(A, s.frow(), [&] {
          depthwise_q<T, true>(A, HT, HB, s, b2, vrows, __ldg(sq + 2), __ldg(sq + 3), Y);
        });
      }
      // the fuse's output codes go to A, which dw2 has read (and whose rows
      // its bulk copies have read); then back into F, once every dot has
      // read F
      const char* wf = next();
      const float* fsy = reinterpret_cast<const float*>(wf + cp8 * s.ast);
      const float* fsx = fsy + cp8;
      const float* fb = fsx + cp8;
      char* Z = A;
      if (active) {
        const float ao = __ldg(sq + 4), so = __ldg(sq + 5);
        const Map in[2] = {{Y, 0, W, W, FLAT, 0, s.ost}, {F, 0, W, W, FLAT, 0, s.ost}};
        dot_stage<O, 2, 4>(in, valid, wf, dc, [&](int p) { return Z + (size_t)p * s.ost; },
                           [&](char* dst, int co, const int (&acc)[2][2]) {
                             O* o = reinterpret_cast<O*>(dst);
#pragma unroll
                             for (int e = 0; e < 2; ++e) {
                               const int c = co + e;
                               o[c] = Dot<O>::op(relu_requant<T>(
                                   fuse_combine(acc[0][e], acc[1][e], fsy[c], fsx[c], fb[c]), ao,
                                   so));
                             }
                           });
      }
      __syncthreads();
      if (active) {     // cp8 codes a pixel: the operand padding of F stays 0
        const int units = cp8 * (int)sizeof(O) / 8;
        for (int i = threadIdx.x; i < valid * units; i += blockDim.x) {
          const int p = i / units, u = i - p * units;
          reinterpret_cast<uint2*>(F + (size_t)p * s.ost)[u] =
              reinterpret_cast<const uint2*>(Z + (size_t)p * s.ost)[u];
        }
      }
    }

    // qDSConv: exact int32 3x3 on the codes of F (halo code rows in HT, HB)
    // -> dequant + bias into A (cp8 floats a pixel) -> fp 1x1 as an ordered
    // sum over input channels -> + bias -> requantize (site recon), codes to
    // device memory
    const char* wr = next();
    const int32_t* dwq = reinterpret_cast<const int32_t*>(wr);
    const float* dws = reinterpret_cast<const float*>(dwq + 9 * cp8);
    const float* dwb = dws + cp8;
    const float* pw = dwb + cp8;
    const float* pwb = pw + cp8 * cpo;
    float* D = reinterpret_cast<float*>(A);
    const int ng = cp8 >> 2;
    depthwise_layer(F, s.crow(), [&] {
      for (int item = threadIdx.x; item < valid * ng; item += blockDim.x) {   // 4 channels
        const int c = 4 * (item % ng), q = item / ng;
        const int i = q / W, jj0 = q - i * W;
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const char* row = strip_row(F, HT, HB, i + dy - 1, vrows, rows, s.crow());
          if (row == nullptr) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int jj = jj0 + dx - 1;
            if (jj < 0 || jj >= W) continue;
            const int4 x = codes4(row + (size_t)jj * s.ost, c, O());
            const int4 wv = *reinterpret_cast<const int4*>(dwq + (dy * 3 + dx) * cp8 + c);
            acc[0] += x.x * wv.x;
            acc[1] += x.y * wv.y;
            acc[2] += x.z * wv.z;
            acc[3] += x.w * wv.w;
          }
        }
        st4(D + (size_t)q * cp8 + c,
            make_float4(dequant(acc[0], dws[c], dwb[c]), dequant(acc[1], dws[c + 1], dwb[c + 1]),
                        dequant(acc[2], dws[c + 2], dwb[c + 2]),
                        dequant(acc[3], dws[c + 3], dwb[c + 3])));
      }
    });
    __syncthreads();
    if (active) {
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
          for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
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
          for (int k = 0; k < 4; ++k) {
            const int co = 4 * g + k;
            if (co < a.Cout) px[co] = requant<T>(__fadd_rn(acc[r][k], pwb[co]), ao, so);
          }
        }
      }
    }
  }
  cluster_wait();                              // matches the last arrive
  cp_wait_all();
}

template <class T>
ClusterLaunch<Args> launcher(int W, int Cin, int C, int Cout, int n_sfb, int rows, int cluster,
                             int threads, cudaStream_t stream) {
  return ClusterLaunch<Args>(
      qmega_kernel<T>,
      QShape(Cin, C, Cout, (int)sizeof(OpOf<T>), n_sfb, rows, W).smem_bytes(), cluster, threads,
      stream);
}

}  // namespace

// Runs the chain on `stream` as a persistent grid of as many clusters as the
// card holds at once (at most N): x (N,H,W,Cin) fp32 -> out (N,H,W,Cout)
// codes, int8 for bits <= 8 else int32. Returns the launch's CUDA error;
// cudaErrorInvalidValue for a width past the dots' 64 channels or a launch
// shape the kernel does not take, cudaErrorLaunchOutOfResources when no
// cluster of this shape fits the card.
extern "C" int qmega_forward(const float* x, const void* w, const float* qc, void* out, int N,
                             int H, int W, int Cin, int C, int Cout, int n_sfb, int rows,
                             int cluster, int threads, int bits, void* stream) {
  if (C < 1 || C > NTMAX * 8 || Cin < 1 || Cin > NTMAX * 8 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || rows < 1 || (long long)rows * cluster < H)
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
  return (long long)QShape(Cin, C, Cout, bits <= 8 ? 1 : 2, n_sfb, rows, W).smem_bytes();
}

// The clusters qmega_forward keeps resident for this shape (0 when none
// fits or the query fails), for the sizing report.
extern "C" int qmega_resident_clusters(int W, int Cin, int C, int Cout, int n_sfb, int rows,
                                       int cluster, int threads, int bits) {
  if (bits <= 8)
    return launcher<int8_t>(W, Cin, C, Cout, n_sfb, rows, cluster, threads, nullptr).resident();
  return launcher<int32_t>(W, Cin, C, Cout, n_sfb, rows, cluster, threads, nullptr).resident();
}
