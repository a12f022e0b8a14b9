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
// (qconv.cu) and their plain versions (kernels/ref.py::qmega_ref). Every
// rounded fp step and every integer dot comes from qmath.cuh, which qconv.cu
// includes too; the order of every fp sum is the plain version's.
//
// What bounds it: at C54 x4 the chain does per LR pixel 58,968 integer MACs
// (3*54 for the first 1x1, 5 x 4 x 54^2 for the qSFBs' 1x1s, the fuse's two
// dots included, 9*54 for the int32 depthwise) and ~22,400 fp32 operations
// (quantize, dequant, depthwise, combine, requantize, the recon 1x1 54 ->
// 48), against 12 bytes in and 48 codes out. So it is bound by operations:
// for 1024 32x32 patches 123.7 G integer operations and 23.5 GFLOP fp32;
// on an H100 SXM at the data sheet's rates (int8 on the tensor cores at
// 1,979 TOPS, fp32 at 67 TFLOP/s, fxp10's int32 counted at the fp32 rate)
// 0.41 ms for int8 and 2.20 ms for fxp10, against 0.02 / 0.06 ms of
// device-memory traffic. The dots stay on the CUDA cores here (__dp4a /
// int32 multiply-add), so the int8 bound at the tensor-core rate is out of
// this kernel's reach.
//
// Design: csrc/mega.cu's cluster layout, not the TPU's block sizing. Each
// patch belongs to one thread-block cluster (CLUSTER blocks, launched
// persistent: a cluster walks patches), and each block of the cluster owns a
// strip of `rows` consecutive rows. A block holds, for its strip:
//   A0, A1  fp32, a pointwise output (dequantized, + bias) with one halo row
//           above and one below; in qDSConv A[k] holds the feature CODES with
//           their halo rows and A[k^1] the dequantized depthwise output
//   Wt      the packed weights of the current layer group (one SFB: 3 code
//           matrices + 27 fp vectors), a contiguous 16-byte copy
//   F       the running feature codes, also the qSFB shortcut
//   Z       the fuse's output codes; F and Z swap after each qSFB (the fuse
//           reads every channel of F[p] while writing Z[p], so it cannot
//           write in place)
//   Y       the codes of b1, then of b2 (y1 is dead once b2's pointwise has
//           read it, and the cluster barrier of b2's halo lies between); on
//           entry, the quantized input
// Two kinds of halo: the fp 3x3 of each qBSConv group reads its neighbours'
// fp32 pointwise outputs (0 on pixels off the patch and on rows past H,
// bias included: the SAME padding of the dequantized map); the int32 3x3 of
// qDSConv reads its neighbours' codes (0 off the patch). Before each of the
// 2*n_sfb + 2 depthwise layers the block fills its halo rows from its
// neighbours' strips over distributed shared memory after one cluster
// barrier; the layers alternate between A0 and A1, so a neighbour reads my
// A[k] between barriers L and L+1 and I write A[k] again only after barrier
// L+1. Blocks whose strip lies wholly past H compute nothing but keep the
// barriers. The fp depthwise slides a 3x3 window of inputs down a column in
// registers (one thread per (channel group, column)), summing its taps in
// (dy, dx) raster order with rounded ops.
//
// Weights arrive packed once per (tree, width, pack, device) in the TPU
// kernel's operand order (_flat_q_operands; kernels/megakernel.py::
// pack_qweights): code matrices zero-padded to channel counts that are
// multiples of 4 and already in the staged layout of qmath.cuh, fp vectors
// and matrices zero-padded likewise, every operand a multiple of 16 bytes.
// The site constants (clip, step pairs of `_act_points`) come as one small
// fp32 array.
#include <stdint.h>

#include "cluster.cuh"
#include "common.cuh"
#include "qmath.cuh"

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

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Byte sizes of the packed weight buffer's three groups
// (kernels/megakernel.py::QWeightLayout); cb: bytes of one code.
struct QLayout {
  int cpi, cp, cpo, cb, first, sfb, recon;
  __host__ __device__ QLayout(int Cin, int C, int Cout, int cb_)
      : cpi(round4(Cin)), cp(round4(C)), cpo(round4(Cout)), cb(cb_),
        first(cpi * cp * cb + 48 * cp),               // pwq, scale, pwb, dw (9), dwb
        sfb(3 * cp * cp * cb + 108 * cp),            // b1, b2, fuseq, fsy, fsx, fb
        recon(44 * cp + 4 * cp * cpo + 4 * cpo) {}   // dwq (9), dws, dwb, pw_fq, pwb
  __host__ __device__ int stage_bytes(int n_sfb) const {
    const int m = imax(first, recon);
    return n_sfb > 0 ? imax(m, sfb) : m;
  }
};

// Pixels of one A buffer: the strip with its two halo rows, and at least
// the strip's padded pixel count (A[k^1] holds qDSConv's depthwise output).
__host__ __device__ inline int a_pixels(int rows, int W) {
  return imax((rows + 2) * W, round4(rows * W));
}

// Shared-memory bytes of one block (A0, A1, Wt, F, Z, Y).
__host__ __device__ inline size_t smem_bytes(const QLayout& l, int rows, int W, int n_sfb) {
  const size_t pp = round4(rows * W);
  return 2 * sizeof(float) * (size_t)a_pixels(rows, W) * l.cp + l.stage_bytes(n_sfb) +
         (size_t)l.cb * pp * (2 * l.cp + imax(l.cp, l.cpi));
}

// Walks a packed layer group in operand order.
struct Cursor {
  const unsigned char* p;
  template <class U>
  __device__ const U* take(int n) {
    const U* r = reinterpret_cast<const U*>(p);
    p += (size_t)n * sizeof(U);
    return r;
  }
};

// One qBSConv group's operands: code weights (kp x cp), scale, bias,
// depthwise (9 x cp), depthwise bias.
template <class T>
struct QBS {
  const T* pwq;
  const float *scale, *pwb, *dw, *dwb;
  __device__ QBS(Cursor& c, int kp, int cp)
      : pwq(c.take<T>(kp * cp)), scale(c.take<float>(cp)), pwb(c.take<float>(cp)),
        dw(c.take<float>(9 * cp)), dwb(c.take<float>(cp)) {}
};

// dst[0, bytes) = src[0, bytes), bytes % 16 == 0, both 16-byte aligned.
__device__ __forceinline__ void copy16(const unsigned char* __restrict__ src, int bytes,
                                       unsigned char* dst) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = __ldg(s + i);
}

// Integer 1x1 over the strip's P pixels, dequantized: A's interior row
// pixel p, channels co..co+3 = dequant(X[p] . w(:, co)); 0 on pixels past H
// (bias included). One thread per (pixel, 4 output channels).
template <class T>
__device__ __forceinline__ void pointwise_q(const T* X, int cpi, const T* wq,
                                            const float* scale, const float* bias, int cp,
                                            int P, int valid, float* Ai) {
  const int ng = cp >> 2;
  for (int item = threadIdx.x; item < P * ng; item += blockDim.x) {
    const int g = item % ng, p = item / ng;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < valid) {
      int acc[4];
      dot4(X + p * cpi, wq, cpi, cp, 4 * g, acc);
      const int c = 4 * g;
      o = make_float4(dequant(acc[0], scale[c], bias[c]), dequant(acc[1], scale[c + 1], bias[c + 1]),
                      dequant(acc[2], scale[c + 2], bias[c + 2]),
                      dequant(acc[3], scale[c + 3], bias[c + 3]));
    }
    st4(Ai + p * cp + 4 * g, o);
  }
}

__device__ __forceinline__ void tap4(float4& acc, float4 v, float4 w) {
  acc.x = mul_add_rn(acc.x, v.x, w.x);
  acc.y = mul_add_rn(acc.y, v.y, w.y);
  acc.z = mul_add_rn(acc.z, v.z, w.z);
  acc.w = mul_add_rn(acc.w, v.w, w.w);
}

// fp 3x3 depthwise from A ((rows+2) x W pixels, halo rows included) to the
// rows x W strip, + bias, optional ReLU, requantized to codes in out (rows*W
// x cp). Output (i, j) reads A (i + dy, j + dx - 1), columns off the patch
// read 0; taps in (dy, dx) raster order from 0. One thread per (channel
// group, column), sliding a 3x3 window of inputs down the column.
template <class T>
__device__ __forceinline__ void depthwise_q(const float* __restrict__ A, const float* w9,
                                            const float* bias, int cp, int W, int rows,
                                            bool relu, float ao, float so, T* out) {
  const int ng = cp >> 2;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int item = threadIdx.x; item < ng * W; item += blockDim.x) {
    const int g = item % ng, j = item / ng;
    const float* a = A + 4 * g;
    const bool left = j > 0, right = j + 1 < W;
    auto in = [&](int r, int jj, bool ok) { return ok ? ld4(a + (r * W + jj) * cp) : zero; };
    float4 w[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) w[t] = ld4(w9 + t * cp + 4 * g);
    const float4 b = ld4(bias + 4 * g);
    float4 a0 = in(0, j - 1, left), a1 = in(0, j, true), a2 = in(0, j + 1, right);
    float4 b0 = in(1, j - 1, left), b1 = in(1, j, true), b2 = in(1, j + 1, right);
    for (int i = 0; i < rows; ++i) {
      const float4 c0 = in(i + 2, j - 1, left), c1 = in(i + 2, j, true),
                   c2 = in(i + 2, j + 1, right);
      float4 d = zero;
      tap4(d, a0, w[0]);
      tap4(d, a1, w[1]);
      tap4(d, a2, w[2]);
      tap4(d, b0, w[3]);
      tap4(d, b1, w[4]);
      tap4(d, b2, w[5]);
      tap4(d, c0, w[6]);
      tap4(d, c1, w[7]);
      tap4(d, c2, w[8]);
      float v[4] = {__fadd_rn(d.x, b.x), __fadd_rn(d.y, b.y), __fadd_rn(d.z, b.z),
                    __fadd_rn(d.w, b.w)};
      T* o = out + (i * W + j) * cp + 4 * g;
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = requant<T>(relu ? fmaxf(v[k], 0.f) : v[k], ao, so);
      a0 = b0; a1 = b1; a2 = b2;
      b0 = c0; b1 = c1; b2 = c2;
    }
  }
}

template <class T>
__global__ void __launch_bounds__(MAX_THREADS, 1) qmega_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), cs = (int)cl.num_blocks();
  const int H = a.H, W = a.W, rows = a.rows;
  const QLayout l(a.Cin, a.C, a.Cout, (int)sizeof(T));
  const int cpi = l.cpi, cp = l.cp, cpo = l.cpo, ng = cp >> 2;
  const int P = rows * W, pp = round4(P);
  const int r0 = rank * rows;
  const int valid = imax(0, imin(H - r0, rows)) * W;   // strip pixels inside
  const bool active = valid > 0;
  const int frow = W * cp * (int)sizeof(float);        // bytes of one fp32 row
  const int crow = W * cp * (int)sizeof(T);            // bytes of one code row
  const float* qc = a.qc;

  unsigned char* A[2] = {sm, sm + sizeof(float) * (size_t)a_pixels(rows, W) * cp};
  unsigned char* Wt = A[1] + sizeof(float) * (size_t)a_pixels(rows, W) * cp;
  T* F = reinterpret_cast<T*>(Wt + l.stage_bytes(a.n_sfb));
  T* Z = F + pp * cp;
  T* Y = Z + pp * cp;
  auto interior = [&](int k) { return reinterpret_cast<float*>(A[k] + frow); };

  int k = 0;
  for (int n = blockIdx.x / cs; n < a.N; n += gridDim.x / cs) {
    const size_t strip = ((size_t)n * H + r0) * W;   // first pixel of the strip

    // quantize x (site "in") -> qBSConv Cin -> C, no ReLU (site "first"), into F
    if (active) {
      __syncthreads();
      copy16(a.w, l.first, Wt);
      const float ai = __ldg(qc), si = __ldg(qc + 1);
      const float* xs = a.x + strip * a.Cin;
      for (int i = threadIdx.x; i < pp * cpi; i += blockDim.x) {
        const int p = i / cpi, c = i - p * cpi;
        Y[i] = (p < valid && c < a.Cin) ? requant<T>(__ldg(xs + (size_t)p * a.Cin + c), ai, si)
                                        : T(0);
      }
      __syncthreads();
      Cursor s{Wt};
      const QBS<T> w(s, cpi, cp);
      pointwise_q(Y, cpi, w.pwq, w.scale, w.pwb, cp, P, valid, interior(k));
    }
    exchange(cl, A[k], rank, cs, r0, rows, H, frow, active);
    if (active) {
      Cursor s{Wt};
      const QBS<T> w(s, cpi, cp);
      depthwise_q(reinterpret_cast<const float*>(A[k]), w.dw, w.dwb, cp, W, rows, false,
                  __ldg(qc + 2), __ldg(qc + 3), F);
    }
    k ^= 1;

    // each qSFB: qBSConv (relu, site b1) -> qBSConv (relu, site b2) -> fuse
    // ((wf . y2) * sy + (wf . x) * sx) + b -> ReLU -> requantize (site out)
    for (int sfb = 0; sfb < a.n_sfb; ++sfb) {
      const float* sq = qc + 4 + 6 * sfb;
      Cursor s{Wt};
      const QBS<T> b1(s, cp, cp), b2(s, cp, cp);
      const T* wf = s.take<T>(cp * cp);
      const float* fsy = s.take<float>(cp);
      const float* fsx = s.take<float>(cp);
      const float* fb = s.take<float>(cp);
      if (active) {
        __syncthreads();
        copy16(a.w + l.first + (size_t)sfb * l.sfb, l.sfb, Wt);
        __syncthreads();
        pointwise_q(F, cp, b1.pwq, b1.scale, b1.pwb, cp, P, valid, interior(k));
      }
      exchange(cl, A[k], rank, cs, r0, rows, H, frow, active);
      if (active) {
        depthwise_q(reinterpret_cast<const float*>(A[k]), b1.dw, b1.dwb, cp, W, rows, true,
                    __ldg(sq), __ldg(sq + 1), Y);
        __syncthreads();
      }
      k ^= 1;
      if (active) pointwise_q(Y, cp, b2.pwq, b2.scale, b2.pwb, cp, P, valid, interior(k));
      exchange(cl, A[k], rank, cs, r0, rows, H, frow, active);
      if (active) {
        depthwise_q(reinterpret_cast<const float*>(A[k]), b2.dw, b2.dwb, cp, W, rows, true,
                    __ldg(sq + 2), __ldg(sq + 3), Y);
        __syncthreads();
        const float ao = __ldg(sq + 4), so = __ldg(sq + 5);
        for (int item = threadIdx.x; item < P * ng; item += blockDim.x) {
          const int g = item % ng, p = item / ng;
          T* z = Z + p * cp + 4 * g;
          if (p >= valid) {
#pragma unroll
            for (int j = 0; j < 4; ++j) z[j] = T(0);
            continue;
          }
          int ay[4], ax[4];
          dot4(Y + p * cp, wf, cp, cp, 4 * g, ay);
          dot4(F + p * cp, wf, cp, cp, 4 * g, ax);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int co = 4 * g + j;
            z[j] = requant<T>(fmaxf(fuse_combine(ay[j], ax[j], fsy[co], fsx[co], fb[co]), 0.f),
                              ao, so);
          }
        }
      }
      T* t = F;
      F = Z;
      Z = t;
      k ^= 1;
    }

    // qDSConv: exact int32 3x3 on the codes -> dequant + bias -> fp 1x1 as
    // an ordered sum over input channels -> + bias -> requantize (site
    // recon), codes to device memory
    Cursor s{Wt};
    const int32_t* dwq = s.take<int32_t>(9 * cp);
    const float* dws = s.take<float>(cp);
    const float* dwb = s.take<float>(cp);
    const float* pw = s.take<float>(cp * cpo);
    const float* pwb = s.take<float>(cpo);
    T* Ac = reinterpret_cast<T*>(A[k]);
    if (active) {
      __syncthreads();
      copy16(a.w + l.first + (size_t)a.n_sfb * l.sfb, l.recon, Wt);
      for (int i = threadIdx.x; i < P * cp; i += blockDim.x)
        Ac[W * cp + i] = i / cp < valid ? F[i] : T(0);
    }
    exchange(cl, A[k], rank, cs, r0, rows, H, crow, active);
    if (active) {
      float* D = reinterpret_cast<float*>(A[k ^ 1]);   // pp x cp
      for (int item = threadIdx.x; item < P * cp; item += blockDim.x) {
        const int c = item % cp, q = item / cp;
        const int i = q / W, j = q - i * W;
        int acc = 0;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int jj = j + dx - 1;
            if (jj >= 0 && jj < W)
              acc += static_cast<int>(Ac[((i + dy) * W + jj) * cp + c]) * dwq[(dy * 3 + dx) * cp + c];
          }
        D[item] = dequant(acc, dws[c], dwb[c]);
      }
      __syncthreads();
      const float ao = __ldg(qc + 4 + 6 * a.n_sfb), so = __ldg(qc + 5 + 6 * a.n_sfb);
      T* os = static_cast<T*>(a.out) + strip * a.Cout;
      // 4 output channels of the 4 pixels p, p + pp/4, p + pp/2, p + 3pp/4
      const int npg = pp >> 2, ngo = cpo >> 2;
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
            const float d = D[(pg + r * npg) * cp + ci];
            acc[r][0] = mul_add_rn(acc[r][0], d, wv.x);
            acc[r][1] = mul_add_rn(acc[r][1], d, wv.y);
            acc[r][2] = mul_add_rn(acc[r][2], d, wv.z);
            acc[r][3] = mul_add_rn(acc[r][3], d, wv.w);
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
  cl.sync();   // no block leaves while a neighbour may still read its shared memory
}

template <class T>
ClusterLaunch<Args> launcher(int W, int Cin, int C, int Cout, int n_sfb, int rows, int cluster,
                             int threads, cudaStream_t stream) {
  return ClusterLaunch<Args>(qmega_kernel<T>,
                             smem_bytes(QLayout(Cin, C, Cout, (int)sizeof(T)), rows, W, n_sfb),
                             cluster, threads, stream);
}

}  // namespace

// Runs the chain on `stream` as a persistent grid of as many clusters as the
// card holds at once (at most N): x (N,H,W,Cin) fp32 -> out (N,H,W,Cout)
// codes, int8 for bits <= 8 else int32. Returns the launch's CUDA error;
// cudaErrorLaunchOutOfResources when no cluster of this shape fits the card.
extern "C" int qmega_forward(const float* x, const void* w, const float* qc, void* out, int N,
                             int H, int W, int Cin, int C, int Cout, int n_sfb, int rows,
                             int cluster, int threads, int bits, void* stream) {
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
  return (long long)smem_bytes(QLayout(Cin, C, Cout, bits <= 8 ? 1 : 4), rows, W, n_sfb);
}

// The clusters qmega_forward keeps resident for this shape (0 when none
// fits or the query fails), for the sizing report.
extern "C" int qmega_resident_clusters(int W, int Cin, int C, int Cout, int n_sfb, int rows,
                                       int cluster, int threads, int bits) {
  if (bits <= 8)
    return launcher<int8_t>(W, Cin, C, Cout, n_sfb, rows, cluster, threads, nullptr).resident();
  return launcher<int32_t>(W, Cin, C, Cout, n_sfb, rows, cluster, threads, nullptr).resident();
}
