// Subnet-group megakernel: BSConv -> n_sfb x SFB -> DSConv for a batch of
// patches, NHWC fp32, each patch's running feature kept in shared memory from
// entry to exit. Pixel shuffle runs outside, as in the TPU kernel.
//
// Replaces the TPU kernel repro/kernels/megakernel.py::essr_forward_megakernel
// (_mega_kernel at megakernel.py:186, _mega_forward at :251).
//
// What bounds it: at C54 x4 the chain does 52,326 MAC per LR pixel (first
// 3*54 + 9*54, each SFB 3*54^2 + 18*54, recon 9*54 + 54*48) against 4*(3 + 48)
// bytes in and out, so it is bound by the card's fp32 (non-tensor) rate:
// 109.7 GFLOP, about 1.64 ms for 1024 32x32 patches on an H100 SXM at
// 67 TFLOP/s, against 0.064 ms of device-memory traffic.
//
// Design: a C54 32x32 map is 229 KB with channels padded to 56, more than a
// block's 227 KB of shared memory, and an SFB needs its input (the shortcut)
// and a working map live at once. So each patch belongs to one thread-block
// cluster (CLUSTER blocks, launched persistent: a cluster walks patches), and
// each block of the cluster owns a strip of `rows` consecutive rows. A block
// holds, for its strip:
//   F       the running feature, also the SFB shortcut    (rows*W px)
//   A0, A1  a pointwise output with one halo row above and one below
//                                                         ((rows+2)*W px)
//   B       a depthwise output; on entry, the staged input pixels
//   Wt      the weights of the current layer group, copied from device
//           memory at the start of the group
// Before each of the 2*n_sfb + 2 depthwise layers the block fills its halo
// rows from its neighbours' strips over distributed shared memory
// (cluster.cuh's exchange, shared with qmega.cu; zero at the patch border,
// and on rows past H). The depthwise's SAME padding applies to the
// pointwise OUTPUT, bias included, so pointwise results on rows past H are
// stored as 0. The depthwise layers alternate between A0 and A1: a
// neighbour reads my A[k] between cluster barriers L and L+1, and I write
// A[k] again only after barrier L+1, so one cluster barrier per layer is
// enough. The whole patch is resident, so nothing is recomputed (the per-op
// SFB kernel recomputes a 1.56x halo) and no intermediate touches device
// memory. Blocks whose strip lies wholly past H (patches shorter than
// CLUSTER rows) compute nothing but keep the barriers. A depthwise thread
// owns one (channel group, column) of the strip and slides a 3x3 window of
// inputs down it in registers (reading all nine taps for every output made
// the depthwise layers cost ~6x their FFMA time in shared-memory traffic).
//
// Weights arrive packed in one buffer in the TPU kernel's operand order
// (_flat_fp_operands), every matrix and vector zero-padded to channel counts
// that are multiples of 4 (kernels/megakernel.py::pack_weights), so staging a
// layer group is one contiguous float4 copy. Arithmetic is fp32 FFMA on the
// CUDA cores (no TF32).
#include "cluster.cuh"
#include "common.cuh"

using namespace essr;

namespace {

constexpr int MAX_THREADS = 512;

struct Args {
  const float *x, *w;
  float* out;
  int N, H, W, Cin, C, Cout, n_sfb, rows;
};

// Float offsets of the packed weight buffer (kernels/megakernel.py::WeightLayout).
struct Layout {
  int cpi, cp, cpo, first, sfb, recon;
  __host__ __device__ Layout(int Cin, int C, int Cout)
      : cpi(round4(Cin)), cp(round4(C)), cpo(round4(Cout)),
        first(cpi * cp + 11 * cp),
        sfb(3 * cp * cp + 23 * cp),
        recon(10 * cp + cp * cpo + cpo) {}
  __host__ __device__ int stage_floats(int n_sfb) const {
    int m = first > recon ? first : recon;
    return n_sfb > 0 && sfb > m ? sfb : m;
  }
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory floats of one block (F, A0, A1, B, Wt).
__host__ __device__ inline size_t smem_floats(const Layout& l, int rows, int W, int n_sfb) {
  const size_t pp = round4(rows * W);
  return pp * l.cp + 2 * (size_t)(rows + 2) * W * l.cp + pp * imax(l.cp, l.cpi) +
         l.stage_floats(n_sfb);
}

// dst[0, n) = src[0, n), n % 4 == 0, both 16-byte aligned.
__device__ __forceinline__ void copy4(const float* __restrict__ src, int n, float* dst) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d[i] = __ldg(s + i);
}

__device__ __forceinline__ void fma4(float4& acc, float4 v, float4 w) {
  acc.x = fmaf(v.x, w.x, acc.x);
  acc.y = fmaf(v.y, w.y, acc.y);
  acc.z = fmaf(v.z, w.z, acc.z);
  acc.w = fmaf(v.w, w.w, acc.w);
}

// 3x3 depthwise from A ((rows+2) x W pixels, halo rows included) to the
// rows x W strip: output (i, j) reads A (i + dy, j + dx - 1), columns off the
// patch read 0. One thread per (channel group, column): it keeps the nine
// taps and a 3x3 window of inputs in registers and slides the window down the
// column: each input row is loaded once per thread, not once per output that
// reads it. acc in (dy, dx) raster order, then epi(q, co, acc); the epilogue
// adds the bias.
template <class Epi>
__device__ __forceinline__ void depthwise_strip(const float* __restrict__ A,
                                                const float* __restrict__ w9, int cp, int W,
                                                int rows, Epi epi) {
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
    float4 a0 = in(0, j - 1, left), a1 = in(0, j, true), a2 = in(0, j + 1, right);
    float4 b0 = in(1, j - 1, left), b1 = in(1, j, true), b2 = in(1, j + 1, right);
    for (int i = 0; i < rows; ++i) {
      const float4 c0 = in(i + 2, j - 1, left), c1 = in(i + 2, j, true),
                   c2 = in(i + 2, j + 1, right);
      float4 acc = zero;
      fma4(acc, a0, w[0]);
      fma4(acc, a1, w[1]);
      fma4(acc, a2, w[2]);
      fma4(acc, b0, w[3]);
      fma4(acc, b1, w[4]);
      fma4(acc, b2, w[5]);
      fma4(acc, c0, w[6]);
      fma4(acc, c1, w[7]);
      fma4(acc, c2, w[8]);
      epi(i * W + j, 4 * g, acc);
      a0 = b0; a1 = b1; a2 = b2;
      b0 = c0; b1 = c1; b2 = c2;
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS, 1) mega_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), cs = (int)cl.num_blocks();
  const int H = a.H, W = a.W, rows = a.rows;
  const Layout l(a.Cin, a.C, a.Cout);
  const int cpi = l.cpi, cp = l.cp, cpo = l.cpo;
  const int P = rows * W, pp = round4(P);
  const int r0 = rank * rows;
  const int valid = imax(0, H - r0 < rows ? H - r0 : rows) * W;   // strip pixels inside
  const bool active = valid > 0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int frow = W * cp * (int)sizeof(float);   // bytes of one row of A

  float* F = sm;                                     // pp x cp
  float* A[2] = {F + pp * cp, F + pp * cp + (rows + 2) * W * cp};
  float* B = A[1] + (rows + 2) * W * cp;             // pp x max(cp, cpi)
  float* Wt = B + pp * imax(cp, cpi);

  // pointwise into A's interior, + bias, 0 on pixels past H
  auto to_interior = [&](float* Ak, const float* bias) {
    return [=](int p, int co, float4 v) {
      if (p < P) st4(Ak + (W + p) * cp + co, p < valid ? add4(v, ld4(bias + co)) : zero);
    };
  };

  int k = 0;
  for (int n = blockIdx.x / cs; n < a.N; n += gridDim.x / cs) {
    const size_t strip = ((size_t)n * H + r0) * W;   // first pixel of the strip

    // first: BSConv Cin -> C, no ReLU, into F
    if (active) {
      __syncthreads();
      copy4(a.w, l.first, Wt);
      const float* xs = a.x + strip * a.Cin;
      for (int i = threadIdx.x; i < pp * cpi; i += blockDim.x) {
        const int p = i / cpi, c = i - p * cpi;
        B[i] = (p < valid && c < a.Cin) ? __ldg(xs + (size_t)p * a.Cin + c) : 0.f;
      }
      __syncthreads();
      pointwise(B, cpi, Wt, cp, pp, to_interior(A[k], Wt + cpi * cp));
    }
    exchange(cl, reinterpret_cast<unsigned char*>(A[k]), rank, cs, r0, rows, H, frow, active);
    if (active) {
      const float* dwb = Wt + cpi * cp + 10 * cp;
      depthwise_strip(A[k], Wt + cpi * cp + cp, cp, W, rows, [&](int q, int co, float4 v) {
        st4(F + q * cp + co, add4(v, ld4(dwb + co)));
      });
    }
    k ^= 1;

    // each SFB: relu(BSConv) -> relu(BSConv) -> + F -> 1x1 fuse -> ReLU, into F
    for (int s = 0; s < a.n_sfb; ++s) {
      const float* W1 = Wt;
      const float* b1 = W1 + cp * cp;
      const float* D1 = b1 + cp;
      const float* d1 = D1 + 9 * cp;
      const float* W2 = d1 + cp;
      const float* b2 = W2 + cp * cp;
      const float* D2 = b2 + cp;
      const float* d2 = D2 + 9 * cp;
      const float* WF = d2 + cp;
      const float* bf = WF + cp * cp;
      if (active) {
        __syncthreads();
        copy4(a.w + l.first + (size_t)s * l.sfb, l.sfb, Wt);
        __syncthreads();
        pointwise(F, cp, W1, cp, pp, to_interior(A[k], b1));
      }
      exchange(cl, reinterpret_cast<unsigned char*>(A[k]), rank, cs, r0, rows, H, frow, active);
      if (active) {
        depthwise_strip(A[k], D1, cp, W, rows, [&](int q, int co, float4 v) {
          st4(B + q * cp + co, relu4(add4(v, ld4(d1 + co))));
        });
        __syncthreads();
      }
      k ^= 1;
      if (active) pointwise(B, cp, W2, cp, pp, to_interior(A[k], b2));
      exchange(cl, reinterpret_cast<unsigned char*>(A[k]), rank, cs, r0, rows, H, frow, active);
      if (active) {
        depthwise_strip(A[k], D2, cp, W, rows, [&](int q, int co, float4 v) {
          st4(B + q * cp + co, add4(relu4(add4(v, ld4(d2 + co))), ld4(F + q * cp + co)));
        });
        __syncthreads();
        pointwise(B, cp, WF, cp, pp, [&](int p, int co, float4 v) {
          if (p < P) st4(F + p * cp + co, relu4(add4(v, ld4(bf + co))));
        });
      }
      k ^= 1;
    }

    // recon: 3x3 depthwise + bias -> 1x1 C -> Cout + bias, to device memory
    const float* RD = Wt;
    const float* rdb = RD + 9 * cp;
    const float* RP = rdb + cp;
    const float* rpb = RP + cp * cpo;
    if (active) {
      __syncthreads();
      copy4(a.w + l.first + (size_t)a.n_sfb * l.sfb, l.recon, Wt);
      float4* Ai = reinterpret_cast<float4*>(A[k] + W * cp);
      const float4* F4 = reinterpret_cast<const float4*>(F);
      for (int i = threadIdx.x; i < P * cp / 4; i += blockDim.x)
        Ai[i] = (4 * i) / cp < valid ? F4[i] : zero;
    }
    exchange(cl, reinterpret_cast<unsigned char*>(A[k]), rank, cs, r0, rows, H, frow, active);
    if (active) {
      depthwise_strip(A[k], RD, cp, W, rows, [&](int q, int co, float4 v) {
        st4(B + q * cp + co, add4(v, ld4(rdb + co)));
      });
      __syncthreads();
      float* os = a.out + strip * a.Cout;
      const bool vec = (a.Cout & 3) == 0;
      pointwise(B, cp, RP, cpo, pp, [&](int p, int co, float4 v) {
        if (p >= valid || co >= a.Cout) return;
        const float4 o = add4(v, ld4(rpb + co));
        float* px = os + (size_t)p * a.Cout;
        if (vec)
          st4(px + co, o);
        else
          store4(px, co, a.Cout, o);
      });
    }
    k ^= 1;
  }
  cl.sync();   // no block leaves while a neighbour may still read its shared memory
}

}  // namespace

// Runs the chain on `stream` as a persistent grid of as many clusters as the
// card holds at once (at most N). Returns the launch's CUDA error;
// cudaErrorLaunchOutOfResources when no cluster of this shape fits the card.
extern "C" int mega_forward(const float* x, const float* w, float* out, int N, int H, int W,
                            int Cin, int C, int Cout, int n_sfb, int rows, int cluster,
                            int threads, void* stream) {
  const Args a{x, w, out, N, H, W, Cin, C, Cout, n_sfb, rows};
  ClusterLaunch<Args> launch(mega_kernel,
                             smem_floats(Layout(Cin, C, Cout), rows, W, n_sfb) * sizeof(float),
                             cluster, threads, static_cast<cudaStream_t>(stream));
  return launch.launch(a, N);
}

// The clusters mega_forward keeps resident for this shape (0 when none fits
// or the query fails), for the sizing report.
extern "C" int mega_resident_clusters(int W, int Cin, int C, int Cout, int n_sfb, int rows,
                                      int cluster, int threads) {
  ClusterLaunch<Args> launch(mega_kernel,
                             smem_floats(Layout(Cin, C, Cout), rows, W, n_sfb) * sizeof(float),
                             cluster, threads, nullptr);
  return launch.resident();
}
