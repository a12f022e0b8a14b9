// Subnet-group megakernel: BSConv -> n_sfb x SFB -> DSConv for a batch of
// patches, NHWC fp32, each patch's running feature kept in shared memory from
// entry to exit. Pixel shuffle runs outside, as in the TPU kernel.
//
// Replaces the TPU kernel repro/kernels/megakernel.py::essr_forward_megakernel
// (:292; _mega_forward at :251, _mega_kernel at :186).
//
// What bounds it: at C54 x4 the chain does 52,326 MAC per LR pixel (first
// 3*54 + 9*54, each SFB 3*54^2 + 18*54, recon 9*54 + 54*48) against 4*(3 + 48)
// bytes in and out, so it is bound by the card's fp32 (non-tensor) rate:
// 109.7 GFLOP, 1.6378 ms for 1024 32x32 patches on an H100 SXM at 67 TFLOP/s,
// against 0.064 ms of device-memory traffic. 84% of the MACs are the 15 C x C
// pointwise layers.
//
// Design (sized by kernels/megakernel.py::group_report):
// - Each patch belongs to one thread-block cluster of 1, 2, 4, 8 or 16 blocks
//   (launched persistent: a cluster walks patches), and each block owns a
//   strip of `rows` consecutive full-width rows. Of the cluster sizes whose
//   strip fits a block's shared memory, the sizing takes the one that keeps
//   the most strip rows resident on an SM: taller strips pay fewer barriers
//   a row, and several blocks on an SM hide one block's barriers and
//   latencies behind another's work (C54 32x32: 4 blocks of 8 rows, one
//   block an SM; C27: 8 blocks of 4 rows, three an SM; 16x16 C54: one
//   block a patch, no halo at all).
// - A block holds three maps of its strip, F (the running feature, also the
//   SFB shortcut), A (a pointwise output) and B (a depthwise output; on
//   entry the input pixels), and two halo rows HT and HB, one row above and
//   one below the strip, which the neighbours fill. A pixel takes C (padded
//   to 8) + 4 floats, so the 16-byte loads of consecutive pixels fall on
//   distinct banks; where that fits nowhere (64x64 at C54), C padded to 8.
// - Halos are pushed: before each of the 2*n_sfb + 2 depthwise layers one
//   thread of a block sends its first and last rows into its neighbours'
//   HB and HT as two bulk copies (cp.async.bulk, shared::cta to
//   shared::cluster), each completing on an mbarrier of the receiver, which
//   expects its halo bytes and waits on its own barrier: no fence at GPU
//   scope and no cluster barrier (a release arrive fences the whole GPU and
//   cost ~0.25 ms at C54; 16-byte st.async stores into the mbarrier cost
//   more than they saved). One pair of halo rows serves every layer, so a
//   block must not overwrite a neighbour's halo row before the neighbour has
//   read it: a block arrives (relaxed: every value it read has been
//   consumed) on a cluster barrier once it has read the layer's halo rows,
//   and waits on it just before its next push; the wait falls after a
//   pointwise layer, so it rarely waits. The depthwise's SAME padding
//   applies to the pointwise OUTPUT, bias included: rows past H and halos at
//   the patch border read 0, and pointwise pixels past H are never
//   computed. Blocks whose strip lies wholly past H keep the barriers.
// - Weights are staged one layer ahead: the packed buffer is a sequence of
//   pieces (a 1x1 with its bias, a 3x3 with its bias), and while a layer
//   runs, the next layer's piece is on its way by cp.async into the other
//   slot of a two-slot ring; the barrier that starts a layer is the one that
//   frees the slot.
// - Each pointwise thread owns 4 pixels x 8 output channels (csrc/sfb.cu's
//   register tile): per 4 input channels 4 loads of 16 bytes of inputs and 8
//   of weights for 128 FFMA, the next 4 channels' loads in flight; a warp
//   shares its channel group, so weight loads broadcast. Each depthwise
//   thread owns 4 channels of two adjacent columns and slides a 3x4 window
//   down a segment of its rows in registers.
// - The first layer's input arrives by 16-byte loads; the recon's output is
//   staged unpadded in shared memory and leaves as one contiguous run of the
//   strip's rows, 16 bytes a thread.
// - The arithmetic is in the layer chain's order (bsconv.cu, sfb.cu,
//   dsconv.cu), so the output is bit-identical to it: each pointwise output
//   is one fmaf chain over input channels ascending from 0 (depth padded to
//   4 with zeros), then + bias; each depthwise sums its 9 taps in (dy, dx)
//   raster order from 0, then + bias.
// - Measured (scripts/torch_mega_ab.py; NVIDIA H100 80GB HBM3, 700.00 W): at
//   N = 1024 32x32 0.72x the pulled-halo kernel it replaces at C54 and 0.84x
//   at C27, 0.80x / 0.59x the layer chain of the same call. The pointwise
//   layers take ~60% of the time at C54, the depthwise ~20%; a row
//   prefetch in the depthwise and four columns a thread ran slower (spills
//   at the 128 registers of 448 threads).
//
// Weights arrive packed in one buffer in the TPU kernel's operand order
// (_flat_fp_operands; kernels/megakernel.py::pack_weights): every matrix and
// vector zero-padded, the dot depth to a multiple of 4 and the output
// channels to a multiple of 8, so every piece is one contiguous run of
// 16-byte units. Arithmetic is fp32 FFMA on the CUDA cores (no TF32).
#include "cluster.cuh"
#include "common.cuh"

using namespace essr;

namespace {

constexpr int MAX_THREADS = 448;

__host__ __device__ inline int round8(int c) { return (c + 7) & ~7; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

struct Args {
  const float *x, *w;
  float* out;
  int N, H, W, Cin, C, Cout, n_sfb, rows, pad;
};

// The launch's layout (the same sums as kernels/megakernel.py::WeightLayout
// and _sizing), in floats.
struct Shape {
  int cpi, cp4, cp8, cpo8;   // Cin to 4; C to 4 (dot depth) and 8 (outputs); Cout to 8
  int st;                    // one pixel of a map
  int fpw, dw, pw, rpw;      // pieces: the first 1x1, a 3x3, a C x C 1x1, the recon's 1x1
  int sfb, slot;             // one SFB's pieces; a ring slot
  int map, fa;               // one map of the strip; F and A together (also the output stage)
  __host__ __device__ Shape(int Cin, int C, int Cout, int n_sfb, int rows, int W, int pad) {
    cpi = round4(Cin);
    cp4 = round4(C);
    cp8 = round8(C);
    cpo8 = round8(Cout);
    st = cp8 + pad;
    fpw = cpi * cp8 + cp8;
    dw = 10 * cp8;
    pw = cp4 * cp8 + cp8;
    rpw = cp4 * cpo8 + cpo8;
    sfb = 3 * pw + 2 * dw;
    slot = imax(imax(fpw, dw), imax(rpw, n_sfb > 0 ? pw : 0));
    map = rows * W * st;
    fa = imax(2 * map, round4(rows * W * Cout));
  }
  // F + A | B | HT | HB | two ring slots | the halo mbarrier (4 floats)
  __host__ __device__ size_t smem_floats(int W) const {
    return (size_t)fa + map + 2 * W * st + 2 * slot + 4;
  }
  // Piece q of a patch's walk (first 1x1, first 3x3, per SFB b1 1x1, b1 3x3,
  // b2 1x1, b2 3x3, fuse 1x1, then the recon's 3x3 and 1x1): its float
  // offset in the packed buffer and its length.
  __device__ void piece(int q, int n_sfb, int& off, int& len) const {
    if (q < 2) {
      off = q ? fpw : 0;
      len = q ? dw : fpw;
      return;
    }
    q -= 2;
    const int base = fpw + dw;
    if (q < 5 * n_sfb) {
      const int u = q % 5;
      off = base + (q / 5) * sfb + (u >> 1) * (pw + dw) + (u & 1) * pw;
      len = (u & 1) ? dw : pw;
      return;
    }
    q -= 5 * n_sfb;
    off = base + n_sfb * sfb + q * dw;
    len = q ? rpw : dw;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
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

// Pointwise (1x1) over the first P pixels of `in` (st floats a pixel), kin
// input channels (a multiple of 4) -> cpout output channels (a multiple of 8):
//   acc(p, co..co+7) = sum_{ci < kin} in[p * st + ci] * w[ci * cpout + co], ci ascending
// then epi(p, co, acc[0..3], acc[4..7]); the epilogue adds the bias. A thread
// owns 8 output channels of 4 pixels (pg, pg + P/4, ...); consecutive threads
// take consecutive pixels of one channel group. The loads of the next 4 input
// channels are issued before the FFMA of the current 4.
template <class Epi>
__device__ __forceinline__ void pointwise8(const float* __restrict__ in, int st, int kin,
                                           const float* __restrict__ w, int cpout, int P,
                                           Epi epi) {
  const int ng = cpout >> 3, npg = (P + 3) >> 2;
  for (int item = threadIdx.x; item < ng * npg; item += blockDim.x) {
    const int g = item / npg, pg = item - g * npg;
    const float* src[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) src[k] = in + (pg + k * npg < P ? pg + k * npg : pg) * st;
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
    for (int ci = 0; ci < kin; ci += 4) {
      const int cn = ci + 4 < kin ? ci + 4 : ci;
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

// 3x3 depthwise of a strip: outputs at rows [0, vrows) x columns [0, W)
// from the map `in` (W pixels a row, st floats a pixel), whose row -1 is
// `top` and row `rows` is `bot`: output (i, j) reads in(i + dy - 1,
// j + dx - 1); columns off the patch, and rows from vrows on when vrows <
// rows (past H), read 0. acc in (dy, dx) raster order from 0, then
// epi(i * W + j, co, acc); the epilogue adds the bias (w9 + 9 * cp8). One
// thread per (channel group of 4, pair of adjacent columns, row segment)
// keeps the nine taps and a 3x4 window of inputs in registers and slides it
// down its rows: each input is loaded once per thread, and the two columns'
// sums are independent chains.
template <class Epi>
__device__ __forceinline__ void depthwise_strip(const float* in, const float* top,
                                                const float* bot, int st,
                                                const float* __restrict__ w9, int cp8, int W,
                                                int rows, int vrows, Epi epi) {
  const int ng = cp8 >> 2, pairs = (W + 1) >> 1;
  const int segs = imax(1, imin(vrows, (int)blockDim.x / (ng * pairs)));
  const int seg_rows = (vrows + segs - 1) / segs;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int item = threadIdx.x; item < ng * pairs * segs; item += blockDim.x) {
    const int g = item % ng, rest = item / ng;
    const int jp = rest % pairs, i0 = (rest / pairs) * seg_rows, i1 = imin(vrows, i0 + seg_rows);
    if (i0 >= i1) continue;
    const int j = 2 * jp;                      // this thread's columns: j and j + 1
    const bool two = j + 1 < W;
    const bool ok0 = j > 0, ok2 = j + 1 < W, ok3 = two && j + 2 < W;
    int r = i0 - 1;
    auto row = [&](float4& v0, float4& v1, float4& v2, float4& v3) {
      const float* p = r < 0 ? top : r < vrows ? in + (size_t)r * W * st : r == rows ? bot
                                                                                    : nullptr;
      if (p == nullptr) {
        v0 = v1 = v2 = v3 = zero;
      } else {
        p += j * st + 4 * g;
        v0 = ok0 ? ld4(p - st) : zero;
        v1 = ld4(p);
        v2 = ok2 ? ld4(p + st) : zero;
        v3 = ok3 ? ld4(p + 2 * st) : zero;
      }
      ++r;
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
      epi(i * W + j, 4 * g, s0);
      if (two) epi(i * W + j + 1, 4 * g, s1);
      a0 = b0; a1 = b1; a2 = b2; a3 = b3;
      b0 = c0; b1 = c1; b2 = c2; b3 = c3;
    }
  }
}

// The strip's n = valid * Cin input floats (contiguous in device memory) into
// B, Cin channels a pixel at a stride of st, the channels [Cin, cpi) zero;
// 16 bytes a load where the strip starts on 16 bytes.
__device__ __forceinline__ void load_input(const float* __restrict__ xs, int valid, int Cin,
                                           int cpi, int st, float* B) {
  const int n = valid * Cin;
  int done = 0;
  if ((reinterpret_cast<size_t>(xs) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(xs);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
      const float4 v = __ldg(x4 + i);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = 4 * i + u, p = f / Cin;
        B[p * st + f - p * Cin] = lane(v, u);
      }
    }
    done = n & ~3;
  }
  for (int f = done + threadIdx.x; f < n; f += blockDim.x) {
    const int p = f / Cin;
    B[p * st + f - p * Cin] = __ldg(xs + f);
  }
  const int pad = cpi - Cin;
  for (int i = threadIdx.x; i < valid * pad; i += blockDim.x) {
    const int p = i / pad;
    B[p * st + Cin + i - p * pad] = 0.f;
  }
}

// n floats from shared memory to device memory, 16 bytes a store where the
// destination starts on 16 bytes.
__device__ __forceinline__ void store_output(const float* S, float* __restrict__ dst, int n) {
  int done = 0;
  if ((reinterpret_cast<size_t>(dst) & 15) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(S)[i];
    done = n & ~3;
  }
  for (int f = done + threadIdx.x; f < n; f += blockDim.x) dst[f] = S[f];
}

__global__ void __launch_bounds__(MAX_THREADS, 1) mega_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), cs = (int)cl.num_blocks();
  const int H = a.H, W = a.W, R = a.rows, Cout = a.Cout;
  const Shape s(a.Cin, a.C, Cout, a.n_sfb, R, W, a.pad);
  const int st = s.st, cp8 = s.cp8;
  const int r0 = rank * R;
  const int vrows = imax(0, imin(H - r0, R));
  const int valid = vrows * W;                 // strip pixels inside the patch
  const bool active = valid > 0;
  const int row_bytes = W * st * (int)sizeof(float);

  float* F = sm;                               // the running feature, the SFB shortcut
  float* A = F + s.map;                        // pointwise outputs
  float* B = sm + s.fa;                        // depthwise outputs; on entry the input
  float* HT = B + s.map;                       // halo row above the strip
  float* HB = HT + W * st;                     // halo row below
  float* ring = HB + W * st;                   // two slots of s.slot floats
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 2 * s.slot);   // halo rows landed
  float* stage = F;                            // the recon's output, unpadded (F and A)
  const unsigned incoming = halo_bytes(rank, cs, r0, R, H, row_bytes);
  unsigned parity = 0;

  // piece j of this block's walk (patch j / np, piece j % np) goes to slot j & 1
  const int np = 4 + 5 * a.n_sfb;
  const int n0 = blockIdx.x / cs, dn = gridDim.x / cs;
  const long long total = n0 < a.N ? ((long long)(a.N - 1 - n0) / dn + 1) * np : 0;
  long long j = 0;
  auto fetch = [&](long long q) {
    if (q < total) {
      int off, len;
      s.piece((int)(q % np), a.n_sfb, off, len);
      float* dst = ring + (q & 1) * s.slot;
      for (int i = threadIdx.x; i < len / 4; i += blockDim.x)
        cp_async16(dst + 4 * i, a.w + off + 4 * i);
    }
    cp_commit();
  };
  // the next layer's weights: wait for them, then (the barrier has freed
  // the other slot) start the copy of the layer after it
  auto next = [&]() -> const float* {
    cp_wait_all();
    __syncthreads();
    fetch(j + 1);
    return ring + (j++ & 1) * s.slot;
  };
  // a pointwise layer in -> out (C channels), + bias, ReLU where asked
  auto pointwise_layer = [&](const float* in, int kin, float* out, bool relu) {
    const float* w = next();
    const float* b = w + kin * cp8;
    if (active)
      pointwise8(in, st, kin, w, cp8, valid, [&](int p, int co, float4 lo, float4 hi) {
        lo = add4(lo, ld4(b + co));
        hi = add4(hi, ld4(b + co + 4));
        float* d = out + p * st + co;
        st4(d, relu ? relu4(lo) : lo);
        st4(d + 4, relu ? relu4(hi) : hi);
      });
  };
  // a depthwise layer on the map `in`: push its halo rows once every block
  // has read the last layer's, wait for mine to land, run, and say that my
  // halo rows are read
  auto depthwise_layer = [&](const float* in, auto epi) {
    fence_proxy_async();                       // `in`'s rows, for the bulk copies
    const float* w = next();                   // the barrier also completes `in`
    if (threadIdx.x == 0) mbar_arrive_expect(bar, incoming);
    cluster_wait();
    if (active && threadIdx.x == 0)
      push_halo_bulk(reinterpret_cast<const char*>(in),
                     reinterpret_cast<const char*>(in + (size_t)(R - 1) * W * st),
                     reinterpret_cast<char*>(HT), reinterpret_cast<char*>(HB), bar, rank, cs,
                     r0, R, H, row_bytes);
    mbar_wait(bar, parity);
    parity ^= 1;
    if (active) {
      const float* b = w + 9 * cp8;
      depthwise_strip(in, HT, HB, st, w, cp8, W, R, vrows,
                      [&](int q, int co, float4 v) { epi(q, co, add4(v, ld4(b + co))); });
    }
    if (threadIdx.x == 0) bulk_wait_read();    // before `in` is written again
    cluster_arrive_relaxed();
  };

  // the halo rows no neighbour fills read 0 (the patch border, rows past H)
  for (int i = threadIdx.x; i < 2 * W * st; i += blockDim.x) HT[i] = 0.f;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  fetch(0);
  cluster_arrive();                            // matched by the wait before the first push
  for (int n = n0; n < a.N; n += dn) {
    const size_t strip = ((size_t)n * H + r0) * W;   // first pixel of the strip

    // first: BSConv Cin -> C, no ReLU, into F
    if (active) load_input(a.x + strip * a.Cin, valid, a.Cin, s.cpi, st, B);
    pointwise_layer(B, s.cpi, A, false);
    depthwise_layer(A, [&](int q, int co, float4 v) { st4(F + q * st + co, v); });

    // each SFB: relu(BSConv) -> relu(BSConv) -> + F -> 1x1 fuse -> ReLU, into F
    for (int sfb = 0; sfb < a.n_sfb; ++sfb) {
      pointwise_layer(F, s.cp4, A, false);
      depthwise_layer(A, [&](int q, int co, float4 v) { st4(B + q * st + co, relu4(v)); });
      pointwise_layer(B, s.cp4, A, false);
      depthwise_layer(A, [&](int q, int co, float4 v) {
        st4(B + q * st + co, add4(relu4(v), ld4(F + q * st + co)));
      });
      pointwise_layer(B, s.cp4, F, true);
    }

    // recon: 3x3 depthwise + bias -> 1x1 C -> Cout + bias, staged, to device memory
    depthwise_layer(F, [&](int q, int co, float4 v) { st4(B + q * st + co, v); });
    const float* w = next();
    const float* b = w + s.cp4 * s.cpo8;
    const bool vec = (Cout & 3) == 0;
    if (active)
      pointwise8(B, st, s.cp4, w, s.cpo8, valid, [&](int p, int co, float4 lo, float4 hi) {
        lo = add4(lo, ld4(b + co));
        hi = add4(hi, ld4(b + co + 4));
        float* px = stage + p * Cout;
        if (vec) {
          if (co < Cout) st4(px + co, lo);
          if (co + 4 < Cout) st4(px + co + 4, hi);
        } else {
          store4(px, co, Cout, lo);
          store4(px, co + 4, Cout, hi);
        }
      });
    __syncthreads();
    if (active) store_output(stage, a.out + strip * Cout, valid * Cout);
  }
  cluster_wait();                              // matches the last arrive
  cp_wait_all();
}

}  // namespace

// Dynamic shared memory of one block, in bytes (kernels/megakernel.py::
// group_report states the same).
extern "C" long long mega_smem_bytes(int W, int Cin, int C, int Cout, int n_sfb, int rows,
                                     int pad) {
  return (long long)(Shape(Cin, C, Cout, n_sfb, rows, W, pad).smem_floats(W) * sizeof(float));
}

// Runs the chain on `stream` as a persistent grid of as many clusters as the
// card holds at once (at most N). Returns the launch's CUDA error;
// cudaErrorInvalidValue for a launch shape the kernel does not take,
// cudaErrorLaunchOutOfResources when no cluster of this shape fits the card.
extern "C" int mega_forward(const float* x, const float* w, float* out, int N, int H, int W,
                            int Cin, int C, int Cout, int n_sfb, int rows, int cluster,
                            int threads, int pad, void* stream) {
  if (rows < 1 || (long long)rows * cluster < H || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0 || (pad != 0 && pad != 4))
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, out, N, H, W, Cin, C, Cout, n_sfb, rows, pad};
  ClusterLaunch<Args> launch(mega_kernel, mega_smem_bytes(W, Cin, C, Cout, n_sfb, rows, pad),
                             cluster, threads, static_cast<cudaStream_t>(stream));
  return launch.launch(a, N);
}

// The clusters mega_forward keeps resident for this shape (0 when none fits
// or the query fails), for the sizing report.
extern "C" int mega_resident_clusters(int W, int Cin, int C, int Cout, int n_sfb, int rows,
                                      int cluster, int threads, int pad) {
  ClusterLaunch<Args> launch(mega_kernel, mega_smem_bytes(W, Cin, C, Cout, n_sfb, rows, pad),
                             cluster, threads, nullptr);
  return launch.resident();
}
