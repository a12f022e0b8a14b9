// Tensor-core dots and the requantize and depthwise steps of the integer
// (PAMS lattice) kernels, shared by the qSFB band walker (qsfb.cu) and the quantized
// megakernel (qmega.cu), so the two cannot drift apart.
//
// The 1x1 dots: mma.sync with A = 16 pixels x 32 bytes of codes and B = the
// transposed weight codes (a row of `ast` bytes per output channel), both
// from shared memory through ldmatrix.
// - int8: mma.sync.m16n8k32.row.col.s32.s8.s8.s32, exact integer arithmetic.
//   The depth pads to a multiple of 32 with zero codes and zero weights.
// - fxp10: mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 on the codes held as
//   floats (qsfb.cu), or m16n8k16 f16 on the codes held as fp16 (qmega.cu,
//   Dot<__half>). Both are exact. Codes and weight codes lie in [-511, 511] (qmax =
//   2^(bits-1) - 1, repro/quant/pams.py:44-45, and the int32 storage of the
//   +-511 codes, :221-222), and TF32 holds every integer up to 2^11 exactly.
//   With K <= 64 every product and every partial sum is an integer of
//   magnitude at most 511^2 * 64 = 16,711,744 < 2^24, which fp32 holds
//   exactly in any order and under any rounding of the accumulator. fp16 also
//   holds every integer up to 2^11 exactly, so the same bound covers it. The
//   epilogue takes the int back with __float2int_rn.
// An operand pixel takes an odd multiple of 16 bytes (operand_stride), so the
// eight rows of one ldmatrix fall on distinct banks.
#pragma once

#include <cuda_fp16.h>
#include <stdint.h>

#include "common.cuh"
#include "qmath.cuh"

namespace essr {

constexpr int NTMAX = 8;           // n-tiles of 8 output channels a dot task holds (C <= 64)
constexpr int FLAT = 1 << 30;      // Map.m of a buffer that is not a ring

__host__ __device__ inline int up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Bytes of one operand pixel (or weight row) holding `bytes` of codes: the
// next multiple of 16, made odd in units of 16.
__host__ __device__ inline int operand_stride(int bytes) {
  const int s = up(bytes, 16);
  return (s / 16) % 2 == 0 ? s + 16 : s;
}

// Pixel p of a stage's region (w pixels a row, rows from r0) in a buffer of
// rows of `len` pixels, `st` bytes a pixel: row slot (r0 + p / w) % m (m =
// FLAT for a buffer whose row 0 is r0), column oc + p % w.
struct Map {
  char* base;
  int r0, w, len, m, oc, st;
  __device__ __forceinline__ char* at(int p) const {
    const int i = p / w, j = p - i * w;
    return base + ((size_t)((r0 + i) % m) * len + oc + j) * st;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const char* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm2(unsigned (&r)[2], const char* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void cp_async16(char* dst, const char* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async8(char* dst, const char* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(char* dst, const char* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// The widest copy unit (16, 8, 4 or 1 bytes) that every row start, the row
// stride and the row length allow.
__device__ __forceinline__ int copy_unit(const void* p, size_t stride, int len) {
  const size_t al = reinterpret_cast<size_t>(p) | stride | (size_t)len;
  return (al & 15) == 0 ? 16 : (al & 7) == 0 ? 8 : (al & 3) == 0 ? 4 : 1;
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What a code type is as a dot operand in shared memory, its accumulator,
// and its tensor-core product d += a . b (A 16 x 32 bytes, B 32 bytes x 8).
template <class T>
struct Dot;

template <>
struct Dot<int8_t> {
  using Op = int8_t;
  using Acc = int;
  static __device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ int value(int acc) { return acc; }
  // four codes (channels k..k+3) as one 4-byte operand unit
  static __device__ __forceinline__ void put4(char* dst, const int (&v)[4]) {
    *reinterpret_cast<unsigned*>(dst) = (unsigned)(v[0] & 0xff) | (unsigned)(v[1] & 0xff) << 8 |
                                        (unsigned)(v[2] & 0xff) << 16 |
                                        (unsigned)(v[3] & 0xff) << 24;
  }
  static __device__ __forceinline__ Op op(int v) { return (Op)v; }
  static __device__ __forceinline__ int code(Op v) { return v; }
};

template <>
struct Dot<int32_t> {
  using Op = float;
  using Acc = float;
  // Exact only while |code| <= 2^11 (TF32 holds the operand) and every sum
  // stays below 2^24: the fxp10 lattice's +-511 codes at K <= 64 (head note).
  static __device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ int value(float acc) { return __float2int_rn(acc); }
  static __device__ __forceinline__ void put4(char* dst, const int (&v)[4]) {
    *reinterpret_cast<float4*>(dst) = make_float4(__int2float_rn(v[0]), __int2float_rn(v[1]),
                                                  __int2float_rn(v[2]), __int2float_rn(v[3]));
  }
  static __device__ __forceinline__ Op op(int v) { return __int2float_rn(v); }
  static __device__ __forceinline__ int code(Op v) { return __float2int_rn(v); }
};

// fxp10 codes held as fp16 (the quantized megakernel's operands): the same
// bound makes mma.sync m16n8k16 f16 exact. fp16 holds every integer up to
// 2^11 exactly, as TF32 does, so the +-511 codes and weight codes are exact
// operands, their products exact in the fp32 accumulator, and every partial
// sum an integer below 511^2 * 64 < 2^24. A k-step (32 bytes) is 16 codes,
// half an fp32 operand's bytes.
template <>
struct Dot<__half> {
  using Op = __half;
  using Acc = float;
  static __device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ int value(float acc) { return __float2int_rn(acc); }
  static __device__ __forceinline__ void put4(char* dst, const int (&v)[4]) {
    __half2* h = reinterpret_cast<__half2*>(dst);
    h[0] = __halves2half2(__int2half_rn(v[0]), __int2half_rn(v[1]));
    h[1] = __halves2half2(__int2half_rn(v[2]), __int2half_rn(v[3]));
  }
  static __device__ __forceinline__ Op op(int v) { return __int2half_rn(v); }
  static __device__ __forceinline__ int code(Op v) { return __half2int_rn(v); }
};

// acc[q][j] += A_q . B(n-tile nt0 + j) for j < ntc <= NT, over ks k-steps of
// 32 bytes. A_q: the 16 pixels whose ldmatrix row this lane addresses in
// arow[q]; B: the transposed code weights `wt` (a row of ast bytes per
// output channel). One ldmatrix.x4 brings an A tile, one more the B halves
// of two n-tiles.
template <class T, int NA, int NT>
__device__ __forceinline__ void tile_dot(const char* (&arow)[NA], const char* wt, int ast,
                                         int ks, int nt0, int ntc,
                                         typename Dot<T>::Acc (&acc)[NA][NT][4]) {
  const int lane = threadIdx.x & 31;
  // this lane's B row: n-tile nt0 + (lane >> 4), k half (lane >> 3) & 1
  const char* brow = wt + (size_t)((nt0 + (lane >> 4)) * 8 + (lane & 7)) * ast +
                     ((lane >> 3) & 1) * 16;
  for (int k = 0; k < ks; ++k) {
    // every fragment of the k-step first, then its products: the loads'
    // latencies overlap instead of queueing behind each product
    unsigned a[NA][4], b[NT / 2][4];
#pragma unroll
    for (int q = 0; q < NA; ++q) ldsm4(a[q], arow[q] + 32 * k);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      const char* bp = brow + (size_t)j * 8 * ast + 32 * k;
      if (j + 1 < ntc) {
        ldsm4(b[j / 2], bp);
      } else if (j < ntc) {
        unsigned h[2];
        ldsm2(h, bp);
        b[j / 2][0] = h[0];
        b[j / 2][1] = h[1];
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < ntc)
#pragma unroll
        for (int q = 0; q < NA; ++q)
          Dot<T>::mma(acc[q][j], a[q], b[j / 2][2 * (j & 1)], b[j / 2][2 * (j & 1) + 1]);
  }
}

// A dot stage over the P pixels of the regions a[0..NA): warps take tasks
// (an M-tile of 16 pixels, a group of n-tiles), enough for every warp where
// the pixels allow. Then, for each pixel p < P of a task and each of its
// channel pairs co, co + 1: epi(px(p), co, v), v[q] the two integer sums of
// a[q]. The shape s gives the code bytes (sz), the output channels padded to
// 8 (cp8), the dot depth in codes (kp) and the bytes of a weight row (ast).
// A task holds at most NT n-tiles (NT even): its accumulators take NA * NT *
// 4 registers a lane.
template <class T, int NA, int NT = NTMAX, class Sh, class Px, class Epi>
__device__ __forceinline__ void dot_stage(const Map (&a)[NA], int P, const char* wt, const Sh& s,
                                          Px px, Epi epi) {
  using Acc = typename Dot<T>::Acc;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int mtn = (P + 15) >> 4, ntn = s.cp8 >> 3;
  int groups = imax(1, imin((nwarps + mtn - 1) / imax(mtn, 1), (ntn + 1) >> 1));
  groups = imax(groups, (ntn + NT - 1) / NT);
  const int ntg = up((ntn + groups - 1) / groups, 2);
  groups = (ntn + ntg - 1) / ntg;
  const int ks = s.kp * s.sz / 32;
  const int g = lane >> 2, t = lane & 3;
  for (int task = warp; task < mtn * groups; task += nwarps) {
    const int mt = task / groups, gi = task - mt * groups;
    const int m0 = mt * 16, nt0 = gi * ntg, ntc = imin(ntg, ntn - nt0);
    const int pl = imin(m0 + (lane & 7) + ((lane >> 3) & 1) * 8, P - 1);
    const char* arow[NA];
#pragma unroll
    for (int q = 0; q < NA; ++q) arow[q] = a[q].at(pl) + (lane >> 4) * 16;
    Acc acc[NA][NT][4];
#pragma unroll
    for (int q = 0; q < NA; ++q)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][j][e] = 0;
    tile_dot<T, NA, NT>(arow, wt, s.ast, ks, nt0, ntc, acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + g + 8 * h;
      if (p >= P) continue;
      char* dst = px(p);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < ntc) {
          int v[NA][2];
#pragma unroll
          for (int q = 0; q < NA; ++q) {
            v[q][0] = Dot<T>::value(acc[q][j][2 * h]);
            v[q][1] = Dot<T>::value(acc[q][j][2 * h + 1]);
          }
          epi(dst, (nt0 + j) * 8 + 2 * t, v);
        }
      }
    }
  }
}

// requant(relu(v)) of qmath.cuh, bit for bit: a value that the ReLU makes 0
// is code 0 for any step s and any clip a >= 0 (a site's clip is |alpha| +
// 1e-8, kernels/qconv.py act_qconsts): 0 clips to 0, 0 / s is +-0 (or NaN,
// which converts to 0). So the division runs only for v > 0. A zero
// dividend would take __fdiv_rn's slow path, and the ReLU zeroes about half
// of every site's values.
template <class T>
__device__ __forceinline__ int relu_requant(float v, float a, float s) {
  return v > 0.f ? (int)requant<T>(v, a, s) : 0;
}

__device__ __forceinline__ void mac4(float4& s, float4 v, float4 w) {
  s.x = mul_add_rn(s.x, v.x, w.x);
  s.y = mul_add_rn(s.y, v.y, w.y);
  s.z = mul_add_rn(s.z, v.z, w.z);
  s.w = mul_add_rn(s.w, v.w, w.w);
}

}  // namespace essr
