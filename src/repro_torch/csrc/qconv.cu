// Integer-domain quantized ESSR kernel quantize (PAMS serving path, paper
// Sec. IV-H): fp32 NHWC -> the lattice codes of the chain's input site, as
// int8_t ("int8") or int32_t ("fxp10"). The C entry takes an int `bits`: 8
// picks int8_t codes, anything wider int32_t. The chain's other kernels are
// band walkers of their own: qBSConv in bsconv.cu (the BSConv walker's codes
// datapath), qSFB in qsfb.cu, qDSConv in dsconv.cu (the DSConv walker's
// codes datapath).
//
// Replaces the TPU kernel repro/kernels/qconv.py::quantize_fused (pallas_call
// at qconv.py:156).
//
// Arithmetic contract: bit for bit kernels/ref.py::quantize_ref, through
// qmath.cuh's requant (clip, then __fdiv_rn, then rintf).
//
// What bounds it, at N = 1024 C54 32x32 patches (x4) on an H100 SXM
// (3.35 TB/s): the bytes it moves, 4 in and 1 / 4 out an element (int8 /
// fxp10), 15.7 / 25.2 MB, 0.0047 / 0.0075 ms. A ~5 us kernel, about what
// a launch costs the host, so resident_grid's queries are cached
// (common.cuh).
//
// Design: a stream of 16-byte loads. Each thread takes UNROLL groups of 4
// consecutive elements a step, all UNROLL float4 loads issued before any
// is used (64 bytes in flight a thread), and writes each group's 4 codes as
// one char4 (int8) or int4 (fxp10) store; consecutive threads take
// consecutive groups. A scalar head covers the elements before x's first
// 16-byte boundary (a storage offset that is not a multiple of 4 floats)
// and a scalar tail the last n % 4; where the head is not empty the groups'
// codes land off the store's alignment and go out one by one. A clipped 0
// (or -0) is code 0 without a division: __fdiv_rn takes its slow path on a
// zero dividend, in every warp that holds one (letterboxed video is full of
// zeros). Every lane still divides, a zero's lane s by s (the fast path), so
// no warp splits, and the code is bit-equal to requant's.
#include <stdint.h>

#include "common.cuh"
#include "qmath.cuh"

using namespace essr;

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

// requant's code (qmath.cuh: clip, __fdiv_rn, rintf), with a clipped +-0
// taken as code 0 and never divided.
template <class T>
__device__ __forceinline__ T code(float v, float a, float s) {
  const float c = fminf(fmaxf(v, -a), a);
  const int q = static_cast<int>(rintf(__fdiv_rn(c == 0.f ? s : c, s)));
  return static_cast<T>(c == 0.f ? 0 : q);
}

__device__ __forceinline__ void store_codes4(int8_t* p, float4 v, float a, float s) {
  *reinterpret_cast<char4*>(p) = make_char4(code<int8_t>(v.x, a, s), code<int8_t>(v.y, a, s),
                                            code<int8_t>(v.z, a, s), code<int8_t>(v.w, a, s));
}

__device__ __forceinline__ void store_codes4(int32_t* p, float4 v, float a, float s) {
  *reinterpret_cast<int4*>(p) = make_int4(code<int32_t>(v.x, a, s), code<int32_t>(v.y, a, s),
                                          code<int32_t>(v.z, a, s), code<int32_t>(v.w, a, s));
}

// out[i] for i in [0, n): groups of 4 from `head` on (x + head is 16-byte
// aligned), the head's and the tail's elements by block 0's first threads.
// VEC_OUT: out + head is aligned for one 4-code store.
template <class T, bool VEC_OUT>
__global__ void __launch_bounds__(THREADS) quantize_kernel(const float* __restrict__ x,
                                                           const float* __restrict__ qc,
                                                           T* __restrict__ out, int n,
                                                           int head) {
  const float a = qc[0], s = qc[1];
  const int groups = (n - head) >> 2, tail = (n - head) & 3;
  if (blockIdx.x == 0 && threadIdx.x < head + tail) {
    const int i = threadIdx.x < head ? threadIdx.x : head + 4 * groups + threadIdx.x - head;
    out[i] = code<T>(__ldg(x + i), a, s);
  }
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  T* o = out + head;
  const int step = gridDim.x * THREADS * UNROLL;
  for (int g0 = blockIdx.x * THREADS * UNROLL + threadIdx.x; g0 < groups; g0 += step) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int g = g0 + u * THREADS;
      if (g < groups) v[u] = __ldg(xv + g);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int g = g0 + u * THREADS;
      if (g >= groups) break;
      if (VEC_OUT) {
        store_codes4(o + 4 * g, v[u], a, s);
      } else {
        o[4 * g] = code<T>(v[u].x, a, s);
        o[4 * g + 1] = code<T>(v[u].y, a, s);
        o[4 * g + 2] = code<T>(v[u].z, a, s);
        o[4 * g + 3] = code<T>(v[u].w, a, s);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <class T, bool VEC_OUT>
int quantize_launch(const float* x, const float* qc, T* out, int n, int head, void* stream) {
  const long long groups = (n - head) / 4;
  const long long tiles = (groups + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  int grid = 0;
  cudaError_t e = resident_grid(quantize_kernel<T, VEC_OUT>, THREADS, 0,
                                tiles > 0 ? tiles : 1, &grid);
  if (e != cudaSuccess) return (int)e;
  quantize_kernel<T, VEC_OUT><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, qc, out, n, head);
  return (int)cudaGetLastError();
}

template <class T>
int quantize_dispatch(const float* x, const float* qc, T* out, int n, void* stream) {
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x);
  int head = (int)((16 - (ax & 15)) & 15) / (int)sizeof(float);
  if (head > n) head = n;
  const uintptr_t ao = reinterpret_cast<uintptr_t>(out + head);
  if (ao % (4 * sizeof(T)) == 0)
    return quantize_launch<T, true>(x, qc, out, n, head, stream);
  return quantize_launch<T, false>(x, qc, out, n, head, stream);
}

}  // namespace

// Codes of n fp32 values on `stream`: as many blocks as are resident at
// once, at most one 1,024-group tile each. Returns the launch's CUDA error.
extern "C" int quantize_forward(const float* x, const float* qc, void* out, int n, int bits,
                                void* stream) {
  if (bits <= 8) return quantize_dispatch(x, qc, static_cast<int8_t*>(out), n, stream);
  return quantize_dispatch(x, qc, static_cast<int32_t*>(out), n, stream);
}
