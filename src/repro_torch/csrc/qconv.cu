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
// fxp10), 15.7 / 25.2 MB, 0.0047 / 0.0075 ms.
//
// Design: one thread per element, grid-stride.
#include <stdint.h>

#include "common.cuh"
#include "qmath.cuh"

using namespace essr;

namespace {

// ---------------------------------------------------------------------------
// quantize: one thread per element, grid-stride
// ---------------------------------------------------------------------------

template <class T>
__global__ void __launch_bounds__(256) quantize_kernel(const float* __restrict__ x,
                                                       const float* __restrict__ qc,
                                                       T* __restrict__ out, int n) {
  const float a = qc[0], s = qc[1];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    out[i] = requant<T>(__ldg(x + i), a, s);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <class T>
int quantize_launch(const float* x, const float* qc, T* out, int n, void* stream) {
  int grid = 0;
  cudaError_t e = resident_grid(quantize_kernel<T>, 256, 0, (n + 255) / 256, &grid);
  if (e != cudaSuccess) return (int)e;
  quantize_kernel<T><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, qc, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int quantize_forward(const float* x, const float* qc, void* out, int n, int bits,
                                void* stream) {
  if (bits <= 8) return quantize_launch(x, qc, static_cast<int8_t*>(out), n, stream);
  return quantize_launch(x, qc, static_cast<int32_t*>(out), n, stream);
}
