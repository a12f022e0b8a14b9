// Per-pixel arithmetic of the integer (PAMS lattice) kernels, shared by the
// per-layer kernels (qconv.cu, qsfb.cu, dsconv.cu's qDSConv) and the
// quantized megakernel (qmega.cu), so they cannot drift apart.
//
// Contract: bit for bit the plain versions in repro_torch/kernels/ref.py.
// Codes are integers, so a one-ulp difference in one fp step flips a code
// that lies on a .5 boundary, and the flip grows down the chain. Every fp
// multiply, add and divide here is an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn), which nvcc never contracts into an FMA;
// callers keep the plain version's order: dequant (float(acc) * scale) +
// bias; depthwise taps in (dy, dx) raster order from 0, then + bias; qSFB's
// combine ((acc_y * sy) + (acc_x * sx)) + b; qDSConv's fp 1x1 an ordered sum
// over input channels 0..C-1 from 0; requantize clip, then divide, then
// rintf (half to even, as torch.round). Integer dots are exact in any order:
// __dp4a over groups of 4 int8 channels, int32 multiply-add for fxp10 codes
// (|sum| <= 511 * 511 * 64 < 2^31).
//
// Code weights in shared memory (stage_codes): for int8 one 4-byte word per
// (group of 4 input channels, output channel), word (k / 4) * cop + co
// holding input channels k..k+3 (the operand of one __dp4a); for int32 row
// k * cop + co. Either way one 16-byte load brings the weights of 4 output
// channels.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace essr {

template <class T>
__device__ __forceinline__ T requant(float v, float a, float s) {
  return static_cast<T>(static_cast<int>(rintf(__fdiv_rn(fminf(fmaxf(v, -a), a), s))));
}

__device__ __forceinline__ float dequant(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

// acc + v * w, two rounded ops: one depthwise tap, one step of an ordered
// fp 1x1.
__device__ __forceinline__ float mul_add_rn(float acc, float v, float w) {
  return __fadd_rn(acc, __fmul_rn(v, w));
}

// qSFB's fuse: ((acc_y * sy) + (acc_x * sx)) + b.
__device__ __forceinline__ float fuse_combine(int ay, int ax, float sy, float sx, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn(ay), sy), __fmul_rn(__int2float_rn(ax), sx)),
                   b);
}

// acc[k] = sum_ci x[ci] * w(ci, co0 + k), k < 4, over cpi (a multiple of 4)
// input channels; w as staged by stage_codes. One 16-byte load brings the
// weights of the 4 output channels (co0 is a multiple of 4).
__device__ __forceinline__ void dot4(const int8_t* x, const int8_t* w, int cpi, int cpo,
                                     int co0, int acc[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = 0;
  for (int ci = 0; ci < cpi; ci += 4) {
    const int xv = *reinterpret_cast<const int*>(x + ci);
    const int4 wv = *reinterpret_cast<const int4*>(w + 4 * ((ci >> 2) * cpo + co0));
    acc[0] = __dp4a(xv, wv.x, acc[0]);
    acc[1] = __dp4a(xv, wv.y, acc[1]);
    acc[2] = __dp4a(xv, wv.z, acc[2]);
    acc[3] = __dp4a(xv, wv.w, acc[3]);
  }
}

__device__ __forceinline__ void dot4(const int32_t* x, const int32_t* w, int cpi, int cpo,
                                     int co0, int acc[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = 0;
  for (int ci = 0; ci < cpi; ++ci) {
    const int xv = x[ci];
    const int4 wv = *reinterpret_cast<const int4*>(w + ci * cpo + co0);
    acc[0] += xv * wv.x;
    acc[1] += xv * wv.y;
    acc[2] += xv * wv.z;
    acc[3] += xv * wv.w;
  }
}

// Code weights w (K x Co, row-major) into shared memory, zero-padded to
// kp x cop, in the layout dot4 reads (see the head of this file).
__device__ __forceinline__ void stage_codes(const int8_t* __restrict__ w, int K, int Co, int kp,
                                            int cop, int8_t* dst) {
  for (int i = threadIdx.x; i < kp * cop; i += blockDim.x) {
    const int j = i & 3, word = i >> 2;
    const int kg = word / cop, co = word - kg * cop, k = 4 * kg + j;
    dst[i] = (k < K && co < Co) ? w[(size_t)k * Co + co] : int8_t(0);
  }
}

__device__ __forceinline__ void stage_codes(const int32_t* __restrict__ w, int K, int Co,
                                            int kp, int cop, int32_t* dst) {
  for (int i = threadIdx.x; i < kp * cop; i += blockDim.x) {
    const int k = i / cop, co = i - k * cop;
    dst[i] = (k < K && co < Co) ? __ldg(w + (size_t)k * Co + co) : 0;
  }
}

}  // namespace essr
