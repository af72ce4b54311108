// The QONNX rounding modes as device helpers, shared by every kernel that
// quantizes: B4 (quant_dequant.cu) and B6's fused activation requant
// (quant_grouped_conv.cu), so both round bit-identically.
//
// Each mode matches repro/kernels/quant_dequant.py · `_round_kernel_body`;
// every add and multiply is an explicit _rn intrinsic, so nothing is
// contracted into an FMA.
#pragma once

#include <stdint.h>

namespace qdq {

enum Mode { ROUND = 0, CEIL = 1, FLOOR = 2, UP = 3, DOWN = 4, HALF_UP = 5, HALF_DOWN = 6 };

// jnp.sign: +1 / -1, and the argument itself for +-0 and NaN
__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v);
}

template <int MODE>
__device__ __forceinline__ float round_mode(float v) {
  if (MODE == ROUND) return rintf(v);                 // ties to even
  if (MODE == CEIL) return ceilf(v);
  if (MODE == FLOOR) return floorf(v);
  if (MODE == DOWN) return truncf(v);                 // toward zero
  if (MODE == UP) return __fmul_rn(sign_of(v), ceilf(fabsf(v)));
  if (MODE == HALF_UP) return __fmul_rn(sign_of(v), floorf(__fadd_rn(fabsf(v), 0.5f)));
  return __fmul_rn(sign_of(v), ceilf(__fsub_rn(fabsf(v), 0.5f)));   // HALF_DOWN
}

// clip(round_mode(y / qs + qz), lo, hi): the compares let NaN through, as
// jnp.clip does
template <int MODE>
__device__ __forceinline__ float quantize(float y, float qs, float qz, float lo, float hi) {
  float q = round_mode<MODE>(__fadd_rn(__fdiv_rn(y, qs), qz));
  q = q < lo ? lo : q;
  return q > hi ? hi : q;
}

// 1 / qs when qs is a power of two whose reciprocal is a finite normal
// float32, else 0: then y * (1 / qs) and y / qs round the same real number
// y * 2^-e, so quantize_inv multiplies where it may (B6's act requant)
__device__ __forceinline__ float exact_inverse(float qs) {
  const uint32_t b = __float_as_uint(qs);
  const int e = (int)((b >> 23) & 0xFF);              // 1 .. 253: 2^-e normal too
  if ((b & 0x7FFFFF) != 0 || e < 1 || e > 253) return 0.0f;
  return __uint_as_float((b & 0x80000000u) | ((uint32_t)(254 - e) << 23));
}

// quantize with inv = exact_inverse(qs): the same bits
template <int MODE>
__device__ __forceinline__ float quantize_inv(float y, float qs, float inv, float qz, float lo,
                                              float hi) {
  const float t = inv != 0.0f ? __fmul_rn(y, inv) : __fdiv_rn(y, qs);
  float q = round_mode<MODE>(__fadd_rn(t, qz));
  q = q < lo ? lo : q;
  return q > hi ? hi : q;
}

}  // namespace qdq
