// The QONNX rounding modes as device helpers, shared by every kernel that
// quantizes: B4 (quant_dequant.cu) and B6's fused activation requant
// (quant_grouped_conv.cu), so both round bit-identically.
//
// Each mode matches repro/kernels/quant_dequant.py · `_round_kernel_body`;
// every add and multiply is an explicit _rn intrinsic, so nothing is
// contracted into an FMA.
#pragma once

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

}  // namespace qdq
