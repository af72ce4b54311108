// B3: the integer-only requantization epilogue, as a __device__ helper
// shared by B1 / B2 (quant_matmul.cu) and B5 / B6 (quant_grouped_conv.cu),
// with a 32-bit path (Req32) for B2's int8 body and B6.
//
// Replaces repro/kernels/requant.py · `int_epilogue`, which the reference
// inlines into `_qmm_kernel`, `_qmm4_kernel`, `_gqmm_kernel` and
// `_dw_kernel`; its plain twin is repro_torch/kernels/requant.py ·
// `int_epilogue_plain`.  For an int32 accumulator and an int32 multiplier:
//   p = acc * mult                       (int32, as the reference)
//   p = max(p, 0)                        (relu)
//   no act:  y = float(p) * 2^-shift
//   act:     q = round_shift(p + zp * 2^s, s)   s >= 0
//            q = p * 2^-s + zp                  s < 0 (exact left shift)
//            y = float(clip(q, lo, hi) - zp) * 2^-T_a
// The zero point, the shift and the clip run in int64, and every shift of
// a possibly negative value is written as a multiply, so no step can
// overflow or reach undefined behaviour (a left shift of a negative int,
// or a shift by 32 or more).  The floor quotient `p >> s` is an
// arithmetic shift of an int64 (s <= 62, checked by the wrapper).  The
// last conversion is __int2float_rn and the scale multiply __fmul_rn.
#pragma once

#include <stdint.h>

namespace b3 {

// the QONNX rounding modes, numbered as qdq_round.cuh's (ROUND_TO_ZERO is
// DOWN, mapped by the wrapper)
enum Mode { ROUND = 0, CEIL = 1, FLOOR = 2, UP = 3, DOWN = 4, HALF_UP = 5, HALF_DOWN = 6 };

// IntRequant's fields, in its order, plus the float32 output scale
// (2^-shift without an act Quant, 2^-T_a with one), computed on the host.
struct IntReq {
  int shift, relu, has_act, act_shift, act_zp, act_lo, act_hi, act_out_shift, mode;
  float out_mul;
};

// round(p / 2^s) under `mode`, from the floor decomposition
// p = q * 2^s + r with 0 <= r < 2^s (repro/core/quant_ops.py · round_shift)
__device__ __forceinline__ long long round_shift(long long p, int s, int mode) {
  if (s == 0) return p;
  const long long q = p >> s;
  const long long r = p - q * (1LL << s);
  const long long half = 1LL << (s - 1);
  bool up;
  switch (mode) {
    case FLOOR: up = false; break;
    case CEIL: up = r != 0; break;
    case DOWN: up = r != 0 && p < 0; break;
    case UP: up = r != 0 && p > 0; break;
    case HALF_UP: up = p >= 0 ? r >= half : r > half; break;
    case HALF_DOWN: up = p >= 0 ? r > half : r >= half; break;
    default: up = r > half || (r == half && (q & 1) != 0); break;   // ROUND
  }
  return q + (up ? 1 : 0);
}

__device__ __forceinline__ float int_epilogue(int acc, int mult, const IntReq& rq) {
  // the int32 product of the reference (wrapping, though the lowering's
  // proof keeps it below 2^24)
  int p = (int)(uint32_t)((long long)acc * (long long)mult);
  if (rq.relu && p < 0) p = 0;
  if (!rq.has_act) return __fmul_rn(__int2float_rn(p), rq.out_mul);
  const int s = rq.act_shift;
  long long q;
  if (s >= 0)
    q = round_shift((long long)p + (long long)rq.act_zp * (1LL << s), s, rq.mode);
  else
    q = (long long)p * (1LL << -s) + rq.act_zp;
  q = q < rq.act_lo ? (long long)rq.act_lo : q;
  q = q > rq.act_hi ? (long long)rq.act_hi : q;
  return __fmul_rn(__int2float_rn((int)(q - rq.act_zp)), rq.out_mul);
}

// The 32-bit path of B3 (B2's int8 body, B6): int_epilogue's function
// with an act Quant computed on 32-bit integers, for callers that checked
// that no intermediate can leave int32 -- on the host (make_req32: 0 <=
// act_shift <= 31 and |act_zp · 2^act_shift| < 2^30) and per value
// (fits32: |acc · mult| < 2^30).  The card has no 64-bit integer unit, so
// each int64 shift, compare or add above costs two or more instructions.
struct Req32 {
  IntReq rq;
  int fast;          // the host's half of the 32-bit condition
  int zp_s;          // act_zp · 2^act_shift
  uint32_t mask;     // 2^act_shift - 1
  uint32_t half;     // 2^(act_shift - 1); 1 at act_shift 0, where mask 0 rounds nothing
};

inline Req32 make_req32(const IntReq& rq) {
  Req32 e{};
  e.rq = rq;
  const int sh = rq.act_shift;
  if (rq.has_act && sh >= 0 && sh <= 31) {
    const long long zp_s = (long long)rq.act_zp * (1LL << sh);
    if (zp_s > -(1LL << 30) && zp_s < (1LL << 30)) {
      e.fast = 1;
      e.zp_s = (int)zp_s;
      e.mask = sh == 0 ? 0u : 0xFFFFFFFFu >> (32 - sh);
      e.half = sh == 0 ? 1u : 1u << (sh - 1);
    }
  }
  return e;
}

// the int32 product acc · mult (as int_epilogue wraps it) within 2^30
__device__ __forceinline__ bool fits32(int p) { return (uint32_t)p + (1u << 30) < (1u << 31); }

// int_epilogue of the int32 product p = acc · mult, with an act Quant, on
// 32-bit integers (the caller has checked the ranges), rounding mode MODE
template <int MODE>
__device__ __forceinline__ float int_epilogue32(int p, const Req32& e) {
  const IntReq& rq = e.rq;
  if (rq.relu && p < 0) p = 0;
  const int v = p + e.zp_s;
  int q = v >> rq.act_shift;                            // floor, as round_shift
  const uint32_t r = (uint32_t)v & e.mask;
  bool up;
  switch (MODE) {
    case FLOOR: up = false; break;
    case CEIL: up = r != 0; break;
    case DOWN: up = r != 0 && v < 0; break;
    case UP: up = r != 0 && v > 0; break;
    case HALF_UP: up = v >= 0 ? r >= e.half : r > e.half; break;
    case HALF_DOWN: up = v >= 0 ? r > e.half : r >= e.half; break;
    default: up = r > e.half || (r == e.half && (q & 1) != 0); break;   // ROUND
  }
  q += up ? 1 : 0;
  q = q < rq.act_lo ? rq.act_lo : q;
  q = q > rq.act_hi ? rq.act_hi : q;
  return __fmul_rn(__int2float_rn(q - rq.act_zp), rq.out_mul);
}

}  // namespace b3
