// The integer bodies' staging of x, shared by B2's int8 tensor-core body
// (quant_matmul.cu) and the integer bodies of B5 / B6
// (quant_grouped_conv.cu): one copy of the helper, one set of bits.
//
// An integer body stages each float32 x as round(x / div), the division an
// IEEE __fdiv_rn (the reference divides x by the activation scale, whose
// quotients the lowering proved to be the integers q - z) and the rounding
// __float2int_rn.  Three modes give those bits, chosen once per launch on
// the host (repro_torch/kernels/quant_matmul.py · `staging`, which also
// emulates them on the CPU: `staged_values`):
//   RECIPROCAL  div a power of two whose reciprocal `mul` is a finite
//               normal float32: x * mul rounds the same real number
//               x * 2^-e as x / div, so one multiply;
//   QUOTIENT    any other div whose reciprocal `rcp` = float32(1 / div) is
//               a finite normal float32: the guess n = rint(x * rcp) is the
//               staged value wherever x / div is exactly n, which one FMA
//               checks (n * div - x == 0, exact: a nonzero difference of
//               such floats is at least 2^-149), since __fdiv_rn returns n
//               there; where the check fails x is divided.  Every x of the
//               integer path is such a multiple;
//   DIVISION    anything else: __fdiv_rn for every x.
#pragma once

#include <stdint.h>

namespace stg {

enum Mode { RECIPROCAL = 0, QUOTIENT = 1, DIVISION = 2 };

struct Stage {
  float div, mul, rcp;
  int mode;
};

// the launch's staging; mul is read in RECIPROCAL mode only
inline Stage make_stage(float div, float mul, int mode) {
  return Stage{div, mul, 1.0f / div, mode};
}

__device__ __forceinline__ float4 divide4(float4 f, float div) {
  return make_float4(__fdiv_rn(f.x, div), __fdiv_rn(f.y, div), __fdiv_rn(f.z, div),
                     __fdiv_rn(f.w, div));
}

// four elements' values before the final rounding: x * mul (RECIPROCAL),
// the guess rint(x * rcp) (QUOTIENT; `exact` turns false where it is not
// x / div) or x / div (DIVISION)
__device__ __forceinline__ float4 quotients4(float4 f, const Stage& st, bool& exact) {
  if (st.mode == RECIPROCAL)
    return make_float4(__fmul_rn(f.x, st.mul), __fmul_rn(f.y, st.mul), __fmul_rn(f.z, st.mul),
                       __fmul_rn(f.w, st.mul));
  if (st.mode == QUOTIENT) {
    const float4 n = make_float4(rintf(__fmul_rn(f.x, st.rcp)), rintf(__fmul_rn(f.y, st.rcp)),
                                 rintf(__fmul_rn(f.z, st.rcp)), rintf(__fmul_rn(f.w, st.rcp)));
    exact &= (__fmaf_rn(n.x, st.div, -f.x) == 0.f) & (__fmaf_rn(n.y, st.div, -f.y) == 0.f) &
             (__fmaf_rn(n.z, st.div, -f.z) == 0.f) & (__fmaf_rn(n.w, st.div, -f.w) == 0.f);
    return n;
  }
  return divide4(f, st.div);
}

// four elements' staged integers
__device__ __forceinline__ int4 stage_int4(float4 f, const Stage& st) {
  bool exact = true;
  float4 q = quotients4(f, st, exact);
  if (!exact) q = divide4(f, st.div);
  return make_int4(__float2int_rn(q.x), __float2int_rn(q.y), __float2int_rn(q.z),
                   __float2int_rn(q.w));
}

// one element's staged integer
__device__ __forceinline__ int stage_int(float x, const Stage& st) {
  if (st.mode == RECIPROCAL) return __float2int_rn(__fmul_rn(x, st.mul));
  if (st.mode == QUOTIENT) {
    const float n = rintf(__fmul_rn(x, st.rcp));
    if (__fmaf_rn(n, st.div, -x) == 0.f) return __float2int_rn(n);
  }
  return __float2int_rn(__fdiv_rn(x, st.div));
}

}  // namespace stg
