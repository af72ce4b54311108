// B4: fused quantize-dequantize, the QONNX Quant op (repro_torch/kernels/quant_dequant.py).
//
// Replaces the Pallas kernel `_qdq_kernel` of repro/kernels/quant_dequant.py:
//   q = clip(round_mode(x / s + z), lo, hi);  out = (q - z) * s   (or int8 q)
// with s, z per tensor (stride 0) or per last-dim column (stride 1).
//
// Elementwise and bound by bytes: one float read and one float (or int8)
// written per element.  One thread per element in a grid-stride loop; the
// rounding mode and the code output are template parameters, so each
// instantiation is a straight line of float ops.
//
// Rounding follows the reference exactly: the division is IEEE (nvcc's
// default -prec-div=true, and __fdiv_rn spells it out), every add and
// multiply is an explicit _rn intrinsic so nothing is contracted into an
// FMA, and the clip propagates NaN as jnp.clip does.  The rounding modes
// and the clip live in qdq_round.cuh, shared with B6's fused requant.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qdq_round.cuh"

using namespace qdq;

namespace {

template <int MODE, bool CODES>
__global__ void qdq_kernel(const float* __restrict__ x, const float* __restrict__ s,
                           const float* __restrict__ z, void* __restrict__ out,
                           long long n, int cols, int s_stride, int z_stride,
                           float lo, float hi) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const int c = (int)(i % cols);
    const float sc = s[c * s_stride];
    const float zp = z[c * z_stride];
    const float q = quantize<MODE>(x[i], sc, zp, lo, hi);
    if (CODES)
      static_cast<int8_t*>(out)[i] = (int8_t)q;
    else
      static_cast<float*>(out)[i] = __fmul_rn(__fsub_rn(q, zp), sc);
  }
}

template <int MODE>
void launch_mode(bool codes, int blocks, cudaStream_t st, const float* x, const float* s,
                 const float* z, void* out, long long n, int cols, int s_stride,
                 int z_stride, float lo, float hi) {
  if (codes)
    qdq_kernel<MODE, true><<<blocks, 256, 0, st>>>(x, s, z, out, n, cols, s_stride, z_stride, lo, hi);
  else
    qdq_kernel<MODE, false><<<blocks, 256, 0, st>>>(x, s, z, out, n, cols, s_stride, z_stride, lo, hi);
}

}  // namespace

// x: n floats viewed as (n / cols, cols); out: n floats, or n int8 codes.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int qdq_launch(const float* x, const float* s, const float* z, void* out,
                          long long n, int cols, int s_stride, int z_stride, float lo,
                          float hi, int mode, int codes, void* stream) {
  if (n > 0) {
    long long want = (n + 255) / 256;
    const int blocks = (int)(want < 8192 ? want : 8192);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (mode) {
      case ROUND: launch_mode<ROUND>(codes, blocks, st, x, s, z, out, n, cols, s_stride, z_stride, lo, hi); break;
      case CEIL: launch_mode<CEIL>(codes, blocks, st, x, s, z, out, n, cols, s_stride, z_stride, lo, hi); break;
      case FLOOR: launch_mode<FLOOR>(codes, blocks, st, x, s, z, out, n, cols, s_stride, z_stride, lo, hi); break;
      case UP: launch_mode<UP>(codes, blocks, st, x, s, z, out, n, cols, s_stride, z_stride, lo, hi); break;
      case DOWN: launch_mode<DOWN>(codes, blocks, st, x, s, z, out, n, cols, s_stride, z_stride, lo, hi); break;
      case HALF_UP: launch_mode<HALF_UP>(codes, blocks, st, x, s, z, out, n, cols, s_stride, z_stride, lo, hi); break;
      case HALF_DOWN: launch_mode<HALF_DOWN>(codes, blocks, st, x, s, z, out, n, cols, s_stride, z_stride, lo, hi); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
