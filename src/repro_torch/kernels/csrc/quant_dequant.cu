// B4: fused quantize-dequantize, the QONNX Quant op (repro_torch/kernels/quant_dequant.py).
//
// Replaces the Pallas kernel `_qdq_kernel` of repro/kernels/quant_dequant.py:
//   q = clip(round_mode(x / s + z), lo, hi);  out = (q - z) * s   (or int8 q)
// with s, z per tensor (stride 0) or per last-dim column (stride 1).
//
// Bound on the card: bytes.  One float32 read and one float32 (or int8)
// write per element; the arithmetic is a handful of float ops.  So the
// design moves 16 bytes per access and keeps the integer pipe out of the
// way of the loads:
//   - the geometry is the host plan's (quant_dequant.py · qdq_launch_plan):
//     a scalar head of 0-3 elements brings x onto 16 bytes, the body is
//     read as float4 (U independent 16-byte loads in flight per thread per
//     trip of a grid-stride loop sized to a few waves of SMs), and a
//     scalar tail of 0-3 elements ends it; block 0 takes head and tail.
//     The wrapper allocates the output at x's phase, so the body's stores
//     are 16-byte float4 or 4 int8 codes in one 32-bit word (`ovec`; a
//     plan without it stores element by element);
//   - per-tensor s and z (PER_CH false) are read once per thread, never
//     per element, and never by the host (no synchronisation);
//   - per-channel columns are found once per thread with one modulo and
//     then advanced by adds and a compare (no division in the loop); a
//     vector wraps its columns where cols % 4 != 0;
//   - the index is 32-bit (I = int) below 2^31 elements, 64-bit above;
//   - the division x / s keeps its bits at a lower price: where s is a
//     power of two whose reciprocal is a finite normal float32
//     (qdq::exact_inverse), x * (1 / s) rounds the same real number once,
//     so it is a multiply (qdq::quantize_inv); any other s keeps the IEEE
//     __fdiv_rn.  Every act quantizer of the zoo has such a scale.
//
// Rounding follows the reference exactly: every add and multiply is an
// explicit _rn intrinsic so nothing is contracted into an FMA, and the
// clip propagates NaN as jnp.clip does.  The rounding modes and the clip
// live in qdq_round.cuh, shared with B6's fused requant.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qdq_round.cuh"

using namespace qdq;

namespace {

constexpr int THREADS = 256;     // the plan's threads per block
constexpr int UMAX = 4;          // the most 16-byte loads a thread keeps in flight

// the host plan's geometry (quant_dequant.py · qdq_launch_plan, QDQ_GEO_FIELDS)
struct Geo {
  long long n, nvec;             // elements; float4 vectors of the body
  int cols, head, tail, ovec, unroll, blocks;
};

// one element's code, or its dequantized value
template <int MODE>
__device__ __forceinline__ float qdq1(float v, float sc, float inv, float zp, float lo, float hi,
                                      bool codes) {
  const float q = quantize_inv<MODE>(v, sc, inv, zp, lo, hi);
  return codes ? q : __fmul_rn(__fsub_rn(q, zp), sc);
}

__device__ __forceinline__ uint32_t code_byte(float q) {
  return (uint32_t)(uint8_t)(int8_t)(int)q;       // q is clipped into int8
}

template <typename I, int MODE, bool CODES, bool PER_CH>
__global__ void __launch_bounds__(THREADS)
qdq_kernel(const float* __restrict__ x, const float* __restrict__ s,
           const float* __restrict__ z, void* __restrict__ out, Geo g, int s_stride,
           int z_stride, float lo, float hi) {
  float* outf = static_cast<float*>(out);
  int8_t* out8 = static_cast<int8_t*>(out);
  // per tensor: one read of s and z per thread
  const float s0 = s[0], z0 = z[0], inv0 = exact_inverse(s0);

  // head (elements 0 .. head - 1) and tail (the last `tail`), block 0
  if (blockIdx.x == 0 && (int)threadIdx.x < g.head + g.tail) {
    const int t = threadIdx.x;
    const I i = t < g.head ? (I)t : (I)g.head + 4 * (I)g.nvec + (I)(t - g.head);
    float sc = s0, zp = z0, inv = inv0;
    if (PER_CH) {
      const int c = (int)(i % (I)g.cols);
      sc = s[c * s_stride];
      zp = z[c * z_stride];
      inv = exact_inverse(sc);
    }
    const float v = qdq1<MODE>(x[i], sc, inv, zp, lo, hi, CODES);
    if (CODES)
      out8[i] = (int8_t)(int)v;
    else
      outf[i] = v;
  }

  const float4* xv = reinterpret_cast<const float4*>(x + g.head);
  const I nvec = (I)g.nvec;
  const int U = g.unroll;
  const I sweep = (I)gridDim.x * THREADS * U;            // vectors per trip of the grid
  I v0 = (I)blockIdx.x * THREADS * U + threadIdx.x;
  // per channel: the column of vector v0's first element, and the column
  // steps to the thread's next vector in a trip and to its next trip
  int c0 = 0, dj = 0, dt = 0;
  if (PER_CH) {
    c0 = (int)(((I)g.head + 4 * v0) % (I)g.cols);
    dj = (int)((4LL * THREADS) % g.cols);
    dt = (int)((4 * (long long)sweep) % g.cols);
  }
  for (; v0 < nvec; v0 += sweep) {
    float4 f[UMAX];
#pragma unroll
    for (int j = 0; j < UMAX; ++j) {
      const I v = v0 + (I)j * THREADS;
      if (j < U && v < nvec) f[j] = __ldg(xv + v);
    }
    int c = c0;
#pragma unroll
    for (int j = 0; j < UMAX; ++j) {
      const I v = v0 + (I)j * THREADS;
      if (j < U && v < nvec) {
        const float e[4] = {f[j].x, f[j].y, f[j].z, f[j].w};
        float r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (PER_CH) {
            int ck = c + k;
            while (ck >= g.cols) ck -= g.cols;           // at most 3 turns, at cols < 4
            const float sc = s[ck * s_stride];
            r[k] = qdq1<MODE>(e[k], sc, exact_inverse(sc), z[ck * z_stride], lo, hi, CODES);
          } else {
            r[k] = qdq1<MODE>(e[k], s0, inv0, z0, lo, hi, CODES);
          }
        }
        const I i = (I)g.head + 4 * v;
        if (g.ovec) {
          if (CODES)
            *reinterpret_cast<uint32_t*>(out8 + i) = code_byte(r[0]) | code_byte(r[1]) << 8 |
                                                     code_byte(r[2]) << 16 |
                                                     code_byte(r[3]) << 24;
          else
            *reinterpret_cast<float4*>(outf + i) = make_float4(r[0], r[1], r[2], r[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (CODES)
              out8[i + k] = (int8_t)(int)r[k];
            else
              outf[i + k] = r[k];
          }
        }
      }
      if (PER_CH) {
        c += dj;
        if (c >= g.cols) c -= g.cols;
      }
    }
    if (PER_CH) {
      c0 += dt;
      if (c0 >= g.cols) c0 -= g.cols;
    }
  }
}

template <typename I, int MODE, bool CODES>
void launch_ch(bool per_ch, const Geo& g, cudaStream_t st, const float* x, const float* s,
               const float* z, void* out, int s_stride, int z_stride, float lo, float hi) {
  if (per_ch)
    qdq_kernel<I, MODE, CODES, true><<<g.blocks, THREADS, 0, st>>>(x, s, z, out, g, s_stride,
                                                                    z_stride, lo, hi);
  else
    qdq_kernel<I, MODE, CODES, false><<<g.blocks, THREADS, 0, st>>>(x, s, z, out, g, s_stride,
                                                                     z_stride, lo, hi);
}

template <int MODE>
void launch_mode(bool wide, bool codes, bool per_ch, const Geo& g, cudaStream_t st,
                 const float* x, const float* s, const float* z, void* out, int s_stride,
                 int z_stride, float lo, float hi) {
  if (wide) {
    if (codes)
      launch_ch<long long, MODE, true>(per_ch, g, st, x, s, z, out, s_stride, z_stride, lo, hi);
    else
      launch_ch<long long, MODE, false>(per_ch, g, st, x, s, z, out, s_stride, z_stride, lo, hi);
  } else {
    if (codes)
      launch_ch<int, MODE, true>(per_ch, g, st, x, s, z, out, s_stride, z_stride, lo, hi);
    else
      launch_ch<int, MODE, false>(per_ch, g, st, x, s, z, out, s_stride, z_stride, lo, hi);
  }
}

}  // namespace

// x: n floats viewed as (n / cols, cols); out: n floats, or n int8 codes.
// geo: the plan's QDQ_GEO_FIELDS (n, nvec, cols, head, tail, ovec,
// unroll, blocks, wide).  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int qdq_launch(const float* x, const float* s, const float* z, void* out,
                          const long long* geo, int s_stride, int z_stride, float lo, float hi,
                          int mode, int codes, void* stream) {
  const Geo g{geo[0], geo[1], (int)geo[2], (int)geo[3], (int)geo[4],
              (int)geo[5], (int)geo[6], (int)geo[7]};
  const bool wide = geo[8] != 0;
  if (g.n <= 0) return (int)cudaGetLastError();
  if (g.cols <= 0 || g.unroll < 1 || g.unroll > UMAX || g.blocks < 1 || g.head + g.tail > THREADS)
    return (int)cudaErrorInvalidValue;
  const bool per_ch = s_stride != 0 || z_stride != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case ROUND: launch_mode<ROUND>(wide, codes, per_ch, g, st, x, s, z, out, s_stride, z_stride, lo, hi); break;
    case CEIL: launch_mode<CEIL>(wide, codes, per_ch, g, st, x, s, z, out, s_stride, z_stride, lo, hi); break;
    case FLOOR: launch_mode<FLOOR>(wide, codes, per_ch, g, st, x, s, z, out, s_stride, z_stride, lo, hi); break;
    case UP: launch_mode<UP>(wide, codes, per_ch, g, st, x, s, z, out, s_stride, z_stride, lo, hi); break;
    case DOWN: launch_mode<DOWN>(wide, codes, per_ch, g, st, x, s, z, out, s_stride, z_stride, lo, hi); break;
    case HALF_UP: launch_mode<HALF_UP>(wide, codes, per_ch, g, st, x, s, z, out, s_stride, z_stride, lo, hi); break;
    case HALF_DOWN: launch_mode<HALF_DOWN>(wide, codes, per_ch, g, st, x, s, z, out, s_stride, z_stride, lo, hi); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
