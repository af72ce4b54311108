// B5 / B6: grouped and depthwise quantized convolution
// (repro_torch/kernels/quant_grouped_conv.py).
//
// B5 replaces the Pallas kernel `_gqmm_kernel` (`quant_grouped_matmul`) of
// repro/kernels/quant_grouped_conv.py:
//   out[g, m, n] = (sum_k x[g, m, k] * w[g, k, n]) * s[g*Ng + n]  [+ bias[g*Ng + n]]
// x (G, M, Kg) float32 with any group and row strides (unit stride along
// Kg), so the conv wrapper passes a view of its im2col matrix; w (G, Kg, Ng)
// int8, or (G, Kg/2, Ng) with row 2r of each group in the low nibble and
// 2r+1 in the high nibble, both sign-extended; s scalar (stride 0) or per
// output channel; out (G, M, Ng) with any group and row strides, so the
// conv wrapper receives its (M, G*Ng) matrix without a transpose.
//
// B5 is B1's tiling with the group as grid axis z, each block owning a
// 32x32 output tile of one group and walking that group's Kg itself (the
// TPU grid carried K in VMEM scratch, which blocks running in any order
// cannot share).  The int4 variant unpacks nibbles while it stages the
// weight tile, so device memory serves the packed bytes.  Its three bodies
// are B1's (quant_matmul.cu): EPI_F32 a true float32 dot (FMA on the CUDA
// cores, no TF32 or tensor cores), then (acc * s) rounded, + bias; EPI_I32
// an int32 dot of the integer values of x / in_div (__fdiv_rn, then
// __float2int_rn while staging; IMAD), then float(acc) * s, + bias; EPI_B3
// the same dot, then the integer epilogue B3 (int_epilogue.cuh) with s
// holding int32 multipliers, + bias.  On this card it is
// bound by the FMA / IMAD rate for wide Kg and by the bytes of x and out
// for narrow Kg; at moderate group counts M is large, so the grid fills
// the SMs.
//
// B6 replaces `_dw_kernel` (`quant_depthwise_conv2d`):
//   acc[n, c, oh, ow] = sum_{i, j} x[n, c, oh*sh - pt + i*dh, ow*sw - pl + j*dw] * w[i*kW + j, c]
//   y = acc * s[c] (rounded); y += b[c]; y = max(y, 0); y = (q - qz) * qs,
//   q = clip(round_mode(y / qs + qz), lo, hi)       (each step optional)
// One thread per output element reads its kH*kW taps straight from the
// NCHW input and masks the padding itself, so the reference's (T, M, C)
// tap tensor never exists.  A block works inside one (n, c) plane, so the
// index math per output is two 32-bit operations and the channel's
// constants are shared by the block.  The taps are summed in (kh, kw)
// row-major order with separately rounded products (no FMA), the order of
// the plain twin, and the epilogue uses the reference's order with _rn
// intrinsics; the requant is qdq_round.cuh's, the same code as B4.  B6 is
// bound by bytes: one read of x and one write of the output (the kH*kW
// re-reads of neighbouring taps come from L1/L2), against about 2*kH*kW
// flops per output element.  On the integer path (EPI_I32 / EPI_B3, as
// B5's) each tap is converted to its integer value as it is read (after
// __fdiv_rn by in_div unless that is 1), the products are summed in int32,
// and EPI_B3 replaces the whole dequant / ReLU / requant epilogue by B3, as
// the reference's `_dw_kernel` does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_epilogue.cuh"
#include "qdq_round.cuh"

using namespace qdq;

namespace {

constexpr int BM = 32, BN = 32, BK = 32, THREADS = 256;
enum Epi { EPI_F32 = 0, EPI_I32 = 1, EPI_B3 = 2 };

template <int EPI>
struct Acc { using T = int; };
template <>
struct Acc<EPI_F32> { using T = float; };

// one input element: float32 as it is, or its integer value
template <int EPI>
__device__ __forceinline__ typename Acc<EPI>::T stage_x(float v, float in_div) {
  if (EPI == EPI_F32) return v;
  if (in_div != 1.0f) v = __fdiv_rn(v, in_div);
  return __float2int_rn(v);
}

template <bool PACKED, int EPI>
__global__ void __launch_bounds__(THREADS)
gqmm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
            const void* __restrict__ s, const float* __restrict__ bias,
            float* __restrict__ out, int M, int Kg, int Ng, long long x_gs,
            long long x_rs, long long o_gs, long long o_rs, int s_stride, float in_div,
            b3::IntReq rq) {
  using T = typename Acc<EPI>::T;
  __shared__ T xs[BM][BK + 1];
  __shared__ T ws[BK][BN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int g = blockIdx.z;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const float* xg = x + g * x_gs;
  const int8_t* wg = w + (long long)g * (PACKED ? Kg / 2 : Kg) * Ng;
  T acc[2][2] = {{0, 0}, {0, 0}};

  for (int k0 = 0; k0 < Kg; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gk = k0 + c;
      xs[r][c] = (gr < M && gk < Kg) ? stage_x<EPI>(xg[gr * x_rs + gk], in_div) : T(0);
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gc = col0 + c;
      int v = 0;
      if (gk < Kg && gc < Ng) {
        if (PACKED) {
          const int b = wg[(long long)(gk >> 1) * Ng + gc];
          v = (gk & 1) ? (b >> 4) : ((int)(int8_t)(b << 4) >> 4);
        } else {
          v = wg[(long long)gk * Ng + gc];
        }
      }
      ws[r][c] = T(v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const T a0 = xs[ty][kk], a1 = xs[ty + 16][kk];
      const T b0 = ws[kk][tx], b1 = ws[kk][tx + 16];
      if (EPI == EPI_F32) {
        acc[0][0] = fmaf(a0, b0, acc[0][0]);
        acc[0][1] = fmaf(a0, b1, acc[0][1]);
        acc[1][0] = fmaf(a1, b0, acc[1][0]);
        acc[1][1] = fmaf(a1, b1, acc[1][1]);
      } else {
        acc[0][0] += a0 * b0;
        acc[0][1] += a0 * b1;
        acc[1][0] += a1 * b0;
        acc[1][1] += a1 * b1;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row0 + ty + 16 * i, c = col0 + tx + 16 * j;
      if (r < M && c < Ng) {
        const int ch = g * Ng + c;
        float o;
        if (EPI == EPI_B3) {
          o = b3::int_epilogue((int)acc[i][j], static_cast<const int*>(s)[ch * s_stride], rq);
        } else {
          const float a = EPI == EPI_F32 ? (float)acc[i][j] : __int2float_rn((int)acc[i][j]);
          o = __fmul_rn(a, static_cast<const float*>(s)[ch * s_stride]);
        }
        if (bias != nullptr) o = __fadd_rn(o, bias[ch]);
        out[g * o_gs + r * o_rs + c] = o;
      }
    }
  }
}

template <bool PACKED>
void gqmm_epi(int epi, dim3 grid, cudaStream_t st, const float* x, const int8_t* w,
              const void* s, const float* bias, float* out, int M, int Kg, int Ng,
              long long x_gs, long long x_rs, long long o_gs, long long o_rs, int s_stride,
              float in_div, const b3::IntReq& rq) {
  if (epi == EPI_F32)
    gqmm_kernel<PACKED, EPI_F32><<<grid, THREADS, 0, st>>>(
        x, w, s, bias, out, M, Kg, Ng, x_gs, x_rs, o_gs, o_rs, s_stride, in_div, rq);
  else if (epi == EPI_I32)
    gqmm_kernel<PACKED, EPI_I32><<<grid, THREADS, 0, st>>>(
        x, w, s, bias, out, M, Kg, Ng, x_gs, x_rs, o_gs, o_rs, s_stride, in_div, rq);
  else
    gqmm_kernel<PACKED, EPI_B3><<<grid, THREADS, 0, st>>>(
        x, w, s, bias, out, M, Kg, Ng, x_gs, x_rs, o_gs, o_rs, s_stride, in_div, rq);
}

b3::IntReq int_req(int epi, const int* rq, float out_mul) {
  if (epi != EPI_B3) return b3::IntReq{};
  return b3::IntReq{rq[0], rq[1], rq[2], rq[3], rq[4], rq[5], rq[6], rq[7], rq[8], out_mul};
}

struct DwShape {
  int C, H, W, OH, OW, kh, kw, sh, sw, pt, pl, dh, dw;
};

// grid.x: one (n, c) plane each; grid.y and the threads stride over the
// plane's OH*OW outputs, so the per-output index math is 32-bit and the
// channel's scale, bias and taps are the same for the whole block
template <int MODE, int EPI>
__global__ void dw_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                          const void* __restrict__ s, const float* __restrict__ bias,
                          const float* __restrict__ qs_p, const float* __restrict__ qz_p,
                          float* __restrict__ out, DwShape p, int s_stride, int relu, int act,
                          float lo, float hi, float in_div, b3::IntReq rq) {
  using T = typename Acc<EPI>::T;
  const int plane = blockIdx.x;                   // n*C + c
  const int c = plane % p.C;
  const int hw = p.OH * p.OW;
  const float* xc = x + (long long)plane * p.H * p.W;
  float* oc = out + (long long)plane * hw;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < hw; i += gridDim.y * blockDim.x) {
    const int oh = i / p.OW, ow = i - oh * p.OW;
    T acc = 0;
    for (int a = 0; a < p.kh; ++a) {
      const int ih = oh * p.sh - p.pt + a * p.dh;
      if (ih < 0 || ih >= p.H) continue;          // zero padding adds +-0
      for (int b = 0; b < p.kw; ++b) {
        const int iw = ow * p.sw - p.pl + b * p.dw;
        if (iw < 0 || iw >= p.W) continue;
        const int wv = w[(a * p.kw + b) * p.C + c];
        if (EPI == EPI_F32)
          acc = __fadd_rn(acc, __fmul_rn(xc[ih * p.W + iw], (float)wv));
        else
          acc += stage_x<EPI>(xc[ih * p.W + iw], in_div) * wv;
      }
    }
    if (EPI == EPI_B3) {
      oc[i] = b3::int_epilogue((int)acc, static_cast<const int*>(s)[c * s_stride], rq);
      continue;
    }
    const float af = EPI == EPI_F32 ? (float)acc : __int2float_rn((int)acc);
    float y = __fmul_rn(af, static_cast<const float*>(s)[c * s_stride]);
    if (bias != nullptr) y = __fadd_rn(y, bias[c]);
    if (relu) y = y < 0.0f ? 0.0f : y;            // NaN passes, as jnp.maximum
    if (act) {
      const float qs = *qs_p, qz = *qz_p;
      const float q = quantize<MODE>(y, qs, qz, lo, hi);
      y = __fmul_rn(__fsub_rn(q, qz), qs);
    }
    oc[i] = y;
  }
}

template <int MODE, int EPI>
void dw_mode(dim3 grid, int threads, cudaStream_t st, const float* x, const int8_t* w,
             const void* s, const float* bias, const float* qs, const float* qz, float* out,
             const DwShape& p, int s_stride, int relu, int act, float lo, float hi,
             float in_div, const b3::IntReq& rq) {
  dw_kernel<MODE, EPI><<<grid, threads, 0, st>>>(x, w, s, bias, qs, qz, out, p, s_stride, relu,
                                                 act, lo, hi, in_div, rq);
}

// the fp32 epilogue's act requant rounds by MODE (a template parameter)
template <int EPI>
int dw_modes(int mode, dim3 grid, int threads, cudaStream_t st, const float* x,
             const int8_t* w, const void* s, const float* bias, const float* qs,
             const float* qz, float* out, const DwShape& p, int s_stride, int relu, int act,
             float lo, float hi, float in_div, const b3::IntReq& rq) {
  switch (act ? mode : (int)ROUND) {
    case ROUND: dw_mode<ROUND, EPI>(grid, threads, st, x, w, s, bias, qs, qz, out, p, s_stride, relu, act, lo, hi, in_div, rq); break;
    case CEIL: dw_mode<CEIL, EPI>(grid, threads, st, x, w, s, bias, qs, qz, out, p, s_stride, relu, act, lo, hi, in_div, rq); break;
    case FLOOR: dw_mode<FLOOR, EPI>(grid, threads, st, x, w, s, bias, qs, qz, out, p, s_stride, relu, act, lo, hi, in_div, rq); break;
    case UP: dw_mode<UP, EPI>(grid, threads, st, x, w, s, bias, qs, qz, out, p, s_stride, relu, act, lo, hi, in_div, rq); break;
    case DOWN: dw_mode<DOWN, EPI>(grid, threads, st, x, w, s, bias, qs, qz, out, p, s_stride, relu, act, lo, hi, in_div, rq); break;
    case HALF_UP: dw_mode<HALF_UP, EPI>(grid, threads, st, x, w, s, bias, qs, qz, out, p, s_stride, relu, act, lo, hi, in_div, rq); break;
    case HALF_DOWN: dw_mode<HALF_DOWN, EPI>(grid, threads, st, x, w, s, bias, qs, qz, out, p, s_stride, relu, act, lo, hi, in_div, rq); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// Kg is the logical per-group depth (the packed weight has Kg / 2 rows per
// group).  x_gs / x_rs and o_gs / o_rs are the group and row strides of x
// and out in elements.  bias may be null.  epi, in_div, rq and out_mul as
// qmm_launch's (quant_matmul.cu).  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int gqmm_launch(const float* x, const int8_t* w, const void* s, const float* bias,
                           float* out, int G, int M, int Kg, int Ng, long long x_gs,
                           long long x_rs, long long o_gs, long long o_rs, int s_stride,
                           int packed, int epi, float in_div, const int* rq, float out_mul,
                           void* stream) {
  if (epi < EPI_F32 || epi > EPI_B3) return (int)cudaErrorInvalidValue;
  const b3::IntReq r = int_req(epi, rq, out_mul);
  if (G > 0 && M > 0 && Ng > 0) {
    const dim3 grid((M + BM - 1) / BM, (Ng + BN - 1) / BN, G);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (packed)
      gqmm_epi<true>(epi, grid, st, x, w, s, bias, out, M, Kg, Ng, x_gs, x_rs, o_gs, o_rs,
                     s_stride, in_div, r);
    else
      gqmm_epi<false>(epi, grid, st, x, w, s, bias, out, M, Kg, Ng, x_gs, x_rs, o_gs, o_rs,
                      s_stride, in_div, r);
  }
  return (int)cudaGetLastError();
}

// x (N, C, H, W) and out (N, C, OH, OW) contiguous float32; w (kh*kw, C)
// int8; s scalar (stride 0) or (C,), float32 or (epi 2) int32 multipliers;
// bias (C,) or null; qs / qz one float each on the device, read only when
// act != 0, with the static clip bounds lo / hi and the rounding mode of
// qdq_round.cuh (the fp32 epilogue's act requant; epi 2 folds ReLU and the
// act Quant into rq).  epi, in_div, rq and out_mul as qmm_launch's.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dw_launch(const float* x, const int8_t* w, const void* s, const float* bias,
                         const float* qs, const float* qz, float* out, int N, int C, int H,
                         int W, int OH, int OW, int kh, int kw, int sh, int sw, int pt, int pl,
                         int dh, int dw, int s_stride, int relu, int act, float lo, float hi,
                         int mode, int epi, float in_div, const int* rq, float out_mul,
                         void* stream) {
  if (epi < EPI_F32 || epi > EPI_B3) return (int)cudaErrorInvalidValue;
  const b3::IntReq r = int_req(epi, rq, out_mul);
  const int hw = OH * OW;
  if ((long long)N * C > 0 && hw > 0) {
    // a block no wider than the plane (warp multiples), the plane's tail
    // over grid.y
    const int threads = hw >= 256 ? 256 : (hw + 31) / 32 * 32;
    const int tiles = (hw + threads - 1) / threads;
    const dim3 grid((unsigned)(N * C), tiles < 65535 ? tiles : 65535);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const DwShape p{C, H, W, OH, OW, kh, kw, sh, sw, pt, pl, dh, dw};
    int err;
    if (epi == EPI_F32)
      err = dw_modes<EPI_F32>(mode, grid, threads, st, x, w, s, bias, qs, qz, out, p, s_stride,
                              relu, act, lo, hi, in_div, r);
    else if (epi == EPI_I32)
      err = dw_modes<EPI_I32>(mode, grid, threads, st, x, w, s, bias, qs, qz, out, p, s_stride,
                              relu, act, lo, hi, in_div, r);
    else
      err = dw_modes<EPI_B3>(ROUND, grid, threads, st, x, w, s, bias, qs, qz, out, p, s_stride,
                             0, 0, lo, hi, in_div, r);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}
