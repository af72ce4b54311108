// B1 / B2: weight-quantized matmul (repro_torch/kernels/quant_matmul.py).
//
// Replaces the Pallas kernels `_qmm_kernel` (int8 weights, B1) and
// `_qmm4_kernel` (int4 weights packed two per byte along K, B2) of
// repro/kernels/quant_matmul.py:
//   out[m, n] = (sum_k x[m, k] * w[k, n]) * s[n]  [+ bias[n]]
// x (M, K) float32; w (K, N) int8, or (K/2, N) int8 with row 2r in the low
// nibble and row 2r+1 in the high nibble, both sign-extended; s scalar
// (stride 0) or per column; bias per column or absent.
//
// Three bodies, chosen by the EPI template parameter as the reference
// chooses by `acc_dtype` and `requant`:
//   EPI_F32  a true float32 dot, as the reference's: FMA on the CUDA
//            cores, no TF32 or tensor-core path; (acc * s) rounded, + bias;
//   EPI_I32  an int32 dot of integer values: x (divided by in_div, an IEEE
//            __fdiv_rn, unless in_div is 1) is converted with
//            __float2int_rn as its tile is staged, the weights as int8 or
//            unpacked nibbles, IMAD on the CUDA cores; then float(acc) * s,
//            + bias;
//   EPI_B3   the same int32 dot, then the integer requant epilogue B3
//            (int_epilogue.cuh) with s carrying int32 multipliers, + bias.
// On the integer path the lowering divides x by the activation scale here,
// in the staging load: it proved the quotient an integer (q - z), which a
// correctly rounded division returns exactly.
// Each block owns a 32x32 output tile and walks the whole K axis itself
// (K is not a grid axis, so no partial sums cross blocks); 256 threads
// each keep 2x2 accumulators.  A K step stages a 32x32 slice of x and of
// the weights in shared memory; B2 unpacks the nibbles while it stages
// them, so the packed bytes are what device memory serves.  Ragged edges
// load zeros instead of padding copies.
//
// At the TFC shapes (M <= 256, K <= 784, N <= 64) the work is small: the
// bound is the FMA / IMAD rate for the 784-wide layer and the bytes of x
// for the rest; this simple tiling leaves most SMs idle at such M.  On
// MobileNet-224 the pointwise layers are bound by operations; the integer
// body runs at the CUDA cores' IMAD rate, not on the int8 tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_epilogue.cuh"

namespace {

constexpr int BM = 32, BN = 32, BK = 32, THREADS = 256;
enum Epi { EPI_F32 = 0, EPI_I32 = 1, EPI_B3 = 2 };

template <int EPI>
struct Acc { using T = int; };
template <>
struct Acc<EPI_F32> { using T = float; };

// one staged x element: float32 as it is, or its integer value
template <int EPI>
__device__ __forceinline__ typename Acc<EPI>::T stage_x(float v, float in_div) {
  if (EPI == EPI_F32) return v;
  if (in_div != 1.0f) v = __fdiv_rn(v, in_div);
  return __float2int_rn(v);
}

template <bool PACKED, int EPI>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
           const void* __restrict__ s, const float* __restrict__ bias,
           float* __restrict__ out, int M, int K, int N, int s_stride, float in_div,
           b3::IntReq rq) {
  using T = typename Acc<EPI>::T;
  __shared__ T xs[BM][BK + 1];
  __shared__ T ws[BK][BN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  T acc[2][2] = {{0, 0}, {0, 0}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gk = k0 + c;
      xs[r][c] = (gr < M && gk < K) ? stage_x<EPI>(x[(long long)gr * K + gk], in_div) : T(0);
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gc = col0 + c;
      int v = 0;
      if (gk < K && gc < N) {
        if (PACKED) {
          const int b = w[(long long)(gk >> 1) * N + gc];
          v = (gk & 1) ? (b >> 4) : ((int)(int8_t)(b << 4) >> 4);
        } else {
          v = w[(long long)gk * N + gc];
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
      if (r < M && c < N) {
        float o;
        if (EPI == EPI_B3) {
          o = b3::int_epilogue((int)acc[i][j], static_cast<const int*>(s)[c * s_stride], rq);
        } else {
          const float a = EPI == EPI_F32 ? (float)acc[i][j] : __int2float_rn((int)acc[i][j]);
          o = __fmul_rn(a, static_cast<const float*>(s)[c * s_stride]);
        }
        if (bias != nullptr) o = __fadd_rn(o, bias[c]);
        out[(long long)r * N + c] = o;
      }
    }
  }
}

template <bool PACKED>
void qmm_epi(int epi, dim3 grid, cudaStream_t st, const float* x, const int8_t* w,
             const void* s, const float* bias, float* out, int M, int K, int N, int s_stride,
             float in_div, const b3::IntReq& rq) {
  if (epi == EPI_F32)
    qmm_kernel<PACKED, EPI_F32><<<grid, THREADS, 0, st>>>(x, w, s, bias, out, M, K, N,
                                                          s_stride, in_div, rq);
  else if (epi == EPI_I32)
    qmm_kernel<PACKED, EPI_I32><<<grid, THREADS, 0, st>>>(x, w, s, bias, out, M, K, N,
                                                          s_stride, in_div, rq);
  else
    qmm_kernel<PACKED, EPI_B3><<<grid, THREADS, 0, st>>>(x, w, s, bias, out, M, K, N,
                                                         s_stride, in_div, rq);
}

}  // namespace

// K is the logical depth (the packed weight has K / 2 rows).  bias may be
// null.  epi: 0 float32 body, 1 int32 body with the float32 epilogue, 2
// int32 body with B3 (s then holds int32 multipliers and rq points at the 9
// IntRequant ints, read on the host).  On the integer bodies x is divided
// by in_div while staged (1 = no division).  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int qmm_launch(const float* x, const int8_t* w, const void* s, const float* bias,
                          float* out, int M, int K, int N, int s_stride, int packed, int epi,
                          float in_div, const int* rq, float out_mul, void* stream) {
  if (epi < EPI_F32 || epi > EPI_B3) return (int)cudaErrorInvalidValue;
  b3::IntReq r{};
  if (epi == EPI_B3) {
    r = b3::IntReq{rq[0], rq[1], rq[2], rq[3], rq[4], rq[5], rq[6], rq[7], rq[8], out_mul};
  }
  if (M > 0 && N > 0) {
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (packed)
      qmm_epi<true>(epi, grid, st, x, w, s, bias, out, M, K, N, s_stride, in_div, r);
    else
      qmm_epi<false>(epi, grid, st, x, w, s, bias, out, M, K, N, s_stride, in_div, r);
  }
  return (int)cudaGetLastError();
}
