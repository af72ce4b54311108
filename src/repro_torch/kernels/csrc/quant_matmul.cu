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
// A true float32 dot, as the reference's: FMA on the CUDA cores, no TF32 or
// tensor-core path.  Each block owns a 32x32 output tile and walks the
// whole K axis itself (K is not a grid axis, so no partial sums cross
// blocks); 256 threads each keep 2x2 accumulators.  A K step stages a
// 32x32 slice of x and of the weights in shared memory; B2 unpacks the
// nibbles while it stages them, so the packed bytes are what device memory
// serves.  Ragged edges load zeros instead of padding copies.  The
// epilogue rounds like the reference: (acc * s) rounded, then + bias.
//
// At the TFC shapes (M <= 256, K <= 784, N <= 64) the work is small: the
// bound is the float32 FMA rate for the 784-wide layer and the bytes of x
// for the rest; this simple tiling leaves most SMs idle at such M.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32, BN = 32, BK = 32, THREADS = 256;

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ s, const float* __restrict__ bias,
           float* __restrict__ out, int M, int K, int N, int s_stride) {
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gk = k0 + c;
      xs[r][c] = (gr < M && gk < K) ? x[(long long)gr * K + gk] : 0.0f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gc = col0 + c;
      float v = 0.0f;
      if (gk < K && gc < N) {
        if (PACKED) {
          const int b = w[(long long)(gk >> 1) * N + gc];
          v = (float)((gk & 1) ? (b >> 4) : ((int)(int8_t)(b << 4) >> 4));
        } else {
          v = (float)w[(long long)gk * N + gc];
        }
      }
      ws[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = xs[ty][kk], a1 = xs[ty + 16][kk];
      const float b0 = ws[kk][tx], b1 = ws[kk][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row0 + ty + 16 * i, c = col0 + tx + 16 * j;
      if (r < M && c < N) {
        float o = __fmul_rn(acc[i][j], s[c * s_stride]);
        if (bias != nullptr) o = __fadd_rn(o, bias[c]);
        out[(long long)r * N + c] = o;
      }
    }
  }
}

}  // namespace

// K is the logical depth (the packed weight has K / 2 rows).  bias may be
// null.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int qmm_launch(const float* x, const int8_t* w, const float* s, const float* bias,
                          float* out, int M, int K, int N, int s_stride, int packed,
                          void* stream) {
  if (M > 0 && N > 0) {
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (packed)
      qmm_kernel<true><<<grid, THREADS, 0, st>>>(x, w, s, bias, out, M, K, N, s_stride);
    else
      qmm_kernel<false><<<grid, THREADS, 0, st>>>(x, w, s, bias, out, M, K, N, s_stride);
  }
  return (int)cudaGetLastError();
}
