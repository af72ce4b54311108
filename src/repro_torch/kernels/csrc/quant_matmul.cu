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
// qmm_kernel: three bodies, chosen by the EPI template parameter as the
// reference chooses by `acc_dtype` and `requant`:
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
// load zeros instead of padding copies.  At the TFC shapes (M <= 256,
// K <= 784, N <= 64) the work is small: the bound is the FMA / IMAD rate for
// the 784-wide layer and the bytes of x for the rest.
//
// qmm_i8_kernel: B2's integer body on the int8 tensor cores (EPI_I32 and
// EPI_B3), taken where the lowering proved every staged code q - z in
// [-127, 127] (RequantPlan.int8_codes); without that proof B2 keeps
// qmm_kernel's IMAD body.  Bound on the card: bytes.  MobileNet-224's
// pointwise layers do 8.63 G integer operations at 8 rows, 0.0044 ms at
// 1,979 TOP/s, against 0.0448 ms to read x (float32) and write the output
// (float32) once.  At 8 rows most of those layers give a 64x64 tiling only
// 100-400 blocks, one to three per SM, with 4-16 K steps each, so what a
// simple kernel pays is each step's chain of latencies (load, convert,
// barrier, mma), not the card's bandwidth; the design shortens that chain:
//   - a block of 4 warps owns a 64x64 output tile (each warp 32x32: two
//     16-row by four 8-column mma tiles) and walks K in steps of 64 (two
//     mma k-steps of 32);
//   - x is read as float32 by 16-byte cp.async and the packed weight bytes
//     likewise, into a ring of 3 raw stages in shared memory, so the loads
//     run 2 steps ahead (operands whose rows are not on 16 bytes, K % 4 or
//     N % 16 not 0, are read element by element into the same ring);
//   - each raw stage is converted once per block: x to int8 codes laid out
//     [m][k], the nibbles unpacked (sign-extended) to [n][k] (the `col` B
//     operand), into one of two code buffers; rows are 80 bytes, so
//     ldmatrix's eight row reads hit distinct banks;
//   - step s multiplies code buffer s & 1 (mma.sync.m16n8k32.s32.s8.s8.s32
//     on ldmatrix fragments) and then converts step s + 1 into the other
//     buffer: the two are independent, so one barrier a step serves both
//     and a warp's conversions overlap its products;
//   - ragged M, N and K are zero-filled while loading (a zero code or
//     weight adds nothing);
//   - the epilogue (float(acc) * s, or B3, then the bias) runs on the C
//     fragments.  B3 there is b3::int_epilogue's function computed on
//     32-bit integers wherever no intermediate can leave int32 (the
//     host's check of the zero point and shift, a range check of acc ·
//     mult), else b3::int_epilogue itself: the card has no 64-bit
//     integer unit, so each int64 shift, compare or add there costs two
//     or more instructions per output.
// The staging division keeps __fdiv_rn's bits at a lower price, through
// int_staging.cuh (shared with B5 / B6): when in_scale is a power of two
// whose reciprocal is a finite normal float32, the host passes that
// reciprocal and the kernel multiplies (x * 2^-e and x / 2^e round the same
// real number); for any other scale, an x whose quotient is exactly an
// integer n (n · s - x == 0 in one FMA, exact) stages n, which is what
// __fdiv_rn returns, and any other x is divided with __fdiv_rn.  Every x
// of the integer path is such a multiple.  The int32
// sums of integer products are exact in any order, so this body equals the
// IMAD body and the twin bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_epilogue.cuh"
#include "int_staging.cuh"

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

// ------------------------------------------- B2 on the int8 tensor cores

namespace tc {

constexpr int BM = 64, BN = 64, THREADS = 128;
constexpr int STAGES = 3;       // raw stages: loads run 2 K steps ahead of the codes

// BK: the K step, 64, or 32 where K <= 32 (MobileNet's first pointwise
// layer), so that no half-empty stage is loaded; code rows are BK + 16
// bytes (48 or 80), so ldmatrix's eight row reads hit distinct banks
template <int BK>
struct Smem {
  float xraw[STAGES][BM][BK];           // x as loaded, float32
  uint8_t wraw[STAGES][BK / 2][BN];     // packed weight rows as loaded
  int8_t xs[2][BM][BK + 16];            // codes, [m][k], double-buffered
  int8_t ws[2][BN][BK + 16];            // weights, [n][k], double-buffered
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), exact int32 accumulation
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

using stg::Stage;

// a quotient as an int8 code in the low byte
__device__ __forceinline__ uint32_t code(float q) {
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(q);
}

// four x elements staged as four int8 codes by int_staging.cuh's
// RECIPROCAL or QUOTIENT mode; in QUOTIENT mode `exact` turns false where
// the guess is not the quotient, and the caller then divides (codes4_div)
__device__ __forceinline__ uint32_t codes4(float4 f, const Stage& st, bool& exact) {
  const float4 q = stg::quotients4(f, st, exact);
  return code(q.x) | code(q.y) << 8 | code(q.z) << 16 | code(q.w) << 24;
}

__device__ __forceinline__ uint32_t codes4_div(float4 f, float div) {
  const float4 q = stg::divide4(f, div);
  return code(q.x) | code(q.y) << 8 | code(q.z) << 16 | code(q.w) << 24;
}

// a packed byte's two sign-extended nibbles as int8 bytes: low (row 2r)
// in bits 0-7, high (row 2r + 1) in bits 8-15
__device__ __forceinline__ uint32_t nibbles(uint32_t byte) {
  const int lo = (int)(int8_t)(byte << 4) >> 4, hi = (int)(int8_t)byte >> 4;
  return (uint32_t)(uint8_t)lo | ((uint32_t)(uint8_t)hi << 8);
}

// B3 as this body runs it: int_epilogue.cuh's 32-bit path (Req32) wherever
// no intermediate can leave int32 (the host's check of the zero point and
// shift, and every |acc · mult| of the thread below 2^30, checked once per
// thread), with the rounding mode a template parameter; else
// b3::int_epilogue itself for the thread's outputs.
using Req = b3::Req32;

// the warp's 32x32 of C fragments through the epilogue into out.  MODE:
// a rounding mode for B3 on 32-bit integers, or -1 for the general path
// (float(acc) * s, or b3::int_epilogue); then the bias
template <int EPI, int MODE>
__device__ __forceinline__ void write_tile(const int (&acc)[2][4][4], float* __restrict__ out,
                                           int M, int N, int r0, int c0, const void* s,
                                           int s_stride, const float* bias, const Req& e) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 8 * j;               // this thread's columns c and c + 1
    if (c >= N) continue;
    float sf[2] = {0.f, 0.f}, b[2] = {0.f, 0.f};
    int mult[2] = {0, 0};
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      if (c + cc >= N) continue;
      if (EPI == EPI_B3)
        mult[cc] = static_cast<const int*>(s)[(c + cc) * s_stride];
      else
        sf[cc] = static_cast<const float*>(s)[(c + cc) * s_stride];
      if (bias != nullptr) b[cc] = bias[c + cc];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 16 * i + 8 * hh;
        if (r >= M) continue;
        float o[2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int a = acc[i][j][2 * hh + cc];
          if (EPI != EPI_B3)
            o[cc] = __fmul_rn(__int2float_rn(a), sf[cc]);
          else if (MODE < 0)
            o[cc] = b3::int_epilogue(a, mult[cc], e.rq);
          else
            o[cc] = b3::int_epilogue32<MODE < 0 ? 0 : MODE>(
                (int)((uint32_t)a * (uint32_t)mult[cc]), e);
          if (bias != nullptr) o[cc] = __fadd_rn(o[cc], b[cc]);
        }
        float* dst = out + (long long)r * N + c;
        if (c + 1 >= N)
          dst[0] = o[0];
        else if ((N & 1) == 0)
          *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
        else {
          dst[0] = o[0];
          dst[1] = o[1];
        }
      }
    }
  }
}

// the 32-bit B3 path needs every |acc · mult| of the thread below 2^30
__device__ __forceinline__ bool fits32(const int (&acc)[2][4][4], int N, int c0, const void* s,
                                       int s_stride) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = c0 + 8 * j + cc;
      const int mult = c < N ? static_cast<const int*>(s)[c * s_stride] : 0;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          ok = ok && b3::fits32((int)((uint32_t)acc[i][j][2 * hh + cc] * (uint32_t)mult));
        }
    }
  return ok;
}

// x_vec: K % 4 == 0 and x on 16 bytes, so x rows go by 16-byte cp.async;
// w_vec: N % 16 == 0 and w on 16 bytes, so packed rows do too.  Otherwise
// that operand is loaded element by element (ragged test and TFC shapes).
template <int EPI, int BK>
__global__ void __launch_bounds__(THREADS)
qmm_i8_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
              const void* __restrict__ s, const float* __restrict__ bias,
              float* __restrict__ out, int M, int K, int N, int s_stride, Stage xst,
              int x_vec, int w_vec, Req rq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<BK>& sm = *reinterpret_cast<Smem<BK>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int kp = K >> 1, steps = (K + BK - 1) / BK;
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);

  // the raw x and weight bytes of the K step at k0 into ring slot `slot`
  auto load = [&](int slot, int k0) {
    constexpr int XPR = BK / 4;                            // 16-byte pieces per x row
#pragma unroll
    for (int i = 0; i < BM * XPR / THREADS; ++i) {
      const int c = tid + THREADS * i, r = c / XPR, kc = k0 + (c % XPR) * 4;
      float* dst = &sm.xraw[slot][r][(c % XPR) * 4];
      const float* src = x + (long long)(row0 + r) * K + kc;
      const bool in = row0 + r < M;
      if (x_vec) {
        cp_async16(dst, in && kc < K ? src : x, in && kc < K ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = in && kc + e < K ? src[e] : 0.f;
      }
    }
    constexpr int WPR = BN / 16;                           // 16-byte pieces per w row
    if (w_vec) {
      for (int c = tid; c < BK / 2 * WPR; c += THREADS) {
        const int r = c / WPR, pr = (k0 >> 1) + r;
        const int cb = col0 + (c % WPR) * 16;
        const int bytes = pr < kp ? max(0, min(16, N - cb)) : 0;
        cp_async16(&sm.wraw[slot][r][(c % WPR) * 16], bytes ? wb + (long long)pr * N + cb : wb,
                   bytes);
      }
    } else {
      for (int c = tid; c < BK / 2 * BN; c += THREADS) {
        const int r = c / BN, n = c % BN, pr = (k0 >> 1) + r;
        sm.wraw[slot][r][n] = pr < kp && col0 + n < N ? wb[(long long)pr * N + col0 + n] : 0;
      }
    }
  };

  // raw slot -> codes and unpacked weights in buffer `buf`
  auto stage = [&](int slot, int buf) {
    constexpr int XPR = BK / 4;
    bool exact = true;
#pragma unroll
    for (int i = 0; i < BM * XPR / THREADS; ++i) {
      const int c = tid + THREADS * i, r = c / XPR, k = (c % XPR) * 4;
      const float4 f = *reinterpret_cast<const float4*>(&sm.xraw[slot][r][k]);
      *reinterpret_cast<uint32_t*>(&sm.xs[buf][r][k]) = codes4(f, xst, exact);
    }
    if (!exact) {                 // a quotient that is no integer: divide this thread's x
      for (int i = 0; i < BM * XPR / THREADS; ++i) {
        const int c = tid + THREADS * i, r = c / XPR, k = (c % XPR) * 4;
        const float4 f = *reinterpret_cast<const float4*>(&sm.xraw[slot][r][k]);
        *reinterpret_cast<uint32_t*>(&sm.xs[buf][r][k]) = codes4_div(f, xst.div);
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 8 * BN / THREADS; ++i) {   // column n, packed rows 4j .. 4j + 3
      const int item = tid + THREADS * i, n = item % BN, j = item / BN;
      uint2 v8;
      v8.x = nibbles(sm.wraw[slot][4 * j][n]) | nibbles(sm.wraw[slot][4 * j + 1][n]) << 16;
      v8.y = nibbles(sm.wraw[slot][4 * j + 2][n]) | nibbles(sm.wraw[slot][4 * j + 3][n]) << 16;
      *reinterpret_cast<uint2*>(&sm.ws[buf][n][8 * j]) = v8;
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  // prologue: raw stages 0 .. STAGES - 2 in flight, step 0's codes staged
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) load(st, st * BK);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  stage(0, 0);
  // step st: the products of codes[st & 1] and the staging of step st + 1
  // into codes[(st + 1) & 1] are independent, so one barrier per step
  // serves both, and a warp's conversions overlap its mma
  for (int st = 0; st < steps; ++st) {
    if (st + STAGES - 1 < steps) load((st + STAGES - 1) % STAGES, (st + STAGES - 1) * BK);
    cp_async_commit();
    cp_async_wait<STAGES - 2>();               // step st + 1's raw stage has landed
    __syncthreads();                           // codes[st & 1] staged; old buffers free
    const int buf = st & 1;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(smem_addr(&sm.xs[buf][wm + 16 * i + (lane & 15)][kk * 32 + (lane >> 4) * 16]),
                    a[i]);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4(smem_addr(&sm.ws[buf][wn + 16 * p + (lane & 7) + ((lane >> 4) << 3)]
                                    [kk * 32 + ((lane >> 3) & 1) * 16]),
                    b[p]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
    if (st + 1 < steps) stage((st + 1) % STAGES, buf ^ 1);
  }

  // the epilogue on the C fragments: rows r0 + 16 i + 8 hh, columns
  // c0 + 8 j + cc of this thread
  const int r0 = row0 + wm + g, c0 = col0 + wn + 2 * t;
  if (EPI == EPI_B3 && rq.fast && fits32(acc, N, c0, s, s_stride)) {
#define QMM_I8_WRITE(MODE) \
  write_tile<EPI, MODE>(acc, out, M, N, r0, c0, s, s_stride, bias, rq)
    switch (rq.rq.mode) {
      case b3::CEIL: QMM_I8_WRITE(b3::CEIL); break;
      case b3::FLOOR: QMM_I8_WRITE(b3::FLOOR); break;
      case b3::UP: QMM_I8_WRITE(b3::UP); break;
      case b3::DOWN: QMM_I8_WRITE(b3::DOWN); break;
      case b3::HALF_UP: QMM_I8_WRITE(b3::HALF_UP); break;
      case b3::HALF_DOWN: QMM_I8_WRITE(b3::HALF_DOWN); break;
      default: QMM_I8_WRITE(b3::ROUND); break;
    }
#undef QMM_I8_WRITE
  } else {
    write_tile<EPI, -1>(acc, out, M, N, r0, c0, s, s_stride, bias, rq);
  }
}

template <int EPI, int BK>
int launch_i8(dim3 grid, cudaStream_t st, const float* x, const int8_t* w, const void* s,
              const float* bias, float* out, int M, int K, int N, int s_stride,
              const Stage& xst, const Req& rq) {
  constexpr int bytes = (int)sizeof(Smem<BK>);
  static bool attr_set = false;  // one device per process: set the opt-in once
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(qmm_i8_kernel<EPI, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int x_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  qmm_i8_kernel<EPI, BK><<<grid, THREADS, bytes, st>>>(x, w, s, bias, out, M, K, N, s_stride,
                                                       xst, x_vec, w_vec, rq);
  return (int)cudaGetLastError();
}

template <int EPI>
int launch_i8_k(dim3 grid, cudaStream_t st, const float* x, const int8_t* w, const void* s,
                const float* bias, float* out, int M, int K, int N, int s_stride,
                const Stage& xst, const Req& rq) {
  if (K <= 32)
    return launch_i8<EPI, 32>(grid, st, x, w, s, bias, out, M, K, N, s_stride, xst, rq);
  return launch_i8<EPI, 64>(grid, st, x, w, s, bias, out, M, K, N, s_stride, xst, rq);
}

}  // namespace tc

// the IntRequant's nine ints (read on the host) and the output scale, or
// none off the B3 body
b3::IntReq int_req(int epi, const int* rq, float out_mul) {
  if (epi != EPI_B3) return b3::IntReq{};
  return b3::IntReq{rq[0], rq[1], rq[2], rq[3], rq[4], rq[5], rq[6], rq[7], rq[8], out_mul};
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
  const b3::IntReq r = int_req(epi, rq, out_mul);
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

// B2's integer body on the int8 tensor cores (qmm_i8_kernel): w is the
// (K / 2, N) packing, K even; epi 1 (float32 epilogue) or 2 (B3, rq as for
// qmm_launch).  Each x element is multiplied by in_mul when in_mul != 0 (the
// exact reciprocal of a power-of-two in_div, checked on the host), else
// divided by in_div.  Every staged code must lie in [-128, 127] (the
// lowering's proof).  Returns cudaGetLastError() after the launch.
extern "C" int qmm_i8_launch(const float* x, const int8_t* w, const void* s, const float* bias,
                             float* out, int M, int K, int N, int s_stride, int epi,
                             float in_div, float in_mul, const int* rq, float out_mul,
                             void* stream) {
  if ((epi != EPI_I32 && epi != EPI_B3) || (K & 1)) return (int)cudaErrorInvalidValue;
  const tc::Req e =
      b3::make_req32(int_req(epi, rq, out_mul));
  const tc::Stage xst =
      stg::make_stage(in_div, in_mul, in_mul != 0.f ? stg::RECIPROCAL : stg::QUOTIENT);
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const dim3 grid((M + tc::BM - 1) / tc::BM, (N + tc::BN - 1) / tc::BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (epi == EPI_I32)
    return tc::launch_i8_k<EPI_I32>(grid, st, x, w, s, bias, out, M, K, N, s_stride, xst, e);
  return tc::launch_i8_k<EPI_B3>(grid, st, x, w, s, bias, out, M, K, N, s_stride, xst, e);
}
