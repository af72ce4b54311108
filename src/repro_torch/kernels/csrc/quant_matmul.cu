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
// Both kernels also run a conv as an implicit GEMM (quant_conv.py ·
// quant_conv2d, for every conv with kH·kW > 1 or any padding): x is then the
// conv's NCHW float32 input and the (N·OH·OW, C·kH·kW) operand its patches,
// which no one writes.  Each element is gathered by address
// (conv_taps.cuh, one map for both kernels) with a 4-byte cp.async into the
// raw ring, laid out [k][m] so that a warp copies consecutive ow of one k,
// padding taps zero-filled by the copy; the ring's existing conversion then
// stages it as it stages a row-loaded x (the same float32 values through
// the same int_staging.cuh, so the integer bodies give the same bits, and
// the float32 body sums in the same K order under the same host plan).  The
// epilogue writes out[n, o, oh, ow] directly: B2's int8 body from its C
// fragments (eight consecutive rows a column), the CUDA-core body through a
// shared-memory tile stored along m.  Bound there: the bytes of x and of the
// output (CNV's conv #2 at 256 images: 59 MB and 51 MB, 0.033 ms), where the
// patch path moved a float32 matrix 9x its input, written by aten's im2col
// and copied twice.
//
// cc::qmm_kernel (B1, and B2's float32 and IMAD bodies): three bodies,
// chosen by the EPI template parameter as the reference chooses by
// `acc_dtype` and `requant`:
//   EPI_F32  a true float32 dot, as the reference's: FMA on the CUDA
//            cores, no TF32 or tensor-core path; (acc * s) rounded, + bias;
//   EPI_I32  an int32 dot of integer values: x is staged as round(x /
//            in_div) by int_staging.cuh (shared with B2's int8 body, B5 and
//            B6: a reciprocal multiply at a power-of-two in_div, else an
//            exact-quotient check, else __fdiv_rn, all with the IEEE
//            division's bits), the weights as int8 or unpacked nibbles,
//            IMAD on the CUDA cores; then float(acc) * s, + bias;
//   EPI_B3   the same int32 dot, then the integer requant epilogue B3
//            (int_epilogue.cuh; its 32-bit path where no intermediate can
//            leave int32) with s carrying int32 multipliers, + bias.
// On the integer path the lowering divides x by the activation scale here,
// in the staging: it proved the quotient an integer (q - z), which a
// correctly rounded division returns exactly.
// Bound on the card: at TFC's shapes (M <= 256, K <= 784, N <= 64) a few
// hundred nanoseconds of FMA, IMAD or bytes; at the first convs of CNV and
// MobileNet (K = 27, M up to 100352) the bytes of x and the output.  What
// a simple kernel pays at TFC is the chain of latencies of too few blocks
// (a 32x32 tile gave 16 blocks on 132 SMs at 256x784x64, each walking all
// 25 K steps), so the design fills the card and shortens each block's chain:
//   - the geometry is the host plan's (quant_matmul.py · qmm_launch_plan):
//     a 16x64 output tile at small M, 64x64 or 128x32 (N <= 32) where those
//     give half a wave of blocks or more; 256 threads, each 1x4 or 4x4
//     outputs;
//   - where the tiles do not fill the card, K is split across a thread
//     block cluster of up to 8 CTAs (the portable limit): CTA r of a
//     cluster sums the contiguous range [r kc, (r + 1) kc) of K, the
//     partial tiles meet in shared memory, and each CTA reduces its slice
//     of the tile over the cluster's CTAs through distributed shared
//     memory in rank order 0, 1, ..., then runs the epilogue on it: one
//     launch, no atomics, the same bits on every call.  A float32 split
//     only reorders the sums (within the order bound 2 K 2^-24 (|x| @ |w|)
//     |s|; exact on dyadic x); int32 sums wrap alike in any order;
//   - x comes by 16-byte cp.async (rows where K % 4 == 0 and x lies on 16
//     bytes; where K < BK the block's rows are one contiguous span, copied
//     flat and read with pitch K), else element by element; a conv's
//     patches by the gather (X_GATHER: each thread keeps one row of the
//     tile, the float32 body reads the [k][m] slot as it landed and the
//     integer bodies stage it to [m][k]);
//     the weight bytes by 16-byte cp.async where N % 16 == 0; into a ring
//     of 3 raw stages, so the loads run 2 K steps ahead;
//   - each raw stage is converted once per block into one of two buffers:
//     the weights (int8 or unpacked nibbles) to float32 or int32, x on the
//     integer bodies to its staged integers; the float32 body reads x as
//     it landed.  Step s computes buffer s & 1 and then converts step
//     s + 1 into the other, so one barrier a step serves both;
//   - ragged M, N and K are zero-filled while loading (a zero weight adds
//     nothing); the flat span is read only up to K;
//   - B3 runs with its rounding mode chosen once per thread (a template
//     constant) and its int64 path out of line: a mode switch at every
//     output and the int64 code inlined at each took the 128x32 integer
//     tile to 128 registers a thread.
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
//     N % 16 not 0, are read element by element into the same ring; a
//     conv's patches are gathered, thread t keeping row t % 64 of the tile);
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_taps.cuh"
#include "int_epilogue.cuh"
#include "int_staging.cuh"

namespace {

enum Epi { EPI_F32 = 0, EPI_I32 = 1, EPI_B3 = 2 };

template <int EPI>
struct Acc { using T = int; };
template <>
struct Acc<EPI_F32> { using T = float; };

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
                                           int s_stride, const float* bias, const Req& e,
                                           const taps::Conv& cv, int gather) {
  // gather mode: out is (N_img, N, OH, OW), so a row's channels lie OH·OW
  // apart and the eight rows g of a column are consecutive floats
  long long ro[2][2];
  const int ohw = cv.OH * cv.OW;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 16 * i + 8 * hh;
      ro[i][hh] = gather && r < M ? taps::out_row(cv, r, N) : 0;
    }
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
        if (gather) {
          float* dst = out + ro[i][hh] + (long long)c * ohw;
          dst[0] = o[0];
          if (c + 1 < N) dst[ohw] = o[1];
          continue;
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
// gather: x is a conv's NCHW input and the operand its patches, read by
// conv_taps.cuh's address map (cv) into the raw ring laid out [k][m], and
// out is the conv's NCHW output.
template <int EPI, int BK>
__global__ void __launch_bounds__(THREADS)
qmm_i8_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
              const void* __restrict__ s, const float* __restrict__ bias,
              float* __restrict__ out, int M, int K, int N, int s_stride, Stage xst,
              int x_vec, int w_vec, Req rq, taps::Conv cv, int gather) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<BK>& sm = *reinterpret_cast<Smem<BK>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int kp = K >> 1, steps = (K + BK - 1) / BK;
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);
  // gather mode: thread tid gathers row tid % BM of the tile, columns
  // kq E .. kq E + E - 1 of each step
  constexpr int KQ = THREADS / BM, GE = BK / KQ;
  const taps::Row grow = gather ? taps::row(cv, row0 + tid % BM, M) : taps::Row{};

  // the raw x and weight bytes of the K step at k0 into ring slot `slot`
  auto load = [&](int slot, int k0) {
    constexpr int XPR = BK / 4;                            // 16-byte pieces per x row
    if (gather) {
      const int kq = tid / BM;
      taps::gather<GE>(&sm.xraw[slot][0][0] + kq * GE * BM + tid % BM, BM, x, cv, grow,
                       k0 + kq * GE, K);
    } else {
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

  // item c of a stage: row r and columns k .. k + 3, and their raw floats
  // ([m][k] as loaded by rows; [k][m] as gathered, consecutive rows to
  // consecutive threads so that the reads hit distinct banks)
  auto item = [&](int c, int& r, int& k) {
    constexpr int XPR = BK / 4;
    if (gather) {
      r = c % BM;
      k = c / BM * 4;
    } else {
      r = c / XPR;
      k = (c % XPR) * 4;
    }
  };
  auto raw4 = [&](int slot, int r, int k) {
    if (gather) {
      const float* t = &sm.xraw[slot][0][0] + k * BM + r;
      return make_float4(t[0], t[BM], t[2 * BM], t[3 * BM]);
    }
    return *reinterpret_cast<const float4*>(&sm.xraw[slot][r][k]);
  };

  // raw slot -> codes and unpacked weights in buffer `buf`
  auto stage = [&](int slot, int buf) {
    constexpr int XPR = BK / 4;
    bool exact = true;
#pragma unroll
    for (int i = 0; i < BM * XPR / THREADS; ++i) {
      int r, k;
      item(tid + THREADS * i, r, k);
      *reinterpret_cast<uint32_t*>(&sm.xs[buf][r][k]) = codes4(raw4(slot, r, k), xst, exact);
    }
    if (!exact) {                 // a quotient that is no integer: divide this thread's x
      for (int i = 0; i < BM * XPR / THREADS; ++i) {
        int r, k;
        item(tid + THREADS * i, r, k);
        *reinterpret_cast<uint32_t*>(&sm.xs[buf][r][k]) = codes4_div(raw4(slot, r, k), xst.div);
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
  write_tile<EPI, MODE>(acc, out, M, N, r0, c0, s, s_stride, bias, rq, cv, gather)
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
    write_tile<EPI, -1>(acc, out, M, N, r0, c0, s, s_stride, bias, rq, cv, gather);
  }
}

template <int EPI, int BK>
int launch_i8(dim3 grid, cudaStream_t st, const float* x, const int8_t* w, const void* s,
              const float* bias, float* out, int M, int K, int N, int s_stride,
              const Stage& xst, const Req& rq, const taps::Conv& cv, int gather) {
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
                                                       xst, x_vec, w_vec, rq, cv, gather);
  return (int)cudaGetLastError();
}

template <int EPI>
int launch_i8_k(dim3 grid, cudaStream_t st, const float* x, const int8_t* w, const void* s,
                const float* bias, float* out, int M, int K, int N, int s_stride,
                const Stage& xst, const Req& rq, const taps::Conv& cv, int gather) {
  if (K <= 32)
    return launch_i8<EPI, 32>(grid, st, x, w, s, bias, out, M, K, N, s_stride, xst, rq, cv,
                              gather);
  return launch_i8<EPI, 64>(grid, st, x, w, s, bias, out, M, K, N, s_stride, xst, rq, cv,
                            gather);
}

}  // namespace tc

// ----------------------------------- B1 / B2 on the CUDA cores (FMA, IMAD)

namespace cc {

namespace cg = cooperative_groups;

constexpr int THREADS = 256, BK = 32, STAGES = 3;
constexpr int XP = BK + 4;            // x row pitch in row mode: 16-byte rows, 4 banks apart
enum Tile { SMALL = 0, WIDE = 1, TALL = 2 };
enum XMode { X_SCALAR = 0, X_VEC = 1, X_FLAT = 2, X_GATHER = 3 };

// the host plan's geometry (quant_matmul.py · qmm_launch_plan, QMM_GEO_FIELDS)
struct Geo {
  int M, K, N, tile, tiles_m, tiles_n, split, kc, stages, bufs, xmode, wvec, ovec, smem;
};

template <int EPI>
struct Vec { using T = int4; };
template <>
struct Vec<EPI_F32> { using T = float4; };

// shared memory of one block, in bytes (each part a multiple of 16): a ring
// of `stages` raw slots (x as loaded, then the weight bytes), then `bufs`
// converted buffers (the weights as T, [k][n], then x staged to integers
// on the integer bodies).  A launch whose CTAs take fewer K steps than 3
// allocates only the slots they use (quant_matmul.py · qmm_smem_bytes), so
// more blocks fit an SM; the partial tiles of a split reuse the ring.
template <int BM, int BN, bool PACKED, int EPI>
struct Layout {
  static constexpr int WR = PACKED ? BK / 2 : BK;        // weight byte rows a step
  static constexpr int XSLOT = 4 * BM * XP, WSLOT = WR * BN;
  static constexpr int WCBUF = 4 * BK * BN, XCBUF = EPI == EPI_F32 ? 0 : 4 * BM * XP;
  static constexpr int RAW = XSLOT + WSLOT, BUF = WCBUF + XCBUF;
  static constexpr int bytes(int stages, int bufs) { return stages * RAW + bufs * BUF; }
  static_assert(XSLOT % 16 == 0 && WSLOT % 16 == 0 && WCBUF % 16 == 0, "16-byte parts");
};

__device__ __forceinline__ void mac(float& acc, float a, float b) { acc = fmaf(a, b, acc); }
__device__ __forceinline__ void mac(int& acc, int a, int b) {
  acc = (int)((uint32_t)acc + (uint32_t)a * (uint32_t)b);          // wraps as int32
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int add(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }

// B3's general path (int64), out of line: an act Quant whose values may
// leave int32, taken at few outputs or none
__device__ __noinline__ float b3_general(int acc, int mult, const b3::IntReq rq) {
  return b3::int_epilogue(acc, mult, rq);
}

// one output through the epilogue, then the bias.  B3 without an act
// Quant is int_epilogue's first lines; with one, its 32-bit path in
// rounding mode MODE where the host's check (e.fast) and |acc * mult| <
// 2^30 hold, else the general path
template <int EPI, int MODE>
__device__ __forceinline__ float epi1(typename Acc<EPI>::T a, int c, const void* s, int s_stride,
                                      const float* bias, const b3::Req32& e) {
  float o;
  if constexpr (EPI == EPI_B3) {
    const int mult = static_cast<const int*>(s)[c * s_stride];
    int p = (int)((uint32_t)a * (uint32_t)mult);
    if (!e.rq.has_act) {
      if (e.rq.relu && p < 0) p = 0;
      o = __fmul_rn(__int2float_rn(p), e.rq.out_mul);
    } else {
      o = e.fast && b3::fits32(p) ? b3::int_epilogue32<MODE>(p, e) : b3_general(a, mult, e.rq);
    }
  } else if constexpr (EPI == EPI_I32) {
    o = __fmul_rn(__int2float_rn(a), static_cast<const float*>(s)[c * s_stride]);
  } else {
    o = __fmul_rn(a, static_cast<const float*>(s)[c * s_stride]);
  }
  if (bias != nullptr) o = __fadd_rn(o, bias[c]);
  return o;
}

// f(std::integral_constant<int, MODE>) with B3's rounding mode as MODE,
// chosen once for a thread's outputs (0 off the B3 body)
template <int EPI, typename F>
__device__ __forceinline__ void with_mode(const b3::Req32& e, F&& f) {
  using std::integral_constant;
  if constexpr (EPI != EPI_B3) {
    f(integral_constant<int, 0>{});
  } else {
    switch (e.rq.mode) {
      case b3::CEIL: f(integral_constant<int, b3::CEIL>{}); break;
      case b3::FLOOR: f(integral_constant<int, b3::FLOOR>{}); break;
      case b3::UP: f(integral_constant<int, b3::UP>{}); break;
      case b3::DOWN: f(integral_constant<int, b3::DOWN>{}); break;
      case b3::HALF_UP: f(integral_constant<int, b3::HALF_UP>{}); break;
      case b3::HALF_DOWN: f(integral_constant<int, b3::HALF_DOWN>{}); break;
      default: f(integral_constant<int, b3::ROUND>{}); break;
    }
  }
}

// four weight values (int8 bytes, or nibbles as ints) as a T vector
template <typename V, typename T>
__device__ __forceinline__ V vec4(int a, int b, int c, int d) {
  return V{T(a), T(b), T(c), T(d)};
}

// Each block: one BM x BN output tile, or with a split (cluster) the K range
// of its cluster rank; TX x TY threads, thread (tx, ty) owning rows
// ty + TY i (i < TM) and columns TN tx .. TN tx + 3.  In X_GATHER mode x is
// a conv's NCHW input, read through conv_taps.cuh's address map (cv) into
// raw slots laid out [k][m], and out is the conv's NCHW output.
template <int BM, int BN, int TM, int TN, bool PACKED, int EPI>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
           const void* __restrict__ s, const float* __restrict__ bias,
           float* __restrict__ out, Geo g, int s_stride, stg::Stage xst, b3::Req32 rq,
           taps::Conv cv) {
  using T = typename Acc<EPI>::T;
  using V = typename Vec<EPI>::T;
  using L = Layout<BM, BN, PACKED, EPI>;
  constexpr int TX = BN / TN, TY = THREADS / TX, WR = L::WR;
  static_assert(TN == 4 && TY * TM == BM, "tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const bufs = smem_raw + g.stages * L::RAW;
  auto xraw = [&](int slot) { return reinterpret_cast<float*>(smem_raw + slot * L::RAW); };
  auto wraw = [&](int slot) { return smem_raw + slot * L::RAW + L::XSLOT; };
  auto wconv = [&](int buf) { return reinterpret_cast<T*>(bufs + buf * L::BUF); };
  auto xconv = [&](int buf) { return reinterpret_cast<int*>(bufs + buf * L::BUF + L::WCBUF); };
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int split = g.split;
  const int rank = split > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int row0 = (blockIdx.x / split) * BM, col0 = blockIdx.y * BN;
  const int k_lo = rank * g.kc, k_hi = min(g.K, k_lo + g.kc);
  const int steps = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  const int xp = g.xmode == X_FLAT ? g.K : XP;
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);
  const int wr_hi = PACKED ? k_hi / 2 : k_hi;           // weight byte rows end
  // X_GATHER: thread tid gathers row tid % BM of the tile, columns
  // kq GE .. kq GE + GE - 1 of each step (THREADS is a multiple of BM)
  const bool gather = g.xmode == X_GATHER;
  constexpr int KQ = THREADS / BM, GE = BK / KQ;
  const taps::Row grow = gather ? taps::row(cv, row0 + tid % BM, g.M) : taps::Row{};

  // the raw x and weight bytes of the K step at k0 into ring slot `slot`
  auto load = [&](int slot, int k0) {
    float* xs = xraw(slot);
    if (gather) {
      const int kq = tid / BM;
      taps::gather<GE>(xs + kq * GE * BM + tid % BM, BM, x, cv, grow, k0 + kq * GE, k_hi);
    } else if (g.xmode == X_FLAT) {                // one step: the tile's rows are one span
      const int span = min(BM, g.M - row0) * g.K;
      const float* src = x + (long long)row0 * g.K;
      for (int c = tid; c < (BM * g.K + 3) / 4; c += THREADS) {
        const int bytes = max(0, min(16, 4 * (span - 4 * c)));
        tc::cp_async16(xs + 4 * c, bytes ? src + 4 * c : x, bytes);
      }
    } else if (g.xmode == X_VEC) {
      for (int c = tid; c < BM * (BK / 4); c += THREADS) {
        const int r = c / (BK / 4), kq = c % (BK / 4) * 4, gk = k0 + kq;
        const bool in = row0 + r < g.M && gk < k_hi;
        tc::cp_async16(xs + r * XP + kq, in ? x + (long long)(row0 + r) * g.K + gk : x,
                       in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK, gk = k0 + kk;
        xs[r * XP + kk] = row0 + r < g.M && gk < k_hi ? x[(long long)(row0 + r) * g.K + gk] : 0.f;
      }
    }
    uint8_t* ws = wraw(slot);
    const int pr0 = PACKED ? k0 / 2 : k0;
    if (g.wvec) {
      for (int c = tid; c < WR * (BN / 16); c += THREADS) {
        const int r = c / (BN / 16), cb = c % (BN / 16) * 16, pr = pr0 + r;
        const bool in = pr < wr_hi && col0 + cb < g.N;
        tc::cp_async16(ws + r * BN + cb, in ? wb + (long long)pr * g.N + col0 + cb : wb,
                       in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < WR * BN; e += THREADS) {
        const int r = e / BN, n = e % BN, pr = pr0 + r;
        ws[e] = pr < wr_hi && col0 + n < g.N ? wb[(long long)pr * g.N + col0 + n] : 0;
      }
    }
  };

  // raw slot -> buffer `buf`: the weights as T, x staged (integer bodies)
  auto convert = [&](int slot, int buf) {
    const uint8_t* ws = wraw(slot);
    T* wc = wconv(buf);
    for (int i = tid; i < WR * BN / 4; i += THREADS) {
      const uint32_t b4 = *reinterpret_cast<const uint32_t*>(ws + 4 * i);
      int v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = (int)(int8_t)(uint8_t)(b4 >> (8 * k));
      if (PACKED) {           // byte row r: logical rows 2r (low nibble), 2r + 1 (high)
        const int r = i / (BN / 4), n = i % (BN / 4) * 4;
        int lo[4], hi[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          lo[k] = (int)(int8_t)(uint8_t)((uint32_t)v[k] << 4) >> 4;
          hi[k] = v[k] >> 4;
        }
        *reinterpret_cast<V*>(wc + 2 * r * BN + n) = vec4<V, T>(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<V*>(wc + (2 * r + 1) * BN + n) = vec4<V, T>(hi[0], hi[1], hi[2], hi[3]);
      } else {
        *reinterpret_cast<V*>(wc + 4 * i) = vec4<V, T>(v[0], v[1], v[2], v[3]);
      }
    }
    if constexpr (EPI != EPI_F32) {
      const float* xs = xraw(slot);
      int* xc = xconv(buf);
      if (gather) {           // [k][m] as gathered -> [m][k] staged, pitch XP
        for (int i = tid; i < BM * (BK / 4); i += THREADS) {
          const int r = i % BM, k = i / BM * 4;
          const float* t = xs + k * BM + r;
          *reinterpret_cast<int4*>(xc + r * XP + k) =
              stg::stage_int4(make_float4(t[0], t[BM], t[2 * BM], t[3 * BM]), xst);
        }
        return;
      }
      const bool flat = g.xmode == X_FLAT;
      const int pieces = flat ? (BM * g.K + 3) / 4 : BM * (BK / 4);
      for (int i = tid; i < pieces; i += THREADS) {
        const int off = flat ? 4 * i : i / (BK / 4) * XP + i % (BK / 4) * 4;
        *reinterpret_cast<int4*>(xc + off) =
            stg::stage_int4(*reinterpret_cast<const float4*>(xs + off), xst);
      }
    }
  };

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  // kn of the step's BK columns hold K (the flat span's pitch is K, so it
  // is read only that far).  COLS: x lies [k][m] (the float32 body's
  // gathered raw slot, read as it landed), else [m][k] with pitch xp
  auto compute = [&](int slot, int buf, int kn, auto cols) {
    constexpr bool COLS = decltype(cols)::value;
    const int rs = COLS ? 1 : xp, ks = COLS ? BM : 1;
    const T* xr;
    if constexpr (EPI == EPI_F32)
      xr = xraw(slot) + ty * rs;          // the float32 body reads x as it landed
    else
      xr = xconv(buf) + ty * rs;
    const T* wc = wconv(buf) + tx * TN;
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      const V b = *reinterpret_cast<const V*>(wc + kk * BN);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const T a = xr[i * TY * rs + kk * ks];
        mac(acc[i][0], a, b.x);
        mac(acc[i][1], a, b.y);
        mac(acc[i][2], a, b.z);
        mac(acc[i][3], a, b.w);
      }
    }
  };

  if (steps > 0) {
    load(0, k_lo);
    tc::cp_async_commit();
    if (steps > 1) load(1, k_lo + BK);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                   // step 0 has landed (this thread's copies)
    __syncthreads();
    convert(0, 0);
    for (int st = 0; st < steps; ++st) {
      tc::cp_async_wait<0>();                 // step st + 1 has landed
      __syncthreads();                        // buffer st converted; step st - 1 done with
      if (st + 2 < steps) load((st + 2) % STAGES, k_lo + (st + 2) * BK);
      tc::cp_async_commit();
      const int kn = min(BK, k_hi - k_lo - st * BK);
      if constexpr (EPI == EPI_F32) {
        if (gather)
          compute(st % STAGES, st & 1, kn, std::true_type{});
        else
          compute(st % STAGES, st & 1, kn, std::false_type{});
      } else {
        compute(st % STAGES, st & 1, kn, std::false_type{});
      }
      if (st + 1 < steps) convert((st + 1) % STAGES, (st + 1) & 1);
    }
  }

  if (split > 1) {
    // the partial tiles meet over the cluster: each CTA reduces its slice
    // of the tile in rank order and runs the epilogue on it
    cg::cluster_group cluster = cg::this_cluster();
    tc::cp_async_wait<0>();
    __syncthreads();                          // the ring is free
    T* red = reinterpret_cast<T*>(smem_raw);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) red[(ty + TY * i) * BN + tx * TN + j] = acc[i][j];
    cluster.sync();                           // every partial written and visible
    const int per = (BM * BN + split - 1) / split;
    const int e1 = min(BM * BN, (rank + 1) * per);
    with_mode<EPI>(rq, [&](auto mode) {
      constexpr int MODE = decltype(mode)::value;
      for (int e = rank * per + tid; e < e1; e += THREADS) {
        T v = *cluster.map_shared_rank(red + e, 0);
        for (int q = 1; q < split; ++q) v = add(v, *cluster.map_shared_rank(red + e, q));
        const int r = row0 + e / BN, c = col0 + e % BN;
        if (r < g.M && c < g.N) {
          const long long o = gather ? taps::out_row(cv, r, g.N) + (long long)c * cv.OH * cv.OW
                                     : (long long)r * g.N + c;
          out[o] = epi1<EPI, MODE>(v, c, s, s_stride, bias, rq);
        }
      }
    });
    cluster.sync();                           // no CTA leaves while its partials are read
    return;
  }

  // gathered: out is NCHW, so the tile goes through shared memory ([n][m],
  // pitch BM + 1) and then out along m, consecutive rows (consecutive ow)
  // to consecutive threads
  float* const tile = reinterpret_cast<float*>(smem_raw);
  if (gather) {
    tc::cp_async_wait<0>();
    __syncthreads();                          // the ring and the buffers are free
  }
  with_mode<EPI>(rq, [&](auto mode) {
    constexpr int MODE = decltype(mode)::value;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + ty + TY * i, c = col0 + tx * TN;
      if (r >= g.M) continue;
      float o[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        o[j] = c + j < g.N ? epi1<EPI, MODE>(acc[i][j], c + j, s, s_stride, bias, rq) : 0.f;
      if (gather) {
#pragma unroll
        for (int j = 0; j < TN; ++j) tile[(tx * TN + j) * (BM + 1) + ty + TY * i] = o[j];
        continue;
      }
      float* dst = out + (long long)r * g.N + c;
      if (g.ovec && c + TN <= g.N) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (c + j < g.N) dst[j] = o[j];
      }
    }
  });
  if (gather) {
    __syncthreads();
    const int r = row0 + tid % BM;
    if (r < g.M) {
      const long long ro = taps::out_row(cv, r, g.N), ohw = (long long)cv.OH * cv.OW;
      for (int c = tid / BM; c < BN && col0 + c < g.N; c += KQ)
        out[ro + (col0 + c) * ohw] = tile[c * (BM + 1) + tid % BM];
    }
  }
}

template <int BM, int BN, int TM, int TN, bool PACKED, int EPI>
int launch(const Geo& g, cudaStream_t st, const float* x, const int8_t* w, const void* s,
           const float* bias, float* out, int s_stride, const stg::Stage& xst,
           const b3::Req32& rq, const taps::Conv& cv) {
  using L = Layout<BM, BN, PACKED, EPI>;
  auto kernel = qmm_kernel<BM, BN, TM, TN, PACKED, EPI>;
  // the plan's size is the kernel's, a split's partials fit it, and so does
  // the gathered path's NCHW tile
  if (g.smem != L::bytes(g.stages, g.bufs) ||
      (g.split > 1 && BM * BN * 4 > g.stages * L::RAW) ||
      (g.xmode == X_GATHER && (BM + 1) * BN * 4 > g.smem))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // one device per process: opt in to the largest once
  constexpr int most = L::bytes(STAGES, 2);
  if (!attr_set && most > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
  }
  attr_set = true;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.tiles_m * g.split, g.tiles_n, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.split > 1 ? 1 : 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, x, w, s, bias, out, g, s_stride, xst, rq, cv);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool PACKED, int EPI>
int launch_tile(const Geo& g, cudaStream_t st, const float* x, const int8_t* w, const void* s,
                const float* bias, float* out, int s_stride, const stg::Stage& xst,
                const b3::Req32& rq, const taps::Conv& cv) {
  switch (g.tile) {
    case SMALL:
      return launch<16, 64, 1, 4, PACKED, EPI>(g, st, x, w, s, bias, out, s_stride, xst, rq, cv);
    case WIDE:
      return launch<64, 64, 4, 4, PACKED, EPI>(g, st, x, w, s, bias, out, s_stride, xst, rq, cv);
    case TALL:
      return launch<128, 32, 4, 4, PACKED, EPI>(g, st, x, w, s, bias, out, s_stride, xst, rq,
                                                cv);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool PACKED>
int launch_epi(int epi, const Geo& g, cudaStream_t st, const float* x, const int8_t* w,
               const void* s, const float* bias, float* out, int s_stride,
               const stg::Stage& xst, const b3::Req32& rq, const taps::Conv& cv) {
  if (epi == EPI_F32)
    return launch_tile<PACKED, EPI_F32>(g, st, x, w, s, bias, out, s_stride, xst, rq, cv);
  if (epi == EPI_I32)
    return launch_tile<PACKED, EPI_I32>(g, st, x, w, s, bias, out, s_stride, xst, rq, cv);
  return launch_tile<PACKED, EPI_B3>(g, st, x, w, s, bias, out, s_stride, xst, rq, cv);
}

}  // namespace cc

// the IntRequant's nine ints (read on the host) and the output scale, or
// none off the B3 body
b3::IntReq int_req(int epi, const int* rq, float out_mul) {
  if (epi != EPI_B3) return b3::IntReq{};
  return b3::IntReq{rq[0], rq[1], rq[2], rq[3], rq[4], rq[5], rq[6], rq[7], rq[8], out_mul};
}

// the conv geometry's 14 ints (read on the host; quant_conv.py ·
// CONV_GEO_FIELDS), or none; false where they do not describe an (M, K)
// operand of a conv over an x of fewer than 2^31 elements
bool conv_geo(const int* c, int M, int K, taps::Conv& cv) {
  cv = taps::Conv{};
  if (c == nullptr) return true;
  cv = taps::Conv{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9], c[10], c[11],
                  c[12], c[13]};
  for (int i = 0; i < 14; ++i)
    if (c[i] < (i < 12 ? 1 : 0)) return false;
  return (long long)cv.N * cv.OH * cv.OW == M && (long long)cv.C * cv.kh * cv.kw == K &&
         (long long)cv.N * cv.C * cv.H * cv.W < (1LL << 31);
}

}  // namespace

// K is the logical depth (the packed weight has K / 2 rows).  bias may be
// null.  geo: the plan's QMM_GEO_FIELDS; conv: null, or with the plan's
// X_GATHER mode the conv's geometry (x its NCHW input, out its NCHW output).  epi: 0 float32 body, 1 int32
// body with the float32 epilogue, 2 int32 body with B3 (s then holds int32
// multipliers and rq points at the 9 IntRequant ints, read on the host).
// On the integer bodies x is staged as round(x / in_div) by
// int_staging.cuh in mode stage_mode (in_mul: the exact reciprocal, read
// in RECIPROCAL mode).  Returns the launch's error, or cudaGetLastError()
// after it (0 = launched; a cluster the card refuses is an error).
extern "C" int qmm_launch(const float* x, const int8_t* w, const void* s, const float* bias,
                          float* out, const int* geo, int s_stride, int packed, int epi,
                          float in_div, float in_mul, int stage_mode, const int* rq,
                          float out_mul, const int* conv, void* stream) {
  if (epi < EPI_F32 || epi > EPI_B3) return (int)cudaErrorInvalidValue;
  const cc::Geo g{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], geo[6],
                  geo[7], geo[8], geo[9], geo[10], geo[11], geo[12], geo[13]};
  if (g.M <= 0 || g.N <= 0) return (int)cudaGetLastError();
  // every CTA's K steps must fit the ring: at most `stages` of them unless
  // the ring is whole (3 slots, 2 buffers)
  const int most_steps = (g.kc + cc::BK - 1) / cc::BK;
  if (g.split < 1 || g.split > 8 || g.kc < cc::BK || g.kc % cc::BK != 0 ||
      g.stages < 1 || g.stages > cc::STAGES || g.bufs != (g.stages < 2 ? 1 : 2) ||
      (g.stages < cc::STAGES && most_steps > g.stages) ||
      (g.xmode == cc::X_FLAT && (g.split != 1 || g.K >= cc::BK)) ||
      (g.xmode == cc::X_GATHER) != (conv != nullptr))
    return (int)cudaErrorInvalidValue;
  taps::Conv cv;
  if (!conv_geo(conv, g.M, g.K, cv)) return (int)cudaErrorInvalidValue;
  const b3::Req32 r = b3::make_req32(int_req(epi, rq, out_mul));
  const stg::Stage xst = stg::make_stage(in_div, in_mul, stage_mode);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed) return cc::launch_epi<true>(epi, g, st, x, w, s, bias, out, s_stride, xst, r, cv);
  return cc::launch_epi<false>(epi, g, st, x, w, s, bias, out, s_stride, xst, r, cv);
}

// B2's integer body on the int8 tensor cores (qmm_i8_kernel): w is the
// (K / 2, N) packing, K even; epi 1 (float32 epilogue) or 2 (B3, rq as for
// qmm_launch).  Each x element is multiplied by in_mul when in_mul != 0 (the
// exact reciprocal of a power-of-two in_div, checked on the host), else
// divided by in_div.  Every staged code must lie in [-128, 127] (the
// lowering's proof).  conv: null, or the conv's geometry, x then its NCHW
// input and out its NCHW output.  Returns cudaGetLastError() after the
// launch.
extern "C" int qmm_i8_launch(const float* x, const int8_t* w, const void* s, const float* bias,
                             float* out, int M, int K, int N, int s_stride, int epi,
                             float in_div, float in_mul, const int* rq, float out_mul,
                             const int* conv, void* stream) {
  taps::Conv cv;
  if ((epi != EPI_I32 && epi != EPI_B3) || (K & 1) || !conv_geo(conv, M, K, cv))
    return (int)cudaErrorInvalidValue;
  const tc::Req e =
      b3::make_req32(int_req(epi, rq, out_mul));
  const tc::Stage xst =
      stg::make_stage(in_div, in_mul, in_mul != 0.f ? stg::RECIPROCAL : stg::QUOTIENT);
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const dim3 grid((M + tc::BM - 1) / tc::BM, (N + tc::BN - 1) / tc::BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gather = conv != nullptr;
  if (epi == EPI_I32)
    return tc::launch_i8_k<EPI_I32>(grid, st, x, w, s, bias, out, M, K, N, s_stride, xst, e, cv,
                                    gather);
  return tc::launch_i8_k<EPI_B3>(grid, st, x, w, s, bias, out, M, K, N, s_stride, xst, e, cv,
                                 gather);
}
