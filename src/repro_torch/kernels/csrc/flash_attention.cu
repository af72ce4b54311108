// B7: flash attention, causal or full, GQA (repro_torch/kernels/flash_attention.py).
//
// Replaces the Pallas kernel `_flash_kernel` of repro/kernels/flash_attention.py:
//   out[b, h] = softmax(q[b, h] k[b, h / G]^T / sqrt(hd) [+ causal mask]) v[b, h / G]
// with the online softmax: per query row a running max m, a running sum l
// and an accumulator acc, all float32, rescaled by exp(m_prev - m_new) as
// each key tile arrives, so the (Sq, Sk) score matrix never reaches device
// memory.  q is (B, H, Sq, hd), k and v (B, KV, Sk, hd), H = KV * G; every
// tensor comes with its own strides (the last dimension contiguous), so the
// model passes transposed views of its (B, S, H, hd) activations and of its
// (B, C, KV, hd) cache, and the output is written in q's layout.
//
// Bound on the card: operations.  The two products do 4·hd operations per
// (query, key) pair, about S²/2 pairs under the causal mask, against q, k, v
// and out moved once, (2·Sq + 2·Sk)·hd elements: at the LM's prefill
// lengths (S in the thousands, hd 128) that is hundreds of operations per
// byte, far above the card's float32 ridge of 67e12 / 3.35e12 = 20 per
// byte.  This kernel's products run on the float32 CUDA cores
// (67 TFLOP/s), not yet on the tensor cores.
//
// Design (simple first): one block of 256 threads per (q tile of 64 rows,
// head, batch).  A loop walks the key tiles of 64 keys up to the causal
// diagonal (the tiles above it are skipped, as the reference skips its
// blocks); K (transposed) and V tiles are staged in shared memory as
// float32.  Thread (ty, tx) of the 16 x 16 grid owns query rows ty + 16 i
// (i < 4): it computes the scores of keys tx + 16 j (j < 4) and the output
// columns tx + 16 j (j < hd / 16); the row max and row sum are reduced over
// the 16 threads of a row with shuffles, and the probabilities go through
// shared memory (over the K tile, which is no longer needed) into the P·V
// product.  Query head h reads KV head h / G in place: K and V are never
// repeated per query head.  Query tiles are launched heaviest first.
//
// Rounding follows the reference where it moves bits: q is cast to float32
// and multiplied by the float32 1/sqrt(hd) before the dot; the mask fill is
// -1e30 (a masked key adds exp(-1e30 - m) = 0 once a row has seen key 0,
// which every tile loop does first); exp is the accurate expf; the output is
// acc / max(l, 1e-30) as an IEEE division, rounded to the output type to
// nearest even.  Keys past Sk and query rows past Sq are masked (ragged
// lengths need no padding).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;     // a 16 x 16 thread grid
constexpr int RPT = BQ / 16;     // query rows per thread
constexpr int CPT = BK / 16;     // score columns per thread
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// shared memory floats: Qs [BQ][HD + 1], Kt/Ps [max(HD, BQ)][BK + 1], Vs [BK][HD]
template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + (HD > BQ ? HD : BQ) * (BK + 1) + BK * HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int G, int Sq, int Sk, float scale, int causal,
          long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
          long long kss, long long vsb, long long vsh, long long vss, long long osb,
          long long osh, long long oss) {
  constexpr int DPT = HD / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                          // q * scale
  float* Kt = Qs + BQ * (HD + 1);            // K tile, transposed
  float* Vs = Kt + (HD > BQ ? HD : BQ) * (BK + 1);
  float* Ps = Kt;                            // probabilities, over the used K tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    float x = 0.f;
    if (q0 + r < Sq) x = __fmul_rn(to_f32(qb[(q0 + r) * qss + d]), scale);
    Qs[r * (HD + 1) + d] = x;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // causal: no query row of this tile sees a key past its last row
  const int q_last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  const int k_end = causal ? (q_last + 1 < Sk ? q_last + 1 : Sk) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();             // the previous tile's P and V reads are done
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int c = i / HD, d = i - c * HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Sk) {
        kx = to_f32(kb[(k0 + c) * kss + d]);
        vx = to_f32(vb[(k0 + c) * vss + d]);
      }
      Kt[d * (BK + 1) + c] = kx;
      Vs[c * HD + d] = vx;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[RPT], ka[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qa[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) ka[j] = Kt[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= Sk || (causal && kp > qp)) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(__fsub_rn(m[i], m_new));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], m_new));
        rs = __fadd_rn(rs, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      l[i] = __fadd_rn(__fmul_rn(l[i], corr), rs);
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = __fmul_rn(acc[i][j], corr);
      m[i] = m_new;
    }

    __syncthreads();             // every score read of the K tile is done
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[RPT], va[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pa[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) va[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < Sq) {
      const float den = fmaxf(l[i], 1e-30f);
      T* orow = o + b * osb + h * osh + r * oss;
#pragma unroll
      for (int j = 0; j < DPT; ++j) store(orow + tx + 16 * j, __fdiv_rn(acc[i][j], den));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int G, int Sq,
           int Sk, float scale, int causal, const long long* st, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  static bool attr_set = false;  // one device per process: set the opt-in once
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(fa_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), G, Sq, Sk, scale, causal, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int H, int G,
              int Sq, int Sk, float scale, int causal, const long long* st, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, G, Sq, Sk, scale, causal, st, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, G, Sq, Sk, scale, causal, st, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, G, Sq, Sk, scale, causal, st, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, G, Sq, Sk, scale, causal, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, hd), k / v (B, KV, Sk, hd), o (B, H, Sq, hd); strides in elements
// (batch, head, position; the last dimension is contiguous).  dtype: 0 float32,
// 1 bfloat16 (q, k, v and o alike).  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int KV, int Sq, int Sk, int hd, int dtype, int causal, float scale,
                         long long qsb, long long qsh, long long qss, long long ksb,
                         long long ksh, long long kss, long long vsb, long long vsh,
                         long long vss, long long osb, long long osh, long long oss,
                         void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, H, H / KV, Sq, Sk, scale, causal, st, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, H / KV, Sq, Sk, scale, causal, st, s);
  return (int)cudaErrorInvalidValue;
}
