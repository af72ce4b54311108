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
// (B, C, KV, hd) cache, and the output is written in q's layout.  Query
// head h reads KV head h / G in place (K and V are never repeated per query
// head); query tiles are launched heaviest first (the bf16 body makes the
// tile the slowest grid axis, so that holds across heads and batches); the
// key tiles above the causal diagonal are skipped, as the reference skips
// its blocks.
//
// Bound on the card: operations.  The two products do 4·hd operations per
// (query, key) pair, about S²/2 pairs under the causal mask, against q, k, v
// and out moved once, (2·Sq + 2·Sk)·hd elements: at the LM's prefill
// lengths (S in the thousands, hd 128) that is hundreds of operations per
// byte, above the bf16 tensor cores' ridge of 989e12 / 3.35e12 = 295 per
// byte, and far above the float32 CUDA cores' 67e12 / 3.35e12 = 20.
//
// Two bodies, one per input type; both keep the roundings of the reference
// that move bits: the -1e30 mask fill (a masked key adds exp(-1e30 - m) = 0
// once a row has seen key 0, which every tile loop does first), float32
// softmax state, the output acc / max(l, 1e-30) as an IEEE division,
// rounded once to the output type to nearest even.  Keys past Sk and query
// rows past Sq are masked (ragged lengths need no padding).
//
// bf16 (fa_bf16_kernel): the products on the bf16 tensor cores, FA2-style
// on mma.sync.m16n8k16 with float32 accumulation.  One block of 4 warps
// owns a 64-row query tile of one (batch, head); each warp owns 16 rows and
// keeps their Q fragments in registers (read once with ldmatrix).  K and V
// tiles of 64 keys are staged with 16-byte cp.async into shared memory rows
// padded by 16 bytes (so ldmatrix's eight row reads hit distinct banks),
// double-buffered: tile j + 1 is in flight while tile j is multiplied.
// S = Q·K^T is exact products of bf16 values summed in float32; the scale,
// with log2(e) folded in, multiplies the float32 scores after the dot (q·scale
// cannot feed a bf16 operand exactly), so the softmax takes exp2f of
// s·scale·log2e - m.  The softmax runs on the accumulator fragments in
// registers: a row's 64 scores lie on the 4 threads of a quad, whose max
// and sum reduce with two __shfl_xor_sync; a warp whose row maxima did not
// move skips the rescale of its accumulator (a factor of exactly 1).  P·V
// reuses the score fragments as the A operand (m16n8k16's C layout is its
// A layout pairwise) and reads V through ldmatrix.trans.  P is split into
// two bf16 parts, p_hi = bf16(p)
// and p_lo = bf16(p - p_hi), multiplied into one float32 accumulator: 1.5x
// the tensor-core work of one bf16 P, and P carries a relative error of
// about 2^-16 instead of 2^-9, which keeps the result within one bf16 step
// of the float32 twin.  l sums the float32 p.  The wrapper guarantees the
// 16-byte alignment of every row the copies read.
//
// float32 (fa_kernel): the products on the float32 CUDA cores (no TF32),
// one block of 256 threads per (q tile of 64 rows, head, batch); K
// (transposed) and V tiles of 64 keys are staged in shared memory.  Thread
// (ty, tx) of the 16 x 16 grid owns query rows ty + 16 i (i < 4): it
// computes the scores of keys tx + 16 j (j < 4) and the output columns
// tx + 16 j (j < hd / 16); the row max and row sum are reduced over the 16
// threads of a row with shuffles, and the probabilities go through shared
// memory (over the K tile, which is no longer needed) into the P·V
// product.  q is cast to float32 and multiplied by the float32 1/sqrt(hd)
// before the dot, and exp is the accurate expf, as in the reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr float NEG = -1e30f;

// ------------------------------------------------------------ float32 body

constexpr int THREADS = 256;     // a 16 x 16 thread grid
constexpr int RPT = BQ / 16;     // query rows per thread
constexpr int CPT = BK / 16;     // score columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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


// --------------------------------------------------------------- bf16 body

using bf16 = __nv_bfloat16;
constexpr int TC_WARPS = 4;               // 16 query rows each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int PAD = 8;                    // bf16 padding per shared row: 16 bytes

// shared memory: Q [BQ][HD + PAD], K [2][BK][HD + PAD], V [2][BK][HD + PAD]
template <int HD>
constexpr int tc_smem_bytes() {
  return (BQ + 4 * BK) * (HD + PAD) * (int)sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; `full` false writes 16 zero bytes, reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
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
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// (x, y) -> the bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y);
// x - hi.x is exact in float32
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(x, __low2float(h)), __fsub_rn(y, __high2float(h))));
}

// rows r0 .. r0 + 63 of a (rows, HD) operand with row stride rs into a
// shared tile of row stride HD + PAD; rows at or past n_valid are zeroed
template <int HD>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base, long long rs, int r0,
                                          int n_valid, int tid) {
  constexpr int CHUNKS = HD / 8;          // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < BK * CHUNKS / TC_THREADS; ++i) {
    const int c = tid + i * TC_THREADS;
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const bool ok = r0 + r < n_valid;
    const bf16* src = ok ? base + (long long)(r0 + r) * rs + col : base;
    cp_async16(smem_addr(tile + r * (HD + PAD) + col), src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 2)
fa_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int G, int Sq, int Sk,
               float scale_log2, int causal, long long qsb, long long qsh, long long qss,
               long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
               long long vss, long long osb, long long osh, long long oss) {
  constexpr int LD = HD + PAD;
  constexpr int KSTEPS = HD / 16;         // k-steps of S = Q K^T
  constexpr int STILES = BK / 8;          // score n-tiles per key tile
  constexpr int OTILES = HD / 8;          // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;                // two buffers of BK rows
  bf16* Vs = Ks + 2 * BK * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  // the query tile is the slowest grid axis: every head's heaviest tile first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / G;
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + kvh * ksh;
  const bf16* vb = v + b * vsb + kvh * vsh;

  // causal: no query row of this tile sees a key past its last row
  const int q_last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  const int k_end = causal ? (q_last + 1 < Sk ? q_last + 1 : Sk) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  load_tile<HD>(Qs, qb, qss, q0, Sq, tid);
  load_tile<HD>(Ks, kb, kss, 0, Sk, tid);
  load_tile<HD>(Vs, vb, vss, 0, Sk, tid);
  cp_async_commit();

  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  uint32_t qf[KSTEPS][4];
  float acc[OTILES][4];
#pragma unroll
  for (int j = 0; j < OTILES; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_lo = NEG, m_hi = NEG, l_lo = 0.f, l_hi = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n_tiles) {               // the next tile's copies overlap this tile
      const int nb = (it + 1) & 1;
      load_tile<HD>(Ks + nb * BK * LD, kb, kss, k0 + BK, Sk, tid);
      load_tile<HD>(Vs + nb * BK * LD, vb, vss, k0 + BK, Sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();                   // this tile (and Q) has landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldmatrix_x4(smem_addr(Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8),
                    qf[ks]);
    }
    const bf16* Kt = Ks + (it & 1) * BK * LD;
    const bf16* Vt = Vs + (it & 1) * BK * LD;

    // S = Q K^T: a 16 x 64 score block per warp
    float s[STILES][4];
#pragma unroll
    for (int j = 0; j < STILES; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < STILES / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(smem_addr(Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                              ((lane >> 3) & 1) * 8),
                    bk);
        mma_bf16(s[2 * np], qf[ks], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[ks], bk[2], bk[3]);
      }
    }

    // scale (in log2 units), then mask the ragged edge and the diagonal tile
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + warp * 16);
    float mx_lo = NEG, mx_hi = NEG;
#pragma unroll
    for (int j = 0; j < STILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[j][e], scale_log2);
        if (masked) {
          const int kp = k0 + j * 8 + 2 * t + (e & 1);
          const int qp = e < 2 ? row_lo : row_hi;
          if (kp >= Sk || (causal && kp > qp)) x = NEG;
        }
        s[j][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = exp2f(__fsub_rn(m_lo, mn_lo));
    const float corr_hi = exp2f(__fsub_rn(m_hi, mn_hi));
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < STILES; ++j) {
      s[j][0] = exp2f(__fsub_rn(s[j][0], mn_lo));
      s[j][1] = exp2f(__fsub_rn(s[j][1], mn_lo));
      s[j][2] = exp2f(__fsub_rn(s[j][2], mn_hi));
      s[j][3] = exp2f(__fsub_rn(s[j][3], mn_hi));
      rs_lo = __fadd_rn(rs_lo, __fadd_rn(s[j][0], s[j][1]));
      rs_hi = __fadd_rn(rs_hi, __fadd_rn(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rs_lo = __fadd_rn(rs_lo, __shfl_xor_sync(0xffffffffu, rs_lo, off));
      rs_hi = __fadd_rn(rs_hi, __shfl_xor_sync(0xffffffffu, rs_hi, off));
    }
    l_lo = __fadd_rn(__fmul_rn(l_lo, corr_lo), rs_lo);
    l_hi = __fadd_rn(__fmul_rn(l_hi, corr_hi), rs_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    // a factor of 1 (no row max of the warp moved) leaves acc as it is
    if (__any_sync(0xffffffffu, corr_lo != 1.f || corr_hi != 1.f)) {
#pragma unroll
      for (int j = 0; j < OTILES; ++j) {
        acc[j][0] = __fmul_rn(acc[j][0], corr_lo);
        acc[j][1] = __fmul_rn(acc[j][1], corr_lo);
        acc[j][2] = __fmul_rn(acc[j][2], corr_hi);
        acc[j][3] = __fmul_rn(acc[j][3], corr_hi);
      }
    }

    // acc += (P_hi + P_lo) V, P's fragments straight from the scores'
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < OTILES / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(smem_addr(Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                    dp * 16 + (lane >> 4) * 8),
                          bv);
        mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();                      // every read of this buffer is done
  }

  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int j = 0; j < OTILES; ++j) {
    const int col = j * 8 + 2 * t;
    if (row_lo < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_lo * oss + col) =
          __floats2bfloat162_rn(__fdiv_rn(acc[j][0], den_lo), __fdiv_rn(acc[j][1], den_lo));
    if (row_hi < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_hi * oss + col) =
          __floats2bfloat162_rn(__fdiv_rn(acc[j][2], den_hi), __fdiv_rn(acc[j][3], den_hi));
  }
}

// ------------------------------------------------------------------ launch

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int G, int Sq,
               int Sk, float scale, int causal, const long long* st, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  static bool attr_set = false;  // one device per process: set the opt-in once
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(fa_kernel<float, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_kernel<float, HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), G, Sq, Sk, scale, causal, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int G,
                int Sq, int Sk, float scale, int causal, const long long* st,
                cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(fa_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  // the scores in log2 units: exp(s - m) = exp2(s·log2e - m·log2e)
  const float scale_log2 = scale * 1.44269504088896340736f;
  fa_bf16_kernel<HD><<<grid, TC_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), G, Sq, Sk, scale_log2, causal, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int H, int G,
              int Sq, int Sk, float scale, int causal, const long long* st, cudaStream_t s) {
#define FA_CASE(D)                                                                    \
  case D:                                                                             \
    return BF16 ? launch_bf16<D>(q, k, v, o, B, H, G, Sq, Sk, scale, causal, st, s)  \
                : launch_f32<D>(q, k, v, o, B, H, G, Sq, Sk, scale, causal, st, s);
  switch (hd) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// q (B, H, Sq, hd), k / v (B, KV, Sk, hd), o (B, H, Sq, hd); strides in elements
// (batch, head, position; the last dimension is contiguous).  dtype: 0 float32,
// 1 bfloat16 (q, k, v and o alike; every row the bf16 body reads or writes
// starts on 16 bytes, as the wrapper checks).  Returns cudaGetLastError()
// after the launch (0 = launched).
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
    return launch_hd<false>(hd, q, k, v, o, B, H, H / KV, Sq, Sk, scale, causal, st, s);
  if (dtype == 1)
    return launch_hd<true>(hd, q, k, v, o, B, H, H / KV, Sq, Sk, scale, causal, st, s);
  return (int)cudaErrorInvalidValue;
}
