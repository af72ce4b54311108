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
// B6 replaces `_dw_kernel` (`quant_depthwise_conv2d`):
//   acc[n, c, oh, ow] = sum_{i, j} x[n, c, oh*sh - pt + i*dh, ow*sw - pl + j*dw] * w[i*kW + j, c]
//   y = acc * s[c] (rounded); y += b[c]; y = max(y, 0); y = (q - qz) * qs,
//   q = clip(round_mode(y / qs + qz), lo, hi)       (each step optional)
//
// Both have B1's three bodies (quant_matmul.cu): EPI_F32 a float32 dot,
// then (acc * s) rounded, + bias; EPI_I32 an int32 dot of the integer
// values of x / in_div, then float(acc) * s, + bias; EPI_B3 the same dot,
// then the integer epilogue B3 (int_epilogue.cuh) with s holding int32
// multipliers (on B6 B3 is the whole epilogue).  The integer bodies stage
// x by int_staging.cuh, B2's helper: one multiply at a power-of-two scale,
// else an exact-quotient check, else the IEEE division, each with
// __fdiv_rn's bits, once per staged element.
//
// Both are bound by bytes on this card: B6's 13 MobileNet-224 layers at 8
// rows do ~370 M operations against ~160 MB, B5 at the grouped conv's shape
// (8 x 25088 x 72 x 8) ~231 M against ~64 MB, 2-4 operations per byte where
// the card's balance is ~20 float32 operations per byte.  So the designs
// read each byte once, coalesced and 16 bytes at a time where the layout
// allows, convert each staged element once, and give every block enough
// work; the products stay on the CUDA cores (FMA, IMAD).
//
// B6 (dw_kernel).  A block owns an output tile; its geometry comes from
// the host plan `dw_launch_plan` (quant_grouped_conv.py), passed in as
// DwGeo.  Large planes take 2-D tiles of one plane (tile mode): the input
// window of the tile, its halo included, is staged into shared memory by
// 16-byte cp.async from a start floored to 16 bytes (W % 4 == 0: each
// 16-byte piece lies wholly inside a row or wholly in the padding, which
// the copy zero-fills) or by scalar loads.  Small planes go several
// consecutive (n, c) planes to a block (flat mode): in NCHW they are one
// contiguous span, copied flat (16-byte cp.async where the span lies on 16
// bytes) and read as it lies, the padding read as zeros by predicate (a
// padded copy cost a second pass over shared memory and a barrier, which
// at these sizes, one wave of blocks, is the block's critical path).  The
// integer bodies convert each staged element to its int32 value once, in
// place (int32 and not int16: any code the twin takes fits, no range proof
// is needed, and the tile is the float32 body's size).  Each thread then
// computes R outputs down one column: lanes hold consecutive columns, so
// the tap reads of a warp hit consecutive words (conflict-free at stride
// 1; the plan pads the row and plane pitches against conflicts between
// the warp's row groups), and a 3x3 kernel at row stride 1 or 2
// reads each staged row of its window once into registers for every
// output that uses it (FAST), 3 reads a row instead of 3 per output.  The
// float32 body keeps the twin's order: each output sums its taps in (kh,
// kw) row-major order, products and sums rounded apart (__fmul_rn,
// __fadd_rn); a zero of the padding (stored or read by predicate) adds
// +-0 there, as the twin's 0 * w.
// Outputs are written by consecutive lanes to consecutive columns.
//
// B5 (gqmm_kernel).  A block of GQ_BM threads owns GQ_BM rows of one group
// and BN (8, 16 or 32, the smallest that holds Ng; wider Ng takes several
// column tiles) columns: the tile follows Ng, so no lane computes padding
// columns of a 32-wide tile.  Each K slice (the whole Kg up to 128) stages
// the rows of x by 16-byte cp.async straight from the strided im2col view
// where Kg % 4 == 0 and the row and group offsets are on 16 bytes, else
// element by element, walking the tile with incremental indices (no / or %
// per element); the group's weight slice is staged (int4 unpacked) once per
// block and shared by every row.  A thread owns one row and keeps BN
// accumulators; it reads its x four at a time (the row pitch keeps the
// 16-byte reads of 8 lanes on distinct banks) and the weights as broadcast
// 16-byte reads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_epilogue.cuh"
#include "int_staging.cuh"
#include "qdq_round.cuh"

namespace {

enum Epi { EPI_F32 = 0, EPI_I32 = 1, EPI_B3 = 2 };

template <int EPI>
struct Acc {
  using T = int;
  using V4 = int4;
};
template <>
struct Acc<EPI_F32> {
  using T = float;
  using V4 = float4;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}


// one staged element: float32 as it is, or its integer value
template <int EPI>
__device__ __forceinline__ typename Acc<EPI>::T stage1(float v, const stg::Stage& st) {
  if (EPI == EPI_F32) return v;
  return stg::stage_int(v, st);
}

// a tile of floats converted in place to integer values, four at a time
__device__ __forceinline__ void convert4(void* p, const stg::Stage& st) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  *reinterpret_cast<int4*>(p) = stg::stage_int4(f, st);
}

// acc += v * w: float32 rounded apart (the twins' order), or int32
template <int EPI>
__device__ __forceinline__ void mac(typename Acc<EPI>::T& acc, typename Acc<EPI>::T v,
                                    typename Acc<EPI>::T w) {
  if (EPI == EPI_F32)
    acc = __fadd_rn(acc, __fmul_rn(v, w));
  else
    acc += v * w;
}

// the fp32 epilogue's act requant, its rounding mode a launch constant
__device__ __forceinline__ float quantize_mode(int mode, float y, float qs, float qz, float lo,
                                               float hi) {
  switch (mode) {
    case qdq::CEIL: return qdq::quantize<qdq::CEIL>(y, qs, qz, lo, hi);
    case qdq::FLOOR: return qdq::quantize<qdq::FLOOR>(y, qs, qz, lo, hi);
    case qdq::UP: return qdq::quantize<qdq::UP>(y, qs, qz, lo, hi);
    case qdq::DOWN: return qdq::quantize<qdq::DOWN>(y, qs, qz, lo, hi);
    case qdq::HALF_UP: return qdq::quantize<qdq::HALF_UP>(y, qs, qz, lo, hi);
    case qdq::HALF_DOWN: return qdq::quantize<qdq::HALF_DOWN>(y, qs, qz, lo, hi);
    default: return qdq::quantize<qdq::ROUND>(y, qs, qz, lo, hi);
  }
}

// what a launch's epilogue needs
struct Epilogue {
  const void* s;            // float32 scales, or int32 multipliers (EPI_B3)
  const float* bias;        // or null
  const float* qs;          // act requant scale / zero point (device), act only
  const float* qz;
  int s_stride, relu, act, mode;
  float lo, hi;
  b3::Req32 rq;             // B3 (rq.rq) and its 32-bit path (B6)
  stg::Stage st;
};

b3::IntReq int_req(int epi, const int* rq, float out_mul) {
  if (epi != EPI_B3) return b3::IntReq{};
  return b3::IntReq{rq[0], rq[1], rq[2], rq[3], rq[4], rq[5], rq[6], rq[7], rq[8], out_mul};
}

// the dynamic shared memory opt-in above 48 KB, set once per kernel and size
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

// ------------------------------------------------------------------ B5

constexpr int GQ_BM = 128;    // rows per block, one per thread

// the host plan's geometry (quant_grouped_conv.py · gqmm_launch_plan)
struct GqGeo {
  int G, M, Kg, Ng, BN, KS, pitch, vec, ovec, col_tiles, smem;
};

template <bool PACKED, int EPI, int BN>
__global__ void __launch_bounds__(GQ_BM)
gqmm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w, float* __restrict__ out,
            GqGeo g, long long x_gs, long long x_rs, long long o_gs, long long o_rs, Epilogue e) {
  using T = typename Acc<EPI>::T;
  using V4 = typename Acc<EPI>::V4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);            // [GQ_BM][pitch]
  T* ws = xs + GQ_BM * g.pitch;                       // [KS][BN]
  const int tid = threadIdx.x, grp = blockIdx.z;
  const int row0 = blockIdx.x * GQ_BM, n0 = blockIdx.y * BN;
  const int rows = min(GQ_BM, g.M - row0);
  const float* xg = x + grp * x_gs + (long long)row0 * x_rs;
  const int8_t* wg = w + (long long)grp * (PACKED ? g.Kg / 2 : g.Kg) * g.Ng;
  T acc[BN];
#pragma unroll
  for (int n = 0; n < BN; ++n) acc[n] = T(0);

  for (int k0 = 0; k0 < g.Kg; k0 += g.KS) {
    const int ks = min(g.KS, g.Kg - k0);           // columns of x in this slice
    const int ks4 = (ks + 3) & ~3;                 // staged, zero-filled to 4
    const int cpr = ks4 >> 2;                      // 16-byte pieces per row
    // this thread's pieces: (r, c) from tid, then + GQ_BM each time
    const int dr = GQ_BM / cpr, dc = GQ_BM - dr * cpr;
    if (g.vec) {
      int r = tid / cpr, c = tid - r * cpr;
      for (; r < GQ_BM; r += dr) {
        const bool in = r < rows;
        cp_async16(xs + r * g.pitch + 4 * c, in ? xg + r * x_rs + k0 + 4 * c : x, in ? 16 : 0);
        c += dc;
        if (c >= cpr) { c -= cpr; ++r; }
      }
      cp_async_wait_all();
      if (EPI != EPI_F32) {                       // the same pieces, converted in place
        for (r = tid / cpr, c = tid - r * cpr; r < GQ_BM; r += dr) {
          convert4(xs + r * g.pitch + 4 * c, e.st);
          c += dc;
          if (c >= cpr) { c -= cpr; ++r; }
        }
      }
    } else {
      // element by element: piece (r, c) covers columns 4c .. 4c + 3
      for (int r = tid / cpr, c = tid - r * cpr; r < GQ_BM; r += dr) {
        const float* src = xg + r * x_rs + k0 + 4 * c;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xs[r * g.pitch + 4 * c + j] =
              r < rows && 4 * c + j < ks ? stage1<EPI>(src[j], e.st) : T(0);
        c += dc;
        if (c >= cpr) { c -= cpr; ++r; }
      }
    }
    // the group's weight slice, unpacked, zero beyond Kg and Ng
    for (int i = tid; i < ks4 * BN; i += GQ_BM) {
      const int kk = i / BN, n = i % BN;           // BN a power of two
      const int gk = k0 + kk, gn = n0 + n;
      int v = 0;
      if (kk < ks && gn < g.Ng) {
        if (PACKED) {
          const int b = wg[(long long)(gk >> 1) * g.Ng + gn];
          v = (gk & 1) ? (b >> 4) : ((int)(int8_t)(b << 4) >> 4);
        } else {
          v = wg[(long long)gk * g.Ng + gn];
        }
      }
      ws[i] = T(v);
    }
    __syncthreads();
    const T* xr = xs + tid * g.pitch;
    for (int kk = 0; kk < ks4; kk += 4) {
      const V4 a = *reinterpret_cast<const V4*>(xr + kk);
      const T av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T* wr = ws + (kk + j) * BN;
#pragma unroll
        for (int n = 0; n < BN; n += 4) {
          const V4 b = *reinterpret_cast<const V4*>(wr + n);
          if (EPI == EPI_F32) {
            acc[n] = fmaf(av[j], b.x, acc[n]);
            acc[n + 1] = fmaf(av[j], b.y, acc[n + 1]);
            acc[n + 2] = fmaf(av[j], b.z, acc[n + 2]);
            acc[n + 3] = fmaf(av[j], b.w, acc[n + 3]);
          } else {
            acc[n] += av[j] * b.x;
            acc[n + 1] += av[j] * b.y;
            acc[n + 2] += av[j] * b.z;
            acc[n + 3] += av[j] * b.w;
          }
        }
      }
    }
    __syncthreads();
  }

  if (tid >= rows) return;
  float* op = out + grp * o_gs + (long long)(row0 + tid) * o_rs + n0;
#pragma unroll
  for (int n = 0; n < BN; n += 4) {
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = grp * g.Ng + n0 + n + j;
      if (n0 + n + j >= g.Ng) {
        o[j] = 0.f;
      } else if (EPI == EPI_B3) {
        o[j] = b3::int_epilogue((int)acc[n + j], static_cast<const int*>(e.s)[ch * e.s_stride],
                                e.rq.rq);
      } else {
        const float a = EPI == EPI_F32 ? (float)acc[n + j] : __int2float_rn((int)acc[n + j]);
        o[j] = __fmul_rn(a, static_cast<const float*>(e.s)[ch * e.s_stride]);
      }
      if (e.bias != nullptr && n0 + n + j < g.Ng) o[j] = __fadd_rn(o[j], e.bias[ch]);
    }
    if (g.ovec && n0 + n + 4 <= g.Ng) {
      *reinterpret_cast<float4*>(op + n) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + n + j < g.Ng) op[n + j] = o[j];
    }
  }
}

template <bool PACKED, int EPI, int BN>
int gqmm_go(const GqGeo& g, cudaStream_t st, const float* x, const int8_t* w, float* out,
            long long x_gs, long long x_rs, long long o_gs, long long o_rs, const Epilogue& e) {
  static int allowed = 0;
  auto kernel = gqmm_kernel<PACKED, EPI, BN>;
  const cudaError_t err = allow_smem(kernel, g.smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.M + GQ_BM - 1) / GQ_BM, g.col_tiles, g.G);
  kernel<<<grid, GQ_BM, g.smem, st>>>(x, w, out, g, x_gs, x_rs, o_gs, o_rs, e);
  return (int)cudaGetLastError();
}

template <bool PACKED, int EPI>
int gqmm_bn(const GqGeo& g, cudaStream_t st, const float* x, const int8_t* w, float* out,
            long long x_gs, long long x_rs, long long o_gs, long long o_rs, const Epilogue& e) {
  if (g.BN == 8) return gqmm_go<PACKED, EPI, 8>(g, st, x, w, out, x_gs, x_rs, o_gs, o_rs, e);
  if (g.BN == 16) return gqmm_go<PACKED, EPI, 16>(g, st, x, w, out, x_gs, x_rs, o_gs, o_rs, e);
  if (g.BN == 32) return gqmm_go<PACKED, EPI, 32>(g, st, x, w, out, x_gs, x_rs, o_gs, o_rs, e);
  return (int)cudaErrorInvalidValue;
}

template <bool PACKED>
int gqmm_epi(int epi, const GqGeo& g, cudaStream_t st, const float* x, const int8_t* w,
             float* out, long long x_gs, long long x_rs, long long o_gs, long long o_rs,
             const Epilogue& e) {
  if (epi == EPI_F32) return gqmm_bn<PACKED, EPI_F32>(g, st, x, w, out, x_gs, x_rs, o_gs, o_rs, e);
  if (epi == EPI_I32) return gqmm_bn<PACKED, EPI_I32>(g, st, x, w, out, x_gs, x_rs, o_gs, o_rs, e);
  return gqmm_bn<PACKED, EPI_B3>(g, st, x, w, out, x_gs, x_rs, o_gs, o_rs, e);
}

// ------------------------------------------------------------------ B6

constexpr int DW_MAX_THREADS = 256;   // the plan's most threads a block

// the host plan's geometry (quant_grouped_conv.py · dw_launch_plan, in the
// order of its DW_GEO_FIELDS)
struct DwGeo {
  int N, C, H, W, OH, OW, kh, kw, sh, sw, pt, pl, dh, dw;
  int P, TH, TW, R, RG, tiles_h, tiles_w, rows, cols, pitch, plane_pitch, vec, flat, buffer,
      threads, blocks, smem, fast;
};

// the fused float32 epilogue's constants for one channel (DwOut) and the
// stores of a thread's nv outputs down its column, the act requant's
// rounding mode a template parameter (-1: no act requant); its division
// by qs is a multiply where qdq::exact_inverse allows it (the same bits)
struct DwOut {
  float sf, bias, qs, inv, qz, lo, hi;
  bool has_bias, relu;
};

template <int EPI, int MODE, int R>
__device__ __forceinline__ void dw_store(const typename Acc<EPI>::T (&acc)[R], float* op, int nv,
                                         int OW, const DwOut& f) {
#pragma unroll
  for (int o = 0; o < R; ++o) {
    if (o >= nv) break;
    float y = __fmul_rn(EPI == EPI_F32 ? (float)acc[o] : __int2float_rn((int)acc[o]), f.sf);
    if (f.has_bias) y = __fadd_rn(y, f.bias);
    if (f.relu) y = y < 0.0f ? 0.0f : y;            // NaN passes, as jnp.maximum
    if (MODE >= 0)
      y = __fmul_rn(__fsub_rn(qdq::quantize_inv<MODE < 0 ? 0 : MODE>(y, f.qs, f.inv, f.qz, f.lo,
                                                                      f.hi),
                              f.qz),
                    f.qs);
    op[o * OW] = y;
  }
}

// B3 on 32-bit integers over the products acc · mult (checked to fit)
template <int MODE, int R>
__device__ __forceinline__ void dw_store_b3(const int (&prod)[R], float* op, int nv, int OW,
                                            const b3::Req32& rq) {
#pragma unroll
  for (int o = 0; o < R; ++o) {
    if (o >= nv) break;
    op[o * OW] = b3::int_epilogue32<MODE>(prod[o], rq);
  }
}

// a block's work item: its planes and output tile, and where its staged
// window starts in the input (r0, c0) and in the tile (off)
struct DwItem {
  int plane0, np, oh0, ow0, r0, c0, off;
};

__device__ __forceinline__ DwItem dw_item(const DwGeo& g, int item) {
  DwItem it{0, 1, 0, 0, 0, 0, 0};
  if (g.flat) {
    it.plane0 = item * g.P;
    it.np = min(g.P, g.N * g.C - it.plane0);
  } else {
    const int tiles = g.tiles_h * g.tiles_w;
    it.plane0 = item / tiles;
    const int t = item - it.plane0 * tiles, th = t / g.tiles_w;
    it.oh0 = th * g.TH;
    it.ow0 = (t - th * g.tiles_w) * g.TW;
  }
  it.r0 = it.oh0 * g.sh - g.pt;
  it.c0 = it.ow0 * g.sw - g.pl;
  if (g.vec && !g.flat) {
    it.off = it.c0 & 3;                               // floor to 16 bytes
    it.c0 -= it.off;
  }
  return it;
}

// Stage a block's item into shared memory `tile`, each element converted
// once on the integer bodies.  Tile mode with vec: 16-byte cp.async of the
// window's rows from a start floored to 16 bytes, the padding zero-filled
// by the copy, then each thread converts the pieces it copied in place;
// without vec: scalar loads, converted and stored.  Flat mode: the planes'
// span as it lies in x, by 16-byte cp.async where it lies on 16 bytes (then
// converted in place likewise) and scalar loads for the rest; the compute
// reads it as it lies, the padding as zeros by predicate (FLAT).
template <int EPI>
__device__ __forceinline__ void dw_stage(const DwGeo& g, const DwItem& it, const float* x,
                                         typename Acc<EPI>::T* tile, const stg::Stage& st) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* xp = x + (long long)it.plane0 * g.H * g.W;
  if (g.flat) {
    const int len = it.np * g.H * g.W;
    const int head = g.vec ? len & ~3 : 0;
    for (int i = 4 * tid; i < head; i += 4 * nt) cp_async16(tile + i, xp + i, 16);
    for (int i = head + tid; i < len; i += nt) tile[i] = stage1<EPI>(xp[i], st);
    cp_async_wait_all();                             // this thread's copies landed
    if (EPI != EPI_F32)
      for (int i = 4 * tid; i < head; i += 4 * nt) convert4(tile + i, st);
    return;
  }
  if (g.vec) {
    const int cpr = g.cols >> 2;
    const int dr = nt / cpr, dc = nt - dr * cpr;
    for (int r = tid / cpr, c = tid - r * cpr; r < g.rows; r += dr) {
      const int ih = it.r0 + r, iw = it.c0 + 4 * c;
      const bool in = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      cp_async16(tile + r * g.pitch + 4 * c, in ? xp + ih * g.W + iw : x, in ? 16 : 0);
      c += dc;
      if (c >= cpr) { c -= cpr; ++r; }
    }
    cp_async_wait_all();
    if (EPI == EPI_F32) return;
    for (int r = tid / cpr, c = tid - r * cpr; r < g.rows; r += dr) {
      convert4(tile + r * g.pitch + 4 * c, st);
      c += dc;
      if (c >= cpr) { c -= cpr; ++r; }
    }
    return;
  }
  const int dr = nt / g.cols, dc = nt - dr * g.cols;
  for (int r = tid / g.cols, c = tid - r * g.cols; r < g.rows; r += dr) {
    const int ih = it.r0 + r, iw = it.c0 + c;
    const bool in = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
    tile[r * g.pitch + c] = stage1<EPI>(in ? xp[ih * g.W + iw] : 0.f, st);
    c += dc;
    if (c >= g.cols) { c -= g.cols; ++r; }
  }
}

// R outputs down one column per thread, then the epilogue
template <int EPI, int R, int FAST, bool FLAT>
__device__ __forceinline__ void dw_compute(const DwGeo& g, const DwItem& it,
                                           const typename Acc<EPI>::T* tile,
                                           const int8_t* __restrict__ w, float* __restrict__ out,
                                           const Epilogue& e) {
  using T = typename Acc<EPI>::T;
  const int tid = threadIdx.x, per_plane = g.RG * g.TW;
  if (tid >= g.P * per_plane) return;
  const int p = tid / per_plane, q = tid - p * per_plane;
  const int rg = q / g.TW, col = q - rg * g.TW;
  const int plane = it.plane0 + p, i0 = rg * R, ow = it.ow0 + col;
  if (p >= it.np || ow >= g.OW || i0 >= g.TH || it.oh0 + i0 >= g.OH) return;
  const int c = plane % g.C;
  // flat mode reads the raw planes (pitch W, plane pitch H·W) and reads
  // the padding as zeros by predicate: staged (r, c) is input (r - pt, c - pl)
  const T* base = tile + p * g.plane_pitch + i0 * g.sh * g.pitch + col * g.sw + it.off -
                  (FLAT ? g.pt * g.pitch + g.pl : 0);
  const int r_lo = g.pt, r_hi = g.pt + g.H, c_lo = g.pl, c_hi = g.pl + g.W;
  T acc[R];
#pragma unroll
  for (int o = 0; o < R; ++o) acc[o] = T(0);
  if constexpr (FAST != 0) {
    constexpr int SH = FAST;
    T wr[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wr[t] = T(w[t * g.C + c]);
#pragma unroll
    const int c0 = col * g.sw;
    const bool k0 = !FLAT || (c0 >= c_lo && c0 < c_hi);
    const bool k1 = !FLAT || (c0 + g.dw >= c_lo && c0 + g.dw < c_hi);
    const bool k2 = !FLAT || (c0 + 2 * g.dw >= c_lo && c0 + 2 * g.dw < c_hi);
    for (int rr = 0; rr < (R - 1) * SH + 3; ++rr) {
      const T* row = base + rr * g.pitch;
      const int r = i0 * g.sh + rr;
      const bool in = !FLAT || (r >= r_lo && r < r_hi);
      const T v0 = in && k0 ? row[0] : T(0), v1 = in && k1 ? row[g.dw] : T(0);
      const T v2 = in && k2 ? row[2 * g.dw] : T(0);
#pragma unroll
      for (int o = 0; o < R; ++o) {
        const int a = rr - o * SH;                 // the tap row this input is for output o
        if (a >= 0 && a < 3) {
          mac<EPI>(acc[o], v0, wr[3 * a]);
          mac<EPI>(acc[o], v1, wr[3 * a + 1]);
          mac<EPI>(acc[o], v2, wr[3 * a + 2]);
        }
      }
    }
  } else {
    for (int a = 0; a < g.kh; ++a)
      for (int b = 0; b < g.kw; ++b) {
        const T wv = T(w[(a * g.kw + b) * g.C + c]);
        const T* tap = base + a * g.dh * g.pitch + b * g.dw;
        const int cc = col * g.sw + b * g.dw;
        const bool kc = !FLAT || (cc >= c_lo && cc < c_hi);
#pragma unroll
        for (int o = 0; o < R; ++o) {
          const int r = (i0 + o) * g.sh + a * g.dh;
          mac<EPI>(acc[o], kc && (!FLAT || (r >= r_lo && r < r_hi)) ? tap[o * g.sh * g.pitch] : T(0),
                   wv);
        }
      }
  }

  // ---- the epilogue, consecutive lanes on consecutive columns
  const int nv = min(R, min(g.TH - i0, g.OH - it.oh0 - i0));   // this thread's outputs
  float* op = out + (long long)plane * g.OH * g.OW + (long long)(it.oh0 + i0) * g.OW + ow;
  if constexpr (EPI == EPI_B3) {
    const int mult = static_cast<const int*>(e.s)[c * e.s_stride];
    int prod[R];
    bool fits = e.rq.fast;
#pragma unroll
    for (int o = 0; o < R; ++o) {
      prod[o] = (int)((uint32_t)acc[o] * (uint32_t)mult);
      fits = fits && (o >= nv || b3::fits32(prod[o]));
    }
    if (!fits) {
#pragma unroll
      for (int o = 0; o < R; ++o)
        if (o < nv) op[o * g.OW] = b3::int_epilogue(acc[o], mult, e.rq.rq);
      return;
    }
    switch (e.rq.rq.mode) {
      case b3::CEIL: dw_store_b3<b3::CEIL, R>(prod, op, nv, g.OW, e.rq); break;
      case b3::FLOOR: dw_store_b3<b3::FLOOR, R>(prod, op, nv, g.OW, e.rq); break;
      case b3::UP: dw_store_b3<b3::UP, R>(prod, op, nv, g.OW, e.rq); break;
      case b3::DOWN: dw_store_b3<b3::DOWN, R>(prod, op, nv, g.OW, e.rq); break;
      case b3::HALF_UP: dw_store_b3<b3::HALF_UP, R>(prod, op, nv, g.OW, e.rq); break;
      case b3::HALF_DOWN: dw_store_b3<b3::HALF_DOWN, R>(prod, op, nv, g.OW, e.rq); break;
      default: dw_store_b3<b3::ROUND, R>(prod, op, nv, g.OW, e.rq); break;
    }
  } else {
    DwOut f{static_cast<const float*>(e.s)[c * e.s_stride], 0.f, 0.f, 0.f, 0.f, e.lo, e.hi,
            e.bias != nullptr, e.relu != 0};
    if (f.has_bias) f.bias = e.bias[c];
    if (!e.act) {
      dw_store<EPI, -1, R>(acc, op, nv, g.OW, f);
      return;
    }
    f.qs = *e.qs;
    f.qz = *e.qz;
    f.inv = qdq::exact_inverse(f.qs);
    switch (e.mode) {
      case qdq::CEIL: dw_store<EPI, qdq::CEIL, R>(acc, op, nv, g.OW, f); break;
      case qdq::FLOOR: dw_store<EPI, qdq::FLOOR, R>(acc, op, nv, g.OW, f); break;
      case qdq::UP: dw_store<EPI, qdq::UP, R>(acc, op, nv, g.OW, f); break;
      case qdq::DOWN: dw_store<EPI, qdq::DOWN, R>(acc, op, nv, g.OW, f); break;
      case qdq::HALF_UP: dw_store<EPI, qdq::HALF_UP, R>(acc, op, nv, g.OW, f); break;
      case qdq::HALF_DOWN: dw_store<EPI, qdq::HALF_DOWN, R>(acc, op, nv, g.OW, f); break;
      default: dw_store<EPI, qdq::ROUND, R>(acc, op, nv, g.OW, f); break;
    }
  }
}

// FAST: 0 any kernel; 1 / 2 a 3x3 kernel at row stride 1 / 2, row
// dilation 1, whose window rows are read once into registers; FLAT the
// flat mode.  Block b stages and computes work item b.
template <int EPI, int R, int FAST, bool FLAT>
__global__ void __launch_bounds__(DW_MAX_THREADS, 4)
dw_kernel(const float* __restrict__ x, const int8_t* __restrict__ w, float* __restrict__ out,
          DwGeo g, Epilogue e) {
  using T = typename Acc<EPI>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const DwItem it = dw_item(g, blockIdx.x);
  dw_stage<EPI>(g, it, x, tile, e.st);
  __syncthreads();
  dw_compute<EPI, R, FAST, FLAT>(g, it, tile, w, out, e);
}

template <int EPI, int R, int FAST, bool FLAT>
int dw_go(const DwGeo& g, cudaStream_t st, const float* x, const int8_t* w, float* out,
          const Epilogue& e) {
  static int allowed = 0;
  auto kernel = dw_kernel<EPI, R, FAST, FLAT>;
  const cudaError_t err = allow_smem(kernel, g.smem, allowed);
  if (err != cudaSuccess) return (int)err;
  kernel<<<g.blocks, g.threads, g.smem, st>>>(x, w, out, g, e);
  return (int)cudaGetLastError();
}

template <int EPI, int R>
int dw_fast(const DwGeo& g, cudaStream_t st, const float* x, const int8_t* w, float* out,
            const Epilogue& e) {
  if (g.flat) {
    if (g.fast == 1) return dw_go<EPI, R, 1, true>(g, st, x, w, out, e);
    if (g.fast == 2) return dw_go<EPI, R, 2, true>(g, st, x, w, out, e);
    return dw_go<EPI, R, 0, true>(g, st, x, w, out, e);
  }
  if (g.fast == 1) return dw_go<EPI, R, 1, false>(g, st, x, w, out, e);
  if (g.fast == 2) return dw_go<EPI, R, 2, false>(g, st, x, w, out, e);
  return dw_go<EPI, R, 0, false>(g, st, x, w, out, e);
}

template <int EPI>
int dw_rows(const DwGeo& g, cudaStream_t st, const float* x, const int8_t* w, float* out,
            const Epilogue& e) {
  if (g.R == 4) return dw_fast<EPI, 4>(g, st, x, w, out, e);
  if (g.R == 7) return dw_fast<EPI, 7>(g, st, x, w, out, e);
  return (int)cudaErrorInvalidValue;
}

Epilogue make_epilogue(const void* s, const float* bias, const float* qs, const float* qz,
                       int s_stride, int relu, int act, float lo, float hi, int mode, int epi,
                       float in_div, float in_mul, int stage_mode, const int* rq,
                       float out_mul) {
  return Epilogue{s,  bias, qs, qz, s_stride, relu, act, mode, lo, hi,
                  b3::make_req32(int_req(epi, rq, out_mul)), stg::make_stage(in_div, in_mul, stage_mode)};
}

}  // namespace

// geo: the 11 ints of GqGeo (gqmm_launch_plan).  x_gs / x_rs and o_gs /
// o_rs are the group and row strides of x and out in elements.  bias may
// be null.  epi, rq and out_mul as qmm_launch's (quant_matmul.cu); on the
// integer bodies x is staged by int_staging.cuh's mode `stage_mode` with
// in_div, and in_mul in RECIPROCAL mode.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int gqmm_launch(const float* x, const int8_t* w, const void* s, const float* bias,
                           float* out, const int* geo, long long x_gs, long long x_rs,
                           long long o_gs, long long o_rs, int s_stride, int packed, int epi,
                           float in_div, float in_mul, int stage_mode, const int* rq,
                           float out_mul, void* stream) {
  if (epi < EPI_F32 || epi > EPI_B3) return (int)cudaErrorInvalidValue;
  const GqGeo g = *reinterpret_cast<const GqGeo*>(geo);
  if (g.G <= 0 || g.M <= 0 || g.Ng <= 0) return (int)cudaGetLastError();
  const Epilogue e = make_epilogue(s, bias, nullptr, nullptr, s_stride, 0, 0, 0.f, 0.f, 0, epi,
                                   in_div, in_mul, stage_mode, rq, out_mul);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed) return gqmm_epi<true>(epi, g, st, x, w, out, x_gs, x_rs, o_gs, o_rs, e);
  return gqmm_epi<false>(epi, g, st, x, w, out, x_gs, x_rs, o_gs, o_rs, e);
}

// x (N, C, H, W) and out (N, C, OH, OW) contiguous float32; w (kh*kw, C)
// int8; geo: the 32 ints of DwGeo (dw_launch_plan); s scalar (stride 0) or
// (C,), float32 or (epi 2) int32 multipliers; bias (C,) or null; qs / qz
// one float each on the device, read only when act != 0, with the static
// clip bounds lo / hi and the rounding mode of qdq_round.cuh (the fp32
// epilogue's act requant; epi 2 folds ReLU and the act Quant into rq).
// epi, the staging and rq as gqmm_launch's.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int dw_launch(const float* x, const int8_t* w, const void* s, const float* bias,
                         const float* qs, const float* qz, float* out, const int* geo,
                         int s_stride, int relu, int act, float lo, float hi, int mode, int epi,
                         float in_div, float in_mul, int stage_mode, const int* rq,
                         float out_mul, void* stream) {
  if (epi < EPI_F32 || epi > EPI_B3) return (int)cudaErrorInvalidValue;
  const DwGeo g = *reinterpret_cast<const DwGeo*>(geo);
  if (g.blocks <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (epi == EPI_B3) {
    const Epilogue e = make_epilogue(s, nullptr, nullptr, nullptr, s_stride, 0, 0, 0.f, 0.f, 0,
                                     epi, in_div, in_mul, stage_mode, rq, out_mul);
    return dw_rows<EPI_B3>(g, st, x, w, out, e);
  }
  const Epilogue e = make_epilogue(s, bias, qs, qz, s_stride, relu, act, lo, hi, mode, epi,
                                   in_div, in_mul, stage_mode, rq, out_mul);
  if (epi == EPI_F32) return dw_rows<EPI_F32>(g, st, x, w, out, e);
  return dw_rows<EPI_I32>(g, st, x, w, out, e);
}
