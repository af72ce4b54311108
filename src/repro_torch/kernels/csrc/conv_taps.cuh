// The implicit GEMM's address map, shared by B1 / B2's CUDA-core body and
// B2's int8 tensor-core body (quant_matmul.cu): a conv's A operand is read
// straight from its NCHW float32 input by address, so no patch matrix is
// ever written.
//
// Row m = (n, oh, ow) of the (N·OH·OW, C·kH·kW) operand and column
// k = (c, kh, kw), c slowest (the order of quant_conv.py · im2col_weights),
// hold the element
//   x[n, c, oh·sh + kh·dh - pt, ow·sw + kw·dw - pl]
// or an exact 0 where that lies in the padding (ONNX pads [t, l, b, r], which
// may be asymmetric: the bottom and right pads only set OH and OW).  The
// address splits into a row part and a column part:
//   base(m) = n·C·H·W + ih·W + iw,   ih = oh·sh - pt,   iw = ow·sw - pl
//   off(k)  = c·H·W + dy·W + dx,     dy = kh·dh,        dx = kw·dw
// and the element lies inside the map where 0 <= ih + dy < H and
// 0 <= iw + dx < W.  A thread keeps one row of its block's tile for the
// whole launch (the threads of a tile's column of k are consecutive rows,
// so a warp reads consecutive ow of one k, contiguous at unit stride),
// decomposes the first column of its run once per K step, and walks the
// run by carries, with no division.  Every element goes by a 4-byte
// cp.async; a padding tap, a row past M and a column past the rank's K
// range go with src-size 0, which writes 0: no branch, no padded copy.
// The host half (the same row bases, tap offsets and bounds, applied by a
// torch gather) is quant_conv.py · gather_patches, which the CPU tests hold
// against extract_patches.
#pragma once

#include <stdint.h>

namespace taps {

// the conv's geometry, in the order of quant_conv.py · CONV_GEO_FIELDS
struct Conv {
  int N, C, H, W, OH, OW, kh, kw, sh, sw, dh, dw, pt, pl;
};

// a row's part of the address; ih and iw of tap (0, 0), either may be
// outside the map; full: every tap of the row lies inside
struct Row {
  long long base;
  int ih, iw;
  bool full;
};

// a column's part of the address
struct Tap {
  int off, dy, dx;
};

// row m; a row past M lies outside the map at every tap
__device__ __forceinline__ Row row(const Conv& cv, int m, int M) {
  if (m >= M) return Row{0, -(1 << 30), 0, false};
  const int ohw = cv.OH * cv.OW;
  const int n = m / ohw, p = m - n * ohw, oh = p / cv.OW, ow = p - oh * cv.OW;
  const int ih = oh * cv.sh - cv.pt, iw = ow * cv.sw - cv.pl;
  const bool full = ih >= 0 && iw >= 0 && ih + (cv.kh - 1) * cv.dh < cv.H &&
                    iw + (cv.kw - 1) * cv.dw < cv.W;
  return Row{(long long)n * cv.C * cv.H * cv.W + (long long)ih * cv.W + iw, ih, iw, full};
}

// column k, decomposed
__device__ __forceinline__ Tap tap(const Conv& cv, int k) {
  const int taps = cv.kh * cv.kw;
  const int c = k / taps, t = k - c * taps, i = t / cv.kw, j = t - i * cv.kw;
  const int dy = i * cv.dh, dx = j * cv.dw;
  return Tap{c * cv.H * cv.W + dy * cv.W + dx, dy, dx};
}

// column k + 1 from column k: kw, then kh, then c
__device__ __forceinline__ void next(const Conv& cv, Tap& t) {
  t.dx += cv.dw;
  t.off += cv.dw;
  if (t.dx == cv.kw * cv.dw) {
    t.dx = 0;
    t.dy += cv.dh;
    t.off += cv.dh * cv.W - cv.kw * cv.dw;
    if (t.dy == cv.kh * cv.dh) {
      t.dy = 0;
      t.off += cv.H * cv.W - cv.kh * cv.dh * cv.W;
    }
  }
}

// 4 bytes global -> shared, zero-filled where `bytes` is 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}

// columns k .. k + E - 1 of row r into dst[0], dst[pitch], ..., the columns
// at k_hi and beyond as 0.  A warp whose rows are all full and whose run
// lies inside the K range (every unpadded conv's, the inner rows of a
// padded one) takes the loop without checks; the choice is the warp's, so
// a padded map's edge rows split no warp.  Every lane of the warp calls it.
template <int E>
__device__ __forceinline__ void gather(float* dst, int pitch, const float* __restrict__ x,
                                       const Conv& cv, const Row& r, int k, int k_hi) {
  Tap t = tap(cv, k);
  if (__all_sync(0xffffffffu, r.full && k + E <= k_hi)) {
    const float* xr = x + r.base;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      cp_async4(dst + e * pitch, xr + t.off, 4);
      next(cv, t);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool in = k + e < k_hi && (unsigned)(r.ih + t.dy) < (unsigned)cv.H &&
                    (unsigned)(r.iw + t.dx) < (unsigned)cv.W;
    cp_async4(dst + e * pitch, in ? x + r.base + t.off : x, in ? 4 : 0);
    next(cv, t);
  }
}

// where output row m of channel 0 lies in the (N, O, OH, OW) output; channel
// o adds o·OH·OW
__device__ __forceinline__ long long out_row(const Conv& cv, int m, int O) {
  const int ohw = cv.OH * cv.OW, n = m / ohw;
  return (long long)n * O * ohw + (m - n * ohw);
}

}  // namespace taps
