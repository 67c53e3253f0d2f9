// What the two correlation lookups share (corr_lookup.cu, kernel 2, and
// corr_patch.cu, kernel 6): the levels of one launch, a query's window
// start, and bf16 unpacking.
#pragma once
#include <cuda_runtime.h>

#define CORR_MAX_LEVELS 4

// The pyramid levels one launch covers: level i is read at coords *
// scale[i] and writes channels [offset + i * (2r+1)^2, ...) of the output.
// Passed by value as a kernel parameter.
struct CorrLevels {
  const void* ptr[CORR_MAX_LEVELS];
  int Hp[CORR_MAX_LEVELS];  // padded level height (hl + 2(2r+1))
  int Wp[CORR_MAX_LEVELS];
  float scale[CORR_MAX_LEVELS];
  int n;
};

// A query's window on the padded level: tap start (sx, sy), bilinear
// fractions, and whether any of it lies inside the level (vq); the
// arithmetic of codd_torch/ops/corr.py:_window_starts, float for float.
struct CorrWindow {
  int sx, sy;
  float fx, fy;
  bool vq;
};

template <int R>
__device__ __forceinline__ CorrWindow corr_window(float x, float y,
                                                  float scale, int Hp,
                                                  int Wp) {
  constexpr int P = 2 * R + 1;
  const int hl = Hp - 2 * P, wl = Wp - 2 * P;
  float cx = __fmul_rn(x, scale), cy = __fmul_rn(y, scale);
  float x0 = floorf(cx), y0 = floorf(cy);
  CorrWindow w;
  w.fx = __fsub_rn(cx, x0);
  w.fy = __fsub_rn(cy, y0);
  w.vq = (x0 >= (float)(-(R + 1))) && (x0 <= (float)(wl - 1 + R)) &&
         (y0 >= (float)(-(R + 1))) && (y0 <= (float)(hl - 1 + R));
  w.sx = (int)fminf(fmaxf(x0, (float)(-(R + 1))), (float)(wl - 1 + R)) - R + P;
  w.sy = (int)fminf(fmaxf(y0, (float)(-(R + 1))), (float)(hl - 1 + R)) - R + P;
  return w;
}

// the two bf16 values of a 32-bit word, low half first, as f32 (exact)
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// (1-fy)*((1-fx)*d00 + fx*d01) + fy*((1-fx)*d10 + fx*d11), rounded step by
// step in this order as the plain version is
__device__ __forceinline__ float corr_bilinear(float gx, float fx, float gy,
                                               float fy, float d00, float d01,
                                               float d10, float d11) {
  float top = __fadd_rn(__fmul_rn(gx, d00), __fmul_rn(fx, d01));
  float bot = __fadd_rn(__fmul_rn(gx, d10), __fmul_rn(fx, d11));
  return __fadd_rn(__fmul_rn(gy, top), __fmul_rn(fy, bot));
}
