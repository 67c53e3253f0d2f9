// Windowed lookup in the bf16 correlation volumes, every level of a
// pyramid in one launch, sm_90a.
//
// Replaces the slab gather + codd_tpu/ops/pallas/corr_select.py:
// window_select + bilinear combine of codd_tpu/ops/corr.py
// (_lookup_level_volume, select="reduce").  Per query q = (b, n) and level:
// clamp the window start (corr_window), read the t x t = (2r+2)^2 bf16 taps
// vol[b, n, sy + ty, sx + tx], zero them when the whole window is outside
// the level (vq), and write the (2r+1)^2 bilinear values into out[b, n,
// offset + level * (2r+1)^2 + yy * (2r+1) + xx] (out has out_c channels).
//
// Bound by bytes: per query and level 64 bf16 taps in 8 rows of 16 bytes,
// each row in a 165 MB (level 0) volume that no cache holds, so the time is
// the latency of scattered 16-byte reads.  One warp a query: lane
// 8 * level + ty reads tap row ty of its level with two aligned 16-byte
// loads (the row starts at any even byte), both in flight before either is
// used, and shifts the taps into place with selects and a funnel shift;
// row ty + 1, the bilinear pair's lower row, comes from the next lane by a
// shuffle.  The query's outputs of all levels go through shared memory and
// leave as one run of consecutive floats.  r is a template parameter, so
// every loop is unrolled.  Each output is rounded step by step in the
// plain version's order (corr_bilinear), so the taps alone decide its bits.
// (At the main path's 48x160 queries the four levels take 0.0074 ms on an
// NVIDIA H100 80GB HBM3 at 700 W, 2.5 times the byte bound, against
// 0.028 ms for grid_sample on the same volumes; chip_smoke.py phase 3.)
#include <stdint.h>

#include "corr_common.cuh"

#define K2_WARPS 8  // queries a block

template <int R>
__global__ void __launch_bounds__(32 * K2_WARPS)
corr_lookup_kernel(const __grid_constant__ CorrLevels lv,
                   const float* __restrict__ coords, float* __restrict__ out,
                   long long BN, int out_c, int offset) {
  constexpr int T = 2 * R + 2, R1 = 2 * R + 1, K = R1 * R1;
  __shared__ float sout[K2_WARPS][CORR_MAX_LEVELS * K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * K2_WARPS + warp;  // b * N + n
  if (q >= BN) return;  // the whole warp
  const int lvl = lane >> 3, ty = lane & 7;
  const bool active = lvl < lv.n;

  CorrWindow win = {0, 0, 0.f, 0.f, false};
  unsigned tw[4] = {0u, 0u, 0u, 0u};  // taps of row ty, bf16 pairs
  if (active) {
    const int Hp = lv.Hp[lvl], Wp = lv.Wp[lvl];
    win = corr_window<R>(coords[q * 2], coords[q * 2 + 1], lv.scale[lvl], Hp,
                         Wp);
    if (win.vq && ty < T) {
      const unsigned short* vol = (const unsigned short*)lv.ptr[lvl];
      const uintptr_t addr =
          (uintptr_t)(vol + (q * Hp + win.sy + ty) * (long long)Wp + win.sx);
      const unsigned off = (unsigned)(addr & 15u);  // even
      const uint4* a0 = (const uint4*)(addr - off);
      const uint4 lo = __ldg(a0);
      // the second block holds the row's last tap whenever it is needed,
      // so it never reaches past the volume
      const uint4 hi = off + 2 * T > 16 ? __ldg(a0 + 1) : make_uint4(0, 0, 0, 0);
      unsigned wd[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      if (off & 8u) {
#pragma unroll
        for (int i = 0; i < 6; ++i) wd[i] = wd[i + 2];
      }
      if (off & 4u) {
#pragma unroll
        for (int i = 0; i < 5; ++i) wd[i] = wd[i + 1];
      }
      const unsigned sh = (off & 2u) ? 16u : 0u;
#pragma unroll
      for (int m = 0; m < 4; ++m) tw[m] = __funnelshift_r(wd[m], wd[m + 1], sh);
    }
  }
  unsigned dn[4];  // row ty + 1 of the same level (lanes of one level are 8)
#pragma unroll
  for (int m = 0; m < 4; ++m) dn[m] = __shfl_down_sync(0xffffffffu, tw[m], 1);

  float* so = sout[warp];
  if (active && ty < R1) {
    float a[8], b[8];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      a[2 * m] = bf16_lo(tw[m]);
      a[2 * m + 1] = bf16_hi(tw[m]);
      b[2 * m] = bf16_lo(dn[m]);
      b[2 * m + 1] = bf16_hi(dn[m]);
    }
    const float gx = __fsub_rn(1.0f, win.fx), gy = __fsub_rn(1.0f, win.fy);
#pragma unroll
    for (int xx = 0; xx < R1; ++xx)
      so[lvl * K + ty * R1 + xx] = corr_bilinear(
          gx, win.fx, gy, win.fy, a[xx], a[xx + 1], b[xx], b[xx + 1]);
  }
  __syncwarp();
  float* op = out + q * out_c + offset;
  for (int i = lane; i < lv.n * K; i += 32) op[i] = so[i];
}

// vols: L device pointers (B, N, Hp, Wp) bf16; hw: L (Hp, Wp) pairs;
// scales: L floats.  Level i writes channels [offset + i * (2r+1)^2, ...).
extern "C" int corr_lookup_launch(const void* const* vols, const int* hw,
                                  const float* scales, int L,
                                  const void* coords, void* out, int B, int N,
                                  int r, int out_c, int offset, void* stream) {
  if (L < 1 || L > CORR_MAX_LEVELS || r < 0 || r > 3)
    return (int)cudaErrorInvalidValue;
  CorrLevels lv = {};
  for (int i = 0; i < L; ++i) {
    lv.ptr[i] = vols[i];
    lv.Hp[i] = hw[2 * i];
    lv.Wp[i] = hw[2 * i + 1];
    lv.scale[i] = scales[i];
  }
  lv.n = L;
  const long long BN = (long long)B * N;
  if (BN == 0) return 0;
  const unsigned blocks = (unsigned)((BN + K2_WARPS - 1) / K2_WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)coords;
  float* o = (float*)out;
  switch (r) {
    case 0: corr_lookup_kernel<0><<<blocks, 32 * K2_WARPS, 0, s>>>(lv, c, o, BN, out_c, offset); break;
    case 1: corr_lookup_kernel<1><<<blocks, 32 * K2_WARPS, 0, s>>>(lv, c, o, BN, out_c, offset); break;
    case 2: corr_lookup_kernel<2><<<blocks, 32 * K2_WARPS, 0, s>>>(lv, c, o, BN, out_c, offset); break;
    default: corr_lookup_kernel<3><<<blocks, 32 * K2_WARPS, 0, s>>>(lv, c, o, BN, out_c, offset); break;
  }
  return (int)cudaGetLastError();
}
