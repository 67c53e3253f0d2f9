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
//
// The file's second kernel, 2b, is the lookup's backward: the VJP of
// codd_tpu/ops/corr.py:_lookup_level_volume with respect to the volumes
// and the coordinates (codd_tpu differentiates it through XLA; no Pallas
// kernel of its own).  Per query and level the 49 cotangents g go through
// the transpose of the bilinear combine to the t x t tap cotangents, which
// are added into the query's own plane of the volume's running cotangent:
// a query touches only its plane, so the planes are collision-free and no
// float atomics are needed.  The corners' terms are added d11, d10, d01,
// d00, JAX's order; select "xla" adds them in f32 and rounds once to bf16,
// select "reduce" rounds each to bf16 and adds in bf16 (a template
// parameter).  Each tap's cotangent then meets the running cotangent as
// autograd's bf16 add of a dense cotangent meets it: acc = bf16(acc + s),
// one more rounding.  The training step's 16 GN iterations look up the
// same volumes, so the 16 calls of one backward add into one running
// cotangent, zeroed once (ops/corr.py:VolumeCarry), as codd_tpu's scan
// carry adds each iteration's; on zeros the add is the dense VJP's store.
// The coordinates' cotangent is sum_levels scale * sum_taps g . d out /
// d (fx, fy) on the masked taps read back from the volume, summed in a
// fixed order (a lane's row, then the rows, then the levels), so two
// launches give equal bits.  Bound by bytes: per query and level 49 f32
// cotangents, 64 bf16 taps read, the 64 window entries of the running
// cotangent read and written, 2 coords (~43 MB for a training call at
// B=4, 48x96, no dense plane); one warp a query as in the forward, a lane
// a tap row of one level, row ty - 1's cotangents from the lane before by
// a shuffle.  A lane reads its window row of the running cotangent in the
// one or two aligned 16-byte blocks that hold it and writes back only the
// row's own bytes, in the fewest naturally aligned stores: a wider store
// would rewrite bytes of the next tap row of the plane or of the next
// query's plane, which other lanes add into at the same time.
#include <stdint.h>

#include <cuda_bf16.h>

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

// ---------------------------------------------------------------------------
// Kernel 2b: the backward.
// ---------------------------------------------------------------------------

// The volumes' running cotangents of one launch, level i at ptr[i], each
// shaped as its volume (B, N, Hp, Wp) bf16 and 16-byte aligned; the
// kernel adds each query's window into them.
struct CorrGrads {
  void* ptr[CORR_MAX_LEVELS];
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// row[i] = bf16(row[i] + s[i]) for the T bf16 entries at ``row`` (any even
// byte address); each s[i] is a bf16 value.  The one or two aligned
// 16-byte blocks that hold the row are read whole; the sums are placed
// in the blocks' frame (the row starts at entry o of the first block) and
// only entries o .. o + T - 1 are stored, each block by the largest
// aligned pieces (16, 8, 4, 2 bytes) that lie inside the row.
template <int T>
__device__ __forceinline__ void add_row(unsigned short* row,
                                        const float (&s)[T]) {
  const uintptr_t addr = (uintptr_t)row;
  const int o = (int)((addr & 15u) >> 1), e = o + T;
  uint4* blk = (uint4*)(addr & ~(uintptr_t)15u);
  const uint4 lo = blk[0];
  const uint4 hi = e > 8 ? blk[1] : make_uint4(0, 0, 0, 0);
  const unsigned a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  unsigned w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int m = 0; m < T / 2; ++m)  // s in the row's frame
    w[m] = (__float_as_uint(s[2 * m]) >> 16) |
           (__float_as_uint(s[2 * m + 1]) & 0xffff0000u);
  // shifted by o entries into the blocks' frame
  if (o & 1) {
#pragma unroll
    for (int m = 7; m > 0; --m) w[m] = __funnelshift_l(w[m - 1], w[m], 16);
    w[0] <<= 16;
  }
  if (o & 2) {
#pragma unroll
    for (int m = 7; m > 0; --m) w[m] = w[m - 1];
    w[0] = 0u;
  }
  if (o & 4) {
#pragma unroll
    for (int m = 7; m > 1; --m) w[m] = w[m - 2];
    w[0] = w[1] = 0u;
  }
  unsigned n[8];  // the sums, every entry of the blocks (stored: the row's)
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const unsigned short l = __bfloat16_as_ushort(__float2bfloat16_rn(
        __fadd_rn(bf16_lo(a[m]), bf16_lo(w[m]))));
    const unsigned short h = __bfloat16_as_ushort(__float2bfloat16_rn(
        __fadd_rn(bf16_hi(a[m]), bf16_hi(w[m]))));
    n[m] = (unsigned)l | ((unsigned)h << 16);
  }
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (o <= 8 * b && 8 * b + 8 <= e) {
      blk[b] = make_uint4(n[4 * b], n[4 * b + 1], n[4 * b + 2], n[4 * b + 3]);
      continue;
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = 8 * b + 4 * hf, m = p / 2;
      if (o <= p && p + 4 <= e) {
        ((uint2*)blk)[p / 4] = make_uint2(n[m], n[m + 1]);
        continue;
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int q = p + 2 * k;
        if (o <= q && q + 2 <= e) {
          ((unsigned*)blk)[q / 2] = n[q / 2];
          continue;
        }
        if (o <= q && q < e)
          ((unsigned short*)blk)[q] = (unsigned short)(n[q / 2] & 0xffffu);
        if (o <= q + 1 && q + 1 < e)
          ((unsigned short*)blk)[q + 1] = (unsigned short)(n[q / 2] >> 16);
      }
    }
  }
}

template <int R, bool REDUCE>
__global__ void __launch_bounds__(32 * K2_WARPS)
corr_lookup_backward_kernel(const __grid_constant__ CorrLevels lv,
                            const __grid_constant__ CorrGrads gr,
                            const float* __restrict__ coords,
                            const float* __restrict__ g,
                            float* __restrict__ dcoords, long long BN) {
  constexpr int T = 2 * R + 2, R1 = 2 * R + 1, K = R1 * R1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * K2_WARPS + warp;  // b * N + n
  if (q >= BN) return;  // the whole warp
  const int lvl = lane >> 3, ty = lane & 7;
  const bool active = lvl < lv.n;
  const int gc = lv.n * K;  // g's channels

  CorrWindow win = {0, 0, 0.f, 0.f, false};
  int Hp = 0, Wp = 0;
  unsigned tw[4] = {0u, 0u, 0u, 0u};  // taps of row ty, bf16 pairs
  float gcur[R1];                     // g's row ty of this level
#pragma unroll
  for (int xx = 0; xx < R1; ++xx) gcur[xx] = 0.f;
  if (active) {
    Hp = lv.Hp[lvl];
    Wp = lv.Wp[lvl];
    win = corr_window<R>(coords[q * 2], coords[q * 2 + 1], lv.scale[lvl], Hp,
                         Wp);
    if (ty < R1) {
      const float* gp = g + q * gc + lvl * K + ty * R1;
#pragma unroll
      for (int xx = 0; xx < R1; ++xx) gcur[xx] = gp[xx];
    }
    if (win.vq && ty < T) {  // the forward's row load
      const unsigned short* vol = (const unsigned short*)lv.ptr[lvl];
      const uintptr_t addr =
          (uintptr_t)(vol + (q * Hp + win.sy + ty) * (long long)Wp + win.sx);
      const unsigned off = (unsigned)(addr & 15u);
      const uint4* a0 = (const uint4*)(addr - off);
      const uint4 lo = __ldg(a0);
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
  // row ty - 1 of g and row ty + 1 of the taps, from the neighbouring lanes
  // of the same level (a level's lanes are 8)
  float gprev[R1];
#pragma unroll
  for (int xx = 0; xx < R1; ++xx)
    gprev[xx] = __shfl_up_sync(0xffffffffu, gcur[xx], 1);
  unsigned dn[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) dn[m] = __shfl_down_sync(0xffffffffu, tw[m], 1);

  const float fx = win.fx, fy = win.fy;
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);

  // the tap cotangents of row ty, added into the query's plane
  if (active && win.vq && ty < T) {
    float sv[T];
#pragma unroll
    for (int tx = 0; tx < T; ++tx) {
      // absent corners are the +0 of JAX's pads
      const float p11 = (ty >= 1 && tx >= 1)
                            ? __fmul_rn(__fmul_rn(gprev[tx - 1], fy), fx) : 0.f;
      const float p10 = (ty >= 1 && tx < R1)
                            ? __fmul_rn(__fmul_rn(gprev[tx], fy), gx) : 0.f;
      const float p01 = (ty < R1 && tx >= 1)
                            ? __fmul_rn(__fmul_rn(gcur[tx - 1], gy), fx) : 0.f;
      const float p00 = (ty < R1 && tx < R1)
                            ? __fmul_rn(__fmul_rn(gcur[tx], gy), gx) : 0.f;
      float s;
      if (REDUCE) {
        s = bf16_round(__fadd_rn(bf16_round(p11), bf16_round(p10)));
        s = bf16_round(__fadd_rn(s, bf16_round(p01)));
        s = bf16_round(__fadd_rn(s, bf16_round(p00)));
      } else {
        s = __fadd_rn(__fadd_rn(__fadd_rn(p11, p10), p01), p00);
      }
      // 0 + s, as a scatter-add into zeros: a -0 becomes +0, so no -0
      // ever enters the running cotangent
      sv[tx] = bf16_round(__fadd_rn(s, 0.0f));
    }
    add_row<T>((unsigned short*)gr.ptr[lvl] +
                   (q * Hp + win.sy + ty) * (long long)Wp + win.sx,
               sv);
  }

  // the coordinates: row ty of the window, taps rows ty and ty + 1
  float sx_ = 0.f, sy_ = 0.f;
  if (active && ty < R1) {
    float a[8], b[8];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      a[2 * m] = bf16_lo(tw[m]);
      a[2 * m + 1] = bf16_hi(tw[m]);
      b[2 * m] = bf16_lo(dn[m]);
      b[2 * m + 1] = bf16_hi(dn[m]);
    }
#pragma unroll
    for (int xx = 0; xx < R1; ++xx) {
      const float dfx = __fadd_rn(__fmul_rn(gy, __fsub_rn(a[xx + 1], a[xx])),
                                  __fmul_rn(fy, __fsub_rn(b[xx + 1], b[xx])));
      const float dfy = __fadd_rn(__fmul_rn(gx, __fsub_rn(b[xx], a[xx])),
                                  __fmul_rn(fx, __fsub_rn(b[xx + 1], a[xx + 1])));
      sx_ = __fadd_rn(sx_, __fmul_rn(gcur[xx], dfx));
      sy_ = __fadd_rn(sy_, __fmul_rn(gcur[xx], dfy));
    }
  }
  // the level's rows in order (lane 8 * lvl holds the sum), then the levels
  float lx = 0.f, ly = 0.f;
#pragma unroll
  for (int row = 0; row < R1; ++row) {
    const float vx = __shfl_sync(0xffffffffu, sx_, (lane & ~7) + row);
    const float vy = __shfl_sync(0xffffffffu, sy_, (lane & ~7) + row);
    lx = __fadd_rn(lx, vx);
    ly = __fadd_rn(ly, vy);
  }
  float cx = 0.f, cy = 0.f;
#pragma unroll
  for (int l = 0; l < CORR_MAX_LEVELS; ++l) {
    const float vx = __shfl_sync(0xffffffffu, lx, 8 * l);
    const float vy = __shfl_sync(0xffffffffu, ly, 8 * l);
    if (l < lv.n) {
      cx = __fadd_rn(cx, __fmul_rn(lv.scale[l], vx));
      cy = __fadd_rn(cy, __fmul_rn(lv.scale[l], vy));
    }
  }
  if (lane == 0) {
    dcoords[q * 2] = cx;
    dcoords[q * 2 + 1] = cy;
  }
}

template <int R>
static void corr_lookup_backward_r(bool reduce, unsigned blocks,
                                   cudaStream_t s, const CorrLevels& lv,
                                   const CorrGrads& gr, const float* c,
                                   const float* g, float* dc, long long BN) {
  if (reduce)
    corr_lookup_backward_kernel<R, true>
        <<<blocks, 32 * K2_WARPS, 0, s>>>(lv, gr, c, g, dc, BN);
  else
    corr_lookup_backward_kernel<R, false>
        <<<blocks, 32 * K2_WARPS, 0, s>>>(lv, gr, c, g, dc, BN);
}

// vols: L device pointers (B, N, Hp, Wp) bf16; hw: L (Hp, Wp) pairs;
// scales: L floats; g (B, N, L * (2r+1)^2) f32; grads: L device pointers
// shaped as vols, 16-byte aligned, the running cotangents the windows are
// added into (zeros for the dense VJP); dcoords (B, N, 2) f32.
// reduce != 0 takes select "reduce"'s roundings, else select "xla"'s.
extern "C" int corr_lookup_backward_launch(
    const void* const* vols, const int* hw, const float* scales, int L,
    const void* coords, const void* g, void* const* grads, void* dcoords,
    int B, int N, int r, int reduce, void* stream) {
  if (L < 1 || L > CORR_MAX_LEVELS || r < 0 || r > 3)
    return (int)cudaErrorInvalidValue;
  CorrLevels lv = {};
  CorrGrads gr = {};
  for (int i = 0; i < L; ++i) {
    lv.ptr[i] = vols[i];
    lv.Hp[i] = hw[2 * i];
    lv.Wp[i] = hw[2 * i + 1];
    lv.scale[i] = scales[i];
    gr.ptr[i] = grads[i];
  }
  lv.n = L;
  const long long BN = (long long)B * N;
  if (BN == 0) return 0;
  const unsigned blocks = (unsigned)((BN + K2_WARPS - 1) / K2_WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)coords;
  const float* gg = (const float*)g;
  float* dc = (float*)dcoords;
  switch (r) {
    case 0: corr_lookup_backward_r<0>(reduce, blocks, s, lv, gr, c, gg, dc, BN); break;
    case 1: corr_lookup_backward_r<1>(reduce, blocks, s, lv, gr, c, gg, dc, BN); break;
    case 2: corr_lookup_backward_r<2>(reduce, blocks, s, lv, gr, c, gg, dc, BN); break;
    default: corr_lookup_backward_r<3>(reduce, blocks, s, lv, gr, c, gg, dc, BN); break;
  }
  return (int)cudaGetLastError();
}
