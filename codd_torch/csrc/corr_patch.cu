// Windowed correlation lookup straight from the pooled bf16 feature levels
// (no correlation volume), every level of a pyramid in one launch, sm_90a.
//
// Replaces scripts/kernel_corr_pallas.py:corr_dots_pallas and the XLA code
// around it in codd_tpu/ops/corr.py:_lookup_level (window starts, patch
// gather, tap dots, vq mask, bilinear combine).  Per query n of batch b and
// level:
//   dots[ty][tx] = sum_c f1[b,n,c] * f2p[b, sy+ty, sx+tx, c]   (t x t taps)
//   out[b,n,offset + level*(2r+1)^2 + yy*(2r+1) + xx]
//       = bilinear mix of dots[yy..yy+1][xx..xx+1]
// with f1 (B,N,128) bf16, f2p the level zero-padded by 2r+1 (B,Hp,Wp,128)
// bf16, f32 products (exact for bf16 operands) and f32 sums.
//
// What bounds it.  A query's 64 taps are 16 KB of the level, and the
// windows of neighbouring queries overlap almost wholly.  Read per query
// from L2, a level-0 pass moves 126 MB through L2 for 3.7 MB of level.  So
// a block takes a tile of 4 x 8 queries of one level (the coordinates are
// coherent in 2-D), stages the bounding box of their windows in shared
// memory once (one cp.async.bulk a box row, counted on an mbarrier), and
// its queries read their taps from there.  The box row stride is the row's
// pixels plus 16 bytes, so the 8 lanes of a quarter warp, which read one
// 16-byte chunk of 8 rows of one column, hit 8 different bank groups.  A
// block whose box would exceed the budget (box_bytes, chosen by the
// wrapper) reads its taps straight from global memory instead, in the same
// code with another base pointer; corr.py:patch_lookup_plan says which
// blocks do.  Staged, shared memory and the instruction rate bound it: a
// tap's dot reads 256 bytes of shared memory and takes 128 fmaf and 128
// integer operations that widen bf16 to f32.  (At the main path's 48x160
// queries the four levels take 0.043 ms on an NVIDIA H100 80GB HBM3 at
// 700 W, chip_smoke.py phase 3: about 12 times the byte bound, about twice
// what the shared-memory reads alone would take.)
//
// One warp a query: the warp widens the query's f1 row to f32 in shared
// memory (read back by broadcast), and lane (ty, tx) = (l & 7, l >> 3) takes
// taps (ty, tx) and (ty, tx + 4).  For each tap it forms 16 partial sums of
// 8 channels each, in channel order, by fmaf from 0, then joins them in a
// fixed pairing, (p, p^8), (p, p^4), (p, p^2), (p, p^1), as a half-warp
// xor-shuffle tree (8, 4, 2, 1) would, without the shuffles; partials are
// formed in the order the pairing consumes them, two that share a 32-byte
// sector of a tap together.  The t*t dots go to shared memory and the
// (2r+1)^2 outputs are combined there (two rounds of the warp).
//
// The backward (training; the VJP of codd_tpu/ops/corr.py:_lookup_level,
// which XLA differentiates there): one warp a query, every level in turn.
// The level's 49 cotangents go through the transpose of the bilinear
// combine to the t*t tap cotangents (each corner's term added in the order
// d00, d01, d10, d11, as corr.py:_bilinear_transpose); a masked query
// (vq = 0) skips the level.  Lane l owns channels 4l .. 4l+3: for each tap
// in row-major order it adds dtap * level[tap] to its df1 sums (one f32
// chain a channel over all levels, rounded once to bf16: df1 is written in
// full by its query) and scatters dtap * f1 into a zeroed f32 copy of the
// padded level with a 16-byte atomicAdd (rounded once to bf16 by the
// wrapper).  What bounds it: the scatter, 64 x 128 atomic adds a query and
// level into windows that neighbouring queries share (f32, no staging of
// the window's gradient in shared memory yet).
#include <stdint.h>

#include "corr_common.cuh"
#include "gn_common.cuh"  // the mbarrier and bulk-copy (TMA) wrappers

#define PC 128             // feature channels
#define PIX_BYTES 256      // one level pixel: 128 bf16
#define TILE_H 4           // a block's queries: 4 rows x 8 columns,
#define TILE_W 8           // one a lane of warp 0 while the box is planned
#define K6_WARPS 8         // queries are shared out over 8 warps
#define MAXT 8             // taps per side, 2r+2 with r <= 3

template <bool STAGED>
__device__ __forceinline__ uint4 load16(const unsigned char* p) {
  if (STAGED) return *(const uint4*)p;
  return __ldg((const uint4*)p);
}

// Partial p of the dots of both taps: channels 8p .. 8p+7 in channel
// order, by fmaf from 0 (products of bf16 values are exact in f32).
template <bool STAGED>
__device__ __forceinline__ void partial(const unsigned char* p0,
                                        const unsigned char* p1, bool has0,
                                        bool has1, const float* a, int p,
                                        float& x, float& y) {
  const float4 a0 = ((const float4*)a)[2 * p];
  const float4 a1 = ((const float4*)a)[2 * p + 1];
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4 k0 = has0 ? load16<STAGED>(p0 + 16 * p) : zero;
  const uint4 k1 = has1 ? load16<STAGED>(p1 + 16 * p) : zero;
  const unsigned u0[4] = {k0.x, k0.y, k0.z, k0.w};
  const unsigned u1[4] = {k1.x, k1.y, k1.z, k1.w};
  x = 0.f;
  y = 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    x = fmaf(av[2 * m], bf16_lo(u0[m]), x);
    x = fmaf(av[2 * m + 1], bf16_hi(u0[m]), x);
    y = fmaf(av[2 * m], bf16_lo(u1[m]), y);
    y = fmaf(av[2 * m + 1], bf16_hi(u1[m]), y);
  }
}

// u_p = s_p + s_p+8 and u_p+1 = s_p+1 + s_p+9 for both taps (x: the first
// tap, y: the second); partials p and p+1 share a 32-byte sector of a tap.
template <bool STAGED>
__device__ __forceinline__ void quad(const unsigned char* p0,
                                     const unsigned char* p1, bool has0,
                                     bool has1, const float* a, int p,
                                     float (&x)[2], float (&y)[2]) {
  float xs[4], ys[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    partial<STAGED>(p0, p1, has0, has1, a, p + (i & 1) + 8 * (i >> 1), xs[i],
                    ys[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    x[i] = __fadd_rn(xs[i], xs[i + 2]);
    y[i] = __fadd_rn(ys[i], ys[i + 2]);
  }
}

// The t*t tap dots of one query into dots[ty * t + tx].  ``base`` points at
// tap (0, 0) of the window, rows ``rowstride`` bytes apart, pixels
// PIX_BYTES apart; ``a`` is the query's f1 row in f32.  The 16 partials of
// a dot are joined as a half-warp xor-shuffle tree joins them, u_p = s_p +
// s_p+8, v_p = u_p + u_p+4, (v_0 + v_2) + (v_1 + v_3), and taken in the
// order that tree consumes them, so few are live at a time.
template <int R, bool STAGED>
__device__ __forceinline__ void tap_dots(const unsigned char* base,
                                         long long rowstride,
                                         const float* a, float* dots,
                                         int lane) {
  constexpr int T = 2 * R + 2;
  const int ty = lane & 7, tx = lane >> 3;
  const bool has0 = ty < T && tx < T, has1 = ty < T && tx + 4 < T;
  const unsigned char* p0 = base + ty * rowstride + tx * PIX_BYTES;
  const unsigned char* p1 = p0 + 4 * PIX_BYTES;
  float ux[2], uy[2], wx[2], wy[2], v01x[2], v01y[2];
  quad<STAGED>(p0, p1, has0, has1, a, 0, ux, uy);  // u0, u1
  quad<STAGED>(p0, p1, has0, has1, a, 4, wx, wy);  // u4, u5
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // v0, v1
    v01x[i] = __fadd_rn(ux[i], wx[i]);
    v01y[i] = __fadd_rn(uy[i], wy[i]);
  }
  quad<STAGED>(p0, p1, has0, has1, a, 2, ux, uy);  // u2, u3
  quad<STAGED>(p0, p1, has0, has1, a, 6, wx, wy);  // u6, u7
  // v2 = u2 + u6, v3 = u3 + u7; dot = (v0 + v2) + (v1 + v3)
  if (has0)
    dots[ty * T + tx] = __fadd_rn(__fadd_rn(v01x[0], __fadd_rn(ux[0], wx[0])),
                                  __fadd_rn(v01x[1], __fadd_rn(ux[1], wx[1])));
  if (has1)
    dots[ty * T + tx + 4] =
        __fadd_rn(__fadd_rn(v01y[0], __fadd_rn(uy[0], wy[0])),
                  __fadd_rn(v01y[1], __fadd_rn(uy[1], wy[1])));
}

template <int R>
__global__ void __launch_bounds__(32 * K6_WARPS, 2)
corr_patch_lookup_kernel(const unsigned char* __restrict__ f1,
                         const __grid_constant__ CorrLevels lv,
                         const float* __restrict__ coords,
                         float* __restrict__ out, int h, int w, int tiles_x,
                         int tiles_per_b, int out_c, int offset,
                         int box_bytes) {
  constexpr int T = 2 * R + 2, R1 = 2 * R + 1, K = R1 * R1;
  extern __shared__ __align__(128) unsigned char box[];
  __shared__ __align__(16) float f1s[K6_WARPS][PC];
  __shared__ float sdots[K6_WARPS][MAXT * MAXT];
  __shared__ CorrWindow qwin[TILE_H * TILE_W];
  __shared__ int qn[TILE_H * TILE_W];  // query index n, or -1 off the grid
  __shared__ int plan[4];              // box x0, y0, row stride; staged
  __shared__ __align__(8) unsigned long long bar;

  const int lvl = blockIdx.y;
  const int b = blockIdx.x / tiles_per_b, tile = blockIdx.x % tiles_per_b;
  const int qy0 = (tile / tiles_x) * TILE_H, qx0 = (tile % tiles_x) * TILE_W;
  const int Hp = lv.Hp[lvl], Wp = lv.Wp[lvl];
  const unsigned char* level = (const unsigned char*)lv.ptr[lvl];
  const long long N = (long long)h * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (warp == 0) {  // plan: each lane one query of the tile
    const int qy = qy0 + lane / TILE_W, qx = qx0 + lane % TILE_W;
    const bool in = qy < h && qx < w;
    const long long n = (long long)qy * w + qx;
    CorrWindow win = {0, 0, 0.f, 0.f, false};
    if (in) {
      const long long q = b * N + n;
      win = corr_window<R>(coords[q * 2], coords[q * 2 + 1], lv.scale[lvl],
                           Hp, Wp);
    }
    qwin[lane] = win;
    qn[lane] = in ? (int)n : -1;
    const bool use = in && win.vq;  // only these read taps
    const int x_lo = __reduce_min_sync(0xffffffffu, use ? win.sx : 0x7fffffff);
    const int y_lo = __reduce_min_sync(0xffffffffu, use ? win.sy : 0x7fffffff);
    const int x_hi = __reduce_max_sync(0xffffffffu, use ? win.sx : -1);
    const int y_hi = __reduce_max_sync(0xffffffffu, use ? win.sy : -1);
    // no query reads taps: nothing to stage and nothing to read
    const bool any = x_hi >= 0;
    const int bw = any ? x_hi - x_lo + T : 0, bh = any ? y_hi - y_lo + T : 0;
    const long long stride = (long long)bw * PIX_BYTES + 16;
    const bool staged = any && stride * bh <= box_bytes;
    if (lane == 0) {
      plan[0] = x_lo;
      plan[1] = y_lo;
      plan[2] = (int)stride;
      plan[3] = staged;
      if (staged) {
        mbar_init(smem_u32(&bar), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        mbar_expect(smem_u32(&bar), (unsigned)(bw * bh * PIX_BYTES));
      }
    }
    __syncwarp();
    if (staged) {
      for (int row = lane; row < bh; row += 32)
        bulk_copy(box + row * stride,
                  level + (((long long)b * Hp + y_lo + row) * Wp + x_lo) *
                              PIX_BYTES,
                  (unsigned)(bw * PIX_BYTES), smem_u32(&bar));
    }
  }
  __syncthreads();
  const bool staged = plan[3] != 0;
  if (staged) mbar_wait(smem_u32(&bar), 0);

  float* a = f1s[warp];
  float* dots = sdots[warp];
  float* outl = out + offset + lvl * K;
  // a query's f1 row is loaded while the one before it computes
  auto f1_row = [&](int i) {
    return qn[i] >= 0 ? __ldg((const uint2*)(f1 + (b * N + qn[i]) * (PC * 2)) +
                              lane)
                      : make_uint2(0u, 0u);
  };
  uint2 v = f1_row(warp);
  for (int i = warp; i < TILE_H * TILE_W; i += K6_WARPS) {
    const uint2 next =
        i + K6_WARPS < TILE_H * TILE_W ? f1_row(i + K6_WARPS) : make_uint2(0u, 0u);
    const int n = qn[i];
    if (n >= 0) {  // the whole warp
      const CorrWindow win = qwin[i];
      const long long q = b * N + n;
      if (win.vq) {
        *(float4*)(a + 4 * lane) =
            make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
        __syncwarp();
        if (staged) {
          const long long stride = plan[2];
          tap_dots<R, true>(box + (win.sy - plan[1]) * stride +
                                (win.sx - plan[0]) * PIX_BYTES,
                            stride, a, dots, lane);
        } else {
          const long long stride = (long long)Wp * PIX_BYTES;
          tap_dots<R, false>(
              level + (((long long)b * Hp + win.sy) * Wp + win.sx) * PIX_BYTES,
              stride, a, dots, lane);
        }
      } else {
        // the whole window lies outside the level: every tap is masked to 0
        for (int tap = lane; tap < T * T; tap += 32) dots[tap] = 0.f;
      }
      __syncwarp();
      const float gx = __fsub_rn(1.0f, win.fx), gy = __fsub_rn(1.0f, win.fy);
      float* op = outl + q * out_c;
      for (int o = lane; o < K; o += 32) {
        const int yy = o / R1, xx = o - yy * R1;
        const float* d = dots + yy * T + xx;
        op[o] = corr_bilinear(gx, win.fx, gy, win.fy, d[0], d[1], d[T], d[T + 1]);
      }
      __syncwarp();  // dots and a are the next query's
    }
    v = next;
  }
}

template <int R>
static int launch(const void* f1, const CorrLevels& lv, const void* coords,
                  void* out, int B, int h, int w, int out_c, int offset,
                  int box_bytes, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      corr_patch_lookup_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      box_bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (w + TILE_W - 1) / TILE_W;
  const int tiles_per_b = tiles_x * ((h + TILE_H - 1) / TILE_H);
  dim3 grid((unsigned)(B * tiles_per_b), (unsigned)lv.n);
  corr_patch_lookup_kernel<R><<<grid, 32 * K6_WARPS, box_bytes, s>>>(
      (const unsigned char*)f1, lv, (const float*)coords, (float*)out, h, w,
      tiles_x, tiles_per_b, out_c, offset, box_bytes);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

#define KB_WARPS 8  // queries of a block, one a warp

// The f32 gradients of the padded levels, one launch's worth
struct CorrGrads {
  float* ptr[CORR_MAX_LEVELS];
};

#if !defined(__CUDACC_VER_MAJOR__) || __CUDACC_VER_MAJOR__ < 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ < 1)
#error "corr_patch.cu needs nvcc 12.1 or later (16-byte float4 atomicAdd)"
#endif

__device__ __forceinline__ void add4(float* p, float a, float b, float c,
                                     float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

template <int R>
__global__ void __launch_bounds__(32 * KB_WARPS)
corr_patch_lookup_backward_kernel(const unsigned char* __restrict__ f1,
                                  const __grid_constant__ CorrLevels lv,
                                  const float* __restrict__ coords,
                                  const float* __restrict__ g,
                                  __nv_bfloat16* __restrict__ df1,
                                  const __grid_constant__ CorrGrads dl,
                                  long long N, long long total) {
  constexpr int T = 2 * R + 2, R1 = 2 * R + 1, K = R1 * R1;
  __shared__ float sg[KB_WARPS][K];
  __shared__ float sd[KB_WARPS][MAXT * MAXT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * KB_WARPS + warp;
  if (q >= total) return;  // the whole warp
  const long long b = q / N;
  const uint2 fv = __ldg(reinterpret_cast<const uint2*>(f1 + q * (PC * 2)) + lane);
  const float f[4] = {bf16_lo(fv.x), bf16_hi(fv.x), bf16_lo(fv.y), bf16_hi(fv.y)};
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const float* gq = g + q * (long long)(lv.n * K);
  float* gs = sg[warp];
  float* ds = sd[warp];
  for (int lvl = 0; lvl < lv.n; ++lvl) {
    const int Hp = lv.Hp[lvl], Wp = lv.Wp[lvl];
    const CorrWindow win =
        corr_window<R>(coords[q * 2], coords[q * 2 + 1], lv.scale[lvl], Hp, Wp);
    if (!win.vq) continue;  // every tap is masked: no cotangent
    for (int o = lane; o < K; o += 32) gs[o] = __ldg(gq + lvl * K + o);
    __syncwarp();
    const float gx = __fsub_rn(1.0f, win.fx), gy = __fsub_rn(1.0f, win.fy);
    for (int tap = lane; tap < T * T; tap += 32) {
      const int ty = tap / T, tx = tap - ty * T;
      float d = 0.f;
      if (ty < R1 && tx < R1)
        d = __fadd_rn(d, __fmul_rn(__fmul_rn(gs[ty * R1 + tx], gy), gx));
      if (ty < R1 && tx >= 1)
        d = __fadd_rn(d, __fmul_rn(__fmul_rn(gs[ty * R1 + tx - 1], gy), win.fx));
      if (ty >= 1 && tx < R1)
        d = __fadd_rn(d, __fmul_rn(__fmul_rn(gs[(ty - 1) * R1 + tx], win.fy), gx));
      if (ty >= 1 && tx >= 1)
        d = __fadd_rn(d, __fmul_rn(__fmul_rn(gs[(ty - 1) * R1 + tx - 1], win.fy),
                                   win.fx));
      ds[tap] = d;
    }
    __syncwarp();
    const long long at = (b * Hp + win.sy) * Wp + win.sx;  // tap (0, 0)
    const unsigned char* lp =
        (const unsigned char*)lv.ptr[lvl] + at * PIX_BYTES + lane * 8;
    float* gp = dl.ptr[lvl] + at * PC + lane * 4;
    for (int ty = 0; ty < T; ++ty) {
      for (int tx = 0; tx < T; ++tx) {
        const float d = ds[ty * T + tx];
        const long long off = (long long)ty * Wp + tx;
        const uint2 kv = __ldg(reinterpret_cast<const uint2*>(lp + off * PIX_BYTES));
        acc[0] = __fmaf_rn(d, bf16_lo(kv.x), acc[0]);
        acc[1] = __fmaf_rn(d, bf16_hi(kv.x), acc[1]);
        acc[2] = __fmaf_rn(d, bf16_lo(kv.y), acc[2]);
        acc[3] = __fmaf_rn(d, bf16_hi(kv.y), acc[3]);
        if (d != 0.f)
          add4(gp + off * PC, __fmul_rn(d, f[0]), __fmul_rn(d, f[1]),
               __fmul_rn(d, f[2]), __fmul_rn(d, f[3]));
      }
    }
    __syncwarp();  // gs and ds are the next level's
  }
  __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0], acc[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2], acc[3]);
  uint2 out;
  out.x = *reinterpret_cast<unsigned*>(&lo);
  out.y = *reinterpret_cast<unsigned*>(&hi);
  reinterpret_cast<uint2*>(df1 + q * PC)[lane] = out;
}

template <int R>
static int launch_backward(const void* f1, const CorrLevels& lv,
                           const CorrGrads& dl, const void* coords,
                           const void* g, void* df1, long long N,
                           long long total, cudaStream_t s) {
  const unsigned blocks = (unsigned)((total + KB_WARPS - 1) / KB_WARPS);
  corr_patch_lookup_backward_kernel<R><<<blocks, 32 * KB_WARPS, 0, s>>>(
      (const unsigned char*)f1, lv, (const float*)coords, (const float*)g,
      (__nv_bfloat16*)df1, dl, N, total);
  return (int)cudaGetLastError();
}

// The backward: g (B, h, w, L * (2r+1)^2) f32 cotangents of one launch's
// output (offset 0); df1 (B, h*w, 128) bf16, written in full; grads: L
// device pointers, f32 (B, Hp, Wp, 128) zeroed buffers the kernel adds into.
extern "C" int corr_patch_lookup_backward_launch(
    const void* f1, const void* const* levels, const int* hw,
    const float* scales, int L, const void* coords, const void* g, void* df1,
    void* const* grads, int B, int h, int w, int r, void* stream) {
  if (L < 1 || L > CORR_MAX_LEVELS || r < 0 || 2 * r + 2 > MAXT)
    return (int)cudaErrorInvalidValue;
  CorrLevels lv = {};
  CorrGrads dl = {};
  for (int i = 0; i < L; ++i) {
    lv.ptr[i] = levels[i];
    lv.Hp[i] = hw[2 * i];
    lv.Wp[i] = hw[2 * i + 1];
    lv.scale[i] = scales[i];
    dl.ptr[i] = (float*)grads[i];
  }
  lv.n = L;
  const long long N = (long long)h * w, total = (long long)B * N;
  if (total == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (r) {
    case 0: return launch_backward<0>(f1, lv, dl, coords, g, df1, N, total, s);
    case 1: return launch_backward<1>(f1, lv, dl, coords, g, df1, N, total, s);
    case 2: return launch_backward<2>(f1, lv, dl, coords, g, df1, N, total, s);
    default: return launch_backward<3>(f1, lv, dl, coords, g, df1, N, total, s);
  }
}

// levels: L device pointers (B, Hp, Wp, 128) bf16, 16-byte aligned; hw: L
// (Hp, Wp) pairs; scales: L floats.  Level i writes channels
// [offset + i * (2r+1)^2, ...).  box_bytes: the shared memory a block may
// stage its box in (a multiple of 16).
extern "C" int corr_patch_lookup_launch(const void* f1,
                                        const void* const* levels,
                                        const int* hw, const float* scales,
                                        int L, const void* coords, void* out,
                                        int B, int h, int w, int r, int out_c,
                                        int offset, int box_bytes,
                                        void* stream) {
  if (L < 1 || L > CORR_MAX_LEVELS || r < 0 || 2 * r + 2 > MAXT ||
      box_bytes < 0 || box_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CorrLevels lv = {};
  for (int i = 0; i < L; ++i) {
    lv.ptr[i] = levels[i];
    lv.Hp[i] = hw[2 * i];
    lv.Wp[i] = hw[2 * i + 1];
    lv.scale[i] = scales[i];
  }
  lv.n = L;
  if ((long long)B * h * w == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (r) {
    case 0: return launch<0>(f1, lv, coords, out, B, h, w, out_c, offset, box_bytes, s);
    case 1: return launch<1>(f1, lv, coords, out, B, h, w, out_c, offset, box_bytes, s);
    case 2: return launch<2>(f1, lv, coords, out, B, h, w, out_c, offset, box_bytes, s);
    default: return launch<3>(f1, lv, coords, out, B, h, w, out_c, offset, box_bytes, s);
  }
}
