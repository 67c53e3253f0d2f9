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
// which XLA differentiates there).  Per query and level the 49 cotangents
// go through the transpose of the bilinear combine to the t*t tap
// cotangents (each corner's term added in the order d00, d01, d10, d11, as
// corr.py:_bilinear_transpose; a masked query, vq = 0, has none); then
// df1 += sum_taps dtap * level[tap] and dlevel[tap] += dtap * f1.  The
// second is a scatter into windows that neighbouring queries share: the
// first form of this kernel (a warp a query) added 64 x 128 f32 a query
// and level into the level's gradient with global atomics, 598.7 M scalar
// adds at the motion stage's training call (B=4, 48x96 queries), and read
// every tap from L2.
//
// This form takes the forward's tile (4 x 8 queries) and half of the 128
// channels a block, and every level in turn, and writes both sums as
// products over the box of the tile's windows, chunk by chunk (at most
// pmax pixels: bands of whole box rows, or runs of one row of a wider
// box).  D (chunk pixel x the tile's 32 queries, f32 in shared memory)
// holds each query's tap cotangents at its window, 0 elsewhere; then
//   dbox  = D F1       (pixels x 32 x 64 channels)
//   df1^T += box^T D   (64 channels x pixels x 32)
// on mma.sync m16n8k8 TF32: f1 and the box are bf16, exact in TF32; D is
// split into hi + lo (2^-22 of it is lost), the small product first.
// Each element of dbox is one fresh accumulator (8 mma), complete for the
// block, and is added to the level once, a 16-byte atomicAdd of 4
// channels, where some window covers its pixel: 40.8 M scalar adds a call
// at the training call on chip_smoke.py's smooth field (96.7 M on the
// scattered one).  The halo that neighbouring tiles share meets in
// global memory in a run-dependent order; a block's own sums have a fixed
// order, and df1, whose groups of 8 k-steps join the running f32 sums by
// IEEE adds (the tensor cores truncate where they accumulate), is written
// once, rounded to bf16: equal bits on every launch.  The chunk's half
// pixels are staged 16 bytes a thread by cp.async, counted on an mbarrier
// (one arrival a thread), while dbox, which needs only D and F1, runs.
// (One cp.async.bulk a half pixel, issued by one warp, was slower.)
// Shared-memory f32 atomics into an f32 box, the simpler alternative,
// need 64 KB a 256-pixel half box for the gradient alone and keep the
// scatter's 64 x 64 adds a query a block; the products touch each box
// element once.
// Pixel rows of the box are 160 bytes and D's rows 40 floats, so the
// fragment loads of both products meet 8 different bank groups a quarter
// warp.
//
// What bounds it: each chunk's fixed cost (zeroing and filling D, three
// block barriers, the copies' latency) and each level's plan come first,
// then the two products, then the global atomics (copies of the kernel
// with one part cut out at a time); far above the 0.036 ms the function's
// operations take in f32 at the training call (see PERF.md).  106
// registers at r = 3, no spills (-Xptxas=-v; the first form: 40-48,
// none).
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

// The forward: grid (tiles, levels), a block one level of one tile, its
// queries' 49 outputs.
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

  const int b = blockIdx.x / tiles_per_b, tile = blockIdx.x % tiles_per_b;
  const int qy0 = (tile / tiles_x) * TILE_H, qx0 = (tile % tiles_x) * TILE_W;
  const long long N = (long long)h * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lvl = blockIdx.y;
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int Hp = lv.Hp[lvl], Wp = lv.Wp[lvl];
  const unsigned char* level = (const unsigned char*)lv.ptr[lvl];
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
    const int x_lo =
        __reduce_min_sync(0xffffffffu, use ? win.sx : 0x7fffffff);
    const int y_lo =
        __reduce_min_sync(0xffffffffu, use ? win.sy : 0x7fffffff);
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
      if (staged) mbar_expect(smem_u32(&bar), (unsigned)(bw * bh * PIX_BYTES));
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
  // a query's f1 row is loaded while the one before it computes
  auto f1_row = [&](int i) {
    return qn[i] >= 0
               ? __ldg((const uint2*)(f1 + (b * N + qn[i]) * (PC * 2)) + lane)
               : make_uint2(0u, 0u);
  };
  uint2 v = f1_row(warp);
  for (int i = warp; i < TILE_H * TILE_W; i += K6_WARPS) {
    const uint2 next = i + K6_WARPS < TILE_H * TILE_W ? f1_row(i + K6_WARPS)
                                                      : make_uint2(0u, 0u);
    const int n = qn[i];
    if (n >= 0) {  // the whole warp
      const CorrWindow win = qwin[i];
      const long long q = b * N + n;
      if (win.vq) {
        *(float4*)(a + 4 * lane) = make_float4(bf16_lo(v.x), bf16_hi(v.x),
                                               bf16_lo(v.y), bf16_hi(v.y));
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
        // the whole window lies outside the level: every tap is masked
        for (int tap = lane; tap < T * T; tap += 32) dots[tap] = 0.f;
      }
      __syncwarp();
      const float gx = __fsub_rn(1.0f, win.fx), gy = __fsub_rn(1.0f, win.fy);
      float* op = out + offset + lvl * K + q * out_c;
      for (int o = lane; o < K; o += 32) {
        const int yy = o / R1, xx = o - yy * R1;
        const float* d = dots + yy * T + xx;
        op[o] = corr_bilinear(gx, win.fx, gy, win.fy, d[0], d[1], d[T],
                              d[T + 1]);
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

#define KB_THREADS 256  // 8 warps
#define KB_CH 64        // channels of a block: one half of the 128
#define KB_PIX 160      // bytes of a staged half pixel: 64 bf16 + 32 pad
#define KB_DROW 40      // floats of a D row: 32 queries, the coverage flag, pad
#define KB_F1ROW 72     // floats of a staged f1 row: 64 channels + pad
// shared memory a chunk pixel takes (its half pixel and its D row); the
// wrapper's budget over this, in whole m-tiles of 16, is the chunk size
#define KB_PIX_BYTES (KB_PIX + 4 * KB_DROW)

// The f32 gradients of the padded levels, one launch's worth
struct CorrGrads {
  float* ptr[CORR_MAX_LEVELS];
};

#if !defined(__CUDACC_VER_MAJOR__) || __CUDACC_VER_MAJOR__ < 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ < 1)
#error "corr_patch.cu needs nvcc 12.1 or later (16-byte float4 atomicAdd)"
#endif

// dynamic shared memory of a backward block: the chunk (pmax half pixels
// and D rows), f1 of the tile's queries and their cotangents, every level
__host__ __device__ inline int kb_smem_bytes(int pmax, int L, int K) {
  return pmax * KB_PIX_BYTES + 32 * KB_F1ROW * 4 + 32 * L * K * 4;
}

// 16 bytes from global to shared memory by this thread, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// one arrival on ``bar`` once this thread's earlier cp.async have landed
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

template <int R>
__global__ void __launch_bounds__(KB_THREADS, 2)
corr_patch_lookup_backward_kernel(const unsigned char* __restrict__ f1,
                                  const __grid_constant__ CorrLevels lv,
                                  const float* __restrict__ coords,
                                  const float* __restrict__ g,
                                  __nv_bfloat16* __restrict__ df1,
                                  const __grid_constant__ CorrGrads dl, int h,
                                  int w, int tiles_x, int tiles_per_b,
                                  int pmax) {
  constexpr int T = 2 * R + 2, R1 = 2 * R + 1, K = R1 * R1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = lv.n;
  unsigned char* box = smem;                           // [pmax][KB_PIX]
  float* D = reinterpret_cast<float*>(smem + pmax * KB_PIX);  // [pmax][KB_DROW]
  float* f1s = D + pmax * KB_DROW;                     // [32][KB_F1ROW]
  float* gs = f1s + 32 * KB_F1ROW;                     // [32][L * K]
  __shared__ CorrWindow qwin[TILE_H * TILE_W];
  __shared__ float2 qc[TILE_H * TILE_W];  // the queries' coordinates
  __shared__ int qn[TILE_H * TILE_W];     // query index n, or -1 off the grid
  __shared__ int plan[4];                 // box x0, y0, width (0: nothing), height
  __shared__ __align__(8) unsigned long long bar;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, c = lane & 3;  // mma group and thread in group
  const int b = blockIdx.x / tiles_per_b, tile = blockIdx.x % tiles_per_b;
  const int ch0 = blockIdx.y * KB_CH;      // the block's channels
  const int qy0 = (tile / tiles_x) * TILE_H, qx0 = (tile % tiles_x) * TILE_W;
  const long long N = (long long)h * w;

  if (tid < TILE_H * TILE_W) {
    const int qy = qy0 + tid / TILE_W, qx = qx0 + tid % TILE_W;
    const bool in = qy < h && qx < w;
    const long long n = (long long)qy * w + qx;
    qn[tid] = in ? (int)n : -1;
    qc[tid] = in ? make_float2(__ldg(coords + (b * N + n) * 2),
                               __ldg(coords + (b * N + n) * 2 + 1))
                 : make_float2(0.f, 0.f);
  }
  if (tid == 0) {  // every thread arrives once a chunk, when its copies land
    mbar_init(smem_u32(&bar), KB_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // f1 of the tile's queries, this half's channels, widened to f32 (exact,
  // and so exact in TF32), and the queries' cotangents of every level; 0
  // for a query off the grid
  for (int e = tid; e < 32 * (KB_CH / 4); e += KB_THREADS) {
    const int q = e / (KB_CH / 4), part = e % (KB_CH / 4);
    uint2 v = make_uint2(0u, 0u);
    if (qn[q] >= 0)
      v = __ldg(reinterpret_cast<const uint2*>(
                    f1 + ((b * N + qn[q]) * PC + ch0) * 2) + part);
    *reinterpret_cast<float4*>(f1s + q * KB_F1ROW + 4 * part) =
        make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
  }
  for (int e = tid; e < 32 * L * K; e += KB_THREADS) {
    const int q = e / (L * K), o = e - q * (L * K);
    gs[e] = qn[q] >= 0 ? __ldg(g + (b * N + qn[q]) * (long long)(L * K) + o)
                       : 0.f;
  }

  // df1^T of the tile, summed over every level in registers: this warp's
  // m-tile of 16 channels (mt) and two n-tiles of 8 queries (nt0, nt0 + 1).
  // Lane (gq, c) holds channels 16 mt + 2 gq (rows gq of the mma) and
  // 16 mt + 2 gq + 1 (rows gq + 8) of queries 8 nt + 2c and 8 nt + 2c + 1.
  const int mt = warp & 3, nt0 = 2 * (warp >> 2);
  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  unsigned phase = 0;

  for (int lvl = 0; lvl < L; ++lvl) {
    const int Hp = lv.Hp[lvl], Wp = lv.Wp[lvl];
    const unsigned char* level = (const unsigned char*)lv.ptr[lvl];
    __syncthreads();  // the last level's windows and chunk are used
    if (warp == 0) {  // plan: each lane one query of the tile
      CorrWindow win = corr_window<R>(qc[lane].x, qc[lane].y, lv.scale[lvl],
                                      Hp, Wp);
      win.vq = win.vq && qn[lane] >= 0;  // only these have taps
      qwin[lane] = win;
      const int x_lo = __reduce_min_sync(0xffffffffu, win.vq ? win.sx : 0x7fffffff);
      const int y_lo = __reduce_min_sync(0xffffffffu, win.vq ? win.sy : 0x7fffffff);
      const int x_hi = __reduce_max_sync(0xffffffffu, win.vq ? win.sx : -1);
      const int y_hi = __reduce_max_sync(0xffffffffu, win.vq ? win.sy : -1);
      if (lane == 0) {
        const bool any = x_hi >= 0;
        plan[0] = x_lo;
        plan[1] = y_lo;
        plan[2] = any ? x_hi - x_lo + T : 0;
        plan[3] = any ? y_hi - y_lo + T : 0;
      }
    }
    __syncthreads();
    const int x_lo = plan[0], y_lo = plan[1], bw = plan[2], bh = plan[3];
    if (bw == 0) continue;  // no window touches the level (block-uniform)
    // The box in chunks of at most pmax pixels: bands of whole rows, or,
    // for a box wider than pmax, runs of pmax pixels of one row.
    const int cw = bw <= pmax ? bw : pmax;
    const int rows = bw <= pmax ? pmax / bw : 1;
    float* dlv = dl.ptr[lvl];
    for (int cy = 0; cy < bh; cy += rows) {
      for (int cx = 0; cx < bw; cx += cw) {
        const int nr = min(rows, bh - cy), nc = min(cw, bw - cx);
        const int P = nr * nc, Pp = (P + 15) & ~15;
        const int ax = x_lo + cx, ay = y_lo + cy;  // on the padded level
        __syncthreads();  // the last chunk's D and box are read
        for (int e = tid; e < Pp * (KB_DROW / 4); e += KB_THREADS)
          reinterpret_cast<float4*>(D)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int e = tid; e < (Pp - P) * (KB_PIX / 16); e += KB_THREADS)
          reinterpret_cast<uint4*>(box + P * KB_PIX)[e] = make_uint4(0u, 0u, 0u, 0u);
        __syncthreads();
        // D (chunk pixel p, query q): q's tap cotangent at p, 0 where p is
        // outside q's window; column 32 flags the pixels some window
        // covers.  A tap's cotangent is the transpose of the bilinear
        // combine, each corner's term added in the order d00, d01, d10, d11
        // (corr.py:_bilinear_transpose).
        int any = 0;
        for (int e = tid; e < 32 * T * T; e += KB_THREADS) {
          const int q = e / (T * T), tap = e - q * (T * T);
          const int ty = tap / T, tx = tap - ty * T;
          const CorrWindow win = qwin[q];
          const int py = win.sy + ty - ay, px = win.sx + tx - ax;
          if (win.vq && py >= 0 && py < nr && px >= 0 && px < nc) {
            const float* gg = gs + q * (L * K) + lvl * K;
            const float gx = __fsub_rn(1.0f, win.fx), gy = __fsub_rn(1.0f, win.fy);
            float d = 0.f;
            if (ty < R1 && tx < R1)
              d = __fadd_rn(d, __fmul_rn(__fmul_rn(gg[ty * R1 + tx], gy), gx));
            if (ty < R1 && tx >= 1)
              d = __fadd_rn(d, __fmul_rn(__fmul_rn(gg[ty * R1 + tx - 1], gy), win.fx));
            if (ty >= 1 && tx < R1)
              d = __fadd_rn(d, __fmul_rn(__fmul_rn(gg[(ty - 1) * R1 + tx], win.fy), gx));
            if (ty >= 1 && tx >= 1)
              d = __fadd_rn(d, __fmul_rn(__fmul_rn(gg[(ty - 1) * R1 + tx - 1], win.fy),
                                         win.fx));
            const int p = py * nc + px;
            D[p * KB_DROW + q] = d;
            D[p * KB_DROW + 32] = 1.0f;
            any = 1;
          }
        }
        if (!__syncthreads_or(any)) continue;  // no window meets the chunk
        // the chunk's half pixels, 16 bytes a thread at a time; each thread
        // arrives on the barrier when its copies have landed
        for (int e = tid; e < P * (KB_CH / 8); e += KB_THREADS) {
          const int p = e / (KB_CH / 8), part = e % (KB_CH / 8);
          const int py = p / nc, px = p - py * nc;
          cp_async16(box + p * KB_PIX + 16 * part,
                     level + (((long long)b * Hp + ay + py) * Wp + ax + px) *
                                 PIX_BYTES + ch0 * 2 + 16 * part);
        }
        cp_async_arrive(smem_u32(&bar));

        // The level's gradient on the chunk, dbox = D F1 (P x 32 queries x
        // 64 channels): an m-tile of 16 pixels at a time a warp, D split
        // into TF32 hi + lo (F1 is exact), small product first.  Each
        // element is complete in one fresh accumulator (8 mma), so the
        // block adds it to the level once: a 16-byte atomicAdd of 4
        // channels, for the pixels some window covers.
        for (int m0 = 16 * warp; m0 < Pp; m0 += 16 * (KB_THREADS / 32)) {
          unsigned ah[4][4], al[4][4];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float* dr = D + (m0 + gq) * KB_DROW + 8 * s + c;
            split_tf32(dr[0], ah[s][0], al[s][0]);
            split_tf32(dr[8 * KB_DROW], ah[s][1], al[s][1]);
            split_tf32(dr[4], ah[s][2], al[s][2]);
            split_tf32(dr[8 * KB_DROW + 4], ah[s][3], al[s][3]);
          }
          // after the exchange below: row gq (even c) or gq + 8 (odd c)
          const bool odd = c & 1;
          const int p = m0 + gq + (odd ? 8 : 0);
          const bool add = p < P && D[p * KB_DROW + 32] != 0.f;
          const int py = p / nc, px = p - py * nc;
          float* gp = dlv + (((long long)b * Hp + ay + py) * Wp + ax + px) * PC +
                      ch0 + 2 * c - (odd ? 2 : 0);
#pragma unroll 2
          for (int nt = 0; nt < KB_CH / 8; ++nt) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const unsigned b0 = __float_as_uint(f1s[(8 * s + c) * KB_F1ROW + 8 * nt + gq]);
              const unsigned b1 =
                  __float_as_uint(f1s[(8 * s + c + 4) * KB_F1ROW + 8 * nt + gq]);
              mma_tf32(d, al[s], b0, b1);
              mma_tf32(d, ah[s], b0, b1);
            }
            // lanes c and c ^ 1 trade halves: the even lane keeps row gq,
            // channels 2c .. 2c + 3 of the n-tile; the odd one row gq + 8,
            // channels 2c - 2 .. 2c + 1
            const float r0 = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
            const float r1 = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
            if (add)
              atomicAdd(reinterpret_cast<float4*>(gp + 8 * nt),
                        odd ? make_float4(r0, r1, d[2], d[3])
                            : make_float4(d[0], d[1], r0, r1));
          }
        }

        // df1^T += box^T D (64 channels x P x 32 queries): bf16 box values
        // are exact in TF32, D is split.  Groups of 8 k-steps go to a fresh
        // accumulator and join the running sum by IEEE adds (the tensor
        // cores truncate where they accumulate).
        mbar_wait(smem_u32(&bar), phase & 1);
        ++phase;
        const unsigned char* ap = box + (16 * mt + 2 * gq) * 2;
        for (int k0 = 0; k0 < Pp; k0 += 64) {
          float part[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
          const int kend = min(k0 + 64, Pp);
          for (int kk = k0; kk < kend; kk += 8) {
            const unsigned u0 = *reinterpret_cast<const unsigned*>(ap + (kk + c) * KB_PIX);
            const unsigned u1 =
                *reinterpret_cast<const unsigned*>(ap + (kk + c + 4) * KB_PIX);
            const unsigned a[4] = {u0 << 16, u0 & 0xffff0000u, u1 << 16,
                                   u1 & 0xffff0000u};
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float* dr = D + (kk + c) * KB_DROW + 8 * (nt0 + j) + gq;
              unsigned h0, l0, h1, l1;
              split_tf32(dr[0], h0, l0);
              split_tf32(dr[4 * KB_DROW], h1, l1);
              mma_tf32(part[j], a, l0, l1);
              mma_tf32(part[j], a, h0, h1);
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
        }
      }
    }
  }

  // df1, written in full: each f32 sum rounded once to bf16
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = 8 * (nt0 + j) + 2 * c;
    const int ch = ch0 + 16 * mt + 2 * gq;
    if (qn[q] >= 0)
      *reinterpret_cast<unsigned*>(df1 + (b * N + qn[q]) * PC + ch) =
          pack_bf16(acc[j][0], acc[j][2]);
    if (qn[q + 1] >= 0)
      *reinterpret_cast<unsigned*>(df1 + (b * N + qn[q + 1]) * PC + ch) =
          pack_bf16(acc[j][1], acc[j][3]);
  }
}

template <int R>
static int launch_backward(const void* f1, const CorrLevels& lv,
                           const CorrGrads& dl, const void* coords,
                           const void* g, void* df1, int B, int h, int w,
                           int pmax, cudaStream_t s) {
  const int bytes = kb_smem_bytes(pmax, lv.n, (2 * R + 1) * (2 * R + 1));
  cudaError_t err = cudaFuncSetAttribute(
      corr_patch_lookup_backward_kernel<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  // two blocks an SM need more than the default split of L1 and shared memory
  err = cudaFuncSetAttribute(corr_patch_lookup_backward_kernel<R>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (w + TILE_W - 1) / TILE_W;
  const int tiles_per_b = tiles_x * ((h + TILE_H - 1) / TILE_H);
  dim3 grid((unsigned)(B * tiles_per_b), PC / KB_CH);
  corr_patch_lookup_backward_kernel<R><<<grid, KB_THREADS, bytes, s>>>(
      (const unsigned char*)f1, lv, (const float*)coords, (const float*)g,
      (__nv_bfloat16*)df1, dl, h, w, tiles_x, tiles_per_b, pmax);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the coordinates' gradient
// ---------------------------------------------------------------------------
//
// For each query, sum_o g[o] d out[o] / d (fx, fy) over its window, the
// bilinear weights' derivatives (floor() has none):
//   d out / d fx = (1 - fy)(d01 - d00) + fy (d11 - d10)
//   d out / d fy = (1 - fx)(d10 - d00) + fx (d11 - d01)
// from the forward's masked tap dots d, and dcoords[q] = sum over levels,
// in order, of scale * that: two floats a query.  A masked query (vq = 0)
// has zero dots and so zero gradient, as in codd_tpu.
//
// A block takes one level of the forward's 4 x 8 tile (grid (tiles, L)).
// Every tap dot of the tile is one product on the tensor cores, S = F1
// box^T (the tile's 32 queries x the pixels of the box of their windows,
// k = 128 channels), mma.sync m16n8k16 on bf16 operands (exact products)
// with f32 sums; each group of four k-steps starts from 0 and joins the
// running sum by an IEEE add (the tensor cores truncate where they
// accumulate).  The box is staged in chunks of at most pmax pixels (the
// wrapper's budget; bands of whole box rows, or runs of one row of a
// wider box), by cp.async, 16 bytes a thread, each pixel's sixteen 16-byte
// chunks swizzled by its low three bits; the tile's f1 rows come with the
// first chunk, the same way.  Every box is staged: reading the taps of a
// large one from global memory, a warp a query, as the forward does, took
// 82 % of the time on the scattered field (PERF.md).  A warp takes one
// m-tile of 16 queries and every fourth n-tile of 8 pixels, its operands
// by ldmatrix (the swizzle puts the 8 rows of each 8 x 8 matrix in 8 bank
// groups), and writes each (query, pixel) that lies in the query's window
// to its tap in shared memory, where the f1 rows were.  A tap's value is
// its own column of one mma, whatever the chunk: the same bits at any
// budget.  The epilogue gives each query 8 lanes, each lane outputs o = l,
// l + 8, ... in order by fmaf, joined by a fixed xor-shuffle tree (4, 2,
// 1).  Each block writes its 32 queries' level gradients to scratch, and a
// second kernel, a thread a query, sums the L levels in order (as
// corr.py:_coords_backward does): no atomics, the same bits on every
// launch.  (The L levels of a tile as one thread block cluster, rank 0
// summing them through distributed shared memory, kept the cluster's
// blocks resident until the level-0 block, the largest box, was done:
// 0.090 against 0.058 ms, PERF.md.)
#define KC_THREADS 256  // 8 warps: two m-tiles of 16 queries, four n-tile phases

// byte offset of 16-byte chunk j of staged row (pixel or query) p
__device__ __forceinline__ int swz(int p, int j) {
  return p * PIX_BYTES + ((j ^ (p & 7)) << 4);
}

// four 8 x 8 b16 matrices, lane l giving the address of row l & 7 of
// matrix l >> 3
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int R>
__global__ void __launch_bounds__(KC_THREADS, 3)
corr_patch_lookup_coords_backward_kernel(
    const unsigned char* __restrict__ f1, const __grid_constant__ CorrLevels lv,
    const float* __restrict__ coords, const float* __restrict__ g, int h,
    int w, int tiles_x, int tiles_per_b, int gc, int pmax,
    float2* __restrict__ part) {
  constexpr int T = 2 * R + 2, R1 = 2 * R + 1, K = R1 * R1;
  extern __shared__ __align__(128) unsigned char box[];  // [pmax][PIX_BYTES]
  // each query's t x t tap dots; before them, the tile's f1 rows (bf16)
  __shared__ __align__(128) float taps[TILE_H * TILE_W][MAXT * MAXT];
  __shared__ CorrWindow qwin[TILE_H * TILE_W];
  __shared__ int qn[TILE_H * TILE_W];  // query index n, or -1 off the grid
  __shared__ int plan[4];              // box x0, y0, width (0: none), height

  const int b = blockIdx.x / tiles_per_b, tile = blockIdx.x % tiles_per_b;
  const int qy0 = (tile / tiles_x) * TILE_H, qx0 = (tile % tiles_x) * TILE_W;
  const long long N = (long long)h * w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lvl = blockIdx.y;
  const int Hp = lv.Hp[lvl], Wp = lv.Wp[lvl];
  const unsigned char* level = (const unsigned char*)lv.ptr[lvl];
  if (warp == 0) {  // plan: each lane one query of the tile
    const int qy = qy0 + lane / TILE_W, qx = qx0 + lane % TILE_W;
    const bool in = qy < h && qx < w;
    const long long n = (long long)qy * w + qx;
    CorrWindow win = {0, 0, 0.f, 0.f, false};
    if (in)
      win = corr_window<R>(coords[(b * N + n) * 2], coords[(b * N + n) * 2 + 1],
                           lv.scale[lvl], Hp, Wp);
    win.vq = win.vq && in;  // only these read taps
    qwin[lane] = win;
    qn[lane] = in ? (int)n : -1;
    const int x_lo = __reduce_min_sync(0xffffffffu, win.vq ? win.sx : 0x7fffffff);
    const int y_lo = __reduce_min_sync(0xffffffffu, win.vq ? win.sy : 0x7fffffff);
    const int x_hi = __reduce_max_sync(0xffffffffu, win.vq ? win.sx : -1);
    const int y_hi = __reduce_max_sync(0xffffffffu, win.vq ? win.sy : -1);
    if (lane == 0) {
      const bool any = x_hi >= 0;
      plan[0] = x_lo;
      plan[1] = y_lo;
      plan[2] = any ? x_hi - x_lo + T : 0;
      plan[3] = any ? y_hi - y_lo + T : 0;
    }
  }
  __syncthreads();
  const int x_lo = plan[0], y_lo = plan[1], bw = plan[2], bh = plan[3];
  unsigned char* ftile = reinterpret_cast<unsigned char*>(taps);

  // CUTOUT dots {
  const int mt = warp & 1, gq = lane >> 2, c = lane & 3;
  unsigned a[8][4];  // the m-tile's f1 over the 8 k-steps of 16 channels
  int wy[2], wx[2];  // this lane's accumulator rows, queries 16 mt + gq, + 8
  bool use[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const CorrWindow win = qwin[16 * mt + gq + 8 * i];
    use[i] = win.vq;
    wy[i] = win.sy - y_lo;
    wx[i] = win.sx - x_lo;
  }
  // chunks: bands of whole rows, or runs of pmax pixels of one row
  const int cw = bw <= pmax ? bw : pmax, rows = bw <= pmax ? pmax / bw : 1;
  bool first = true;
  for (int cy = 0; cy < bh; cy += rows) {
    for (int cx = 0; cx < bw; cx += cw) {
      const int nr = min(rows, bh - cy), nc = min(cw, bw - cx), P = nr * nc;
      // CUTOUT stage {
      if (!first) __syncthreads();  // the last chunk is read
      {  // pixel p = e / 16 at (py, px) of the chunk, stepped without a
         // division: e advances by KC_THREADS, p by KC_THREADS / 16
        const int j = tid & 15;
        int p = tid >> 4, py = p / nc, px = p - py * nc;
        for (; p < P; p += KC_THREADS / 16) {
          cp_async16(box + swz(p, j),
                     level + (((long long)b * Hp + y_lo + cy + py) * Wp + x_lo +
                              cx + px) * PIX_BYTES + 16 * j);
          for (px += KC_THREADS / 16; px >= nc; px -= nc) ++py;
        }
      }
      if (first)
        for (int e = tid; e < TILE_H * TILE_W * 16; e += KC_THREADS) {
          const int q = e >> 4, j = e & 15;
          if (qn[q] >= 0)
            cp_async16(ftile + swz(q, j),
                       f1 + (b * N + qn[q]) * PIX_BYTES + 16 * j);
          else
            *reinterpret_cast<uint4*>(ftile + swz(q, j)) =
                make_uint4(0u, 0u, 0u, 0u);
        }
      cp_async_wait_all();
      __syncthreads();
      // CUTOUT stage }
      if (first) {
        const int row = 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          ldsm_x4(a[ks], smem_u32(ftile + swz(row, 2 * ks + (lane >> 4))));
        __syncthreads();  // every warp holds its f1 before taps overwrite it
        first = false;
      }
      int sy = (8 * (warp >> 1) + 2 * c) / nc;  // pixel p0 + 2c at (sy, sx)
      int sx = 8 * (warp >> 1) + 2 * c - sy * nc;
      for (int p0 = 8 * (warp >> 1); p0 < P; p0 += 8 * (KC_THREADS / 64)) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kg = 0; kg < 2; ++kg) {
          float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < 4; kk += 2) {
            const int ks = 4 * kg + kk;
            unsigned bb[4];  // k-steps ks and ks + 1: chunks 2 ks .. 2 ks + 3
            ldsm_x4(bb, smem_u32(box + swz(p0 + (lane & 7), 2 * ks + (lane >> 3))));
            mma_bf16(s4, a[ks], bb[0], bb[1]);
            mma_bf16(s4, a[ks + 1], bb[2], bb[3]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], s4[e]);
        }
        // d[e]: query 16 mt + gq + 8 (e >> 1), chunk pixel p0 + 2c + (e & 1)
        const int p = p0 + 2 * c, py = sy, px = sx;
        const int by[2] = {cy + py, cy + py + (px + 1 == nc)};
        const int bx[2] = {cx + px, px + 1 == nc ? cx : cx + px + 1};
        for (sx += 8 * (KC_THREADS / 64); sx >= nc; sx -= nc) ++sy;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, k = e & 1;
          const int ty = by[k] - wy[i], tx = bx[k] - wx[i];
          if (use[i] && p + k < P && (unsigned)ty < (unsigned)T &&
              (unsigned)tx < (unsigned)T)
            taps[16 * mt + gq + 8 * i][ty * T + tx] = d[e];
        }
      }
    }
  }
  __syncthreads();
  // CUTOUT dots }

  {  // the epilogue: 8 lanes a query
    const int q = tid >> 3, l = tid & 7;
    const CorrWindow win = qwin[q];
    const float* dots = taps[q];
    float px = 0.f, py = 0.f;
    if (win.vq) {
    // CUTOUT epilogue {
      const float gx = __fsub_rn(1.0f, win.fx), gy = __fsub_rn(1.0f, win.fy);
      const float* gp = g + (b * N + qn[q]) * (long long)gc + lvl * K;
      for (int o = l; o < K; o += 8) {
        const int yy = o / R1, xx = o - yy * R1;
        const float* d = dots + yy * T + xx;
        const float dfx = __fadd_rn(__fmul_rn(gy, __fsub_rn(d[1], d[0])),
                                    __fmul_rn(win.fy, __fsub_rn(d[T + 1], d[T])));
        const float dfy = __fadd_rn(__fmul_rn(gx, __fsub_rn(d[T], d[0])),
                                    __fmul_rn(win.fx, __fsub_rn(d[T + 1], d[1])));
        px = fmaf(__ldg(gp + o), dfx, px);
        py = fmaf(__ldg(gp + o), dfy, py);
      }
    // CUTOUT epilogue }
    }
#pragma unroll
    for (int m = 4; m > 0; m >>= 1) {  // lanes of one query (uniform in 8)
      px = __fadd_rn(px, __shfl_xor_sync(0xffffffffu, px, m));
      py = __fadd_rn(py, __shfl_xor_sync(0xffffffffu, py, m));
    }
    if (l == 0 && qn[q] >= 0)
      part[(long long)lvl * (gridDim.x / tiles_per_b) * N + b * N + qn[q]] =
          make_float2(px, py);
  }
}

// dcoords[q] = sum over levels, in order, of scale * part[level][q]
__global__ void __launch_bounds__(256)
corr_patch_lookup_coords_backward_sum(const float2* __restrict__ part,
                                      const __grid_constant__ CorrLevels lv,
                                      float2* __restrict__ dcoords,
                                      long long BN) {
  const long long q = (long long)blockIdx.x * 256 + threadIdx.x;
  if (q >= BN) return;
  float2 acc = make_float2(0.f, 0.f);
  for (int r = 0; r < lv.n; ++r) {
    const float2 pr = part[r * BN + q];
    acc.x = fmaf(lv.scale[r], pr.x, acc.x);
    acc.y = fmaf(lv.scale[r], pr.y, acc.y);
  }
  dcoords[q] = acc;
}

template <int R>
static int launch_coords(const void* f1, const CorrLevels& lv,
                         const void* coords, void* dcoords, void* part,
                         const void* g, int B, int h, int w, int pmax,
                         cudaStream_t s) {
  const int bytes = pmax * PIX_BYTES;
  auto fn = corr_patch_lookup_coords_backward_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (w + TILE_W - 1) / TILE_W;
  const int tiles_per_b = tiles_x * ((h + TILE_H - 1) / TILE_H);
  fn<<<dim3((unsigned)(B * tiles_per_b), (unsigned)lv.n), KC_THREADS, bytes,
       s>>>((const unsigned char*)f1, lv, (const float*)coords,
            (const float*)g, h, w, tiles_x, tiles_per_b,
            lv.n * (2 * R + 1) * (2 * R + 1), pmax, (float2*)part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long BN = (long long)B * h * w;
  corr_patch_lookup_coords_backward_sum<<<(unsigned)((BN + 255) / 256), 256,
                                          0, s>>>((const float2*)part, lv,
                                                  (float2*)dcoords, BN);
  return (int)cudaGetLastError();
}

// The backward: g (B, h, w, L * (2r+1)^2) f32 cotangents of one launch's
// output (offset 0); df1 (B, h*w, 128) bf16, written in full; grads: L
// device pointers, f32 (B, Hp, Wp, 128) zeroed buffers the kernel adds into.
// box_bytes: the shared memory a block may stage a chunk of its box in
// (KB_PIX_BYTES a pixel; at least one m-tile of 16 pixels).
extern "C" int corr_patch_lookup_backward_launch(
    const void* f1, const void* const* levels, const int* hw,
    const float* scales, int L, const void* coords, const void* g, void* df1,
    void* const* grads, int B, int h, int w, int r, int box_bytes,
    void* stream) {
  if (L < 1 || L > CORR_MAX_LEVELS || r < 0 || 2 * r + 2 > MAXT ||
      box_bytes < 0)
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
  if ((long long)B * h * w == 0) return 0;
  const int fit = box_bytes / KB_PIX_BYTES / 16 * 16;
  const int pmax = fit > 16 ? fit : 16;
  cudaStream_t s = (cudaStream_t)stream;
  switch (r) {
    case 0: return launch_backward<0>(f1, lv, dl, coords, g, df1, B, h, w, pmax, s);
    case 1: return launch_backward<1>(f1, lv, dl, coords, g, df1, B, h, w, pmax, s);
    case 2: return launch_backward<2>(f1, lv, dl, coords, g, df1, B, h, w, pmax, s);
    default: return launch_backward<3>(f1, lv, dl, coords, g, df1, B, h, w, pmax, s);
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

// The gradient of the lookup's coordinates: g (B,h,w,L*K) the cotangent of
// the four-level output, dcoords (B,h,w,2) f32, written in full; part: L *
// B*h*w float2 of scratch (each level's gradients).  box_bytes: the shared
// memory a block may stage a chunk of its box in (256 bytes a pixel, in
// whole n-tiles of 8 pixels, at least one).
extern "C" int corr_patch_lookup_coords_backward_launch(
    const void* f1, const void* const* levels, const int* hw,
    const float* scales, int L, const void* coords, const void* g,
    void* dcoords, void* part, int B, int h, int w, int r, int box_bytes,
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
  const int fit = box_bytes / PIX_BYTES / 8 * 8;
  const int pmax = fit > 8 ? fit : 8;
  cudaStream_t s = (cudaStream_t)stream;
  switch (r) {
    case 0: return launch_coords<0>(f1, lv, coords, dcoords, part, g, B, h, w, pmax, s);
    case 1: return launch_coords<1>(f1, lv, coords, dcoords, part, g, B, h, w, pmax, s);
    case 2: return launch_coords<2>(f1, lv, coords, dcoords, part, g, B, h, w, pmax, s);
    default: return launch_coords<3>(f1, lv, coords, dcoords, part, g, B, h, w, pmax, s);
  }
}
