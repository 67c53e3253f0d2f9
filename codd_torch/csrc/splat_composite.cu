// Front-to-back alpha compositing of sorted splat fragments, sm_90a.
//
// Replaces codd_tpu/ops/pallas/splat_composite.py:composite_tiles.  Pixel
// p's run is order[offsets[p] .. offsets[p+1]) of fragment ids, sorted by
// (pixel, quantized z), ties by fragment id; fragment o belongs to point
// n = o % N.  Weight alpha * exp(sum of log1p(-alpha) over the earlier
// fragments of the run), for the first ppp fragments only; zbuf is the
// first fragment's z (0 for an empty run) and count the run length.  No
// per-tile overflow drop.  Every output is the same sequence of the same
// rounded operations as a walk of its pixel's run, whichever kernel runs,
// so the bits do not depend on the form; ids and the remainder o % N are
// taken in 32 bits (the wrapper holds K*N < 2^31).
//
// Two forms, one launch a call, chosen by C (PERF.md has the measurements):
// - C <= WALK_C (the motion module's full-res call: C = 6, ~2-3 fragments
//   a pixel, 491,520 pixels): a thread a pixel walks its run with the sums
//   in registers.  Its cost is the gathers' traffic; every batched, tiled
//   or grouped form measured ran slower.
// - Wider features (the quarter-res call: C = 32, ~9-12 fragments a pixel,
//   30,720 pixels, fewer than the card holds threads): a walk waits on its
//   dependent loads one fragment after another.  splat_composite_lanes
//   gives a pixel LANES lanes of one warp, each holding LANE_CH channels
//   (c0 + g + k * LANES): the lanes read the run's ids and alphas a lane a
//   fragment, share them by shuffles, and load ROWS feature rows at a time,
//   a row's channels across the lanes.  Four pixels a warp keep every
//   pixel of that call in flight at once.
// No tensor cores: there are no products to batch (the TPU kernel's
// one-hot matmuls stand in for scatters, which a GPU does not need).
#include <cuda_runtime.h>

#define WALK_C 8          // channels a walk holds in registers, at most
#define WALK_THREADS 256  // threads a block of the walk
#define LANES 8           // lanes a pixel in splat_composite_lanes
#define LANE_CH 4         // channels a lane holds
#define ROWS 2            // feature rows a lane loads at a time
#define LANE_THREADS 256  // threads a block of splat_composite_lanes

// a thread a pixel, its run in order (C <= WALK_C)
__global__ void __launch_bounds__(WALK_THREADS)
splat_composite_walk(const long long* __restrict__ order,
                     const long long* __restrict__ offsets,
                     const float* __restrict__ alpha,
                     const float* __restrict__ z,
                     const float* __restrict__ feat, float* __restrict__ out,
                     float* __restrict__ zbuf, float* __restrict__ cnt,
                     int npix, int N, int C, int ppp) {
  const int p = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (p >= npix) return;
  const int s = (int)offsets[p], e = (int)offsets[p + 1];
  float acc[WALK_C];
#pragma unroll
  for (int c = 0; c < WALK_C; ++c) acc[c] = 0.f;
  float logT = 0.f;
  const int stop = e - s > ppp ? s + ppp : e;
  for (int i = s; i < stop; ++i) {
    const int o = (int)order[i];
    const float a = alpha[o];
    const float wgt = __fmul_rn(a, expf(logT));
    const float* fp = feat + (long long)((unsigned)o % (unsigned)N) * C;
#pragma unroll
    for (int c = 0; c < WALK_C; ++c)
      if (c < C) acc[c] = __fadd_rn(acc[c], __fmul_rn(fp[c], wgt));
    logT = __fadd_rn(logT, log1pf(-a));
  }
  float* op = out + (long long)p * C;
#pragma unroll
  for (int c = 0; c < WALK_C; ++c)
    if (c < C) op[c] = acc[c];
  zbuf[p] = e > s ? z[(unsigned)order[s] % (unsigned)N] : 0.0f;
  cnt[p] = (float)(e - s);
}

// LANES lanes a pixel, lanes over channels (any C)
__global__ void __launch_bounds__(LANE_THREADS)
splat_composite_lanes(const long long* __restrict__ order,
                      const long long* __restrict__ offsets,
                      const float* __restrict__ alpha,
                      const float* __restrict__ z,
                      const float* __restrict__ feat, float* __restrict__ out,
                      float* __restrict__ zbuf, float* __restrict__ cnt,
                      int npix, int N, int C, int ppp) {
  static_assert(ROWS <= LANES && LANES % ROWS == 0 && 32 % LANES == 0,
                "a step's rows within a group, groups within a warp");
  const unsigned FULL = 0xffffffffu;
  const int g = threadIdx.x % LANES;
  const long long q =
      ((long long)blockIdx.x * LANE_THREADS + threadIdx.x) / LANES;
  const bool live = q < npix;
  const int p = live ? (int)q : 0;
  int s = 0, e = 0;
  if (live) {
    s = (int)offsets[p];
    e = (int)offsets[p + 1];
  }
  const int m = e - s > ppp ? ppp : e - s;    // fragments composited
  const int mw = __reduce_max_sync(FULL, m);  // the warp's, for the loops
  if (live && g == 0) {
    zbuf[p] = e > s ? z[(unsigned)order[s] % (unsigned)N] : 0.0f;
    cnt[p] = (float)(e - s);
  }
  float* op = out + (long long)p * C;
  for (int c0 = 0; c0 < C; c0 += LANES * LANE_CH) {
    float acc[LANE_CH];
#pragma unroll
    for (int k = 0; k < LANE_CH; ++k) acc[k] = 0.f;
    float logT = 0.f;
    for (int b = 0; b < mw; b += LANES) {
      const int nb = m - b;  // this pixel's fragments left (may be <= 0)
      float a = 0.f;
      int n = 0;
      if (g < nb) {
        const int o = (int)order[s + b + g];
        a = alpha[o];
        n = (int)((unsigned)o % (unsigned)N);
      }
      const int rw = mw - b < LANES ? mw - b : LANES;
      for (int r = 0; r < rw; r += ROWS) {
        float f[ROWS][LANE_CH], av[ROWS];
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const int nr = __shfl_sync(FULL, n, r + u, LANES);
          av[u] = __shfl_sync(FULL, a, r + u, LANES);
#pragma unroll
          for (int k = 0; k < LANE_CH; ++k) {
            const int c = c0 + g + k * LANES;
            f[u][k] = r + u < nb && c < C ? feat[(long long)nr * C + c] : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
          if (r + u < nb) {
            const float wgt = __fmul_rn(av[u], expf(logT));
#pragma unroll
            for (int k = 0; k < LANE_CH; ++k)
              acc[k] = __fadd_rn(acc[k], __fmul_rn(f[u][k], wgt));
            logT = __fadd_rn(logT, log1pf(-av[u]));
          }
      }
    }
#pragma unroll
    for (int k = 0; k < LANE_CH; ++k) {
      const int c = c0 + g + k * LANES;
      if (live && c < C) op[c] = acc[k];
    }
  }
}

// form: 0 by C, 1 the walk (C <= WALK_C), 2 the lanes
extern "C" int splat_composite_launch(const void* order, const void* offsets,
                                      const void* alpha, const void* z,
                                      const void* feat, void* out, void* zbuf,
                                      void* cnt, int npix, int N, int C,
                                      int ppp, int form, void* stream) {
  if (npix == 0) return 0;
  if (form == 0) form = C <= WALK_C ? 1 : 2;
  if (form == 1 && C > WALK_C) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long* o = (const long long*)order;
  const long long* off = (const long long*)offsets;
  if (form == 1) {
    splat_composite_walk<<<(npix + WALK_THREADS - 1) / WALK_THREADS,
                           WALK_THREADS, 0, st>>>(
        o, off, (const float*)alpha, (const float*)z, (const float*)feat,
        (float*)out, (float*)zbuf, (float*)cnt, npix, N, C, ppp);
  } else {
    const long long threads = (long long)npix * LANES;
    splat_composite_lanes<<<(int)((threads + LANE_THREADS - 1) /
                                  LANE_THREADS),
                            LANE_THREADS, 0, st>>>(
        o, off, (const float*)alpha, (const float*)z, (const float*)feat,
        (float*)out, (float*)zbuf, (float*)cnt, npix, N, C, ppp);
  }
  return (int)cudaGetLastError();
}
