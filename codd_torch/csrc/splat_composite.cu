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
//
// The backward (training; the VJP of codd_tpu/ops/splat.py:_splat_one_sort,
// whose forward is this function).  For pixel p's run, fragments i in key
// order with w_i = a_i T_i (T_i = exp of the exclusive sum of log1p(-a)),
// i < ppp, and the cotangents g_p (C floats) and gz_p:
//   dfeat[n] += w_i g_p over the fragments i of point n;
//   dalpha_i  = T_i (g_p . f_i) - (1 / (1 - a_i)) sum_{i<k<ppp} w_k (g_p . f_k)
//               (0 for i >= ppp);
//   dz[n]    += gz_p for the run's head fragment.
// Two launches, no float atomics, so every sum has a fixed order and two
// runs give the same bits.  A point's sum runs over its K fragments, which
// lie in K different runs, so it needs every run done first; a launch
// boundary is that grid-wide barrier.
// - The runs pass writes, at each fragment id of the run, dalpha and
//   frag[o] = (w_i, p, head flag in the sign bit) for the second pass;
//   fragments past ppp get w = 0 and dalpha = 0.  The exclusive sum of
//   log1p(-a) is the forward's sequence of rounded adds, so w_i is the
//   forward's weight in bits, and the suffix sum of w_k (g . f_k) is taken
//   from the run's end one add at a time.  Two forms, by C, like the
//   forward: for C <= WALK_C (the full-res call: C = 6, ~2-3 fragments a
//   pixel) splat_composite_backward_runs gives a pixel BLANES lanes, lane
//   r the run's rank-r fragment and its dot g_p . f in channel order, the
//   two sums passed along the lanes one add at a time; for wider features
//   (the quarter-res call: C = 32) splat_composite_backward_lanes gives a
//   pixel a warp, lane (r, j) = (lane / 4, lane % 4) the rank-r fragment
//   and channels 8j .. 8j + 7 (+ 32 t), each dot four chains of 8 joined by
//   a fixed xor-shuffle tree (a 32-long chain a lane waits on its loads),
//   the sums along the lanes at stride 4, and it writes one 16-byte record
//   frag[o] = (w, p, dalpha), which the points pass copies to dalpha: one
//   scattered store a fragment, not two.  So ppp <= BLANES.  At full res
//   the cost is those scattered stores; a walk a pixel, the 16-byte
//   record and records in run order all measured slower there (PERF.md
//   section 6, PR 15).
// - The points pass: a thread a point and group of 4 channels walks the
//   point's K fragments (o = k N + n) in order: one with alpha > 0 lies in
//   a run (a culled fragment has alpha 0, the projection's mask) and adds
//   w g_p, and gz_p where it heads its run; the culled ones get dalpha = 0
//   here, so dalpha needs no zero fill.
#include <cuda_runtime.h>

#define WALK_C 8          // channels a walk holds in registers, at most
#define WALK_THREADS 256  // threads a block of the walk
#define LANES 8           // lanes a pixel in splat_composite_lanes
#define LANE_CH 4         // channels a lane holds
#define ROWS 2            // feature rows a lane loads at a time
#define LANE_THREADS 256  // threads a block of splat_composite_lanes
#define BLANES 8          // lanes a pixel in the 8-lane run pass (ppp max)
#define BWD_THREADS 256   // threads a block of either backward pass
#define HEAD_BIT 0x80000000u  // frag[o].y: the fragment heads its run

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

// ---------------------------------------------------------------------------
// backward

// g . f over C channels in channel order, one fmaf each: by 16- or
// 8-byte loads where every row of that C is so aligned (the same bits)
__device__ __forceinline__ float row_dot(const float* __restrict__ gp,
                                        const float* __restrict__ fp, int C) {
  float dot = 0.f;
  if ((C & 3) == 0) {
#pragma unroll 4
    for (int c = 0; c < C; c += 4) {
      const float4 u = *(const float4*)(gp + c), v = *(const float4*)(fp + c);
      dot = fmaf(u.w, v.w, fmaf(u.z, v.z, fmaf(u.y, v.y, fmaf(u.x, v.x, dot))));
    }
  } else if ((C & 1) == 0) {
#pragma unroll 4
    for (int c = 0; c < C; c += 2) {
      const float2 u = *(const float2*)(gp + c), v = *(const float2*)(fp + c);
      dot = fmaf(u.y, v.y, fmaf(u.x, v.x, dot));
    }
  } else {
    for (int c = 0; c < C; ++c) dot = fmaf(gp[c], fp[c], dot);
  }
  return dot;
}

// BLANES lanes a pixel, lane r the run's rank-r fragment
__global__ void __launch_bounds__(BWD_THREADS)
splat_composite_backward_runs(const long long* __restrict__ order,
                              const long long* __restrict__ offsets,
                              const float* __restrict__ alpha,
                              const float* __restrict__ feat,
                              const float* __restrict__ g,
                              float* __restrict__ dalpha,
                              int2* __restrict__ frag, int npix, int N, int C,
                              int ppp) {
  static_assert(32 % BLANES == 0, "groups within a warp");
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x % BLANES;
  const long long q =
      ((long long)blockIdx.x * BWD_THREADS + threadIdx.x) / BLANES;
  const bool live = q < npix;
  const int p = live ? (int)q : 0;
  int s = 0, e = 0;
  if (live) {
    s = (int)offsets[p];
    e = (int)offsets[p + 1];
  }
  const int m = e - s > ppp ? ppp : e - s;  // fragments composited
  const bool mine = lane < m;
  int o = 0;
  float a = 0.f, dot = 0.f;
  if (mine) {
    o = (int)order[s + lane];
    a = alpha[o];
    const long long fo = (long long)((unsigned)o % (unsigned)N) * C;
    dot = row_dot(g + (long long)p * C, feat + fo, C);
  }
  // exclusive sum of log1p(-a) up the lanes: after round r the lanes <= r
  // hold theirs, each the forward's running sum, one add at a time
  const float la = mine ? log1pf(-a) : 0.f;
  float excl = 0.f;
#pragma unroll
  for (int r = 1; r < BLANES; ++r) {
    const float up = __shfl_up_sync(FULL, __fadd_rn(excl, la), 1, BLANES);
    if (lane >= 1) excl = up;
  }
  const float T = expf(excl);
  const float w = mine ? __fmul_rn(a, T) : 0.f;
  const float wd = __fmul_rn(w, dot);
  // sum of w_k (g . f_k) over the later fragments, passed down the lanes
  float after = 0.f;
#pragma unroll
  for (int r = 1; r < BLANES; ++r) {
    const float dn = __shfl_down_sync(FULL, __fadd_rn(after, wd), 1, BLANES);
    if (lane < BLANES - 1) after = dn;
  }
  if (mine) {
    dalpha[o] = __fsub_rn(__fmul_rn(T, dot),
                          __fdiv_rn(after, __fsub_rn(1.0f, a)));
    frag[o] = make_int2(__float_as_int(w),
                        (int)((unsigned)p | (lane == 0 ? HEAD_BIT : 0u)));
  }
  for (int r = ppp + lane; r < e - s; r += BLANES) {  // past ppp: no weight
    const int o2 = (int)order[s + r];
    dalpha[o2] = 0.f;
    frag[o2] = make_int2(0, p);
  }
}

// a warp a pixel: lane (r, j) the run's rank-r fragment, channels 8j + 32t
// .. + 7 (C > WALK_C)
__global__ void __launch_bounds__(BWD_THREADS)
splat_composite_backward_lanes(const long long* __restrict__ order,
                               const long long* __restrict__ offsets,
                               const float* __restrict__ alpha,
                               const float* __restrict__ feat,
                               const float* __restrict__ g,
                               int4* __restrict__ frag, int npix, int N,
                               int C, int ppp) {
  static_assert(BLANES * 4 == 32, "a rank's 4 lanes, a run's ranks a warp");
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31, r = lane >> 2, j = lane & 3;
  const long long q = ((long long)blockIdx.x * BWD_THREADS + threadIdx.x) >> 5;
  if (q >= npix) return;  // the whole warp
  const int p = (int)q;
  const int s = (int)offsets[p], e = (int)offsets[p + 1];
  const int m = e - s > ppp ? ppp : e - s;  // fragments composited
  const bool mine = r < m;
  int o = 0;
  float a = 0.f, dot = 0.f;
  if (mine) {
    o = (int)order[s + r];
    a = alpha[o];
  }
  // CUTOUT lanes dot {
  if (mine) {
    const float* gp = g + (long long)p * C;
    const float* fp = feat + (long long)((unsigned)o % (unsigned)N) * C;
    for (int c = 8 * j; c < C; c += 32) {
      if ((C & 3) == 0) {  // two 16-byte loads of each row
#pragma unroll
        for (int h = 0; h < 8; h += 4) {
          if (c + h >= C) break;
          const float4 u = *(const float4*)(gp + c + h),
                       v = *(const float4*)(fp + c + h);
          dot = fmaf(u.w, v.w,
                     fmaf(u.z, v.z, fmaf(u.y, v.y, fmaf(u.x, v.x, dot))));
        }
      } else {
        for (int k = c; k < c + 8 && k < C; ++k) dot = fmaf(gp[k], fp[k], dot);
      }
    }
  }
  // the four chains of a fragment: (j0 + j1) + (j2 + j3)
  dot = __fadd_rn(dot, __shfl_xor_sync(FULL, dot, 1));
  dot = __fadd_rn(dot, __shfl_xor_sync(FULL, dot, 2));
  // CUTOUT lanes dot }
  const float la = mine ? log1pf(-a) : 0.f;
  float excl = 0.f;
  // CUTOUT scan1 {
  // exclusive sum of log1p(-a) up the ranks: after round k the ranks <= k
  // hold theirs, each the forward's running sum, one add at a time
#pragma unroll
  for (int k = 1; k < BLANES; ++k) {
    const float up = __shfl_up_sync(FULL, __fadd_rn(excl, la), 4);
    if (r >= 1) excl = up;
  }
  // CUTOUT scan1 }
  const float T = expf(excl);
  const float w = mine ? __fmul_rn(a, T) : 0.f;
  const float wd = __fmul_rn(w, dot);
  float after = 0.f;
  // CUTOUT scan2 {
  // sum of w_k (g . f_k) over the later fragments, passed down the ranks
#pragma unroll
  for (int k = 1; k < BLANES; ++k) {
    const float dn = __shfl_down_sync(FULL, __fadd_rn(after, wd), 4);
    if (r < BLANES - 1) after = dn;
  }
  // CUTOUT scan2 }
  if (mine && j == 0)
    frag[o] = make_int4(__float_as_int(w),
                        (int)((unsigned)p | (r == 0 ? HEAD_BIT : 0u)),
                        __float_as_int(__fsub_rn(__fmul_rn(T, dot),
                            __fdiv_rn(after, __fsub_rn(1.0f, a)))), 0);
  for (int k = ppp + lane; k < e - s; k += 32)  // past ppp: no weight
    frag[order[s + k]] = make_int4(0, p, 0, 0);
}

// a thread a point and group of 4 channels, its K fragments in order;
// REC16: frag holds 16-byte records (w, p, dalpha), copied to dalpha here
template <bool REC16>
__global__ void __launch_bounds__(BWD_THREADS)
splat_composite_backward_points(const float* __restrict__ alpha,
                                const void* __restrict__ frag,
                                const float* __restrict__ g,
                                const float* __restrict__ gz,
                                float* __restrict__ dfeat,
                                float* __restrict__ dalpha,
                                float* __restrict__ dz, int N, int C, int K,
                                int groups) {
  const long long t = (long long)blockIdx.x * BWD_THREADS + threadIdx.x;
  if (t >= (long long)N * groups) return;
  const int n = (int)(t / groups), c0 = (int)(t % groups) * 4;
  const bool first = c0 == 0;
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, az = 0.f;
  for (int k = 0; k < K; ++k) {
    const long long o = (long long)k * N + n;
    if (alpha[o] > 0.f) {
      int2 fr;
      if (REC16) {
        const int4 r = reinterpret_cast<const int4*>(frag)[o];
        fr = make_int2(r.x, r.y);
        if (first) dalpha[o] = __int_as_float(r.z);
      } else {
        fr = reinterpret_cast<const int2*>(frag)[o];
      }
      const float w = __int_as_float(fr.x);
      const unsigned pu = (unsigned)fr.y;
      const float* gp = g + (long long)(pu & ~HEAD_BIT) * C + c0;
      float gv[4];
      if ((C & 3) == 0) {
        const float4 v = *(const float4*)gp;
        gv[0] = v.x, gv[1] = v.y, gv[2] = v.z, gv[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[j] = c0 + j < C ? gp[j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(w, gv[j]));
      if (first && (pu & HEAD_BIT)) az = __fadd_rn(az, gz[pu & ~HEAD_BIT]);
    } else if (first) {
      dalpha[o] = 0.f;  // culled: in no run
    }
  }
  float* dp = dfeat + (long long)n * C;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c0 + j < C) dp[c0 + j] = acc[j];
  if (first) dz[n] = az;
}

// frag: 4 K*N ints of scratch, written where the first pass reaches: an
// int2 (w, p) a fragment id for C <= WALK_C (dalpha written beside), an
// int4 (w, p, dalpha) above
extern "C" int splat_composite_backward_launch(
    const void* order, const void* offsets, const void* alpha,
    const void* feat, const void* g, const void* gz, void* frag, void* dfeat,
    void* dalpha, void* dz, int npix, int N, int C, int K, int ppp,
    void* stream) {
  if (ppp > BLANES || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool eight = C <= WALK_C;  // the 8-lane runs pass, int2 records
  const long long* o = (const long long*)order;
  const long long* off = (const long long*)offsets;
  if (npix > 0) {  // CUTOUT runs
    const long long threads = (long long)npix * (eight ? BLANES : 32);
    const int blocks = (int)((threads + BWD_THREADS - 1) / BWD_THREADS);
    if (eight)
      splat_composite_backward_runs<<<blocks, BWD_THREADS, 0, st>>>(
          o, off, (const float*)alpha, (const float*)feat, (const float*)g,
          (float*)dalpha, (int2*)frag, npix, N, C, ppp);
    else
      splat_composite_backward_lanes<<<blocks, BWD_THREADS, 0, st>>>(
          o, off, (const float*)alpha, (const float*)feat, (const float*)g,
          (int4*)frag, npix, N, C, ppp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (N > 0) {  // CUTOUT points
    const int groups = (C + 3) / 4;
    const long long threads = (long long)N * groups;
    const int blocks = (int)((threads + BWD_THREADS - 1) / BWD_THREADS);
    if (eight)
      splat_composite_backward_points<false><<<blocks, BWD_THREADS, 0, st>>>(
          (const float*)alpha, frag, (const float*)g, (const float*)gz,
          (float*)dfeat, (float*)dalpha, (float*)dz, N, C, K, groups);
    else
      splat_composite_backward_points<true><<<blocks, BWD_THREADS, 0, st>>>(
          (const float*)alpha, frag, (const float*)g, (const float*)gz,
          (float*)dfeat, (float*)dalpha, (float*)dz, N, C, K, groups);
  }
  return (int)cudaGetLastError();
}
