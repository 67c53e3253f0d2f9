// Slant-plane tile-warp cost (HITNet propagation), sm_90a.
//
// Replaces codd_tpu/ops/pallas/tile_warp.py:tile_warp_cost.  One thread
// per pixel (b, y, x): the pixel's plane disparity, its four right-feature
// taps on row y, three lerped warps (k = -1, 0, +1) and their L1 costs to
// the left feature, written straight into the PixelUnshuffled
// (B, ht, wt, 48) layout, channel k*16 + i*4 + j.  Bound by bytes; see
// codd_torch/ops/tile_warp.py.
//
// Three forms, one body (the FORM template parameter):
//   0  f32 in, f32 out.  Arithmetic that decides floor() uses
//      round-to-nearest intrinsics so nvcc cannot contract it into FMAs
//      that the plain PyTorch version does not do.
//   1  bf16 in, bf16 out, "exact": codd_tpu's tile_warping computed in
//      bf16, i.e. every elementwise step rounded to bf16 in the order of
//      the plain version (the plane offsets of jnp.linspace in bf16, the
//      x grid itself in bf16, the gather start rounded twice), the channel
//      sum in f32 and rounded once.  The per-channel lerp and |l - w| run
//      as native bf16x2 operations on the loaded pairs: each f32 step and
//      its rounding to bf16 was a conversion, ~190 a pixel, and those
//      conversions set the form's time.
//   2  bf16 in, bf16 out, "pallas": form 0's f32 body on the widened
//      inputs (bf16 -> f32 is exact), only the output rounded.
//
// Backward (tile_warp_cost_backward_launch, forms 0 and 1): the VJP of
// tile_warping given g = dL/dcost (B, ht, wt, 48).  Per pixel, tap pair
// (m, m+1) of offset k and s = +1 where fea_l - warped >= 0, -1 elsewhere
// (JAX's derivative of |x|, select(x >= 0, g, -g)):
//   dfea_l          += g_k s                     (the pixel's own: stored)
//   dfea_r[x0-1+m]  -= g_k s (1 - f)             (in-image taps only: a
//   dfea_r[x0+m]    -= g_k s f                    scatter along the row)
//   dlocal_d        += sum_c g_k s (tap_{m+1} - tap_m)     (floor() has no
//   dhyp3[tile]     += dlocal_d * (1, a, b)                 gradient, df/dp = 1)
// with a, b the pixel's column and row offsets in its tile.  Every tap of a
// pixel on row y lies on row y, so one block owns a row of dfea_r and turns
// the scatter into a gather: it sorts the row's pixels by their first tap,
// keeps each pixel's g, f and the 2-bit signs s in shared memory, and each
// column rebuilds and sums the terms of the taps that read it and stores
// them once, with no float atomics and no zero fill.  A cluster of the 4
// row blocks of a tile row sums each tile's dlocal through distributed
// shared memory and writes dhyp3 once, in a fixed order.  Bound by bytes
// like the forward (each input read once, each gradient written once).
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

// one bf16 rounding of an f32 result, back in f32 (round to nearest even)
__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&u.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&u.y);
  float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four bf16 channels as two pairs, unwidened
__device__ __forceinline__ void load_pairs(const __nv_bfloat16* p,
                                           __nv_bfloat162 (&v)[2]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  v[1] = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
}

__device__ __forceinline__ float l1_f32(float l, float a, float b, float g,
                                        float f) {
  return fabsf(l - __fadd_rn(__fmul_rn(a, g), __fmul_rn(b, f)));
}

// Form 1's plane of pixel x on row i of its tile: tile_warping's steps in
// bf16.  The plane offsets are jnp.linspace(-1.5, 1.5, 4, dtype=bf16) =
// {-1.5, -0.49609375, 0.5, 1.5}; the x grid is a bf16 arange.  The 4-column
// block starts at clip(x0 - 1 + 3, 0, W + 2) in the 3-column zero-padded
// row, both sums and the bound W + 2 rounded to bf16, and the gather clamps
// the start to W + 2 (col0 = start - 3 is the first tap's column); tap m
// reads the image where x0 - 1 + m lies in [0, W - 1], computed exactly
// (XLA keeps that sum in f32), and its column does too.
__device__ __forceinline__ void plane_exact(float d, float sx, float sy,
                                            int x, int i, int W, float& x0,
                                            float& f, int& col0,
                                            bool (&ok)[4]) {
  const float cs[4] = {-1.5f, -0.49609375f, 0.5f, 1.5f};
  const float local_d = rb(__fadd_rn(
      rb(__fadd_rn(d, rb(__fmul_rn(cs[x & 3], sx)))),
      rb(__fmul_rn(cs[i], sy))));
  const float p = rb(__fsub_rn(rb((float)x), local_d));
  x0 = floorf(p);
  f = rb(__fsub_rn(p, x0));
  const float s = fminf(
      fmaxf(rb(__fadd_rn(rb(__fsub_rn(x0, 1.0f)), 3.0f)), 0.0f),
      rb((float)(W + 2)));
  col0 = min((int)s, W + 2) - 3;
  for (int m = 0; m < 4; ++m) {
    const float xm = x0 - 1.0f + (float)m;
    const int col = col0 + m;
    ok[m] = xm >= 0.0f && xm <= (float)(W - 1) && col >= 0 && col < W;
  }
}

template <int FORM, typename T>
__global__ void tile_warp_cost_kernel(const T* __restrict__ hyp3,
                                      const T* __restrict__ fea_l,
                                      const T* __restrict__ fea_r,
                                      T* __restrict__ out, int B, int H,
                                      int W, int C) {
  long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long npix = (long long)B * H * W;
  if (pix >= npix) return;
  int x = (int)(pix % W);
  int y = (int)((pix / W) % H);
  int b = (int)(pix / ((long long)W * H));
  int ht = H / 4, wt = W / 4;
  int ty = y >> 2, tx = x >> 2, i = y & 3, j = x & 3;

  const T* hp = hyp3 + (((long long)b * ht + ty) * wt + tx) * 3;
  float d = load1(hp), sx = load1(hp + 1), sy = load1(hp + 2);
  float x0, f, g;
  // form 1: the first tap's column; per tap m, whether it reads the image
  int col0 = 0;
  bool ok[4];
  if (FORM == 1) {
    plane_exact(d, sx, sy, x, i, W, x0, f, col0, ok);
    g = rb(__fsub_rn(1.0f, f));
  } else {
    // to_plane: (d + cx * dx) + cy * dy with c = -1.5, -0.5, 0.5, 1.5
    float cx = (float)j - 1.5f, cy = (float)i - 1.5f;
    float local_d =
        __fadd_rn(__fadd_rn(d, __fmul_rn(cx, sx)), __fmul_rn(cy, sy));
    float p = __fsub_rn((float)x, local_d);
    x0 = floorf(p);
    f = __fsub_rn(p, x0);
    g = __fsub_rn(1.0f, f);
    for (int m = 0; m < 4; ++m) {
      float xm = x0 - 1.0f + (float)m;
      ok[m] = (xm >= 0.0f) && (xm <= (float)(W - 1));
    }
  }

  const T* row = fea_r + ((long long)b * H + y) * (long long)W * C;
  const T* fl = fea_l + pix * C;
  const T* tap[4];
  for (int m = 0; m < 4; ++m) {
    int xi;
    if (FORM == 1) {
      xi = ok[m] ? col0 + m : 0;
    } else {
      float xm = x0 - 1.0f + (float)m;
      xi = ok[m] ? (int)xm : 0;
    }
    tap[m] = row + (long long)xi * C;
  }

  float cost[3] = {0.f, 0.f, 0.f};
  if constexpr (FORM == 1) {
    // |rb(l - rb(rb(a g) + rb(b f)))| two channels an instruction in bf16:
    // for bf16 operands a product is exact in f32 and a sum or difference
    // rounds once either way, so each native bf16x2 step (round to
    // nearest, never contracted into an FMA) gives the bits of the f32
    // step rounded to bf16 (tests/test_torch_tile_warp.py::
    // test_bf16_ops_round_once); only |l - w| is widened, for the f32 sum
    const __nv_bfloat162 g2 = __float2bfloat162_rn(g);
    const __nv_bfloat162 f2 = __float2bfloat162_rn(f);
    const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
    for (int c = 0; c < C; c += 4) {
      __nv_bfloat162 l[2], t[4][2];
      load_pairs(fl + c, l);
      for (int m = 0; m < 4; ++m) {
        if (ok[m]) {
          load_pairs(tap[m] + c, t[m]);
        } else {
          t[m][0] = zero;
          t[m][1] = zero;
        }
      }
      // k = -1, 0, +1 lerps the tap pairs starting at 2, 1, 0; channels
      // summed in order
      for (int kk = 0; kk < 3; ++kk) {
        const int m = 2 - kk;
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 w = __hadd2_rn(__hmul2_rn(t[m][h], g2),
                                              __hmul2_rn(t[m + 1][h], f2));
          const float2 e = __bfloat1622float2(__habs2(__hsub2_rn(l[h], w)));
          cost[kk] += e.x;
          cost[kk] += e.y;
        }
      }
    }
  } else {
    for (int c = 0; c < C; c += 4) {
      float4 l = load4(fl + c);
      float4 t[4];
      for (int m = 0; m < 4; ++m)
        t[m] = ok[m] ? load4(tap[m] + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      // k = -1, 0, +1 lerps the tap pairs starting at 2, 1, 0
      for (int kk = 0; kk < 3; ++kk) {
        int m = 2 - kk;
        cost[kk] += l1_f32(l.x, t[m].x, t[m + 1].x, g, f) +
                    l1_f32(l.y, t[m].y, t[m + 1].y, g, f) +
                    l1_f32(l.z, t[m].z, t[m + 1].z, g, f) +
                    l1_f32(l.w, t[m].w, t[m + 1].w, g, f);
      }
    }
  }
  T* op = out + (((long long)b * ht + ty) * wt + tx) * 48 + i * 4 + j;
  store1(op, cost[0]);
  store1(op + 16, cost[1]);
  store1(op + 32, cost[2]);
}

template <int FORM, typename T>
int launch(const void* hyp3, const void* fea_l, const void* fea_r, void* out,
           int B, int H, int W, int C, cudaStream_t stream) {
  long long npix = (long long)B * H * W;
  int threads = 128;
  unsigned blocks = (unsigned)((npix + threads - 1) / threads);
  if (blocks == 0) return 0;
  tile_warp_cost_kernel<FORM, T><<<blocks, threads, 0, stream>>>(
      (const T*)hyp3, (const T*)fea_l, (const T*)fea_r, (T*)out, B, H, W, C);
  return (int)cudaGetLastError();
}

constexpr int kBwdMaxThreads = 512;

// Shared memory of a row block, in bytes: by sort slot, a pixel's (g_-1,
// g_0, g_+1, f) (16 W); by pixel, its bin and rank, then its slot (4 W);
// the bins' starts (4 (W + 4)); dL/d local_d a pixel (4 W); form 1 only,
// a pixel's six channel sums of df so far, three bf16 pairs (12 W); by
// slot, the signs of l - warped of the channel group a pass takes (cg W).
__host__ __device__ __forceinline__ size_t bwd_smem_bytes(int W, int cg,
                                                          int form) {
  return (size_t)(28 + (form == 1 ? 12 : 0) + cg) * W + 16;
}

// A pixel's plane as the forward of FORM computes it (so that floor(), the
// masks and the signs agree): the lerp fraction f, the first tap's column
// col0 and the taps' mask, bit m for tap m.  Form 0 reads tap m at column
// col0 + m wherever it is masked in.
template <int FORM, typename T>
__device__ __forceinline__ void bwd_plane(const T* hp, int x, int i, int W,
                                          float& f, int& col0,
                                          unsigned& okbits) {
  const float d = load1(hp), sx = load1(hp + 1), sy = load1(hp + 2);
  float x0;
  bool ok[4];
  if (FORM == 1) {
    plane_exact(d, sx, sy, x, i, W, x0, f, col0, ok);
  } else {
    // to_plane's offsets: a along x (multiplies dx), b along y (dy)
    const float cx = (float)(x & 3) - 1.5f, cy = (float)i - 1.5f;
    const float local_d =
        __fadd_rn(__fadd_rn(d, __fmul_rn(cx, sx)), __fmul_rn(cy, sy));
    const float p = __fsub_rn((float)x, local_d);
    x0 = floorf(p);
    f = __fsub_rn(p, x0);
    for (int m = 0; m < 4; ++m) {
      const float xm = x0 - 1.0f + (float)m;
      ok[m] = (xm >= 0.0f) && (xm <= (float)(W - 1));
    }
    // the first tap's column where some tap is in the image
    col0 = (ok[0] || ok[1] || ok[2] || ok[3]) ? (int)x0 - 1 : 0;
  }
  okbits = 0;
  for (int m = 0; m < 4; ++m) okbits |= (ok[m] ? 1u : 0u) << m;
}

// 2 bits of a packed sign (1: set, 2: negative) applied to v: s * v
__device__ __forceinline__ float signed_by(unsigned bits, float v) {
  return (bits & 1u) ? __uint_as_float(__float_as_uint(v) ^ ((bits & 2u) << 30))
                     : 0.f;
}

// four channels of a pixel as floats (bf16 widens exactly)
template <typename T>
__device__ __forceinline__ void load_ch4(const T* p, float (&v)[4]) {
  const float4 t = load4(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void store_ch4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
// each value rounded once to bf16
__device__ __forceinline__ void store_ch4(__nv_bfloat16* p,
                                          const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ unsigned bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bf162_of(unsigned u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// Form 1, four channels of one pixel, two channels an instruction in
// bf16x2 (each step the f32 step rounded once, as in the forward): the
// lerps and the signs of l - warped (packed into the returned word, byte
// kk, bits 2q and 2q + 1 for channel q); dfea_l = (e_+1 + e_0) + e_-1
// stored; and for each offset kk the channel sums of -e tap_j (lane 0) and
// -e tap_j+1 (lane 1) in acc[kk], each product rounded and each add, in
// channel order.  g2[kk]: (g_kk, g_kk) as bf16x2 bits.
__device__ __forceinline__ unsigned channels_exact(
    const __nv_bfloat16* fl, const __nv_bfloat16* row, int col0, int C,
    unsigned okbits, __nv_bfloat162 gf2, __nv_bfloat162 f2,
    const unsigned (&g2)[3], __nv_bfloat162 (&acc)[3],
    __nv_bfloat16* dfl) {
  __nv_bfloat162 l[2], t[4][2];
  load_pairs(fl, l);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  for (int m = 0; m < 4; ++m) {
    if ((okbits >> m) & 1u) {
      load_pairs(row + (long long)(col0 + m) * C, t[m]);
    } else {
      t[m][0] = zero;
      t[m][1] = zero;
    }
  }
  unsigned word = 0;
  uint2 dl;
  for (int h = 0; h < 2; ++h) {
    __nv_bfloat162 e[3];
    // k = -1, 0, +1 lerps the tap pairs starting at 2, 1, 0; |x|'s
    // cotangent is +g for x >= 0, -g elsewhere (JAX's select)
    for (int kk = 0; kk < 3; ++kk) {
      const int m = 2 - kk;
      const __nv_bfloat162 w = __hadd2_rn(__hmul2_rn(t[m][h], gf2),
                                          __hmul2_rn(t[m + 1][h], f2));
      const float2 d = __bfloat1622float2(__hsub2_rn(l[h], w));
      const bool n0 = !(d.x >= 0.f), n1 = !(d.y >= 0.f);
      const unsigned eb =
          g2[kk] ^ (n0 ? 0x8000u : 0u) ^ (n1 ? 0x80000000u : 0u);
      e[kk] = bf162_of(eb);
      word |= (n0 ? 3u : 1u) << (8 * kk + 4 * h);
      word |= (n1 ? 3u : 1u) << (8 * kk + 4 * h + 2);
      const __nv_bfloat162 ne = bf162_of(eb ^ 0x80008000u);  // -e
      acc[kk] = __hadd2_rn(acc[kk], __hmul2_rn(
          __low2bfloat162(ne), __lows2bfloat162(t[m][h], t[m + 1][h])));
      acc[kk] = __hadd2_rn(acc[kk], __hmul2_rn(
          __high2bfloat162(ne), __highs2bfloat162(t[m][h], t[m + 1][h])));
    }
    const unsigned v = bits_of(__hadd2_rn(__hadd2_rn(e[2], e[1]), e[0]));
    if (h == 0) dl.x = v; else dl.y = v;
  }
  *reinterpret_cast<uint2*>(dfl) = dl;
  return word;
}

// One block per image row (b, y), a cluster of 4 blocks per tile row.
// Every tap of a pixel on row y reads row y of fea_r, so the block owns that
// row of dfea_r and gathers it instead of scattering (a float add into
// shared memory is a compare-and-swap loop on this card, ATOMS.CAST.SPIN,
// and 64 a pixel of them set the time):
//   0. the row's pixels sorted by the bin of their first tap, col0 + 3 in
//      [0, W + 2] (a stable counting sort: ranks in pixel order within a
//      bin, then a scan); a pixel's data lives at its slot; a pixel with
//      no tap in the image takes no slot;
//   1. per channel group of cg channels, each pixel stores its dfea_l,
//      keeps dlocal (dloc) and packs the sign of l - warped, 2 bits a
//      channel and offset, at its slot (with its g and f in the first);
//   2. each column sums the cotangents of the taps that read it, taps 0..3
//      of the slots of bins c + 3 .. c, rebuilt from the signs, g and f,
//      and stores the group's channels once, 16 bytes a lane.
// The cluster's rank 0 reads the four rows' dloc through distributed
// shared memory and writes each tile's three sums once, in a fixed order.
//
// FORM 1 (bf16 in and out, the "exact" form's VJP) keeps that structure
// and takes each step in the dtypes jax.vjp(tile_warping) gives it: the
// plane, the lerps and the signs of the forward's form 1; dfea_l the two
// bf16 adds (e_+1 + e_0) + e_-1; a tap's cotangent its one or two lerp
// cotangents, each rounded, added in bf16 (the pixel's ok mask rides in
// the low bits of f, a bf16 value); dfea_r each column's tap cotangents
// summed in f32 and rounded once; df six channel sums rounded after every
// add (kept across channel groups in shared memory), combined in the
// transpose's order; the tile sums of to_plane's transpose rounded after
// every add.  The sums' order is fixed, so every output but dfea_r is the
// plain version's bits (ops/tile_warp.py:_backward_exact), and dfea_r, whose
// column sums run in bin order and pixel order within a bin (the stable
// sort), has the same bits at every launch.
template <int FORM, typename T>
__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(kBwdMaxThreads, 2)
tile_warp_cost_backward_kernel(
    const T* __restrict__ hyp3, const T* __restrict__ fea_l,
    const T* __restrict__ fea_r, const T* __restrict__ g,
    T* __restrict__ dhyp3, T* __restrict__ dfea_l, T* __restrict__ dfea_r,
    int H, int W, int C, int cg) {
  extern __shared__ float4 smem4[];
  __shared__ int warp_sum[kBwdMaxThreads / 32];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  float4* gfv = smem4;                                 // [W] by slot
  int* slot = reinterpret_cast<int*>(gfv + W);         // [W] by pixel
  int* start = slot + W;                               // [W + 4]
  float* dloc = reinterpret_cast<float*>(start + W + 4);     // [W]
  // form 1: by pixel, the three (pa, pb) pairs of its channel sums so far
  unsigned* part = reinterpret_cast<unsigned*>(dloc + W);    // [3][W]
  unsigned* signs = part + (FORM == 1 ? 3 * W : 0);          // [cg/4][W]
  const int wt = W / 4, nb = W + 3, nk = cg / 4;
  const int by = blockIdx.x;             // b * H + y
  const int y = by % H, i = y & 3;
  const long long bt = by / 4;           // b * ht + ty
  const T* row = fea_r + (long long)by * W * C;
  T* drow = dfea_r + (long long)by * W * C;
  const int nt = blockDim.x, tid = threadIdx.x;

  // 0. the counting sort, stable: a pixel's rank in its bin is the number
  // of pixels left of it in that bin (its warp's lanes with the same bin
  // by __match_any_sync, then the warps in turn add their counts), so a
  // column's taps are summed in the same order at every launch
  const int lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k <= nb; k += nt) start[k] = 0;
  __syncthreads();
  for (int xb = 0; xb < W; xb += nt) {  // every thread, every pass
    const int x = xb + tid;
    int bin = -1;  // no tap in the image (also a NaN plane), or x >= W
    if (x < W) {
      float f;
      int col0;
      unsigned okbits;
      bwd_plane<FORM>(hyp3 + (bt * wt + (x >> 2)) * 3, x, i, W, f, col0,
                      okbits);
      if (okbits) bin = col0 + 3;
    }
    const unsigned same = __match_any_sync(0xffffffffu, bin);
    const unsigned left = same & ((1u << lane) - 1u);
    int base = 0;
    for (int w = 0; w < nt / 32; ++w) {
      if (warp == w && bin >= 0) base = start[bin];
      __syncwarp();
      if (warp == w && bin >= 0 && left == 0)
        start[bin] = base + __popc(same);
      __syncthreads();
    }
    if (x < W) slot[x] = bin < 0 ? -1 : (bin << 16 | (base + __popc(left)));
  }
  __syncthreads();
  {  // exclusive scan of the nb bin counts in place; start[nb]: their sum
    const int per = (nb + nt - 1) / nt;
    const int lo = min(tid * per, nb), hi = min(lo + per, nb);
    int sum = 0;
    for (int k = lo; k < hi; ++k) sum += start[k];
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int run = incl - sum;
    for (int w = 0; w < warp; ++w) run += warp_sum[w];
    for (int k = lo; k < hi; ++k) {
      const int v = start[k];
      start[k] = run;
      run += v;
    }
    if (tid == nt - 1) start[nb] = run;
  }
  __syncthreads();
  for (int x = tid; x < W; x += nt) {
    const int code = slot[x];
    if (code >= 0) slot[x] = start[code >> 16] + (code & 0xffff);
  }

  for (int c0 = 0; c0 < C; c0 += cg) {
    // 1. (the first pass reads slot[x] as its own thread wrote it)
    for (int x = tid; x < W; x += nt) {
      const long long tile = bt * wt + (x >> 2);
      float f;
      int col0;
      unsigned okbits;
      bwd_plane<FORM>(hyp3 + tile * 3, x, i, W, f, col0, okbits);
      const float gf = FORM == 1 ? rb(__fsub_rn(1.0f, f))
                                 : __fsub_rn(1.0f, f);
      const long long pix = (long long)by * W + x;
      const T* fl = fea_l + pix * C;
      T* dfl = dfea_l + pix * C;
      const T* gp = g + tile * 48 + i * 4 + (x & 3);
      const float gk[3] = {load1(gp), load1(gp + 16), load1(gp + 32)};
      const int s = slot[x];
      if (c0 == 0 && s >= 0) {
        // form 1: the taps' mask in the 16 low bits of f, which are 0
        const float fk = FORM == 1
            ? __uint_as_float(__float_as_uint(f) | okbits) : f;
        gfv[s] = make_float4(gk[0], gk[1], gk[2], fk);
      }
      // dL/d local_d of this pixel (form 0); form 1: per offset kk the
      // channel sums of the cotangents of (1 - f) and f so far, a bf16 pair
      float dlocal = 0.f;
      __nv_bfloat162 acc[3];
      unsigned g2[3];
      if (FORM == 1) {
        for (int kk = 0; kk < 3; ++kk) {
          acc[kk] = c0 > 0 ? bf162_of(part[kk * W + x])
                           : __float2bfloat162_rn(0.f);
          g2[kk] = bits_of(__float2bfloat162_rn(gk[kk]));
        }
      }
      for (int c = c0; c < c0 + cg; c += 4) {
        unsigned word = 0;  // byte kk, bits 2q, 2q + 1: sign of channel q
        if constexpr (FORM == 1) {
          word = channels_exact(fl + c, row + c, col0, C, okbits,
                                __float2bfloat162_rn(gf),
                                __float2bfloat162_rn(f), g2, acc, dfl + c);
        } else {
          float lv[4];
          load_ch4(fl + c, lv);
          float tv[4][4];  // [tap][channel]
          for (int m = 0; m < 4; ++m) {
            if ((okbits >> m) & 1u) {
              load_ch4(row + (long long)(col0 + m) * C + c, tv[m]);
            } else {
              tv[m][0] = tv[m][1] = tv[m][2] = tv[m][3] = 0.f;
            }
          }
          float dl[4] = {0.f, 0.f, 0.f, 0.f};
          for (int q = 0; q < 4; ++q) {
            // k = -1, 0, +1 lerps the tap pairs starting at 2, 1, 0; |x|'s
            // cotangent is +g for x >= 0, -g elsewhere (JAX's select)
            for (int kk = 0; kk < 3; ++kk) {
              const int m = 2 - kk;
              const float a = tv[m][q], bb = tv[m + 1][q];
              const float v = __fsub_rn(lv[q], __fadd_rn(__fmul_rn(a, gf),
                                                         __fmul_rn(bb, f)));
              const bool neg = !(v >= 0.f);
              const float e = neg ? -gk[kk] : gk[kk];
              word |= (neg ? 3u : 1u) << (8 * kk + 2 * q);
              dl[q] += e;
              dlocal += e * (bb - a);
            }
          }
          store_ch4(dfl + c, dl);
        }
        if (s >= 0) signs[((c - c0) >> 2) * W + s] = word;
      }
      if (FORM == 1) {
        if (c0 + cg < C) {
          for (int kk = 0; kk < 3; ++kk) part[kk * W + x] = bits_of(acc[kk]);
        } else {
          // df in the transpose's order, then dlocal_d = -df
          float pa[3], pb[3];
          for (int kk = 0; kk < 3; ++kk) {
            const float2 v = __bfloat1622float2(acc[kk]);
            pa[kk] = v.x;
            pb[kk] = v.y;
          }
          float v = rb(__fsub_rn(pb[2], pa[2]));
          v = rb(__fadd_rn(v, pb[1]));
          v = rb(__fsub_rn(v, pa[1]));
          v = rb(__fadd_rn(v, pb[0]));
          v = rb(__fsub_rn(v, pa[0]));
          dloc[x] = -v;
        }
      } else {
        dloc[x] = c0 == 0 ? dlocal : dloc[x] + dlocal;
      }
    }
    __syncthreads();
    // 2. each (column c, 4 channels): tap m of the slots of bin c + 3 - m
    // takes -(g s)(1 - f) of the pair that starts there (offset 2 - m) and
    // -(g s) f of the pair that ends there (offset 3 - m)
    for (int t = tid; t < W * nk; t += nt) {
      const int c = t / nk, k = t % nk;
      const unsigned* sk = signs + k * W;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int m = 0; m < 4; ++m) {
        const int ka = 2 - m, kb = 3 - m;
        for (int e = start[c + 3 - m]; e < start[c + 4 - m]; ++e) {
          const float4 gv = gfv[e];
          const float gk4[4] = {gv.x, gv.y, gv.z, 0.f};
          float f = gv.w;
          if (FORM == 1) {
            const unsigned u = __float_as_uint(f);
            if (!((u >> m) & 1u)) continue;  // tap m masked out
            f = __uint_as_float(u & 0xffff0000u);
          }
          const float gf = FORM == 1 ? rb(__fsub_rn(1.0f, f))
                                     : __fsub_rn(1.0f, f);
          const float A = ka >= 0 ? gk4[ka >= 0 ? ka : 3] * gf : 0.f;
          const float Bv = kb <= 2 ? gk4[kb <= 2 ? kb : 3] * f : 0.f;
          const unsigned word = sk[e];
          if constexpr (FORM == 1) {
            // each cotangent -(s g)(1 - f) or -(s g) f rounded once; an
            // inner tap adds its two in bf16, two channels an instruction
            const unsigned a2 = bits_of(__float2bfloat162_rn(A));
            const unsigned b2 = bits_of(__float2bfloat162_rn(Bv));
            for (int q = 0; q < 4; q += 2) {
              // -(s X): X's sign flipped where s > 0, per lane
              const unsigned wa = ka >= 0 ? word >> (8 * ka + 2 * q) : 0u;
              const unsigned wb = kb <= 2 ? word >> (8 * kb + 2 * q) : 0u;
              const unsigned va = a2 ^ ((wa & 2u) ? 0u : 0x8000u)
                                     ^ ((wa & 8u) ? 0u : 0x80000000u);
              const unsigned vb = b2 ^ ((wb & 2u) ? 0u : 0x8000u)
                                     ^ ((wb & 8u) ? 0u : 0x80000000u);
              const float2 v = __bfloat1622float2(
                  ka < 0 ? bf162_of(vb)
                         : kb > 2 ? bf162_of(va)
                                  : __hadd2_rn(bf162_of(va), bf162_of(vb)));
              acc[q] += v.x;
              acc[q + 1] += v.y;
            }
          } else {
            for (int q = 0; q < 4; ++q) {
              float v = 0.f;
              if (ka >= 0) v -= signed_by(word >> (8 * ka + 2 * q), A);
              if (kb <= 2) v -= signed_by(word >> (8 * kb + 2 * q), Bv);
              acc[q] += v;
            }
          }
        }
      }
      store_ch4(drow + (long long)c * C + c0 + 4 * k, acc);
    }
    __syncthreads();
  }

  // the tile's sums over its 4 rows (the cluster's 4 blocks, rank = i) and
  // 4 columns, in that order
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int tx = tid; tx < wt; tx += nt) {
      float sd = 0.f, sxx = 0.f, syy = 0.f;
      if (FORM == 1) {
        // to_plane's transpose in bf16: r by tile column a (a sum over the
        // rows), q by row b; d = sum_a r, dx = sum_a c_a r, dy = sum_b c_b q
        const float cs[4] = {-1.5f, -0.49609375f, 0.5f, 1.5f};
        float r[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
        for (int rr = 0; rr < 4; ++rr) {
          const float* dl = cluster.map_shared_rank(dloc, rr) + tx * 4;
          for (int jj = 0; jj < 4; ++jj) {
            r[jj] = rb(__fadd_rn(r[jj], dl[jj]));
            q[rr] = rb(__fadd_rn(q[rr], dl[jj]));
          }
        }
        for (int jj = 0; jj < 4; ++jj) {
          sd = rb(__fadd_rn(sd, r[jj]));
          sxx = rb(__fadd_rn(sxx, rb(__fmul_rn(cs[jj], r[jj]))));
          syy = rb(__fadd_rn(syy, rb(__fmul_rn(cs[jj], q[jj]))));
        }
      } else {
        for (int rr = 0; rr < 4; ++rr) {
          const float* dl = cluster.map_shared_rank(dloc, rr) + tx * 4;
          const float ry = (float)rr - 1.5f;
          for (int jj = 0; jj < 4; ++jj) {
            const float v = dl[jj];
            sd += v;
            sxx += ((float)jj - 1.5f) * v;
            syy += ry * v;
          }
        }
      }
      T* out = dhyp3 + (bt * wt + tx) * 3;
      store1(out, sd);
      store1(out + 1, sxx);
      store1(out + 2, syy);
    }
  }
  // no block leaves while rank 0 may still read its dloc
  cluster.sync();
}

template <int FORM, typename T>
int launch_backward(const void* hyp3, const void* fea_l, const void* fea_r,
                    const void* g, void* dhyp3, void* dfea_l, void* dfea_r,
                    int B, int H, int W, int C, int cg, cudaStream_t stream) {
  const size_t bytes = bwd_smem_bytes(W, cg, FORM);
  cudaError_t err = cudaFuncSetAttribute(
      tile_warp_cost_backward_kernel<FORM, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // threads: the fewest passes over the row of at most kBwdMaxThreads
  const int passes = (W + kBwdMaxThreads - 1) / kBwdMaxThreads;
  const int threads = ((W + passes - 1) / passes + 31) / 32 * 32;
  tile_warp_cost_backward_kernel<FORM, T><<<(unsigned)(B * H), threads,
                                            bytes, stream>>>(
      (const T*)hyp3, (const T*)fea_l, (const T*)fea_r, (const T*)g,
      (T*)dhyp3, (T*)dfea_l, (T*)dfea_r, H, W, C, cg);
  return (int)cudaGetLastError();
}

}  // namespace

// form: 0 f32, 1 bf16 "exact", 2 bf16 "pallas" (see the top of the file)
extern "C" int tile_warp_cost_launch(const void* hyp3, const void* fea_l,
                                     const void* fea_r, void* out, int B,
                                     int H, int W, int C, int form,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case 0: return launch<0, float>(hyp3, fea_l, fea_r, out, B, H, W, C, s);
    case 1:
      return launch<1, __nv_bfloat16>(hyp3, fea_l, fea_r, out, B, H, W, C, s);
    case 2:
      return launch<2, __nv_bfloat16>(hyp3, fea_l, fea_r, out, B, H, W, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward, every output written in full; form: 0 f32, 1 bf16 "exact"
// (the "pallas" form has no backward).  cg: the channels of a pass of the
// row block, a multiple of 4 that divides C (the shared memory grows with
// W x cg; ops/tile_warp.py:backward_channel_group chooses it).
extern "C" int tile_warp_cost_backward_launch(
    const void* hyp3, const void* fea_l, const void* fea_r, const void* g,
    void* dhyp3, void* dfea_l, void* dfea_r, int B, int H, int W, int C,
    int cg, int form, void* stream) {
  if (cg < 4 || cg % 4 || C % cg || H % 4 || W % 4 || W >= 1 << 15)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case 0:
      return launch_backward<0, float>(hyp3, fea_l, fea_r, g, dhyp3, dfea_l,
                                       dfea_r, B, H, W, C, cg, s);
    case 1:
      return launch_backward<1, __nv_bfloat16>(hyp3, fea_l, fea_r, g, dhyp3,
                                               dfea_l, dfea_r, B, H, W, C,
                                               cg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
