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
// Backward (tile_warp_cost_backward_launch, f32 only): the VJP of
// tile_warping given g = dL/dcost (B, ht, wt, 48).  Per pixel, tap pair
// (m, m+1) of offset k and s = sign(fea_l - warped) (0 at 0, as the
// derivative of |x|):
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
    // jnp.linspace(-1.5, 1.5, 4, dtype=bf16) = {-1.5, -0.49609375, 0.5, 1.5}
    const float cs[4] = {-1.5f, -0.49609375f, 0.5f, 1.5f};
    float local_d = rb(__fadd_rn(rb(__fadd_rn(d, rb(__fmul_rn(cs[j], sx)))),
                                 rb(__fmul_rn(cs[i], sy))));
    float p = rb(__fsub_rn(rb((float)x), local_d));
    x0 = floorf(p);
    f = rb(__fsub_rn(p, x0));
    g = rb(__fsub_rn(1.0f, f));
    // tile_warping: the 4-column block starts at clip(x0 - 1 + 3, 0, W + 2)
    // in the 3-column zero-padded row, both sums and the bound W + 2
    // rounded to bf16; the taps are masked by x0 - 1 + m in [0, W - 1],
    // computed exactly (XLA keeps that sum in f32)
    float s = fminf(fmaxf(rb(__fadd_rn(rb(__fsub_rn(x0, 1.0f)), 3.0f)), 0.0f),
                    rb((float)(W + 2)));
    col0 = (int)s - 3;
    for (int m = 0; m < 4; ++m) {
      float xm = x0 - 1.0f + (float)m;
      int col = col0 + m;
      ok[m] = xm >= 0.0f && xm <= (float)(W - 1) && col >= 0 && col < W;
    }
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

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

constexpr int kBwdMaxThreads = 512;

// Shared memory of a row block, in bytes: by sort slot, a pixel's (g_-1,
// g_0, g_+1, f) (16 W); by pixel, its bin and rank, then its slot (4 W);
// the bins' starts (4 (W + 4)); dL/d local_d a pixel (4 W); by slot, the
// signs of l - warped of the channel group a pass takes (cg W).
__host__ __device__ __forceinline__ size_t bwd_smem_bytes(int W, int cg) {
  return (size_t)(28 + cg) * W + 16;
}

// A pixel's plane as the forward computes it (round-to-nearest intrinsics,
// so that floor() and the signs agree): the lerp fraction f and x0.
__device__ __forceinline__ void bwd_plane(const float* hp, int x, float cy,
                                          float& f, float& x0) {
  // to_plane's offsets: a along x (multiplies dx), b along y (dy)
  const float cx = (float)(x & 3) - 1.5f;
  const float d = __ldg(hp), sx = __ldg(hp + 1), sy = __ldg(hp + 2);
  const float local_d =
      __fadd_rn(__fadd_rn(d, __fmul_rn(cx, sx)), __fmul_rn(cy, sy));
  const float p = __fsub_rn((float)x, local_d);
  x0 = floorf(p);
  f = __fsub_rn(p, x0);
}

// 2 bits of a packed sign (1: nonzero, 2: negative) applied to v: s * v
__device__ __forceinline__ float signed_by(unsigned bits, float v) {
  return (bits & 1u) ? __uint_as_float(__float_as_uint(v) ^ ((bits & 2u) << 30))
                     : 0.f;
}

// One block per image row (b, y), a cluster of 4 blocks per tile row.
// Every tap of a pixel on row y reads row y of fea_r, so the block owns that
// row of dfea_r and gathers it instead of scattering (a float add into
// shared memory is a compare-and-swap loop on this card, ATOMS.CAST.SPIN,
// and 64 a pixel of them set the time):
//   0. the row's pixels sorted by the bin of their first tap, x0 + 2 for
//      x0 in [-2, W] (a counting sort: ranks by integer shared atomics,
//      native, and a scan); a pixel's data lives at its slot;
//   1. per channel group of cg channels, each pixel stores its dfea_l,
//      keeps dlocal (dloc) and packs the sign of l - warped, 2 bits a
//      channel and offset, at its slot (with its g and f in the first);
//   2. each column sums the cotangents of the taps that read it, taps 0..3
//      of the slots of bins c + 3 .. c, rebuilt from the signs, g and f,
//      and stores the group's channels once, 16 bytes a lane.
// The cluster's rank 0 reads the four rows' dloc through distributed
// shared memory and writes each tile's three sums once, in a fixed order.
__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(kBwdMaxThreads, 2)
tile_warp_cost_backward_kernel(
    const float* __restrict__ hyp3, const float* __restrict__ fea_l,
    const float* __restrict__ fea_r, const float* __restrict__ g,
    float* __restrict__ dhyp3, float* __restrict__ dfea_l,
    float* __restrict__ dfea_r, int H, int W, int C, int cg) {
  extern __shared__ float4 smem4[];
  __shared__ int warp_sum[kBwdMaxThreads / 32];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  float4* gfv = smem4;                                 // [W] by slot
  int* slot = reinterpret_cast<int*>(gfv + W);         // [W] by pixel
  int* start = slot + W;                               // [W + 4]
  float* dloc = reinterpret_cast<float*>(start + W + 4);     // [W]
  unsigned* signs = reinterpret_cast<unsigned*>(dloc + W);   // [cg/4][W]
  const int wt = W / 4, nb = W + 3, nk = cg / 4;
  const int by = blockIdx.x;             // b * H + y
  const int y = by % H, i = y & 3;
  const long long bt = by / 4;           // b * ht + ty
  const float cy = (float)i - 1.5f;
  const float* row = fea_r + (long long)by * W * C;
  float* drow = dfea_r + (long long)by * W * C;
  const int nt = blockDim.x, tid = threadIdx.x;

  // 0. the counting sort
  for (int k = tid; k <= nb; k += nt) start[k] = 0;
  __syncthreads();
  for (int x = tid; x < W; x += nt) {
    float f, x0;
    bwd_plane(hyp3 + (bt * wt + (x >> 2)) * 3, x, cy, f, x0);
    int code = -1;  // no tap in the image (also a NaN plane)
    if (x0 >= -2.0f && x0 <= (float)W) {
      const int bin = (int)x0 + 2;
      code = bin << 16 | atomicAdd(start + bin, 1);
    }
    slot[x] = code;
  }
  __syncthreads();
  {  // exclusive scan of the nb bin counts in place; start[nb]: their sum
    const int per = (nb + nt - 1) / nt;
    const int lo = min(tid * per, nb), hi = min(lo + per, nb);
    int sum = 0;
    for (int k = lo; k < hi; ++k) sum += start[k];
    const int lane = tid & 31, warp = tid >> 5;
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
      float f, x0;
      bwd_plane(hyp3 + tile * 3, x, cy, f, x0);
      const float gf = __fsub_rn(1.0f, f);
      bool ok[4];
      int col[4];
      for (int m = 0; m < 4; ++m) {
        const float xm = x0 - 1.0f + (float)m;
        ok[m] = (xm >= 0.0f) && (xm <= (float)(W - 1));
        col[m] = ok[m] ? (int)xm : 0;
      }
      const long long pix = (long long)by * W + x;
      const float* fl = fea_l + pix * C;
      float* dfl = dfea_l + pix * C;
      const float* gp = g + tile * 48 + i * 4 + (x & 3);
      const float gk[3] = {__ldg(gp), __ldg(gp + 16), __ldg(gp + 32)};
      const int s = slot[x];
      if (c0 == 0 && s >= 0) gfv[s] = make_float4(gk[0], gk[1], gk[2], f);
      float dlocal = 0.f;  // dL/d local_d of this pixel
      for (int c = c0; c < c0 + cg; c += 4) {
        const float4 l4 = load4(fl + c);
        const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
        float tv[4][4];  // [tap][channel]
        for (int m = 0; m < 4; ++m) {
          const float4 t = ok[m] ? load4(row + (long long)col[m] * C + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
          tv[m][0] = t.x; tv[m][1] = t.y; tv[m][2] = t.z; tv[m][3] = t.w;
        }
        float dl[4] = {0.f, 0.f, 0.f, 0.f};
        unsigned word = 0;  // byte kk, bits 2q, 2q + 1: sign of channel q
        for (int q = 0; q < 4; ++q) {
          // k = -1, 0, +1 lerps the tap pairs starting at 2, 1, 0
          for (int kk = 0; kk < 3; ++kk) {
            const int m = 2 - kk;
            const float a = tv[m][q], bb = tv[m + 1][q];
            const float w = __fadd_rn(__fmul_rn(a, gf), __fmul_rn(bb, f));
            const float sg = sign_of(__fsub_rn(lv[q], w));
            const float e = gk[kk] * sg;
            dl[q] += e;
            dlocal += e * (bb - a);
            word |= (sg != 0.f ? 1u : 0u) << (8 * kk + 2 * q);
            word |= (sg < 0.f ? 2u : 0u) << (8 * kk + 2 * q);
          }
        }
        *reinterpret_cast<float4*>(dfl + c) =
            make_float4(dl[0], dl[1], dl[2], dl[3]);
        if (s >= 0) signs[((c - c0) >> 2) * W + s] = word;
      }
      dloc[x] = c0 == 0 ? dlocal : dloc[x] + dlocal;
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
          const float f = gv.w, gf = __fsub_rn(1.0f, f);
          const float A = ka >= 0 ? gk4[ka >= 0 ? ka : 3] * gf : 0.f;
          const float Bv = kb <= 2 ? gk4[kb <= 2 ? kb : 3] * f : 0.f;
          const unsigned word = sk[e];
          for (int q = 0; q < 4; ++q) {
            float v = 0.f;
            if (ka >= 0) v -= signed_by(word >> (8 * ka + 2 * q), A);
            if (kb <= 2) v -= signed_by(word >> (8 * kb + 2 * q), Bv);
            acc[q] += v;
          }
        }
      }
      *reinterpret_cast<float4*>(drow + (long long)c * C + c0 + 4 * k) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
  }

  // the tile's sums over its 4 rows (the cluster's 4 blocks, rank = i) and
  // 4 columns, in that order
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int tx = tid; tx < wt; tx += nt) {
      float sd = 0.f, sxx = 0.f, syy = 0.f;
      for (int r = 0; r < 4; ++r) {
        const float* dl = cluster.map_shared_rank(dloc, r) + tx * 4;
        const float ry = (float)r - 1.5f;
        for (int jj = 0; jj < 4; ++jj) {
          const float v = dl[jj];
          sd += v;
          sxx += ((float)jj - 1.5f) * v;
          syy += ry * v;
        }
      }
      float* out = dhyp3 + (bt * wt + tx) * 3;
      out[0] = sd;
      out[1] = sxx;
      out[2] = syy;
    }
  }
  // no block leaves while rank 0 may still read its dloc
  cluster.sync();
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

// The f32 backward; every output is written in full.  cg: the channels of a
// pass of the row block, a multiple of 4 that divides C (the shared memory
// grows with W x cg; ops/tile_warp.py:backward_channel_group chooses it).
extern "C" int tile_warp_cost_backward_launch(
    const void* hyp3, const void* fea_l, const void* fea_r, const void* g,
    void* dhyp3, void* dfea_l, void* dfea_r, int B, int H, int W, int C,
    int cg, void* stream) {
  if (cg < 4 || cg % 4 || C % cg || H % 4 || W % 4 || W >= 1 << 15)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H == 0) return 0;
  const size_t bytes = bwd_smem_bytes(W, cg);
  cudaError_t err = cudaFuncSetAttribute(
      tile_warp_cost_backward_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // threads: the fewest passes over the row of at most kBwdMaxThreads
  const int passes = (W + kBwdMaxThreads - 1) / kBwdMaxThreads;
  const int threads = ((W + passes - 1) / passes + 31) / 32 * 32;
  tile_warp_cost_backward_kernel<<<(unsigned)(B * H), threads, bytes,
                                   (cudaStream_t)stream>>>(
      (const float*)hyp3, (const float*)fea_l, (const float*)fea_r,
      (const float*)g, (float*)dhyp3, (float*)dfea_l, (float*)dfea_r, H, W,
      C, cg);
  return (int)cudaGetLastError();
}
