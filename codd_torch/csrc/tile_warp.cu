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
//      sum in f32 and rounded once.
//   2  bf16 in, bf16 out, "pallas": form 0's f32 body on the widened
//      inputs (bf16 -> f32 is exact), only the output rounded.
//
// Backward (tile_warp_cost_backward_launch, f32 only): the VJP of
// tile_warping given g = dL/dcost (B, ht, wt, 48).  Per pixel, tap pair
// (m, m+1) of offset k and s = sign(fea_l - warped) (0 at 0, as the
// derivative of |x|):
//   dfea_l          += g_k s                     (the pixel's own: stored)
//   dfea_r[x0-1+m]  -= g_k s (1 - f)             (in-image taps only: a
//   dfea_r[x0+m]    -= g_k s f                    scatter, atomicAdd into a
//                                                  zeroed dfea_r)
//   dlocal_d        += sum_c g_k s (tap_{m+1} - tap_m)     (floor() has no
//   dhyp3[tile]     += dlocal_d * (1, a, b)                 gradient, df/dp = 1)
// with a, b the pixel's column and row offsets in its tile.  Threads are
// laid out tile-major: a block of 128 holds 8 whole tiles, 16 lanes of a
// warp one tile, so the tile's three sums are a shuffle reduction, written
// once, with no atomics.  Bound by bytes like the forward (each input read
// once, each gradient written once).
#include <cuda_bf16.h>
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

// form 1: |l - lerp(a, b)| with every step rounded to bf16
__device__ __forceinline__ float l1_exact(float l, float a, float b, float g,
                                          float f) {
  float w = rb(__fadd_rn(rb(__fmul_rn(a, g)), rb(__fmul_rn(b, f))));
  return fabsf(rb(__fsub_rn(l, w)));
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
  for (int c = 0; c < C; c += 4) {
    float4 l = load4(fl + c);
    float4 t[4];
    for (int m = 0; m < 4; ++m)
      t[m] = ok[m] ? load4(tap[m] + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    // k = -1, 0, +1 lerps the tap pairs starting at 2, 1, 0
    for (int kk = 0; kk < 3; ++kk) {
      int m = 2 - kk;
      if (FORM == 1) {
        cost[kk] += l1_exact(l.x, t[m].x, t[m + 1].x, g, f);
        cost[kk] += l1_exact(l.y, t[m].y, t[m + 1].y, g, f);
        cost[kk] += l1_exact(l.z, t[m].z, t[m + 1].z, g, f);
        cost[kk] += l1_exact(l.w, t[m].w, t[m + 1].w, g, f);
      } else {
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

constexpr int kTilesPerBlock = 8;  // 16 lanes a tile, 128 threads a block

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

__global__ void tile_warp_cost_backward_kernel(
    const float* __restrict__ hyp3, const float* __restrict__ fea_l,
    const float* __restrict__ fea_r, const float* __restrict__ g,
    float* __restrict__ dhyp3, float* __restrict__ dfea_l,
    float* __restrict__ dfea_r, int B, int H, int W, int C) {
  const int ht = H / 4, wt = W / 4;
  const long long ntiles = (long long)B * ht * wt;
  const long long tile =
      (long long)blockIdx.x * kTilesPerBlock + (threadIdx.x >> 4);
  const int lane16 = threadIdx.x & 15;
  const int i = lane16 >> 2, j = lane16 & 3;
  // to_plane's offsets: a along x (multiplies dx), b along y (dy)
  const float cx = (float)j - 1.5f, cy = (float)i - 1.5f;
  float dlocal = 0.f;  // dL/d local_d of this pixel
  if (tile < ntiles) {
    const int tx = (int)(tile % wt);
    const int ty = (int)((tile / wt) % ht);
    const int b = (int)(tile / ((long long)wt * ht));
    const int y = ty * 4 + i, x = tx * 4 + j;
    const float* hp = hyp3 + tile * 3;
    const float d = __ldg(hp), sx = __ldg(hp + 1), sy = __ldg(hp + 2);
    // the forward's arithmetic, so that floor() and the signs agree
    const float local_d =
        __fadd_rn(__fadd_rn(d, __fmul_rn(cx, sx)), __fmul_rn(cy, sy));
    const float p = __fsub_rn((float)x, local_d);
    const float x0 = floorf(p);
    const float f = __fsub_rn(p, x0);
    const float gf = __fsub_rn(1.0f, f);
    bool ok[4];
    int col[4];
    for (int m = 0; m < 4; ++m) {
      const float xm = x0 - 1.0f + (float)m;
      ok[m] = (xm >= 0.0f) && (xm <= (float)(W - 1));
      col[m] = ok[m] ? (int)xm : 0;
    }
    const long long pix = ((long long)b * H + y) * W + x;
    const float* row = fea_r + ((long long)b * H + y) * (long long)W * C;
    float* drow = dfea_r + ((long long)b * H + y) * (long long)W * C;
    const float* fl = fea_l + pix * C;
    float* dfl = dfea_l + pix * C;
    const float* gp = g + tile * 48 + i * 4 + j;
    const float gk[3] = {__ldg(gp), __ldg(gp + 16), __ldg(gp + 32)};

    for (int c = 0; c < C; c += 4) {
      const float4 l4 = load4(fl + c);
      const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
      float tv[4][4];  // [tap][channel]
      for (int m = 0; m < 4; ++m) {
        const float4 t = ok[m] ? load4(row + (long long)col[m] * C + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        tv[m][0] = t.x; tv[m][1] = t.y; tv[m][2] = t.z; tv[m][3] = t.w;
      }
      float dl[4] = {0.f, 0.f, 0.f, 0.f};
      float dt[4][4] = {};
      for (int q = 0; q < 4; ++q) {
        // k = -1, 0, +1 lerps the tap pairs starting at 2, 1, 0
        for (int kk = 0; kk < 3; ++kk) {
          const int m = 2 - kk;
          const float a = tv[m][q], bb = tv[m + 1][q];
          const float w = __fadd_rn(__fmul_rn(a, gf), __fmul_rn(bb, f));
          const float e = gk[kk] * sign_of(__fsub_rn(lv[q], w));
          dl[q] += e;
          dt[m][q] -= e * gf;
          dt[m + 1][q] -= e * f;
          dlocal += e * (bb - a);
        }
      }
      *reinterpret_cast<float4*>(dfl + c) =
          make_float4(dl[0], dl[1], dl[2], dl[3]);
      for (int m = 0; m < 4; ++m) {
        if (!ok[m]) continue;
        float* dp = drow + (long long)col[m] * C + c;
        for (int q = 0; q < 4; ++q)
          if (dt[m][q] != 0.f) atomicAdd(dp + q, dt[m][q]);
      }
    }
  }
  // the tile's sums over its 16 lanes (every lane takes part)
  float sd = dlocal, sxx = cx * dlocal, syy = cy * dlocal;
  for (int off = 8; off > 0; off >>= 1) {
    sd += __shfl_xor_sync(0xffffffffu, sd, off);
    sxx += __shfl_xor_sync(0xffffffffu, sxx, off);
    syy += __shfl_xor_sync(0xffffffffu, syy, off);
  }
  if (tile < ntiles && lane16 == 0) {
    dhyp3[tile * 3] = sd;
    dhyp3[tile * 3 + 1] = sxx;
    dhyp3[tile * 3 + 2] = syy;
  }
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

// The f32 backward.  dfea_r must hold zeros: the kernel adds into it.
// Every other output is written in full.
extern "C" int tile_warp_cost_backward_launch(
    const void* hyp3, const void* fea_l, const void* fea_r, const void* g,
    void* dhyp3, void* dfea_l, void* dfea_r, int B, int H, int W, int C,
    void* stream) {
  long long ntiles = (long long)B * (H / 4) * (W / 4);
  unsigned blocks =
      (unsigned)((ntiles + kTilesPerBlock - 1) / kTilesPerBlock);
  if (blocks == 0) return 0;
  tile_warp_cost_backward_kernel<<<blocks, kTilesPerBlock * 16, 0,
                                   (cudaStream_t)stream>>>(
      (const float*)hyp3, (const float*)fea_l, (const float*)fea_r,
      (const float*)g, (float*)dhyp3, (float*)dfea_l, (float*)dfea_r, B, H,
      W, C);
  return (int)cudaGetLastError();
}
