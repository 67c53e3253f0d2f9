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
