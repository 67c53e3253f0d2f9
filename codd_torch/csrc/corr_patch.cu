// Windowed correlation lookup straight from the pooled bf16 feature level
// (no correlation volume), sm_90a.
//
// Replaces scripts/kernel_corr_pallas.py:corr_dots_pallas and the XLA code
// around it in codd_tpu/ops/corr.py:_lookup_level (window starts, patch
// gather, tap dots, vq mask, bilinear combine).  Per query n of batch b:
//   dots[ty][tx] = sum_c f1[b,n,c] * f2p[b, sy+ty, sx+tx, c]   (t x t taps)
//   out[b,n,offset + yy*(2r+1) + xx] = bilinear mix of dots[yy..yy+1][xx..xx+1]
// with f1 (B,N,128) bf16, f2p the level zero-padded by 2r+1 (B,Hp,Wp,128)
// bf16, f32 products (exact for bf16 operands) and f32 sums.
//
// One warp per query.  Each lane keeps 8 of the 128 channels of f1 (lanes
// l and l+16 the same 8); a half-warp reads one tap's 256-byte row as 16
// bytes a lane, so one load instruction covers two taps and a patch row of
// t taps is one contiguous run.  Each lane sums its 8 products in channel
// order, then the 16 lanes of a half-warp add up by xor-shuffles (8, 4, 2,
// 1): a fixed order.  The t*t dots go to shared memory and (2r+1)^2 lanes
// (two rounds) combine four each.  A level is at most 3.7 MB and stays in
// L2, which the taps are read from 64 times over.  Bound by bytes; see
// codd_torch/ops/corr.py.
#include <cuda_runtime.h>

#define PC 128    // feature channels
#define WARPS 8   // queries per block
#define MAXT 8    // taps per side, 2r+2 with r <= 3

__device__ __forceinline__ void bf16x8_to_f32(const uint4& v, float (&f)[8]) {
  const unsigned int u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__global__ void __launch_bounds__(32 * WARPS)
corr_patch_lookup_kernel(const uint4* __restrict__ f1,
                         const uint4* __restrict__ f2p,
                         const float* __restrict__ coords,
                         float* __restrict__ out, long long BN, int N, int Hp,
                         int Wp, int r, float scale, int out_c, int offset) {
  __shared__ float sdots[WARPS][MAXT * MAXT];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long q = (long long)blockIdx.x * WARPS + warp;  // b * N + n
  if (q >= BN) return;
  int b = (int)(q / N);
  int t = 2 * r + 2, R1 = 2 * r + 1, P = 2 * r + 1;
  int hl = Hp - 2 * P, wl = Wp - 2 * P;

  float cx = __fmul_rn(coords[q * 2 + 0], scale);
  float cy = __fmul_rn(coords[q * 2 + 1], scale);
  float x0 = floorf(cx), y0 = floorf(cy);
  float fx = __fsub_rn(cx, x0), fy = __fsub_rn(cy, y0);
  bool vq = (x0 >= (float)(-(r + 1))) && (x0 <= (float)(wl - 1 + r)) &&
            (y0 >= (float)(-(r + 1))) && (y0 <= (float)(hl - 1 + r));
  int sx = (int)fminf(fmaxf(x0, (float)(-(r + 1))), (float)(wl - 1 + r)) - r + P;
  int sy = (int)fminf(fmaxf(y0, (float)(-(r + 1))), (float)(hl - 1 + r)) - r + P;

  float* dots = sdots[warp];
  int half = lane >> 4, sub = lane & 15;  // sub: which 8 channels
  if (vq) {
    float a[8];
    bf16x8_to_f32(__ldg(f1 + q * (PC / 8) + sub), a);
    for (int tap = half; tap < t * t; tap += 2) {
      int ty = tap / t, tx = tap - ty * t;
      const uint4* row =
          f2p + (((long long)b * Hp + sy + ty) * Wp + sx + tx) * (PC / 8);
      float k[8];
      bf16x8_to_f32(__ldg(row + sub), k);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) s = fmaf(a[c], k[c], s);
#pragma unroll
      for (int m = 8; m >= 1; m >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, m));
      if (sub == 0) dots[tap] = s;
    }
  } else {
    // the whole window lies outside the level: every tap is masked to 0
    for (int tap = lane; tap < t * t; tap += 32) dots[tap] = 0.f;
  }
  __syncwarp();

  float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  float* op = out + q * out_c + offset;
  for (int o = lane; o < R1 * R1; o += 32) {
    int yy = o / R1, xx = o - yy * R1;
    const float* d = dots + yy * t + xx;
    // (1-fy)*((1-fx)*d00 + fx*d01) + fy*((1-fx)*d10 + fx*d11)
    float top = __fadd_rn(__fmul_rn(gx, d[0]), __fmul_rn(fx, d[1]));
    float bot = __fadd_rn(__fmul_rn(gx, d[t]), __fmul_rn(fx, d[t + 1]));
    op[o] = __fadd_rn(__fmul_rn(gy, top), __fmul_rn(fy, bot));
  }
}

extern "C" int corr_patch_lookup_launch(const void* f1, const void* f2p,
                                        const void* coords, void* out, int B,
                                        int N, int Hp, int Wp, int r,
                                        float scale, int out_c, int offset,
                                        void* stream) {
  long long BN = (long long)B * N;
  if (BN == 0) return 0;
  if (r < 0 || 2 * r + 2 > MAXT) return (int)cudaErrorInvalidValue;
  unsigned blocks = (unsigned)((BN + WARPS - 1) / WARPS);
  corr_patch_lookup_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const uint4*)f1, (const uint4*)f2p, (const float*)coords, (float*)out,
      BN, N, Hp, Wp, r, scale, out_c, offset);
  return (int)cudaGetLastError();
}
