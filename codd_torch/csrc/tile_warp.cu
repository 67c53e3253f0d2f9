// Slant-plane tile-warp cost (HITNet propagation), sm_90a.
//
// Replaces codd_tpu/ops/pallas/tile_warp.py:tile_warp_cost.  One thread
// per pixel (b, y, x): the pixel's plane disparity, its four right-feature
// taps on row y, three lerped warps (k = -1, 0, +1) and their L1 costs to
// the left feature, written straight into the PixelUnshuffled
// (B, ht, wt, 48) layout, channel k*16 + i*4 + j.  Bound by bytes; see
// codd_torch/ops/tile_warp.py.  Arithmetic that decides floor() uses
// round-to-nearest intrinsics so nvcc cannot contract it into FMAs that the
// plain PyTorch version does not do.
#include <cuda_runtime.h>

__global__ void tile_warp_cost_kernel(const float* __restrict__ hyp3,
                                      const float* __restrict__ fea_l,
                                      const float* __restrict__ fea_r,
                                      float* __restrict__ out,
                                      int B, int H, int W, int C) {
  long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long npix = (long long)B * H * W;
  if (pix >= npix) return;
  int x = (int)(pix % W);
  int y = (int)((pix / W) % H);
  int b = (int)(pix / ((long long)W * H));
  int ht = H / 4, wt = W / 4;
  int ty = y >> 2, tx = x >> 2, i = y & 3, j = x & 3;

  const float* hp = hyp3 + (((long long)b * ht + ty) * wt + tx) * 3;
  float d = hp[0], sx = hp[1], sy = hp[2];
  // to_plane: (d + cx * dx) + cy * dy with c = -1.5, -0.5, 0.5, 1.5
  float cx = (float)j - 1.5f, cy = (float)i - 1.5f;
  float local_d = __fadd_rn(__fadd_rn(d, __fmul_rn(cx, sx)), __fmul_rn(cy, sy));
  float p = __fsub_rn((float)x, local_d);
  float x0 = floorf(p);
  float f = __fsub_rn(p, x0);
  float g = __fsub_rn(1.0f, f);

  const float* row = fea_r + ((long long)b * H + y) * (long long)W * C;
  const float* fl = fea_l + pix * C;
  const float* tap[4];
  bool ok[4];
  for (int m = 0; m < 4; ++m) {
    float xm = x0 - 1.0f + (float)m;
    ok[m] = (xm >= 0.0f) && (xm <= (float)(W - 1));
    int xi = ok[m] ? (int)xm : 0;
    tap[m] = row + (long long)xi * C;
  }

  float cost[3] = {0.f, 0.f, 0.f};
  for (int c = 0; c < C; c += 4) {
    float4 l = *reinterpret_cast<const float4*>(fl + c);
    float4 t[4];
    for (int m = 0; m < 4; ++m)
      t[m] = ok[m] ? __ldg(reinterpret_cast<const float4*>(tap[m] + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    // k = -1, 0, +1 lerps the tap pairs starting at 2, 1, 0
    for (int kk = 0; kk < 3; ++kk) {
      int m = 2 - kk;
      float w0 = __fadd_rn(__fmul_rn(t[m].x, g), __fmul_rn(t[m + 1].x, f));
      float w1 = __fadd_rn(__fmul_rn(t[m].y, g), __fmul_rn(t[m + 1].y, f));
      float w2 = __fadd_rn(__fmul_rn(t[m].z, g), __fmul_rn(t[m + 1].z, f));
      float w3 = __fadd_rn(__fmul_rn(t[m].w, g), __fmul_rn(t[m + 1].w, f));
      cost[kk] += fabsf(l.x - w0) + fabsf(l.y - w1) + fabsf(l.z - w2) +
                  fabsf(l.w - w3);
    }
  }
  float* op = out + (((long long)b * ht + ty) * wt + tx) * 48 + i * 4 + j;
  op[0] = cost[0];
  op[16] = cost[1];
  op[32] = cost[2];
}

extern "C" int tile_warp_cost_launch(const void* hyp3, const void* fea_l,
                                     const void* fea_r, void* out, int B,
                                     int H, int W, int C, void* stream) {
  long long npix = (long long)B * H * W;
  int threads = 128;
  unsigned blocks = (unsigned)((npix + threads - 1) / threads);
  if (blocks == 0) return 0;
  tile_warp_cost_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)hyp3, (const float*)fea_l, (const float*)fea_r,
      (float*)out, B, H, W, C);
  return (int)cudaGetLastError();
}
