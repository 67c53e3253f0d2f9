// Front-to-back alpha compositing of sorted splat fragments, sm_90a.
//
// Replaces codd_tpu/ops/pallas/splat_composite.py:composite_tiles.  One
// thread per pixel p walks its run order[offsets[p] .. offsets[p+1]) of
// fragment ids (sorted by (pixel, quantized z), ties by fragment id).
// Fragment o belongs to point n = o % N.  Weight alpha * exp(sum of
// log1p(-alpha) over the earlier fragments of the run), for the first
// ppp fragments only; zbuf is the first fragment's z (0 for an empty run)
// and count the run length.  No per-tile overflow drop.  Bound by bytes;
// see codd_torch/ops/splat.py.
#include <cuda_runtime.h>

#define MAXC 32

__global__ void splat_composite_kernel(const long long* __restrict__ order,
                                       const long long* __restrict__ offsets,
                                       const float* __restrict__ alpha,
                                       const float* __restrict__ z,
                                       const float* __restrict__ feat,
                                       float* __restrict__ out,
                                       float* __restrict__ zbuf,
                                       float* __restrict__ cnt, int npix,
                                       int N, int C, int ppp) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  long long s = offsets[p], e = offsets[p + 1];
  float acc[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) acc[c] = 0.f;
  float logT = 0.f;
  long long stop = e - s > ppp ? s + ppp : e;
  for (long long i = s; i < stop; ++i) {
    long long o = order[i];
    int n = (int)(o % N);
    float a = alpha[o];
    float wgt = __fmul_rn(a, expf(logT));
    const float* fp = feat + (long long)n * C;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) acc[c] = __fadd_rn(acc[c], __fmul_rn(fp[c], wgt));
    logT = __fadd_rn(logT, log1pf(-a));
  }
  float* op = out + (long long)p * C;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) op[c] = acc[c];
  zbuf[p] = e > s ? z[order[s] % N] : 0.0f;
  cnt[p] = (float)(e - s);
}

extern "C" int splat_composite_launch(const void* order, const void* offsets,
                                      const void* alpha, const void* z,
                                      const void* feat, void* out, void* zbuf,
                                      void* cnt, int npix, int N, int C,
                                      int ppp, void* stream) {
  if (C > MAXC) return (int)cudaErrorInvalidValue;
  if (npix == 0) return 0;
  int threads = 256;
  int blocks = (npix + threads - 1) / threads;
  splat_composite_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)order, (const long long*)offsets,
      (const float*)alpha, (const float*)z, (const float*)feat, (float*)out,
      (float*)zbuf, (float*)cnt, npix, N, C, ppp);
  return (int)cudaGetLastError();
}
