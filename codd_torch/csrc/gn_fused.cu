// Fused GN core of RAFT-3D: windowed sigmoid-attention aggregation of the
// 27-value normal-equation field + damping + unrolled 6x6 LL^T solve,
// sm_90a, all in f32.
//
// Replaces codd_tpu/ops/pallas/gn_fused.py:gn_fused_solve.  Block = one
// segment of QX = 32 queries on one row (lane = query) times G = 8 warps.
// The block walks the key rows of its (2r+1)-row window; each row's keys
// (the segment's columns +- r, clipped to the image) are staged in shared
// memory with their squared norms, and warp g takes columns g, g+G, ...,
// so every lane of a warp reads the same key (a shared-memory broadcast).
// logit = 2 q.k - |q|^2 - |k|^2 with the norms subtracted outside the dot
// product as in the oracle.  The G partial sums of each query are added in
// a fixed order, then warp 0 damps H += (lm*diag(H) + ep) I, solves
// H dx = b and zeroes a non-finite dx.  Bound by operations; see
// codd_torch/ops/gn.py.
#include <cuda_runtime.h>

#define AC 32  // embedding channels
#define NV 27  // 21 packed H entries + 6 b entries
#define QX 32  // queries per block
#define G 8    // warps per block, splitting the key columns

__device__ __forceinline__ int tri(int i, int j) {
  // packed upper-triangle index of (min(i,j), max(i,j)) in row-major order
  if (i > j) { int t = i; i = j; j = t; }
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

__global__ void __launch_bounds__(QX * G)
gn_fused_solve_kernel(const float* __restrict__ ae,
                      const float* __restrict__ vals,
                      float* __restrict__ out, int h, int w, int R,
                      float lm, float ep) {
  extern __shared__ float smem[];
  const int KW = QX + 2 * R;
  float* kae = smem;              // [KW][AC]
  float* kval = kae + KW * AC;    // [KW][NV]
  float* ksq = kval + KW * NV;    // [KW]

  int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  int x0 = blockIdx.x * QX, qy = blockIdx.y, b = blockIdx.z;
  int qx = x0 + lane;
  bool active = qx < w;
  long long plane = (long long)b * h * w;

  float q[AC];
  float qsq = 0.f;
  {
    const float* qp = ae + (plane + (long long)qy * w + (active ? qx : 0)) * AC;
#pragma unroll
    for (int c = 0; c < AC; ++c) {
      q[c] = qp[c];
      qsq = __fadd_rn(qsq, __fmul_rn(q[c], q[c]));
    }
  }
  float acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.f;

  int kx_lo = max(x0 - R, 0), kx_hi = min(x0 + QX - 1 + R, w - 1);
  int nk = kx_hi - kx_lo + 1;
  int ky_lo = max(qy - R, 0), ky_hi = min(qy + R, h - 1);
  for (int ky = ky_lo; ky <= ky_hi; ++ky) {
    __syncthreads();
    const float* arow = ae + (plane + (long long)ky * w + kx_lo) * AC;
    const float* vrow = vals + (plane + (long long)ky * w + kx_lo) * NV;
    for (int e = threadIdx.x; e < nk * AC; e += QX * G) kae[e] = arow[e];
    for (int e = threadIdx.x; e < nk * NV; e += QX * G) kval[e] = vrow[e];
    __syncthreads();
    for (int k = threadIdx.x; k < nk; k += QX * G) {
      float s = 0.f;
      for (int c = 0; c < AC; ++c)
        s = __fadd_rn(s, __fmul_rn(kae[k * AC + c], kae[k * AC + c]));
      ksq[k] = s;
    }
    __syncthreads();
    if (!active) continue;
    for (int k = g; k < nk; k += G) {
      int kx = kx_lo + k;
      if (abs(kx - qx) > R) continue;
      const float* kp = kae + k * AC;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < AC; ++c) dot = fmaf(q[c], kp[c], dot);
      float logit = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, dot), qsq), ksq[k]);
      float s = 1.0f / (1.0f + expf(-logit));
      const float* vp = kval + k * NV;
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v] = fmaf(s, vp[v], acc[v]);
    }
  }

  // fixed-order sum of the G partials; reuses the key staging buffer
  __syncthreads();
  float* red = smem;  // [G][QX][NV]
#pragma unroll
  for (int v = 0; v < NV; ++v) red[(g * QX + lane) * NV + v] = acc[v];
  __syncthreads();
  if (g != 0 || !active) return;
  float a[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float s = red[lane * NV + v];
    for (int gg = 1; gg < G; ++gg) s = __fadd_rn(s, red[(gg * QX + lane) * NV + v]);
    a[v] = s;
  }

  // damping H + (lm*diag(H) + ep) I and the unrolled LL^T solve, written
  // with round-to-nearest intrinsics in the order of cholesky_solve_small
  float H[6][6], L[6][6], y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) H[i][j] = a[tri(i, j)];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    H[i][i] = __fadd_rn(H[i][i], __fadd_rn(__fmul_rn(lm, H[i][i]), ep));
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = __fsub_rn(s, __fmul_rn(L[i][k], L[j][k]));
      L[i][j] = (i == j) ? __fsqrt_rn(fmaxf(s, 1e-12f)) : __fdiv_rn(s, L[j][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = a[21 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = __fsub_rn(s, __fmul_rn(L[i][k], y[k]));
    y[i] = __fdiv_rn(s, L[i][i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = __fsub_rn(s, __fmul_rn(L[k][i], x[k]));
    x[i] = __fdiv_rn(s, L[i][i]);
  }
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(x[i]);
  float* op = out + (plane + (long long)qy * w + qx) * 6;
#pragma unroll
  for (int i = 0; i < 6; ++i) op[i] = finite ? x[i] : 0.0f;
}

extern "C" int gn_fused_solve_launch(const void* ae, const void* vals,
                                     void* out, int B, int h, int w, int R,
                                     float lm, float ep, void* stream) {
  if (B == 0 || h == 0 || w == 0) return 0;
  int KW = QX + 2 * R;
  size_t stage = (size_t)KW * (AC + NV + 1) * sizeof(float);
  size_t reduce = (size_t)G * QX * NV * sizeof(float);
  size_t bytes = stage > reduce ? stage : reduce;
  cudaError_t err = cudaFuncSetAttribute(
      gn_fused_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + QX - 1) / QX, h, B);
  gn_fused_solve_kernel<<<grid, QX * G, bytes, (cudaStream_t)stream>>>(
      (const float*)ae, (const float*)vals, (float*)out, h, w, R, lm, ep);
  return (int)cudaGetLastError();
}
