// Fused GN core of RAFT-3D: windowed sigmoid-attention aggregation of the
// 27-value normal-equation field + damping + unrolled 6x6 LL^T solve,
// sm_90a, f32 (optionally bf16-rounded scores and values).
//
// Replaces codd_tpu/ops/pallas/gn_fused.py:gn_fused_solve.  The
// aggregation is gn_common.cuh's: a block of 16 x 2 queries, two mma.sync
// m-tiles of five warps each, key rows staged by the copy engine
// (cp.async.bulk) through a ring of three buffers, both products in split
// TF32 (or bf16 for the second) with the f32 norms outside, fixed-order
// sums.  Its epilogue damps H += (lm*diag(H) + ep) I, solves H dx = b and
// zeroes a non-finite dx, one thread a query.  Bound by the warp schedulers
// around the mma.sync pipe; see gn_common.cuh and codd_torch/ops/gn.py.
#include "gn_common.cuh"

__device__ __forceinline__ int tri(int i, int j) {
  // packed upper-triangle index of (min(i,j), max(i,j)) in row-major order
  if (i > j) { int t = i; i = j; j = t; }
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// the epilogue, one thread a query: damp, solve, zero a non-finite update,
// store
struct DampedSolve {
  float* out;
  int h, w;
  float lm, ep;
  __device__ __forceinline__ void operator()(const float (&a)[NV], int b,
                                             int qy, int qx) const {
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
    float* op = out + (((long long)b * h + qy) * w + qx) * 6;
#pragma unroll
    for (int i = 0; i < 6; ++i) op[i] = finite ? x[i] : 0.0f;
  }
};

template <bool BF16>
__global__ void __launch_bounds__(GN_THREADS, 2)
gn_fused_solve_kernel(const float* __restrict__ ae,
                      const float* __restrict__ vals,
                      float* __restrict__ out, int h, int w, int R,
                      float lm, float ep) {
  extern __shared__ __align__(16) float smem[];
  gn_window_sums<BF16>(ae, vals, smem, h, w, R,
                       DampedSolve{out, h, w, lm, ep});
}

template <bool BF16>
static int launch(const void* ae, const void* vals, void* out, int B, int h,
                  int w, int R, float lm, float ep, void* stream) {
  size_t bytes = gn_smem_bytes(R);
  cudaError_t err = cudaFuncSetAttribute(
      gn_fused_solve_kernel<BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // two blocks an SM need more than the default split of L1 and shared memory
  err = cudaFuncSetAttribute(gn_fused_solve_kernel<BF16>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid = gn_grid(B, h, w);
  gn_fused_solve_kernel<BF16><<<grid, GN_THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)ae, (const float*)vals, (float*)out, h, w, R, lm, ep);
  return (int)cudaGetLastError();
}

extern "C" int gn_fused_solve_launch(const void* ae, const void* vals,
                                     void* out, int B, int h, int w, int R,
                                     float lm, float ep, int bf16_scores,
                                     void* stream) {
  if (B == 0 || h == 0 || w == 0) return 0;
  return bf16_scores ? launch<true>(ae, vals, out, B, h, w, R, lm, ep, stream)
                     : launch<false>(ae, vals, out, B, h, w, R, lm, ep, stream);
}
