// Windowed sigmoid-attention aggregation of the 27-value GN field, sm_90a:
//
//   out_i = sum_j sigmoid(-|ae_i - ae_j|^2) * vals_j,   |dy|, |dx| <= R
//
// Replaces codd_tpu/ops/pallas/gn_window.py:gn_window_aggregate.  The
// aggregation is gn_common.cuh's, the same code gn_fused.cu solves on: a
// block of 16 x 2 queries as two mma.sync m-tiles, key rows staged by
// the copy engine (cp.async.bulk) through a ring, both products in split
// TF32 (or bf16 for the second).  The logit's f32 norms are subtracted outside the product (the
// TPU kernel folds them into augmented vectors, which is what diverged when
// compiled for the chip).  Its epilogue writes the 27 sums (B, h, w, 27);
// damping and the 6x6 solve run in PyTorch.  Bound by the warp schedulers
// around the mma.sync pipe; see gn_common.cuh and codd_torch/ops/gn.py.
#include "gn_common.cuh"

// the epilogue, one thread a query: store the sums
struct StoreSums {
  float* out;
  int h, w;
  __device__ __forceinline__ void operator()(const float (&a)[NV], int b,
                                             int qy, int qx) const {
    float* op = out + (((long long)b * h + qy) * w + qx) * NV;
#pragma unroll
    for (int v = 0; v < NV; ++v) op[v] = a[v];
  }
};

template <bool BF16>
__global__ void __launch_bounds__(GN_THREADS, 2)
gn_window_aggregate_kernel(const float* __restrict__ ae,
                           const float* __restrict__ vals,
                           float* __restrict__ out, int h, int w, int R) {
  extern __shared__ __align__(16) float smem[];
  gn_window_sums<BF16>(ae, vals, smem, h, w, R, StoreSums{out, h, w});
}

template <bool BF16>
static int launch(const void* ae, const void* vals, void* out, int B, int h,
                  int w, int R, void* stream) {
  size_t bytes = gn_smem_bytes(R);
  cudaError_t err = cudaFuncSetAttribute(
      gn_window_aggregate_kernel<BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // two blocks an SM need more than the default split of L1 and shared memory
  err = cudaFuncSetAttribute(gn_window_aggregate_kernel<BF16>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid = gn_grid(B, h, w);
  gn_window_aggregate_kernel<BF16>
      <<<grid, GN_THREADS, bytes, (cudaStream_t)stream>>>(
          (const float*)ae, (const float*)vals, (float*)out, h, w, R);
  return (int)cudaGetLastError();
}

extern "C" int gn_window_aggregate_launch(const void* ae, const void* vals,
                                          void* out, int B, int h, int w,
                                          int R, int bf16_scores,
                                          void* stream) {
  if (B == 0 || h == 0 || w == 0) return 0;
  return bf16_scores ? launch<true>(ae, vals, out, B, h, w, R, stream)
                     : launch<false>(ae, vals, out, B, h, w, R, stream);
}
