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
//
// The backward (training; codd_tpu lets XLA differentiate the sums, so it
// replaces no Pallas kernel): for the sums' cotangent G, a query i and a
// key j of its window,
//
//   s_ij = sigmoid(2 a_i.a_j - |a_i|^2 - |a_j|^2)
//   dvals_i = sum_j s_ij G_j                  (the window is symmetric)
//   u_ij = s_ij (1 - s_ij) (G_i.v_j + G_j.v_i)
//   dae_i = -2 sum_j u_ij (a_i - a_j)
//
// so each output row is one pass over its own window and nothing is
// scattered.  A block takes BQ = 32 queries of one row, a lane each, and
// BW = 4 warps; each key row of the window is staged in shared memory (a
// key's ae, vals, G and |a_j|^2, 88 floats), and the warps take its keys in
// turn: every lane of a warp reads the same key, a broadcast.  s_ij is
// recomputed in f32 on the CUDA cores; a lane sums its keys in order, and
// the BW partials of a query are added in a fixed order, so a launch gives
// the same bits every time.  About 145 multiply-adds a pair (the 32-wide
// logit dot, the two 27-wide dots, the 27 dvals and 32 dae updates): bound
// by operations (f32, 67 TFLOP/s), with a third of the staged columns
// outside a query's window at R = 32 (masked, not skipped).  A tensor-core
// form is later work.
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


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

#define BQ 32            // queries of a block: one row, one a lane
#define BW 4             // warps, taking the keys of a staged row in turn
#define KS 88            // floats a staged key: ae | vals, pad | G | |a|^2
#define K_VALS AC        // 32: vals at [32, 59), a pad float
#define K_G (AC + 28)    // 60: G at [60, 87)
#define K_SQ (K_G + NV)  // 87: |a_j|^2
#define NP (AC + NV)     // partials a lane keeps: dae (32), dvals (27)

__device__ __forceinline__ void load_row27(float (&d)[NV], const float* p) {
#pragma unroll
  for (int t = 0; t < NV; ++t) d[t] = __ldg(p + t);
}

// a 27-float run of a staged key (16-byte aligned): six float4 and three
__device__ __forceinline__ void smem27(float (&d)[NV], const float* p) {
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    const float4 v = reinterpret_cast<const float4*>(p)[t];
    d[4 * t] = v.x; d[4 * t + 1] = v.y; d[4 * t + 2] = v.z; d[4 * t + 3] = v.w;
  }
  d[24] = p[24]; d[25] = p[25]; d[26] = p[26];
}

// x . y over 27 floats in three interleaved chains, joined in order
__device__ __forceinline__ float dot27(const float (&x)[NV], const float (&y)[NV]) {
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
#pragma unroll
  for (int t = 0; t < NV; t += 3) {
    c0 = __fmaf_rn(x[t], y[t], c0);
    c1 = __fmaf_rn(x[t + 1], y[t + 1], c1);
    c2 = __fmaf_rn(x[t + 2], y[t + 2], c2);
  }
  return __fadd_rn(__fadd_rn(c0, c1), c2);
}

__global__ void __launch_bounds__(32 * BW, 2)
gn_window_aggregate_backward_kernel(const float* __restrict__ ae,
                                    const float* __restrict__ vals,
                                    const float* __restrict__ g,
                                    float* __restrict__ dae,
                                    float* __restrict__ dvals, int h, int w,
                                    int R) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int x0 = blockIdx.x * BQ, qy = blockIdx.y, b = blockIdx.z;
  const long long plane = (long long)b * h * w;
  const int qx = x0 + lane;
  const bool inside = qx < w;
  // a lane past the image's edge takes the row's first query and keeps no key
  const long long qi = plane + (long long)qy * w + (inside ? qx : x0);

  float a[AC], v[NV], G[NV];
#pragma unroll
  for (int c = 0; c < AC; c += 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(ae + qi * AC + c));
    a[c] = t.x; a[c + 1] = t.y; a[c + 2] = t.z; a[c + 3] = t.w;
  }
  load_row27(v, vals + qi * NV);
  load_row27(G, g + qi * NV);
  float qsq = 0.f;
#pragma unroll
  for (int c = 0; c < AC; ++c) qsq = __fmaf_rn(a[c], a[c], qsq);

  float pa[AC], pv[NV];  // sum_j u (a_i - a_j), sum_j s G_j
#pragma unroll
  for (int c = 0; c < AC; ++c) pa[c] = 0.f;
#pragma unroll
  for (int t = 0; t < NV; ++t) pv[t] = 0.f;

  const int kx_lo = max(x0 - R, 0), kx_hi = min(x0 + BQ - 1 + R, w - 1);
  const int nk = kx_hi - kx_lo + 1;
  const int lo = inside ? max(qx - R, 0) : 1 << 30;
  const int hi = inside ? min(qx + R, w - 1) : -1;
  const int ky_lo = max(qy - R, 0), ky_hi = min(qy + R, h - 1);

  for (int ky = ky_lo; ky <= ky_hi; ++ky) {
    __syncthreads();  // the previous row's keys are read
    const long long k0 = plane + (long long)ky * w + kx_lo;
    for (int e = tid; e < nk * AC; e += 32 * BW)
      sm[(e / AC) * KS + e % AC] = __ldg(ae + k0 * AC + e);
    for (int e = tid; e < nk * NV; e += 32 * BW) {
      sm[(e / NV) * KS + K_VALS + e % NV] = __ldg(vals + k0 * NV + e);
      sm[(e / NV) * KS + K_G + e % NV] = __ldg(g + k0 * NV + e);
    }
    __syncthreads();
    for (int k = tid; k < nk; k += 32 * BW) {
      const float* kp = sm + k * KS;
      float s2 = 0.f;
#pragma unroll
      for (int c = 0; c < AC; ++c) s2 = __fmaf_rn(kp[c], kp[c], s2);
      sm[k * KS + K_SQ] = s2;
    }
    __syncthreads();
    for (int k = wid; k < nk; k += BW) {
      const int kx = kx_lo + k;
      const bool keep = kx >= lo && kx <= hi;
      if (!__any_sync(0xffffffffu, keep)) continue;
      const float* kp = sm + k * KS;
      float kv[AC];
#pragma unroll
      for (int c = 0; c < AC; c += 4) {
        const float4 t = *reinterpret_cast<const float4*>(kp + c);
        kv[c] = t.x; kv[c + 1] = t.y; kv[c + 2] = t.z; kv[c + 3] = t.w;
      }
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
      for (int c = 0; c < AC; c += 4) {
        d0 = __fmaf_rn(a[c], kv[c], d0);
        d1 = __fmaf_rn(a[c + 1], kv[c + 1], d1);
        d2 = __fmaf_rn(a[c + 2], kv[c + 2], d2);
        d3 = __fmaf_rn(a[c + 3], kv[c + 3], d3);
      }
      const float dot = __fadd_rn(__fadd_rn(d0, d1), __fadd_rn(d2, d3));
      const float logit =
          __fsub_rn(__fmaf_rn(2.0f, dot, -qsq), kp[K_SQ]);
      const float s = keep ? sigmoid_fast(logit) : 0.f;
      float kvals[NV], kg[NV];
      smem27(kvals, kp + K_VALS);
      smem27(kg, kp + K_G);
      const float u = __fmul_rn(__fmul_rn(s, __fsub_rn(1.0f, s)),
                                __fadd_rn(dot27(G, kvals), dot27(kg, v)));
#pragma unroll
      for (int t = 0; t < NV; ++t) pv[t] = __fmaf_rn(s, kg[t], pv[t]);
#pragma unroll
      for (int c = 0; c < AC; ++c)
        pa[c] = __fmaf_rn(u, __fsub_rn(a[c], kv[c]), pa[c]);
    }
  }

  // the BW partials of each query, added in a fixed order; reuses the row
  __syncthreads();
  float* red = sm;  // [BW][BQ][NP]
#pragma unroll
  for (int c = 0; c < AC; ++c) red[(wid * BQ + lane) * NP + c] = pa[c];
#pragma unroll
  for (int t = 0; t < NV; ++t) red[(wid * BQ + lane) * NP + AC + t] = pv[t];
  __syncthreads();
  for (int e = tid; e < BQ * NP; e += 32 * BW) {
    const int q = e / NP, t = e % NP;
    if (x0 + q >= w) continue;
    float sum = red[q * NP + t];
#pragma unroll
    for (int n = 1; n < BW; ++n) sum = __fadd_rn(sum, red[(n * BQ + q) * NP + t]);
    const long long o = plane + (long long)qy * w + x0 + q;
    if (t < AC)
      dae[o * AC + t] = -2.0f * sum;
    else
      dvals[o * NV + t - AC] = sum;
  }
}

// dae (B, h, w, 32) and dvals (B, h, w, 27) are written in full.
extern "C" int gn_window_aggregate_backward_launch(
    const void* ae, const void* vals, const void* g, void* dae, void* dvals,
    int B, int h, int w, int R, void* stream) {
  if (B == 0 || h == 0 || w == 0) return 0;
  if (R < 0) return (int)cudaErrorInvalidValue;
  const int nk = w < BQ + 2 * R ? w : BQ + 2 * R;
  size_t bytes = (size_t)nk * KS * sizeof(float);
  const size_t reduce = (size_t)BW * BQ * NP * sizeof(float);
  if (reduce > bytes) bytes = reduce;
  cudaError_t err = cudaFuncSetAttribute(
      gn_window_aggregate_backward_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + BQ - 1) / BQ, h, B);
  gn_window_aggregate_backward_kernel<<<grid, 32 * BW, bytes,
                                        (cudaStream_t)stream>>>(
      (const float*)ae, (const float*)vals, (const float*)g, (float*)dae,
      (float*)dvals, h, w, R);
  return (int)cudaGetLastError();
}
