// Windowed sigmoid-attention aggregation of the 27-value GN field, shared
// by gn_fused.cu (aggregate + damp + solve) and gn_window.cu (aggregate
// only), sm_90a.
//
//   agg_i = sum_j sigmoid(-|ae_i - ae_j|^2) * vals_j,   |dy|, |dx| <= R
//
// Block = one segment of QX = 32 queries on one row (lane = query) times
// G = 8 warps.  The block walks the key rows of its (2R+1)-row window; each
// row's keys (the segment's columns +- R, clipped to the image) are staged
// in shared memory with their squared norms, and warp g takes columns
// g, g+G, ..., so every lane of a warp reads the same key (a shared-memory
// broadcast).  logit = 2 q.k - |q|^2 - |k|^2 with the norms subtracted
// outside the dot product, as in the oracle.  The G partial sums of each
// query are added in a fixed order.  With BF16 the sigmoid score and the
// value are rounded to bf16 (round to nearest even) before their product;
// a product of two bf16 values is exact in f32, and the sum stays f32.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define AC 32  // embedding channels
#define NV 27  // 21 packed H entries + 6 b entries
#define QX 32  // queries per block
#define G 8    // warps per block, splitting the key columns

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dynamic shared memory a block needs: the key staging buffer, reused for
// the cross-warp reduction
inline size_t gn_smem_bytes(int R) {
  int KW = QX + 2 * R;
  size_t stage = (size_t)KW * (AC + NV + 1) * sizeof(float);
  size_t reduce = (size_t)G * QX * NV * sizeof(float);
  return stage > reduce ? stage : reduce;
}

// Every thread of the block calls this.  For each query inside the image,
// one thread (of warp 0) ends in ``epilogue(a, b, qy, qx)`` with the 27 sums
// of query (b, qy, qx) in a[].
template <bool BF16, class Epilogue>
__device__ __forceinline__ void gn_window_sums(const float* __restrict__ ae,
                                               const float* __restrict__ vals,
                                               float* smem, int h, int w,
                                               int R, Epilogue epilogue) {
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
    for (int e = threadIdx.x; e < nk * NV; e += QX * G)
      kval[e] = BF16 ? round_bf16(vrow[e]) : vrow[e];
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
      if (BF16) s = round_bf16(s);
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
  epilogue(a, b, qy, qx);
}
