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
//   dae_i = -2 sum_j u_ij (a_i - a_j) = -2 (a_i rowsum(U)_i - (U A)_i)
//
// so each output row is one pass over its own window and nothing is
// scattered.  Four products around an elementwise step: S = A A^T (the
// logits), P = [G | V] [V | G]^T (G_i.v_j + V_i.G_j in one product, 2 x 27
// values padded to 2 x 28), then S G and U A; all 3xTF32 on mma.sync (one
// TF32 product in place of any of the four breaks the bound:
// tests/test_torch_gn.py), ~57 mma a 16 x 8 tile of pairs against the
// forward's 24.  It is built on gn_window_sums' machinery: the 16 x 2
// query tile as two m-tiles of NS warps that take a staged row's 16-key
// chunks in turn, the NSTAGE ring of key rows fed by cp.async.bulk
// (KeyRows, which here also stages G), the accumulator fragment of S and of
// U as the A operand of the second products, the mask tested only where a
// chunk reaches past a query's window, and fixed-order sums: a launch
// gives the same bits every time.  A query's [G | V] fragments, the same
// for the NS warps of its m-tile, are split once and sit in shared memory.  Its first form (a
// thread a query, f32 on the CUDA cores, ~145 multiply-adds a pair with
// each pair's symmetric terms computed from both ends) took 1.129 ms at
// the motion stage's training call (B=4, 48x96); see PERF.md for this
// one.  Computing each unordered pair once would need a reduction across
// blocks (the pair's other end lies in another block's window) and is
// left out.  What bounds it: the mma.sync issue and the ~300 other
// instructions a tile (operand splits, fragment loads, sigmoid), at 10
// warps an SM: 168 registers, the cap for 320 threads, which are
// allocated as 12 warps (a cap of 200 does not launch), and 76 bytes
// spilled (-Xptxas=-v; the first form: 236 registers, none).  Copies with
// the operand splits or the P product cut out ran markedly faster; the
// bf16-score form below takes its key operands from a pre-pass and runs P
// and S G in bf16.
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

#define KP 7   // k-steps of P = [G | V] [V | G]^T: 2 x 28 values
#define BR 72  // floats a query's partials take in the cross-warp reduction

// x rounded to bf16 (to nearest even), as f32
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The backward's ring of key rows: gn_window_sums' NSTAGE buffers, each
// one key row of the block's window (key row ky_lo + r, columns kx_lo ..
// kx_lo + nk - 1, in buffer r % NSTAGE, counted on that buffer's
// mbarrier), here with the sums' cotangent G staged beside the values:
// [KW][AC] embeddings, the keys' vals, their G, [KW] squared norms.  (One
// such struct for both passes left the forward's bits as they were and
// made it slower, so gn_window_sums keeps its own lambdas.)
struct KeyRows {
  float* smem;
  unsigned long long* bars;   // NSTAGE, in shared memory
  const float* ae;
  const float* val[2];        // vals and G, (B, h, w, NV) each
  long long plane, vals_end;  // the batch element's first pixel; B*h*w*NV
  int KW, stage, w, kx_lo, ky_lo, nk;

  __device__ __forceinline__ float* buf(int r) const {
    return smem + (r % NSTAGE) * stage;
  }
  __device__ __forceinline__ int val_at(int i) const {
    return KW * AC + i * (KW * NV + 8);
  }
  __device__ __forceinline__ long long first(int r) const {
    return plane + (long long)(ky_lo + r) * w + kx_lo;
  }
  // run i (0: vals, 1: G) of row r, past the row's 16-byte offset
  __device__ __forceinline__ const float* values(int r, int i) const {
    return buf(r) + val_at(i) + (int)((first(r) * NV) & 3);
  }
  __device__ __forceinline__ const float* norms(int r) const {
    return buf(r) + val_at(2);
  }

  // Row r into its buffer, asked for by one thread, as gn_window_sums asks:
  // the embeddings are one run of memory, and so is each run of values,
  // taken from the 16-byte boundary below its first float; the last floats
  // of a whole array, with no full 16 bytes left, the thread copies itself.
  __device__ __forceinline__ void request(int r) const {
    float* b = buf(r);
    const unsigned bar = smem_u32(&bars[r % NSTAGE]);
    const long long at = first(r);
    const int off = (int)((at * NV) & 3);
    const long long room = vals_end - (at * NV - off);
    const int want = off + nk * NV;  // floats up to the row's last value
    const int whole = (int)min((long long)((want + 3) & ~3), room & ~3LL);
    fence_async_proxy();
    mbar_expect(bar, (unsigned)(nk * AC + 2 * whole) * 4u);
    bulk_copy(b, ae + at * AC, (unsigned)(nk * AC) * 4u, bar);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const float* vsrc = val[v] + (at * NV - off);
      float* kval = b + val_at(v);
      if (whole > 0) bulk_copy(kval, vsrc, (unsigned)whole * 4u, bar);
      for (int i = whole; i < want; ++i) kval[i] = vsrc[i];
    }
  }

  // squared norms of a landed row: four threads a key, 8 channels each in
  // order, then ((p0 + p1) + p2) + p3
  __device__ __forceinline__ void prepare(int r, int tid) const {
    float* b = buf(r);
    for (int base = 0; base < nk; base += GN_THREADS / 4) {
      int k = base + (tid >> 2), part = tid & 3;
      float p = 0.f;
      if (k < nk) {
        const float4* kp = reinterpret_cast<const float4*>(b + k * AC);
        p = sq8(kp[2 * part], kp[2 * part + 1]);
      }
      float s = __fadd_rn(p, __shfl_down_sync(0xffffffffu, p, 1));
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, p, 2));
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, p, 3));
      if (k < nk && part == 0) b[val_at(2) + k] = s;
    }
  }
};

// The backward on the tensor cores, gn_window_sums' tile and ring: for
// each 16 x 8 tile of (query, key) pairs, S = Q K^T (the logits), P =
// [G | V]_q [V | G]_k^T (G_i.v_j + V_i.G_j), both 3xTF32 on three
// accumulators; s and u = s (1 - s) P on the accumulator fragments; then
// the fragments, split, are the A operands of dvals += S G_k and U A_k, a
// fresh accumulator each (3 mma) joined to the running sums by IEEE adds.
// The bf16-score form is a kernel of its own, below.
__global__ void __launch_bounds__(GN_THREADS, 1)
gn_window_aggregate_backward_kernel(const float* __restrict__ ae,
                                    const float* __restrict__ vals,
                                    const float* __restrict__ g,
                                    float* __restrict__ dae,
                                    float* __restrict__ dvals, int h, int w,
                                    int R) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int slot = wid % NS;                // which chunks of a row
  const int gq = lane >> 2, c = lane & 3;   // mma group and thread in group
  const int x0 = blockIdx.x * QX, qy0 = blockIdx.y * QY, b = blockIdx.z;
  const int qy = qy0 + wid / NS;            // the warp's query row (m-tile)
  const long long plane = (long long)b * h * w;

  const int kx_lo = max(x0 - R, 0), kx_hi = min(x0 + QX - 1 + R, w - 1);
  const int nk = kx_hi - kx_lo + 1, nchunks = (nk + CHUNK - 1) / CHUNK;
  const int ky_lo = max(qy0 - R, 0), ky_hi = min(qy0 + QY - 1 + R, h - 1);
  const int nrows = ky_hi - ky_lo + 1;

  __shared__ __align__(8) unsigned long long bars[NSTAGE];
  const KeyRows ring = {smem, bars, ae, {vals, g}, plane,
                        (long long)gridDim.z * h * w * NV, gn_row_keys(R),
                        gn_stage_floats(R, 2), w, kx_lo, ky_lo, nk};
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < NSTAGE; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // zero the ring: keys past a row's last one are read and must be finite
  for (int e = tid; e < NSTAGE * ring.stage / 4; e += GN_THREADS)
    reinterpret_cast<float4*>(smem)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  fence_async_proxy();
  __syncthreads();
  if (tid == 0) {
    ring.request(0);
    if (nrows > 1) ring.request(1);
  }

  // This lane's two queries, columns gq and gq + 8 of the warp's row (one
  // outside the image reads the block's first and keeps no key): Q as split
  // A fragments, as the forward holds it; [G | V] as split A fragments in
  // shared memory, the same for the NS warps of an m-tile: k-step s, index
  // c (c + 4) is value t = 8s + c (+ 4) of [G (27), 0, V (27), 0], whose
  // zeros meet the keys' 28th values.  (In f32 registers they spilled 56
  // bytes more, and split at each use they cost time.)  A k-step's hi and
  // lo are two 16-byte words, a lane's 14 of them 60 words after the last
  // lane's: the 8 lanes of a quarter warp meet 8 different bank groups.
  __shared__ __align__(16) unsigned gvs[QY][32][8 * KP + 4];
  const uint4* gv = reinterpret_cast<const uint4*>(gvs[wid / NS][lane]);
  unsigned qh[4][4], ql[4][4];
  float qsq[2];
  int dlo[2], dhi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qx = x0 + gq + 8 * i;
    const bool inside = qx < w && qy < h;
    const long long qi =
        plane + (long long)(inside ? qy : qy0) * w + (inside ? qx : x0);
    const float4* qp = reinterpret_cast<const float4*>(ae + qi * AC);
    qsq[i] = __fadd_rn(__fadd_rn(__fadd_rn(sq8(qp[0], qp[1]), sq8(qp[2], qp[3])),
                                 sq8(qp[4], qp[5])), sq8(qp[6], qp[7]));
    dlo[i] = inside ? max(qx - R, 0) - kx_lo : 1 << 30;
    dhi[i] = inside ? min(qx + R, w - 1) - kx_lo : -1;
    const float4 lo4 = qp[c], hi4 = qp[4 + c];
    const float* a = reinterpret_cast<const float*>(&lo4);
    const float* a4 = reinterpret_cast<const float*>(&hi4);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      split_tf32(a[s], qh[s][i], ql[s][i]);
      split_tf32(a4[s], qh[s][2 + i], ql[s][2 + i]);
    }
    const float* gp = g + qi * NV;
    const float* vp = vals + qi * NV;
    if (slot == 0) {
      unsigned* gw = gvs[wid / NS][lane];
#pragma unroll
      for (int s = 0; s < KP; ++s)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int t = 8 * s + c + 4 * k;
          const float x = t < NV ? __ldg(gp + t)
                          : t >= 28 && t < 28 + NV ? __ldg(vp + t - 28)
                                                   : 0.f;
          split_tf32(x, gw[8 * s + i + 2 * k], gw[8 * s + 4 + i + 2 * k]);
        }
    }
  }
  auto window_bits = [&](int t0) {
    unsigned keep = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * i + 2 * c + (e & 1);
        keep |= (unsigned)(t >= dlo[e >> 1] && t <= dhi[e >> 1]) << (4 * i + e);
      }
    return keep;
  };
  const unsigned keep0 = window_bits(slot * CHUNK);

  // dvals and U A: value / channel 8c + j (e 0, 2) and 8c + 4 + j (e 1, 3)
  // of columns gq (e 0, 1) and gq + 8 (e 2, 3); rowsum(U) of both columns
  float av[4][4], aa[4][4], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[j][e] = aa[j][e] = 0.f;

  mbar_wait(smem_u32(&bars[0]), 0);
  ring.prepare(0, tid);
  __syncthreads();

  for (int r = 0; r < nrows; ++r) {
    if (tid == 0 && r + 2 < nrows) ring.request(r + 2);
    if (r + 1 < nrows) {
      mbar_wait(smem_u32(&bars[(r + 1) % NSTAGE]), ((r + 1) / NSTAGE) & 1);
      ring.prepare(r + 1, tid);
    }
    const int ky = ky_lo + r;
    if (qy < h && ky >= qy - R && ky <= qy + R) {
      const float* kae = ring.buf(r);
      const float* kval = ring.values(r, 0);
      const float* kg = ring.values(r, 1);
      const float* ksq = ring.norms(r);
      for (int p = slot; p < nchunks; p += NS) {
        const int t0 = p * CHUNK;
        const unsigned keep = p == slot ? keep0 : window_bits(t0);
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // the chunk's two 8-key tiles
          const int tb = t0 + 8 * i;
          // S = Q K^T: key tb + gq, channels 4c .. 4c + 3, 16 + 4c ..
          const float4* kp = reinterpret_cast<const float4*>(kae + (tb + gq) * AC);
          const float4 k0 = kp[c], k1 = kp[4 + c];
          const float* kf0 = reinterpret_cast<const float*>(&k0);
          const float* kf1 = reinterpret_cast<const float*>(&k1);
          float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f},
                bg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            unsigned h0, l0, h1, l1;
            split_tf32(kf0[s], h0, l0);
            split_tf32(kf1[s], h1, l1);
            mma_tf32(s1, ql[s], h0, h1);
            mma_tf32(s2, qh[s], l0, l1);
            mma_tf32(bg, qh[s], h0, h1);
          }
          // P: key tb + gq's [v (28) | G (28)], value t = 8s + c (+ 4)
          const float* kv = kval + (tb + gq) * NV;
          const float* kgg = kg + (tb + gq) * NV;
          float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f},
                pg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int s = 0; s < KP; ++s) {
            const uint4 hv = gv[2 * s], lv = gv[2 * s + 1];
            const unsigned ah[4] = {hv.x, hv.y, hv.z, hv.w};
            const unsigned al[4] = {lv.x, lv.y, lv.z, lv.w};
            unsigned h0, l0, h1, l1;
            const int t = 8 * s + c;
            split_tf32(s < 4 ? kv[t] : kgg[t - 28], h0, l0);
            split_tf32(s < 3 ? kv[t + 4] : kgg[t + 4 - 28], h1, l1);
            mma_tf32(p1, al, h0, h1);
            mma_tf32(p2, ah, l0, l1);
            mma_tf32(pg, ah, h0, h1);
          }
          // s and u of (column gq | gq + 8) x (key tb + 2c | tb + 2c + 1)
          const float2 kn = *reinterpret_cast<const float2*>(ksq + tb + 2 * c);
          float sv[4], uv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float S = __fadd_rn(__fadd_rn(s1[e], s2[e]), bg[e]);
            const float logit = __fsub_rn(__fmaf_rn(2.0f, S, -qsq[e >> 1]),
                                          (e & 1) ? kn.y : kn.x);
            sv[e] = (keep >> (4 * i + e)) & 1 ? sigmoid_fast(logit) : 0.f;
            const float d = __fmul_rn(sv[e], __fsub_rn(1.0f, sv[e]));
            const float P = __fadd_rn(__fadd_rn(p1[e], p2[e]), pg[e]);
            uv[e] = __fmul_rn(d, P);
          }
          rs[0] = __fadd_rn(__fadd_rn(rs[0], uv[0]), uv[1]);
          rs[1] = __fadd_rn(__fadd_rn(rs[1], uv[2]), uv[3]);
          // the columns (2c, 2c + 1) a lane holds are k-indices (c, c + 4)
          unsigned sh[4], sl[4], uh[4], ul[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int f = (e & 1) * 2 + (e >> 1);  // 0, 2, 1, 3
            split_tf32(sv[f], sh[e], sl[e]);
            split_tf32(uv[f], uh[e], ul[e]);
          }
          // dvals += S G_k and U A_k: keys tb + 2c and tb + 2c + 1, value
          // (channel) 4gq + j of n-tile j.  G's columns 27 .. 31 read the
          // next key's and feed sums that are dropped.
          const float* gk = kg + (tb + 2 * c) * NV + 4 * gq;
          const float4 ka0 = *reinterpret_cast<const float4*>(kae + (tb + 2 * c) * AC + 4 * gq);
          const float4 ka1 = *reinterpret_cast<const float4*>(kae + (tb + 2 * c + 1) * AC + 4 * gq);
          const float* kx0 = reinterpret_cast<const float*>(&ka0);
          const float* kx1 = reinterpret_cast<const float*>(&ka1);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            unsigned h0, l0, h1, l1;
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            split_tf32(gk[j], h0, l0);
            split_tf32(gk[NV + j], h1, l1);
            mma_tf32(d, sl, h0, h1);
            mma_tf32(d, sh, l0, l1);
            mma_tf32(d, sh, h0, h1);
#pragma unroll
            for (int e = 0; e < 4; ++e) av[j][e] = __fadd_rn(av[j][e], d[e]);
            float q[4] = {0.f, 0.f, 0.f, 0.f};
            split_tf32(kx0[j], h0, l0);
            split_tf32(kx1[j], h1, l1);
            mma_tf32(q, ul, h0, h1);
            mma_tf32(q, uh, l0, l1);
            mma_tf32(q, uh, h0, h1);
#pragma unroll
            for (int e = 0; e < 4; ++e) aa[j][e] = __fadd_rn(aa[j][e], q[e]);
          }
        }
      }
    }
    __syncthreads();
  }

  // rowsum(U) over the group's four lanes, then the NS partials of each
  // query in a fixed order; reuses the ring
  rs[0] = __fadd_rn(rs[0], __shfl_xor_sync(0xffffffffu, rs[0], 1));
  rs[0] = __fadd_rn(rs[0], __shfl_xor_sync(0xffffffffu, rs[0], 2));
  rs[1] = __fadd_rn(rs[1], __shfl_xor_sync(0xffffffffu, rs[1], 1));
  rs[1] = __fadd_rn(rs[1], __shfl_xor_sync(0xffffffffu, rs[1], 2));
  float* red = smem;  // [QY * NS][QX][BR]: dvals 0 .., U A 32 .., rowsum 64
  float* r0 = red + (wid * QX + gq) * BR;
  float* r8 = r0 + 8 * BR;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r0[8 * c + j] = av[j][0];
    r0[8 * c + 4 + j] = av[j][1];
    r8[8 * c + j] = av[j][2];
    r8[8 * c + 4 + j] = av[j][3];
    r0[32 + 8 * c + j] = aa[j][0];
    r0[32 + 8 * c + 4 + j] = aa[j][1];
    r8[32 + 8 * c + j] = aa[j][2];
    r8[32 + 8 * c + 4 + j] = aa[j][3];
  }
  if (c == 0) {
    r0[64] = rs[0];
    r8[64] = rs[1];
  }
  __syncthreads();
  for (int e = tid; e < QY * QX * (NV + AC); e += GN_THREADS) {
    const int q = e / (NV + AC), v = e % (NV + AC);
    const int oy = qy0 + q / QX, ox = x0 + q % QX;
    if (oy >= h || ox >= w) continue;
    const float* part = red + ((q / QX) * NS * QX + q % QX) * BR;
    const long long o = plane + (long long)oy * w + ox;
    if (v < NV) {
      float s = part[v];
#pragma unroll
      for (int n = 1; n < NS; ++n) s = __fadd_rn(s, part[n * QX * BR + v]);
      dvals[o * NV + v] = s;
    } else {
      const int ch = v - NV;
      float ua = part[32 + ch], u = part[64];
#pragma unroll
      for (int n = 1; n < NS; ++n) {
        ua = __fadd_rn(ua, part[n * QX * BR + 32 + ch]);
        u = __fadd_rn(u, part[n * QX * BR + 64]);
      }
      // dae = -2 (rowsum(U) a - U A)
      dae[o * AC + ch] =
          __fmul_rn(-2.0f, __fsub_rn(__fmul_rn(u, __ldg(ae + o * AC + ch)), ua));
    }
  }
}

// ---------------------------------------------------------------------------
// backward, bf16 scores
// ---------------------------------------------------------------------------
//
// The VJP of codd_tpu's windowed sums with bf16 scores (codd_tpu/ops/
// gn.py:268, bf16_scores=True), whose roundings jax.vjp fixes: with vb =
// bf16(v) and sb = bf16(s), s the f32 sigmoid,
//
//   dS_ij = bf16(G_i.vb_j), rounded once an ordered pair
//   u_ij = dS_ij s_ij (1 - s_ij) + dS_ji s_ij (1 - s_ij)
//   dvals_i = sum over the 32-column blocks k of the other end, from the
//             highest: f32(bf16(t_k)), t_k = sum_{j in block k} sb_ij G_j
//
// Its first form was the f32 kernel's body with the bf16 steps: 0.8505
// ms at B=4, 48x128 (NVIDIA H100 80GB HBM3, 700.00 W),
// where cutting parts out ranked the P product (G_i.vb_j and vb_i.G_j:
// 16 TF32 mma a 16 x 8 tile and 12 shared-memory loads of the query's
// split [G | vb]) first at 0.26 ms, the sigmoid and u step at 0.12 and
// the keys' TF32 splits and bf16 roundings, redone by every warp at every
// tile, at 0.11 (tools/kernel_cutouts.py --kernel gn_backward).  This
// form keeps the tile (QY x NS warps, a warp a 16-key chunk of a staged
// row), the ring, the fixed-order sums and the one-block-a-chunk rule,
// and changes what feeds the tensor cores:
//
// - A pre-pass writes each key's operands once, as the products read
//   them (gn_backward_bf16_keys_kernel, a KREC-word record a key, rows
//   padded to whole chunks with zero keys): the TF32 hi and lo of its 32
//   channels (S = Q K^T and U A_k, 3xTF32 as before), vb as bf16 pairs,
//   G as three bf16 parts (hi + mid + lo = G exactly) in pairs, and the
//   squared norm.  The ring stages whole records with one bulk copy a row;
//   the main loop splits and rounds no key.
// - P in bf16 on m16n8k16: G_i.vb_j as G's three parts against the exact
//   vb (6 mma for 32 values), vb_i.G_j likewise with the query's vb in
//   registers; 12 mma in place of 16, and 6 shared-memory loads of the
//   query's parts.  Products of bf16 values are exact in f32, as the
//   split TF32 products were, so dS is the same f32 dot rounded once.
// - S G in bf16 over the whole chunk: sb is exact in bf16, so the chunk's
//   16 scores are one m16n8k16 A fragment (the forward's packing) against
//   G's three parts, 3 mma an n-tile a chunk (8 TF32 mma a tile before),
//   the fresh sum joined to the block's partial by IEEE adds.
//
// Why 10 warps an SM still: the query's S fragments (32 registers), the
// p2 fragments (8), dvals and U A (32) and the tile's temporaries need
// more than the 128 registers 16 warps would leave, and the fragments
// reloaded from shared memory in their place would cost more
// shared-memory bandwidth than the key splits took in instructions.

#define KREC 132   // words of a key's record: 33 16-byte words
#define KR_HI 0    // TF32 hi of the 32 channels
#define KR_LO 32   // TF32 lo
#define KR_VB 64   // bf16(v) in pairs: word m holds values 2m (low), 2m + 1
#define KR_G 80    // G's bf16 parts hi, mid, lo, 16 pair words each
#define KR_SQ 128  // the squared norm; 129 .. 131 zero
// BR of the cross-warp reduction, odd: a warp's stores of its lanes'
// partials (query gq at BRB gq, value 8c + j) meet 32 banks, not 4
#define BRB 73

// part p (0 hi, 1 mid, 2 lo) of x as three bf16 values that add to x
// exactly: x - hi and (x - hi) - mid are exact in f32
__device__ __forceinline__ float bf16_part(float x, int p) {
  const float hi = bf16r(x);
  if (p == 0) return hi;
  const float r = __fsub_rn(x, hi);
  const float mid = bf16r(r);
  return p == 1 ? mid : bf16r(__fsub_rn(r, mid));
}

// One thread a 16-byte word of a record: words 0-7 the channels' TF32 hi,
// 8-15 their lo, 16-19 vb, 20-31 G's parts, 32 the norm (summed as
// KeyRows::prepare sums it).  A key past the row's end (x >= w) is zeros.
__global__ void __launch_bounds__(256)
gn_backward_bf16_keys_kernel(const float* __restrict__ ae,
                             const float* __restrict__ vals,
                             const float* __restrict__ g,
                             uint4* __restrict__ recs, long long nquads,
                             int w, int wp) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nquads) return;
  const long long key = t / (KREC / 4);
  const int q = (int)(t % (KREC / 4)), x = (int)(key % wp);
  unsigned o[4] = {0u, 0u, 0u, 0u};
  if (x < w) {
    const long long pix = key / wp * w + x;
    const float4* kp = reinterpret_cast<const float4*>(ae + pix * AC);
    if (q < 16) {
      const float4 f = __ldg(kp + (q & 7));
      const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        unsigned hi, lo;
        split_tf32(fv[k], hi, lo);
        o[k] = q < 8 ? hi : lo;
      }
    } else if (q < 32) {
      const int part = (q - 16) >> 2;  // 0: vb; 1, 2, 3: G's hi, mid, lo
      const float* src = (part == 0 ? vals : g) + pix * NV;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int m = 4 * ((q - 16) & 3) + k;  // values 2m, 2m + 1
        const float e0 = 2 * m < NV ? __ldg(src + 2 * m) : 0.f;
        const float e1 = 2 * m + 1 < NV ? __ldg(src + 2 * m + 1) : 0.f;
        o[k] = part == 0 ? pack_bf16(e0, e1)
                         : pack_bf16(bf16_part(e0, part - 1),
                                     bf16_part(e1, part - 1));
      }
    } else {
      float s = __fadd_rn(sq8(__ldg(kp), __ldg(kp + 1)),
                          sq8(__ldg(kp + 2), __ldg(kp + 3)));
      s = __fadd_rn(s, sq8(__ldg(kp + 4), __ldg(kp + 5)));
      o[0] = __float_as_uint(__fadd_rn(s, sq8(__ldg(kp + 6), __ldg(kp + 7))));
    }
  }
  recs[t] = make_uint4(o[0], o[1], o[2], o[3]);
}

// The records of the image, B x h x wp keys (wp = w rounded up to whole
// chunks), key row ky_lo + r of the block's window in ring buffer r %
// NSTAGE from column kx_lo (a multiple of CHUNK), whole chunks.
__global__ void __launch_bounds__(GN_THREADS, 1)
gn_window_aggregate_backward_bf16_kernel(const float* __restrict__ ae,
                                         const float* __restrict__ vals,
                                         const float* __restrict__ g,
                                         const unsigned* __restrict__ recs,
                                         float* __restrict__ dae,
                                         float* __restrict__ dvals, int h,
                                         int w, int R) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int slot = wid % NS;                // which chunks of a row
  const int gq = lane >> 2, c = lane & 3;   // mma group and thread in group
  const int x0 = blockIdx.x * QX, qy0 = blockIdx.y * QY, b = blockIdx.z;
  const int qy = qy0 + wid / NS;            // the warp's query row (m-tile)
  const long long plane = (long long)b * h * w;
  const int wp = (w + CHUNK - 1) & ~(CHUNK - 1);

  const int kx_lo = max(x0 - R, 0), kx_hi = min(x0 + QX - 1 + R, w - 1);
  const int nk = kx_hi - kx_lo + 1, nchunks = (nk + CHUNK - 1) / CHUNK;
  const int ky_lo = max(qy0 - R, 0), ky_hi = min(qy0 + QY - 1 + R, h - 1);
  const int nrows = ky_hi - ky_lo + 1;
  const int stage = gn_row_keys(R) * KREC;  // words of a ring buffer
  unsigned* ring = reinterpret_cast<unsigned*>(smem);

  __shared__ __align__(8) unsigned long long bars[NSTAGE];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < NSTAGE; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // row r's records, one bulk copy asked for by one thread
  auto request = [&](int r) {
    const unsigned bar = smem_u32(&bars[r % NSTAGE]);
    const unsigned bytes = (unsigned)(nchunks * CHUNK * KREC) * 4u;
    fence_async_proxy();
    mbar_expect(bar, bytes);
    bulk_copy(ring + (r % NSTAGE) * stage,
              recs + (((long long)b * h + ky_lo + r) * wp + kx_lo) * KREC,
              bytes, bar);
  };
  if (tid == 0) {
    request(0);
    if (nrows > 1) request(1);
  }

  // This lane's two queries, columns gq and gq + 8 of the warp's row (one
  // outside the image reads the block's first and keeps no key): Q as
  // split TF32 A fragments; vb_q as p2's bf16 A fragments (k-step t,
  // register i + 2 hk: column gq + 8 i, values 16 t + 8 hk + 2c and + 1);
  // G_q's three parts as p1's, in shared memory (the same for the NS
  // warps of an m-tile): part p, k-step t is 16-byte word 2p + t of a
  // lane's 7, so a quarter warp meets 8 bank groups.
  __shared__ __align__(16) unsigned gqs[QY][32][28];
  const uint4* gq4 = reinterpret_cast<const uint4*>(gqs[wid / NS][lane]);
  unsigned qh[4][4], ql[4][4], vq[2][4];
  float qsq[2];
  int dlo[2], dhi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qx = x0 + gq + 8 * i;
    const bool inside = qx < w && qy < h;
    const long long qi =
        plane + (long long)(inside ? qy : qy0) * w + (inside ? qx : x0);
    const float4* qp = reinterpret_cast<const float4*>(ae + qi * AC);
    qsq[i] = __fadd_rn(__fadd_rn(__fadd_rn(sq8(qp[0], qp[1]), sq8(qp[2], qp[3])),
                                 sq8(qp[4], qp[5])), sq8(qp[6], qp[7]));
    dlo[i] = inside ? max(qx - R, 0) - kx_lo : 1 << 30;
    dhi[i] = inside ? min(qx + R, w - 1) - kx_lo : -1;
    const float4 lo4 = qp[c], hi4 = qp[4 + c];
    const float* a = reinterpret_cast<const float*>(&lo4);
    const float* a4 = reinterpret_cast<const float*>(&hi4);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      split_tf32(a[s], qh[s][i], ql[s][i]);
      split_tf32(a4[s], qh[s][2 + i], ql[s][2 + i]);
    }
    const float* gp = g + qi * NV;
    const float* vp = vals + qi * NV;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
        const int v0 = 16 * t + 8 * hk + 2 * c;
        const float e0 = v0 < NV ? __ldg(vp + v0) : 0.f;
        const float e1 = v0 + 1 < NV ? __ldg(vp + v0 + 1) : 0.f;
        vq[t][i + 2 * hk] = pack_bf16(e0, e1);
        if (slot == 0) {
          const float g0 = v0 < NV ? __ldg(gp + v0) : 0.f;
          const float g1 = v0 + 1 < NV ? __ldg(gp + v0 + 1) : 0.f;
#pragma unroll
          for (int p = 0; p < 3; ++p)
            gqs[wid / NS][lane][(2 * p + t) * 4 + i + 2 * hk] =
                pack_bf16(bf16_part(g0, p), bf16_part(g1, p));
        }
      }
  }
  auto window_bits = [&](int t0) {
    unsigned keep = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * i + 2 * c + (e & 1);
        keep |= (unsigned)(t >= dlo[e >> 1] && t <= dhi[e >> 1]) << (4 * i + e);
      }
    return keep;
  };
  const unsigned keep0 = window_bits(slot * CHUNK);

  // dvals and U A: value / channel 8c + j (e 0, 2) and 8c + 4 + j (e 1, 3)
  // of columns gq (e 0, 1) and gq + 8 (e 2, 3); rowsum(U) of both columns
  float av[4][4], aa[4][4], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[j][e] = aa[j][e] = 0.f;
  __syncthreads();  // gqs written

  for (int r = 0; r < nrows; ++r) {
    if (tid == 0 && r + 2 < nrows) request(r + 2);
    mbar_wait(smem_u32(&bars[r % NSTAGE]), (r / NSTAGE) & 1);
    const int ky = ky_lo + r;
    if (qy < h && ky >= qy - R && ky <= qy + R) {
      const unsigned* row = ring + (r % NSTAGE) * stage;
      for (int p = slot; p < nchunks; p += NS) {
        const int t0 = p * CHUNK;
        const unsigned keep = p == slot ? keep0 : window_bits(t0);
        unsigned pa[4];  // the chunk's bf16 scores, S G's A fragment
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // the chunk's two 8-key tiles
          const int tb = t0 + 8 * i;
          // S = Q K^T: key tb + gq, channels 4c .. 4c + 3, 16 + 4c ..
          const unsigned* kr = row + (tb + gq) * KREC;
          const uint4 h0 = *reinterpret_cast<const uint4*>(kr + KR_HI + 4 * c);
          const uint4 h1 = *reinterpret_cast<const uint4*>(kr + KR_HI + 16 + 4 * c);
          const uint4 l0 = *reinterpret_cast<const uint4*>(kr + KR_LO + 4 * c);
          const uint4 l1 = *reinterpret_cast<const uint4*>(kr + KR_LO + 16 + 4 * c);
          const unsigned kh0[4] = {h0.x, h0.y, h0.z, h0.w};
          const unsigned kh1[4] = {h1.x, h1.y, h1.z, h1.w};
          const unsigned kl0[4] = {l0.x, l0.y, l0.z, l0.w};
          const unsigned kl1[4] = {l1.x, l1.y, l1.z, l1.w};
          float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f},
                bg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            mma_tf32(s1, ql[s], kh0[s], kh1[s]);
            mma_tf32(s2, qh[s], kl0[s], kl1[s]);
            mma_tf32(bg, qh[s], kh0[s], kh1[s]);
          }
          // P: p1 = G_q.vb_k, p2 = vb_q.G_k, G's parts lo first; k-step t
          // takes values 16t .. 16t + 15, pair words 8t + c and 8t + c + 4
          float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f};
          // CUTOUT p {
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const unsigned b0 = kr[KR_VB + 8 * t + c];
            const unsigned b1 = kr[KR_VB + 8 * t + 4 + c];
#pragma unroll
            for (int pp = 2; pp >= 0; --pp) {
              const uint4 ga = gq4[2 * pp + t];
              const unsigned af[4] = {ga.x, ga.y, ga.z, ga.w};
              mma_bf16(p1, af, b0, b1);
              mma_bf16(p2, vq[t], kr[KR_G + 16 * pp + 8 * t + c],
                       kr[KR_G + 16 * pp + 8 * t + 4 + c]);
            }
          }
          // CUTOUT p }
          // s and u of (column gq | gq + 8) x (key tb + 2c | tb + 2c + 1)
          const float kn0 = __uint_as_float(row[(tb + 2 * c) * KREC + KR_SQ]);
          const float kn1 =
              __uint_as_float(row[(tb + 2 * c + 1) * KREC + KR_SQ]);
          float sv[4], uv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float S = __fadd_rn(__fadd_rn(s1[e], s2[e]), bg[e]);
            const float logit = __fsub_rn(__fmaf_rn(2.0f, S, -qsq[e >> 1]),
                                          (e & 1) ? kn1 : kn0);
            // CUTOUT sigmoid {
            sv[e] = (keep >> (4 * i + e)) & 1 ? sigmoid_fast(logit) : 0.f;
            const float d = __fmul_rn(sv[e], __fsub_rn(1.0f, sv[e]));
            uv[e] = __fadd_rn(__fmul_rn(bf16r(p1[e]), d),
                              __fmul_rn(bf16r(p2[e]), d));
            // CUTOUT sigmoid }
          }
          rs[0] = __fadd_rn(__fadd_rn(rs[0], uv[0]), uv[1]);
          rs[1] = __fadd_rn(__fadd_rn(rs[1], uv[2]), uv[3]);
          // the tile's scores rounded to bf16: rows gq, gq + 8, keys 2c,
          // 2c + 1 of the chunk's k-indices 8i ..
          pa[2 * i] = pack_bf16(sv[0], sv[1]);
          pa[2 * i + 1] = pack_bf16(sv[2], sv[3]);
          // U A_k: the columns (2c, 2c + 1) a lane holds are k-indices (c,
          // c + 4); keys tb + 2c and tb + 2c + 1, channel 4gq + j of n-tile j
          unsigned uh[4], ul[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(uv[(e & 1) * 2 + (e >> 1)], uh[e], ul[e]);
          const unsigned* ka0 = row + (tb + 2 * c) * KREC + 4 * gq;
          const unsigned* ka1 = ka0 + KREC;
          const uint4 x0h = *reinterpret_cast<const uint4*>(ka0 + KR_HI);
          const uint4 x1h = *reinterpret_cast<const uint4*>(ka1 + KR_HI);
          const uint4 x0l = *reinterpret_cast<const uint4*>(ka0 + KR_LO);
          const uint4 x1l = *reinterpret_cast<const uint4*>(ka1 + KR_LO);
          const unsigned xh0[4] = {x0h.x, x0h.y, x0h.z, x0h.w};
          const unsigned xh1[4] = {x1h.x, x1h.y, x1h.z, x1h.w};
          const unsigned xl0[4] = {x0l.x, x0l.y, x0l.z, x0l.w};
          const unsigned xl1[4] = {x1l.x, x1l.y, x1l.z, x1l.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float q[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(q, ul, xh0[j], xh1[j]);
            mma_tf32(q, uh, xl0[j], xl1[j]);
            mma_tf32(q, uh, xh0[j], xh1[j]);
#pragma unroll
            for (int e = 0; e < 4; ++e) aa[j][e] = __fadd_rn(aa[j][e], q[e]);
          }
        }
        // dvals += S G_k over the chunk (k = its 16 keys): B holds keys
        // (2c, 2c + 1) and (2c + 8, 2c + 9) at value 4gq + j of n-tile j,
        // G's parts lo first; each key's values 4gq .. 4gq + 3 are one
        // 8-byte load a part, and a byte permute pairs two keys' values
        const unsigned* kg0 = row + (t0 + 2 * c) * KREC + KR_G + 2 * gq;
        float dd[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dd[j][e] = 0.f;
#pragma unroll
        for (int pp = 2; pp >= 0; --pp) {
          const uint2 w0 = *reinterpret_cast<const uint2*>(kg0 + 16 * pp);
          const uint2 w1 = *reinterpret_cast<const uint2*>(kg0 + KREC + 16 * pp);
          const uint2 w8 = *reinterpret_cast<const uint2*>(kg0 + 8 * KREC + 16 * pp);
          const uint2 w9 = *reinterpret_cast<const uint2*>(kg0 + 9 * KREC + 16 * pp);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const unsigned sel = (j & 1) ? 0x7632u : 0x5410u;
            const unsigned b0 = __byte_perm(j < 2 ? w0.x : w0.y,
                                            j < 2 ? w1.x : w1.y, sel);
            const unsigned b1 = __byte_perm(j < 2 ? w8.x : w8.y,
                                            j < 2 ? w9.x : w9.y, sel);
            mma_bf16(dd[j], pa, b0, b1);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) av[j][e] = __fadd_rn(av[j][e], dd[j][e]);
      }
    }
    __syncthreads();
  }

  // CUTOUT sums {
  // rowsum(U) over the group's four lanes, then the partials of each query
  // in a fixed order; reuses the ring
  rs[0] = __fadd_rn(rs[0], __shfl_xor_sync(0xffffffffu, rs[0], 1));
  rs[0] = __fadd_rn(rs[0], __shfl_xor_sync(0xffffffffu, rs[0], 2));
  rs[1] = __fadd_rn(rs[1], __shfl_xor_sync(0xffffffffu, rs[1], 1));
  rs[1] = __fadd_rn(rs[1], __shfl_xor_sync(0xffffffffu, rs[1], 2));
  float* red = smem;  // [QY * NS][QX][BRB]: dvals 0 .., U A 32 .., rowsum 64
  float* r0 = red + (wid * QX + gq) * BRB;
  float* r8 = r0 + 8 * BRB;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r0[8 * c + j] = av[j][0];
    r0[8 * c + 4 + j] = av[j][1];
    r8[8 * c + j] = av[j][2];
    r8[8 * c + 4 + j] = av[j][3];
    r0[32 + 8 * c + j] = aa[j][0];
    r0[32 + 8 * c + 4 + j] = aa[j][1];
    r8[32 + 8 * c + j] = aa[j][2];
    r8[32 + 8 * c + 4 + j] = aa[j][3];
  }
  if (c == 0) {
    r0[64] = rs[0];
    r8[64] = rs[1];
  }
  __syncthreads();
  for (int e = tid; e < QY * QX * (NV + AC); e += GN_THREADS) {
    const int q = e / (NV + AC), v = e % (NV + AC);
    const int oy = qy0 + q / QX, ox = x0 + q % QX;
    if (oy >= h || ox >= w) continue;
    const float* part = red + ((q / QX) * NS * QX + q % QX) * BRB;
    const long long o = plane + (long long)oy * w + ox;
    if (v < NV) {
      // slot n's chunk is in block (kx_lo + 16 n) / 32, one of the tile's
      // block m - 1, m, m + 1 (lo, mid, hi); slots past the row's chunks
      // hold 0
      float lo = 0.f, mid = 0.f, hi = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int k = ((kx_lo + n * CHUNK) >> 5) - (x0 >> 5);
        const float pv = part[n * QX * BRB + v];
        if (k < 0) lo = __fadd_rn(lo, pv);
        else if (k == 0) mid = __fadd_rn(mid, pv);
        else hi = __fadd_rn(hi, pv);
      }
      dvals[o * NV + v] =
          __fadd_rn(__fadd_rn(bf16r(hi), bf16r(mid)), bf16r(lo));
    } else {
      const int ch = v - NV;
      float ua = part[32 + ch], u = part[64];
#pragma unroll
      for (int n = 1; n < NS; ++n) {
        ua = __fadd_rn(ua, part[n * QX * BRB + 32 + ch]);
        u = __fadd_rn(u, part[n * QX * BRB + 64]);
      }
      // dae = -2 (rowsum(U) a - U A)
      dae[o * AC + ch] =
          __fmul_rn(-2.0f, __fsub_rn(__fmul_rn(u, __ldg(ae + o * AC + ch)), ua));
    }
  }
  // CUTOUT sums }
}

// dae (B, h, w, 32) and dvals (B, h, w, 27) are written in full.
extern "C" int gn_window_aggregate_backward_launch(
    const void* ae, const void* vals, const void* g, void* dae, void* dvals,
    int B, int h, int w, int R, void* stream) {
  if (B == 0 || h == 0 || w == 0) return 0;
  if (R < 0) return (int)cudaErrorInvalidValue;
  size_t bytes = (size_t)NSTAGE * gn_stage_floats(R, 2) * sizeof(float);
  const size_t reduce = (size_t)QY * NS * QX * BR * sizeof(float);
  if (reduce > bytes) bytes = reduce;
  cudaError_t err = cudaFuncSetAttribute(
      gn_window_aggregate_backward_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid = gn_grid(B, h, w);
  gn_window_aggregate_backward_kernel<<<grid, GN_THREADS, bytes,
                                        (cudaStream_t)stream>>>(
      (const float*)ae, (const float*)vals, (const float*)g, (float*)dae,
      (float*)dvals, h, w, R);
  return (int)cudaGetLastError();
}

// The bf16-score form; R must be 32.  ``recs`` is the wrapper's scratch
// for the key records, B * h * round_up(w, 16) * KREC 32-bit words: the
// pre-pass writes it, then the main kernel reads it, on ``stream``.
extern "C" int gn_window_aggregate_backward_bf16_launch(
    const void* ae, const void* vals, const void* g, void* recs, void* dae,
    void* dvals, int B, int h, int w, int R, void* stream) {
  if (B == 0 || h == 0 || w == 0) return 0;
  if (R != 32) return (int)cudaErrorInvalidValue;
  const int wp = (w + CHUNK - 1) & ~(CHUNK - 1);
  const long long nquads = (long long)B * h * wp * (KREC / 4);
  // CUTOUT keys {
  gn_backward_bf16_keys_kernel<<<(unsigned)((nquads + 255) / 256), 256, 0,
                                 (cudaStream_t)stream>>>(
      (const float*)ae, (const float*)vals, (const float*)g, (uint4*)recs,
      nquads, w, wp);
  // CUTOUT keys }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t bytes = (size_t)NSTAGE * gn_row_keys(R) * KREC * sizeof(unsigned);
  const size_t reduce = (size_t)QY * NS * QX * BRB * sizeof(float);
  if (reduce > bytes) bytes = reduce;
  err = cudaFuncSetAttribute(gn_window_aggregate_backward_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid = gn_grid(B, h, w);
  gn_window_aggregate_backward_bf16_kernel<<<grid, GN_THREADS, bytes,
                                             (cudaStream_t)stream>>>(
      (const float*)ae, (const float*)vals, (const float*)g,
      (const unsigned*)recs, (float*)dae, (float*)dvals, h, w, R);
  return (int)cudaGetLastError();
}

// registers a thread and local (spilled) bytes of the backward's form
extern "C" int gn_window_aggregate_backward_attributes(int bf16, int* regs,
                                                       int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = bf16 ? cudaFuncGetAttributes(
                               &a, gn_window_aggregate_backward_bf16_kernel)
                         : cudaFuncGetAttributes(
                               &a, gn_window_aggregate_backward_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
