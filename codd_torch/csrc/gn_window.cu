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
// the operand splits or the P product cut out ran markedly faster.
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
  // lo are two
  // 16-byte words, a lane's 14 of them 60 words after the last lane's: the
  // 8 lanes of a quarter warp meet 8 different bank groups.
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
            const float P = __fadd_rn(__fadd_rn(p1[e], p2[e]), pg[e]);
            uv[e] = __fmul_rn(__fmul_rn(sv[e], __fsub_rn(1.0f, sv[e])), P);
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
