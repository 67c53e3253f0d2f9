// Windowed sigmoid-attention aggregation of the 27-value GN field, shared
// by gn_fused.cu (aggregate + damp + solve) and gn_window.cu (aggregate
// only), sm_90a, on the tensor cores (mma.sync).
//
//   agg_i = sum_j sigmoid(2 q_i.k_j - |q_i|^2 - |k_j|^2) * vals_j,
//           |dy|, |dx| <= R,   q = k = ae
//
// The work is two small matrix products around a sigmoid, S = Q K^T
// (queries x 32 channels x keys) and A = sigmoid(S) V (keys x 27 values).
//
// Tile.  A block takes QX = 16 query columns of QY = 2 rows: one 16-row mma
// tile (m-tile) a row.  A narrow tile keeps the staged window useful: 2R+1
// of the 2R+16 staged columns lie in each query's window (81 % at R = 32),
// and the two rows share every staged key row but the first and the last.
// Each m-tile has NS = 5 warps, which take the 16-key chunks of a staged
// row in turn (5 chunks a row at R = 32); only chunks that reach past a
// query's window, at both ends of a row, test |kx - qx| <= R.  Ten warps at
// 96 registers let two blocks share an SM; with two m-tiles a warp, sharing
// the key fragments, the operation count fell by a third and the time rose
// (0.140 against 0.127 ms at 48x160, NVIDIA H100 80GB HBM3, 700.00 W): the
// warps, not the count, hide the mma's latency.
//
// Ring.  Key rows go through NSTAGE = 3 shared-memory buffers.  One thread
// asks the copy engine (cp.async.bulk on an mbarrier) for a row: the
// embeddings of its keys are one run of memory, and so are their 27-float
// values, which are taken from the 16-byte boundary below their first float
// (a key's values are 108 bytes).  Row r+2 is on its way and row r+1 gets
// its squared norms while row r computes: one __syncthreads a row.  (Copies
// by the threads themselves, cp.async of 16 and 4 bytes, cost a third of
// the kernel's time.)
//
// Products.  f32 accuracy on TF32 tensor cores by splitting: x = hi + lo,
// a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (3xTF32; lo.lo, 2^-22 of the
// product, is below the f32 rounding of the logit itself, see
// tests/test_torch_gn.py).  Q is split once a kernel and held as A
// fragments in registers; K and V are split as their fragments are loaded.
// logit = 2 S - |q|^2 - |k|^2 with the f32 norms subtracted outside the
// product, as in the oracle; the sigmoid runs on the accumulator fragment
// in registers, which then is the A operand of the second product: the
// column pair (2c, 2c+1) a lane holds of S becomes k-indices (c, c+4) of
// m16n8k8, and V's rows are loaded in that order, so nothing is shuffled.
// With BF16 the score and the value are rounded to bf16 (round to nearest
// even) and two 8-key tiles are one m16n8k16 A fragment; products of bf16
// values are exact in the f32 accumulator, as in the plain version.
//
// Sums.  The NS partials of each query are added in a fixed order in shared
// memory, so a launch gives the same bits every time.
//
// What bounds it.  mma.sync's TF32 m16n8k8 takes ~12 cycles of an SM
// sub-core here (about 150 TFLOP/s over the card, a third of the wgmma
// peak), and a 16x8 tile of pairs needs 24 of them (bf16 scores: 14) beside
// ~170 other operations (split, sigmoid, masks, fragment loads), which
// overlap only in part.  wgmma's 64-row tile as four rows of 16 columns
// would mask no more than this tiling; it needs K and V^T split in shared
// memory in its own layouts, and is left open.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define AC 32      // embedding channels
#define NV 27      // 21 packed H entries + 6 b entries
#define QX 16      // query columns of a block: the rows of an mma tile
#define QY 2       // query rows of a block: one m-tile each
#define NS 5       // warps of an m-tile, splitting the chunks of a key row
#define CHUNK 16   // keys a warp takes at a time: two 8-key mma tiles
#define NSTAGE 3   // ring of staged key rows
#define GN_THREADS (32 * QY * NS)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// mbarrier and bulk-copy (TMA) wrappers: one thread asks for a whole row,
// the copy engine moves it and counts its bytes on the barrier
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ``bytes`` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory, counted on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// orders this thread's earlier shared-memory accesses before later copies
// of the copy engine
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x = hi + lo for the TF32 tensor cores.  hi is x rounded to TF32 (10
// mantissa bits, to nearest, ties away): what cvt.rna.tf32.f32 gives, bit
// for bit on finite values, in two integer operations; the cvt runs at a
// quarter of their rate and cost a fifth of the kernel's time.  lo = x - hi
// is exact in f32 and is rounded the same way, which leaves 2^-23 of x.
// (Handed over whole, the tensor cores cut its 13 low bits: 2^-21 of x.
// Sums that agree with the plain version's to 1e-6 either way then moved a
// streamed frame's fused disparity, through the model's near-ties, on ten
// times as many pixels as the CUDA-core kernel before this one had.)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
  lo = (lo + 0x1000u) & 0xffffe000u;
}

// 1 / (1 + e^-x): ex2.approx (2 ulp), then rcp.approx refined by one Newton
// step to within an ulp of the rounded quotient the plain version takes
// (rcp.approx alone is the other half of the note above).  The clamp keeps
// an overflowed e^-x from turning 0 x inf into NaN in the step.
__device__ __forceinline__ float sigmoid_fast(float x) {
  float e, s;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(x * -1.4426950408889634f));
  e = fminf(1.0f + e, 3.0e38f);
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(s) : "f"(e));
  return __fmaf_rn(s, __fmaf_rn(-e, s, 1.0f), s);
}

// d += a b, a 16x8 (row), b 8x8 (col), TF32 operands, f32 sum
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, a 16x16 (row), b 16x8 (col), bf16 operands, f32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16, lo in the lower half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}

// sum of squares of 8 channels, in order
__device__ __forceinline__ float sq8(float4 a, float4 b) {
  float s = __fmul_rn(a.x, a.x);
  s = __fadd_rn(s, __fmul_rn(a.y, a.y));
  s = __fadd_rn(s, __fmul_rn(a.z, a.z));
  s = __fadd_rn(s, __fmul_rn(a.w, a.w));
  s = __fadd_rn(s, __fmul_rn(b.x, b.x));
  s = __fadd_rn(s, __fmul_rn(b.y, b.y));
  s = __fadd_rn(s, __fmul_rn(b.z, b.z));
  return __fadd_rn(s, __fmul_rn(b.w, b.w));
}

// keys a staged row can hold: whole chunks
__host__ __device__ inline int gn_row_keys(int R) {
  return (QX + 2 * R + CHUNK - 1) & ~(CHUNK - 1);
}

// floats of one staged row: [KW][AC] embeddings, then nval runs of the
// keys' 27 values (vals; the backward also stages the sums' cotangent G),
// each with room for the row's offset from a 16-byte boundary and for the
// last key's read of 32 columns, then [KW] squared norms
__host__ __device__ inline int gn_stage_floats(int R, int nval = 1) {
  return gn_row_keys(R) * (AC + nval * NV + 1) + 8 * nval;
}

// dynamic shared memory a block needs: the ring of staged rows, reused for
// the cross-warp reduction (every warp's 16 x 32 partials, then the block's
// 32 x 27 sums)
inline size_t gn_smem_bytes(int R) {
  size_t ring = (size_t)NSTAGE * gn_stage_floats(R) * sizeof(float);
  size_t reduce = (size_t)(QY * NS * QX * 32 + QY * QX * NV) * sizeof(float);
  return ring > reduce ? ring : reduce;
}

inline dim3 gn_grid(int B, int h, int w) {
  return dim3((w + QX - 1) / QX, (h + QY - 1) / QY, B);
}

// Every thread of the block calls this.  For each query inside the image,
// one thread ends in ``epilogue(a, b, qy, qx)`` with the 27 sums of query
// (b, qy, qx) in a[].
template <bool BF16, class Epilogue>
__device__ __forceinline__ void gn_window_sums(const float* __restrict__ ae,
                                               const float* __restrict__ vals,
                                               float* smem, int h, int w,
                                               int R, Epilogue epilogue) {
  const int KW = gn_row_keys(R);
  const int stage = gn_stage_floats(R);
  const int ksq_at = KW * (AC + NV) + 8;  // the norms' place in a stage

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int slot = wid % NS;              // which chunks of a row
  const int g = lane >> 2, c = lane & 3;  // mma group and thread in group
  const int x0 = blockIdx.x * QX, qy0 = blockIdx.y * QY, b = blockIdx.z;
  const int qy = qy0 + wid / NS;          // the warp's query row (m-tile)
  const long long plane = (long long)b * h * w;

  const int kx_lo = max(x0 - R, 0), kx_hi = min(x0 + QX - 1 + R, w - 1);
  const int nk = kx_hi - kx_lo + 1, nchunks = (nk + CHUNK - 1) / CHUNK;
  const int ky_lo = max(qy0 - R, 0), ky_hi = min(qy0 + QY - 1 + R, h - 1);
  const int nrows = ky_hi - ky_lo + 1;

  // One barrier a ring buffer counts the bytes of the row that lands there.
  __shared__ __align__(8) unsigned long long bars[NSTAGE];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < NSTAGE; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Zero the ring: the keys of a last, partial chunk are never written and
  // have to stay finite (0 x NaN).
  for (int e = tid; e < NSTAGE * stage / 4; e += GN_THREADS)
    reinterpret_cast<float4*>(smem)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  fence_async_proxy();
  __syncthreads();

  // Key row r into its ring buffer, asked for by one thread: the embeddings
  // of its nk keys are one run of memory, and so are their values, taken
  // from the 16-byte boundary below their first float, which lands ``off``
  // floats into the buffer.  Only the last floats of the whole array may
  // have no full 16 bytes left; those the thread copies itself.
  const long long vals_end = (long long)gridDim.z * h * w * NV;
  auto request = [&](int r) {
    float* buf = smem + (r % NSTAGE) * stage;
    const unsigned bar = smem_u32(&bars[r % NSTAGE]);
    const long long at = plane + (long long)(ky_lo + r) * w + kx_lo;
    const int off = (int)((at * NV) & 3);
    const float* vsrc = vals + (at * NV - off);
    const long long room = vals_end - (at * NV - off);
    const int want = off + nk * NV;  // floats up to the row's last value
    const int whole = (int)min((long long)((want + 3) & ~3), room & ~3LL);
    float* kval = buf + KW * AC;
    fence_async_proxy();
    mbar_expect(bar, (unsigned)(nk * AC + whole) * 4u);
    bulk_copy(buf, ae + at * AC, (unsigned)(nk * AC) * 4u, bar);
    if (whole > 0) bulk_copy(kval, vsrc, (unsigned)whole * 4u, bar);
    for (int i = whole; i < want; ++i) kval[i] = vsrc[i];
  };
  // squared norms of a landed row: four threads a key, 8 channels each in
  // order, then ((p0 + p1) + p2) + p3
  auto prepare = [&](int r) {
    float* buf = smem + (r % NSTAGE) * stage;
    for (int base = 0; base < nk; base += GN_THREADS / 4) {
      int k = base + (tid >> 2), part = tid & 3;
      float p = 0.f;
      if (k < nk) {
        const float4* kp = reinterpret_cast<const float4*>(buf + k * AC);
        p = sq8(kp[2 * part], kp[2 * part + 1]);
      }
      float s = __fadd_rn(p, __shfl_down_sync(0xffffffffu, p, 1));
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, p, 2));
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, p, 3));
      if (k < nk && part == 0) buf[ksq_at + k] = s;
    }
  };

  if (tid == 0) {
    request(0);
    if (nrows > 1) request(1);
  }

  // This lane's two queries: columns g and g + 8 of the warp's row.  A
  // query outside the image reads the block's first one and keeps no key.
  unsigned qh[4][4], ql[4][4];  // A fragments of Q, four k-steps
  float qsq[2];
  int dlo[2], dhi[2];  // staged columns of a row inside the query's window
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qx = x0 + g + 8 * i;
    const bool inside = qx < w && qy < h;
    const float4* qp = reinterpret_cast<const float4*>(
        ae + (plane + (long long)(inside ? qy : qy0) * w + (inside ? qx : x0)) * AC);
    qsq[i] = __fadd_rn(__fadd_rn(__fadd_rn(sq8(qp[0], qp[1]), sq8(qp[2], qp[3])),
                                 sq8(qp[4], qp[5])), sq8(qp[6], qp[7]));
    dlo[i] = inside ? max(qx - R, 0) - kx_lo : 1 << 30;
    dhi[i] = inside ? min(qx + R, w - 1) - kx_lo : -1;
    // channel 4c + s is k-index c of k-step s, channel 16 + 4c + s is c + 4:
    // a key's fragment is then two float4 loads
    const float4 lo4 = qp[c], hi4 = qp[4 + c];
    const float* a = reinterpret_cast<const float*>(&lo4);
    const float* a4 = reinterpret_cast<const float*>(&hi4);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      split_tf32(a[s], qh[s][i], ql[s][i]);
      split_tf32(a4[s], qh[s][2 + i], ql[s][2 + i]);
    }
  }
  // Which of this lane's 8 scores of the chunk at staged column t0 lie in
  // their query's window: bit 4i + e for score e of tile i.  It is the same
  // for every key row, so the warp's first chunk (its only one while a row
  // has no more than NS) gets it here, once.
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

  float acc[4][4];  // value 8c + j (and 8c + 4 + j) of columns g (and g + 8)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  mbar_wait(smem_u32(&bars[0]), 0);
  prepare(0);
  __syncthreads();

  // Row r computes while row r + 2 is on its way and row r + 1, asked for an
  // iteration ago, gets its norms; the barrier that ends r hands r + 1 over
  // and frees r's buffer for row r + 3.
  for (int r = 0; r < nrows; ++r) {
    if (tid == 0 && r + 2 < nrows) request(r + 2);
    if (r + 1 < nrows) {
      mbar_wait(smem_u32(&bars[(r + 1) % NSTAGE]), ((r + 1) / NSTAGE) & 1);
      prepare(r + 1);
    }
    const int ky = ky_lo + r;
    if (qy < h && ky >= qy - R && ky <= qy + R) {
      const float* kae = smem + (r % NSTAGE) * stage;
      const float* kval =  // the row's values, past its 16-byte offset
          kae + KW * AC + (int)(((plane + (long long)ky * w + kx_lo) * NV) & 3);
      const float* ksq = kae + ksq_at;
      for (int p = slot; p < nchunks; p += NS) {
        const int t0 = p * CHUNK;
        const unsigned keep = p == slot ? keep0 : window_bits(t0);
        unsigned pa[4], vb[2][4];  // BF16: the chunk's scores and values
        // f32: the chunk's own sums.  The tensor cores truncate where they
        // add to the accumulator, so a sum carried over thousands of mma
        // would drift low by ~1e-5 of itself; six a chunk do not, and the
        // chunk joins the running sum by IEEE adds.
        float d[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // the chunk's two 8-key tiles
          const int tb = t0 + 8 * i;
          // S = Q K^T in three independent sums: lo.hi, hi.lo, hi.hi.
          // K: key tb + g, channels 4c .. 4c + 3 and 16 + 4c .. 16 + 4c + 3.
          const float4* kp = reinterpret_cast<const float4*>(kae + (tb + g) * AC);
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
          // scores of (column g | g + 8) x (key tb + 2c | tb + 2c + 1)
          const float2 kn = *reinterpret_cast<const float2*>(ksq + tb + 2 * c);
          float P[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float S = __fadd_rn(__fadd_rn(s1[e], s2[e]), bg[e]);
            float logit = __fsub_rn(__fmaf_rn(2.0f, S, -qsq[e >> 1]),
                                    (e & 1) ? kn.y : kn.x);
            P[e] = (keep >> (4 * i + e)) & 1 ? sigmoid_fast(logit) : 0.f;
          }
          // V: keys tb + 2c and tb + 2c + 1, columns 4g .. 4g + 3, one for
          // each of the four n-tiles.  Columns 27 .. 31 read the next key's
          // values and feed sums that are dropped.
          const float* vp = kval + (tb + 2 * c) * NV + 4 * g;
          if (BF16) {
            pa[2 * i] = pack_bf16(P[0], P[1]);
            pa[2 * i + 1] = pack_bf16(P[2], P[3]);
#pragma unroll
            for (int j = 0; j < 4; ++j) vb[i][j] = pack_bf16(vp[j], vp[NV + j]);
          } else {
            // S's columns (2c, 2c + 1) are k-indices (c, c + 4) here
            unsigned ph[4], pl[4];
            split_tf32(P[0], ph[0], pl[0]);
            split_tf32(P[2], ph[1], pl[1]);
            split_tf32(P[1], ph[2], pl[2]);
            split_tf32(P[3], ph[3], pl[3]);
            unsigned vh[4][2], vl[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              split_tf32(vp[j], vh[j][0], vl[j][0]);
              split_tf32(vp[NV + j], vh[j][1], vl[j][1]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_tf32(d[j], pl, vh[j][0], vh[j][1]);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_tf32(d[j], ph, vl[j][0], vl[j][1]);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_tf32(d[j], ph, vh[j][0], vh[j][1]);
          }
        }
        if (BF16) {
          // one mma a chunk on the running sum: ~50 in a row drift by 1e-6
          // of it, far inside what bf16 scores allow
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[j], pa, vb[0][j], vb[1][j]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], d[j][e]);
        }
      }
    }
    __syncthreads();
  }

  // fixed-order sum of the NS partials of each m-tile; reuses the ring
  // (every warp is past the last barrier of the loop)
  float* red = smem;                       // [QY * NS][QX][32]
  float* sums = smem + QY * NS * QX * 32;  // [QY * QX][NV]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[(wid * QX + g) * 32 + 8 * c + j] = acc[j][0];
    red[(wid * QX + g) * 32 + 8 * c + 4 + j] = acc[j][1];
    red[(wid * QX + g + 8) * 32 + 8 * c + j] = acc[j][2];
    red[(wid * QX + g + 8) * 32 + 8 * c + 4 + j] = acc[j][3];
  }
  __syncthreads();
  for (int e = tid; e < QY * QX * NV; e += GN_THREADS) {
    const int q = e / NV, v = e % NV;
    const float* part = red + ((q / QX) * NS * QX + q % QX) * 32 + v;
    float s = part[0];
#pragma unroll
    for (int n = 1; n < NS; ++n) s = __fadd_rn(s, part[n * QX * 32]);
    sums[e] = s;
  }
  __syncthreads();
  if (tid >= QY * QX) return;
  const int oy = qy0 + tid / QX, ox = x0 + tid % QX;
  if (oy >= h || ox >= w) return;
  float a[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) a[v] = sums[tid * NV + v];
  epilogue(a, b, oy, ox);
}
