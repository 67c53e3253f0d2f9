// Windowed lookup in one level of the bf16 correlation volume, sm_90a.
//
// Replaces the slab gather + codd_tpu/ops/pallas/corr_select.py:
// window_select + bilinear combine of codd_tpu/ops/corr.py
// (_lookup_level_volume, select="reduce").  One thread per (query n, output
// row yy): it clamps the query's window start (_window_starts), reads the
// two tap rows yy, yy+1 (t = 2r+2 bf16 each) straight from
// vol[b, n, sy + yy + {0,1}, sx + k], zeroes them when the whole window is
// outside the level (vq), and writes the 2r+1 bilinear values of its row
// into out[b, n, offset + yy*(2r+1) + xx] (out has out_c channels).
// Bound by bytes; see codd_torch/ops/corr.py.
#include <cuda_runtime.h>

__device__ __forceinline__ float bf16_to_f32(unsigned short v) {
  return __uint_as_float(((unsigned int)v) << 16);
}

__global__ void corr_lookup_kernel(const unsigned short* __restrict__ vol,
                                   const float* __restrict__ coords,
                                   float* __restrict__ out, int B, int N,
                                   int Hp, int Wp, int r, float scale,
                                   int out_c, int offset) {
  int R1 = 2 * r + 1;
  long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)B * N * R1;
  if (tid >= total) return;
  int yy = (int)(tid % R1);
  long long q = tid / R1;  // b * N + n
  int P = 2 * r + 1;
  int hl = Hp - 2 * P, wl = Wp - 2 * P;

  float cx = __fmul_rn(coords[q * 2 + 0], scale);
  float cy = __fmul_rn(coords[q * 2 + 1], scale);
  float x0 = floorf(cx), y0 = floorf(cy);
  float fx = __fsub_rn(cx, x0), fy = __fsub_rn(cy, y0);
  bool vq = (x0 >= (float)(-(r + 1))) && (x0 <= (float)(wl - 1 + r)) &&
            (y0 >= (float)(-(r + 1))) && (y0 <= (float)(hl - 1 + r));
  int sx = (int)fminf(fmaxf(x0, (float)(-(r + 1))), (float)(wl - 1 + r)) - r + P;
  int sy = (int)fminf(fmaxf(y0, (float)(-(r + 1))), (float)(hl - 1 + r)) - r + P;

  const unsigned short* row0 = vol + (q * Hp + sy + yy) * (long long)Wp + sx;
  const unsigned short* row1 = row0 + Wp;
  float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  float* op = out + q * out_c + offset + yy * R1;
  float a0 = vq ? bf16_to_f32(__ldg(row0)) : 0.0f;
  float b0 = vq ? bf16_to_f32(__ldg(row1)) : 0.0f;
  for (int xx = 0; xx < R1; ++xx) {
    float a1 = vq ? bf16_to_f32(__ldg(row0 + xx + 1)) : 0.0f;
    float b1 = vq ? bf16_to_f32(__ldg(row1 + xx + 1)) : 0.0f;
    // (1-fy)*((1-fx)*d00 + fx*d01) + fy*((1-fx)*d10 + fx*d11)
    float top = __fadd_rn(__fmul_rn(gx, a0), __fmul_rn(fx, a1));
    float bot = __fadd_rn(__fmul_rn(gx, b0), __fmul_rn(fx, b1));
    op[xx] = __fadd_rn(__fmul_rn(gy, top), __fmul_rn(fy, bot));
    a0 = a1;
    b0 = b1;
  }
}

extern "C" int corr_lookup_launch(const void* vol, const void* coords,
                                  void* out, int B, int N, int Hp, int Wp,
                                  int r, float scale, int out_c, int offset,
                                  void* stream) {
  long long total = (long long)B * N * (2 * r + 1);
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks == 0) return 0;
  corr_lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned short*)vol, (const float*)coords, (float*)out, B, N,
      Hp, Wp, r, scale, out_c, offset);
  return (int)cudaGetLastError();
}
