// K7: the device TPL cost pass, per 16x16 TPL unit.
//
// Replaces svt_av1_psy_tpu/ops/tpl.py: tpl_intra_stage and tpl_pair_stage.
//   tpl_intra_kernel  one CUDA block per unit: floor(mean), then the SA8D of
//                     the mean-removed block, max(., 1).
//   tpl_pair_kernel   one CUDA block per unit: sums the 2x2 group of 8x8-child
//                     SSD grids (K2's int32 output) for both HME centres,
//                     argmin over the 2 x 25 x 25 offsets (lowest flat index on
//                     ties, as jnp.argmin), centre + offset clipped as
//                     jnp.clip(v, -b, hi - b), min of max in that order (for
//                     units in the 64-aligned padding hi - b < 0 pulls the
//                     vector back into the frame), the 16x16
//                     prediction gathered from the padded reference (clamped
//                     as dynamic_slice clamps), and min(inter SA8D, intra).
// SA8D per 8x8 quadrant is (sum |H8 q H8^T| + 2) >> 2, summed over the four
// quadrants. Everything is integer; on the 8-bit TPL planes it equals the
// JAX program's float32 einsums, whose sums stay below 2^24.
// Bound on the H100: reading the child grids (2 x 4 x 625 int32 per unit,
// 43 MB per 960x540 frame); the block's pixels and the Hadamard stages sit
// in shared memory.

#include <limits.h>

#include "common.cuh"

#define TPL_R 12
#define TPL_G 25
#define TPL_GG (TPL_G * TPL_G)

__device__ __forceinline__ int warp_sum_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// H8[i][j] = (-1)^popcount(i & j) (Sylvester order, the rows of _HAD8).
__device__ __forceinline__ int had8(int i, int j) {
  return (__popc(i & j) & 1) ? -1 : 1;
}

// SA8D of the 16x16 residual res (row-major); 256 threads, all must call.
// Thread t works on quadrant t >> 6, row (t >> 3) & 7, column t & 7.
__device__ int sa8d16(const int* res, int* tmp, int* red) {
  const int t = threadIdx.x, q = t >> 6, i = (t >> 3) & 7, k = t & 7;
  const int oy = (q >> 1) * 8, ox = (q & 1) * 8;
  int a = 0;
  for (int j = 0; j < 8; ++j) a += had8(i, j) * res[(oy + j) * 16 + ox + k];
  tmp[t] = a;                                // (H8 q)[i][k]
  __syncthreads();
  int b = 0;
  for (int kk = 0; kk < 8; ++kk) b += tmp[(q << 6) + i * 8 + kk] * had8(k, kk);
  int s = warp_sum_i(abs(b));                // two warps per quadrant
  if ((t & 31) == 0) red[t >> 5] = s;
  __syncthreads();
  int tot = 0;
  for (int qq = 0; qq < 4; ++qq) tot += (red[2 * qq] + red[2 * qq + 1] + 2) >> 2;
  __syncthreads();                           // tmp / red reusable after return
  return tot;
}

// floor(mean) of the 16x16 block in shared memory (arithmetic shift floors).
__device__ int block_mean16(const int* blk, int* red) {
  int s = warp_sum_i(blk[threadIdx.x]);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  int tot = 0;
  for (int w = 0; w < 8; ++w) tot += red[w];
  __syncthreads();
  return tot >> 8;
}

__device__ int intra_cost(const int* blk, int* res, int* tmp, int* red) {
  const int mean = block_mean16(blk, red);
  res[threadIdx.x] = blk[threadIdx.x] - mean;
  __syncthreads();
  return max(sa8d16(res, tmp, red), 1);
}

__global__ void __launch_bounds__(SVT_NT) tpl_intra_kernel(
    const float* __restrict__ src, int Wp, float* __restrict__ out) {
  __shared__ int blk[256], res[256], tmp[256], red[8];
  const int gc = Wp / 16, uy = blockIdx.x / gc, ux = blockIdx.x % gc;
  const int t = threadIdx.x;
  blk[t] = (int)src[(size_t)(uy * 16 + (t >> 4)) * Wp + ux * 16 + (t & 15)];
  __syncthreads();
  const int intra = intra_cost(blk, res, tmp, red);
  if (t == 0) out[blockIdx.x] = (float)intra;
}

__global__ void __launch_bounds__(SVT_NT) tpl_pair_kernel(
    const float* __restrict__ src, const float* __restrict__ ref,
    const int* __restrict__ cy2, const int* __restrict__ cx2,
    const int* __restrict__ ssd8, int Hp, int Wp, int Hr, int Wr, int PAD,
    float* __restrict__ out) {
  __shared__ int blk[256], res[256], tmp[256], red[8];
  __shared__ long long redv[SVT_NT / 32];
  __shared__ int redi[SVT_NT / 32];
  const int gc = Wp / 16, gr = Hp / 16, u = blockIdx.x;
  const int uy = u / gc, ux = u % gc, t = threadIdx.x;
  const int nsc = Wp / 64, n = (Hp / 64) * nsc;
  const int sb = (uy >> 2) * nsc + (ux >> 2);
  const int cr0 = (uy & 3) * 2, cc0 = (ux & 3) * 2;
  blk[t] = (int)src[(size_t)(uy * 16 + (t >> 4)) * Wp + ux * 16 + (t & 15)];

  long long bv = LLONG_MAX;
  int bi = INT_MAX;
  for (int k = t; k < 2 * TPL_GG; k += blockDim.x) {
    const int ci = k / TPL_GG, o = k % TPL_GG;
    const int* base = ssd8 + ((size_t)ci * n + sb) * 64 * TPL_GG + o;
    long long s = 0;
    for (int r = 0; r < 2; ++r)
      for (int c = 0; c < 2; ++c)
        s += base[(size_t)((cr0 + r) * 8 + cc0 + c) * TPL_GG];
    argmin_merge(bv, bi, s, k);
  }
  block_argmin(bv, bi, redv, redi);
  const int sel = bi / TPL_GG, off = bi % TPL_GG;
  const int by = uy * 16, bx = ux * 16;
  const int my = min(max(cy2[sel * n + sb] + off / TPL_G - TPL_R, -by), (Hr - 16) - by);
  const int mx = min(max(cx2[sel * n + sb] + off % TPL_G - TPL_R, -bx), (Wr - 16) - bx);
  const int Hpad = Hp + 2 * PAD, Wpad = Wp + 2 * PAD;
  const int ys = clamp_start(by + PAD + my, Hpad, 16);
  const int xs = clamp_start(bx + PAD + mx, Wpad, 16);
  res[t] = blk[t] - (int)ref[(size_t)(ys + (t >> 4)) * Wpad + xs + (t & 15)];
  __syncthreads();
  const int inter = max(sa8d16(res, tmp, red), 1);
  const int intra = intra_cost(blk, res, tmp, red);
  if (t == 0) {
    const int m = gr * gc;
    out[u] = (float)my;
    out[m + u] = (float)mx;
    out[2 * m + u] = (float)min(inter, intra);
    out[3 * m + u] = (float)intra;
  }
}

extern "C" int tpl_intra_launch(const float* src, int Hp, int Wp, float* out,
                                void* stream) {
  tpl_intra_kernel<<<(Hp / 16) * (Wp / 16), SVT_NT, 0, (cudaStream_t)stream>>>(
      src, Wp, out);
  return (int)cudaGetLastError();
}

extern "C" int tpl_pair_launch(const float* src, const float* ref, const int* cy2,
                               const int* cx2, const int* ssd8, int Hp, int Wp,
                               int Hr, int Wr, int PAD, float* out, void* stream) {
  tpl_pair_kernel<<<(Hp / 16) * (Wp / 16), SVT_NT, 0, (cudaStream_t)stream>>>(
      src, ref, cy2, cx2, ssd8, Hp, Wp, Hr, Wr, PAD, out);
  return (int)cudaGetLastError();
}
