// K9: the SGRPROJ parameter sweep's projection statistics.
//
// Replaces svt_av1_psy_tpu/ops/lr_search.py: _sgr_stats. For every candidate
// ep of one plane, the whole-plane self-guided filter pair and the per-tile
// sums of [f0 f0, f0 f1, f1 f1, f0 d, f1 d, d d] (f = flt - dgd << 4,
// d = src << 4 - dgd << 4) over the zero-padded T x T tile grid.
//   sgr_ab_kernel    one thread per point of the (H+2) x (W+2) A/B grid and
//                    one grid row of blocks per (ep, radius) pair: the
//                    (2r+1)^2 box sums of dgd and dgd^2 over the edge-padded
//                    plane (direct integer sums: the JAX program's int32
//                    cumsum wraps at 10-bit 1080p, but its differences are
//                    exact mod 2^32 and equal these), then the A/B transform.
//                    The z index rounds as the JAX program computes it,
//                    floor((f32(p) * f32(s) + 2^19) / 2^20) in IEEE float32
//                    (no fast math, no FMA contraction: -fmad=false), the
//                    reference's documented +/-1 drift from the exact index.
//   sgr_tile_kernel  one CUDA block per (tile, ep): the r0 even/odd-row blend
//                    and the r1 3x3 blend, and the six products summed exactly
//                    in int64 (returned as float64).
// Bound on the H100: the box sums (up to 50 loads per A/B point per pair, from
// L1/L2) and the A/B grids' traffic (two int32 planes per pair).

#include "common.cuh"

#define SGR_MTABLE_BITS 20
#define SGR_RECIP_BITS 12
#define SGR_SGR 256
#define SGR_RST_BITS 4

__device__ __forceinline__ long long rpot(long long x, int n) {
  return n > 0 ? (x + (1LL << (n - 1))) >> n : x;
}

// pairs: (n_pairs, 2) int32 rows (r, s); At / Bt: (n_pairs, H+2, W+2) int32.
__global__ void __launch_bounds__(SVT_NT) sgr_ab_kernel(
    const int* __restrict__ dgd, int H, int W, int bd,
    const int* __restrict__ pairs, const int* __restrict__ x_by_xplus1,
    const int* __restrict__ one_by_x, int* __restrict__ At, int* __restrict__ Bt) {
  const int G2 = (H + 2) * (W + 2);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= G2) return;
  const int pr = blockIdx.y, r = pairs[2 * pr], s = pairs[2 * pr + 1];
  const int gy = i / (W + 2), gx = i % (W + 2);
  long long A = 0, B = 0;
  for (int dy = -r; dy <= r; ++dy) {
    const int y = min(max(gy - 1 + dy, 0), H - 1);
    const int* row = dgd + (size_t)y * W;
    for (int dx = -r; dx <= r; ++dx) {
      const long long v = row[min(max(gx - 1 + dx, 0), W - 1)];
      A += v * v;
      B += v;
    }
  }
  const int n = (2 * r + 1) * (2 * r + 1);
  const long long a = rpot(A, 2 * (bd - 8)), b = rpot(B, bd - 8);
  const long long p = max(a * n - b * b, 0LL);
  float t = (float)p * (float)s;
  t = t + (float)(1 << (SGR_MTABLE_BITS - 1));
  t = t / (float)(1 << SGR_MTABLE_BITS);
  const int z = min(max((int)floorf(t), 0), 255);
  const int at = x_by_xplus1[z];
  const size_t o = (size_t)pr * G2 + i;
  At[o] = at;
  Bt[o] = (int)rpot((long long)(SGR_SGR - at) * B * one_by_x[n - 1], SGR_RECIP_BITS);
}

// eps: (n_eps, 2) int32 rows (pair index of r0 or -1, pair index of r1 or -1).
// out: (n_eps, 6, th, tw) float64.
__global__ void __launch_bounds__(SVT_NT) sgr_tile_kernel(
    const int* __restrict__ src, const int* __restrict__ dgd, int H, int W, int T,
    int th, int tw, const int* __restrict__ eps, const int* __restrict__ At,
    const int* __restrict__ Bt, double* __restrict__ out) {
  __shared__ long long red[SVT_NT / 32];
  const int tile = blockIdx.x, e = blockIdx.y;
  const int ty = tile / tw, tx = tile % tw;
  const int i0 = eps[2 * e], i1 = eps[2 * e + 1];
  const int GW = W + 2;
  const size_t G2 = (size_t)(H + 2) * GW;
  const int* A0 = At + (i0 >= 0 ? (size_t)i0 * G2 : 0);
  const int* B0 = Bt + (i0 >= 0 ? (size_t)i0 * G2 : 0);
  const int* A1 = At + (i1 >= 0 ? (size_t)i1 * G2 : 0);
  const int* B1 = Bt + (i1 >= 0 ? (size_t)i1 * G2 : 0);
  long long s00 = 0, s01 = 0, s11 = 0, s0d = 0, s1d = 0, sdd = 0;
  for (int q = threadIdx.x; q < T * T; q += blockDim.x) {
    const int y = ty * T + q / T, x = tx * T + q % T;
    if (y >= H || x >= W) continue;
    const long long dv = dgd[(size_t)y * W + x];
    const long long u = dv << SGR_RST_BITS;
    const long long d = ((long long)src[(size_t)y * W + x] << SGR_RST_BITS) - u;
    const size_t c = (size_t)(y + 1) * GW + (x + 1);   // A/B grid centre
    long long f0 = 0, f1 = 0;
    if (i0 >= 0) {
      long long a, b;
      int nb;
      if ((y & 1) == 0) {     // even rows blend the odd neighbours
        a = (long long)(A0[c - GW] + A0[c + GW]) * 6
            + (long long)(A0[c - GW - 1] + A0[c + GW - 1] + A0[c - GW + 1] + A0[c + GW + 1]) * 5;
        b = (long long)(B0[c - GW] + B0[c + GW]) * 6
            + (long long)(B0[c - GW - 1] + B0[c + GW - 1] + B0[c - GW + 1] + B0[c + GW + 1]) * 5;
        nb = 5;
      } else {                // odd rows use their own
        a = (long long)A0[c] * 6 + (long long)(A0[c - 1] + A0[c + 1]) * 5;
        b = (long long)B0[c] * 6 + (long long)(B0[c - 1] + B0[c + 1]) * 5;
        nb = 4;
      }
      f0 = rpot(a * dv + b, 8 + nb - SGR_RST_BITS) - u;
    }
    if (i1 >= 0) {
      const long long a =
          (long long)(A1[c] + A1[c - 1] + A1[c + 1] + A1[c - GW] + A1[c + GW]) * 4
          + (long long)(A1[c - GW - 1] + A1[c - GW + 1] + A1[c + GW - 1] + A1[c + GW + 1]) * 3;
      const long long b =
          (long long)(B1[c] + B1[c - 1] + B1[c + 1] + B1[c - GW] + B1[c + GW]) * 4
          + (long long)(B1[c - GW - 1] + B1[c - GW + 1] + B1[c + GW - 1] + B1[c + GW + 1]) * 3;
      f1 = rpot(a * dv + b, 8 + 5 - SGR_RST_BITS) - u;
    }
    s00 += f0 * f0;
    s01 += f0 * f1;
    s11 += f1 * f1;
    s0d += f0 * d;
    s1d += f1 * d;
    sdd += d * d;
  }
  const long long sums[6] = {s00, s01, s11, s0d, s1d, sdd};
  for (int k = 0; k < 6; ++k) {
    const long long v = block_sum_ll(sums[k], red);
    if (threadIdx.x == 0) out[((size_t)e * 6 + k) * th * tw + tile] = (double)v;
    __syncthreads();
  }
}

extern "C" int sgr_ab_launch(const int* dgd, int H, int W, int bd, const int* pairs,
                             int n_pairs, const int* x_by_xplus1,
                             const int* one_by_x, int* At, int* Bt, void* stream) {
  if (n_pairs == 0) return 0;
  const long long G2 = (long long)(H + 2) * (W + 2);
  dim3 grid((unsigned)((G2 + SVT_NT - 1) / SVT_NT), (unsigned)n_pairs);
  sgr_ab_kernel<<<grid, SVT_NT, 0, (cudaStream_t)stream>>>(
      dgd, H, W, bd, pairs, x_by_xplus1, one_by_x, At, Bt);
  return (int)cudaGetLastError();
}

extern "C" int sgr_tile_launch(const int* src, const int* dgd, int H, int W, int T,
                               int th, int tw, const int* eps, int n_eps,
                               const int* At, const int* Bt, double* out,
                               void* stream) {
  dim3 grid((unsigned)(th * tw), (unsigned)n_eps);
  sgr_tile_kernel<<<grid, SVT_NT, 0, (cudaStream_t)stream>>>(
      src, dgd, H, W, T, th, tw, eps, At, Bt, out);
  return (int)cudaGetLastError();
}
