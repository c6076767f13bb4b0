// Aggregation + argmin over the 8x8-child SSD grids, shared by K3
// (inter_decide.cu, the depth stage) and K4 (tf.cu, the TF-ME _best_mv).
#pragma once

#include <limits.h>

#include "common.cuh"

#define SVT_R 12
#define SVT_G 25
#define SVT_GG (SVT_G * SVT_G)

// One unit of kkh x kkw children (rows cr0.., cols cc0..) of superblock sb:
// sums its children's int32 SSD grids exactly (int64), rounds to float32
// once, adds lam * mvb[offset] when mvb is given, and takes the argmin over
// both centres' 2 x 25 x 25 offsets (lowest flat index on ties, as
// jnp.argmin). g is (2, n, 8, 8, 25, 25). Every thread must call it.
__device__ void grid_argmin(const int* __restrict__ g, int n, int sb, int cr0,
                            int cc0, int kkh, int kkw, float lam,
                            const float* __restrict__ mvb, float* redv,
                            int* redi, int& sel, int& off) {
  float bv = INFINITY;
  int bi = INT_MAX;
  for (int k = threadIdx.x; k < 2 * SVT_GG; k += blockDim.x) {
    const int ci = k / SVT_GG, o = k % SVT_GG;
    const int* base = g + ((size_t)ci * n + sb) * 64 * SVT_GG + o;
    long long s = 0;
    for (int r = 0; r < kkh; ++r)
      for (int c = 0; c < kkw; ++c)
        s += base[(size_t)((cr0 + r) * 8 + cc0 + c) * SVT_GG];
    float v = (float)s;
    if (mvb != nullptr) v = v + lam * mvb[o];
    argmin_merge(bv, bi, v, k);
  }
  block_argmin(bv, bi, redv, redi);
  sel = bi / SVT_GG;
  off = bi % SVT_GG;
}
