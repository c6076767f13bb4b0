// K2: the integer SSD surfaces of the inter search's grids stage.
//
// Replaces the HME surfaces (_hme, _hme4) and the child grids (_sb_windows +
// _child_grids) of svt_av1_psy_tpu/ops/inter_search.py:grids_stage, which
// compute box - 2 corr + energy with a float32 integral image. Here every SSD
// is summed directly in integers: exact at any bit depth up to 10.
//
// hme_kernel: one block per superblock; the SB's pooled-sum block and its
// (2R+b)^2 window sit in shared memory; each thread scores offsets of the
// 33x33 surface in int64, the centre biased by 0.995 (in double), and the
// block reduces to the lowest-index argmin.
// child_grids_kernel: one block per (superblock, centre); the 88x88 reference
// window at the centre and the SB's 64x64 pixels sit in shared memory (read
// straight from the padded plane, never materialised in device memory); each
// thread computes (child, offset) SSDs of 64 products in int32.
// Bound on the H100: integer multiply-adds from shared memory.

#include "common.cuh"

#define HME_R 16
#define HME_SIDE (2 * HME_R + 1)

__global__ void __launch_bounds__(SVT_NT) hme_kernel(
    const int* __restrict__ dsrc, const int* __restrict__ dref,
    int* __restrict__ idx, int nsc, int b, int PD, int Wr) {
  __shared__ int blk[16 * 16];
  __shared__ int win[(HME_SIDE + 15) * (HME_SIDE + 15)];
  __shared__ double redv[SVT_NT / 32];
  __shared__ int redi[SVT_NT / 32];
  const int sb = blockIdx.x, sr = sb / nsc, sc = sb % nsc;
  const int Wd = nsc * b, span = HME_SIDE + b - 1;
  for (int p = threadIdx.x; p < b * b; p += blockDim.x)
    blk[p] = dsrc[(size_t)(sr * b + p / b) * Wd + sc * b + p % b];
  const int y0 = sr * b + PD - HME_R, x0 = sc * b + PD - HME_R;
  for (int p = threadIdx.x; p < span * span; p += blockDim.x)
    win[p] = dref[(size_t)(y0 + p / span) * Wr + x0 + p % span];
  __syncthreads();
  double bv = INFINITY;
  int bi = 0x7fffffff;
  for (int k = threadIdx.x; k < HME_SIDE * HME_SIDE; k += blockDim.x) {
    const int u = k / HME_SIDE, v = k % HME_SIDE;
    long long s = 0;
    for (int y = 0; y < b; ++y)
      for (int x = 0; x < b; ++x) {
        const long long d = (long long)(blk[y * b + x] - win[(u + y) * span + v + x]);
        s += d * d;
      }
    double val = (double)s;
    if (k == HME_R * HME_SIDE + HME_R) val *= 0.995;
    argmin_merge(bv, bi, val, k);
  }
  block_argmin(bv, bi, redv, redi);
  if (threadIdx.x == 0) idx[sb] = bi;
}

__global__ void __launch_bounds__(SVT_NT) child_grids_kernel(
    const int* __restrict__ ref, const int* __restrict__ src,
    const int* __restrict__ cy2, const int* __restrict__ cx2,
    int* __restrict__ out, int n, int nsc, int Hr, int Wr, int Wp, int R) {
  const int G = 2 * R + 1, W = 64 + 2 * R;   // W <= 88
  __shared__ int win[88 * 88];
  __shared__ int s[64 * 64];
  const int sb = blockIdx.x, ci = blockIdx.y, sr = sb / nsc, sc = sb % nsc;
  const int pad = (Wr - Wp) / 2;   // the reference plane's border, PAD
  const int y0 = clamp_start(sr * 64 + pad - R + cy2[ci * n + sb], Hr, W);
  const int x0 = clamp_start(sc * 64 + pad - R + cx2[ci * n + sb], Wr, W);
  for (int p = threadIdx.x; p < W * W; p += blockDim.x)
    win[p] = ref[(size_t)(y0 + p / W) * Wr + x0 + p % W];
  for (int p = threadIdx.x; p < 64 * 64; p += blockDim.x)
    s[p] = src[(size_t)(sr * 64 + p / 64) * Wp + sc * 64 + p % 64];
  __syncthreads();
  int* o = out + ((size_t)ci * n + sb) * 64 * G * G;
  for (int q = threadIdx.x; q < 64 * G * G; q += blockDim.x) {
    const int child = q / (G * G), k = q % (G * G);
    const int by = child >> 3, bx = child & 7, u = k / G, v = k % G;
    const int* sp = s + by * 8 * 64 + bx * 8;
    const int* wp = win + (by * 8 + u) * W + bx * 8 + v;
    int acc = 0;
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) {
        const int d = sp[y * 64 + x] - wp[y * W + x];
        acc += d * d;
      }
    o[q] = acc;
  }
}

extern "C" int hme_launch(const int* dsrc, const int* dref, int* idx, int nsr,
                          int nsc, int b, int PD, int Wr, void* stream) {
  if (b != 8 && b != 16) return (int)cudaErrorInvalidValue;
  hme_kernel<<<nsr * nsc, SVT_NT, 0, (cudaStream_t)stream>>>(dsrc, dref, idx, nsc,
                                                             b, PD, Wr);
  return (int)cudaGetLastError();
}

extern "C" int child_grids_launch(const int* ref, const int* src, const int* cy2,
                                  const int* cx2, int* out, int nsr, int nsc,
                                  int Hr, int Wr, int Wp, int R, void* stream) {
  if (R > 12) return (int)cudaErrorInvalidValue;
  dim3 grid(nsr * nsc, 2);
  child_grids_kernel<<<grid, SVT_NT, 0, (cudaStream_t)stream>>>(
      ref, src, cy2, cx2, out, nsr * nsc, nsc, Hr, Wr, Wp, R);
  return (int)cudaGetLastError();
}
