// K5: the AV1 forward and inverse + add 2-D transforms, batched over lanes.
//
// Replaces svt_av1_psy_tpu/ops/txfm.py: forward_transform_2d (:110) and
// inverse_transform_add (:148). One CUDA block per lane: the lane's H x W block
// and one scratch block sit in dynamic shared memory (<= 32 KB at 64x64), each
// butterfly stage runs over all of the block's vectors at once (txfm.cuh).
// Lanes are read and written at a stride, so the residual commit (K6) runs its
// planes in place in its lane buffers; an optional per-lane selector picks the
// second of two specs (the commit's chroma tx type follows the luma eob).
// Bound on the H100: per-stage block barriers and launch latency at the
// commit's lane counts; a few thousand int32 multiply-adds per lane.

#include "common.cuh"
#include "txfm.cuh"

__device__ __forceinline__ const Tx2D& pick(const Tx2D& p0, const Tx2D& p1,
                                            const int* sel, int sel_stride, int b) {
  return (sel != nullptr && sel[(long long)b * sel_stride] != 0) ? p1 : p0;
}

__global__ void __launch_bounds__(SVT_NT) txfm_fwd_kernel(
    Tx2D p0, Tx2D p1, const int* __restrict__ sel, int sel_stride,
    const int* __restrict__ x, int* __restrict__ out, long long ls, long long ps) {
  extern __shared__ int sm[];
  const int b = blockIdx.x, q = blockIdx.y;
  const Tx2D& p = pick(p0, p1, sel, sel_stride, b);
  const int HW = p.H * p.W;
  const long long o = b * ls + q * ps;
  int* a = sm;
  int* t = sm + HW;
  for (int e = threadIdx.x; e < HW; e += blockDim.x) a[e] = x[o + e];
  __syncthreads();
  const int* r = fwd2d(p, a, t);
  for (int e = threadIdx.x; e < HW; e += blockDim.x) out[o + e] = r[e];
}

// out_kind: 0 int32, 1 uint8, 2 uint16 samples
__global__ void __launch_bounds__(SVT_NT) txfm_inv_add_kernel(
    Tx2D p0, Tx2D p1, const int* __restrict__ sel, int sel_stride,
    const int* __restrict__ c, const int* __restrict__ pred, void* __restrict__ out,
    int out_kind, long long ls, long long ps) {
  extern __shared__ int sm[];
  const int b = blockIdx.x, q = blockIdx.y;
  const Tx2D& p = pick(p0, p1, sel, sel_stride, b);
  const int HW = p.H * p.W, peak = (1 << p.bd) - 1;
  const long long o = b * ls + q * ps;
  int* a = sm;
  int* t = sm + HW;
  for (int e = threadIdx.x; e < HW; e += blockDim.x) a[e] = c[o + e];
  __syncthreads();
  const int* r = inv2d(p, a, t);
  for (int e = threadIdx.x; e < HW; e += blockDim.x) {
    const int v = min(max(wadd(pred[o + e], r[e]), 0), peak);
    if (out_kind == 0) ((int*)out)[o + e] = v;
    else if (out_kind == 1) ((unsigned char*)out)[o + e] = (unsigned char)v;
    else ((unsigned short*)out)[o + e] = (unsigned short)v;
  }
}

// Specs are host int64 arrays (tx2d_from); spec1 may be null when sel is.
// Plane q of lane b of every operand sits at its base + b * lane_stride +
// q * plane_stride (elements). Returns the CUDA error of the launch.
extern "C" int txfm_fwd_launch(const long long* spec0, const long long* spec1,
                               const int* sel, int sel_stride, const int* x,
                               int* out, long long lane_stride,
                               long long plane_stride, int B, int nplanes,
                               cudaStream_t st) {
  if (B <= 0) return 0;
  const Tx2D p0 = tx2d_from(spec0);
  const Tx2D p1 = spec1 ? tx2d_from(spec1) : p0;
  const size_t sh = 2u * p0.H * p0.W * sizeof(int);
  txfm_fwd_kernel<<<dim3(B, nplanes), SVT_NT, sh, st>>>(p0, p1, sel, sel_stride, x,
                                                       out, lane_stride, plane_stride);
  return (int)cudaGetLastError();
}

extern "C" int txfm_inv_add_launch(const long long* spec0, const long long* spec1,
                                   const int* sel, int sel_stride, const int* c,
                                   const int* pred, void* out, int out_kind,
                                   long long lane_stride, long long plane_stride,
                                   int B, int nplanes, cudaStream_t st) {
  if (B <= 0) return 0;
  const Tx2D p0 = tx2d_from(spec0);
  const Tx2D p1 = spec1 ? tx2d_from(spec1) : p0;
  const size_t sh = 2u * p0.H * p0.W * sizeof(int);
  txfm_inv_add_kernel<<<dim3(B, nplanes), SVT_NT, sh, st>>>(
      p0, p1, sel, sel_stride, c, pred, out, out_kind, lane_stride, plane_stride);
  return (int)cudaGetLastError();
}
