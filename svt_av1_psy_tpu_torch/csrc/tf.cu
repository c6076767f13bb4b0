// K4: whole-frame temporal filtering (alt-ref / keyframe TF).
//
// Replaces svt_av1_psy_tpu/ops/tf.py: tf_pair_stage, tf_chroma_stage and
// tf_finalize_stage.
//   tf_block_kernel    one CUDA block per 32x32 luma block: the 32x32 and four
//                      16x16 TF-ME vectors from the child grids (grid_argmin.cuh,
//                      shared with K3), clipped into the frame; the two
//                      predictions, their exact (int64) SSEs, the 16x16
//                      refinement choice, the block weight round(16 exp(-mse/t))
//                      zeroed at >= 8t, and the chosen prediction.
//   tf_weight_kernel   one thread per pixel: the edge-clamped 5x5 box of the
//                      squared error (int64), then the per-pixel weight
//                      (luma mixes in the block MSE; chroma is gated by luma).
//   tf_chroma_pred_kernel  one thread per chroma pixel at mv32 >> 1 (arithmetic).
//   tf_finalize_kernel one thread per output pixel: centre weight 16,
//                      floor((acc + floor(den / 2)) / den) in integers, crop.
// Rounding follows the JAX program: rintf (half to even, as jnp.round), IEEE
// expf and division (no fast math), gathers clamped as dynamic_slice clamps.
// Bound on the H100: memory traffic of the per-pixel passes; the per-block
// pass keeps both predictions in shared memory.

#include "common.cuh"
#include "grid_argmin.cuh"

__device__ __forceinline__ int clip_mv(int v, int b0, int hi) {
  return min(max(v, -b0), hi - b0);   // jnp.clip(v, -b0, hi - b0)
}

__global__ void __launch_bounds__(SVT_NT) tf_block_kernel(
    const float* __restrict__ src, const float* __restrict__ ref,
    const int* __restrict__ cy2, const int* __restrict__ cx2,
    const int* __restrict__ ssd8, float thresh, int Hp, int Wp, int Hr, int Wr,
    int PAD, float* __restrict__ pred, float* __restrict__ mse_blk,
    float* __restrict__ wgt_blk, int* __restrict__ mv32y, int* __restrict__ mv32x) {
  __shared__ int p32[32 * 32];
  __shared__ int p16[32 * 32];
  __shared__ int s[32 * 32];
  __shared__ float redv[SVT_NT / 32];
  __shared__ int redi[SVT_NT / 32];
  __shared__ long long red_ll[SVT_NT / 32];
  const int gc32 = Wp / 32, ur = blockIdx.x / gc32, uc = blockIdx.x % gc32;
  const int nsc = Wp / 64, n = (Hp / 64) * nsc;
  const int sb = (ur >> 1) * nsc + (uc >> 1);
  const int Hpad = Hp + 2 * PAD, Wpad = Wp + 2 * PAD;
  for (int p = threadIdx.x; p < 1024; p += blockDim.x)
    s[p] = (int)src[(size_t)(ur * 32 + (p >> 5)) * Wp + uc * 32 + (p & 31)];

  int sel, off;
  grid_argmin(ssd8, n, sb, (ur & 1) * 4, (uc & 1) * 4, 4, 4, 0.f, nullptr, redv,
              redi, sel, off);
  const int by = ur * 32, bx = uc * 32;
  const int my = clip_mv(cy2[sel * n + sb] + off / SVT_G - SVT_R, by, Hr - 32);
  const int mx = clip_mv(cx2[sel * n + sb] + off % SVT_G - SVT_R, bx, Wr - 32);
  {
    const int ys = clamp_start(by + PAD + my, Hpad, 32);
    const int xs = clamp_start(bx + PAD + mx, Wpad, 32);
    for (int p = threadIdx.x; p < 1024; p += blockDim.x)
      p32[p] = (int)ref[(size_t)(ys + (p >> 5)) * Wpad + xs + (p & 31)];
  }
  for (int q = 0; q < 4; ++q) {
    const int r16 = ur * 2 + (q >> 1), c16 = uc * 2 + (q & 1);
    grid_argmin(ssd8, n, sb, (r16 & 3) * 2, (c16 & 3) * 2, 2, 2, 0.f, nullptr,
                redv, redi, sel, off);
    const int b16y = r16 * 16, b16x = c16 * 16;
    const int m16y = clip_mv(cy2[sel * n + sb] + off / SVT_G - SVT_R, b16y, Hr - 16);
    const int m16x = clip_mv(cx2[sel * n + sb] + off % SVT_G - SVT_R, b16x, Wr - 16);
    const int ys = clamp_start(b16y + PAD + m16y, Hpad, 16);
    const int xs = clamp_start(b16x + PAD + m16x, Wpad, 16);
    for (int p = threadIdx.x; p < 256; p += blockDim.x) {
      const int y = p >> 4, x = p & 15;
      p16[((q >> 1) * 16 + y) * 32 + (q & 1) * 16 + x] =
          (int)ref[(size_t)(ys + y) * Wpad + xs + x];
    }
  }
  __syncthreads();
  long long a32 = 0, a16 = 0;
  for (int p = threadIdx.x; p < 1024; p += blockDim.x) {
    const long long d32 = p32[p] - s[p], d16 = p16[p] - s[p];
    a32 += d32 * d32;
    a16 += d16 * d16;
  }
  const long long sse32 = block_sum_ll(a32, red_ll);
  const long long sse16 = block_sum_ll(a16, red_ll);
  const float mse32 = (float)((double)sse32 / 1024.0);
  const float mse16 = (float)((double)sse16 / 1024.0);
  const bool use_sub = (mse32 > thresh) && (mse16 < mse32);
  const float mse = use_sub ? mse16 : mse32;
  const int* chosen = use_sub ? p16 : p32;
  for (int p = threadIdx.x; p < 1024; p += blockDim.x)
    pred[(size_t)(by + (p >> 5)) * Wp + bx + (p & 31)] = (float)chosen[p];
  if (threadIdx.x == 0) {
    mse_blk[blockIdx.x] = mse;
    wgt_blk[blockIdx.x] = mse < 8.0f * thresh ? rintf(16.0f * expf(-mse / thresh)) : 0.0f;
    mv32y[blockIdx.x] = my;
    mv32x[blockIdx.x] = mx;
  }
}

// Per-pixel weights. luma (gate_plane == nullptr): err = 0.5 box + 0.5 mse of
// the 32x32 block, gated by the block weight; chroma: err = box, gated by
// the luma weight at (2y, 2x) of a plane gate_w wide.
__global__ void __launch_bounds__(SVT_NT) tf_weight_kernel(
    const float* __restrict__ pred, const float* __restrict__ src, int H, int W,
    float thresh, const float* __restrict__ mse_blk,
    const float* __restrict__ wgt_blk, const float* __restrict__ gate_plane,
    int gate_w, float* __restrict__ w_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const int y = i / W, x = i % W;
  long long box = 0;
  for (int dy = -2; dy <= 2; ++dy) {
    const int yy = min(max(y + dy, 0), H - 1);
    for (int dx = -2; dx <= 2; ++dx) {
      const int xx = min(max(x + dx, 0), W - 1);
      const long long d = (long long)((int)pred[(size_t)yy * W + xx] -
                                      (int)src[(size_t)yy * W + xx]);
      box += d * d;
    }
  }
  const float boxf = (float)box * (float)(1.0 / 25.0);
  float w;
  if (gate_plane == nullptr) {
    const int b = (y >> 5) * (W >> 5) + (x >> 5);
    const float err = 0.5f * boxf + 0.5f * mse_blk[b];
    w = rintf(16.0f * expf(-err / thresh));
    if (!(wgt_blk[b] > 0.0f)) w = 0.0f;
  } else {
    w = rintf(16.0f * expf(-boxf / thresh));
    if (!(gate_plane[(size_t)(2 * y) * gate_w + 2 * x] > 0.0f)) w = 0.0f;
  }
  w_out[i] = w;
}

__global__ void tf_chroma_pred_kernel(
    const float* __restrict__ ru, const float* __restrict__ rv,
    const int* __restrict__ mv32y, const int* __restrict__ mv32x, int Hc, int Wc,
    int Hpc, int Wpc, int PAD, float* __restrict__ pu, float* __restrict__ pv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Hpc * Wpc) return;
  const int y = i / Wpc, x = i % Wpc, gy = y >> 4, gx = x >> 4;
  const int g = gy * (Wpc >> 4) + gx;
  const int by = gy * 16, bx = gx * 16;
  const int my = clip_mv(mv32y[g] >> 1, by, Hc - 16);
  const int mx = clip_mv(mv32x[g] >> 1, bx, Wc - 16);
  const int Hr = Hpc + 2 * PAD, Wr = Wpc + 2 * PAD;
  const int ys = clamp_start(by + PAD + my, Hr, 16);
  const int xs = clamp_start(bx + PAD + mx, Wr, 16);
  const size_t o = (size_t)(ys + (y & 15)) * Wr + xs + (x & 15);
  pu[i] = ru[o];
  pv[i] = rv[o];
}

__global__ void tf_finalize_kernel(const float* __restrict__ src,
                                   const float* __restrict__ preds,
                                   const float* __restrict__ ws, int K, int Hp,
                                   int Wp, int Hr, int Wr, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Hr * Wr) return;
  const int y = i / Wr, x = i % Wr;
  const size_t o = (size_t)y * Wp + x, plane = (size_t)Hp * Wp;
  long long acc = 16 * (long long)src[o], den = 16;
  for (int k = 0; k < K; ++k) {
    const long long w = (long long)ws[k * plane + o];
    acc += (long long)preds[k * plane + o] * w;
    den += w;
  }
  out[i] = (float)((acc + den / 2) / den);
}

static inline int nblk(long long n) { return (int)((n + SVT_NT - 1) / SVT_NT); }

extern "C" int tf_pair_launch(const float* src, const float* ref, const int* cy2,
                              const int* cx2, const int* ssd8, float thresh, int Hp,
                              int Wp, int Hr, int Wr, int PAD, float* pred,
                              float* mse_blk, float* wgt_blk, int* mv32y,
                              int* mv32x, float* w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  tf_block_kernel<<<(Hp / 32) * (Wp / 32), SVT_NT, 0, st>>>(
      src, ref, cy2, cx2, ssd8, thresh, Hp, Wp, Hr, Wr, PAD, pred, mse_blk,
      wgt_blk, mv32y, mv32x);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tf_weight_kernel<<<nblk((long long)Hp * Wp), SVT_NT, 0, st>>>(
      pred, src, Hp, Wp, thresh, mse_blk, wgt_blk, nullptr, 0, w);
  return (int)cudaGetLastError();
}

extern "C" int tf_chroma_launch(const float* cu, const float* cv, const float* ru,
                                const float* rv, const int* mv32y,
                                const int* mv32x, const float* wy, float thresh_uv,
                                int Hc, int Wc, int Hpc, int Wpc, int PAD,
                                float* pu, float* wu, float* pv, float* wv,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = nblk((long long)Hpc * Wpc);
  tf_chroma_pred_kernel<<<nb, SVT_NT, 0, st>>>(ru, rv, mv32y, mv32x, Hc, Wc, Hpc,
                                               Wpc, PAD, pu, pv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tf_weight_kernel<<<nb, SVT_NT, 0, st>>>(pu, cu, Hpc, Wpc, thresh_uv, nullptr,
                                          nullptr, wy, 2 * Wpc, wu);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tf_weight_kernel<<<nb, SVT_NT, 0, st>>>(pv, cv, Hpc, Wpc, thresh_uv, nullptr,
                                          nullptr, wy, 2 * Wpc, wv);
  return (int)cudaGetLastError();
}

extern "C" int tf_finalize_launch(const float* src, const float* preds,
                                  const float* ws, int K, int Hp, int Wp, int Hr,
                                  int Wr, float* out, void* stream) {
  tf_finalize_kernel<<<nblk((long long)Hr * Wr), SVT_NT, 0, (cudaStream_t)stream>>>(
      src, preds, ws, K, Hp, Wp, Hr, Wr, out);
  return (int)cudaGetLastError();
}
