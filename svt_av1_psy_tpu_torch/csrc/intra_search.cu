// K1: full-frame intra mode + tx-type search, one CUDA block per SxS block.
//
// Replaces svt_av1_psy_tpu/ops/intra_search.py:search_block_batch (the jitted
// TPU program). Per block: 12 linear predictions refs(1+4S) x G plus Paeth,
// the residual's orthonormal transform tv r th^T, dead-zone quantisation,
// the rate from the bit tables, argmin over 13 modes (lowest index wins a
// tie), then the same RD over n_tx tx-type bases for the winning mode.
//
// Numbers: the bank product is exact in float32 (power-of-two weights on
// integer samples); transforms and all sums run in float64 and round to
// float32 once, exactly as the plain PyTorch version does. Built with
// -fmad=false so each float32 expression rounds as PyTorch rounds it.
//
// Bound on the H100: reading G from L2 (6.3 MB per block at S=32); the
// residual, both transform passes and the levels stay in shared memory.

#include "common.cuh"

#define NMODES 13

template <int S>
struct Geo {
  static constexpr int SS = S * S;
  static constexpr int L = 1 + 4 * S;
  static constexpr int LP = (L + 3) & ~3;
  static constexpr int KEEP = S < 32 ? S : 32;
  static constexpr int NK = KEEP * KEEP;
  static constexpr size_t smem =
      (size_t)SS * 8 + (SVT_NT / 32) * 8 + (size_t)LP * 4 + (size_t)5 * SS * 4 +
      (size_t)NK * 4 + (SVT_NT / 32) * 4 + 16 + NK;
};

struct Tabs {
  const int* scan;
  const float* qm_w;
  const float* level_bits;
  const float* eob_bits;
  const float* txb_skip;
};

template <int S>
__device__ void predict(int m, const float* refs_s, const float* src_s,
                        const float* __restrict__ G, float* res_s) {
  using g = Geo<S>;
  for (int p = threadIdx.x; p < g::SS; p += blockDim.x) {
    float v;
    if (m < NMODES - 1) {
      const float* col = G + (size_t)m * g::SS + p;
      float acc = 0.f;
      for (int l = 0; l < g::L; ++l)
        acc += refs_s[l] * col[(size_t)l * (NMODES - 1) * g::SS];
      v = floorf(acc + 0.5f);
    } else {
      const int r = p / S, c = p % S;
      const float t = refs_s[1 + c], lf = refs_s[1 + 2 * S + r], tl = refs_s[0];
      const float base = t + lf - tl;
      const float pl = fabsf(base - lf), pt = fabsf(base - t), ptl = fabsf(base - tl);
      v = (pl <= pt && pl <= ptl) ? lf : (pt <= ptl ? t : tl);
    }
    res_s[p] = src_s[p] - v;
  }
  __syncthreads();
}

// dist / lost / rate of the residual in res_s under bases (tv, th).
template <int S>
__device__ void rd_of(const float* res_s, const float* tv_s, const float* th_s,
                      double* tmp, float* coef_s, unsigned char* lvl_s,
                      double* red_d, int* red_i, const Tabs& tb, float qd,
                      float qa, float& dist, float& lost, float& rate) {
  using g = Geo<S>;
  const int tid = threadIdx.x;
  for (int o = tid; o < g::SS; o += blockDim.x) {
    const int a = o / S, c = o % S;
    double acc = 0.0;
    for (int b = 0; b < S; ++b) acc += (double)tv_s[a * S + b] * (double)res_s[b * S + c];
    tmp[o] = acc;
  }
  __syncthreads();
  double lost_acc = 0.0;
  for (int o = tid; o < g::SS; o += blockDim.x) {
    const int a = o / S, d = o % S;
    double acc = 0.0;
    for (int c = 0; c < S; ++c) acc += tmp[a * S + c] * (double)th_s[d * S + c];
    const float cf = (float)acc;
    if (a < g::KEEP && d < g::KEEP) coef_s[a * g::KEEP + d] = cf;
    else lost_acc += (double)(cf * cf);
  }
  __syncthreads();
  double dist_acc = 0.0;
  int eob_loc = 0;
  for (int i = tid; i < g::NK; i += blockDim.x) {
    const int pos = tb.scan[i];
    const float acf = fabsf(coef_s[pos]);
    const float q = pos == 0 ? qd * tb.qm_w[0] : qa * tb.qm_w[pos];
    float lv = floorf(acf / q + 0.375f);
    lv = fminf(fmaxf(lv, 0.f), 63.f);
    const float err = acf - lv * q;
    dist_acc += (double)(err * err);
    lvl_s[i] = (unsigned char)lv;
    if (lv > 0.f) eob_loc = i + 1;
  }
  const double D = block_sum_d(dist_acc, red_d);
  const double LO = block_sum_d(lost_acc, red_d);
  const int eob = block_max_i(eob_loc, red_i);
  double r_acc = 0.0;
  for (int i = tid; i < eob; i += blockDim.x) r_acc += (double)tb.level_bits[lvl_s[i]];
  const double R = block_sum_d(r_acc, red_d);
  float rt = (float)R + tb.eob_bits[eob];
  rate = eob > 0 ? rt + tb.txb_skip[0] : tb.txb_skip[1];
  dist = (float)D;
  lost = (float)LO;
}

template <int S>
__global__ void __launch_bounds__(SVT_NT) intra_search_kernel(
    const float* __restrict__ src, const float* __restrict__ refs,
    const float* __restrict__ qdc, const float* __restrict__ qac, float lam,
    const float* __restrict__ G, const int* __restrict__ scan2d,
    const int* __restrict__ scans_tx, const float* __restrict__ tvs,
    const float* __restrict__ ths, const float* __restrict__ level_bits,
    const float* __restrict__ eob_bits, const float* __restrict__ txb_skip,
    const float* __restrict__ ymb, const float* __restrict__ ext_bits,
    const float* __restrict__ qm_w, const float* __restrict__ dist_w,
    float tls, int n_tx, int* best_mode, int* best_tx, float* best_cost,
    float* mode_cost0) {
  using g = Geo<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  double* tmp = (double*)smem;
  double* red_d = tmp + g::SS;
  float* refs_s = (float*)(red_d + SVT_NT / 32);
  float* src_s = refs_s + g::LP;
  float* res_s = src_s + g::SS;
  float* tv_s = res_s + g::SS;
  float* th_s = tv_s + g::SS;
  float* coef_s = th_s + g::SS;
  int* red_i = (int*)(coef_s + g::NK);
  int* bcast = red_i + SVT_NT / 32;
  unsigned char* lvl_s = (unsigned char*)(bcast + 4);

  const int n = blockIdx.x, tid = threadIdx.x;
  for (int l = tid; l < g::L; l += blockDim.x) refs_s[l] = refs[(size_t)n * g::L + l];
  for (int p = tid; p < g::SS; p += blockDim.x) {
    src_s[p] = src[(size_t)n * g::SS + p];
    tv_s[p] = tvs[p];
    th_s[p] = tvs[p];
  }
  __syncthreads();
  const float qd = qdc[n], qa = qac[n];
  Tabs tb{scan2d, qm_w, level_bits, eob_bits, txb_skip};

  float best = INFINITY;
  int bm = 0;
  for (int m = 0; m < NMODES; ++m) {
    predict<S>(m, refs_s, src_s, G, res_s);
    float dist, lost, rate;
    rd_of<S>(res_s, tv_s, th_s, tmp, coef_s, lvl_s, red_d, red_i, tb, qd, qa,
             dist, lost, rate);
    const float cost = (dist + lost) * dist_w[m] + lam * (rate + ymb[m]);
    if (cost < best) { best = cost; bm = m; }
    __syncthreads();
  }
  if (n_tx <= 1) {
    if (tid == 0) {
      best_mode[n] = bm; best_tx[n] = 0; best_cost[n] = best; mode_cost0[n] = best;
    }
    return;
  }
  predict<S>(bm, refs_s, src_s, G, res_s);
  float bt_cost = INFINITY;
  int bt = 0;
  for (int t = 0; t < n_tx; ++t) {
    for (int p = tid; p < g::SS; p += blockDim.x) {
      tv_s[p] = tvs[(size_t)t * g::SS + p];
      th_s[p] = ths[(size_t)t * g::SS + p];
    }
    __syncthreads();
    tb.scan = scans_tx + (size_t)t * g::NK;
    float dist, lost, rate;
    rd_of<S>(res_s, tv_s, th_s, tmp, coef_s, lvl_s, red_d, red_i, tb, qd, qa,
             dist, lost, rate);
    const float c = (dist + lost) + lam * tls * (rate + ext_bits[t]);
    if (c < bt_cost) { bt_cost = c; bt = t; }
    __syncthreads();
  }
  if (tid == 0) {
    best_mode[n] = bm; best_tx[n] = bt;
    best_cost[n] = bt_cost + lam * ymb[bm];
    mode_cost0[n] = best;
  }
}

template <int S>
static int launch(const float* src, const float* refs, const float* qdc,
                  const float* qac, float lam, const float* G, const int* scan2d,
                  const int* scans_tx, const float* tvs, const float* ths,
                  const float* level_bits, const float* eob_bits,
                  const float* txb_skip, const float* ymb, const float* ext_bits,
                  const float* qm_w, const float* dist_w, float tls, int N,
                  int n_tx, int* bm, int* bt, float* bc, float* mc0,
                  cudaStream_t st) {
  const size_t sm = Geo<S>::smem;
  cudaError_t e = cudaFuncSetAttribute(
      intra_search_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (e != cudaSuccess) return (int)e;
  intra_search_kernel<S><<<N, SVT_NT, sm, st>>>(
      src, refs, qdc, qac, lam, G, scan2d, scans_tx, tvs, ths, level_bits,
      eob_bits, txb_skip, ymb, ext_bits, qm_w, dist_w, tls, n_tx, bm, bt, bc, mc0);
  return (int)cudaGetLastError();
}

extern "C" int intra_search_launch(
    const float* src, const float* refs, const float* qdc, const float* qac,
    float lam, const float* G, const int* scan2d, const int* scans_tx,
    const float* tvs, const float* ths, const float* level_bits,
    const float* eob_bits, const float* txb_skip, const float* ymb,
    const float* ext_bits, const float* qm_w, const float* dist_w, float tls,
    int N, int S, int n_tx, int* bm, int* bt, float* bc, float* mc0,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SVT_K1(SZ)                                                              \
  case SZ:                                                                      \
    return launch<SZ>(src, refs, qdc, qac, lam, G, scan2d, scans_tx, tvs, ths,  \
                      level_bits, eob_bits, txb_skip, ymb, ext_bits, qm_w,      \
                      dist_w, tls, N, n_tx, bm, bt, bc, mc0, st);
  switch (S) {
    SVT_K1(8)
    SVT_K1(16)
    SVT_K1(32)
    SVT_K1(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SVT_K1
}
