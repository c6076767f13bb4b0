// K3: the candidate ladder and decision of every BWxBH block of a frame.
//
// Replaces svt_av1_psy_tpu/ops/inter_search.py:depth_stage. One CUDA block per
// output block: per reference the argmin of aggregated child SSD +
// lambda * MV_BITS over both HME centres (grid_argmin.cuh, shared with K4),
// the NEWMV prediction against the GLOBALMV / zero candidate, then the
// compound average with its 1/16 margin, the tune bias and the 5-mode
// open-loop intra fallback (DC/V/H/SMOOTH/PAETH from source neighbours).
// Every candidate costs SSE + psy_scale * sum |E(src) - E(pred)| over 8x8
// tiles, E = SA8D - SAD/4 via the 8x8 Hadamard.
//
// Numbers: predictions are kept doubled as integers (the compound average is
// a half-integer), SSE in int64, tile energies exactly in float64, and each
// sum rounds to float32 once -- the same arithmetic as the plain PyTorch
// version, so rows and costs agree bit for bit.
// Bound on the H100: reading the child grids once per block shape; all
// candidate predictions live in shared memory (<= 96 KB at 64x64).

#include "common.cuh"
#include "grid_argmin.cuh"

__constant__ int HAD8[64] = {
    1, 1, 1, 1, 1, 1, 1, 1,     1, -1, 1, -1, 1, -1, 1, -1,
    1, 1, -1, -1, 1, 1, -1, -1, 1, -1, -1, 1, 1, -1, -1, 1,
    1, 1, 1, 1, -1, -1, -1, -1, 1, -1, 1, -1, -1, 1, -1, 1,
    1, 1, -1, -1, -1, -1, 1, 1, 1, -1, -1, 1, -1, 1, 1, -1};

// smooth weights for 8, 16, 32, 64 at offsets 0, 8, 24, 56 (spec 7.11.2)
__constant__ int SMW[120] = {
    255, 197, 146, 105, 73, 50, 37, 32,
    255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26, 20, 17, 16,
    255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111, 101, 92, 83, 74,
    66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14, 12, 10, 9, 8, 8,
    255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176, 169, 163, 156, 150,
    144, 138, 133, 127, 121, 116, 111, 106, 101, 96, 91, 86, 82, 77, 73, 69,
    65, 61, 57, 54, 50, 47, 44, 41, 38, 35, 32, 29, 27, 25, 22, 20,
    18, 16, 15, 13, 12, 10, 9, 8, 7, 6, 6, 5, 5, 4, 4, 4};

__device__ __forceinline__ int smw_off(int s) {
  return s == 8 ? 0 : (s == 16 ? 8 : (s == 32 ? 24 : 56));
}

struct Ctx {
  int BW, BH, kkw, kk, npx;
  float psy_scale;
  const int* s2;
  int *h1, *h2;
  double *e_src, *e_p, *red_d;
  long long* red_ll;
};

// Exact SA8D - SAD/4 of every 8x8 tile of the doubled block P2 -> e[kk].
__device__ void tile_energy(const int* P2, const Ctx& c, double* e) {
  const int nt = c.kk * 64;
  for (int o = threadIdx.x; o < nt; o += blockDim.x) {
    const int t = o >> 6, i = (o >> 3) & 7, k = o & 7;
    const int* tp = P2 + (t / c.kkw) * 8 * c.BW + (t % c.kkw) * 8;
    int acc = 0;
    for (int j = 0; j < 8; ++j) acc += HAD8[i * 8 + j] * tp[j * c.BW + k];
    c.h1[o] = acc;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < nt; o += blockDim.x) {
    const int* hp = c.h1 + (o & ~7);
    const int l = o & 7;
    int acc = 0;
    for (int k = 0; k < 8; ++k) acc += hp[k] * HAD8[l * 8 + k];
    c.h2[o] = abs(acc);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < c.kk; t += blockDim.x) {
    long long T2 = 0, sad2 = 0;
    for (int q = 0; q < 64; ++q) T2 += c.h2[t * 64 + q];
    const int* tp = P2 + (t / c.kkw) * 8 * c.BW + (t % c.kkw) * 8;
    for (int j = 0; j < 8; ++j)
      for (int k = 0; k < 8; ++k) sad2 += tp[j * c.BW + k];
    e[t] = ((double)T2 * 0.5 + 2.0) * 0.25 - (double)sad2 * 0.5 * 0.25;
  }
  __syncthreads();
}

// SSE + psy cost of the doubled prediction P2 (every thread gets it).
__device__ float cand_cost(const int* P2, const Ctx& c) {
  long long s = 0;
  for (int p = threadIdx.x; p < c.npx; p += blockDim.x) {
    const long long d = (long long)(c.s2[p] - P2[p]);
    s += d * d;
  }
  const long long sse4 = block_sum_ll(s, c.red_ll);
  tile_energy(P2, c, c.e_p);
  double ps = 0.0;
  for (int t = 0; t < c.kk; ++t) ps += fabs(c.e_src[t] - c.e_p[t]);
  const float sse = (float)((double)sse4 * 0.25);
  return sse + (float)ps * c.psy_scale;
}

__device__ void gather2(const float* __restrict__ ref, int Hr, int Wr, int ys,
                        int xs, int BH, int BW, int* dst) {
  ys = clamp_start(ys, Hr, BH);
  xs = clamp_start(xs, Wr, BW);
  for (int p = threadIdx.x; p < BH * BW; p += blockDim.x)
    dst[p] = 2 * (int)ref[(size_t)(ys + p / BW) * Wr + xs + p % BW];
  __syncthreads();
}

__global__ void __launch_bounds__(SVT_NT) inter_decide_kernel(
    const float* __restrict__ src, const float* __restrict__ ref_l,
    const float* __restrict__ ref_a, const int* __restrict__ cy_l,
    const int* __restrict__ cx_l, const int* __restrict__ g_l,
    const int* __restrict__ cy_a, const int* __restrict__ cx_a,
    const int* __restrict__ g_a, const float* __restrict__ pvec, int Hp, int Wp,
    int BW, int BH, int two_ref, int bd, int PAD, const float* __restrict__ mvb,
    int* __restrict__ rows, float* __restrict__ cost) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npx = BW * BH, kkh = BH / 8, kkw = BW / 8, kk = kkh * kkw;
  double* e_src = (double*)smem;
  double* e_p = e_src + 64;
  double* red_d = e_p + 64;
  long long* red_ll = (long long*)(red_d + 8);
  float* redv = (float*)(red_ll + 8);
  int* redi = (int*)(redv + 8);
  int* A = redi + 8;
  int* Lc = A + 64;
  int* misc = Lc + 64;          // corner, dc
  int* s2 = misc + 8;
  int* pb0 = s2 + npx;
  int* pb1 = pb0 + npx;
  int* pc = pb1 + npx;
  int* h1 = pc + npx;
  int* h2 = h1 + npx;

  const int blk = blockIdx.x, gcn = Wp / BW, bi = blk / gcn, bj = blk % gcn;
  const int y0 = bi * BH, x0 = bj * BW;
  const int Hr = Hp + 2 * PAD, Wr = Wp + 2 * PAD;
  const int nsc = Wp / 64, n = (Hp / 64) * nsc, kh = 64 / BH, kw = 64 / BW;
  const int sb = (bi / kh) * nsc + bj / kw;
  const int cr0 = (bi % kh) * kkh, cc0 = (bj % kw) * kkw;
  const int gm0 = (int)pvec[0], gm1 = (int)pvec[1];
  const float lam = pvec[2], psy_rd = pvec[3], bias_pct = pvec[4];
  Ctx c{BW, BH, kkw, kk, npx, psy_rd * (bd == 8 ? 0.5f : 4.0f), s2, h1, h2,
        e_src, e_p, red_d, red_ll};

  for (int p = threadIdx.x; p < npx; p += blockDim.x)
    s2[p] = 2 * (int)src[(size_t)(y0 + p / BW) * Wp + x0 + p % BW];
  __syncthreads();
  tile_energy(s2, c, e_src);

  float c_r[2];
  int my_r[2], mx_r[2];
  bool new_r[2];
  const int nref = two_ref ? 2 : 1;
  for (int ri = 0; ri < nref; ++ri) {
    const float* ref = ri ? ref_a : ref_l;
    const int* cy = ri ? cy_a : cy_l;
    const int* cx = ri ? cx_a : cx_l;
    int* pb = ri ? pb1 : pb0;
    int sel, off;
    grid_argmin(ri ? g_a : g_l, n, sb, cr0, cc0, kkh, kkw, lam, mvb, redv, redi,
                sel, off);
    const int mvy = cy[sel * n + sb] + off / SVT_G - SVT_R;
    const int mvx = cx[sel * n + sb] + off % SVT_G - SVT_R;
    gather2(ref, Hr, Wr, y0 + PAD + mvy, x0 + PAD + mvx, BH, BW, pb);
    const float c_new = cand_cost(pb, c);
    int oy = PAD, ox = PAD, zy = 0, zx = 0;
    if (ri == 0) {
      oy = min(max(PAD + gm0, 0), Hr - Hp);
      ox = min(max(PAD + gm1, 0), Wr - Wp);
      zy = gm0;
      zx = gm1;
    }
    gather2(ref, Hr, Wr, y0 + oy, x0 + ox, BH, BW, pc);
    const float c_zg = cand_cost(pc, c);
    const bool nw = (c_new < c_zg) && (c_zg > (float)((BW * BH) << 2));
    if (!nw)
      for (int p = threadIdx.x; p < npx; p += blockDim.x) pb[p] = pc[p];
    __syncthreads();
    c_r[ri] = nw ? c_new : c_zg;
    my_r[ri] = nw ? mvy : zy;
    mx_r[ri] = nw ? mvx : zx;
    new_r[ri] = nw;
  }
  bool a_wins = false, use_comp = false;
  float inter_cost = c_r[0];
  if (two_ref) {
    a_wins = c_r[1] < c_r[0];
    const float bs = a_wins ? c_r[1] : c_r[0];
    for (int p = threadIdx.x; p < npx; p += blockDim.x) pc[p] = (pb0[p] + pb1[p]) / 2;
    __syncthreads();
    const float c_c = cand_cost(pc, c);
    use_comp = c_c < bs - bs * 0.0625f;
    inter_cost = use_comp ? c_c : bs;
  } else {
    my_r[1] = my_r[0];
    mx_r[1] = mx_r[0];
    new_r[1] = new_r[0];
  }
  const float inter_biased = inter_cost * (bias_pct * 0.01f);

  // open-loop intra fallback from source neighbours
  if (threadIdx.x == 0) {
    const bool have_a = bi > 0, have_l = bj > 0;
    const int base = 1 << (bd - 1);
    const int l0 = have_l ? (int)src[(size_t)y0 * Wp + x0 - 1] : 0;
    const int a0 = have_a ? (int)src[(size_t)(y0 - 1) * Wp + x0] : 0;
    const int fill_a = have_l ? l0 : base, fill_l = have_a ? a0 : base;
    long long sa = 0, sl = 0;
    for (int x = 0; x < BW; ++x) {
      A[x] = have_a ? (int)src[(size_t)(y0 - 1) * Wp + x0 + x] : fill_a;
      sa += A[x];
    }
    for (int y = 0; y < BH; ++y) {
      Lc[y] = have_l ? (int)src[(size_t)(y0 + y) * Wp + x0 - 1] : fill_l;
      sl += Lc[y];
    }
    misc[0] = (have_a && have_l) ? (int)src[(size_t)(y0 - 1) * Wp + x0 - 1]
              : (have_a ? A[0] : (have_l ? Lc[0] : base));
    const int np2 = BH + BW;
    misc[1] = (have_a && have_l) ? (int)((sa + sl + np2 / 2) / np2)
              : (have_a ? (int)((sa + BW / 2) / BW)
                        : (have_l ? (int)((sl + BH / 2) / BH) : base));
  }
  __syncthreads();
  float best_ic = INFINITY;
  int best_im = 0;
  const int* wv = SMW + smw_off(BH);
  const int* wh = SMW + smw_off(BW);
  for (int k = 0; k < 5; ++k) {
    for (int p = threadIdx.x; p < npx; p += blockDim.x) {
      const int y = p / BW, x = p % BW;
      int v;
      if (k == 0) v = misc[1];
      else if (k == 1) v = A[x];
      else if (k == 2) v = Lc[y];
      else if (k == 3)
        v = (wv[y] * A[x] + (256 - wv[y]) * Lc[BH - 1] + wh[x] * Lc[y] +
             (256 - wh[x]) * A[BW - 1] + 256) >> 9;
      else {
        const int t = A[x], l = Lc[y], tl = misc[0];
        const int pbse = t + l - tl;
        const int pl = abs(pbse - l), pt = abs(pbse - t), ptl = abs(pbse - tl);
        v = (pl <= pt && pl <= ptl) ? l : (pt <= ptl ? t : tl);
      }
      pc[p] = 2 * v;
    }
    __syncthreads();
    const float ck = cand_cost(pc, c);
    if (ck < best_ic) { best_ic = ck; best_im = k; }
  }
  if (!(inter_cost > (float)((BW * BH) << 1))) best_ic = INFINITY;
  if (threadIdx.x == 0) {
    const bool ui = inter_biased <= best_ic;
    const int imodes[5] = {0, 1, 2, 9, 12};
    const int single_ref = a_wins ? 4 : 1;
    const int single_mode = (a_wins ? new_r[1] : new_r[0]) ? 16 : 15;
    const int single_my = a_wins ? my_r[1] : my_r[0];
    const int single_mx = a_wins ? mx_r[1] : mx_r[0];
    const int col_ref = use_comp ? 7 : single_ref;
    const int col_mode = use_comp ? 24 : single_mode;
    const int col_my = (use_comp ? my_r[0] : single_my) * 8;
    const int col_mx = (use_comp ? mx_r[0] : single_mx) * 8;
    int* row = rows + (size_t)blk * 8;
    row[0] = ui ? 1 : 0;
    row[1] = ui ? col_ref : 0;
    row[2] = ui ? col_mode : imodes[best_im];
    row[3] = ui ? col_my : 0;
    row[4] = ui ? col_mx : 0;
    row[5] = (use_comp ? my_r[1] : single_my) * 8;
    row[6] = (use_comp ? mx_r[1] : single_mx) * 8;
    row[7] = 0;
    cost[blk] = fminf(inter_biased, best_ic);
  }
}

extern "C" int inter_decide_launch(
    const float* src, const float* ref_l, const float* ref_a, const int* cy_l,
    const int* cx_l, const int* g_l, const int* cy_a, const int* cx_a,
    const int* g_a, const float* pvec, int Hp, int Wp, int BW, int BH,
    int two_ref, int bd, int PAD, const float* mvb, int* rows, float* cost,
    void* stream) {
  const int npx = BW * BH;
  const size_t sm = 136 * 8 + 8 * 8 + 8 * 4 + (8 + 64 + 64 + 8) * 4 + (size_t)6 * npx * 4;
  cudaError_t e = cudaFuncSetAttribute(
      inter_decide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (e != cudaSuccess) return (int)e;
  const int nblk = (Hp / BH) * (Wp / BW);
  inter_decide_kernel<<<nblk, SVT_NT, sm, (cudaStream_t)stream>>>(
      src, ref_l, ref_a, cy_l, cx_l, g_l, cy_a, cx_a, g_a, pvec, Hp, Wp, BW, BH,
      two_ref, bd, PAD, mvb, rows, cost);
  return (int)cudaGetLastError();
}
