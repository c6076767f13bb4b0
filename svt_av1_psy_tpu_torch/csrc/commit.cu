// K6: the device residual commit of one (S, compound, luma tx type) group of
// inter leaves.
//
// Replaces svt_av1_psy_tpu/ops/commit.py: _group_program (:326), with the
// transforms of ops/txfm.py running as K5 launches between K6's two kernels:
//   commit_pred_kernel   one CUDA block per (lane, plane): the 8-tap (or 4-tap
//                        below 8 pels) 2-D subpel prediction from the clamped
//                        (h+7) x (w+7) patch at pad - 3 (single: convolve +
//                        round; compound: two jnt convolves and the average),
//                        then the residual against the clamped source block;
//   K5 forward           (txfm.cu) on the residual, in place in the lane buffers;
//   commit_quant_kernel  one CUDA block per (lane, plane): QM quantize in uint32
//                        hi/lo multiplies, eob over the scan, the RDOQ eob-fast
//                        trim, dequant into a zeroed block, the int16 scan-packed
//                        levels, the eobs and the overflow flag;
//   K5 inverse + add     (txfm.cu) into the packed recon output.
// Chroma runs after luma: its tx type follows the luma eob (_group_program:402),
// so K5 and the quantizer pick the variant per lane from meta_out[:, 0].
// Gathers take their start as jax.lax.dynamic_slice does (a negative start
// counts from the end, then clamps), so padding lanes (position 1 << 24) read
// inside the planes; their outputs are discarded.
// Bound on the H100: launch latency at the commit's lane counts (<= 2048 lanes,
// a few KB each); the prediction's 8 taps read the reference through L1.

#include "common.cuh"
#include "txfm.cuh"

struct PredArgs {
  const void* ref[3];   // per plane (2, ref_h, ref_w): LAST and the second ref
  const void* src[3];   // per plane (src_h, src_w)
  int ref_h[3], ref_w[3], src_h[3], src_w[3];
  const int* meta;      // (B, 8): y, x, mv_r, mv_c, mv2_r, mv2_c, ref_idx, q_sel
  const int* f8;        // (16, 8) subpel kernels, rows = phase
  const int* f4;
  int S, bd, is_comp, pad, ref_bytes, src_bytes, T;
  int* pred;            // (B, T) int32: luma, then u, v
  int* res;
};

struct QuantArgs {
  const int* coef;      // (B, T) forward transform output
  int* dq;              // (B, T) dequantized coefficients (zero outside)
  int T;
  const int* meta;
  const int* qtab;      // (U, 10) quant rows, gathered by q_sel
  int U;
  const int* qm[2];     // per variant: (n,) or null
  const int* iqm[2];
  const int* scan[2];   // per variant: (n,)
  int nvar, log_scale, Sp, plane0;
  int off[3];           // plane offsets in a lane
  short* lv;            // (B, lv_stride) scan-packed levels
  int lv_stride;
  int lv_off[3];
  int K;                // levels kept for this launch's planes
  int* meta_out;        // (B, 4): eob_y, eob_u, eob_v, over (zeroed)
  int nplanes, rdoq;
};

// The start jax.lax.dynamic_slice uses: a negative start counts from the end,
// then it clamps into [0, dim - size] (jnp indexing treats an index alike).
__device__ __forceinline__ int dslice(int s, int dim, int size) {
  return clamp_start(s < 0 ? s + dim : s, dim, size);
}

__device__ __forceinline__ int ld(const void* p, long long i, int bytes) {
  return bytes == 1 ? (int)((const unsigned char*)p)[i]
                    : (int)((const unsigned short*)p)[i];
}

// mode 0: single-reference convolve (_conv2d_batched); 1: jnt convolve into
// `out` (_jnt_conv_batched); 2: jnt convolve averaged into `out`
// (_compound_avg of out and the new buffer).
__device__ void conv_pass(const PredArgs& a, int pl, int ri, int ys, int xs, int w,
                          const int* fx, const int* fy, int mode, int* im, int* out) {
  const int h = w, Wp = a.ref_w[pl], bd = a.bd, peak = (1 << bd) - 1;
  const long long plane = (long long)a.ref_h[pl] * Wp;
  const void* ref = a.ref[pl];
  for (int e = threadIdx.x; e < (h + 7) * w; e += blockDim.x) {
    const int r = e / w, c = e - r * w;
    const long long base = ri * plane + (long long)(ys + r) * Wp + xs + c;
    int s = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += fx[k] * ld(ref, base + k, a.ref_bytes);
    im[e] = mode == 0 ? (s + (1 << (bd + 6)) + 4) >> 3
                      : ((1 << (bd + 6)) + s + 4) >> 3;
  }
  __syncthreads();
  const int ob = bd + 11;
  for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
    const int r = e / w, c = e - r * w;
    int s = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += fy[k] * im[(r + k) * w + c];
    if (mode == 0) {
      const int v = ((s + (1 << ob) + (1 << 10)) >> 11)
                    - ((1 << (ob - 11)) + (1 << (ob - 12)));
      out[e] = min(max(v, 0), peak);
    } else {
      const int b1 = ((1 << ob) + s + 64) >> 7;
      if (mode == 1) {
        out[e] = b1;
      } else {
        const int ro = (1 << (ob - 7)) + (1 << (ob - 8));
        const int t = ((((out[e] + b1) >> 1) - ro) + 8) >> 4;
        out[e] = min(max(t, 0), peak);
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(SVT_NT) commit_pred_kernel(PredArgs a) {
  extern __shared__ int sm[];
  const int b = blockIdx.x, pl = blockIdx.y;
  const int S = pl ? a.S >> 1 : a.S;
  int* im = sm;
  int* p = sm + (S + 7) * S;
  const int* m = a.meta + (long long)b * 8;
  const int py = pl ? m[0] >> 1 : m[0], px = pl ? m[1] >> 1 : m[1];
  const int* ft = S > 4 ? a.f8 : a.f4;
  const int Hp = a.ref_h[pl], Wp = a.ref_w[pl];
  for (int k = 0; k < (a.is_comp ? 2 : 1); ++k) {
    const int mr = m[2 + 2 * k], mc = m[3 + 2 * k];
    const int ipy = pl ? mr >> 4 : mr >> 3, phy = pl ? mr & 15 : (mr & 7) << 1;
    const int ipx = pl ? mc >> 4 : mc >> 3, phx = pl ? mc & 15 : (mc & 7) << 1;
    const int ri = a.is_comp ? k : dslice(m[6], 2, 1);
    const int ys = dslice(py + ipy + a.pad - 3, Hp, S + 7);
    const int xs = dslice(px + ipx + a.pad - 3, Wp, S + 7);
    conv_pass(a, pl, ri, ys, xs, S, ft + phx * 8, ft + phy * 8,
              a.is_comp ? 1 + k : 0, im, p);
  }
  const int sy = dslice(py, a.src_h[pl], S), sx = dslice(px, a.src_w[pl], S);
  const int S0 = a.S;
  const long long o = (long long)b * a.T + (pl == 0 ? 0 : pl == 1 ? S0 * S0
                                                      : S0 * S0 + S * S);
  const void* src = a.src[pl];
  for (int e = threadIdx.x; e < S * S; e += blockDim.x) {
    const int r = e / S, c = e - r * S;
    const int s = ld(src, (long long)(sy + r) * a.src_w[pl] + sx + c, a.src_bytes);
    a.pred[o + e] = p[e];
    a.res[o + e] = s - p[e];
  }
}

// floor((a * b) >> s) in uint32 with the hi/lo split of _mul_shift_u32
__device__ __forceinline__ unsigned mul_shift_u32(unsigned a, unsigned b, int s) {
  const unsigned hi = a >> 14, lo = a & 16383u;
  const unsigned p = hi * b, q = lo * b;
  if (s >= 14)
    return (p >> (s - 14)) + ((((p & ((1u << (s - 14)) - 1u)) << 14) + q) >> s);
  return (p << (14 - s)) + (q >> s);
}

__device__ __forceinline__ int shl(int x, int k) { return (int)((unsigned)x << k); }

__global__ void __launch_bounds__(SVT_NT) commit_quant_kernel(QuantArgs a) {
  __shared__ int qc[1024];
  __shared__ int fl[1024];
  __shared__ int red[SVT_NT / 32];
  const int b = blockIdx.x, pl = a.plane0 + blockIdx.y;
  const int W = a.Sp, cw = min(W, 32), n = cw * cw, ls = a.log_scale;
  const int v = (a.nvar > 1 && a.meta_out[(long long)b * 4] > 0) ? 1 : 0;
  const int* qm = a.qm[v];
  const int* iqm = a.iqm[v];
  const int* scan = a.scan[v];
  const int qsel = dslice(a.meta[(long long)b * 8 + 7], a.U, 1);
  const int* q = a.qtab + qsel * 10;
  const long long base = (long long)b * a.T + a.off[pl];
  int* dq = a.dq + base;
  const int* co = a.coef + base;
  for (int e = threadIdx.x; e < W * W; e += blockDim.x) dq[e] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / cw, c = i - r * cw;
    const int f = co[r * W + c];
    const bool ac = i != 0;
    const int zbin = rshift(ac ? q[1] : q[0], ls);
    const int rnd = rshift(ac ? q[3] : q[2], ls);
    const unsigned mq = (unsigned)wadd(ac ? q[5] : q[4], 1 << 16);
    const unsigned qs = (unsigned)(ac ? q[7] : q[6]);
    const int deq = ac ? q[9] : q[8];
    const int wt = qm ? qm[i] : 32, iwt = iqm ? iqm[i] : 32;
    const int aa = f < 0 ? wsub(0, f) : f;
    const bool live = wmul(aa, wt) >= shl(zbin, 5);
    const int tmpw = wmul(wadd(aa, rnd), wt);
    const unsigned x = mul_shift_u32((unsigned)tmpw, mq, 16);
    int abs_q = (int)mul_shift_u32(x, qs, 16 - ls + 5);
    if (!live) abs_q = 0;
    const int dequant = wadd(wmul(deq, iwt), 16) >> 5;
    const int abs_dq = (int)mul_shift_u32((unsigned)abs_q, (unsigned)dequant, ls);
    qc[i] = f < 0 ? wsub(0, abs_q) : abs_q;
    fl[i] = f;
    dq[r * W + c] = f < 0 ? wsub(0, abs_dq) : abs_dq;
  }
  __syncthreads();
  int e_loc = 0;
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    if (qc[scan[j]] != 0) e_loc = max(e_loc, j + 1);
  int eob = block_max_i(e_loc, red);
  if (a.rdoq) {   // update_coeff_eob_fast (_rdoq_trim)
    const int dc = q[8], acq = q[9];
    const int zdc = wadd(dc, wadd(wmul(dc, 70), 64) >> 7);
    const int zac = wadd(acq, wadd(wmul(acq, 70), 64) >> 7);
    int l = 0;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int i = scan[j];
      const int as = fl[i] < 0 ? wsub(0, fl[i]) : fl[i];
      const bool cond = shl(as, 1 + ls) < (i != 0 ? zac : zdc) || qc[i] == 0;
      if (!cond && j + 1 <= eob) l = max(l, j + 1);
    }
    const int ne = block_max_i(l, red);
    for (int j = ne + threadIdx.x; j < n; j += blockDim.x) {
      const int i = scan[j];
      qc[i] = 0;
      dq[(i / cw) * W + i % cw] = 0;
    }
    __syncthreads();
    eob = ne;
  }
  int mx = 0;
  short* lv = a.lv + (long long)b * a.lv_stride + a.lv_off[pl];
  for (int j = threadIdx.x; j < a.K; j += blockDim.x) {
    const int val = qc[scan[j]];
    lv[j] = (short)val;
    mx = max(mx, val < 0 ? wsub(0, val) : val);
  }
  mx = block_max_i(mx, red);
  if (threadIdx.x == 0) {
    int* mo = a.meta_out + (long long)b * 4;
    mo[pl] = eob;
    if (a.nplanes == 1) mo[1] = mo[2] = eob;
    if (eob > a.K || mx > 32767) atomicOr(mo + 3, 1);
  }
}

// Parameters come as host int64 arrays (the layouts ops/commit.py builds):
// pred: ref[3], src[3], ref_h[3], ref_w[3], src_h[3], src_w[3], meta, f8, f4,
//       S, bd, is_comp, pad, ref_bytes, src_bytes, T, pred, res   (30 values)
// quant: coef, dq, T, meta, qtab, U, qm[2], iqm[2], scan[2], nvar, log_scale,
//        Sp, plane0, off[3], lv, lv_stride, lv_off[3], K, meta_out, nplanes,
//        rdoq                                                     (28 values)
#define PTR(T, v) ((T)(uintptr_t)(v))

extern "C" int commit_pred_launch(const long long* p, int B, int nplanes,
                                  cudaStream_t st) {
  if (B <= 0) return 0;
  PredArgs a;
  for (int i = 0; i < 3; ++i) {
    a.ref[i] = PTR(const void*, p[i]);
    a.src[i] = PTR(const void*, p[3 + i]);
    a.ref_h[i] = (int)p[6 + i]; a.ref_w[i] = (int)p[9 + i];
    a.src_h[i] = (int)p[12 + i]; a.src_w[i] = (int)p[15 + i];
  }
  a.meta = PTR(const int*, p[18]); a.f8 = PTR(const int*, p[19]);
  a.f4 = PTR(const int*, p[20]);
  a.S = (int)p[21]; a.bd = (int)p[22]; a.is_comp = (int)p[23]; a.pad = (int)p[24];
  a.ref_bytes = (int)p[25]; a.src_bytes = (int)p[26]; a.T = (int)p[27];
  a.pred = PTR(int*, p[28]); a.res = PTR(int*, p[29]);
  const size_t sh = (size_t)((a.S + 7) * a.S + a.S * a.S) * sizeof(int);
  commit_pred_kernel<<<dim3(B, nplanes), SVT_NT, sh, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int commit_quant_launch(const long long* p, int B, int nplanes_launch,
                                   cudaStream_t st) {
  if (B <= 0) return 0;
  QuantArgs a;
  a.coef = PTR(const int*, p[0]); a.dq = PTR(int*, p[1]); a.T = (int)p[2];
  a.meta = PTR(const int*, p[3]); a.qtab = PTR(const int*, p[4]); a.U = (int)p[5];
  for (int v = 0; v < 2; ++v) {
    a.qm[v] = PTR(const int*, p[6 + v]);
    a.iqm[v] = PTR(const int*, p[8 + v]);
    a.scan[v] = PTR(const int*, p[10 + v]);
  }
  a.nvar = (int)p[12]; a.log_scale = (int)p[13]; a.Sp = (int)p[14];
  a.plane0 = (int)p[15];
  for (int i = 0; i < 3; ++i) { a.off[i] = (int)p[16 + i]; a.lv_off[i] = (int)p[21 + i]; }
  a.lv = PTR(short*, p[19]); a.lv_stride = (int)p[20]; a.K = (int)p[24];
  a.meta_out = PTR(int*, p[25]); a.nplanes = (int)p[26]; a.rdoq = (int)p[27];
  if (a.Sp < 4 || a.Sp > 64) return (int)cudaErrorInvalidValue;   // qc / fl hold 32 x 32
  commit_quant_kernel<<<dim3(B, nplanes_launch), SVT_NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}
