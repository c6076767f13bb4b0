// K5 device code: the AV1 forward and inverse 2-D transforms on one lane's
// H x W block in shared memory (included by txfm.cu and commit.cu).
//
// Mirrors svt_av1_psy_tpu/ops/txfm.py:29-185. The 1-D transforms interpret the
// butterfly stage tables of codec/transforms.compiled_stages, uploaded by the
// wrapper as int32 (stages, 5, n) arrays [A, B, wa, wb, kind] with kind 0 pass,
// 1 clamped add/sub (inverse), 2 butterfly with round shift. Every operation
// is int32 and wraps as the JAX program's int32 does (the arithmetic goes
// through unsigned, where overflow is defined); nothing is widened, so the
// clamps act on the same values.
#pragma once

#include <stdint.h>

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
// round_shift(x, bit): (x + 2^(bit-1)) >> bit for bit > 0, x << -bit below
__device__ __forceinline__ int rshift(int x, int bit) {
  if (bit == 0) return x;
  if (bit > 0) return wadd(x, 1 << (bit - 1)) >> bit;
  return (int)((unsigned)x << (-bit));
}
__device__ __forceinline__ int clampb(int x, int bit) {
  const int lo = -(1 << (bit - 1)), hi = (1 << (bit - 1)) - 1;
  return min(max(x, lo), hi);
}

#define TX_GRAPH 0
#define TX_ADST4 1
#define TX_IDENT 2

struct Tx1D {
  const int* g;   // (nst, 5, n) stage table, TX_GRAPH only
  int kind, n, cos_bit, nst, clamp;   // clamp 0: none
};

struct Tx2D {
  Tx1D col, row;
  int H, W, ud, lr, rect;
  int s0, s1, s2;            // FWD_SHIFT[ts] or INV_SHIFT[ts] (s2 unused)
  int clamp_in, clamp_mid, bd;
};

// Host side: the 23-value int64 spec built by ops/txfm.py tx_spec.
static inline Tx1D tx1d_from(const long long* p) {
  Tx1D t;
  t.g = (const int*)(uintptr_t)p[0];
  t.kind = (int)p[1]; t.n = (int)p[2]; t.cos_bit = (int)p[3];
  t.nst = (int)p[4]; t.clamp = (int)p[5];
  return t;
}
static inline Tx2D tx2d_from(const long long* p) {
  Tx2D s;
  s.col = tx1d_from(p);
  s.row = tx1d_from(p + 6);
  s.H = (int)p[12]; s.W = (int)p[13]; s.ud = (int)p[14]; s.lr = (int)p[15];
  s.rect = (int)p[16]; s.s0 = (int)p[17]; s.s1 = (int)p[18]; s.s2 = (int)p[19];
  s.clamp_in = (int)p[20]; s.clamp_mid = (int)p[21]; s.bd = (int)p[22];
  return s;
}

__device__ __forceinline__ int identity1d(int x, int n) {
  switch (n) {
    case 4: return rshift(wmul(x, 5793), 12);
    case 8: return wmul(x, 2);
    case 16: return rshift(wmul(wmul(x, 2), 5793), 12);
    case 32: return wmul(x, 4);
    default: return rshift(wmul(wmul(x, 4), 5793), 12);
  }
}

// sinpi[1..4] of codec/transforms._SINPI
__device__ __forceinline__ void sinpi4(int bit, int& s1, int& s2, int& s3, int& s4) {
  switch (bit) {
    case 10: s1 = 330; s2 = 621; s3 = 836; s4 = 951; break;
    case 11: s1 = 660; s2 = 1241; s3 = 1672; s4 = 1901; break;
    case 12: s1 = 1321; s2 = 2482; s3 = 3344; s4 = 3803; break;
    case 13: s1 = 2642; s2 = 4964; s3 = 6689; s4 = 7606; break;
    case 14: s1 = 5283; s2 = 9929; s3 = 13377; s4 = 15212; break;
    case 15: s1 = 10566; s2 = 19858; s3 = 26755; s4 = 30424; break;
    default: s1 = 21133; s2 = 39716; s3 = 53510; s4 = 60849; break;
  }
}

// Output i of adst4 (ops/txfm.py _adst4_jnp) on x0..x3.
__device__ __forceinline__ int adst4_out(int i, int x0, int x1, int x2, int x3,
                                         int bit, bool inverse) {
  int s1_, s2_, s3_, s4_;
  sinpi4(bit, s1_, s2_, s3_, s4_);
  int o;
  if (inverse) {
    const int s0 = wadd(wadd(wmul(s1_, x0), wmul(s4_, x2)), wmul(s2_, x3));
    const int s1 = wsub(wsub(wmul(s2_, x0), wmul(s1_, x2)), wmul(s4_, x3));
    const int s3 = wmul(s3_, x1);
    const int s2 = wmul(s3_, wadd(wsub(x0, x2), x3));
    o = i == 0 ? wadd(s0, s3) : i == 1 ? wadd(s1, s3) : i == 2 ? s2
                                : wsub(wadd(s0, s1), s3);
  } else {
    const int s7 = wsub(wadd(x0, x1), x3);
    const int a0 = wadd(wadd(wmul(s1_, x0), wmul(s2_, x1)), wmul(s4_, x3));
    const int a1 = wmul(s3_, s7);
    const int a2 = wadd(wsub(wmul(s4_, x0), wmul(s1_, x1)), wmul(s2_, x3));
    const int a3 = wmul(s3_, x2);
    o = i == 0 ? wadd(a0, a3) : i == 1 ? a1 : i == 2 ? wsub(a2, a3)
                                : wadd(wsub(a2, a0), a3);
  }
  return rshift(o, bit);
}

// One 1-D pass over M vectors of length t.n; element i of vector m sits at
// m * vs + i * es. Input in `a`, `b` is scratch; returns the buffer holding the
// result. Every thread of the block must call it (it synchronises).
__device__ int* tx1d(const Tx1D& t, bool inverse, int* a, int* b, int M, int vs,
                     int es) {
  const int n = t.n, N = M * n;
  if (t.kind == TX_IDENT) {
    for (int idx = threadIdx.x; idx < N; idx += blockDim.x) {
      const int m = idx / n, i = idx - m * n, o = m * vs + i * es;
      a[o] = identity1d(a[o], n);
    }
    __syncthreads();
    return a;
  }
  if (t.kind == TX_ADST4) {
    for (int idx = threadIdx.x; idx < N; idx += blockDim.x) {
      const int m = idx / 4, i = idx - m * 4, o = m * vs;
      b[o + i * es] = adst4_out(i, a[o], a[o + es], a[o + 2 * es], a[o + 3 * es],
                                t.cos_bit, inverse);
    }
    __syncthreads();
    return b;
  }
  int* cur = a;
  int* nxt = b;
  for (int s = 0; s < t.nst; ++s) {
    const int* A = t.g + (s * 5) * n;
    const int* B = A + n;
    const int* wa = B + n;
    const int* wb = wa + n;
    const int* kd = wb + n;
    for (int idx = threadIdx.x; idx < N; idx += blockDim.x) {
      const int m = idx / n, i = idx - m * n, base = m * vs;
      const int acc = wadd(wmul(wa[i], cur[base + A[i] * es]),
                           wmul(wb[i], cur[base + B[i] * es]));
      const int k = kd[i];
      nxt[base + i * es] = k == 2 ? rshift(acc, t.cos_bit)
                         : (k == 1 && t.clamp) ? clampb(acc, t.clamp) : acc;
    }
    __syncthreads();
    int* tmp = cur; cur = nxt; nxt = tmp;
  }
  return cur;
}

// Forward 2-D transform (ops/txfm.py forward_transform_2d) of the raster
// H x W residual in `a`; `b` is scratch. Returns the buffer with the
// coefficients (raster H x W).
__device__ int* fwd2d(const Tx2D& p, int* a, int* b) {
  const int H = p.H, W = p.W, HW = H * W;
  for (int e = threadIdx.x; e < HW; e += blockDim.x) {
    const int r = e / W, c = e - r * W;
    b[e] = rshift(a[(p.ud ? H - 1 - r : r) * W + c], -p.s0);
  }
  __syncthreads();
  int* x = tx1d(p.col, false, b, a, W, 1, W);          // columns: length H
  int* y = x == a ? b : a;
  for (int e = threadIdx.x; e < HW; e += blockDim.x) {
    const int r = e / W, c = e - r * W;
    y[e] = rshift(x[r * W + (p.lr ? W - 1 - c : c)], -p.s1);
  }
  __syncthreads();
  x = tx1d(p.row, false, y, x, H, W, 1);                // rows: length W
  for (int e = threadIdx.x; e < HW; e += blockDim.x) {
    const int r = e / W, c = e - r * W;
    int v = rshift(x[e], -p.s2);
    if (p.rect) v = rshift(wmul(v, 5793), 12);
    if ((W == 64 && c >= 32) || (H == 64 && r >= 32)) v = 0;
    x[e] = v;
  }
  __syncthreads();
  return x;
}

// Inverse 2-D transform (ops/txfm.py inverse_transform_add, before the add)
// of the raster H x W coefficients in `a`; `b` is scratch. Returns the buffer
// holding the residual in raster order (flips applied).
__device__ int* inv2d(const Tx2D& p, int* a, int* b) {
  const int H = p.H, W = p.W, HW = H * W;
  for (int e = threadIdx.x; e < HW; e += blockDim.x) {
    const int r = e / W, c = e - r * W;
    int v = a[e];
    if ((W == 64 && c >= 32) || (H == 64 && r >= 32)) v = 0;
    if (p.rect) v = rshift(wmul(v, 2896), 12);
    a[e] = clampb(v, p.clamp_in);
  }
  __syncthreads();
  int* x = tx1d(p.row, true, a, b, H, W, 1);             // rows: length W
  int* y = x == a ? b : a;
  for (int e = threadIdx.x; e < HW; e += blockDim.x) {
    const int r = e / W, c = e - r * W;
    y[e] = clampb(rshift(x[r * W + (p.lr ? W - 1 - c : c)], -p.s0), p.clamp_mid);
  }
  __syncthreads();
  x = tx1d(p.col, true, y, x, W, 1, W);                  // columns: length H
  y = x == a ? b : a;
  for (int e = threadIdx.x; e < HW; e += blockDim.x) {
    const int r = e / W, c = e - r * W;
    y[e] = rshift(x[(p.ud ? H - 1 - r : r) * W + c], -p.s1);
  }
  __syncthreads();
  return y;
}
