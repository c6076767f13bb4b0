// K8: batched CDEF filter of the non-skipped blocks of one plane.
//
// Replaces svt_av1_psy_tpu/ops/filters.py: cdef_filter_blocks (the mirror of
// codec/cdef.filter_blocks). One thread per output pixel: the two primary
// taps along the block direction and the four secondary taps along dir +/- 2,
// each at distance 1 and 2 in both signs, with the constrain
// sign(d) * min(|d|, max(0, th - (|d| >> shift))) (th == 0 gives 0),
// shift = max(0, damping - floor(log2(th))); CDEF_VERY_LARGE (the unavailable
// border) is left out of the max only; then x + ((8 + sum - (sum < 0)) >> 4)
// clipped to [min, max] of the taps read. Integer throughout, bit-exact.
// The direction, primary tap and secondary tap tables are codec/cdef.py's
// _DIRS, _PRI_TAPS and _SEC_TAPS, uploaded by the wrapper.
// Bound on the H100: reading the (bh+4) x (bw+4) neighbourhoods (2.25x the
// output for luma, 4x for chroma); each pixel's 12 taps come from L1.

#include "common.cuh"

#define CDEF_VERY_LARGE 0x7F7F

__device__ __forceinline__ int cdef_constrain(int d, int th, int shift) {
  if (th == 0) return 0;
  const int ad = abs(d);
  const int c = min(ad, max(0, th - (ad >> shift)));
  return d < 0 ? -c : (d > 0 ? c : 0);
}

__global__ void __launch_bounds__(SVT_NT) cdef_kernel(
    const int* __restrict__ nb, const int* __restrict__ dirs,
    const int* __restrict__ pri_strength, const int* __restrict__ dirs_tab,
    const int* __restrict__ pri_taps, const int* __restrict__ sec_taps, int N,
    int sec, int pri_damping, int sec_damping, int bw, int bh, int bd,
    int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int per = bw * bh;
  if (i >= N * per) return;
  const int b = i / per, y = (i % per) / bw, x = i % bw;
  const int W4 = bw + 4;
  const int* p0 = nb + (size_t)b * (bh + 4) * W4 + (y + 2) * W4 + (x + 2);
  const int xv = p0[0];
  const int pri = pri_strength[b], dir = dirs[b];
  const int tap = (pri >> (bd - 8)) & 1;
  const int shift_p = max(0, pri_damping - (31 - __clz(max(pri, 1))));
  const int shift_s = max(0, sec_damping - (31 - __clz(max(sec, 1))));
  int sum = 0, mx = xv, mn = xv;
  for (int k = 0; k < 2; ++k) {
    const int ptap = pri_taps[tap * 2 + k], stap = sec_taps[tap * 2 + k];
    const int dy = dirs_tab[(dir * 2 + k) * 2], dx = dirs_tab[(dir * 2 + k) * 2 + 1];
    for (int sgn = 1; sgn >= -1; sgn -= 2) {
      const int p = p0[sgn * (dy * W4 + dx)];
      sum += ptap * cdef_constrain(p - xv, pri, shift_p);
      if (p != CDEF_VERY_LARGE) mx = max(mx, p);
      mn = min(mn, p);
    }
    for (int delta = 2; delta >= -2; delta -= 4) {
      const int d2 = (dir + delta) & 7;
      const int sdy = dirs_tab[(d2 * 2 + k) * 2], sdx = dirs_tab[(d2 * 2 + k) * 2 + 1];
      for (int sgn = 1; sgn >= -1; sgn -= 2) {
        const int s = p0[sgn * (sdy * W4 + sdx)];
        sum += stap * cdef_constrain(s - xv, sec, shift_s);
        if (s != CDEF_VERY_LARGE) mx = max(mx, s);
        mn = min(mn, s);
      }
    }
  }
  const int v = xv + ((8 + sum - (sum < 0)) >> 4);
  out[i] = min(max(v, mn), mx);
}

extern "C" int cdef_launch(const int* nb, const int* dirs, const int* pri_strength,
                           const int* dirs_tab, const int* pri_taps,
                           const int* sec_taps, int N, int sec, int pri_damping,
                           int sec_damping, int bw, int bh, int bd, int* out,
                           void* stream) {
  const long long total = (long long)N * bw * bh;
  if (total == 0) return 0;
  cdef_kernel<<<(int)((total + SVT_NT - 1) / SVT_NT), SVT_NT, 0,
                (cudaStream_t)stream>>>(nb, dirs, pri_strength, dirs_tab,
                                         pri_taps, sec_taps, N, sec, pri_damping,
                                         sec_damping, bw, bh, bd, out);
  return (int)cudaGetLastError();
}
