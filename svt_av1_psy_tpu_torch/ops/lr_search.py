"""Kernel K9: the device SGRPROJ parameter sweep (`csrc/lr_search.cu`).

Replaces `svt_av1_psy_tpu/ops/lr_search.py:_sgr_stats`; `sgr_search_units`
is the reference's host driver with the call moved to the port. For every
candidate ep of one plane: the whole-plane self-guided filter pair (edge-
truncated box sums over the edge-padded plane, the A/B transform, the r0
even/odd-row blend and the r1 3x3 blend) and the per-tile Gram /
correlation sums [f0 f0, f0 f1, f1 f1, f0 d, f1 d, d d].

Exactness: the box sums, the filters and the tile sums are exact integers
(int64 sums of integer products, returned as float64). The z index of the
A/B transform rounds as the JAX program rounds it, floor((f32(p) f32(s) +
2^19) / 2^20) in IEEE float32: the reference's documented +/-1 drift at
table boundaries (a search-only drift; the committed filter is the exact
host one), kept so that the port picks what the reference picks. The JAX
program's tile sums are float32 products summed in float32, which this port
does not reproduce: they agree to a relative 1e-5 of each sum's scale.

Bound on the H100: the box sums and the A/B grids' traffic (two int32
planes per (ep, radius)); the tile pass is one CUDA block per (tile, ep).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from svt_av1_psy_tpu.codec.sgr import (ONE_BY_X, SGR_PARAMS,
                                       SGRPROJ_MTABLE_BITS, SGRPROJ_RECIP_BITS,
                                       SGRPROJ_RST_BITS, SGRPROJ_SGR,
                                       SGRPROJ_SGR_BITS, X_BY_XPLUS1,
                                       _encode_xq, decode_xq)

from . import _build

_BORDER = 3
_I64 = torch.int64
_F32 = torch.float32

calls = {"kernel": 0, "plain": 0}


def _rpot(x, n):
    return (x + (1 << (n - 1))) >> n if n > 0 else x


# ------------------------------------------------------------ plain version
def _box_grid(dgd, r):
    """(2r+1)^2 box sums of dgd and dgd^2 on the (H+2, W+2) A/B grid (grid
    point (i, j) centres on dgd (i-1, j-1)), over the edge-padded plane."""
    H, W = dgd.shape
    dev = dgd.device
    ri = torch.arange(-1 - r, H + 1 + r, device=dev).clamp_(0, H - 1)
    ci = torch.arange(-1 - r, W + 1 + r, device=dev).clamp_(0, W - 1)
    ext = dgd.to(_I64)[ri][:, ci]
    sq = ext * ext
    A = torch.zeros(H + 2, W + 2, dtype=_I64, device=dev)
    B = torch.zeros_like(A)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            A += sq[dy:dy + H + 2, dx:dx + W + 2]
            B += ext[dy:dy + H + 2, dx:dx + W + 2]
    return A, B


def ab_z_index(p, s: int):
    """The A/B transform's table index as the JAX program computes it, in
    float32: floor((f32(p) * f32(s) + 2^19) / 2^20)."""
    f = lambda v: torch.tensor(float(v), dtype=_F32, device=p.device)
    t = p.to(_F32) * f(s) + f(1 << (SGRPROJ_MTABLE_BITS - 1))
    return torch.floor(t / f(1 << SGRPROJ_MTABLE_BITS)).to(_I64)


def _ab_transform(A, B, r, s, bd):
    n = (2 * r + 1) * (2 * r + 1)
    a = _rpot(A, 2 * (bd - 8))
    b = _rpot(B, bd - 8)
    p = torch.clamp(a * n - b * b, min=0)
    z = ab_z_index(p, s)
    At = torch.from_numpy(X_BY_XPLUS1).to(A.device)[z.clamp(0, 255)]
    Bt = _rpot((SGRPROJ_SGR - At) * B * int(ONE_BY_X[n - 1]),
               SGRPROJ_RECIP_BITS)
    return At, Bt


def _selfguided(dgd, ep, bd):
    """Whole-plane (f0, f1) = (flt0 - u, flt1 - u), int64, or None where
    the radius is 0."""
    H, W = dgd.shape
    r0, r1, s0, s1 = SGR_PARAMS[ep]
    d = dgd.to(_I64)
    u = d << SGRPROJ_RST_BITS
    f0 = f1 = None
    if r0 > 0:
        At, Bt = _ab_transform(*_box_grid(dgd, r0), r0, s0, bd)

        def own(X):
            return X[1:H + 1, 1:W + 1] * 6 + (X[1:H + 1, 0:W] + X[1:H + 1, 2:W + 2]) * 5

        def nbr(X):
            return ((X[0:H, 1:W + 1] + X[2:H + 2, 1:W + 1]) * 6
                    + (X[0:H, 0:W] + X[2:H + 2, 0:W] + X[0:H, 2:W + 2]
                       + X[2:H + 2, 2:W + 2]) * 5)

        even = (torch.arange(H, device=dgd.device) % 2 == 0)[:, None]
        v_even = nbr(At) * d + nbr(Bt)
        v_odd = own(At) * d + own(Bt)
        flt0 = torch.where(even,
                           _rpot(v_even, SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS),
                           _rpot(v_odd, SGRPROJ_SGR_BITS + 4 - SGRPROJ_RST_BITS))
        f0 = flt0 - u
    if r1 > 0:
        At, Bt = _ab_transform(*_box_grid(dgd, r1), r1, s1, bd)

        def blend(X):
            return ((X[1:H + 1, 1:W + 1] + X[1:H + 1, 0:W] + X[1:H + 1, 2:W + 2]
                     + X[0:H, 1:W + 1] + X[2:H + 2, 1:W + 1]) * 4
                    + (X[0:H, 0:W] + X[0:H, 2:W + 2] + X[2:H + 2, 0:W]
                       + X[2:H + 2, 2:W + 2]) * 3)

        flt1 = _rpot(blend(At) * d + blend(Bt),
                     SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)
        f1 = flt1 - u
    return f0, f1


def sgr_stats_ref(src, dgd, T: int, bd: int, eps: tuple):
    """Plain version: src / dgd (H, W) int32 -> (n_eps, 6, th, tw) float64
    per-tile sums, exact."""
    H, W = src.shape
    th, tw = -(-H // T), -(-W // T)
    dev = src.device
    d = (src.to(_I64) - dgd.to(_I64)) << SGRPROJ_RST_BITS
    zero = torch.zeros(H, W, dtype=_I64, device=dev)

    def tiles(x):
        p = torch.zeros(th * T, tw * T, dtype=_I64, device=dev)
        p[:H, :W] = x
        return p.reshape(th, T, tw, T).sum((1, 3))

    outs = []
    for ep in eps:
        f0, f1 = _selfguided(dgd, ep, bd)
        f0 = zero if f0 is None else f0
        f1 = zero if f1 is None else f1
        outs.append(torch.stack([tiles(f0 * f0), tiles(f0 * f1), tiles(f1 * f1),
                                 tiles(f0 * d), tiles(f1 * d), tiles(d * d)]))
    return torch.stack(outs).to(torch.float64)


# ------------------------------------------------------------ the kernel
@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("lr_search")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sgr_ab_launch.argtypes = [P, I, I, I, P, I, P, P, P, P, P]
    lib.sgr_tile_launch.argtypes = [P, P] + [I] * 5 + [P, I, P, P, P, P]
    for fn in (lib.sgr_ab_launch, lib.sgr_tile_launch):
        fn.restype = ctypes.c_int
    return lib


def _plan(eps):
    """(pairs (n_pairs, 2) [r, s], per-ep pair indices (n_eps, 2), -1 where
    the radius is 0)."""
    pairs, idx = [], []
    for ep in eps:
        r0, r1, s0, s1 = SGR_PARAMS[ep]
        row = []
        for r, s in ((r0, s0), (r1, s1)):
            if r > 0:
                row.append(len(pairs))
                pairs.append((r, s))
            else:
                row.append(-1)
        idx.append(row)
    return (np.array(pairs, np.int32).reshape(-1, 2),
            np.array(idx, np.int32).reshape(-1, 2))


def sgr_stats(src, dgd, T: int, bd: int, eps: tuple):
    """K9: the kernel for CUDA tensors, the plain version for CPU tensors."""
    eps = tuple(int(e) for e in eps)
    if not _build.on_cuda(src, "K9"):
        _build.count(calls, "plain")
        return sgr_stats_ref(src, dgd, T, bd, eps)
    dev = src.device
    H, W = src.shape
    for t in (src, dgd):
        _build.need(t, (H, W), torch.int32, dev, "K9")
    th, tw = -(-H // T), -(-W // T)
    pairs, idx = _plan(eps)
    n_pairs = pairs.shape[0]
    At = torch.empty((max(n_pairs, 1), H + 2, W + 2), dtype=torch.int32,
                     device=dev)
    Bt = torch.empty_like(At)
    out = torch.empty((len(eps), 6, th, tw), dtype=torch.float64, device=dev)
    pairs_t = torch.from_numpy(pairs).to(dev)
    idx_t = torch.from_numpy(idx).to(dev)
    xtab = _build.table("sgr_x_by_xplus1", X_BY_XPLUS1, dev)
    otab = _build.table("sgr_one_by_x", ONE_BY_X, dev)
    P, st = _build.ptr, _build.stream(dev)
    lib = _lib()
    _build.check(lib.sgr_ab_launch(P(dgd), H, W, int(bd), P(pairs_t), n_pairs,
                                   P(xtab), P(otab), P(At), P(Bt), st),
                 "sgr_ab_launch")
    _build.check(lib.sgr_tile_launch(P(src), P(dgd), H, W, int(T), th, tw,
                                     P(idx_t), len(eps), P(At), P(Bt), P(out),
                                     st), "sgr_tile_launch")
    _build.count(calls, "kernel")
    return out


# ------------------------------------------------------------ driver
def sgr_search_units(src_crop, dgd_crop, pr, bd: int, eps, device="cpu") -> dict:
    """The reference's device SGR sweep for every unit of one plane, on the
    torch `device`. src_crop / dgd_crop: (crop_h, crop_w) int arrays (source
    and post-CDEF). pr: PlaneRestoration (unit grid). Returns {(ui, uj): (ep,
    xqd, est_sse)}; callers re-verify with the exact integer filter."""
    eps = tuple(int(e) for e in eps)
    device = torch.device(device)
    T = pr.size
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    stats = sgr_stats(up(src_crop), up(dgd_crop), T, bd, eps).cpu().numpy()
    out = {}
    for ui in range(pr.vunits):
        for uj in range(pr.hunits):
            v0, v1, h0, h1 = pr.unit_limits(ui, uj)
            t0r, t1r = v0 // T, -(-v1 // T)
            t0c, t1c = h0 // T, -(-h1 // T)
            s = stats[:, :, t0r:t1r, t0c:t1c].sum(axis=(2, 3))  # (n_eps, 6)
            npix = float((v1 - v0) * (h1 - h0))
            best = None
            for ei, ep in enumerate(eps):
                h00, h01, h11, c0, c1, dd = (float(x) / npix for x in s[ei])
                r0, r1, _, _ = SGR_PARAMS[ep]
                if r0 > 0 and r1 > 0:
                    det = h00 * h11 - h01 * h01
                    if det < 1e-8:
                        xq = (0, 0)
                    else:
                        xq = (int(np.rint((h11 * c0 - h01 * c1) / det * 128)),
                              int(np.rint((h00 * c1 - h01 * c0) / det * 128)))
                elif r0 > 0:
                    xq = ((int(np.rint(c0 / h00 * 128))
                           if h00 >= 1e-8 else 0), 0)
                else:
                    xq = (0, (int(np.rint(c1 / h11 * 128))
                              if h11 >= 1e-8 else 0))
                xqd = _encode_xq(xq, ep)
                xq0, xq1 = decode_xq(xqd, ep)
                # analytic SSE of the quantized projection, <<4 domain
                q0, q1 = xq0 / 128.0, xq1 / 128.0
                est = (dd - 2.0 * (q0 * c0 + q1 * c1)
                       + q0 * q0 * h00 + 2.0 * q0 * q1 * h01
                       + q1 * q1 * h11) * npix
                if best is None or est < best[2]:
                    best = (ep, xqd, est / 256.0)
            out[(ui, uj)] = best
    return out
