"""Kernels K2 and K3: the open-loop inter search of every frame.

K2 (`csrc/ssd_grids.cu`) replaces `svt_av1_psy_tpu/ops/inter_search.py:
grids_stage`: per 64x64 superblock (SB), two HME centres (8x- and
4x-decimated SSD surfaces over +/-16 decimated pels, argmin with a 0.995
centre bias, 3x3 median) and the SSD grid of every 8x8 child over +/-12
pels around each centre. The kernel computes the surfaces and grids
directly in integers: a child's SSD is at most 64 * 1023^2 < 2^31, and HME
works on pooled *sums* in int64 (that scales the SSD by f^4 and leaves the
argmin and the centre bias unchanged). It reads the reference at each
centre without materialising the windows. Box pooling and the median stay
PyTorch ops in the wrapper. The JAX program computes the same surfaces as
box - 2 corr + energy with a float32 integral image, which is not exact
even at 8-bit (the integral over an 88x88 window reaches ~5e8 > 2^24), so
K2 matches it exactly only where those float32 sums are exact.
Bound on the H100: integer multiply-adds (~0.6 G per reference at 480p);
the 88x88 window and the SB's pixels sit in shared memory.

K3 (`csrc/inter_decide.cu`) replaces `depth_stage`: per BWxBH block, the
argmin of aggregated child SSD + lambda * MV_BITS over both centres, the
NEWMV prediction, GLOBALMV / zero candidate, compound average, tune bias
and the 5-mode open-loop intra fallback, with SSE + psy (Hadamard SA8D -
SAD/4) costs. Child SSDs, SSEs and psy sums are aggregated exactly (int64
and float64) and rounded to float32 once, in the kernel and the plain
version alike, so the two agree bit for bit; JAX's float32 summation order
alone explains any disagreement with the reference.
Bound on the H100: reading the child grids (36 MB per reference at 480p);
one CUDA block per output block keeps every candidate prediction in shared
memory.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

R_HME = 16
HME_DEC = 8
REACH = 120
R = 12
G = 2 * R + 1
PAD = 144
DEPTHS = (8, 16, 32, 64)

_SM_W = {
    4: np.array([255, 149, 85, 64], np.float32),
    8: np.array([255, 197, 146, 105, 73, 50, 37, 32], np.float32),
    16: np.array([255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33,
                  26, 20, 17, 16], np.float32),
    32: np.array([255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122,
                  111, 101, 92, 83, 74, 66, 59, 52, 45, 39, 34, 29, 25,
                  21, 17, 14, 12, 10, 9, 8, 8], np.float32),
    64: np.array([255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182,
                  176, 169, 163, 156, 150, 144, 138, 133, 127, 121, 116,
                  111, 106, 101, 96, 91, 86, 82, 77, 73, 69, 65, 61, 57,
                  54, 50, 47, 44, 41, 38, 35, 32, 29, 27, 25, 22, 20, 18,
                  16, 15, 13, 12, 10, 9, 8, 7, 6, 6, 5, 5, 4, 4, 4],
                 np.float32),
}

_d = np.abs(np.arange(G, dtype=np.float64) - R)
_comp_bits = np.log2(1.0 + 8.0 * _d)
MV_BITS = (1.2 * (_comp_bits[:, None] + _comp_bits[None, :]) + 6.0) \
    .astype(np.float32)
MV_BITS.setflags(write=False)

_INTRA_PMODES = np.array([0, 1, 2, 9, 12], np.int32)

_HAD8 = np.array([[1, 1, 1, 1, 1, 1, 1, 1],
                  [1, -1, 1, -1, 1, -1, 1, -1],
                  [1, 1, -1, -1, 1, 1, -1, -1],
                  [1, -1, -1, 1, 1, -1, -1, 1],
                  [1, 1, 1, 1, -1, -1, -1, -1],
                  [1, -1, 1, -1, -1, 1, -1, 1],
                  [1, 1, -1, -1, -1, -1, 1, 1],
                  [1, -1, -1, 1, -1, 1, 1, -1]], np.float32)

calls = {"grids": {"kernel": 0, "plain": 0}, "depth": {"kernel": 0, "plain": 0}}

_I64 = torch.int64
_F32 = torch.float32
_F64 = torch.float64


def pad_dims(h: int, w: int):
    """Frame dims padded up to whole 64x64 superblocks."""
    return -(-h // 64) * 64, -(-w // 64) * 64


# --------------------------------------------------------------- prep
def _edge_pad(x, top, bottom, left, right):
    """Edge (replicate) padding of a 2-D tensor by index clamping."""
    h, w = x.shape
    ri = torch.arange(-top, h + bottom, device=x.device).clamp_(0, h - 1)
    ci = torch.arange(-left, w + right, device=x.device).clamp_(0, w - 1)
    return x[ri][:, ci]


def prep_frame(y, Hp: int, Wp: int):
    """(h, w) integer plane tensor -> (src (Hp, Wp) f32, ref (Hp+2P, Wp+2P)
    f32), both edge-padded."""
    x = y.to(_F32)
    h, w = x.shape
    src = _edge_pad(x, 0, Hp - h, 0, Wp - w)
    return src, _edge_pad(src, PAD, PAD, PAD, PAD)


def prep_ref(y, Hp: int, Wp: int):
    """Reference-only prep: one edge pad with the summed margins."""
    x = y.to(_F32)
    h, w = x.shape
    return _edge_pad(x, PAD, PAD + Hp - h, PAD, PAD + Wp - w)


# --------------------------------------------------------------- K2
def _pool_sum(x, f):
    h, w = x.shape
    return x.reshape(h // f, f, w // f, f).sum((1, 3))


def _median3x3(v, nsr, nsc):
    g = v.reshape(nsr, nsc)
    gp = _edge_pad(g, 1, 1, 1, 1)
    sh = torch.stack([gp[r:r + nsr, c:c + nsc]
                      for r in range(3) for c in range(3)])
    return sh.median(0).values.reshape(-1).to(torch.int32)


def _hme_level(dsrc, dref, nsr, nsc, dec, kernel):
    """One HME level on pooled sums -> median-filtered (dy, dx) full-pel."""
    b = 64 // dec
    PD = PAD // dec
    side = 2 * R_HME + 1
    if kernel:
        idx = _hme_kernel(dsrc, dref, nsr, nsc, b, PD)
    else:
        idx = _hme_idx_ref(dsrc, dref, nsr, nsc, b, PD)
    dy = torch.clamp((idx // side - R_HME) * dec, -REACH, REACH)
    dx = torch.clamp((idx % side - R_HME) * dec, -REACH, REACH)
    return _median3x3(dy, nsr, nsc), _median3x3(dx, nsr, nsc)


def _hme_idx_ref(dsrc, dref, nsr, nsc, b, PD):
    n = nsr * nsc
    side = 2 * R_HME + 1
    dsrc, dref = dsrc.to(_I64), dref.to(_I64)
    blk = dsrc.reshape(nsr, b, nsc, b).permute(0, 2, 1, 3).reshape(n, b, b)
    i = torch.arange(n, device=dsrc.device)
    r0 = (i // nsc) * b + PD - R_HME
    c0 = (i % nsc) * b + PD - R_HME
    span = torch.arange(side + b - 1, device=dsrc.device)
    wins = dref[(r0[:, None] + span)[:, :, None], (c0[:, None] + span)[:, None, :]]
    ssd = torch.empty(n, side, side, dtype=_I64, device=dsrc.device)
    for u in range(side):
        rows = wins[:, u:u + b, :].unfold(2, b, 1)          # (n, b, side, b)
        d = rows - blk[:, :, None, :]
        ssd[:, u] = (d * d).sum((1, 3))
    flat = ssd.reshape(n, side * side).to(_F64)
    flat[:, R_HME * side + R_HME] *= 0.995
    return torch.argmin(flat, 1)


def _sb_kids(src_i, nsr, nsc):
    n = nsr * nsc
    return (src_i.reshape(nsr, 64, nsc, 64).permute(0, 2, 1, 3)
            .reshape(n, 8, 8, 8, 8).permute(0, 1, 3, 2, 4))   # (n, by, bx, y, x)


def _win_origin(cy, cx, nsr, nsc, Hr, Wr):
    i = torch.arange(nsr * nsc, device=cy.device)
    win = 64 + 2 * R
    y0 = ((i // nsc) * 64 + PAD - R + cy).clamp(0, Hr - win)
    x0 = ((i % nsc) * 64 + PAD - R + cx).clamp(0, Wr - win)
    return y0, x0


def _child_grids_ref(ref_i, src_i, cy, cx, nsr, nsc):
    n = nsr * nsc
    Hr, Wr = ref_i.shape
    y0, x0 = _win_origin(cy, cx, nsr, nsc, Hr, Wr)
    span = torch.arange(64 + 2 * R, device=ref_i.device)
    wins = ref_i[(y0[:, None] + span)[:, :, None], (x0[:, None] + span)[:, None, :]]
    kids = _sb_kids(src_i, nsr, nsc)
    out = torch.empty(n, 8, 8, G, G, dtype=torch.int32, device=ref_i.device)
    for by in range(8):
        for bx in range(8):
            w = wins[:, by * 8:by * 8 + G + 7, bx * 8:bx * 8 + G + 7]
            p = w.unfold(1, 8, 1).unfold(2, 8, 1)             # (n, G, G, 8, 8)
            d = p - kids[:, by, bx, None, None]
            out[:, by, bx] = (d * d).sum((-1, -2)).to(torch.int32)
    return out


def grids_stage_ref(src, ref):
    """Plain PyTorch version of K2. src (Hp, Wp) f32; ref (Hp+2P, Wp+2P)
    f32. Returns (ctr_y (2, N) i32, ctr_x (2, N) i32, ssd8 (2, N, 8, 8, G,
    G) i32)."""
    return _grids(src, ref, kernel=False)


def _grids(src, ref, kernel):
    Hp, Wp = src.shape
    nsr, nsc = Hp // 64, Wp // 64
    src_i = src.to(torch.int32)
    ref_i = ref.to(torch.int32)
    cy_a, cx_a = _hme_level(_pool_sum(src_i, HME_DEC), _pool_sum(ref_i, HME_DEC),
                            nsr, nsc, HME_DEC, kernel)
    cy_b, cx_b = _hme_level(_pool_sum(src_i, 4), _pool_sum(ref_i, 4),
                            nsr, nsc, 4, kernel)
    cy2 = torch.stack([cy_a, cy_b])
    cx2 = torch.stack([cx_a, cx_b])
    if kernel:
        ssd8 = _child_kernel(ref_i, src_i, cy2, cx2, nsr, nsc)
    else:
        ssd8 = torch.stack([_child_grids_ref(ref_i, src_i, cy2[c], cx2[c],
                                             nsr, nsc) for c in range(2)])
    return cy2, cx2, ssd8


@functools.lru_cache(maxsize=1)
def _k2():
    lib = _build.load("ssd_grids")
    lib.hme_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.hme_launch.restype = ctypes.c_int
    lib.child_grids_launch.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.child_grids_launch.restype = ctypes.c_int
    return lib


def _hme_kernel(dsrc, dref, nsr, nsc, b, PD):
    dsrc = dsrc.to(torch.int32).contiguous()
    dref = dref.to(torch.int32).contiguous()
    idx = torch.empty(nsr * nsc, dtype=torch.int32, device=dsrc.device)
    rc = _k2().hme_launch(_build.ptr(dsrc), _build.ptr(dref), _build.ptr(idx),
                          nsr, nsc, b, PD, dref.shape[1],
                          _build.stream(dsrc.device))
    _build.check(rc, "hme_launch")
    return idx.long()


def _child_kernel(ref_i, src_i, cy2, cx2, nsr, nsc):
    n = nsr * nsc
    ref_i = ref_i.contiguous()
    src_i = src_i.contiguous()
    cy2 = cy2.contiguous()
    cx2 = cx2.contiguous()
    out = torch.empty(2, n, 8, 8, G, G, dtype=torch.int32, device=ref_i.device)
    rc = _k2().child_grids_launch(
        _build.ptr(ref_i), _build.ptr(src_i), _build.ptr(cy2), _build.ptr(cx2),
        _build.ptr(out), nsr, nsc, ref_i.shape[0], ref_i.shape[1],
        src_i.shape[1], R, _build.stream(ref_i.device))
    _build.check(rc, "child_grids_launch")
    return out


def grids_stage(src, ref):
    """K2: the kernel for CUDA tensors, the plain version for CPU tensors."""
    if src.device.type == "cpu":
        _build.count(calls["grids"], "plain")
        return _grids(src, ref, kernel=False)
    if src.device.type != "cuda":
        raise ValueError(f"K2 takes cpu or cuda tensors, not {src.device}")
    Hp, Wp = src.shape
    if (Hp % 64 or Wp % 64 or tuple(ref.shape) != (Hp + 2 * PAD, Wp + 2 * PAD)
            or ref.device != src.device):
        raise ValueError(f"K2: src {tuple(src.shape)} / ref {tuple(ref.shape)}")
    out = _grids(src, ref, kernel=True)
    _build.count(calls["grids"], "kernel")
    return out


# --------------------------------------------------------------- K3 plain
_HAD8_64 = torch.from_numpy(_HAD8.astype(np.float64))


def tile_energy2(x2):
    """psy 8x8 tile energy SA8D - SAD/4 of x2 / 2, for x2 (..., 8, 8) int64
    holding TWICE the samples (compound averages are half-integers).
    Exact in float64; the values are exactly representable in float32."""
    h = _HAD8_64.to(x2.device)
    x = x2.to(_F64)
    t = torch.matmul(torch.matmul(h, x), h.T)
    sa8d = (t.abs().sum((-1, -2)) * 0.5 + 2.0) * 0.25
    sad = x.sum((-1, -2)) * 0.5 * 0.25
    return sa8d - sad


def _tiles(x, BH, BW):
    """(Gr, Gc, BH, BW) -> (Gr, Gc, kk, 8, 8)."""
    gr, gc = x.shape[:2]
    kh, kw = BH // 8, BW // 8
    return (x.reshape(gr, gc, kh, 8, kw, 8).permute(0, 1, 2, 4, 3, 5)
            .reshape(gr, gc, kh * kw, 8, 8))


def _blocks(x, BH, BW):
    h, w = x.shape
    return x.reshape(h // BH, BH, w // BW, BW).permute(0, 2, 1, 3)


def _gather(ref2, by, bx, BH, BW):
    """(Gr, Gc, BH, BW) blocks of ref2 at top-left (by, bx), clamped into
    range as jax.lax.dynamic_slice clamps."""
    Hr, Wr = ref2.shape
    by = by.clamp(0, Hr - BH)
    bx = bx.clamp(0, Wr - BW)
    ys = by[..., None] + torch.arange(BH, device=ref2.device)
    xs = bx[..., None] + torch.arange(BW, device=ref2.device)
    return ref2[ys[..., :, None], xs[..., None, :]]


def _sb_to_grid(x, nsr, nsc, kh, kw):
    tail = x.shape[3:]
    return (x.reshape((nsr, nsc, kh, kw) + tail).transpose(1, 2)
            .reshape((nsr * kh, nsc * kw) + tail))


def agg_argmin_ref(ssd8, cy2, cx2, nsr, nsc, BH, BW, lam=None):
    """Shared by K3 and K4's _best_mv: aggregate child grids (exactly) into
    BHxBW blocks, round to f32 once, add lam * MV_BITS when lam is given,
    argmin over both centres. Returns (mv_y, mv_x) int64 (Gr, Gc)."""
    n = nsr * nsc
    kh, kw, kkh, kkw = 64 // BH, 64 // BW, BH // 8, BW // 8
    agg = ssd8.to(_I64).reshape(2, n, kh, kkh, kw, kkw, G, G).sum((3, 5))
    grid = torch.stack([_sb_to_grid(agg[c], nsr, nsc, kh, kw)
                        for c in range(2)], 2).to(_F32)
    if lam is not None:
        grid = grid + lam * _mvb(grid.device)
    gr, gc = grid.shape[:2]
    idx = torch.argmin(grid.reshape(gr, gc, 2 * G * G), -1)
    sel = idx // (G * G)
    off = idx % (G * G)

    def ctr(v):
        per = v.to(_I64).reshape(2, nsr, 1, nsc, 1).expand(2, nsr, kh, nsc, kw)
        return per.reshape(2, gr, gc)

    ar = torch.arange(gr, device=ssd8.device)[:, None]
    ac = torch.arange(gc, device=ssd8.device)[None, :]
    mv_y = ctr(cy2)[sel, ar, ac] + off // G - R
    mv_x = ctr(cx2)[sel, ar, ac] + off % G - R
    return mv_y, mv_x


def _intra_preds2(src_i, BH, BW, bd):
    """(Gr, Gc, 5, BH, BW) doubled open-loop intra predictions (DC, V, H,
    SMOOTH, PAETH) from source neighbours, with the availability rules of
    the native kernel."""
    Hp, Wp = src_i.shape
    gr, gc = Hp // BH, Wp // BW
    dev = src_i.device
    base = 1 << (bd - 1)
    s = src_i.to(_I64)
    ab = torch.zeros(gr, gc, BW, dtype=_I64, device=dev)
    ab[1:] = s[BH - 1:Hp - 1:BH, :].reshape(gr - 1, gc, BW)
    lf = torch.zeros(gr, gc, BH, dtype=_I64, device=dev)
    lf[:, 1:] = s[:, BW - 1:Wp - 1:BW].reshape(gr, BH, gc - 1).transpose(1, 2)
    have_a = (torch.arange(gr, device=dev) > 0)[:, None]
    have_l = (torch.arange(gc, device=dev) > 0)[None, :]
    basev = torch.tensor(base, dtype=_I64, device=dev)
    fill_a = torch.where(have_l, lf[:, :, 0], basev)
    fill_l = torch.where(have_a, ab[:, :, 0], basev)
    A = torch.where(have_a[..., None], ab, fill_a[..., None])
    L = torch.where(have_l[..., None], lf, fill_l[..., None])
    ct = torch.zeros(gr, gc, dtype=_I64, device=dev)
    ct[1:, 1:] = s[BH - 1:Hp - 1:BH, BW - 1:Wp - 1:BW]
    corner = torch.where(have_a & have_l, ct,
                         torch.where(have_a, A[:, :, 0],
                                     torch.where(have_l, L[:, :, 0], basev)))
    npx = BH + BW
    dc = torch.where(
        have_a & have_l, (A.sum(-1) + L.sum(-1) + npx // 2) // npx,
        torch.where(have_a, (A.sum(-1) + BW // 2) // BW,
                    torch.where(have_l, (L.sum(-1) + BH // 2) // BH, basev)))
    shape = (gr, gc, BH, BW)
    p_dc = dc[..., None, None].expand(shape)
    p_v = A[:, :, None, :].expand(shape)
    p_h = L[:, :, :, None].expand(shape)
    wv = torch.from_numpy(_SM_W[BH].astype(np.int64)).to(dev)
    wh = torch.from_numpy(_SM_W[BW].astype(np.int64)).to(dev)
    below = L[:, :, -1]
    right = A[:, :, -1]
    sm = (wv[:, None] * A[:, :, None, :]
          + (256 - wv)[:, None] * below[..., None, None]
          + wh[None, :] * L[:, :, :, None]
          + (256 - wh)[None, :] * right[..., None, None])
    p_sm = (sm + 256) >> 9
    t = A[:, :, None, :]
    l = L[:, :, :, None]
    tl = corner[..., None, None]
    pb = t + l - tl
    pl, pt, ptl = (pb - l).abs(), (pb - t).abs(), (pb - tl).abs()
    p_pa = torch.where((pl <= pt) & (pl <= ptl), l, torch.where(pt <= ptl, t, tl))
    return 2 * torch.stack([p_dc, p_v, p_h, p_sm, p_pa.expand(shape)], 2)


def depth_stage_ref(src, ref_l, ref_a, cy_l, cx_l, g_l, cy_a, cx_a, g_a,
                    pvec, BW: int, BH: int, two_ref: bool, bd: int):
    """Plain PyTorch version of K3 (the JAX program's signature). Returns
    rows (Gr*Gc, 8) i32 and costs (Gr*Gc,) f32."""
    dev = src.device
    gm = pvec[:2].to(torch.int32).to(_I64)
    lam, psy_rd, bias_pct = pvec[2], pvec[3], pvec[4]
    Hp, Wp = src.shape
    nsr, nsc = Hp // 64, Wp // 64
    gr, gc = Hp // BH, Wp // BW
    psy_scale = psy_rd * torch.tensor(0.5 if bd == 8 else 4.0, dtype=_F32)
    src2 = 2 * src.to(_I64)
    src2_blk = _blocks(src2, BH, BW)
    src_e = tile_energy2(_tiles(src2_blk, BH, BW))            # (Gr, Gc, kk)

    def cand_cost(pred2):
        d = src2_blk - pred2
        sse = ((d * d).sum((-1, -2)).to(_F64) * 0.25).to(_F32)
        pe = tile_energy2(_tiles(pred2, BH, BW))
        psy = (src_e - pe).abs().sum(-1).to(_F32)
        return sse + psy * psy_scale

    ar = (torch.arange(gr, device=dev) * BH)[:, None]
    ac = (torch.arange(gc, device=dev) * BW)[None, :]
    zero = torch.zeros(gr, gc, dtype=_I64, device=dev)
    per_ref = [(ref_l, cy_l, cx_l, g_l)]
    if two_ref:
        per_ref.append((ref_a, cy_a, cx_a, g_a))
    ref_best = []
    for ri, (ref, cy, cx, ssd8) in enumerate(per_ref):
        ref2 = 2 * ref.to(_I64)
        mv_y, mv_x = agg_argmin_ref(ssd8, cy, cx, nsr, nsc, BH, BW, lam=lam)
        p_new = _gather(ref2, ar + PAD + mv_y, ac + PAD + mv_x, BH, BW)
        c_new = cand_cost(p_new)
        if ri == 0:
            oy = int((PAD + gm[0]).clamp(0, ref.shape[0] - Hp))
            ox = int((PAD + gm[1]).clamp(0, ref.shape[1] - Wp))
            zg = (zero + gm[0], zero + gm[1])
        else:
            oy = ox = PAD
            zg = (zero, zero)
        p_zg = _gather(ref2, ar + oy + zero, ac + ox + zero, BH, BW)
        c_zg = cand_cost(p_zg)
        new_wins = (c_new < c_zg) & (c_zg > float((BW * BH) << 2))
        ref_best.append((torch.where(new_wins, c_new, c_zg),
                         torch.where(new_wins, mv_y, zg[0]),
                         torch.where(new_wins, mv_x, zg[1]),
                         torch.where(new_wins[..., None, None], p_new, p_zg),
                         new_wins))
    c_l, my_l, mx_l, p_l, new_l = ref_best[0]
    if two_ref:
        c_a, my_a, mx_a, p_a, new_a = ref_best[1]
        a_wins = c_a < c_l
        best_single = torch.where(a_wins, c_a, c_l)
        c_c = cand_cost((p_l + p_a) // 2)
        use_comp = c_c < best_single - best_single * 0.0625
        inter_cost = torch.where(use_comp, c_c, best_single)
    else:
        my_a, mx_a, new_a = my_l, mx_l, new_l
        a_wins = torch.zeros_like(new_l)
        use_comp = torch.zeros_like(new_l)
        inter_cost = c_l
    inter_biased = inter_cost * (bias_pct * torch.tensor(0.01, dtype=_F32))

    ip2 = _intra_preds2(src.to(_I64), BH, BW, bd)             # (Gr, Gc, 5, BH, BW)
    i_cost = torch.stack([cand_cost(ip2[:, :, k]) for k in range(5)], -1)
    best_im = torch.argmin(i_cost, -1)
    best_ic = i_cost.amin(-1)
    gate = inter_cost > float((BW * BH) << 1)
    best_ic = torch.where(gate, best_ic, torch.full_like(best_ic, float("inf")))
    use_inter = inter_biased <= best_ic
    imode = torch.from_numpy(_INTRA_PMODES).to(dev)[best_im].to(_I64)

    single_ref = torch.where(a_wins, 4, 1)
    single_mode = torch.where(torch.where(a_wins, new_a, new_l), 16, 15)
    single_my = torch.where(a_wins, my_a, my_l)
    single_mx = torch.where(a_wins, mx_a, mx_l)
    col_ref = torch.where(use_comp, 7, single_ref)
    col_mode = torch.where(use_comp, 24, single_mode)
    col_my = torch.where(use_comp, my_l, single_my) * 8
    col_mx = torch.where(use_comp, mx_l, single_mx) * 8
    col_m2y = torch.where(use_comp, my_a, single_my) * 8
    col_m2x = torch.where(use_comp, mx_a, single_mx) * 8
    z = torch.zeros_like(col_my)
    rows = torch.stack([
        use_inter.to(_I64),
        torch.where(use_inter, col_ref, z),
        torch.where(use_inter, col_mode, imode),
        torch.where(use_inter, col_my, z),
        torch.where(use_inter, col_mx, z),
        col_m2y, col_m2x, z], -1).reshape(gr * gc, 8).to(torch.int32)
    cost = torch.minimum(inter_biased, best_ic).reshape(gr * gc)
    return rows, cost


# --------------------------------------------------------------- K3 kernel
@functools.lru_cache(maxsize=1)
def _k3():
    lib = _build.load("inter_decide")
    lib.inter_decide_launch.argtypes = [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4
    lib.inter_decide_launch.restype = ctypes.c_int
    return lib


_MVB_DEV: dict = {}


def _mvb(device):
    t = _MVB_DEV.get(device)
    if t is None:
        t = _MVB_DEV[device] = torch.from_numpy(MV_BITS.copy()).to(device)
    return t


def depth_stage(src, ref_l, ref_a, cy_l, cx_l, g_l, cy_a, cx_a, g_a, pvec,
                BW: int, BH: int, two_ref: bool, bd: int):
    """K3: the kernel for CUDA tensors, the plain version for CPU tensors."""
    if src.device.type == "cpu":
        _build.count(calls["depth"], "plain")
        return depth_stage_ref(src, ref_l, ref_a, cy_l, cx_l, g_l, cy_a, cx_a,
                               g_a, pvec, BW=BW, BH=BH, two_ref=two_ref, bd=bd)
    if src.device.type != "cuda":
        raise ValueError(f"K3 takes cpu or cuda tensors, not {src.device}")
    Hp, Wp = src.shape
    n = (Hp // 64) * (Wp // 64)
    if BW not in (8, 16, 32, 64) or BH not in (8, 16, 32, 64):
        raise ValueError(f"K3 block shape {BW}x{BH}")
    for t, shp, dt in ((src, (Hp, Wp), _F32),
                       (ref_l, (Hp + 2 * PAD, Wp + 2 * PAD), _F32),
                       (ref_a, (Hp + 2 * PAD, Wp + 2 * PAD), _F32),
                       (cy_l, (2, n), torch.int32), (cx_l, (2, n), torch.int32),
                       (cy_a, (2, n), torch.int32), (cx_a, (2, n), torch.int32),
                       (g_l, (2, n, 8, 8, G, G), torch.int32),
                       (g_a, (2, n, 8, 8, G, G), torch.int32),
                       (pvec, (5,), _F32)):
        if (tuple(t.shape) != shp or t.dtype != dt or t.device != src.device
                or not t.is_contiguous()):
            raise ValueError(f"K3 argument {tuple(t.shape)} {t.dtype}: want "
                             f"{shp} {dt} contiguous on {src.device}")
    gr, gc = Hp // BH, Wp // BW
    rows = torch.empty(gr * gc, 8, dtype=torch.int32, device=src.device)
    cost = torch.empty(gr * gc, dtype=_F32, device=src.device)
    rc = _k3().inter_decide_launch(
        *[_build.ptr(t) for t in (src, ref_l, ref_a, cy_l, cx_l, g_l, cy_a,
                                  cx_a, g_a, pvec)],
        Hp, Wp, BW, BH, int(bool(two_ref)), int(bd), PAD,
        _build.ptr(_mvb(src.device)), _build.ptr(rows), _build.ptr(cost),
        _build.stream(src.device))
    _build.check(rc, "inter_decide_launch")
    _build.count(calls["depth"], "kernel")
    return rows, cost


# --------------------------------------------------------------- drivers
def shapes_for(depths: tuple = DEPTHS, rect: bool = False) -> tuple:
    """(w, h) block shapes a search covers: the square depths plus, with
    rect partitioning, the HORZ/VERT halves of every >=16 node."""
    shapes = [(S, S) for S in depths]
    if rect:
        dmax = max(depths)
        for S in (16, 32, 64):
            if S <= dmax:
                shapes.append((S, S >> 1))
                shapes.append((S >> 1, S))
    return tuple(shapes)


def decide_frame_staged(src, ref_l, ref_a, pvec, two_ref: bool, bd: int,
                        shapes: tuple):
    """Launch the staged search for one frame; returns one packed f32
    tensor on the frame's device (decode with unpack_frame)."""
    cy_l, cx_l, g_l = grids_stage(src, ref_l)
    if two_ref:
        cy_a, cx_a, g_a = grids_stage(src, ref_a)
    else:
        cy_a, cx_a, g_a = cy_l, cx_l, g_l
    flat = []
    for (w, h) in shapes:
        rows, costs = depth_stage(src, ref_l, ref_a, cy_l, cx_l, g_l,
                                  cy_a, cx_a, g_a, pvec,
                                  BW=w, BH=h, two_ref=two_ref, bd=bd)
        flat += [rows.to(_F32).reshape(-1), costs]
    return torch.cat(flat)


def unpack_frame(vec: np.ndarray, Hp: int, Wp: int, shapes: tuple):
    """Host-side decode of a packed result vector -> {key: (rows, costs)}
    where key is int S for squares, (w, h) for rect shapes."""
    res = {}
    off = 0
    for (w, h) in shapes:
        nblk = (Hp // h) * (Wp // w)
        rows = vec[off:off + nblk * 8].reshape(nblk, 8).astype(np.int32)
        off += nblk * 8
        costs = vec[off:off + nblk].astype(np.float32)
        off += nblk
        res[w if w == h else (w, h)] = (rows, costs)
    return res


def upload_plane(p, device):
    """numpy (h, w) uint8/uint16 plane -> integer tensor on `device`."""
    a = np.ascontiguousarray(p)
    if a.dtype == np.uint16:
        a = a.view(np.int16)          # samples < 2^15: same values
    elif a.dtype != np.uint8:
        a = a.astype(np.int16)
    return torch.from_numpy(a).to(device)


def chunk_search(frames, jobs, bd: int, shapes: tuple = None, post=None,
                 device="cpu"):
    """Search a chunk of frames, streaming results per job.

    frames: list of (h, w) numpy source planes; jobs: list of dicts {src,
    ref_l, ref_a (index into frames or None), gm (1/8-pel), lam, psy_rd,
    bias_pct}. Every job's kernels are queued on the current stream first;
    then each job's packed result is copied to the host, its copy awaited
    and the result delivered in job order (to `post(j, res)` as soon as it
    lands). Returns one {S: (rows, costs)} per job."""
    device = torch.device(device)
    h, w = frames[0].shape
    Hp, Wp = pad_dims(h, w)
    params = np.zeros((len(jobs), 5), np.float32)
    for j, job in enumerate(jobs):
        params[j] = (round(job["gm"][0] / 8.0), round(job["gm"][1] / 8.0),
                     job["lam"], job["psy_rd"], job["bias_pct"])
    shapes = shapes_for(DEPTHS) if shapes is None else tuple(shapes)
    pf = {}

    def prep(i):
        if i not in pf:
            pf[i] = prep_frame(upload_plane(frames[i], device), Hp, Wp)
        return pf[i]

    pdev = torch.from_numpy(params).to(device)
    cuda = device.type == "cuda"
    pending = []
    for j, job in enumerate(jobs):
        two = job["ref_a"] is not None
        vec = decide_frame_staged(
            prep(job["src"])[0], prep(job["ref_l"])[1],
            prep(job["ref_a"] if two else job["ref_l"])[1], pdev[j].contiguous(),
            two_ref=two, bd=bd, shapes=shapes)
        if cuda:
            host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
            host.copy_(vec, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            pending.append((host, ev))
        else:
            pending.append((vec, None))
    out = []
    for j, (host, ev) in enumerate(pending):
        if ev is not None:
            ev.synchronize()
        res = unpack_frame(host.numpy(), Hp, Wp, shapes)
        out.append(res)
        if post is not None:
            post(j, res)
    return out


def search_frame_np(y, ref_l_y, ref_a_y, gm, lam, psy_rd, bias_pct, bd,
                    depths: tuple = DEPTHS, rect: bool = False,
                    device="cpu"):
    """Synchronous single-frame wrapper: numpy planes in, {S: (rows, costs)}
    out. `gm` is the frame's LAST global MV in 1/8-pel units."""
    frames = [y, ref_l_y] + ([ref_a_y] if ref_a_y is not None else [])
    job = dict(src=0, ref_l=1, ref_a=(2 if ref_a_y is not None else None),
               gm=gm, lam=lam, psy_rd=psy_rd, bias_pct=bias_pct)
    return chunk_search(frames, [job], bd, shapes_for(depths, rect),
                        device=device)[0]
