"""Kernel K7: the device TPL cost pass (`csrc/tpl.cu`).

Replaces `svt_av1_psy_tpu/ops/tpl.py`: `tpl_intra_stage` and
`tpl_pair_stage`. Per 16x16 TPL unit: the SA8D of the mean-removed block
(intra), and against the display predecessor the best full-pel vector from
K2's child grids (2x2 children summed, argmin over both centres, lowest
index on ties), clipped into the frame, and the SA8D of the MC residual
(inter, at most intra). All of it is integer and exact; on the 8-bit TPL
planes it equals the JAX program's float32 einsums (sums below 2^24) when
both are fed the same grids. JAX's own grids are inexact float32 (K2's
docstring), so its vectors may differ from the port's on real content.

Bound on the H100: reading the child grids (43 MB per 960x540 frame); one
CUDA block per unit keeps the pixels and the Hadamard stages in shared
memory.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .inter_search import (_HAD8, PAD, G, R, _gather, _sb_to_grid, grids_stage,
                           pad_dims, prep_frame, upload_plane)

BLK = 16
_I64 = torch.int64
_F32 = torch.float32

calls = {"kernel": 0, "plain": 0}


# ------------------------------------------------------------ plain version
def _units(x):
    """(Hp, Wp) -> (gr, gc, 16, 16)."""
    h, w = x.shape
    return x.reshape(h // BLK, BLK, w // BLK, BLK).transpose(1, 2)


def _sa8d16(blocks):
    """(gr, gc, 16, 16) int64 -> (gr, gc) int64: per 8x8 quadrant
    (sum |H8 q H8^T| + 2) >> 2, summed. The Hadamard products run in float64,
    exact for these integers (and float64 matmul runs on CUDA too)."""
    gr, gc = blocks.shape[:2]
    h = torch.from_numpy(_HAD8.astype(np.float64)).to(blocks.device)
    q = (blocks.reshape(gr, gc, 2, 8, 2, 8).permute(0, 1, 2, 4, 3, 5)
         .reshape(gr, gc, 4, 8, 8).to(torch.float64))
    t = torch.matmul(torch.matmul(h, q), h.T)
    per_q = (t.abs().sum((-1, -2)).to(_I64) + 2) >> 2
    return per_q.sum(-1)


def _intra(blk):
    mean = torch.div(blk.sum((-1, -2), keepdim=True), BLK * BLK,
                     rounding_mode="floor")
    return torch.clamp(_sa8d16(blk - mean), min=1)


def tpl_intra_stage_ref(src, Hr: int, Wr: int):
    """Plain version of the intra stage: src (Hp, Wp) f32 -> (gr*gc,) f32."""
    return _intra(_units(src.to(_I64))).reshape(-1).to(_F32)


def tpl_pair_stage_ref(src, ref, cy2, cx2, ssd8, Hr: int, Wr: int):
    """Plain version of the pair stage. src (Hp, Wp) f32, ref (Hp+2P, Wp+2P)
    f32, cy2 / cx2 (2, n) i32, ssd8 (2, n, 8, 8, G, G) i32. Returns the
    packed f32 vector [mv_y, mv_x, inter, intra], each (gr*gc,) raster."""
    dev = src.device
    Hp, Wp = src.shape
    nsr, nsc = Hp // 64, Wp // 64
    n = nsr * nsc
    gr, gc = Hp // BLK, Wp // BLK
    agg = ssd8.to(_I64).reshape(2, n, 4, 2, 4, 2, G, G).sum((3, 5))
    grid = torch.stack([_sb_to_grid(agg[c], nsr, nsc, 4, 4) for c in range(2)],
                       2)                                   # (gr, gc, 2, G, G)
    idx = torch.argmin(grid.reshape(gr, gc, 2 * G * G), -1)  # first minimum
    sel, off = idx // (G * G), idx % (G * G)

    def ctr(v):
        per = v.to(_I64).reshape(2, nsr, 1, nsc, 1).expand(2, nsr, 4, nsc, 4)
        return per.reshape(2, gr, gc)

    ar = torch.arange(gr, device=dev)[:, None]
    ac = torch.arange(gc, device=dev)[None, :]
    by, bx = ar * BLK, ac * BLK
    # jnp.clip is min(max(.)): in the 64-aligned padding the upper bound is
    # negative and pulls the unit's vector back into the frame
    mv_y = torch.minimum(torch.maximum(ctr(cy2)[sel, ar, ac] + off // G - R, -by),
                         (Hr - BLK) - by)
    mv_x = torch.minimum(torch.maximum(ctr(cx2)[sel, ar, ac] + off % G - R, -bx),
                         (Wr - BLK) - bx)
    pred = _gather(ref.to(_I64), by + PAD + mv_y, bx + PAD + mv_x, BLK, BLK)
    blk = _units(src.to(_I64))
    intra = _intra(blk)
    inter = torch.minimum(torch.clamp(_sa8d16(blk - pred), min=1), intra)
    return torch.cat([mv_y.reshape(-1), mv_x.reshape(-1), inter.reshape(-1),
                      intra.reshape(-1)]).to(_F32)


# ------------------------------------------------------------ the kernel
@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("tpl")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tpl_intra_launch.argtypes = [P, I, I, P, P]
    lib.tpl_pair_launch.argtypes = [P] * 5 + [I] * 5 + [P, P]
    for fn in (lib.tpl_intra_launch, lib.tpl_pair_launch):
        fn.restype = ctypes.c_int
    return lib


def _check_src(src):
    Hp, Wp = src.shape
    if Hp % 64 or Wp % 64:
        raise ValueError(f"K7: src {tuple(src.shape)} is not 64-aligned")
    _build.need(src, (Hp, Wp), _F32, src.device, "K7")
    return Hp, Wp


def tpl_intra_stage(src, Hr: int, Wr: int):
    """K7 intra stage: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if not _build.on_cuda(src, "K7"):
        _build.count(calls, "plain")
        return tpl_intra_stage_ref(src, Hr, Wr)
    Hp, Wp = _check_src(src)
    out = torch.empty((Hp // BLK) * (Wp // BLK), dtype=_F32, device=src.device)
    rc = _lib().tpl_intra_launch(_build.ptr(src), Hp, Wp, _build.ptr(out),
                                 _build.stream(src.device))
    _build.check(rc, "tpl_intra_launch")
    _build.count(calls, "kernel")
    return out


def tpl_pair_stage(src, ref, cy2, cx2, ssd8, Hr: int, Wr: int):
    """K7 pair stage: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if not _build.on_cuda(src, "K7"):
        _build.count(calls, "plain")
        return tpl_pair_stage_ref(src, ref, cy2, cx2, ssd8, Hr, Wr)
    dev = src.device
    Hp, Wp = _check_src(src)
    n = (Hp // 64) * (Wp // 64)
    for t, shape, dtype in ((ref, (Hp + 2 * PAD, Wp + 2 * PAD), _F32),
                            (cy2, (2, n), torch.int32), (cx2, (2, n), torch.int32),
                            (ssd8, (2, n, 8, 8, G, G), torch.int32)):
        _build.need(t, shape, dtype, dev, "K7")
    out = torch.empty(4 * (Hp // BLK) * (Wp // BLK), dtype=_F32, device=dev)
    P = _build.ptr
    rc = _lib().tpl_pair_launch(P(src), P(ref), P(cy2), P(cx2), P(ssd8), Hp, Wp,
                                int(Hr), int(Wr), PAD, P(out), _build.stream(dev))
    _build.check(rc, "tpl_pair_launch")
    _build.count(calls, "kernel")
    return out


# ------------------------------------------------------------ driver
def tpl_group_stats(luma: list, device="cpu"):
    """Port of the reference's `tpl_group_stats`: the device TPL cost pass for
    a display-order group of (already 8-bit-shifted, possibly decimated) luma
    planes, on `device`. Returns the per-frame stats dicts rc/tpl builds
    ({intra, inter (bh, bw) f64, mv (bh, bw, 2) i32, bh, bw}).

    frames[0] gets intra-only stats; frame i >= 1 searches frame i-1 (K2 +
    K7). Every frame's kernels are queued before the first fetch, and each
    frame's packed vector is fetched once."""
    device = torch.device(device)
    H, W = luma[0].shape
    Hp, Wp = pad_dims(H, W)
    bh, bw = H // BLK, W // BLK
    gr, gc = Hp // BLK, Wp // BLK
    preps = [prep_frame(upload_plane(np.asarray(p), device), Hp, Wp)
             for p in luma]
    vecs = [tpl_intra_stage(preps[0][0], H, W)]
    for i in range(1, len(luma)):
        cy2, cx2, g = grids_stage(preps[i][0], preps[i - 1][1])
        vecs.append(tpl_pair_stage(preps[i][0], preps[i - 1][1], cy2, cx2, g,
                                   H, W))
    stats = []
    for i, v in enumerate(vecs):
        a = v.cpu().numpy()
        if i == 0:
            intra = a.reshape(gr, gc)[:bh, :bw].astype(np.float64)
            stats.append(dict(intra=intra, inter=intra.copy(),
                              mv=np.zeros((bh, bw, 2), np.int32), bh=bh, bw=bw))
            continue
        n = gr * gc
        mv_y = a[0:n].reshape(gr, gc)[:bh, :bw].astype(np.int32)
        mv_x = a[n:2 * n].reshape(gr, gc)[:bh, :bw].astype(np.int32)
        inter = a[2 * n:3 * n].reshape(gr, gc)[:bh, :bw].astype(np.float64)
        intra = a[3 * n:4 * n].reshape(gr, gc)[:bh, :bw].astype(np.float64)
        stats.append(dict(intra=intra, inter=inter,
                          mv=np.stack([mv_y, mv_x], axis=-1), bh=bh, bw=bw))
    return stats
