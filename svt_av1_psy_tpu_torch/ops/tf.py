"""Kernel K4: whole-frame temporal filtering (`csrc/tf.cu`).

Replaces `svt_av1_psy_tpu/ops/tf.py`: `tf_pair_stage`, `tf_chroma_stage` and
`tf_finalize_stage`. TF-ME reuses K2's child grids; the 32x32 / 16x16 best
vectors share their aggregation and argmin device code with K3. The block
SSEs, the 5x5 box of squared errors and the finalize sums are exact integers
in the kernel and in the plain version; the weights round as the JAX program
rounds them (`jnp.round` is half to even, so `rintf`; IEEE `expf` and
division). The kernel and the plain version may still differ by one in a
weight where the CUDA and host `exp` differ in the last bit, so a filtered
pixel may differ by one.

Bound on the H100: memory traffic of the per-pixel weight and finalize
passes (a few planes of float32 per neighbour); the per-block pass keeps both
candidate predictions in shared memory.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from svt_av1_psy_tpu.codec.temporal_filter import (_noise_decay,
                                                   estimate_plane_noise)

from . import _build
from .inter_search import (PAD, _blocks, _gather, agg_argmin_ref,
                           grids_stage, pad_dims, prep_frame, prep_ref,
                           upload_plane)

_CENTER_W = 16.0
_F32 = torch.float32
_I64 = torch.int64

calls = {"kernel": 0, "plain": 0}


# ------------------------------------------------------------ plain version
def _box5(d2):
    """Edge-padded 5x5 window sum of an int64 plane, as float32 / 25."""
    h, w = d2.shape
    ri = torch.arange(-2, h + 2, device=d2.device).clamp_(0, h - 1)
    ci = torch.arange(-2, w + 2, device=d2.device).clamp_(0, w - 1)
    p = d2[ri][:, ci]
    s = sum(p[dy:dy + h, dx:dx + w] for dy in range(5) for dx in range(5))
    return s.to(_F32) * torch.tensor(1.0 / 25.0, dtype=_F32)


def _rep(x, B):
    return x.repeat_interleave(B, 0).repeat_interleave(B, 1)


def _plane(blk):
    gr, gc, bh, bw = blk.shape
    return blk.transpose(1, 2).reshape(gr * bh, gc * bw)


def _best_mv_ref(ssd8, cy2, cx2, nsr, nsc, B, Hr, Wr):
    mv_y, mv_x = agg_argmin_ref(ssd8, cy2, cx2, nsr, nsc, B, B)
    gr, gc = mv_y.shape
    by = torch.arange(gr, device=ssd8.device)[:, None] * B
    bx = torch.arange(gc, device=ssd8.device)[None, :] * B
    mv_y = torch.minimum(torch.maximum(mv_y, -by), (Hr - B) - by)
    mv_x = torch.minimum(torch.maximum(mv_x, -bx), (Wr - B) - bx)
    return mv_y, mv_x


def _weight(err, thresh):
    return torch.round(_CENTER_W * torch.exp(-err / thresh))


def tf_pair_stage_ref(src, ref, cy2, cx2, ssd8, thresh, Hr: int, Wr: int):
    """Plain version of one neighbour's luma stage. Returns (pred (Hp, Wp)
    f32, w (Hp, Wp) f32, mv32_y, mv32_x (gr32, gc32) i32)."""
    dev = src.device
    thresh = torch.tensor(thresh, dtype=_F32, device=dev)
    Hp, Wp = src.shape
    nsr, nsc = Hp // 64, Wp // 64
    mv32y, mv32x = _best_mv_ref(ssd8, cy2, cx2, nsr, nsc, 32, Hr, Wr)
    mv16y, mv16x = _best_mv_ref(ssd8, cy2, cx2, nsr, nsc, 16, Hr, Wr)
    ref_i = ref.to(_I64)
    src_i = src.to(_I64)

    def at(B, my, mx):
        gr, gc = my.shape
        by = torch.arange(gr, device=dev)[:, None] * B + PAD
        bx = torch.arange(gc, device=dev)[None, :] * B + PAD
        return _gather(ref_i, by + my, bx + mx, B, B)

    p32 = _plane(at(32, mv32y, mv32x))
    p16 = _plane(at(16, mv16y, mv16x))
    sse32 = _blocks((p32 - src_i) ** 2, 32, 32).sum((-1, -2))
    sse16 = _blocks((p16 - src_i) ** 2, 32, 32).sum((-1, -2))
    mse32 = (sse32.double() / 1024.0).to(_F32)
    mse16 = (sse16.double() / 1024.0).to(_F32)
    use_sub = (mse32 > thresh) & (mse16 < mse32)
    mse = torch.where(use_sub, mse16, mse32)
    pred = torch.where(_rep(use_sub, 32), p16, p32)
    wgt = torch.where(mse < 8.0 * thresh, _weight(mse, thresh),
                      torch.zeros_like(mse))
    err = 0.5 * _box5((pred - src_i) ** 2) + 0.5 * _rep(mse, 32)
    w = _weight(err, thresh)
    w = torch.where(_rep(wgt, 32) > 0.0, w, torch.zeros_like(w))
    return pred.to(_F32), w, mv32y.to(torch.int32), mv32x.to(torch.int32)


def tf_chroma_stage_ref(cu, cv, ru, rv, mv32y, mv32x, wy, thresh_uv,
                        Hc: int, Wc: int):
    """Plain version of one neighbour's chroma stage (4:2:0). Returns
    (pred_u, w_u, pred_v, w_v), each (Hp/2, Wp/2) f32."""
    dev = cu.device
    thresh_uv = torch.tensor(thresh_uv, dtype=_F32, device=dev)
    grc, gcc = mv32y.shape
    by = torch.arange(grc, device=dev)[:, None] * 16
    bx = torch.arange(gcc, device=dev)[None, :] * 16
    my = mv32y.to(_I64) >> 1
    mx = mv32x.to(_I64) >> 1
    my = torch.minimum(torch.maximum(my, -by), (Hc - 16) - by)
    mx = torch.minimum(torch.maximum(mx, -bx), (Wc - 16) - bx)
    gate = wy[::2, ::2] > 0.0
    outs = []
    for csrc, cref in ((cu, ru), (cv, rv)):
        pred = _plane(_gather(cref.to(_I64), by + PAD + my, bx + PAD + mx,
                              16, 16))
        w = _weight(_box5((pred - csrc.to(_I64)) ** 2), thresh_uv)
        outs += [pred.to(_F32), torch.where(gate, w, torch.zeros_like(w))]
    return tuple(outs)


def tf_finalize_stage_ref(src, preds, ws, Hr: int, Wr: int):
    """Plain version of the weighted average (centre weight 16, round half
    up): (Hp, Wp) src, (K, Hp, Wp) preds / weights -> (Hr, Wr) f32."""
    w = ws.to(_I64)
    acc = 16 * src.to(_I64) + (preds.to(_I64) * w).sum(0)
    den = 16 + w.sum(0)
    return ((acc + den // 2) // den)[:Hr, :Wr].to(_F32)


# ------------------------------------------------------------ the kernel
@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("tf")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tf_pair_launch.argtypes = [P] * 5 + [F] + [I] * 5 + [P] * 7
    lib.tf_chroma_launch.argtypes = [P] * 7 + [F] + [I] * 5 + [P] * 5
    lib.tf_finalize_launch.argtypes = [P] * 3 + [I] * 5 + [P] * 2
    for fn in (lib.tf_pair_launch, lib.tf_chroma_launch, lib.tf_finalize_launch):
        fn.restype = ctypes.c_int
    return lib


def _need(t, shape, dtype, dev):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"K4 argument {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}: want {tuple(shape)} {dtype} on {dev}")


def _check_device(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K4 takes cpu or cuda tensors, not {t.device}")
    return t.device.type == "cuda"


def tf_pair_stage(src, ref, cy2, cx2, ssd8, thresh, Hr: int, Wr: int):
    """K4 luma stage: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if not _check_device(src):
        _build.count(calls, "plain")
        return tf_pair_stage_ref(src, ref, cy2, cx2, ssd8, thresh, Hr, Wr)
    dev = src.device
    Hp, Wp = src.shape
    n = (Hp // 64) * (Wp // 64)
    _need(src, (Hp, Wp), _F32, dev)
    _need(ref, (Hp + 2 * PAD, Wp + 2 * PAD), _F32, dev)
    _need(cy2, (2, n), torch.int32, dev)
    _need(cx2, (2, n), torch.int32, dev)
    _need(ssd8, (2, n, 8, 8, 25, 25), torch.int32, dev)
    g = (Hp // 32, Wp // 32)
    pred = torch.empty(Hp, Wp, dtype=_F32, device=dev)
    w = torch.empty_like(pred)
    mse = torch.empty(g, dtype=_F32, device=dev)
    wgt = torch.empty_like(mse)
    mvy = torch.empty(g, dtype=torch.int32, device=dev)
    mvx = torch.empty_like(mvy)
    P = _build.ptr
    rc = _lib().tf_pair_launch(P(src), P(ref), P(cy2), P(cx2), P(ssd8),
                               float(np.float32(thresh)), Hp, Wp, Hr, Wr, PAD,
                               P(pred), P(mse), P(wgt), P(mvy), P(mvx), P(w),
                               _build.stream(dev))
    _build.check(rc, "tf_pair_launch")
    _build.count(calls, "kernel")
    return pred, w, mvy, mvx


def tf_chroma_stage(cu, cv, ru, rv, mv32y, mv32x, wy, thresh_uv,
                    Hc: int, Wc: int):
    """K4 chroma stage (4:2:0)."""
    if not _check_device(cu):
        _build.count(calls, "plain")
        return tf_chroma_stage_ref(cu, cv, ru, rv, mv32y, mv32x, wy,
                                   thresh_uv, Hc, Wc)
    dev = cu.device
    Hpc, Wpc = cu.shape
    _need(cv, (Hpc, Wpc), _F32, dev)
    _need(cu, (Hpc, Wpc), _F32, dev)
    for r in (ru, rv):
        _need(r, (Hpc + 2 * PAD, Wpc + 2 * PAD), _F32, dev)
    _need(mv32y, (Hpc // 16, Wpc // 16), torch.int32, dev)
    _need(mv32x, (Hpc // 16, Wpc // 16), torch.int32, dev)
    _need(wy, (2 * Hpc, 2 * Wpc), _F32, dev)
    outs = [torch.empty(Hpc, Wpc, dtype=_F32, device=dev) for _ in range(4)]
    P = _build.ptr
    rc = _lib().tf_chroma_launch(P(cu), P(cv), P(ru), P(rv), P(mv32y),
                                 P(mv32x), P(wy), float(np.float32(thresh_uv)),
                                 Hc, Wc, Hpc, Wpc, PAD, *[P(o) for o in outs],
                                 _build.stream(dev))
    _build.check(rc, "tf_chroma_launch")
    _build.count(calls, "kernel")
    return tuple(outs)


def tf_finalize_stage(src, preds, ws, Hr: int, Wr: int):
    """K4 finalize: weighted average over the neighbour stack, cropped."""
    if not _check_device(src):
        _build.count(calls, "plain")
        return tf_finalize_stage_ref(src, preds, ws, Hr, Wr)
    dev = src.device
    Hp, Wp = src.shape
    K = preds.shape[0]
    _need(src, (Hp, Wp), _F32, dev)
    _need(preds, (K, Hp, Wp), _F32, dev)
    _need(ws, (K, Hp, Wp), _F32, dev)
    out = torch.empty(Hr, Wr, dtype=_F32, device=dev)
    P = _build.ptr
    rc = _lib().tf_finalize_launch(P(src), P(preds), P(ws), K, Hp, Wp, Hr, Wr,
                                   P(out), _build.stream(dev))
    _build.check(rc, "tf_finalize_launch")
    _build.count(calls, "kernel")
    return out


# ------------------------------------------------------------ driver
# Bytes one superblock holds while a frame filters: the child grids of the
# neighbour in flight (2 x 64 x 25 x 25 int32) plus, per neighbour, luma and
# chroma predictions and weights in float32.
_BYTES_PER_SB = 2 * 64 * 625 * 4
_BYTES_PER_SB_NEIGHBOUR = 64 * 64 * 4 * 3
_SB_BUDGET_HOST = 2048          # the reference's bound, for host tensors


def _sb_budget(device, n_neighbours: int) -> int:
    """How many superblocks one band may hold: half the card's free memory
    on CUDA; the reference's constant on the host."""
    device = torch.device(device)
    if device.type != "cuda":
        return _SB_BUDGET_HOST
    free, _total = torch.cuda.mem_get_info(device)
    per = _BYTES_PER_SB + n_neighbours * _BYTES_PER_SB_NEIGHBOUR
    return max(1, int(free // 2 // per))


def temporal_filter_device(center, neighbors, strength: int, bd: int = 8,
                           device="cpu"):
    """Port of the reference's device TF driver (same signature plus the
    device): host noise estimation, then per neighbour the K2 grids and K4
    stages, one finalize per plane. Frames above the superblock budget
    band-split."""
    cy0 = np.asarray(center[0])
    H, W = cy0.shape
    nsc = -(-W // 64)
    budget = _sb_budget(device, len(neighbors))
    if -(-H // 64) * nsc > budget:
        rows = max(1, budget // nsc) * 64
        outs = []
        y0 = 0
        while y0 < H:
            y1 = min(y0 + rows, H)
            if H - y1 < 64:
                y1 = H

            def cut(t, lo, hi):
                return tuple(
                    None if p is None
                    else np.asarray(p)[lo >> s: (hi + s) >> s]
                    for p, s in zip(t, (0, 1, 1)))

            outs.append(_tf_device_frame(cut(center, y0, y1),
                                         [cut(nb, y0, y1) for nb in neighbors],
                                         strength, bd, device))
            y0 = y1
        fy = np.concatenate([o[0] for o in outs], axis=0)
        if outs[0][1] is None:
            return fy, None, None
        return (fy, np.concatenate([o[1] for o in outs], axis=0),
                np.concatenate([o[2] for o in outs], axis=0))
    return _tf_device_frame(center, neighbors, strength, bd, device)


def _tf_device_frame(center, neighbors, strength: int, bd: int, device):
    cy, cu, cv = center
    if strength <= 0 or not neighbors:
        return cy, cu, cv
    device = torch.device(device)
    cy = np.asarray(cy)
    H, W = cy.shape
    Hp, Wp = pad_dims(H, W)
    base = 24.0 * (2.0 ** (strength - 1)) * (1 << (2 * (bd - 8)))
    thresh = base * _noise_decay(estimate_plane_noise(cy, bd))
    mono = cu is None
    if not mono:
        cu = np.asarray(cu)
        cv = np.asarray(cv)
        thresh_uv = base * _noise_decay(estimate_plane_noise(cu, bd))
        Hc, Wc = cu.shape
        Hp2, Wp2 = Hp // 2, Wp // 2

    def up(p, hp, wp):
        return prep_frame(upload_plane(p, device), hp, wp)[0]

    def up_ref(p, hp, wp):
        return prep_ref(upload_plane(np.asarray(p), device), hp, wp)

    src = up(cy, Hp, Wp)
    if not mono:
        csrc_u = up(cu, Hp2, Wp2)
        csrc_v = up(cv, Hp2, Wp2)
    preds_y, ws_y = [], []
    preds_u, ws_u, preds_v, ws_v = [], [], [], []
    for ny, nu, nv in neighbors:
        nref = up_ref(ny, Hp, Wp)
        g = grids_stage(src, nref)
        pred, w, mv32y, mv32x = tf_pair_stage(src, nref, *g, thresh, H, W)
        preds_y.append(pred)
        ws_y.append(w)
        if not mono:
            pu, wu, pv, wv = tf_chroma_stage(
                csrc_u, csrc_v, up_ref(nu, Hp2, Wp2), up_ref(nv, Hp2, Wp2),
                mv32y, mv32x, w, thresh_uv, Hc, Wc)
            preds_u.append(pu)
            ws_u.append(wu)
            preds_v.append(pv)
            ws_v.append(wv)

    fy = tf_finalize_stage(src, torch.stack(preds_y), torch.stack(ws_y), H, W)
    if mono:
        return fy.cpu().numpy().astype(cy.dtype), None, None
    fu = tf_finalize_stage(csrc_u, torch.stack(preds_u), torch.stack(ws_u),
                           Hc, Wc)
    fv = tf_finalize_stage(csrc_v, torch.stack(preds_v), torch.stack(ws_v),
                           Hc, Wc)
    return (fy.cpu().numpy().astype(cy.dtype),
            fu.cpu().numpy().astype(cu.dtype),
            fv.cpu().numpy().astype(cv.dtype))
