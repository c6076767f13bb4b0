"""Kernel K6: the device residual commit of inter leaves (`csrc/commit.cu`).

Replaces `svt_av1_psy_tpu/ops/commit.py`: `_group_program` (:326, built by
`_jit_group` :442) and its caller `commit_frame` (:576). For every inter leaf
the mode decision produced, one group per (leaf size S, compound, luma tx
type) runs

    MC prediction -> residual -> forward TX -> QM quantize (+ RDOQ eob-fast
    trim) -> dequantize -> inverse TX -> reconstruction

bit-exactly in integers and hands the C walk scan-packed levels, eobs and
recon blocks (`CommitResult`, read through `walk_native.c`'s `pre_*`
fields), so the walk only does syntax and range coding for those leaves.

On a CUDA device a group is K6's prediction kernel, K5's forward transform
(`ops/txfm.py`), K6's quantize kernel and K5's inverse + add, luma first,
then both chroma planes (their tx type follows the luma eob). On the CPU it
is the plain version `_group_program`, a line-for-line counterpart of the
JAX program; it computes both chroma variants and selects, as JAX does,
while the kernels compute only the selected one (the same outputs).

The host side (leaf enumeration and eligibility, the 16-row qindex table,
the chunking, the pow-2 fetch ladder, the unpack and the recon scatter) is
the reference's, line for line; its numpy helpers are imported unchanged.
Refs and sources go up once per frame from pinned host buffers; all chunks'
results come back in one device-to-host copy per frame.
Bound on the H100: the per-frame copies (~1.3 MB up, ~0.2-1 MB down at
480p) and launch latency; each group is a few hundred lanes of <= 64x64.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from svt_av1_psy_tpu.codec.quant import TX_SCALE
from svt_av1_psy_tpu.ops.commit import (_CHUNK_LANES, _K_FETCH, CommitResult,
                                        _chroma_geom, _leaf_qp_rows, _lv_caps,
                                        _scan_np, _size_tts, _tx_size_of)

from . import _build
from . import txfm as TX
from .txfm import forward_transform_2d_ref, inverse_transform_add_ref

_I32 = torch.int32
_I64 = torch.int64
_M32 = 0xFFFFFFFF

calls = {"kernel": 0, "plain": 0}
# per-encode leaf counts of commit_frame: inter leaves decided, lanes sent to
# the device, lanes whose levels the walk reads (the rest it recomputes)
leaves = {"inter": 0, "lanes": 0, "kept": 0}


# ------------------------------------------------------------ plain version
def _conv2d_batched(patches, fx, fy, w: int, h: int, bd: int):
    """Unified single-ref 2D convolve: patches (B, h+7, w+7) int32, fx/fy
    (B, 8) int32 per-leaf kernel rows (phase-0 rows are deltas)."""
    x = patches
    off = 1 << (bd + 6)
    im = torch.zeros((x.shape[0], h + 7, w), dtype=_I32, device=x.device)
    for k in range(8):
        im = im + fx[:, k, None, None] * x[:, :, k:k + w]
    im = (im + off + 4) >> 3
    out = torch.zeros((x.shape[0], h, w), dtype=_I32, device=x.device)
    for k in range(8):
        out = out + fy[:, k, None, None] * im[:, k:k + h, :]
    offset_bits = bd + 14 - 3
    out = ((out + (1 << offset_bits) + (1 << 10)) >> 11) - (
        (1 << (offset_bits - 11)) + (1 << (offset_bits - 12)))
    return out.clamp(0, (1 << bd) - 1)


def _jnt_conv_batched(patches, fx, fy, w: int, h: int, bd: int):
    """Jnt convolve into the ConvBuf domain."""
    R0, R1, FB = 3, 7, 7
    offset_bits = bd + 2 * FB - R0
    im = torch.full((patches.shape[0], h + 7, w), 1 << (bd + FB - 1),
                    dtype=_I32, device=patches.device)
    for k in range(8):
        im = im + fx[:, k, None, None] * patches[:, :, k:k + w]
    im = (im + (1 << (R0 - 1))) >> R0
    out = torch.full((patches.shape[0], h, w), 1 << offset_bits, dtype=_I32,
                     device=patches.device)
    for k in range(8):
        out = out + fy[:, k, None, None] * im[:, k:k + h, :]
    return (out + (1 << (R1 - 1))) >> R1


def _compound_avg(buf0, buf1, bd: int):
    """COMPOUND_AVERAGE tail."""
    R0, R1, FB = 3, 7, 7
    offset_bits = bd + 2 * FB - R0
    round_offset = (1 << (offset_bits - R1)) + (1 << (offset_bits - R1 - 1))
    round_bits = 2 * FB - R0 - R1
    tmp = ((buf0 + buf1) >> 1) - round_offset
    tmp = (tmp + (1 << (round_bits - 1))) >> round_bits
    return tmp.clamp(0, (1 << bd) - 1)


def _u32(x):
    """int32 (or uint32-in-int64) -> its uint32 value, held in int64."""
    return x.to(_I64) & _M32


def _i32(x):
    """uint32-in-int64 -> int32 with the wrap of `.astype(jnp.int32)`."""
    return (((x + (1 << 31)) & _M32) - (1 << 31)).to(_I32)


def _mul_shift_u32(a, b, s: int):
    """floor((a * b) >> s) with the uint32 hi/lo split of the JAX program,
    each uint32 step wrapped explicitly (values in int64)."""
    a = _u32(a)
    b = _u32(b)
    hi = a >> 14
    lo = a & 16383
    p = (hi * b) & _M32
    q = (lo * b) & _M32
    if s >= 14:
        low = (((p & ((1 << (s - 14)) - 1)) << 14) & _M32)
        return ((p >> (s - 14)) + (((low + q) & _M32) >> s)) & _M32
    return (((p << (14 - s)) & _M32) + (q >> s)) & _M32


def _quantize_batched(flat, qp, qm, iqm, log_scale: int, n: int):
    """Device quantize_b: flat (B, n) int32 raster coeffs; qp (B, 10) int32
    rows; qm/iqm (n,) int32 or None. Returns (qcoeff, dqcoeff) int32."""
    dev = flat.device
    is_ac = (torch.arange(n, device=dev) != 0)[None, :]

    def rpot(v):
        if log_scale:
            return (v + (1 << (log_scale - 1))) >> log_scale
        return v

    def sel(dc_i, ac_i):
        return torch.where(is_ac, qp[:, ac_i, None], qp[:, dc_i, None])

    zbin = rpot(sel(0, 1))
    rnd = rpot(sel(2, 3))
    m = sel(4, 5) + (1 << 16)
    qs = sel(6, 7)
    deq = sel(8, 9)
    wt = (qm[None, :] if qm is not None
          else torch.full((1, n), 32, dtype=_I32, device=dev))
    iwt = (iqm[None, :] if iqm is not None
           else torch.full((1, n), 32, dtype=_I32, device=dev))

    sign = flat < 0
    a = flat.abs()
    live = a * wt >= (zbin << 5)
    tmpw = (a + rnd) * wt
    x = _mul_shift_u32(tmpw, m, 16)
    abs_q = _i32(_mul_shift_u32(x, qs, 16 - log_scale + 5))
    abs_q = torch.where(live, abs_q, torch.zeros_like(abs_q))
    dequant = (deq * iwt + 16) >> 5
    abs_dq = _i32(_mul_shift_u32(abs_q, dequant, log_scale))
    return (torch.where(sign, -abs_q, abs_q),
            torch.where(sign, -abs_dq, abs_dq))


def _eob_batched(qcoeff, scan):
    """eob per row: 1 + last scan index with a nonzero coeff (0 if none)."""
    nz = qcoeff[:, scan.long()] != 0
    idx = torch.arange(1, scan.shape[0] + 1, dtype=_I32,
                       device=qcoeff.device)[None, :]
    return torch.where(nz, idx, torch.zeros_like(idx)).max(dim=1).values.to(_I32)


def _rdoq_trim(flat, qcoeff, dqcoeff, eob, qp, scan, log_scale: int):
    """RDOQ eob-fast tier: the new eob is the last scan position (within the
    old eob) that fails the trim condition; later positions are zeroed."""
    n = scan.shape[0]
    sl = scan.long()
    dev = flat.device
    deq_dc, deq_ac = qp[:, 8, None], qp[:, 9, None]
    zbin_dc = deq_dc + ((deq_dc * 70 + 64) >> 7)
    zbin_ac = deq_ac + ((deq_ac * 70 + 64) >> 7)
    a_s = flat[:, sl].abs()
    is_ac = (scan != 0)[None, :]
    zbin = torch.where(is_ac, zbin_ac, zbin_dc)
    cond = ((a_s << (1 + log_scale)) < zbin) | (qcoeff[:, sl] == 0)
    idx = torch.arange(1, n + 1, dtype=_I32, device=dev)[None, :]
    live = torch.where(~cond & (idx <= eob[:, None]), idx, torch.zeros_like(idx))
    new_eob = live.max(dim=1).values.to(_I32)
    spos = torch.zeros(n, dtype=_I32, device=dev)
    spos[sl] = torch.arange(n, dtype=_I32, device=dev)
    keep = spos[None, :] < new_eob[:, None]
    return (torch.where(keep, qcoeff, torch.zeros_like(qcoeff)),
            torch.where(keep, dqcoeff, torch.zeros_like(dqcoeff)), new_eob)


def _dslice(s, dim: int, size: int):
    """The start `jax.lax.dynamic_slice` uses: a negative start counts from
    the end (+ dim), then the start clamps into [0, dim - size]."""
    return torch.where(s < 0, s + dim, s).clamp(0, dim - size).long()


def _gather_ref(ref2, starts, ph: int, pw: int):
    """ref2 (2, Hp, Wp); starts (B, 3) int32 (ref_idx, y, x) -> (B, ph, pw)
    int32 patches, with dynamic_slice's start rule."""
    R, Hp, Wp = ref2.shape
    dev = ref2.device
    ri = _dslice(starts[:, 0], R, 1)
    ys = _dslice(starts[:, 1], Hp, ph)
    xs = _dslice(starts[:, 2], Wp, pw)
    rows = ys[:, None] + torch.arange(ph, device=dev)[None, :]
    cols = xs[:, None] + torch.arange(pw, device=dev)[None, :]
    return ref2[ri[:, None, None], rows[:, :, None], cols[:, None, :]].to(_I32)


def _gather_src(srcp, py, px, ph: int, pw: int):
    Hs, Ws = srcp.shape
    dev = srcp.device
    ys = _dslice(py, Hs, ph)
    xs = _dslice(px, Ws, pw)
    rows = ys[:, None] + torch.arange(ph, device=dev)[None, :]
    cols = xs[:, None] + torch.arange(pw, device=dev)[None, :]
    return srcp[rows[:, :, None], cols[:, None, :]].to(_I32)


def _plane_run(src_blk, pred, sel, tx_size: int, tts, qp, qms, iqms,
               scans, bd: int, rdoq: bool, K: int):
    """One plane's residual pipeline over the tx-type variants `tts`; `sel`
    (B,) picks the variant per leaf when there are two. Returns (lv (B, K)
    scan-packed levels, eob (B,), recon (B, H, W) int32)."""
    B, H, W = src_blk.shape
    cw, ch = min(W, 32), min(H, 32)
    n = cw * ch
    log_scale = int(TX_SCALE[tx_size])
    resid = src_blk - pred
    outs = []
    for vi, tt in enumerate(tts):
        co = forward_transform_2d_ref(resid, tx_size, int(tt))
        flat = co[:, :ch, :cw].reshape(B, n)
        qc, dqc = _quantize_batched(flat, qp, qms[vi], iqms[vi], log_scale, n)
        eob = _eob_batched(qc, scans[vi])
        if rdoq:
            qc, dqc, eob = _rdoq_trim(flat, qc, dqc, eob, qp, scans[vi],
                                      log_scale)
        full = torch.zeros((B, H, W), dtype=_I32, device=src_blk.device)
        full[:, :ch, :cw] = dqc.reshape(B, ch, cw)
        rec = inverse_transform_add_ref(full, pred, tx_size, int(tt), bd)
        lv = qc[:, scans[vi][:K].long()]
        outs.append((lv, eob, rec))
    if len(tts) == 1:
        return outs[0]
    lv = torch.stack([o[0] for o in outs])
    eob = torch.stack([o[1] for o in outs])
    rec = torch.stack([o[2] for o in outs])
    bi = torch.arange(B, device=src_blk.device)
    s = sel.long()
    return lv[s, bi], eob[s, bi], rec[s, bi]


def _group_program(refs, srcs, meta, qtab_y, qtab_uv, f8, f4, tabs_y,
                   tabs_uv, *, S: int, bd: int, is_comp: bool,
                   nplanes: int, rdoq: bool, pad: int, tts_y, tts_uv):
    """Plain version of one (S, is_comp, luma tx type) group over B lanes.

    refs: per plane (2, Hp, Wp) uint8 / int16 (LAST, second reference);
    srcs: per plane (H, W); meta (B, 8) int32 [y, x, mv_r, mv_c, mv2_r,
    mv2_c, ref_idx, q_sel]; qtab_y / qtab_uv (U, 10) int32; f8 / f4 (16, 8)
    int32; tabs_*: (qms, iqms, scans) per variant. Returns (lv (B, Ky+2Kuv)
    int16, meta_out (B, 4) int32 [eob_y, eob_u, eob_v, over], rec (B,
    S*S(+2 chroma)) uint8, or int16 holding uint16 samples)."""
    W = H = S
    Ky, Kuv = _lv_caps(S, nplanes)
    posy = meta[:, 0:2]
    mv = meta[:, 2:4]
    mv2 = meta[:, 4:6]
    ref_idx = meta[:, 6]
    # jnp indexing: a negative index counts from the end, others clamp
    qsel = _dslice(meta[:, 7], qtab_y.shape[0], 1)
    qp_y = qtab_y[qsel]
    qp_uv = qtab_uv[qsel]

    def phases(mvp, plane):
        if plane == 0:
            return mvp >> 3, (mvp & 7) << 1
        return mvp >> 4, mvp & 15

    def pred_plane(refp, plane, pw_, ph_, px, py):
        fxt = f8 if pw_ > 4 else f4
        fyt = f8 if ph_ > 4 else f4
        ip, phs = phases(mv, plane)
        starts = torch.stack(
            [torch.zeros_like(ref_idx) if is_comp else ref_idx,
             py + ip[:, 0] + pad - 3,
             px + ip[:, 1] + pad - 3], dim=1)
        fx = fxt[phs[:, 1].long()]
        fy = fyt[phs[:, 0].long()]
        p0 = _gather_ref(refp, starts, ph_ + 7, pw_ + 7)
        if not is_comp:
            return _conv2d_batched(p0, fx, fy, pw_, ph_, bd)
        b0 = _jnt_conv_batched(p0, fx, fy, pw_, ph_, bd)
        ip2, phs2 = phases(mv2, plane)
        starts2 = torch.stack(
            [torch.ones_like(ref_idx),
             py + ip2[:, 0] + pad - 3,
             px + ip2[:, 1] + pad - 3], dim=1)
        p1 = _gather_ref(refp, starts2, ph_ + 7, pw_ + 7)
        b1 = _jnt_conv_batched(p1, fxt[phs2[:, 1].long()],
                               fyt[phs2[:, 0].long()], pw_, ph_, bd)
        return _compound_avg(b0, b1, bd)

    py_, px_ = posy[:, 0], posy[:, 1]
    ts_y = _tx_size_of(S, S)
    predY = pred_plane(refs[0], 0, W, H, px_, py_)
    srcbY = _gather_src(srcs[0], py_, px_, H, W)
    lvY, eobY, recY = _plane_run(srcbY, predY, None, ts_y, tts_y, qp_y,
                                 tabs_y[0], tabs_y[1], tabs_y[2], bd, rdoq,
                                 Ky)
    rdt = torch.uint8 if bd == 8 else torch.int16
    recb = [recY.to(rdt)]
    lvs, eobs = [lvY], [eobY]
    over = eobY > Ky
    over = over | (lvY.abs().max(dim=1).values > 32767)

    if nplanes > 1:
        cw, ch_, ts_uv = _chroma_geom(W, H)
        cx, cy = px_ >> 1, py_ >> 1
        sel = ((eobY > 0).to(_I32) if len(tts_uv) > 1 else None)
        for plane in (1, 2):
            predC = pred_plane(refs[plane], plane, cw, ch_, cx, cy)
            srcbC = _gather_src(srcs[plane], cy, cx, ch_, cw)
            lvC, eobC, recC = _plane_run(srcbC, predC, sel, ts_uv, tts_uv,
                                         qp_uv, tabs_uv[0], tabs_uv[1],
                                         tabs_uv[2], bd, rdoq, Kuv)
            lvs.append(lvC)
            eobs.append(eobC)
            over = over | (eobC > Kuv) | (lvC.abs().max(dim=1).values > 32767)
            recb.append(recC.to(rdt))
    lv = torch.cat(lvs, dim=1).to(torch.int16)
    eob3 = torch.stack(eobs + [eobs[0]] * (3 - len(eobs)), dim=1)
    meta_out = torch.cat([eob3, over[:, None].to(_I32)], dim=1)
    B = meta.shape[0]
    rec = torch.cat([b.reshape(B, -1) for b in recb], dim=1)
    return lv, meta_out, rec


# ------------------------------------------------------------ the kernel
@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("commit")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.commit_pred_launch.argtypes = [P, I, I, P]
    lib.commit_quant_launch.argtypes = [P, I, I, P]
    lib.commit_pred_launch.restype = ctypes.c_int
    lib.commit_quant_launch.restype = ctypes.c_int
    return lib


def _check_device(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K6 takes cpu or cuda tensors, not {t.device}")
    return t.device.type == "cuda"


def _need(t, shape, dtypes, dev, what):
    if (tuple(t.shape) != tuple(shape) or t.dtype not in dtypes
            or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"K6 {what} {tuple(t.shape)} {t.dtype} on {t.device}: "
                         f"want {tuple(shape)} {dtypes} on {dev}")


_SAMPLES = (torch.uint8, torch.int16)


def _addr(t):
    return 0 if t is None else t.data_ptr()


def _launch(fn, params, B: int, grid_y: int, dev, what: str):
    p = np.asarray(params, np.int64)
    rc = fn(ctypes.c_void_p(p.ctypes.data), B, grid_y, _build.stream(dev))
    _build.check(rc, what)
    _build.count(calls, "kernel")


def _group_kernel(refs, srcs, meta, qtab_y, qtab_uv, f8, f4, tabs_y,
                  tabs_uv, *, S, bd, is_comp, nplanes, rdoq, pad, tts_y,
                  tts_uv):
    dev = meta.device
    B = meta.shape[0]
    Ky, Kuv = _lv_caps(S, nplanes)
    c = S >> 1
    T = S * S + (2 * c * c if nplanes > 1 else 0)
    U = qtab_y.shape[0]
    _need(meta, (B, 8), (_I32,), dev, "meta")
    for q in (qtab_y, qtab_uv):
        _need(q, (U, 10), (_I32,), dev, "quant table")
    for f in (f8, f4):
        _need(f, (16, 8), (_I32,), dev, "filter table")
    for p in range(nplanes):
        _need(refs[p], (2,) + tuple(refs[p].shape[1:]), _SAMPLES, dev, "ref")
        _need(srcs[p], tuple(srcs[p].shape), _SAMPLES, dev, "source")
        if (refs[p].dtype != refs[0].dtype or srcs[p].dtype != srcs[0].dtype
                or refs[p].shape[1] < (S >> min(p, 1)) + 7
                or srcs[p].shape[0] < (S >> min(p, 1))):
            raise ValueError("K6: planes disagree in type or are too small")
    pred = torch.empty(B, T, dtype=_I32, device=dev)
    res = torch.empty_like(pred)
    coef = torch.empty_like(pred)
    dq = torch.empty_like(pred)
    lv = torch.empty(B, Ky + 2 * Kuv, dtype=torch.int16, device=dev)
    meta_out = torch.zeros(B, 4, dtype=_I32, device=dev)
    rec = torch.empty(B, T, dtype=torch.uint8 if bd == 8 else torch.int16,
                      device=dev)
    lib = _lib()
    pl3 = list(range(nplanes)) + [0] * (3 - nplanes)
    _launch(lib.commit_pred_launch,
            [refs[p].data_ptr() for p in pl3] + [srcs[p].data_ptr() for p in pl3]
            + [refs[p].shape[1] for p in pl3] + [refs[p].shape[2] for p in pl3]
            + [srcs[p].shape[0] for p in pl3] + [srcs[p].shape[1] for p in pl3]
            + [meta.data_ptr(), f8.data_ptr(), f4.data_ptr(), S, bd,
               int(is_comp), pad, refs[0].element_size(),
               srcs[0].element_size(), T, pred.data_ptr(), res.data_ptr()],
            B, nplanes, dev, "commit_pred_launch")

    def quant(plane0, nlaunch, tabs, qtab, Sp, ts, K):
        qms, iqms, scans = tabs
        nv = len(scans)
        two = (lambda xs: [_addr(xs[0]), _addr(xs[-1])])
        _launch(lib.commit_quant_launch,
                [coef.data_ptr(), dq.data_ptr(), T, meta.data_ptr(),
                 qtab.data_ptr(), U] + two(qms) + two(iqms) + two(scans)
                + [nv, int(TX_SCALE[ts]), Sp, plane0, 0, S * S, S * S + c * c,
                   lv.data_ptr(), Ky + 2 * Kuv, 0, Ky, Ky + Kuv, K,
                   meta_out.data_ptr(), nplanes, int(rdoq)],
                B, nlaunch, dev, "commit_quant_launch")

    ts_y = _tx_size_of(S, S)
    TX.fwd_launch(TX.tx_spec(ts_y, tts_y[0], False, 8, dev), None, None, res,
                  coef, B, T)
    quant(0, 1, tabs_y, qtab_y, S, ts_y, Ky)
    TX.inv_launch(TX.tx_spec(ts_y, tts_y[0], True, bd, dev), None, None, dq,
                  pred, rec, B, T)
    if nplanes > 1:
        _, _, ts_uv = _chroma_geom(S, S)
        fw = [TX.tx_spec(ts_uv, t, False, 8, dev) for t in tts_uv]
        iv = [TX.tx_spec(ts_uv, t, True, bd, dev) for t in tts_uv]
        two = len(tts_uv) > 1
        sel = (meta_out, 4) if two else None
        o = S * S
        TX.fwd_launch(fw[0], fw[-1] if two else None, sel, res[:, o:],
                      coef[:, o:], B, T, 2, c * c)
        quant(1, 2, tabs_uv, qtab_uv, c, ts_uv, Kuv)
        TX.inv_launch(iv[0], iv[-1] if two else None, sel, dq[:, o:],
                      pred[:, o:], rec[:, o:], B, T, 2, c * c)
    return lv, meta_out, rec


def commit_group(refs, srcs, meta, qtab_y, qtab_uv, f8, f4, tabs_y, tabs_uv,
                 **kw):
    """K6 group (keywords of `_group_program`): the kernels for CUDA
    tensors, the plain version for CPU tensors."""
    if not _check_device(meta):
        _build.count(calls, "plain")
        return _group_program(refs, srcs, meta, qtab_y, qtab_uv, f8, f4,
                              tabs_y, tabs_uv, **kw)
    return _group_kernel(refs, srcs, meta, qtab_y, qtab_uv, f8, f4, tabs_y,
                         tabs_uv, **kw)


@functools.lru_cache(maxsize=None)
def _jit_group(S, is_comp, vi, bd, nplanes, rdoq, pad):
    """The group callable of one (leaf size, compound, luma tx type,
    config), with the reference's variant layout: tts_y = (tt,), tts_uv =
    (ctt0[, ctt])."""
    tts_y_all, tts_uv_all = _size_tts(S)
    tt = tts_y_all[vi]
    ctt0, ctt = tts_uv_all[0], tts_uv_all[vi]
    tts_y = (tt,)
    tts_uv = (ctt0,) if ctt == ctt0 else (ctt0, ctt)
    return functools.partial(commit_group, S=S, bd=bd, is_comp=bool(is_comp),
                             nplanes=nplanes, rdoq=rdoq, pad=pad,
                             tts_y=tts_y, tts_uv=tts_uv)


@functools.lru_cache(maxsize=64)
def _size_tables(S: int, nplanes: int, qm_key, device):
    """Per-variant (qm, iqm, scan) int32 tensors on `device` for leaf size
    S. qm_key: tuple(qm_levels) or None (frame-constant)."""
    from svt_av1_psy_tpu.codec.qm import get_qm

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    def plane_tabs(plane, ts, tts):
        qms, iqms, scans = [], [], []
        for t in tts:
            qm = iqm = None
            if t < 9 and qm_key is not None:
                qm, iqm = get_qm(qm_key[plane], plane > 0, ts)
            qms.append(None if qm is None else t32(qm))
            iqms.append(None if iqm is None else t32(iqm))
            scans.append(t32(_scan_np(ts, t)))
        return (tuple(qms), tuple(iqms), tuple(scans))

    tts_y, tts_uv = _size_tts(S)
    tabs_y = plane_tabs(0, _tx_size_of(S, S), tts_y)
    if nplanes > 1:
        _, _, ts_uv = _chroma_geom(S, S)
        tabs_uv = plane_tabs(1, ts_uv, tts_uv)
    else:
        tabs_uv = ((), (), ())
    return tabs_y, tabs_uv


@functools.lru_cache(maxsize=256)
def _vi_tables(S: int, nplanes: int, qm_key, vi: int, device):
    """Single-variant tables matching _jit_group(S, ..., vi)'s layout."""
    tabs_y, tabs_uv = _size_tables(S, nplanes, qm_key, device)
    tts_y, tts_uv = _size_tts(S)
    y = tuple(t[vi:vi + 1] for t in tabs_y)
    if nplanes <= 1:
        return y, ((), (), ())
    if tts_uv[vi] == tts_uv[0]:
        uv = tuple(t[0:1] for t in tabs_uv)
    else:
        uv = tuple((t[0], t[vi]) for t in tabs_uv)
    return y, uv


@functools.lru_cache(maxsize=8)
def _filter_tables(f8_bytes: bytes, device):
    from svt_av1_psy_tpu.codec.spec_tables import get_tables

    f8 = np.frombuffer(f8_bytes, np.int32).reshape(16, 8)
    f4 = np.asarray(get_tables()._raw["interp_sub_pel_filters_4"], np.int32)
    return (torch.from_numpy(f8.copy()).to(device),
            torch.from_numpy(np.ascontiguousarray(f4)).to(device))


# ------------------------------------------------------------- host glue
def _upload(a, device):
    """numpy uint8 / uint16 array -> tensor on `device` (uint16 as int16:
    samples < 2^15 keep their values), through a pinned buffer for CUDA."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.to(device, non_blocking=True)


def commit_frame(enc):
    """Run the device residual commit for all eligible inter leaves of
    one InterFrameEncoder frame on `enc.shared["torch_device"]`. Returns
    CommitResult or None (no eligible leaf)."""
    if enc.qindex == 0 or getattr(enc, "inter_dec", None) is None:
        return None
    device = torch.device(enc.shared["torch_device"])
    nplanes = enc.nplanes
    pad = enc.pad
    from svt_av1_psy_tpu.codec.mv_pred import LAST_FRAME

    refs0 = enc.refs.get(LAST_FRAME)
    ref2 = enc.refs.get(enc.ref2) if enc.ref2 is not None else None
    if refs0 is None:
        return None

    # ---- enumerate eligible leaves, grouped by (W, is_comp, vi)
    inter_txt = getattr(enc, "inter_txt", None) or {}
    mi_rows, mi_cols = enc.mi_rows, enc.mi_cols
    sbq = enc.sb_qindex_map if enc.delta_q_present else None
    pre_slot = np.zeros((mi_rows, mi_cols), np.int32)
    groups: dict = {}

    def ref_bounds_ok(planes, plane, y, x, ph_, pw_):
        hp, wp = planes[plane].shape
        return 0 <= y and 0 <= x and y + ph_ + 7 <= hp and x + pw_ + 7 <= wp

    feat = getattr(enc, "feat", None)
    for (r, c), d in enc.inter_dec.items():
        if not d[0]:
            continue
        leaves["inter"] += 1
        geom = enc.leaf_geom.get((r, c))
        if geom is None:
            continue
        W, H = geom
        if W != H or W < 8 or W > 64:
            continue
        if feat is not None and (feat["filt"][r, c] or feat["ii"][r, c]
                                 or feat["mm"][r, c]
                                 or feat["ctype"][r, c]):
            continue
        if (r * 4 + H > enc.planes[0].recon.shape[0]
                or c * 4 + W > enc.planes[0].recon.shape[1]
                or r * 4 + H > enc.src[0].shape[0]
                or c * 4 + W > enc.src[0].shape[1]):
            continue
        md = int(d[2])
        is_comp = md >= 17
        if is_comp:
            if len(d) < 7 or ref2 is None:
                continue
            mvs = (int(d[3]), int(d[4]), int(d[5]), int(d[6]))
            ridx = 0
        else:
            rf = d[1]
            if rf == LAST_FRAME:
                ridx = 0
            elif enc.ref2 is not None and rf == enc.ref2 and ref2 is not None:
                ridx = 1
            else:
                continue
            mvs = (int(d[3]), int(d[4]), 0, 0)
        x0, y0 = c * 4, r * 4
        ok = True
        for pl in range(nplanes):
            ss = 0 if pl == 0 else 1
            pw_, ph_ = max(W >> ss, 4) if ss else W, max(H >> ss, 4) if ss else H
            if ss:
                pw_, ph_ = W >> 1, H >> 1
            for mi_, (mr, mc) in ((0, (mvs[0], mvs[1])),
                                  (1, (mvs[2], mvs[3]))):
                if mi_ == 1 and not is_comp:
                    continue
                ip_y = mr >> (3 + ss)
                ip_x = mc >> (3 + ss)
                py0 = (y0 >> ss) + ip_y + pad - 3
                px0 = (x0 >> ss) + ip_x + pad - 3
                planes = refs0 if (mi_ == 0 and ridx == 0) or is_comp and mi_ == 0 else (
                    ref2 if ref2 is not None else refs0)
                if mi_ == 0 and not is_comp and ridx == 1:
                    planes = ref2
                if not ref_bounds_ok(planes, pl, py0, px0, ph_, pw_):
                    ok = False
                    break
            if not ok:
                break
        if not ok:
            continue
        tt = int(inter_txt.get((r, c), 0))
        tts_y_s, _ = _size_tts(W)
        if tt not in tts_y_s:
            continue
        vi = tts_y_s.index(tt)
        q = int(sbq[r >> 4, c >> 4]) if sbq is not None else enc.qindex
        groups.setdefault((W, is_comp, vi), []).append((r, c, mvs, ridx, q))

    if not groups:
        return None

    from svt_av1_psy_tpu.profiling import stage as _stage

    rdt = np.uint8 if enc.bd == 8 else np.uint16

    def stack_refs(plane):
        a = np.asarray(refs0[plane], rdt)
        b = (np.asarray(ref2[plane], rdt) if ref2 is not None else a)
        return _upload(np.stack([a, b]), device)

    with _stage("device:commit_upload"):
        drefs = [stack_refs(p) for p in range(nplanes)]
        dsrc = [_upload(np.asarray(enc.src[p], rdt), device)
                for p in range(nplanes)]
    f8, f4 = _filter_tables(
        np.ascontiguousarray(enc.me[LAST_FRAME]._filters, np.int32).tobytes(),
        device)

    rdoq = bool(getattr(enc, "rdoq_fast", False) and enc.noise_norm == 0)
    qm_key = (tuple(int(x) for x in enc.qm_levels)
              if enc.qm_levels is not None else None)

    group_keys = tuple(sorted(groups))
    refs_in = drefs + [drefs[0]] * (3 - nplanes)
    srcs_in = dsrc + [dsrc[0]] * (3 - nplanes)

    # per-frame quant tables: one row per distinct qindex (U fixed at 16)
    quniq = sorted({q for items in groups.values()
                    for (_r, _c, _mvs, _ri, q) in items})
    U = 16
    if len(quniq) > U:     # delta-q extremes: host walk handles the tail
        drop = set(quniq[U:])
        for key in list(groups):
            groups[key] = [it for it in groups[key] if it[4] not in drop]
            if not groups[key]:
                del groups[key]
        quniq = quniq[:U]
        group_keys = tuple(sorted(groups))
        if not groups:
            return None
    qmap = {q: i for i, q in enumerate(quniq)}
    qt_y, qt_uv = _leaf_qp_rows(enc, quniq + [quniq[0]] * (U - len(quniq)))

    # every chunk's lane metadata, packed on the host and uploaded once
    plan = []      # (key, part, B, row0)
    rows_total = 0
    for key in group_keys:
        items = groups[key]
        B = _CHUNK_LANES[key[0]]
        for c0 in range(0, len(items), B):
            plan.append((key, items[c0:c0 + B], B, rows_total))
            rows_total += B
    meta_all = np.zeros((rows_total, 8), np.int32)
    for key, part, B, row0 in plan:
        meta_all[row0:row0 + B, 0:2] = 1 << 24     # padding lanes
        for i, (r, c, mvs, ri, q) in enumerate(part):
            meta_all[row0 + i] = (r * 4, c * 4, mvs[0], mvs[1], mvs[2],
                                  mvs[3], ri, qmap[q])

    chunks = []   # (key, items_part, (ky_s, kuv_s), n_fetch_lanes, arrays)
    with _stage("device:commit_dispatch"):
        dqt_y = _upload(qt_y, device)
        dqt_uv = _upload(qt_uv, device)
        dmeta = _upload(meta_all, device)
        for key, part, B, row0 in plan:
            S, is_comp, vi = key
            Ky, Kuv = _lv_caps(S, nplanes)
            ky_s, kuv_s = _K_FETCH[S] if nplanes > 1 else (
                _K_FETCH[S][0], 0)
            fn = _jit_group(S, bool(is_comp), vi, enc.bd, nplanes, rdoq, pad)
            tabs_y, tabs_uv = _vi_tables(S, nplanes, qm_key, vi, device)
            n = len(part)
            lv, meta_out, rec = fn(refs_in, srcs_in, dmeta[row0:row0 + B],
                                   dqt_y, dqt_uv, f8, f4, tabs_y, tabs_uv)
            # pow2 lane ladder
            nf = 64
            while nf < n:
                nf *= 2
            nf = min(B, nf)
            fl = [lv[:nf, :ky_s]]
            if nplanes > 1:
                fl.append(lv[:nf, Ky:Ky + kuv_s])
                fl.append(lv[:nf, Ky + Kuv:Ky + Kuv + kuv_s])
            fl.append(meta_out[:nf])
            fl.append(rec[:nf])
            chunks.append((key, part, (ky_s, kuv_s), nf, fl))
        flat = torch.cat([t.reshape(-1).view(torch.uint8)
                          for ch in chunks for t in ch[4]])
    with _stage("device:commit_wait"):
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
    with _stage("device:commit_fetch"):
        host = flat.cpu().numpy()
    fetched = []
    pos = 0
    for _key, _part, _k, _nf, fl in chunks:
        outs = []
        for t in fl:
            nb = t.numel() * t.element_size()
            dt = {torch.int16: np.int16, torch.int32: np.int32,
                  torch.uint8: np.uint8}[t.dtype]
            a = host[pos:pos + nb].view(dt).reshape(tuple(t.shape))
            if t.dtype == torch.int16 and t is fl[-1]:
                a = a.view(np.uint16)          # 10-bit recon samples
            outs.append(a)
            pos += nb
        fetched.append(outs)

    # ---- host unpack: scan->raster levels for the C walk + recon blocks
    # scattered into fresh frame planes (numpy fancy indexing)
    def _sizes(S):
        ny = min(S, 32) * min(S, 32)
        nuv = (min(S >> 1, 32) * min(S >> 1, 32)) if nplanes > 1 else 0
        return ny, nuv

    total = sum(len(part) * (ny + 2 * nuv)
                for (Sk, _, _), part, _, _, _ in chunks
                for ny, nuv in (_sizes(Sk),))
    n_slots = sum(len(part) for _, part, _, _, _ in chunks)
    pre_qc = np.zeros(total, np.int32)
    pre_off = np.zeros(3 * n_slots, np.int32)
    pre_eob = np.zeros(3 * n_slots, np.int32)
    rec_np = [np.zeros(enc.planes[p].recon.shape,
                       enc.planes[p].recon.dtype) for p in range(nplanes)]

    off = 0
    slot = 0
    for (key, part, (ky_s, kuv_s), nf, _fl), out in zip(chunks, fetched):
        S, is_comp, vi = key
        n = len(part)
        if nplanes > 1:
            lv_y, lv_u, lv_v, m4, recf = out
        else:
            lv_y, m4, recf = out
            lv_u = lv_v = None
        eob3 = np.asarray(m4[:n, :3])
        over = np.asarray(m4[:n, 3]) != 0
        keep = ~over & (eob3[:, 0] <= ky_s)
        if nplanes > 1:
            keep &= (eob3[:, 1] <= kuv_s) & (eob3[:, 2] <= kuv_s)
        ny, nuv = _sizes(S)
        tts_y, tts_uv = _size_tts(S)
        ts_y = _tx_size_of(S, S)
        pr = np.fromiter((it[0] for it in part), np.int64, n)
        pc = np.fromiter((it[1] for it in part), np.int64, n)
        po = 0
        for p in range(nplanes):
            ss = 0 if p == 0 else 1
            hh = ww = S >> ss
            rb = np.asarray(recf[:n, po:po + hh * ww]).reshape(n, hh, ww)
            po += hh * ww
            y0 = (pr * 4) >> ss
            x0 = (pc * 4) >> ss
            yy = np.broadcast_to(
                y0[:, None, None] + np.arange(hh)[None, :, None],
                (n, hh, ww))
            xx = np.broadcast_to(
                x0[:, None, None] + np.arange(ww)[None, None, :],
                (n, hh, ww))
            rec_np[p][yy, xx] = rb
        qcr = np.zeros((n, ny + 2 * nuv), np.int32)
        rows = np.nonzero(keep)[0]
        if rows.size:
            sc = _scan_np(ts_y, tts_y[vi])[:ky_s]
            qcr[rows[:, None], sc[None, :]] = np.asarray(
                lv_y[:n], np.int32)[rows]
            if nplanes > 1:
                lvu = np.asarray(lv_u[:n], np.int32)
                lvv = np.asarray(lv_v[:n], np.int32)
                _, _, ts_uv = _chroma_geom(S, S)
                if tts_uv[vi] == tts_uv[0]:
                    segs = ((rows, tts_uv[0]),)
                else:
                    segs = ((rows[eob3[rows, 0] == 0], tts_uv[0]),
                            (rows[eob3[rows, 0] > 0], tts_uv[vi]))
                for rsel, ctt in segs:
                    if rsel.size:
                        scc = _scan_np(ts_uv, ctt)[:kuv_s]
                        qcr[rsel[:, None], ny + scc[None, :]] = lvu[rsel]
                        qcr[rsel[:, None], ny + nuv + scc[None, :]] = (
                            lvv[rsel])
        for i, (r, c, mvs, ri, q) in enumerate(part):
            if not keep[i]:
                slot += 1
                off += ny + 2 * nuv
                continue
            pre_slot[r, c] = slot + 1
            pre_off[slot * 3] = off
            pre_eob[slot * 3] = eob3[i, 0]
            pre_qc[off:off + ny] = qcr[i, :ny]
            if nplanes > 1:
                pre_off[slot * 3 + 1] = off + ny
                pre_eob[slot * 3 + 1] = eob3[i, 1]
                pre_off[slot * 3 + 2] = off + ny + nuv
                pre_eob[slot * 3 + 2] = eob3[i, 2]
                pre_qc[off + ny:off + ny + 2 * nuv] = qcr[i, ny:]
            off += ny + 2 * nuv
            slot += 1

    leaves["lanes"] += n_slots
    leaves["kept"] += int(np.count_nonzero(pre_slot))
    return CommitResult(pre_slot, pre_off, pre_eob, pre_qc, rec_np)
