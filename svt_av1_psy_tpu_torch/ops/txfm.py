"""Kernel K5: the AV1 forward and inverse 2-D transforms (`csrc/txfm.cu`).

Replaces `svt_av1_psy_tpu/ops/txfm.py`: `forward_transform_2d` (:110) and
`inverse_transform_add` (:148). The 1-D transforms are the butterfly graphs
of `codec/transforms.compiled_stages` (the numpy golden model's tables),
adst4's closed form and the identity scalings; the 2-D functions add the flips,
the stage shifts, the rect sqrt(2) scaling, the 64-point zeroing and the
clamps. Everything is int32, wrapping as the JAX program's int32 does (the
AV1 stage shifts keep valid inputs in range; the inverse path holds for
bd <= 10).

The kernel interprets the same stage tables: each (graph, cos_bit) is
uploaded once per device as an int32 (stages, 5, n) tensor [A, B, wa, wb,
kind]. One CUDA block per lane keeps the lane's H x W block in shared memory
and evaluates each stage for all of its vectors in parallel.
Bound on the H100: launch latency and the per-stage block barriers at the
commit's lane counts (a few hundred lanes of <= 64x64); the arithmetic is a
few thousand int32 multiply-adds per lane.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from svt_av1_psy_tpu.codec import transforms as T
from svt_av1_psy_tpu.codec.constants import (TX_HEIGHT, TX_TYPE_1D, TX_WIDTH,
                                             TxType, TxType1D)

from . import _build

_I32 = torch.int32

calls = {"kernel": 0, "plain": 0}


# ------------------------------------------------------------ plain version
def _round_shift(x, bit: int):
    if bit == 0:
        return x
    if bit > 0:
        return (x + (1 << (bit - 1))) >> bit
    return x << (-bit)


def _clamp(x, bit):
    if bit is None:
        return x
    return x.clamp(-(1 << (bit - 1)), (1 << (bit - 1)) - 1)


@functools.lru_cache(maxsize=None)
def _stages_torch(name: str, cos_bit: int, device):
    """compiled_stages as int32 / bool tensors on `device`."""
    out = []
    for A, B, wa, wb, is_btf, is_clamp in T.compiled_stages(name, cos_bit):
        out.append(tuple(torch.from_numpy(np.asarray(a, np.int32)).to(device)
                         for a in (A, B, wa, wb))
                   + tuple(torch.from_numpy(np.asarray(m, bool)).to(device)
                           for m in (is_btf, is_clamp)))
    return out


def _eval_graph(name: str, x, cos_bit: int, clamp_bit):
    """x: (batch, n) int32 -> (batch, n) int32, one gather + select per
    stage (`_eval_graph_jnp`)."""
    cur = x
    for A, B, wa, wb, is_btf, is_clamp in _stages_torch(name, cos_bit,
                                                         x.device):
        acc = wa[None, :] * cur[:, A] + wb[None, :] * cur[:, B]
        shifted = _round_shift(acc, cos_bit)
        clamped = _clamp(acc, clamp_bit) if clamp_bit is not None else acc
        cur = torch.where(is_btf[None, :], shifted,
                          torch.where(is_clamp[None, :], clamped, acc))
    return cur


def _adst4(x, cos_bit: int, inverse: bool):
    sinpi = np.asarray(T.sinpi_arr(cos_bit), np.int32)
    s1_, s2_, s3_, s4_ = (int(sinpi[i]) for i in range(1, 5))
    x0, x1, x2, x3 = (x[:, i] for i in range(4))
    if inverse:
        s0 = s1_ * x0 + s4_ * x2 + s2_ * x3
        s1 = s2_ * x0 - s1_ * x2 - s4_ * x3
        s3 = s3_ * x1
        s2 = s3_ * ((x0 - x2) + x3)
        o0 = s0 + s3
        o1 = s1 + s3
        o2 = s2
        o3 = (s0 + s1) - s3
    else:
        s7 = (x0 + x1) - x3
        a0 = s1_ * x0 + s2_ * x1 + s4_ * x3
        a1 = s3_ * s7
        a2 = s4_ * x0 - s1_ * x1 + s2_ * x3
        a3 = s3_ * x2
        o0 = a0 + a3
        o1 = a1
        o2 = a2 - a3
        o3 = (a2 - a0) + a3
    return _round_shift(torch.stack([o0, o1, o2, o3], dim=1), cos_bit)


def _identity(x, n: int):
    if n == 4:
        return _round_shift(x * T.NEW_SQRT2, T.NEW_SQRT2_BITS)
    if n == 8:
        return x * 2
    if n == 16:
        return _round_shift(x * 2 * T.NEW_SQRT2, T.NEW_SQRT2_BITS)
    if n == 32:
        return x * 4
    return _round_shift(x * 4 * T.NEW_SQRT2, T.NEW_SQRT2_BITS)


def _txfm_1d(x, kind, n, cos_bit, inverse, clamp_bit):
    if kind == TxType1D.IDTX:
        return _identity(x, n)
    if kind in (TxType1D.ADST, TxType1D.FLIPADST):
        if n == 4:
            return _adst4(x, cos_bit, inverse)
        name = f"{'i' if inverse else 'f'}adst{n}"
    else:
        name = f"{'i' if inverse else 'f'}dct{n}"
    return _eval_graph(name, x, cos_bit, clamp_bit)


def _inv_ranges(bd: int):
    if bd == 8:
        return 16, 16
    if bd == 10:
        return 18, 16
    return 20, 18


def forward_transform_2d_ref(residual, tx_size: int, tx_type: int):
    """Plain version: residual (B, H, W) int32 -> coeffs (B, H, W) int32."""
    B, H, W = residual.shape
    w_idx = int(np.log2(W)) - 2
    h_idx = int(np.log2(H)) - 2
    shift = T.FWD_SHIFT[tx_size]
    cos_bit_col = T.FWD_COS_BIT_COL[w_idx][h_idx]
    cos_bit_row = T.FWD_COS_BIT_ROW[w_idx][h_idx]
    vtype, htype = TX_TYPE_1D[TxType(tx_type)]
    ud_flip, lr_flip = T._flips(tx_type)

    x = residual.to(_I32)
    if ud_flip:
        x = x.flip(1)
    x = _round_shift(x, -int(shift[0]))
    xc = x.transpose(1, 2).reshape(B * W, H)
    xc = _txfm_1d(xc, vtype, H, cos_bit_col, False, None)
    xc = _round_shift(xc, -int(shift[1]))
    buf = xc.reshape(B, W, H).transpose(1, 2)
    if lr_flip:
        buf = buf.flip(2)
    xr = buf.reshape(B * H, W)
    xr = _txfm_1d(xr, htype, W, cos_bit_row, False, None)
    xr = _round_shift(xr, -int(shift[2]))
    out = xr.reshape(B, H, W)
    if abs(T._rect_log_ratio(W, H)) == 1:
        out = _round_shift(out * T.NEW_SQRT2, T.NEW_SQRT2_BITS)
    if W == 64:
        out = out.clone()
        out[:, :, 32:] = 0
    if H == 64:
        out = out.clone()
        out[:, 32:, :] = 0
    return out.to(_I32).contiguous()


def inverse_transform_add_ref(coeffs, pred, tx_size: int, tx_type: int,
                              bd: int = 8):
    """Plain version: coeffs (B, H, W) int32 + pred -> recon (B, H, W)
    int32."""
    B, H, W = coeffs.shape
    shift = T.INV_SHIFT[tx_size]
    vtype, htype = TX_TYPE_1D[TxType(tx_type)]
    ud_flip, lr_flip = T._flips(tx_type)
    range_row, range_col = _inv_ranges(bd)
    assert bd <= 10, "the int32 inverse path holds for bd <= 10"
    x = coeffs.to(_I32).clone()
    if W == 64:
        x[:, :, 32:] = 0
    if H == 64:
        x[:, 32:, :] = 0
    if abs(T._rect_log_ratio(W, H)) == 1:
        x = _round_shift(x * T.NEW_INV_SQRT2, T.NEW_SQRT2_BITS)
    x = _clamp(x, bd + 8)
    xr = x.reshape(B * H, W)
    xr = _txfm_1d(xr, htype, W, T.INV_COS_BIT, True, range_row)
    xr = _round_shift(xr, -int(shift[0]))
    buf = xr.reshape(B, H, W)
    if lr_flip:
        buf = buf.flip(2)
    buf = _clamp(buf, max(bd + 6, 16))
    xc = buf.transpose(1, 2).reshape(B * W, H)
    xc = _txfm_1d(xc, vtype, H, T.INV_COS_BIT, True, range_col)
    xc = _round_shift(xc, -int(shift[1]))
    out = xc.reshape(B, W, H).transpose(1, 2)
    if ud_flip:
        out = out.flip(1)
    recon = pred.to(_I32) + out
    return recon.clamp(0, (1 << bd) - 1).to(_I32).contiguous()


# ------------------------------------------------------------ the kernel
# 1-D spec (6 int64): [graph pointer, kind (0 graph, 1 adst4, 2 identity),
# n, cos_bit, stages, clamp bit (0: none)]; 2-D spec (23 int64): column
# spec, row spec, H, W, ud_flip, lr_flip, rect, shift0, shift1, shift2,
# clamp_in, clamp_mid, bd (the layout `tx2d_from` of txfm.cuh reads).
SPEC_LEN = 23

_GRAPHS: dict = {}


def _graph(name: str, cos_bit: int, device):
    """The stage table of one graph on `device`, uploaded once."""
    key = (name, cos_bit, device)
    g = _GRAPHS.get(key)
    if g is None:
        st = T.compiled_stages(name, cos_bit)
        arr = np.stack([np.stack([np.asarray(A, np.int32), np.asarray(B, np.int32),
                                  np.asarray(wa, np.int32), np.asarray(wb, np.int32),
                                  (np.asarray(is_btf, np.int32) * 2
                                   + np.asarray(is_clamp, np.int32))])
                        for A, B, wa, wb, is_btf, is_clamp in st])
        g = _GRAPHS[key] = (torch.from_numpy(np.ascontiguousarray(arr))
                            .to(device), len(st))
    return g


def _spec1d(kind1d, n: int, cos_bit: int, inverse: bool, clamp, device):
    if kind1d == TxType1D.IDTX:
        return [0, 2, n, cos_bit, 0, 0]
    is_adst = kind1d in (TxType1D.ADST, TxType1D.FLIPADST)
    if is_adst and n == 4:
        return [0, 1, n, cos_bit, 0, 0]
    name = f"{'i' if inverse else 'f'}{'adst' if is_adst else 'dct'}{n}"
    g, nst = _graph(name, cos_bit, device)
    return [g.data_ptr(), 0, n, cos_bit, nst, clamp or 0]


@functools.lru_cache(maxsize=None)
def tx_spec(tx_size: int, tx_type: int, inverse: bool, bd: int, device):
    """The 2-D spec of one (tx_size, tx_type) as a host int64 array; its
    graph pointers stay valid while the process lives (`_GRAPHS`)."""
    W, H = int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])
    vtype, htype = TX_TYPE_1D[TxType(tx_type)]
    ud, lr = T._flips(tx_type)
    rect = int(abs(T._rect_log_ratio(W, H)) == 1)
    if inverse:
        rr, rc = _inv_ranges(bd)
        s = T.INV_SHIFT[tx_size]
        col = _spec1d(vtype, H, T.INV_COS_BIT, True, rc, device)
        row = _spec1d(htype, W, T.INV_COS_BIT, True, rr, device)
        shifts = [int(s[0]), int(s[1]), 0]
    else:
        w_idx, h_idx = int(np.log2(W)) - 2, int(np.log2(H)) - 2
        s = T.FWD_SHIFT[tx_size]
        col = _spec1d(vtype, H, T.FWD_COS_BIT_COL[w_idx][h_idx], False, None,
                      device)
        row = _spec1d(htype, W, T.FWD_COS_BIT_ROW[w_idx][h_idx], False, None,
                      device)
        shifts = [int(s[0]), int(s[1]), int(s[2])]
    vals = (col + row + [H, W, int(ud), int(lr), rect] + shifts
            + [bd + 8, max(bd + 6, 16), bd])
    assert len(vals) == SPEC_LEN
    return np.array(vals, np.int64)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("txfm")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.txfm_fwd_launch.argtypes = [P, P, P, I, P, P, L, L, I, I, P]
    lib.txfm_inv_add_launch.argtypes = [P, P, P, I, P, P, P, I, L, L, I, I, P]
    lib.txfm_fwd_launch.restype = ctypes.c_int
    lib.txfm_inv_add_launch.restype = ctypes.c_int
    return lib


_OUT_KIND = {torch.int32: 0, torch.uint8: 1, torch.int16: 2}


def _host_ptr(a):
    return ctypes.c_void_p(a.ctypes.data) if a is not None else None


def _sel_args(sel):
    if sel is None:
        return None, 0
    t, stride = sel
    return _build.ptr(t), stride


def fwd_launch(spec0, spec1, sel, x, out, B: int, stride: int,
               nplanes: int = 1, plane_stride: int = 0):
    """Launch K5 forward over B lanes x nplanes planes: plane q of lane b
    reads its (H, W) int32 residual at x + b * stride + q * plane_stride and
    writes its coeffs at the same offset of `out`. `sel` = (int32 tensor,
    stride) or None: lanes whose selector is nonzero take spec1. The only
    place K5 forward launches."""
    sp, ss = _sel_args(sel)
    rc = _lib().txfm_fwd_launch(_host_ptr(spec0), _host_ptr(spec1), sp, ss,
                                _build.ptr(x), _build.ptr(out), stride,
                                plane_stride, B, nplanes,
                                _build.stream(x.device))
    _build.check(rc, "txfm_fwd_launch")
    _build.count(calls, "kernel")


def inv_launch(spec0, spec1, sel, c, pred, out, B: int, stride: int,
               nplanes: int = 1, plane_stride: int = 0):
    """Launch K5 inverse + add + clip over B lanes x nplanes planes: int32
    coeffs and pred, and `out` (int32, uint8, or int16 holding uint16
    samples), all at the offsets of `fwd_launch`. The only place K5
    inverse launches."""
    sp, ss = _sel_args(sel)
    rc = _lib().txfm_inv_add_launch(
        _host_ptr(spec0), _host_ptr(spec1), sp, ss, _build.ptr(c),
        _build.ptr(pred), _build.ptr(out), _OUT_KIND[out.dtype], stride,
        plane_stride, B, nplanes, _build.stream(c.device))
    _build.check(rc, "txfm_inv_add_launch")
    _build.count(calls, "kernel")


def _check_device(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K5 takes cpu or cuda tensors, not {t.device}")
    return t.device.type == "cuda"


def _need(t, shape, dev):
    if (tuple(t.shape) != tuple(shape) or t.dtype != _I32 or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"K5 argument {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}: want {tuple(shape)} int32 on {dev}")


def forward_transform_2d(residual, tx_size: int, tx_type: int):
    """K5 forward: the kernel for CUDA tensors, the plain version for CPU
    tensors. residual (B, H, W) int32 -> coeffs (B, H, W) int32."""
    if not _check_device(residual):
        _build.count(calls, "plain")
        return forward_transform_2d_ref(residual, tx_size, tx_type)
    B, H, W = residual.shape
    if (W, H) != (int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])):
        raise ValueError(f"K5: block {W}x{H} is not tx_size {tx_size}")
    _need(residual, (B, H, W), residual.device)
    out = torch.empty_like(residual)
    spec = tx_spec(int(tx_size), int(tx_type), False, 8, residual.device)
    fwd_launch(spec, None, None, residual, out, B, H * W)
    return out


def inverse_transform_add(coeffs, pred, tx_size: int, tx_type: int,
                          bd: int = 8):
    """K5 inverse + add + clip: coeffs (B, H, W) int32 + pred (B, H, W)
    int32 -> recon (B, H, W) int32."""
    if not _check_device(coeffs):
        _build.count(calls, "plain")
        return inverse_transform_add_ref(coeffs, pred, tx_size, tx_type, bd)
    B, H, W = coeffs.shape
    if (W, H) != (int(TX_WIDTH[tx_size]), int(TX_HEIGHT[tx_size])):
        raise ValueError(f"K5: block {W}x{H} is not tx_size {tx_size}")
    if bd > 10:
        raise ValueError("K5: the int32 inverse path holds for bd <= 10")
    _need(coeffs, (B, H, W), coeffs.device)
    _need(pred, (B, H, W), coeffs.device)
    out = torch.empty_like(coeffs)
    spec = tx_spec(int(tx_size), int(tx_type), True, int(bd), coeffs.device)
    inv_launch(spec, None, None, coeffs, pred, out, B, H * W)
    return out
