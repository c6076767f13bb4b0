"""Kernel K1: one depth's full-frame intra mode + tx-type search.

Replaces `svt_av1_psy_tpu/ops/intra_search.py:search_block_batch` (and the
`search_multi_depth_flat` driver around it) with `csrc/intra_search.cu`.

What it computes, per SxS block: the 12 linear intra predictions as the
product refs(1+4S) x G(1+4S, 12 S^2) with floor(+0.5), plus Paeth; the
orthonormal DCT of each residual; dead-zone quantisation; the coefficient
rate from the bit tables; the argmin over 13 modes (ties to the lowest
index, as `jnp.argmin`); then, when n_tx > 1, the same RD over the tx-type
bases of the winning mode.

Numbers: the prediction product is exact in float32 (power-of-two weights,
integer samples). The transforms and every sum run in float64 and round to
float32 once, in the kernel and in the plain version alike, so the two make
the same decisions; against the JAX program (float32 sums) they agree up to
its summation order.

On the H100 the kernel is bound by reading the dense bank G from L2: one
CUDA block per image block reads all of G (6.3 MB at S=32). The design keeps
the residual, both transform passes and the levels in shared memory, so no
intermediate touches device memory; sharing G across blocks (or using its
sparsity) is later work.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from svt_av1_psy_tpu.codec import transforms as T
from svt_av1_psy_tpu.codec.constants import (PredictionMode, TxType,
                                             TxType1D, TX_TYPE_1D)
from svt_av1_psy_tpu.codec.intra import _SM_WEIGHTS
from svt_av1_psy_tpu.codec.intra_dir import MODE_TO_ANGLE, get_dx, get_dy

from . import _build

# ---------------------------------------------------------------- tables
# (numpy copies of the reference's builders: the originals live in a module
# that imports jax)
LINEAR_MODES = (
    PredictionMode.DC_PRED, PredictionMode.V_PRED, PredictionMode.H_PRED,
    PredictionMode.D45_PRED, PredictionMode.D135_PRED, PredictionMode.D113_PRED,
    PredictionMode.D157_PRED, PredictionMode.D203_PRED, PredictionMode.D67_PRED,
    PredictionMode.SMOOTH_PRED, PredictionMode.SMOOTH_V_PRED,
    PredictionMode.SMOOTH_H_PRED,
)
ALL_MODES = LINEAR_MODES + (PredictionMode.PAETH_PRED,)
N_MODES = len(ALL_MODES)

# intra ext-tx search sets; the 1-D types of eset 1 are not searched, as in
# the reference
EXT_TX_SET_1 = (TxType.DCT_DCT, TxType.ADST_DCT, TxType.DCT_ADST,
                TxType.ADST_ADST, TxType.IDTX)
EXT_TX_SET_2 = (TxType.DCT_DCT, TxType.ADST_DCT, TxType.DCT_ADST,
                TxType.ADST_ADST, TxType.IDTX)

_SM_W = {k: v.astype(np.float64) for k, v in _SM_WEIGHTS.items()}


def _ref_len(S: int) -> int:
    return 1 + 4 * S          # [corner, above(2S), left(2S)]


@functools.lru_cache(maxsize=16)
def mode_matrix_bank(S: int) -> np.ndarray:
    """(L, 12 * S * S) f32: every linear intra predictor as one matrix."""
    L = _ref_len(S)
    A0 = 1
    L0 = 1 + 2 * S
    mats = []
    for mode in LINEAR_MODES:
        G = np.zeros((L, S, S), np.float64)
        if mode == PredictionMode.DC_PRED:
            G[A0:A0 + S] = 1.0 / (2 * S)
            G[L0:L0 + S] = 1.0 / (2 * S)
        elif mode == PredictionMode.V_PRED:
            for c in range(S):
                G[A0 + c, :, c] = 1.0
        elif mode == PredictionMode.H_PRED:
            for r in range(S):
                G[L0 + r, r, :] = 1.0
        elif mode == PredictionMode.SMOOTH_PRED:
            ww = _SM_W[S]
            for r in range(S):
                for c in range(S):
                    G[A0 + c, r, c] += ww[r] / 512.0
                    G[L0 + S - 1, r, c] += (256.0 - ww[r]) / 512.0
                    G[L0 + r, r, c] += ww[c] / 512.0
                    G[A0 + S - 1, r, c] += (256.0 - ww[c]) / 512.0
        elif mode == PredictionMode.SMOOTH_V_PRED:
            ww = _SM_W[S]
            for r in range(S):
                G[A0:A0 + S, r, :] += np.eye(S) * (ww[r] / 256.0)
                G[L0 + S - 1, r, :] += (256.0 - ww[r]) / 256.0
        elif mode == PredictionMode.SMOOTH_H_PRED:
            ww = _SM_W[S]
            for c in range(S):
                G[L0:L0 + S, :, c] += np.eye(S) * (ww[c] / 256.0)
                G[A0 + S - 1, :, c] += (256.0 - ww[c]) / 256.0
        else:
            _fill_directional(G, int(MODE_TO_ANGLE[mode]), S, A0, L0)
        mats.append(G.reshape(L, S * S))
    return np.stack(mats, axis=1).reshape(L, -1).astype(np.float32)


def _fill_directional(G, angle: int, S: int, A0: int, L0: int):
    """Weights for dr_pred z1/z2/z3 -- static per (r, c)."""
    dx, dy = get_dx(angle), get_dy(angle)
    mb = 2 * S - 1
    if angle < 90:
        for r in range(S):
            for c in range(S):
                x = (r + 1) * dx
                base = (x >> 6) + c
                shift = (x & 0x3F) >> 1
                if base >= mb:
                    G[A0 + mb, r, c] = 1.0
                else:
                    G[A0 + base, r, c] += (32 - shift) / 32.0
                    G[A0 + min(base + 1, mb), r, c] += shift / 32.0
    elif angle > 180:
        for r in range(S):
            for c in range(S):
                y = (c + 1) * dy
                base = (y >> 6) + r
                shift = (y & 0x3F) >> 1
                if base >= mb:
                    G[L0 + mb, r, c] = 1.0
                else:
                    G[L0 + base, r, c] += (32 - shift) / 32.0
                    G[L0 + min(base + 1, mb), r, c] += shift / 32.0
    else:
        la = 1 + 2 * S

        def l_idx(j):
            return 0 if j == 0 else 2 * S + j

        for r in range(S):
            for c in range(S):
                x = -(r + 1) * dx + (c << 6)
                base1 = x >> 6
                if base1 >= -1:
                    shift1 = (x & 0x3F) >> 1
                    i1 = int(np.clip(base1 + 1, 0, la - 2))
                    G[i1, r, c] += (32 - shift1) / 32.0
                    G[i1 + 1, r, c] += shift1 / 32.0
                else:
                    y = (r << 6) - (c + 1) * dy
                    base2 = y >> 6
                    shift2 = (y & 0x3F) >> 1
                    i2 = int(np.clip(base2 + 1, 0, la - 2))
                    G[l_idx(i2), r, c] += (32 - shift2) / 32.0
                    G[l_idx(i2 + 1), r, c] += shift2 / 32.0


@functools.lru_cache(maxsize=64)
def orth_1d(kind: int, n: int, inverse: bool = False) -> np.ndarray:
    """Orthonormalized AV1 1-D transform basis (n, n) f32, probed from the
    bit-exact integer kernels."""
    kind = TxType1D(kind)
    if kind == TxType1D.IDTX:
        return np.eye(n, dtype=np.float32)
    scale = 1 << 14
    x = (np.eye(n) * scale).astype(np.int64)
    cos_bit = 12 if n >= 8 else 13
    y = T._txfm_1d(x, kind, n, cos_bit, False, None).astype(np.float64)
    M = y.T / scale
    norms = np.linalg.norm(M, axis=1, keepdims=True)
    return (M / norms).astype(np.float32)


@functools.lru_cache(maxsize=64)
def coeff_gain(S: int) -> float:
    """Scalar k with c_av1 = k * c_orth for an SxS AV1 forward transform
    (quantizer tx_scale folded in)."""
    from svt_av1_psy_tpu.codec.quant import TX_SCALE
    from svt_av1_psy_tpu.codec.transforms import forward_transform_2d

    tx_size = {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}[S]
    rng = np.random.default_rng(7)
    r = rng.integers(-255, 256, (4, S, S)).astype(np.int32)
    c_av1 = forward_transform_2d(r, tx_size, 0).astype(np.float64)
    d = orth_1d(int(TxType1D.DCT), S)
    c_orth = np.einsum("ab,nbc,dc->nad", d, r.astype(np.float64), d)
    keep = min(S, 32)
    num = (c_av1[:, :keep, :keep] * c_orth[:, :keep, :keep]).sum()
    den = (c_orth[:, :keep, :keep] ** 2).sum()
    k = num / den
    return float(k * (1 << int(TX_SCALE[tx_size])))


def tx_pair(tx_type: TxType, S: int):
    """(Tv, Th) orthonormal matrices for a 2-D tx type (flip folded in)."""
    vk, hk = TX_TYPE_1D[TxType(tx_type)]

    def mat(kind):
        if kind == TxType1D.FLIPADST:
            return orth_1d(int(TxType1D.ADST), S)[:, ::-1].copy()
        return orth_1d(int(kind), S)

    return mat(vk), mat(hk)


_TABLE_DTYPES = {"G": torch.float32, "scan2d": torch.int32,
                 "scans_tx": torch.int32, "tvs": torch.float32,
                 "ths": torch.float32, "level_bits": torch.float32,
                 "eob_bits": torch.float32, "txb_skip": torch.float32,
                 "y_mode_bits": torch.float32, "ext_tx_bits": torch.float32,
                 "qm_w": torch.float32, "dist_w": torch.float32}


def tables_to_torch(tb: dict, device) -> dict:
    """The reference's per-depth numpy search tables (intra_rdo._build_tables)
    as the port's tensors on `device`; scalars and tx_set pass through."""
    out = {}
    for k, v in tb.items():
        dt = _TABLE_DTYPES.get(k)
        if dt is None:
            out[k] = v
        else:
            out[k] = torch.as_tensor(np.ascontiguousarray(v)).to(
                device=device, dtype=dt).contiguous()
    out["tx_lam_scale"] = float(np.float32(tb["tx_lam_scale"]))
    return out


# ------------------------------------------------------------ plain version
calls = {"kernel": 0, "plain": 0}

_F32 = torch.float32
_F64 = torch.float64


def _txb_rd(cf, qs, scan, level_bits, eob_bits, txb_skip):
    """cf (..., nk) f32 raster coefficients, qs (..., nk) f32 steps, scan
    (..., nk) raster positions in scan order -> (dist f32, rate f32), with
    every sum in float64 rounded once."""
    acf = cf.abs()
    lvl = torch.clamp(torch.floor(acf / qs + 0.375), 0.0, 63.0)
    err = acf - lvl * qs
    dist = (err * err).to(_F64).sum(-1).to(_F32)
    lvl_scan = torch.gather(lvl, -1, scan.expand(lvl.shape).long())
    nk = cf.shape[-1]
    idx = torch.arange(1, nk + 1, device=cf.device)
    eob = torch.where(lvl_scan > 0, idx, torch.zeros_like(idx)).amax(-1)
    include = idx - 1 < eob[..., None]
    lb = level_bits[lvl_scan.long()].to(_F64)
    rate = torch.where(include, lb, torch.zeros_like(lb)).sum(-1).to(_F32)
    rate = rate + eob_bits[eob]
    rate = torch.where(eob > 0, rate + txb_skip[0], txb_skip[1].expand_as(rate))
    return dist, rate


def _qsteps(qdc, qac, qm_w, shape):
    qs = qac.reshape(-1, *([1] * (len(shape) - 1))) * qm_w
    qs = qs.expand(shape).clone()
    qs[..., 0] = (qdc * qm_w[0]).reshape(-1, *([1] * (len(shape) - 2)))
    return qs


def _transform(resid, tv, th, keep):
    """tv @ r @ th^T in float64 -> (kept coefficients f32 (..., keep*keep),
    lost energy f32 (...,))."""
    c = torch.matmul(torch.matmul(tv.to(_F64), resid.to(_F64)),
                     th.to(_F64).transpose(-1, -2)).to(_F32)
    kept = c[..., :keep, :keep]
    outside = (c * c).to(_F64)
    outside[..., :keep, :keep] = 0.0
    lost = outside.sum((-1, -2)).to(_F32)
    return kept.reshape(*kept.shape[:-2], keep * keep), lost


def _predictions(refs, G, S):
    N = refs.shape[0]
    lin = torch.floor(torch.matmul(refs.to(_F64), G.to(_F64)) + 0.5).to(_F32)
    lin = lin.reshape(N, N_MODES - 1, S, S)
    t = refs[:, None, 1:1 + S]
    l = refs[:, 1 + 2 * S:1 + 3 * S, None]
    tl = refs[:, 0, None, None]
    base = t + l - tl
    p_l, p_t, p_tl = (base - l).abs(), (base - t).abs(), (base - tl).abs()
    paeth = torch.where((p_l <= p_t) & (p_l <= p_tl), l.expand_as(base),
                        torch.where(p_t <= p_tl, t.expand_as(base),
                                    tl.expand_as(base)))
    return torch.cat([lin, paeth[:, None]], 1)


def mode_costs_ref(src, refs, qstep_dc, qstep_ac, lam, G, scan2d, tvs,
                   level_bits, eob_bits, txb_skip, y_mode_bits, qm_w, dist_w,
                   S: int):
    """Stage 1 of the plain version: the (N, 13) RD cost of every mode and
    the (N, 13, S, S) residuals."""
    keep = min(S, 32)
    lam = torch.tensor(lam, dtype=_F32, device=src.device)
    resid = src[:, None] - _predictions(refs, G, S)
    cf, lost = _transform(resid, tvs[0], tvs[0], keep)
    qs = _qsteps(qstep_dc, qstep_ac, qm_w, (src.shape[0], N_MODES, keep * keep))
    dist, rate = _txb_rd(cf, qs, scan2d, level_bits, eob_bits, txb_skip)
    return (dist + lost) * dist_w + lam * (rate + y_mode_bits), resid


def search_block_batch_ref(src, refs, qstep_dc, qstep_ac, lam, G, scan2d,
                           scans_tx, tvs, ths, level_bits, eob_bits,
                           txb_skip, y_mode_bits, ext_tx_bits, qm_w, dist_w,
                           tx_lam_scale, S: int, n_tx: int):
    """Plain PyTorch version of K1 (same signature as the JAX program).
    Returns (best_mode i32, best_tx i32, best_cost f32, mode_cost0 f32)."""
    keep = min(S, 32)
    nk = keep * keep
    cost, resid = mode_costs_ref(src, refs, qstep_dc, qstep_ac, lam, G,
                                 scan2d, tvs, level_bits, eob_bits, txb_skip,
                                 y_mode_bits, qm_w, dist_w, S)
    lam = torch.tensor(lam, dtype=_F32, device=src.device)
    best_mode = torch.argmin(cost, 1)
    mode_cost0 = cost.amin(1)
    if n_tx <= 1:
        return (best_mode.int(), torch.zeros_like(best_mode, dtype=torch.int32),
                mode_cost0, mode_cost0)
    br = resid[torch.arange(src.shape[0], device=src.device), best_mode]
    cft, lost_t = _transform(br[:, None], tvs, ths, keep)
    qst = _qsteps(qstep_dc, qstep_ac, qm_w, (src.shape[0], n_tx, nk))
    dist_t, rate_t = _txb_rd(cft, qst, scans_tx, level_bits, eob_bits,
                             txb_skip)
    tls = torch.tensor(tx_lam_scale, dtype=_F32, device=src.device)
    cost_t = (dist_t + lost_t) + lam * tls * (rate_t + ext_tx_bits)
    best_tx = torch.argmin(cost_t, 1)
    best_cost = cost_t.amin(1) + lam * y_mode_bits[best_mode]
    return best_mode.int(), best_tx.int(), best_cost, mode_cost0


# ------------------------------------------------------------ the kernel
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 12 \
    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("intra_search")
    lib.intra_search_launch.argtypes = _ARGTYPES
    lib.intra_search_launch.restype = ctypes.c_int
    return lib


def search_block_batch(src, refs, qstep_dc, qstep_ac, lam, G, scan2d,
                       scans_tx, tvs, ths, level_bits, eob_bits, txb_skip,
                       y_mode_bits, ext_tx_bits, qm_w, dist_w, tx_lam_scale,
                       S: int, n_tx: int):
    """K1: the kernel for CUDA tensors, the plain version for CPU tensors."""
    if src.device.type == "cpu":
        _build.count(calls, "plain")
        return search_block_batch_ref(
            src, refs, qstep_dc, qstep_ac, lam, G, scan2d, scans_tx, tvs,
            ths, level_bits, eob_bits, txb_skip, y_mode_bits, ext_tx_bits,
            qm_w, dist_w, tx_lam_scale, S=S, n_tx=n_tx)
    if src.device.type != "cuda":
        raise ValueError(f"K1 takes cpu or cuda tensors, not {src.device}")
    if S not in (8, 16, 32, 64) or n_tx < 1 or n_tx > 16:
        raise ValueError(f"K1 takes S in 8/16/32/64 and 1<=n_tx<=16 "
                         f"(got S={S}, n_tx={n_tx})")
    keep = min(S, 32)
    N = src.shape[0]
    L = _ref_len(S)
    args = (src, refs, qstep_dc, qstep_ac, G, scan2d, scans_tx, tvs, ths,
            level_bits, eob_bits, txb_skip, y_mode_bits, ext_tx_bits, qm_w,
            dist_w)
    shapes = ((N, S, S), (N, L), (N,), (N,), (L, (N_MODES - 1) * S * S),
              (keep * keep,), (n_tx, keep * keep), (n_tx, S, S),
              (n_tx, S, S), (64,), (eob_bits.shape[0],), (2,), (N_MODES,),
              (n_tx,), (keep * keep,), (N_MODES,))
    for a, shp in zip(args, shapes):
        want = torch.int32 if a is scan2d or a is scans_tx else _F32
        if (a.device != src.device or a.dtype != want
                or tuple(a.shape) != shp or not a.is_contiguous()):
            raise ValueError(f"K1 argument of shape {tuple(a.shape)} "
                             f"{a.dtype} on {a.device}: want {shp} {want}")
    best_mode = torch.empty(N, dtype=torch.int32, device=src.device)
    best_tx = torch.empty_like(best_mode)
    best_cost = torch.empty(N, dtype=_F32, device=src.device)
    mode_cost0 = torch.empty_like(best_cost)
    if N:
        rc = _lib().intra_search_launch(
            *[_build.ptr(a) for a in args[:4]], float(np.float32(lam)),
            *[_build.ptr(a) for a in args[4:]], float(np.float32(tx_lam_scale)),
            N, S, n_tx, _build.ptr(best_mode), _build.ptr(best_tx),
            _build.ptr(best_cost), _build.ptr(mode_cost0),
            _build.stream(src.device))
        _build.check(rc, "intra_search_launch")
        _build.count(calls, "kernel")
    return best_mode, best_tx, best_cost, mode_cost0


# ------------------------------------------------------------ packing
def search_multi_depth_flat(flat, lam, tables, cfgs):
    """All depths of one frame from ONE flat f32 tensor ([blocks, refs, qdc,
    qac] per depth) into ONE packed f32 tensor ([modes, tx, cost] per
    depth). tables: per-depth tables_to_torch dicts; cfgs: ((S, n_tx, Npad,
    L), ...)."""
    parts = []
    off = 0
    for dtb, (S, n_tx, N, L) in zip(tables, cfgs):
        blocks = flat[off:off + N * S * S].reshape(N, S, S); off += N * S * S
        refs = flat[off:off + N * L].reshape(N, L); off += N * L
        qdc = flat[off:off + N]; off += N
        qac = flat[off:off + N]; off += N
        bm, bt, bc, _ = search_block_batch(
            blocks, refs, qdc, qac, lam, dtb["G"], dtb["scan2d"],
            dtb["scans_tx"], dtb["tvs"], dtb["ths"], dtb["level_bits"],
            dtb["eob_bits"], dtb["txb_skip"], dtb["y_mode_bits"],
            dtb["ext_tx_bits"], dtb["qm_w"], dtb["dist_w"],
            dtb["tx_lam_scale"], S=S, n_tx=n_tx)
        parts += [bm.to(_F32), bt.to(_F32), bc]
    return torch.cat(parts)


def unpack_multi_depth(packed: np.ndarray, ns):
    """Split the packed output back into per-depth (modes i32, tx i32,
    cost f32) given the per-depth padded N list."""
    out = []
    off = 0
    for n in ns:
        bm = packed[off:off + n].astype(np.int32); off += n
        bt = packed[off:off + n].astype(np.int32); off += n
        bc = packed[off:off + n]; off += n
        out.append((bm, bt, bc))
    return out
