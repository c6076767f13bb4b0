"""Frame-level intra RDO of the port: kernel K1 dispatch + partition DP.

A twin of `svt_av1_psy_tpu/codec/intra_rdo.py` (the reference imports jax at
module level). The host prep, the table builders and the partition DP are
the reference's, copied; what changes:

- `search_intra_decisions` takes the encoder's `device`. Its device branch
  (reference :309-363) uploads one flat float32 tensor per frame, runs K1
  (`ops/intra_search.search_multi_depth_flat`) and copies one packed tensor
  back. The 256-block threshold is the reference's: below it the plain
  PyTorch version runs on host tensors, where the reference runs its numpy
  mirror.
- The per-depth tables go to the device once (`_device_tables`, through
  `ops.intra_search.tables_to_torch`).
- The mesh branch is gone: `tpu_mesh_shape` is refused by the port's
  encoder.
"""

from __future__ import annotations

import functools as _functools
from dataclasses import dataclass, field

import numpy as np

from svt_av1_psy_tpu.codec.constants import PredictionMode, TxSize, TxType
from svt_av1_psy_tpu.codec.rd import intra_rate_model, lambda_sse_per_bit
from svt_av1_psy_tpu.codec.spec_tables import get_tables
from ..ops.intra_search import ALL_MODES as _ALL_MODES_ORDER

_S_TO_TXSIZE = {4: int(TxSize.TX_4X4), 8: int(TxSize.TX_8X8),
                16: int(TxSize.TX_16X16), 32: int(TxSize.TX_32X32),
                64: int(TxSize.TX_64X64)}
_TXS_CTX = {8: 1, 16: 2, 32: 3, 64: 4}
_SIZE_LOG2M4 = {8: 2, 16: 4, 32: 6, 64: 6}
_BSL = {8: 0, 16: 1, 32: 2, 64: 3}


@dataclass
class IntraDecisions:
    """Per-frame search output consumed by the conformant encode pass.

    parts[S]: (rows, cols) bool grid, True = SPLIT at that square node
    modes[S]: (rows, cols) int grid of PredictionMode
    tx_types[S]: (rows, cols) int grid of TxType (DCT where not searched)
    """

    parts: dict = field(default_factory=dict)
    modes: dict = field(default_factory=dict)
    tx_types: dict = field(default_factory=dict)
    max_leaf: int = 32
    min_leaf: int = 8
    # rect[S]: (rows, cols) uint8 grid over SxS nodes: 0 = none/split (use
    # parts), 2 = PARTITION_HORZ, 3 = PARTITION_VERT
    # (product_coding_loop.c:9791 searches these shapes inline; here the
    # DP emits them as explicit per-node overrides)
    rect: dict = field(default_factory=dict)

    def rect_part(self, mi_row: int, mi_col: int, size: int) -> int:
        p = self.rect.get(size)
        if p is None:
            return 0
        r, c = (mi_row * 4) // size, (mi_col * 4) // size
        if r >= p.shape[0] or c >= p.shape[1]:
            return 0
        return int(p[r, c])

    def split(self, mi_row: int, mi_col: int, size: int) -> bool:
        p = self.parts.get(size)
        if p is None:
            return size > self.max_leaf
        r, c = (mi_row * 4) // size, (mi_col * 4) // size
        if r >= p.shape[0] or c >= p.shape[1]:
            return True
        return bool(p[r, c])

    def mode(self, mi_row: int, mi_col: int, W: int, H: int) -> int:
        s = min(W, H)
        while s not in self.modes and s > 4:
            s >>= 1
        m = self.modes.get(s)
        if m is None:
            return int(PredictionMode.DC_PRED)
        r = min((mi_row * 4) // s, m.shape[0] - 1)
        c = min((mi_col * 4) // s, m.shape[1] - 1)
        return int(m[r, c])

    def tx_type(self, mi_row: int, mi_col: int, W: int, H: int) -> int:
        if W != H:
            return int(TxType.DCT_DCT)
        t = self.tx_types.get(W)
        if t is None:
            return int(TxType.DCT_DCT)
        r = min((mi_row * 4) // W, t.shape[0] - 1)
        c = min((mi_col * 4) // W, t.shape[1] - 1)
        return int(t[r, c])


def _block_refs(src: np.ndarray, S: int, bd: int) -> np.ndarray:
    """(N, 1+4S) reference vectors for every SxS block of the padded plane,
    from *source* pixels (open loop), with the spec's unavailability
    substitutions at the frame edges (intra_encoder._gather_neighbors).
    Fully vectorized (sliding windows over the padded plane)."""
    from numpy.lib.stride_tricks import sliding_window_view

    ph, pw = src.shape
    rows, cols = ph // S, pw // S
    base = np.float32(1 << (bd - 1))
    s = src.astype(np.float32)
    L = 1 + 4 * S
    refs = np.empty((rows, cols, L), np.float32)

    # above: block (bi>0, bj) reads src[bi*S-1, bj*S : bj*S+2S], cols clipped
    ext_c = np.concatenate([s, np.repeat(s[:, -1:], 2 * S, axis=1)], axis=1)
    above_rows = ext_c[S - 1::S][: rows - 1]                    # (rows-1, pw+2S)
    aw = sliding_window_view(above_rows, 2 * S, axis=1)[:, ::S]  # (rows-1, cols, 2S)
    refs[1:, :, 1:1 + 2 * S] = aw[:, :cols]

    # left: block (bi, bj>0) reads src[bi*S : bi*S+2S, bj*S-1], rows clipped
    ext_r = np.concatenate([s, np.repeat(s[-1:, :], 2 * S, axis=0)], axis=0)
    left_cols = ext_r[:, S - 1::S][:, : cols - 1]                # (ph+2S, cols-1)
    lw = sliding_window_view(left_cols, 2 * S, axis=0)[::S]      # (rows, cols-1, 2S)
    refs[:, 1:, 1 + 2 * S:1 + 4 * S] = lw[:rows].transpose(0, 1, 2)

    # corners for interior blocks
    refs[1:, 1:, 0] = s[S - 1::S, S - 1::S][: rows - 1, : cols - 1]

    # frame-edge substitutions (spec 7.11.2 unavailable-reference rules):
    # no above -> above[:] = left[0] (or base-1); no left -> left[:] =
    # above[0] (or base+1); corner from the available side (or base)
    refs[0, 1:, 1:1 + 2 * S] = refs[0, 1:, 1 + 2 * S][:, None]
    refs[1:, 0, 1 + 2 * S:1 + 4 * S] = refs[1:, 0, 1][:, None]
    refs[0, 1:, 0] = refs[0, 1:, 1 + 2 * S]
    refs[1:, 0, 0] = refs[1:, 0, 1]
    refs[0, 0, 0] = base
    refs[0, 0, 1:1 + 2 * S] = base - 1
    refs[0, 0, 1 + 2 * S:] = base + 1
    return refs.reshape(rows * cols, L)


def _qsteps_for_blocks(rows, cols, S, qindex, sb_qindex_map, chroma_delta,
                       bd, seg_fn=None):
    """Per-block (dc_step, ac_step) in the orthonormal search domain."""
    t = get_tables()
    if sb_qindex_map is None:
        qmap = np.full((rows, cols), qindex, np.int32)
    else:
        rep = 64 // S
        qmap = np.repeat(np.repeat(sb_qindex_map, rep, 0), rep, 1)[:rows, :cols]
    qmap = np.clip(qmap, 1, 255)
    dc = np.array([t.dc_q(int(q), bd) for q in range(256)], np.float32)
    ac = np.array([t.ac_q(int(q), bd) for q in range(256)], np.float32)
    from ..ops.intra_search import coeff_gain

    g = coeff_gain(S)
    return (dc[qmap].reshape(-1) / g).astype(np.float32), \
        (ac[qmap].reshape(-1) / g).astype(np.float32)


@_functools.lru_cache(maxsize=64)
def _cached_tables(S: int, qctx_bucket: int, tx_search_depths, qm_levels,
                   psy_knobs=(0, 0.0, False)):
    tb, n_tx = _build_tables(S, {0: 10, 1: 40, 2: 90, 3: 160}[qctx_bucket],
                             tx_search_depths, qm_levels, *psy_knobs)
    return tb, n_tx


@_functools.lru_cache(maxsize=64)
def _device_tables(S: int, qctx_bucket: int, tx_search_depths, qm_levels,
                   psy_knobs=(0, 0.0, False), device="cpu"):
    """Device-resident copies of the per-depth search tables (uploaded
    once per device)."""
    from ..ops.intra_search import tables_to_torch

    tb, n_tx = _cached_tables(S, qctx_bucket, tx_search_depths, qm_levels,
                              psy_knobs)
    return tables_to_torch(tb, device), n_tx


def search_tables_for_depth(S: int, qindex: int, tx_search_depths=(8, 16),
                            qm_levels=None, psy_knobs=(0, 0.0, False)):
    from svt_av1_psy_tpu.bitstream.frame_context import _coeff_qctx

    return _cached_tables(S, _coeff_qctx(int(qindex)),
                          tuple(tx_search_depths),
                          tuple(qm_levels) if qm_levels is not None else None,
                          tuple(psy_knobs))


def _build_tables(S: int, qindex: int, tx_search_depths=(8, 16),
                  qm_levels=None, spy_rd: int = 0, psy_rd: float = 0.0,
                  sharp_tx: bool = False):
    """All replicated table arrays one depth's search consumes, as a dict
    (the contract shared by search_intra_decisions and the multi-chip
    sharded_frame_step). Returns (tables, n_tx)."""
    from ..ops.intra_search import (EXT_TX_SET_1, EXT_TX_SET_2,
                                    mode_matrix_bank, tx_pair)
    from ..ops.intra_search import ALL_MODES

    t = get_tables()
    rm = intra_rate_model(int(qindex))
    y_mode_bits = np.array([rm.y_mode_bits[int(m)] for m in ALL_MODES],
                           np.float32)
    tx_size = _S_TO_TXSIZE[S]
    keep = min(S, 32)
    nk = keep * keep
    if qm_levels is not None:
        from svt_av1_psy_tpu.codec.qm import get_qm

        _qm, iqm = get_qm(qm_levels[0], False, tx_size)
        qm_w = (iqm.astype(np.float32) / 32.0)
    else:
        qm_w = np.ones(nk, np.float32)
    ct = rm.coeff[_TXS_CTX[S]]
    eob_bits = rm.eob[_SIZE_LOG2M4[S]]
    scan2d = t.scan(tx_size, 0).astype(np.int32)
    do_tx = S in tx_search_depths
    if do_tx:
        from svt_av1_psy_tpu.codec.intra_encoder import EXT_TX_IND_INTRA

        tx_set = EXT_TX_SET_1 if S == 8 else EXT_TX_SET_2
        eset = 1 if S == 8 else 2
        sqr = {8: 1, 16: 2}[S]
        tvs = np.stack([tx_pair(tt, S)[0] for tt in tx_set])
        ths = np.stack([tx_pair(tt, S)[1] for tt in tx_set])
        scans_tx = np.stack([t.scan(tx_size, int(tt)).astype(np.int32)
                             for tt in tx_set])
        ext_bits = np.array([rm.ext_tx_bits[(eset, sqr)][
            EXT_TX_IND_INTRA[eset][int(tt)]] for tt in tx_set], np.float32)
    else:
        tx_set = (TxType.DCT_DCT,)
        tvs = np.stack([tx_pair(TxType.DCT_DCT, S)[0]])
        ths = np.stack([tx_pair(TxType.DCT_DCT, S)[1]])
        scans_tx = scan2d[None]
        ext_bits = np.zeros(1, np.float32)
    from ..ops.intra_search import mode_matrix_bank

    # spy-rd per-mode distortion weights (pic_operators.c:247-258: bias
    # against blurry/neutral intra predictions; full spy-rd only)
    dist_w = np.ones(len(ALL_MODES), np.float32)
    if spy_rd == 1:
        for i, m in enumerate(ALL_MODES):
            mi = int(m)
            if mi in (0, 9, 10, 11) and psy_rd == 0.0:   # DC/SMOOTH family
                dist_w[i] = 1.25
            elif mi in (1, 2, 12):                        # V/H/PAETH
                dist_w[i] = 1.125
    tx_lam_scale = np.float32(0.25 if sharp_tx else 1.0)
    tables = {"G": mode_matrix_bank(S), "scan2d": scan2d, "scans_tx": scans_tx,
              "tvs": tvs, "ths": ths, "level_bits": ct["level_bits"],
              "eob_bits": eob_bits, "txb_skip": ct["txb_skip"],
              "y_mode_bits": y_mode_bits, "ext_tx_bits": ext_bits,
              "qm_w": qm_w, "tx_set": tx_set, "dist_w": dist_w,
              "tx_lam_scale": tx_lam_scale}
    return tables, len(tx_set)


def search_intra_decisions(
    src_padded: np.ndarray,       # (ph, pw) uint16, SB-aligned padded source
    qindex: int,
    bd: int = 8,
    sb_qindex_map=None,
    qm_levels=None,
    depths=(8, 16, 32),
    tx_search_depths=(8, 16),
    update_type: str = "kf",
    lambda_scale: float = 1.0,
    backend: str = "auto",
    psy_knobs=(0, 0.0, False),   # (spy_rd, psy_rd, sharp_tx)
    device="cpu",
) -> IntraDecisions:
    import torch

    from ..ops.intra_search import (search_multi_depth_flat,
                                    unpack_multi_depth)

    ph, pw = src_padded.shape
    lam = np.float32(lambda_sse_per_bit(qindex, bd, update_type) * lambda_scale)
    rm = intra_rate_model(int(qindex))

    dec = IntraDecisions(max_leaf=max(depths), min_leaf=min(depths))
    cost = {}
    # ---- host prep for every depth, then ONE upload, one K1 launch per
    # depth and ONE download per frame
    payloads = []
    for S in depths:
        rows, cols = ph // S, pw // S
        if rows == 0 or cols == 0:
            continue
        refs = _block_refs(src_padded, S, bd)
        N = rows * cols
        blocks = (src_padded.reshape(rows, S, cols, S).transpose(0, 2, 1, 3)
                  .reshape(N, S, S).astype(np.float32))
        qdc, qac = _qsteps_for_blocks(rows, cols, S, qindex, sb_qindex_map,
                                      0, bd)
        tb, n_tx = search_tables_for_depth(S, qindex, tx_search_depths,
                                           qm_levels, psy_knobs)
        payloads.append(dict(S=S, rows=rows, cols=cols, N=N, blocks=blocks,
                             refs=refs, qdc=qdc, qac=qac, tb=tb, n_tx=n_tx))

    min_n = min(p["N"] for p in payloads)
    use_device = ((min_n >= 256 and backend != "numpy")
                  or backend == "device_all")
    # below the threshold the plain version runs on host tensors, where the
    # reference runs its numpy mirror
    run_on = torch.device(device) if use_device else torch.device("cpu")
    from svt_av1_psy_tpu.bitstream.frame_context import _coeff_qctx
    from svt_av1_psy_tpu.profiling import stage as _stage

    bucket = _coeff_qctx(int(qindex))
    tx_key = tuple(tx_search_depths)
    qm_key = tuple(qm_levels) if qm_levels is not None else None
    tabs, cfgs, flats, ns = [], [], [], []
    for p in payloads:
        N, S = p["N"], p["S"]
        npad = max(256, 1 << int(np.ceil(np.log2(N)))) if use_device else N
        blocks, refs, qdc, qac = p["blocks"], p["refs"], p["qdc"], p["qac"]
        if npad > N:
            pad = npad - N
            blocks = np.concatenate([blocks, np.zeros((pad, S, S), np.float32)])
            refs = np.concatenate([refs, np.zeros((pad, refs.shape[1]), np.float32)])
            qdc = np.concatenate([qdc, np.ones(pad, np.float32)])
            qac = np.concatenate([qac, np.ones(pad, np.float32)])
        ns.append(npad)
        dtb, n_tx = _device_tables(S, bucket, tx_key, qm_key,
                                   tuple(psy_knobs), run_on)
        tabs.append(dtb)
        cfgs.append((S, n_tx, npad, refs.shape[1]))
        flats += [blocks.ravel(), refs.ravel(), qdc, qac]
    with _stage("device:intra_search" if use_device else "host:intra_search"):
        flat = torch.from_numpy(np.concatenate(flats)).to(run_on)
        packed = search_multi_depth_flat(flat, float(lam), tabs, cfgs)
        outs = unpack_multi_depth(packed.cpu().numpy(), ns)

    for p, (bm, bt, bc) in zip(payloads, outs):
        S, N, rows, cols = p["S"], p["N"], p["rows"], p["cols"]
        bm = np.asarray(bm)[:N].reshape(rows, cols)
        bt = np.asarray(bt)[:N].reshape(rows, cols)
        cost[S] = np.asarray(bc)[:N].reshape(rows, cols).astype(np.float64)
        mode_lut = np.array([int(m) for m in _ALL_MODES_ORDER], np.int32)
        tx_lut = np.array([int(tt) for tt in p["tb"]["tx_set"]], np.int32)
        dec.modes[S] = mode_lut[bm]
        dec.tx_types[S] = tx_lut[bt]

    # ---- bottom-up partition DP (NONE vs SPLIT), costs include part bits
    sizes = sorted(cost.keys())
    best = cost[sizes[0]] + lam * rm.part_none_bits[_BSL[sizes[0]]]
    for S in sizes[1:]:
        r, c = cost[S].shape
        child = best
        ch = (child[0:2 * r:2, 0:2 * c:2] + child[0:2 * r:2, 1:2 * c:2]
              + child[1:2 * r:2, 0:2 * c:2] + child[1:2 * r:2, 1:2 * c:2])
        none_cost = cost[S] + lam * rm.part_none_bits[_BSL[S]]
        split_cost = ch + lam * rm.part_split_bits[_BSL[S]]
        dec.parts[S] = split_cost < none_cost
        best = np.minimum(none_cost, split_cost)
    return dec


