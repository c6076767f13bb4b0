#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (svt_av1_psy_tpu_torch).

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases, each failing with a non-zero exit:
  1. the card (nvidia-smi name and power limit), torch / CUDA versions, and
     which native host libraries (mc, walk, ec, dav1d) this machine has;
  2. builds the nine kernel libraries (nvcc, sm_90a, all started together) and
     prints each build's seconds and its ptxas registers / spills;
  3. holds each kernel against its plain PyTorch version on the card, at the
     480p preset-10 shapes of the main path and the 1080p preset-6 shapes of
     the quality path, with seeded inputs, and times both with CUDA events
     (K6 and K9 also with the profiler's kernel time):
       K1 intra search  identical modes and tx, except blocks whose two best
                        costs are within 1e-5 relative (counted); also S 8 and
                        S 64 with 5 tx types
       K2 SSD grids     exact
       K3 inter decide  rows exact, at (32, 32) and at every rect shape
       K4 TF            |delta| <= 1 with >= 99.9 % of pixels equal
       K5 transforms    exact, every (tx_size, tx_type) of tx_types_for_size
                        (which holds every pair the commit reaches), 8 / 10-bit
       K6 commit        lv, meta_out and rec exact, S 8/16/32/64, each compound
                        and tx variant, RDOQ on, 8-bit, and 10-bit at S 32/64
       K7 TPL           both stages exact on 960x540 decimated luma of the
                        10-bit 1080p clip (the pair stage on K2's grids)
       K8 CDEF          exact, luma 8x8 and chroma 4x4, 8- and 10-bit, sec
                        0/1/2/4, pri 0 and variance-adjusted, 1080p planes
       K9 SGR sweep     exact (int64 tile sums) on 1080p luma (T 256) and
                        540p chroma (T 128), the 8 eps of preset 6 and all 16
     and, at 10 bits, K1 at S 8 / 16 with 5 tx types and K3 at every shape;
  4. encodes the bench clip (854x480, 24 frames, preset 10, CRF 35) through
     Encoder(cfg, device="cuda"), prints fps, kbps, PSNR-Y and device_frac,
     checks that K1-K4 each launched, checks dav1d conformance where dav1d
     exists, and re-encodes the first 9 frames on the card and with
     device="cpu" (plain versions) to compare size, PSNR and decision rows;
  5. encodes the same clip with commit_backend="device" (K5 + K6 lift the
     inter leaves' prediction, transforms, quantization and recon off the C
     walk), prints fps, kbps, PSNR-Y, device_frac, the commit and host stage
     times and the K5 / K6 launches, checks the stream equals phase 4's
     (host commit), and checks 9-frame device- and host-commit card encodes
     are byte-identical in stream and every recon;
  6. the quality path: encodes 10 frames of the 1920x1080 clip at 10 bits,
     preset 6, CRF 35, with tpl_backend and filters_backend "device" (K7-K9,
     beside K1-K4), prints fps, kbps, PSNR-Y, device_frac, the stage times
     and the launches, and checks that K7, K8 and K9 launched; writes the
     stream and its recons' SHA-256 to chiprun_out/quality_1080p.* (and
     checks them with dav1d where the machine has it); encodes the
     same clip with both backends "host" for comparison (not a gate); and
     checks that 5 frames of the 480p clip at 10 bits, preset 6, with the
     device backends encode byte-identically on the card and with
     device="cpu" (plain versions, the same hybrid search).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. jax is blocked: the port must not need it.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

sys.modules["jax"] = None          # importing jax anywhere now fails

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ------------------------------------------------------------------ phase 3
def check_k1(dev, frame, bd=8, cases=((16, 1), (32, 1), (8, 5), (64, 5))):
    import numpy as np
    import torch

    from svt_av1_psy_tpu.bitstream.frame_context import _coeff_qctx
    from svt_av1_psy_tpu.codec.constants import TxType
    from svt_av1_psy_tpu_torch.codec import intra_rdo as IR
    from svt_av1_psy_tpu_torch.ops import intra_search as K

    q = 140
    ph, pw = -(-frame.shape[0] // 64) * 64, -(-frame.shape[1] // 64) * 64
    pad = np.pad(frame, ((0, ph - frame.shape[0]), (0, pw - frame.shape[1])),
                 mode="edge").astype(np.uint16)
    lam = float(np.float32(IR.lambda_sse_per_bit(q, bd, "kf")))
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for S, n_tx in cases:
        refs = IR._block_refs(pad, S, bd)
        N = refs.shape[0]
        blocks = (pad.reshape(ph // S, S, pw // S, S).transpose(0, 2, 1, 3)
                  .reshape(N, S, S).astype(np.float32))
        qdc, qac = IR._qsteps_for_blocks(ph // S, pw // S, S, q, None, 0, bd)
        npad = max(256, 1 << int(np.ceil(np.log2(N))))
        tb, n = IR._cached_tables(S, _coeff_qctx(q),
                                  (8, 16) if n_tx > 1 else (), None)
        if n != n_tx:      # S 64 with 5 tx bases: synthetic DCT/IDTX set
            tb = dict(tb)
            tt = (TxType.DCT_DCT, TxType.IDTX) * 2 + (TxType.DCT_DCT,)
            tb["tvs"] = np.stack([K.tx_pair(t, S)[0] for t in tt])
            tb["ths"] = np.stack([K.tx_pair(t, S)[1] for t in tt])
            tb["scans_tx"] = np.stack([tb["scan2d"]] * 5)
            tb["ext_tx_bits"] = np.arange(5, dtype=np.float32)
        t = K.tables_to_torch(tb, dev)

        def padn(a, fill):
            extra = np.full((npad - N,) + a.shape[1:], fill, np.float32)
            return torch.from_numpy(np.concatenate([a, extra])).to(dev)

        args = (padn(blocks, 0), padn(refs, 0), padn(qdc, 1), padn(qac, 1),
                lam, t["G"], t["scan2d"], t["scans_tx"], t["tvs"], t["ths"],
                t["level_bits"], t["eob_bits"], t["txb_skip"],
                t["y_mode_bits"], t["ext_tx_bits"], t["qm_w"], t["dist_w"],
                t["tx_lam_scale"])
        kw = dict(S=S, n_tx=n_tx)
        k = K.search_block_batch(*args, **kw)
        p = K.search_block_batch_ref(*args, **kw)
        torch.cuda.synchronize()
        costs, _ = K.mode_costs_ref(*args[:7], args[8], *args[10:14],
                                    args[15], args[16], S)
        two = costs.sort(1).values[:, :2]
        tie = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0].abs()
        bad = ((k[0] != p[0]) | (k[1] != p[1])) & ~tie
        err = float((k[2] - p[2]).abs().max())
        print(f"  K1 {bd}-bit S={S:2d} n_tx={n_tx} N={npad}: mode/tx mismatches "
              f"{int(((k[0] != p[0]) | (k[1] != p[1])).sum())} "
              f"(near-ties {int(tie.sum())}, outside ties {int(bad.sum())}), "
              f"max |d cost| {err:.3g}")
        if int(bad.sum()):
            fail(f"K1 disagrees with its plain version at S={S}")
        if bd == 8 and (S, n_tx) in ((16, 1), (32, 1)):   # the main path
            worst = max(worst, err)
            ms += cuda_ms(lambda: K.search_block_batch(*args, **kw), 20)
            plain_ms += cuda_ms(lambda: K.search_block_batch_ref(*args, **kw), 3)
    return worst, ms, plain_ms


def check_inter(dev, frames, bd=8, shapes=None):
    import numpy as np
    import torch

    from svt_av1_psy_tpu_torch.ops import inter_search as I

    Hp, Wp = I.pad_dims(*frames[0].shape)
    src, _ = I.prep_frame(I.upload_plane(frames[2], dev), Hp, Wp)
    ref_l = I.prep_frame(I.upload_plane(frames[0], dev), Hp, Wp)[1]
    ref_a = I.prep_frame(I.upload_plane(frames[4], dev), Hp, Wp)[1]
    gk = I.grids_stage(src, ref_l)
    gp = I.grids_stage_ref(src, ref_l)
    torch.cuda.synchronize()
    k2_err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(gk, gp))
    print(f"  K2 {bd}-bit grids 480p: max |d| {k2_err} over centres and "
          f"{gk[2].numel()} child SSDs")
    if k2_err:
        fail("K2 disagrees with its plain version")
    k2_ms = cuda_ms(lambda: I.grids_stage(src, ref_l), 10)
    k2_plain = cuda_ms(lambda: I.grids_stage_ref(src, ref_l), 2)
    ga = I.grids_stage(src, ref_a)
    pvec = torch.tensor([1.0, -2.0, 37.5, 1.0, 100.0], device=dev)
    k3_err, k3_ms, k3_plain = 0.0, 0.0, 0.0
    for (w, h) in shapes or I.shapes_for(I.DEPTHS, rect=True):
        for two in (True, False):
            a = (src, ref_l, ref_a, *gk, *ga, pvec)
            kw = dict(BW=w, BH=h, two_ref=two, bd=bd)
            rk, ck = I.depth_stage(*a, **kw)
            rp, cp = I.depth_stage_ref(*a, **kw)
            torch.cuda.synchronize()
            rows_bad = int((rk != rp).any(1).sum())
            cerr = float((ck - cp).abs().max())
            print(f"  K3 {bd}-bit {w}x{h} two_ref={int(two)}: rows differing "
                  f"{rows_bad}/{rk.shape[0]}, max |d cost| {cerr:.3g}")
            if rows_bad:
                fail(f"K3 rows disagree at {w}x{h}")
            if (w, h) == (32, 32):                # the main path's shape
                k3_err = max(k3_err, cerr)
                k3_ms += cuda_ms(lambda: I.depth_stage(*a, **kw), 20)
                k3_plain += cuda_ms(lambda: I.depth_stage_ref(*a, **kw), 3)
    return (k2_err, k2_ms, k2_plain), (k3_err, k3_ms / 2, k3_plain / 2)


def tf_agreement(dev, center, nbrs, bd):
    """K2 + K4 on the card against the plain versions on the host."""
    import numpy as np

    from svt_av1_psy_tpu_torch.ops import tf as T

    out_k = T.temporal_filter_device(center, nbrs, 1, bd, device=dev)
    out_p = T.temporal_filter_device(center, nbrs, 1, bd, device="cpu")
    worst, eq = 0, 1.0
    for a, b in zip(out_k, out_p):
        if a is None:
            continue
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        worst = max(worst, int(d.max()))
        eq = min(eq, float((d == 0).mean()))
    print(f"  K4 {bd}-bit TF {center[0].shape[1]}x{center[0].shape[0]}, "
          f"{len(nbrs)} neighbours"
          f"{'' if center[1] is not None else ', mono'}: max |d| {worst}, "
          f"equal share {eq:.6f}")
    if worst > 1 or eq < 0.999:
        fail("K4 disagrees with its plain version")
    return worst


def check_k4(dev, frames, u, v):
    import numpy as np
    import torch

    from svt_av1_psy_tpu_torch.ops import inter_search as I
    from svt_av1_psy_tpu_torch.ops import tf as T

    worst = tf_agreement(dev, (frames[3], u, v),
                         [(frames[i], u, v) for i in (0, 1, 2, 4, 5, 6)], 8)
    # timed: one neighbour's luma and chroma stages, plus the finalize of
    # all three planes over 6 neighbours
    H, W = frames[0].shape
    Hc, Wc = u.shape
    Hp, Wp = I.pad_dims(H, W)
    src = I.prep_frame(I.upload_plane(frames[3], dev), Hp, Wp)[0]
    ref = I.prep_ref(I.upload_plane(frames[4], dev), Hp, Wp)
    cu = I.prep_frame(I.upload_plane(u, dev), Hp // 2, Wp // 2)[0]
    ru = I.prep_ref(I.upload_plane(u, dev), Hp // 2, Wp // 2)
    g = I.grids_stage(src, ref)
    preds, preds_c = torch.stack([src] * 6), torch.stack([cu] * 6)
    ws, ws_c = torch.full_like(preds, 8.0), torch.full_like(preds_c, 8.0)

    def run(pair, chroma, fin):
        pr, w, my, mx = pair(src, ref, *g, 50.0, H, W)
        chroma(cu, cu, ru, ru, my, mx, w, 40.0, Hc, Wc)
        fin(src, preds, ws, H, W)
        for _ in range(2):
            fin(cu, preds_c, ws_c, Hc, Wc)

    ms = cuda_ms(lambda: run(T.tf_pair_stage, T.tf_chroma_stage,
                             T.tf_finalize_stage), 20)
    plain = cuda_ms(lambda: run(T.tf_pair_stage_ref, T.tf_chroma_stage_ref,
                                T.tf_finalize_stage_ref), 3)
    return worst, ms, plain


def check_k5(dev):
    """K5 against its plain version on the card over every (tx_size,
    tx_type) of tx_types_for_size, 8- and 10-bit; then times the main
    path's shapes (32x32 luma x 128 lanes, 16x16 chroma x 256)."""
    import numpy as np
    import torch

    from svt_av1_psy_tpu.codec.constants import TX_HEIGHT, TX_WIDTH
    from svt_av1_psy_tpu.codec.transforms import tx_types_for_size
    from svt_av1_psy_tpu_torch.ops import commit as C
    from svt_av1_psy_tpu_torch.ops import txfm as X

    swept = {(ts, int(tt)) for ts in range(19) for tt in tx_types_for_size(ts)}
    reached = set()
    for S in (8, 16, 32, 64):
        tts_y, tts_uv = C._size_tts(S)
        reached |= {(C._tx_size_of(S, S), t) for t in tts_y}
        reached |= {(C._chroma_geom(S, S)[2], t) for t in tts_uv}
    if not reached <= swept:
        fail(f"K5 sweep misses commit pairs {sorted(reached - swept)}")
    worst = 0
    for bd in (8, 10):
        peak = (1 << bd) - 1
        for ts, tt in sorted(swept):
            H, W = int(TX_HEIGHT[ts]), int(TX_WIDTH[ts])
            rng = np.random.default_rng(ts * 16 + tt + bd)
            res = torch.from_numpy(rng.integers(-peak, peak + 1, (64, H, W))
                                   .astype(np.int32)).to(dev)
            pred = torch.from_numpy(rng.integers(0, peak + 1, (64, H, W))
                                    .astype(np.int32)).to(dev)
            fk = X.forward_transform_2d(res, ts, tt)
            fp = X.forward_transform_2d_ref(res, ts, tt)
            ik = X.inverse_transform_add(fp, pred, ts, tt, bd)
            ip = X.inverse_transform_add_ref(fp, pred, ts, tt, bd)
            torch.cuda.synchronize()
            err = max(int((fk - fp).abs().max()), int((ik - ip).abs().max()))
            worst = max(worst, err)
            if err:
                fail(f"K5 disagrees with its plain version at tx_size {ts} "
                     f"tx_type {tt} bd {bd}: max |d| {err}")
    print(f"  K5 transforms: {len(swept)} (tx_size, tx_type) pairs x bd 8/10, "
          f"fwd and inv+add, {len(reached)} commit pairs among them: "
          f"max |d| {worst}")
    rng = np.random.default_rng(5)
    ry = torch.from_numpy(rng.integers(-60, 61, (128, 32, 32)).astype(np.int32)).to(dev)
    rc = torch.from_numpy(rng.integers(-30, 31, (256, 16, 16)).astype(np.int32)).to(dev)
    py = torch.full_like(ry, 128)
    pc = torch.full_like(rc, 128)

    def run(fwd, inv):
        inv(fwd(ry, 3, 0), py, 3, 0, 8)
        inv(fwd(rc, 2, 0), pc, 2, 0, 8)

    ms = cuda_ms(lambda: run(X.forward_transform_2d, X.inverse_transform_add), 20)
    plain = cuda_ms(lambda: run(X.forward_transform_2d_ref,
                                X.inverse_transform_add_ref), 3)
    return worst, ms, plain


def k6_case(dev, frames, chroma, S, bd, seed):
    """Group inputs cut from the bench clip: refs frames 0 and 2 (edge-padded
    as the encoder pads them), source frame 1, _CHUNK_LANES[S] lanes on the
    S grid with MVs near the clip's motion, a tenth of them padding lanes,
    16 quant rows (qindex 60..250)."""
    import numpy as np
    import torch

    from svt_av1_psy_tpu.codec.quant import build_plane_quant
    from svt_av1_psy_tpu.codec.spec_tables import get_tables
    from svt_av1_psy_tpu_torch.ops import commit as C

    pad = 160
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bd == 8 else np.uint16

    def planes(k):
        out = [frames[k], chroma[k][0], chroma[k][1]]
        return [p.astype(dt) << (bd - 8) for p in out]

    r0, sr, r1 = planes(0), planes(1), planes(2)
    refs = [C._upload(np.stack([np.pad(a, pad, mode="edge"),
                                np.pad(b, pad, mode="edge")]), dev)
            for a, b in zip(r0, r1)]
    srcs = [C._upload(p, dev) for p in sr]
    H, W = frames[0].shape
    B = C._CHUNK_LANES[S]
    meta = np.zeros((B, 8), np.int32)
    meta[:, 0] = rng.integers(0, H // S, B) * S
    meta[:, 1] = rng.integers(0, W // S, B) * S
    meta[:, 6] = rng.integers(0, 2, B)
    # the clip pans by (2, 3) pels a frame: true MVs (16, 24) to frame 0 and
    # (-16, -24) to frame 2 in 1/8 pel, jittered over every subpel phase
    meta[:, 2:4] = np.where(meta[:, 6:7] == 0, (16, 24), (-16, -24))
    meta[:, 4:6] = (-16, -24)
    meta[:, 2:6] += rng.integers(-12, 13, (B, 4))
    meta[:, 7] = rng.integers(0, 16, B)
    meta[B - B // 10:, 0:2] = 1 << 24
    qt = np.zeros((2, 16, 10), np.int32)
    for i, q in enumerate(np.linspace(60, 250, 16).astype(int)):
        for p in range(2):
            pq = build_plane_quant(int(q), 0, 0, bd, 1, 140)
            qt[p, i] = (pq.zbin[0], pq.zbin[1], pq.round[0], pq.round[1],
                        pq.quant[0], pq.quant[1], pq.quant_shift[0],
                        pq.quant_shift[1], pq.dequant[0], pq.dequant[1])
    tab = get_tables()._raw
    f8, f4 = (torch.from_numpy(np.asarray(tab[k], np.int32)).to(dev)
              for k in ("interp_sub_pel_filters_8", "interp_sub_pel_filters_4"))
    return (refs, srcs, torch.from_numpy(meta).to(dev),
            torch.from_numpy(qt[0]).to(dev), torch.from_numpy(qt[1]).to(dev),
            f8, f4), pad


def check_k6(dev, frames, chroma, bd, sizes=(8, 16, 32, 64)):
    """K6 against its plain version on the card: every (S, compound, vi)
    group, RDOQ on; all three outputs bit-equal. Times the main path's S=32
    groups (mean over compound x vi)."""
    import torch

    from svt_av1_psy_tpu_torch.ops import commit as C

    worst, ms, plain, n = 0, 0.0, 0.0, 0
    for S in sizes:
        args, pad = k6_case(dev, frames, chroma, S, bd, S + bd)
        for is_comp in (False, True):
            for vi in range(len(C._size_tts(S)[0])):
                fn = C._jit_group(S, is_comp, vi, bd, 3, True, pad)
                tabs = C._vi_tables(S, 3, None, vi, dev)
                k = fn(*args, *tabs)
                p = C._group_program(*args, *tabs, **fn.keywords)
                torch.cuda.synchronize()
                err = max(int((a.long() - b.long()).abs().max())
                          for a, b in zip(k, p))
                eobs = p[1][:, :3]
                print(f"  K6 {bd}-bit S={S:2d} comp={int(is_comp)} vi={vi}: "
                      f"max |d| {err} over lv/meta/rec; luma eob 0 in "
                      f"{int((eobs[:, 0] == 0).sum())}/{eobs.shape[0]} lanes, "
                      f"over {int(p[1][:, 3].sum())}")
                worst = max(worst, err)
                if err:
                    fail(f"K6 disagrees with its plain version at S={S} "
                         f"comp={int(is_comp)} vi={vi} bd={bd}")
                if S == 32 and bd == 8:               # the main path's groups
                    ms += cuda_ms(lambda: fn(*args, *tabs), 20)
                    plain += cuda_ms(lambda: C._group_program(
                        *args, *tabs, **fn.keywords), 3)
                    n += 1
    return worst, ms / max(n, 1), plain / max(n, 1)


def kernel_time_ms(fn, reps, prefixes):
    """Device time of the kernels whose names start with `prefixes`, per
    call of fn, from torch.profiler (launch gaps excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tot = 0.0
    for e in prof.key_averages():
        if e.key.startswith(prefixes):
            tot += getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0))
    return tot / 1000.0 / reps


def check_k7(dev, luma):
    """K7 on the TPL shapes of the 1080p path: 960x540 decimated 8-bit luma
    (frame 1 against frame 0), the pair stage on K2's grids."""
    import torch

    from svt_av1_psy_tpu_torch.ops import inter_search as I
    from svt_av1_psy_tpu_torch.ops import tpl as TP

    H, W = luma[0].shape
    Hp, Wp = I.pad_dims(H, W)
    src = I.prep_frame(I.upload_plane(luma[1], dev), Hp, Wp)[0]
    ref = I.prep_frame(I.upload_plane(luma[0], dev), Hp, Wp)[1]
    g = I.grids_stage(src, ref)
    ik, ip = TP.tpl_intra_stage(src, H, W), TP.tpl_intra_stage_ref(src, H, W)
    pk = TP.tpl_pair_stage(src, ref, *g, H, W)
    pp = TP.tpl_pair_stage_ref(src, ref, *g, H, W)
    torch.cuda.synchronize()
    err = max(float((ik - ip).abs().max()), float((pk - pp).abs().max()))
    m = ik.numel()
    moved = int((pk[:2 * m] != 0).sum())
    print(f"  K7 TPL {W}x{H} -> {Hp}x{Wp}, {m} units: max |d| {err} over intra "
          f"and the packed pair vector ({moved} non-zero MV components)")
    if err:
        fail("K7 disagrees with its plain version")

    def run(intra, pair):
        intra(src, H, W)
        pair(src, ref, *g, H, W)

    ms = cuda_ms(lambda: run(TP.tpl_intra_stage, TP.tpl_pair_stage), 20)
    plain = cuda_ms(lambda: run(TP.tpl_intra_stage_ref, TP.tpl_pair_stage_ref), 3)
    dev_ms = kernel_time_ms(lambda: run(TP.tpl_intra_stage, TP.tpl_pair_stage),
                            10, ("tpl_",))
    plain_dev = kernel_time_ms(
        lambda: run(TP.tpl_intra_stage_ref, TP.tpl_pair_stage_ref), 3, ("",))
    return err, ms, plain, dev_ms, plain_dev


def cdef_neighbourhoods(img, dev, bs):
    """Every bs x bs block's (bs+4)^2 neighbourhood of one plane, padded with
    CDEF_VERY_LARGE, gathered on the card (as the port's cdef_frame does)."""
    import torch

    from svt_av1_psy_tpu.codec.cdef import CDEF_VERY_LARGE

    h, w = img.shape
    pad = torch.full((h + 4, w + 4), CDEF_VERY_LARGE, dtype=torch.int32,
                     device=dev)
    pad[2:-2, 2:-2] = torch.from_numpy(img.astype("int32")).to(dev)
    r = torch.arange(h // bs, device=dev).repeat_interleave(w // bs)
    c = torch.arange(w // bs, device=dev).repeat(h // bs)
    ys = r[:, None] * bs + torch.arange(bs + 4, device=dev)
    xs = c[:, None] * bs + torch.arange(bs + 4, device=dev)
    return pad[ys[:, :, None], xs[:, None, :]].contiguous()


def check_k8(dev, y10, u10):
    """K8 on whole 1080p planes: luma 8x8 (32400 blocks) and chroma 4x4, at 8
    and 10 bits, pri 0 and variance-adjusted, sec 0/1/2/4."""
    import numpy as np
    import torch

    from svt_av1_psy_tpu.codec.cdef import adjust_strength
    from svt_av1_psy_tpu_torch.ops import filters as F

    worst, timed = 0, None
    for bd in (8, 10):
        sh = bd - 8
        for luma in (True, False):
            img = (y10 if luma else u10) >> (10 - bd)
            bs = 8 if luma else 4
            nbs = cdef_neighbourhoods(img, dev, bs)
            N = nbs.shape[0]
            rng = np.random.default_rng(bd + luma)
            dirs = rng.integers(0, 8, N).astype(np.int32)
            var = rng.integers(0, 1 << 16, N).astype(np.int64)
            damp = 3 + 2 + sh - (0 if luma else 1)
            bad = 0
            for pri in (0, 4):
                p = pri << sh
                pstr = (adjust_strength(p, var) if luma
                        else np.full(N, p)).astype(np.int32)
                d = torch.from_numpy(dirs if p else np.zeros_like(dirs)).to(dev)
                pt = torch.from_numpy(pstr).to(dev)
                for sec in (0, 1, 2, 4):
                    args = (nbs, d, pt, sec << sh, damp, damp, bs, bs, bd)
                    k = F.cdef_filter_blocks(*args)
                    q = F.cdef_filter_blocks_ref(*args)
                    torch.cuda.synchronize()
                    err = int((k - q).abs().max())
                    worst = max(worst, err)
                    bad += int(err != 0)
                    if luma and bd == 10 and pri == 4 and sec == 2:
                        timed = args
            print(f"  K8 CDEF {bd}-bit {'luma 8x8' if luma else 'chroma 4x4'} "
                  f"N={N}: 8 (pri, sec) cases, {bad} differing; max |d| {worst}")
            if bad:
                fail(f"K8 disagrees with its plain version ({bd}-bit)")
    ms = cuda_ms(lambda: F.cdef_filter_blocks(*timed), 20)
    plain = cuda_ms(lambda: F.cdef_filter_blocks_ref(*timed), 3)
    return worst, ms, plain


def check_k9(dev, y10, u10):
    """K9 on the 1080p luma plane (T 256) and the 540p chroma plane (T 128)
    at 10 bits, against a seeded noisy copy (the post-CDEF plane's stand-in):
    the 8 eps of preset 6, and all 16 on luma. Exact."""
    import numpy as np
    import torch

    from svt_av1_psy_tpu_torch.ops import lr_search as L

    worst, timed = 0.0, None
    rng = np.random.default_rng(9)
    for name, plane, T in (("luma", y10, 256), ("chroma", u10, 128)):
        src = plane.astype(np.int32)
        dgd = np.clip(src + rng.integers(-36, 37, src.shape), 0, 1023)
        st = torch.from_numpy(src).to(dev)
        dt = torch.from_numpy(dgd.astype(np.int32)).to(dev)
        for eps in (tuple(range(0, 16, 2)),) + ((tuple(range(16)),)
                                                if name == "luma" else ()):
            k = L.sgr_stats(st, dt, T, 10, eps)
            q = L.sgr_stats_ref(st, dt, T, 10, eps)
            torch.cuda.synchronize()
            err = float((k - q).abs().max())
            worst = max(worst, err)
            print(f"  K9 SGR {name} {src.shape[1]}x{src.shape[0]} T={T} "
                  f"{len(eps)} eps -> {tuple(k.shape)}: max |d| {err}")
            if err:
                fail(f"K9 disagrees with its plain version ({name})")
            if name == "luma" and len(eps) == 8:
                timed = (st, dt, T, 10, eps)
    ms = cuda_ms(lambda: L.sgr_stats(*timed), 10)
    plain = cuda_ms(lambda: L.sgr_stats_ref(*timed), 2)
    dev_ms = kernel_time_ms(lambda: L.sgr_stats(*timed), 10, ("sgr_",))
    plain_dev = kernel_time_ms(lambda: L.sgr_stats_ref(*timed), 2, ("",))
    return worst, ms, plain, dev_ms, plain_dev


# ------------------------------------------------------------------ phase 4
def encode(frames, u, v, device, n, commit="auto", preset=10, bd=8, **opts):
    import numpy as np

    from svt_av1_psy_tpu.config import EncoderConfig
    from svt_av1_psy_tpu_torch.api import Encoder

    H, W = frames[0].shape
    cfg = EncoderConfig(width=W, height=H, preset=preset, stat_report=True,
                        recon_enabled=True, commit_backend=commit,
                        input_depth=bd)
    cfg.qp = 35
    for k, val in opts.items():
        setattr(cfg, k, val)
    enc = Encoder(cfg, device=device).init()
    pkts = []
    for i in range(n):
        enc.send_picture(frames[i], u, v.copy())
        while (p := enc.get_packet()) is not None:
            pkts.append(p)
    enc.flush()
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    if enc._me_pipe is not None:
        enc._me_pipe.drain()
    stream = b"".join(p.data for p in pkts)
    psnr = [p.stats["psnr_y"] for p in pkts if p.stats]
    return stream, pkts, float(np.mean(psnr)) if psnr else float("nan")


N_1080 = 10      # frames of the 1080p clip (the reference cell has 24)


def quality_clip():
    """The reference's 1080p cell clip (bench._video) at 10 bits: (luma
    frames, u, v), each uint16."""
    import numpy as np

    from bench import _video

    frames, u, v = _video(1920, 1080, N_1080)
    return ([f.astype(np.uint16) << 2 for f in frames],
            u.astype(np.uint16) << 2, v.astype(np.uint16) << 2)


def main():
    sys.path.insert(0, HERE)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    try:
        import numpy as np

        import svt_av1_psy_tpu_torch  # noqa: F401
        from bench import _video
    except ImportError as e:
        fail(f"the repository is not beside this script ({e})")
    from svt_av1_psy_tpu import profiling
    from svt_av1_psy_tpu.bitstream import ec_native
    from svt_av1_psy_tpu.codec.me import decimate
    from svt_av1_psy_tpu.codec import mc_native, walk_native
    from svt_av1_psy_tpu.io import dav1d
    from svt_av1_psy_tpu_torch import device as D
    from svt_av1_psy_tpu_torch.ops import _build
    from svt_av1_psy_tpu_torch.ops import commit as C
    from svt_av1_psy_tpu_torch.ops import inter_search as I
    from svt_av1_psy_tpu_torch.ops import intra_search as K
    from svt_av1_psy_tpu_torch.ops import tf as T
    from svt_av1_psy_tpu_torch.ops import txfm as X
    from svt_av1_psy_tpu_torch.parallel import pipeline as PL

    # ---- phase 1
    card = smi()
    dev = D.resolve("cuda")
    print(f"[1] card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    have_dav1d = dav1d.available()
    print(f"    native: mc {mc_native.available()} walk "
          f"{walk_native.available()} ec {ec_native.available()} dav1d "
          f"{have_dav1d}", flush=True)

    # ---- phase 2
    t0 = time.perf_counter()
    info = _build.build_all()
    print(f"[2] kernels built in {time.perf_counter() - t0:.1f} s (sm_90a)")
    for name, b in info.items():
        regs = [ln.strip().replace("ptxas info    : ", "")
                for ln in b["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln or "entry function" in ln]
        print(f"    {name}: {b['seconds']:.1f} s{' (cached)' if b['cached'] else ''}")
        for ln in regs:
            print(f"      {ln}")
    sys.stdout.flush()

    # ---- phase 3
    frames, u, v = _video(854, 480, 24)
    print("[3] kernels vs plain versions at 480p")
    k1 = check_k1(dev, frames[0])
    k2, k3 = check_inter(dev, frames)
    k4 = check_k4(dev, frames, u, v)
    f10 = [f.astype(np.uint16) << 2 for f in frames[:5]]
    check_k1(dev, f10[0], bd=10, cases=((16, 1), (32, 1)))
    check_inter(dev, f10, bd=10, shapes=((32, 32), (64, 64)))
    tf_agreement(dev, (f10[2], None, None),
                 [(f10[i], None, None) for i in (0, 1, 3)], 10)
    crop = [(f[:470, :838], u[:235, :419], v[:235, :419]) for f in frames[:4]]
    tf_agreement(dev, crop[1], [crop[0], crop[2], crop[3]], 8)   # 838x470
    sys.stdout.flush()
    k5 = check_k5(dev)
    sys.stdout.flush()
    chroma = [(f[::2, ::2], f[1::2, 1::2]) for f in frames[:3]]
    k6 = check_k6(dev, frames, chroma, 8)
    check_k6(dev, frames, chroma, 10, sizes=(32, 64))
    args, pad = k6_case(dev, frames, chroma, 32, 8, 40)
    groups = [(C._jit_group(32, c, vi, 8, 3, True, pad),
               C._vi_tables(32, 3, None, vi, dev))
              for c in (False, True) for vi in (0, 1)]
    k6_dev = kernel_time_ms(lambda: [fn(*args, *t) for fn, t in groups], 10,
                            ("commit_", "txfm_")) / len(groups)
    print(f"  K5 ms {k5[1]:.4f} (plain {k5[2]:.4f}); K6 group S=32 ms "
          f"{k6[1]:.4f} (plain {k6[2]:.4f}), its kernels' device time "
          f"{k6_dev:.4f} ms per group (profiler)")
    sys.stdout.flush()
    print("[3] the 1080p preset-6 path's kernels, 10-bit clip")
    q = quality_clip()
    k7 = check_k7(dev, [decimate(p >> 2, 1) for p in q[0][:2]])
    k8 = check_k8(dev, q[0][0], q[1])
    k9 = check_k9(dev, q[0][0], q[1])
    print(f"  K7 ms {k7[1]:.4f} (plain {k7[2]:.4f}), device time {k7[3]:.4f} "
          f"(plain {k7[4]:.4f}): intra + pair stage; K8 ms {k8[1]:.4f} (plain "
          f"{k8[2]:.4f}): 10-bit luma N=32400; K9 ms {k9[1]:.4f} (plain "
          f"{k9[2]:.4f}), device time {k9[3]:.4f} (plain {k9[4]:.4f}): 1080p "
          "luma, 8 eps; device times from the profiler, all kernels of the "
          "call")
    print("[3] K1 at S 8 / 16 with 5 tx types and K3 at every shape, 10-bit 480p")
    check_k1(dev, f10[0], bd=10, cases=((8, 5), (16, 5)))
    check_inter(dev, f10, bd=10)
    sys.stdout.flush()

    # ---- phase 4
    print("[4] end to end: 854x480 x24, preset 10, CRF 35, device cuda")
    encode(frames, u, v, dev, 8)                   # warm run, as bench.py
    counters = (K.calls, I.calls["grids"], I.calls["depth"], T.calls)
    for c in counters:
        c["kernel"] = 0
        c["plain"] = 0
    profiling.reset()
    t0 = time.perf_counter()
    stream, pkts, psnr = encode(frames, u, v, dev, 24)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = [c["kernel"] for c in counters]
    prof = profiling.snapshot()
    dev_s = sum(x["s"] for k, x in prof.items() if k.startswith("device:"))
    fps = 24 / dt
    kbps = len(stream) * 8 * 25 / 24 / 1000
    print(f"    fps {fps:.4f}  kbps {kbps:.1f}  PSNR-Y {psnr:.4f} dB  "
          f"device_frac {dev_s / dt:.4f}  ({card})")
    print("    stages: " + ", ".join(f"{k} {x['s']:.3f}s"
                                    for k, x in sorted(prof.items())))
    print(f"    launches K1 {launches[0]} K2 {launches[1]} K3 {launches[2]} "
          f"K4 {launches[3]}; plain calls "
          f"{[c['plain'] for c in counters]}")
    if min(launches) < 1:
        fail("a kernel of the main path was never launched")
    if not (np.isfinite(psnr) and psnr > 25.0 and len(stream) > 1000):
        fail(f"implausible encode: {len(stream)} bytes, PSNR {psnr}")
    shown = [p for p in pkts if p.recon is not None]
    if have_dav1d:
        W, H = 854, 480
        for i, p in enumerate(shown):
            d = dav1d.decode_nth(stream, i, W, H)
            if not all(np.array_equal(d[k], p.recon[k]) for k in range(3)):
                fail(f"frame {i} does not decode to the encoder's recon")
        print(f"    dav1d: all {len(shown)} frames decode to the recon")
    else:
        print("    dav1d ABSENT on this machine: conformance NOT checked "
              "(not a pass)")

    rows = {}

    def recording(orig, tag):
        def get(self, key, timeout=600.0):
            res = orig(self, key, timeout)
            rows[(tag, key[1])] = res
            return res
        return get

    orig_get = PL.InterSearchPipeline.get
    PL.InterSearchPipeline.get = recording(orig_get, "cuda")
    s_card, _, p_card = encode(frames, u, v, dev, 9)
    PL.InterSearchPipeline.get = recording(orig_get, "cpu")
    from svt_av1_psy_tpu.config import EncoderConfig
    from svt_av1_psy_tpu_torch.api import Encoder

    cfg_cpu = EncoderConfig(width=854, height=480, preset=10, stat_report=True,
                            recon_enabled=True)
    cfg_cpu.qp = 35
    cfg_cpu.inter_me_backend = "device"
    cfg_cpu.tf_backend = "device"
    enc = Encoder(cfg_cpu, device="cpu").init()
    pk = []
    for i in range(9):
        enc.send_picture(frames[i], u, v.copy())
        while (p := enc.get_packet()) is not None:
            pk.append(p)
    enc.flush()
    while (p := enc.get_packet()) is not None:
        pk.append(p)
    PL.InterSearchPipeline.get = orig_get
    s_cpu = b"".join(p.data for p in pk)
    p_cpu = float(np.mean([p.stats["psnr_y"] for p in pk if p.stats]))
    agree = tot = 0
    for (tag, idx), res in rows.items():
        if tag != "cuda" or ("cpu", idx) not in rows:
            continue
        other = rows[("cpu", idx)]
        for key, (r, _c) in res.items():
            agree += int((r == other[key][0]).all(1).sum())
            tot += r.shape[0]
    share = agree / max(tot, 1)
    print(f"    first 9 frames: card {len(s_card)} B PSNR {p_card:.4f} dB; "
          f"cpu plain {len(s_cpu)} B PSNR {p_cpu:.4f} dB; identical "
          f"{s_card == s_cpu}; decision rows agree {agree}/{tot}")
    if (abs(len(s_card) - len(s_cpu)) > 0.02 * len(s_cpu)
            or abs(p_card - p_cpu) > 0.05 or tot == 0 or share < 0.99):
        fail("the card's encode strays from the plain versions' encode")
    sys.stdout.flush()

    # ---- phase 5
    print("[5] end to end with commit_backend=device: 854x480 x24, preset 10, "
          "CRF 35, device cuda")
    encode(frames, u, v, dev, 8, commit="device")   # warm run
    counters = (K.calls, I.calls["grids"], I.calls["depth"], T.calls, X.calls,
                C.calls)
    for c in counters:
        c["kernel"] = 0
        c["plain"] = 0
    for k in C.leaves:
        C.leaves[k] = 0
    profiling.reset()
    t0 = time.perf_counter()
    stream5, pkts5, psnr5 = encode(frames, u, v, dev, 24, commit="device")
    torch.cuda.synchronize()
    dt5 = time.perf_counter() - t0
    launches5 = [c["kernel"] for c in counters]
    prof = profiling.snapshot()
    dev_s = sum(x["s"] for k, x in prof.items() if k.startswith("device:"))
    kbps5 = len(stream5) * 8 * 25 / 24 / 1000
    print(f"    fps {24 / dt5:.4f}  kbps {kbps5:.1f}  PSNR-Y {psnr5:.4f} dB  "
          f"device_frac {dev_s / dt5:.4f}  ({card})")
    print("    stages: " + ", ".join(f"{k} {x['s']:.3f}s"
                                    for k, x in sorted(prof.items())))
    print(f"    launches K1 {launches5[0]} K2 {launches5[1]} K3 {launches5[2]} "
          f"K4 {launches5[3]} K5 {launches5[4]} K6 {launches5[5]}; plain calls "
          f"{[c['plain'] for c in counters]}")
    print(f"    inter leaves {C.leaves['inter']}, sent to the device "
          f"{C.leaves['lanes']}, levels kept for the walk {C.leaves['kept']} "
          "(the walk recomputes the rest)")
    if min(launches5[4:]) < 1:
        fail("K5 or K6 was never launched by the device-commit encode")
    if stream5 != stream:
        fail("the device-commit stream differs from phase 4's host-commit "
             "stream")
    for a, b in zip(pkts, pkts5):
        if (a.recon is None) != (b.recon is None) or (
                a.recon is not None
                and not all(np.array_equal(x, y)
                            for x, y in zip(a.recon, b.recon))):
            fail("a device-commit recon differs from phase 4's")
    s_dev, pk_dev, _ = encode(frames, u, v, dev, 9, commit="device")
    s_host, pk_host, _ = encode(frames, u, v, dev, 9, commit="host")
    same = s_dev == s_host and len(pk_dev) == len(pk_host) and all(
        (a.recon is None) == (b.recon is None)
        and (a.recon is None or all(np.array_equal(x, y)
                                    for x, y in zip(a.recon, b.recon)))
        for a, b in zip(pk_dev, pk_host))
    print(f"    first 9 frames: device commit {len(s_dev)} B, host commit "
          f"{len(s_host)} B, stream and every recon identical {same}")
    if not same:
        fail("the device-commit and host-commit encodes differ")

    # ---- phase 6
    from svt_av1_psy_tpu_torch.ops import filters as F
    from svt_av1_psy_tpu_torch.ops import lr_search as L
    from svt_av1_psy_tpu_torch.ops import tpl as TP

    print(f"[6] the quality path: 1920x1080 x{N_1080}, 10-bit, preset 6, CRF "
          "35, tpl_backend and filters_backend device, device cuda")
    y6, u6, v6 = q
    dev_opts = dict(tpl_backend="device", filters_backend="device")
    counters6 = (K.calls, I.calls["grids"], I.calls["depth"], T.calls,
                 TP.calls, F.calls, L.calls)
    for c in counters6:
        c["kernel"] = 0
        c["plain"] = 0
    profiling.reset()
    t0 = time.perf_counter()
    s6, pk6, psnr6 = encode(y6, u6, v6, dev, N_1080, preset=6, bd=10, **dev_opts)
    torch.cuda.synchronize()
    dt6 = time.perf_counter() - t0
    launches6 = [c["kernel"] for c in counters6]
    prof6 = profiling.snapshot()
    dev_s = sum(x["s"] for k, x in prof6.items() if k.startswith("device:"))
    kbps6 = len(s6) * 8 * 25 / N_1080 / 1000
    print(f"    fps {N_1080 / dt6:.4f}  kbps {kbps6:.1f}  PSNR-Y {psnr6:.4f} dB  "
          f"device_frac {dev_s / dt6:.4f}  wall {dt6:.3f} s  ({card})")
    print("    stages: " + ", ".join(f"{k} {x['s']:.3f}s"
                                    for k, x in sorted(prof6.items())))
    print(f"    launches K1 {launches6[0]} K2 {launches6[1]} K3 {launches6[2]} "
          f"K4 {launches6[3]} K7 {launches6[4]} K8 {launches6[5]} K9 "
          f"{launches6[6]}; plain calls {[c['plain'] for c in counters6]}")
    if min(launches6[4:]) < 1:
        fail("K7, K8 or K9 was never launched by the quality-path encode")
    if min(launches6[:4]) < 1:
        fail("a kernel of K1-K4 was never launched by the quality-path encode")
    shown6 = [p for p in pk6 if p.recon is not None]
    if not (np.isfinite(psnr6) and psnr6 > 25.0 and len(s6) > 10000
            and len(shown6) == N_1080
            and all(p.recon[0].shape == (1080, 1920) for p in shown6)):
        fail(f"implausible quality-path encode: {len(s6)} bytes, PSNR {psnr6}, "
             f"{len(shown6)} frames shown")
    # the stream and its recons' hashes, for a dav1d check where dav1d is
    base = os.path.join(HERE, "chiprun_out", "quality_1080p")
    os.makedirs(os.path.dirname(base), exist_ok=True)
    with open(base + ".obu", "wb") as f:
        f.write(s6)
    with open(base + ".json", "w") as f:
        json.dump({"width": 1920, "height": 1080, "recon_sha256": [
            [hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()
             for x in p.recon] for p in shown6]}, f)
    if have_dav1d:
        for i, p in enumerate(shown6):
            d = dav1d.decode_nth(s6, i, 1920, 1080)
            if not all(np.array_equal(d[k], p.recon[k]) for k in range(3)):
                fail(f"1080p frame {i} does not decode to the encoder's recon")
        print(f"    dav1d: all {len(shown6)} frames decode to the recon")
    else:
        print(f"    dav1d ABSENT: stream and recon hashes written to {base}.*")
    sys.stdout.flush()
    profiling.reset()
    t0 = time.perf_counter()
    s6h, _, psnr6h = encode(y6, u6, v6, dev, N_1080, preset=6, bd=10,
                            tpl_backend="host", filters_backend="host")
    dt6h = time.perf_counter() - t0
    prof6h = profiling.snapshot()
    print(f"    host backends: fps {N_1080 / dt6h:.4f}  kbps "
          f"{len(s6h) * 8 * 25 / N_1080 / 1000:.1f}  PSNR-Y {psnr6h:.4f} dB  "
          f"wall {dt6h:.3f} s")
    print("    stages: " + ", ".join(f"{k} {x['s']:.3f}s"
                                    for k, x in sorted(prof6h.items())))
    sys.stdout.flush()

    # 480p, 10-bit, p6, 5 frames: the card against the plain versions on the
    # host, both on the same hybrid search (the CPU encode is told that the
    # device search is the default, as it is on the card) and the device TF
    f480 = [f.astype(np.uint16) << 2 for f in frames[:5]]
    u480, v480 = u.astype(np.uint16) << 2, v.astype(np.uint16) << 2
    opts480 = dict(dev_opts, tf_backend="device")
    rows.clear()
    PL.InterSearchPipeline.get = recording(orig_get, "cuda")
    s_c, pk_c, p_c = encode(f480, u480, v480, dev, 5, preset=6, bd=10, **opts480)
    PL.InterSearchPipeline.get = recording(orig_get, "cpu")
    orig_default = PL.device_backend_default
    PL.device_backend_default = lambda device: True
    try:
        s_h, pk_h, p_h = encode(f480, u480, v480, "cpu", 5, preset=6, bd=10,
                                **opts480)
    finally:
        PL.device_backend_default = orig_default
        PL.InterSearchPipeline.get = orig_get
    agree = tot = 0
    for (tag, idx), res in rows.items():
        if tag != "cuda" or ("cpu", idx) not in rows:
            continue
        for key, (r, _c) in res.items():
            agree += int((r == rows[("cpu", idx)][key][0]).all(1).sum())
            tot += r.shape[0]
    same = s_c == s_h and all(
        (a.recon is None) == (b.recon is None)
        and (a.recon is None or all(np.array_equal(x, y)
                                    for x, y in zip(a.recon, b.recon)))
        for a, b in zip(pk_c, pk_h))
    print(f"    480p 10-bit p6 x5: card {len(s_c)} B PSNR {p_c:.4f} dB; cpu "
          f"plain {len(s_h)} B PSNR {p_h:.4f} dB; stream and recons identical "
          f"{same}; decision rows agree {agree}/{tot}")
    if not same or tot == 0:
        fail("the card's 480p p6 encode differs from the plain versions'")
    sys.stdout.flush()

    rec = {"kernels": [
        {"name": "K1 intra_search", "route": "cuda",
         "source": "svt_av1_psy_tpu_torch/csrc/intra_search.cu",
         "replaces": "svt_av1_psy_tpu/ops/intra_search.py:357",
         "launches": launches[0], "max_abs_err": k1[0], "ms": k1[1],
         "plain_ms": k1[2]},
        {"name": "K2 ssd_grids", "route": "cuda",
         "source": "svt_av1_psy_tpu_torch/csrc/ssd_grids.cu",
         "replaces": "svt_av1_psy_tpu/ops/inter_search.py:425",
         "launches": launches[1], "max_abs_err": k2[0], "ms": k2[1],
         "plain_ms": k2[2]},
        {"name": "K3 inter_decide", "route": "cuda",
         "source": "svt_av1_psy_tpu_torch/csrc/inter_decide.cu",
         "replaces": "svt_av1_psy_tpu/ops/inter_search.py:452",
         "launches": launches[2], "max_abs_err": k3[0], "ms": k3[1],
         "plain_ms": k3[2]},
        {"name": "K4 tf", "route": "cuda",
         "source": "svt_av1_psy_tpu_torch/csrc/tf.cu",
         "replaces": "svt_av1_psy_tpu/ops/tf.py:95",
         "launches": launches[3], "max_abs_err": k4[0], "ms": k4[1],
         "plain_ms": k4[2]},
        {"name": "K5 txfm", "route": "cuda",
         "source": "svt_av1_psy_tpu_torch/csrc/txfm.cu",
         "replaces": "svt_av1_psy_tpu/ops/txfm.py:110",
         "launches": launches5[4], "max_abs_err": k5[0], "ms": k5[1],
         "plain_ms": k5[2]},
        {"name": "K6 commit", "route": "cuda",
         "source": "svt_av1_psy_tpu_torch/csrc/commit.cu",
         "replaces": "svt_av1_psy_tpu/ops/commit.py:326",
         "launches": launches5[5], "max_abs_err": k6[0], "ms": k6[1],
         "plain_ms": k6[2]},
        {"name": "K7 tpl", "route": "cuda",
         "source": "svt_av1_psy_tpu_torch/csrc/tpl.cu",
         "replaces": "svt_av1_psy_tpu/ops/tpl.py:52",
         "launches": launches6[4], "max_abs_err": k7[0], "ms": k7[1],
         "plain_ms": k7[2]},
        {"name": "K8 cdef", "route": "cuda",
         "source": "svt_av1_psy_tpu_torch/csrc/cdef.cu",
         "replaces": "svt_av1_psy_tpu/ops/filters.py:30",
         "launches": launches6[5], "max_abs_err": k8[0], "ms": k8[1],
         "plain_ms": k8[2]},
        {"name": "K9 lr_search", "route": "cuda",
         "source": "svt_av1_psy_tpu_torch/csrc/lr_search.cu",
         "replaces": "svt_av1_psy_tpu/ops/lr_search.py:136",
         "launches": launches6[6], "max_abs_err": k9[0], "ms": k9[1],
         "plain_ms": k9[2]},
    ]}
    print(card)
    print(json.dumps(rec))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
