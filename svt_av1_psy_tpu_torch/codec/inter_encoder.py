"""Inter frame encoder of the port.

`InterFrameEncoder` subclasses the reference's
(`svt_av1_psy_tpu/codec/inter_encoder.py`) and overrides the five methods
that reach the reference's jax modules, and one that fails at some frame
sizes; each is the reference's body with these changes:

- `_closed_device_rows` (reference :363): runs the port's K2 + K3
  (`ops/inter_search.search_frame_np`) on `shared["torch_device"]`, with no
  `try`: a failure raises instead of falling back to the native decide.
- `_decide_jobs` (:396), `_native_decide_timed` (:497): `pad_dims` comes
  from the port's `ops/inter_search`.
- `_pre_walk_multi` (:719): `IntraDecisions` comes from the port's
  `codec/intra_rdo`.
- `_device_commit` (:634): runs the port's K5 + K6 commit
  (`ops/commit.commit_frame`) on `shared["torch_device"]`. The reference's
  `try/except` around the commit is gone: a failed commit raises and never
  falls back to the host walk.
- `_warp_pred` (:1275) and `_warp_upgrade_dec` (:1307): a luma leaf that
  crosses the right or bottom edge of the 8-aligned frame (the forced rect
  edge leaves where an edge superblock holds 24 columns or 16 rows, e.g.
  854 wide or 144 high) is warped block by block, as chroma already is,
  instead of being cut from the whole-plane warp, which ends at the
  8-aligned edge. The reference's cut is shorter than the leaf and it
  raises on the shape mismatch (preset <= 6 with a global-motion model);
  inside the frame the two predictions are the same pixels.

Reference modules are imported absolutely; `ops` and `codec.intra_rdo`
resolve to the port's twins.
"""

from __future__ import annotations

import numpy as np

from svt_av1_psy_tpu.codec import inter_encoder as _ref
from svt_av1_psy_tpu.codec import mc_native
from svt_av1_psy_tpu.codec.constants import (BLOCK_HEIGHT, BLOCK_WIDTH,
                                             PartitionType)
from svt_av1_psy_tpu.codec.intra_encoder import _BSIZE_BY_WH, _partition_subsize
from svt_av1_psy_tpu.codec.mv_pred import ALTREF_FRAME, LAST_FRAME


class InterFrameEncoder(_ref.InterFrameEncoder):
    def _warp_pred(self, plane, px, py, pw, ph):
        """Normative warp prediction from the LAST recon: luma slices the
        whole-plane cache where the leaf lies inside it and warps the block
        itself where it crosses the 8-aligned edge."""
        if plane == 0:
            wp = self._gm_warp_luma()[py: py + ph, px: px + pw]
            if wp.shape == (ph, pw):
                return wp
            from svt_av1_psy_tpu.codec.warp import ROTZOOM, warp_plane

            ref = self.refs[LAST_FRAME][0]
            vis = ref[self.pad: self.pad + self.h, self.pad: self.pad + self.w]
            return warp_plane(ROTZOOM, self.gm_wm, self.gm_shear, vis, px, py,
                              pw, ph, 0, 0, self.bd)
        return super()._warp_pred(plane, px, py, pw, ph)

    def _warp_upgrade_dec(self, r, c, W, H, t, cost):
        """Swap the kernel's decision for GLOBALMV-warp when the warp
        prediction beats it (the reference's body, with the prediction from
        `_warp_pred`)."""
        if self.gm_wm is None or min(W, H) < 8:
            return t
        if t[0] == 1 and len(t) == 5 and int(t[2]) == _ref.GLOBALMV:
            if t[1] != LAST_FRAME:
                return t            # other refs keep identity gm (0, 0)
            mv = self._gm_block(r, c, W, H)
            return (1, LAST_FRAME, _ref.GLOBALMV, mv[0], mv[1])
        x0, y0 = c * 4, r * 4
        wp = self._warp_pred(0, x0, y0, W, H)
        src = self.src[0][y0: y0 + H, x0: x0 + W]
        sse = int(np.sum((src.astype(np.int64) - wp) ** 2))
        if sse + self._psy_cost(src, wp) < cost:
            mv = self._gm_block(r, c, W, H)
            return (1, LAST_FRAME, _ref.GLOBALMV, mv[0], mv[1])
        return t

    def _closed_device_rows(self):
        """CLOSED-LOOP device decide: the same staged K2 + K3 search the
        pipeline runs open-loop (ops/inter_search), but against this
        frame's actual reconstructed references — the open-loop rows'
        one quality gap on long pyramid intervals (source-ref costs
        cannot model recon noise; tools/ab_search.py measured -1.4 dB at
        interval 16). Synchronous: recon only exists at commit time, so
        this search cannot be prefetched; it replaces the native decide
        for the covered (square/rect, grid-aligned) jobs."""
        from ..ops.inter_search import search_frame_np
        from svt_av1_psy_tpu.codec.rd import lambda_sse_per_bit
        from svt_av1_psy_tpu.profiling import stage

        with stage("device:inter_search"):
            h, w = self.h, self.w
            src = np.asarray(self.src[0])[:h, :w]
            ref_l = np.asarray(self.me[LAST_FRAME].ref)[:h, :w]
            ref_a = (np.asarray(self.me[self.ref2].ref)[:h, :w]
                     if self.ref2 is not None else None)
            lam = 0.35 * float(lambda_sse_per_bit(self.qindex, self.bd, "p"))
            return search_frame_np(
                src, ref_l, ref_a, self.gm_mv, lam,
                float(self.psy_rd), float(self.inter_bias_pct),
                self.bd, depths=self.inter_depths,
                rect=self.inter_rect, device=self.shared["torch_device"])

    def _decide_jobs(self, jobs):
        """Decision rows + costs for (r, c, W, H) candidate jobs, from the
        prefetched device search where it covers the block (square,
        grid-aligned, depth computed on device) and the native kernel for
        the rest (forced odd-size edge leaves). Returns (res, costj) dicts
        keyed by (r, c, W, H), or None when no backend is available."""
        dr = self.shared.get("device_rows")
        if dr is None and self.shared.get("closed_device_decide"):
            dr = self._closed_device_rows()
        res, costj = {}, {}
        native_jobs = []
        if dr is not None:
            from ..ops.inter_search import pad_dims

            Hp, Wp = pad_dims(self.h, self.w)
            any_dev = False
            for (r, c, w, h) in jobs:
                dv = dr.get(w) if w == h else dr.get((w, h))
                if dv is not None and (r * 4) % h == 0 and (c * 4) % w == 0:
                    idx = (r * 4 // h) * (Wp // w) + (c * 4 // w)
                    row = [int(v) for v in dv[0][idx]]
                    if row[0] == 1 and row[2] == 15:
                        # GLOBALMV rows carry the real (subpel) global MV
                        mv = self.gm_mv if row[1] == 1 else (0, 0)
                        row[3], row[4] = int(mv[0]), int(mv[1])
                    res[(r, c, w, h)] = row
                    costj[(r, c, w, h)] = float(dv[1][idx])
                    any_dev = True
                else:
                    native_jobs.append((r, c, w, h))
            if any_dev:
                self.shared["device_fullpel"] = True
        else:
            native_jobs = list(jobs)
        if native_jobs:
            blocks = np.array([(c * 4, r * 4, w, h)
                               for (r, c, w, h) in native_jobs], np.int32)
            rows = self._native_decide(blocks)
            if rows is None:
                if dr is None or not res:
                    return None
                # no native library: code uncovered edge leaves as intra DC
                for (r, c, w, h) in native_jobs:
                    x0, y0 = c * 4, r * 4
                    blkpx = self.src[0][y0 : y0 + h, x0 : x0 + w] \
                        .astype(np.int64)
                    sse = float(((blkpx - int(blkpx.mean())) ** 2).sum())
                    res[(r, c, w, h)] = [0, 0, 0, 0, 0, 0, 0, 0]
                    costj[(r, c, w, h)] = sse
            else:
                for (r, c, w, h), row in zip(native_jobs, rows):
                    res[(r, c, w, h)] = [int(v) for v in row]
                    costj[(r, c, w, h)] = float(row[7])
        return res, costj

    def _native_decide_timed(self, blocks):
        me = self.me[LAST_FRAME]
        curq = me._cur_pyramid(self.src[0])
        from svt_av1_psy_tpu.codec.spec_tables import get_tables

        filters4 = np.ascontiguousarray(
            get_tables()._raw["interp_sub_pel_filters_4"], np.int32)
        golden = None
        ref2_gate = 4       # search ref2 when residual > (W*H) << 4
        if self.ref2 is not None:
            mg = self.me[self.ref2]
            golden = (mg.ref, mg.ref_q,
                      np.ascontiguousarray(self.refs[self.ref2][0], np.int32))
            if self.ref2 == ALTREF_FRAME:
                ref2_gate = -1  # B frame: always search the future reference
        ref_pad = np.ascontiguousarray(self.refs[LAST_FRAME][0], np.int32)
        tseed = None
        if self.seed_grid is not None:
            pr, pc = self.seed_grid
            b = np.asarray(blocks, np.int32)
            r = np.clip(b[:, 1] >> 2, 0, pr.shape[0] - 1)
            c = np.clip(b[:, 0] >> 2, 0, pr.shape[1] - 1)
            tdy = (pr[r, c].astype(np.int32) >> 3)
            tdx = (pc[r, c].astype(np.int32) >> 3)
            tseed = (np.ascontiguousarray(tdy, np.int32),
                     np.ascontiguousarray(tdx, np.int32))
        # device-search MVs as per-block seeds (long-interval frames where
        # the open-loop rows are not trusted as decisions): the dual-
        # pyramid HME already covered the +/-128 reach, so the native
        # kernel's own HME grid shrinks to a local refinement
        sr0, sr1 = self.sr
        dsr = self.shared.get("device_seed_rows")
        if dsr is not None:
            from ..ops.inter_search import pad_dims

            Hp, Wp = pad_dims(self.h, self.w)
            b = np.asarray(blocks, np.int32)
            nb = len(b)
            if tseed is None:
                tseed = (np.full(nb, np.iinfo(np.int32).max, np.int32),
                         np.full(nb, np.iinfo(np.int32).max, np.int32))
            n_seeded = 0
            for i in range(nb):
                x0, y0, w, h = (int(b[i, 0]), int(b[i, 1]),
                                int(b[i, 2]), int(b[i, 3]))
                dv = dsr.get(w) if w == h else dsr.get((w, h))
                if dv is None or (y0 % h) or (x0 % w):
                    continue
                idx = (y0 // h) * (Wp // w) + (x0 // w)
                row = dv[0][idx]
                if row[0] == 1 and row[2] >= 16:
                    # decided NEWMV / compound: first MV
                    tseed[0][i] = int(row[3]) >> 3
                    tseed[1][i] = int(row[4]) >> 3
                else:
                    # intra/zero rows stash the best single-ref MV in the
                    # mv2 slots (depth_stage row packing)
                    tseed[0][i] = int(row[5]) >> 3
                    tseed[1][i] = int(row[6]) >> 3
                n_seeded += 1
            # (shrinking the grid range when seeds cover the frame was
            # tried twice and measurably hurt at long intervals — the
            # native HME still finds better full-pel MVs than the rate-
            # weighted device grid argmin; seeds stay candidates + pruning
            # bounds only)
        return mc_native.inter_decide_frame(
            self.src[0], me.ref, me.ref_q, curq, ref_pad, self.pad, golden,
            me._filters, filters4, self.bd, sr0, self.gm_mv,
            float(self.psy_rd), blocks, ref2_gate=ref2_gate,
            search_range2=sr1, inter_bias_pct=self.inter_bias_pct,
            tseed=tseed, ref_dists=self.ref_distances)

    def _pre_walk_multi(self):
        """Inter partition RDO: evaluate every center-inside square node at
        the preset's depths (+ the forced rectangular edge leaves) in one
        native call, then a bottom-up NONE-vs-SPLIT DP with partition-rate
        bits picks the tree (the inter analog of intra_rdo's DP; reference:
        md_encode_block partition recursion, product_coding_loop.c:10862).
        Emits self.decisions (parts maps) + self.inter_dec (chosen leaves).
        Returns False to fall back to the fixed-size walk."""
        from .intra_rdo import IntraDecisions
        from svt_av1_psy_tpu.codec.rd import intra_rate_model, lambda_sse_per_bit

        dmin, dmax = self.inter_depths[0], self.inter_depths[-1]
        cands, forced, rect_jobs = [], [], []

        def collect(r, c, S):
            if r >= self.mi_rows or c >= self.mi_cols:
                return
            half = S >> 3
            has_rows = (r + half) < self.mi_rows
            has_cols = (c + half) < self.mi_cols
            bsize = _BSIZE_BY_WH[(S, S)]
            if has_rows and has_cols:
                if S <= dmax:
                    cands.append((r, c, S))
                    if self.inter_rect and S >= 16:
                        # HORZ/VERT halves of this node
                        # (product_coding_loop.c:9791)
                        rect_jobs.append((r, c, S, S >> 1))
                        rect_jobs.append((r + half, c, S, S >> 1))
                        rect_jobs.append((r, c, S >> 1, S))
                        rect_jobs.append((r, c + half, S >> 1, S))
                        if self.inter_part4 and S >= 32:
                            # HORZ_4/VERT_4 strips (>= 32: the 16x4
                            # strips' sub-4 chroma rules stay out)
                            sm = S >> 4        # strip pitch in mi units
                            for i in range(4):
                                rect_jobs.append((r + i * sm, c, S, S >> 2))
                                rect_jobs.append((r, c + i * sm, S >> 2, S))
                if S > dmin:
                    S2 = S >> 1
                    collect(r, c, S2)
                    collect(r, c + half, S2)
                    collect(r + half, c, S2)
                    collect(r + half, c + half, S2)
            elif has_cols:
                sub = _partition_subsize(bsize, PartitionType.PARTITION_HORZ)
                forced.append((r, c, sub))
                if r + half < self.mi_rows:
                    forced.append((r + half, c, sub))
            elif has_rows:
                sub = _partition_subsize(bsize, PartitionType.PARTITION_VERT)
                forced.append((r, c, sub))
                if c + half < self.mi_cols:
                    forced.append((r, c + half, sub))
            else:
                S2 = S >> 1
                collect(r, c, S2)
                collect(r, c + half, S2)
                collect(r + half, c, S2)
                collect(r + half, c + half, S2)

        sb_mi = self.sb_size >> 2
        for r0 in range(0, self.mi_rows, sb_mi):
            for c0 in range(0, self.mi_cols, sb_mi):
                collect(r0, c0, 64)

        jobs = [(r, c, S, S) for (r, c, S) in cands]
        jobs += [(r, c, int(BLOCK_WIDTH[bs]), int(BLOCK_HEIGHT[bs]))
                 for (r, c, bs) in forced]
        jobs += rect_jobs
        got = self._decide_jobs(jobs)
        if got is None:
            return False
        res, costj = got

        # 0.35x lambda: the kernel cost is SSE-only (no per-candidate rate),
        # so a full-strength lambda over-merges at high q (blurry 64x64
        # leaves on B frames); the reduced weight restores the RA-vs-LD margin
        # while keeping the preset-4 byte savings (measured on the pan set)
        lam = 0.35 * float(lambda_sse_per_bit(self.qindex, self.bd, "p"))
        rm = intra_rate_model(int(self.qindex))
        BSL = {8: 0, 16: 1, 32: 2, 64: 3}
        LEAF_BITS = 24.0   # flat mode/mv/skip overhead per coded leaf
        memo = {}

        def ncost(r, c, S):
            if r >= self.mi_rows or c >= self.mi_cols:
                return 0.0
            key = (r, c, S)
            got = memo.get(key)
            if got is not None:
                return got[0]
            half = S >> 3
            has_rows = (r + half) < self.mi_rows
            has_cols = (c + half) < self.mi_cols
            bsize = _BSIZE_BY_WH[(S, S)]
            split = 0   # chosen partition: 0 NONE, 1 SPLIT, 2 HORZ, 3 VERT
            if has_rows and has_cols:
                none_cost = np.inf
                if S <= dmax:
                    none_cost = (costj[(r, c, S, S)]
                                 + lam * (float(rm.part_none_bits[BSL[S]])
                                          + LEAF_BITS))
                split_cost = np.inf
                if S > dmin:
                    S2 = S >> 1
                    split_cost = (ncost(r, c, S2) + ncost(r, c + half, S2)
                                  + ncost(r + half, c, S2)
                                  + ncost(r + half, c + half, S2)
                                  + lam * float(rm.part_split_bits[BSL[S]]))
                horz_cost = vert_cost = np.inf
                ab_cost = [np.inf] * 4   # HORZ_A, HORZ_B, VERT_A, VERT_B
                do_ab = self.inter_ab
                if self.inter_rect and S >= 16 and S <= dmax:
                    horz_cost = (costj[(r, c, S, S >> 1)]
                                 + costj[(r + half, c, S, S >> 1)]
                                 + lam * (float(rm.part_horz_bits[BSL[S]])
                                          + 2 * LEAF_BITS))
                    vert_cost = (costj[(r, c, S >> 1, S)]
                                 + costj[(r, c + half, S >> 1, S)]
                                 + lam * (float(rm.part_vert_bits[BSL[S]])
                                          + 2 * LEAF_BITS))
                    # AB partitions (product_coding_loop.c:9791): priced
                    # from costs the job set already computed (quarter
                    # squares + rect halves) - no extra native searches
                    S2 = S >> 1

                    def q(rr, cc):
                        return costj.get((rr, cc, S2, S2))

                    combos = (
                        (q(r, c), q(r, c + half),
                         costj.get((r + half, c, S, S2))),        # HORZ_A
                        (costj.get((r, c, S, S2)),
                         q(r + half, c), q(r + half, c + half)),  # HORZ_B
                        (q(r, c), q(r + half, c),
                         costj.get((r, c + half, S2, S))),        # VERT_A
                        (costj.get((r, c, S2, S)),
                         q(r, c + half), q(r + half, c + half)),  # VERT_B
                    )
                    for i, parts3 in enumerate(combos):
                        if not do_ab:
                            break
                        if all(p is not None for p in parts3):
                            ab_cost[i] = (float(sum(parts3))
                                          + lam * (float(rm.part_split_bits[BSL[S]])
                                                   + 3 * LEAF_BITS))
                h4_cost = v4_cost = np.inf
                if self.inter_part4 and self.inter_rect \
                        and 32 <= S <= dmax:
                    sm = S >> 4
                    h4 = [costj.get((r + i * sm, c, S, S >> 2))
                          for i in range(4)]
                    v4 = [costj.get((r, c + i * sm, S >> 2, S))
                          for i in range(4)]
                    if all(x is not None for x in h4):
                        h4_cost = (float(sum(h4))
                                   + lam * (float(rm.part_split_bits[BSL[S]])
                                            + 4 * LEAF_BITS))
                    if all(x is not None for x in v4):
                        v4_cost = (float(sum(v4))
                                   + lam * (float(rm.part_split_bits[BSL[S]])
                                            + 4 * LEAF_BITS))
                cost = none_cost
                if split_cost < cost:
                    cost, split = split_cost, 1
                if horz_cost < cost:
                    cost, split = horz_cost, 2
                if vert_cost < cost:
                    cost, split = vert_cost, 3
                for i, acst in enumerate(ab_cost):
                    if acst < cost:
                        cost, split = acst, 4 + i
                if h4_cost < cost:
                    cost, split = h4_cost, 8
                if v4_cost < cost:
                    cost, split = v4_cost, 9
            elif has_cols:
                sub = _partition_subsize(bsize, PartitionType.PARTITION_HORZ)
                w, h = int(BLOCK_WIDTH[sub]), int(BLOCK_HEIGHT[sub])
                cost = costj[(r, c, w, h)] + lam * LEAF_BITS
                if r + half < self.mi_rows:
                    cost += costj[(r + half, c, w, h)] + lam * LEAF_BITS
            elif has_rows:
                sub = _partition_subsize(bsize, PartitionType.PARTITION_VERT)
                w, h = int(BLOCK_WIDTH[sub]), int(BLOCK_HEIGHT[sub])
                cost = costj[(r, c, w, h)] + lam * LEAF_BITS
                if c + half < self.mi_cols:
                    cost += costj[(r, c + half, w, h)] + lam * LEAF_BITS
            else:
                S2 = S >> 1
                cost = (ncost(r, c, S2) + ncost(r, c + half, S2)
                        + ncost(r + half, c, S2)
                        + ncost(r + half, c + half, S2))
            memo[key] = (cost, split)
            return cost

        for r0 in range(0, self.mi_rows, sb_mi):
            for c0 in range(0, self.mi_cols, sb_mi):
                ncost(r0, c0, 64)

        parts = {}
        for S in self.inter_depths:
            if S > dmin:
                gr = -((-self.mi_rows * 4) // S)
                gc = -((-self.mi_cols * 4) // S)
                parts[S] = np.zeros((gr, gc), bool)
        rects = {}
        if self.inter_rect:
            # all sizes 16..dmax: frame-corner nodes recurse below dmin,
            # so rect choices can appear at any node size
            S = 16
            while S <= dmax:
                gr = -((-self.mi_rows * 4) // S)
                gc = -((-self.mi_cols * 4) // S)
                rects[S] = np.zeros((gr, gc), np.uint8)
                S <<= 1
        dec_map = {}

        def extract(r, c, S):
            if r >= self.mi_rows or c >= self.mi_cols:
                return
            half = S >> 3
            has_rows = (r + half) < self.mi_rows
            has_cols = (c + half) < self.mi_cols
            bsize = _BSIZE_BY_WH[(S, S)]
            if has_rows and has_cols:
                part = memo[(r, c, S)][1] if S <= dmax else 1
                if part >= 8:         # HORZ_4/VERT_4: four strips
                    rects[S][(r * 4) // S, (c * 4) // S] = part
                    sm = S >> 4
                    if part == 8:
                        geoms4 = tuple(((r + i * sm, c), S, S >> 2)
                                       for i in range(4))
                    else:
                        geoms4 = tuple(((r, c + i * sm), S >> 2, S)
                                       for i in range(4))
                    for ((rr, cc), w_, h_) in geoms4:
                        t = self._dec_from_row(res[(rr, cc, w_, h_)])
                        if self.gm_wm is not None:
                            t = self._warp_upgrade_dec(
                                rr, cc, w_, h_, t, costj[(rr, cc, w_, h_)])
                        dec_map[(rr, cc)] = t
                        self.leaf_geom[(rr, cc)] = (w_, h_)
                elif part >= 4:       # AB: two quarters + one rect half
                    rects[S][(r * 4) // S, (c * 4) // S] = part
                    S2 = S >> 1
                    geoms3 = {
                        4: (((r, c), S2, S2), ((r, c + half), S2, S2),
                            ((r + half, c), S, S2)),
                        5: (((r, c), S, S2), ((r + half, c), S2, S2),
                            ((r + half, c + half), S2, S2)),
                        6: (((r, c), S2, S2), ((r + half, c), S2, S2),
                            ((r, c + half), S2, S)),
                        7: (((r, c), S2, S), ((r, c + half), S2, S2),
                            ((r + half, c + half), S2, S2)),
                    }[part]
                    for ((rr, cc), w_, h_) in geoms3:
                        t = self._dec_from_row(res[(rr, cc, w_, h_)])
                        if self.gm_wm is not None:
                            t = self._warp_upgrade_dec(
                                rr, cc, w_, h_, t, costj[(rr, cc, w_, h_)])
                        dec_map[(rr, cc)] = t
                        self.leaf_geom[(rr, cc)] = (w_, h_)
                elif part >= 2:
                    rects[S][(r * 4) // S, (c * 4) // S] = part
                    if part == 2:     # HORZ: two SxS/2 leaves
                        geoms = ((r, c), (r + half, c))
                        w_, h_ = S, S >> 1
                    else:             # VERT
                        geoms = ((r, c), (r, c + half))
                        w_, h_ = S >> 1, S
                    for (rr, cc) in geoms:
                        t = self._dec_from_row(res[(rr, cc, w_, h_)])
                        if self.gm_wm is not None:
                            t = self._warp_upgrade_dec(
                                rr, cc, w_, h_, t, costj[(rr, cc, w_, h_)])
                        dec_map[(rr, cc)] = t
                        self.leaf_geom[(rr, cc)] = (w_, h_)
                elif S > dmin and part == 1:
                    p = parts.get(S)
                    if p is not None:
                        p[(r * 4) // S, (c * 4) // S] = True
                    S2 = S >> 1
                    extract(r, c, S2)
                    extract(r, c + half, S2)
                    extract(r + half, c, S2)
                    extract(r + half, c + half, S2)
                else:
                    t = self._dec_from_row(res[(r, c, S, S)])
                    if self.gm_wm is not None:
                        t = self._warp_upgrade_dec(r, c, S, S, t,
                                                   costj[(r, c, S, S)])
                    dec_map[(r, c)] = t
                    self.leaf_geom[(r, c)] = (S, S)
            elif has_cols:
                sub = _partition_subsize(bsize, PartitionType.PARTITION_HORZ)
                w, h = int(BLOCK_WIDTH[sub]), int(BLOCK_HEIGHT[sub])
                for (rr, cc) in (((r, c),) + (((r + half, c),)
                                 if r + half < self.mi_rows else ())):
                    t = self._dec_from_row(res[(rr, cc, w, h)])
                    if self.gm_wm is not None:
                        t = self._warp_upgrade_dec(rr, cc, w, h, t,
                                                   costj[(rr, cc, w, h)])
                    dec_map[(rr, cc)] = t
                    self.leaf_geom[(rr, cc)] = (w, h)
            elif has_rows:
                sub = _partition_subsize(bsize, PartitionType.PARTITION_VERT)
                w, h = int(BLOCK_WIDTH[sub]), int(BLOCK_HEIGHT[sub])
                for (rr, cc) in (((r, c),) + (((r, c + half),)
                                 if c + half < self.mi_cols else ())):
                    t = self._dec_from_row(res[(rr, cc, w, h)])
                    if self.gm_wm is not None:
                        t = self._warp_upgrade_dec(rr, cc, w, h, t,
                                                   costj[(rr, cc, w, h)])
                    dec_map[(rr, cc)] = t
                    self.leaf_geom[(rr, cc)] = (w, h)
            else:
                S2 = S >> 1
                extract(r, c, S2)
                extract(r, c + half, S2)
                extract(r + half, c, S2)
                extract(r + half, c + half, S2)

        for r0 in range(0, self.mi_rows, sb_mi):
            for c0 in range(0, self.mi_cols, sb_mi):
                extract(r0, c0, 64)

        self._refine_fullpel(dec_map)
        self._third_ref_rescue(dec_map, costj)
        dec_obj = IntraDecisions(parts=parts, modes={}, tx_types={},
                                 max_leaf=dmax, min_leaf=dmin, rect=rects)
        self.decisions = dec_obj
        self.inter_dec = dec_map
        self._inter_tx_search()
        self.shared["inter_dec"] = dec_map
        self.shared["inter_decisions"] = dec_obj
        return True

    def _device_commit(self):
        """Device residual commit (ops/commit.py): batch-run pred/TX/
        quant/recon for the decided inter leaves on the torch device; the
        C walk then only does syntax + range coding for them."""
        want = self.device_commit
        if want is None:
            # "auto" resolves to off, as in the reference
            want = False
        if want and self.plane_dq[1:3] != self.plane_dq[3:5]:
            # the device commit shares one chroma quant row for u and v;
            # per-plane u != v deltas (chroma_*_qindex_offset) take the
            # host walk instead
            want = False
        if not want or getattr(self, "inter_dec", None) is None:
            return
        from svt_av1_psy_tpu.codec import walk_native

        if not walk_native.eligible(self):
            return
        from svt_av1_psy_tpu.profiling import stage

        if "pre_commit" in self.shared:    # LR re-encode / later tiles
            res = self.shared["pre_commit"]
        else:
            from ..ops.commit import commit_frame

            # exclusive profiling: the device:* sub-stages inside
            # commit_frame account the device time; this span is host glue
            with stage("host:commit_glue"):
                res = commit_frame(self)
            self.shared["pre_commit"] = res
        if res is None:
            return
        self.pre_commit = res
        for p in range(self.nplanes):
            self.planes[p].recon[:] = res.recon[p]
