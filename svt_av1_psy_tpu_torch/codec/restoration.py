"""Loop-restoration search dispatch of the port.

A twin of `svt_av1_psy_tpu/codec/restoration.py:pick_lr` whose device
branch runs the port's K9 SGR sweep (`ops/lr_search.sgr_search_units`) on
the encoder's device, under a `device:lr_search` stage. Unlike the
reference, the sweep is not wrapped in a `try` that falls back to the host
search: a failure raises. The per-unit Wiener solve, the exact SGR and
Wiener filters, the SSE compare and the frame-type choice are the
reference's own host code; `apply_restoration` and the other names are
re-exported from the reference unchanged.
"""

from __future__ import annotations

import numpy as np

from svt_av1_psy_tpu.codec.restoration import (  # noqa: F401
    BORDER, RESTORE_NONE, RESTORE_SGRPROJ, RESTORE_SWITCHABLE, RESTORE_WIENER,
    PlaneRestoration, _solve_taps, apply_restoration, filter_unit,
    save_boundary_rows)
from svt_av1_psy_tpu.profiling import stage


def pick_lr(src_plane, cdef_plane, deblock_plane, crop_w, crop_h, ss,
            bd: int = 8, unit_size: int = 64,
            enable_sgr: bool = True, sgr_eps_step: int = 1,
            backend: str = "host", device="cpu") -> PlaneRestoration:
    """Per-unit restoration search, the reference's `pick_lr` plus the torch
    `device`: backend="device" picks each unit's SGR ep with K9, and the
    exact host filter and SSE then decide the unit."""
    if sgr_eps_step <= 0:
        enable_sgr = False
        sgr_eps_step = 1
    pr = PlaneRestoration(crop_w, crop_h, ss, unit_size)
    crop = np.asarray(cdef_plane)[:crop_h, :crop_w].astype(np.int64)
    ext = np.pad(crop, BORDER, mode="edge")
    above, below = save_boundary_rows(np.asarray(deblock_plane), crop,
                                      crop_w, crop_h, ss)
    src = np.asarray(src_plane)[:crop_h, :crop_w].astype(np.int64)
    dev_sgr = None
    if enable_sgr and backend == "device":
        from ..ops.lr_search import sgr_search_units

        with stage("device:lr_search"):
            dev_sgr = sgr_search_units(src, crop, pr, bd,
                                       eps=range(0, 16, sgr_eps_step),
                                       device=device)
    kinds = set()
    for ui in range(pr.vunits):
        for uj in range(pr.hunits):
            v0, v1, h0, h1 = pr.unit_limits(ui, uj)
            # decoder-compat guard (the reference's): merged chroma units
            # stay RESTORE_NONE (dav1d 1.0.0 crashes filtering them)
            if ss and (h1 - h0 > pr.size or v1 - v0 > pr.size):
                continue
            s = src[v0:v1, h0:h1]
            base_sse = int(((crop[v0:v1, h0:h1] - s) ** 2).sum())
            # near-lossless unit: no restoration tool can pay for its
            # coefficients (sub-1/16-px avg error) -> skip the search
            if base_sse < (s.size >> 4):
                continue
            taps = _solve_taps(ext[v0: v1 + 6, h0: h1 + 6], s, chroma=ss > 0)
            info = ("W", taps)
            filt = filter_unit(ext, pr, above, below, v0, v1, h0, h1, info, bd)
            sse = int(((filt - s) ** 2).sum())
            if enable_sgr:
                if dev_sgr is not None:
                    ep, xqd, _ = dev_sgr[(ui, uj)]
                else:
                    from svt_av1_psy_tpu.codec.sgr import search_sgr_unit

                    ep, xqd, _ = search_sgr_unit(
                        s, ext[v0: v1 + 6, h0: h1 + 6], h1 - h0, v1 - v0,
                        bd, eps=range(0, 16, sgr_eps_step))
                sinfo = ("S", ep, xqd)
                sfilt = filter_unit(ext, pr, above, below, v0, v1, h0, h1,
                                    sinfo, bd)
                ssse = int(((sfilt - s) ** 2).sum())
                if ssse < sse:
                    info, sse = sinfo, ssse
            # small margin so near-ties do not pay the coefficient cost
            if sse + (base_sse >> 8) < base_sse:
                pr.unit_info[ui][uj] = info
                kinds.add(info[0])
    if not kinds:
        pr.frame_type = RESTORE_NONE
    elif kinds == {"W"}:
        pr.frame_type = RESTORE_WIENER
    elif kinds == {"S"}:
        pr.frame_type = RESTORE_SGRPROJ
    else:
        pr.frame_type = RESTORE_SWITCHABLE
    return pr
