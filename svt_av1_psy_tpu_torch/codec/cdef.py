"""CDEF dispatch of the port.

A twin of `svt_av1_psy_tpu/codec/cdef.py:cdef_frame` whose device branch
runs the port's K8 (`ops/filters.cdef_filter_blocks`) on the encoder's
device. The skip map, the direction search (native C, or numpy) and the
variance-adjusted strengths are the reference's own, as are the host branch
and `pick_cdef_strengths`. The device branch uploads each plane once, pads
it with CDEF_VERY_LARGE, gathers the (N, bh+4, bw+4) neighbourhoods and
scatters the filtered blocks back on the device (the reference cuts them
with one numpy slice per block), then copies the plane back: the same
values. That device part runs under a `device:cdef` stage. No branch
catches an exception.
"""

from __future__ import annotations

import numpy as np
import torch

from svt_av1_psy_tpu.codec import cdef as _ref
from svt_av1_psy_tpu.codec import mc_native
from svt_av1_psy_tpu.codec.cdef import (CDEF_VERY_LARGE,  # noqa: F401
                                        adjust_strength, find_dir_blocks,
                                        pick_cdef_strengths)
from svt_av1_psy_tpu.profiling import stage


def cdef_frame(planes, mi_skip: np.ndarray, base_q_idx: int, y_pri: int,
               y_sec: int, uv_pri: int, uv_sec: int, cdef_damping: int,
               bd: int = 8, backend: str = "host", device="cpu"):
    """Apply CDEF in place to [y, (u, v)] aligned recon planes: the
    reference's signature plus the torch `device`."""
    if backend != "device":
        return _ref.cdef_frame(planes, mi_skip, base_q_idx, y_pri, y_sec,
                               uv_pri, uv_sec, cdef_damping, bd,
                               backend="host")
    device = torch.device(device)
    coeff_shift = bd - 8
    y_sec += y_sec == 3
    uv_sec += uv_sec == 3
    damping = cdef_damping + coeff_shift
    luma = planes[0]
    H, W = luma.shape
    nb8_r, nb8_c = H // 8, W // 8
    # 8x8 skipped iff all four covering 4x4 mi units are skip
    sk = mi_skip[: nb8_r * 2, : nb8_c * 2].astype(bool)
    blk_skip = (sk[0::2, 0::2] & sk[1::2, 0::2] & sk[0::2, 1::2] & sk[1::2, 1::2])
    by, bx = np.nonzero(~blk_skip)
    if len(by) == 0:
        return
    by32 = np.ascontiguousarray(by, np.int32)
    bx32 = np.ascontiguousarray(bx, np.int32)
    nat = mc_native.cdef_find_dir_blocks(np.ascontiguousarray(luma, np.int32),
                                         by32, bx32, coeff_shift)
    if nat is not None:
        dirs, var = nat
    else:
        blocks = np.stack([luma[r * 8: r * 8 + 8, c * 8: c * 8 + 8]
                           for r, c in zip(by, bx)])
        dirs, var = find_dir_blocks(blocks, coeff_shift)
    from ..ops.filters import cdef_filter_blocks

    with stage("device:cdef"):
        r_t = torch.from_numpy(by.astype(np.int64)).to(device)
        c_t = torch.from_numpy(bx.astype(np.int64)).to(device)
        for plane, img in enumerate(planes):
            if img is None:
                continue
            pri = (y_pri if plane == 0 else uv_pri) << coeff_shift
            sec = (y_sec if plane == 0 else uv_sec) << coeff_shift
            if pri == 0 and sec == 0:
                continue
            ss = 0 if plane == 0 else 1
            bw = bh = 8 >> ss
            pdamp = sdamp = damping - (plane != 0)
            if plane == 0:
                pstr = adjust_strength(pri, var).astype(np.int32)
            else:
                pstr = np.full(len(by), pri, np.int32)
            d_used = dirs if pri > 0 else np.zeros_like(dirs)
            h, w = img.shape
            pad = torch.full((h + 4, w + 4), CDEF_VERY_LARGE, dtype=torch.int32,
                             device=device)
            pad[2:-2, 2:-2] = torch.from_numpy(
                np.ascontiguousarray(img).astype(np.int32)).to(device)
            ys = r_t[:, None] * bh + torch.arange(bh + 4, device=device)
            xs = c_t[:, None] * bw + torch.arange(bw + 4, device=device)
            nbs = pad[ys[:, :, None], xs[:, None, :]]          # (N, bh+4, bw+4)
            out = cdef_filter_blocks(
                nbs, torch.from_numpy(np.ascontiguousarray(d_used, np.int32)).to(device),
                torch.from_numpy(pstr).to(device), int(sec), pdamp, sdamp, bw, bh, bd)
            dst = pad[2:-2, 2:-2].clone()
            dst[ys[:, 2:2 + bh, None] - 2, xs[:, None, 2:2 + bw] - 2] = out
            img[:] = dst.cpu().numpy().astype(img.dtype)
