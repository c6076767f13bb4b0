"""TPL dispatch of the port.

A twin of `svt_av1_psy_tpu/rc/tpl.py:tpl_analysis` whose device branch runs
the port's K2 + K7 cost pass (`ops/tpl.tpl_group_stats`) on the encoder's
device, under the same `device:tpl` stage. "auto" picks the device branch
when the device is CUDA. Frames of 720 lines or more run at half
resolution, and groups whose (decimated) frames have min(dim) < 64 take the
host branch, as in the reference. The host branch, the propagation and the
qindex consumers are the reference's own. No branch catches an exception.
"""

from __future__ import annotations

import numpy as np
import torch

from svt_av1_psy_tpu.codec.me import decimate
from svt_av1_psy_tpu.profiling import stage
from svt_av1_psy_tpu.rc import tpl as _ref
from svt_av1_psy_tpu.rc.tpl import (BLK, _propagate, tpl_qindex,  # noqa: F401
                                    tpl_sb_qindex_map)


def tpl_analysis(frames: list, bd: int = 8, backend: str = "host",
                 device="cpu"):
    """The reference's `tpl_analysis` plus the torch `device`. Returns (r0,
    beta_map, unit_px)."""
    if backend != "host" and (backend == "device"
                              or torch.device(device).type == "cuda"):
        luma = [np.asarray(f) >> (bd - 8) for f in frames]
        unit_px = BLK
        if luma[0].shape[0] >= 720:
            luma = [decimate(f, 1) for f in luma]
            unit_px = BLK * 2
        if min(luma[0].shape) >= 64:
            from ..ops.tpl import tpl_group_stats

            with stage("device:tpl"):
                stats = tpl_group_stats(luma, device=device)
            return _propagate(stats, len(luma), unit_px)
    return _ref.tpl_analysis(frames, bd, backend="host")
