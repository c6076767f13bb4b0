"""Temporal filtering dispatch of the port.

A twin of `svt_av1_psy_tpu/codec/temporal_filter.py:temporal_filter` whose
device branch runs the port's K2 + K4 (`ops/tf.temporal_filter_device`) on
the encoder's device. The host branch is the reference's own per-block
filter. "auto" picks the device branch when the device is CUDA; frames with
min(dim) < 64 always take the host branch, as in the reference. No branch
catches an exception.
"""

from __future__ import annotations

import numpy as np
import torch

from svt_av1_psy_tpu.codec import temporal_filter as _ref


def temporal_filter(center, neighbors, strength: int, bd: int = 8,
                    backend: str = "auto", device="cpu"):
    """Filter one source picture against neighbour source pictures; the
    reference's signature plus the torch `device`."""
    cy, cu, cv = center
    if strength <= 0 or not neighbors:
        return cy, cu, cv
    if backend != "host" and min(np.asarray(cy).shape) >= 64:
        if backend == "device" or torch.device(device).type == "cuda":
            from svt_av1_psy_tpu.profiling import stage as _st

            from ..ops.tf import temporal_filter_device

            with _st("device:tf"):
                return temporal_filter_device(center, neighbors, strength, bd,
                                              device=device)
    return _ref.temporal_filter(center, neighbors, strength, bd,
                                backend="host")
