"""The port's one device rule: an explicit `torch.device`, never a silent
substitute.

`resolve("cuda")` on a host without a card raises; nothing here falls back
to the CPU. Resolving a CUDA device also turns TF32 off for matmul and
cuDNN, so any float32 product the port leaves to PyTorch runs in full
float32 (the intra prediction bank is exact only there).
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
