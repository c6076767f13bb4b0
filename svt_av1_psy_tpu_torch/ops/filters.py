"""Kernel K8: the batched CDEF filter (`csrc/cdef.cu`).

Replaces `svt_av1_psy_tpu/ops/filters.py:cdef_filter_blocks`, the batched
mirror of `codec/cdef.filter_blocks`: per non-skipped block, the primary
taps along its direction and the secondary taps along direction +/- 2 with
the damped constrain, the rounded sum, and the clip to the taps' range
(CDEF_VERY_LARGE borders left out of the max). Integer throughout: the
kernel, the plain version and the JAX program agree bit for bit.

Bound on the H100: memory traffic of the neighbourhoods (one thread per
output pixel; 12 taps per pixel from cache).

The JAX module's other programs (`_convolve_2d`, `_wiener_block`) are used
by tests only and are not ported yet.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from svt_av1_psy_tpu.codec.cdef import (_DIRS, _PRI_TAPS, _SEC_TAPS,
                                        CDEF_VERY_LARGE)

from . import _build

_I32 = torch.int32

calls = {"kernel": 0, "plain": 0}


def _msb(x):
    """floor(log2(max(x, 1))) of a non-negative int32 tensor (31 - clz)."""
    return sum(((x >> k) > 0).to(x.dtype) for k in range(1, 31))


def _constrain(d, th, shift):
    ad = d.abs()
    con = torch.sign(d) * torch.minimum(ad, torch.clamp(th - (ad >> shift), min=0))
    return torch.where(th == 0, torch.zeros_like(con), con)


# ------------------------------------------------------------ plain version
def cdef_filter_blocks_ref(nb, dirs, pri_strength, sec_strength: int,
                           pri_damping: int, sec_damping: int, bw: int,
                           bh: int, bd: int):
    """Plain version: nb (N, bh+4, bw+4) int32, dirs (N,) and pri_strength
    (N,) int32 -> (N, bh, bw) int32."""
    dev = nb.device
    N = nb.shape[0]
    x = nb[:, 2:2 + bh, 2:2 + bw]
    pri = pri_strength.to(_I32).reshape(N)
    dirs = dirs.to(torch.int64).reshape(N)
    tap_idx = ((pri >> (bd - 8)) & 1).to(torch.int64)
    dirs_tab = torch.from_numpy(_DIRS.astype(np.int64)).to(dev)
    pri_taps = torch.from_numpy(_PRI_TAPS).to(dev)
    sec_taps = torch.from_numpy(_SEC_TAPS).to(dev)
    rows = torch.arange(bh, device=dev)[None, :, None] + 2
    cols = torch.arange(bw, device=dev)[None, None, :] + 2
    bi = torch.arange(N, device=dev)[:, None, None]

    def at(dy, dx):
        return nb[bi, rows + dy[:, None, None], cols + dx[:, None, None]]

    th_p = pri[:, None, None]
    shift_p = torch.clamp(pri_damping - _msb(th_p), min=0)
    sec = torch.tensor(int(sec_strength), dtype=_I32, device=dev)
    shift_s = max(0, sec_damping - max(int(sec_strength).bit_length() - 1, 0))
    very_large = torch.tensor(CDEF_VERY_LARGE, dtype=_I32, device=dev)
    sum_ = torch.zeros((N, bh, bw), dtype=_I32, device=dev)
    mx = x.clone()
    mn = x.clone()

    def minmax(p):
        nonlocal mx, mn
        mx = torch.maximum(mx, torch.where(p == very_large, mx, p))
        mn = torch.minimum(mn, p)

    for k in range(2):
        ptap = pri_taps[tap_idx, k][:, None, None]
        stap = sec_taps[tap_idx, k][:, None, None]
        dy, dx = dirs_tab[dirs, k, 0], dirs_tab[dirs, k, 1]
        for sgn in (1, -1):
            p = at(sgn * dy, sgn * dx)
            sum_ += ptap * _constrain(p - x, th_p, shift_p)
            minmax(p)
        for delta in (2, -2):
            d2 = (dirs + delta) & 7
            sdy, sdx = dirs_tab[d2, k, 0], dirs_tab[d2, k, 1]
            for sgn in (1, -1):
                s = at(sgn * sdy, sgn * sdx)
                sum_ += stap * _constrain(s - x, sec, shift_s)
                minmax(s)
    y = x + ((8 + sum_ - (sum_ < 0).to(_I32)) >> 4)
    return torch.minimum(torch.maximum(y, mn), mx)


# ------------------------------------------------------------ the kernel
@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("cdef")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cdef_launch.argtypes = [P] * 6 + [I] * 7 + [P, P]
    lib.cdef_launch.restype = ctypes.c_int
    return lib


def cdef_filter_blocks(nb, dirs, pri_strength, sec_strength: int,
                       pri_damping: int, sec_damping: int, bw: int, bh: int,
                       bd: int):
    """K8: the kernel for CUDA tensors, the plain version for CPU tensors."""
    if not _build.on_cuda(nb, "K8"):
        _build.count(calls, "plain")
        return cdef_filter_blocks_ref(nb, dirs, pri_strength, sec_strength,
                                      pri_damping, sec_damping, bw, bh, bd)
    dev = nb.device
    N = nb.shape[0]
    for t, shape in ((nb, (N, bh + 4, bw + 4)), (dirs, (N,)),
                     (pri_strength, (N,))):
        _build.need(t, shape, _I32, dev, "K8")
    out = torch.empty((N, bh, bw), dtype=_I32, device=dev)
    P = _build.ptr
    tabs = [_build.table(k, a, dev) for k, a in (("cdef_dirs", _DIRS),
                                                 ("cdef_pri_taps", _PRI_TAPS),
                                                 ("cdef_sec_taps", _SEC_TAPS))]
    rc = _lib().cdef_launch(P(nb), P(dirs), P(pri_strength),
                            *[P(t) for t in tabs], N, int(sec_strength),
                            int(pri_damping), int(sec_damping), int(bw), int(bh),
                            int(bd), P(out), _build.stream(dev))
    _build.check(rc, "cdef_launch")
    _build.count(calls, "kernel")
    return out
