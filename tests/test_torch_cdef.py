"""K8 (the batched CDEF filter) and the port's CDEF dispatch against the JAX
package and the reference's host CDEF on the CPU.

CDEF is integer throughout, so the plain version must equal the JAX program
and the host filter bit for bit.
"""

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu.codec.cdef import CDEF_VERY_LARGE, adjust_strength
from svt_av1_psy_tpu.codec.cdef import cdef_frame as ref_cdef_frame
from svt_av1_psy_tpu.codec.cdef import filter_blocks as cdef_host
from svt_av1_psy_tpu.ops.filters import cdef_filter_blocks as cdef_jax
from svt_av1_psy_tpu_torch.codec.cdef import cdef_frame
from svt_av1_psy_tpu_torch.ops import filters as F

torch.set_num_threads(2)


def _case(rng, N, bw, bh, bd):
    peak = (1 << bd) - 1
    nb = rng.integers(0, peak + 1, (N, bh + 4, bw + 4)).astype(np.int32)
    nb[0, :2, :] = CDEF_VERY_LARGE            # unavailable borders
    nb[1, :, :2] = CDEF_VERY_LARGE
    nb[2, -2:, :] = CDEF_VERY_LARGE
    nb[3, :, -2:] = CDEF_VERY_LARGE
    # smooth blocks, so the constrain's thresholds bite
    base = rng.integers(0, peak + 1, (N, 1, 1))
    nb[N // 2:] = np.where(nb[N // 2:] == CDEF_VERY_LARGE, CDEF_VERY_LARGE,
                           np.clip(base[N // 2:] + rng.integers(
                               -12 << (bd - 8), 13 << (bd - 8),
                               (N - N // 2, bh + 4, bw + 4)), 0, peak))
    dirs = rng.integers(0, 8, N).astype(np.int32)
    var = rng.integers(0, 40000, N).astype(np.int64)
    return nb.astype(np.int32), dirs, var


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("luma", [True, False])
def test_k8_plain_equals_jax_and_host(bd, luma):
    """Luma 8x8 with variance-adjusted per-block primary strengths, chroma
    4x4 with one strength; secondary strengths 0, 1, 2, 4 (<< bd - 8), and
    primary 0; every JAX result also equals the host numpy filter."""
    rng = np.random.default_rng(bd * 2 + luma)
    bw = bh = 8 if luma else 4
    N = 40
    nb, dirs, var = _case(rng, N, bw, bh, bd)
    damp = 5 + (bd - 8) - (0 if luma else 1)
    shift = bd - 8
    for pri in (0, 2, 4):
        p = pri << shift
        if luma:
            pstr = adjust_strength(p, var).astype(np.int32)
        else:
            pstr = np.full(N, p, np.int32)
        d_used = dirs if p > 0 else np.zeros_like(dirs)
        for sec in (0, 1, 2, 4):
            s = sec << shift
            want = np.asarray(cdef_jax(nb, d_used, pstr, s, damp, damp, bw, bh, bd))
            got = F.cdef_filter_blocks(torch.from_numpy(nb), torch.from_numpy(d_used),
                                       torch.from_numpy(pstr), s, damp, damp,
                                       bw, bh, bd).numpy()
            assert np.array_equal(got, want), (pri, sec)
            host = cdef_host(nb, d_used, pstr, s, damp, damp, bw, bh, bd)
            assert np.array_equal(want, host), (pri, sec)


def _planes(rng, H, W, bd):
    peak = (1 << bd) - 1
    y = (np.cumsum(rng.normal(0, 4 << (bd - 8), (H, W)), axis=1)
         + (128 << (bd - 8)) + rng.normal(0, 3 << (bd - 8), (H, W)))
    u = np.cumsum(rng.normal(0, 3 << (bd - 8), (H // 2, W // 2)), axis=0) \
        + (120 << (bd - 8))
    dt = np.uint8 if bd == 8 else np.uint16
    return [np.clip(p, 0, peak).astype(dt) for p in (y, u, u[::-1] + 3)]


@pytest.mark.parametrize("bd,strengths", [
    (8, (4, 2, 2, 1)), (10, (2, 3, 4, 0)), (8, (0, 2, 0, 1)), (10, (1, 0, 0, 0)),
])
def test_cdef_frame_equals_reference_host(bd, strengths):
    """The port's device branch (K8 plain, neighbourhoods gathered and
    scattered in torch) equals the reference's host CDEF (native C where it
    builds, numpy otherwise) on whole planes with a random skip map."""
    rng = np.random.default_rng(bd + sum(strengths))
    H, W = 72, 96
    planes = _planes(rng, H, W, bd)
    mi_skip = (rng.random((H // 4, W // 4)) < 0.3).astype(np.uint8)
    y_pri, y_sec, uv_pri, uv_sec = strengths
    want = [p.copy() for p in planes]
    ref_cdef_frame(want, mi_skip, 120, y_pri, y_sec, uv_pri, uv_sec, 4, bd,
                   backend="host")
    got = [p.copy() for p in planes]
    before = F.calls["plain"]
    cdef_frame(got, mi_skip, 120, y_pri, y_sec, uv_pri, uv_sec, 4, bd,
               backend="device", device="cpu")
    for g, w, p in zip(got, want, planes):
        assert g.dtype == p.dtype
        assert np.array_equal(g, w)
    assert any(not np.array_equal(w, p) for w, p in zip(want, planes))
    n_planes = int(bool(y_pri or y_sec)) + 2 * int(bool(uv_pri or uv_sec))
    assert F.calls["plain"] == before + n_planes


def test_cdef_host_backend_and_all_skip():
    """backend host runs the reference's host filter (no K8 call); an
    all-skip frame is left as it is."""
    rng = np.random.default_rng(3)
    planes = _planes(rng, 64, 64, 8)
    before = dict(F.calls)
    got = [p.copy() for p in planes]
    cdef_frame(got, np.zeros((16, 16), np.uint8), 100, 2, 1, 2, 1, 4, 8,
               backend="host", device="cpu")
    want = [p.copy() for p in planes]
    ref_cdef_frame(want, np.zeros((16, 16), np.uint8), 100, 2, 1, 2, 1, 4, 8)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    got = [p.copy() for p in planes]
    cdef_frame(got, np.ones((16, 16), np.uint8), 100, 2, 1, 2, 1, 4, 8,
               backend="device", device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(got, planes))
    assert F.calls == before


@pytest.mark.parametrize("kernel", ["K7", "K8", "K9"])
def test_wrappers_run_plain_only_on_cpu_tensors(kernel):
    """The K7-K9 wrappers take the plain version only for CPU tensors: a
    tensor on any other device (here "meta") raises before any launch or
    plain call, as a CUDA tensor launches the kernel or raises."""
    from svt_av1_psy_tpu_torch.ops import lr_search, tpl

    meta = lambda *shape, dt=torch.int32: torch.empty(shape, dtype=dt,
                                                      device="meta")
    mod, call = {
        "K7": (tpl, lambda: tpl.tpl_intra_stage(meta(64, 64, dt=torch.float32),
                                                64, 64)),
        "K8": (F, lambda: F.cdef_filter_blocks(meta(4, 12, 12), meta(4), meta(4),
                                               0, 3, 3, 8, 8, 8)),
        "K9": (lr_search, lambda: lr_search.sgr_stats(meta(64, 64), meta(64, 64),
                                                      64, 8, (0,))),
    }[kernel]
    before = dict(mod.calls)
    with pytest.raises(ValueError, match=kernel):
        call()
    assert mod.calls == before
