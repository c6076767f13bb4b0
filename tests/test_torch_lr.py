"""K9 (the SGRPROJ sweep's statistics), its host driver and the port's
`pick_lr` against the JAX package on the CPU.

The port's box sums, filters and tile sums are exact integers. The JAX
program multiplies in float32 and sums each tile in float32, so the two
agree to a tolerance: for the sum S_ij of f_i f_j over a tile, |port - JAX|
<= 1e-5 * sqrt(S_ii S_jj) (the Cauchy-Schwarz bound of |S_ij|, so S_ii
itself on the diagonal). The A/B transform's z index rounds in float32 as
the JAX program rounds it, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_av1_psy_tpu.codec import sgr as S
from svt_av1_psy_tpu.codec.restoration import PlaneRestoration
from svt_av1_psy_tpu.codec.restoration import pick_lr as ref_pick_lr
from svt_av1_psy_tpu.ops import lr_search as JL
from svt_av1_psy_tpu_torch.codec.restoration import pick_lr
from svt_av1_psy_tpu_torch.ops import lr_search as L

torch.set_num_threads(2)

RTOL = 1e-5
_DIAG = (0, 0, 2, 0, 2, 5)       # S_ii, S_jj of each of the six sums
_OTHER = (0, 2, 2, 5, 5, 5)


def _planes(seed, H, W, bd, noise=9):
    rng = np.random.default_rng(seed)
    peak = (1 << bd) - 1
    src = (np.cumsum(rng.normal(0, 5 << (bd - 8), (H, W)), axis=1)
           + (128 << (bd - 8))).clip(0, peak).astype(np.int64)
    n = noise << (bd - 8)
    dgd = np.clip(src + rng.integers(-n, n + 1, (H, W)), 0, peak)
    return src, dgd


def _blocky(seed, H, W, bd, noise=6, blk=5):
    """Piecewise-constant planes with Gaussian noise: the edge-preserving
    self-guided filter beats Wiener on most units."""
    rng = np.random.default_rng(seed)
    peak = (1 << bd) - 1
    levels = rng.integers(30, 220, (H // blk + 1, W // blk + 1))
    src = np.kron(levels, np.ones((blk, blk), np.int64))[:H, :W] << (bd - 8)
    noisy = src + rng.normal(0, noise << (bd - 8), (H, W)).round()
    return src, np.clip(noisy, 0, peak).astype(np.int64)


def _jax_stats(src, dgd, T, bd, eps):
    H, W = src.shape
    return np.asarray(JL._sgr_stats(
        jax.device_put(src.astype(np.int32)), jax.device_put(dgd.astype(np.int32)),
        H=H, W=W, T=T, bd=bd, eps=tuple(eps))).astype(np.float64)


@pytest.mark.parametrize("H,W,T,bd,step", [
    (72, 100, 32, 8, 2),       # partial edge tiles, the 8 eps of preset 6
    (90, 130, 64, 10, 1),      # 10-bit, all 16 eps
    (64, 64, 64, 10, 2),       # one whole tile
])
def test_k9_plain_equals_jax_within_tolerance(H, W, T, bd, step):
    eps = tuple(range(0, 16, step))
    src, dgd = _planes(bd + H, H, W, bd)
    want = _jax_stats(src, dgd, T, bd, eps)
    got = L.sgr_stats(torch.from_numpy(src.astype(np.int32)),
                      torch.from_numpy(dgd.astype(np.int32)), T, bd, eps).numpy()
    assert got.shape == want.shape == (len(eps), 6, -(-H // T), -(-W // T))
    assert got.dtype == np.float64
    assert np.array_equal(got, np.round(got))             # exact integers
    scale = np.sqrt(got[:, _DIAG] * got[:, _OTHER])
    assert np.all(np.abs(got - want) <= RTOL * np.maximum(scale, 1.0))
    # radius-0 halves of the parameter sets contribute zeros
    for i, ep in enumerate(eps):
        r0, r1, _, _ = S.SGR_PARAMS[ep]
        if r0 == 0:
            assert not got[i, (0, 1, 3)].any()
        if r1 == 0:
            assert not got[i, (1, 2, 4)].any()


def test_z_index_bit_equal_to_jax_float32():
    """The port's z index equals `_ab_transform_j`'s float32 expression on
    p values spread over 0..2^26 (A/B grids of 10-bit content reach ~1e7),
    for every s of SGR_PARAMS; it differs from the exact integer index by
    at most 1, and does so somewhere (the reference's documented drift)."""
    rng = np.random.default_rng(0)
    p = np.concatenate([rng.integers(0, 1 << 26, 20000),
                        rng.integers(0, 1 << 14, 2000)]).astype(np.int32)
    drift = 0
    for s in sorted({x for row in S.SGR_PARAMS for x in row[2:] if x > 0}):
        want = np.asarray(jnp.floor(
            (jnp.asarray(p).astype(jnp.float32) * float(s)
             + float(1 << (S.SGRPROJ_MTABLE_BITS - 1)))
            / float(1 << S.SGRPROJ_MTABLE_BITS)).astype(jnp.int32))
        got = L.ab_z_index(torch.from_numpy(p), s).numpy()
        assert np.array_equal(got, want), s
        exact = S._rpot(p.astype(np.int64) * s, S.SGRPROJ_MTABLE_BITS)
        assert np.abs(got - exact).max() <= 1
        drift += int((got != exact).sum())
    assert drift > 0


@pytest.mark.parametrize("r,s,bd", [(2, 140, 8), (1, 3236, 8), (2, 22, 10),
                                    (1, 925, 10)])
def test_ab_transform_equals_jax(r, s, bd):
    """At / Bt from box sums of real planes equal `_ab_transform_j`."""
    src, dgd = _planes(r + s, 40, 56, bd)
    A, B = L._box_grid(torch.from_numpy(dgd), r)
    At_j, Bt_j = JL._ab_transform_j(jnp.asarray(A.numpy(), jnp.int32),
                                    jnp.asarray(B.numpy(), jnp.int32), r, s, bd)
    At, Bt = L._ab_transform(A, B, r, s, bd)
    assert np.array_equal(At.numpy(), np.asarray(At_j))
    assert np.array_equal(Bt.numpy(), np.asarray(Bt_j))
    # the box sums are the reference's edge-truncated sums over the
    # edge-padded plane, cut to the (H+2, W+2) grid
    ext = np.pad(dgd, 3, mode="edge")
    assert np.array_equal(A.numpy(), S._boxsum(ext, r, True)[2:-2, 2:-2])
    assert np.array_equal(B.numpy(), S._boxsum(ext, r, False)[2:-2, 2:-2])


@pytest.mark.parametrize("H,W,T,bd,step,seed,blocky", [
    (160, 160, 64, 8, 2, 3, False), (128, 192, 64, 10, 2, 4, False),
    (96, 96, 32, 8, 1, 5, False), (128, 160, 64, 10, 2, 6, True),
])
def test_sgr_search_units_same_picks(H, W, T, bd, step, seed, blocky):
    """Per unit, the port's sweep picks the same (ep, xqd) as the JAX sweep.
    A pick may differ only at a near-tie (the two best estimated SSEs within
    1e-6 relative of each other); measured on these planes: none differ."""
    src, dgd = (_blocky if blocky else _planes)(seed, H, W, bd)
    pr = PlaneRestoration(W, H, 0, T)
    eps = range(0, 16, step)
    want = JL.sgr_search_units(src, dgd, pr, bd, eps)
    got = L.sgr_search_units(src, dgd, pr, bd, eps, device="cpu")
    assert set(got) == set(want)
    differ = [k for k in want if got[k][:2] != want[k][:2]]
    for k in differ:
        assert abs(got[k][2] - want[k][2]) <= 1e-6 * abs(want[k][2]), k
    assert len(differ) == 0
    for k in want:
        assert abs(got[k][2] - want[k][2]) <= 1e-4 * max(abs(want[k][2]), 1.0)


@pytest.mark.parametrize("bd,ss", [(8, 0), (10, 1)])
def test_pick_lr_equals_reference(bd, ss):
    """The port's pick_lr equals the reference's, unit for unit: with the
    device sweep (K9 plain against the JAX sweep) and with the host search.
    On these planes the SGR filter wins units (8-bit luma: switchable, 5 of
    6 units SGR; 10-bit chroma: all 3 coded units SGR)."""
    H, W = (128, 160) if ss == 0 else (64, 80)
    src, dgd = _blocky(1, H, W, bd)
    args = (src, dgd, dgd, W, H, ss, bd)
    for backend in ("device", "host"):
        want = ref_pick_lr(*args, unit_size=64, sgr_eps_step=2, backend=backend)
        before = L.calls["plain"]
        got = pick_lr(*args, unit_size=64, sgr_eps_step=2, backend=backend,
                      device="cpu")
        assert got.frame_type == want.frame_type, backend
        assert got.unit_info == want.unit_info, backend
        assert L.calls["plain"] == before + (backend == "device")
        if backend == "device":
            assert any(u is not None and u[0] == "S"
                       for row in got.unit_info for u in row)
