"""Port K6 (the device residual commit) on the CPU: the plain `_group_program`
against the JAX program `_jit_group(...)` on synthetic lanes, bit-exact on
all three outputs (scan-packed levels, eobs + overflow flag, recon).

Cases mirror tests/test_commit.py:33,56,85 one level up: every leaf size, both
prediction kinds (single reference and compound), every luma tx variant of
`_size_tts(S)`, RDOQ on and off, 8- and 10-bit, quantizer matrices, and a
monochrome group. Lanes sit near the clip's motion with jittered subpel MVs,
some far outside the frame (clamped gathers) and some padding lanes.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from svt_av1_psy_tpu.codec.quant import build_plane_quant
from svt_av1_psy_tpu.codec.spec_tables import get_tables
from svt_av1_psy_tpu.ops import commit as JC
from svt_av1_psy_tpu_torch.ops import commit as PC

torch.set_num_threads(2)

CPU = torch.device("cpu")
PAD = 24
H = W = 128

# (S, is_comp, vi, rdoq, bd, qm_key, nplanes)
CASES = (
    [(S, bool(vi % 2), vi, True, 8, None, 3)
     for S in (8, 16, 32, 64) for vi in range(len(JC._size_tts(S)[0]))]
    + [(S, True, 0, False, 8, None, 3) for S in (8, 16, 32, 64)]
    + [(32, True, 1, True, 10, None, 3), (64, False, 0, False, 10, None, 3),
       (16, False, 0, True, 8, (5, 7, 7), 3), (8, True, 3, True, 8, (8, 4, 4), 3),
       (16, False, 2, True, 8, None, 1)]
)


def _lanes(S, bd, nplanes, seed):
    """refs (per plane (2, Hp, Wp)), srcs, meta, quant tables, filters."""
    rng = np.random.default_rng(seed)
    peak = (1 << bd) - 1
    dt = np.uint8 if bd == 8 else np.uint16
    big = (np.cumsum(rng.normal(0, 5, (H + 2 * PAD + 16, W + 2 * PAD + 16)), 1)
           + np.cumsum(rng.normal(0, 3, (H + 2 * PAD + 16, W + 2 * PAD + 16)), 0))
    big = (big - big.min()) / (np.ptp(big) + 1e-9) * peak

    def crop(dy, dx, noise):
        a = big[8 + dy:8 + dy + H + 2 * PAD, 8 + dx:8 + dx + W + 2 * PAD]
        return np.clip(a + rng.normal(0, noise, a.shape), 0, peak)

    refs_l = [crop(0, 0, 1), crop(4, 6, 1)]           # padded luma refs
    src_l = crop(2, 3, 2)[PAD:PAD + H, PAD:PAD + W]    # halfway between

    def planes(a):          # 4:2:0 chroma: the luma subsampled
        ys = [a]
        if nplanes > 1:
            ys += [a[::2, ::2], a[1::2, 1::2]]
        return [np.ascontiguousarray(p.astype(dt)) for p in ys]

    r0, r1 = planes(refs_l[0]), planes(refs_l[1])
    refs = [np.stack([a, b]) for a, b in zip(r0, r1)]
    srcs = planes(src_l)
    B = 24
    meta = np.zeros((B, 8), np.int32)
    meta[:, 0] = rng.integers(0, H // S, B) * S
    meta[:, 1] = rng.integers(0, W // S, B) * S
    meta[:, 6] = rng.integers(0, 2, B)
    meta[:, 2:4] = np.where(meta[:, 6:7] == 0, (16, 24), (-16, -24))
    meta[:, 4:6] = (-16, -24)
    meta[:, 2:6] += rng.integers(-12, 13, (B, 4))
    meta[:3, 2:6] = (16, 24, -16, -24)          # integer MVs: phase 0
    meta[3, 2:4] = (900, -900)                  # far outside: clamped gather
    meta[:, 7] = rng.integers(0, 16, B)
    meta[-3:, 0:2] = 1 << 24                    # padding lanes
    qt = np.zeros((2, 16, 10), np.int32)
    for i, q in enumerate(np.linspace(20, 255, 16).astype(int)):
        for p in range(2):
            pq = build_plane_quant(int(q), 0, 0, bd, 1, 120)
            qt[p, i] = (pq.zbin[0], pq.zbin[1], pq.round[0], pq.round[1],
                        pq.quant[0], pq.quant[1], pq.quant_shift[0],
                        pq.quant_shift[1], pq.dequant[0], pq.dequant[1])
    tab = get_tables()._raw
    f8 = np.asarray(tab["interp_sub_pel_filters_8"], np.int32)
    f4 = np.asarray(tab["interp_sub_pel_filters_4"], np.int32)
    refs += [refs[0]] * (3 - nplanes)
    srcs += [srcs[0]] * (3 - nplanes)
    return refs, srcs, meta, qt, f8, f4


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


def _run_both(S, is_comp, vi, rdoq, bd, qm_key, nplanes, seed=0):
    refs, srcs, meta, qt, f8, f4 = _lanes(S, bd, nplanes, seed + S)
    fn = JC._jit_group(S, is_comp, vi, bd, nplanes, rdoq, PAD)
    ty, tuv = JC._vi_tables(S, nplanes, qm_key, vi)
    want = fn([jnp.asarray(r) for r in refs], [jnp.asarray(s) for s in srcs],
              jnp.asarray(meta), jnp.asarray(qt[0]), jnp.asarray(qt[1]),
              jnp.asarray(f8), jnp.asarray(f4), ty, tuv)
    pty, ptuv = PC._vi_tables(S, nplanes, qm_key, vi, CPU)
    got = PC._jit_group(S, is_comp, vi, bd, nplanes, rdoq, PAD)(
        [_t(r) for r in refs], [_t(s) for s in srcs], _t(meta), _t(qt[0]),
        _t(qt[1]), _t(f8), _t(f4), pty, ptuv)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("S,is_comp,vi,rdoq,bd,qm_key,nplanes", CASES)
def test_group_program_matches_jax(S, is_comp, vi, rdoq, bd, qm_key, nplanes):
    (lv, mo, rec), (plv, pmo, prec) = _run_both(S, is_comp, vi, rdoq, bd,
                                                 qm_key, nplanes)
    assert plv.dtype == np.int16 and np.array_equal(lv, plv)
    assert pmo.dtype == np.int32 and np.array_equal(mo, pmo)
    if bd == 8:
        assert prec.dtype == np.uint8 and np.array_equal(rec, prec)
    else:          # 10-bit samples travel as int16 bits of uint16
        assert np.array_equal(rec, prec.view(np.uint16))
    Ky, Kuv = JC._lv_caps(S, nplanes)
    assert lv.shape == (24, Ky + 2 * Kuv) and mo.shape == (24, 4)


def test_lanes_exercise_both_chroma_variants():
    """The chroma tx type follows the luma eob: the synthetic lanes must
    hold luma eob 0 and > 0 for the selection to be tested."""
    _, (_, mo, _) = _run_both(8, True, 3, True, 8, None, 3)
    assert (mo[:, 0] == 0).any() and (mo[:, 0] > 0).any()
    assert (mo[:, 3] == 0).any()


@pytest.mark.parametrize("S", [8, 16, 32, 64])
def test_tables_match_reference(S):
    for qm_key in (None, (5, 7, 7)):
        jy, juv = JC._size_tables(S, 3, qm_key)
        py, puv = PC._size_tables(S, 3, qm_key, CPU)
        for jt, pt in ((jy, py), (juv, puv)):
            for ja, pa in zip(jt, pt):
                assert len(ja) == len(pa)
                for a, b in zip(ja, pa):
                    assert (a is None) == (b is None)
                    if a is not None:
                        assert np.array_equal(np.asarray(a), b.numpy())


def test_mul_shift_u32_is_exact_and_matches_jax():
    """Exact within the quantizer's ranges (tmpw * m >> 16 + ...: tmpw <
    2^28; dequant: abs_q < 2^15, dequant < 2^14), and equal to JAX's uint32
    arithmetic also where it wraps."""
    rng = np.random.default_rng(7)
    for s, a_hi, b_hi in ((16, 1 << 28, (1 << 16) + 2), (19, 1 << 28, 1 << 16),
                          (21, 1 << 28, 1 << 16), (0, 1 << 15, 1 << 14),
                          (2, 1 << 15, 1 << 14), (1, 1 << 31, 1 << 31)):
        a = rng.integers(0, a_hi, 4096, dtype=np.int64)
        b = rng.integers(0, b_hi, 4096, dtype=np.int64)
        got = PC._mul_shift_u32(torch.from_numpy(a), torch.from_numpy(b), s)
        if a_hi < (1 << 31):
            assert np.array_equal(got.numpy(), (a * b) >> s)
        want = np.asarray(JC._mul_shift_u32(jnp.asarray(a.astype(np.int32)),
                                            jnp.asarray(b.astype(np.int32)), s))
        assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_group_refuses_other_devices():
    meta = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        PC.commit_group(None, None, meta, None, None, None, None, None, None,
                        S=8, bd=8, is_comp=False, nplanes=3, rdoq=True,
                        pad=PAD, tts_y=(0,), tts_uv=(0,))


def test_group_counts_plain_calls_on_cpu():
    refs, srcs, meta, qt, f8, f4 = _lanes(16, 8, 3, 1)
    before = dict(PC.calls)
    ty, tuv = PC._vi_tables(16, 3, None, 0, CPU)
    PC._jit_group(16, False, 0, 8, 3, True, PAD)(
        [_t(r) for r in refs], [_t(s) for s in srcs], _t(meta), _t(qt[0]),
        _t(qt[1]), _t(f8), _t(f4), ty, tuv)
    assert PC.calls == {"kernel": before["kernel"], "plain": before["plain"] + 1}
