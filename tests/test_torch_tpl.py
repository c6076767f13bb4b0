"""K7 (the device TPL cost pass) and the port's TPL dispatch against the JAX
package on the CPU.

The plain versions of both K7 entry points equal the JAX programs exactly
when both are fed the same inputs: integer SA8D sums stay below 2^24 on the
8-bit TPL planes, so JAX's float32 einsums are exact there. The whole pass
(K2 grids + K7) equals JAX's only where JAX's float32 SSD grids are exact
(pixels 0..15); on 8-bit content the MV agreement rate is measured and the
end-to-end r0 is held to the reference's own device-vs-host envelope.
"""

import jax
import numpy as np
import pytest
import torch

from svt_av1_psy_tpu.ops import inter_search as JI
from svt_av1_psy_tpu.ops import tpl as JT
from svt_av1_psy_tpu.rc.tpl import tpl_analysis as ref_tpl_analysis
from svt_av1_psy_tpu_torch.ops import inter_search as I
from svt_av1_psy_tpu_torch.ops import tpl as T
from svt_av1_psy_tpu_torch.rc.tpl import tpl_analysis

torch.set_num_threads(2)


def _pan(n, W, H, motion=(4, 8), seed=0, amp=255):
    """n frames of a smooth random texture panning by `motion` per frame,
    scaled to 0..amp."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(0, 5, (H + 64, W + 64)), axis=1) + 128
    base = (base.clip(0, 255) * (amp / 255.0)).round().astype(np.uint8)
    return [base[motion[0] * i:motion[0] * i + H,
                 motion[1] * i:motion[1] * i + W].copy() for i in range(n)]


def _preps(frames):
    H, W = frames[0].shape
    Hp, Wp = JI.pad_dims(H, W)
    jp = [JI.prep_frame(jax.device_put(f.astype(np.uint16)), Hp=Hp, Wp=Wp)
          for f in frames]
    tp = [I.prep_frame(I.upload_plane(f, "cpu"), Hp, Wp) for f in frames]
    return jp, tp


@pytest.mark.parametrize("H,W,seed", [(100, 136, 0), (64, 64, 1)])
def test_intra_stage_equals_jax(H, W, seed):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (H, W)).astype(np.uint8)
    jp, tp = _preps([f])
    want = np.asarray(JT.tpl_intra_stage(jp[0][0], Hr=H, Wr=W))
    got = T.tpl_intra_stage(tp[0][0], H, W).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("H,W,seed", [(100, 136, 2), (128, 192, 3)])
def test_pair_stage_equals_jax_on_the_same_grids(H, W, seed):
    """Both versions read JAX's own grids (integer-valued float32). The
    100x136 frame pads to 128x192: the units below row 100 and right of
    column 136 lie in the 64-aligned padding, where the clip's upper bound
    (Hr - 16) - b is negative and pulls the vector back into the frame."""
    frames = _pan(2, W, H, seed=seed)
    frames[1] = np.clip(frames[1].astype(int)
                        + np.random.default_rng(seed).integers(-6, 7, (H, W)),
                        0, 255).astype(np.uint8)
    jp, tp = _preps(frames)
    cy2, cx2, g = JI.grids_stage(jp[1][0], jp[0][1])
    want = np.asarray(JT.tpl_pair_stage(jp[1][0], jp[0][1], cy2, cx2, g,
                                        Hr=H, Wr=W))
    g_np = np.asarray(g)
    assert np.array_equal(g_np, np.round(g_np))          # integer-valued
    got = T.tpl_pair_stage(
        tp[1][0], tp[0][1], torch.from_numpy(np.array(cy2, np.int32)),
        torch.from_numpy(np.array(cx2, np.int32)),
        torch.from_numpy(g_np.astype(np.int32)), H, W).numpy()
    assert np.array_equal(got, want)
    Hp, Wp = JI.pad_dims(H, W)
    gr, gc = Hp // 16, Wp // 16
    mv_y = got[:gr * gc].reshape(gr, gc)
    if Hp > H:      # padding rows: vectors clipped to the frame's last rows
        by = np.arange(gr)[:, None] * 16
        assert np.all(mv_y[H // 16 + 1:] <= (H - 16) - by[H // 16 + 1:])


def test_group_stats_equal_jax_on_low_amplitude_content():
    """Pixels 0..15: JAX's float32 SSD grids are exact, so the whole pass
    (K2 + K7 plain) equals the JAX pass: every vector and cost."""
    frames = _pan(4, 192, 128, amp=15, seed=5)
    want = JT.tpl_group_stats([f.astype(np.uint16) for f in frames])
    got = T.tpl_group_stats(frames, device="cpu")
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for k in ("intra", "inter", "mv"):
            assert np.array_equal(a[k], b[k]), k
        assert (a["bh"], a["bw"]) == (b["bh"], b["bw"])


def test_group_stats_on_8bit_content_agreement():
    """8-bit content with noise (+/-40): the intra costs are equal; JAX's
    inexact float32 grids move some vectors. Measured on this clip: 187 of
    192 vectors agree (97.4 %); where they agree the inter costs are equal.
    The bound allows 10 % of units to differ."""
    rng = np.random.default_rng(7)
    frames = [np.clip(f.astype(int) + rng.integers(-40, 41, f.shape), 0,
                      255).astype(np.uint8) for f in _pan(3, 192, 128, seed=7)]
    want = JT.tpl_group_stats([f.astype(np.uint16) for f in frames])
    got = T.tpl_group_stats(frames, device="cpu")
    agree = total = 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a["intra"], b["intra"]), i
        if i:
            same = (a["mv"] == b["mv"]).all(-1)
            agree += int(same.sum())
            total += same.size
            assert np.array_equal(a["inter"][same], b["inter"][same])
            assert np.all(a["inter"] <= a["intra"])
    assert agree >= 0.9 * total, (agree, total)


@pytest.mark.parametrize("scramble,seed", [(False, 1), (True, 2)])
def test_r0_within_the_reference_envelope(scramble, seed):
    """As tests/test_tpl.py holds the JAX device pass: r0 within 0.12 of the
    host pass, on predictable and on scrambled content; and within 0.02 of
    the JAX device pass."""
    rng = np.random.default_rng(seed)
    frames = ([rng.integers(0, 256, (128, 192)).astype(np.uint8)
               for _ in range(4)] if scramble else _pan(4, 192, 128, seed=seed))
    r0_h, _, _ = ref_tpl_analysis(frames, backend="host")
    r0_j, _, _ = ref_tpl_analysis(frames, backend="device")
    r0_p, beta, unit = tpl_analysis(frames, backend="device", device="cpu")
    assert abs(r0_p - r0_h) < 0.12, (r0_h, r0_p)
    assert abs(r0_p - r0_j) < 0.02, (r0_j, r0_p)
    assert beta.shape == (128 // 16, 192 // 16) and unit == 16


def test_tpl_dispatch():
    """host and (on the CPU) auto take the reference's host pass; device
    runs K2 + K7 (plain versions on host tensors); small frames stay on the
    host; 720-line frames run decimated (unit 32)."""
    frames = _pan(3, 128, 96, seed=3)
    before = dict(T.calls)
    want = ref_tpl_analysis(frames, backend="host")
    for backend in ("host", "auto"):
        got = tpl_analysis(frames, backend=backend, device="cpu")
        assert got[0] == want[0] and np.array_equal(got[1], want[1])
    assert T.calls == before
    tpl_analysis(frames, backend="device", device="cpu")
    assert T.calls["plain"] == before["plain"] + 3      # 1 intra + 2 pairs
    small = [f[:48, :64] for f in frames]
    got = tpl_analysis(small, backend="device", device="cpu")
    assert got[0] == ref_tpl_analysis(small, backend="host")[0]
    assert T.calls["plain"] == before["plain"] + 3
    tall = [np.tile(f, (8, 1))[:720, :128] for f in frames]
    r0, beta, unit = tpl_analysis(tall, backend="device", device="cpu")
    assert unit == 32 and beta.shape == (360 // 16, 64 // 16)
