"""Port K1 (intra search) against the JAX reference, on the CPU.

The same numpy inputs go through `svt_av1_psy_tpu.ops.intra_search.
search_block_batch` (jitted on the CPU) and the port's plain PyTorch version
(`svt_av1_psy_tpu_torch.ops.intra_search`, which the wrapper takes for host
tensors). The port sums in float64 and rounds once; JAX sums in float32, so
costs agree to rtol 1e-5 and decisions exactly on these inputs.
"""

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu.codec.constants import TxType
from svt_av1_psy_tpu.codec.intra_rdo import (_block_refs, _build_tables,
                                             _qsteps_for_blocks)
from svt_av1_psy_tpu.codec.rd import lambda_sse_per_bit
from svt_av1_psy_tpu.ops import intra_search as J
from svt_av1_psy_tpu_torch.ops import intra_search as P

torch.set_num_threads(2)


def test_table_builders_match_reference():
    for S in (8, 16, 32, 64):
        assert np.array_equal(P.mode_matrix_bank(S), J.mode_matrix_bank(S))
        assert P.coeff_gain(S) == J.coeff_gain(S)
        for kind in ((0, 1, 3) if S <= 16 else (0, 3)):   # DCT, ADST, IDTX
            assert np.array_equal(P.orth_1d(kind, S), J.orth_1d(kind, S))
        for tt in J.EXT_TX_SET_1 if S <= 16 else (TxType.DCT_DCT,):
            for a, b in zip(P.tx_pair(tt, S), J.tx_pair(tt, S)):
                assert np.array_equal(a, b)
    assert P.ALL_MODES == J.ALL_MODES
    assert P.EXT_TX_SET_1 == J.EXT_TX_SET_1 and P.EXT_TX_SET_2 == J.EXT_TX_SET_2


def test_tables_to_torch_round_trip():
    tb, n_tx = _build_tables(16, 90, (8, 16), None)
    t = P.tables_to_torch(tb, "cpu")
    for k, v in tb.items():
        if isinstance(v, np.ndarray) and v.ndim:
            assert np.array_equal(t[k].numpy(), v), k
    assert t["tx_lam_scale"] == float(tb["tx_lam_scale"])
    assert t["scan2d"].dtype == torch.int32 and n_tx == 5


def _inputs(S, n_tx, bd):
    rng = np.random.default_rng(S + n_tx + bd)
    H = W = 128 if S < 64 else 256
    y = (np.cumsum(rng.normal(0, 6, (H, W)), axis=1) + 128).clip(0, 255)
    y = (y * (1 << (bd - 8))).astype(np.uint16)
    refs = _block_refs(y, S, bd)
    N = refs.shape[0]
    blocks = (y.reshape(H // S, S, W // S, S).transpose(0, 2, 1, 3)
              .reshape(N, S, S).astype(np.float32))
    qdc, qac = _qsteps_for_blocks(H // S, W // S, S, 90, None, 0, bd)
    tb, n = _build_tables(S, 90, (8, 16), None)
    if n != n_tx:
        # S 32 with 5 tx bases (no AV1 set has it; the kernel takes it)
        tb = dict(tb)
        tt = (TxType.DCT_DCT, TxType.IDTX) * 2 + (TxType.DCT_DCT,)
        tt = tt[:n_tx]
        tb["tvs"] = np.stack([J.tx_pair(t, S)[0] for t in tt])
        tb["ths"] = np.stack([J.tx_pair(t, S)[1] for t in tt])
        tb["scans_tx"] = np.stack([tb["scan2d"]] * n_tx)
        tb["ext_tx_bits"] = np.arange(n_tx, dtype=np.float32) * 1.5
    lam = np.float32(lambda_sse_per_bit(90, bd, "kf"))
    return blocks, refs, qdc, qac, lam, tb


# S 64 with 5 tx bases is outside the JAX program (its stage-2 reshape
# assumes S <= 32); chip_smoke.py holds that case against the plain version.
@pytest.mark.parametrize("bd", (8, 10))
@pytest.mark.parametrize("S,n_tx", [(8, 1), (8, 5), (16, 1), (16, 5),
                                    (32, 1), (32, 5), (64, 1)])
def test_k1_plain_matches_jax(S, n_tx, bd):
    blocks, refs, qdc, qac, lam, tb = _inputs(S, n_tx, bd)
    keys = ("G", "scan2d", "scans_tx", "tvs", "ths", "level_bits",
            "eob_bits", "txb_skip", "y_mode_bits", "ext_tx_bits", "qm_w",
            "dist_w")
    jo = [np.asarray(a) for a in J.search_block_batch(
        blocks, refs, qdc, qac, lam, *[tb[k] for k in keys],
        tb["tx_lam_scale"], S=S, n_tx=n_tx)]
    t = P.tables_to_torch(tb, "cpu")
    before = P.calls["plain"]
    po = [a.numpy() for a in P.search_block_batch(
        torch.from_numpy(blocks), torch.from_numpy(refs),
        torch.from_numpy(qdc), torch.from_numpy(qac), float(lam),
        *[t[k] for k in keys], t["tx_lam_scale"], S=S, n_tx=n_tx)]
    assert P.calls["plain"] == before + 1
    assert np.array_equal(jo[0], po[0])
    assert np.array_equal(jo[1], po[1])
    np.testing.assert_allclose(po[2], jo[2], rtol=1e-5)
    np.testing.assert_allclose(po[3], jo[3], rtol=1e-5)


def test_search_intra_decisions_twin_matches_reference():
    """The port's intra_rdo on the plain versions vs the reference's device
    path (as tests/test_rdo.py:116 holds the reference's two backends)."""
    from svt_av1_psy_tpu.codec.intra_rdo import search_intra_decisions as ref
    from svt_av1_psy_tpu_torch.codec.intra_rdo import search_intra_decisions

    rng = np.random.default_rng(11)
    y = (np.cumsum(rng.normal(0, 6, (128, 128)), axis=1) + 128) \
        .clip(0, 255).astype(np.uint16)
    a = ref(y, 90, 8, backend="device_all")
    b = search_intra_decisions(y, 90, 8, backend="device_all", device="cpu")
    assert sorted(a.modes) == sorted(b.modes)
    for S in a.modes:
        assert np.array_equal(a.modes[S], b.modes[S]), S
        assert np.array_equal(a.tx_types[S], b.tx_types[S]), S
    for S in a.parts:
        assert np.array_equal(a.parts[S], b.parts[S]), S


def test_kernel_wrapper_refuses_other_devices():
    blocks, refs, qdc, qac, lam, tb = _inputs(8, 1, 8)
    t = P.tables_to_torch(tb, "meta")
    m = [torch.from_numpy(a).to("meta") for a in (blocks, refs, qdc, qac)]
    with pytest.raises(ValueError):
        P.search_block_batch(*m, float(lam), t["G"], t["scan2d"],
                             t["scans_tx"], t["tvs"], t["ths"],
                             t["level_bits"], t["eob_bits"], t["txb_skip"],
                             t["y_mode_bits"], t["ext_tx_bits"], t["qm_w"],
                             t["dist_w"], t["tx_lam_scale"], S=8, n_tx=1)
