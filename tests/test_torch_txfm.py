"""Port K5 (AV1 2-D transforms) on the CPU, through its plain PyTorch version.

Bit-exact against the numpy golden model `codec/transforms.py` over every
tx size and each of its tx types at bd 8 and 10 (torch needs no compile per
shape, so the whole sweep is cheap), and against the JAX program
`ops/txfm.py` on the sample set of tests/test_ops_txfm.py. The CUDA kernel is
held against the same plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu.codec.constants import TX_HEIGHT, TX_WIDTH
from svt_av1_psy_tpu.codec.transforms import (
    forward_transform_2d as fwd_np,
    inverse_transform_add as inv_np,
    tx_types_for_size,
)
from svt_av1_psy_tpu.ops.txfm import (
    forward_transform_2d as fwd_jax,
    inverse_transform_add as inv_jax,
)
from svt_av1_psy_tpu_torch.ops import txfm as X

torch.set_num_threads(2)

FAST = [(0, 0), (0, 3), (1, 9), (3, 0), (5, 1)]  # tests/test_ops_txfm.py:23


def _inputs(tx_size, tt, bd, n=4):
    rng = np.random.default_rng(tx_size * 16 + tt + 1000 * bd)
    H, W = int(TX_HEIGHT[tx_size]), int(TX_WIDTH[tx_size])
    peak = (1 << bd) - 1
    res = rng.integers(-peak, peak + 1, (n, H, W)).astype(np.int32)
    pred = rng.integers(0, peak + 1, (n, H, W)).astype(np.uint16)
    return res, pred


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("tx_size", range(19))
def test_plain_matches_numpy_model_every_type(tx_size, bd):
    for tt in tx_types_for_size(tx_size):
        tt = int(tt)
        res, pred = _inputs(tx_size, tt, bd)
        ref_f = fwd_np(res, tx_size, tt, bd)
        got_f = X.forward_transform_2d_ref(torch.from_numpy(res), tx_size, tt)
        assert got_f.dtype == torch.int32
        assert np.array_equal(ref_f, got_f.numpy()), ("fwd", tx_size, tt, bd)
        ref_i = inv_np(ref_f, pred, tx_size, tt, bd)
        got_i = X.inverse_transform_add_ref(
            torch.from_numpy(ref_f), torch.from_numpy(pred.astype(np.int32)),
            tx_size, tt, bd)
        assert np.array_equal(ref_i.astype(np.int32), got_i.numpy()), \
            ("inv", tx_size, tt, bd)


@pytest.mark.parametrize("tx_size,tt", FAST, ids=lambda p: str(p))
def test_plain_matches_jax(tx_size, tt):
    res, pred = _inputs(tx_size, tt, 8)
    got_f = X.forward_transform_2d_ref(torch.from_numpy(res), tx_size, tt)
    assert np.array_equal(np.asarray(fwd_jax(res, tx_size, tt)), got_f.numpy())
    coeffs = got_f.numpy()
    want = np.asarray(inv_jax(coeffs, pred.astype(np.int32), tx_size, tt, 8))
    got = X.inverse_transform_add_ref(torch.from_numpy(coeffs),
                                      torch.from_numpy(pred.astype(np.int32)),
                                      tx_size, tt, 8)
    assert np.array_equal(want, got.numpy())


def test_wrapper_runs_plain_on_cpu_tensors():
    res, pred = _inputs(3, 0, 8)
    before = dict(X.calls)
    f = X.forward_transform_2d(torch.from_numpy(res), 3, 0)
    r = X.inverse_transform_add(f, torch.from_numpy(pred.astype(np.int32)), 3, 0)
    assert X.calls["plain"] == before["plain"] + 2
    assert X.calls["kernel"] == before["kernel"]
    assert np.array_equal(f.numpy(), fwd_np(res, 3, 0))
    assert r.dtype == torch.int32


def test_wrapper_refuses_other_devices():
    x = torch.zeros((1, 8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        X.forward_transform_2d(x, 1, 0)


def test_specs_cover_the_kernel_layout():
    """The host spec (the 23 int64 values txfm.cuh reads) for a rect size
    with flips, and the stage table of its graphs."""
    from svt_av1_psy_tpu.codec import transforms as T

    ts, tt = 7, 4           # 8x16 FLIPADST_DCT: vertical ADST16, flipped
    s = X.tx_spec(ts, tt, False, 8, torch.device("cpu"))
    assert s.dtype == np.int64 and len(s) == X.SPEC_LEN
    H, W = int(TX_HEIGHT[ts]), int(TX_WIDTH[ts])
    assert (H, W) == (16, 8) and (s[12], s[13]) == (H, W)
    assert (s[14], s[15]) == (1, 0)            # ud flip only
    assert s[16] == 1                          # 2:1 rect scaling
    assert list(s[17:20]) == [int(v) for v in T.FWD_SHIFT[ts]]
    assert (s[1], s[2], s[7], s[8]) == (0, H, 0, W)    # two graphs
    assert s[5] == 0 and s[11] == 0            # no clamps forward
    inv = X.tx_spec(ts, tt, True, 10, torch.device("cpu"))
    assert (inv[5], inv[11]) == (16, 18)       # col / row clamp at bd 10
    assert (inv[20], inv[21], inv[22]) == (18, 16, 10)
    table, nst = X._graph("idct16", T.INV_COS_BIT, torch.device("cpu"))
    assert tuple(table.shape) == (nst, 5, 16)
    st = T.compiled_stages("idct16", T.INV_COS_BIT)
    assert np.array_equal(table[:, 0].numpy(), np.stack([a[0] for a in st]))
    assert np.array_equal(table[:, 4].numpy(),
                          np.stack([a[4] * 2 + a[5] for a in st]))
