"""The port's quality-preset path end to end on the CPU: 10-bit, preset 6,
with `tpl_backend="device"` (K2 + K7) and `filters_backend="device"` (K8
CDEF, K9 SGR sweep), on the plain versions.

The port's encode runs in a subprocess with `sys.modules["jax"] = None`.
Its stream must decode bit-exactly in dav1d and equal the reference's
(JAX on the CPU, the same backends) byte for byte: every kernel on this
path is exact, and at this size the JAX programs' float32 sums (the TPL
grids, the SGR tile sums) move no decision.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu.config import EncoderConfig
from test_torch_encoder import load_native_locked

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

_PORT_ENCODE = r"""
import json, sys
sys.modules["jax"] = None
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tests")
import numpy as np, torch
torch.set_num_threads(2)
from test_torch_encoder import load_native_locked
native = load_native_locked()
assert all(native.values()), native
from test_torch_quality_path import clip, config
from svt_av1_psy_tpu_torch.api import Encoder
from svt_av1_psy_tpu_torch.ops import filters, lr_search, tpl

W, H = int(sys.argv[3]), int(sys.argv[4])
frames, u, v = clip(W, H, 9)
enc = Encoder(config(W, H), device="cpu").init()
pkts = []
for f in frames:
    enc.send_picture(f, u, v.copy())
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
enc.flush()
while (p := enc.get_packet()) is not None:
    pkts.append(p)
shown = [p for p in pkts if p.recon is not None]
np.savez(sys.argv[2], stream=np.frombuffer(b"".join(p.data for p in pkts), np.uint8),
         **{f"recon{i}_{k}": p.recon[k] for i, p in enumerate(shown) for k in range(3)})
print(json.dumps(dict(
    psnr=float(np.mean([p.stats["psnr_y"] for p in pkts if p.stats])),
    shown=len(shown), tpl=tpl.calls, cdef=filters.calls, lr=lr_search.calls,
    jax=sys.modules["jax"] is not None)))
"""


def clip(W, H, n):
    """The bench's synthetic clip, shifted to 10 bits."""
    sys.path.insert(0, str(ROOT))
    from bench import _video

    frames, u, v = _video(W, H, n)
    return ([f.astype(np.uint16) << 2 for f in frames],
            u.astype(np.uint16) << 2, v.astype(np.uint16) << 2)


def config(W, H, backends="device"):
    cfg = EncoderConfig(width=W, height=H, preset=6, input_depth=10,
                        recon_enabled=True, stat_report=True)
    cfg.qp = 35
    cfg.tpl_backend = backends
    cfg.filters_backend = backends
    return cfg


def _port_encode(tmp_path, W, H):
    out = tmp_path / "port.npz"
    r = subprocess.run([sys.executable, "-c", _PORT_ENCODE, str(ROOT), str(out),
                        str(W), str(H)], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    info = json.loads(r.stdout.strip().splitlines()[-1])
    assert info["jax"] is False
    data = np.load(out)
    return info, data["stream"].tobytes(), data


def _assert_decodes(stream, data, n, W, H):
    from svt_av1_psy_tpu.io import dav1d

    assert dav1d.available()
    for i in range(n):
        d = dav1d.decode_nth(stream, i, W, H)
        for k in range(3):
            assert np.array_equal(d[k], data[f"recon{i}_{k}"]), (i, k)


def _reference_encode(W, H):
    from svt_av1_psy_tpu.api import Encoder

    frames, u, v = clip(W, H, 9)
    enc = Encoder(config(W, H)).init()
    pkts = []
    for f in frames:
        enc.send_picture(f, u, v.copy())
        while (p := enc.get_packet()) is not None:
            pkts.append(p)
    enc.flush()
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    return (b"".join(p.data for p in pkts),
            float(np.mean([p.stats["psnr_y"] for p in pkts if p.stats])))


def test_quality_path_matches_reference(tmp_path):
    """192x128 x 9, 10-bit, p6, CRF 35: both TPL passes (keyframe window and
    GoP base), CDEF and the SGR sweep on every frame run through K7-K9's
    plain versions, and the stream is the reference's byte for byte."""
    native = load_native_locked()
    assert all(native.values()), native
    W, H = 192, 128
    info, stream, data = _port_encode(tmp_path, W, H)
    assert info["shown"] == 9
    for k in ("tpl", "cdef", "lr"):
        assert info[k]["plain"] > 0 and info[k]["kernel"] == 0, (k, info[k])
    _assert_decodes(stream, data, 9, W, H)
    ref_stream, ref_psnr = _reference_encode(W, H)
    assert abs(len(stream) - len(ref_stream)) <= 0.01 * len(ref_stream)
    assert abs(info["psnr"] - ref_psnr) <= 0.05
    assert stream == ref_stream


def test_edge_leaf_warp_repair(tmp_path):
    """176x144: the bottom superblock row holds 16 lines, so the p6 inter
    partition search forces rect leaves that cross the 8-aligned edge. With
    a global-motion model the reference cuts their luma warp from the
    whole-plane warp, which is shorter, and raises; the port warps such a
    leaf block by block, and its stream decodes bit-exactly."""
    native = load_native_locked()
    assert all(native.values()), native
    W, H = 176, 144
    from svt_av1_psy_tpu.api import Encoder

    frames, u, v = clip(W, H, 9)
    enc = Encoder(config(W, H, backends="host")).init()
    with pytest.raises(ValueError, match="broadcast"):
        for f in frames:
            enc.send_picture(f, u, v.copy())
            while enc.get_packet() is not None:
                pass
        enc.flush()
    info, stream, data = _port_encode(tmp_path, W, H)
    assert info["shown"] == 9
    _assert_decodes(stream, data, 9, W, H)


def test_device_sgr_failure_raises(monkeypatch):
    """No host fallback: a failure in the device SGR sweep raises out of the
    encoder (the reference warns and runs its host search instead)."""
    from svt_av1_psy_tpu_torch.api import Encoder
    from svt_av1_psy_tpu_torch.ops import lr_search

    def boom(*a, **k):
        raise RuntimeError("forced SGR sweep failure")

    monkeypatch.setattr(lr_search, "sgr_stats", boom)
    frames, u, v = clip(64, 64, 1)
    cfg = config(64, 64)
    cfg.look_ahead_distance = 0
    enc = Encoder(cfg, device="cpu").init()
    with pytest.raises(RuntimeError, match="forced SGR sweep failure"):
        enc.send_picture(frames[0], u, v.copy())
        enc.flush()


def test_cli_quality_path(tmp_path):
    """The CLI takes --tpl-backend device --filters-backend device and runs
    K7-K9 (plain versions with --device cpu)."""
    from svt_av1_psy_tpu.io.y4m import Y4MHeader, Y4MWriter
    from svt_av1_psy_tpu_torch.app import cli
    from svt_av1_psy_tpu_torch.ops import filters, lr_search, tpl

    frames, u, v = clip(128, 128, 5)
    y4m = tmp_path / "in.y4m"
    with open(y4m, "wb") as f:
        w = Y4MWriter(f, Y4MHeader(128, 128, 25, 1))
        for y in frames:
            w.write_frame((y >> 2).astype(np.uint8), (u >> 2).astype(np.uint8),
                          (v >> 2).astype(np.uint8))
    before = [dict(m.calls) for m in (tpl, filters, lr_search)]
    out = tmp_path / "out.ivf"
    assert cli.main(["-i", str(y4m), "-b", str(out), "--device", "cpu",
                     "--preset", "6", "--tpl-backend", "device",
                     "--filters-backend", "device"]) == 0
    assert out.stat().st_size > 32
    for b, m in zip(before, (tpl, filters, lr_search)):
        assert m.calls["plain"] > b["plain"] and m.calls["kernel"] == 0
