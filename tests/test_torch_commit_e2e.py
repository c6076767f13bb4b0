"""The port's device residual commit end to end on the CPU.

A 176x144 x 4 preset-10 qp-40 encode (the clip of tests/test_commit.py:110)
through the port with commit_backend="device" on device="cpu" runs K5 + K6's
plain versions and must be byte-identical, stream and recon, to the reference
encoder's host commit (tests/test_commit.py:171 holds the reference's device
commit to the same stream). The port runs in a subprocess with
`sys.modules["jax"] = None`. A failing commit raises from the encode: there
is no fallback to the host walk.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_encoder import ROOT, load_native_locked

torch.set_num_threads(2)

_CLIP = r"""
import numpy as np
from svt_av1_psy_tpu.config import EncoderConfig


def encode(Encoder, commit, W=176, H=144, n=4, bd=8, seed=3, **dev):
    rng = np.random.default_rng(seed)
    peak = (1 << bd) - 1
    dt = np.uint8 if bd == 8 else np.uint16
    base = (np.cumsum(rng.normal(0, 4 * peak / 255, (H, W + 4 * n)), axis=1)
            + peak / 2).clip(0, peak)
    frames = [np.clip(base[:, i * 2:i * 2 + W]
                      + rng.normal(0, 3 * peak / 255, (H, W)), 0, peak)
              .astype(dt) for i in range(n)]
    u = np.full(((H + 1) // 2, (W + 1) // 2), (1 << bd) // 2 - 6, dt)
    cfg = EncoderConfig(width=W, height=H, input_depth=bd, preset=10,
                        recon_enabled=True, commit_backend=commit)
    cfg.qp = 40
    enc = Encoder(cfg, **dev).init()
    for i, y in enumerate(frames):
        enc.send_picture(y, u, u.copy(), pts=i)
    enc.flush()
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    return pkts
"""

_PORT = r"""
import json, sys
sys.modules["jax"] = None
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tests")
import numpy as np, torch
torch.set_num_threads(2)
from test_torch_encoder import load_native_locked
native = load_native_locked()
assert all(native.values()), native
from svt_av1_psy_tpu_torch.api import Encoder
from svt_av1_psy_tpu_torch.ops import commit, txfm
""" + _CLIP + r"""
pkts = encode(Encoder, "device", device="cpu")
shown = [p for p in pkts if p.recon is not None]
np.savez(sys.argv[2], stream=np.frombuffer(b"".join(p.data for p in pkts), np.uint8),
         **{f"recon{i}_{k}": p.recon[k] for i, p in enumerate(shown) for k in range(3)})
print(json.dumps(dict(commit=commit.calls, txfm=txfm.calls, shown=len(shown),
                      jax=sys.modules["jax"] is not None)))
"""


def _clip_encode():
    ns = {}
    exec(_CLIP, ns)
    return ns["encode"]


def test_port_device_commit_matches_reference_host_commit(tmp_path):
    native = load_native_locked()
    assert all(native.values()), f"native libraries failed to load: {native}"
    out = tmp_path / "port.npz"
    r = subprocess.run([sys.executable, "-c", _PORT, str(ROOT), str(out)],
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    info = json.loads(r.stdout.strip().splitlines()[-1])
    assert info["jax"] is False
    # the commit ran, on its plain version (host tensors)
    assert info["commit"]["plain"] > 0 and info["commit"]["kernel"] == 0
    assert info["txfm"]["kernel"] == 0
    data = np.load(out)

    from svt_av1_psy_tpu.api import Encoder

    ref = _clip_encode()(Encoder, "host")
    assert data["stream"].tobytes() == b"".join(p.data for p in ref)
    shown = [p for p in ref if p.recon is not None]
    assert info["shown"] == len(shown) == 4
    for i, p in enumerate(shown):
        for k in range(3):
            assert np.array_equal(data[f"recon{i}_{k}"], p.recon[k]), (i, k)


def test_failing_commit_raises_without_host_fallback(monkeypatch):
    from svt_av1_psy_tpu_torch.api import Encoder
    from svt_av1_psy_tpu_torch.ops import commit

    def broken(enc):
        raise RuntimeError("commit kernel failed")

    monkeypatch.setattr(commit, "commit_frame", broken)
    with pytest.raises(RuntimeError, match="commit kernel failed"):
        _clip_encode()(Encoder, "device", n=2, device="cpu")


def test_auto_commit_stays_off():
    """"auto" resolves to off, as in the reference: no commit call."""
    from svt_av1_psy_tpu_torch.api import Encoder
    from svt_av1_psy_tpu_torch.ops import commit

    before = dict(commit.calls)
    pkts = _clip_encode()(Encoder, "auto", n=2, device="cpu")
    assert pkts and commit.calls == before
