"""The port's encoder end to end on the CPU, its refusals, and its smoke
script's refusal to run without a card.

The end-to-end encode runs in a subprocess with `sys.modules["jax"] = None`,
so any import of jax by the port (or by a reference module it reuses) fails
the run.

The reference's C libraries (walk, mc, ec, dav1d) build on first use into one
path, with no lock and no atomic rename, and a failed load returns None (the
encoder then takes the Python walk; mc_native never retries). pytest-xdist
workers build them at the same moment, so `load_native_locked` loads them
under a lock on a file in their build directory, retries while a concurrent
writer may still be linking, and the tests assert they loaded: a failed build
shows as such, not as a stream mismatch.
"""

import fcntl
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu.config import EncoderConfig
from svt_av1_psy_tpu.errors import SvtAv1Error

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
W, H, N = 160, 128, 9


def load_native_locked(root=ROOT, attempts=3):
    """{name: loaded} for the reference's walk, mc, ec and dav1d libraries,
    loaded under an exclusive lock on `native/build/load.lock`."""
    from svt_av1_psy_tpu.bitstream import ec_native
    from svt_av1_psy_tpu.codec import mc_native, walk_native
    from svt_av1_psy_tpu.io import dav1d

    mods = {"walk": walk_native, "mc": mc_native, "ec": ec_native,
            "dav1d": dav1d}
    build = Path(root) / "svt_av1_psy_tpu" / "native" / "build"
    build.mkdir(parents=True, exist_ok=True)
    with open(build / "load.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        for i in range(attempts):
            if i:
                time.sleep(2.0)
            for m in mods.values():
                if m._lib is None and hasattr(m, "_tried"):
                    m._tried = False      # mc_native caches a failed try
            got = {k: m._load() is not None for k, m in mods.items()}
            if all(got.values()):
                break
    return got


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
from bench import _video
from svt_av1_psy_tpu.config import EncoderConfig
from svt_av1_psy_tpu_torch.api import Encoder
from svt_av1_psy_tpu_torch.ops import inter_search, intra_search, tf

W, H, N = 160, 128, 9
frames, u, v = _video(W, H, N)
cfg = EncoderConfig(width=W, height=H, preset=10, recon_enabled=True,
                    stat_report=True)
cfg.qp = 35
cfg.inter_me_backend = "device"
cfg.tf_backend = "device"
enc = Encoder(cfg, device="cpu").init()
pkts = []
for f in frames:
    enc.send_picture(f, u, v.copy())
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
enc.flush()
while (p := enc.get_packet()) is not None:
    pkts.append(p)
enc._me_pipe.drain()
shown = [p for p in pkts if p.recon is not None]
np.savez(sys.argv[2], stream=np.frombuffer(b"".join(p.data for p in pkts), np.uint8),
         **{f"recon{i}_{k}": p.recon[k] for i, p in enumerate(shown) for k in range(3)})
print(json.dumps(dict(
    psnr=float(np.mean([p.stats["psnr_y"] for p in pkts if p.stats])),
    shown=len(shown), intra=intra_search.calls,
    grids=inter_search.calls["grids"], depth=inter_search.calls["depth"],
    tf=tf.calls, jax=sys.modules["jax"] is not None)))
"""


def _reference_encode():
    sys.path.insert(0, str(ROOT))
    from bench import _video
    from svt_av1_psy_tpu.api import Encoder

    frames, u, v = _video(W, H, N)
    cfg = EncoderConfig(width=W, height=H, preset=10, recon_enabled=True,
                        stat_report=True)
    cfg.qp = 35
    cfg.inter_me_backend = "device"
    cfg.tf_backend = "device"
    enc = Encoder(cfg).init()
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


def test_port_encodes_without_jax_and_matches_reference(tmp_path):
    native = load_native_locked()
    assert all(native.values()), f"native libraries failed to load: {native}"
    out = tmp_path / "port.npz"
    r = subprocess.run([sys.executable, "-c", _PORT_ENCODE, str(ROOT), str(out)],
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    info = json.loads(r.stdout.strip().splitlines()[-1])
    assert info["jax"] is False
    # the device branches ran, on their plain versions (host tensors)
    for k in ("intra", "grids", "depth", "tf"):
        assert info[k]["plain"] > 0 and info[k]["kernel"] == 0, (k, info[k])
    data = np.load(out)
    stream = data["stream"].tobytes()
    assert info["shown"] == N

    from svt_av1_psy_tpu.io import dav1d

    if dav1d.available():
        for i in range(N):
            d = dav1d.decode_nth(stream, i, W, H)
            for k in range(3):
                assert np.array_equal(d[k], data[f"recon{i}_{k}"]), (i, k)

    ref_stream, ref_psnr = _reference_encode()
    assert abs(len(stream) - len(ref_stream)) <= 0.02 * len(ref_stream)
    assert abs(info["psnr"] - ref_psnr) <= 0.05
    # measured: every kernel's plain version makes the reference's decisions
    # on this clip, so the streams are byte-identical
    assert stream == ref_stream


def test_refuses_cuda_without_a_card():
    from svt_av1_psy_tpu_torch.api import Encoder

    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    cfg = EncoderConfig(width=64, height=64)
    with pytest.raises(RuntimeError, match="cuda"):
        Encoder(cfg, device="cuda")
    with pytest.raises(RuntimeError):
        Encoder(cfg)                      # the default device is cuda


@pytest.mark.parametrize("option,value,item", [
    ("tpu_mesh_shape", (2, 1), "item 10"),
])
def test_refuses_unported_options(option, value, item):
    from svt_av1_psy_tpu_torch.api import Encoder

    cfg = EncoderConfig(width=64, height=64)
    setattr(cfg, option, value)
    with pytest.raises(SvtAv1Error, match=item):
        Encoder(cfg, device="cpu").init()


@pytest.mark.parametrize("option,value", [
    ("filters_backend", "device"),
    ("tpl_backend", "device"),
    ("tpl_backend", "auto"),
])
def test_accepts_ported_options(option, value):
    """The device TPL (K7) and the device CDEF / SGR sweep (K8, K9) are
    ported: init takes their backends on the CPU."""
    from svt_av1_psy_tpu_torch.api import Encoder

    cfg = EncoderConfig(width=64, height=64)
    setattr(cfg, option, value)
    enc = Encoder(cfg, device="cpu").init()
    assert getattr(enc.config, option) == value


def test_accepts_device_commit_on_cpu():
    """commit_backend="device" is ported (K5 + K6): init accepts it."""
    from svt_av1_psy_tpu_torch.api import Encoder

    cfg = EncoderConfig(width=64, height=64)
    cfg.commit_backend = "device"
    enc = Encoder(cfg, device="cpu").init()
    assert enc.config.commit_backend == "device"


def test_device_resolution():
    from svt_av1_psy_tpu_torch.device import resolve

    assert resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve("meta")


def test_pipeline_reraises_worker_failure():
    """No hidden fallback: a failed search raises from get() instead of
    returning None."""
    from svt_av1_psy_tpu_torch.parallel.pipeline import InterSearchPipeline

    pipe = InterSearchPipeline(bd=8, shapes=((32, 32),), device="cpu")
    z = np.zeros((64, 64), np.uint8)
    bad = dict(key="k", src=0, ref_l=5, ref_a=None, gm=(0, 0), lam=1.0,
               psy_rd=0.0, bias_pct=100.0)      # ref_l indexes no frame
    pipe.submit([z], [bad])
    with pytest.raises(RuntimeError, match="worker failed"):
        pipe.get("k", timeout=60)
    with pytest.raises(KeyError):
        pipe.get("never-submitted")


def test_pipeline_stress_many_chunks():
    """Chunks submitted while earlier results are read, with a short switch
    interval: every key gets exactly its own frame's result."""
    import threading

    from svt_av1_psy_tpu_torch.ops.inter_search import chunk_search, shapes_for
    from svt_av1_psy_tpu_torch.parallel.pipeline import InterSearchPipeline

    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 255, (64, 64)).astype(np.uint8) for _ in range(3)]
    jobs = [dict(key=None, src=i, ref_l=(i + 1) % 3, ref_a=None, gm=(0, 0),
                 lam=20.0, psy_rd=0.5, bias_pct=100.0) for i in range(3)]
    shapes = shapes_for((32,))
    want = chunk_search(frames, jobs, 8, shapes)
    pipe = InterSearchPipeline(bd=8, shapes=shapes, device="cpu")
    got = {}

    def reader(keys):
        for k in keys:
            got[k] = pipe.get(k, timeout=120)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        readers = []
        for c in range(8):
            keys = [(c, i) for i in range(3)]
            pipe.submit(frames, [dict(j, key=k) for j, k in zip(jobs, keys)])
            t = threading.Thread(target=reader, args=(keys,))
            t.start()
            readers.append(t)
        for t in readers:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 24
    for (c, i), res in got.items():
        assert np.array_equal(res[32][0], want[i][32][0]), (c, i)


def test_pipeline_get_times_out():
    from svt_av1_psy_tpu_torch.parallel.pipeline import InterSearchPipeline

    pipe = InterSearchPipeline(bd=8, shapes=((32, 32),), device="cpu")
    pipe._events["slow"] = __import__("threading").Event()
    with pytest.raises(TimeoutError):
        pipe.get("slow", timeout=0.01)


def test_temporal_filter_dispatch():
    """Host backend and small frames take the reference's host filter;
    backend=device runs the port's K4 (plain versions on host tensors)."""
    from svt_av1_psy_tpu.codec.temporal_filter import temporal_filter as ref
    from svt_av1_psy_tpu_torch.codec.temporal_filter import temporal_filter
    from svt_av1_psy_tpu_torch.ops import tf

    rng = np.random.default_rng(1)
    mk = lambda h, w: (rng.integers(0, 255, (h, w)).astype(np.uint8),
                       rng.integers(0, 255, (h // 2, w // 2)).astype(np.uint8),
                       rng.integers(0, 255, (h // 2, w // 2)).astype(np.uint8))
    c, n = mk(48, 48), [mk(48, 48)]
    for a, b in zip(temporal_filter(c, n, 2, 8, backend="device"),
                    ref(c, n, 2, 8, backend="host")):
        assert np.array_equal(a, b)
    c, n = mk(64, 64), [mk(64, 64)]
    before = tf.calls["plain"]
    temporal_filter(c, n, 2, 8, backend="auto", device="cpu")
    assert tf.calls["plain"] == before            # auto on the CPU: host
    temporal_filter(c, n, 2, 8, backend="device", device="cpu")
    # one luma pair stage, one chroma stage, three finalizes
    assert tf.calls["plain"] == before + 5


def test_cli_encodes_on_cpu(tmp_path):
    from svt_av1_psy_tpu.io.y4m import Y4MHeader, Y4MWriter
    from svt_av1_psy_tpu_torch.app import cli

    rng = np.random.default_rng(0)
    y4m = tmp_path / "in.y4m"
    with open(y4m, "wb") as f:
        w = Y4MWriter(f, Y4MHeader(64, 64, 25, 1))
        for _ in range(2):
            w.write_frame(rng.integers(0, 255, (64, 64)).astype(np.uint8),
                          np.full((32, 32), 128, np.uint8),
                          np.full((32, 32), 128, np.uint8))
    out = tmp_path / "out.ivf"
    assert cli.main(["-i", str(y4m), "-b", str(out), "--device", "cpu",
                     "--preset", "10"]) == 0
    assert out.stat().st_size > 32


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    # alone in a directory, without the repository beside it
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    r = subprocess.run([sys.executable, str(lone)], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
