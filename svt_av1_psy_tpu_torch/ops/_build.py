"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each kernel source is compiled by `nvcc` into its own shared library with a
plain C interface and loaded with `ctypes` (no PyTorch headers: a build
takes seconds, not minutes); `build_all` starts every nvcc at once. Libraries land in `svt_av1_psy_tpu_torch/build/`
under a name keyed by a hash of the sources and flags, so the first use in a
fresh checkout builds everything and later uses load the cached file.

Flags: `sm_90a` (Hopper), `-O3`, no `--use_fast_math` (the TF weights need
IEEE `expf` and IEEE division, the SGR sweep IEEE float32 multiply, add
and divide) and `-fmad=false` (no multiply-add contraction, so every
float32 expression rounds as the plain PyTorch version rounds it). A missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

KERNELS = {
    "intra_search": "intra_search.cu",
    "ssd_grids": "ssd_grids.cu",
    "inter_decide": "inter_decide.cu",
    "tf": "tf.cu",
    "txfm": "txfm.cu",
    "commit": "commit.cu",
    "tpl": "tpl.cu",
    "cdef": "cdef.cu",
    "lr_search": "lr_search.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_INFO: dict = {}     # name -> {"seconds": s, "ptxas": text, "cached": bool}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.isfile("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot "
                           "be built on this host")
    return path


def _key(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / KERNELS[name]]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(name: str) -> Path:
    key = _key(name)
    lib = BUILD / f"lib{name}_{key}.so"
    log = lib.with_suffix(".log")
    if lib.is_file():
        # a build of this process keeps its own record
        BUILD_INFO.setdefault(name, {
            "seconds": 0.0, "cached": True,
            "ptxas": log.read_text() if log.is_file() else ""})
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / KERNELS[name])]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {r.returncode}):\n"
                           f"{r.stdout}\n{r.stderr}")
    log.write_text(r.stdout + r.stderr)
    os.replace(tmp, lib)
    BUILD_INFO[name] = {"seconds": dt, "cached": False,
                        "ptxas": r.stdout + r.stderr}
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _LIBS[name] = lib
        return lib


def build_all() -> dict:
    """Build every kernel library at once (one nvcc per source, all started
    together), then load them; returns BUILD_INFO."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        for f in [pool.submit(_build, name) for name in KERNELS]:
            f.result()
    for name in KERNELS:
        load(name)
    return dict(BUILD_INFO)


def check(rc: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


_COUNT_LOCK = threading.Lock()     # launch counters and the table cache


def count(calls: dict, key: str):
    """Add one to a wrapper's launch counter (wrappers run on the main
    thread and on the inter-search worker)."""
    with _COUNT_LOCK:
        calls[key] += 1


def on_cuda(t, kernel: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} takes cpu or cuda tensors, not {t.device}")
    return t.device.type == "cuda"


def need(t, shape, dtype, device, kernel: str):
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` (what a kernel's C entry point assumes)."""
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{kernel} argument {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}: want {tuple(shape)} {dtype} contiguous "
                         f"on {device}")


_TABLES: dict = {}


def table(name: str, array, device):
    """A constant int32 table uploaded once per device."""
    import numpy as np

    key = (name, str(device))
    with _COUNT_LOCK:
        t = _TABLES.get(key)
        if t is None:
            t = _TABLES[key] = torch.from_numpy(
                np.ascontiguousarray(array, np.int32)).to(device)
        return t


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """The current CUDA stream of `device` (each thread launches on its own
    current stream)."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
