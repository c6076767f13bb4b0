"""Host/device pipelined inter search of the port.

A twin of `svt_av1_psy_tpu/parallel/pipeline.py`. One worker thread runs the
open-loop search of whole mini-GoP chunks (`ops/inter_search.chunk_search`:
K2 + K3) while the main thread commits earlier frames. On CUDA the worker
owns one `torch.cuda.Stream` and launches every kernel on it; each job's
packed result is copied to pinned host memory and that copy is awaited
before the result is posted.

Unlike the reference, nothing here hides a failure: a worker exception is
stored and re-raised from `get()` (and from every later call), and a
`get()` that times out raises.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from svt_av1_psy_tpu.profiling import stage


class InterSearchPipeline:
    """One background worker feeding open-loop decision rows to commits."""

    def __init__(self, bd: int = 8, shapes=((8, 8), (16, 16), (32, 32),
                                             (64, 64)), device="cpu"):
        self.bd = int(bd)
        self.shapes = tuple((int(w), int(h)) for (w, h) in shapes)
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue()
        self._results: dict = {}
        self._events: dict = {}
        self._lock = threading.Lock()
        self._error = None
        self._thread = threading.Thread(
            target=self._worker, name="inter-search", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- API
    def warm(self, h: int, w: int):
        """Run both search variants once on (h, w) frames off the critical
        path (builds the kernels on first use)."""
        z = np.zeros((h, w), np.uint8 if self.bd == 8 else np.uint16)
        jobs = [dict(key=None, src=0, ref_l=1, ref_a=2, gm=(0, 0),
                     lam=20.0, psy_rd=0.0, bias_pct=100.0),
                dict(key=None, src=1, ref_l=0, ref_a=None, gm=(0, 0),
                     lam=20.0, psy_rd=0.0, bias_pct=100.0)]
        self._q.put(([z, z, z], jobs))

    def submit(self, frames, jobs):
        """frames: list of (h, w) source planes; jobs: dicts with keys {key,
        src, ref_l, ref_a, gm, lam, psy_rd, bias_pct}; `key` is the
        caller's handle (None for no result)."""
        self._raise_if_failed()
        with self._lock:
            for j in jobs:
                if j["key"] is not None:
                    self._events[j["key"]] = threading.Event()
        self._q.put((frames, jobs))

    def get(self, key, timeout: float = 600.0):
        """Block until `key`'s {shape: (rows, costs)} result arrives."""
        with self._lock:
            ev = self._events.get(key)
        if ev is None:
            raise KeyError(f"no inter search was submitted for {key!r}")
        if not ev.wait(timeout):
            raise TimeoutError(f"inter search for {key!r} did not finish "
                               f"within {timeout} s")
        self._raise_if_failed()
        with self._lock:
            self._events.pop(key, None)
            return self._results.pop(key)

    def drain(self):
        """Wait until the queue is empty; re-raise a worker failure."""
        self._q.join()
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            raise RuntimeError("inter search worker failed") from self._error

    # ----------------------------------------------------------- worker
    def _worker(self):
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        while True:
            frames, jobs = self._q.get()
            try:
                if self._error is None:
                    with stage("device:inter_search"):
                        if stream is not None:
                            with torch.cuda.stream(stream):
                                self._run_chunk(frames, jobs)
                        else:
                            self._run_chunk(frames, jobs)
            except Exception as e:            # stored, re-raised by get()
                self._error = e
            finally:
                if self._error is not None:
                    self._wake(jobs)
                self._q.task_done()

    def _run_chunk(self, frames, jobs):
        from ..ops import inter_search as dev

        def post(j, res):
            key = jobs[j]["key"]
            if key is None:
                return
            with self._lock:
                self._results[key] = res
                ev = self._events.get(key)
                if ev is not None:
                    ev.set()

        dev.chunk_search(frames, jobs, self.bd, self.shapes, post=post,
                         device=self.device)

    def _wake(self, jobs):
        with self._lock:
            for j in jobs:
                ev = self._events.get(j["key"])
                if ev is not None:
                    ev.set()


_PIPELINE = None


def get_pipeline(bd: int = 8, depths=(8, 16, 32, 64), rect: bool = False,
                 device="cpu"):
    """Process-wide singleton per (bd, shapes, device)."""
    from ..ops.inter_search import shapes_for

    global _PIPELINE
    shapes = shapes_for(tuple(depths), rect)
    device = torch.device(device)
    if (_PIPELINE is None or _PIPELINE._error is not None
            or _PIPELINE.bd != bd or _PIPELINE.shapes != shapes
            or _PIPELINE.device != device):
        _PIPELINE = InterSearchPipeline(bd=bd, shapes=shapes, device=device)
    return _PIPELINE


def device_backend_default(device) -> bool:
    """The device search is the default when the encoder's device is CUDA."""
    return torch.device(device).type == "cuda"
