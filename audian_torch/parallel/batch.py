"""File-level data parallelism for the batch CLIs.

The counterpart of ``audian_tpu/parallel/batch.py``: ``map_files`` is the
dispatch point of ``audian-songdetector -j``.  A thread per worker, files
handed out to the workers and each worker pinned round-robin to one of
``devices``: the worker makes its device the thread's current CUDA device
(``torch.cuda.device``), which is where the port's default ``"cuda"``
resolves (:func:`audian_torch.utils.resolve_device`), so every file's
dense DSP runs on its worker's device while the host-side event logic of
the other files overlaps with it.  There is no cross-file communication.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from .mesh import local_devices

__all__ = ["map_files"]


def map_files(fn, files, devices=None, max_workers=None, verbose=0):
    """Apply ``fn(path) -> result`` to every file, data-parallel across
    devices.

    Parameters
    ----------
    fn : callable taking a file path; its work on the default device
        ``"cuda"`` runs on the worker's device.
    files : sequence of paths.
    devices : explicit device list (default: every CUDA device; without
        CUDA that raises).  A CPU device pins nothing.
    max_workers : cap on concurrent files (default: one per device).
    verbose : print a dispatch line per file.

    Returns the list of results in input order.  A failing file does not
    abort the others: failures are gathered and the first is re-raised
    once every file has run.  A failure is something ``fn`` RAISES; an
    exception object ``fn`` returns as a value is an ordinary result.
    """
    files = list(files)
    if devices is None:
        devices = local_devices()
    devices = [torch.device(d) for d in devices]
    if not files:
        return []
    nw = max_workers or len(devices)
    nw = max(1, min(nw, len(files)))

    def guarded(path):
        # private failure sentinel (not the raw Exception type, which a
        # per-file error-report fn could legitimately RETURN)
        try:
            return (True, fn(path))
        except Exception as exc:
            return (False, exc)

    def pinned(dev):
        if dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    if nw == 1:
        # same gather-then-reraise semantics as the threaded path: a
        # failing file must not abort the others
        with pinned(devices[0]):
            results = [guarded(f) for f in files]
    else:
        counter = itertools.count()
        lock = threading.Lock()
        slot = threading.local()

        def worker(path):
            if not hasattr(slot, "dev"):
                with lock:
                    slot.dev = devices[next(counter) % len(devices)]
            if verbose:
                print(f"  [{slot.dev}] {path}", flush=True)
            with pinned(slot.dev):
                return guarded(path)

        with ThreadPoolExecutor(max_workers=nw) as pool:
            results = list(pool.map(worker, files))
    for ok, r in results:
        if not ok:
            raise r
    return [r for _ok, r in results]
