"""Structured runtime tracing.

The counterpart of ``audian_tpu/utils/trace.py``: the same event kinds and
fields land in a structured in-memory event log that can be mirrored to
``logging`` (enable with ``AUDIAN_TORCH_TRACE=1`` or :func:`enable`), plus
a context manager around ``torch.profiler``.  A span times the host work
of its block and waits for nothing: where the block ends in a pull
(``.cpu()``) its time includes the device work before it, otherwise it
times the launches.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import Counter, deque

__all__ = ["trace_event", "events", "clear", "enable", "disable",
           "summary", "timed", "device_profile"]

logger = logging.getLogger("audian_torch")

_lock = threading.Lock()
_events = deque(maxlen=10000)
_enabled = bool(os.environ.get("AUDIAN_TORCH_TRACE"))


def enable(log=True):
    """Turn tracing on (optionally mirroring to the ``audian_torch``
    logger)."""
    global _enabled
    _enabled = True
    with _lock:  # concurrent enables must not install two handlers
        if log and not logger.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter("audian %(message)s"))
            logger.addHandler(handler)
            logger.setLevel(logging.INFO)


def disable():
    global _enabled
    _enabled = False


def trace_event(kind, **fields):
    """Record one structured event (no-op unless tracing is enabled)."""
    if not _enabled:
        return
    ev = dict(kind=kind, t=time.time(), **fields)
    with _lock:
        _events.append(ev)
    if logger.isEnabledFor(logging.INFO):
        body = " ".join(f"{k}={v}" for k, v in fields.items())
        logger.info("%s %s", kind, body)


def events(kind=None):
    with _lock:
        evs = list(_events)
    if kind is None:
        return evs
    return [e for e in evs if e["kind"] == kind]


def clear():
    with _lock:
        _events.clear()


def summary():
    """Event counts and total wall time per kind."""
    out = {}
    for e in events():
        s = out.setdefault(e["kind"], Counter())
        s["count"] += 1
        if "ms" in e:
            s["ms"] += e["ms"]
    return {k: dict(v) for k, v in out.items()}


@contextlib.contextmanager
def timed(kind, **fields):
    """Trace the wall time of a block as an event with an ``ms`` field."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        trace_event(kind, ms=round((time.perf_counter() - t0) * 1e3, 3),
                    **fields)


@contextlib.contextmanager
def device_profile(path):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    a card, the device, exported as a Chrome trace to ``path`` (view it in
    Perfetto or ``chrome://tracing``)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path))
