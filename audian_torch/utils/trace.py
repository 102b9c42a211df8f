"""Structured runtime tracing.

The counterpart of ``audian_tpu/utils/trace.py``: the same event kinds and
fields land in a structured in-memory log that can be mirrored to
``logging``, plus a context manager around ``torch.profiler``.

Tracing is on while :func:`enable` or ``AUDIAN_TORCH_TRACE=1`` says so, and
while a ``torch.profiler`` session records.  :func:`timed` is the span:
its record holds ``kind``, ``id``, ``parent`` (the id of the enclosing span
on the same thread, or ``None``), ``t0_ns`` and ``t1_ns`` from
``time.perf_counter_ns()``, ``ms``, and the caller's fields.  With
``device=`` a CUDA device it also holds ``device_ms``, the time between two
CUDA events recorded on that device's current stream at the span's ends;
it is resolved without waiting where a thread's outermost span closes, or
when the log is read, never inside a span.  Under a
profiler each span also enters ``record_function("audian.<kind>")``, so
it sits in the exported Chrome trace on the device trace's clock, with the
launches made inside it nested under it.  A span times the host work of
its block and waits for nothing: where the block ends in a pull
(``.cpu()``) its host time includes the device work before it, otherwise
it times the launches.  :func:`tag` adds a field to the innermost open
span from code that runs inside it (the FIR path a node took).

The log keeps per-kind aggregates that never drop (:func:`summary`) and a
ring of the last :data:`RING` records (:func:`events`) that counts what it
drops.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from collections import deque

import numpy as np
import torch

__all__ = ["trace_event", "events", "clear", "enable", "disable",
           "summary", "tag", "timed", "device_profile", "idle_by_span"]

logger = logging.getLogger("audian_torch")

#: records the ring holds: a 40 s traced scrub window makes about 10 a step
RING = 1 << 16
#: unresolved device-timed spans kept before the passed ones are resolved
_RESOLVE_AT = 32

_lock = threading.Lock()
_ring = deque(maxlen=RING)
#: kind -> {"count", "ms", "device_ms", "bytes", "dropped"} (what applies)
_agg = {}
#: (record, start event, end event) of device-timed spans, oldest first
_pending = deque()
#: device index -> CUDA timing events ready for reuse
_pool = {}
_ids = itertools.count(1)
_local = threading.local()
_enabled = bool(os.environ.get("AUDIAN_TORCH_TRACE"))
_profiling = torch.autograd._profiler_enabled


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


def _stack():
    """This thread's open spans' records, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _add(rec):
    """Put a finished record into the ring and the aggregates (under
    ``_lock``)."""
    if len(_ring) == RING:
        _agg[_ring[0]["kind"]]["dropped"] += 1
    _ring.append(rec)
    a = _agg.get(rec["kind"])
    if a is None:
        a = _agg[rec["kind"]] = {"count": 0, "dropped": 0}
    a["count"] += 1
    for key in ("ms", "bytes"):
        if key in rec:
            a[key] = a.get(key, 0) + rec[key]


def _log(rec, skip):
    if logger.isEnabledFor(logging.INFO):
        body = " ".join(f"{k}={v}" for k, v in rec.items() if k not in skip)
        logger.info("%s %s", rec["kind"], body)


def trace_event(kind, **fields):
    """Record one point event (no-op unless tracing is on), with its
    ``parent`` span and ``t_ns``."""
    if not (_enabled or _profiling()):
        return
    stack = _stack()
    rec = dict(kind=kind, parent=stack[-1]["id"] if stack else None,
               t_ns=time.perf_counter_ns(), **fields)
    with _lock:
        _add(rec)
    _log(rec, ("kind", "parent", "t_ns"))


class _Off:
    """The span while tracing is off: one shared object that records
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __setitem__(self, key, value):
        pass


_OFF = _Off()


def _event(index):
    pool = _pool.get(index)
    return pool.pop() if pool else torch.cuda.Event(enable_timing=True)


def _resolve(wait):
    """Give the pending device-timed spans their ``device_ms``, oldest
    first: all of them, waiting on each (``wait``), or those whose end
    event has passed, stopping at the first that has not (under
    ``_lock``)."""
    while _pending:
        rec, ev0, ev1, index = _pending[0]
        if wait:
            ev1.synchronize()
        elif not ev1.query():
            return
        _pending.popleft()
        ms = ev0.elapsed_time(ev1)
        rec["device_ms"] = ms
        a = _agg[rec["kind"]]
        a["device_ms"] = a.get("device_ms", 0.0) + ms
        _pool.setdefault(index, []).extend((ev0, ev1))


class _Span:
    __slots__ = ("rec", "rf", "ev", "index", "stream")

    def __init__(self, kind, device, fields):
        self.rec = dict(kind=kind, id=next(_ids), parent=None, **fields)
        self.rf = self.ev = self.stream = None
        self.index = None
        if device is not None:
            device = torch.device(device)
            if device.type == "cuda":
                self.index = (device.index if device.index is not None
                              else torch.cuda.current_device())

    def __setitem__(self, key, value):
        self.rec[key] = value

    def __enter__(self):
        rec = self.rec
        stack = _stack()
        if stack:
            rec["parent"] = stack[-1]["id"]
        stack.append(rec)
        if _profiling():
            self.rf = torch.profiler.record_function("audian." + rec["kind"])
            self.rf.__enter__()
        if self.index is not None:
            with _lock:
                self.ev = _event(self.index)
            self.stream = torch.cuda.current_stream(self.index)
            self.ev.record(self.stream)
        rec["t0_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        ev1 = None
        if self.ev is not None:
            with _lock:
                ev1 = _event(self.index)
            ev1.record(self.stream)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        rec["t1_ns"] = t1
        rec["ms"] = (t1 - rec["t0_ns"]) * 1e-6
        with _lock:
            _add(rec)
            if ev1 is not None:
                _pending.append((rec, self.ev, ev1, self.index))
            # resolving costs a query and an elapsed time a pair: done
            # where the thread's outermost span closes, so that no
            # enclosing span's time holds it
            if not stack and len(_pending) > _RESOLVE_AT:
                _resolve(wait=False)
        _log(rec, ("kind", "id", "parent", "t0_ns", "t1_ns"))
        return False


def tag(key, value):
    """Add ``value`` to the field ``key`` of the innermost span open on
    this thread, after a comma where the field holds one already (so that
    a span records each of several calls inside it); a no-op while
    tracing is off or no span is open."""
    if not (_enabled or _profiling()):
        return
    stack = _stack()
    if stack:
        rec = stack[-1]
        rec[key] = f"{rec[key]},{value}" if key in rec else value


def timed(kind, device=None, **fields):
    """The span of a block: ``with timed(kind, **fields) as span:``.
    ``span[key] = value`` adds a field known only inside the block (such
    as the bytes of a pull).  With ``device=`` a CUDA device the span is
    also timed on that device (``device_ms``); another device is timed on
    the host only.  While tracing is off this returns one shared object
    that does nothing."""
    if not (_enabled or _profiling()):
        return _OFF
    return _Span(kind, device, fields)


def events(kind=None):
    """The ring's records (of ``kind``), oldest first, their device times
    resolved (waiting only on the spans still pending)."""
    with _lock:
        _resolve(wait=True)
        evs = list(_ring)
    if kind is None:
        return evs
    return [e for e in evs if e["kind"] == kind]


def clear():
    """Empty the ring and the aggregates; spans still pending on the
    device are dropped unresolved."""
    with _lock:
        _pending.clear()
        _ring.clear()
        _agg.clear()


def summary():
    """Per kind: ``count``, ``dropped`` (records the ring lost), and where
    they apply the sums ``ms`` (host), ``device_ms`` and ``bytes``; exact
    however many records the ring dropped."""
    with _lock:
        _resolve(wait=True)
        return {k: dict(v) for k, v in _agg.items()}


@contextlib.contextmanager
def device_profile(path):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    a card, the device, exported as a Chrome trace to ``path`` (view it in
    Perfetto or ``chrome://tracing``; :func:`idle_by_span` reads it)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path))


#: Chrome-trace categories of work on the device
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside any span"


def idle_by_span(chrome_trace, within=None):
    """The device's idle seconds in a Chrome trace (a path, the exported
    dict, or its list of events), grouped by the innermost ``audian.*``
    range that encloses the start of each gap, with :data:`OUTSIDE` as a
    group of its own; largest first.  ``within`` names one range of the
    trace (its first occurrence) to look inside; by default the whole
    trace, from its first event's start to its last event's end."""
    evs = chrome_trace
    if isinstance(evs, (str, os.PathLike)):
        with open(evs) as f:
            evs = json.load(f)
    if isinstance(evs, dict):
        evs = evs["traceEvents"]
    xs = [e for e in evs if e.get("ph") == "X"]
    if within is None:
        w0 = min(float(e["ts"]) for e in xs)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in xs)
    else:
        win = next((e for e in xs if e.get("name") == within), None)
        if win is None:
            raise ValueError(f"the trace holds no range {within!r}")
        w0 = float(win["ts"])
        w1 = w0 + float(win["dur"])
    busy = sorted((max(float(e["ts"]), w0),
                   min(float(e["ts"]) + float(e["dur"]), w1))
                  for e in xs
                  if str(e.get("cat", "")).lower() in _DEVICE_CATS)
    gaps, t = [], w0
    for a, b in busy:
        if b <= a:
            continue
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    if not gaps:
        return {}
    starts = np.array([a for a, _ in gaps])
    length = np.array([b - a for a, b in gaps])
    best = np.full(len(gaps), np.inf)
    owner = np.full(len(gaps), -1)
    # the host's ranges (the device's copies of them, ``gpu_user_annotation``,
    # cover the work and not what the host was doing)
    ranges = [e for e in xs if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("audian.")]
    for k, e in enumerate(ranges):
        s, d = float(e["ts"]), float(e["dur"])
        i0 = np.searchsorted(starts, s, "left")
        i1 = np.searchsorted(starts, s + d, "left")
        inner = np.arange(i0, i1)[best[i0:i1] > d]
        best[inner] = d
        owner[inner] = k
    out = {}
    for k, sec in zip(owner, length * 1e-6):
        name = ranges[k]["name"] if k >= 0 else OUTSIDE
        out[name] = out.get(name, 0.0) + float(sec)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
