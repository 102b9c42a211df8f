"""The device trace of a run: ``torch.profiler`` over the measured window,
reduced from its Chrome trace to what the per-layer metrics read.

The window is the benchmark's own range :data:`WINDOW`; other ranges the
generators put around calls (``portbench.<name>``) are matched to the device
work they launched through the launches' correlation ids.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
from collections import defaultdict

import numpy as np
import torch

#: the range the measured window runs in
WINDOW = "portbench.window"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")
_HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
         "python_function")


def rng(name):
    """A range of the benchmark's own, recorded when a trace is taken."""
    return torch.profiler.record_function(f"portbench.{name}")


class Trace:
    """What the metrics read from one traced window: ``window_s``,
    ``busy_s`` (the union of device work in it), the device seconds by
    kernel name, the device seconds launched inside each occurrence of a
    range, and the breakdown of the window."""

    def __init__(self, events):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW} range")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        dev = [e for e in events if e.get("ph") == "X"
               and str(e.get("cat", "")).lower() in _DEVICE
               and w0 <= float(e["ts"]) <= w1]
        iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in dev)
        merged = []
        for a, b in iv:
            b = min(b, w1)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        self.kernels = defaultdict(lambda: [0.0, 0])
        for e in dev:
            k = self.kernels[e["name"]]
            k[0] += float(e["dur"]) * 1e-6
            k[1] += 1
        self._ranges = self._range_device(events, dev, w0, w1)
        self.breakdown = {
            "device_ops": sorted(([n, s] for n, (s, _) in
                                  self.kernels.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": self._gaps(events, merged, w0, w1)}

    def kernel_s(self, part):
        """``(seconds, launches)`` of the device work whose name holds
        ``part``."""
        hits = [v for n, v in self.kernels.items() if part in n]
        return sum(s for s, _ in hits), sum(c for _, c in hits)

    def range_s(self, name):
        """Device seconds launched inside each occurrence of the range
        ``portbench.<name>``, in order."""
        return self._ranges.get(f"portbench.{name}", [])

    @staticmethod
    def _range_device(events, dev, w0, w1):
        by_corr = defaultdict(float)
        for e in dev:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                by_corr[c] += float(e["dur"]) * 1e-6
        launches = sorted(
            (float(e["ts"]), e.get("tid"), e["args"]["correlation"])
            for e in events if str(e.get("cat", "")).lower() in _LAUNCH
            and "correlation" in e.get("args", {}))
        ts = np.array([t for t, _, _ in launches])
        out = defaultdict(list)
        for e in events:
            if (e.get("cat") != "user_annotation"
                    or not str(e.get("name", "")).startswith("portbench.")
                    or e["name"] == WINDOW
                    or not w0 <= float(e["ts"]) <= w1):
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            i0, i1 = np.searchsorted(ts, a), np.searchsorted(ts, b, "right")
            out[e["name"]].append(sum(
                by_corr.get(c, 0.0) for _, tid, c in launches[i0:i1]
                if tid == e.get("tid")))
        return out

    @staticmethod
    def _gaps(events, merged, w0, w1):
        """The device's idle time in the window, by what the host was doing
        at the start of each gap (the innermost host event there): the ten
        largest sums."""
        gaps = [(a, b) for (_, a), (b, _) in zip(
            [[w0, w0]] + merged, merged + [[w1, w1]]) if b - a > 0]
        host = [e for e in events if e.get("ph") == "X"
                and str(e.get("cat", "")).lower() in _HOST
                and e.get("name") != WINDOW]
        hs = np.array([float(e["ts"]) for e in host])
        he = hs + np.array([float(e["dur"]) for e in host])
        by = defaultdict(float)
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
            t = a + 0.5 * min(b - a, 1.0)
            inside = np.nonzero((hs <= t) & (he >= t))[0]
            name = (host[min(inside, key=lambda i: he[i] - hs[i])]["name"]
                    if len(inside) else "host idle")
            by[name] += (b - a) * 1e-6
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:10]


@contextlib.contextmanager
def window(trace):
    """The measured window, profiled when ``trace``; yields a holder whose
    ``trace`` is the reduced :class:`Trace` after the block (``None``
    untraced)."""
    holder = type("Traced", (), {"trace": None})()
    if not trace:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield holder
    tmp = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    holder.trace = Trace(events)
