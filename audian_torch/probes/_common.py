"""What the probes share: one timed configuration, its printed line and
each probe's ``main``; ``chip_smoke.py`` times and names the card with the
same :func:`median_ms`, :func:`host_us` and :func:`card_line`."""

from __future__ import annotations

import shutil
import subprocess
import time

import torch

from ..utils import resolve_device

#: device-memory rate of one H100 SXM (HBM3, the published peak)
PEAK_BYTES = 3.35e12
#: the recordings' sample rate, for seconds per recording hour
RATE = 96000.0
#: timed runs a configuration, after one warm-up
REPS = 5
#: calls back to back a timed run of a probe's configuration, as the
#: reference's probes time them (``benchmarks/*_bench.py``: 8 calls, one
#: fence)
CALLS = 8
#: the seed of every probe's input
SEED = 0


def median_ms(fn, device=None, reps=REPS, calls=1):
    """``fn()`` once as a warm-up, then on a CUDA device (the current one
    where ``device`` is None) the median CUDA-event ms of ``reps`` runs;
    with ``calls`` > 1 each run is that many calls back to back, divided by
    ``calls``, so that the host's enqueue of one call overlaps the card's
    work on the one before (a kernel's device time).  ``None`` on another
    device, where a time would be the host's."""
    fn()
    if device is not None and device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        times.append(a.elapsed_time(b) / calls)
    return float(sorted(times)[len(times) // 2])


def host_us(fn, calls=200, rounds=3):
    """The host's microseconds a call of ``fn`` on the CUDA card (its
    enqueue): ``perf_counter`` over ``calls`` calls with no synchronize
    inside, the median of ``rounds`` runs, each after a synchronize."""
    fn()
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        a = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - a) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(out)[len(out) // 2]


def measure(kernel, label, fn, nbytes, samples, device):
    """One configuration: ``fn`` timed by :func:`median_ms` over
    :data:`CALLS` calls back to back (``ms``, the card's time, as the
    reference times it) and as a lone call (``lone_ms``, the host's enqueue
    in it), with the rates its ``nbytes`` of reads plus writes and
    ``samples`` a channel give at ``ms``."""
    ms = median_ms(fn, device, calls=CALLS)
    row = {"kernel": kernel, "label": label, "ms": ms,
           "lone_ms": median_ms(fn, device), "bytes": int(nbytes),
           "samples": int(samples), "gbps": None, "share": None,
           "s_per_hour": None}
    if ms is not None:
        row["gbps"] = nbytes / ms / 1e6
        row["share"] = nbytes / ms / 1e-3 / PEAK_BYTES
        row["s_per_hour"] = ms * 1e-3 * 3600 * RATE / samples
    return row


def line(row):
    """A row as the reference prints it, with its rates, and its lone
    call's time after them."""
    if row["ms"] is None:
        return f"{row['label']:40s} not measured (no card)"
    return (f"{row['label']:40s} {row['ms']:9.4f} ms/call  "
            f"{row['gbps']:7.1f} GB/s r+w  {100 * row['share']:5.1f} % of "
            f"{PEAK_BYTES / 1e12:.2f} TB/s  {row['s_per_hour']:7.4f} "
            f"s/h-equiv  (lone call {row['lone_ms']:.4f} ms)")


def card_line(device=None):
    """``nvidia-smi``'s name and power limit of the card (card 0 where
    ``device`` is None), or the device's name where the tool is missing."""
    index = 0 if device is None else device.index or 0
    tool = shutil.which("nvidia-smi")
    if tool:
        out = subprocess.run(
            [tool, "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(index)


def main(sweep):
    """Run ``sweep`` on the CUDA card and print its lines; raises without
    CUDA (a host time is no card figure)."""
    device = resolve_device(None)
    print(f"card: {card_line(device)}", flush=True)
    sweep(device=device, echo=True)
    return 0
