"""Generator ``graph_scrub``: one browser user dragging the low-pass cutoff
over a fixed view, in a closed loop with no think time.

The recording is made from the seed and written as a PCM-16 WAV into the
run's temporary directory; ``audian_torch.data.Data`` opens it with the
configuration's window and ``default_traces()`` at the configuration's
band, and moves to the traffic's view.  Each step sets the filter's
``lowpass_cutoff`` to the next of the traffic's cutoffs, which recomputes
the whole window on the graph, then refreshes the view: the min/max tiles
of ``filtered`` and ``envelope`` and the uint8 dB tiles of
``spectrogram`` on every channel, through the ``view/render.py`` tilers, at
the traffic's fixed colour levels.  A step ends when its tiles are on the
host; a synchronize between the recompute and the refresh splits the
step's host time between the two.  Set-up warms one cycle of the
cutoffs.

Checked: the ``filtered``, ``envelope`` and ``spectrogram`` windows at the
last step's cutoff, and the tiles of the last step and of steps drawn from
the seed, against the configuration's reference.
"""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import scipy.io.wavfile
import torch

from .. import compare, devtrace, recordings
from ..reference import dsp

TRACES = ("filtered", "envelope", "spectrogram")


class Refresh:
    """The view's tiles after a step: min/max of ``filtered`` and
    ``envelope``, uint8 dB of ``spectrogram``, every channel; returns them
    by (trace, channel)."""

    def __init__(self, device, channels, levels):
        from audian_torch.view.render import SpecTiler, TraceTiler

        self.traces = TraceTiler(device=device)
        self.spec = SpecTiler(device=device)
        self.levels = np.tile(np.asarray(levels, np.float32), (channels, 1))

    def __call__(self, d, t0, t1):
        tiles = {}
        for name in TRACES[:2]:
            for c in range(d.channels):
                tiles[name, c] = self.traces.tile(d[name], t0, t1, channel=c)
        for c in range(d.channels):
            tiles["spectrogram", c] = self.spec.tile(
                d["spectrogram"], c, self.levels[c, 0], self.levels[c, 1],
                quantize=True, t0=t0, t1=t1, levels=self.levels)
        return tiles


def open_data(r, path):
    """``Data`` as the browser opens it, with the configuration's window,
    traces and band, at the traffic's view."""
    from audian_torch.data import Data, default_traces

    cfg = r.config
    d = Data(path, buffer_time=cfg["buffer_s"], back_time=cfg["back_s"],
             device=r.device)
    for node in default_traces():
        d.add_trace(node)
    d.open()
    d["filtered"].update(highpass_cutoff=cfg["highpass_hz"],
                         lowpass_cutoff=cfg["lowpass_hz"])
    env, spec = d["envelope"]._node, d["spectrogram"]._node
    got = (env.envelope_cutoff, env.filter_order, spec.nfft, spec.hop)
    want = (cfg["envelope_hz"], cfg["envelope_order"], cfg["nfft"],
            cfg["hop"])
    if got != want:
        raise ValueError(f"default_traces() give {got}, the configuration "
                         f"{want}")
    d.update_times(*r.traffic["view_s"])
    return d


def run(r):
    cfg, tr, dev = r.config, r.traffic, r.device
    rate, C = float(cfg["rate_hz"]), int(cfg["channels"])
    t0, t1 = tr["view_s"]
    cutoffs = tr["cutoffs_hz"]
    gen = recordings.generator(r.seed, dev)
    codes = recordings.songs(gen, tr["recording_s"], C, rate, tr["signal"],
                             dev).cpu().numpy()
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        path = os.path.join(tmp, "recording.wav")
        scipy.io.wavfile.write(path, int(rate), codes)
        out = _scrub(r, path, codes, t0, t1, cutoffs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _scrub(r, path, codes, t0, t1, cutoffs):
    from audian_torch.utils import trace as ptrace

    cfg, tr = r.config, r.traffic
    d = open_data(r, path)
    refresh = Refresh(r.device, d.channels, tr["spec_levels_db"])
    for c in cutoffs:                          # warm-up: one cycle
        d["filtered"].update(lowpass_cutoff=c)
        refresh(d, t0, t1)
    probe = {int(k) for k in r.rng.choice(tr["check_from"],
                                          tr["check_steps"], replace=False)}
    kept, lat = {}, []
    if r.trace:
        ptrace.enable(log=False)
        ptrace.clear()
    r.reset_peak()
    r.setup_done()
    with devtrace.window(r.trace) as traced:
        start = time.perf_counter()
        i = 0
        while True:
            c = cutoffs[i % len(cutoffs)]
            a = time.perf_counter()
            with devtrace.rng("graph"):
                d["filtered"].update(lowpass_cutoff=c)
            r.sync()
            b = time.perf_counter()
            with devtrace.rng("tiles"):
                tiles = refresh(d, t0, t1)
            r.sync()
            e = time.perf_counter()
            lat.append(e - a)
            r.record("graph", b - a)
            r.record("tiles", e - b)
            if i in probe:
                kept[i] = (c, tiles)
            i += 1
            if e - start >= r.seconds:
                break
        window_s = time.perf_counter() - start
    kept[i - 1] = (c, tiles)
    r.read_peak()
    if r.trace:
        r.spans["graph.run"] = [ev["ms"] for ev in ptrace.events("graph.run")]
        ptrace.disable()
    wins = {n: (d[n].offset, d[n].buffer) for n in TRACES}
    r.calls["graph"] = [(cut, len(wins["filtered"][1]),
                         len(wins["envelope"][1]),
                         len(wins["spectrogram"][1]))
                        for cut in (cutoffs[k % len(cutoffs)]
                                    for k in range(i))]
    d.close()
    del d
    r.free()
    if r.variant == "control":
        wins, kept = _control(r, codes, wins, kept, c)
    samples = [_check_windows(r, codes, wins, c)]
    samples += [_check_tiles(r, codes, cut, tiles)
                for cut, tiles in kept.values()]
    p90 = (statistics.quantiles(lat, n=10, method="inclusive")[8]
           if i > 1 else lat[0])
    return {"e2e": {"step_ms_mean": 1e3 * window_s / i,
                    "step_ms_p90": 1e3 * p90},
            "samples": samples, "attempted": i, "trace": traced.trace}


def _check_windows(r, codes, wins, cutoff):
    """The gaps of the three windows at the last step's cutoff."""
    ref = r.cell.reference()
    (of, F), (oe, E), (os_, S) = (wins[n] for n in TRACES)
    lo, hi = min(of, oe), max(of + len(F), oe + len(E))
    y, e = ref.span(r.config, codes, lo, hi, cutoff, r.device)
    out = {"filtered_err": compare.max_abs(F.T, y[:, of - lo :
                                                  of - lo + len(F)]),
           "envelope_err": compare.max_abs(E.T, e[:, oe - lo :
                                                  oe - lo + len(E)])}
    del y, e
    out["psd_db_err"] = compare.db_gap(
        S, ref.spectrogram(r.config, codes, os_, os_ + len(S), cutoff,
                           r.device))
    return out


def _tile_geometry(times, rate):
    """``(start, step, bins)`` of a min/max tile from its times."""
    step = int(round((times[1] - times[0]) * 2 * rate))
    return int(round(times[0] * rate)), step, len(times) // 2


def _spec_geometry(img, rect, rate, hop):
    """``(first frame, pool, rows)`` of a dB tile from its rectangle."""
    frame_rate = rate / hop
    rows = img.shape[0]
    pool = max(int(round(rect[2] * frame_rate / rows)), 1)
    return int(round(rect[0] * frame_rate)), pool, rows


def _ref_tiles(r, codes, cutoff, tiles, precision="float64"):
    """The reference's tiles of the same geometry: min/max by (trace,
    channel) and uint8 dB images by channel."""
    ref = r.cell.reference()
    cfg, C = r.config, int(r.config["channels"])
    rate, hop = float(cfg["rate_hz"]), int(cfg["hop"])
    start, step, w = _tile_geometry(tiles["filtered", 0][0], rate)
    y, e = ref.span(cfg, codes, start, start + w * step, cutoff, r.device,
                    precision)
    out = {}
    for name, s in (("filtered", y), ("envelope", e)):
        for c in range(C):
            out[name, c] = dsp.minmax_tile(s[c], 0, step, w)
    f0, pool, rows = _spec_geometry(*tiles["spectrogram", 0], rate, hop)
    p = ref.spectrogram(cfg, codes, f0, f0 + rows * pool, cutoff, r.device,
                        precision)
    p = p.reshape(rows, pool, *p.shape[1:]).amax(1)
    zmin, zmax = r.traffic["spec_levels_db"]
    for c in range(C):
        out["spectrogram", c] = dsp.db_u8(p[:, c], zmin, zmax)
    return out


def _check_tiles(r, codes, cutoff, tiles):
    """The gaps of one step's tiles: the min/max values (absolute) and the
    share of dB pixels that differ."""
    want = _ref_tiles(r, codes, cutoff, tiles)
    C = int(r.config["channels"])
    err = max(compare.max_abs(torch.as_tensor(tiles[n, c][1]),
                              want[n, c].cpu())
              for n in TRACES[:2] for c in range(C))
    flips = np.mean([compare.differ_share(
        torch.as_tensor(tiles["spectrogram", c][0]),
        want["spectrogram", c].cpu()) for c in range(C)])
    return {"tile_err": err, "spec_tile_flips": float(flips)}


def _control(r, codes, wins, kept, cutoff):
    """The reference in TF32 in the program's place: its windows at the last
    cutoff and its tiles at the kept steps' geometry."""
    ref = r.cell.reference()
    (of, F), (oe, E), (os_, S) = (wins[n] for n in TRACES)
    lo, hi = min(of, oe), max(of + len(F), oe + len(E))
    y, e = ref.span(r.config, codes, lo, hi, cutoff, r.device, "tf32")
    ctl = {"filtered": (of, y[:, of - lo : of - lo + len(F)].T),
           "envelope": (oe, e[:, oe - lo : oe - lo + len(E)].T),
           "spectrogram": (os_, ref.spectrogram(
               r.config, codes, os_, os_ + len(S), cutoff, r.device,
               "tf32"))}
    tiles = {}
    for k, (cut, got) in kept.items():
        t = _ref_tiles(r, codes, cut, got, "tf32")
        tiles[k] = (cut, {key: ((got[key][0], v.cpu().numpy())
                                if key[0] != "spectrogram"
                                else (v.cpu().numpy(), got[key][1]))
                          for key, v in t.items()})
    return ctl, tiles
