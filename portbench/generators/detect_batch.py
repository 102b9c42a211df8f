"""Generator ``detect_batch``: the song detector's decimating envelope over
recording hours resident on the card.

The hour is made from the seed as one time-first ``(frames, C)`` int16
tensor with the detector's halo of zeros before and after, so that each
window is a contiguous slice of it: ``chunk + 2 halo`` frames from every
``chunk``-th frame, in the layout the detector hands its envelope.  The
window runs whole hours, each window through the ``EnvDetKernel`` that
``analysis/events.py:_make_envdet`` builds for the configuration's designs,
dispatched ahead; the envelopes stay on the card, and the hour ends in a
synchronize.  Set-up warms the shape with one hour.

Checked: the envelopes of windows of the window's last hour drawn from
the seed against the configuration's reference.
"""

from __future__ import annotations

import time

import scipy.signal as sps
import torch

from .. import compare, devtrace, recordings


def step(cfg):
    """The detector's decimation: the rate over ten times the envelope
    cutoff (``analysis/events.py:band_env``), rounded."""
    rate = float(cfg["rate_hz"])
    return int(round(rate / min(cfg["envelope_hz"]
                                * cfg["envelope_rate_factor"], rate)))


def _envdet(cfg, device, precision=None):
    """``(envdet, chunk, halo)``: the program's decimating envelope for the
    configuration, as the detector builds it, or (``precision`` given) the
    same kernel at that rung."""
    from audian_torch.analysis.events import _make_envdet, detect_halo
    from audian_torch.ops.cuda.envdet import EnvDetKernel
    from audian_torch.ops.design import FilterDesign

    rate = float(cfg["rate_hz"])
    fd = FilterDesign.from_sos(sps.butter(
        cfg["filter_order"], (cfg["highpass_hz"], cfg["lowpass_hz"]),
        "bandpass", fs=rate, output="sos"), eps=cfg["fir_truncation_eps"])
    ed = FilterDesign.from_sos(sps.butter(
        cfg["envelope_order"], cfg["envelope_hz"], "lowpass", fs=rate,
        output="sos"), eps=cfg["fir_truncation_eps"])
    halo = detect_halo(fd, ed)
    kernel, chunk = _make_envdet(fd, ed, step(cfg), halo, device)
    if precision is not None:
        kernel = EnvDetKernel(fd, ed, step(cfg), kernel.nout, hb=halo,
                              precision=precision, device=device)
    return kernel, chunk, halo


def run(r):
    cfg, tr, dev = r.config, r.traffic, r.device
    rate, C = float(cfg["rate_hz"]), int(cfg["channels"])
    envdet, chunk, halo = _envdet(
        cfg, dev, None if r.variant == "program" else tr["control_precision"])
    W = int(tr["chunk_frames"]) + 2 * halo
    if envdet.window_need(halo) > W:
        raise ValueError(f"the envelope needs {envdet.window_need(halo)} "
                         f"frames, the window holds {W}")
    total = int(round(tr["recording_s"] * rate))
    nwin = -(-total // chunk)
    hour_x = torch.zeros((nwin * chunk + W - chunk, C), dtype=torch.int16,
                         device=dev)
    gen = recordings.generator(r.seed, dev)
    piece = 1 << 22
    for a in range(0, total, piece):
        m = min(piece, total - a)
        hour_x[halo + a : halo + a + m] = recordings.gated_tone(
            gen, a, m, C, rate, tr["signal"], dev)

    def hour(keep=(), kept=None, enqueue=None):
        for k in range(nwin):
            xw = hour_x[k * chunk : k * chunk + W]
            a = time.perf_counter()
            env = envdet(xw, halo)
            if enqueue is not None:
                enqueue.append(time.perf_counter() - a)
            if k in keep:
                kept[k] = env
        r.sync()

    hour()                                    # warm-up
    keep = tuple(int(k) for k in r.rng.choice(nwin, tr["check_windows"],
                                              replace=False))
    kept, enqueue = {}, []
    r.reset_peak()
    r.setup_done()
    hours = 0
    with devtrace.window(r.trace) as traced:
        t0 = time.perf_counter()
        while True:
            hour(keep, kept, enqueue)
            hours += 1
            if time.perf_counter() - t0 >= r.seconds:
                break
        window_s = time.perf_counter() - t0
    r.read_peak()
    r.host["enqueue.envdet"] = enqueue
    r.calls["envdet"] = [(W, envdet.nout, step(cfg))] * (nwin * hours)
    nout = envdet.nout
    inputs = {k: hour_x[k * chunk : k * chunk + W].clone() for k in keep}
    del hour_x, envdet
    r.free()
    ref = r.cell.reference()
    samples = [{"envelope_rel_err": compare.rel_scale(
        kept.pop(k), ref.envelope(cfg, inputs[k], halo, nout))}
        for k in keep]
    rec_h = tr["recording_s"] / 3600.0
    return {"e2e": {"batch_s_per_rec_h": window_s / (hours * rec_h)},
            "samples": samples, "attempted": hours * nwin,
            "trace": traced.trace}

