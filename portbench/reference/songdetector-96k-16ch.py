"""The plain reference of ``songdetector-96k-16ch``: a zero-phase
Butterworth band-pass, its square smoothed forward and backward by a
Butterworth low-pass, ``2 sqrt(max(e, 0))`` kept every ``step`` samples
with ``step`` the rate over ten times the envelope cutoff; designed again
from the configuration and computed in float64 by FFT convolution
(:mod:`.dsp`), a few channels at a time.
"""

from __future__ import annotations

import torch

from . import dsp

#: channels computed at once
BLOCK = 4


def step(cfg):
    """The decimation: the rate over the envelope's rate, ten times its
    cutoff (``songdetector.py``), rounded."""
    rate = float(cfg["rate_hz"])
    env_rate = min(cfg["envelope_hz"] * cfg["envelope_rate_factor"], rate)
    return int(round(rate / env_rate))


def envelope(cfg, xw, hb, nout, precision="float64"):
    """The envelope of a time-first window of codes ``xw`` ``(W, C)`` at
    samples ``hb + j step``, ``j < nout``: ``(nout, C)``."""
    rate = float(cfg["rate_hz"])
    gb, cb = dsp.zero_phase(dsp.butter(
        cfg["filter_order"], (cfg["highpass_hz"], cfg["lowpass_hz"]),
        "bandpass", rate))
    gl, cl = dsp.zero_phase(dsp.butter(
        cfg["envelope_order"], cfg["envelope_hz"], "lowpass", rate))
    s = step(cfg)
    out = []
    for c0 in range(0, xw.shape[1], BLOCK):
        x = xw[:, c0 : c0 + BLOCK].T.to(dsp.dtype(precision)) / 32768.0
        y = dsp.centred(x, gb, cb, precision)
        e = dsp.centred(y * y, gl, cl, precision)
        e = e[:, hb : hb + (nout - 1) * s + 1 : s]
        out.append(2.0 * torch.sqrt(torch.clamp_min(e, 0.0)))
        del x, y
    return torch.cat(out).T
