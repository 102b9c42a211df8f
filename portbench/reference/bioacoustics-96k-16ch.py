"""The plain reference of ``bioacoustics-96k-16ch``: a causal Butterworth
band-pass, the pi/2-rectified envelope smoothed forward and backward by a
Butterworth low-pass and clamped at zero, and the density PSD of Hann
frames at hop 128, all designed again from the configuration and computed
in float64 by FFT convolution (:mod:`.dsp`), a few channels at a time.

Streams are channels-first ``(C, frames)``; ``codes`` are PCM-16, read as
``k / 2^15``.
"""

from __future__ import annotations

import math

import torch

from . import dsp

#: channels computed at once
BLOCK = 4
#: samples of warm-up on each side of a span of a recording (two seconds
#: at 96 kHz: both designs decay to round-off well inside it)
WARM = 192000


def designs(cfg, lowpass_hz=None):
    """``(h, g, c)``: the band-pass's impulse response, the envelope's
    zero-phase kernel and its centre."""
    rate = float(cfg["rate_hz"])
    lp = float(cfg["lowpass_hz"] if lowpass_hz is None else lowpass_hz)
    h = dsp.impulse(dsp.butter(cfg["filter_order"],
                               (cfg["highpass_hz"], lp), "bandpass", rate))
    g, c = dsp.zero_phase(dsp.butter(cfg["envelope_order"],
                                     cfg["envelope_hz"], "lowpass", rate))
    return h, g, c


def streams(x, h, g, c, precision="float64"):
    """Filtered and envelope of unit-scale rows ``x``."""
    y = dsp.causal(x, h, precision)
    e = dsp.centred((math.pi / 2) * y.abs(), g, c, precision)
    return y, torch.clamp_min(e, 0.0)


def chain(cfg, x_ext, hb, n, precision="float64"):
    """The chain over one extended chunk ``x_ext = [hb | n | tail]`` of
    codes: ``filtered`` and ``envelope`` ``(C, n)``, ``psd`` ``(n // hop,
    C, nbins)`` (frame ``f`` from sample ``f hop``), and the chunk's
    ``power`` (sum of filtered^2), ``env_sum`` and ``psd_sum``."""
    h, g, c = designs(cfg)
    hop, nfft = int(cfg["hop"]), int(cfg["nfft"])
    parts = []
    for c0 in range(0, x_ext.shape[0], BLOCK):
        x = x_ext[c0 : c0 + BLOCK].to(dsp.dtype(precision)) / 32768.0
        y, e = streams(x, h, g, c, precision)
        p = dsp.psd(y[:, hb:], 0, n // hop, nfft, hop,
                    float(cfg["rate_hz"]), precision)
        parts.append((y[:, hb : hb + n], e[:, hb : hb + n], p))
        del x, y, e
    y, e, p = (torch.cat(z, dim=1 if i == 2 else 0)
               for i, z in enumerate(zip(*parts)))
    return {"filtered": y, "envelope": e, "psd": p,
            "power": (y * y).sum(1), "env_sum": e.sum(1),
            "psd_sum": p.sum(0)}


def span(cfg, codes, lo, hi, lowpass_hz, device, precision="float64"):
    """Filtered and envelope ``(C, hi - lo)`` of the recording's samples
    ``[lo, hi)`` at ``lowpass_hz``, from ``codes`` ``(frames, C)`` with
    :data:`WARM` samples of warm-up on each side."""
    h, g, c = designs(cfg, lowpass_hz)
    a, b = max(lo - WARM, 0), min(hi + WARM, codes.shape[0])
    ys, es = [], []
    for c0 in range(0, codes.shape[1], BLOCK):
        x = torch.as_tensor(codes[a:b, c0 : c0 + BLOCK].T.copy(),
                            device=device).to(dsp.dtype(precision))
        y, e = streams(x / 32768.0, h, g, c, precision)
        ys.append(y[:, lo - a : hi - a])
        es.append(e[:, lo - a : hi - a])
        del x, y, e
    return torch.cat(ys), torch.cat(es)


def spectrogram(cfg, codes, f0, f1, lowpass_hz, device,
                precision="float64"):
    """The PSD ``(f1 - f0, C, nbins)`` of the recording's frames
    ``[f0, f1)`` (frame ``f`` from sample ``f hop``)."""
    hop, nfft = int(cfg["hop"]), int(cfg["nfft"])
    y, _ = span(cfg, codes, f0 * hop, (f1 - 1) * hop + nfft, lowpass_hz,
                device, precision)
    return dsp.psd(y, 0, f1 - f0, nfft, hop, float(cfg["rate_hz"]),
                   precision)
