"""Forward step of the flagship chain on the port's per-op path.

``entry()`` returns ``(step, example_args)``: the causal band-pass
(``sosfilt_fir``), the pi/2-rectified zero-phase envelope
(``sosfiltfilt_fir``, clamped at zero) and the Hann PSD spectrogram of a
time-first ``(n, channels)`` signal — the same step as the JAX package's
``__graft_entry__.entry()``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops.design import FilterDesign, design_envelope_filter, design_filter
from .ops.sos import sosfilt_fir, sosfiltfilt_fir
from .ops.stft import hann_window, spectrogram
from .utils import resolve_device

__all__ = ["RATE", "entry"]

RATE = 96000.0


def _designs():
    filt = FilterDesign.from_sos(design_filter(RATE, 2000.0, 40000.0))
    env = FilterDesign.from_sos(design_envelope_filter(RATE, 500.0))
    return filt, env


def entry(device=None):
    """(fn, example_args) — the forward step and a 2-channel 30 kHz tone
    of 2^15 samples on ``device`` (the CUDA card by default; "cpu" runs
    on the host)."""
    device = resolve_device(device)
    nfft, hop = 256, 128
    window = hann_window(nfft)

    def step(x, filt, env):
        y = sosfilt_fir(filt.fir, x, axis=0, return_zf=False)
        rect = (math.pi / 2) * torch.abs(y)
        e = torch.clamp_min(
            sosfiltfilt_fir(env.fir, rect, env.zi0, env.padlen, axis=0), 0.0)
        s = spectrogram(y, RATE, nfft, hop, window=window)
        return {"filtered": y, "envelope": e, "spectrogram": s}

    filt, env = _designs()
    n = 1 << 15
    t = np.arange(n, dtype=np.float32) / RATE
    x = np.stack([np.sin(2 * np.pi * 30000.0 * t)] * 2, axis=1)
    x = torch.from_numpy(x.astype(np.float32)).to(device)
    return step, (x, filt, env)
