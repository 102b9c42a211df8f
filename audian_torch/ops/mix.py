"""Playback mix-down on tensors: channel averaging, heterodyne shifting,
anti-alias decimation and fades.

The counterpart of ``audian_tpu/ops/mix.py``.  The selected channels are
averaged into at most two output channels (first half left, second half
right); with heterodyning on, the mix is multiplied by ``sin(2 pi f t)``,
low-passed at 20 kHz with a zero-phase filter and decimated, bringing
ultrasonic content into the audible band; 0.1 s sine-squared fades end it.

Every function takes PCM integers as well as floats: a signed integer
input is scaled by 2^(bits-1) (int16 codes to ``k / 2**15``, int32 to
``k / 2**31``), where the JAX package scales only int16 and casts other
integers unscaled.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import on_device
from .design import FilterDesign, design_filter
from .sos import sosfiltfilt_fir

__all__ = ["fade", "heterodyne", "prepare_playback", "stereo_mixdown"]

HETERODYNE_CUTOFF = 20000.0  # Hz, the reference's playback low-pass


def _as_float(x):
    """A signed integer tensor as float32 scaled by 2^(bits-1) (exact for
    int16, correctly rounded for int32); floats pass unchanged, other
    integers are cast."""
    if x.dtype.is_floating_point:
        return x
    if x.dtype.is_signed:
        bits = torch.iinfo(x.dtype).bits
        return (x.to(torch.float64) * 2.0 ** (1 - bits)).to(torch.float32)
    return x.to(torch.float32)


def _carrier(a, b, cycles_per_sample):
    """Host float64 carrier samples for frames [a, b): the phase reduced
    mod 1 before the sine, so long recordings keep full accuracy."""
    cyc = np.arange(a, b, dtype=np.float64) * cycles_per_sample
    return np.sin((2.0 * np.pi) * np.mod(cyc, 1.0))


def stereo_mixdown(x, channels=None, device=None):
    """Average channels into at most 2 playback channels: the first half
    of the shown channels to the left, the rest to the right.  ``x`` is a
    tensor (computed where it lies) or host data (moved to ``device``, the
    CUDA card by default)."""
    x = _as_float(on_device(x, device))
    if x.ndim == 1:
        x = x[:, None]
    if channels is not None:
        x = x[:, list(channels)]
    nch = x.shape[1]
    if nch == 1:
        return x
    n2 = (nch + 1) // 2
    return torch.stack([x[:, :n2].mean(dim=1), x[:, n2:].mean(dim=1)],
                       dim=1)


def heterodyne(x, rate, freq, device=None):
    """Multiply with a ``sin(2 pi freq t)`` carrier to shift ultrasonic
    bands down into the audible range.  The carrier is made on the host in
    float64 (in blocks, to bound host memory) and uploaded once."""
    x = _as_float(on_device(x, device))
    n = int(x.shape[0])
    c = float(freq) / float(rate)
    carrier = np.empty(n, np.float32)
    block = 1 << 22
    for a in range(0, n, block):
        b = min(a + block, n)
        carrier[a:b] = _carrier(a, b, c)
    carrier = torch.as_tensor(carrier, dtype=x.dtype, device=x.device)
    return x * carrier.reshape((-1,) + (1,) * (x.ndim - 1))


def fade(x, rate, fade_time=0.1, device=None):
    """Sine-squared fade-in and fade-out over ``fade_time`` seconds."""
    x = _as_float(on_device(x, device))
    n = x.shape[0]
    nf = min(int(round(fade_time * rate)), n // 2)
    if nf <= 0:
        return x
    ramp = torch.sin((0.5 * math.pi / nf)
                     * torch.arange(nf, dtype=x.dtype, device=x.device)) ** 2
    ramp = ramp.reshape((nf,) + (1,) * (x.ndim - 1))
    out = x.clone()
    out[:nf] *= ramp
    out[n - nf :] *= torch.flip(ramp, (0,))
    return out


def prepare_playback(x, rate, channels=None, use_heterodyne=False,
                     heterodyne_freq=0.0, rate_fac=1.0, fade_time=0.1,
                     device=None):
    """The whole playback pipeline on the device; returns ``(playdata,
    playback_rate)`` with ``playdata`` a float32 tensor ``(n, 1 or 2)``.

    The heterodyne low-pass is the JAX package's design (order 2 at
    20 kHz), run as the zero-phase FIR filter of
    :func:`~audian_torch.ops.sos.sosfiltfilt_fir` (scipy ``sosfiltfilt``
    within the design's eps)."""
    play = stereo_mixdown(x, channels, device)
    out_rate = rate
    if use_heterodyne:
        play = heterodyne(play, rate, heterodyne_freq)
        sos = design_filter(rate, lowpass_cutoff=HETERODYNE_CUTOFF, order=2)
        nstep = max(1, int(np.round(rate / (2 * HETERODYNE_CUTOFF))))
        if sos is not None:
            d = FilterDesign.from_sos(sos)
            play = sosfiltfilt_fir(d.fir, play, d.zi0, d.padlen)
        play = play[::nstep].contiguous()
        out_rate = rate / nstep
    return fade(play, out_rate / rate_fac, fade_time), out_rate / rate_fac
