"""The plain reference of ``ultrasound-384k-16ch``: the bioacoustics
reference's equations (a causal Butterworth band-pass, the pi/2-rectified
envelope smoothed forward and backward by a Butterworth low-pass and
clamped at zero, the density PSD of Hann frames), designed again from this
configuration's numbers (20-90 kHz, 1 kHz, NFFT 512 at hop 256, 384 kHz)
and computed in float64 by FFT convolution, a few channels at a time.

The designs' impulse responses run out to 1e-16 (:func:`.dsp.impulse`):
at 384 kHz the band-pass's within 200 samples and the envelope's
zero-phase kernel reaches 3192 samples either side, against the
program's 84 and 1393 at its 1e-7 truncation.  A chunk's reference sees
only the chunk's own halos, as the program does: the band-pass's
history is the whole left halo (1619 samples, eight times its decay),
and the envelope's lags past the halos carry 8.3e-8 of its kernel's
mass, a hundredth of the 1e-5 guarantee (:func:`truncation`).
"""

from __future__ import annotations

import numpy as np

from .. import core
from . import dsp

#: the bioacoustics reference, whose functions take the configuration
_BIO = core.load_module("reference", "bioacoustics-96k-16ch")
BLOCK = _BIO.BLOCK


def designs(cfg, lowpass_hz=None):
    """``(h, g, c)``: the band-pass's impulse response, the envelope's
    zero-phase kernel and its centre."""
    return _BIO.designs(cfg, lowpass_hz)


def chain(cfg, x_ext, hb, n, precision="float64"):
    """The chain over one extended chunk ``x_ext = [hb | n | tail]`` of
    codes: ``filtered`` and ``envelope`` ``(C, n)``, ``psd`` ``(n // hop,
    C, nbins)`` (frame ``f`` from sample ``f hop``), and the chunk's
    ``power``, ``env_sum`` and ``psd_sum``."""
    return _BIO.chain(cfg, x_ext, hb, n, precision)


def truncation(cfg, hb, ha):
    """``(history, lags)``: the band-pass's impulse mass past ``hb``
    samples, and the envelope kernel's mass at lags the halos do not hold
    (past ``hb`` less the band-pass's decay before the chunk, past ``ha``
    after it), each over its kernel's whole L1 mass."""
    h, g, c = designs(cfg)
    a = np.abs(h)
    history = float(a[hb:].sum() / a.sum())
    reach = hb - len(h)
    b = np.abs(g)
    lags = float((b[: max(c - reach, 0)].sum()
                  + b[c + ha + 1 :].sum()) / b.sum())
    return history, lags
