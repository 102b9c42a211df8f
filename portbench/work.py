"""The yardstick's counts: the operations and bytes a configuration's work
needs, the same whatever implements it, and the least time the card could
take for them.

The taps are the configuration's own designs truncated where their
impulse responses decay below ``fir_truncation_eps`` (``r^T < eps`` for
the largest pole radius ``r``), worked out here from the configuration's
numbers and not read from the program.  The windowed DFT counts as a dense
real product of ``2 nfft (nfft + 2)`` operations a frame and channel, the
power as three a bin.  Bytes are the int16 input and the float32 outputs,
each once.  A program that changes what the work is (an FFT for the DFT,
an interpolated envelope) needs the counts redone here.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import scipy.signal as sps

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_s(flop, nbytes):
    """``(least seconds, "operations" or "bytes")`` of the work on the
    card's fixed peaks."""
    t_op = flop / PEAKS["flop_per_s"]
    t_mem = nbytes / PEAKS["bytes_per_s"]
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def taps(order, cutoff, btype, rate, eps):
    """The true taps of a causal Butterworth design at ``eps``."""
    sos = sps.butter(order, cutoff, btype, fs=rate, output="sos")
    r = max(float(np.abs(np.roots([1.0, s[4], s[5]])).max()) for s in sos)
    return max(int(math.ceil(math.log(eps) / math.log(r))), 8)


def chain_taps(cfg, lowpass_hz=None):
    """``(filter taps, envelope taps)`` of the bioacoustics chain: the
    causal band-pass and the zero-phase envelope (``2 T - 1``)."""
    rate, eps = float(cfg["rate_hz"]), cfg["fir_truncation_eps"]
    lp = cfg["lowpass_hz"] if lowpass_hz is None else lowpass_hz
    tf = taps(cfg["filter_order"], (cfg["highpass_hz"], lp), "bandpass",
              rate, eps)
    te = taps(cfg["envelope_order"], cfg["envelope_hz"], "lowpass", rate,
              eps)
    return tf, 2 * te - 1


def dft_flop(cfg, frames):
    """The windowed DFT and the power of ``frames`` frames of a channel."""
    nfft = int(cfg["nfft"])
    return frames * (2 * nfft * (nfft + 2) + 3 * (nfft // 2 + 1))


def chain_count(cfg, n):
    """``(flop, bytes)`` of the chain over ``n`` samples of every channel:
    filter, envelope, ``n // hop`` PSD frames; int16 in, filtered,
    envelope and PSD out."""
    C, hop = int(cfg["channels"]), int(cfg["hop"])
    tf, le = chain_taps(cfg)
    nf = n // hop
    flop = C * (2 * n * (tf + le) + dft_flop(cfg, nf))
    nbytes = C * (2 * n + 8 * n + 4 * nf * (int(cfg["nfft"]) // 2 + 1))
    return flop, nbytes


def envdet_count(cfg, window, nout, step):
    """``(flop, bytes)`` of the detector's envelope of one window of
    ``window`` samples a channel: the zero-phase band-pass over the samples
    the ``nout`` outputs need, its square, the envelope's taps at each
    output; int16 in, float32 out."""
    C, rate = int(cfg["channels"]), float(cfg["rate_hz"])
    eps = cfg["fir_truncation_eps"]
    lb = 2 * taps(cfg["filter_order"], (cfg["highpass_hz"],
                                         cfg["lowpass_hz"]),
                  "bandpass", rate, eps) - 1
    ll = 2 * taps(cfg["envelope_order"], cfg["envelope_hz"], "lowpass",
                  rate, eps) - 1
    ny = (nout - 1) * step + ll
    return (C * (ny * (2 * lb + 1) + 2 * nout * ll),
            C * (2 * window + 4 * nout))


def graph_count(cfg, lowpass_hz, n_filtered, n_envelope, n_frames):
    """``(flop, bytes)`` of one recompute of a window: the band-pass over
    ``n_filtered`` samples, the envelope over ``n_envelope``, the PSD of
    ``n_frames`` frames; int16 in, the three float32 windows out."""
    C = int(cfg["channels"])
    tf, le = chain_taps(cfg, lowpass_hz)
    flop = C * (2 * n_filtered * tf + 2 * n_envelope * le
                + dft_flop(cfg, n_frames))
    nbins = int(cfg["nfft"]) // 2 + 1
    nbytes = C * (2 * n_filtered + 4 * n_filtered + 4 * n_envelope
                  + 4 * n_frames * nbins)
    return flop, nbytes
