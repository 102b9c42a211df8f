"""Amplitude envelope.

The counterpart of ``audian_tpu/ops/envelope.py`` (reference behavior,
`src/audian/bufferedenvelope.py:34-41`): rectify and scale by pi/2 (the
mean of ``|sin|`` is 2/pi, so a unit-amplitude tone maps to a unit
envelope), smooth with a zero-phase low/band-pass, and clamp negatives to
zero in the pure-lowpass case.  As in the JAX function the smoother is
the exact ``sosfiltfilt`` (:func:`audian_torch.ops.sos.sosfiltfilt`, the
blocked state-space form), which in float32 holds scipy float64 as
closely as the truncated-FIR path does.
"""

from __future__ import annotations

import math

import torch

from ..utils import on_device
from .sos import sosfiltfilt

__all__ = ["envelope"]


def envelope(x, sos, clamp_negative=True, padlen=None, axis=0,
             block_size=1 << 17, device=None):
    """Rectified, zero-phase-smoothed amplitude envelope.

    Parameters
    ----------
    x : signal, time on ``axis`` (a tensor stays on its device; host data
        goes to ``device``, the CUDA card by default), computed in
        float32.
    sos : envelope smoothing cascade from
        :func:`audian_torch.ops.design.design_envelope_filter`; if ``None``
        the reference returns zeros (`src/audian/bufferedenvelope.py:36-37`).
    clamp_negative : clamp the result at zero (the reference does this only
        when no envelope-highpass is set).
    padlen : the odd edge extension (scipy's default when ``None``).
    block_size : samples the smoother filters at once (its memory bound).
    """
    x = on_device(x, device).to(torch.float32)
    if sos is None:
        return torch.zeros_like(x)
    rect = (math.pi / 2) * torch.abs(x)
    env = sosfiltfilt(sos, rect, axis=axis, padlen=padlen,
                      block_size=block_size)
    if clamp_negative:
        env = torch.clamp_min(env, 0.0)
    return env
