"""The cells' recordings, made on the device from the seed.

Frozen copies of the makers in ``chip_smoke.py``, so that a change to the
program cannot move the inputs: :func:`gated_tone` is ``int16_chunk``
(the chain's signal, also ``detect_chunk``'s with other numbers) written
for any span of a long recording, and :func:`songs` is
``interactive_recording`` with the seed an argument.  Each draws its noise
from a ``torch.Generator`` on the device in a few large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed, device):
    """The cell's generator on ``device``: any whole-number seed."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def pcm16(x):
    """Unit-scale float samples to PCM-16 codes (``k / 2^15``)."""
    return torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(
        torch.int16)


def gated_tone(gen, start, count, channels, rate, sig, device):
    """PCM-16 ``(count, channels)`` of a recording's samples ``start ..
    start + count``: ``sig["tone_amp"]`` times a ``sig["tone_hz"]`` tone
    gated on and off at ``sig["gate_hz"]``, plus Gaussian noise of
    ``sig["noise_amp"]`` drawn from ``gen``."""
    t = (torch.arange(start, start + count, device=device,
                      dtype=torch.float64) / rate)[:, None]
    tone = torch.sin(2 * math.pi * sig["tone_hz"] * t) * (
        torch.sin(2 * math.pi * sig["gate_hz"] * t) > 0)
    x = sig["noise_amp"] * torch.randn((count, channels), generator=gen,
                                       device=device)
    return pcm16(x + (sig["tone_amp"] * tone).to(torch.float32))


def songs(gen, seconds, channels, rate, sig, device):
    """PCM-16 ``(n, channels)``: Gaussian noise of ``sig["noise_amp"]`` plus,
    every ``sig["every_s"]`` seconds from ``sig["first_s"]``, a song of
    ``sig["song_s"]`` seconds, a channel's carrier (2 kHz plus 450 Hz a
    channel) amplitude-modulated at ``sig["am_hz"]``."""
    n = int(seconds * rate)
    x = sig["noise_amp"] * torch.randn((n, channels), generator=gen,
                                       device=device)
    carriers = 2000.0 + 450.0 * torch.arange(channels, device=device,
                                             dtype=torch.float64)
    for s0 in np.arange(sig["first_s"], seconds - 2.0, sig["every_s"]):
        i0, i1 = int(s0 * rate), int((s0 + sig["song_s"]) * rate)
        t = torch.arange(i0, i1, device=device,
                         dtype=torch.float64)[:, None] / rate
        am = 0.5 * (1 + torch.sin(2 * math.pi * sig["am_hz"] * t))
        x[i0:i1] += (0.5 * am * torch.sin(2 * math.pi * carriers * t)).to(
            x.dtype)
    return pcm16(x)
