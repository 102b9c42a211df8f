"""Plain float64 signal processing for the references: Butterworth designs,
impulse responses run out to round-off, FFT convolution, the density PSD,
and the view's min/max and uint8 dB tiles.

Nothing here imports the program: every design is worked out again from a
configuration's numbers.  ``precision="tf32"`` computes the same in
float32 with every product's operands rounded to TF32 (10 mantissa bits,
as the tensor cores take them; the products are then exact in float32
whatever algorithm ``conv1d`` or ``matmul`` picks): the next precision
below the configurations' float32, the control that the comparisons have
to refuse.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.fft
import scipy.signal as sps
import torch

#: impulse responses run until they decay below this share of their start
TAIL = 1e-16


def butter(order, cutoff, btype, rate):
    """A Butterworth design as second-order sections."""
    return sps.butter(order, cutoff, btype, fs=rate, output="sos")


def pole_radius(sos):
    """The largest pole magnitude of a cascade."""
    return max(float(np.abs(np.roots([1.0, s[4], s[5]])).max())
               for s in np.atleast_2d(sos))


def impulse(sos, tail=TAIL):
    """The causal impulse response, run until ``r^n < tail``."""
    n = int(math.ceil(math.log(tail) / math.log(pole_radius(sos)))) + 8
    x = np.zeros(n)
    x[0] = 1.0
    return sps.sosfilt(sos, x)


def zero_phase(sos, tail=TAIL):
    """``(g, c)``: the kernel of a forward-backward pass, ``h`` convolved
    with itself reversed, and its centre."""
    h = impulse(sos, tail)
    return np.convolve(h, h[::-1]), len(h) - 1


def tf32(t):
    """Float32 rounded to TF32: 10 mantissa bits, to nearest, ties away
    from zero (``cvt.rna.tf32.f32``)."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def dtype(precision):
    return torch.float64 if precision == "float64" else torch.float32


def _full(x, k, precision):
    """The full convolution of each row of ``x`` with ``k``."""
    N, K = x.shape[1], len(k)
    if precision == "float64":
        n = scipy.fft.next_fast_len(N + K - 1, real=True)
        kt = torch.as_tensor(k, dtype=torch.float64, device=x.device)
        y = torch.fft.irfft(torch.fft.rfft(x, n) * torch.fft.rfft(kt, n), n)
        return y[:, : N + K - 1]
    w = tf32(torch.as_tensor(k[::-1].copy(), device=x.device)).reshape(1, 1,
                                                                       -1)
    return torch.nn.functional.conv1d(tf32(x)[:, None], w,
                                      padding=K - 1)[:, 0]


def causal(x, h, precision="float64"):
    """``y[i] = sum_m h[m] x[i - m]``, nothing before the first sample."""
    return _full(x, h, precision)[:, : x.shape[1]]


def centred(v, g, c, precision="float64"):
    """``e[i] = sum_k g[k] v[i + c - k]``, zeros outside ``v``."""
    return _full(v, g, precision)[:, c : c + v.shape[1]]


def hann(nfft):
    """The periodic Hann window."""
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nfft) / nfft)


def psd(y, f0, nf, nfft, hop, rate, precision="float64"):
    """The one-sided density PSD of frames ``f0 .. f0 + nf`` of the rows of
    ``y`` (frame ``f`` is ``y[f hop : f hop + nfft]``): ``(nf, rows,
    nfft // 2 + 1)``."""
    w = hann(nfft)
    frames = y.unfold(1, nfft, hop)[:, f0 : f0 + nf]
    nb = nfft // 2 + 1
    if precision == "float64":
        X = torch.fft.rfft(frames * torch.as_tensor(w, device=y.device), nfft)
        p = X.real ** 2 + X.imag ** 2
    else:
        k = np.arange(nfft)[:, None] * np.arange(nb)[None, :]
        ang = 2 * np.pi * k / nfft
        m = np.concatenate([w[:, None] * np.cos(ang),
                            -w[:, None] * np.sin(ang)], axis=1)
        X = tf32(frames) @ tf32(torch.as_tensor(m, device=y.device))
        p = X[..., :nb] ** 2 + X[..., nb:] ** 2
    scale = torch.full((nb,), 2.0 / (rate * float(np.sum(w ** 2))),
                       dtype=p.dtype, device=p.device)
    scale[0] /= 2
    if nfft % 2 == 0:
        scale[-1] /= 2
    return torch.movedim(p * scale, 1, 0)


def minmax_tile(trace, start, step, width):
    """Interleaved min/max of ``width`` bins of ``step`` samples of a
    ``(frames,)`` trace from ``start``."""
    seg = trace[start : start + width * step].reshape(width, step)
    return torch.stack([seg.amin(1), seg.amax(1)], 1).reshape(-1)


def db_u8(p, zmin, zmax):
    """Power to the view's uint8: dB over ``[zmin, zmax]``, clipped,
    rounded."""
    db = 10.0 * torch.log10(torch.clamp_min(p, 1e-20))
    return torch.round(255.0 * torch.clamp((db - zmin) / (zmax - zmin),
                                           0.0, 1.0)).to(torch.uint8)
