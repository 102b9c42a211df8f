"""STFT power spectrogram and dB conversion on tensors.

Semantics: density-scaled one-sided PSD with a periodic Hann window and no
detrending, i.e. ``scipy.signal.spectrogram(x, fs, window='hann',
nperseg=nfft, noverlap=nfft-hop, detrend=False, scaling='density',
mode='psd')``, with ``(n - nfft)//hop + 1`` frames.  The window and the
DFT matrices are built on the host in float64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .sos import full_fp32

__all__ = [
    "decibel",
    "frame_signal",
    "hann_window",
    "inverse_decibel",
    "num_frames",
    "one_sided_doubling",
    "spectrogram",
    "spectrogram_frequencies",
]


def one_sided_doubling(nfft):
    """One-sided PSD doubling vector: 2 everywhere except DC (and Nyquist
    when ``nfft`` is even) — shared by :func:`spectrogram` and the fused
    chain so the two PSDs cannot diverge."""
    nbins = nfft // 2 + 1
    dbl = np.full(nbins, 2.0, np.float64)
    dbl[0] = 1.0
    if nfft % 2 == 0:
        dbl[-1] = 1.0
    return dbl


@functools.lru_cache(maxsize=64)
def _hann(nfft, dtype):
    n = np.arange(nfft, dtype=np.float64)
    w = np.asarray(0.5 - 0.5 * np.cos(2.0 * np.pi * n / nfft), dtype)
    w.setflags(write=False)
    return w


def hann_window(nfft, dtype=np.float32):
    """Periodic Hann window (scipy ``get_window('hann', nfft)``) as a
    read-only host numpy array (float64 math, requested dtype)."""
    return _hann(int(nfft), np.dtype(dtype))


def num_frames(n, nfft, hop):
    """Number of full STFT frames in ``n`` samples."""
    if n < nfft:
        return 0
    return (n - nfft) // hop + 1


def spectrogram_frequencies(rate, nfft):
    """One-sided frequency axis, ``nfft//2 + 1`` bins up to Nyquist."""
    return np.arange(nfft // 2 + 1) * (rate / nfft)


def frame_signal(x, nfft, hop, nframes=None):
    """Overlapping frames of ``x`` (time on axis 0) as a strided view,
    zero-extended when ``nframes`` reaches past the end.

    Returns shape ``(nframes, nfft) + x.shape[1:]``.
    """
    n = x.shape[0]
    if nframes is None:
        nframes = num_frames(n, nfft, hop)
    if nframes <= 0:
        return x.new_zeros((0, nfft) + tuple(x.shape[1:]))
    need = (nframes - 1) * hop + nfft
    if need > n:
        x = torch.cat([x, x.new_zeros((need - n,) + tuple(x.shape[1:]))])
    frames = x[:need].unfold(0, nfft, hop)       # (nframes, ..., nfft)
    return torch.movedim(frames, -1, 1)


def _dft_matrices(nfft, nbins, dtype):
    """Real/imag DFT analysis matrix, (nfft, 2*nbins), host numpy."""
    k = np.arange(nfft)[:, None]
    b = np.arange(nbins)[None, :]
    ang = 2.0 * np.pi * k * b / nfft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(dtype)


@functools.lru_cache(maxsize=16)
def _dft_tensors(nfft, dtype, device):
    """``(DFT matrix, one-sided doubling)`` on ``device``, made once per
    NFFT: the spectrogram of a scroll step uploads no coefficients."""
    def put(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (put(_dft_matrices(nfft, nfft // 2 + 1, np.float64)),
            put(one_sided_doubling(nfft)))


def spectrogram(x, rate, nfft, hop, window=None, detrend=False,
                method="auto"):
    """One-sided PSD spectrogram of ``x`` ((n,) or (n, channels)).

    ``method`` is "matmul" (real DFT as a matrix product), "fft"
    (``torch.fft.rfft``) or "auto" (matmul for nfft <= 1024, as the JAX
    package chooses).  Returns ``(nframes, ..., nfft//2 + 1)`` in
    ``unit**2/Hz``: time first, frequency last.
    """
    if not torch.is_floating_point(x):
        x = x.to(torch.float32)
    dtype = x.dtype
    if window is None:
        window = hann_window(nfft, np.float64)
    if not isinstance(window, torch.Tensor):
        window = np.array(window)  # writable: the cached Hann is read-only
    window = torch.as_tensor(window, dtype=dtype, device=x.device)
    frames = frame_signal(x, nfft, hop)               # (nf, nfft, ...)
    if detrend == "constant":
        frames = frames - frames.mean(dim=1, keepdim=True)
    wshape = (1, nfft) + (1,) * (frames.ndim - 2)
    frames = frames * window.reshape(wshape)
    nbins = nfft // 2 + 1
    if method == "auto":
        method = "matmul" if nfft <= 1024 else "fft"
    ft = torch.movedim(frames, 1, -1)                 # (nf, ..., nfft)
    if method == "matmul":
        with full_fp32():
            spec = ft @ _dft_tensors(nfft, dtype, x.device)[0]
        re, im = spec[..., :nbins], spec[..., nbins:]
        psd = re * re + im * im
    else:
        spec = torch.fft.rfft(ft, n=nfft, dim=-1)
        psd = (spec.real * spec.real + spec.imag * spec.imag).to(dtype)
    scale = 1.0 / (rate * torch.sum(window * window))
    factors = _dft_tensors(nfft, dtype, x.device)[1] * scale
    return psd * factors


def decibel(power, ref_power=1.0, min_power=1e-20):
    """``10*log10(power/ref)``; values at or below ``min_power`` map to
    ``-inf`` (thunderlab ``decibel`` semantics).  ``ref_power=None`` uses
    the maximum."""
    if ref_power is None:
        ref_power = torch.max(power)
    low = power <= min_power
    safe = torch.where(low, torch.ones_like(power), power / ref_power)
    return torch.where(low, torch.full_like(power, -torch.inf),
                       10.0 * torch.log10(safe))


def inverse_decibel(db, ref_power=1.0):
    """Inverse of :func:`decibel` for finite values."""
    return ref_power * torch.pow(10.0, db / 10.0)
