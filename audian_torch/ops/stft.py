"""STFT power spectrogram and dB conversion on tensors.

Semantics: density-scaled one-sided PSD with a periodic Hann window and no
detrending, i.e. ``scipy.signal.spectrogram(x, fs, window='hann',
nperseg=nfft, noverlap=nfft-hop, detrend=False, scaling='density',
mode='psd')``, with ``(n - nfft)//hop + 1`` frames.  The window and the
DFT matrices are built on the host in float64.

:func:`spectrogram` takes one of two routes, chosen from its input:

- the kernel route: a CUDA float32 signal, the matrix-product method, no
  detrending and a host window (or none).  The window, the DFT, the
  density scale and the one-sided doubling are folded into one
  ``(nfft, 2*nbins)`` analysis bank (:func:`analysis_bank`, the batch
  chain's ``spec_w`` too), kept on the device per NFFT, rate and window
  with its TF32 split.  A time-first stream is turned channels-first by
  the phase-major relayout kernel (:func:`.cuda.probes.pm_forward`, its
  columns as the phases).  The strided-window product
  (:func:`.cuda.window_matmul.window_matmul`, ``csrc/window_matmul.cu``)
  reads the frames straight from the channels-first stream, three TF32
  passes on the tensor cores (HIGHEST, the precision of an fp32 FMA), and
  the power is ``re*re + im*im`` of its columns (:func:`bank_psd`, which
  the batch chain's spectrogram stages call too).
- the plain route, every other input: the frames as a strided view, the
  window multiplied in, then the real DFT as one full-fp32 matrix product
  (cuBLAS on the card) or ``torch.fft.rfft`` for NFFT above 1024.  It is
  the kernel route's twin on the CPU.

The route is traced: ``stft`` on the innermost open span reads ``kernel``
or ``plain`` (:func:`audian_torch.utils.trace.tag`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils import trace as _trace
from .cuda.precision import HIGHEST
from .cuda.probes import MAX_STRIDE, pm_forward
from .cuda.window_matmul import BankSplit, window_matmul
from .sos import full_fp32

__all__ = [
    "analysis_bank",
    "bank_psd",
    "decibel",
    "frame_signal",
    "hann_window",
    "inverse_decibel",
    "num_frames",
    "one_sided_doubling",
    "spectrogram",
    "spectrogram_frequencies",
    "spectrogram_padded",
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


def analysis_bank(nfft, rate, window=None):
    """The ``(nfft, 2*nbins)`` float32 analysis bank of a window product:
    the window times the real and imaginary DFT, each column scaled by
    ``sqrt(doubling * scale)`` (the density scale and the one-sided
    doubling), so that ``re*re + im*im`` of a frame's product is its PSD.
    Built on the host in float64 from ``window`` (a host array; the
    periodic Hann by default).  The batch chain's ``spec_w`` and the
    kernel route of :func:`spectrogram` share it."""
    nfft = int(nfft)
    nbins = nfft // 2 + 1
    win = (hann_window(nfft, np.float64) if window is None
           else np.asarray(window, np.float64))
    W = _dft_matrices(nfft, nbins, np.float64)
    scale = 1.0 / (float(rate) * float(np.sum(win ** 2)))
    dbl = one_sided_doubling(nfft)
    amp = np.sqrt(np.concatenate([dbl * scale, dbl * scale]))
    return ((win[:, None] * W) * amp[None, :]).astype(np.float32)


def bank_psd(x_cf, bank, hop, nframes, split, precision, skip=0, out=None):
    """The PSD of the frames at ``hop`` of a channels-first stream ``x_cf``
    over an analysis bank (:func:`analysis_bank`): one strided-window
    product over ``skip + nframes`` frames
    (:func:`.cuda.window_matmul.window_matmul`, with the bank's
    ``BankSplit`` ``split`` at the rung ``precision``), its first ``skip``
    frames dropped, then ``re*re + im*im`` of its columns in two passes,
    ``torch.mul`` into ``out`` and ``addcmul_``.  Returns the
    ``(nframes, C, nbins)`` power, written into ``out`` where given."""
    nb = bank.shape[1] // 2
    s = window_matmul(x_cf, bank, hop, skip + nframes, out_layout="fco",
                      split=split, precision=precision)[skip:]
    re, im = s[..., :nb], s[..., nb:]
    return torch.mul(re, re, out=out).addcmul_(im, im)


@functools.lru_cache(maxsize=16)
def _device_bank(nfft, rate, window, device):
    """``(analysis bank, its BankSplit)`` on ``device`` for ``window`` (the
    bytes of its float64 values, or None), made once: a cutoff step
    uploads and splits nothing, an NFFT step builds one bank an NFFT."""
    if window is not None:
        window = np.frombuffer(window, np.float64)
    bank = torch.from_numpy(analysis_bank(nfft, rate, window)).to(device)
    return bank, BankSplit()


def _method(method, nfft):
    """``method`` with "auto" resolved: matmul for nfft <= 1024, as the JAX
    package chooses."""
    if method == "auto":
        return "matmul" if nfft <= 1024 else "fft"
    return method


def _takes_kernel(x, nfft, hop, window, detrend, method):
    """Whether :func:`spectrogram` runs ``x`` on the kernel route (the
    module docstring; ``method`` resolved), within the kernel's
    limits: at most 65535 columns, 32-bit offsets into a column."""
    if not (x.is_cuda and x.dtype == torch.float32 and method == "matmul"
            and detrend != "constant"
            and not isinstance(window, torch.Tensor)):
        return False
    n = x.shape[0]
    cols = math.prod(x.shape[1:])
    return (cols <= 65535 and n < 2**31
            and (num_frames(n, nfft, hop) + 64) * hop + nfft < 2**31)


def _channels_first(x):
    """The ``(n, cols)`` stream as the ``(cols, n)`` rows the window
    product reads (contiguous on the card): a view where it lies so
    already; from a contiguous time-first stream by the
    phase-major relayout kernel (:func:`.cuda.probes.pm_forward` with the
    columns as phases, ``out[c, i] = x[i, c]``); else a torch copy."""
    n, cols = x.shape
    if x.T.is_contiguous():
        return x.T
    if x.is_contiguous() and cols <= MAX_STRIDE:
        return pm_forward(x.reshape(1, n * cols), cols)
    return x.T.contiguous()


def _kernel_spectrogram(x, rate, nfft, hop, window, n_out=None):
    """The kernel route: the first ``min(nframes, n_out)`` frames' PSD by
    one window product over the channels-first stream, then zero frames up
    to ``n_out`` (``nframes`` frames where it is None).  On a CPU tensor
    the window product runs its plain version."""
    n, rest = x.shape[0], tuple(x.shape[1:])
    nf = num_frames(n, nfft, hop)
    if n_out is None:
        n_out = nf
    nf = min(nf, n_out)
    nbins = nfft // 2 + 1
    key = (None if window is None
           else np.asarray(window, np.float64).tobytes())
    bank, split = _device_bank(int(nfft), float(rate), key, x.device)
    xc = _channels_first(x.reshape(n, math.prod(rest)))
    psd = xc.new_empty((n_out, xc.shape[0], nbins))
    bank_psd(xc, bank, hop, nf, split, HIGHEST, out=psd[:nf])
    psd[nf:].zero_()
    return psd.reshape((n_out,) + rest + (nbins,))


def _plain_spectrogram(x, rate, nfft, hop, window, detrend, method):
    """The plain route (the module docstring)."""
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


def _routed(x, rate, nfft, hop, window, detrend, method, n_out):
    """:func:`spectrogram` by the route ``x`` takes, the route traced;
    with ``n_out`` as :func:`spectrogram_padded`."""
    if not torch.is_floating_point(x):
        x = x.to(torch.float32)
    method = _method(method, nfft)
    if _takes_kernel(x, nfft, hop, window, detrend, method):
        _trace.tag("stft", "kernel")
        return _kernel_spectrogram(x, rate, nfft, hop, window, n_out)
    _trace.tag("stft", "plain")
    sxx = _plain_spectrogram(x, rate, nfft, hop, window, detrend, method)
    if n_out is None:
        return sxx
    sxx = sxx[:n_out]
    nf = sxx.shape[0]
    if n_out == nf:
        return sxx
    return torch.cat([sxx, sxx.new_zeros((n_out - nf,) + sxx.shape[1:])])


def spectrogram(x, rate, nfft, hop, window=None, detrend=False,
                method="auto"):
    """One-sided PSD spectrogram of ``x`` ((n,) or (n, channels), or more
    axes after time).

    ``method`` is "matmul" (real DFT as a matrix product), "fft"
    (``torch.fft.rfft``) or "auto" (matmul for nfft <= 1024, as the JAX
    package chooses).  ``window`` is a host array or a tensor (the
    periodic Hann by default); ``detrend`` False or "constant".  Returns
    ``(nframes, ..., nfft//2 + 1)`` in ``unit**2/Hz``: time first,
    frequency last.

    A CUDA float32 ``x`` with the matmul method, no detrending and a host
    window (or none) takes the kernel route: one strided-window product
    over the analysis bank on the tensor cores in three TF32 passes
    (HIGHEST, the precision of an fp32 FMA), counted in
    ``window_matmul.launches``.  Every other input takes the plain route
    (the module docstring).  The route is tagged ``stft`` on the
    innermost open span.
    """
    return _routed(x, rate, nfft, hop, window, detrend, method, None)


def spectrogram_padded(x, rate, nfft, hop, n_out, window=None):
    """The first ``min(nframes, n_out)`` frames of :func:`spectrogram`
    (no detrending, the "auto" method), then zero frames up to ``n_out``:
    a frame whose window overhangs ``x`` is zero, not a frame of the
    zero-extended signal.  The kernel route writes its power into the
    ``n_out`` frames where they lie; the plain route appends the zeros."""
    return _routed(x, rate, nfft, hop, window, False, "auto", int(n_out))


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
