"""Host-side IIR filter design (numpy and scipy).

Filter design is small, data-independent work that stays on the host; only
the data path runs on the device.  This is the numpy counterpart of
``audian_tpu/ops/design.py``: Butterworth design, the cascade's state-space
form, the truncated impulse and state responses behind the FIR
execution of :mod:`audian_torch.ops.sos` and the fused chain, and the
interpolated-FIR factors of the fused chain's two-stage envelope.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.signal import butter, sosfilt_zi

__all__ = [
    "FilterDesign",
    "FirKernels",
    "design_envelope_filter",
    "design_filter",
    "effective_impulse_length",
    "filtfilt_padlen",
    "filtfilt_sym_kernel",
    "fir_kernels",
    "ifir_factor",
    "ifir_factor_auto",
    "impulse_response",
    "sos_initial_conditions",
    "sos_pole_radius",
]


def design_filter(rate, highpass_cutoff=0.0, lowpass_cutoff=None, order=2):
    """Trace filter: ``None`` for a pass-through, else a lowpass, highpass
    or bandpass Butterworth SOS cascade.  Out-of-range cutoffs clamp, and
    an inverted band drops its lowpass side."""
    nyq = rate / 2
    if lowpass_cutoff is None:
        lowpass_cutoff = nyq
    highpass_cutoff = min(max(float(highpass_cutoff), 0.0), 0.999 * nyq)
    lowpass_cutoff = min(max(float(lowpass_cutoff), 0.0), nyq)
    if lowpass_cutoff <= highpass_cutoff:
        lowpass_cutoff = nyq
    if highpass_cutoff < 0.001 * nyq and lowpass_cutoff >= nyq - 1e-8:
        return None
    if highpass_cutoff < 0.001 * nyq:
        return butter(order, lowpass_cutoff, "lowpass", fs=rate, output="sos")
    if lowpass_cutoff >= nyq - 1e-8:
        return butter(order, highpass_cutoff, "highpass", fs=rate, output="sos")
    return butter(
        order, (highpass_cutoff, lowpass_cutoff), "bandpass", fs=rate, output="sos"
    )


def design_envelope_filter(rate, envelope_cutoff=500.0, highpass_cutoff=0.0, order=2):
    """Envelope smoothing filter; ``None`` when the design is infeasible.

    The cutoff floors at ``5e-4 * rate``: a near-DC cutoff's truncated FIR
    would need hundreds of thousands of taps.
    """
    nyq = rate / 2
    if float(envelope_cutoff) <= 0:
        return None
    envelope_cutoff = min(max(float(envelope_cutoff), 5e-4 * rate),
                          0.999 * nyq)
    if highpass_cutoff > 0:
        highpass_cutoff = min(float(highpass_cutoff),
                              0.99 * envelope_cutoff)
    try:
        if highpass_cutoff > 0:
            return butter(
                order, (highpass_cutoff, envelope_cutoff), "bandpass",
                fs=rate, output="sos",
            )
        return butter(order, envelope_cutoff, "lowpass", fs=rate, output="sos")
    except ValueError:
        return None


def sos_pole_radius(sos):
    """Largest pole magnitude of an SOS cascade (stability / decay rate)."""
    sos = np.asarray(sos, dtype=np.float64)
    rmax = 0.0
    for sec in sos:
        a1, a2 = sec[4], sec[5]
        roots = np.roots([1.0, a1, a2]) if (a1 != 0 or a2 != 0) else np.zeros(1)
        if len(roots):
            rmax = max(rmax, float(np.max(np.abs(roots))))
    return rmax


def effective_impulse_length(sos, eps=1e-7, max_len=1 << 20):
    """Samples after which the impulse response has decayed below ``eps``
    (relative): the truncation length of the FIR execution."""
    r = sos_pole_radius(sos)
    if r <= 0.0:
        return 2 * len(np.atleast_2d(sos)) + 1
    if r >= 1.0:
        return max_len
    n = int(np.ceil(np.log(eps) / np.log(r)))
    return int(min(max(n, 8), max_len))


def _cascade_state_space(sos):
    """Single state-space (A, B, C, D) for the whole SOS cascade in
    transposed direct form II coordinates (states stacked per section)."""
    sos = np.asarray(sos, dtype=np.float64)
    ns = len(sos)
    A = np.zeros((2 * ns, 2 * ns))
    B = np.zeros((2 * ns,))
    C = np.zeros((2 * ns,))
    D = 1.0
    for k, sec in enumerate(sos):
        b0, b1, b2, _, a1, a2 = sec
        # section k: s' = M s + K u, y = b0 u + s[0], with u the output of
        # the cascade so far (affine in the earlier states and the input)
        M = np.array([[-a1, 1.0], [-a2, 0.0]])
        K = np.array([b1 - a1 * b0, b2 - a2 * b0])
        i = 2 * k
        A[i : i + 2, i : i + 2] = M
        A[i : i + 2, :i] = np.outer(K, C[:i])
        B[i : i + 2] = K * D
        C_new = np.zeros_like(C)
        C_new[:i] = b0 * C[:i]
        C_new[i] = 1.0
        C = C_new
        D = b0 * D
    return A, B, C, D


def _matrix_powers(A, T):
    """``A**k`` for ``k`` in [0, T) by repeated doubling."""
    n = A.shape[0]
    powers = np.empty((T, n, n))
    powers[0] = np.eye(n)
    m = 1
    Am = A.copy()
    while m < T:
        k = min(m, T - m)
        powers[m : m + k] = powers[:k] @ Am
        Am = Am @ Am
        m *= 2
    return powers


def impulse_response(sos, T):
    """First ``T`` samples of the cascade's impulse response (float64)."""
    A, B, C, D = _cascade_state_space(
        np.atleast_2d(np.asarray(sos, dtype=np.float64)))
    powers = _matrix_powers(A, T)
    h = np.empty(T)
    h[0] = D
    if T > 1:
        h[1:] = (powers[: T - 1] @ B) @ C
    return h


@dataclasses.dataclass(frozen=True)
class FirKernels:
    """Truncated responses (host, float64) of an SOS cascade.

    ``h`` is the impulse response, ``state_out`` row ``k`` is ``C A**k``
    (the output response to each initial state component), and
    ``input_state`` row ``j`` is ``A**j B`` (the final state left by an
    input ``j`` steps before the block end).  ``A`` carries the initial
    state across blocks shorter than the kernel.
    """

    h: np.ndarray
    state_out: np.ndarray
    input_state: np.ndarray
    eps: float
    A: np.ndarray = None

    @property
    def length(self):
        return self.h.shape[0]


def fir_kernels(sos, eps=1e-7, max_len=1 << 20, pad_to_pow2=False,
                pad_to=None):
    """Truncated impulse and state responses of an SOS cascade.

    ``pad_to_pow2`` extends the responses to the next power of two and
    ``pad_to`` to an exact length; the extension is exact (the responses
    keep decaying), not zero padding.
    """
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    T = effective_impulse_length(sos, eps, max_len)
    if pad_to is not None:
        T = max(T, int(pad_to))
    if pad_to_pow2:
        T = 1 << (T - 1).bit_length()
    A, B, C, D = _cascade_state_space(sos)
    powers = _matrix_powers(A, T)
    h = np.empty(T)
    h[0] = D
    if T > 1:
        h[1:] = (powers[: T - 1] @ B) @ C
    state_out = np.einsum("tij,i->tj", powers, C)
    input_state = powers @ B
    return FirKernels(h=h, state_out=state_out, input_state=input_state,
                      eps=eps, A=A)


def filtfilt_sym_kernel(sos, eps=1e-7, max_len=1 << 20, pad_to=None):
    """Symmetric FIR kernel equivalent of zero-phase ``sosfiltfilt``:
    ``g = h (*) reverse(h)``, length ``2T-1``, group delay ``T-1``.
    Interior samples match scipy within ``eps``; the edges follow the
    caller's halo.  Returns ``(g, delay)``."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    T = effective_impulse_length(sos, eps, max_len)
    if pad_to is not None:
        T = max(T, int(pad_to))
    h = impulse_response(sos, T)
    g = np.convolve(h, h[::-1])
    return g, T - 1


def sos_initial_conditions(sos):
    """Steady-state step-response initial conditions, identical to
    ``scipy.signal.sosfilt_zi`` (shape ``(nsec, 2)``)."""
    return sosfilt_zi(np.atleast_2d(np.asarray(sos, dtype=np.float64)))


def filtfilt_padlen(sos):
    """Default edge padding length used by ``scipy.signal.sosfiltfilt``."""
    sos = np.atleast_2d(np.asarray(sos))
    ntaps = 2 * len(sos) + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    return int(3 * ntaps)


@dataclasses.dataclass(frozen=True)
class FilterDesign:
    """Host-side design bundle for one SOS filter: coefficients,
    steady-state initial conditions, the ``sosfiltfilt`` edge padding and
    the truncated FIR responses (extended to a power of two)."""

    sos: np.ndarray
    zi0: np.ndarray
    padlen: int
    fir: FirKernels

    @classmethod
    def from_sos(cls, sos, eps=1e-7, max_len=1 << 20, pad_to=None):
        sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
        return cls(
            sos=sos,
            zi0=sos_initial_conditions(sos),
            padlen=filtfilt_padlen(sos),
            fir=fir_kernels(sos, eps=eps, max_len=max_len, pad_to=pad_to,
                            pad_to_pow2=True),
        )


def ifir_factor(kernel, M=8, Li=None, Lg=None, iters=200):
    """Interpolated-FIR factorization ``kernel ≈ conv(i, upsample(g, M))``.

    The envelope's smoothing kernel is a very narrow low-pass (500 Hz at
    96 kHz is 1 % of Nyquist) some 1.1 k taps long; convolving with it
    costs ``2·len(kernel)`` operations a sample.  The interpolated FIR
    (Neuvo, Dong and Mitra 1984) replaces it with a short full-rate image
    suppressor ``i`` followed by the model filter ``g`` at stride ``M``
    (zero-stuffed), which runs on the phase-major stream without the
    zeros.

    The factors are fit to the given (truncated) kernel by alternating
    least squares in float64, so the error is measured at design time:
    ``err`` is the L1 error, which bounds the worst-case output error for
    unit-peak input.  Returns ``(i, g, err)`` with
    ``len(i) + (len(g)-1)*M >= len(kernel)``.
    """
    k = np.asarray(kernel, np.float64)
    L = len(k)
    M = int(M)
    if Li is None:
        Li = 12 * M + 1
    if Lg is None:
        Lg = -(-(L - Li) // M) + 3
    n = Li + (Lg - 1) * M
    tgt = np.zeros(n)
    tgt[:L] = k
    # start from a windowed-sinc image suppressor at the first image
    t = np.arange(Li) - (Li - 1) / 2
    i = np.sinc(t / M) * np.hamming(Li)
    i /= i.sum()
    g = None
    prev = None
    for _ in range(iters):
        A = np.zeros((n, Lg))
        for j in range(Lg):
            A[j * M : j * M + Li, j] = i
        g, *_ = np.linalg.lstsq(A, tgt, rcond=None)
        B = np.zeros((n, Li))
        for j in range(Lg):
            B[j * M : j * M + Li, :] += g[j] * np.eye(Li)
        i, *_ = np.linalg.lstsq(B, tgt, rcond=None)
        r = float(np.abs(B @ i - tgt).sum())
        if prev is not None and abs(prev - r) < 1e-13:
            break
        prev = r
    A = np.zeros((n, Lg))
    for j in range(Lg):
        A[j * M : j * M + Li, j] = i
    err = float(np.abs(A @ g - tgt).sum())
    return i, g, err


def ifir_factor_auto(kernel, tol, phases=(16, 8, 4), taps=(12, 18, 26)):
    """The most aggressive IFIR factorization within ``tol``: strides
    ``M`` from large to small, image suppressors of ``taps[k]*M + 1``
    from short to long; the first ``(i, g, M, err)`` with L1 error
    ``<= tol``, or ``None`` when even the gentlest misses (the caller
    keeps the dense kernel)."""
    k = np.asarray(kernel, np.float64)
    for M in phases:
        if len(k) < 24 * M:
            continue
        for t in taps:
            i, g, err = ifir_factor(k, M=M, Li=t * M + 1)
            if err <= tol:
                return i, g, M, err
    return None
