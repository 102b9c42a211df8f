"""Second-order-section (SOS) IIR filtering, exact and as truncated FIR.

**Exact** (:func:`sosfilt`, :func:`sosfiltfilt`, :func:`sosfilt_zi`, with
scipy's conventions).  Each section runs in a blocked state-space form.
Over a block of ``L`` samples its output is the zero-state response, an
``L x L`` lower-triangular Toeplitz product with the section's impulse
response, plus the observability rows times the state at the block's
start; a block moves the state by ``A^L`` plus its controllability rows
times the block's input.  The states at all block starts follow from a
doubling scan over the blocks in ``log2(blocks)`` steps.  Every matrix is
computed on the host in float64 from the float64 coefficients and only
then rounded to the signal's dtype, so near DC the poles do not move as
they do when the recurrence's coefficients are rounded to float32, and
the error stays near that of the FIR path.  The state is carried in the
section's balanced basis (controllability and observability Gramians
equal and diagonal), where rounding it costs least; ``zi`` and ``zf``
are converted at the ends.  The JAX package runs the same functions as an
associative scan over the per-sample recurrence.

**Truncated FIR** (:func:`sosfilt_fir`, :func:`sosfiltfilt_fir`).  A
stable cascade's impulse response decays geometrically, so convolving
with the response truncated where it falls below ``eps`` gives the same
output to within ``eps``.  Initial-state effects enter as a rank-``2*nsec``
correction on the first ``T`` samples, and the final state is recovered
from the last ``T`` inputs, so block-chaining stays exact up to ``eps``.
``zi`` conventions and ``sosfiltfilt`` padding follow scipy.

Which route :func:`sosfilt_fir`'s convolution takes is decided by what
the input shows, with no option: a float32 stream on a CUDA device runs
the hand-written kernel :func:`audian_torch.ops.cuda.fir.fir`
(``csrc/fir.cu``, Toeplitz products on the tensor cores: three TF32
passes at HIGHEST and HIGH, one at DEFAULT; a long design as slices of
its taps, one launch each), whatever the design; every other input (the
CPU, another dtype) runs the plain twin, ``torch.nn.functional.conv1d``
(:func:`_fir_valid_cf`).  Each call adds its route (``kernel`` or
``plain``) to the ``fir`` field of the enclosing trace span
(:func:`audian_torch.utils.trace.tag`; a graph node's ``graph.node``).
The plain twins of the fused chain and of envdet call
:func:`_fir_valid_cf` directly and stay on ``conv1d``.  The plain route
and the state corrections (``matmul``) run all products in full float32
(:func:`full_fp32`) unless a FIR function is given
``precision=DEFAULT`` (:mod:`.cuda.precision`): then cuBLAS and cuDNN may
take TF32 for that call (:func:`matmul_precision`), as the JAX package's
DEFAULT runs one pass.  HIGHEST, the default, and HIGH keep full float32.
"""

from __future__ import annotations

import contextlib

import functools

import numpy as np
import scipy.linalg
import torch
import torch.nn.functional as F

from ..utils import on_device
from ..utils import trace as _trace
from .cuda.precision import DEFAULT, HIGHEST, MATMUL_RUNGS, check
from .design import filtfilt_padlen

__all__ = [
    "full_fp32",
    "matmul_precision",
    "odd_ext",
    "sosfilt",
    "sosfilt_fir",
    "sosfilt_zi",
    "sosfiltfilt",
    "sosfiltfilt_fir",
    "sosfiltfilt_sym",
]

#: samples a block of the exact filter's state-space form
IIR_BLOCK = 128


@contextlib.contextmanager
def matmul_precision(precision=HIGHEST):
    """Run float32 matrix products and convolutions at ``precision`` on the
    GPU for the duration of the block (or of the decorated call), then put
    both TF32 flags back as the caller left them: HIGHEST and HIGH in full
    float32 (both flags off), DEFAULT in TF32 where cuBLAS and cuDNN take
    it (both on); another value raises ValueError."""
    tf32 = check(precision, MATMUL_RUNGS) == DEFAULT
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def full_fp32():
    """:func:`matmul_precision` at HIGHEST.  cuDNN runs float32
    convolutions in TF32 (about three decimal digits) unless told not to,
    which would break the 1e-5 contract of the plain versions the kernels
    are held against; the caller's own matmuls keep its setting."""
    return matmul_precision(HIGHEST)


def _toeplitz_bank_np(h, block):
    """The (block, block+T-1) Toeplitz matrix ``H[o, k] = h[o + T - 1 - k]``
    (zero outside [0, T)) for a concrete kernel, built on the host."""
    h = np.asarray(h)
    T = h.shape[0]
    o = np.arange(block)[:, None]
    k = np.arange(block + T - 1)[None, :]
    idx = o + (T - 1) - k
    return np.where((idx >= 0) & (idx < T),
                    h[np.clip(idx, 0, T - 1)], h.dtype.type(0))


def _fir_valid_cf(x_cf, h, precision=HIGHEST):
    """``out[c, i] = sum_m h[m] x[c, i + T - 1 - m]`` for ``i`` in
    ``[0, n - T + 1)``: the causal FIR over a channels-first stream whose
    first ``T - 1`` samples are history, at ``precision``."""
    with matmul_precision(precision):
        h = torch.as_tensor(h, dtype=x_cf.dtype, device=x_cf.device)
        w = torch.flip(h, (0,)).reshape(1, 1, -1)
        return F.conv1d(x_cf.unsqueeze(1), w).squeeze(1)


def _conv1d_same_causal(x, h, precision=HIGHEST):
    """Causal convolution ``y[n] = sum_j h[j] x[n-j]`` along axis 0 of a
    (n, channels) array with zero history, at ``precision``."""
    T = len(h)
    xp = F.pad(x.T, (T - 1, 0))
    return _fir_valid_cf(xp, h, precision).T


def _causal_fir(x, h, precision=HIGHEST):
    """:func:`_conv1d_same_causal` by the route ``x`` takes (the module
    docstring): the kernel for a CUDA float32 stream, else the plain
    twin; the route is traced."""
    if x.is_cuda and x.dtype == torch.float32:
        # imported here: the kernel's module imports the chain's, which
        # imports this one
        from .cuda.fir import fir
        _trace.tag("fir", "kernel")
        return fir(x, h, precision)
    _trace.tag("fir", "plain")
    return _conv1d_same_causal(x, h, precision)


def _time_first(x, axis):
    """``(x moved to time-first and flattened to (n, cols), restore)``."""
    if not torch.is_floating_point(x):
        x = x.to(torch.float32)
    axis = axis % max(x.ndim, 1)
    xt = torch.movedim(x, axis, 0)
    shape = xt.shape

    def restore(flat):
        return torch.movedim(flat.reshape(shape), 0, axis)

    return xt.reshape(shape[0], -1), restore


def sosfilt_fir(kernels, x, zi=None, axis=0, return_zf=None,
                precision=HIGHEST):
    """Causal SOS filtering through the truncated impulse response.

    ``kernels`` is a :class:`audian_torch.ops.design.FirKernels`.  Output
    matches scipy ``sosfilt`` within ``kernels.eps`` (relative).  ``zi``
    uses scipy's per-section convention ``(nsec, ..., 2, ...)``; the final
    conditions come from the last ``T`` samples, plus ``A**n`` times the
    initial state when the block is shorter than the kernel.  Its
    products run at ``precision`` (HIGHEST, HIGH or DEFAULT; see
    :func:`matmul_precision`); the convolution runs on the tensor-core
    kernel for a CUDA float32 stream (the module docstring).
    """
    with matmul_precision(precision):
        if return_zf is None:
            return_zf = zi is not None
        ndim = x.ndim
        axis = axis % max(ndim, 1)
        flat, restore = _time_first(x, axis)
        dtype, dev = flat.dtype, flat.device
        n = flat.shape[0]
        y = _causal_fir(flat, kernels.h, precision)
        nstate = kernels.state_out.shape[1]
        s0 = None
        if zi is not None:
            zi_t = torch.movedim(
                torch.as_tensor(zi, dtype=dtype, device=dev), 1 + axis, 1)
            s0 = zi_t.reshape(nstate, -1)                   # (2*nsec, cols)
            G = torch.as_tensor(
                kernels.state_out[: min(n, kernels.length)], dtype=dtype,
                device=dev)
            y = torch.cat([y[: G.shape[0]] + G @ s0, y[G.shape[0]:]])
        out = restore(y)
        if not return_zf:
            return out
        T = min(kernels.length, n)
        Phi = torch.as_tensor(
            np.ascontiguousarray(kernels.input_state[:T][::-1]),
            dtype=dtype, device=dev)                        # (T, 2*nsec)
        zf = Phi.T @ flat[n - T:]                           # (2*nsec, cols)
        if s0 is not None and n < kernels.length and kernels.A is not None:
            # the initial state has not decayed within this short block
            An = torch.as_tensor(np.linalg.matrix_power(kernels.A, n),
                                 dtype=dtype, device=dev)
            zf = zf + An @ s0
        xt_shape = torch.movedim(x, axis, 0).shape
        zf = zf.reshape((nstate // 2, 2) + tuple(xt_shape[1:]))
        if ndim > 1:
            zf = torch.movedim(zf, 1, 1 + axis)
        return out, zf


def odd_ext(x, n, axis=0):
    """Odd extension at both ends along ``axis`` (scipy ``odd_ext``)."""
    if n == 0:
        return x
    xt = torch.movedim(x, axis, 0)
    if n > xt.shape[0] - 1:
        raise ValueError(
            f"extension length n ({n}) is too big; it must not exceed "
            f"x.shape[axis]-1 ({xt.shape[0] - 1})")
    left = 2 * xt[0] - torch.flip(xt[1 : n + 1], (0,))
    right = 2 * xt[-1] - torch.flip(xt[-(n + 1) : -1], (0,))
    return torch.movedim(torch.cat([left, xt, right]), 0, axis)


def _forward_backward(filt, x, zi0, padlen, axis):
    """``sosfiltfilt``'s edges around a causal filter ``filt(v, zi)``
    (time first): the odd extension of ``padlen`` samples, steady-state
    initial conditions ``zi0`` (nsec, 2) scaled by the edge samples, a
    pass forward and one backward."""
    if not torch.is_floating_point(x):
        x = x.to(torch.float32)
    xt = torch.movedim(x, axis, 0)
    if xt.shape[0] <= padlen:
        raise ValueError(
            f"The length of the input vector x must be greater than padlen, "
            f"which is {padlen}."
        )
    ext = odd_ext(xt, padlen, axis=0)
    zi0 = torch.as_tensor(zi0, dtype=x.dtype, device=x.device)
    bshape = tuple(zi0.shape) + (1,) * (xt.ndim - 1)

    def zi_for(edge):
        return zi0.reshape(bshape) * edge[None, None]

    y = torch.flip(filt(ext, zi_for(ext[0])), (0,))
    y = torch.flip(filt(y, zi_for(y[0])), (0,))
    if padlen:
        y = y[padlen:-padlen]
    return torch.movedim(y, 0, axis)


def sosfiltfilt_fir(kernels, x, zi0, padlen, axis=0):
    """Zero-phase filtering on the FIR path with scipy ``sosfiltfilt``
    semantics: odd edge padding and steady-state initial conditions
    scaled by the edge samples.  ``zi0`` is ``sosfilt_zi`` (nsec, 2)."""
    return _forward_backward(
        lambda v, zi: sosfilt_fir(kernels, v, zi=zi, return_zf=False),
        x, zi0, padlen, axis)


def sosfiltfilt_sym(g, delay, x, axis=0, precision=HIGHEST):
    """Zero-phase filtering as one symmetric convolution with ``(g, delay)``
    from :func:`audian_torch.ops.design.filtfilt_sym_kernel`, at
    ``precision``.  Interior samples match ``sosfiltfilt``; within
    ``delay`` samples of the ends the input is taken as zero, so callers
    carry halos."""
    flat, restore = _time_first(x, axis)
    ext = F.pad(flat.T, (0, delay))
    y = _conv1d_same_causal(ext.T, g, precision)[delay:]
    return restore(y)


# ---------------------------------------------------------------------------
# Exact filtering: the blocked state-space form.
# ---------------------------------------------------------------------------


def _normalize_sos(sos):
    """``sos`` as a float64 (nsec, 6) host array (a 1-D row is one
    section)."""
    if isinstance(sos, torch.Tensor):
        sos = sos.detach().cpu().numpy()
    return np.atleast_2d(np.asarray(sos, np.float64))


def _balance(A, K, c):
    """``(T, Tinv)``: the section's balanced basis, ``z = Tinv s``.  The
    identity when the section is not minimal (a first-order section has
    a state that nothing reaches)."""
    try:
        Wc = scipy.linalg.solve_discrete_lyapunov(A, np.outer(K, K))
        Wo = scipy.linalg.solve_discrete_lyapunov(A.T, np.outer(c, c))
        Lc = np.linalg.cholesky(Wc)
        Lo = np.linalg.cholesky(Wo)
    except (np.linalg.LinAlgError, ValueError):
        return np.eye(2), np.eye(2)
    U, sv, Vt = np.linalg.svd(Lo.T @ Lc)
    if not np.all(np.isfinite(sv)) or sv.min() <= 1e-300:
        return np.eye(2), np.eye(2)
    r = sv ** -0.5
    return Lc @ Vt.T * r[None, :], (U * r[None, :]).T @ Lo.T


@functools.lru_cache(maxsize=64)
def _section_mats(coeffs, L):
    """Float64 matrices of one section ``(b0, b1, b2, 1, a1, a2)`` in
    transposed direct form II over blocks of ``L`` samples, in the
    balanced basis ``z = Tinv s``:

    - ``toep`` (L, L): the zero-state response, ``toep[n, m] = h[n - m]``;
    - ``obs`` (L, 2): the output's rows over the state at the block start;
    - ``ctrl`` (2, L): the state at the block end over the block's input;
    - ``pows`` (L + 1, 2, 2): ``A^r`` for ``r <= L``;
    - ``T``, ``Tinv``: the basis to and from scipy's states."""
    b0, b1, b2, _, a1, a2 = coeffs
    A = np.array([[-a1, 1.0], [-a2, 0.0]])
    K = np.array([b1 - a1 * b0, b2 - a2 * b0])
    c = np.array([1.0, 0.0])
    T, Tinv = _balance(A, K, c)
    A, K, c = Tinv @ A @ T, Tinv @ K, c @ T
    pows = np.empty((L + 1, 2, 2))
    pows[0] = np.eye(2)
    for r in range(L):
        pows[r + 1] = A @ pows[r]
    obs = np.einsum("k,nkj->nj", c, pows[:L])              # c A^n
    h = np.concatenate([[b0], obs[: L - 1] @ K])           # c A^(n-1) K
    ctrl = np.einsum("mij,j->im", pows[L - 1 :: -1][:L], K)  # A^(L-1-m) K
    n = np.arange(L)
    lag = n[:, None] - n[None, :]
    toep = np.where(lag >= 0, h[np.clip(lag, 0, L - 1)], 0.0)
    return toep, obs, ctrl, pows, T, Tinv


def _section_tensors(mats, nb, like):
    """The section's matrices on ``like``'s device and dtype, uploaded
    once a call: the Toeplitz, observability and controllability rows,
    ``A^r`` for ``r <= L``, ``A^(L 2^k)`` for the doubling scan over ``nb``
    blocks, and the basis."""
    toep, obs, ctrl, pows, T, Tinv = mats
    L = toep.shape[0]
    steps = [pows[L]]
    while (1 << len(steps)) <= nb:
        steps.append(steps[-1] @ steps[-1])
    return tuple(torch.as_tensor(m, dtype=like.dtype, device=like.device)
                 for m in (toep, obs, ctrl, pows, np.stack(steps), T, Tinv))


def _doubling_scan(w, steps):
    """``S[b] = sum_{j <= b} P^(b-j) w[j]`` over the first axis of ``w``
    (blocks, 2, cols), in ``ceil(log2(blocks))`` steps; ``steps[k]`` is
    ``P^(2^k)``."""
    S, k = w, 0
    while (1 << k) < S.shape[0]:
        d = 1 << k
        S = torch.cat([S[:d], S[d:] + steps[k] @ S[:-d]])
        k += 1
    return S


def _section_chunk(x, mats, z0):
    """One section over one chunk ``x`` (n, cols) from the balanced state
    ``z0`` (2, cols), with ``mats`` from :func:`_section_tensors`:
    ``(y, z_end)``."""
    toep, obs, ctrl, pows, steps = mats[:5]
    L = toep.shape[0]
    n, cols = x.shape
    nb = -(-n // L)
    r = n - (nb - 1) * L                       # samples of the last block
    xb = F.pad(x, (0, 0, 0, nb * L - n)).reshape(nb, L, cols)
    S = _doubling_scan(torch.cat([z0[None], ctrl @ xb]), steps)
    y = (toep @ xb + obs @ S[:nb]).reshape(nb * L, cols)[:n]
    if r == L:
        return y, S[nb]
    return y, pows[r] @ S[nb - 1] + ctrl[:, L - r:] @ xb[nb - 1, :r]


@full_fp32()
def sosfilt(sos, x, zi=None, axis=0, block_size=1 << 17, return_zf=None,
            device=None):
    """Causal SOS filtering with ``scipy.signal.sosfilt``'s conventions.

    sos : (nsec, 6) cascade, or one section as a 1-D row.
    x : input, time on ``axis`` (a tensor stays on its device; host data
        goes to ``device``, the CUDA card by default).  Integer input is
        filtered as float32; a float dtype is kept.
    zi : initial conditions, scipy's shape ``(nsec, ..., 2, ...)`` with 2
        in place of the time axis.
    block_size : samples filtered at once (the memory bound); the state
        is carried from one to the next exactly.
    return_zf : also return the final conditions (default: ``zi`` given).

    Each section runs in the blocked state-space form of the module
    docstring: blocks of :data:`IIR_BLOCK` samples, a doubling scan over
    them.
    """
    if return_zf is None:
        return_zf = zi is not None
    x = on_device(x, device)
    sos = _normalize_sos(sos)
    nsec = sos.shape[0]
    axis = axis % max(x.ndim, 1)
    flat, restore = _time_first(x, axis)
    dtype, dev = flat.dtype, flat.device
    n, cols = flat.shape
    rest = tuple(torch.movedim(x, axis, 0).shape[1:])
    if zi is None:
        s0 = flat.new_zeros((nsec, 2, cols))
    else:
        zi_t = torch.movedim(torch.as_tensor(zi, dtype=dtype, device=dev),
                             1 + axis, 1)
        s0 = zi_t.reshape(nsec, 2, cols)
    step = max(int(block_size), 1)
    y = flat.contiguous()
    zfs = []
    for k in range(nsec):
        mats = _section_tensors(
            _section_mats(tuple(float(v) for v in sos[k]), IIR_BLOCK),
            -(-min(step, n) // IIR_BLOCK), flat)
        T, Tinv = mats[5:]
        z = Tinv @ s0[k]
        out = torch.empty_like(y)
        for lo in range(0, n, step):
            out[lo : lo + step], z = _section_chunk(y[lo : lo + step], mats,
                                                    z)
        y = out
        zfs.append(T @ z)
    out = restore(y)
    if not return_zf:
        return out
    zf = torch.stack(zfs).reshape((nsec, 2) + rest)
    return out, torch.movedim(zf, 1, 1 + axis) if rest else zf


def sosfilt_zi(sos):
    """Steady-state initial conditions of the cascade for a unit step,
    ``scipy.signal.sosfilt_zi``'s (nsec, 2), as a float64 CPU tensor."""
    sos = _normalize_sos(sos)
    b0, b1, b2 = sos[:, 0], sos[:, 1], sos[:, 2]
    a1, a2 = sos[:, 4], sos[:, 5]
    k1 = b1 - a1 * b0
    k2 = b2 - a2 * b0
    # zi solves (I - A) zi = K, A = [[-a1, 1], [-a2, 0]]
    det = 1.0 + a1 + a2
    zi = np.stack([(k1 + k2) / det, ((1.0 + a1) * k2 - a2 * k1) / det], 1)
    # each section's step is the DC gain of the sections before it
    dc = (b0 + b1 + b2) / det
    scale = np.concatenate([[1.0], np.cumprod(dc)[:-1]])
    return torch.from_numpy(zi * scale[:, None])


def sosfiltfilt(sos, x, axis=0, padlen=None, block_size=1 << 17,
                device=None):
    """Zero-phase forward-backward filtering with
    ``scipy.signal.sosfiltfilt``'s semantics: odd edge extension of
    ``padlen`` samples (scipy's default when ``None``) and steady-state
    initial conditions scaled by the edge samples, through
    :func:`sosfilt` both ways.  Raises ``ValueError`` when ``x`` is not
    longer than ``padlen``."""
    sos = _normalize_sos(sos)
    return _forward_backward(
        lambda v, zi: sosfilt(sos, v, zi=zi, block_size=block_size,
                              return_zf=False),
        on_device(x, device), sosfilt_zi(sos),
        filtfilt_padlen(sos) if padlen is None else int(padlen), axis)
