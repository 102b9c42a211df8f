"""Second-order-section (SOS) IIR filtering as truncated-FIR convolution.

A stable cascade's impulse response decays geometrically, so convolving
with the response truncated where it falls below ``eps`` gives the same
output to within ``eps``.  Initial-state effects enter as a rank-``2*nsec``
correction on the first ``T`` samples, and the final state is recovered
from the last ``T`` inputs, so block-chaining stays exact up to ``eps``.
``zi`` conventions and ``sosfiltfilt`` padding follow scipy.

These are the building blocks of the fused chain's plain version; the
convolutions run through ``torch.nn.functional.conv1d`` and the state
corrections through ``matmul``, both in full float32 (:func:`full_fp32`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "full_fp32",
    "odd_ext",
    "sosfilt_fir",
    "sosfiltfilt_fir",
    "sosfiltfilt_sym",
]


@contextlib.contextmanager
def full_fp32():
    """Run float32 matrix products and convolutions in full float32 on the
    GPU for the duration of the block (or of the decorated call), then put
    both TF32 flags back as the caller left them.  cuDNN runs float32
    convolutions in TF32 (about three decimal digits) unless told not to,
    which would break the 1e-5 contract of the plain versions the kernels
    are held against; the caller's own matmuls keep its setting."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


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


@full_fp32()
def _fir_valid_cf(x_cf, h):
    """``out[c, i] = sum_m h[m] x[c, i + T - 1 - m]`` for ``i`` in
    ``[0, n - T + 1)``: the causal FIR over a channels-first stream whose
    first ``T - 1`` samples are history."""
    h = torch.as_tensor(h, dtype=x_cf.dtype, device=x_cf.device)
    w = torch.flip(h, (0,)).reshape(1, 1, -1)
    return F.conv1d(x_cf.unsqueeze(1), w).squeeze(1)


def _conv1d_same_causal(x, h):
    """Causal convolution ``y[n] = sum_j h[j] x[n-j]`` along axis 0 of a
    (n, channels) array with zero history."""
    T = len(h)
    xp = F.pad(x.T, (T - 1, 0))
    return _fir_valid_cf(xp, h).T


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


@full_fp32()
def sosfilt_fir(kernels, x, zi=None, axis=0, return_zf=None):
    """Causal SOS filtering through the truncated impulse response.

    ``kernels`` is a :class:`audian_torch.ops.design.FirKernels`.  Output
    matches scipy ``sosfilt`` within ``kernels.eps`` (relative).  ``zi``
    uses scipy's per-section convention ``(nsec, ..., 2, ...)``; the final
    conditions come from the last ``T`` samples, plus ``A**n`` times the
    initial state when the block is shorter than the kernel.
    """
    if return_zf is None:
        return_zf = zi is not None
    ndim = x.ndim
    axis = axis % max(ndim, 1)
    flat, restore = _time_first(x, axis)
    dtype, dev = flat.dtype, flat.device
    n = flat.shape[0]
    y = _conv1d_same_causal(flat, kernels.h)
    nstate = kernels.state_out.shape[1]
    s0 = None
    if zi is not None:
        zi_t = torch.movedim(torch.as_tensor(zi, dtype=dtype, device=dev),
                             1 + axis, 1)
        s0 = zi_t.reshape(nstate, -1)                       # (2*nsec, cols)
        G = torch.as_tensor(kernels.state_out[: min(n, kernels.length)],
                            dtype=dtype, device=dev)
        y = torch.cat([y[: G.shape[0]] + G @ s0, y[G.shape[0]:]])
    out = restore(y)
    if not return_zf:
        return out
    T = min(kernels.length, n)
    Phi = torch.as_tensor(np.ascontiguousarray(kernels.input_state[:T][::-1]),
                          dtype=dtype, device=dev)          # (T, 2*nsec)
    zf = Phi.T @ flat[n - T:]                               # (2*nsec, cols)
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


def sosfiltfilt_fir(kernels, x, zi0, padlen, axis=0):
    """Zero-phase filtering on the FIR path with scipy ``sosfiltfilt``
    semantics: odd edge padding and steady-state initial conditions
    scaled by the edge samples.  ``zi0`` is ``sosfilt_zi`` (nsec, 2)."""
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

    y = sosfilt_fir(kernels, ext, zi=zi_for(ext[0]), axis=0, return_zf=False)
    y = torch.flip(y, (0,))
    y = sosfilt_fir(kernels, y, zi=zi_for(y[0]), axis=0, return_zf=False)
    y = torch.flip(y, (0,))
    if padlen:
        y = y[padlen:-padlen]
    return torch.movedim(y, 0, axis)


def sosfiltfilt_sym(g, delay, x, axis=0):
    """Zero-phase filtering as one symmetric convolution with ``(g, delay)``
    from :func:`audian_torch.ops.design.filtfilt_sym_kernel`.  Interior
    samples match ``sosfiltfilt``; within ``delay`` samples of the ends
    the input is taken as zero, so callers carry halos."""
    flat, restore = _time_first(x, axis)
    ext = F.pad(flat.T, (0, delay))
    y = _conv1d_same_causal(ext.T, g)[delay:]
    return restore(y)
