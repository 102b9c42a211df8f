"""Decimating batch song-detection envelope: zero-phase band-pass, square,
envelope low-pass, 1-in-``step`` decimation, ``2 sqrt(max(e, 0))``.

The port of ``audian_tpu/ops/envdet.py``.  Both forms take a time-first
window ``xw (W, C)`` (float32, or raw PCM-16 int16 read as k/2^15) and
return the ``(nout, C)`` envelope whose output ``j`` sits at window sample
``off0 + j*step``:

- :class:`EnvDet` runs two strided-window matrix products
  (:mod:`.cuda.window_matmul`): the zero-phase band-pass as one
  symmetric-kernel Toeplitz bank over the dequantized window, then the
  envelope low-pass with the square as the premap and the decimation
  folded into the bank (:func:`_decimating_bank`), so each 128-output frame
  advances by ``128*step`` samples.  Any ``off0 >= hb`` works.
- :class:`audian_torch.ops.cuda.envdet.EnvDetKernel` runs everything in
  one kernel pass, with the first output at exactly ``hb``.

The symmetric kernels come from
:func:`audian_torch.ops.design.filtfilt_sym_kernel` at the designs'
(power-of-two) FIR budgets.  Interior samples match scipy's
``sosfiltfilt`` chain to the truncation ``eps``; the caller supplies the
halos (``audian_torch.analysis.events``).

``precision`` (:mod:`.cuda.precision`) takes the JAX package's values for
both forms: HIGHEST (the default) and HIGH run the tensor-core products
as three TF32 passes, within about 1e-6 of the float64 oracle; DEFAULT as
one TF32 pass, about 1e-3 relative, the throughput opt-in of batch jobs
(the TPU's DEFAULT is one bf16 pass).  The split-bf16 rungs are refused,
as the JAX package's decimating stage refuses them.  The kernel's
decimating stage runs in fp32 FMAs under every rung.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import resolve_device
from ..utils import trace as _trace
from .cuda.precision import HIGHEST, MATMUL_RUNGS, check
from .cuda.window_matmul import BankSplit, window_matmul
from .design import filtfilt_sym_kernel
from .sos import _toeplitz_bank_np

__all__ = ["EnvDet", "EnvDetDesign"]


def _decimating_bank(g, step, block=128):
    """Analysis bank ``B[r, o] = g[o*step + L-1 - r]``: frame ``f`` of a
    window matmul at stride ``block*step`` then yields
    ``out[f*block+o] = sum_m g[m] y[(f*block+o)*step + (L-1) - m]`` —
    ``block`` decimated convolution outputs per frame, with the smoother's
    full look-back folded into the row offset."""
    g = np.asarray(g, np.float64)
    L = len(g)
    K = (block - 1) * step + L
    r = np.arange(K)[:, None]
    o = np.arange(block)[None, :]
    idx = o * step + (L - 1) - r
    return np.where((idx >= 0) & (idx < L),
                    g[np.clip(idx, 0, L - 1)], 0.0).astype(np.float32)


def _float_window(xw):
    """int16 stays raw (the kernels dequantize it); anything else is
    float32."""
    return xw if xw.dtype == torch.int16 else xw.to(torch.float32)


class EnvDetDesign:
    """The design both envelope forms share: the symmetric band-pass
    ``g_bp`` (delay ``d_bp``) and envelope ``g_lp`` (delay ``d_lp``)
    kernels, the decimation ``step``, ``nout`` outputs per window and the
    window headroom ``hb`` before the first output.

    ``fdesign``/``edesign`` are :class:`audian_torch.ops.design.FilterDesign`
    values; their ``fir.length`` budgets set the kernel lengths.
    ``precision`` is HIGHEST (``None``, the default), HIGH or DEFAULT (see
    the module).  ``device`` defaults to the CUDA card ("cpu" runs the
    plain versions).  Raises ValueError when the geometry cannot be
    covered or on another precision.
    """

    def __init__(self, fdesign, edesign, step, nout, hb, precision=None,
                 device=None):
        g_bp, d_bp = filtfilt_sym_kernel(fdesign.sos,
                                         pad_to=fdesign.fir.length)
        g_lp, d_lp = filtfilt_sym_kernel(edesign.sos,
                                         pad_to=edesign.fir.length)
        self._setup(g_bp, d_bp, g_lp, d_lp, step, nout, hb, precision,
                    device)

    @classmethod
    def from_kernels(cls, g_bp, d_bp, g_lp, d_lp, step, nout, hb,
                     precision=None, device=None):
        """The same envelope over precomputed symmetric kernels."""
        self = cls.__new__(cls)
        self._setup(g_bp, d_bp, g_lp, d_lp, step, nout, hb, precision,
                    device)
        return self

    def _setup(self, g_bp, d_bp, g_lp, d_lp, step, nout, hb, precision,
               device):
        self.precision = check(HIGHEST if precision is None else precision,
                               MATMUL_RUNGS)
        self.device = resolve_device(device)
        self.g_bp_np = np.asarray(g_bp, np.float64)
        self.g_lp_np = np.asarray(g_lp, np.float64)
        self.d_bp, self.d_lp = int(d_bp), int(d_lp)
        self.lb, self.ll = len(self.g_bp_np), len(self.g_lp_np)
        self.step = int(step)
        self.nout = int(nout)
        self.hb = int(hb)
        if self.step < 1 or self.nout < 1:
            raise ValueError("step and nout must be >= 1")
        #: the envelope's look-back in band-passed samples
        self.lead2 = self.ll - 1 - self.d_lp
        self._build()

    def _build(self):
        raise NotImplementedError

    def _tensor(self, a):
        return torch.tensor(np.ascontiguousarray(a, np.float32),
                            device=self.device)

    def window_need(self, off0_max):
        """Samples the window must hold for the largest valid ``off0``."""
        return off0_max + self.d_bp + (self.nout - 1) * self.step \
            + self.d_lp + 1


class EnvDet(EnvDetDesign):
    """The two-stage envelope on :func:`window_matmul`, for any in-window
    offset ``off0 >= hb`` of the first output."""

    def _build(self):
        if self.hb + self.d_bp < self.lead2:
            raise ValueError(
                f"window headroom hb={self.hb} is smaller than the envelope "
                f"look-back ({self.lead2 - self.d_bp}); widen the halo")
        self.w_bp = self._tensor(
            _toeplitz_bank_np(self.g_bp_np.astype(np.float32), 128).T)
        self.b2 = self._tensor(_decimating_bank(self.g_lp_np, self.step))
        # the banks' TF32 splits for the window_matmul kernel, made once
        self._split_bp, self._split_b2 = BankSplit(), BankSplit()

    def __call__(self, xw, off0):
        """Envelope of one window ``xw (W, C)`` (float32 or raw int16) with
        the first output at window sample ``off0``: ``(nout, C)``."""
        with _trace.timed("envdet.call", frames=len(xw)):
            return self._envelope(xw, int(off0))

    def _envelope(self, xw, off0):
        x_cf = _float_window(xw).T
        C, W = x_cf.shape
        base = self.hb + self.d_bp - self.lead2   # stage-1 output crop
        n_y = self.lead2 + (self.nout - 1) * self.step + self.d_lp + 1
        w2 = base + n_y
        if w2 > W:
            raise ValueError(
                f"window of {W} samples cannot cover {w2} (halo + outputs); "
                f"widen the window or lower nout")
        if off0 < self.hb or self.window_need(off0) > W:
            raise ValueError(f"off0={off0} needs hb <= off0 and "
                             f"{self.window_need(off0)} window samples, "
                             f"the window has {W}")
        xs = x_cf[:, off0 - self.hb : off0 - self.hb + w2]
        # stage 1: y_ext[i] = sum_m g_bp[m] xs[base + i - m]
        xp = F.pad(xs, (self.lb - 1, 0))
        caus = window_matmul(xp, self.w_bp, 128, -(-w2 // 128),
                             premap="dequant", out_layout="cf",
                             split=self._split_bp, precision=self.precision)
        y_ext = caus[:, base : base + n_y].contiguous()
        # stage 2: the decimating squared-envelope conv (square as premap)
        raw = window_matmul(y_ext, self.b2, 128 * self.step,
                            -(-self.nout // 128), premap="square",
                            out_layout="fco", split=self._split_b2,
                            precision=self.precision)     # (nf2, C, 128)
        env = raw.permute(1, 0, 2).reshape(C, -1)[:, : self.nout]
        # env = sqrt(2 * e) with e = 2*conv  ->  2*sqrt(conv)
        return (2.0 * torch.sqrt(torch.clamp_min(env, 0.0))).T
