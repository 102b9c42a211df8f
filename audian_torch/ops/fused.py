"""Channels-first fused chain: band-pass FIR, rectified zero-phase
envelope and Hann PSD spectrogram of a ``(channels, frames)`` stream.

Two forms over one design.  :meth:`FusedChainCF.chain_cf` is the batch
call over halo-extended chunks: where the single-pass kernel
(:mod:`.cuda.chain`) takes the design (a filter and an envelope design,
``hop == 128``, ``nfft % 128 == 0`` and a tile that fits one block) it
runs the whole chain in one kernel pass per chunk; for every other
design it runs the per-stage route on the same chunk.  The per-stage
methods (:meth:`~FusedChainCF.filtered_cf`,
:meth:`~FusedChainCF.envelope_cf`, :meth:`~FusedChainCF.spectrogram_fc`)
run every design as strided-window matrix products
(:mod:`.cuda.window_matmul`) over Toeplitz banks and the windowed DFT on
whole streams.
With ``ifir=True`` a long envelope kernel runs as an interpolated FIR:
two window products, a short image suppressor at the full rate and the
model filter on the phase-major stream (:func:`.design.ifir_factor`).

The spectrogram comes back ``(nframes, channels, nbins)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import resolve_device, round_up
from ..utils import trace as _trace
from . import design
from .cuda.chain import (ALL_OUTPUTS, ChainKernel, _check_outputs,
                         as_stream, fits)
from .cuda.precision import HIGHEST, MATMUL_RUNGS
from .cuda.precision import check as check_precision
from .cuda.probes import pm_forward, pm_inverse
from .cuda.window_matmul import BankSplit, window_matmul
from .raw16 import dequant16
from .sos import _toeplitz_bank_np
from .stft import _dft_matrices, hann_window, one_sided_doubling

__all__ = ["FusedChainCF", "design_arrays", "kernel_arrays"]


def design_arrays(rate, filt_sos=None, env_sos=None, env_clamp=True,
                  nfft=256, hop=128, eps=1e-7, block=128, ifir=False,
                  ifir_phase=8, ifir_tol=None):
    """The host-side state of a fused chain (numpy), the same arrays the
    JAX ``FusedChainCF`` computes: the truncated filter response
    ``_h_filt`` and its Toeplitz bank ``filt_w``, the symmetric envelope
    kernel ``_g_env`` with its delay, the envelope's ``env_mode`` and
    banks (``env_w`` when dense; ``env_i_w`` and ``env_g_w`` with
    ``ifir_M`` and ``ifir_Lg`` when "ifir"), its halo ``env_halo``, and
    the analysis matrix ``spec_w`` (periodic Hann, density scale and
    one-sided doubling folded in)."""
    h = g = None
    delay = 0
    if filt_sos is not None:
        h = design.impulse_response(
            filt_sos, design.effective_impulse_length(filt_sos, eps))
    if env_sos is not None:
        g, delay = design.filtfilt_sym_kernel(env_sos, eps=eps)
    return kernel_arrays(rate, h, g, delay, env_clamp, nfft, hop, block,
                         ifir, ifir_phase, ifir_tol)


def kernel_arrays(rate, h_filt=None, g_env=None, env_delay=0,
                  env_clamp=True, nfft=256, hop=128, block=128, ifir=False,
                  ifir_phase=8, ifir_tol=None):
    """:func:`design_arrays` over given kernels: the causal filter
    response ``h_filt`` and the symmetric envelope kernel ``g_env`` of
    group delay ``env_delay`` (either may be None).

    With ``ifir`` the envelope is factored as the JAX package factors it:
    a kernel of 96 taps or more, strides ``(ifir_phase, 8, 4)`` that
    divide ``block``, an L1 fit error of at most ``ifir_tol`` (2e-6 by
    default, well inside the 1e-5 scipy budget) and a non-negative lead;
    otherwise the envelope stays dense."""
    rate = float(rate)
    nfft = int(nfft)
    a = {"rate": rate, "nfft": nfft, "hop": int(hop),
         "env_clamp": bool(env_clamp), "_h_filt": None, "filt_w": None,
         "_g_env": None, "env_w": None, "env_delay": 0, "env_mode": None,
         "env_halo": 0, "ifir_M": None, "ifir_Lg": None, "env_i_w": None,
         "env_g_w": None}
    if h_filt is not None:
        h = np.asarray(h_filt, np.float64)
        a["_h_filt"] = h
        a["filt_w"] = _toeplitz_bank_np(h.astype(np.float32), block).T
    if g_env is not None:
        g = np.asarray(g_env, np.float64)
        delay = int(env_delay)
        a["_g_env"] = g
        a["env_delay"] = delay
        fit = None
        if ifir and len(g) >= 96:
            phases = tuple(dict.fromkeys(
                m for m in (int(ifir_phase), 8, 4) if block % m == 0))
            fit = design.ifir_factor_auto(
                g, 2e-6 if ifir_tol is None else ifir_tol, phases=phases)
        if fit is not None:
            ik, gk, M, _ = fit
            lead = (len(ik) - 1) + (len(gk) - 1) * M - delay
            if lead >= 0:
                a.update(env_mode="ifir", ifir_M=M, ifir_Lg=len(gk),
                         env_halo=lead)
                a["env_i_w"] = _toeplitz_bank_np(ik.astype(np.float32),
                                                 block).T
                a["env_g_w"] = _toeplitz_bank_np(gk.astype(np.float32),
                                                 block).T
        if a["env_mode"] is None:
            a.update(env_mode="dense", env_halo=len(g) - 1)
            a["env_w"] = _toeplitz_bank_np(g.astype(np.float32), block).T
    nbins = nfft // 2 + 1
    win = hann_window(nfft, np.float64)
    W = _dft_matrices(nfft, nbins, np.float64)
    scale = 1.0 / (rate * float(np.sum(win ** 2)))
    dbl = one_sided_doubling(nfft)
    amp = np.sqrt(np.concatenate([dbl * scale, dbl * scale]))
    a["spec_w"] = ((win[:, None] * W) * amp[None, :]).astype(np.float32)
    return a


class FusedChainCF(nn.Module):
    """Fused chain over a fixed design, on one device.

    Parameters
    ----------
    rate : sample rate (Hz).
    filt_sos / env_sos : SOS cascades (either may be None).
    env_clamp : clamp the envelope at zero.
    nfft, hop : spectrogram geometry.
    eps : FIR truncation tolerance.
    block : Toeplitz bank width of the per-stage filter and envelope.
    ifir : run the envelope as the two-stage interpolated FIR where
        its kernel factors within ``ifir_tol`` (``env_mode`` says which
        form was taken); at the bioacoustics envelope (500 Hz at
        96 kHz) its two banks hold 2.95 times fewer rows than the dense
        one.
    ifir_phase : the first stride to try (then 8, then 4).
    ifir_tol : the largest L1 error of the factors (2e-6 by default).
    device : where the banks live and the chain runs: the CUDA card by
        default (the kernels; raises without CUDA), or "cpu" (the plain
        versions).
    precision : the rung of every window product (:mod:`.cuda.precision`:
        HIGHEST, the default, or HIGH, three TF32 passes; DEFAULT, one),
        and of the single-pass kernel's three stages.
    """

    def __init__(self, rate, filt_sos=None, env_sos=None, env_clamp=True,
                 nfft=256, hop=128, eps=1e-7, block=128, ifir=False,
                 ifir_phase=8, ifir_tol=None, device=None,
                 precision=HIGHEST):
        super().__init__()
        self._setup(design_arrays(rate, filt_sos, env_sos, env_clamp, nfft,
                                  hop, eps, block, ifir, ifir_phase,
                                  ifir_tol), device, precision)

    @classmethod
    def from_arrays(cls, arrays, device=None, precision=HIGHEST):
        """A chain over precomputed arrays (the keys of
        :func:`design_arrays`)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self._setup(arrays, device, precision)
        return self

    def _setup(self, a, device, precision):
        device = resolve_device(device)
        self.precision = check_precision(precision, MATMUL_RUNGS)
        self.rate = float(a["rate"])
        self.nfft = int(a["nfft"])
        self.hop = int(a["hop"])
        self.env_clamp = bool(a["env_clamp"])
        self.nbins = self.nfft // 2 + 1
        self._h_filt = a["_h_filt"]
        self._g_env = a["_g_env"]
        self.env_delay = int(a["env_delay"]) if self._g_env is not None else 0

        def buf(x):
            if x is None:
                return None
            return torch.tensor(np.ascontiguousarray(x, np.float32),
                                device=device)

        self.register_buffer("filt_w", buf(a["filt_w"]))
        self.register_buffer("env_w", buf(a["env_w"]))
        self.register_buffer("env_i_w", buf(a["env_i_w"]))
        self.register_buffer("env_g_w", buf(a["env_g_w"]))
        self.register_buffer("spec_w", buf(a["spec_w"]))
        #: each bank's TF32 split for the window_matmul kernel, made once
        self._splits = {k: BankSplit() for k in
                        ("filt_w", "env_w", "env_i_w", "env_g_w", "spec_w")}
        if self.spec_w.shape != (self.nfft, 2 * self.nbins):
            raise ValueError("spec_w does not match nfft")
        self.env_mode = a["env_mode"]
        self.env_halo = int(a["env_halo"])
        self.ifir_M, self.ifir_Lg = a["ifir_M"], a["ifir_Lg"]
        banks = [w for w in (self.filt_w, self.env_w, self.env_i_w)
                 if w is not None]
        self.block = banks[0].shape[1] if banks else 128
        self.filt_halo = 0 if self._h_filt is None else len(self._h_filt) - 1
        self._chain = None
        # the single-pass gate: both designs, hop 128, whole 128-sample
        # DFT blocks, and a tile that fits one block (every other design
        # runs the per-stage route)
        if (self._h_filt is not None and self._g_env is not None
                and self.hop == 128 and self.nfft % 128 == 0
                and fits(len(self._h_filt), len(self._g_env),
                         self.env_delay, self.nfft)):
            self._chain = ChainKernel(
                self.rate, self._h_filt, self._g_env, self.env_delay,
                a["spec_w"], self.nbins, env_clamp=self.env_clamp,
                nfft=self.nfft, device=device, precision=self.precision)
            return
        # the per-stage route's geometry over an extended chunk: the
        # filtered stream runs from ``lead`` samples before the chunk (the
        # envelope's look-back, rounded up to whole hops so that the PSD's
        # frames fall on its frame grid) to ``ha`` past it; the envelope's
        # outputs start ``_env_off`` samples before the chunk
        if self.env_mode == "ifir":
            look_back = self.env_halo
        elif self.env_mode == "dense":
            look_back = len(self._g_env) - 1 - self.env_delay
        else:
            look_back = 0
        self._lead = round_up(look_back, self.hop)
        self._env_off = self._lead - look_back
        self._hb = self.filt_halo + self._lead
        self._ha = max(self.env_delay, self.nfft - self.hop)
        if device.type == "cuda":
            for k in ("filt_w", "env_w", "env_i_w", "env_g_w", "spec_w"):
                if getattr(self, k) is not None:
                    self._splits[k](getattr(self, k))

    @property
    def chain_kernel(self):
        """The single-pass chain (:class:`ChainKernel`), or ``None`` when
        the design or geometry does not fit it."""
        return self._chain

    @property
    def hb(self):
        """Samples before the chunk that :meth:`chain_cf` reads: the
        single-pass kernel's where it takes the design, else the per-stage
        route's."""
        return self._chain.hb if self._chain is not None else self._hb

    @property
    def ha(self):
        """Samples past the chunk that :meth:`chain_cf` reads (columns past
        the stream's end read as zero)."""
        return self._chain.ha if self._chain is not None else self._ha

    # -- stages ---------------------------------------------------------------

    def filtered_cf(self, x_cf):
        """Causal band-pass of a channels-first stream; same length."""
        if self.filt_w is None:
            return x_cf
        n = x_cf.shape[1]
        B = self.block
        xp = F.pad(x_cf, (self.filt_halo, 0))
        y = window_matmul(xp, self.filt_w, B, -(-n // B), out_layout="cf",
                          split=self._splits["filt_w"],
                          precision=self.precision)
        return y[:, :n]

    def envelope_cf(self, y_cf):
        """Rectified symmetric-kernel envelope of a (filtered) stream;
        the rectifier runs inside the window build.  Interior samples
        match scipy's pi/2-rectified ``sosfiltfilt``.  In "ifir" mode
        the kernel runs as two window products
        (:meth:`_envelope_ifir_cf`)."""
        if self.env_mode is None:
            return torch.zeros_like(y_cf)
        if self.env_mode == "ifir":
            return self._envelope_ifir_cf(y_cf)
        return self._envelope_dense_cf(
            F.pad(y_cf, (self.env_halo, self.env_delay)), self.env_delay,
            y_cf.shape[1])

    def _envelope_dense_cf(self, xp, start, n):
        """The dense envelope's window product over ``xp``: its outputs
        ``start .. start + n``, clamped as ``env_clamp`` says."""
        e = window_matmul(xp, self.env_w, self.block,
                          -(-(start + n) // self.block), premap="rectify",
                          out_layout="cf", split=self._splits["env_w"],
                          precision=self.precision)[:, start : start + n]
        return torch.clamp_min(e, 0.0) if self.env_clamp else e

    def _envelope_ifir_cf(self, y_cf):
        """The two-stage IFIR envelope.  Stage A rectifies and runs the
        image suppressor at the full rate, from ``delay - (Lg-1)*M`` on
        (the ``env_halo`` left pad holds that lead).  Its output ``u``
        is laid out phase-major, ``(C, Q, M) -> (C*M, Q)``, so the model
        filter at stride ``M`` is a plain causal FIR along each row:
        ``e[t] = sum_j g[j] u[t + delay - j*M]`` (stage B).  The inverse
        relayout gives the stream back.  Both relayouts are the tiled
        transposes of :mod:`.cuda.probes` (:func:`~.cuda.probes.pm_forward`,
        :func:`~.cuda.probes.pm_inverse`), which read the stage outputs'
        slices where they lie; on the CPU their plain versions, torch
        copies."""
        C, n = y_cf.shape
        B, M = self.block, self.ifir_M
        n_pad = -(-n // M) * M
        xp = F.pad(y_cf, (self.env_halo, self.env_delay + n_pad - n))
        n_u = n_pad + (self.ifir_Lg - 1) * M
        u = window_matmul(xp, self.env_i_w, B, -(-n_u // B),
                          premap="rectify", out_layout="cf",
                          split=self._splits["env_i_w"],
                          precision=self.precision)[:, :n_u]
        q_out = n_pad // M
        u_pm = pm_forward(u, M)
        e_pm = window_matmul(u_pm, self.env_g_w, B, -(-q_out // B),
                             out_layout="cf",
                             split=self._splits["env_g_w"],
                             precision=self.precision)[:, :q_out]
        e = pm_inverse(e_pm, M)[:, :n]
        return torch.clamp_min(e, 0.0) if self.env_clamp else e

    def spectrogram_fc(self, y_cf, nframes=None):
        """PSD spectrogram of a channels-first stream: (nf, C, nbins)."""
        n = y_cf.shape[1]
        if nframes is None:
            nframes = max((n - self.nfft) // self.hop + 1, 0)
        s = window_matmul(y_cf.contiguous(), self.spec_w, self.hop, nframes,
                          out_layout="fco", split=self._splits["spec_w"],
                          precision=self.precision)
        re, im = s[..., : self.nbins], s[..., self.nbins:]
        return re * re + im * im

    def chain_cf(self, x_ext, n, stats=False, outputs=ALL_OUTPUTS):
        """The whole chain over an extended stream ``[hb | n | ha...]``
        (``hb = self.hb``, ``ha >= self.ha``; columns past the stream's end
        read as zero), int16 (PCM-16, k/2^15) or float32.  Returns
        ``(filtered (C, n), envelope (C, n), psd (n // hop, C, nbins))``,
        frame ``f`` from sample ``f hop``, with a stats dict as a fourth
        element when ``stats=True``: ``power`` (per-channel sum of
        filtered²), ``env_sum`` (envelope mass) and ``psd_sum`` (the PSD
        summed over frames, (C, nbins)), each zero for a masked stage.
        ``outputs`` masks stages, which then come back as ``None``.

        Where the single-pass kernel takes the design it runs the chunk in
        one pass; every other design runs the per-stage route
        (:meth:`_stages_cf`).  The JAX package's ``chain_cf`` raises for
        those designs."""
        if self._chain is None:
            return self._stages_cf(x_ext, n, stats, outputs)
        with _trace.timed("chain.call", device=self.spec_w.device,
                          frames=int(n)):
            return self._chain(x_ext, n, stats=stats, outputs=outputs)

    def _stages_cf(self, x_ext, n, stats, outputs):
        """The per-stage route of :meth:`chain_cf`.  The band-pass is one
        window product over the chunk and its left halo as they lie (int16
        through the ``"dequant"`` premap), giving the filtered stream from
        ``_lead`` samples before the chunk to ``ha`` past it.  The envelope
        runs on that stream: dense, one product with the rectifier as its
        premap whose outputs start ``_env_off`` samples before the chunk;
        "ifir", its two stages over the envelope's span.  The PSD takes
        the stream's frames at ``hop`` and drops the ``_lead / hop``
        before the chunk.  The statistics are reductions on the device.
        Filtered and envelope are views into the route's longer streams.
        Every window product runs at ``precision``; a masked envelope or
        PSD launches nothing.  The ``stages.call`` span counts the window
        products in ``launches``."""
        outputs = _check_outputs(outputs)
        x_ext = as_stream(x_ext, self.spec_w.device)
        if x_ext.dtype not in (torch.int16, torch.float32):
            raise TypeError(f"x_ext must be int16 or float32, not "
                            f"{x_ext.dtype}")
        n = int(n)
        if n < 1:
            raise ValueError("n must be >= 1")
        x_ext = x_ext.contiguous()
        C = x_ext.shape[0]
        B, hop, nb, lead = self.block, self.hop, self.nbins, self._lead
        want_f, want_e, want_s = (k in outputs for k in ALL_OUTPUTS)
        dev = self.spec_w.device
        y = e = s = None
        with _trace.timed("stages.call", device=dev, frames=n) as span:
            launches = window_matmul.launches
            with _trace.timed("stages.stage", device=dev, stage="filtered"):
                ny = lead + n + self._ha
                if self.filt_w is None:
                    xf = (dequant16(x_ext) if x_ext.dtype == torch.int16
                          else x_ext)[:, :ny]
                    y_ext = F.pad(xf, (0, ny - xf.shape[1])).contiguous()
                else:
                    y_ext = window_matmul(
                        x_ext, self.filt_w, B, -(-ny // B),
                        premap=("dequant" if x_ext.dtype == torch.int16
                                else None), out_layout="cf",
                        split=self._splits["filt_w"],
                        precision=self.precision)
            if want_f:
                y = y_ext[:, lead : lead + n]
            if want_e:
                with _trace.timed("stages.stage", device=dev,
                                  stage="envelope"):
                    e = self._stages_envelope(y_ext, n)
            if want_s:
                with _trace.timed("stages.stage", device=dev,
                                  stage="spectrogram"):
                    q = lead // hop
                    z = window_matmul(y_ext, self.spec_w, hop, q + n // hop,
                                      out_layout="fco",
                                      split=self._splits["spec_w"],
                                      precision=self.precision)[q:]
                    s = z[..., :nb] * z[..., :nb]
                    s.addcmul_(z[..., nb:], z[..., nb:])
                    del z
            st = None
            if stats:
                with _trace.timed("stages.stage", device=dev, stage="stats"):
                    zeros = y_ext.new_zeros(C)
                    st = {"power": (zeros if y is None else
                                    torch.linalg.vector_norm(y, dim=1)
                                    .square()),
                          "env_sum": zeros if e is None else e.sum(1),
                          "psd_sum": (y_ext.new_zeros((C, nb)) if s is None
                                      else s.sum(0))}
            span["launches"] = window_matmul.launches - launches
        return (y, e, s, st) if stats else (y, e, s)

    def _stages_envelope(self, y_ext, n):
        """The route's envelope ``(C, n)`` of the chunk from the filtered
        stream ``y_ext`` (which starts ``_lead`` samples before it)."""
        if self.env_mode is None:
            return y_ext.new_zeros((y_ext.shape[0], n))
        off = self._env_off
        if self.env_mode == "ifir":
            # the envelope's span: its look-back before the chunk, its
            # delay past it
            return self._envelope_ifir_cf(
                y_ext[:, off : self._lead + n + self.env_delay])[
                    :, self._lead - off : self._lead - off + n]
        return self._envelope_dense_cf(y_ext, off, n)

    def forward(self, x_cf, nspec_frames=None, outputs=ALL_OUTPUTS):
        """Per-stage chain, called as ``chain(x_cf, nspec_frames,
        outputs)``: a dict with the requested outputs."""
        y = self.filtered_cf(x_cf)
        out = {}
        if "filtered" in outputs:
            out["filtered"] = y
        if self.env_mode is not None and "envelope" in outputs:
            out["envelope"] = self.envelope_cf(y)
        if "spectrogram" in outputs:
            out["spectrogram"] = self.spectrogram_fc(y, nspec_frames)
        return out
