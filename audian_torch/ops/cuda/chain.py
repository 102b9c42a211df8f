"""Single-pass fused chain: int16 or float32 PCM -> band-pass FIR ->
{rectified zero-phase envelope, Hann PSD at hop 128} + chunk statistics.

:class:`ChainKernel` is the host setup of
``audian_tpu/ops/pallas/chain.py:FusedChainKernel``: the halo geometry
(``hb``, ``ha``, ``lead``, ``tail``, ``offe``), the lane-packed analysis
matrix ``ws``, and the TPU kernel's generalized Toeplitz banks with their
sub-block classification (``wf``/``we``, ``act_f``/``act_e``).  The CUDA
kernel (``csrc/chain.cu``) runs each convolution as Toeplitz-block
products on the tensor cores (3xTF32), gathering the blocks from the
taps split on the host (``h_split``/``g_split``, :func:`split_tf32`); its
steps cover exactly the true taps, which are the rows of the active
sub-blocks.  The PSD reads the pair-interleaved ``ws_pairs``.

:func:`chain` launches the kernel on a CUDA tensor and runs the plain
PyTorch version :func:`chain_plain` on a CPU tensor; any other device
raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...utils import resolve_device, round_up
from ..raw16 import dequant16
from ..sos import _fir_valid_cf, full_fp32
from ..stft import frame_signal
from ._build import SMEM_LIMIT, check, count_launch, load_library

__all__ = ["ALL_OUTPUTS", "ChainKernel", "chain", "chain_plain",
           "split_tf32"]

#: the full output set (and the default ``outputs`` mask)
ALL_OUTPUTS = ("filtered", "envelope", "spectrogram")

#: output samples per kernel tile (``TJ`` in csrc/chain.cu)
TILE = 2048
#: threads per kernel block (``NT`` in csrc/chain.cu)
_THREADS = 256
#: zero taps each side of a split tap vector (``TPAD`` in csrc/chain.cu)
TAP_PAD = 24
#: zeros past a staged stream (``SLACK`` in csrc/chain.cu)
_SLACK = 32


def split_tf32(a):
    """``(hi, lo)`` float32 arrays with ``a = hi + lo`` up to 2^-22 of |a|:
    each part rounded to TF32 (10 explicit mantissa bits, to nearest, ties
    away from zero), as ``cvt.rna.tf32.f32`` rounds it."""
    a = np.ascontiguousarray(a, np.float32)

    def rna(v):
        u = v.view(np.uint32)
        return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
            np.float32)

    hi = rna(a)
    return hi, rna(a - hi)


def _split_taps(taps):
    """The kernel's tap operand: ``[hi | lo]``, each ``T + 2 TAP_PAD`` long
    with :data:`TAP_PAD` zeros on either side."""
    hi, lo = split_tf32(taps)
    return np.concatenate([np.pad(p, TAP_PAD) for p in (hi, lo)])


def _pair_columns(ws):
    """The lane-packed analysis matrix with each bin's real and imaginary
    columns side by side: ``[re 0, re Nyquist, re 1, im 1, re 2, im 2,
    ...]`` (the kernel's PSD then squares and sums a bin in registers)."""
    half = ws.shape[1] // 2
    order = [0, half]
    for b in range(1, half):
        order += [b, half + b]
    return ws[:, order]


def _shift_bank(h, D, off, block=128):
    """Generalized Toeplitz bank ``B[r, o] = h[o + D - off - r]``, rows
    padded to a multiple of 128: with it,
    ``out[g*block + o] = sum_r z[g*block + off + r] B[r, o]`` equals the
    convolution ``out[t] = sum_m h[m] z[t + D - m]``."""
    h = np.asarray(h, np.float64)
    L = len(h)
    K = round_up(D - off + block, 128)
    r = np.arange(K)[:, None]
    o = np.arange(block)[None, :]
    idx = o + D - off - r
    B = np.where((idx >= 0) & (idx < L), h[np.clip(idx, 0, L - 1)], 0.0)
    return B.astype(np.float32)


#: sub-blocks count as light while their aggregate L1 mass stays below this
#: fraction of the bank total (see :func:`_active`)
LIGHT_MASS_FRAC = 1e-3


def _active(bank):
    """Classify a bank's 128-row sub-blocks as ``(kb, full)`` pairs: all-zero
    blocks are dropped, and the lightest blocks are flagged
    ``full=False`` greedily from the smallest while their cumulative L1
    mass stays under :data:`LIGHT_MASS_FRAC` of the bank total."""
    nb = bank.shape[0] // 128
    mass = [float(np.abs(bank[kb * 128 : (kb + 1) * 128]).sum())
            for kb in range(nb)]
    budget = LIGHT_MASS_FRAC * sum(mass)
    light = set()
    for kb in sorted(range(nb), key=lambda kb: mass[kb]):
        if mass[kb] > budget:
            break
        budget -= mass[kb]
        light.add(kb)
    return tuple((kb, kb not in light)
                 for kb in range(nb) if mass[kb] > 0.0)


def geometry(Tf, L, delay, nfft):
    """``(lead, tail, y0)`` of a design with ``Tf`` filter taps and an
    ``L``-tap envelope of group delay ``delay``: the envelope's look-back,
    the consumers' look-ahead past the chunk, and the filter's history,
    each a whole number of 128-sample frames."""
    lead = round_up(L - 1 - delay, 128)
    tail = round_up(max(delay, nfft - 128), 128)
    return lead, tail, round_up(Tf - 1, 128)


def smem_bytes(Tf, L, lead, tail):
    """Shared memory of one chain block (``smem_bytes`` in csrc/chain.cu):
    the input span with its slack split into TF32 hi and lo (the split
    rectified span reuses it), the filtered span, the envelope halves'
    meeting point and the reduction buffer; the taps are read through L1,
    so ``L`` does not count."""
    ylen = TILE + lead + tail
    return 4 * (2 * round_up(ylen + Tf - 1 + _SLACK, 32) + ylen + TILE
                + _THREADS)


def fits(Tf, L, delay, nfft):
    """Whether a design's tile fits the shared memory of one block."""
    lead, tail, _ = geometry(Tf, L, delay, nfft)
    return smem_bytes(Tf, L, lead, tail) <= SMEM_LIMIT


class ChainKernel:
    """The single-pass chain over a fixed design, on one device.

    Inputs are extended streams ``[hb | n | ha...]`` (channels-first,
    int16 or float32) with ``hb = self.hb``; columns past the stream's end
    read as zero.  Raises ValueError when the design does not fit one
    kernel block's shared memory (:func:`fits`).  ``device`` defaults to
    the CUDA card (see :func:`audian_torch.utils.resolve_device`).
    """

    def __init__(self, rate, h_filt, g_env, env_delay, spec_w, nbins,
                 env_clamp=True, nfft=256, device=None):
        self.rate = float(rate)
        self.nfft = int(nfft)
        self.nbins = int(nbins)
        self.env_clamp = bool(env_clamp)
        Tf = len(h_filt)
        L = len(g_env)
        delay = int(env_delay)
        self.delay = delay
        self.lead, self.tail, y0 = geometry(Tf, L, delay, self.nfft)
        self.hb = y0 + self.lead
        self.ha = self.tail
        self.wf = _shift_bank(h_filt, D=y0, off=0)
        self.act_f = _active(self.wf)
        De = self.lead + delay
        self.offe = 128 * ((De - L + 1) // 128)
        self.we = _shift_bank(g_env, D=De, off=self.offe)
        self.act_e = _active(self.we)
        # lane-pack the analysis matrix: for real input and even nfft the
        # imaginary parts of bin 0 and the Nyquist bin are zero, so it
        # carries exactly nfft columns: [re 0..half-1 | re Nyquist |
        # im 1..half-1]
        spec_w = np.asarray(spec_w, np.float32)
        half = self.nbins - 1
        if spec_w.shape != (self.nfft, 2 * self.nbins):
            raise ValueError(f"spec_w must be ({self.nfft}, {2 * self.nbins})")
        tiny = 1e-9 * float(np.abs(spec_w).max())
        if (np.abs(spec_w[:, self.nbins]).max() > tiny
                or np.abs(spec_w[:, 2 * self.nbins - 1]).max() > tiny):
            raise ValueError("spec_w's DC and Nyquist columns must be real")
        ws = np.concatenate(
            [spec_w[:, :half], spec_w[:, half : half + 1],
             spec_w[:, self.nbins + 1 : 2 * self.nbins - 1]], axis=1)
        self.smem_bytes = smem_bytes(Tf, L, self.lead, self.tail)
        if self.smem_bytes > SMEM_LIMIT:
            raise ValueError(
                f"chain kernel tile needs {self.smem_bytes} B of shared "
                f"memory (filter {Tf} + envelope {L} taps); the per-stage "
                f"methods handle this design")

        device = resolve_device(device)

        def dev(a):
            return torch.tensor(np.ascontiguousarray(a, np.float32),
                                device=device)

        self.h = dev(h_filt)
        self.g = dev(g_env)
        self.ws = dev(ws)
        self.spec_w = dev(spec_w)
        self.h_split = dev(_split_taps(h_filt))
        self.g_split = dev(_split_taps(g_env))
        self.ws_pairs = dev(_pair_columns(ws))

    def __call__(self, x_ext, n, stats=False, outputs=ALL_OUTPUTS):
        """Run the chain over ``x_ext = [hb | n | ha...]``.

        Returns ``(y, e, spec)`` with shapes (C, n), (C, n),
        (n//128, C, nbins); masked stages come back as ``None``.  With
        ``stats=True`` a dict follows: ``power`` (per-channel sum of y²),
        ``env_sum`` (envelope mass) and ``psd_sum`` (PSD column sums,
        (C, nbins)), each zero for a masked stage.
        """
        return chain(self, x_ext, n, stats=stats, outputs=outputs)


def _check_outputs(outputs):
    outputs = tuple(outputs)
    bad = set(outputs) - set(ALL_OUTPUTS)
    if bad or not outputs:
        raise ValueError(f"outputs must be a non-empty subset of "
                         f"{ALL_OUTPUTS}, got {outputs!r}")
    return outputs


def _result(y, e, s, stats, power, env_sum, psd_sum):
    out = (y, e, s)
    if stats:
        return out + ({"power": power, "env_sum": env_sum,
                       "psd_sum": psd_sum},)
    return out


@full_fp32()
def chain_plain(ck, x_ext, n, stats=False, outputs=ALL_OUTPUTS):
    """Plain PyTorch version of :func:`chain`: the filter and the envelope
    as ``conv1d`` over the halo'd stream, the PSD as ``unfold`` frames
    times the full analysis matrix ``spec_w``, all in full float32."""
    outputs = _check_outputs(outputs)
    n = int(n)
    x = dequant16(x_ext) if x_ext.dtype == torch.int16 else x_ext.float()
    C = x.shape[0]
    Tf, L = len(ck.h), len(ck.g)
    start = ck.hb - ck.lead - (Tf - 1)
    stop = ck.hb + n + ck.tail
    seg = x[:, start:stop]
    if seg.shape[1] < stop - start:
        seg = torch.nn.functional.pad(seg, (0, stop - start - seg.shape[1]))
    y_ext = _fir_valid_cf(seg, ck.h)              # j in [-lead, n + tail)
    zeros_c = x.new_zeros(C)
    y = e = s = None
    power, env_sum = zeros_c, zeros_c
    psd_sum = x.new_zeros((C, ck.nbins))
    if "filtered" in outputs:
        y = y_ext[:, ck.lead : ck.lead + n]
        power = torch.sum(y * y, dim=1)
    if "envelope" in outputs:
        v = (math.pi / 2) * torch.abs(y_ext)
        a = ck.lead + ck.delay - (L - 1)
        e = _fir_valid_cf(v[:, a : a + n + L - 1], ck.g)
        if ck.env_clamp:
            e = torch.clamp_min(e, 0.0)
        env_sum = torch.sum(e, dim=1)
    if "spectrogram" in outputs:
        frames = frame_signal(y_ext[:, ck.lead:].T, ck.nfft, 128, n // 128)
        spec = torch.movedim(frames, 1, -1) @ ck.spec_w   # (nf, C, 2 nbins)
        re, im = spec[..., : ck.nbins], spec[..., ck.nbins:]
        s = re * re + im * im
        psd_sum = torch.sum(s, dim=0)
    return _result(y, e, s, stats, power, env_sum, psd_sum)


def chain(ck, x_ext, n, stats=False, outputs=ALL_OUTPUTS):
    """The single-pass chain of ``ck`` over ``x_ext = [hb | n | ha...]``.

    A CUDA tensor runs the kernel on its own device (counted in
    ``chain.launches``); a CPU
    tensor runs :func:`chain_plain`.  ``outputs`` is the static mask: a
    stage not requested is neither computed nor written, returns ``None``
    and reports zero stats.
    """
    if x_ext.device.type == "cpu":
        return chain_plain(ck, x_ext, n, stats, outputs)
    if x_ext.device.type != "cuda":
        raise ValueError(f"chain runs on cuda or cpu, not {x_ext.device}")
    outputs = _check_outputs(outputs)
    if x_ext.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"x_ext must be int16 or float32, not {x_ext.dtype}")
    if x_ext.ndim != 2 or not x_ext.is_contiguous():
        raise ValueError("x_ext must be a contiguous (C, frames) tensor")
    if x_ext.device != ck.h.device:
        raise ValueError(f"x_ext is on {x_ext.device}, the chain's design "
                         f"on {ck.h.device}")
    n = int(n)
    if n < 1:
        raise ValueError("n must be >= 1")
    C, xlen = x_ext.shape
    if C > 65535:
        raise ValueError(f"at most 65535 channels (one grid row each), "
                         f"got {C}")
    want_f, want_e, want_s = (name in outputs for name in ALL_OUTPUTS)
    ntiles = -(-n // TILE)
    nf = n // 128

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x_ext.device)

    y = empty(C, n) if want_f else None
    e = empty(C, n) if want_e else None
    s = empty(nf, C, ck.nbins) if want_s else None
    pp, gp = empty(C, ntiles), empty(C, ntiles)
    qp = empty(C, ntiles, ck.nbins)
    lib = load_library()
    # launched on the tensor's device: the current device may be another
    with torch.cuda.device(x_ext.device):
        code = lib.chain_launch(
            x_ext.data_ptr(), int(x_ext.dtype == torch.int16), xlen, C, n,
            ck.h_split.data_ptr(), len(ck.h), ck.g_split.data_ptr(),
            len(ck.g), ck.delay, ck.lead, ck.tail, ck.hb,
            ck.ws_pairs.data_ptr(), ck.nfft, int(ck.env_clamp), int(want_f),
            int(want_e), int(want_s), 0 if y is None else y.data_ptr(),
            0 if e is None else e.data_ptr(),
            0 if s is None else s.data_ptr(), pp.data_ptr(), gp.data_ptr(),
            qp.data_ptr(), torch.cuda.current_stream(x_ext.device).cuda_stream)
    check(code, "chain")
    count_launch(chain)
    return _result(y, e, s, stats, pp.sum(dim=1), gp.sum(dim=1),
                   qp.sum(dim=1))


chain.launches = 0
