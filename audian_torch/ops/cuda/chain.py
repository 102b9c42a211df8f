"""Single-pass fused chain: int16 or float32 PCM -> band-pass FIR ->
{rectified zero-phase envelope, Hann PSD at hop 128} + chunk statistics.

:class:`ChainKernel` is the host setup of
``audian_tpu/ops/pallas/chain.py:FusedChainKernel``: the halo geometry
(``hb``, ``ha``, ``lead``, ``tail``, ``offe``), the lane-packed analysis
matrix ``ws``, and the TPU kernel's generalized Toeplitz banks with their
sub-block classification (``wf``/``we``, ``act_f``/``act_e``).  The CUDA
kernel (``csrc/chain.cu``) runs each convolution as Toeplitz products on
the tensor cores (wgmma, ``csrc/wgmma_conv.cuh``), gathering the slices
from the taps split on the host; its steps cover exactly the true taps,
which are the rows of the active sub-blocks.  The PSD is a dense product
with the pair-interleaved analysis matrix (:func:`_pair_columns` of
``ws``), split and laid out K-major on the host.

Each stage takes its own precision rung (:mod:`.precision`; ``precision=``
one rung or a (filter, envelope, PSD) tuple, 3xTF32 on every stage by
default): three TF32 passes (HIGHEST, HIGH) over TF32 splits
(:func:`split_tf32`: ``h_split``/``g_split``, ``ws_slices``), one TF32
pass (DEFAULT), or three or four bf16 passes (BF16X3, BF16X4) over bf16
splits (:func:`split_bf16`: the pair vectors of :func:`pair_taps`,
:func:`psd_slices_bf16`).  As in the JAX kernel, light parts of the
filter and the envelope run one pass whatever the rung: the core's units
of 128 taps whose summed L1 mass stays under :data:`LIGHT_MASS_FRAC` of
the taps' (:func:`light_units`, ``light_f``/``light_e``; the JAX flags of
the banks' 128-row sub-blocks stay as the record).  :func:`smem_bytes`
and :func:`pick_tile` mirror the kernel's shared-memory formula and the
host's tile choice for the stages' modes.

:func:`chain` launches the kernel on a CUDA tensor and runs the plain
PyTorch version :func:`chain_plain` on a CPU tensor; any other device
raises.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ...utils import resolve_device, round_up
from ..raw16 import dequant16
from ..sos import _fir_valid_cf, full_fp32
from ..stft import frame_signal
from ._build import SMEM_LIMIT, launch, load_library
from .precision import (BF16X3, BF16X4, HIGHEST, core_mode,
                        stage_precisions)

__all__ = ["ALL_OUTPUTS", "BF16X3", "BF16X4", "ChainKernel", "as_stream",
           "bf16_rne", "chain", "chain_plain", "core_steps", "fits",
           "flags_tensor", "light_units", "pair_taps", "pick_tile", "psd_slices", "psd_slices_bf16",
           "smem_bytes", "split_bf16", "split_tf32", "stream_rows",
           "unit_masses", "unit_steps"]

#: the full output set (and the default ``outputs`` mask)
ALL_OUTPUTS = ("filtered", "envelope", "spectrogram")

#: output samples per kernel tile, widest first (``TILE_MAX`` in
#: csrc/chain.cu is the first); the host takes the widest that fits
TILES = (16384, 8192, 4096, 2048, 1024, 512, 256, 128)
#: consumer warps of a kernel block (``NWARP`` in csrc/chain.cu): the
#: statistics come back as one partial per warp
WARPS = 8
#: zero taps each side of a split tap vector (``TPAD`` in
#: csrc/wgmma_conv.cuh): a bf16 slice of 64 x 16 reaches 79 past either end
TAP_PAD = 80
#: the kernel's PSD operand ring (``RING`` and ``STAGE_BYTES`` in
#: csrc/chain.cu): 8 stages of two slices of 8 rows by 128 columns, hi and
#: lo
_SLICE_COLS = 128
_RING = 8
_RING_BYTES = _RING * 2 * (2 * 8 * _SLICE_COLS * 4)
#: mbarriers after the two regions (``NBAR`` in csrc/chain.cu)
_NBAR = 3 + 2 * _RING


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


def bf16_rne(a):
    """float32 ``a`` rounded to bfloat16 (8 significant bits, to nearest,
    ties to even), as float32: ``cvt.rn.bf16`` and ``torch.bfloat16``;
    a NaN becomes the quiet NaN 0x7FC00000, infinities stay."""
    a = np.ascontiguousarray(a, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    r = np.where(np.isnan(a), np.uint32(0x7FC00000), r)
    return r.view(np.float32)


def split_bf16(a):
    """``(hi, lo)`` float32 arrays, each bf16-representable: ``hi =
    bf16(a)`` and ``lo = bf16(a - hi)``, both rounded to nearest even (the
    TPU's DEFAULT pass rounds the f32 remainder to bf16 too), so that
    ``hi + lo`` is ``a`` within about 2^-16 of |a|."""
    a = np.ascontiguousarray(a, np.float32)
    hi = bf16_rne(a)
    return hi, bf16_rne(a - hi)


def _split_taps(taps):
    """The kernel's TF32 tap operand: ``[hi | lo]``, each ``T + 2 TAP_PAD``
    long with :data:`TAP_PAD` zeros on either side."""
    hi, lo = split_tf32(taps)
    return np.concatenate([np.pad(p, TAP_PAD) for p in (hi, lo)])


def pair_taps(taps):
    """The kernel's bf16 tap operand: ``[hi | lo]`` int32 vectors of
    ``T + 2 TAP_PAD`` words, word ``TAP_PAD + m`` holding the bf16 bits of
    ``taps[m]`` in its low half and of ``taps[m - 1]`` in its high half
    (zero outside the taps): an A register of a 64 x 16 Toeplitz slice,
    ``(A[n][2t], A[n][2t + 1])``, is then one word."""
    out = []
    for part in split_bf16(taps):
        b = (np.pad(part, TAP_PAD).view(np.uint32) >> 16).astype(np.uint32)
        prev = np.concatenate([[0], b[:-1]]).astype(np.uint32)
        out.append((b | (prev << 16)).view(np.int32))
    return np.concatenate(out)


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


def core_steps(T, D, kw=8):
    """``(v_lo, v_hi)``: the core's steps of ``kw`` taps (8 TF32, 16 bf16)
    whose 64 x kw slices meet a tap of a ``T``-tap convolution at delay
    ``D`` (``wgconv::steps``)."""
    x = D - T - (kw - 2)
    return (-(-x // kw) if x > 0 else 0), (D + 63) // kw


def unit_steps(T, D, kw=8, phase=0):
    """The core's units as ``[start, end)`` step ranges: 128 taps each from
    the base ``v_lo - phase``, cut to ``[v_lo, v_hi]``."""
    v_lo, v_hi = core_steps(T, D, kw)
    vb = 128 // kw
    base = v_lo - phase
    return [(max(v_lo, base + vb * u), min(base + vb * (u + 1), v_hi + 1))
            for u in range((v_hi - base + vb) // vb)]


def unit_masses(taps, D, kw=8, phase=0):
    """Each unit's L1 tap mass, the largest over the 64 output rows of a
    column: row ``n`` of steps ``[vs, ve)`` reads the taps ``D + n - kw
    (ve - 1) - (kw - 1) .. D + n - kw vs``, so a unit's one-pass error at
    any output is at most this mass times the pass's rounding."""
    a = np.abs(np.asarray(taps, np.float64))
    T = len(a)
    cs = np.concatenate([[0.0], np.cumsum(a)])
    n = np.arange(64)
    out = []
    for vs, ve in unit_steps(T, D, kw, phase):
        lo = np.clip(D + n - kw * (ve - 1) - (kw - 1), 0, T)
        hi = np.clip(D + n - kw * vs + 1, 0, T)
        out.append(float(np.max(np.where(hi > lo, cs[hi] - cs[lo], 0.0))))
    return out


def light_units(taps, D, kw=8):
    """``(phase, flags)``: the core's units of a convolution and which run
    one pass, by the JAX kernel's rule (:func:`_active`) on the core's own
    granularity: light greedily from the smallest :func:`unit_masses` while
    their sum stays under :data:`LIGHT_MASS_FRAC` of the taps' L1 mass.
    The units' base (``phase``) is the one that leaves the most steps
    light (then the fewest units, then the least phase)."""
    budget0 = LIGHT_MASS_FRAC * float(np.abs(np.asarray(taps,
                                                        np.float64)).sum())
    best = None
    for phase in range(128 // kw):
        mass = unit_masses(taps, D, kw, phase)
        spans = unit_steps(len(taps), D, kw, phase)
        budget, light = budget0, set()
        for u in sorted(range(len(mass)), key=mass.__getitem__):
            if mass[u] > budget:
                break
            budget -= mass[u]
            light.add(u)
        saved = sum(spans[u][1] - spans[u][0] for u in light)
        key = (saved, -len(mass), -phase)
        if best is None or key > best[0]:
            best = (key, phase, tuple(u in light for u in range(len(mass))))
    return best[1], best[2]


@lru_cache(maxsize=64)
def flags_tensor(flags, device):
    """The kernels' unit flags (a tuple of bools) as int32 on ``device``,
    made once for each value."""
    return torch.tensor([int(f) for f in flags] or [0], dtype=torch.int32,
                        device=device)


def geometry(Tf, L, delay, nfft):
    """``(lead, tail, y0)`` of a design with ``Tf`` filter taps and an
    ``L``-tap envelope of group delay ``delay``: the envelope's look-back,
    the consumers' look-ahead past the chunk, and the filter's history,
    each a whole number of 128-sample frames."""
    lead = round_up(L - 1 - delay, 128)
    tail = round_up(max(delay, nfft - 128), 128)
    return lead, tail, round_up(Tf - 1, 128)


def stream_rows(ncols, D, kw=8):
    """Rows a plane of a split stream needs for ``ncols`` output columns of
    64 at delay ``D`` with steps of ``kw`` taps (quad-major TF32 at 8,
    octet-major bf16 at 16; ``stream_rows`` in csrc/wgmma_conv.cuh),
    odd."""
    return ((64 * ncols + D + kw - 1 + 63) // 64) | 1


def _kw(mode):
    """Taps a step of the core in ``mode`` (``wgconv::kwidth``)."""
    return 16 if mode >= 2 else 8


def smem_bytes(Tf, L, delay, lead, tail, nfft, tile, modes=(0, 0)):
    """Shared memory of one chain block at ``tile`` outputs
    (``chain_smem_bytes`` in csrc/chain.cu) with the filter and the
    envelope in the core's ``modes``: region X holds the split input
    stream, then the PSD operand ring, then the split rectified stream (a
    part 256 bytes a row for TF32, 128 for bf16); region Y the input copy,
    then the filtered span; the mbarriers follow.  The taps are read
    through L1, so ``L`` counts only through the halos."""
    del L, nfft
    mode_f, mode_e = modes
    ylen = tile + lead + tail
    xspan = ylen + Tf - 1
    nu_f = stream_rows(max(ylen // 64, 64), Tf - 1, _kw(mode_f))
    nu_e = stream_rows(max(tile // 64, 64), lead + delay, _kw(mode_e))
    x = max(2 * 2048 // _kw(mode_f) * nu_f, 2 * 2048 // _kw(mode_e) * nu_e,
            _RING_BYTES)
    y = max(4 * ylen, (4 * xspan + 32 + 15) & ~15)
    return x + y + 8 * _NBAR


def pick_tile(Tf, L, delay, nfft, modes=(0, 0)):
    """The widest tile of :data:`TILES` whose block fits the shared memory
    with the filter and the envelope in ``modes``, or ``None``."""
    lead, tail, _ = geometry(Tf, L, delay, nfft)
    for tile in TILES:
        if smem_bytes(Tf, L, delay, lead, tail, nfft, tile,
                      modes) <= SMEM_LIMIT:
            return tile
    return None


def fits(Tf, L, delay, nfft, modes=(0, 0)):
    """Whether some tile of a design fits the shared memory of one
    block."""
    return pick_tile(Tf, L, delay, nfft, modes) is not None


def psd_slices(ws_pairs):
    """The kernel's PSD operand: the pair-interleaved analysis matrix
    (nfft x nfft, rows k, columns the bin pairs) split into TF32 hi and lo and cut into slices of 8 rows
    by 128 columns, column group major, each slice ``[hi | lo]`` of
    K-major core matrices: word ``512 kq + 32 (c // 8) + 4 (c % 8) + r``
    of a part holds row ``8 kk + 4 kq + r``, column ``128 cg + c``."""
    ws = np.asarray(ws_pairs, np.float32)
    nfft = ws.shape[0]
    parts = np.stack(split_tf32(ws))               # (2, k, col)
    a = parts.reshape(2, nfft // 8, 2, 4, nfft // _SLICE_COLS, 16, 8)
    # (part, kk, kq, r, cg, c8, c) -> (cg, kk, part, kq, c8, c, r)
    return np.ascontiguousarray(a.transpose(4, 1, 0, 2, 5, 6, 3)).ravel()


def psd_slices_bf16(ws_pairs):
    """The kernel's PSD operand for a bf16 PSD: the pair-interleaved
    analysis matrix split into bf16 hi and lo (:func:`split_bf16`) and cut
    into slices of 16 rows by 128 columns, column group major, each slice
    ``[hi | lo]`` of K-major core matrices of eight bf16 along K: half-word
    ``1024 ko + 64 (c // 8) + 8 (c % 8) + r`` of a part holds row
    ``16 kk + 8 ko + r``, column ``128 cg + c`` (the bytes of a TF32
    slice, read with the same descriptor strides).  int16 bit patterns."""
    ws = np.asarray(ws_pairs, np.float32)
    nfft = ws.shape[0]
    parts = (np.stack(split_bf16(ws)).view(np.uint32) >> 16).astype(
        np.uint16)                                 # (2, k, col)
    a = parts.reshape(2, nfft // 16, 2, 8, nfft // _SLICE_COLS, 16, 8)
    # (part, kk, ko, r, cg, c8, c) -> (cg, kk, part, ko, c8, c, r)
    return np.ascontiguousarray(
        a.transpose(4, 1, 0, 2, 5, 6, 3)).ravel().view(np.int16)


class ChainKernel:
    """The single-pass chain over a fixed design, on one device.

    Inputs are extended streams ``[hb | n | ha...]`` (channels-first,
    int16 or float32) with ``hb = self.hb``; columns past the stream's end
    read as zero.  Raises ValueError when the design does not fit one
    kernel block's shared memory (:func:`fits`), or on a precision that is
    not one rung or a (filter, envelope, PSD) tuple of rungs
    (:mod:`.precision`).  ``device`` defaults to the CUDA card (see
    :func:`audian_torch.utils.resolve_device`).

    ``light_f``/``light_e`` flag the filter's and the envelope's units
    that run one pass (from ``phase_f``/``phase_e``, :func:`light_units`);
    a check may set them all ``False`` to run every unit in full.
    """

    #: per-stage (filter, envelope, PSD) rungs: 3xTF32 everywhere.  The
    #: JAX package ships (HIGHEST, BF16X3, BF16X3) (its
    #: ``FusedChainKernel.DEFAULT_PRECISION``); the port keeps fp32
    #: precision on every stage by default and runs the JAX tuple only when
    #: asked (a divergence, ROADMAP.md Queue 3)
    DEFAULT_PRECISION = (HIGHEST, HIGHEST, HIGHEST)

    def __init__(self, rate, h_filt, g_env, env_delay, spec_w, nbins,
                 env_clamp=True, nfft=256, device=None,
                 precision=DEFAULT_PRECISION):
        self.precision = stage_precisions(precision)
        self.modes = tuple(core_mode(p) for p in self.precision)
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
        # the core's units and the ones that run one pass, at each stage's
        # step width
        kw_f, kw_e = (_kw(m) for m in self.modes[:2])
        self.phase_f, self.light_f = light_units(h_filt, Tf - 1, kw_f)
        self.phase_e, self.light_e = light_units(g_env, De, kw_e)
        self.tile = pick_tile(Tf, L, delay, self.nfft, self.modes[:2])
        if self.tile is None:
            raise ValueError(
                f"chain kernel tile needs more than {SMEM_LIMIT} B of "
                f"shared memory (filter {Tf} + envelope {L} taps); the "
                f"per-stage methods handle this design")
        self.smem_bytes = smem_bytes(Tf, L, delay, self.lead, self.tail,
                                     self.nfft, self.tile, self.modes[:2])

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
        self.ws_slices = dev(psd_slices(_pair_columns(ws)))
        # each stage's operand in its mode: the TF32 splits above, or bf16
        # pair vectors and slices
        bf = [m >= 2 for m in self.modes]
        self.h_taps = (torch.from_numpy(pair_taps(h_filt)).to(device)
                       if bf[0] else self.h_split)
        self.g_taps = (torch.from_numpy(pair_taps(g_env)).to(device)
                       if bf[1] else self.g_split)
        self.ws_operand = (
            torch.from_numpy(psd_slices_bf16(_pair_columns(ws))).to(device)
            if bf[2] else self.ws_slices)

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
    times the full analysis matrix ``spec_w``, all in full float32 whatever
    ``ck.precision`` (checked): the function, not a rung's rounding."""
    stage_precisions(ck.precision)
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


def as_stream(x_ext, device):
    """``x_ext`` as a tensor: a host array (numpy, as the JAX chain takes)
    goes to ``device``, int16 as it is and anything else as float32; a
    tensor stays where it is."""
    if isinstance(x_ext, torch.Tensor):
        return x_ext
    a = np.asarray(x_ext)
    if a.dtype != np.int16:
        a = a.astype(np.float32, copy=False)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def chain(ck, x_ext, n, stats=False, outputs=ALL_OUTPUTS):
    """The single-pass chain of ``ck`` over ``x_ext = [hb | n | ha...]``.

    A CUDA tensor runs the kernel on its own device (counted in
    ``chain.launches``); a CPU
    tensor runs :func:`chain_plain`.  ``outputs`` is the static mask: a
    stage not requested is neither computed nor written, returns ``None``
    and reports zero stats.  A host array (numpy, as the JAX chain takes)
    goes to the design's device first: int16 as it is, anything else as
    float32.
    """
    x_ext = as_stream(x_ext, ck.h.device)
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
    ntiles = -(-n // ck.tile)
    nf = n // 128

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x_ext.device)

    y = empty(C, n) if want_f else None
    e = empty(C, n) if want_e else None
    s = empty(nf, C, ck.nbins) if want_s else None
    pp, gp = empty(C, ntiles, WARPS), empty(C, ntiles, WARPS)
    # the kernel writes the PSD's partials only where it runs the PSD
    qp = (empty(C, ntiles, WARPS, ck.nbins) if want_s else
          torch.zeros((C, ntiles, WARPS, ck.nbins), device=x_ext.device))
    # launched on the tensor's device: the current device may be another
    launch(chain, "chain", load_library().chain_launch, x_ext.device,
           x_ext.data_ptr(), int(x_ext.dtype == torch.int16), xlen, C, n,
           ck.h_taps.data_ptr(), len(ck.h), ck.g_taps.data_ptr(),
           len(ck.g), ck.delay, ck.lead, ck.tail, ck.hb,
           ck.ws_operand.data_ptr(), ck.nfft, ck.tile, *ck.modes,
           ck.phase_f, ck.phase_e,
           flags_tensor(tuple(ck.light_f) + tuple(ck.light_e),
                        x_ext.device).data_ptr(),
           int(ck.env_clamp), int(want_f), int(want_e), int(want_s),
           0 if y is None else y.data_ptr(),
           0 if e is None else e.data_ptr(),
           0 if s is None else s.data_ptr(), pp.data_ptr(), gp.data_ptr(),
           qp.data_ptr())
    return _result(y, e, s, stats, pp.sum(dim=(1, 2)), gp.sum(dim=(1, 2)),
                   qp.sum(dim=(1, 2)))


chain.launches = 0
