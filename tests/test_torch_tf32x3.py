"""The 3xTF32 arithmetic of the tensor-core kernels, emulated on the CPU.

``csrc/hopper.cuh`` splits each float32 operand into TF32 hi and lo parts
(``cvt.rna.tf32.f32``: the low 13 mantissa bits rounded to nearest, ties
away from zero) and sums hi*hi + hi*lo + lo*hi in float32.  The helpers
below do the same on the float32 bit patterns, and run

- the chain kernel's decomposition (``csrc/chain.cu``): each convolution
  as 16 x 8 Toeplitz slices of the taps, gathered by the kernel's index
  formula, times row-offset views of the staged stream, summed in blocks
  of 16 steps (128 taps), the envelope's blocks in two halves; the PSD as
  the tile's 16 frames times the pair-interleaved analysis matrix;
- the window_matmul kernel (``csrc/window_matmul.cu``): its sums in
  blocks of 128 taps at every caller's shapes; the host's plan (span or
  rows mode, column blocks, ring) against the kernel's shared-memory
  layout; and its staging and per-step A gather against ``unfold``.

Each result is held against the JAX package (``chain_cf`` and
``window_matmul`` in interpret mode on the CPU) and against float64 (scipy
or a float64 product of the same taps), at the kernels' budgets: filtered
and envelope 1e-5, PSD 0.013 dB for bins within 60 dB of the peak, window
stages 1e-5 of the output scale.  The MMA's own summation order is not
emulated; chip_smoke.py holds the kernels to the same budgets on the card.
"""

import math
from functools import lru_cache

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax.numpy as jnp

from audian_tpu.ops import design_envelope_filter, design_filter
from audian_tpu.ops.fused import FusedChainCF as JaxChain
from audian_tpu.ops.pallas.window_matmul import window_matmul as jax_wm

from audian_torch.convert import ARRAY_KEYS, chain_from_arrays
from audian_torch.models import get_preset
from audian_torch.ops.cuda._build import SMEM_LIMIT
from audian_torch.ops.cuda.chain import (TAP_PAD, TILES, ChainKernel,
                                         _pair_columns, fits, geometry,
                                         pick_tile, smem_bytes, split_tf32)
from audian_torch.ops.cuda.window_matmul import bank_conflicts, column_blocks
from audian_torch.ops.cuda.window_matmul import plan as wm_plan
from audian_torch.ops.cuda.window_matmul import smem_bytes as wm_smem_bytes
from audian_torch.ops.cuda.window_matmul import span_byte as wm_span_byte
from audian_torch.ops.cuda.window_matmul import window_matmul_plain
from audian_torch.ops.design import FilterDesign
from audian_torch.ops.envdet import EnvDet
from audian_torch.ops.fused import FusedChainCF

RATE = 48000.0
SOS_F = design_filter(RATE, 1000.0, 8000.0)
SOS_E = design_envelope_filter(RATE, 500.0)
TOL = 1e-5
TOL_PSD_DB = 0.013


# -- the TF32 arithmetic --------------------------------------------------

def rna(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    return r.view(torch.float32)


def split(x):
    hi = rna(x)
    return hi, rna(x - hi)


def mm3(a, b):
    """``a @ b`` in three TF32 passes summed in float32 (small ones
    first)."""
    ah, al = split(a)
    bh, bl = split(b)
    return (ah @ bl + al @ bh) + ah @ bh


def test_rna_rounds_like_cvt():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-12, -(1.0 + 2**-11),
                      1.0 + 2**-11 - 2**-23, 3.0e-39, 0.0],
                     dtype=torch.float32)
    want = [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10), 1.0,
            None, 0.0]
    got = rna(x)
    for g, w in zip(got.tolist(), want):
        if w is not None:
            assert g == w
    # the low 13 bits are zero, and the remainder is within 2^-22 of |x|
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    hi, lo = split(r)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    err = (hi.double() + lo.double() - r.double()).abs() / r.double().abs()
    assert float(err.max()) <= 2.0**-22
    # the host split of the taps is the same rounding
    h, l = split_tf32(r.numpy())
    assert torch.equal(torch.from_numpy(h), hi)
    assert torch.equal(torch.from_numpy(l), lo)


# -- the wgmma convolution core (csrc/wgmma_conv.cuh) ----------------------

VB = 16                # 8-tap steps a unit (128 taps)


def steps(T, D):
    """The core's 8-tap steps ``[v_lo, v_hi]`` whose 64 x 8 slices meet a
    tap (``wgconv::steps``)."""
    x = D - T - 6
    return ((x + 7) // 8 if x > 0 else 0), (D + 63) // 8


def qm_word(i, nu):
    """Word of sample ``i`` in one part of a quad-major stream of ``nu``
    rows a plane (``wgconv::qm_word``)."""
    return 4 * (((i >> 2) & 15) * nu + (i >> 6)) + (i & 3)


def quad_major(x, nu):
    """``x (B, n)`` written into a quad-major stream ``(B, 64 nu)``, zero
    past its end, as the kernels' fills write it."""
    out = torch.zeros(x.shape[0], 64 * nu, dtype=x.dtype)
    i = torch.arange(min(x.shape[1], 64 * nu))
    out[:, qm_word(i, nu)] = x[:, : len(i)]
    return out


def b_operand(words, nu, row0, v, N):
    """``B_v (B, 8, N)`` as the wgmma descriptor reads it from a stream:
    start ``4 (2 (v % 8) nu + v // 8 + row0)`` words, ``LBO = 4 nu`` words
    between the two k-quads, ``SBO = 32`` words between 8-column groups,
    each core matrix eight 4-word rows."""
    k = torch.arange(8)[:, None]
    U = torch.arange(N)[None, :]
    addr = (4 * (2 * (v % 8) * nu + v // 8 + row0) + (k // 4) * 4 * nu
            + (U // 8) * 32 + (U % 8) * 4 + k % 4)
    return words[:, addr]


def a_operand(tp, T, D, v, ph_off=0):
    """``A_v (64, 8)`` gathered from the host's split taps (``[hi | lo]``,
    each ``T + 2 TAP_PAD`` long): ``(hi, lo)``."""
    n = torch.arange(64)[:, None]
    k = torch.arange(8)[None, :]
    idx = ph_off + TAP_PAD + D + n - k - 8 * v
    return tp[idx], tp[idx + T + 2 * TAP_PAD]


def conv_core(parts, nu, tp, T, D, col0, N, units, nvb, v_lo, v_hi,
              src_rows=0, tap_phase=0):
    """``wgconv::conv``: the sum over ``units`` (phase ``u // nvb``, 16
    steps each) for the ``N`` columns from ``col0``, each unit's partial
    of three TF32 passes added to the total in fp32: ``(B, 64, N)``,
    ``out[64 (col0 + U) + n]`` at ``[:, n, U]``."""
    hi, lo = parts
    total = torch.zeros(hi.shape[0], 64, N)
    for u in units:
        ph, ub = divmod(u, nvb)
        vb = v_lo + VB * ub
        part = torch.zeros_like(total)
        for v in range(vb, min(vb + VB, v_hi + 1)):
            ah, al = a_operand(tp, T, D, v, ph * tap_phase)
            bh = b_operand(hi, nu, ph * src_rows + col0, v, N)
            bl = b_operand(lo, nu, ph * src_rows + col0, v, N)
            part = part + ((ah @ bl + al @ bh) + ah @ bh)
        total = total + part
    return total


def stream_rows(ncols, D):
    return ((64 * ncols + D + 7 + 63) // 64) | 1


def chunks(ncols, N):
    """``(col0, from, width)`` of a stage's chunks: ``N`` columns each, the
    last one moved back to end at ``ncols`` (its columns below ``from``
    left to the chunk before)."""
    return [(min(ch * N, max(ncols - N, 0)), ch * N, N)
            for ch in range(-(-ncols // N))]


def conv_tc(src, tp, T, D, ncols, N=64):
    """``out[b, i] = sum_m taps[m] src[b, i + D - m]`` for ``i < 64
    ncols`` as a kernel stage runs it: the source split and written
    quad-major, the stage's chunks (:func:`chunks`), each through
    :func:`conv_core` over all its units."""
    v_lo, v_hi = steps(T, D)
    nvb = (v_hi - v_lo + VB) // VB
    plan = chunks(ncols, N)
    nu = stream_rows(max([ncols] + [w for _, _, w in plan]), D)
    hi, lo = split(src)
    parts = (quad_major(hi, nu), quad_major(lo, nu))
    out = torch.zeros(src.shape[0], 64, ncols)
    for col0, start, w in plan:
        acc = conv_core(parts, nu, tp, T, D, col0, w, range(nvb), nvb, v_lo,
                        v_hi)
        for U in range(max(start, col0), min(col0 + w, ncols)):
            out[:, :, U] = acc[:, :, U - col0]
    return out.transpose(1, 2).reshape(src.shape[0], 64 * ncols)


def chain_tc(ck, x_ext, n):
    """The chain kernel's arithmetic over ``x_ext = [hb | n | ha...]``, at
    the tile the host picks: ``(y, e, psd)`` shaped (C, n), (C, n),
    (n // 128, C, nbins)."""
    x = x_ext.float() / 32768.0 if x_ext.dtype == torch.int16 \
        else x_ext.float()
    C = x.shape[0]
    Tf, L, tj = len(ck.h), len(ck.g), ck.tile
    ylen = tj + ck.lead + ck.tail
    xspan = ylen + Tf - 1
    ntiles = -(-n // tj)
    x = torch.nn.functional.pad(x, (0, ck.hb + ntiles * tj + xspan))
    src = torch.stack([x[:, ck.hb + j * tj - ck.lead - (Tf - 1):][:, :xspan]
                       for j in range(ntiles)], 1).reshape(-1, xspan)
    ys = conv_tc(src, ck.h_split, Tf, Tf - 1, ylen // 64)
    y = ys[:, ck.lead : ck.lead + tj].reshape(C, -1)[:, :n]
    ncols = tj // 64
    e = conv_tc((math.pi / 2) * ys.abs(), ck.g_split, L, ck.lead + ck.delay,
                ncols, N=128 if ncols >= 256 else 64)
    e = e.clamp_min(0.0) if ck.env_clamp else e
    e = e.reshape(C, -1)[:, :n]
    # the PSD: 64-frame tiles (A, split on the fly) against ws_slices
    nfft, half = ck.nfft, ck.nbins - 1
    nfr = tj // 128
    fr = torch.stack([ys[:, ck.lead + 128 * f : ck.lead + 128 * f + nfft]
                      for f in range(nfr)], 1)           # (B, nfr, nfft)
    fh, fl = split(fr)
    bh, bl = psd_operand(ck.ws_slices, nfft)
    s = (fh @ bl + fl @ bh) + fh @ bh                    # (B, nfr, nfft)
    re, im = s[..., 0::2], s[..., 1::2]
    p = re * re + im * im
    psd = torch.cat([re[..., :1] ** 2, p[..., 1:], im[..., :1] ** 2], -1)
    psd = psd.reshape(C, -1, ck.nbins)[:, : n // 128].transpose(0, 1)
    return y, e, psd


def psd_operand(slices, nfft):
    """``(hi, lo)`` of the PSD's B operand, ``(nfft, nfft)``, read from the
    host's slices as the kernel's descriptors read them: slice ``(cg, kk)``
    holds rows ``8 kk ..``, columns ``128 cg ..``; a part's core matrices
    sit 2048 bytes apart along K (LBO) and 128 bytes along N (SBO)."""
    nk = nfft // 8
    k = torch.arange(8)[:, None]
    c = torch.arange(128)[None, :]
    out = []
    for part in (0, 1):
        B = torch.zeros(nfft, nfft)
        for cg in range(nfft // 128):
            for kk in range(nk):
                base = (cg * nk + kk) * 2048 + part * 1024
                addr = base + (k // 4) * 512 + (c // 8) * 32 + (c % 8) * 4 \
                    + k % 4
                B[8 * kk : 8 * kk + 8, 128 * cg : 128 * cg + 128] = \
                    slices[addr]
        out.append(B)
    return tuple(out)


def psd_db_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    keep = want >= want.max() * 1e-6
    return float(np.abs(10 * np.log10(np.maximum(got[keep], 1e-300)
                                      / want[keep])).max())


@pytest.fixture(scope="module")
def chains():
    jc = JaxChain(RATE, filt_sos=SOS_F, env_sos=SOS_E, nfft=256, hop=128,
                  eps=1e-8)
    arrays = {k: (None if getattr(jc, k) is None
                  else np.asarray(getattr(jc, k))) for k in ARRAY_KEYS}
    return jc, chain_from_arrays(arrays, device="cpu")


def _stream(ck, n, seed):
    """(2, hb + n + ha): a gated 5 kHz tone plus noise, PCM-16, with the
    zero history of a recording's start."""
    rng = np.random.default_rng(seed)
    t = np.arange(n + ck.ha) / RATE
    x = np.sin(2 * np.pi * 5000.0 * t) * (np.sin(2 * np.pi * 6.0 * t) > 0)
    x = np.stack([0.5 * x, 0.25 * x]) + 0.05 * rng.standard_normal(
        (2, len(t)))
    q = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    return np.pad(q, [(0, 0), (ck.hb, 0)])


def test_steps_cover_the_true_taps(chains):
    """The core's 64 x 8 slices cover every true tap and little else (the
    zero corners of the first and last slices, within the host's zero
    padding), and the sub-blocks of the TPU's banks that act_f / act_e
    leave out hold no tap: covering the taps skips them."""
    _, tc = chains
    ck = tc.chain_kernel
    for taps, D, bank, act in (
            (ck.h, len(ck.h) - 1, ck.wf, ck.act_f),
            (ck.g, ck.lead + ck.delay, ck.we, ck.act_e)):
        T = len(taps)
        v_lo, v_hi = steps(T, D)
        # A_v holds taps[D - 8 v + (-7 .. 63)]
        m_lo, m_hi = D - 8 * v_hi - 7, D - 8 * v_lo + 63
        assert -TAP_PAD <= m_lo <= 0 and T - 1 <= m_hi < T + TAP_PAD
        assert 8 * (v_hi - v_lo + 1) <= T + 64 + 14
        active = {kb for kb, _ in act}
        skipped = [kb for kb in range(bank.shape[0] // 128)
                   if kb not in active]
        assert not any(bank[128 * kb : 128 * kb + 128].any()
                       for kb in skipped)
        assert sum(int(bank[128 * kb : 128 * kb + 128].any())
                   for kb in active) == len(active)
    for split_taps, taps in ((ck.h_split, ck.h), (ck.g_split, ck.g)):
        T = len(taps)
        hi, lo = split(taps)
        assert torch.equal(split_taps[TAP_PAD : TAP_PAD + T], hi)
        assert torch.equal(split_taps[3 * TAP_PAD + T : 3 * TAP_PAD + 2 * T],
                           lo)


@pytest.mark.parametrize("n", [4096, 3968])       # whole tiles, padded tail
def test_chain_decomposition_matches_jax_and_scipy(chains, n):
    jc, tc = chains
    ck = tc.chain_kernel
    q = _stream(ck, n, seed=3)
    y, e, s = chain_tc(ck, torch.from_numpy(q), n)
    jy, je, js = (np.asarray(a) for a in jc.chain_cf(jnp.asarray(q), n))
    assert float(np.abs(y.numpy() - jy).max()) <= TOL
    assert float(np.abs(e.numpy() - je).max()) <= TOL
    assert psd_db_err(s.numpy(), js) <= TOL_PSD_DB
    # scipy float64 from the zero history
    sig = q[:, ck.hb :].astype(np.float64) / 32768.0
    ys = sps.sosfilt(SOS_F, sig, axis=1)
    assert float(np.abs(y.numpy() - ys[:, :n]).max()) <= TOL
    es = np.maximum(sps.sosfiltfilt(SOS_E, (np.pi / 2) * np.abs(ys),
                                    axis=1), 0.0)
    d = tc.env_delay
    assert float(np.abs(e.numpy()[:, d : n - d] - es[:, d : n - d]).max()) \
        <= TOL
    _, _, ss = sps.spectrogram(ys[:, : n // 128 * 128 + 128], fs=RATE,
                               window="hann", nperseg=256, noverlap=128,
                               detrend=False, scaling="density", mode="psd",
                               axis=1)
    assert psd_db_err(s.numpy(), ss.transpose(2, 0, 1)[: n // 128]) \
        <= TOL_PSD_DB


def test_chain_decomposition_long_envelope():
    """A 24 Hz envelope (thousands of taps) against a float64 evaluation of
    the same taps: the blocked partial sums hold 1e-5."""
    fc = FusedChainCF(RATE, filt_sos=SOS_F,
                      env_sos=design_envelope_filter(RATE, 24.0), eps=1e-7,
                      device="cpu")
    ck = fc.chain_kernel
    assert isinstance(ck, ChainKernel) and len(ck.g) > 4096
    n = 2048
    q = _stream(ck, n, seed=5)
    y, e, _ = chain_tc(ck, torch.from_numpy(q), n)
    x = torch.from_numpy(q).double() / 32768.0
    Tf, L = len(ck.h), len(ck.g)
    seg = torch.nn.functional.pad(
        x[:, ck.hb - ck.lead - (Tf - 1):], (0, ck.tail))
    yf = torch.nn.functional.conv1d(
        seg[:, None], ck.h.double().flip(0)[None, None])[:, 0]
    a = ck.lead + ck.delay - (L - 1)
    ef = torch.nn.functional.conv1d(
        ((math.pi / 2) * yf.abs())[:, None, a : a + n + L - 1],
        ck.g.double().flip(0)[None, None])[:, 0].clamp_min(0.0)
    assert float((y.double() - yf[:, ck.lead : ck.lead + n]).abs().max()) \
        <= TOL
    assert float((e.double() - ef).abs().max()) <= TOL


# -- the core's layouts and the host's tile -----------------------------------

@pytest.mark.parametrize("nu", [73, 157, 285])
def test_quad_major_layout_round_trip(nu):
    """Every sample of a quad-major stream has its own word, and what the
    wgmma descriptor of a step reads (``b_operand``) is ``src[64 (col0 +
    U) + 8 v + k]``, for any step, column offset and width; eight
    consecutive quads of a warp's fill land in eight distinct 16-byte bank
    groups (``nu`` odd)."""
    i = torch.arange(64 * nu)
    words = qm_word(i, nu)
    assert len(set(words.tolist())) == 64 * nu and int(words.max()) < 64 * nu
    src = torch.arange(64 * nu, dtype=torch.float64)[None]
    stream = quad_major(src, nu)
    for v in (0, 1, 7, 8, 13, 23):
        for col0, N in ((0, 64), (5, 8), (nu - 64 - 4, 64)):
            got = b_operand(stream, nu, col0, v, N)[0]
            k = torch.arange(8)[:, None]
            U = torch.arange(N)[None, :]
            assert torch.equal(got, (64 * (col0 + U) + 8 * v + k).double())
    quads = torch.arange(8)
    groups = (4 * (quads * nu) // 4) % 8
    assert len(set(groups.tolist())) == 8


def test_psd_slices_follow_the_descriptor(chains):
    """The host's PSD slices, read as the kernel's descriptors read them,
    give back the TF32 split of the pair-interleaved analysis matrix
    exactly."""
    _, tc = chains
    ck = tc.chain_kernel
    bh, bl = psd_operand(ck.ws_slices, ck.nfft)
    hi, lo = split(torch.from_numpy(_pair_columns(ck.ws.numpy())))
    assert torch.equal(bh, hi) and torch.equal(bl, lo)
    assert ck.ws_slices.numel() == 2 * ck.nfft * ck.nfft


def pr10_smem_bytes(Tf, lead, tail):
    """Shared memory of the earlier chain kernel's block (2048 outputs,
    the split input span, the filtered span, the envelope halves' meeting
    point and the reduction buffer)."""
    ylen = 2048 + lead + tail
    return 4 * (2 * (-(-(ylen + Tf - 1 + 32) // 32) * 32) + ylen + 2048
                + 256)


def test_fits_accepts_every_earlier_design():
    """Every design the earlier kernel's gate took (its 2048-output tile
    within a block's shared memory) takes this kernel, at the widest tile
    of TILES that fits; envelopes up to the earlier gate's edge (about
    16 k taps) included, and the 24 Hz envelope of a 48 kHz chain."""
    taken = 0
    for nfft in (128, 256, 512):
        for Tf in (63, 175, 213, 1023):
            for L in list(range(15, 16500, 997)) + [14511, 16001]:
                delay = (L - 1) // 2
                lead, tail, _ = geometry(Tf, L, delay, nfft)
                if pr10_smem_bytes(Tf, lead, tail) > SMEM_LIMIT:
                    continue
                taken += 1
                tile = pick_tile(Tf, L, delay, nfft)
                assert fits(Tf, L, delay, nfft) and tile in TILES
                assert smem_bytes(Tf, L, delay, lead, tail, nfft,
                                  tile) <= SMEM_LIMIT
                wider = [t for t in TILES if t > tile]
                if wider:
                    assert smem_bytes(Tf, L, delay, lead, tail, nfft,
                                      min(wider)) > SMEM_LIMIT
    assert taken > 150
    fc = FusedChainCF(RATE, filt_sos=SOS_F,
                      env_sos=design_envelope_filter(RATE, 24.0), eps=1e-7,
                      device="cpu")
    ck = fc.chain_kernel
    assert ck is not None and len(ck.g) > 14000
    assert ck.smem_bytes == smem_bytes(len(ck.h), len(ck.g), ck.delay,
                                       ck.lead, ck.tail, ck.nfft, ck.tile)


# -- the window_matmul kernel's implicit GEMM -------------------------------

def trunc(x):
    """float32 ``x`` as the tensor cores read it as TF32: its low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_a(x):
    """The window_matmul kernel's split of A (``split_fast``): hi rounded
    as ``cvt.rna`` rounds, lo the remainder as it is, which the tensor
    cores truncate."""
    hi = rna(x)
    return hi, trunc(x - hi)


def window_tc(x, w, S, nframes, premap):
    """``window_matmul`` as the kernel sums it: 3xTF32 (A split by
    :func:`split_a`, ``w`` by :func:`split`) in blocks of 128 taps."""
    K = w.shape[0]
    x = x.float() / 32768.0 if x.dtype == torch.int16 else x.float()
    if premap == "rectify":
        x = (math.pi / 2) * x.abs()
    elif premap == "square":
        x = x * x
    need = (nframes - 1) * S + K
    x = torch.nn.functional.pad(x, (0, max(0, need - x.shape[1])))
    fr = x[:, :need].unfold(1, K, S)                       # (C, nf, K)
    acc = 0.0
    for k0 in range(0, K, 128):
        ah, al = split_a(fr[..., k0 : k0 + 128])
        bh, bl = split(w[k0 : k0 + 128])
        acc = acc + ((ah @ bl + al @ bh) + ah @ bh)
    return acc


def _window_cases():
    bio = get_preset("bioacoustics").fused(96000.0, device="cpu")
    fdet = FilterDesign.from_sos(sps.butter(1, (1000.0, 10000.0), "bandpass",
                                            fs=96000.0, output="sos"))
    edet = FilterDesign.from_sos(sps.butter(1, 500.0, "lowpass", fs=96000.0,
                                            output="sos"))
    ed = EnvDet(fdet, edet, 19, 256, 4096, device="cpu")
    global WINDOW_ENVDET
    WINDOW_ENVDET = ed
    return {
        "bioacoustics filter": (bio.filt_w, 128, 12, None),
        "bioacoustics envelope": (bio.env_w, 128, 12, "rectify"),
        "bioacoustics psd": (bio.spec_w, 128, 12, None),
        "ultrasound hop 90": (bio.spec_w, 90, 12, None),
        "EnvDet band-pass, dequant": (ed.w_bp, 128, 12, "dequant"),
        "EnvDet decimating envelope, square": (ed.b2, 128 * 19, 3, "square"),
    }


WINDOW_CASES = _window_cases()
#: callers whose banks are built on first use: (owner, bank), stride,
#: frames, premap; the last one runs past a 128-frame kernel tile
MORE_WINDOW_CASES = {
    "ultrasound psd": (("us", "spec_w"), 256, 12, None),
    "ultrasound envelope": (("us", "env_w"), 128, 12, "rectify"),
    "IFIR stage A": (("ifir", "env_i_w"), 128, 12, "rectify"),
    "IFIR stage B": (("ifir", "env_g_w"), 128, 12, None),
    "ragged last tile": (("bio", "filt_w"), 128, 130, None),
}


def _window_case(name):
    if name in WINDOW_CASES:
        return WINDOW_CASES[name]
    (owner, attr), S, nfr, premap = MORE_WINDOW_CASES[name]
    return getattr(_banks()[owner], attr), S, nfr, premap


@pytest.mark.parametrize("name", [*WINDOW_CASES, *MORE_WINDOW_CASES])
def test_window_matmul_gemm_matches_jax_and_float64(name):
    from audian_tpu.ops.envdet import _dequant, _square
    from audian_tpu.ops.fused import _rectify

    w, S, nfr, premap = _window_case(name)
    K = w.shape[0]
    rng = np.random.default_rng(9)
    n = (nfr - 1) * S + K - 21
    x = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    if premap == "dequant":
        x = np.round(np.clip(x, -1, 1) * 32767).astype(np.int16)
    got = window_tc(torch.from_numpy(x), w, S, nfr, premap).numpy()
    jp = {None: None, "rectify": _rectify, "dequant": _dequant,
          "square": _square}[premap]
    want = np.asarray(jax_wm(jnp.asarray(x), jnp.asarray(w.numpy()), S, nfr,
                             premap=jp, out_layout="fco")).transpose(1, 0, 2)
    xf = x.astype(np.float64) / (32768.0 if premap == "dequant" else 1.0)
    xf = {"rectify": (np.pi / 2) * np.abs(xf), "square": xf * xf}.get(
        premap, xf)
    xf = np.pad(xf, [(0, 0), (0, 21)])
    f64 = np.stack([xf[:, f * S : f * S + K] for f in range(nfr)], 1) \
        @ w.numpy().astype(np.float64)
    scale = float(np.abs(f64).max())
    assert float(np.abs(got - want).max()) <= TOL * scale
    assert float(np.abs(got - f64).max()) <= TOL * scale


# -- the window_matmul kernel's geometry (csrc/window_matmul.cu) -------------

@lru_cache(maxsize=None)
def _banks():
    """The caller banks of the per-stage presets, the IFIR envelope and
    EnvDet, built once (the IFIR factor fit takes a moment)."""
    bio = get_preset("bioacoustics").fused(96000.0, eps=2e-6, device="cpu")
    us = get_preset("ultrasound").fused(384000.0, eps=2e-6, device="cpu")
    fi = FusedChainCF(96000.0, env_sos=design_envelope_filter(96000.0, 500.0),
                      eps=1e-7, ifir=True, device="cpu")
    ed = WINDOW_ENVDET
    return {"bio": bio, "us": us, "ifir": fi, "envdet": ed}


#: every caller of window_matmul: (bank, stride, bytes a sample, the mode
#: the plan must take)
CALLERS = {
    "bioacoustics filter": (("bio", "filt_w"), 128, 4, "span"),
    "bioacoustics envelope": (("bio", "env_w"), 128, 4, "span"),
    "bioacoustics psd": (("bio", "spec_w"), 128, 4, "span"),
    "ultrasound filter": (("us", "filt_w"), 128, 4, "span"),
    "ultrasound envelope": (("us", "env_w"), 128, 4, "span"),
    "ultrasound psd": (("us", "spec_w"), 256, 4, "span"),
    "hop-90 psd": (("bio", "spec_w"), 90, 4, "span"),
    "EnvDet band-pass": (("envdet", "w_bp"), 128, 2, "span"),
    "EnvDet decimating envelope": (("envdet", "b2"), 128 * 19, 4, "rows"),
    "IFIR stage A": (("ifir", "env_i_w"), 128, 4, "span"),
    "IFIR stage B": (("ifir", "env_g_w"), 128, 4, "span"),
}


def _caller(name):
    (owner, attr), S, es, mode = CALLERS[name]
    return getattr(_banks()[owner], attr), S, es, mode


@pytest.mark.parametrize("name", list(CALLERS))
def test_window_plan_fits_every_caller(name):
    """The host's plan puts every caller in its mode with a column split
    and a ring that fit one block's shared memory, the span at every
    stride the presets use without a bank conflict on the fragment loads
    of S = 128 and 256 (the card's run holds the formula against the
    kernel's own, ``window_matmul_smem_bytes``)."""
    w, S, es, mode = _caller(name)
    K, O = w.shape
    p = wm_plan(K, O, S, es)
    assert p.mode == mode
    assert p.smem == wm_smem_bytes(K, O, S, es, p.N, p.mode, p.lsh, p.nbuf,
                                   p.ring)
    assert p.smem <= SMEM_LIMIT and 4 <= p.ring <= 8
    assert p.N * p.ncb >= O and p.N % 8 == 0 and p.N <= 256
    assert p.nbuf == 2 or mode == "span"
    if mode == "span":
        assert p.nbuf in (1, 2) and (es << p.lsh) % 16 == 0
        if S in (128, 256):
            assert bank_conflicts(S, es, p.lsh) == 1.0
        # a second span buffer whenever it fits beside four stages
        if p.nbuf == 1:
            two = wm_smem_bytes(K, O, S, es, p.N, "span", p.lsh, 2, 4)
            assert two > SMEM_LIMIT


@pytest.mark.parametrize("O, want", [(128, (128, 1)), (258, (136, 2)),
                                     (514, (176, 3)), (130, (136, 1)),
                                     (1026, (176, 6)), (40, (128, 1))])
def test_column_blocks_cover_the_columns(O, want):
    """Column blocks cover O exactly once with little padding (less than
    one 8-column group a block beyond an even split): 258 in two blocks of
    136, 514 in three of 176, no block near empty."""
    N, nb = column_blocks(O)
    assert (N, nb) == want
    cols = np.concatenate([np.arange(cb * N, min(cb * N + N, O))
                           for cb in range(nb)])
    assert np.array_equal(cols, np.arange(O))
    assert O - (nb - 1) * N > N // 2 or nb == 1
    assert nb * N - O < 8 * nb or N == 128


def _x_bytes(x, lead):
    """``x`` (C, n) laid out from byte ``lead`` of a flat buffer, with 16
    bytes of slack past its end (a 16-byte block never crosses a page)."""
    raw = np.zeros(lead + x.nbytes + 32, np.uint8)
    raw[lead : lead + x.nbytes] = np.frombuffer(x.tobytes(), np.uint8)
    return raw


def _load(buf, byte, es):
    """float32 values of samples at byte offsets ``byte`` of ``buf``
    (int16 dequantized by 2^-15)."""
    if es == 2:
        v = buf[byte] .astype(np.uint16) | (buf[byte + 1].astype(np.uint16) << 8)
        return v.view(np.int16).astype(np.float32) / 32768.0
    b = np.stack([buf[byte + i] for i in range(4)], -1).astype(np.uint32)
    v = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    return v.view(np.float32)


def gather_tile(x, K, S, nframes, c, f0, p, lead):
    """The A operand of one kernel item, ``(128, 8 V)``, as the kernel
    builds it: the producer's bulk copies of the span (span mode: chunks of
    ``2^lsh`` samples from the 16-byte aligned start, each followed by 16
    bytes of padding) or of each unit's window rows (rows mode: 128 taps a
    row from its aligned start), then every consumer thread's four values
    of every step, zero past n and past K."""
    C, n = x.shape
    es = x.dtype.itemsize
    raw = _x_bytes(x, lead)
    V = -(-K // 8)
    # the consumer threads: rows m0 and m0 + 8, taps t and t + 4 of a step
    wg, w, g, t = np.meshgrid(np.arange(2), np.arange(4), np.arange(8),
                              np.arange(4), indexing="ij")
    m0, t = (64 * wg + 16 * w + g).ravel(), t.ravel()
    v = np.arange(V)[:, None]
    A = np.full((128, 8 * V), np.nan, np.float32)
    if p.mode == "span":
        nf = min(128, nframes - f0)
        ln = (nf - 1) * S + 8 * V
        addr = lead + (c * n + f0 * S) * es
        src = addr & ~15
        off = (addr - src) // es
        cnt = min(ln, max(n - f0 * S, 0))
        nbytes = (off * es + cnt * es + 15) & ~15 if cnt > 0 else 0
        chunk = es << p.lsh
        # the span buffer: 128 frames, whole steps and the alignment
        samples = 16 // es - 1 + 127 * S + 8 * V
        span = np.zeros(-(-samples >> p.lsh) * (chunk + 16) + 64, np.uint8)
        for j in range(-(-nbytes // chunk)):
            m = min(chunk, nbytes - j * chunk)
            span[j * (chunk + 16) : j * (chunk + 16) + m] = \
                raw[src + j * chunk : src + j * chunk + m]
        for dr, dt in ((0, 0), (8, 0), (0, 4), (8, 4)):
            e = off + (m0 + dr) * S + t + dt + 8 * v          # (V, 256)
            val = _load(span, wm_span_byte(e, es, p.lsh), es)
            ok = (e < off + cnt) & (8 * v + t + dt < K)
            A[m0 + dr, 8 * v + t + dt] = np.where(ok, val, 0.0)
        return A
    rp = 128 * es + 16
    for u in range(-(-V // 16)):
        rows = np.zeros(128 * rp + 64, np.uint8)
        for r in range(128):
            if f0 + r >= nframes:
                continue
            col = (f0 + r) * S + 128 * u
            addr = lead + (c * n + col) * es
            src = addr & ~15
            cnt = min(128, max(n - col, 0))
            if cnt > 0:
                m = (addr - src + cnt * es + 15) & ~15
                rows[r * rp : r * rp + m] = raw[src : src + m]
        for dr, dt in ((0, 0), (8, 0), (0, 4), (8, 4)):
            col0 = (f0 + m0 + dr) * S
            roff = (lead + (c * n + col0) * es) & 15
            for vv in range(16 * u, min(16 * u + 16, V)):
                k = 8 * vv + t + dt
                val = _load(rows, (m0 + dr) * rp + roff
                            + es * (8 * (vv % 16) + t + dt), es)
                ok = (k < K) & (col0 + k < n)
                A[m0 + dr, k] = np.where(ok, val, 0.0)
    return A


@pytest.mark.parametrize("S, es, K, lead", [
    (128, 4, 269, 4), (128, 2, 638, 6), (256, 4, 512, 0), (90, 4, 256, 12),
    (2432, 4, 3436, 8), (2432, 2, 200, 2)])
def test_span_gather_equals_unfold(S, es, K, lead):
    """The kernel's staging and per-step A gather (span mode at S = 128,
    256, 90; rows mode at S = 2432), at a misaligned start, over a full
    tile, a ragged last tile running past n, and a channel > 0: every row
    of every item equals ``unfold`` of the zero-extended stream, zero past
    K."""
    rng = np.random.default_rng(S + K)
    C, nframes = 3, 200
    n = (nframes - 1) * S + K - 37 * es
    x = (rng.standard_normal((C, n)) * (3000 if es == 2 else 0.3))
    x = x.astype(np.int16 if es == 2 else np.float32)
    p = wm_plan(K, 128, S, es)
    assert p.mode == ("rows" if S == 2432 else "span")
    V = -(-K // 8)
    xf = x.astype(np.float32) / (32768.0 if es == 2 else 1.0)
    ext = np.pad(xf, [(0, 0), (0, 128 * S + 8 * V)])
    for c, f0 in ((0, 0), (2, 128)):
        A = gather_tile(x, K, S, nframes, c, f0, p, lead)
        nf = min(128, nframes - f0)
        want = np.stack([ext[c, (f0 + m) * S : (f0 + m) * S + 8 * V]
                         for m in range(nf)])
        want[:, K:] = 0.0
        assert np.array_equal(A[:nf], want)


@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0x7FC00000, 0x7F800001,
                                  0xFFFFFFFF, 0x7FFFF000, 0xFF801FFF])
def test_window_split_keeps_nan(bits):
    """A NaN of any payload (the card's canonical 0x7FFFFFFF among them)
    may round to a finite or infinite hi, but its lo, the remainder read
    as TF32, is NaN, so the kernel's products see it; a finite value's
    parts still add up to it within 2^-21."""
    x = torch.tensor([bits - (1 << 32) if bits >= 1 << 31 else bits],
                     dtype=torch.int32).view(torch.float32)
    hi, lo = split_a(x)
    assert bool(torch.isnan(x)) and bool(torch.isnan(trunc(lo)))
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(
        1000).astype(np.float32))
    hi, lo = split_a(r)
    err = (hi.double() + trunc(lo).double() - r.double()).abs()
    assert float((err / r.double().abs()).max()) <= 2.0**-21


@pytest.mark.parametrize("name", ["IFIR stage B", "bioacoustics envelope"])
def test_window_tc_keeps_nonfinite_inputs(name):
    """A NaN or an infinity on a stage's input (stage B's, from stage A on
    the card; the rectified envelope's, from the filter) leaves exactly
    the outputs whose windows hold it non-finite, as the plain version
    does, and the others within the tolerance."""
    w, S, nfr, premap = _window_case(name)
    K = w.shape[0]
    rng = np.random.default_rng(4)
    x = (0.3 * rng.standard_normal((2, (nfr - 1) * S + K))).astype(
        np.float32)
    x[0, 200], x[1, 3 * S + 7], x[1, (nfr - 2) * S + K - 3] = \
        np.nan, np.inf, -np.nan
    x = torch.from_numpy(x)
    got = window_tc(x, w, S, nfr, premap)
    want = window_matmul_plain(x, w, S, nfr, premap, "fco").transpose(0, 1)
    bad = ~torch.isfinite(want)
    assert bool(bad.any()) and not bool(bad.all())
    assert torch.equal(~torch.isfinite(got), bad)
    scale = float(want[~bad].abs().max())
    assert float((got[~bad] - want[~bad]).abs().max()) <= TOL * scale
