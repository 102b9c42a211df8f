"""The 3xTF32 arithmetic of the tensor-core kernels, emulated on the CPU.

``csrc/tf32x3.cuh`` splits each float32 operand into TF32 hi and lo parts
(``cvt.rna.tf32.f32``: the low 13 mantissa bits rounded to nearest, ties
away from zero) and sums hi*hi + hi*lo + lo*hi in float32.  The helpers
below do the same on the float32 bit patterns, and run

- the chain kernel's decomposition (``csrc/chain.cu``): each convolution
  as 16 x 8 Toeplitz slices of the taps, gathered by the kernel's index
  formula, times row-offset views of the staged stream, summed in blocks
  of 16 steps (128 taps), the envelope's blocks in two halves; the PSD as
  the tile's 16 frames times the pair-interleaved analysis matrix;
- the window_matmul kernel's implicit GEMM (``csrc/window_matmul.cu``),
  summed in blocks of 128 taps, at the bioacoustics and EnvDet shapes.

Each result is held against the JAX package (``chain_cf`` and
``window_matmul`` in interpret mode on the CPU) and against float64 (scipy
or a float64 product of the same taps), at the kernels' budgets: filtered
and envelope 1e-5, PSD 0.013 dB for bins within 60 dB of the peak, window
stages 1e-5 of the output scale.  The MMA's own summation order is not
emulated; chip_smoke.py holds the kernels to the same budgets on the card.
"""

import math

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
from audian_torch.ops.cuda.chain import (TAP_PAD, TILE, ChainKernel,
                                         split_tf32)
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


# -- the chain kernel's decomposition ---------------------------------------

def steps(T, D):
    """The kernel's 8-tap steps ``[v_lo, v_hi]`` (``conv_mma``)."""
    x = D - T - 6
    return ((x + 7) // 8 if x > 0 else 0), (D + 15) // 8


def conv_tc(src, taps, D, nout, split=1):
    """``out[b, i] = sum_m taps[m] src[b, i + D - m]`` for ``i < nout`` as
    ``conv_mma`` runs it: ``out[16 U + n] = sum_v A_v[n, :] src[16 U + 8 v
    + (0..7)]`` with ``A_v[n, k] = taps[n - k + D - 8 v]``, in blocks of 16
    steps, the blocks shared by ``split`` groups whose sums are added in
    order."""
    T = len(taps)
    v_lo, v_hi = steps(T, D)
    per = -(-((v_hi - v_lo + 16) // 16) // split) * 16
    tp = torch.zeros(T + 2 * TAP_PAD)
    tp[TAP_PAD : TAP_PAD + T] = taps
    nn = torch.arange(16)[:, None]
    kk = torch.arange(8)[None, :]
    U = torch.arange(nout // 16)[None, :]
    need = 16 * (nout // 16) + 8 * v_hi + 8
    src = torch.nn.functional.pad(src, (0, max(0, need - src.shape[1])))
    total = 0.0
    for v0 in range(v_lo, v_hi + 1, per):
        acc = torch.zeros(src.shape[0], 16, nout // 16)
        for vb in range(v0, min(v0 + per, v_hi + 1), 16):
            part = torch.zeros_like(acc)
            for v in range(vb, min(vb + 16, v_hi + 1)):
                a = tp[TAP_PAD + nn - kk + D - 8 * v]
                b = src[:, 16 * U + 8 * v + kk.T]            # (B, 8, nU)
                part = part + mm3(a, b)
            acc = acc + part
        total = total + acc
    return total.transpose(1, 2).reshape(src.shape[0], nout)


def chain_tc(ck, x_ext, n):
    """The chain kernel's arithmetic over ``x_ext = [hb | n | ha...]``:
    ``(y, e, psd)`` shaped (C, n), (C, n), (n // 128, C, nbins)."""
    x = x_ext.float() / 32768.0 if x_ext.dtype == torch.int16 \
        else x_ext.float()
    C = x.shape[0]
    Tf, L = len(ck.h), len(ck.g)
    ylen = TILE + ck.lead + ck.tail
    xspan = ylen + Tf - 1
    ntiles = -(-n // TILE)
    x = torch.nn.functional.pad(x, (0, ck.hb + ntiles * TILE + xspan))
    src = torch.stack([x[:, ck.hb + j * TILE - ck.lead - (Tf - 1):][:, :xspan]
                       for j in range(ntiles)], 1).reshape(-1, xspan)
    ys = conv_tc(src, ck.h, Tf - 1, ylen)
    y = ys[:, ck.lead : ck.lead + TILE].reshape(C, -1)[:, :n]
    e = conv_tc((math.pi / 2) * ys.abs(), ck.g, ck.lead + ck.delay, TILE,
                split=2)
    e = e.clamp_min(0.0) if ck.env_clamp else e
    e = e.reshape(C, -1)[:, :n]
    nfft, half = ck.nfft, ck.nbins - 1
    fr = torch.stack([ys[:, ck.lead + 128 * f : ck.lead + 128 * f + nfft]
                      for f in range(TILE // 128)], 1)   # (B, 16, nfft)
    s = 0.0
    for k0 in range(0, nfft, 128):
        s = s + mm3(fr[..., k0 : k0 + 128], ck.ws_pairs[k0 : k0 + 128])
    re, im = s[..., 0::2], s[..., 1::2]
    p = re * re + im * im
    psd = torch.cat([re[..., :1] ** 2, p[..., 1:], im[..., :1] ** 2], -1)
    psd = psd.reshape(C, -1, ck.nbins)[:, : n // 128].transpose(0, 1)
    return y, e, psd


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
    """The kernel's slices cover every true tap and little else (the zero
    corners of the first and last slices), and the sub-blocks of the TPU's
    banks that act_f / act_e leave out hold no tap: covering the taps
    skips them."""
    _, tc = chains
    ck = tc.chain_kernel
    for taps, D, bank, act in (
            (ck.h, len(ck.h) - 1, ck.wf, ck.act_f),
            (ck.g, ck.lead + ck.delay, ck.we, ck.act_e)):
        T = len(taps)
        v_lo, v_hi = steps(T, D)
        # A_v holds taps[D - 8 v + (-7 .. 15)]
        m_lo, m_hi = D - 8 * v_hi - 7, D - 8 * v_lo + 15
        assert -TAP_PAD < m_lo <= 0 and T - 1 <= m_hi < T + TAP_PAD
        assert 8 * (v_hi - v_lo + 1) <= T + 30
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


# -- the window_matmul kernel's implicit GEMM -------------------------------

def window_tc(x, w, S, nframes, premap):
    """``window_matmul`` as the kernel sums it: 3xTF32 in blocks of 128
    taps."""
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
        acc = acc + mm3(fr[..., k0 : k0 + 128], w[k0 : k0 + 128])
    return acc


def _window_cases():
    bio = get_preset("bioacoustics").fused(96000.0, device="cpu")
    fdet = FilterDesign.from_sos(sps.butter(1, (1000.0, 10000.0), "bandpass",
                                            fs=96000.0, output="sos"))
    edet = FilterDesign.from_sos(sps.butter(1, 500.0, "lowpass", fs=96000.0,
                                            output="sos"))
    ed = EnvDet(fdet, edet, 19, 256, 4096, device="cpu")
    return {
        "bioacoustics filter": (bio.filt_w, 128, 12, None),
        "bioacoustics envelope": (bio.env_w, 128, 12, "rectify"),
        "bioacoustics psd": (bio.spec_w, 128, 12, None),
        "ultrasound hop 90": (bio.spec_w, 90, 12, None),
        "EnvDet band-pass, dequant": (ed.w_bp, 128, 12, "dequant"),
        "EnvDet decimating envelope, square": (ed.b2, 128 * 19, 3, "square"),
    }


WINDOW_CASES = _window_cases()


@pytest.mark.parametrize("name", list(WINDOW_CASES))
def test_window_matmul_gemm_matches_jax_and_float64(name):
    from audian_tpu.ops.envdet import _dequant, _square
    from audian_tpu.ops.fused import _rectify

    w, S, nfr, premap = WINDOW_CASES[name]
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
