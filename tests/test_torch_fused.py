"""audian_torch's FusedChainCF per-stage methods against the JAX package
and scipy float64, on the headline-style design and on ``ultrasound``
(hop 256, which the single-pass chain refuses in both packages), plus the
chunked == whole invariant of ``chain_cf``."""

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax.numpy as jnp

from audian_tpu.models import get_preset as jax_preset
from audian_tpu.ops import design_envelope_filter, design_filter
from audian_tpu.ops.fused import FusedChainCF as JaxChain

from audian_torch.convert import ARRAY_KEYS, chain_from_arrays
from audian_torch.models import get_preset
from audian_torch.ops.fused import FusedChainCF

RATE = 48000.0
SOS_F = design_filter(RATE, 1000.0, 8000.0)
SOS_E = design_envelope_filter(RATE, 500.0)


def _arrays(jc):
    return {k: (None if getattr(jc, k) is None
                else np.asarray(getattr(jc, k))) for k in ARRAY_KEYS}


@pytest.fixture(scope="module")
def chains():
    jc = JaxChain(RATE, filt_sos=SOS_F, env_sos=SOS_E, nfft=256, hop=128,
                  eps=1e-8)
    return jc, chain_from_arrays(_arrays(jc), device="cpu")


@pytest.fixture(scope="module")
def signal():
    rng = np.random.default_rng(5)
    n = 12000
    t = np.arange(n) / RATE
    x = np.sin(2 * np.pi * 5000.0 * t) * (np.sin(2 * np.pi * 6.0 * t) > 0)
    x = x + 0.05 * rng.standard_normal(n)
    return np.stack([x, 0.5 * x, -x]).astype(np.float32)      # (C, n)


def test_filtered_cf(chains, signal):
    jc, tc = chains
    got = tc.filtered_cf(torch.from_numpy(signal)).numpy()
    np.testing.assert_allclose(got, np.asarray(jc.filtered_cf(signal)),
                               atol=1e-6)
    want = sps.sosfilt(SOS_F, signal.astype(np.float64), axis=1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_envelope_cf(chains, signal):
    jc, tc = chains
    y = sps.sosfilt(SOS_F, signal.astype(np.float64), axis=1)
    y32 = y.astype(np.float32)
    got = tc.envelope_cf(torch.from_numpy(y32)).numpy()
    np.testing.assert_allclose(got, np.asarray(jc.envelope_cf(
        jnp.asarray(y32))), atol=2e-6)
    want = np.maximum(sps.sosfiltfilt(SOS_E, (np.pi / 2) * np.abs(y),
                                      axis=1), 0.0)
    d = tc.env_delay
    np.testing.assert_allclose(got[:, d:-d], want[:, d:-d], atol=1e-5)


@pytest.mark.parametrize("nframes", [None, 40])
def test_spectrogram_fc(chains, signal, nframes):
    jc, tc = chains
    got = tc.spectrogram_fc(torch.from_numpy(signal), nframes).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jc.spectrogram_fc(jnp.asarray(signal), nframes)),
        rtol=1e-4, atol=1e-9)
    if nframes is None:
        _, _, want = sps.spectrogram(
            signal.astype(np.float64), fs=RATE, window="hann", nperseg=256,
            noverlap=128, detrend=False, scaling="density", mode="psd",
            axis=1)
        np.testing.assert_allclose(got, want.transpose(2, 0, 1), rtol=1e-5,
                                   atol=1e-10)


@pytest.mark.parametrize("outputs", [
    ("filtered", "envelope", "spectrogram"), ("envelope",),
    ("filtered", "spectrogram")])
def test_call_matches_jax(chains, signal, outputs):
    jc, tc = chains
    want = jc(signal, outputs=outputs)
    got = tc(torch.from_numpy(signal), outputs=outputs)
    assert set(got) == set(want) == set(outputs)
    tol = {"filtered": dict(atol=1e-6), "envelope": dict(atol=2e-6),
           "spectrogram": dict(rtol=1e-4, atol=1e-9)}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **tol[k])


def test_ultrasound_per_stage(signal):
    """hop 256 / NFFT 512: both packages refuse the single-pass chain and
    run the per-stage path; outputs agree, and match scipy."""
    rate = 96000.0
    jc = jax_preset("ultrasound").fused(rate)
    tc = get_preset("ultrasound").fused(rate, device="cpu")
    assert jc.chain_kernel is None and tc.chain_kernel is None
    assert (tc.hop, tc.nfft) == (256, 512)
    with pytest.raises(ValueError, match="per-stage"):
        tc.chain_cf(torch.zeros((1, 4096)), 128)
    t = np.arange(signal.shape[1]) / rate
    x = (0.5 * np.sin(2 * np.pi * 30000.0 * t) + signal[0] * 0.2)[None]
    x = x.astype(np.float32)
    want = jc(x)
    got = tc(torch.from_numpy(x))
    np.testing.assert_allclose(got["filtered"].numpy(),
                               np.asarray(want["filtered"]), atol=1e-6)
    np.testing.assert_allclose(got["envelope"].numpy(),
                               np.asarray(want["envelope"]), atol=2e-6)
    np.testing.assert_allclose(got["spectrogram"].numpy(),
                               np.asarray(want["spectrogram"]), rtol=1e-4,
                               atol=1e-9)
    sos = design_filter(rate, 20000.0, 90000.0)
    np.testing.assert_allclose(
        got["filtered"].numpy(),
        sps.sosfilt(sos, x.astype(np.float64), axis=1), atol=1e-5)


def test_chain_cf_chunked_equals_whole():
    """The single-pass chain gives the same results whether a recording
    is run whole or in halo-extended chunks (the batch path's invariant,
    tests/test_chunk_equivalence.py)."""
    rate = 48000.0
    chain = FusedChainCF(rate, filt_sos=design_filter(rate, 1000.0, 8000.0),
                         env_sos=design_envelope_filter(rate, 500.0),
                         nfft=256, hop=128, eps=1e-6, device="cpu")
    ck = chain.chain_kernel
    n, chunk = 8192, 4096
    x = np.random.default_rng(9).standard_normal(
        (2, ck.hb + n + ck.ha)).astype(np.float32)
    y_w, e_w, s_w = chain.chain_cf(torch.from_numpy(x), n)
    for k in range(n // chunk):
        lo = k * chunk
        ext = torch.from_numpy(x[:, lo : lo + ck.hb + chunk + ck.ha])
        y_c, e_c, s_c = chain.chain_cf(ext, chunk)
        np.testing.assert_allclose(y_c, y_w[:, lo : lo + chunk], atol=2e-6)
        np.testing.assert_allclose(e_c, e_w[:, lo : lo + chunk], atol=2e-6)
        f0 = lo // 128
        np.testing.assert_allclose(s_c, s_w[f0 : f0 + chunk // 128],
                                   rtol=1e-4, atol=1e-9)


def test_chain_gate_follows_shared_memory():
    """A long envelope whose tile still fits one block's shared memory
    takes the single-pass chain (above the 48 KB default: the launcher
    opts in); a longer one falls back to the per-stage methods, which
    still run."""
    filt = design_filter(RATE, 1000.0, 8000.0)
    env = design_envelope_filter(RATE, 24.0)
    fit = FusedChainCF(RATE, filt_sos=filt, env_sos=env, eps=1e-7,
                       device="cpu")
    assert fit.chain_kernel is not None
    assert 48 * 1024 < fit.chain_kernel.smem_bytes <= 232448
    big = FusedChainCF(RATE, filt_sos=filt, env_sos=env, eps=1e-10,
                       device="cpu")
    assert big.chain_kernel is None
    with pytest.raises(ValueError, match="per-stage"):
        big.chain_cf(torch.zeros((1, 1024)), 128)
    out = big(torch.zeros((1, 4096)))
    assert out["envelope"].shape == (1, 4096)


def test_ifir_is_not_ported():
    with pytest.raises(NotImplementedError):
        FusedChainCF(RATE, env_sos=SOS_E, ifir=True)
