"""audian_torch's FusedChainCF per-stage methods against the JAX package
and scipy float64, on the headline-style design and on ``ultrasound``
(hop 256, which the single-pass chain refuses in both packages), plus the
chunked == whole invariant of ``chain_cf``, and the interpolated-FIR
envelope (``ifir=True``): the mode and factors the JAX package picks,
bit-equal banks, the envelope within 2e-6 of the JAX package's and of a
float64 evaluation of the same float32 factors, and within 3e-6 of the
dense one (the JAX test's budget: the factors' 2e-6 L1 fit error plus
float32 sums).  2e-6 is this file's budget against the JAX envelope: both
packages sum the two stages' 224- and 260-term products in float32, each
about 1e-6 from the float64 evaluation in different samples, so the two
differ by more than 1e-6 in places (1.19e-6 in one sample of the IFIR
stream).  The factor fits (numpy least squares, seconds each) run on one
BLAS thread."""

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax.numpy as jnp
from threadpoolctl import threadpool_limits

from audian_tpu.models import get_preset as jax_preset
from audian_tpu.ops import design_envelope_filter, design_filter
from audian_tpu.ops.fused import FusedChainCF as JaxChain

from audian_torch.convert import ARRAY_KEYS, IFIR_KEYS, chain_from_arrays
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
    run the per-stage path; outputs agree, and match scipy.  The port's
    ``chain_cf`` runs the per-stage route over the stream extended by its
    halos (zeros) and equals the per-stage methods where they see the same
    samples (the JAX package's ``chain_cf`` raises)."""
    rate = 96000.0
    jc = jax_preset("ultrasound").fused(rate)
    tc = get_preset("ultrasound").fused(rate, device="cpu")
    assert jc.chain_kernel is None and tc.chain_kernel is None
    assert (tc.hop, tc.nfft) == (256, 512)
    t = np.arange(signal.shape[1]) / rate
    x = (0.5 * np.sin(2 * np.pi * 30000.0 * t) + signal[0] * 0.2)[None]
    x = x.astype(np.float32)
    want = jc(x)
    got = tc(torch.from_numpy(x))
    n, d = x.shape[1], tc.env_delay
    y, e, s = tc.chain_cf(torch.from_numpy(
        np.pad(x, [(0, 0), (tc.hb, tc.ha)])), n)
    nf = (n - tc.nfft) // tc.hop + 1
    np.testing.assert_allclose(y.numpy(), got["filtered"].numpy(), atol=1e-6)
    np.testing.assert_allclose(e.numpy()[:, : n - d],
                               got["envelope"].numpy()[:, : n - d],
                               atol=2e-6)
    np.testing.assert_allclose(s.numpy()[:nf], got["spectrogram"].numpy(),
                               rtol=1e-4, atol=1e-9)
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
    still run, and ``chain_cf`` to the per-stage route."""
    filt = design_filter(RATE, 1000.0, 8000.0)
    env = design_envelope_filter(RATE, 24.0)
    fit = FusedChainCF(RATE, filt_sos=filt, env_sos=env, eps=1e-7,
                       device="cpu")
    assert fit.chain_kernel is not None
    assert 48 * 1024 < fit.chain_kernel.smem_bytes <= 232448
    big = FusedChainCF(RATE, filt_sos=filt, env_sos=env, eps=1e-10,
                       device="cpu")
    assert big.chain_kernel is None
    y, e, s = big.chain_cf(torch.zeros((1, big.hb + 1024 + big.ha)), 1024)
    assert (y.shape, e.shape, s.shape) == ((1, 1024), (1, 1024),
                                           (8, 1, 129))
    out = big(torch.zeros((1, 4096)))
    assert out["envelope"].shape == (1, 4096)


# -- the interpolated-FIR envelope -----------------------------------------

#: (rate, envelope cutoff): the factors the JAX package picks for the
#: bioacoustics envelope and a wider one, at 96 and 44.1 kHz (1.5 kHz at
#: 44.1 kHz does not factor within 2e-6 and stays dense)
IFIR_DESIGNS = [(96000.0, 500.0), (96000.0, 1500.0), (44100.0, 500.0),
                (44100.0, 1500.0)]
TOL_IFIR = 2e-6
_ifir_cache = {}


def ifir_design_pair(rate, cutoff):
    """The JAX package's and the port's ``FusedChainCF(ifir=True)`` over
    one envelope design (each fits its own factors; kept for the file)."""
    key = (rate, cutoff)
    if key not in _ifir_cache:
        env = design_envelope_filter(rate, cutoff)
        with threadpool_limits(1):
            _ifir_cache[key] = (JaxChain(rate, env_sos=env, ifir=True),
                                FusedChainCF(rate, env_sos=env, ifir=True,
                                             device="cpu"))
    return _ifir_cache[key]


@pytest.fixture(scope="module")
def ifir_chains():
    """The JAX and port IFIR chains with the band-pass, and the port's
    dense one, at the JAX IFIR test's design (48 kHz, 500 Hz, eps 1e-8)."""
    kw = dict(filt_sos=SOS_F, env_sos=SOS_E, eps=1e-8)
    with threadpool_limits(1):
        return (JaxChain(RATE, ifir=True, **kw),
                FusedChainCF(RATE, ifir=True, device="cpu", **kw),
                FusedChainCF(RATE, ifir=False, device="cpu", **kw))


@pytest.fixture(scope="module")
def ifir_signal():
    """The JAX IFIR tests' stream: 2 channels x 20000 samples."""
    rng = np.random.default_rng(42)
    n = 20000
    t = np.arange(n) / RATE
    x = np.sin(2 * np.pi * 5000.0 * t) * (np.sin(2 * np.pi * 6.0 * t) > 0)
    x = x + 0.05 * rng.standard_normal(n)
    return np.stack([x, 0.5 * x]).astype(np.float32)


@pytest.mark.parametrize("rate,cutoff", IFIR_DESIGNS)
def test_ifir_mode_matches_jax(rate, cutoff):
    jc, tc = ifir_design_pair(rate, cutoff)
    assert tc.env_mode == jc.env_mode
    assert tc.env_halo == jc.env_halo and tc.env_delay == jc.env_delay
    if jc.env_mode == "ifir":
        assert (tc.ifir_M, tc.ifir_Lg) == (jc.ifir_M, jc.ifir_Lg)
        assert tc.env_w is None
    else:
        assert tc.ifir_M is None and tc.env_i_w is None


@pytest.mark.parametrize("rate,cutoff", IFIR_DESIGNS[:3])
def test_ifir_banks_equal_jax(rate, cutoff):
    jc, tc = ifir_design_pair(rate, cutoff)
    for k in ("env_i_w", "env_g_w"):
        want = np.asarray(getattr(jc, k))
        got = getattr(tc, k).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_ifir_envelope_matches_jax_and_dense(ifir_chains, ifir_signal):
    jc, tc, dense = ifir_chains
    assert jc.env_mode == tc.env_mode == "ifir"
    assert dense.env_mode == "dense"
    x = torch.from_numpy(ifir_signal)
    got = tc.envelope_cf(x).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jc.envelope_cf(jnp.asarray(ifir_signal))),
        atol=TOL_IFIR)
    # float64: the rectified stream through conv(i, g zero-stuffed by M),
    # the factors as the float32 banks hold them
    M, B = tc.ifir_M, tc.block
    i = tc.env_i_w.numpy()[::-1, 0][B - 1:].astype(np.float64)
    g = tc.env_g_w.numpy()[::-1, 0][B - 1:].astype(np.float64)
    assert len(g) == tc.ifir_Lg
    up = np.zeros((len(g) - 1) * M + 1)
    up[::M] = g
    kern = np.convolve(i, up)
    d, n = tc.env_delay, x.shape[1]
    r = (np.pi / 2) * np.abs(ifir_signal.astype(np.float64))
    e64 = np.stack([np.convolve(ch, kern)[d : d + n] for ch in r])
    np.testing.assert_allclose(got, np.maximum(e64, 0.0), atol=TOL_IFIR)
    want = dense.envelope_cf(x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-6)


def test_ifir_odd_length_stream(ifir_chains, ifir_signal):
    """A length that is no multiple of M: the phases are padded, the
    result cut back, and the samples that do not reach past the end
    equal the longer stream's; the JAX package agrees."""
    jc, tc, _ = ifir_chains
    n = 19997
    assert n % tc.ifir_M
    e = tc.envelope_cf(torch.from_numpy(ifir_signal[:, :n])).numpy()
    assert e.shape == (2, n)
    e2 = tc.envelope_cf(torch.from_numpy(ifir_signal)).numpy()
    valid = n - tc.env_delay
    np.testing.assert_allclose(e[:, :valid], e2[:, :valid], atol=1e-6)
    np.testing.assert_allclose(
        e, np.asarray(jc.envelope_cf(jnp.asarray(ifir_signal[:, :n]))),
        atol=TOL_IFIR)


def test_ifir_chain_from_jax_arrays(ifir_chains, ifir_signal):
    """A JAX IFIR chain's arrays rebuild the port's IFIR chain: the same
    mode and banks, the same envelope bit for bit, and the single-pass
    chain on the dense kernel as in the JAX package."""
    jc, tc, _ = ifir_chains
    arrays = {k: getattr(jc, k) for k in ARRAY_KEYS + IFIR_KEYS}
    arrays = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in arrays.items()}
    assert arrays["env_w"] is None
    rc = chain_from_arrays(arrays, device="cpu")
    assert (rc.env_mode, rc.ifir_M, rc.ifir_Lg, rc.env_halo) == \
        (tc.env_mode, tc.ifir_M, tc.ifir_Lg, tc.env_halo)
    for k in ("env_i_w", "env_g_w", "filt_w", "spec_w"):
        assert torch.equal(getattr(rc, k), getattr(tc, k)), k
    x = torch.from_numpy(ifir_signal)
    assert torch.equal(rc.envelope_cf(x), tc.envelope_cf(x))
    assert rc.chain_kernel is not None
    np.testing.assert_array_equal(rc.chain_kernel.g, tc.chain_kernel.g)
    with pytest.raises(KeyError, match="env_g_w"):
        chain_from_arrays({k: v for k, v in arrays.items()
                           if k != "env_g_w"}, device="cpu")


@pytest.mark.parametrize("outputs", [
    ("filtered", "envelope", "spectrogram"), ("envelope",)])
def test_ifir_call_equals_the_stages(ifir_chains, ifir_signal, outputs):
    _, tc, _ = ifir_chains
    x = torch.from_numpy(ifir_signal)
    got = tc(x, outputs=outputs)
    y = tc.filtered_cf(x)
    want = {"filtered": y, "envelope": tc.envelope_cf(y),
            "spectrogram": tc.spectrogram_fc(y)}
    assert set(got) == set(outputs)
    for k in outputs:
        assert torch.equal(got[k], want[k]), k
