"""audian_torch's FIR filtering and STFT ops against the JAX package (and
scipy float64), the building blocks of the chain's plain version."""

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax.numpy as jnp

from audian_tpu.ops import design as jdesign
from audian_tpu.ops import raw16 as jraw16
from audian_tpu.ops import sos as jsos
from audian_tpu.ops import stft as jstft

from audian_torch.ops import design, raw16, sos, stft

RATE = 48000.0
SOS = jdesign.design_filter(RATE, 1000.0, 8000.0)


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(4).standard_normal((3000, 2)).astype(
        np.float32)


def test_dequant16_bit_exact():
    q = np.array([[-32768, -1, 0, 1, 32767]], np.int16)
    got = raw16.dequant16(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jraw16.dequant16(
        jnp.asarray(q))))
    np.testing.assert_array_equal(got, q.astype(np.float64) / 32768.0)


@pytest.mark.parametrize("n", [3000, 40])      # long block and A**n carry
def test_sosfilt_fir_with_state(x, n):
    k = design.fir_kernels(SOS, eps=1e-9)
    kj = jdesign.fir_kernels(SOS, eps=1e-9)
    zi = np.random.default_rng(1).standard_normal((len(SOS), 2, 2))
    xs = x[:n]
    y, zf = sos.sosfilt_fir(k, torch.from_numpy(xs), zi=zi, axis=0)
    yj, zfj = jsos.sosfilt_fir(kj, xs, zi=zi, axis=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=2e-6)
    np.testing.assert_allclose(zf.numpy(), np.asarray(zfj), atol=2e-6)
    ys, zfs = sps.sosfilt(SOS, xs.astype(np.float64), axis=0, zi=zi)
    np.testing.assert_allclose(y.numpy(), ys, atol=1e-5)
    np.testing.assert_allclose(zf.numpy(), zfs, atol=1e-5)


def test_sosfilt_fir_axis1_1d(x):
    k = design.fir_kernels(SOS, eps=1e-9)
    y = sos.sosfilt_fir(k, torch.from_numpy(x.T.copy()), axis=1)
    np.testing.assert_allclose(
        y.numpy(), sps.sosfilt(SOS, x.T.astype(np.float64), axis=1),
        atol=1e-5)
    y1, zf1 = sos.sosfilt_fir(k, torch.from_numpy(x[:, 0].copy()),
                              zi=np.zeros((len(SOS), 2)))
    assert y1.shape == (3000,) and zf1.shape == (len(SOS), 2)


def test_sosfiltfilt_fir_and_sym(x):
    env = jdesign.design_envelope_filter(RATE, 500.0)
    d = design.FilterDesign.from_sos(env)
    dj = jdesign.FilterDesign.from_sos(env)
    got = sos.sosfiltfilt_fir(d.fir, torch.from_numpy(x), d.zi0, d.padlen)
    want = jsos.sosfiltfilt_fir(dj.fir, x, dj.zi0, dj.padlen)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    np.testing.assert_allclose(got.numpy(), sps.sosfiltfilt(
        env, x.astype(np.float64), axis=0), atol=1e-5)
    g, delay = design.filtfilt_sym_kernel(env, eps=1e-9)
    sym = sos.sosfiltfilt_sym(g, delay, torch.from_numpy(x))
    np.testing.assert_allclose(sym.numpy(), np.asarray(
        jsos.sosfiltfilt_sym(g, delay, x)), atol=2e-6)
    with pytest.raises(ValueError, match="padlen"):
        sos.sosfiltfilt_fir(d.fir, torch.zeros(5), d.zi0, d.padlen)


def test_odd_ext():
    v = np.arange(10.0)[:, None] ** 2
    got = sos.odd_ext(torch.from_numpy(v), 3).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsos.odd_ext(v, 3)))
    with pytest.raises(ValueError):
        sos.odd_ext(torch.from_numpy(v), 10)


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("nfft,hop", [(256, 128), (512, 90)])
def test_spectrogram(x, nfft, hop, method):
    got = stft.spectrogram(torch.from_numpy(x), RATE, nfft, hop,
                           method=method).numpy()
    want = np.asarray(jstft.spectrogram(x, RATE, nfft, hop, method=method))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-10)
    _, _, ss = sps.spectrogram(x.astype(np.float64), fs=RATE, window="hann",
                               nperseg=nfft, noverlap=nfft - hop,
                               detrend=False, scaling="density", mode="psd",
                               axis=0)
    np.testing.assert_allclose(got, ss.transpose(2, 1, 0), rtol=1e-4,
                               atol=1e-10)


def test_frame_signal_and_decibel(x):
    f = stft.frame_signal(torch.from_numpy(x), 256, 100, nframes=31)
    fj = np.asarray(jstft.frame_signal(jnp.asarray(x), 256, 100, nframes=31))
    np.testing.assert_array_equal(f.numpy(), fj)
    p = np.array([0.0, 1e-21, 1e-3, 2.0, 50.0])
    for ref in (1.0, None):
        got = stft.decibel(torch.from_numpy(p), ref).numpy()
        np.testing.assert_allclose(got, np.asarray(jstft.decibel(p, ref)))
    db = torch.tensor([-30.0, 0.0, 12.5], dtype=torch.float64)
    np.testing.assert_allclose(stft.inverse_decibel(db, 2.0).numpy(),
                               np.asarray(jstft.inverse_decibel(
                                   db.numpy(), 2.0)))
