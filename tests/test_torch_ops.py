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


# -- min/max decimation, spectrogram sweeps, dB tiles and playback ----------

from audian_tpu.ops import minmax as jminmax
from audian_tpu.ops import mix as jmix
from audian_tpu.ops import sweep as jsweep

from audian_torch.ops import minmax, mix, sweep


@pytest.mark.parametrize("n,step", [(1000, 10), (1003, 10), (7, 3),
                                    (4096, 64), (5, 8), (100, 1)])
def test_minmax_interleaved_ragged_tails(n, step):
    x = np.random.default_rng(n + step).standard_normal((n, 3)).astype(
        np.float32)
    got = minmax.minmax_interleaved(torch.from_numpy(x), step).numpy()
    if step > 1:
        np.testing.assert_array_equal(got, minmax.reduceat_like(x, step))
    np.testing.assert_array_equal(got, np.asarray(
        jminmax.minmax_interleaved(x, step)))


def test_minmax_int16_and_pyramid():
    rng = np.random.default_rng(9)
    q = rng.integers(-32768, 32767, (1001, 2), dtype=np.int16)
    mins, maxs = minmax.minmax_decimate(torch.from_numpy(q), 7)
    assert mins.dtype == torch.int16
    np.testing.assert_array_equal(
        minmax.interleave_minmax(mins, maxs).numpy(),
        minmax.reduceat_like(q, 7))
    x = rng.standard_normal((10007, 2)).astype(np.float32)
    got = minmax.minmax_pyramid(torch.from_numpy(x), 16)
    want = jminmax.minmax_pyramid(x, 16)
    assert len(got) == len(want) == minmax.pyramid_levels(10007, 16)
    for k, ((a, b), (c, d)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        np.testing.assert_array_equal(b.numpy(), np.asarray(d))
        # level k is the direct decimation by 16 * 2**k
        np.testing.assert_array_equal(
            minmax.interleave_minmax(a, b).numpy(),
            minmax.reduceat_like(x, 16 << k))


def test_spectrogram_sweep_matches_jax(x):
    nffts = (128, 256, 1024, 2048)
    got = sweep.spectrogram_sweep(torch.from_numpy(x), RATE, nffts, 0.75)
    want = jsweep.spectrogram_sweep(x, RATE, nffts, 0.75)
    assert set(got) == set(want) == set(nffts)
    for nfft in nffts:
        assert got[nfft].shape == want[nfft].shape
        np.testing.assert_allclose(got[nfft].numpy(),
                                   np.asarray(want[nfft]), rtol=1e-4,
                                   atol=1e-10)


def test_db_quantize_and_normalize_match_jax(x):
    psd = stft.spectrogram(torch.from_numpy(x), RATE, 256, 128)
    for zmin, zmax in ((-120.0, -40.0), (-80.0, -80.0), (-100.0, -20.0)):
        got = sweep.db_quantize(psd, zmin, zmax).numpy()
        want = np.asarray(jsweep.db_quantize(psd.numpy(), zmin, zmax))
        assert got.dtype == np.uint8
        assert np.abs(got.astype(int) - want).max() <= 1
        np.testing.assert_allclose(
            sweep.db_normalize(psd, zmin, zmax).numpy(),
            np.asarray(jsweep.db_normalize(psd.numpy(), zmin, zmax)),
            atol=1e-5)


def test_mix_steps_match_jax(x):
    sig = torch.from_numpy(x)
    np.testing.assert_allclose(mix.stereo_mixdown(sig, [1, 0]).numpy(),
                               np.asarray(jmix.stereo_mixdown(x, [1, 0])),
                               atol=1e-7)
    x3 = np.concatenate([x, x[:, :1]], axis=1)
    np.testing.assert_allclose(
        mix.stereo_mixdown(torch.from_numpy(x3)).numpy(),
        np.asarray(jmix.stereo_mixdown(x3)), atol=1e-7)
    np.testing.assert_allclose(mix.heterodyne(sig, RATE, 7000.0).numpy(),
                               np.asarray(jmix.heterodyne(x, RATE, 7000.0)),
                               atol=1e-6)
    np.testing.assert_allclose(mix.fade(sig, RATE, 0.01).numpy(),
                               np.asarray(jmix.fade(x, RATE, 0.01)),
                               atol=1e-6)


@pytest.mark.parametrize("het", [False, True])
def test_prepare_playback_matches_jax(het):
    rng = np.random.default_rng(10)
    x = (0.2 * rng.standard_normal((20000, 4))).astype(np.float32)
    kw = dict(channels=[0, 2, 3], use_heterodyne=het,
              heterodyne_freq=30000.0, rate_fac=2.0, fade_time=0.05)
    got, got_rate = mix.prepare_playback(torch.from_numpy(x), 96000.0, **kw)
    want, want_rate = jmix.prepare_playback(x, 96000.0, **kw)
    assert got_rate == want_rate and got.shape == want.shape
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("dtype,bits", [(np.int16, 16), (np.int32, 32),
                                        (np.int8, 8)])
def test_prepare_playback_scales_signed_ints(dtype, bits):
    """Any signed integer input is scaled by 2^(bits-1); the JAX package
    scales only int16 (its heterodyne and fade cast other integers
    unscaled), so the port is held against the JAX result of the scaled
    floats."""
    rng = np.random.default_rng(bits)
    info = np.iinfo(dtype)
    q = rng.integers(info.min, info.max, (6000, 2), dtype=dtype)
    floats = (q.astype(np.float64) / 2.0 ** (bits - 1)).astype(np.float32)
    got, _ = mix.prepare_playback(torch.from_numpy(q), 48000.0,
                                  use_heterodyne=True,
                                  heterodyne_freq=10000.0)
    want, _ = jmix.prepare_playback(floats, 48000.0, use_heterodyne=True,
                                    heterodyne_freq=10000.0)
    same, _ = mix.prepare_playback(torch.from_numpy(floats), 48000.0,
                                   use_heterodyne=True,
                                   heterodyne_freq=10000.0)
    np.testing.assert_array_equal(got.numpy(), same.numpy())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    het = mix.heterodyne(torch.from_numpy(q), 48000.0, 5000.0).numpy()
    np.testing.assert_allclose(het, np.asarray(jmix.heterodyne(
        floats, 48000.0, 5000.0)), atol=1e-6)


def test_ops_put_host_data_on_cuda_by_default(x):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    for call in (lambda: minmax.minmax_decimate(x, 4),
                 lambda: minmax.minmax_pyramid(x, 4),
                 lambda: sweep.spectrogram_sweep(x, RATE, (256,)),
                 lambda: mix.prepare_playback(x, RATE)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert minmax.minmax_decimate(x, 4, device="cpu")[0].device.type == "cpu"


def test_port_calls_leave_the_tf32_flags_as_they_were(x):
    """``full_fp32`` scopes full float32 to each call: a host program's
    own TF32 setting survives the filter, the graph executor and the
    STFT."""
    from audian_torch import graph as tgraph

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        k = design.fir_kernels(SOS, eps=1e-9)
        sos.sosfilt_fir(k, torch.from_numpy(x), zi=np.zeros((len(SOS), 2, 2)))
        g = tgraph.TraceGraph([tgraph.FilterNode("filtered", "data"),
                               tgraph.SpectrogramNode("spectrogram",
                                                      "filtered")])
        g.open(tgraph.TraceSpec(rate=RATE, channels=2, frames=len(x)))
        tgraph.GraphExecutor(g, device="cpu").run(x, 0, pull=True)
        stft.spectrogram(torch.from_numpy(x), RATE, nfft=256, hop=128)
        with sos.full_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
