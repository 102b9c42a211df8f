"""The references against scipy's float64 evaluations at tiny sizes."""

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as sps
import torch

from portbench import compare, core
from portbench.reference import dsp

ROOT = Path(__file__).resolve().parents[2]
BIO = json.loads((ROOT / "portbench/configs/bioacoustics-96k-16ch.json")
                 .read_text())
DET = json.loads((ROOT / "portbench/configs/songdetector-96k-16ch.json")
                 .read_text())
RATE = 96000.0


def noise(shape, seed=0, scale=0.3):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def codes(shape, seed=0):
    x = np.clip(np.round(noise(shape, seed) * 32768), -32768, 32767)
    return x.astype(np.int16)


def test_causal_and_zero_phase_against_scipy():
    sos = dsp.butter(2, (2000.0, 40000.0), "bandpass", RATE)
    x = noise((2, 20000))
    y = dsp.causal(torch.from_numpy(x), dsp.impulse(sos)).numpy()
    assert np.abs(y - sps.sosfilt(sos, x, axis=1)).max() < 1e-12
    sos = dsp.butter(2, 500.0, "lowpass", RATE)
    g, c = dsp.zero_phase(sos)
    e = dsp.centred(torch.from_numpy(x), g, c).numpy()
    want = sps.sosfiltfilt(sos, x, axis=1, padtype=None)
    mid = slice(6000, 14000)      # away from either end's edge handling
    assert np.abs(e[:, mid] - want[:, mid]).max() < 1e-9


def test_psd_against_scipy_spectrogram():
    x = noise((3, 4096))
    p = dsp.psd(torch.from_numpy(x), 2, 20, 256, 128, RATE).numpy()
    _, _, s = sps.spectrogram(x, fs=RATE, window="hann", nperseg=256,
                              noverlap=128, detrend=False,
                              scaling="density", mode="psd")
    want = np.moveaxis(s, -1, 0)[2:22]
    assert p.shape == want.shape == (20, 3, 129)
    assert np.abs(p / want - 1).max() < 1e-10


def test_tf32_control_is_the_function_at_lower_precision():
    # operands rounded to TF32: about 2^-11 of each, so the gaps to float64
    # sit far above float32's and far below the signal
    x = noise((2, 8000))
    sos = dsp.butter(2, (2000.0, 40000.0), "bandpass", RATE)
    h = dsp.impulse(sos)
    y64 = dsp.causal(torch.from_numpy(x), h)
    y32 = dsp.causal(torch.from_numpy(x).float(), h, "tf32")
    gap = float((y64 - y32.double()).abs().max())
    assert 1e-5 < gap < 1e-2
    p64 = dsp.psd(y64, 0, 40, 256, 128, RATE)
    p32 = dsp.psd(y32, 0, 40, 256, 128, RATE, "tf32")
    assert 1e-4 < compare.db_gap(p32, p64) < 3.0
    t = torch.tensor([1.0, 1.0 + 2.0**-12, 1.0 + 2.0**-11, -3.14159265])
    assert dsp.tf32(t).tolist() == [1.0, 1.0, 1.0009765625, -3.140625]


def test_chain_reference():
    ref = core.load_module("reference", "bioacoustics-96k-16ch")
    hb, n, tail = 1024, 8192, 768
    q = codes((2, hb + n + tail))
    out = ref.chain(BIO, torch.from_numpy(q), hb, n)
    x = q.astype(np.float64) / 32768.0
    sos_f = sps.butter(2, (2000.0, 40000.0), "bandpass", fs=RATE,
                       output="sos")
    sos_e = sps.butter(2, 500.0, "lowpass", fs=RATE, output="sos")
    y = sps.sosfilt(sos_f, x, axis=1)
    assert np.abs(out["filtered"].numpy() - y[:, hb : hb + n]).max() < 1e-12
    v = (np.pi / 2) * np.abs(y)
    e = np.maximum(sps.sosfiltfilt(sos_e, v, axis=1, padtype=None), 0)
    mid = slice(3000, 5000)
    assert np.abs(out["envelope"].numpy()[:, mid]
                  - e[:, hb : hb + n][:, mid]).max() < 1e-9
    _, _, s = sps.spectrogram(y[:, hb : hb + n + 128], fs=RATE,
                              window="hann", nperseg=256, noverlap=128,
                              detrend=False, scaling="density", mode="psd")
    p = out["psd"].numpy()
    assert p.shape == (n // 128, 2, 129)
    assert np.abs(p / np.moveaxis(s, -1, 0) - 1).max() < 1e-10
    assert np.allclose(out["power"].numpy(), (y[:, hb : hb + n] ** 2).sum(1),
                       rtol=1e-12)
    assert np.allclose(out["psd_sum"].numpy(), p.sum(0), rtol=1e-12)


def test_detect_reference():
    ref = core.load_module("reference", "songdetector-96k-16ch")
    assert ref.step(DET) == 19
    hb, nout = 4096, 400
    q = codes((hb + 19 * nout + hb, 3), seed=1)
    env = ref.envelope(DET, torch.from_numpy(q), hb, nout).numpy()
    x = q.astype(np.float64) / 32768.0
    sb = sps.butter(1, (1000.0, 10000.0), "bandpass", fs=RATE, output="sos")
    sl = sps.butter(1, 500.0, "lowpass", fs=RATE, output="sos")
    y = sps.sosfiltfilt(sb, x, axis=0, padtype=None)
    e = sps.sosfiltfilt(sl, y * y, axis=0, padtype=None)
    want = 2 * np.sqrt(np.maximum(e[hb : hb + 19 * nout : 19], 0))
    assert env.shape == (nout, 3)
    assert np.abs(env - want).max() / np.abs(want).max() < 1e-9


def test_tiles():
    sign = torch.tensor([1.0, -1.0] * 12, dtype=torch.float64)
    t = torch.arange(24, dtype=torch.float64) * sign
    got = dsp.minmax_tile(t, 4, 4, 3).numpy()
    seg = t.numpy()[4:16].reshape(3, 4)
    assert np.array_equal(got, np.stack([seg.min(1), seg.max(1)],
                                        1).reshape(-1))
    p = torch.tensor([1e-12, 1e-9, 1e-6, 1e-3, 1.0])
    want = np.round(255 * np.clip((10 * np.log10(p.numpy()) + 100) / 70,
                                  0, 1))
    assert np.array_equal(dsp.db_u8(p, -100.0, -30.0).numpy(), want)


@pytest.mark.parametrize("tail", [1e-12, 1e-16])
def test_impulse_runs_out(tail):
    sos = dsp.butter(1, 500.0, "lowpass", RATE)
    h = dsp.impulse(sos, tail)
    assert abs(h[-1]) < tail * abs(h).max()
