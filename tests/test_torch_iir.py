"""The port's exact IIR filters (``audian_torch.ops.sosfilt``,
``sosfilt_zi``, ``sosfiltfilt``) and ``ops.envelope`` against the JAX
package's and scipy's, plus the ops namespace and the analysis table's
pandas export.

At float64 on the CPU both packages hold scipy within 1e-9 (the JAX
package's own ``tests/test_sos.py`` budget); the port computes its
blocked state-space matrices in float64, so float64 input stays within
round-off of scipy.  In float32 the tolerances are stated per design: the
port rounds matrices computed in float64, never the recurrence's
coefficients, so near DC it stays close to scipy where a float32
recurrence (scipy's own ``sosfilt`` on float32 input, 1.7e-3 at 20 Hz)
does not."""

import numpy as np
import pytest
import scipy.signal as sps
import torch

import audian_tpu.ops as jops
from audian_tpu.analysis.table import ResultTable as JTable

import audian_torch.ops as tops
from audian_torch.analysis.table import ResultTable
from audian_torch.ops import (design_envelope_filter, design_filter,
                              envelope, sosfilt, sosfilt_zi, sosfiltfilt)

RATE = 48000.0
TOL_F64 = 1e-9

SOS_CASES = {
    "bandpass": design_filter(RATE, 2000.0, 10000.0, order=2),
    "lowpass3": design_filter(RATE, 0.0, 8000.0, order=3),
    "envelope": design_envelope_filter(RATE, 500.0),
    "env_band": design_envelope_filter(RATE, 500.0, highpass_cutoff=50.0),
}


@pytest.fixture(scope="module")
def signal():
    rng = np.random.default_rng(11)
    n = 20000
    t = np.arange(n) / RATE
    return (np.sin(2 * np.pi * 4000.0 * t)
            + 0.5 * np.sin(2 * np.pi * 300.0 * t)
            + 0.2 * rng.standard_normal(n))


def port(*args, **kw):
    """A port call on the CPU, its tensors as numpy."""
    out = args[0](*args[1:], device="cpu", **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


@pytest.mark.parametrize("name", list(SOS_CASES))
def test_sosfilt_matches_scipy_and_jax(name, signal):
    sos = SOS_CASES[name]
    want = sps.sosfilt(sos, signal)
    got = port(sosfilt, sos, signal)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F64)
    np.testing.assert_allclose(got, np.asarray(jops.sosfilt(sos, signal)),
                               rtol=0, atol=TOL_F64)


@pytest.mark.parametrize("name", ["bandpass", "lowpass3"])
def test_sosfilt_with_zi(name, signal):
    sos = SOS_CASES[name]
    zi = sps.sosfilt_zi(sos) * signal[0]
    want, wzf = sps.sosfilt(sos, signal, zi=zi)
    got, gzf = port(sosfilt, sos, signal, zi=zi)
    assert gzf.shape == wzf.shape == (len(sos), 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F64)
    np.testing.assert_allclose(gzf, wzf, rtol=0, atol=TOL_F64)
    jy, jzf = jops.sosfilt(sos, signal, zi=zi)
    np.testing.assert_allclose(got, np.asarray(jy), rtol=0, atol=TOL_F64)
    np.testing.assert_allclose(gzf, np.asarray(jzf), rtol=0, atol=TOL_F64)
    # no zi: no zf unless asked for
    assert isinstance(sosfilt(sos, signal, device="cpu"), torch.Tensor)
    y, zf = port(sosfilt, sos, signal, return_zf=True)
    np.testing.assert_allclose(zf, sps.sosfilt(sos, signal,
                                               zi=np.zeros((len(sos), 2)))[1],
                               rtol=0, atol=TOL_F64)


@pytest.mark.parametrize("block_size", [1 << 17, 1111])
def test_sosfilt_three_chunks_carry_the_state(signal, block_size):
    """Three chunks of odd lengths, the state carried from each to the
    next, give the whole signal's output and final state, whatever the
    block size."""
    sos = SOS_CASES["bandpass"]
    x = np.stack([signal, 0.3 * signal[::-1]], axis=1)
    zi = np.zeros((len(sos), 2, 2))
    whole, zf_whole = port(sosfilt, sos, x, zi=zi, block_size=block_size)
    parts, zf = [], zi
    for lo, hi in ((0, 7001), (7001, 7130), (7130, len(signal))):
        y, zf = port(sosfilt, sos, x[lo:hi], zi=zf, block_size=block_size)
        parts.append(y)
    np.testing.assert_allclose(np.concatenate(parts), whole, rtol=0,
                               atol=TOL_F64)
    np.testing.assert_allclose(zf, zf_whole, rtol=0, atol=TOL_F64)
    np.testing.assert_allclose(whole, sps.sosfilt(sos, x, axis=0), rtol=0,
                               atol=TOL_F64)


@pytest.mark.parametrize("axis", [1, -1])
def test_sosfilt_time_on_the_last_axis(signal, axis):
    sos = SOS_CASES["lowpass3"]
    x = np.stack([signal[:5000], -signal[5000:10000], signal[:5000] ** 2])
    rng = np.random.default_rng(3)
    zi = rng.standard_normal((len(sos), 3, 2)) * 0.1     # x is (3, 5000)
    want, wzf = sps.sosfilt(sos, x, axis=axis, zi=zi)
    got, gzf = port(sosfilt, sos, x, axis=axis, zi=zi)
    assert gzf.shape == wzf.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F64)
    np.testing.assert_allclose(gzf, wzf, rtol=0, atol=TOL_F64)
    jy, jzf = jops.sosfilt(sos, x, axis=axis, zi=zi)
    np.testing.assert_allclose(got, np.asarray(jy), rtol=0, atol=TOL_F64)
    np.testing.assert_allclose(gzf, np.asarray(jzf), rtol=0, atol=TOL_F64)


def test_sosfilt_int16_input_and_one_section(signal):
    """Integer input is filtered as float32 (as in the JAX package); a
    1-D ``sos`` is one section."""
    q = np.clip(np.round(signal * 8000), -32768, 32767).astype(np.int16)
    sos = SOS_CASES["envelope"]
    assert sos.shape == (1, 6)
    got = port(sosfilt, sos[0], q)
    assert got.dtype == np.float32
    want = sps.sosfilt(sos, q.astype(np.float64))
    scale = float(np.abs(want).max())
    # float32 at the int16 scale of the input: 1e-6 of the output scale
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    jy = np.asarray(jops.sosfilt(sos[0], q))
    assert jy.dtype == np.float32
    # the JAX float32 scan's own budget, 2e-4 of the scale
    # (tests/test_sos.py::test_sosfilt_f32_tolerance)
    np.testing.assert_allclose(got, jy, rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("name", list(SOS_CASES))
def test_sosfilt_zi_matches_scipy(name):
    sos = SOS_CASES[name]
    got = sosfilt_zi(sos).numpy()
    assert got.shape == (len(sos), 2)
    np.testing.assert_allclose(got, sps.sosfilt_zi(sos), rtol=0,
                               atol=TOL_F64)
    np.testing.assert_allclose(got, np.asarray(jops.sosfilt_zi(sos)),
                               rtol=0, atol=TOL_F64)


@pytest.mark.parametrize("name", list(SOS_CASES))
def test_sosfiltfilt_matches_scipy_and_jax(name, signal):
    sos = SOS_CASES[name]
    x = np.stack([signal, 0.3 * signal[::-1]], axis=1)
    want = sps.sosfiltfilt(sos, x, axis=0)
    got = port(sosfiltfilt, sos, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F64)
    np.testing.assert_allclose(got, np.asarray(jops.sosfiltfilt(sos, x)),
                               rtol=0, atol=TOL_F64)


def test_sosfiltfilt_refuses_a_short_signal():
    sos = SOS_CASES["bandpass"]
    padlen = 3 * (2 * len(sos) + 1)
    with pytest.raises(ValueError, match=f"padlen, which is {padlen}"):
        sosfiltfilt(sos, np.zeros(padlen), device="cpu")
    with pytest.raises(ValueError, match=f"padlen, which is {padlen}"):
        jops.sosfiltfilt(sos, np.zeros(padlen))
    got = port(sosfiltfilt, sos, np.ones(padlen + 1))
    np.testing.assert_allclose(got, sps.sosfiltfilt(sos, np.ones(padlen + 1)),
                               rtol=0, atol=TOL_F64)


#: the three float32 designs at 96 kHz: the bioacoustics band-pass, its
#: envelope and a low-pass near DC (poles 0.9991 from the origin), each
#: with its float32 tolerance against scipy float64: a few float32 steps
#: of the output scale (about 1, measured 1.2e-7 to 1.9e-7 for sosfilt)
F32_DESIGNS = {
    "bandpass 2-40 kHz": (design_filter(96000.0, 2000.0, 40000.0), 1e-6),
    "envelope 500 Hz": (design_envelope_filter(96000.0, 500.0), 1e-6),
    "low-pass 20 Hz": (design_envelope_filter(96000.0, 20.0), 1e-6),
}


@pytest.mark.parametrize("name", list(F32_DESIGNS))
def test_float32_holds_scipy(name):
    sos, tol = F32_DESIGNS[name]
    rng = np.random.default_rng(0)
    n = 200000
    t = np.arange(n) / 96000.0
    x = (0.4 * np.sin(2 * np.pi * 5000.0 * t) * (np.sin(2 * np.pi * 3 * t) > 0)
         + 0.3 * np.sin(2 * np.pi * 13.0 * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    x = np.stack([x, -0.5 * x[::-1]], axis=1)
    x64 = x.astype(np.float64)
    got = port(sosfilt, sos, x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, sps.sosfilt(sos, x64, axis=0), rtol=0,
                               atol=tol)
    # zero-phase: two passes and the edge extension, twice the budget
    np.testing.assert_allclose(port(sosfiltfilt, sos, x),
                               sps.sosfiltfilt(sos, x64, axis=0), rtol=0,
                               atol=2 * tol)


@pytest.fixture(scope="module")
def cricket():
    """The conftest's ``cricket_like`` recording from its own generator."""
    rng = np.random.default_rng(42)
    rate = 44100.0
    t = np.arange(int(2.0 * rate)) / rate
    chirps = np.sin(2 * np.pi * 4800.0 * t) * (
        np.sin(2 * np.pi * 25.0 * t) > 0)
    x = np.stack([
        0.6 * chirps + 0.01 * rng.standard_normal(len(t)),
        0.3 * np.roll(chirps, 17) + 0.01 * rng.standard_normal(len(t)),
    ], axis=1)
    return x, rate


@pytest.mark.parametrize("cutoff", [500.0, 1500.0])
def test_envelope_matches_jax_and_scipy(cricket, cutoff):
    """The port's float32 envelope on the exact smoother: within 1e-6 of
    the JAX package's (float64 here) and of scipy float64, and equal to
    itself in small blocks."""
    x, rate = cricket
    sos = design_envelope_filter(rate, cutoff)
    got = envelope(x, sos, device="cpu").numpy()
    want = np.maximum(sps.sosfiltfilt(sos, (np.pi / 2) * np.abs(x), axis=0),
                      0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jops.envelope(x, sos)),
                               rtol=0, atol=1e-6)
    small = envelope(x, sos, block_size=5000, device="cpu").numpy()
    np.testing.assert_allclose(small, got, rtol=0, atol=1e-6)


def test_ops_namespace_has_every_jax_name():
    assert set(jops.__all__) <= set(tops.__all__)
    for name in tops.__all__:
        assert hasattr(tops, name), name


def test_result_table_to_dataframe_matches_jax():
    pd = pytest.importorskip("pandas")
    tables = []
    for cls in (ResultTable, JTable):
        t = cls()
        t.append("t0", "s", "%.3f")
        t.append("peak", "V")
        t.add([0.5, 1.25])
        t.add([1.5])
        t.append("label")
        t.add(["x"], start_column=2)
        tables.append(t.to_dataframe())
    got, want = tables
    assert isinstance(got, pd.DataFrame)
    pd.testing.assert_frame_equal(got, want)
    assert list(got.columns) == ["t0", "peak", "label"]
