"""audian_torch's song-detection pipeline (``analysis/events.py``) against
the JAX package on the CPU: the numpy event functions, the chunked
``band_env`` driver on both its paths, the standalone filters, and
``detect()``.

Both packages run with ``_CHUNK`` patched to the same small size and the
sticky ``_KERNEL_BUDGET`` reset, so every path (host scipy below one
window, the exact edge chunks, the decimating interior chunks) runs at a
few tens of thousands of samples.  Tolerances: the envelope within 1e-5
of its scale of the JAX package and 2e-5 of the scipy float64 oracle (the
JAX package's own chunk-equivalence budget), the filtered stream within
1e-5 (the port computes in float32, the JAX side in float64 under the
tests).
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from audian_tpu.analysis import events as jev
from audian_torch.analysis import events as tev
from audian_torch.ops.cuda.envdet import EnvDetKernel

RATE = 20000.0


@pytest.fixture
def small_chunks(monkeypatch):
    """The same small chunk size and fresh kernel budgets in both
    packages."""
    for mod, chunk in ((jev, 8192), (tev, 8192)):
        monkeypatch.setattr(mod, "_CHUNK", chunk)
        monkeypatch.setattr(mod, "_KERNEL_BUDGET", {"filt": 0, "env": 0})


def _oracle_env(x, band, cutoff, step, rate=RATE):
    y = sps.sosfiltfilt(sps.butter(1, band, "bandpass", fs=rate,
                                   output="sos"), x, axis=0)
    e = 2.0 * sps.sosfiltfilt(sps.butter(1, cutoff, "lowpass", fs=rate,
                                         output="sos"), y ** 2, axis=0)
    return y, np.sqrt(np.maximum(e, 0.0))[::step] * np.sqrt(2.0)


def _envelopes(seed=5, n=6000, c=3):
    """Seeded envelopes: a noise floor with a few loud, modulated songs."""
    rng = np.random.default_rng(seed)
    env = np.abs(0.01 + 0.002 * rng.standard_normal((n, c)))
    t = np.arange(n) / 1000.0
    for k, s in enumerate((1.0, 2.6, 4.1)):
        m = (t >= s) & (t < s + 0.7)
        env[m, k % c] += 0.5 * (1 + np.sin(2 * np.pi * 40.0 * t[m]))
        env[m, (k + 1) % c] += 0.3
    return env


def _events(env, rate=1000.0):
    th = jev.threshold_estimates(env)
    on, off = jev.detect_songs(env, rate, th, 0.2)
    return th, on, off


def _case_crossings(mod, env):
    return [mod.threshold_crossings(env[:, c], 0.2) for c in range(3)]


def _case_merge_remove_widen(mod, env):
    on, off = mod.threshold_crossings(env[:, 0], 0.05)
    on, off = mod.merge_events(on, off, 30)
    on2, off2 = mod.remove_events(on, off, 50)
    return on, off, on2, off2, mod.widen_events(on2, off2, len(env), 80)


def _case_peak_freqs(mod, env):
    _, on, off = _events(env)
    return mod.peak_freqs(on[0], off[0], env[:, 0], 1000.0)


def _case_thresholds(mod, env):
    th = mod.threshold_estimates(env)
    return th, mod.detect_songs(env, 1000.0, th, 0.2)


def _case_env_freqs(mod, env):
    _, on, off = _events(env)
    fr = mod.env_freqs(on, off, env, 1000.0, thresh=10.0)
    return fr, mod.clean_env_freqs(on, off, [f.copy() for f in fr])


def _case_refine(mod, env):
    th, on, off = _events(env)
    fr = mod.env_freqs(on, off, env, 1000.0)
    on, off, fr = mod.clean_env_freqs(on, off, fr)
    out = []
    for mode in ("apply", "average"):
        e = env.copy()
        mod.filter_envelopes(on, off, fr, e, 1000.0, 0.2, mode)
        out.append(e)
        out.append(mod.analyse_songs(on, off, e, 1000.0, fr, th, 0.2))
    return out


NUMPY_CASES = {f.__name__[6:]: f for f in (
    _case_crossings, _case_merge_remove_widen, _case_peak_freqs,
    _case_thresholds, _case_env_freqs, _case_refine)}


def _flat(v):
    if isinstance(v, (list, tuple)):
        return [w for u in v for w in _flat(u)]
    return [np.asarray(v)]


@pytest.mark.parametrize("name", list(NUMPY_CASES))
def test_numpy_event_functions_equal_jax(name):
    env = _envelopes()
    want = _flat(NUMPY_CASES[name](jev, env))
    got = _flat(NUMPY_CASES[name](tev, env))
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("fused", [False, True], ids=["exact", "fused"])
def test_band_env_matches_jax(small_chunks, fused, dtype):
    """n = 50010 leaves a misaligned tail, so the last window's start is
    off the decimation grid; fused, the interior chunks run the
    single-pass envelope's plain version and the edge chunks the exact
    path."""
    n, band, cutoff = 50010, (5500.0, 7500.0), 100.0
    x = np.random.default_rng(11).standard_normal((n, 2))
    if dtype == "int16":
        x = np.clip(np.round(0.3 * x * 32768.0), -32768, 32767).astype(
            np.int16)
        xf = x.astype(np.float64) / 32768.0
    else:
        x = x.astype(np.float32)
        xf = x.astype(np.float64)
    rf = not fused
    yj, ej, rj = jev.band_env(x, RATE, *band, cutoff, return_filtered=rf,
                              fused=fused)
    yt, et, rt = tev.band_env(x, RATE, *band, cutoff, return_filtered=rf,
                              fused=fused, device="cpu")
    assert rt == rj and et.shape == ej.shape == (2501, 2)
    scale = np.abs(ej).max()
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-5 * scale)
    y64, e64 = _oracle_env(xf, band, cutoff, 20)
    np.testing.assert_allclose(et, e64, rtol=0, atol=2e-5 * scale)
    if fused:
        assert yt is None and yj is None
    else:
        assert yt.shape == yj.shape == (n, 2)
        np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5)
        np.testing.assert_allclose(yt, y64, rtol=0, atol=1e-5)


def test_band_env_below_one_window_is_scipy(small_chunks):
    """Below one window both packages answer with the host float64
    oracle: the same numbers."""
    q = np.round(0.3 * np.random.default_rng(2).standard_normal(
        (4000, 2)) * 32767).astype(np.int16)
    for rf in (True, False):
        yj, ej, _ = jev.band_env(q, RATE, 5500.0, 7500.0, 100.0,
                                 return_filtered=rf)
        yt, et, _ = tev.band_env(q, RATE, 5500.0, 7500.0, 100.0,
                                 return_filtered=rf, device="cpu")
        np.testing.assert_array_equal(et, ej)
        if rf:
            np.testing.assert_array_equal(yt, yj)


def test_standalone_filters_match_jax(small_chunks):
    x = np.random.default_rng(4).standard_normal((30000, 2))
    yj = jev.bandpass_filter(x, RATE, 5500.0, 7500.0)
    yt = tev.bandpass_filter(x, RATE, 5500.0, 7500.0, device="cpu")
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5)
    ej, rj = jev.square_envelope(x, RATE, 100.0)
    et, rt = tev.square_envelope(x, RATE, 100.0, device="cpu")
    assert rt == rj
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-5 * np.abs(ej).max())
    np.testing.assert_array_equal(tev.lowpass_filter(x, RATE, 300.0),
                                  jev.lowpass_filter(x, RATE, 300.0))


def test_kernel_budget_is_sticky(small_chunks):
    """A long kernel once seen keeps its budget for later designs, in both
    packages alike."""
    x = np.random.default_rng(6).standard_normal((20000, 1))
    for envf in (44.4, 500.0):
        jev.band_env(x, RATE, 6000.0, 7500.0, envf, return_filtered=False)
        tev.band_env(x, RATE, 6000.0, 7500.0, envf, return_filtered=False,
                     device="cpu")
        assert tev._KERNEL_BUDGET == jev._KERNEL_BUDGET
    assert tev._KERNEL_BUDGET["env"] > 0


def test_cli_design_geometry_equals_jax():
    """At the song detector's default design (16 ch PCM-16 at 96 kHz,
    1-10 kHz band-pass, 500 Hz envelope, step 19) and the real chunk size
    both packages pick the single-pass kernel with the same geometry."""
    from audian_tpu.ops import FilterDesign as JaxDesign
    from audian_tpu.ops.pallas.envdet import EnvDetKernel as JaxKernel
    from audian_torch.ops.cuda.envdet import pick_tile
    from audian_torch.ops.design import FilterDesign

    rate = 96000.0
    sf = sps.butter(1, (1000.0, 10000.0), "bandpass", fs=rate, output="sos")
    se = sps.butter(1, 500.0, "lowpass", fs=rate, output="sos")
    jf, je = JaxDesign.from_sos(sf), JaxDesign.from_sos(se)
    tf, te = FilterDesign.from_sos(sf), FilterDesign.from_sos(se)
    halo = tev.detect_halo(tf, te)
    assert halo == jev.detect_halo(jf, je) == 2048
    jed, jchunk = jev._make_envdet(jf, je, 19, halo)
    ted, tchunk = tev._make_envdet(tf, te, 19, halo, torch.device("cpu"))
    assert isinstance(jed, JaxKernel) and isinstance(ted, EnvDetKernel)
    assert tchunk == jchunk == 2097144
    assert ((ted.lb, ted.d_bp, ted.ll, ted.d_lp, ted.nout, ted.hb)
            == (jed.lb, jed.d_bp, jed.ll, jed.d_lp, jed.nout, jed.hb)
            == (511, 255, 1023, 511, 110376, 2048))
    assert ted.window_need(halo) == jed.window_need(halo) <= (1 << 21) + 4096
    assert ted.tile == pick_tile(511, 1023, 19) == 320


def _two_songs(seed=1):
    """The signal of the JAX package's test_detect_fused_same_songs."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(RATE * 16)) / RATE
    x = 0.02 * rng.standard_normal(len(t))
    for s in (3.0, 9.0):
        m = (t >= s) & (t < s + 1.5)
        am = 0.5 * (1 + np.sin(2 * np.pi * 30.0 * t[m]))
        x[m] += 0.6 * am * np.sin(2 * np.pi * 6500.0 * t[m])
    return x


@pytest.mark.parametrize("return_filtered", [False, True],
                         ids=["fused", "exact"])
def test_detect_same_songs_as_jax(monkeypatch, return_filtered):
    for mod in (jev, tev):
        monkeypatch.setattr(mod, "_CHUNK", 1 << 15)
        monkeypatch.setattr(mod, "_KERNEL_BUDGET", {"filt": 0, "env": 0})
    x = _two_songs()
    want = jev.detect(x, RATE, 5500.0, 7500.0, 100.0,
                      return_filtered=return_filtered)
    got = tev.detect(x, RATE, 5500.0, 7500.0, 100.0,
                     return_filtered=return_filtered, device="cpu")
    assert got["envrate"] == want["envrate"]
    assert (got["filtered"] is None) == (not return_filtered)
    assert [len(o) for o in got["onset_indices"]] == [2]
    for key in ("onset_indices", "offset_indices"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(g, w)
    scale = np.abs(want["envelope"]).max()
    np.testing.assert_allclose(got["envelope"], want["envelope"], rtol=0,
                               atol=1e-5 * scale)
