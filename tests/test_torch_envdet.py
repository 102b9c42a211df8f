"""audian_torch's song-detection envelope against the JAX package: the
decimating bank, the two-stage ``EnvDet`` on ``window_matmul`` and the
single-pass ``EnvDetKernel`` (its plain version on the CPU) against JAX's
``EnvDet`` and Pallas ``EnvDetKernel`` (interpret mode on the CPU).

Both packages compute with the same symmetric kernels: the port's
``filtfilt_sym_kernel`` reproduces the JAX package's bit for bit, and
``convert.envdet_from_arrays`` carries them across.  Tolerance: 1e-5
absolute on unit-variance input, as ``test_envdet_kernel_edge_steps``
holds the two JAX forms (float32 on both sides, sums in different
orders).
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from audian_tpu.ops import FilterDesign as JaxDesign
from audian_tpu.ops.design import filtfilt_sym_kernel as jax_sym_kernel
from audian_tpu.ops.envdet import EnvDet as JaxEnvDet
from audian_tpu.ops.envdet import _decimating_bank as jax_decimating_bank
from audian_tpu.ops.pallas.envdet import EnvDetKernel as JaxEnvDetKernel

from audian_torch.convert import ENVDET_KEYS, envdet_from_arrays
from audian_torch.ops.cuda.envdet import EnvDetKernel, envdet
from audian_torch.ops.cuda.window_matmul import window_matmul
from audian_torch.ops.design import FilterDesign, filtfilt_sym_kernel
from audian_torch.ops.envdet import EnvDet, _decimating_bank

RATE = 8000.0
SOS_BP = sps.butter(1, (1500.0, 3000.0), "bandpass", fs=RATE, output="sos")
SOS_LP = sps.butter(1, 900.0, "lowpass", fs=RATE, output="sos")
HB = 2048


def _designs():
    return ((JaxDesign.from_sos(SOS_BP), JaxDesign.from_sos(SOS_LP)),
            (FilterDesign.from_sos(SOS_BP), FilterDesign.from_sos(SOS_LP)))


def _arrays(step, nout, hb=HB):
    """The JAX package's symmetric kernels and the geometry, as
    ``envdet_from_arrays`` takes them."""
    (jf, je), _ = _designs()
    g_bp, d_bp = jax_sym_kernel(jf.sos, pad_to=jf.fir.length)
    g_lp, d_lp = jax_sym_kernel(je.sos, pad_to=je.fir.length)
    return dict(g_bp=g_bp, d_bp=d_bp, g_lp=g_lp, d_lp=d_lp, step=step,
                nout=nout, hb=hb)


def _window(dtype, n=40000, seed=3):
    x = np.random.default_rng(seed).standard_normal((n, 2)).astype(
        np.float32)
    if dtype == "int16":
        return np.round(np.clip(0.3 * x, -1, 1) * 32767).astype(np.int16)
    return x


@pytest.mark.parametrize("L,step", [(1023, 19), (511, 1), (255, 3),
                                    (1023, 7)])
def test_decimating_bank_equals_jax(L, step):
    g = np.random.default_rng(L).standard_normal(L)
    np.testing.assert_array_equal(_decimating_bank(g, step),
                                  jax_decimating_bank(g, step))


@pytest.mark.parametrize("rate,band,cutoff", [
    (96000.0, (1000.0, 10000.0), 500.0),     # the CLI's default design
    (RATE, (1500.0, 3000.0), 900.0),
    (20000.0, (5500.0, 7500.0), 100.0),
])
def test_symmetric_kernels_bit_for_bit(rate, band, cutoff):
    for sos in (sps.butter(1, band, "bandpass", fs=rate, output="sos"),
                sps.butter(1, cutoff, "lowpass", fs=rate, output="sos")):
        jd, td = JaxDesign.from_sos(sos), FilterDesign.from_sos(sos)
        assert td.fir.length == jd.fir.length
        g_j, d_j = jax_sym_kernel(jd.sos, pad_to=jd.fir.length)
        g_t, d_t = filtfilt_sym_kernel(td.sos, pad_to=td.fir.length)
        assert d_t == d_j
        np.testing.assert_array_equal(g_t, g_j)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("step", [1, 3, 7, 19])
def test_envdet_matches_jax(step, dtype):
    (jf, je), (tf, te) = _designs()
    nout = 2048 // step
    x = _window(dtype)
    a = np.asarray(JaxEnvDet(jf, je, step, nout, HB)(x, HB))
    b = np.asarray(JaxEnvDetKernel(jf, je, step, nout, HB)(x, HB))
    xt = torch.from_numpy(x)
    two = EnvDet(tf, te, step, nout, HB, device="cpu")
    one = envdet_from_arrays(_arrays(step, nout), kernel=True, device="cpu")
    assert isinstance(one, EnvDetKernel)
    c = two(xt, HB).numpy()
    d = one(xt, HB).numpy()
    assert a.shape == b.shape == c.shape == d.shape == (nout, 2)
    for got in (c, d):
        np.testing.assert_allclose(got, a, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, b, rtol=0, atol=1e-5)
    assert np.all(np.isfinite(d)) and np.all(d >= 0)


def test_unaligned_offset():
    """The two-stage form takes any ``off0 >= hb``; the single-pass kernel
    refuses any other offset than ``hb`` in both packages."""
    (jf, je), (tf, te) = _designs()
    step, nout = 7, 256
    x = _window("float32")
    for off0 in (HB + 5, HB + 1234):
        want = np.asarray(JaxEnvDet(jf, je, step, nout, HB)(x, off0))
        got = EnvDet(tf, te, step, nout, HB, device="cpu")(
            torch.from_numpy(x), off0).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="exactly hb"):
        JaxEnvDetKernel(jf, je, step, nout, HB)(x, HB + 5)
    with pytest.raises(ValueError, match="exactly hb"):
        EnvDetKernel(tf, te, step, nout, HB, device="cpu")(
            torch.from_numpy(x), HB + 5)
    with pytest.raises(ValueError, match="off0"):
        EnvDet(tf, te, step, nout, HB, device="cpu")(torch.from_numpy(x),
                                                     HB - 1)


@pytest.mark.parametrize("step,nout", [(1, 2048), (19, 107), (7, 292)])
def test_window_need_equal(step, nout):
    (jf, je), (tf, te) = _designs()
    for jcls, tcls in ((JaxEnvDet, EnvDet),
                       (JaxEnvDetKernel, EnvDetKernel)):
        j = jcls(jf, je, step, nout, HB)
        t = tcls(tf, te, step, nout, HB, device="cpu")
        assert (t.d_bp, t.lb, t.d_lp, t.ll) == (j.d_bp, j.lb, j.d_lp, j.ll)
        for off0 in (HB, HB + 1, HB + 999):
            assert t.window_need(off0) == j.window_need(off0)


def test_headroom_checks_match_jax():
    """Both packages refuse a headroom below the forms' look-back."""
    (jf, je), (tf, te) = _designs()
    # EnvDetKernel needs the combined look-back of both filters (62
    # samples for these 32-sample responses), EnvDet only the envelope's
    # less the band-pass delay
    refused = 0
    for hb in (100, 62, 61, 20):
        for jcls, tcls in ((JaxEnvDet, EnvDet),
                           (JaxEnvDetKernel, EnvDetKernel)):
            try:
                jcls(jf, je, 4, 64, hb)
                jax_ok = True
            except ValueError:
                jax_ok = False
            if jax_ok:
                tcls(tf, te, 4, 64, hb, device="cpu")
            else:
                refused += 1
                with pytest.raises(ValueError):
                    tcls(tf, te, 4, 64, hb, device="cpu")
    assert refused == 2


def test_envdet_from_arrays_equals_design():
    step, nout = 3, 682
    _, (tf, te) = _designs()
    x = torch.from_numpy(_window("int16"))
    for kernel, cls in ((True, EnvDetKernel), (False, EnvDet)):
        a = cls(tf, te, step, nout, HB, device="cpu")(x, HB)
        b = envdet_from_arrays(_arrays(step, nout), kernel=kernel,
                               device="cpu")(x, HB)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(KeyError, match="hb"):
        envdet_from_arrays({k: 1 for k in ENVDET_KEYS if k != "hb"},
                           device="cpu")


def test_wrapper_device_rules():
    """The wrapper takes the plain version only for a CPU tensor, counts
    nothing there, and refuses other devices."""
    _, (tf, te) = _designs()
    ed = EnvDetKernel(tf, te, 5, 128, HB, device="cpu")
    n0, w0 = envdet.launches, window_matmul.launches
    x = torch.zeros((ed.window_need(HB), 2))
    assert envdet(ed, x).shape == (128, 2)
    EnvDet(tf, te, 5, 128, HB, device="cpu")(x, HB)
    assert (envdet.launches, window_matmul.launches) == (n0, w0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        envdet(ed, x.to("meta"))
    with pytest.raises(ValueError, match=r"\(W, C\)"):
        envdet(ed, torch.zeros(100))
