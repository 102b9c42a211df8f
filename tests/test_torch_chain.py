"""The plain single-pass chain of audian_torch against the JAX package's
Pallas ``chain_cf`` (interpret mode on the CPU) and against scipy float64.

Both packages compute with the same coefficients: the port's chain is
built from the JAX chain's arrays (``convert.chain_from_arrays``).
Tolerances as in tests/test_fused.py: filtered atol 2e-6, envelope atol
3e-6, PSD rtol 1e-4 / atol 1e-9, stats rtol 1e-5; against scipy 1e-5.
"""

import itertools

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax.numpy as jnp

from audian_tpu.ops import design_envelope_filter, design_filter
from audian_tpu.ops.fused import FusedChainCF as JaxChain

from audian_torch.convert import ARRAY_KEYS, chain_from_arrays
from audian_torch.ops.cuda.chain import ALL_OUTPUTS, chain

RATE = 48000.0
SOS_F = design_filter(RATE, 1000.0, 8000.0)
SOS_E = design_envelope_filter(RATE, 500.0)


@pytest.fixture(scope="module")
def chains():
    jc = JaxChain(RATE, filt_sos=SOS_F, env_sos=SOS_E, nfft=256, hop=128,
                  eps=1e-8)
    arrays = {k: (None if getattr(jc, k) is None
                  else np.asarray(getattr(jc, k))) for k in ARRAY_KEYS}
    return jc, chain_from_arrays(arrays, device="cpu")


@pytest.fixture(scope="module")
def stream(chains):
    """(C=2, hb + 4096 + ha) gated 5 kHz tone plus noise, and its int16
    quantization."""
    jc, tc = chains
    ck = tc.chain_kernel
    n = ck.hb + 4096 + ck.ha
    rng = np.random.default_rng(11)
    t = np.arange(n) / RATE
    x = np.sin(2 * np.pi * 5000.0 * t) * (np.sin(2 * np.pi * 6.0 * t) > 0)
    x = np.stack([x, 0.5 * x]) + 0.05 * rng.standard_normal((2, n))
    q = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    return x.astype(np.float32), q


def _compare(got, want, stats=True):
    tol = {0: dict(atol=2e-6), 1: dict(atol=3e-6),
           2: dict(rtol=1e-4, atol=1e-9)}
    for i in range(3):
        if want[i] is None:
            assert got[i] is None
            continue
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   **tol[i])
    if stats:
        for key in ("power", "env_sum", "psd_sum"):
            np.testing.assert_allclose(got[3][key].numpy(),
                                       np.asarray(want[3][key]),
                                       rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("n", [2048, 1920])       # exact and padded tail
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_chain_matches_jax(chains, stream, dtype, n):
    jc, tc = chains
    x, q = stream
    xin = q if dtype == "int16" else x
    want = jc.chain_cf(jnp.asarray(xin), n, stats=True)
    got = tc.chain_cf(torch.from_numpy(xin), n, stats=True)
    assert got[0].shape == (2, n) and got[2].shape == (n // 128, 2, 129)
    _compare(got, want)


def test_int16_equals_its_dequantization(chains, stream):
    _, tc = chains
    _, q = stream
    got_q = tc.chain_cf(torch.from_numpy(q), 2048, stats=True)
    got_f = tc.chain_cf(torch.from_numpy(q.astype(np.float32) / 32768.0),
                        2048, stats=True)
    for a, b in zip(got_q[:3], got_f[:3]):
        assert torch.equal(a, b)


MASKS = [m for r in (1, 2, 3) for m in itertools.combinations(ALL_OUTPUTS, r)]


@pytest.mark.parametrize("outputs", MASKS, ids="+".join)
def test_output_masks_match_jax(chains, stream, outputs):
    jc, tc = chains
    _, q = stream
    want = jc.chain_cf(jnp.asarray(q), 2048, stats=True, outputs=outputs)
    got = tc.chain_cf(torch.from_numpy(q), 2048, stats=True,
                      outputs=outputs)
    _compare(got, want)
    full = tc.chain_cf(torch.from_numpy(q), 2048, stats=True)
    for i, (name, key) in enumerate(zip(
            ALL_OUTPUTS, ("power", "env_sum", "psd_sum"))):
        if name in outputs:
            assert torch.equal(got[i], full[i])
            assert torch.equal(got[3][key], full[3][key])
        else:
            assert got[i] is None and not bool(got[3][key].any())


@pytest.mark.parametrize("outputs", [("psd",), (), ("filtered", "psd")])
def test_bad_masks_raise_in_both(chains, stream, outputs):
    jc, tc = chains
    x, _ = stream
    with pytest.raises(ValueError, match="outputs"):
        jc.chain_cf(jnp.asarray(x), 128, outputs=outputs)
    with pytest.raises(ValueError, match="outputs"):
        tc.chain_cf(torch.from_numpy(x), 128, outputs=outputs)
    with pytest.raises(ValueError, match="outputs"):
        chain(tc.chain_kernel, torch.from_numpy(x), 128, outputs=outputs)


def test_chain_meets_scipy(chains, stream):
    """Filtered, envelope interior and PSD against scipy float64 on the
    stream with a zero history (the halo holds zeros)."""
    _, tc = chains
    x, _ = stream
    ck = tc.chain_kernel
    n = 2048
    sig = x[:, : n + ck.ha].astype(np.float64)
    x_ext = np.pad(x[:, : n + ck.ha], [(0, 0), (ck.hb, 0)])
    y, e, s, st = tc.chain_cf(torch.from_numpy(x_ext), n, stats=True)
    ys = sps.sosfilt(SOS_F, sig, axis=1)
    np.testing.assert_allclose(y.numpy(), ys[:, :n], atol=1e-5)
    es = sps.sosfiltfilt(SOS_E, (np.pi / 2) * np.abs(ys), axis=1)
    es = np.maximum(es, 0.0)
    d = tc.env_delay
    np.testing.assert_allclose(e.numpy()[:, d : n - d],
                               es[:, d : n - d], atol=1e-5)
    _, _, ss = sps.spectrogram(ys[:, : n + 128], fs=RATE, window="hann",
                               nperseg=256, noverlap=128, detrend=False,
                               scaling="density", mode="psd", axis=1)
    np.testing.assert_allclose(s.numpy(), ss.transpose(2, 0, 1), rtol=1e-5,
                               atol=1e-10)
    np.testing.assert_allclose(st["power"].numpy(),
                               np.sum(ys[:, :n] ** 2, axis=1), rtol=1e-5)
