"""audian_torch's ``ops.envelope`` against the JAX package's on the
``cricket_like`` recording: the pi/2-rectified zero-phase envelope of a
low-pass (clamped) and a band-pass (not clamped) smoother, and zeros
without a design.

Tolerance 1e-5 absolute: the port smooths in float32 on its blocked
state-space ``sosfiltfilt`` (a few 1e-7 from scipy float64), the JAX
package on its associative-scan IIR in float64 under the tests."""

import numpy as np
import pytest
import torch

from audian_tpu.ops import envelope as jenvelope

from audian_torch.ops import design_envelope_filter, envelope

TOL = 1e-5


# the conftest's fixtures at module scope: a session-scoped generator
# hands this file whatever numbers the files before it on the same
# worker left, so the data would depend on the test schedule
@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="module")
def cricket_like(rng):
    """Synthetic 4.8 kHz carrier chirps with an AM envelope plus noise,
    2 channels at 44.1 kHz (the body of the conftest's fixture)."""
    rate = 44100.0
    t = np.arange(int(2.0 * rate)) / rate
    carrier = np.sin(2 * np.pi * 4800.0 * t)
    am = (np.sin(2 * np.pi * 25.0 * t) > 0).astype(float)
    chirps = carrier * am
    x = np.stack([
        0.6 * chirps + 0.01 * rng.standard_normal(len(t)),
        0.3 * np.roll(chirps, 17) + 0.01 * rng.standard_normal(len(t)),
    ], axis=1)
    return x.astype(np.float64), rate


@pytest.mark.parametrize("highpass,clamp", [(0.0, True), (50.0, False)])
def test_envelope_equals_jax(cricket_like, highpass, clamp):
    x, rate = cricket_like
    sos = design_envelope_filter(rate, 500.0, highpass_cutoff=highpass)
    want = np.asarray(jenvelope(x, sos, clamp_negative=clamp))
    got = envelope(x, sos, clamp_negative=clamp, device="cpu")
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    if not clamp:
        assert float(got.min()) < 0.0     # the band-pass swings below zero


def test_envelope_without_a_design_is_zeros(cricket_like):
    x, _ = cricket_like
    want = np.asarray(jenvelope(x, None))
    got = envelope(x, None, device="cpu")
    assert got.shape == want.shape and not bool(got.any())
