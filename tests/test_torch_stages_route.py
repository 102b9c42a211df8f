"""``FusedChainCF.chain_cf``'s per-stage route, which runs every design the
single-pass kernel refuses, on the ``ultrasound`` preset at 384 kHz (hop
256, NFFT 512): halo-extended int16 and float32 chunks against scipy
float64 and against the JAX package's per-stage methods, chunks against
the whole stream, the statistics, the output masks, the rung, the spans,
and the designs the single-pass kernel takes, which keep it.

Tolerances: against scipy 1e-5 (filtered, envelope) and 0.013 dB (PSD over
bins within 60 dB of the peak), the configurations' guarantees; against
the JAX package tests/test_torch_fused.py's (filtered atol 1e-6, envelope
2e-6, PSD rtol 1e-4 / atol 1e-9)."""

import itertools

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax.numpy as jnp

from audian_tpu.models import get_preset as jax_preset

from audian_torch.models import get_preset
from audian_torch.ops import fused as fused_mod
from audian_torch.ops.cuda.chain import ALL_OUTPUTS, chain
from audian_torch.ops.cuda.precision import BF16X3, DEFAULT, HIGHEST
from audian_torch.ops.design import design_envelope_filter, design_filter
from audian_torch.ops.fused import FusedChainCF
from audian_torch.utils import trace

RATE = 384000.0
C = 2
#: the recording: four blocks of 2^14 frames; the chunks lie inside it
N = 4 << 14
CHUNK = 1 << 14
#: the chunk's first sample (a multiple of the hop, so the whole stream's
#: PSD frames fall on the chunk's)
P0 = 3 << 12
SOS_F = design_filter(RATE, 20000.0, 90000.0)
SOS_E = design_envelope_filter(RATE, 1000.0)


@pytest.fixture(scope="module")
def us():
    return get_preset("ultrasound").fused(RATE, device="cpu")


@pytest.fixture(scope="module")
def recording():
    """PCM-16 ``(C, N)``: a 45 kHz tone gated at 200 Hz plus noise, and
    its float64 reference outputs over the whole recording."""
    rng = np.random.default_rng(22)
    t = np.arange(N) / RATE
    x = 0.5 * np.sin(2 * np.pi * 45000.0 * t) * (
        np.sin(2 * np.pi * 200.0 * t) > 0)
    x = np.stack([x, -0.6 * x]) + 0.05 * rng.standard_normal((C, N))
    q = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    xd = q.astype(np.float64) / 32768.0
    y = sps.sosfilt(SOS_F, xd, axis=1)
    e = np.maximum(sps.sosfiltfilt(SOS_E, (np.pi / 2) * np.abs(y), axis=1),
                   0.0)
    return q, y, e


def extended(q, fc, p0, n, dtype):
    """The chunk ``[p0, p0 + n)`` of ``q`` with ``fc``'s halos, as
    ``dtype``."""
    x = q[:, p0 - fc.hb : p0 + n + fc.ha]
    if dtype == "float32":
        x = x.astype(np.float32) / 32768.0
    return torch.from_numpy(np.ascontiguousarray(x))


def ref_psd(y, p0, n):
    """scipy's density PSD of the frames at hop 256 from ``p0``: ``(n //
    256, C, 257)``."""
    _, _, s = sps.spectrogram(y[:, p0 : p0 + n + 256], fs=RATE,
                              window="hann", nperseg=512, noverlap=256,
                              detrend=False, scaling="density", mode="psd",
                              axis=1)
    return s.transpose(2, 0, 1)[: n // 256]


def db_gap(got, want):
    keep = want >= want.max() * 1e-6
    return float(np.abs(10 * np.log10(got.astype(np.float64)[keep]
                                      / want[keep])).max())


def test_the_preset_takes_the_route(us):
    assert us.chain_kernel is None and (us.hop, us.nfft) == (256, 512)
    assert (len(us._h_filt), len(us._g_env), us.env_delay) == (84, 2787,
                                                               1393)
    assert us.env_mode == "dense" and us.precision == HIGHEST
    # the filter's history and the envelope's look-back in whole hops;
    # the envelope's look-ahead past the chunk
    assert (us.hb, us.ha) == (83 + 1536, 1393)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_route_meets_scipy(us, recording, dtype):
    q, y, e = recording
    got_y, got_e, got_s, st = us.chain_cf(extended(q, us, P0, CHUNK, dtype),
                                          CHUNK, stats=True)
    assert got_y.shape == got_e.shape == (C, CHUNK)
    assert got_s.shape == (CHUNK // 256, C, 257)
    np.testing.assert_allclose(got_y.numpy(), y[:, P0 : P0 + CHUNK],
                               atol=1e-5)
    np.testing.assert_allclose(got_e.numpy(), e[:, P0 : P0 + CHUNK],
                               atol=1e-5)
    assert db_gap(got_s.numpy(), ref_psd(y, P0, CHUNK)) <= 0.013


def test_int16_equals_its_dequantization(us, recording):
    q = recording[0]
    a = us.chain_cf(extended(q, us, P0, CHUNK, "int16"), CHUNK, stats=True)
    b = us.chain_cf(extended(q, us, P0, CHUNK, "float32"), CHUNK,
                    stats=True)
    for u, v in zip(a[:3], b[:3]):
        assert torch.equal(u, v)


def test_route_matches_the_jax_per_stage_methods(us, recording):
    """The JAX package's per-stage methods over the whole dequantized
    recording, read at the chunk (its envelope pads the stream with zeros,
    so only the chunk far from the recording's ends is compared)."""
    q = recording[0]
    jc = jax_preset("ultrasound").fused(RATE)
    x = jnp.asarray(q.astype(np.float32) / 32768.0)
    jy = jc.filtered_cf(x)
    je = np.asarray(jc.envelope_cf(jy))
    js = np.asarray(jc.spectrogram_fc(jy))
    jy = np.asarray(jy)
    y, e, s = us.chain_cf(extended(q, us, P0, CHUNK, "int16"), CHUNK)
    f0 = P0 // 256
    np.testing.assert_allclose(y.numpy(), jy[:, P0 : P0 + CHUNK], atol=1e-6)
    np.testing.assert_allclose(e.numpy(), je[:, P0 : P0 + CHUNK], atol=2e-6)
    np.testing.assert_allclose(s.numpy(), js[f0 : f0 + CHUNK // 256],
                               rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_two_chunks_equal_the_whole(us, recording, dtype):
    """Two chunks, each with its halos from the recording, against one
    chunk over both."""
    q = recording[0]
    whole = us.chain_cf(extended(q, us, P0, 2 * CHUNK, dtype), 2 * CHUNK,
                        stats=True)
    parts = [us.chain_cf(extended(q, us, P0 + k * CHUNK, CHUNK, dtype),
                         CHUNK, stats=True) for k in range(2)]
    for k, part in enumerate(parts):
        sl = slice(k * CHUNK, (k + 1) * CHUNK)
        fl = slice(k * CHUNK // 256, (k + 1) * CHUNK // 256)
        np.testing.assert_allclose(part[0], whole[0][:, sl], atol=2e-6)
        np.testing.assert_allclose(part[1], whole[1][:, sl], atol=2e-6)
        np.testing.assert_allclose(part[2], whole[2][fl], rtol=1e-4,
                                   atol=1e-9)
    for key in ("power", "env_sum", "psd_sum"):
        np.testing.assert_allclose(parts[0][3][key] + parts[1][3][key],
                                   whole[3][key], rtol=1e-5)


def test_statistics_are_the_sums_of_the_outputs(us, recording):
    """``power``, ``env_sum`` and ``psd_sum`` against the float64 sums of
    the reference's outputs (the PSD over bins within 60 dB of the peak),
    and against the sums of the route's own outputs."""
    q, y, e = recording
    got_y, got_e, got_s, st = us.chain_cf(
        extended(q, us, P0, CHUNK, "int16"), CHUNK, stats=True)
    ry, re_ = y[:, P0 : P0 + CHUNK], e[:, P0 : P0 + CHUNK]
    rs = ref_psd(y, P0, CHUNK).sum(0)
    keep = rs >= rs.max() * 1e-6
    np.testing.assert_allclose(st["power"], (ry * ry).sum(1), rtol=1e-5)
    np.testing.assert_allclose(st["env_sum"], re_.sum(1), rtol=1e-5)
    np.testing.assert_allclose(st["psd_sum"].numpy()[keep], rs[keep],
                               rtol=1e-4)
    own = got_y.double()
    np.testing.assert_allclose(st["power"], (own * own).sum(1), rtol=1e-6)
    np.testing.assert_allclose(st["env_sum"], got_e.double().sum(1),
                               rtol=1e-6)
    np.testing.assert_allclose(st["psd_sum"], got_s.double().sum(0),
                               rtol=1e-6)


def counting(monkeypatch):
    """Route every window product of the chain through a wrapper that
    keeps each call's bank and precision and counts it as the card's
    launches are counted."""
    real = fused_mod.window_matmul
    calls = []

    def wm(x, w, stride, nframes, *args, **kwargs):
        calls.append((w, kwargs.get("precision")))
        wm.launches += 1
        return real(x, w, stride, nframes, *args, **kwargs)

    wm.launches = 0
    monkeypatch.setattr(fused_mod, "window_matmul", wm)
    return calls


MASKS = [m for r in (1, 2, 3) for m in itertools.combinations(ALL_OUTPUTS, r)]


@pytest.mark.parametrize("outputs", MASKS, ids="+".join)
def test_output_masks(us, recording, outputs, monkeypatch):
    """A masked stage comes back ``None`` with zero statistics, launches no
    window product, and leaves the others as the full call has them."""
    x = extended(recording[0], us, P0, CHUNK, "int16")
    full = us.chain_cf(x, CHUNK, stats=True)
    calls = counting(monkeypatch)
    got = us.chain_cf(x, CHUNK, stats=True, outputs=outputs)
    banks = [w for w, _ in calls]
    assert banks[0] is us.filt_w
    assert (any(w is us.env_w for w in banks)) == ("envelope" in outputs)
    assert (any(w is us.spec_w for w in banks)) == (
        "spectrogram" in outputs)
    assert len(banks) == 1 + ("envelope" in outputs) + (
        "spectrogram" in outputs)
    for i, (name, key) in enumerate(zip(
            ALL_OUTPUTS, ("power", "env_sum", "psd_sum"))):
        if name in outputs:
            assert torch.equal(got[i], full[i])
            assert torch.equal(got[3][key], full[3][key])
        else:
            assert got[i] is None and not bool(got[3][key].any())


@pytest.mark.parametrize("outputs", [("psd",), ()])
def test_bad_masks_raise(us, outputs):
    with pytest.raises(ValueError, match="outputs"):
        us.chain_cf(torch.zeros((1, us.hb + 512 + us.ha)), 512,
                    outputs=outputs)


@pytest.mark.parametrize("precision", [HIGHEST, DEFAULT])
def test_every_product_takes_the_rung(recording, precision, monkeypatch):
    fc = get_preset("ultrasound").fused(RATE, device="cpu",
                                        precision=precision)
    calls = counting(monkeypatch)
    fc.chain_cf(extended(recording[0], fc, P0, CHUNK, "int16"), CHUNK,
                stats=True)
    assert len(calls) == 3 and {p for _, p in calls} == {precision}


def test_a_rung_window_matmul_lacks_is_refused():
    with pytest.raises(ValueError, match="precision"):
        get_preset("ultrasound").fused(RATE, device="cpu", precision=BF16X3)


def test_spans_of_the_route(us, recording, monkeypatch):
    """One ``stages.call`` a call, with the frames and the window products
    launched in it, around one ``stages.stage`` a stage."""
    counting(monkeypatch)
    x = extended(recording[0], us, P0, CHUNK, "int16")
    trace.clear()
    trace.enable(log=False)
    try:
        us.chain_cf(x, CHUNK, stats=True)
        us.chain_cf(x, CHUNK, outputs=("envelope",))
        calls = trace.events("stages.call")
        stages = trace.events("stages.stage")
        assert not trace.events("chain.call")
    finally:
        trace.disable()
        trace.clear()
    assert [(c["frames"], c["launches"]) for c in calls] == [(CHUNK, 3),
                                                            (CHUNK, 2)]
    assert [s["stage"] for s in stages] == [
        "filtered", "envelope", "spectrogram", "stats", "filtered",
        "envelope"]
    assert [s["parent"] for s in stages] == [calls[0]["id"]] * 4 + [
        calls[1]["id"]] * 2


def test_host_arrays_are_taken(us, recording):
    x = extended(recording[0], us, P0, CHUNK, "int16")
    a = us.chain_cf(x.numpy(), CHUNK)
    b = us.chain_cf(x, CHUNK)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("design", ["no envelope", "no filter"])
def test_designs_without_a_stage(recording, design):
    """A chain without an envelope design returns a zero envelope; one
    without a filter passes the dequantized stream through as filtered."""
    q, y, e = recording
    fc = FusedChainCF(
        RATE, filt_sos=None if design == "no filter" else SOS_F,
        env_sos=None if design == "no envelope" else SOS_E, nfft=512,
        hop=256, device="cpu")
    assert fc.chain_kernel is None
    got_y, got_e, got_s = fc.chain_cf(extended(q, fc, P0, CHUNK, "int16"),
                                      CHUNK)
    if design == "no envelope":
        assert fc.hb == 83 and not bool(got_e.any())
        np.testing.assert_allclose(got_y.numpy(), y[:, P0 : P0 + CHUNK],
                                   atol=1e-5)
    else:
        xd = q.astype(np.float64) / 32768.0
        assert fc.hb == 1536
        assert torch.equal(got_y, torch.from_numpy(
            q[:, P0 : P0 + CHUNK].astype(np.float32) / 32768.0))
        want = np.maximum(sps.sosfiltfilt(SOS_E, (np.pi / 2) * np.abs(xd),
                                          axis=1), 0.0)
        np.testing.assert_allclose(got_e.numpy(), want[:, P0 : P0 + CHUNK],
                                   atol=1e-5)


def test_ifir_envelope_on_the_route():
    """An interpolated-FIR envelope (96 kHz, 500 Hz, hop 256) on the route
    against the same chain's per-stage envelope over the whole stream."""
    from threadpoolctl import threadpool_limits

    rate = 96000.0
    with threadpool_limits(1):
        fc = FusedChainCF(rate, filt_sos=design_filter(rate, 2000.0,
                                                       40000.0),
                          env_sos=design_envelope_filter(rate, 500.0),
                          nfft=512, hop=256, ifir=True, device="cpu")
    assert fc.env_mode == "ifir" and fc.chain_kernel is None
    rng = np.random.default_rng(3)
    q = (3000 * rng.standard_normal((C, N))).astype(np.int16)
    x = torch.from_numpy(q.astype(np.float32) / 32768.0)
    e_whole = fc.envelope_cf(fc.filtered_cf(x))
    _, e, _ = fc.chain_cf(extended(q, fc, P0, CHUNK, "int16"), CHUNK)
    np.testing.assert_allclose(e, e_whole[:, P0 : P0 + CHUNK], atol=2e-6)


# -- designs the single-pass kernel takes keep it ---------------------------

@pytest.fixture(scope="module")
def bio():
    return get_preset("bioacoustics").fused(96000.0, device="cpu")


def test_halos_are_the_kernels(bio):
    ck = bio.chain_kernel
    assert ck is not None
    assert (bio.hb, bio.ha) == (ck.hb, ck.ha)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_bioacoustics_keeps_the_single_pass_kernel(bio, dtype, monkeypatch):
    """``chain_cf`` of a design the kernel takes is the kernel's call bit
    for bit, under the ``chain.call`` span, with no window product."""
    ck = bio.chain_kernel
    n = 4096
    rng = np.random.default_rng(7)
    q = (4000 * rng.standard_normal((C, ck.hb + n + ck.ha))).astype(np.int16)
    x = torch.from_numpy(q if dtype == "int16"
                         else q.astype(np.float32) / 32768.0)
    calls = counting(monkeypatch)
    trace.clear()
    trace.enable(log=False)
    try:
        got = bio.chain_cf(x, n, stats=True)
        kinds = [e["kind"] for e in trace.events()]
    finally:
        trace.disable()
        trace.clear()
    want = chain(ck, x, n, stats=True)
    assert kinds == ["chain.call"] and not calls
    for u, v in zip(got[:3], want[:3]):
        assert torch.equal(u, v)
    for key in want[3]:
        assert torch.equal(got[3][key], want[3][key])
