"""The port's render tiles (``audian_torch.view.render``) against the JAX
package's (``audian_tpu.view.render``) on the same windows: min/max and
slice tiles (quantized and exact), the int16 pack/unpack, the readouts
(``window_extrema``, ``noise_level_stats``, ``mean_power_db_slice``,
``pick_amplitude``, ``power_value``) and the dB image tiles.

Tolerances: exact tiles equal numpy's reduceat exactly; quantized tiles
within one int16 code of the per-channel scale (scale / 32767) of the JAX
package's; u8 dB tiles within one code; dB readouts within 1e-4 dB."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audian_tpu.view import render as jrender

from audian_torch.ops.minmax import reduceat_like
from audian_torch.view import render

TOL_DB = 1e-4


class FakeTrace:
    """Minimal trace: one window at ``offset`` over ``frames`` frames."""

    def __init__(self, buf, rate, offset=0, frames=None):
        self.buffer = buf
        self.rate = rate
        self.offset = offset
        self.frames = len(buf) if frames is None else frames
        self.channels = buf.shape[1]

    def __getitem__(self, key):
        frame, rest = (key[0], key[1:]) if isinstance(key, tuple) else (
            key, ())
        if isinstance(frame, slice):
            frame = slice(frame.start - self.offset,
                          frame.stop - self.offset, frame.step)
        else:
            frame -= self.offset
        out = np.asarray(self.buffer[frame])
        return out[(slice(None),) + rest] if rest and out.ndim > 1 else (
            out[rest] if rest else out)


def twins(x, rate, offset=0, frames=None):
    """The same float32 window as a port trace (tensor) and a JAX trace."""
    x = np.asarray(x, np.float32)
    return (FakeTrace(torch.from_numpy(x.copy()), rate, offset, frames),
            FakeTrace(jnp.asarray(x), rate, offset, frames))


@pytest.fixture(scope="module")
def window():
    rng = np.random.default_rng(21)
    return rng.standard_normal((100000, 2)).astype(np.float32)


VIEWS = [(0.0, 99.0), (10.0, 20.0), (33.3, 37.9), (50.0, 50.4),
         (98.0, 120.0)]


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("t0,t1", VIEWS)
def test_trace_tiles_match_jax(window, quantize, t0, t1):
    tt, jt = twins(window, 1000.0)
    got_t, got = render.TraceTiler(max_pixels=100, quantize=quantize,
                                   device="cpu").tile(tt, t0, t1)
    want_t, want = jrender.TraceTiler(max_pixels=100,
                                      quantize=quantize).tile(jt, t0, t1)
    np.testing.assert_array_equal(got_t, want_t)
    assert got.shape == want.shape and got.dtype == np.float32
    if quantize:
        np.testing.assert_allclose(got, want,
                                   atol=np.abs(window).max() / 32767)
    else:
        np.testing.assert_array_equal(got, want)


def test_exact_tiles_equal_reduceat(window):
    tt, _ = twins(window, 1000.0)
    times, values = render.TraceTiler(max_pixels=100, quantize=False,
                                      device="cpu").tile(tt, 0.0, 99.0)
    step = int(round((times[1] - times[0]) * 2 * tt.rate))
    assert step & (step - 1) == 0 and step >= 99000 // 100
    n = len(values) // 2
    np.testing.assert_array_equal(values, reduceat_like(window[: n * step],
                                                        step))
    _, one = render.TraceTiler(max_pixels=4000, quantize=False,
                               device="cpu").tile(tt, 0.0, 0.5, channel=1)
    np.testing.assert_array_equal(one, window[:501, 1])


def test_tiles_clamp_to_an_offset_window(window):
    tt, jt = twins(window[10000:20000], 1000.0, offset=10000, frames=100000)
    got_t, got = render.TraceTiler(max_pixels=50, device="cpu").tile(
        tt, 0.0, 99.0)
    want_t, want = jrender.TraceTiler(max_pixels=50).tile(jt, 0.0, 99.0)
    np.testing.assert_array_equal(got_t, want_t)
    assert got_t[0] >= 10.0 - 1e-9 and got_t[-1] <= 20.0 + 1e-9
    np.testing.assert_allclose(got, want, atol=np.abs(window).max() / 32767)


def test_scroll_pulls_only_new_columns(window):
    """A scroll of a window with the same content epoch reuses the cached
    columns and pulls a bucket of new ones; the result equals a fresh
    tiler's."""
    class Epoch(FakeTrace):
        content_epoch = 0

    buf = torch.from_numpy(window)
    a = Epoch(buf[:60000], 1000.0)
    tiler = render.TraceTiler(max_pixels=100, quantize=False, device="cpu")
    tiler.tile(a, 0.0, 20.0)
    pulls = []
    orig = render._pull
    render._pull = lambda t: pulls.append(t.shape[0]) or orig(t)
    try:
        a.buffer, a.offset = buf[8192:68192], 8192      # the window slides
        _, got = tiler.tile(a, 12.0, 32.0)
    finally:
        render._pull = orig
    fresh = render.TraceTiler(max_pixels=100, quantize=False, device="cpu")
    np.testing.assert_array_equal(got, fresh.tile(a, 12.0, 32.0)[1])
    full = fresh._cache[next(iter(fresh._cache))]["data"].shape[0]
    assert len(pulls) == 1 and pulls[0] < full


def test_pack_unpack_round_trip():
    rng = np.random.default_rng(3)
    tile = (rng.standard_normal((257, 3)) * [1.0, 1e-3, 40.0]).astype(
        np.float32)
    packed = render._pack_scaled_i16(torch.from_numpy(tile)).numpy()
    want = np.asarray(jrender._pack_scaled_i16(jnp.asarray(tile)))
    assert packed.dtype == np.int16 and packed.shape == (259, 3)
    # the scale's float32 bits, low half first: what np.view reads back
    np.testing.assert_array_equal(packed[:2], want[:2])
    head = np.ascontiguousarray(packed[:2].T).view(np.float32).reshape(-1)
    np.testing.assert_array_equal(head, np.abs(tile).max(axis=0))
    assert np.abs(packed[2:].astype(int) - want[2:]).max() <= 1
    back = render._unpack_scaled_i16(packed)
    assert np.all(np.abs(back - tile) <= np.abs(tile).max(axis=0) / 32767)


def test_window_extrema_matches_jax_and_numpy(window):
    tt, jt = twins(window, 1000.0)
    for t0, t1 in ((0.0, 99.0), (10.0, 20.0), (33.3, 37.9)):
        for c in range(2):
            got = render.window_extrema(tt, t0, t1, c)
            assert got == jrender.window_extrema(jt, t0, t1, c)
            part = window[int(t0 * 1000):int(t1 * 1000), c]
            assert got == (float(part.min()), float(part.max()))
    assert render.window_extrema(tt, 5.0, 5.0, 0) == (0.0, 0.0)


def test_pick_amplitude_and_power_value(window):
    tt, jt = twins(window, 1000.0)
    for args in ((1.0, 10.0, 1.1), (1.0, -10.0, 1.1), (2.0, 0.0, None)):
        assert render.pick_amplitude(tt, *args) == \
            jrender.pick_amplitude(jt, *args)
    power = np.random.default_rng(5).random((700, 2, 33)).astype(np.float32)
    pt, pj = twins(power, 10.0)
    for i, c, j in ((0, 0, 0), (300, 1, 17), (699, 0, 32)):
        assert render.power_value(pt, i, c, j) == \
            jrender.power_value(pj, i, c, j) == float(power[i, c, j])


def test_noise_level_stats_and_mean_power_match_jax():
    rng = np.random.default_rng(6)
    buf = (rng.random((700, 3, 64)).astype(np.float32) ** 4) * 1e-4
    nf = buf.shape[2] // 16
    got = render.noise_level_stats(torch.from_numpy(buf), nf).numpy()
    want = np.asarray(jrender.noise_level_stats(jnp.asarray(buf), nf))
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, want, atol=TOL_DB)
    for c in range(3):
        db_tail = 10 * np.log10(np.maximum(buf[:, c, -nf:], 1e-20))
        assert got[c, 0] == pytest.approx(np.percentile(db_tail, 95),
                                          abs=TOL_DB)
    for i0, i1 in ((150, 411), (0, 700), (690, 700)):
        width = i1 - i0
        wb = min(1 << (width - 1).bit_length(), len(buf))
        start = max(min(i0, len(buf) - wb), 0)
        got = render.mean_power_db_slice(torch.from_numpy(buf), start, 1,
                                         i0 - start, width, wb).numpy()
        want = np.asarray(jrender.mean_power_db_slice(
            jnp.asarray(buf), start, 1, i0 - start, width, wb))
        np.testing.assert_allclose(got, want, atol=TOL_DB)


@pytest.fixture(scope="module")
def power():
    rng = np.random.default_rng(7)
    return ((np.abs(rng.standard_normal((5000, 3, 33))) + 1e-6) ** 3
            * 1e-3).astype(np.float32)


class FakeSpec(FakeTrace):
    fresolution = 125.0
    frequencies = np.arange(33) * 125.0


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("t0,t1", [(None, None), (10.0, 60.0),
                                   (123.4, 400.0), (450.0, 600.0)])
def test_spec_tiles_match_jax(power, quantize, t0, t1):
    tt = FakeSpec(torch.from_numpy(power), 10.0, offset=200, frames=6000)
    jt = FakeSpec(jnp.asarray(power), 10.0, offset=200, frames=6000)
    levels = np.array([(-60.0, 0.0), (-55.0, -5.0), (-70.0, 10.0)],
                      np.float32)
    tiler = render.SpecTiler(max_pixels=400, device="cpu")
    jtiler = jrender.SpecTiler(max_pixels=400)
    for c in range(3):
        for lv in (None, levels):
            got, rect = tiler.tile(tt, c, levels[c, 0], levels[c, 1],
                                   quantize, t0, t1, levels=lv)
            want, jrect = jtiler.tile(jt, c, levels[c, 0], levels[c, 1],
                                      quantize, t0, t1, levels=lv)
            assert rect == jrect and got.shape == want.shape
            if quantize:
                assert got.dtype == np.uint8
                assert np.abs(got.astype(int) - want).max() <= 1
            else:
                np.testing.assert_allclose(got, want, atol=1e-5)


def test_db_tile_u8_rounds_half_to_even_and_clips():
    # 1.0 is 0 dB, exactly half way over [-1, 1] dB: 127.5 rounds to 128
    p = torch.tensor([0.0, 1e-30, 0.5, 1.0, 1.2, 1e6])
    got = render._db_tile_u8(p, -1.0, 1.0).numpy()
    want = np.asarray(jrender._db_tile_u8(jnp.asarray(p.numpy()), -1.0, 1.0))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[3] == 128 and got[-1] == 255


def test_tilers_default_to_cuda_and_refuse_host_arrays(window):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    for cls in (render.TraceTiler, render.SpecTiler):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls()
    with pytest.raises(ValueError, match="window lies on"):
        render.TraceTiler(device="cpu").tile(FakeTrace(window, 1000.0), 0.0,
                                             1.0)
