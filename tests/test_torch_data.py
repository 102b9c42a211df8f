"""The port's loader and ``Data`` (``audian_torch.data``) against the JAX
package's (``audian_tpu.data``) on the same PCM-16 WAV: the loader's reads
and windows, the trace windows through opening, paging, jumps and
parameter updates, the scroll fast path against a full recompute,
``content_epoch``, ``get_region``, the sliding-window helpers at partial
overlaps, and the raw window against the file.

The JAX package's FIR nodes design at the port's lengths
(``fir_lengths.at_port_lengths``), so both plan the same windows.

Tolerances: filtered and envelope windows within 1e-5 absolute of the JAX
package's, the PSD within 1e-4 relative (atol 1e-12); the delta-stitched
windows within 1e-6 of a full recompute (the same float32 arithmetic over
other sub-window edges); raw windows exact."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audian_tpu import graph as jgraph
from audian_tpu.data import Data as JData
from audian_tpu.data import data as jdata_mod
from audian_tpu.data import wavio as jwav
from audian_tpu.data.loader import AudioLoader as JLoader

from audian_torch import graph as tgraph
from audian_torch.data import AudioLoader, Data, wavio
from audian_torch.data import data as data_mod
from audian_torch.stream import BlockPrefetcher

from fir_lengths import at_port_lengths

RATE = 48000.0
SECONDS = 8.0
#: a 1.5 kHz envelope (default_traces' is 500 Hz): its FIR is a quarter
#: as long, which keeps the plain CPU convolutions of these tests short
ENV_CUTOFF = 1500.0
NAMES = ("filtered", "envelope", "spectrogram")
TOL = 1e-5
TOL_PSD_RTOL = 1e-4
TOL_DELTA = 1e-6


def signal(rng, seconds=SECONDS, channels=2):
    n = int(seconds * RATE)
    t = np.arange(n)[:, None] / RATE
    chirps = np.sin(2 * np.pi * (5000.0 + 1500.0 * np.arange(channels)) * t)
    gate = np.sin(2 * np.pi * 1.3 * t) > 0.2
    x = 0.4 * chirps * gate + 0.03 * rng.standard_normal((n, channels))
    return np.clip(x, -1.0, 0.99)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    x = signal(np.random.default_rng(17))
    p = tmp_path_factory.mktemp("tdata") / "rec.wav"
    md = {"BEXT": {"OriginationDate": "2026-05-06",
                   "OriginationTime": "07:08:09"}, "Comment": "port"}
    locs = np.array([[4800, 0], [96000, 4000]])
    labels = np.array([["start", ""], ["song", "trill"]], dtype=object)
    jwav.write_audio(p, x, RATE, metadata=md, locs=locs, labels=labels,
                     encoding="PCM_16")
    return p


def traces(pkg):
    """default_traces() with the test's envelope cutoff, the JAX package's
    FIR nodes at the port's lengths."""
    nodes = [pkg.FilterNode("filtered", "data"),
             pkg.EnvelopeNode("envelope", "filtered",
                              envelope_cutoff=ENV_CUTOFF),
             pkg.SpectrogramNode("spectrogram", "filtered")]
    return at_port_lengths(*nodes) if pkg is jgraph else nodes


def open_data(cls, pkg, path, buffer_time=2.0, back_time=0.5, **kw):
    d = cls(path, buffer_time=buffer_time, back_time=back_time, **kw)
    for node in traces(pkg):
        d.add_trace(node)
    d.open()
    d["filtered"].update(highpass_cutoff=2000.0, lowpass_cutoff=10000.0)
    return d


def open_pair(path):
    """The port's and the JAX package's ``Data`` on ``path``, the filter
    set to 2-10 kHz in both."""
    return (open_data(Data, tgraph, path, device="cpu"),
            open_data(JData, jgraph, path))


def window(trace):
    buf = trace.buffer
    return buf.cpu().numpy() if isinstance(buf, torch.Tensor) else \
        np.asarray(buf)


def check_windows(t, j, label):
    for name in NAMES:
        assert t[name].offset == j[name].offset, (label, name)
        got, want = window(t[name]), window(j[name])
        assert got.shape == want.shape, (label, name)
        if name == "spectrogram":
            np.testing.assert_allclose(got, want, rtol=TOL_PSD_RTOL,
                                       atol=1e-12, err_msg=label)
        else:
            np.testing.assert_allclose(got, want, atol=TOL,
                                       err_msg=f"{label} {name}")


def test_loader_matches_jax(wav, tmp_path):
    ld, jl = AudioLoader(wav, buffer_time=2.0), JLoader(wav, buffer_time=2.0)
    assert (ld.rate, ld.channels, ld.frames, ld.encoding) == \
        (jl.rate, jl.channels, jl.frames, jl.encoding)
    assert ld.format_dict() == jl.format_dict()
    assert ld.metadata() == jl.metadata()
    assert wavio.get_datetime(ld.metadata()).hour == 7
    for a, b in zip(ld.markers(), jl.markers()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ld[1000:5000], jl[1000:5000])
    np.testing.assert_array_equal(ld[380000:379000:-3, 1],
                                  jl[380000:379000:-3, 1])
    for t0, t1 in ((0.0, 0.5), (3.2, 3.9), (7.5, 8.0), (1.0, 1.2)):
        ld.update_time(t0, t1)
        jl.update_time(t0, t1)
        assert ld.offset == jl.offset
        np.testing.assert_array_equal(ld.buffer, jl.buffer)
    q, jq = (np.zeros((3000, 2), np.int16) for _ in range(2))
    ld.read_raw16_into(123456, 3000, q)
    jl.read_raw16_into(123456, 3000, jq)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(q / 32768.0, ld[123456:126456])
    # two files, concatenated, across their boundary
    x = signal(np.random.default_rng(1), 2.0)
    parts = [tmp_path / "a.wav", tmp_path / "b.wav"]
    jwav.write_audio(parts[0], x[:30000], RATE, encoding="FLOAT")
    jwav.write_audio(parts[1], x[30000:], RATE, encoding="FLOAT")
    ld, jl = AudioLoader(parts), JLoader(parts)
    np.testing.assert_array_equal(ld[29000:31000], jl[29000:31000])
    assert ld.get_file_index(30003) == (parts[1], 3)
    ld.close()
    jl.close()


def test_data_session_matches_jax(wav):
    """Open, page forward and back, jump, scrub a cutoff and step NFFT:
    after every move the port's windows equal the JAX package's."""
    t, j = open_pair(wav)
    assert t.keys() == j.keys() and t.start_time == j.start_time
    assert t.meta_data == j.meta_data
    moves = ([(0.0, 0.5)] + [(0.5 * k, 0.5 * k + 0.5) for k in (1, 2, 3, 4)]
             + [(1.5, 2.0), (1.0, 1.5), (6.5, 7.0), (0.4, 0.9)])
    for t0, t1 in moves:
        assert t.update_times(t0, t1) == j.update_times(t0, t1)
        check_windows(t, j, f"view {t0}-{t1}")
    for d in (t, j):
        d["filtered"].update(lowpass_cutoff=8000.0)
    check_windows(t, j, "lowpass 8 kHz")
    for d in (t, j):
        d["spectrogram"].update(nfft=512)
    check_windows(t, j, "nfft 512")
    i0 = int(0.9 * RATE)
    np.testing.assert_allclose(t["envelope"][i0 : i0 + 500, 1],
                               np.asarray(j["envelope"][i0 : i0 + 500, 1]),
                               atol=TOL)
    # outside the window: computed on demand
    np.testing.assert_allclose(t["filtered"][320000:320300],
                               np.asarray(j["filtered"][320000:320300]),
                               atol=TOL)
    t.close()
    j.close()


def test_delta_path_equals_full_recompute(wav):
    t = open_data(Data, tgraph, wav, device="cpu")
    t.update_times(0.0, 0.5)
    deltas = 0
    orig = t._try_delta_update

    def counting(dev, targets):
        nonlocal deltas
        hit = orig(dev, targets)
        deltas += bool(hit and t._last_raw_shift)
        return hit

    t._try_delta_update = counting
    for k in range(1, 7):
        t.update_times(0.5 * k, 0.5 * k + 0.5)
    t.update_times(2.0, 2.5)                      # back through the window
    assert deltas >= 4, "scrolls did not take the incremental path"
    stitched = {n: (t[n].offset, window(t[n])) for n in NAMES}
    raw = t._dev_raw.numpy().copy()
    np.testing.assert_array_equal(raw, t.data.buffer)
    np.testing.assert_array_equal(raw, t.data[t.data.offset:
                                              t.data.offset + len(raw)])
    t._dev_raw = None
    t._try_delta_update = lambda dev, targets: False
    t.update_times(2.0, 2.5)
    for n, (off, arr) in stitched.items():
        assert t[n].offset == off
        np.testing.assert_allclose(arr, window(t[n]), atol=TOL_DELTA,
                                   rtol=TOL_DELTA if n == "spectrogram"
                                   else 0, err_msg=n)
    t.close()


def test_content_epoch_and_get_region(wav):
    t, j = open_pair(wav)
    for d in (t, j):
        d.update_times(2.0, 2.5)
    e0 = {n: t[n].content_epoch for n in NAMES}
    assert e0 == {n: j[n].content_epoch for n in NAMES}
    for d in (t, j):
        d.update_times(2.5, 3.0)                  # a scroll keeps them
    assert {n: t[n].content_epoch for n in NAMES} == e0
    for d in (t, j):
        d["spectrogram"].update(nfft=128)         # only the spectrogram
    e1 = {n: t[n].content_epoch for n in NAMES}
    assert e1 == dict(e0, spectrogram=e0["spectrogram"] + 1)
    for d in (t, j):
        d.set_visible("envelope", False)
        d["filtered"].update(highpass_cutoff=3000.0)
    assert t["envelope"].content_epoch is None    # dirty while hidden
    assert t["filtered"].content_epoch == e1["filtered"] + 1
    for d in (t, j):
        d.set_visible("envelope", True)
    assert {n: t[n].content_epoch for n in NAMES} == \
        {n: j[n].content_epoch for n in NAMES}
    check_windows(t, j, "re-shown after a hidden update")
    for t0, t1, c in ((2.6, 2.7, 0), (7.0, 7.01, 1)):
        got, want = t.get_region(t0, t1, c), j.get_region(t0, t1, c)
        assert set(got) == set(want)
        for name in got:
            for a, b in zip(got[name], want[name]):
                np.testing.assert_allclose(
                    a, np.asarray(b), atol=TOL if name != "spectrogram"
                    else 1e-12, rtol=TOL_PSD_RTOL if name == "spectrogram"
                    else 0, err_msg=name)
    t.close()
    j.close()


@pytest.mark.parametrize("shift,nb", [(3, 3), (3, 8), (-5, 5), (-5, 16),
                                      (15, 16), (-15, 16)])
def test_slides_at_partial_overlap_match_jax(shift, nb):
    """|shift| < len(window): the slide is one copy into a fresh tensor
    (an in-place shift of a tensor onto itself raises in torch)."""
    rng = np.random.default_rng(abs(shift) + nb)
    old = rng.standard_normal((16, 2)).astype(np.float32)
    new = rng.standard_normal((nb, 2)).astype(np.float32)
    told = torch.from_numpy(old.copy())
    got = data_mod._slide_window(told, torch.from_numpy(new), shift)
    want = jdata_mod._slide_window(jnp.asarray(old), jnp.asarray(new),
                                   shift, tail=shift > 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(told.numpy(), old)   # old untouched
    delta = rng.standard_normal((max(nb, abs(shift)), 2)).astype(np.float32)
    pos = 16 - len(delta) if shift > 0 else 0
    got = data_mod._slide_patch(told, torch.from_numpy(delta), shift, pos)
    want = jdata_mod._slide_patch(jnp.asarray(old), jnp.asarray(delta),
                                  shift, pos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_float_wav_uploads_the_loader_window(tmp_path):
    x = signal(np.random.default_rng(2), 4.0, channels=1)
    p = tmp_path / "f.wav"
    jwav.write_audio(p, x, RATE, encoding="FLOAT")
    t = Data(p, buffer_time=1.0, back_time=0.25, device="cpu")
    t.add_trace(tgraph.FilterNode("filtered", "data"))
    t.open()
    assert not t.data.raw16_capable
    for t0 in (0.0, 0.5, 1.0, 2.5):
        t.update_times(t0, t0 + 0.5)
        np.testing.assert_array_equal(t["data"].buffer.numpy(),
                                      t.data.buffer)
    assert t["data"].buffer.dtype == torch.float32
    t.close()


def test_prefetcher_recycles_unreferenced():
    """Evicted block storage is reused, but never while a caller still
    holds a read() view of it."""
    class Source:
        frames, channels, dtype = 12000, 2, np.float32
        data = np.arange(24000, dtype=np.float32).reshape(12000, 2)

        def _read(self, start, nframes, out=None):
            n = min(nframes, self.frames - start)
            if out is None:
                return self.data[start : start + n]
            out[:n] = self.data[start : start + n]
            return out[:n]

    pf = BlockPrefetcher(Source(), block_frames=1000, max_blocks=2,
                         read_ahead=0)
    held = pf.read(0, 100)
    before = held.copy()
    for b in range(1, 12):
        np.testing.assert_array_equal(pf.read(b * 1000, 1000),
                                      Source.data[b * 1000:(b + 1) * 1000])
    pf.drain()
    assert pf._free and pf.recycled > 0
    np.testing.assert_array_equal(held, before)
    pf.close()


def test_data_defaults_to_cuda(wav):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        Data(wav)


def test_flac16_session_equals_the_wav_session(wav, tmp_path):
    """A 16-bit FLAC of the WAV's codes takes the int16 upload, and every
    window of a paging session equals the WAV session's bit for bit (the
    same codes through the same torch ops) and the JAX package's ``Data``
    on the FLAC at this file's tolerances."""
    codes = np.empty((int(SECONDS * RATE), 2), np.int16)
    wavio.read_frames_raw16(wav, 0, len(codes), wavio.wav_info(wav), codes)
    flac = tmp_path / "rec.flac"
    jwav.write_audio(flac, codes, RATE, metadata=jwav.metadata(wav))
    f, w = (open_data(Data, tgraph, p, device="cpu") for p in (flac, wav))
    j = open_data(JData, jgraph, flac)
    assert f.data.raw16_capable and f.data.encoding == "FLAC_16"
    for t0 in (0.0, 0.5, 6.5, 0.4):
        for d in (f, w, j):
            d.update_times(t0, t0 + 0.5)
        label = f"view {t0}"
        assert f["data"].buffer.dtype == torch.float32
        np.testing.assert_array_equal(window(f["data"]), window(w["data"]))
        for name in NAMES:
            assert f[name].offset == w[name].offset
            np.testing.assert_array_equal(window(f[name]), window(w[name]),
                                          err_msg=f"{label} {name}")
        check_windows(f, j, label)
    for d in (f, w, j):
        d.close()


def test_flac24_uploads_the_loader_window(tmp_path):
    x = signal(np.random.default_rng(4), 3.0, channels=1)
    p = tmp_path / "r24.flac"
    jwav.write_audio(p, x, RATE, encoding="PCM_24")
    t = Data(p, buffer_time=1.0, back_time=0.25, device="cpu")
    t.add_trace(tgraph.FilterNode("filtered", "data"))
    t.open()
    assert t.data.encoding == "FLAC_24" and not t.data.raw16_capable
    for t0 in (0.0, 0.5, 2.0):
        t.update_times(t0, t0 + 0.5)
        np.testing.assert_array_equal(t["data"].buffer.numpy(),
                                      t.data.buffer)
        i0 = t.data.offset
        q = np.round(x[i0 : i0 + len(t.data.buffer)] * 2 ** 23)
        np.testing.assert_array_equal(
            t.data.buffer, (np.clip(q, -2 ** 23, 2 ** 23 - 1) / 2 ** 23)
            .astype(np.float32))
    assert t["data"].buffer.dtype == torch.float32
    t.close()
