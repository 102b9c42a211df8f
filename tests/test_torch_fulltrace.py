"""The port's overview (``audian_torch.cache.fulltrace.FullTraceData``)
against the JAX package's: the numpy scan equals the JAX package's
``_compute_python`` exactly, on one file (PCM-16, PCM-24, float, with and
without unwrap) and across files; the artifacts it saves next to the data
and in the JSON-indexed user cache are the JAX package's bytes and load
back, stale and corrupt entries are evicted, and ``close()`` cancels a
background run before it caches anything."""

import json
import time

import numpy as np
import pytest

from audian_tpu.cache import fulltrace as jft
from audian_tpu.data import wavio as jwav
from audian_tpu.data.loader import AudioLoader as JLoader
from audian_tpu import version as jversion

from audian_torch.cache import fulltrace as tft
from audian_torch import version as tversion
from audian_torch.data.loader import AudioLoader


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


def signal(rng, n, channels=2):
    return (0.4 * rng.standard_normal((n, channels))).clip(-1, 1)


@pytest.fixture()
def wav(tmp_path, rng):
    x = signal(rng, 48000)
    p = tmp_path / "rec.wav"
    jwav.write_audio(p, x, 48000, encoding="FLOAT")
    return p


def full_trace(ft_mod, loader):
    if ft_mod is tft:
        return tft.FullTraceData(loader, device="cpu")
    return jft.FullTraceData(loader)


def overview(ft_mod, loader, max_pixel=100):
    ft = full_trace(ft_mod, loader)
    ft.start(max_pixel, background=False)
    return ft


@pytest.mark.parametrize("encoding,unwrap", [
    ("PCM_16", 0.0), ("PCM_24", 0.0), ("FLOAT", 0.0), ("PCM_16", 1.2)])
def test_overview_equals_jax_compute_python(tmp_path, rng, encoding,
                                            unwrap):
    x = signal(rng, 70001, 3)
    if unwrap:
        x[30000:30500] = np.clip(x[30000:30500] + 0.95, -1, 1)
    p = tmp_path / f"r-{encoding}.wav"
    jwav.write_audio(p, x, 48000, encoding=encoding)
    t = AudioLoader(p, buffer_time=0.1, back_time=0.0)
    j = JLoader(p, buffer_time=0.1, back_time=0.0)
    if unwrap:
        t.set_unwrap(unwrap)
        j.set_unwrap(unwrap)
    ft = overview(tft, t, 300)
    assert not ft.short_data and ft.error is None
    jref = jft.FullTraceData(j)
    want = jref._compute_python(0, ft.step)
    np.testing.assert_array_equal(ft.datas, want)
    np.testing.assert_array_equal(ft.times, overview(jft, j, 300).times)
    t.close()
    j.close()


def test_multifile_overview_equals_jax(tmp_path, rng):
    x = signal(rng, 50001)
    paths = []
    for k, sl in enumerate((x[:20001], x[20001:])):
        p = tmp_path / f"m{k}.wav"
        jwav.write_audio(p, sl, 48000, encoding="PCM_16")
        paths.append(p)
    t = AudioLoader(paths, buffer_time=0.1, back_time=0.0)
    j = JLoader(paths, buffer_time=0.1, back_time=0.0)
    got, want = overview(tft, t, 40), overview(jft, j, 40)
    np.testing.assert_array_equal(got.datas, want.datas)
    step = got.step
    flat = t._read_direct(0, t.frames)
    np.testing.assert_array_equal(got.datas,
                                  tft._interleaved_minmax(flat, step))


def test_short_recording_and_interleaved_minmax(wav, rng):
    """A recording the loader's window holds whole is reduced at once
    from that window, on the overview's device."""
    t, j = AudioLoader(wav), JLoader(wav)
    t.update_time(0.0, 1.0)
    j.update_time(0.0, 1.0)
    ft = overview(tft, t)
    assert ft.short_data and ft._thread is None
    np.testing.assert_array_equal(ft.datas, overview(jft, j).datas)
    for n, step in ((1000, 64), (1000, 1000), (5, 7), (64, 64), (65, 64),
                    (0, 3)):
        buf = rng.standard_normal((n, 3))
        np.testing.assert_array_equal(tft._interleaved_minmax(buf, step),
                                      jft._interleaved_minmax(buf, step))


def test_local_artifact_is_the_jax_packages(wav, tmp_path):
    ft = overview(tft, AudioLoader(wav, buffer_time=0.1, back_time=0.0))
    ft.short_data = False
    path = ft.save_data_local()
    assert path.name == "rec-fulltrace.wav"
    mine = path.read_bytes()
    jf = overview(jft, JLoader(wav, buffer_time=0.1, back_time=0.0))
    jf.short_data = False
    assert jf.save_data_local() == path
    assert path.read_bytes() == mine
    for mod, loader in ((tft, AudioLoader), (jft, JLoader)):
        back = full_trace(mod, loader(wav))
        assert back.load_data()
        np.testing.assert_array_equal(back.datas, ft.datas)
        np.testing.assert_allclose(back.times, ft.times, rtol=1e-6)
    # a corrupt local artifact is ignored, not fatal
    path.write_bytes(mine[:40])
    assert not full_trace(tft, AudioLoader(wav)).load_data()


def test_user_cache_roundtrip_and_eviction(wav, tmp_path, monkeypatch):
    class Dirs:
        user_cache_path = tmp_path / "cache"

    monkeypatch.setattr(tft, "audian_dirs", Dirs)
    ft = overview(tft, AudioLoader(wav, buffer_time=0.1, back_time=0.0))
    ft.short_data = False
    saved = ft.save_data()
    assert saved.parent == Dirs.user_cache_path and saved.exists()
    index = json.loads((Dirs.user_cache_path / "fulltraces.json")
                       .read_text())
    (name, props), = index.items()
    assert name == saved.name and props["first"].endswith("rec.wav")
    back = full_trace(tft, AudioLoader(wav))
    assert back.load_data()
    np.testing.assert_array_equal(back.datas, ft.datas)
    # saving again updates the same entry; the LRU keeps max_files
    assert ft.save_data() == saved
    # a stale (changed on disk) recording and a corrupt artifact evict
    saved.write_bytes(saved.read_bytes()[:40])
    assert not full_trace(tft, AudioLoader(wav)).load_data()
    assert not saved.exists()
    assert json.loads((Dirs.user_cache_path / "fulltraces.json")
                      .read_text()) == {}


def test_background_run_saves_and_close_cancels(tmp_path, rng,
                                                monkeypatch):
    class Dirs:
        user_cache_path = tmp_path / "cache"

    monkeypatch.setattr(tft, "audian_dirs", Dirs)
    x = signal(rng, 40001, 1)
    paths = []
    for k, sl in enumerate((x[:20001], x[20001:])):
        p = tmp_path / f"c{k}.wav"
        jwav.write_audio(p, sl, 48000, encoding="FLOAT")
        paths.append(p)
    ft = full_trace(tft, AudioLoader(paths, buffer_time=0.1,
                                     back_time=0.0))
    ft.start(10, background=True)
    ft.wait()
    assert not ft.is_busy() and ft.error is None
    np.testing.assert_array_equal(
        ft.datas, overview(jft, JLoader(paths, buffer_time=0.1,
                                        back_time=0.0), 10).datas)
    assert full_trace(tft, AudioLoader(paths)).load_data()
    # a slow scan of 4 blocks, closed mid-run, stops after its in-flight
    # block and caches nothing.  The first file ends off the segment grid
    # (step 2), so the scan reads blocks of the joined stream through
    # _read_direct: on the grid, the native scan would take the files
    # whole and might finish before the close
    for f in Dirs.user_cache_path.iterdir():
        f.unlink()
    long = []
    for k, n in enumerate((1_600_001, 1_599_999)):
        p = tmp_path / f"long{k}.wav"
        jwav.write_audio(p, np.zeros((n, 1), np.int16), 48000,
                         encoding="PCM_16")
        long.append(p)
    reads = []
    real = AudioLoader._read_direct

    def slow_read(self, start, n, out=None):
        reads.append(start)
        time.sleep(0.2)
        return real(self, start, n, out=out)

    monkeypatch.setattr(AudioLoader, "_read_direct", slow_read)
    ft = full_trace(tft, AudioLoader(long, buffer_time=0.1,
                                     back_time=0.0))
    ft.start(1_600_000, background=True)
    time.sleep(0.05)
    ft.close()
    time.sleep(0.3)
    assert not ft.is_busy() and ft._cancelled
    assert len(reads) <= 2 < -(-3_200_000 // (1 << 20))
    assert not (Dirs.user_cache_path / "fulltraces.json").exists()


def test_cache_dir_is_the_ports_own():
    assert tversion.APPNAME == "audian-torch"
    path = tversion.audian_dirs.user_cache_path
    assert path.name == "audian-torch"
    assert path != jversion.audian_dirs.user_cache_path
