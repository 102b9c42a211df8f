"""``audian-compress`` of the port (``audian_torch.cli.compress``) against
the JAX package's (``audian_tpu.cli.compress``): the same
``<stem>-fulltrace.wav`` values on a WAV (the native scan), a 16-bit FLAC
(the numpy scan of the decoded frames), a multi-file recording whose
boundaries fall on the segment grid (the native scan file by file), one
whose boundaries do not, and an unwrapped recording; the exit status of an
unreadable file.  The overviews are compared exactly, and with numpy's
interleaved min/max of the recording's float32 samples."""

import shutil

import numpy as np
import pytest

from audian_tpu.cli import compress as jcompress
from audian_tpu.data import wavio as jwav

from audian_torch.cache.fulltrace import _interleaved_minmax
from audian_torch.cli import compress as tcompress
from audian_torch.data import AudioLoader, wavio as twav

RATE = 8000.0
PIXELS = 100
#: loader window: shorter than every recording here, so that the overview
#: is scanned from the files and not reduced from the window
LOAD = ["-i", "buffer_time=0.5,back_time=0.1"]


def _codes(rng, n, channels=2):
    t = np.arange(n)[:, None] / RATE
    x = 0.5 * np.sin(2 * np.pi * 440.0 * t * (1 + np.arange(channels)))
    x += 0.1 * rng.standard_normal((n, channels))
    return np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)


def _recording(tmp_path, kind):
    """The files of one recording of ``kind`` and the CLI's extra args."""
    rng = np.random.default_rng(len(kind))
    if kind == "wav":
        names, parts, args = ["rec.wav"], [_codes(rng, 48000)], []
    elif kind == "flac16":
        names, parts, args = ["rec.flac"], [_codes(rng, 48000)], []
    elif kind == "aligned":   # 24000 frames = 50 steps of 480
        names, args = ["a.wav", "b.wav"], []
        parts = [_codes(rng, 24000), _codes(rng, 24000)]
    elif kind == "unaligned":
        names, args = ["a.wav", "b.wav"], []
        parts = [_codes(rng, 23999), _codes(rng, 24001)]
    else:                     # "unwrap": a signal that wraps around
        x = _codes(rng, 48000).astype(np.int32) * 3
        wrapped = ((x + 32768) % 65536 - 32768).astype(np.int16)
        names, parts, args = ["rec.wav"], [wrapped], ["-u", "1.5"]
    paths = []
    for name, q in zip(names, parts):
        p = tmp_path / name
        jwav.write_audio(p, q, RATE, encoding="PCM_16")
        paths.append(p)
    return paths, args


@pytest.mark.parametrize("kind", ["wav", "flac16", "aligned", "unaligned",
                                  "unwrap"])
def test_fulltrace_equals_the_jax_clis(tmp_path, kind, capsys):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    paths, args = _recording(tmp_path / "t", kind)
    for p in paths:
        shutil.copy(p, tmp_path / "j" / p.name)
    jpaths = [tmp_path / "j" / p.name for p in paths]
    assert tcompress.main([*LOAD, "-p", str(PIXELS), *args,
                           *map(str, paths)], device="cpu") == 0
    assert jcompress.main([*LOAD, "-p", str(PIXELS), *args,
                           *map(str, jpaths)]) == 0
    out = paths[0].with_name(paths[0].stem + "-fulltrace.wav")
    assert f"saved fulltrace to {out}" in capsys.readouterr().out
    got, grate = twav.load_audio(out)
    want, wrate = jwav.load_audio(jpaths[0].with_name(out.name))
    assert grate == wrate
    np.testing.assert_array_equal(got, want)
    if kind != "unwrap":
        ld = AudioLoader(paths, prefetch=False)
        samples = ld[0 : ld.frames]
        step = ld.frames // PIXELS
        np.testing.assert_array_equal(got, _interleaved_minmax(samples, step))
        ld.close()


def test_unreadable_file_returns_1(tmp_path, capsys):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF0000WAVEjunk")
    missing = tmp_path / "missing.wav"
    for path in (bad, missing):
        assert tcompress.main([str(path)], device="cpu") == 1
        err = capsys.readouterr().err
        assert jcompress.main([str(path)]) == 1
        assert err == capsys.readouterr().err
        assert err.startswith("error: ")
    with pytest.raises(SystemExit) as e:
        tcompress.main(["--version"], device="cpu")
    assert e.value.code == 0


@pytest.mark.parametrize("pairs", [[], ["a=1,b=2.5"], ["x=y", "n=-3,,"]])
def test_parse_load_kwargs_equals_jax(pairs):
    assert tcompress.parse_load_kwargs(pairs) == \
        jcompress.parse_load_kwargs(pairs)
