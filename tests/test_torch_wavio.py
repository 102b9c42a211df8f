"""audian_torch's raw PCM-16 reader against the JAX package's ``wavio`` on
WAV and RF64 files that the JAX ``write_audio`` writes: header scans and
int16 reads are bit-exact."""

import numpy as np
import pytest

from audian_tpu.data import wavio as jwav

from audian_torch.data import wavio as twav


@pytest.fixture(scope="module")
def pcm():
    rng = np.random.default_rng(21)
    return rng.integers(-32768, 32768, size=(5000, 3)).astype(np.int16)


@pytest.mark.parametrize("fmt", ["WAV", "RF64"])
def test_wav_info_and_raw16_match(tmp_path, pcm, fmt):
    path = tmp_path / f"x_{fmt}.wav"
    jwav.write_audio(path, pcm, 48000.0, encoding="PCM_16", format=fmt,
                     metadata={"INFO": {"Comment": "raw16"}})
    with path.open("rb") as f:
        assert f.read(4) == (b"RF64" if fmt == "RF64" else b"RIFF")
    info = twav.wav_info(path)
    assert info == jwav.wav_info(path)
    assert info[:4] == (48000.0, 3, 5000, "PCM_16")
    for start, nframes in ((0, 5000), (17, 1000), (4900, 300), (6000, 10)):
        got = np.zeros((nframes, 3), np.int16)
        want = np.zeros((nframes, 3), np.int16)
        kg = twav.read_frames_raw16(path, start, nframes, info, got)
        kw = jwav.read_frames_raw16(path, start, nframes, info, want)
        assert kg == kw == max(0, min(nframes, 5000 - start))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:kg], pcm[start : start + kg])


def test_non_pcm16_and_flac_raise(tmp_path, pcm):
    """A FLOAT WAV and a 24-bit FLAC have no int16 codes to read and
    raise; a 16-bit FLAC reads its codes as the JAX package does; junk is
    refused."""
    path = tmp_path / "f.wav"
    jwav.write_audio(path, pcm.astype(np.float32) / 32768.0, 8000.0,
                     encoding="FLOAT")
    info = twav.wav_info(path)
    assert info == jwav.wav_info(path)
    out = np.zeros((10, 3), np.int16)
    with pytest.raises(twav.WavError, match="PCM_16"):
        twav.read_frames_raw16(path, 0, 10, info, out)
    flac = tmp_path / "x.flac"
    jwav.write_audio(flac, pcm, 8000.0, encoding="PCM_16", format="FLAC")
    info = twav.wav_info(flac)
    assert info == jwav.wav_info(flac) == (8000.0, 3, 5000, "FLAC_16", None)
    got, want = np.zeros((300, 3), np.int16), np.zeros((300, 3), np.int16)
    assert twav.read_frames_raw16(flac, 4800, 300, info, got) == \
        jwav.read_frames_raw16(flac, 4800, 300, info, want) == 200
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:200], pcm[4800:])
    flac24 = tmp_path / "x24.flac"
    jwav.write_audio(flac24, pcm, 8000.0, encoding="PCM_24")
    with pytest.raises(twav.WavError, match="PCM_16"):
        twav.read_frames_raw16(flac24, 0, 10, twav.wav_info(flac24), out)
    junk = tmp_path / "junk.wav"
    junk.write_bytes(b"not a wave file at all")
    with pytest.raises(twav.WavError):
        twav.wav_info(junk)


def test_bad_out_buffer_raises(tmp_path, pcm):
    path = tmp_path / "x.wav"
    jwav.write_audio(path, pcm, 8000.0, encoding="PCM_16")
    info = twav.wav_info(path)
    for out in (np.zeros((10, 2), np.int16), np.zeros((5, 3), np.int16),
                np.zeros((10, 3), np.int32),
                np.zeros((3, 10), np.int16).T):
        with pytest.raises(ValueError, match="out must be"):
            twav.read_frames_raw16(path, 0, 10, info, out)


WRITE_MD = {"BEXT": {"Description": "field", "OriginationDate": "2026-03-04",
                     "OriginationTime": "05:06:07", "TimeReference": 96000,
                     "CodingHistory": "A=PCM,F=48000,W=16,M=3ch"},
            "Comment": "writers", "Artist": "audian", "IXYZ": "four"}


@pytest.mark.parametrize("encoding", ["PCM_16", "PCM_24", "PCM_32",
                                      "PCM_U8", "FLOAT", "DOUBLE"])
@pytest.mark.parametrize("fmt", ["WAV", "RF64"])
def test_write_audio_writes_the_jax_packages_bytes(tmp_path, pcm, encoding,
                                                   fmt):
    """The port's ``write_audio`` (the region export's writer) writes the
    bytes of the JAX package's, metadata and markers included, for int16
    codes and for floats; and reads them back to the same values."""
    x = np.random.default_rng(3).uniform(-1.0, 1.0, (777, 3))
    locs = np.array([[10, 5], [300, 0], [700, 77]])
    labels = np.array([["song", "trill"], ["start", ""], ["", "note"]],
                      dtype=object)
    for data in (pcm[:777], x):
        got, want = tmp_path / "t.wav", tmp_path / "j.wav"
        assert twav.write_audio(got, data, 48000.0, metadata=WRITE_MD,
                                locs=locs, labels=labels, encoding=encoding,
                                format=fmt) == got
        jwav.write_audio(want, data, 48000.0, metadata=WRITE_MD, locs=locs,
                         labels=labels, encoding=encoding, format=fmt)
        assert got.read_bytes() == want.read_bytes()
        back, rate = twav.load_audio(got)
        jback, jrate = jwav.load_audio(got)
        assert rate == jrate == 48000.0
        np.testing.assert_array_equal(back, jback)
        assert twav.scan_wav(got)[1] == jwav.scan_wav(got)[1]


def test_metadata_helpers_equal_jax(tmp_path, pcm):
    import copy

    for fmt in ("WAV", "FLAC", None):
        assert twav.available_encodings(fmt) == jwav.available_encodings(fmt)
    for args in (("PCM_24", 96000.0, 1), ("FLOAT", 44100.4, 2),
                 ("FLAC_16", 48000, 16), (None, 8000, 3)):
        assert twav.bext_history_str(*args) == jwav.bext_history_str(*args)
        assert twav.bext_history_str(*args, text="cut") == \
            jwav.bext_history_str(*args, text="cut")
    for md in (WRITE_MD, {"Date": "2026-01-02T03:04:05"}, {}):
        a, b = copy.deepcopy(md), copy.deepcopy(md)
        assert twav.update_starttime(a, 61.25, 48000.0) == \
            jwav.update_starttime(b, 61.25, 48000.0)
        for key in ("CodingHistory", "BEXT.CodingHistory"):
            assert twav.add_history(a, "x", key, "pre") == \
                jwav.add_history(b, "x", key, "pre")
    # FLAC by suffix and by format: the JAX package's bytes
    for name, kw in (("x.flac", {}), ("x.wav", {"format": "FLAC"})):
        got, want = tmp_path / f"t_{name}", tmp_path / f"j_{name}"
        assert twav.write_audio(got, pcm, 48000.0, **kw) == got
        jwav.write_audio(want, pcm, 48000.0, **kw)
        assert got.read_bytes()[:4] == b"fLaC"
        assert got.read_bytes() == want.read_bytes()
    with pytest.raises(ValueError, match="unsupported format"):
        twav.write_audio(tmp_path / "x.wav", pcm, 48000.0, format="XYZ")
    with pytest.raises(twav.WavError, match="unsigned"):
        twav.write_audio(tmp_path / "x.wav", pcm.astype(np.uint16), 48000.0)


@pytest.mark.parametrize("promote", [False, True])
@pytest.mark.parametrize("encoding", ["PCM_16", "PCM_24", "FLOAT"])
def test_wav_writer_writes_the_jax_packages_bytes(tmp_path, pcm, monkeypatch,
                                                  encoding, promote):
    """Blocks appended one by one, a sparse gap, and (with the RIFF cap
    lowered) the promotion to RF64 at close."""
    if promote:
        for mod in (twav, jwav):
            monkeypatch.setattr(mod, "_RIFF_MAX", 4000)
    x = pcm[:1001] if encoding == "PCM_16" else pcm[:1001] / 32768.0
    paths = []
    for mod, name in ((twav, "t.wav"), (jwav, "j.wav")):
        with mod.WavWriter(tmp_path / name, 22050.0, 3, encoding) as w:
            w.write(x[:500]).skip_frames(17)
            w.write(x[500:])
            assert w.frames == 1018
        paths.append(tmp_path / name)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert paths[0].read_bytes()[:4] == (b"RF64" if promote else b"RIFF")
    back, rate = twav.load_audio(paths[0])
    assert rate == 22050.0 and back.shape == (1018, 3)
    np.testing.assert_array_equal(back[500:517], 0.0)


@pytest.mark.parametrize("fmt", ["OGG", "AIFF"])
def test_other_containers_go_through_ffmpeg_as_in_jax(tmp_path, pcm, fmt):
    """Where the system FFmpeg libraries are present both packages write
    and read the container through them (the same samples back);
    where they are not, both refuse with the same message."""
    from audian_tpu import native as jnative

    assert twav.available_formats() == jwav.available_formats()
    got, want = tmp_path / f"t.{fmt.lower()}", tmp_path / f"j.{fmt.lower()}"
    if not jnative.ffm_available():
        with pytest.raises(twav.WavError) as e:
            twav.write_audio(got, pcm, 48000.0)
        with pytest.raises(jwav.WavError) as je:
            jwav.write_audio(got, pcm, 48000.0)
        assert str(e.value) == str(je.value)
        return
    assert twav.write_audio(got, pcm, 48000.0, format=fmt) == got
    jwav.write_audio(want, pcm, 48000.0, format=fmt)
    assert twav.wav_info(got) == jwav.wav_info(want)
    np.testing.assert_array_equal(twav.load_audio(got)[0],
                                  jwav.load_audio(want)[0])
    with pytest.raises(ValueError, match="cue-marker"):
        twav.write_audio(got, pcm, 48000.0, locs=[[1, 0]])
