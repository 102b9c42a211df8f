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
    with pytest.raises(twav.WavError, match="FLAC"):
        twav.wav_info(flac)
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
