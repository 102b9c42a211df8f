"""The port's FLAC codec (``audian_torch.data.flac``) against the JAX
package's (``audian_tpu.data.flac``) and the committed golden files, in the
port's numpy path (the native library hidden) and its native path.

Codec outputs are integers and bytes: every comparison here is exact."""

from pathlib import Path

import numpy as np
import pytest

from audian_tpu import native as jnative
from audian_tpu.data import flac as jflac
from audian_tpu.data import wavio as jwav

from audian_torch import native as tnative
from audian_torch.data import flac as tflac
from audian_torch.data import wavio as twav

GOLDEN = Path(__file__).parent / "data" / "golden"
GOLDEN_NAMES = sorted(p.stem for p in GOLDEN.glob("*.flac"))
PATHS = ["numpy", "native"]


@pytest.fixture(params=PATHS)
def path_kind(request, monkeypatch):
    """Hide the native library of both packages for the numpy path; the
    native path requires the port's library to build here."""
    if request.param == "numpy":
        for mod in (tnative, jnative):
            monkeypatch.setattr(mod, "get_lib", lambda: None)
    else:
        assert tnative.available()
    tflac._OPEN.clear()
    jflac._OPEN.clear()
    yield request.param
    tflac._OPEN.clear()
    jflac._OPEN.clear()


def codes(rng, n, channels, bits):
    """Correlated integer codes at ``bits`` (LPC has work to do) with a
    few full-scale samples."""
    lim = 1 << (bits - 1)
    walk = np.cumsum(rng.normal(size=(n, channels)), axis=0)
    x = np.round(walk / np.abs(walk).max() * 0.7 * lim
                 + rng.normal(scale=lim / 200, size=(n, channels)))
    x[n // 3] = lim - 1
    x[n // 2] = -lim
    x = np.clip(x, -lim, lim - 1)
    return x.astype({8: np.int8, 16: np.int16, 24: np.int32}[bits])


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_golden_files_decode_exactly(path_kind, name):
    ref = np.load(GOLDEN / f"{name}.npz")
    ff = tflac._open(GOLDEN / f"{name}.flac")
    assert ff.sinfo["rate"] == int(ref["rate"])
    assert ff.sinfo["bits"] == int(ref["bits"])
    got = ff.read(0, ff.sinfo["total"])
    np.testing.assert_array_equal(got, ref["samples"].astype(np.int64))
    info = twav.wav_info(GOLDEN / f"{name}.flac")
    assert info == jwav.wav_info(GOLDEN / f"{name}.flac")
    assert info[3] == f"FLAC_{int(ref['bits'])}"


@pytest.mark.parametrize("channels", [1, 2, 4])
@pytest.mark.parametrize("bits", [8, 16, 24])
def test_write_flac_writes_the_jax_packages_bytes(tmp_path, path_kind, bits,
                                                  channels):
    """An odd length, tags: the same bytes as the JAX package's encoder on
    the same path, and a decode back to the codes."""
    q = codes(np.random.default_rng(bits + channels), 3001, channels, bits)
    md = {"Title": "port", "BEXT": {"CodingHistory": "A=PCM,F=8000"}}
    got, want = tmp_path / "t.flac", tmp_path / "j.flac"
    assert tflac.write_flac(got, q, 8000, metadata=md, bits=bits) == got
    jflac.write_flac(want, q, 8000, metadata=md, bits=bits)
    assert got.read_bytes() == want.read_bytes()
    ff = tflac._open(got)
    np.testing.assert_array_equal(ff.read(0, len(q)), q.astype(np.int64))
    assert tflac.flac_metadata(got) == jflac.flac_metadata(got)


def test_lazy_index_reads_equal_a_whole_decode(tmp_path, path_kind):
    rng = np.random.default_rng(5)
    q = codes(rng, 20000, 2, 16)
    p = tmp_path / "lazy.flac"
    tflac.write_flac(p, q, 48000, blocksize=1024)
    whole = tflac._FlacFile(p, index="eager").read(0, len(q))
    np.testing.assert_array_equal(whole, q.astype(np.int64))
    lazy = tflac._FlacFile(p, index="lazy")
    for _ in range(6):
        s = int(rng.integers(0, len(q)))
        m = int(rng.integers(1, 6000))
        np.testing.assert_array_equal(lazy.read(s, m), whole[s : s + m])
    np.testing.assert_array_equal(lazy.read(0, len(q)), whole)
    # the float reads of both packages agree
    np.testing.assert_array_equal(tflac.read_frames(p, 777, 4321),
                                  jflac.read_frames(p, 777, 4321))


def test_read_frames_raw16_gives_the_codes(tmp_path, path_kind):
    q = codes(np.random.default_rng(6), 9000, 3, 16)
    p = tmp_path / "r16.flac"
    tflac.write_flac(p, q, 48000)
    info = twav.wav_info(p)
    for start, n in ((0, 9000), (4095, 10), (8000, 2000)):
        got = np.zeros((n, 3), np.int16)
        want = np.zeros((n, 3), np.int16)
        kg = twav.read_frames_raw16(p, start, n, info, got)
        kw = jwav.read_frames_raw16(p, start, n, info, want)
        assert kg == kw == min(n, 9000 - start)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:kg], q[start : start + kg])
    p24 = tmp_path / "r24.flac"
    tflac.write_flac(p24, q.astype(np.int32) << 8, 48000, bits=24)
    info24 = twav.wav_info(p24)
    out = np.zeros((10, 3), np.int16)
    with pytest.raises(tflac.FlacError) as got:
        tflac.read_frames_raw16(p24, 0, 10, out)
    with pytest.raises(jflac.FlacError) as want:
        jflac.read_frames_raw16(p24, 0, 10, out)
    assert str(got.value) == str(want.value)
    with pytest.raises(twav.WavError, match="raw16 read needs PCM_16"):
        twav.read_frames_raw16(p24, 0, 10, info24, out)


def _corruptions(tmp_path):
    q = codes(np.random.default_rng(8), 12000, 2, 16)
    good = tmp_path / "good.flac"
    jflac.write_flac(good, q, 48000, blocksize=1024)
    raw = good.read_bytes()
    out = {"magic only": b"fLaC" + bytes(60), "truncated": raw[:300]}
    flipped = bytearray(raw)
    flipped[len(raw) // 2] ^= 0x5A
    out["flipped byte"] = bytes(flipped)
    out["no streaminfo"] = b"fLaC" + bytes([0x84, 0, 0, 4]) + bytes(4)
    return out


def test_corrupt_files_raise_the_jax_message(tmp_path, path_kind):
    for label, blob in _corruptions(tmp_path).items():
        p = tmp_path / f"{label.replace(' ', '_')}.flac"
        p.write_bytes(blob)

        def read(mod, wav):
            mod._OPEN.clear()
            info = wav.wav_info(p)
            return wav.read_frames(p, 0, info[2], info)

        with pytest.raises(tflac.FlacError) as got:
            read(tflac, twav)
        assert isinstance(got.value, twav.WavError)
        with pytest.raises(jflac.FlacError) as want:
            read(jflac, jwav)
        assert str(got.value) == str(want.value), label


def test_wavio_reads_flac_as_the_jax_package_does(tmp_path, path_kind):
    q = codes(np.random.default_rng(9), 5000, 2, 24)
    p = tmp_path / "meta.flac"
    md = {"Title": "flac", "BEXT": {"OriginationDate": "2026-01-02",
                                    "OriginationTime": "03:04:05"}}
    jwav.write_audio(p, q, 44100.0, metadata=md, encoding="PCM_24")
    assert twav.wav_info(p) == jwav.wav_info(p) == (44100.0, 2, 5000,
                                                    "FLAC_24", None)
    got, want = twav.scan_wav(p), jwav.scan_wav(p)
    assert got[:2] == want[:2]
    assert got[1]["BEXT.OriginationTime"] == "03:04:05"  # dotted tags
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)
    data, rate, tmd, locs, labels = twav.load_wav(p)
    jdata, jrate, jmd, _, _ = jwav.load_wav(p)
    assert rate == jrate and tmd == jmd and locs.shape == (0, 2)
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(data, q / 2.0 ** 23)
