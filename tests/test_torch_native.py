"""The port's native host runtime (``audian_torch.native``) against the JAX
package's bindings (``audian_tpu.native``) and numpy: frame reads, the
min/max overviews, the FLAC frame decoder; the fallback without a
compiler; and the build into ``build/``, once, when processes race to it.

Every comparison is exact: the two libraries are built from the same
sources, and numpy's reductions pick the same samples."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from audian_tpu import native as jnative
from audian_tpu.data import flac as jflac
from audian_tpu.data import wavio as jwav

from audian_torch import native as tnative
from audian_torch.cache.fulltrace import FullTraceData
from audian_torch.cache.fulltrace import _interleaved_minmax
from audian_torch.data import AudioLoader
from audian_torch.data import flac as tflac
from audian_torch.data import wavio as twav

REPO = Path(__file__).resolve().parents[1]
ENCODINGS = ["PCM_16", "PCM_24", "PCM_32", "FLOAT", "DOUBLE"]


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(31)
    return np.clip(0.3 * rng.standard_normal((12345, 3)), -1.0, 0.99)


def _wav(tmp_path, x, encoding):
    p = tmp_path / f"{encoding}.wav"
    jwav.write_audio(p, x, 48000.0, encoding=encoding)
    return p, twav.wav_info(p)


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_read_frames_equals_jax_and_numpy(tmp_path, x, encoding):
    p, info = _wav(tmp_path, x, encoding)
    _, channels, frames, enc, off = info
    for start, n in ((0, frames), (1001, 4000), (frames - 5, 50)):
        got = tnative.read_frames(p, off, enc, channels, start, n)
        want = jnative.read_frames(p, off, enc, channels, start, n)
        np.testing.assert_array_equal(got, want)
        ref = twav.read_frames(p, start, n, info).astype(np.float32)
        np.testing.assert_array_equal(got, ref)
    out = np.empty((100, channels), np.float32)
    got = tnative.read_frames(p, off, enc, channels, 7, 100, out=out)
    assert np.shares_memory(got, out)
    np.testing.assert_array_equal(
        out, twav.read_frames(p, 7, 100, info).astype(np.float32))
    with pytest.raises(ValueError, match="out must be"):
        tnative.read_frames(p, off, enc, channels, 0, 10,
                            out=np.empty((10, channels), np.float64))


def test_minmax_equals_jax_and_numpy(x):
    xf = x.astype(np.float32)
    for step in (1, 7, 64, 12345, 20000):
        got = tnative.minmax(xf, step)
        np.testing.assert_array_equal(got, jnative.minmax(xf, step))
        np.testing.assert_array_equal(got, _interleaved_minmax(xf, step))


@pytest.mark.parametrize("encoding", ["PCM_16", "FLOAT"])
def test_file_minmax_equals_jax_and_numpy(tmp_path, x, encoding):
    p, (_, channels, frames, enc, off) = _wav(tmp_path, x, encoding)
    data = twav.read_frames(p, 0, frames).astype(np.float32)
    for step, nthreads in ((50, 1), (50, 3), (999, 2)):
        got = tnative.file_minmax(p, off, enc, channels, frames, step,
                                  nthreads=nthreads)
        np.testing.assert_array_equal(
            got, jnative.file_minmax(p, off, enc, channels, frames, step,
                                     nthreads=nthreads))
        np.testing.assert_array_equal(got, _interleaved_minmax(data, step))
    # a slice from a step-aligned start covers its own segments
    part = tnative.file_minmax(p, off, enc, channels, 5000, 50, start=3000)
    np.testing.assert_array_equal(part,
                                  _interleaved_minmax(data[3000:8000], 50))


def test_flac_frame_decoder_equals_jax(tmp_path, x):
    q = np.round(x * 32767).astype(np.int16)
    p = tmp_path / "frames.flac"
    jflac.write_flac(p, q, 48000, blocksize=2048)
    jflac._OPEN.clear()
    ff = jflac._FlacFile(p, index="eager")
    buf = bytes(ff.buf)
    rows = 0
    for off in ff.offsets:
        got = tnative.flac_decode_frame_meta(buf, int(off), ff.sinfo)
        want = jnative.flac_decode_frame_meta(buf, int(off), ff.sinfo)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] and got[1] == rows
        np.testing.assert_array_equal(got[0], q[rows : rows + len(got[0])])
        rows += len(got[0])
    assert rows == len(q)
    # a frame offset that is not a frame
    assert tnative.flac_decode_frame(buf, int(ff.offsets[1]) + 3,
                                     ff.sinfo) is None
    # the native encoder gives the JAX native encoder's stream
    assert tnative.flac_encode(q, 48000, 16) == jnative.flac_encode(
        q, 48000, 16)


def test_missing_compiler_gives_none_and_callers_fall_back(
        tmp_path, monkeypatch, x):
    """With ``CXX`` naming no compiler the loaders return None (nothing is
    built, nothing raises) and every caller takes its numpy path."""
    for name, value in (("_lib", None), ("_tried", False), ("_ffm", None),
                        ("_ffm_tried", False),
                        ("_ROOT", tmp_path / "build")):
        monkeypatch.setattr(tnative, name, value)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert tnative.get_lib() is None and not tnative.available()
    assert tnative.get_ffm() is None and not tnative.ffm_available()
    assert tnative.ffm_probable() is False
    assert not list((tmp_path / "build").rglob("*.so"))
    p, (_, channels, frames, enc, off) = _wav(tmp_path, x, "PCM_16")
    xf = x.astype(np.float32)
    assert tnative.read_frames(p, off, enc, channels, 0, 10) is None
    assert tnative.minmax(xf, 4) is None
    assert tnative.file_minmax(p, off, enc, channels, frames, 4) is None
    assert tnative.flac_encode(np.zeros((16, 1), np.int32), 8000, 16) is None
    assert tnative.ff_audio_decode(p) is None
    assert tnative.ff_audio_encode(tmp_path / "x.ogg", xf, 8000.0) is False
    # the callers: loader reads, the FLAC codec, the overview scan
    ld = AudioLoader(p, buffer_time=0.05, prefetch=False)
    np.testing.assert_array_equal(ld[100:2100], jwav.read_frames(
        p, 100, 2000).astype(np.float32))
    ft = FullTraceData(ld, device="cpu")
    ft.start(100, background=False)
    assert ft.error is None
    np.testing.assert_array_equal(ft.datas, _interleaved_minmax(
        jwav.read_frames(p, 0, frames).astype(np.float32), ft.step))
    ld.close()
    q = np.round(x[:3000] * 32767).astype(np.int16)
    fp = tmp_path / "py.flac"
    tflac.write_flac(fp, q, 8000)
    tflac._OPEN.clear()
    np.testing.assert_array_equal(tflac._open(fp).read(0, 3000), q)
    with pytest.raises(twav.WavError, match="FFmpeg"):
        twav.write_audio(tmp_path / "x.ogg", xf, 8000.0)


def test_racing_first_uses_build_once_into_build(tmp_path):
    """Two processes that use the library first at the same moment: one
    compiler run, one library in the build directory, none in the
    package.  (The build directory is moved to a temporary one and the
    flags cut to -O0 so that the race is short.)"""
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        from audian_torch import native
        native._ROOT = Path({str(tmp_path)!r})
        native._FLAGS = ("-O0", "-shared", "-fPIC", "-pthread")
        sys.stdin.readline()          # both start together
        assert native.available()
        print(native.get_lib()._name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate("go\n", timeout=120) for p in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
    libs = list(tmp_path.rglob("*.so"))
    assert len(libs) == 1 and libs[0].name == "libaudianative.so"
    assert {o.strip() for o, _ in outs} == {str(libs[0])}
    log = (libs[0].parent / "build.log").read_text()
    assert log.count("pid ") == 1, log
    assert not list(tmp_path.rglob("*.tmp"))
    assert not list((REPO / "audian_torch" / "native").glob("*.so"))
    # the library in use lies under build/ beside the package
    assert tnative.available()
    built = Path(tnative.get_lib()._name)
    assert built.is_relative_to(REPO / "build" / "audian_torch" / "native")
    assert built.parent == tnative.build_dir()
