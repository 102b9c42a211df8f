"""ctypes bindings of the native host runtime: bulk PCM decode, threaded
min/max overviews and the FLAC frame decoder and encoder
(``wavio.cc``, ``flacdec.cc``, ``flacenc.cc``), plus the optional FFmpeg
shim (``ffflac.cc``).

The counterpart of ``audian_tpu/native``.  The libraries are built with
the system C++ compiler (``$CXX``, ``g++`` by default) at first use, never
at import, into ``build/audian_torch/native/<hash>/`` beside the package.
The hash covers the sources, the compiler, its flags and the host CPU
(the flags say ``-march=native``), so an edit rebuilds and an unchanged
tree reuses the library.  Concurrent first uses (threads, or processes
such as test workers) build once: a file lock serialises the build and
the library is renamed into place whole.

This is host code that feeds the card.  Where the library cannot be
built (no compiler) the loaders return None and every caller falls back
to numpy; where the FFmpeg development files are missing, the FFmpeg
shim is absent and the formats it adds are not offered.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["FF_EXPORT_FORMATS", "available", "build_dir", "ff_audio_decode",
           "ff_audio_encode", "ff_flac_decode", "ff_flac_encode",
           "ffm_available", "ffm_probable", "file_minmax", "flac_decode_frame",
           "flac_decode_frame_meta", "flac_encode", "get_ffm", "get_lib",
           "minmax", "read_frames"]

_HERE = Path(__file__).resolve().parent
#: where the libraries are built: ``build/audian_torch/native`` beside
#: the package
_ROOT = _HERE.parents[1] / "build" / "audian_torch" / "native"
_SRCS = (_HERE / "wavio.cc", _HERE / "flacdec.cc", _HERE / "flacenc.cc")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
_LIBS = ()
_FFM_SRCS = (_HERE / "ffflac.cc",)
_FFM_FLAGS = ("-O2", "-shared", "-fPIC")
_FFM_LIBS = ("-lavcodec", "-lavformat", "-lavutil")

_lock = threading.Lock()
_lib = None
_tried = False
_ffm = None
_ffm_tried = False

_TAGS = {"PCM_16": (1, 16), "PCM_24": (1, 24), "PCM_32": (1, 32),
         "FLOAT": (3, 32), "DOUBLE": (3, 64)}


def _cxx():
    return os.environ.get("CXX", "g++")


def _cpu_id():
    """The host CPU's model and feature flags (``-march=native`` builds for
    them), or '' where /proc/cpuinfo is not readable."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return ""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2])


def build_dir(srcs=_SRCS, flags=_FLAGS, libs=_LIBS):
    """The directory of the library built from ``srcs`` with ``flags``
    by the current compiler on this CPU."""
    digest = hashlib.sha256(
        "\0".join([_cxx(), *flags, *libs, _cpu_id()]).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return _ROOT / digest.hexdigest()[:16]


def _build_once(name, srcs, flags, libs):
    """Path of ``name`` built from ``srcs``, compiling it first if no
    process has; raises where the compiler fails."""
    out = build_dir(srcs, flags, libs) / name
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out
        tag = f"{os.getpid()}.tmp"
        tmp = out.with_name(f"{name}.{tag}")
        objs = [out.with_name(f"{src.stem}.{tag}.o") for src in srcs]
        # one compiler process a source, all started together, then the
        # link
        cmds = [[_cxx(), *flags, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(srcs, objs)]
        try:
            with open(out.parent / "build.log", "a") as log:
                log.write(f"pid {os.getpid()}: building {name}\n")
                _run(cmds, log)
                _run([[_cxx(), *flags, *map(str, objs), "-o", str(tmp),
                       *libs]], log)
            os.replace(tmp, out)
        finally:
            for f in (*objs, tmp):
                f.unlink(missing_ok=True)
    return out


def _run(cmds, log):
    """Run the commands at once, logging each one's output; raise if any
    fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    for cmd, proc in zip(cmds, procs):
        log.write(" ".join(cmd) + "\n" + proc.communicate()[0])
    for cmd, proc in zip(cmds, procs):
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed ({proc.returncode})")


def _bind(lib, signatures):
    for name, (args, res) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


_P = ctypes.POINTER
_F32, _F64 = _P(ctypes.c_float), _P(ctypes.c_double)
_I32, _I64 = _P(ctypes.c_int32), _P(ctypes.c_int64)
_i, _i64, _s = ctypes.c_int, ctypes.c_int64, ctypes.c_char_p
_SIGNATURES = {
    "an_read_frames": ([_s, _i64, _i, _i, _i, _i64, _i64, _F32], _i64),
    "an_minmax": ([_F32, _i64, _i, _i64, _F64], None),
    "an_file_minmax": ([_s, _i64, _i, _i, _i, _i64, _i64, _i, _F64], _i),
    "an_flac_encode": ([_I32, _i64, _i, _i, _i, _i, _i,
                        _P(ctypes.c_uint8), _i64], _i64),
    "an_flac_decode_frame": ([ctypes.c_void_p, _i64, _i64, _i, _i, _i, _i,
                              _i, _I32, _I64, _I64], _i64),
}
_LL = ctypes.c_longlong
_FFM_SIGNATURES = {
    "ffp_audio_read": ([_s, _P(_F32), _P(_i), _P(_i), _P(_LL)], _i),
    "ffp_audio_release": ([_F32], None),
    "ffp_flac_info": ([_s, _P(_i), _P(_i), _P(_i), _P(_LL)], _i),
    "ffp_flac_decode": ([_s, _I32, _LL], _LL),
    "ffp_flac_encode": ([_s, _I32, _LL, _i, _i, _i, _i], _i),
    "ffp_audio_encode": ([_s, _F32, _LL, _i, _i, _s, _s], _i),
}


def get_lib():
    """The loaded native library, built on demand; None when it cannot be
    built or loaded (callers fall back to numpy)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = _build_once("libaudianative.so", _SRCS, _FLAGS, _LIBS)
            _lib = _bind(ctypes.CDLL(str(path)), _SIGNATURES)
        except Exception:
            return None
        return _lib


def available():
    return get_lib() is not None


def get_ffm():
    """The FFmpeg shim (``ffflac.cc``), built on demand against the system
    libavcodec/libavformat; None when the FFmpeg development files are
    absent.  It adds the containers the in-repo WAV and FLAC codecs do
    not read or write, and an independent FLAC codec for the tests."""
    global _ffm, _ffm_tried
    with _lock:
        if _ffm is not None or _ffm_tried:
            return _ffm
        _ffm_tried = True
        try:
            path = _build_once("libaudianffm.so", _FFM_SRCS, _FFM_FLAGS,
                               _FFM_LIBS)
            _ffm = _bind(ctypes.CDLL(str(path)), _FFM_SIGNATURES)
        except Exception:
            return None
        return _ffm


def ffm_available():
    return get_ffm() is not None


def ffm_probable():
    """Whether the FFmpeg shim is likely to work, answered without
    starting a build (a listing of formats must not wait for a compiler):
    True when it is loaded, already built, or the system libraries are
    findable; False after a failed attempt."""
    if _ffm is not None:
        return True
    if _ffm_tried:
        return False
    if (build_dir(_FFM_SRCS, _FFM_FLAGS, _FFM_LIBS)
            / "libaudianffm.so").exists():
        return True
    return ctypes.util.find_library("avformat") is not None


def ff_audio_decode(path):
    """Decode any container/codec the system FFmpeg libraries know (OGG/
    Vorbis, AIFF, MP3, ...) to ``(float32 (n, ch) in [-1, 1], rate)``: the
    reader for containers outside the in-repo WAV and FLAC decoders when
    ``soundfile`` is absent.  None when the FFmpeg libraries are
    unavailable; raises ValueError when FFmpeg cannot decode the file."""
    lib = get_ffm()
    if lib is None:
        return None
    rate, channels = ctypes.c_int(), ctypes.c_int()
    frames = ctypes.c_longlong()
    data = _F32()
    rc = lib.ffp_audio_read(str(path).encode(), ctypes.byref(data),
                            ctypes.byref(rate), ctypes.byref(channels),
                            ctypes.byref(frames))
    if rc != 0:
        raise ValueError(f"FFmpeg could not decode {path} (rc={rc})")
    try:
        n = int(frames.value) * int(channels.value)
        if n == 0:
            out = np.zeros((0, max(int(channels.value), 1)), np.float32)
        else:
            out = np.ctypeslib.as_array(data, shape=(n,)).reshape(
                int(frames.value), int(channels.value)).copy()
    finally:
        lib.ffp_audio_release(data)
    return out, rate.value


def ff_flac_decode(path):
    """Decode a FLAC file through FFmpeg (an independent codec):
    ``(samples, rate, bits)`` with interleaved (n, ch) int32 codes, or
    None when FFmpeg is unavailable.  Raises ValueError on a decode
    failure (FFmpeg runs with CRC checks that stop at the first error)."""
    lib = get_ffm()
    if lib is None:
        return None
    rate, channels, bits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    frames = ctypes.c_longlong()
    rc = lib.ffp_flac_info(str(path).encode(), ctypes.byref(rate),
                           ctypes.byref(channels), ctypes.byref(bits),
                           ctypes.byref(frames))
    if rc != 0:
        raise ValueError(f"FFmpeg could not decode {path} (rc={rc})")
    out = np.empty((frames.value, channels.value), np.int32)
    got = lib.ffp_flac_decode(str(path).encode(),
                              out.ctypes.data_as(_I32), int(frames.value))
    if got < 0:
        raise ValueError(f"FFmpeg could not decode {path} (rc={got})")
    return out[: int(got)], rate.value, bits.value


def ff_flac_encode(path, samples, rate, bits=16, level=5):
    """Encode int codes (n, ch) at ``bits`` depth to ``path`` with FFmpeg's
    FLAC encoder at compression ``level`` (0..12).  False when FFmpeg is
    unavailable; raises ValueError when the encode fails."""
    lib = get_ffm()
    if lib is None:
        return False
    samples = np.ascontiguousarray(samples, np.int32)
    if samples.ndim == 1:
        samples = samples[:, None]
    frames, channels = samples.shape
    rc = lib.ffp_flac_encode(str(path).encode(),
                             samples.ctypes.data_as(_I32), int(frames),
                             int(channels), int(rate), int(bits), int(level))
    if rc != 0:
        raise ValueError(f"FFmpeg could not encode {path} (rc={rc})")
    return True


#: format name -> FFmpeg muxer of :func:`ff_audio_encode` (the formats a
#: region export offers where the FFmpeg libraries are present)
FF_EXPORT_FORMATS = {"OGG": "ogg", "AIFF": "aiff", "MP3": "mp3",
                     "OPUS": "opus"}


def ff_audio_encode(path, samples, rate, format=None, metadata=None):
    """Encode float samples (``(n, ch)`` in [-1, 1]) into a container the
    system FFmpeg can mux (OGG/Vorbis, AIFF, MP3, Opus, ...): the writer
    beyond the native WAV, RF64 and FLAC ones.  ``format`` is a
    :data:`FF_EXPORT_FORMATS` key or an FFmpeg muxer name; None guesses
    from the suffix.  ``metadata`` (a flat or nested dict) goes to the
    muxer's tags, nested keys dotted.  False when FFmpeg is unavailable;
    raises ValueError when the encode fails (lossy codecs constrain rates
    and channels, or the path is unwritable)."""
    lib = get_ffm()
    if lib is None:
        return False
    samples = np.ascontiguousarray(samples, np.float32)
    if samples.ndim == 1:
        samples = samples[:, None]
    frames, channels = samples.shape
    fmt = FF_EXPORT_FORMATS.get((format or "").upper(), format or "")

    def clean(s):
        # records are 0x1E-separated on the wire so that multi-line values
        # survive; only the separator itself may not appear in them
        return str(s).replace("\x1e", " ")

    kv = []
    for key, val in (metadata or {}).items():
        if isinstance(val, dict):  # nested (e.g. BEXT): dotted keys
            kv += [f"{clean(key)}.{clean(k2)}={clean(v2)}"
                   for k2, v2 in val.items() if not isinstance(v2, dict)]
        else:
            kv.append(f"{clean(key)}={clean(val)}")
    rc = lib.ffp_audio_encode(
        str(path).encode(), samples.ctypes.data_as(_F32), int(frames),
        int(channels), int(round(float(rate))), fmt.encode(),
        "\x1e".join(kv).encode("utf-8", "replace"))
    if rc != 0:
        raise ValueError(
            f"FFmpeg could not encode {path} as {fmt or 'auto'} "
            f"(rc={rc}; lossy codecs constrain rates/channels)")
    return True


def read_frames(path, data_off, encoding, channels, start, nframes,
                out=None):
    """Native read and decode of a PCM or float frame range to float32;
    None when the library is unavailable or the encoding unsupported.

    ``out`` (optional) receives the frames in place: a C-contiguous
    ``(nframes, channels)`` float32 array, recycled by hot read paths;
    the return value is a view of it."""
    lib = get_lib()
    tb = _TAGS.get(encoding)
    if lib is None or tb is None:
        return None
    if out is None:
        out = np.empty((nframes, channels), np.float32)
    elif (out.dtype != np.float32 or out.shape != (nframes, channels)
            or not out.flags.c_contiguous):
        raise ValueError("out must be C-contiguous float32 "
                         f"of shape {(nframes, channels)}")
    got = lib.an_read_frames(str(path).encode(), int(data_off), tb[0], tb[1],
                             int(channels), int(start), int(nframes),
                             out.ctypes.data_as(_F32))
    if got < 0:
        return None
    return out[:got]


def flac_encode(samples, rate, bits, blocksize=4096, max_lpc_order=8):
    """Encode int codes (n, ch) to a complete FLAC stream (bytes) with the
    C++ encoder (the write path; the Python encoder of
    :mod:`audian_torch.data.flac` is the readable reference and the
    fallback).  None when the library is unavailable or rejects the
    geometry."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(samples, np.int32)
    frames, channels = q.shape
    cap = frames * channels * (bits // 8 + 2) + (1 << 17)
    out = np.empty(cap, np.uint8)
    got = lib.an_flac_encode(
        q.ctypes.data_as(_I32), int(frames), int(channels),
        int(round(float(rate))), int(bits), int(blocksize),
        int(max_lpc_order), out.ctypes.data_as(_P(ctypes.c_uint8)),
        int(cap))
    if got < 0:
        return None
    return out[:got].tobytes()


def flac_decode_frame(buf, offset, sinfo):
    """Decode the FLAC frame at byte ``offset`` of ``buf`` (the whole
    stream): its ``(blocksize, channels)`` int32 codes, or None when the
    library is unavailable or rejects the frame (the caller then takes the
    Python decoder)."""
    got = flac_decode_frame_meta(buf, offset, sinfo)
    return None if got is None else got[0]


def flac_decode_frame_meta(buf, offset, sinfo):
    """Like :func:`flac_decode_frame`, returning ``(samples, position,
    end)``: the frame's first-sample index from its coded number and the
    byte offset just past its CRC-16, with which the lazy frame index
    chains frames without a sync scan."""
    lib = get_lib()
    if lib is None:
        return None
    channels = int(sinfo["channels"])
    maxbs = int(sinfo["max_blocksize"])
    out = np.empty((maxbs, channels), np.int32)
    work = np.empty(3 * maxbs, np.int64)
    meta = np.empty(2, np.int64)
    # buf may be bytes or an mmap: view it without a copy
    view = np.frombuffer(buf, np.uint8)
    n = lib.an_flac_decode_frame(
        view.ctypes.data_as(ctypes.c_void_p), len(buf), int(offset),
        int(sinfo["rate"]), channels, int(sinfo["bits"]),
        int(sinfo["min_blocksize"]), maxbs, out.ctypes.data_as(_I32),
        work.ctypes.data_as(_I64), meta.ctypes.data_as(_I64))
    if n < 0:
        return None
    return out[:n], int(meta[0]), int(meta[1])


def minmax(x, step):
    """Interleaved min/max decimation of an (n, channels) float32 array;
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    frames, channels = x.shape
    nseg = -(-frames // step)
    out = np.empty((2 * nseg, channels), np.float64)
    lib.an_minmax(x.ctypes.data_as(_F32), frames, channels, int(step),
                  out.ctypes.data_as(_F64))
    return out


def file_minmax(path, data_off, encoding, channels, frames, step,
                nthreads=None, start=0):
    """Min/max overview of ``frames`` frames from frame ``start`` of a PCM
    or float file, read and reduced by lock-free C++ threads (each owns a
    stripe of blocks).  Returns (2*nseg, channels) float64, or None.
    ``start`` lets a caller cut a long file into cancellable slices."""
    lib = get_lib()
    tb = _TAGS.get(encoding)
    if lib is None or tb is None:
        return None
    if nthreads is None:
        nthreads = max(1, (os.cpu_count() or 2) - 1)
    nseg = -(-frames // step)
    out = np.zeros((2 * nseg, channels), np.float64)
    rc = lib.an_file_minmax(
        str(path).encode(),
        int(data_off) + int(start) * channels * (tb[1] // 8),
        tb[0], tb[1], int(channels), int(frames), int(step), int(nthreads),
        out.ctypes.data_as(_F64))
    if rc != 0:
        return None
    return out
