"""Audio reads and writes: WAV (RIFF, RF64/BW64, Sony Wave64) and FLAC,
with metadata and markers, and other containers through optional
libraries.

The batch chain's read path: :func:`wav_info` scans the headers, and
:func:`read_frames_raw16` reads a frame range of a PCM-16 WAV or a 16-bit
FLAC as int16 codes straight into a caller's buffer (sample = k / 2**15,
dequantized on the device).  The loader's float path: :func:`read_frames`
decodes PCM_U8/16/24/32, FLOAT and DOUBLE WAV frames and FLAC frames to
float64.  :func:`scan_wav` reads the metadata (LIST-INFO tags, the
broadcast-wave ``bext`` chunk, FLAC's VORBIS_COMMENT) and the markers
(``cue`` plus LIST-adtl ``labl``/``note``/``ltxt``) without the payload.
:func:`write_audio` writes PCM_16/24/32, PCM_U8, FLOAT and DOUBLE WAV
(RF64 past 4 GiB) with the same metadata and markers, and FLAC through
:mod:`audian_torch.data.flac`; :class:`WavWriter` appends frames to a WAV
as they come.  :func:`update_starttime`, :func:`bext_history_str` and
:func:`add_history` edit the metadata of a region export.

Other containers (OGG, AIFF, MP3, ...) are read through the optional
``soundfile`` package, else through the system FFmpeg libraries
(:func:`audian_torch.native.ff_audio_decode`), which also write them.
Pure numpy and the standard library, copied from
``audian_tpu/data/wavio.py``.
"""

from __future__ import annotations

import datetime as dt
import struct
import sys
from pathlib import Path

import numpy as np

__all__ = ["WavError", "WavWriter", "add_history", "available_encodings",
           "available_formats", "bext_history_str", "get_datetime",
           "load_audio", "load_wav", "markers", "metadata", "read_frames",
           "read_frames_raw16", "scan_wav", "unwrap", "update_starttime",
           "wav_info", "write_audio"]


class WavError(ValueError):
    pass


_SF = 0  # 0 = untried, None = unavailable, the module otherwise


def _soundfile():
    """The optional ``soundfile`` (libsndfile) package, or None.  Files it
    reads carry a ``None`` data offset in their info tuple."""
    global _SF
    if _SF == 0:
        try:
            import soundfile

            _SF = soundfile
        except ImportError:
            _SF = None
    return _SF


def _sf_unavailable(path):
    return WavError(
        f"{path}: not a RIFF/WAVE or FLAC file (WAV and FLAC decode "
        "natively; other containers need the 'soundfile' package or "
        "the system FFmpeg libraries)")


_FF_CACHE = {}  # (path, mtime, size) -> (float32 samples, rate)
_FF_CACHE_BYTES = 1 << 30


def _ff_decode_cached(p):
    """Whole-file decode of a container that is neither WAV nor FLAC
    through the system FFmpeg libraries, cached so that the loader's
    windowed reads do not decode it again.  None when FFmpeg is
    unavailable; a file FFmpeg tried and failed raises :class:`WavError`
    with its reason."""
    try:
        st = p.stat()
    except OSError:
        return None
    key = (str(p), st.st_mtime_ns, st.st_size)
    hit = _FF_CACHE.get(key)
    if hit is None:
        from .. import native

        try:
            hit = native.ff_audio_decode(p)
        except OSError:
            return None
        except ValueError as e:
            raise WavError(f"{p}: FFmpeg failed to decode: {e}") from e
        if hit is None:
            return None
        # bound the entries and the bytes: a decode above the cap is
        # served uncached
        if hit[0].nbytes > _FF_CACHE_BYTES:
            return hit
        total = sum(v[0].nbytes for v in _FF_CACHE.values())
        if len(_FF_CACHE) > 4 or total + hit[0].nbytes > _FF_CACHE_BYTES:
            _FF_CACHE.clear()
        _FF_CACHE[key] = hit
    return hit


# Standard RIFF caps every chunk size at 32 bits (4 GiB); RF64 and BW64
# carry 64-bit sizes in a ``ds64`` chunk, Sony Wave64 uses GUID chunk ids
# with 64-bit header-inclusive sizes and 8-byte alignment.
_W64_SUFFIX = bytes.fromhex("f3acd3118cd100c04f8edb8a")
_W64_RIFF_GUID = b"riff" + bytes.fromhex("2e91cf11a5d628db04c10000")
_W64_WAVE_GUID = b"wave" + _W64_SUFFIX
# metadata bodies are read whole; cap them so a corrupt 64-bit size
# cannot ask for a multi-GB allocation
_META_CHUNK_CAP = 1 << 26

_ENCODING_NAMES = {(1, 16): "PCM_16", (1, 24): "PCM_24", (1, 32): "PCM_32",
                   (1, 8): "PCM_U8", (3, 32): "FLOAT", (3, 64): "DOUBLE"}
_ENCODINGS = {name: key for key, name in _ENCODING_NAMES.items()}

_INFO_TAGS = {
    "INAM": "Title", "IART": "Artist", "ICMT": "Comment", "ICRD": "Date",
    "IENG": "Engineer", "IGNR": "Genre", "IKEY": "Keywords",
    "IPRD": "Product", "ISFT": "Software", "ISRC": "Source",
    "ICOP": "Copyright", "ISBJ": "Subject",
}
_INFO_TAGS_INV = {v: k for k, v in _INFO_TAGS.items()}

_BEXT_FIELDS = [
    ("Description", 256), ("Originator", 32), ("OriginatorReference", 32),
    ("OriginationDate", 10), ("OriginationTime", 8),
]


def _wave_container(head):
    """Container kind from the first 16 file bytes: ``"riff"`` (RIFF /
    RF64 / BW64 little-endian WAVE family) or ``"w64"``, else None."""
    if head[:4] in (b"RIFF", b"RF64", b"BW64") and head[8:12] == b"WAVE":
        return "riff"
    if head[:16] == _W64_RIFF_GUID:
        return "w64"
    return None


def _parse_ds64(body, path):
    """Chunk-id -> 64-bit size overrides from an RF64 ``ds64`` body."""
    if len(body) < 28:
        raise WavError(f"{path}: ds64 chunk truncated")
    _riff_sz, data_sz, _samples = struct.unpack_from("<QQQ", body, 0)
    sizes = {b"data": data_sz}
    (tn,) = struct.unpack_from("<I", body, 24)
    for k in range(tn):
        base = 28 + 12 * k
        if base + 12 > len(body):
            break  # truncated table: keep what parsed
        (tsz,) = struct.unpack_from("<Q", body, base + 4)
        sizes[bytes(body[base : base + 4])] = tsz
    return sizes


def _walk_wave_chunks(f, path):
    """Yield ``(cid, size, body_offset)`` for each chunk of an open WAVE
    file, with true 64-bit body sizes (RF64 ``ds64`` overrides applied,
    W64 sizes made body-only).  The file is positioned at the body when a
    chunk is yielded; the walker reseeks afterwards."""
    f.seek(0)
    head = f.read(16)
    kind = _wave_container(head)
    if kind == "w64":
        rest = f.read(24)  # 64-bit riff size + the wave GUID
        if len(rest) < 24 or rest[8:24] != _W64_WAVE_GUID:
            raise WavError(f"{path}: not a W64 WAVE file")
        while True:
            hdr = f.read(24)
            if len(hdr) < 24:
                break
            (size,) = struct.unpack("<Q", hdr[16:24])
            if size < 24:
                raise WavError(f"{path}: invalid W64 chunk size {size}")
            body = size - 24
            off = f.tell()
            yield bytes(hdr[:4]), body, off
            f.seek(off + ((body + 7) & ~7))
        return
    if kind is None:
        raise WavError(f"{path}: not a RIFF/WAVE file")
    f.seek(12)
    ds64 = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid = bytes(hdr[:4])
        (size,) = struct.unpack("<I", hdr[4:])
        if cid == b"ds64":
            body = f.read(size + (size & 1))
            ds64 = _parse_ds64(body, path)
            continue
        if size == 0xFFFFFFFF and ds64 is not None and cid in ds64:
            size = ds64[cid]
        off = f.tell()
        yield cid, size, off
        f.seek(off + size + (size & 1))


def _parse_fmt(buf, off, size):
    """Parse and validate a fmt chunk: ``(tag, channels, rate, bits)``."""
    if size < 16 or off + 16 > len(buf):
        raise WavError("fmt chunk truncated")
    tag, channels, rate, _, _, bits = struct.unpack_from("<HHIIHH", buf, off)
    if tag == 0xFFFE and size >= 40 and off + 26 <= len(buf):
        (tag,) = struct.unpack_from("<H", buf, off + 24)  # EXTENSIBLE
    if channels < 1:
        raise WavError(f"invalid channel count: {channels}")
    if rate <= 0:
        raise WavError(f"invalid sample rate: {rate}")
    if bits < 8:
        raise WavError(f"invalid bit depth: {bits}")
    return tag, channels, rate, bits


def wav_info(path):
    """Header scan: ``(rate, channels, frames, encoding, data_offset)``.

    ``frames`` is clamped by the real file size, so a truncated file (or
    an unpatched streamed ``0xFFFFFFFF`` size) never reports frames the
    reads cannot deliver.
    """
    p = Path(path)
    with p.open("rb") as f:
        head = f.read(16)
        if _wave_container(head) is None:
            if head[:4] == b"fLaC":
                from . import flac

                return flac.flac_info(p)
            sf = _soundfile()
            if sf is None:
                got = _ff_decode_cached(p)
                if got is not None:
                    samples, rate = got
                    return (float(rate), int(samples.shape[1]),
                            int(samples.shape[0]), "FFMPEG", None)
                raise _sf_unavailable(path)
            i = sf.info(str(p))
            return (float(i.samplerate), int(i.channels), int(i.frames),
                    f"SF:{i.subtype}", None)
        fmt = None
        for cid, size, off in _walk_wave_chunks(f, path):
            if cid == b"fmt ":
                body = f.read(min(size, _META_CHUNK_CAP))
                fmt = _parse_fmt(body, 0, len(body))
            elif cid == b"data":
                if fmt is None:
                    raise WavError(f"{path}: data before fmt")
                tag, channels, rate, bits = fmt
                avail = max(p.stat().st_size - off, 0)
                frames = min(size, avail) // (channels * (bits // 8))
                enc = _ENCODING_NAMES.get((tag, bits), f"tag{tag}/{bits}")
                return float(rate), channels, frames, enc, off
    raise WavError(f"{path}: missing fmt/data chunk")


def read_frames_raw16(path, start, nframes, info, out):
    """Read 16-bit frames as int16 codes, without a float decode, into
    ``out`` (a C-contiguous ``(>= nframes, channels)`` int16 array): a
    PCM-16 WAV with one ``readinto``, a 16-bit FLAC decoded straight to
    its codes.

    Returns the number of frames read (short files return fewer; the
    caller zero-fills).  Raises :class:`WavError` for anything but PCM-16
    WAV and 16-bit FLAC.
    """
    rate, channels, frames, enc, data_off = info
    if enc not in ("PCM_16", "FLAC_16") or (enc == "PCM_16"
                                            and data_off is None):
        raise WavError(f"{path}: raw16 read needs PCM_16 WAV, got {enc}")
    if (out.dtype != np.int16 or out.ndim != 2
            or out.shape[1] != channels or out.shape[0] < nframes
            or not out.flags.c_contiguous):
        raise ValueError("out must be C-contiguous int16 "
                         f"(>= {nframes}, {channels})")
    if enc == "FLAC_16":
        from . import flac

        return flac.read_frames_raw16(path, start, nframes, out)
    bpf = channels * 2
    start = max(0, min(start, frames))
    nframes = max(0, min(nframes, frames - start))
    with Path(path).open("rb") as f:
        f.seek(data_off + start * bpf)
        view = memoryview(out).cast("B")
        nbytes = f.readinto(view[: nframes * bpf])
    if sys.byteorder != "little":  # pragma: no cover - LE hosts only here
        out[: nbytes // bpf].byteswap(inplace=True)
    return nbytes // bpf


def _decode(raw, tag, bits, channels):
    """PCM or IEEE-float bytes -> (frames, channels) float64 (float32 for
    FLOAT), scaled to [-1, 1]; a partial trailing sample is dropped."""
    bps = max(bits // 8, 1)
    if len(raw) % bps:
        raw = raw[: len(raw) - (len(raw) % bps)]
    if tag == 3:
        dtype = np.float32 if bits == 32 else np.float64
        data = np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8")
        data = data.astype(dtype, copy=False)
    elif tag == 1:
        if bits == 16:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 2 ** 15
        elif bits == 32:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2 ** 31
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            ints = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            data = ints.astype(np.float64) / 2 ** 23
        elif bits == 8:
            data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64)
                    - 128.0) / 128.0
        else:
            raise WavError(f"unsupported PCM bit depth: {bits}")
    else:
        raise WavError(f"unsupported WAV format tag: {tag}")
    frames = len(data) // channels
    return data[: frames * channels].reshape(frames, channels)


def read_frames(path, start, nframes, info=None):
    """Decode frames [start, start + nframes) of a recording (without
    reading the rest) to float values in [-1, 1]."""
    if info is None:
        info = wav_info(path)
    rate, channels, frames, enc, data_off = info
    if enc.startswith("FLAC"):
        from . import flac

        return flac.read_frames(path, start, nframes)
    if enc == "FFMPEG":
        got = _ff_decode_cached(Path(path))
        if got is None:
            raise _sf_unavailable(path)
        start = max(0, min(start, frames))
        nframes = max(0, min(nframes, frames - start))
        return got[0][start : start + nframes].astype(np.float64)
    if data_off is None:  # read by soundfile
        start = max(0, min(start, frames))
        nframes = max(0, min(nframes, frames - start))
        with _soundfile().SoundFile(str(path)) as f:
            f.seek(start)
            return f.read(nframes, dtype="float64", always_2d=True)
    tag, bits = _ENCODINGS.get(enc, (None, None))
    if tag is None:
        raise WavError(f"{path}: unsupported encoding {enc}")
    bpf = channels * (bits // 8)
    start = max(0, min(start, frames))
    nframes = max(0, min(nframes, frames - start))
    with Path(path).open("rb") as f:
        f.seek(data_off + start * bpf)
        raw = f.read(nframes * bpf)
    return _decode(raw, tag, bits, channels)


def _cstr(b):
    return b.split(b"\x00", 1)[0].decode("latin-1", "replace").strip()


def _parse_bext(buf, off, size):
    md = {}
    pos = off
    for name, n in _BEXT_FIELDS:
        md[name] = _cstr(buf[pos : pos + n])
        pos += n
    lo, hi = struct.unpack_from("<II", buf, pos)
    md["TimeReference"] = (hi << 32) | lo
    pos += 8
    (md["Version"],) = struct.unpack_from("<H", buf, pos)
    pos += 2
    pos += 64  # UMID
    pos += 10  # loudness
    pos += 180  # reserved
    if pos < off + size:
        md["CodingHistory"] = _cstr(buf[pos : off + size])
    return {k: v for k, v in md.items() if v not in ("", 0)}


def _parse_list(buf, off, size):
    kind = buf[off : off + 4]
    entries = {}
    pos = off + 4
    end = off + size
    while pos + 8 <= end:
        cid = buf[pos : pos + 4]
        (csize,) = struct.unpack_from("<I", buf, pos + 4)
        body = buf[pos + 8 : pos + 8 + csize]
        entries.setdefault(cid.decode("latin-1"), []).append(body)
        pos += 8 + csize + (csize & 1)
    return kind, entries


def _collect_meta(cid, buf, off, size, md, cues, lengths, names, notes):
    """Fold one non-data chunk into the metadata and marker accumulators.
    A truncated side chunk keeps what parsed and skips the rest: metadata
    and markers are auxiliary, so a malformed one is not fatal."""
    try:
        if cid == b"bext":
            md["BEXT"] = _parse_bext(buf, off, size)
        elif cid == b"LIST":
            kind, entries = _parse_list(buf, off, size)
            if kind == b"INFO":
                for tag4, bodies in entries.items():
                    key = _INFO_TAGS.get(tag4, tag4)
                    md[key] = _cstr(bodies[0])
            elif kind == b"adtl":
                for body in entries.get("labl", []):
                    (cue_id,) = struct.unpack_from("<I", body, 0)
                    names[cue_id] = _cstr(body[4:])
                for body in entries.get("note", []):
                    (cue_id,) = struct.unpack_from("<I", body, 0)
                    notes[cue_id] = _cstr(body[4:])
                for body in entries.get("ltxt", []):
                    cue_id, length = struct.unpack_from("<II", body, 0)
                    lengths[cue_id] = length
        elif cid == b"cue ":
            (ncues,) = struct.unpack_from("<I", buf, off)
            for k in range(ncues):
                base = off + 4 + 24 * k
                cue_id, _, _, _, _, pos = struct.unpack_from("<IIIIII",
                                                             buf, base)
                cues[cue_id] = pos
    except struct.error:
        return


def _marker_arrays(cues, lengths, names, notes):
    ids = sorted(cues)
    locs = np.array(
        [[cues[i], lengths.get(i, 0)] for i in ids], dtype=np.int64
    ).reshape(-1, 2)
    labels = np.array(
        [[names.get(i, ""), notes.get(i, "")] for i in ids], dtype=object
    ).reshape(-1, 2)
    return locs, labels


def scan_wav(path):
    """Header-only scan: ``(rate, md, locs, labels)``, seeking past the
    data payload.  ``md`` holds the INFO tags at top level and the
    broadcast-wave fields under ``"BEXT"``; ``locs`` (n, 2) are
    ``[position, span]`` and ``labels`` (n, 2) ``[label, text]``."""
    p = Path(path)
    md = {}
    cues, lengths, names, notes = {}, {}, {}, {}
    fmt = None
    with p.open("rb") as f:
        head = f.read(16)
        if _wave_container(head) is None:
            locs, labels = _marker_arrays({}, {}, {}, {})
            if head[:4] == b"fLaC":
                from . import flac

                return (flac.flac_info(p)[0], flac.flac_metadata(p),
                        locs, labels)
            sf = _soundfile()
            if sf is None:
                got = _ff_decode_cached(p)
                if got is None:
                    raise _sf_unavailable(path)
                return float(got[1]), {}, locs, labels
            return float(sf.info(str(p)).samplerate), {}, locs, labels
        for cid, size, off in _walk_wave_chunks(f, path):
            if cid == b"data":
                continue  # the walker seeks past the payload
            take = min(size, _META_CHUNK_CAP)
            body = f.read(take)
            if len(body) < take:
                break
            if cid == b"fmt ":
                fmt = _parse_fmt(body, 0, take)
            else:
                _collect_meta(cid, body, 0, take, md, cues, lengths,
                              names, notes)
    if fmt is None:
        raise WavError(f"{path}: missing fmt chunk")
    locs, labels = _marker_arrays(cues, lengths, names, notes)
    return float(fmt[2]), md, locs, labels


def load_wav(path):
    """Read a whole recording: ``(data, rate, md, locs, labels)`` with the
    data as float values in [-1, 1] (float32 for FLOAT WAVs, float64
    otherwise), the metadata as :func:`scan_wav` gives it and the markers
    (FLAC and the other containers have none)."""
    p = Path(path)
    with p.open("rb") as f:
        head = f.read(16)
    if _wave_container(head) is None:
        locs, labels = _marker_arrays({}, {}, {}, {})
        if head[:4] == b"fLaC":
            from . import flac

            data, rate = flac.read_flac(path)
            return data, rate, flac.flac_metadata(path), locs, labels
        sf = _soundfile()
        if sf is None:
            got = _ff_decode_cached(p)
            if got is None:
                raise _sf_unavailable(path)
            return got[0].astype(np.float64), float(got[1]), {}, locs, labels
        data, rate = sf.read(str(path), always_2d=True, dtype="float64")
        return data, float(rate), {}, locs, labels
    info = wav_info(path)
    rate, md, locs, labels = scan_wav(path)
    return read_frames(path, 0, info[2], info), rate, md, locs, labels


def load_audio(path):
    """``(data, rate)`` of a whole recording, decoded to float values in
    [-1, 1]."""
    data, rate, _, _, _ = load_wav(path)
    return data, rate


def metadata(path):
    _, md, _, _ = scan_wav(path)
    return md


def markers(path):
    _, _, locs, labels = scan_wav(path)
    return locs, labels


def get_datetime(md):
    """Recording start datetime from metadata (BEXT OriginationDate/Time or
    INFO ICRD/Date), or None."""
    bext = md.get("BEXT", {})
    date = bext.get("OriginationDate")
    time = bext.get("OriginationTime", "00:00:00")
    if date:
        try:
            return dt.datetime.fromisoformat(f"{date}T{time}")
        except ValueError:
            pass
    date = md.get("Date") or md.get("ICRD")
    if date:
        try:
            return dt.datetime.fromisoformat(str(date))
        except ValueError:
            pass
    return None


def unwrap(data, thresh=1.5, clips=False, ampl_max=1.0, start_shift=0.0,
           return_shift=False):
    """Unwrap data that wrapped around the ADC range: where consecutive
    samples jump by more than ``thresh*ampl_max``, shift by the full range.
    Then either clip to the range or scale down by two (the reference's
    ``-U`` and ``-u`` options).

    ``start_shift`` seeds the cumulative shift so a sequential block scan
    can continue a wrap still active at a block boundary;
    ``return_shift=True`` also returns the final cumulative shift.
    """
    data = np.array(data, dtype=np.float64, copy=True)
    rng = 2.0 * ampl_max
    d = np.diff(data, axis=0)
    steps = np.zeros_like(data)
    steps[1:] = -rng * np.where(d > thresh * ampl_max, 1.0,
                                np.where(d < -thresh * ampl_max, -1.0, 0.0))
    shift = np.cumsum(steps, axis=0) + start_shift
    data += shift
    final = shift[-1] if len(data) else start_shift
    if clips:
        np.clip(data, -ampl_max, ampl_max, out=data)
    else:
        data *= 0.5
    if return_shift:
        return data, final
    return data


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

_RIFF_MAX = 0xFFFFFFFE


def available_formats():
    """The formats :func:`write_audio` writes: WAV, FLAC and RF64 natively,
    the FFmpeg export formats where the system libraries are likely
    present (asked without starting a build), and what ``soundfile``
    knows where it is installed."""
    base = ["WAV", "FLAC", "RF64"]
    from .. import native

    if native.ffm_probable():
        base += sorted(native.FF_EXPORT_FORMATS)
    sf = _soundfile()
    if sf is not None:
        base += sorted(f for f in sf.available_formats() if f not in base)
    return base


def available_encodings(format="WAV"):
    if (format or "").upper() == "FLAC":
        return ["PCM_16", "PCM_24", "PCM_32"]  # FLAC is integer-only
    return list(_ENCODINGS)


def _encode(data, encoding):
    tag, bits = _ENCODINGS[encoding]
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    if np.issubdtype(data.dtype, np.unsignedinteger):
        raise WavError("unsigned integer samples are ambiguous; pass "
                       "signed PCM codes or float in [-1, 1]")
    if np.issubdtype(data.dtype, np.integer):
        # integer input is PCM codes at the dtype's width (k / 2^15 for
        # int16, k / 2^31 for int32), not floats to clip: an int16 array
        # written as PCM_16 round-trips bit-exactly
        width = data.dtype.itemsize * 8
        data = data.astype(np.float64) / float(2 ** (width - 1))
    if tag == 3:
        return data.astype("<f4" if bits == 32 else "<f8").tobytes(), tag, bits
    clipped = np.clip(data, -1.0, 1.0 - 2.0 ** (1 - bits))
    scaled = np.round(clipped * 2 ** (bits - 1)).astype(np.int64)
    if bits == 16:
        return scaled.astype("<i2").tobytes(), tag, bits
    if bits == 32:
        return scaled.astype("<i4").tobytes(), tag, bits
    if bits == 24:
        ints = scaled.astype(np.int64) & 0xFFFFFF
        b = np.empty(ints.shape + (3,), np.uint8)
        b[..., 0] = ints & 0xFF
        b[..., 1] = (ints >> 8) & 0xFF
        b[..., 2] = (ints >> 16) & 0xFF
        return b.tobytes(), tag, bits
    if bits == 8:  # unsigned, 128 offset (the _decode inverse)
        return (np.clip(scaled + 128, 0, 255).astype(np.uint8).tobytes(),
                tag, bits)
    raise WavError(f"unsupported encoding {encoding}")


def _chunk_exact(cid, body):
    pad = b"\x00" if len(body) & 1 else b""
    return cid + struct.pack("<I", len(body)) + body + pad


def _build_bext(bext):
    body = b""
    for name, n in _BEXT_FIELDS:
        body += str(bext.get(name, ""))[:n].encode(
            "latin-1", "replace").ljust(n, b"\x00")
    tr = int(bext.get("TimeReference", 0))
    body += struct.pack("<II", tr & 0xFFFFFFFF, tr >> 32)
    body += struct.pack("<H", int(bext.get("Version", 1)))
    body += b"\x00" * 64   # UMID
    body += b"\x00" * 10   # loudness
    body += b"\x00" * 180  # reserved
    hist = str(bext.get("CodingHistory", ""))
    if hist:
        body += hist.encode("latin-1", "replace")
        if not body.endswith(b"\r\n"):
            body += b"\r\n"
    return body


def _marker_chunks(locs, labels):
    """The ``cue`` chunk and the LIST-adtl ``labl``/``note``/``ltxt``
    entries of ``locs`` (n, 2) ``[position, span]`` and ``labels`` (n, 2)
    ``[label, text]``."""
    locs = np.asarray(locs)
    if locs.ndim == 1:
        locs = np.stack([locs, np.zeros_like(locs)], axis=1)
    cue = struct.pack("<I", len(locs))
    adtl = b""
    for k, (pos, span) in enumerate(locs):
        cue += struct.pack("<IIIIII", k + 1, int(pos), 0x61746164, 0, 0,
                           int(pos))
        label, text = "", ""
        if labels is not None and k < len(labels):
            pair = np.atleast_1d(labels[k])
            label = str(pair[0]) if len(pair) > 0 and pair[0] else ""
            text = str(pair[1]) if len(pair) > 1 and pair[1] else ""
        if label:
            adtl += _chunk_exact(
                b"labl", struct.pack("<I", k + 1)
                + label.encode("latin-1", "replace") + b"\x00")
        if text:
            adtl += _chunk_exact(
                b"note", struct.pack("<I", k + 1)
                + text.encode("latin-1", "replace") + b"\x00")
        if span:
            adtl += _chunk_exact(
                b"ltxt", struct.pack("<II", k + 1, int(span)) + b"\x00" * 12)
    chunks = [_chunk_exact(b"cue ", cue)]
    if adtl:
        chunks.append(_chunk_exact(b"LIST", b"adtl" + adtl))
    return chunks


def write_audio(path, data, rate, metadata=None, locs=None, labels=None,
                encoding="PCM_16", format="WAV"):
    """Write a recording with optional metadata and markers (audioio's
    ``write_audio`` call shape).

    ``data`` is float in [-1, 1] or signed integer PCM codes at the
    dtype's width.  Payloads past the 32-bit RIFF size cap are written as
    RF64 (EBU tech 3306: ``RF64`` magic plus a ``ds64`` chunk with the
    64-bit sizes); ``format="RF64"`` forces that container.

    A ``.flac`` suffix writes FLAC even under the default ``format="WAV"``
    (the suffix is the caller's signal, as in audioio); there
    ``encoding`` picks the stored depth (``PCM_16``/``PCM_24``/``PCM_32``,
    or ``FLAC`` for the input dtype's) and float encodings and markers
    raise.  OGG, AIFF, MP3 and Opus (by ``format`` or suffix) go through
    the system FFmpeg libraries and raise where those are missing."""
    fmt = (format or "WAV").upper()
    if (fmt == "FLAC" or str(encoding).upper() == "FLAC"
            or (fmt == "WAV" and str(path).lower().endswith(".flac"))):
        return _write_flac(path, data, rate, metadata, locs, encoding)
    suffix_fmt = None
    if fmt == "WAV":
        # like the .flac rule, a target suffix is the caller's signal
        sfx = str(path).lower().rsplit(".", 1)
        suffix_fmt = {"ogg": "OGG", "oga": "OGG", "aiff": "AIFF",
                      "aif": "AIFF", "mp3": "MP3", "opus": "OPUS"}.get(
                          sfx[-1] if len(sfx) > 1 else "")
    if fmt not in ("WAV", "RF64") or suffix_fmt:
        return _write_ffmpeg(path, data, rate, metadata, locs,
                             suffix_fmt or fmt, format)
    if encoding not in _ENCODINGS:
        raise WavError(f"unsupported encoding {encoding}")
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    raw, tag, bits = _encode(data, encoding)
    channels = data.shape[1]
    bpf = channels * (bits // 8)
    # ByteRate is informational; clamp it for the huge synthetic rates the
    # overview cache writes (its rate is scaled by 1e6)
    byte_rate = min(int(round(rate)) * bpf, 0xFFFFFFFF)
    chunks = [_chunk_exact(b"fmt ", struct.pack(
        "<HHIIHH", tag, channels, int(round(rate)), byte_rate, bpf, bits))]
    md = dict(metadata or {})
    bext = md.pop("BEXT", None)
    if bext:
        chunks.append(_chunk_exact(b"bext", _build_bext(bext)))
    info_entries = b""
    for key, val in md.items():
        if isinstance(val, dict):
            continue  # non-INFO sections are not representable
        tag4 = _INFO_TAGS_INV.get(key, key if len(key) == 4 else None)
        if tag4 is None:
            continue
        body = str(val).encode("latin-1", "replace") + b"\x00"
        info_entries += _chunk_exact(tag4.encode("latin-1"), body)
    if info_entries:
        chunks.append(_chunk_exact(b"LIST", b"INFO" + info_entries))
    if locs is not None and len(locs):
        chunks += _marker_chunks(locs, labels)
    meta = b"".join(chunks)
    data_size = len(raw)
    pad = b"\x00" if data_size & 1 else b""
    riff_size = 4 + len(meta) + 8 + data_size + len(pad)
    with Path(path).open("wb") as f:
        if riff_size <= _RIFF_MAX and fmt != "RF64":
            f.write(b"RIFF" + struct.pack("<I", riff_size) + b"WAVE")
            f.write(meta)
            f.write(b"data" + struct.pack("<I", data_size))
        else:
            # the 32-bit size fields hold the 0xFFFFFFFF placeholder, the
            # true riff/data sizes live in the leading ds64
            ds64 = struct.pack("<QQQI", riff_size + 36, data_size,
                               data_size // max(bpf, 1), 0)
            f.write(b"RF64" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE")
            f.write(b"ds64" + struct.pack("<I", len(ds64)) + ds64)
            f.write(meta)
            f.write(b"data" + struct.pack("<I", 0xFFFFFFFF))
        f.write(raw)
        f.write(pad)
    return Path(path)


def _write_flac(path, data, rate, metadata, locs, encoding):
    from . import flac

    if locs is not None and len(locs):
        raise ValueError("FLAC has no cue-marker chunk; export markers to "
                         "CSV/XLSX or write a WAV")
    flac_bits = {"FLAC": None, "PCM_16": 16, "PCM_24": 24, "PCM_32": 32}
    enc = (encoding or "FLAC").upper()
    if enc not in flac_bits:
        raise ValueError(f"FLAC cannot store encoding {encoding}: FLAC is "
                         "integer-only (PCM_16/PCM_24/PCM_32)")
    flac.write_flac(path, np.asarray(data), rate, metadata=metadata,
                    bits=flac_bits[enc])
    return Path(path)


def _write_ffmpeg(path, data, rate, metadata, locs, fmt, format):
    """OGG/AIFF/MP3/Opus export through the system FFmpeg libraries."""
    from .. import native

    if fmt not in native.FF_EXPORT_FORMATS:
        raise ValueError(f"unsupported format: {format}")
    if locs is not None and len(locs):
        raise ValueError(f"{fmt} has no cue-marker chunk; export markers "
                         "to CSV/XLSX or write a WAV")
    arr = np.asarray(data)
    if np.issubdtype(arr.dtype, np.unsignedinteger):
        raise WavError("unsigned integer samples are ambiguous; pass "
                       "signed PCM codes or float")
    if np.issubdtype(arr.dtype, np.integer):
        # integer input is PCM codes (the _encode convention)
        arr = arr.astype(np.float64) / float(2 ** (arr.dtype.itemsize * 8
                                                   - 1))
    if native.ff_audio_encode(path, arr.astype(np.float32), rate,
                              format=fmt, metadata=metadata):
        return Path(path)
    raise WavError(f"{path}: {fmt} export needs the system FFmpeg "
                   "libraries (libavformat/libavcodec), which are not "
                   "available; write a WAV or FLAC instead")


class WavWriter:
    """Incremental WAV writer, promoted to RF64 past 4 GiB.

    Appends frames as they arrive without holding the recording in
    memory.  The header reserves a 28-byte ``JUNK`` chunk after the RIFF
    id; :meth:`close` patches the true sizes in place, and where the file
    outgrew the 32-bit RIFF sizes it rewrites the magic to ``RF64`` and
    the ``JUNK`` into the ``ds64`` chunk with the 64-bit sizes (EBU tech
    3306's promotion, so the bytes before the payload never move)::

        with WavWriter(path, rate, channels) as w:
            for block in blocks:
                w.write(block)

    ``write`` takes float frames in [-1, 1] or integer PCM codes (the
    :func:`write_audio` convention); int16 input under ``PCM_16`` is
    appended without a float round trip.  :meth:`skip_frames` extends
    the file with silence sparsely (zero codes without writing them).
    """

    def __init__(self, path, rate, channels, encoding="PCM_16"):
        if encoding not in _ENCODINGS:
            raise WavError(f"unsupported encoding {encoding}")
        self.path = Path(path)
        self.rate = float(rate)
        self.channels = int(channels)
        self.encoding = encoding
        tag, bits = _ENCODINGS[encoding]
        self._bpf = self.channels * (bits // 8)
        self._frames = 0
        byte_rate = min(int(round(self.rate)) * self._bpf, 0xFFFFFFFF)
        f = self.path.open("wb")
        try:
            # 0xFFFFFFFF placeholders, not zeros: if the process dies
            # before close() patches the sizes, readers clamp the data by
            # the file size and every written frame is still read
            f.write(b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE")
            f.write(b"JUNK" + struct.pack("<I", 28) + b"\x00" * 28)
            f.write(_chunk_exact(b"fmt ", struct.pack(
                "<HHIIHH", tag, self.channels, int(round(self.rate)),
                byte_rate, self._bpf, bits)))
            self._data_hdr = f.tell()
            f.write(b"data" + struct.pack("<I", 0xFFFFFFFF))
            self._data_off = f.tell()
        except BaseException:
            f.close()
            raise
        self._f = f

    @property
    def frames(self):
        return self._frames

    def write(self, data):
        """Append frames (shape ``(n,)`` or ``(n, channels)``)."""
        if self._f is None:
            raise WavError(f"{self.path}: writer is closed")
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[:, None]
        if data.shape[1] != self.channels:
            raise WavError(
                f"expected {self.channels} channels, got {data.shape[1]}")
        if data.dtype == np.int16 and self.encoding == "PCM_16":
            raw = np.ascontiguousarray(data, "<i2").tobytes()
        else:
            raw = _encode(data, self.encoding)[0]
        self._f.write(raw)
        self._frames += len(data)
        return self

    def skip_frames(self, n):
        """Extend with ``n`` silent frames without writing their bytes (a
        sparse hole; zero codes decode as silence in every encoding)."""
        if self._f is None:
            raise WavError(f"{self.path}: writer is closed")
        n = int(n)
        if n < 0:
            raise ValueError(f"cannot skip {n} frames")
        if n:
            self._f.seek(n * self._bpf - 1, 1)
            self._f.write(b"\x00")
        self._frames += n
        return self

    def close(self):
        """Patch the deferred sizes (promoting to RF64 if needed)."""
        f, self._f = self._f, None
        if f is None:
            return
        try:
            true_size = self._frames * self._bpf
            padded = true_size + (true_size & 1)
            if true_size & 1:  # odd bytes a frame (PCM_24 mono): pad
                f.seek(self._data_off + true_size)
                f.write(b"\x00")
            riff_size = self._data_off + padded - 8
            if riff_size <= _RIFF_MAX:
                f.seek(4)
                f.write(struct.pack("<I", riff_size))
                f.seek(self._data_hdr + 4)
                f.write(struct.pack("<I", true_size))
            else:
                f.seek(0)
                f.write(b"RF64" + struct.pack("<I", 0xFFFFFFFF))
                f.seek(12)
                f.write(b"ds64" + struct.pack("<I", 28))
                f.write(struct.pack("<QQQI", riff_size, true_size,
                                    self._frames, 0))
                f.seek(self._data_hdr + 4)
                f.write(struct.pack("<I", 0xFFFFFFFF))
        finally:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def update_starttime(md, deltat, rate):
    """Shift the recording start time in ``md`` by ``deltat`` seconds (a
    region cut out of the recording starts later)."""
    start = get_datetime(md)
    if start is not None:
        new = start + dt.timedelta(seconds=float(deltat))
        if "BEXT" in md and "OriginationDate" in md["BEXT"]:
            md["BEXT"]["OriginationDate"] = new.date().isoformat()
            md["BEXT"]["OriginationTime"] = new.time().strftime("%H:%M:%S")
        if "Date" in md:
            md["Date"] = new.isoformat()
    bext = md.get("BEXT")
    if bext and "TimeReference" in bext:
        bext["TimeReference"] = int(bext["TimeReference"]) + int(
            round(float(deltat) * rate))
    return md


def bext_history_str(encoding, rate, channels, text=None):
    """One BWF CodingHistory line, ``A=PCM,F=...,W=...,M=...``."""
    enc = str(encoding or "PCM_16").upper()
    bits = {"FLOAT": 32, "DOUBLE": 64}.get(enc)
    if bits is None:
        # PCM_16/24/32, PCM_U8, FLAC_16/24/...: the trailing digits are
        # the word length
        tail = "".join(c for c in enc.rsplit("_", 1)[-1] if c.isdigit())
        bits = int(tail) if tail else 16
    mode = {1: "mono", 2: "stereo"}.get(int(channels), f"{channels}ch")
    s = f"A=PCM,F={int(round(rate))},W={bits},M={mode}"
    if text:
        s += f",T={text}"
    return s


def add_history(md, history, key="CodingHistory", pre_history=None):
    """Append a history line to the metadata under ``key`` (a dotted path
    is allowed), seeding with ``pre_history`` if the field was empty."""
    d = md
    parts = key.split(".")
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    field = parts[-1]
    old = d.get(field, "")
    if not old and pre_history:
        old = pre_history
    d[field] = (old + "\r\n" + history) if old else history
    return md
