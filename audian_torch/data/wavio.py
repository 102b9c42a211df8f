"""Raw PCM-16 reads from WAV files (RIFF, RF64/BW64, Sony Wave64).

The read path of the batch chain: :func:`wav_info` scans the chunk
headers, and :func:`read_frames_raw16` reads a frame range as
little-endian int16 straight into a caller's buffer (sample = k / 2**15,
dequantized on the device).  Pure numpy and the standard library.
FLAC and other containers are not read here.
"""

from __future__ import annotations

import struct
import sys
from pathlib import Path

import numpy as np

__all__ = ["WavError", "read_frames_raw16", "wav_info"]


class WavError(ValueError):
    pass


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
            kind = "FLAC" if head[:4] == b"fLaC" else "this container"
            raise WavError(f"{path}: {kind} is not read by audian_torch "
                           f"(WAV, RF64 and W64 only)")
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
    """Read PCM-16 frames as raw little-endian int16, without a float
    decode, into ``out`` (a C-contiguous ``(>= nframes, channels)`` int16
    array) with one ``readinto``.

    Returns the number of frames read (short files return fewer; the
    caller zero-fills).  Raises :class:`WavError` for anything but PCM-16.
    """
    rate, channels, frames, enc, data_off = info
    if enc != "PCM_16" or data_off is None:
        raise WavError(f"{path}: raw16 read needs PCM_16 WAV, got {enc}")
    if (out.dtype != np.int16 or out.ndim != 2
            or out.shape[1] != channels or out.shape[0] < nframes
            or not out.flags.c_contiguous):
        raise ValueError("out must be C-contiguous int16 "
                         f"(>= {nframes}, {channels})")
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
