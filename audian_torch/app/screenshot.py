"""View screenshots with embedded navigation metadata.

The counterpart of ``audian_tpu/app/screenshot.py`` (pure Python: the
same chunks, byte for byte, for the same view).  Reference parity:
`src/audian/audian.py:178-260` — screenshots carry the recording path,
time offset/window, and channels in PNG text chunks so dropping a
screenshot back onto the app restores that exact view (a "view
checkpoint", SURVEY.md section 5.4).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

__all__ = ["view_metadata", "save_view_screenshot", "write_view_metadata",
           "read_png_metadata", "parse_view_metadata"]

_KEYS = ("audian-file", "audian-toffset", "audian-twindow",
         "audian-channels")


def view_metadata(browser):
    """Metadata dict describing the browser's current view."""
    return {
        "audian-file": str(browser.data.file_path),
        "audian-toffset": f"{browser.toffset:.6f}",
        "audian-twindow": f"{browser.twindow:.6f}",
        "audian-channels": ",".join(str(c) for c in browser.show_channels),
    }


def save_view_screenshot(fig, browser, path, **kwargs):
    """Save a matplotlib figure as PNG with the view metadata embedded."""
    path = Path(path)
    fig.savefig(path, metadata=view_metadata(browser), **kwargs)
    return path


def write_view_metadata(path, browser):
    """Inject the view metadata as tEXt chunks into an existing PNG
    (stdlib only) — used by frontends whose savers can't embed metadata
    themselves (e.g. Qt's ``QPixmap.save``)."""
    path = Path(path)
    buf = path.read_bytes()
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    iend = buf.rfind(b"IEND")
    if iend < 4:
        raise ValueError(f"{path}: malformed PNG")
    insert = bytearray()
    for key, val in view_metadata(browser).items():
        try:
            # tEXt carries latin-1 only
            body = key.encode("latin-1") + b"\x00" + val.encode("latin-1")
            chunk = b"tEXt" + body
        except UnicodeEncodeError:
            # recording paths can carry any unicode: emit iTXt (UTF-8,
            # uncompressed) like matplotlib's own tEXt->iTXt fallback
            body = (key.encode("latin-1") + b"\x00"     # keyword
                    + b"\x00\x00"                        # no compression
                    + b"\x00" + b"\x00"                  # lang, translated
                    + val.encode("utf-8"))
            chunk = b"iTXt" + body
        insert += struct.pack(">I", len(body)) + chunk + struct.pack(
            ">I", zlib.crc32(chunk) & 0xFFFFFFFF)
    path.write_bytes(buf[: iend - 4] + bytes(insert) + buf[iend - 4 :])
    return path


def read_png_metadata(path):
    """All tEXt/zTXt/iTXt entries of a PNG as a dict (stdlib only)."""
    buf = Path(path).read_bytes()
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    meta = {}
    pos = 8
    while pos + 8 <= len(buf):
        (length,) = struct.unpack_from(">I", buf, pos)
        ctype = buf[pos + 4 : pos + 8]
        body = buf[pos + 8 : pos + 8 + length]
        if ctype == b"tEXt":
            key, _, val = body.partition(b"\x00")
            meta[key.decode("latin-1")] = val.decode("latin-1")
        elif ctype == b"zTXt":
            key, _, rest = body.partition(b"\x00")
            if rest[:1] == b"\x00":
                try:
                    meta[key.decode("latin-1")] = zlib.decompress(
                        rest[1:]).decode("latin-1")
                except zlib.error:
                    pass  # corrupted chunk: skip, keep scanning
        elif ctype == b"iTXt":
            key, _, rest = body.partition(b"\x00")
            if len(rest) >= 2:
                comp_flag, comp_method = rest[0], rest[1]
                rest = rest[2:]
                # skip language tag and translated keyword
                rest = rest.partition(b"\x00")[2].partition(b"\x00")[2]
                try:
                    text = zlib.decompress(rest) if comp_flag else rest
                except zlib.error:
                    pos += 12 + length
                    continue  # corrupted chunk: skip, keep scanning
                meta[key.decode("latin-1")] = text.decode("utf-8", "replace")
        elif ctype == b"IEND":
            break
        pos += 12 + length
    return meta


def parse_view_metadata(path):
    """View parameters from a screenshot, or None when it carries none
    (`audian.py:232-260` restores the view from these on drag-drop)."""
    meta = read_png_metadata(path)
    if "audian-file" not in meta:
        return None
    out = {
        "file": meta["audian-file"],
        "toffset": float(meta.get("audian-toffset", 0.0)),
        "twindow": float(meta.get("audian-twindow", 2.0)),
    }
    ch = meta.get("audian-channels", "")
    out["channels"] = [int(c) for c in ch.split(",") if c.strip()]
    return out
