"""``audian-compress`` on the port: precompute the min/max overview of a
recording.

The counterpart of ``audian_tpu/cli/compress.py`` (the reference's
``compresseddata.main``): the same flags (``-i`` loader keyword arguments,
``-u``/``-U`` unwrap, ``-p`` resolution, ``--version``) and the same
artifact, ``<stem>-fulltrace.wav`` next to the data, computed by
:class:`~audian_torch.cache.fulltrace.FullTraceData`: a WAV by the native
C++ threads, a recording the loader holds whole on the card, the rest in
numpy.

    python -m audian_torch.cli.compress recording.flac [-p 6000]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from ..cache.fulltrace import FullTraceData
from ..data.loader import AudioLoader
from ..utils import resolve_device
from ..version import __version__, __year__

__all__ = ["main", "parse_load_kwargs"]


def parse_load_kwargs(pairs):
    """Parse ``key=value`` strings (comma-separated, repeatable) into
    loader keyword arguments, numbers converted (the audioio
    ``parse_load_kwargs`` contract)."""
    kwargs = {}
    for item in pairs:
        for part in str(item).split(","):
            if not part.strip():
                continue
            key, _, value = part.partition("=")
            value = value.strip()
            try:
                value = int(value)
            except ValueError:
                try:
                    value = float(value)
                except ValueError:
                    pass
            kwargs[key.strip()] = value
    return kwargs


def main(cargs=None, device=None):
    """Run the CLI on ``cargs`` (``sys.argv[1:]`` by default); a recording
    held whole reduces on ``device`` (the CUDA card by default; "cpu" on
    the host).  Returns the exit status."""
    parser = argparse.ArgumentParser(
        description="Compress timeseries data for audian.",
        epilog=f"version {__version__} (audian_torch, 2026-{__year__})",
    )
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument("-i", dest="load_kwargs", default=[],
                        action="append", metavar="KWARGS",
                        help="key-word arguments for the data loader")
    parser.add_argument("-u", dest="unwrap", default=0, type=float,
                        metavar="THRESH", const=1.5, nargs="?",
                        help="unwrap clipped data and downscale by two")
    parser.add_argument("-U", dest="unwrap_clip", default=0, type=float,
                        metavar="THRESH", const=1.5, nargs="?",
                        help="unwrap clipped data and clip")
    parser.add_argument("-p", dest="max_pixel", default=6000, type=int,
                        help="overview resolution in columns (default 6000)")
    parser.add_argument("files", nargs="+", type=str,
                        help="files with the time series data")
    args = parser.parse_args(cargs)
    device = resolve_device(device)

    unwrap, unwrap_clip = args.unwrap, False
    if args.unwrap_clip > 1e-3:
        unwrap, unwrap_clip = args.unwrap_clip, True

    files = []
    if os.name == "nt":
        for fn in args.files:
            files.extend(sorted(glob.glob(fn)))
    else:
        files = args.files

    load_kwargs = parse_load_kwargs(args.load_kwargs)
    try:
        data = AudioLoader(files, **load_kwargs)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        if unwrap > 1e-3:
            data.set_unwrap(unwrap, unwrap_clip)
        ft = FullTraceData(data, device=device)
        ft.start(args.max_pixel, background=False)
        if ft.error is not None:
            # a swallowed read error would persist a zero-filled overview
            # that every later open then prefers over a recomputation
            print(f"error: fulltrace computation failed: {ft.error}",
                  file=sys.stderr)
            return 1
        ft.short_data = False  # the CLI always persists
        path = ft.save_data_local()
    finally:
        data.close()
    if path is not None:
        print(f"saved fulltrace to {path}")
    return 0


def run():
    return main(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(run())
