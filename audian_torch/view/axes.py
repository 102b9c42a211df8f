"""Axis tick geometry and time label formatting (pure functions).

The math core of the reference's custom axis items
(`src/audian/timeaxisitem.py:11-221`, `src/audian/yaxisitem.py:7-46`),
decoupled from Qt: width-aware 1/2/5 tick spacing, the three time label
modes (recording-relative / absolute time of day / per-file), and
h:m:s[.fraction] formatting.  GUI frontends wrap these in their own axis
widgets.
"""

from __future__ import annotations

import datetime as dt
from math import floor, log10

import numpy as np

__all__ = [
    "tick_spacing",
    "time_label_width",
    "format_time_ticks",
    "REC_TIME", "ABS_TIME", "FILE_TIME",
]

#: tick values relative to the start of the recording
REC_TIME = 0
#: tick values as absolute time of day (start time added)
ABS_TIME = 1
#: tick values relative to each file's beginning
FILE_TIME = 2


def tick_spacing(vmin, vmax, size_px, label_px):
    """Major and minor tick spacing for a span rendered at ``size_px``
    pixels with labels ``label_px`` wide: the densest of the 1/2/5
    progression that keeps labels from colliding
    (`timeaxisitem.py:98-117`, `yaxisitem.py:19-46`).

    Returns ``(major, minor)`` or None for an empty span.
    """
    diff = abs(vmax - vmin)
    if diff == 0:
        return None
    max_ticks = max(2, int(size_px / max(label_px, 1)))
    min_spacing = diff / max_ticks
    p10 = 10 ** floor(log10(min_spacing))
    major = 100.0 * p10
    for fac in (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0):
        if fac * p10 >= min_spacing:
            major = fac * p10
            break
    minor = major
    for fac in (100.0, 10.0, 1.0, 0.1):
        minor = fac * p10
        if minor < major:
            break
    return major, minor


def time_label_width(max_value, spacing, mode=REC_TIME, has_starttime=False):
    """Estimated character count of a time tick label
    (`timeaxisitem.py:77-97`)."""
    if has_starttime and mode == ABS_TIME:
        nx = 8
    elif max_value < 1.0:
        nx = 0
    elif max_value >= 3600:
        nx = 8
    elif max_value >= 60:
        nx = 5
    else:
        nx = 2
    if spacing < 0.00001:
        nx += 7
    elif spacing < 0.0001:
        nx += 6
    elif spacing < 0.001:
        nx += 5
    elif spacing < 1.0:
        nx += 4
    return nx + 4


def _fraction(spacing, microsecond):
    if spacing < 0.00001:
        return f"{1.0 * microsecond:06.0f}"
    if spacing < 0.0001:
        return f"{0.1 * microsecond:05.0f}"
    if spacing < 0.001:
        return f"{0.01 * microsecond:04.0f}"
    return f"{0.001 * microsecond:03.0f}"


def format_time_ticks(values, spacing, mode=REC_TIME, starttime=None,
                      file_times=None, file_paths=None, add_date=False,
                      scale=1.0):
    """Render tick values to strings in the requested time mode.

    Returns ``(label, units, strings, filename)`` with the same semantics
    as the reference's ``makeStrings`` (`timeaxisitem.py:120-195`): mode
    falls back to recording time when no start time / only one file is
    known; units switch between s, m:s, and h:m:s by the span; fractions
    scale with the tick spacing.
    """
    values = list(values)
    file_paths = list(file_paths or [])
    file_times = np.asarray(file_times if file_times is not None else [0.0])
    filename = file_paths[0] if file_paths else None
    if not values:
        return None, None, [], filename
    if scale > 1:
        return "Time", "s", [f"{v * scale:.5g}" for v in values], filename
    if mode == ABS_TIME and not starttime:
        mode = REC_TIME
    if mode == FILE_TIME and len(file_times) <= 1:
        mode = REC_TIME

    if mode == ABS_TIME:
        label = "Time"
    elif mode == FILE_TIME:
        label = "File"

        def file_of(t):
            # tick generators emit values slightly outside the view;
            # anything before the first file belongs to the first file
            hits = np.nonzero(file_times <= t)[0]
            return int(hits[-1]) if len(hits) else 0

        fidx = file_of(values[0])
        if fidx < len(file_paths):
            filename = file_paths[fidx]
        # ticks slightly before t=0 clamp to 0 (negative in-file times
        # overflow the datetime-based formatter)
        values = [max(t - file_times[file_of(t)], 0.0) for t in values]
    else:
        label = "REC"
    if mode != ABS_TIME:
        # relative modes format through datetime(1,1,1): negative ticks
        # (emitted by GUI tick generators at the view edge) would overflow
        values = [max(v, 0.0) for v in values]
    max_value = max(values)

    if mode == ABS_TIME:
        if add_date:
            units = "Y-M-D h:m:s"
            fs = ("{year:04d}-{month:02d}-{day:02d} "
                  "{hours:.0f}:{mins:02.0f}:{secs:02.0f}")
        else:
            units = "h:m:s"
            fs = "{hours:.0f}:{mins:02.0f}:{secs:02.0f}"
    elif max_value > 3600:
        units = "h:m:s"
        fs = "{hours:.0f}:{mins:02.0f}:{secs:02.0f}"
    elif max_value > 60:
        units = "m:s"
        fs = "{mins:.0f}:{secs:02.0f}"
    else:
        units = "s"
        fs = "{secs:.0f}"
        spacing = 0.01
    if spacing < 1:
        fs += ".{micros}"

    strings = []
    for t in values:
        if mode == ABS_TIME:
            # wall-clock display: datetime components (wrapping at 24 h
            # is correct here — the date carries the day)
            d = starttime + dt.timedelta(seconds=float(t))
            strings.append(fs.format(
                year=d.year, month=d.month, day=d.day, hours=d.hour,
                mins=d.minute, secs=d.second,
                micros=_fraction(spacing, d.microsecond)))
            continue
        # relative modes label TOTAL elapsed time: datetime components
        # wrap at 24 h / 60 m (a 25 h recording would relabel as 1:00:00,
        # and the 3600 s tick of an m:s axis as 0:00)
        tv = float(t)
        whole = int(tv)
        micros = int(round((tv - whole) * 1e6))
        if micros >= 1_000_000:  # float rounding at the next second
            whole += 1
            micros = 0
        if "hours" in fs:
            hours, mins, secs = whole // 3600, (whole // 60) % 60, whole % 60
        elif "mins" in fs:
            hours, mins, secs = 0, whole // 60, whole % 60
        else:
            hours, mins, secs = 0, 0, whole
        strings.append(fs.format(
            year=1, month=1, day=1, hours=hours, mins=mins, secs=secs,
            micros=_fraction(spacing, micros)))
    return label, units, strings, filename
