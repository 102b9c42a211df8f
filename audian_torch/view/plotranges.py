"""Shared axis ranges across panels and channels.

One :class:`PlotRange` per axis letter (alphabets in
:mod:`audian_torch.view.panels`) owns the per-channel view windows, the
global limits, and the zoom/pan/step/auto/home/end/snap verb surface of
the reference (`src/audian/plotranges.py:15-666`); :class:`PlotRanges`
links the letters so "zoom amplitude" acts on every panel and file
sharing that letter.  The crosshair and stored-marker positions with
their delta readouts live here too.

The implementation differs from the reference by design: plots attach as
(role, channel, ax) records rather than per-role lists, and every verb is
a window transform ``(lo, hi) -> (lo', hi')`` funneled through one clamp
+ broadcast engine.

Axes are duck-typed (``range(axspec)``, ``setXRange``/``setYRange``/
``setZRange``, ``setLimits``, ``amplitudes(t0, t1)``), so the same logic
drives headless tests and any GUI frontend.
"""

from __future__ import annotations

import math

import numpy as np

from .panels import (TIME_AXES, AMPLITUDE_AXES, FREQUENCY_AXES, POWER_AXES,
                     axis_kind)

__all__ = ["PlotRange", "PlotRanges"]

#: verbs PlotRanges broadcasts to every axis letter of an axspec string
VERBS = (
    "zoom_in", "zoom_out", "zoom_in_centered", "zoom_out_centered",
    "down", "up", "small_down", "small_up", "step_down", "step_up",
    "min_down", "min_up", "max_down", "max_up", "home", "end", "snap",
    "auto", "reset", "center",
)

#: duck-typed setter per axis role
_RANGE_SETTER = {"x": "setXRange", "y": "setYRange", "z": "setZRange"}

#: setLimits keyword names per role (z axes carry no limits)
_LIMIT_KEYS = {"x": ("xMin", "xMax", "minXRange", "maxXRange"),
               "y": ("yMin", "yMax", "minYRange", "maxYRange")}

#: smallest window as a fraction of the full span
_ZOOM_FLOOR = 2.0 ** -16


def _finite(v):
    return v is not None and np.isfinite(v)


class _Cursor:
    """One marker slot: which channel/plot it sits on and where."""

    __slots__ = ("channel", "ax", "pos")

    def __init__(self):
        self.clear()

    def clear(self):
        self.channel = None
        self.ax = None
        self.pos = None

    def copy_from(self, other):
        self.channel = other.channel
        self.ax = other.ax
        self.pos = other.pos


class PlotRange:
    """Range state of one axis letter."""

    def __init__(self, axspec, nchannels):
        self.axspec = axspec
        self.rmin = None       # global lower limit over all attached plots
        self.rmax = None       # global upper limit
        self.rstep = None      # finest data-derived step
        self.min_dr = None     # smallest allowed window width
        self.r0 = [None] * nchannels
        self.r1 = [None] * nchannels
        self._plots = []       # (role, channel, ax) attachments
        self._cursor = _Cursor()   # live crosshair
        self._anchor = _Cursor()   # stored marker

    def __repr__(self):
        span = "unset" if self.r0[0] is None else \
            f"[{self.r0[0]:.6g}, {self.r1[0]:.6g}]"
        lim = f"{self.rmin}..{self.rmax}"
        return f"PlotRange({self.axspec!r}, {span}, limits={lim})"

    __str__ = __repr__

    # -- attachment ---------------------------------------------------------------

    def _attach(self, role, ax, channel):
        lo, hi, step = ax.range(self.axspec)
        if lo is not None:
            self.rmin = lo if self.rmin is None else min(self.rmin, lo)
        if hi is not None:
            self.rmax = hi if self.rmax is None else max(self.rmax, hi)
        if step is not None:
            self.rstep = step if self.rstep is None else min(self.rstep, step)
        self._plots.append((role, channel, ax))

    def add_xaxis(self, ax, channel):
        self._attach("x", ax, channel)

    def add_yaxis(self, ax, channel):
        self._attach("y", ax, channel)

    def add_zaxis(self, ax, channel):
        self._attach("z", ax, channel)

    def _axes(self, role=None, channel=None):
        for r, c, ax in self._plots:
            if (role is None or r == role) and \
               (channel is None or c == channel):
                yield ax

    def is_used(self):
        return bool(self._plots)

    def plots(self, role=None, channel=None):
        """The attached plot objects, optionally filtered by axis role
        ('x'/'y'/'z') and channel."""
        return list(self._axes(role, channel))

    # -- classification -----------------------------------------------------------

    def is_time(self):
        return axis_kind(self.axspec) == "time"

    def is_amplitude(self):
        return axis_kind(self.axspec) == "amplitude"

    def is_frequency(self):
        return axis_kind(self.axspec) == "frequency"

    def is_power(self):
        return axis_kind(self.axspec) == "power"

    def _signed(self):
        """Signed axes zoom about their center, positive axes from r0."""
        return self.rmin is not None and self.rmin < 0

    # -- queries ------------------------------------------------------------------

    def at_end(self, channel=0):
        return self.rmax is not None and self.r1[channel] >= self.rmax

    def at_home(self, channel=0):
        return self.rmin is None or self.r0[channel] <= self.rmin

    def set_starttime(self, mode):
        for ax in self._axes("x"):
            ax.set_starttime(mode)

    # -- limits -------------------------------------------------------------------

    def set_limits(self):
        """Compute the zoom floor, push limits into the plots, and reset
        all channels to their initial windows."""
        if not self.is_used():
            return
        bounded = _finite(self.rmin) and _finite(self.rmax)
        if bounded:
            # time axes may zoom to 1 ms; others to a fixed span fraction
            self.min_dr = 0.001 if self.is_time() else \
                (self.rmax - self.rmin) * _ZOOM_FLOOR
        else:
            self.min_dr = 2 * _ZOOM_FLOOR
        for role, keys in _LIMIT_KEYS.items():
            kmin, kmax, kwidth_lo, kwidth_hi = keys
            for ax in self._axes(role):
                kw = {}
                if _finite(self.rmin):
                    kw[kmin] = self.rmin
                if _finite(self.rmax):
                    kw[kmax] = self.rmax
                if bounded:
                    kw[kwidth_lo] = self.min_dr
                    kw[kwidth_hi] = self.rmax - self.rmin
                if kw:
                    ax.setLimits(**kw)
        start = self.rmin if _finite(self.rmin) else -1.0
        stop = 10.0 if self.is_time() else self.rmax
        if not _finite(stop):
            stop = 1.0
        for c in range(len(self.r0)):
            self.r0[c] = start
            self.r1[c] = stop

    # -- the range engine ----------------------------------------------------------

    def _targets(self, channels):
        """Channels a verb acts on; time axes always act on all (their
        window is shared)."""
        if channels is None or self.is_time():
            return range(len(self.r0))
        return channels

    def _has_plots(self, channel):
        return any(True for _ in self._axes(channel=channel))

    def _clamp(self, lo, hi):
        """Slide the window back inside the limits, preserving its width
        where possible (time axes may overrun the end)."""
        width = hi - lo
        if self.rmin is not None and lo < self.rmin:
            lo = self.rmin
            hi = lo + width
        if self.rmax is not None and hi > self.rmax and not self.is_time():
            hi = self.rmax
            lo = hi - width
            if self.rmin is not None and lo < self.rmin:
                lo = self.rmin
        return lo, hi

    def _push(self, channel):
        lo, hi = self.r0[channel], self.r1[channel]
        for role, c, ax in self._plots:
            if c == channel:
                getattr(ax, _RANGE_SETTER[role])(lo, hi)

    def set_ranges(self, r0=None, r1=None, dr=None, channels=None,
                   do_set=True):
        """Set the window on the given channels, clamped to the limits.

        Any of ``r0``/``r1``/``dr`` may be given; a missing edge keeps its
        current value, ``dr`` pins the width to the given edge.  On time
        axes the first resolved window is broadcast to every channel.
        """
        if not self.is_used():
            return
        shared = None   # resolved time window, broadcast to all channels
        for c in self._targets(channels):
            if not self._has_plots(c):
                continue
            if shared is None:
                lo = self.r0[c] if r0 is None else r0
                hi = self.r1[c] if r1 is None else r1
                if dr is not None:
                    if r1 is None:
                        hi = lo + dr
                    else:
                        lo = hi - dr
                lo, hi = self._clamp(lo, hi)
                if self.is_time():
                    shared = (lo, hi)
            else:
                lo, hi = shared
            self.r0[c], self.r1[c] = lo, hi
            if do_set:
                self._push(c)

    def _remap(self, transform, channels=None, do_set=True):
        """Run a window transform per channel.  ``transform(lo, hi)``
        returns the new window or None to leave the channel alone."""
        if not self.is_used():
            return
        targets = self._targets(channels)
        if self.is_time():
            # shared window: transform once, set_ranges broadcasts
            targets = list(targets)[:1]
        for c in targets:
            out = transform(self.r0[c], self.r1[c])
            if out is not None:
                self.set_ranges(out[0], out[1], None, [c], do_set)

    # -- zoom verbs -----------------------------------------------------------------

    def zoom_in(self, channels=None, do_set=True):
        def shrink(lo, hi):
            width = hi - lo
            if width <= self.min_dr:
                return None
            if self._signed():
                mid = (lo + hi) / 2
                return mid - width / 4, mid + width / 4
            return lo, lo + width / 2

        self._remap(shrink, channels, do_set)

    def zoom_out(self, channels=None, do_set=True):
        def grow(lo, hi):
            width = hi - lo
            if self._signed():
                mid = (lo + hi) / 2
                return mid - width, mid + width
            return lo, lo + 2 * width

        self._remap(grow, channels, do_set)

    def zoom_in_centered(self, channels=None, do_set=True):
        def shrink(lo, hi):
            width = hi - lo
            if width <= self.min_dr:
                return None
            mid = (lo + hi) / 2
            return mid - width / 4, mid + width / 4

        self._remap(shrink, channels, do_set)

    def zoom_out_centered(self, channels=None, do_set=True):
        def grow(lo, hi):
            width = hi - lo
            mid = (lo + hi) / 2
            return mid - width, mid + width

        self._remap(grow, channels, do_set)

    # -- pan verbs ------------------------------------------------------------------

    def goto(self, pos, channels=None, do_set=True):
        self._remap(
            lambda lo, hi: (pos, pos + (hi - lo)) if lo != pos else None,
            channels, do_set)

    def _slide(self, offset, channels, do_set):
        """Translate the window, skipping channels already pinned against
        the limit being moved towards."""
        lo_lim = -np.inf if self.rmin is None else self.rmin
        hi_lim = np.inf if self.rmax is None else self.rmax

        def shift(lo, hi):
            blocked = hi >= hi_lim if offset > 0 else lo <= lo_lim
            return None if blocked else (lo + offset, hi + offset)

        self._remap(shift, channels, do_set)

    def move(self, move_fac, channels=None, do_set=True):
        """Pan by a fraction of the current width."""
        if not self.is_used():
            return
        for c in self._targets(channels):
            width = self.r1[c] - self.r0[c]
            self._slide(move_fac * width, [c], do_set)
            if self.is_time():
                break

    def down(self, channels=None, do_set=True):
        self.move(-0.5, channels, do_set)

    def up(self, channels=None, do_set=True):
        self.move(+0.5, channels, do_set)

    def small_down(self, channels=None, do_set=True):
        self.move(-0.05, channels, do_set)

    def small_up(self, channels=None, do_set=True):
        self.move(+0.05, channels, do_set)

    def step_down(self, channels=None, do_set=True):
        if self.rstep is not None:
            self._slide(-self.rstep, channels, do_set)

    def step_up(self, channels=None, do_set=True):
        if self.rstep is not None:
            self._slide(+self.rstep, channels, do_set)

    # -- edge verbs -----------------------------------------------------------------

    def _move_edge(self, which, delta, channels, do_set):
        """Move one window edge by ``delta``, refusing moves that would
        collapse the window (the reference leans on pyqtgraph's viewbox
        minXRange for this; the headless model must enforce it itself)
        or cross the corresponding limit."""
        if self.rstep is None:
            return
        lo_lim = -np.inf if self.rmin is None else self.rmin
        hi_lim = np.inf if self.rmax is None else self.rmax
        floor = self.min_dr or 0.0

        def shift(lo, hi):
            if which == "lo":
                if delta > 0:  # raising the min must keep width > floor
                    new = lo + delta
                    return (new, hi) if hi - new > floor else None
                return (lo + delta, hi) if lo > lo_lim else None
            if delta > 0:
                return (lo, hi + delta) if hi < hi_lim else None
            new = hi + delta   # lowering the max must keep width > floor
            return (lo, new) if new - lo > floor else None

        self._remap(shift, channels, do_set)

    def min_down(self, channels=None, do_set=True):
        self._move_edge("lo", -(self.rstep or 0), channels, do_set)

    def min_up(self, channels=None, do_set=True):
        self._move_edge("lo", +(self.rstep or 0), channels, do_set)

    def max_down(self, channels=None, do_set=True):
        self._move_edge("hi", -(self.rstep or 0), channels, do_set)

    def max_up(self, channels=None, do_set=True):
        self._move_edge("hi", +(self.rstep or 0), channels, do_set)

    # -- jump verbs -----------------------------------------------------------------

    def home(self, channels=None, do_set=True):
        if self.rmin is None:
            return
        self._remap(
            lambda lo, hi: (self.rmin, self.rmin + (hi - lo))
            if lo > self.rmin else None,
            channels, do_set)

    def end(self, channels=None, do_set=True):
        """Jump to the end, with the window edge landed on a half-width
        grid so repeated paging tiles consistently."""
        if self.rmax is None:
            return

        def jump(lo, hi):
            if hi >= self.rmax:
                return None
            width = hi - lo
            stop = math.ceil(self.rmax / (0.5 * width)) * (0.5 * width)
            return stop - width, stop

        self._remap(jump, channels, do_set)

    def snap(self, channels=None, do_set=True):
        """Snap the width to 10·2^k and the offset to half-width
        multiples."""

        def align(lo, hi):
            width = 10 * 2 ** round(math.log2((hi - lo) / 10))
            start = round(lo / (width / 2)) * (width / 2)
            return start, start + width

        self._remap(align, channels, do_set)

    # -- data-driven verbs ------------------------------------------------------------

    def auto(self, t0, t1, channels=None, do_set=True):
        """Fit the range to the data extrema inside [t0, t1]."""
        if not self.is_used() or self.is_time():
            return
        if channels is None:
            channels = range(len(self.r0))
        lo = hi = None
        for c in channels:
            for role in ("x", "y"):
                for ax in self._axes(role, c):
                    a0, a1 = ax.amplitudes(t0, t1)
                    if a0 is None:
                        continue  # nothing visible on this plot
                    lo = a0 if lo is None else min(lo, a0)
                    hi = a1 if hi is None else max(hi, a1)
        if lo is None or lo == hi:
            return  # no visible data (or constant): keep the range
        self.set_ranges(lo, hi, None, channels, do_set)

    def reset(self, channels=None, do_set=True):
        if not self.is_used():
            return
        lo = self.rmin if _finite(self.rmin) else -1.0
        hi = self.rmax if _finite(self.rmax) else +1.0
        self.set_ranges(lo, hi, None, channels, do_set)

    def center(self, channels=None, do_set=True):
        """Symmetrize the window around zero."""
        if self.is_time():
            return
        self._remap(
            lambda lo, hi: (-max(abs(lo), abs(hi)), max(abs(lo), abs(hi))),
            channels, do_set)

    def set_powers(self):
        """Auto color levels from the noise floors of every spectrogram
        item attached to this power axis."""
        if not self.is_power():
            return
        lo = hi = None
        for role, c, ax in self._plots:
            if role != "z":
                continue
            for item in getattr(ax, "data_items", []):
                probe = getattr(getattr(item, "data", None),
                                "estimate_noiselevels", None)
                if probe is None:
                    continue
                z0, z1 = probe(c)
                if z0 is None or z1 is None:
                    continue
                lo = z0 if lo is None else min(lo, z0)
                hi = z1 if hi is None else max(hi, z1)
        if lo is not None and hi is not None:
            self.set_ranges(lo, hi)

    # -- markers ------------------------------------------------------------------
    # Exposed as flat attributes for API compatibility with the tests and
    # the controller; internally two _Cursor slots.

    marker_channel = property(
        lambda self: self._cursor.channel,
        lambda self, v: setattr(self._cursor, "channel", v))
    marker_ax = property(
        lambda self: self._cursor.ax,
        lambda self, v: setattr(self._cursor, "ax", v))
    marker_pos = property(
        lambda self: self._cursor.pos,
        lambda self, v: setattr(self._cursor, "pos", v))
    stored_marker_channel = property(
        lambda self: self._anchor.channel,
        lambda self, v: setattr(self._anchor, "channel", v))
    stored_marker_ax = property(
        lambda self: self._anchor.ax,
        lambda self, v: setattr(self._anchor, "ax", v))
    stored_marker_pos = property(
        lambda self: self._anchor.pos,
        lambda self, v: setattr(self._anchor, "pos", v))

    def clear_marker(self):
        self._cursor.clear()

    def set_marker(self, channel, ax, pos):
        self._cursor.channel = channel
        self._cursor.ax = ax
        self._cursor.pos = pos

    def _role_of(self, ax, channel):
        for role, c, a in self._plots:
            if c == channel and a is ax:
                return role
        return None

    def store_marker(self):
        """Freeze the crosshair as the stored marker; returns the plot it
        sits on plus the position in x or y, per this letter's role
        there."""
        self._anchor.copy_from(self._cursor)
        if self._anchor.channel is None:
            return None, None, None
        role = self._role_of(self._anchor.ax, self._anchor.channel)
        if role == "x":
            return self._anchor.ax, self._anchor.pos, None
        if role == "y":
            return self._anchor.ax, None, self._anchor.pos
        return None, None, None

    def clear_stored_marker(self):
        for role in ("x", "y"):
            for ax in self._axes(role):
                widget = getattr(ax, "stored_marker", None)
                if widget is not None:
                    widget.setVisible(False)
        self._anchor.clear()

    def update_crosshair(self):
        pos = self._cursor.pos
        for role, line_attr in (("x", "xline"), ("y", "yline")):
            for ax in self._axes(role):
                line = getattr(ax, line_attr)
                if pos is not None:
                    line.setPos(pos)
                line.setVisible(pos is not None)


def _broadcast(verb):
    """Make the PlotRanges method that fans ``verb`` out to every letter
    of an axspec string."""

    def dispatch(self, axspec, *args, **kwargs):
        for letter in axspec:
            getattr(self[letter], verb)(*args, **kwargs)

    dispatch.__name__ = verb
    dispatch.__doc__ = f"Apply :meth:`PlotRange.{verb}` to every letter."
    return dispatch


def _marker_query(letters, attr):
    """Make the PlotRanges readout returning (letter, value) of the first
    letter in ``letters`` whose ``attr`` is set."""

    def query(self):
        for letter in letters:
            value = getattr(self[letter], attr)
            if value is not None:
                return letter, value
        return None, None

    return query


def _delta_query(letters):
    """Make the readout of crosshair − stored-marker on the first letter
    carrying both."""

    def query(self):
        for letter in letters:
            r = self[letter]
            if r.marker_pos is not None and r.stored_marker_pos is not None:
                return letter, r.marker_pos - r.stored_marker_pos
        return None, None

    return query


class PlotRanges(dict):
    """All PlotRange objects keyed by axis letter, with verbs broadcast
    over axspec strings."""

    def setup(self, nchannels):
        for letter in TIME_AXES + AMPLITUDE_AXES + FREQUENCY_AXES \
                + POWER_AXES:
            self[letter] = PlotRange(letter, nchannels)

    def add_plot(self, ax):
        self[ax.x()].add_xaxis(ax, ax.channel)
        self[ax.y()].add_yaxis(ax, ax.channel)
        if ax.z():
            self[ax.z()].add_zaxis(ax, ax.channel)

    def set_limits(self):
        for r in self.values():
            r.set_limits()

    def set_ranges(self):
        for r in self.values():
            r.set_ranges()

    def set_powers(self):
        for r in self.values():
            r.set_powers()

    # -- markers -------------------------------------------------------------------

    def clear_marker(self):
        for r in self.values():
            r.clear_marker()

    def store_marker(self):
        """Freeze the crosshair everywhere; when one plot holds both an x
        and a y marker position, show the stored-marker widget there."""
        target = None
        xpos = ypos = None
        for r in self.values():
            r.clear_stored_marker()
            ax, x, y = r.store_marker()
            if ax is None:
                continue
            if target is None:
                target, xpos, ypos = ax, x, y
            elif target is ax:
                xpos = x if xpos is None else xpos
                ypos = y if ypos is None else ypos
        if target is not None and xpos is not None and ypos is not None:
            target.set_stored_marker(xpos, ypos)

    def clear_stored_marker(self):
        for r in self.values():
            r.clear_stored_marker()

    marker_time = _marker_query(TIME_AXES, "marker_pos")
    marker_amplitude = _marker_query(AMPLITUDE_AXES, "marker_pos")
    marker_frequency = _marker_query(FREQUENCY_AXES, "marker_pos")
    marker_power = _marker_query(POWER_AXES, "marker_pos")

    marker_delta_time = _delta_query(TIME_AXES)
    marker_delta_amplitude = _delta_query(AMPLITUDE_AXES)
    marker_delta_frequency = _delta_query(FREQUENCY_AXES)
    marker_delta_power = _delta_query(POWER_AXES)

    def update_crosshair(self):
        for r in self.values():
            r.update_crosshair()


# the verb surface: one broadcasting method per PlotRange verb
for _verb in VERBS:
    setattr(PlotRanges, _verb, _broadcast(_verb))
del _verb
