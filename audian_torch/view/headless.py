"""Headless plot objects for the view-model.

The reference's ``DataBrowser`` owns pyqtgraph plots wired into ``Panels``
and ``PlotRanges`` (`src/audian/databrowser.py:347-442`).  The port, like
``audian_tpu/view/headless.py``, keeps that ownership in the *headless*
controller: these duck-typed axes
satisfy the interfaces :class:`~audian_torch.view.panels.Panel` and
:class:`~audian_torch.view.plotranges.PlotRange` expect (``range``,
``setXRange``/``setYRange``/``setZRange``, ``setLimits``, ``amplitudes``,
``data_items``, crosshair lines), so the full range/panel verb surface
works without any GUI; frontends read the resulting range state back and
draw from device tiles.
"""

from __future__ import annotations

import numpy as np

from .render import pick_amplitude, power_value

__all__ = ["HeadlessLine", "HeadlessMarker", "TraceDataItem",
           "SpecDataItem", "HeadlessAx", "build_view_model"]


class HeadlessLine:
    """Crosshair line stand-in (pyqtgraph InfiniteLine surface)."""

    def __init__(self):
        self.pos = None
        self.visible = False

    def setPos(self, pos):
        self.pos = pos

    def setVisible(self, visible):
        self.visible = bool(visible)


class HeadlessMarker:
    """Stored-marker stand-in (setData/point surface)."""

    def __init__(self):
        self.x = None
        self.y = None
        self.visible = False

    def setData(self, x, y):
        self.x, self.y = x, y
        self.visible = True

    def setVisible(self, visible):
        self.visible = bool(visible)


class TraceDataItem:
    """Headless analog of the reference's ``TraceItem``
    (`src/audian/traceitem.py:10-104`): amplitude lookups over one trace
    on one channel."""

    def __init__(self, browser, name, channel):
        self.browser = browser
        self.name = name
        self.channel = channel

    @property
    def trace(self):
        return self.browser.data[self.name]

    def isVisible(self):
        return self.browser.data.is_visible(self.name)

    def get_amplitude(self, t, x, t1=None):
        """Snap-to-extremum amplitude pick (`traceitem.py:85-104`)."""
        return pick_amplitude(self.trace, t, x, t1, self.channel)

    def amplitudes(self, t0, t1):
        """Window min/max for auto-scaling (`timeplot.py:111-123`): a
        reduction where the window lies, pulling two floats per channel
        instead of the window slice."""
        from .render import window_extrema

        return window_extrema(self.trace, t0, t1, self.channel)

    def update_plot(self):
        pass


class _SpecLevels:
    """``item.data`` adapter for :meth:`PlotRange.set_powers`."""

    def __init__(self, browser):
        self.browser = browser

    def estimate_noiselevels(self, channel):
        return self.browser.estimate_power_levels(channel)


class SpecDataItem:
    """Headless analog of ``SpecItem`` (`src/audian/specitem.py:11-39`):
    per-pixel power lookups plus noise-level estimation."""

    def __init__(self, browser, name, channel):
        self.browser = browser
        self.name = name
        self.channel = channel
        self.data = _SpecLevels(browser)

    @property
    def trace(self):
        return self.browser.data[self.name]

    def isVisible(self):
        return self.browser.data.is_visible(self.name)

    def get_power(self, t, f):
        """dB power at (t, f) (`specitem.py:23-30`).

        Looked up through the cached hover block
        (:func:`~audian_torch.view.render.power_value`): indexing the
        window on the card directly would pay a device round trip per
        mouse-motion event.
        """
        trace = self.trace
        i = int(t * trace.rate) - trace.offset
        freqs = trace.frequencies
        j = int(np.argmin(np.abs(freqs - f)))
        if not 0 <= i < len(trace.buffer):
            return None
        p = power_value(trace, i, self.channel, j)
        return 10 * np.log10(max(p, 1e-20))

    def amplitudes(self, t0, t1):
        trace = self.trace
        return 0.0, float(trace.frequencies[-1])

    def update_plot(self):
        pass


class PowerSideItem:
    """Stand-in for the live power side plot's data item: it must not
    report data amplitudes, or range verbs like ``auto`` on the power
    letter would reset the user's dB color levels to the frequency
    extent (the reference's PowerPlot likewise exposes no amplitudes)."""

    def __init__(self, item):
        self._item = item

    @property
    def data(self):
        return self._item.data

    def isVisible(self):
        return self._item.isVisible()

    def amplitudes(self, t0, t1):
        return None, None

    def update_plot(self):
        pass


class HeadlessAx:
    """One per (panel, channel): holds range/limit/visibility state and
    the crosshair lines; satisfies both the Panel and PlotRange plot
    interfaces."""

    def __init__(self, browser, channel, axspec, data_items=()):
        self.browser = browser
        self.channel = channel
        self.axspec = axspec
        self.data_items = list(data_items)
        self.visible = True
        self.grids = (False, False)
        self.limits = {}
        self.xrange = None
        self.yrange = None
        self.zrange = None
        self.xline = HeadlessLine()
        self.yline = HeadlessLine()
        self.stored_marker = HeadlessMarker()
        self.starttime_mode = 0

    # letters -------------------------------------------------------------------
    def x(self):
        return self.axspec[0]

    def y(self):
        return self.axspec[1] if len(self.axspec) > 1 else ""

    def z(self):
        return self.axspec[2] if len(self.axspec) > 2 else ""

    # PlotRange interface ---------------------------------------------------------
    def range(self, letter):
        """(rmin, rmax, rstep) for one axis letter, derived from the
        browser's data (the reference absorbs these from the plot items'
        data limits)."""
        b = self.browser
        from .panels import Panel

        if letter in Panel.times:
            tmax = b.data.frames / b.data.rate
            return 0.0, tmax, min(10.0, tmax)  # `timeplot.py:86-91`
        if letter in Panel.amplitudes:
            lo, hi = -1.0, 1.0
            for item in self.data_items:
                trace = getattr(item, "trace", None)
                if trace is not None and hasattr(trace, "ampl_min"):
                    lo = min(lo, float(trace.ampl_min))
                    hi = max(hi, float(trace.ampl_max))
            return lo, hi, 1.0  # astep (`timeplot.py:97`)
        if letter in Panel.frequencies:
            # deliberate deviation: the reference falls through to the
            # amplitude branch (astep 1 Hz) for frequency axes, which
            # makes edge-step verbs uselessly slow; step by fmax/16
            fmax = b.data.rate / 2
            return 0.0, fmax, fmax / 16
        if letter in Panel.powers:
            # `spectrogramplot.py:167-176` z-range for p letters
            return -200.0, 20.0, 5.0
        return None, None, None

    def setLimits(self, **kw):
        self.limits.update(kw)

    def setXRange(self, r0, r1):
        self.xrange = (r0, r1)

    def setYRange(self, r0, r1):
        self.yrange = (r0, r1)

    def setZRange(self, r0, r1):
        self.zrange = (r0, r1)

    def amplitudes(self, t0, t1):
        """Data extrema over the visible items, or ``(None, None)`` when
        nothing is visible — a (0, 0) fallback would let auto-scale
        collapse the range to zero width, wedging every zoom/pan verb
        (they all scale by the window width)."""
        lo = hi = None
        for item in self.data_items:
            if not item.isVisible():
                continue
            a0, a1 = item.amplitudes(t0, t1)
            if a0 is None or a1 is None:
                continue  # side items report (None, None) — skip, don't
                          # compare None against a float from another item
            lo = a0 if lo is None or a0 < lo else lo
            hi = a1 if hi is None or a1 > hi else hi
        return lo, hi

    def set_starttime(self, mode):
        self.starttime_mode = mode

    def set_stored_marker(self, x, y):
        self.stored_marker.setData(x, y)

    # Panel interface --------------------------------------------------------------
    def isVisible(self):
        return self.visible

    def setVisible(self, visible):
        self.visible = bool(visible)

    def getViewBox(self):
        return self

    def add_item(self, plot_item, is_data=False):
        self.data_items.append(plot_item)

    def update_plot(self):
        for item in self.data_items:
            if item.isVisible():
                item.update_plot()

    def showGrid(self, x=False, y=False, alpha=0.8):
        self.grids = (x, y)

    def setColorMap(self, color_map):
        self.color_map = color_map


def build_view_model(browser):
    """Create the browser's ``Panels`` + ``PlotRanges`` over headless axes
    — the controller-side twin of the reference's per-channel figure
    construction (`src/audian/databrowser.py:347-442`)."""
    from .panels import Panels
    from .plotranges import PlotRanges

    panels = Panels()
    panels.add_trace("trace")
    if browser.spectrogram:
        panels.add_spectrogram("spectrogram")
    panels.fill(browser.data)

    ranges = PlotRanges()
    ranges.setup(browser.data.channels)

    for name, panel in list(panels.items()):
        if panel.is_spacer() or panel.is_power():
            continue
        for c in range(browser.data.channels):
            items = []
            for trace in browser.data.traces:
                if getattr(trace, "panel", None) != name:
                    continue
                if panel.is_spectrogram():
                    items.append(SpecDataItem(browser, trace.name, c))
                else:
                    items.append(TraceDataItem(browser, trace.name, c))
            ax = HeadlessAx(browser, c, panel.ax_spec, items)
            panel.add_ax(panel.row, ax)
            ranges.add_plot(ax)
            if panel.is_spectrogram():
                pname = name + "-power"
                if pname in panels:
                    pax = HeadlessAx(browser, c, panels[pname].ax_spec,
                                     [PowerSideItem(i) for i in items])
                    panels[pname].add_ax(panels[pname].row, pax)
                    ranges.add_plot(pax)
    ranges.set_limits()
    return panels, ranges
