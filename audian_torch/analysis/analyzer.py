"""Region-analysis plugin protocol.

API-compatible rebuild of the reference's ``Analyzer`` base class
(`src/audian/analyzer.py:13-343`): subclasses add table columns in the
constructor, implement ``analyze(t0, t1, channel, traces)``, store rows
with ``store()``, and may plot event markers on traces or panels.

Event markers are abstracted behind the browser's
``make_event_item(trace_name=..., panel_name=..., channel=...)`` hook so
the same analyzer runs headless (markers recorded as data), under the
matplotlib frontend, or under Qt/pyqtgraph (real ScatterPlotItems).
"""

from __future__ import annotations

from math import floor, log10

import numpy as np

from .table import ResultTable

__all__ = ["Analyzer", "PlainAnalyzer", "EventRecorder"]


class EventRecorder:
    """Headless event sink with the pyqtgraph ScatterPlotItem call surface
    the reference's analyzers use (setData/addPoints/clear).

    Unlike the reference — which pushes real ScatterPlotItems into the
    plots at creation time (`src/audian/analyzer.py:186-252`,
    `databrowser.py:243-245`) — the recorder also remembers WHERE the
    events belong (channel + trace or panel), and the frontends pull the
    recorded points into their own plot items on every refresh.  The
    same analyzer therefore runs identically headless, under matplotlib,
    or under Qt."""

    def __init__(self, symbol=None, color=None, size=None,
                 channel=0, trace_name=None, panel_name=None):
        self.symbol = symbol
        self.color = color
        self.size = size
        self.channel = channel
        self.trace_name = trace_name
        self.panel_name = panel_name
        self.x = np.zeros(0)
        self.y = np.zeros(0)

    def setData(self, x, y):
        self.x = np.asarray(x, float)
        self.y = np.asarray(y, float)

    def addPoints(self, x, y):
        self.x = np.concatenate([self.x, np.asarray(x, float)])
        self.y = np.concatenate([self.y, np.asarray(y, float)])

    def clear(self):
        self.x = np.zeros(0)
        self.y = np.zeros(0)

    def owner_panel(self, browser):
        """Resolve the panel that owns these events — the single home of
        the placement rule both frontends render by
        (`databrowser.py:243-245`): a trace event lands in the panel
        showing the trace, a panel event in the named panel."""
        if self.trace_name is not None and self.trace_name in browser.data:
            return browser.data[self.trace_name].panel
        return self.panel_name


class Analyzer:
    """Base class for analyzing selected regions (see reference docstring
    at `src/audian/analyzer.py:14-100` for the full protocol)."""

    def __init__(self, browser, name, source_name):
        self.browser = browser
        self.name = name
        self.source_name = source_name
        self.source = self.trace(self.source_name)
        self.data = ResultTable()
        self.events = {}
        browser.add_analyzer(self)

    # -- protocol hooks ---------------------------------------------------------

    def analyze(self, t0, t1, channel, traces):
        """Called with the region's per-trace arrays; reimplement."""

    # -- helpers -----------------------------------------------------------------

    def clear(self):
        self.data.clear_data()
        for items in self.events.values():
            for item in items:
                item.clear()

    def traces(self):
        return self.browser.data.keys()

    def trace(self, name):
        data = self.browser.data
        return data[name] if name in data else None

    def make_column(self, label, unit=None, formats=None):
        self.data.append(label, unit, formats)

    def store(self, *args):
        self.data.add(args, 0)

    def _make_events(self, name, symbol, color, size, **where):
        items = []
        channels = self.browser.data.channels
        for c in range(channels):
            items.append(self.browser.make_event_item(
                channel=c, symbol=symbol, color=color, size=size, **where))
        self.events[name] = items

    def make_trace_events(self, name, trace_name, symbol, color, size):
        """Markers drawn on top of a trace (`analyzer.py:186-217`)."""
        self._make_events(name, symbol, color, size, trace_name=trace_name)

    def make_panel_events(self, name, panel_name, symbol, color, size):
        """Markers drawn into a panel (`analyzer.py:220-252`)."""
        self._make_events(name, symbol, color, size, panel_name=panel_name)

    def set_events(self, name, channel, x, y):
        for c, item in enumerate(self.events[name]):
            if c == channel or channel < 0:
                item.setData(x, y)
            else:
                item.clear()

    def add_events(self, name, channel, x, y):
        for c, item in enumerate(self.events[name]):
            if c == channel or channel < 0:
                item.addPoints(x, y)


class PlainAnalyzer(Analyzer):
    """Stores region start/end/duration/channel
    (`src/audian/analyzer.py:311-343`)."""

    def __init__(self, browser):
        super().__init__(browser, "plain", "data")
        nd = max(int(floor(-log10(1 / self.source.rate))), 0)
        self.make_column("tstart", "s", f"%.{nd}f")
        self.make_column("tend", "s", f"%.{nd}f")
        self.make_column("duration", "s", f"%.{nd}f")
        self.make_column("channel", "", "%.0f")

    def analyze(self, t0, t1, channel, traces):
        self.store(t0, t1, t1 - t0, channel)
