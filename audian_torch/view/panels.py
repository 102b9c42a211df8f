"""Plot panels typed by axis specs.

Provides the same panel surface as the reference's panel manager
(`src/audian/panels.py:13-356`) — named plot rows carrying a 2-3 letter
axis spec, with fresh-letter allocation so ranges link per letter across
panels and files — but built around a letter→kind classification table
instead of per-alphabet membership tests, and a row ledger instead of
dict re-sorting.

Axis alphabet (the spec, shared with the reference): ``t`` is time,
``xyu`` are amplitudes, ``fw`` are frequencies, ``pq`` are powers.

Plot objects ("axes") are duck-typed: anything with ``isVisible``,
``setVisible``, ``add_item``, ``update_plot`` works — the headless tests,
the matplotlib frontend, and Qt/pyqtgraph all plug in here.
"""

from __future__ import annotations

__all__ = ["Panel", "Panels", "axis_kind",
           "TIME_AXES", "AMPLITUDE_AXES", "FREQUENCY_AXES", "POWER_AXES"]


# The axis-letter alphabets are part of the public spec: a panel's type is
# fully determined by the kinds of its letters.
TIME_AXES = "t"
AMPLITUDE_AXES = "xyu"
FREQUENCY_AXES = "fw"
POWER_AXES = "pq"

#: letter → semantic kind, the single source of truth for panel typing
_KIND_OF = {}
for _letters, _kind in ((TIME_AXES, "time"), (AMPLITUDE_AXES, "amplitude"),
                        (FREQUENCY_AXES, "frequency"), (POWER_AXES, "power")):
    for _c in _letters:
        _KIND_OF[_c] = _kind

_SPACER_SPEC = "spacer"


def axis_kind(letter):
    """Semantic kind ('time'/'amplitude'/'frequency'/'power') of one axis
    letter, or None for unknown letters/empty strings."""
    return _KIND_OF.get(letter)


class Panel:
    """One named plot row.

    ``ax_spec`` is the 2-3 letter axis spec (x, y, optional z); ``axs``
    holds one plot object per channel, ``axcs`` the associated color
    bars.  Same surface as the reference panel (`src/audian/panels.py`).
    """

    # alphabet aliases kept on the class for API compatibility
    times = TIME_AXES
    amplitudes = AMPLITUDE_AXES
    frequencies = FREQUENCY_AXES
    powers = POWER_AXES
    spacer = _SPACER_SPEC

    def __init__(self, name, ax_spec, row):
        self.name = name
        self.ax_spec = ax_spec
        self.row = row
        self.axs = []    # one plot per channel
        self.axcs = []   # associated color bars

    def __repr__(self):
        return (f"Panel({self.name!r}, {self.ax_spec!r}, row={self.row}, "
                f"plots={len(self.axs)})")

    __str__ = __repr__

    def __len__(self):
        return len(self.axs)

    def __eq__(self, ax_spec):
        return self.ax_spec == ax_spec

    # -- axis letters and kinds ---------------------------------------------------

    def _letter(self, i):
        return self.ax_spec[i] if len(self.ax_spec) > i else ""

    def _kind(self, i):
        return axis_kind(self._letter(i))

    def x(self):
        return self._letter(0)

    def y(self):
        return self._letter(1)

    def z(self):
        return self._letter(2)

    def is_time(self):
        return self._kind(0) == "time"

    def is_xamplitude(self):
        return self._kind(0) == "amplitude"

    def is_yamplitude(self):
        return self._kind(1) == "amplitude"

    def is_xfrequency(self):
        return self._kind(0) == "frequency"

    def is_yfrequency(self):
        return self._kind(1) == "frequency"

    def is_xpower(self):
        return self._kind(0) == "power"

    def is_ypower(self):
        return self._kind(1) == "power"

    def is_zpower(self):
        return self._kind(2) == "power"

    def is_trace(self):
        return self.is_time() and self.is_yamplitude()

    def is_spectrogram(self):
        return self.is_time() and self.is_yfrequency()

    def is_power(self):
        return self.is_xpower() and self.is_yfrequency()

    def is_spacer(self):
        return self.ax_spec == _SPACER_SPEC

    # -- plot wiring ----------------------------------------------------------------

    def add_ax(self, row, ax, axc=None):
        self.row = row
        self.axs.append(ax)
        if axc is not None:
            self.axcs.append(axc)

    def is_used(self):
        return bool(self.axs)

    def is_visible(self, channel):
        return self.axs[channel].isVisible()

    def set_visible(self, visible):
        changed = False
        for ax in self.axs:
            changed |= ax.isVisible() != visible
            ax.setVisible(visible)
        return changed

    def has_visible_traces(self, channel):
        if self.is_spacer():
            return False
        items = getattr(self.axs[channel], "data_items", [])
        return any(item.isVisible() for item in items)

    def has_viewbox(self, viewbox):
        return any(ax.getViewBox() is viewbox for ax in self.axs)

    def show_grid(self, grids):
        if self.is_spacer():
            return
        for ax in self.axs:
            ax.showGrid(x=bool(grids & 1), y=bool(grids & 2), alpha=0.8)

    # -- color bars -----------------------------------------------------------------

    def is_cbar_visible(self, channel):
        return self.axcs[channel].isVisible()

    def set_cbar_visible(self, visible):
        changed = False
        for cbar in self.axcs:
            changed |= cbar.isVisible() != visible
            cbar.setVisible(visible)
        return changed

    def set_colormap(self, color_map):
        for cbar in self.axcs:
            cbar.setColorMap(color_map)

    # -- items and readouts -----------------------------------------------------------

    def add_item(self, plot_item, channel=-1, is_data=False):
        targets = self.axs if channel < 0 else [self.axs[channel]]
        for ax in targets:
            ax.add_item(plot_item, is_data)

    def _items(self, channel):
        return getattr(self.axs[channel], "data_items", [])

    def get_amplitude(self, channel, t, x, t1=None):
        """Snap (t, x) to the nearest data extremum of the topmost trace
        item on this panel, if it shows amplitudes."""
        items = self._items(channel)
        if not self.is_yamplitude() or not items:
            return t, None
        return items[-1].get_amplitude(t, x, t1)

    def get_power(self, channel, t, f):
        """dB power under the cursor of the bottom spectrogram item, if
        this panel shows frequencies."""
        items = self._items(channel)
        if not self.is_yfrequency() or not items:
            return None
        return items[0].get_power(t, f)

    def update_plots(self):
        if self.is_spacer():
            return
        for ax in self.axs:
            if ax.isVisible():
                ax.update_plot()


class Panels(dict):
    """Ordered registry of panels keyed by name.

    Insertion order always equals row order; ``add`` keeps that invariant
    by re-threading the dict through a row ledger instead of sorting on
    every access.
    """

    def __str__(self):
        return "\n".join(str(p) for p in self.values())

    # -- registry maintenance ---------------------------------------------------------

    def _rethread(self, entries):
        """Rebuild the dict in the order of ``entries`` (name, panel)."""
        self.clear()
        self.update(entries)

    def max_row(self):
        return max((p.row for p in self.values()), default=-1)

    def add(self, name, axes, row=None, adjust_rows=True):
        """Register a panel at ``row`` (appending by default); existing
        rows at or below shift down unless ``adjust_rows`` is off (used
        for side panels sharing their master's row)."""
        if row is None:
            row = self.max_row() + 1
        elif adjust_rows:
            for other in self.values():
                if other.row >= row:
                    other.row += 1
        self[name] = Panel(name, axes, row)
        ledger = sorted(self.items(), key=lambda kv: kv[1].row)
        if list(self) != [k for k, _ in ledger]:
            self._rethread(ledger)

    def remove(self, name):
        del self[name]

    # -- panel factories ----------------------------------------------------------------

    def _alloc(self, alphabet, taken):
        """First letter of ``alphabet`` not in ``taken`` (wrapping to the
        first letter when the alphabet is exhausted)."""
        free = [c for c in alphabet if c not in taken]
        return free[0] if free else alphabet[0]

    def add_trace(self, name="trace", row=None):
        """New time×amplitude panel on a fresh amplitude letter."""
        y = self._alloc(AMPLITUDE_AXES,
                        {p.y() for p in self.values() if p.is_trace()})
        self.add(name, TIME_AXES[0] + y, row)

    def add_spectrogram(self, name="spectrogram", row=None):
        """New time×frequency×power panel on fresh frequency/power
        letters, plus its power side panel sharing the same row."""
        specs = [p for p in self.values() if p.is_spectrogram()]
        f = self._alloc(FREQUENCY_AXES, {p.y() for p in specs})
        z = self._alloc(POWER_AXES, {p.z() for p in specs})
        self.add(name, TIME_AXES[0] + f + z, row)
        self.add(name + "-power", z + f, self[name].row, adjust_rows=False)

    def fill(self, data):
        """Create panels for plugin traces that name one not yet built;
        unknown panel types are skipped like the reference
        (`src/audian/panels.py:282-288`) — building a bogus trace panel
        would consume a fresh amplitude letter and shift linkage."""
        for trace in data.traces:
            target = getattr(trace, "panel", None)
            if not target or target in self:
                continue
            ptype = getattr(trace, "panel_type", "trace")
            if ptype == "spectrogram":
                self.add_spectrogram(target)
            elif ptype == "trace":
                self.add_trace(target)

    # -- lookups and fan-out -------------------------------------------------------------

    def add_power_ax(self, name, row, ax):
        side = self.get(name + "-power")
        if side is not None:
            side.add_ax(row, ax)

    def get_panel(self, viewbox):
        for panel in self.values():
            if panel.has_viewbox(viewbox):
                return panel
        return None

    def show_grid(self, grids):
        for panel in self.values():
            panel.show_grid(grids)

    def update_plots(self):
        for panel in self.values():
            panel.update_plots()

    # -- spacers ---------------------------------------------------------------------------

    def insert_spacers(self):
        """Thread a spacer row before every main panel but the first.

        Power side panels ride along with their master and never get a
        spacer of their own.
        """
        entries = []
        for n, (name, panel) in enumerate(self.items()):
            if n and not panel.is_power():
                sname = f"spacer{sum(1 for _, p in entries if p.is_spacer())}"
                entries.append((sname, Panel(sname, _SPACER_SPEC, 0)))
            entries.append((name, panel))
        self._rethread(entries)

    def show_spacers(self, channel):
        """A spacer shows iff the main panel above it is visible; the
        spacer trailing the last visible panel is switched back off.

        (The reference's cleanup pass hides the final *panel* instead of
        that trailing spacer — `src/audian/panels.py:344-356` — which
        reads like a slip; this implements the evident intent.)
        """
        above = None
        dangling = None
        for panel in self.values():
            if panel.is_spacer():
                on = above is not None and above.is_visible(channel)
                panel.set_visible(on)
                if on:
                    dangling = panel
            elif not panel.is_power():
                if panel.is_visible(channel):
                    dangling = None
                above = panel
        if dangling is not None:
            dangling.set_visible(False)
