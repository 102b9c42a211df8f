"""Qt/pyqtgraph frontend of the port (optional dependency).

The counterpart of ``audian_tpu/gui/qt.py``, over the port's headless
browser (:mod:`audian_torch.app`).  The browser hands it host numpy tiles
(:meth:`~audian_torch.app.browser.DataBrowser.trace_tile`,
``spec_tile``, ``power_spectrum``); no tensor reaches a toolkit call.
The port has no device watch and no background resolution warm, so the
JAX frontend's "device lost — host mode" status and its mid-warm
resolution swap are not carried over.

The full-fidelity GUI in the reference's own toolkit
(`src/audian/audian.py`, `src/audian/databrowser.py`): a tabbed main
window over the headless shell, per-channel pyqtgraph trace + spectrogram
panels consuming the browser's render tiles, color bars and a live
power-spectrum side plot per spectrogram (`src/audian/spectrogramplot.py:87-164`),
draggable HP/LP filter-cutoff handles on the spectrogram
(`spectrogramplot.py:99-121,199-217`), custom time/Y axes with the three
start-time modes (`src/audian/timeaxisitem.py`, `yaxisitem.py`), a
whole-recording overview with a draggable view region
(`src/audian/fulltraceplot.py`), rectangle region selection with the
zoom/play/analyze/save modes plus a zoom history
(`src/audian/selectviewbox.py`), hover time readouts
(`src/audian/timeplot.py:154-192`), crosshair with marker storage,
drag-dropped screenshot PNGs restoring their view
(`src/audian/audian.py:226-260`), and the keyboard/menu action surface
dispatching through the *headless* controllers.

All interaction logic lives in the headless layer and is covered by the
headless tests; this module adapts it to Qt and is itself exercised by
``tests/test_torch_gui_qt.py`` against a fake Qt/pyqtgraph implementing
the same API surface, so the adapter works without a display (and without
Qt installed).

Requires PyQt5 and pyqtgraph; environments without Qt fall back to the
matplotlib frontend (:mod:`audian_torch.gui.mpl`).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

try:
    import pyqtgraph as pg
    from PyQt5.QtCore import Qt, QTimer, QRectF
    from PyQt5.QtWidgets import (QApplication, QMainWindow, QTabWidget,
                                 QWidget, QVBoxLayout, QAction, QDialog,
                                 QLabel, QScrollArea, QDialogButtonBox,
                                 QTableWidget, QTableWidgetItem,
                                 QFileDialog, QMessageBox, QHBoxLayout,
                                 QPushButton, QMenu)
    HAVE_QT = True
except ImportError:
    HAVE_QT = False

__all__ = ["run_qt", "HAVE_QT"]


if HAVE_QT:

    pg.setConfigOption("background", "black")
    pg.setConfigOption("foreground", "white")

    class TimeAxisItem(pg.AxisItem):
        """Bottom time axis with width-aware ticks and the three label
        modes of the reference (`src/audian/timeaxisitem.py:11-221`),
        rendered through :mod:`audian_torch.view.axes`."""

        def __init__(self, browser, **kwargs):
            super().__init__(orientation="bottom", **kwargs)
            self.browser = browser
            self.starttime_mode = 0
            self._spacing = 0.01
            self.setLabel("time", units=None)

        def set_starttime(self, mode):
            self.starttime_mode = mode
            self.update_label()

        def tickSpacing(self, minVal, maxVal, size):
            from ..view.axes import tick_spacing, time_label_width

            span = tick_spacing(minVal, maxVal, size, 60.0)
            if span is None:
                return super().tickSpacing(minVal, maxVal, size)
            major, minor = span
            # refine with the actual label width of this spacing/mode
            chars = time_label_width(
                max(abs(minVal), abs(maxVal)), major, self.starttime_mode,
                self.browser.data.start_time is not None)
            span = tick_spacing(minVal, maxVal, size, 8.0 * chars)
            if span is not None:
                major, minor = span
            self._spacing = major
            return [(major, 0), (minor, 0)]

        def _format(self, values, spacing):
            from ..view.axes import format_time_ticks

            data = self.browser.data
            try:
                file_times = data.data.file_start_times()
                file_paths = data.data.file_paths
            except AttributeError:
                file_times, file_paths = None, None
            return format_time_ticks(
                values, spacing, mode=self.starttime_mode,
                starttime=data.start_time, file_times=file_times,
                file_paths=[Path(p).name for p in file_paths or []])

        def tickStrings(self, values, scale, spacing):
            _, _, strings, _ = self._format(values, spacing)
            return strings

        def update_label(self):
            label, units, _, filename = self._format(
                [self.browser.toffset], self._spacing)
            if label == "File" and filename:
                self.setLabel(f"{label} {filename}", units=units)
            else:
                self.setLabel(label or "time", units=units)

    class AmplAxisItem(pg.AxisItem):
        """Left axis with the height-aware 1/2/5 tick progression
        (`src/audian/yaxisitem.py:7-46`)."""

        def __init__(self, label="", **kwargs):
            super().__init__(orientation="left", **kwargs)
            if label:
                self.setLabel(label)

        def tickSpacing(self, minVal, maxVal, size):
            from ..view.axes import tick_spacing

            span = tick_spacing(minVal, maxVal, size, 25.0)
            if span is None:
                return super().tickSpacing(minVal, maxVal, size)
            return [(span[0], 0), (span[1], 0)]

    class SelectViewBox(pg.ViewBox):
        """Rect-drag region selection (`src/audian/selectviewbox.py`):
        left-drag draws a rectangle and hands it to the browser's region
        mode; plain click places the crosshair; hovering feeds the time
        readout."""

        def __init__(self, tab, channel, kind):
            super().__init__()
            self.tab = tab
            self.channel = channel
            self.kind = kind
            #: rect-select on left drag; False = plain pan/zoom drags
            #: (`selectviewbox.py` pan mode)
            self.select_enabled = True
            self.setMouseMode(pg.ViewBox.RectMode)
            # pan/wheel changes must reach the browser: tiles only cover
            # the model's window, and the next refresh would otherwise
            # snap the view back to browser.toffset/twindow
            self.sigRangeChangedManually.connect(
                lambda *a: tab.manual_view_change(self))

        def set_select_mode(self, select):
            self.select_enabled = bool(select)
            self.setMouseMode(pg.ViewBox.RectMode if select
                              else pg.ViewBox.PanMode)

        def mouseDragEvent(self, ev, axis=None):
            # axis is not None when an AxisItem forwards a drag along one
            # axis (axis-local coordinates): that is the standard
            # single-axis scale gesture, not a region selection
            if (axis is not None or ev.button() != Qt.LeftButton
                    or not self.select_enabled):
                return super().mouseDragEvent(ev, axis)
            ev.accept()
            if ev.isFinish():
                p0 = self.mapToView(ev.buttonDownPos())
                p1 = self.mapToView(ev.pos())
                self.rbScaleBox.hide()
                self.tab.region_selected(
                    self.channel, self.kind,
                    min(p0.x(), p1.x()), max(p0.x(), p1.x()),
                    min(p0.y(), p1.y()), max(p0.y(), p1.y()))
            else:
                self.updateScaleBox(ev.buttonDownPos(), ev.pos())

        def mouseClickEvent(self, ev):
            if ev.button() == Qt.LeftButton:
                ev.accept()
                p = self.mapToView(ev.pos())
                self.tab.crosshair_at(self.channel, self.kind,
                                      p.x(), p.y())
            else:
                super().mouseClickEvent(ev)

        def hoverEvent(self, ev):
            if hasattr(ev, "isExit") and ev.isExit():
                self.tab.hover_at(self.channel, self.kind, None, None)
                return
            if hasattr(ev, "pos"):
                p = self.mapToView(ev.pos())
                self.tab.hover_at(self.channel, self.kind, p.x(), p.y())

    class BrowserTab(QWidget):
        """Per-recording tab: per-channel trace + spectrogram rows over
        the browser's tiles, power side plots, color bars, draggable cutoff
        handles, whole-recording overview with a draggable region,
        crosshair lines, marker dots, zoom history."""

        def __init__(self, browser, parent=None, on_status=None):
            super().__init__(parent)
            from ..view.zoom import Rect, ZoomHistory

            self.browser = browser
            self.on_status = on_status or (lambda text: None)
            layout = QVBoxLayout(self)
            self.glw = pg.GraphicsLayoutWidget()
            layout.addWidget(self.glw)
            self.trace_plots = {}
            self.env_curves = {}
            self.spec_images = {}
            self.power_plots = {}
            self.colorbars = {}
            self.hp_lines = {}
            self.lp_lines = {}
            self.marker_dots = {}
            self.xlines = {}
            self.time_axes = []
            #: (channel, plot) in top-to-bottom row order — drives the
            #: bottom-only time-tick rule and the selection borders
            self._rows = []
            #: analyzer event scatters keyed by (analyzer id, event
            #: name, channel) -> (recorder, host plot, scatter item)
            self.event_scatter = {}
            self._updating_cutoffs = False
            row = 0
            b = browser
            fmax = b.data.rate / 2
            # rows exist for EVERY channel of the recording (the
            # reference builds per-channel figures for all channels,
            # `databrowser.py:53-240`); refresh() shows/hides them as
            # the channel verbs scroll or toggle the shown set — a tab
            # opened with a restricted set must still reveal the others
            for c in range(b.data.channels):
                vb = SelectViewBox(self, c, "trace")
                taxis = TimeAxisItem(b)
                self.time_axes.append(taxis)
                pt = self.glw.addPlot(
                    row=row, col=0, viewBox=vb,
                    axisItems={"bottom": taxis,
                               "left": AmplAxisItem(f"ch {c}")})
                curve = pt.plot(pen=pg.mkPen("#00ee00", width=1))
                env = pt.plot(pen=pg.mkPen("#ee8800", width=2))
                dots = pg.ScatterPlotItem(size=8, brush=pg.mkBrush("y"))
                pt.addItem(dots)
                xline = pg.InfiniteLine(angle=90, movable=False,
                                        pen=pg.mkPen("#cccc00"))
                xline.setVisible(False)
                pt.addItem(xline)
                self.trace_plots[c] = (pt, curve)
                self.env_curves[c] = env
                self.marker_dots[c] = dots
                self.xlines[c] = xline
                self._rows.append((c, pt))
                row += 1
                if b.spectrogram in b.data:
                    vbs = SelectViewBox(self, c, "spec")
                    staxis = TimeAxisItem(b)
                    self.time_axes.append(staxis)
                    ps = self.glw.addPlot(
                        row=row, col=0, viewBox=vbs,
                        axisItems={"bottom": staxis,
                                   "left": AmplAxisItem("f/Hz")})
                    img = pg.ImageItem()
                    ps.addItem(img)
                    self.spec_images[c] = (ps, img)
                    self._rows.append((c, ps))
                    # draggable filter-cutoff handles
                    # (`spectrogramplot.py:99-121,199-217`)
                    hp = pg.InfiniteLine(angle=0, movable=True,
                                         pen=pg.mkPen("#ff4444", width=2))
                    lp = pg.InfiniteLine(angle=0, movable=True,
                                         pen=pg.mkPen("#4488ff", width=2))
                    for line in (hp, lp):
                        line.setBounds([0.0, fmax])
                        ps.addItem(line)
                    hp.sigPositionChangeFinished.connect(
                        lambda *a, ch=c: self._cutoff_dragged(ch))
                    lp.sigPositionChangeFinished.connect(
                        lambda *a, ch=c: self._cutoff_dragged(ch))
                    self.hp_lines[c] = hp
                    self.lp_lines[c] = lp
                    # live mean-power side plot
                    # (`spectrogramplot.py:144-164`)
                    pp = self.glw.addPlot(row=row, col=1)
                    pp.setMaximumWidth(120)
                    pcurve = pp.plot(pen=pg.mkPen("#00bbbb", width=1))
                    self.power_plots[c] = (pp, pcurve)
                    # color bar honoring toggle_colorbars
                    # (`spectrogramplot.py:87-92`)
                    # interactive=False: tiles are pre-quantized u8 over
                    # the power range, so the image levels must stay
                    # (0, 255) — a draggable bar would rewrite them;
                    # level changes go through the power-range verbs
                    try:
                        cbar = pg.ColorBarItem(values=(-100.0, 0.0),
                                               interactive=False)
                    except TypeError:  # pyqtgraph < 0.13: no kwarg
                        cbar = pg.ColorBarItem(values=(-100.0, 0.0))
                    cbar.setImageItem(img, insert_in=ps)
                    self.colorbars[c] = cbar
                    row += 1
            # whole-recording overview, one band per channel
            # (`fulltraceplot.py:62-292` builds one row per channel)
            self.overview = self.glw.addPlot(row=row, col=0)
            self.overview.setMaximumHeight(
                min(60 + 25 * b.data.channels, 200))
            self.overview.setLabel("bottom", "time", units="s")
            self.ov_curves = {
                c: self.overview.plot(pen=pg.mkPen("#888888", width=1))
                for c in range(b.data.channels)}
            self.region = pg.LinearRegionItem(
                values=(b.toffset, b.toffset + b.twindow), movable=True)
            self.overview.addItem(self.region)
            self.region.sigRegionChangeFinished.connect(self._region_moved)
            self._setting_region = False
            # zoom history (`selectviewbox.py:107-131`)
            self.zoom_history = ZoomHistory()
            self.zoom_history.init(Rect(b.toffset, 0.0,
                                        b.toffset + b.twindow, 1.0))
            # 500 ms poll of the background decimator
            # (`fulltraceplot.py:157,190`)
            self.poll = QTimer(self)
            self.poll.timeout.connect(self._poll_fulltrace)
            self.poll.start(500)
            # audio position marker ticks (`databrowser.py:1745-1756`)
            self.audio_timer = QTimer(self)
            self.audio_timer.timeout.connect(self._tick_audio)
            # 50 ms auto-scroll ticks (`databrowser.py:1659-1680`)
            self.scroll_timer = QTimer(self)
            self.scroll_timer.timeout.connect(self._tick_scroll)
            # debounce for pan/wheel view changes (manual_view_change)
            self._manual_vb = None
            self.pan_timer = QTimer(self)
            self.pan_timer.timeout.connect(self._apply_manual_range)
            self.audio_marks = {
                c: pg.InfiniteLine(angle=90, pen=pg.mkPen("m"))
                for c in range(b.data.channels)}
            for c, (pt, _) in self.trace_plots.items():
                self.audio_marks[c].setVisible(False)
                pt.addItem(self.audio_marks[c])
            # keep (signal, slot) pairs so teardown() can disconnect:
            # the headless browser outlives a closed tab, and dangling
            # slots would keep refreshing dead plots
            self._connections = []
            for sig in (b.sigTimesChanged, b.sigChannelsChanged):
                slot = lambda *a: self.refresh()
                sig.connect(slot)
                self._connections.append((sig, slot))
            for sig in (b.sigFilterChanged, b.sigEnvelopeChanged,
                        b.sigResolutionChanged, b.sigColorMapChanged,
                        b.sigPanelsChanged):
                sig.connect(self.refresh)
                self._connections.append((sig, self.refresh))
            # linked range changes (shell._dispatch_ranges) arrive here
            # with (axspec, range) args; without this a linked amplitude
            # zoom never repaints the other tabs
            slot = lambda *a: self.refresh()
            b.sigRangesChanged.connect(slot)
            self._connections.append((b.sigRangesChanged, slot))
            self.refresh()

        def teardown(self):
            """Stop timers and detach from the browser (close_tab):
            QTabWidget.removeTab keeps the page widget alive, so without
            this the 500 ms poll and the browser signals would drive a
            dead tab forever."""
            for timer in (self.poll, self.audio_timer, self.scroll_timer,
                          self.pan_timer):
                timer.stop()
            for sig, slot in self._connections:
                try:
                    sig.disconnect(slot)
                except ValueError:
                    pass
            self._connections = []

        # -- drawing ---------------------------------------------------------

        def refresh(self):
            # reentrancy guard (the mpl frontend's _in_redraw twin): a
            # browser signal emitted during the pass would re-enter it
            if getattr(self, "_in_refresh", False):
                return
            self._in_refresh = True
            try:
                self._refresh_body()
            finally:
                self._in_refresh = False

        def _refresh_body(self):
            b = self.browser
            # the port has no device watch: this stays "ok", and the JAX
            # tab's "device lost — host mode" status note is not copied
            b.poll_device_state()
            name = "filtered" if "filtered" in b.data else "data"
            t0, t1 = b.toffset, b.toffset + b.twindow
            # showGrid invalidates the axis picture even when unchanged,
            # so re-apply only when the mask actually moved
            apply_grids = b.grids != getattr(self, "_grids_applied", None)
            for c, (pt, curve) in self.trace_plots.items():
                pt.setVisible(c in b.show_channels and b.show_traces)
                if apply_grids:
                    pt.showGrid(x=bool(b.grids & 1), y=bool(b.grids & 2),
                                alpha=0.8)
                if not pt.isVisible():
                    # hidden rows keep stale data; they are refreshed on
                    # the sigChannelsChanged redraw that reveals them
                    continue
                times, values = b.trace_tile(name, c)
                curve.setData(times, values)
                if "envelope" in b.data and b.data.is_visible("envelope"):
                    et, ev = b.trace_tile("envelope", c)
                    self.env_curves[c].setData(et, ev)
                else:
                    self.env_curves[c].setData([], [])
                sel = [(tm, 0.0) for tm, ch in zip(b.marker_data.times,
                                                   b.marker_data.channels)
                       if t0 <= tm <= t1 and (ch == c or ch < 0)]
                self.marker_dots[c].setData([s[0] for s in sel],
                                            [s[1] for s in sel])
                pt.setXRange(t0, t1, padding=0)
                lo, hi = b.get_range("x", c)
                if lo is not None:
                    pt.setYRange(lo, hi, padding=0)
            cmap = None
            try:
                cmap = pg.colormap.get(b.color_map_name)
            except Exception:
                pass
            for c, (ps, img) in self.spec_images.items():
                ps.setVisible(c in b.show_channels and b.show_specs > 0)
                if apply_grids:
                    ps.showGrid(x=bool(b.grids & 1), y=bool(b.grids & 2),
                                alpha=0.8)
                if not ps.isVisible():
                    self._set_side_panels_visible(c, False)
                    continue
                # u8 tiles: 4x fewer bytes pulled than normalized f32
                tile, rect = b.spec_tile(c, quantize=True)
                # an empty tile must HIDE the image: leaving the old
                # one visible freezes a spectrogram strip at its stale
                # rect while the view scrolls on (the mpl frontend's
                # set_visible twin)
                img.setVisible(bool(tile.size))
                if tile.size:
                    img.setImage(tile, levels=(0, 255))
                    img.setRect(QRectF(rect[0], rect[1], rect[2], rect[3]))
                    if cmap is not None:
                        img.setColorMap(cmap)
                ps.setXRange(t0, t1, padding=0)
                flo, fhi = b.get_range("f", c)
                if flo is not None:
                    ps.setYRange(flo, fhi, padding=0)
                self._refresh_cutoffs(c)
                self._refresh_power(c, t0, t1)
                self._refresh_colorbar(c, cmap, *b.get_range("p", c))
            self._grids_applied = b.grids
            # the crosshair time line follows the headless browser's
            # marker state: script/linked placements render, and leaving
            # crosshair mode (which clears the browser marker) hides it
            ct = b.plot_ranges.marker_time()[1]
            for xline in self.xlines.values():
                if ct is None:
                    xline.setVisible(False)
                else:
                    xline.setPos(ct)
                    xline.setVisible(True)
            self._refresh_analyzer_events()
            for axis in self.time_axes:
                axis.update_label()
            self._sync_axes_and_borders()
            self._poll_fulltrace()
            self._setting_region = True
            self.region.setRegion((t0, t1))
            self._setting_region = False
            if b.scroll_active:
                self.scroll_timer.start(50)
            else:
                self.scroll_timer.stop()

        def _refresh_analyzer_events(self):
            """Pull analyzer event recorders into scatter items on the
            owning plots.  The reference pushes real ScatterPlotItems
            into the plots when the analyzer is constructed
            (`analyzer.py:186-252`, `databrowser.py:243-245`); pulling
            on refresh instead keeps analyzers frontend-agnostic."""
            b = self.browser
            live = set()
            for a, name, rec in b.iter_event_items():
                key = (id(a), name, rec.channel)
                live.add(key)
                # spectrogram-owned events NEVER fall back onto the
                # amplitude plot — their y values are frequencies
                if rec.owner_panel(b) == "spectrogram":
                    host = self.spec_images.get(rec.channel, (None,))[0]
                else:
                    host = self.trace_plots.get(rec.channel, (None,))[0]
                old = self.event_scatter.get(key)
                if old is not None and (old[0] is not rec or
                                        old[1] is not host):
                    old[1].removeItem(old[2])
                    old = None
                if host is None:
                    self.event_scatter.pop(key, None)
                    continue
                if old is None:
                    sp = pg.ScatterPlotItem(
                        symbol=rec.symbol or "o", size=rec.size or 8,
                        brush=pg.mkBrush(rec.color or "r"),
                        pen=pg.mkPen(None))
                    host.addItem(sp)
                    self.event_scatter[key] = (rec, host, sp)
                self.event_scatter[key][2].setData(list(rec.x), list(rec.y))
            for key in list(self.event_scatter):
                if key not in live:
                    _, host, sp = self.event_scatter.pop(key)
                    host.removeItem(sp)

        def _sync_axes_and_borders(self):
            """Only the bottom-most visible data panel keeps its time
            tick values and axis label; the panels above hide them
            (`databrowser.py:994-1008`).  Selected channels get a grey
            border around their viewboxes
            (`databrowser.py:367,969-974`)."""
            b = self.browser
            visible = [pt for _, pt in self._rows if pt.isVisible()]
            bottom = visible[-1] if visible else None
            sel = set(b.selected_channels)
            pen = pg.mkPen("#aaaaaa", width=1)
            for c, pt in self._rows:
                show = pt is bottom
                ax = pt.getAxis("bottom")
                ax.setStyle(showValues=show)
                ax.showLabel(show)
                pt.getViewBox().setBorder(pen if c in sel else None)
            self._apply_row_stretch()

        def _apply_row_stretch(self):
            """Trace rows shrink relative to spectrogram rows as the
            ``show_specs`` level grows (`databrowser.py:118,1050-1052`);
            hidden rows collapse to zero height (the reference pins
            per-panel fixed heights instead, `databrowser.py:1078-1082`
            — stretch factors fit our single-grid layout)."""
            b = self.browser
            frac = b.trace_fracs.get(b.show_specs, 1)
            layout = self.glw.ci.layout
            spec_rows = {id(ps) for ps, _ in self.spec_images.values()}
            for row, (c, pt) in enumerate(self._rows):
                if not pt.isVisible():
                    layout.setRowFixedHeight(row, 0)
                    layout.setRowStretchFactor(row, 0)
                    continue
                layout.setRowMinimumHeight(row, 0)
                layout.setRowMaximumHeight(row, 16777215)
                is_spec = id(pt) in spec_rows
                layout.setRowStretchFactor(
                    row, 1000 if is_spec else max(1, int(1000 * frac)))

        def _set_side_panels_visible(self, channel, visible):
            if channel in self.power_plots:
                self.power_plots[channel][0].setVisible(visible)
            if channel in self.colorbars:
                self.colorbars[channel].setVisible(visible)

        def _refresh_cutoffs(self, channel):
            """Reflect the filter node's cutoffs in the draggable lines
            (`spectrogramplot.py:199-207`)."""
            b = self.browser
            if channel not in self.hp_lines or "filtered" not in b.data:
                return
            f = b.data["filtered"]
            self._updating_cutoffs = True
            try:
                self.hp_lines[channel].setPos(f.highpass_cutoff or 0.0)
                self.lp_lines[channel].setPos(
                    f.lowpass_cutoff or b.data.rate / 2)
            finally:
                self._updating_cutoffs = False

        def _cutoff_dragged(self, channel):
            """A released cutoff handle re-designs the filter live
            (`spectrogramplot.py:208-217`)."""
            if self._updating_cutoffs or "filtered" not in self.browser.data:
                return
            hp = float(self.hp_lines[channel].value())
            lp = float(self.lp_lines[channel].value())
            if lp < hp:
                hp, lp = lp, hp
            self.browser.update_filter(highpass_cutoff=hp,
                                       lowpass_cutoff=lp)

        def _refresh_power(self, channel, t0, t1):
            """Mean power spectrum of the visible window on the side plot
            (`spectrogramplot.py:144-164`)."""
            b = self.browser
            if channel not in self.power_plots:
                return
            pp, pcurve = self.power_plots[channel]
            visible = bool(b.show_powers) and b.show_specs > 0
            pp.setVisible(visible)
            if not visible:
                return
            freqs, db = b.power_spectrum(channel, t0, t1)
            finite = np.isfinite(db)
            pcurve.setData(np.asarray(db)[finite],
                           np.asarray(freqs)[finite])
            flo, fhi = b.get_range("f", channel)
            if flo is not None:
                pp.setYRange(flo, fhi, padding=0)

        def _refresh_colorbar(self, channel, cmap, plo, phi):
            if channel not in self.colorbars:
                return
            cbar = self.colorbars[channel]
            cbar.setVisible(bool(self.browser.show_cbars))
            # the image item holds u8 tiles mapped onto [plo, phi] dB, so
            # the bar's levels must stay (0, 255) — setting dB levels here
            # would re-map (and saturate) the image; the dB range goes on
            # the bar's axis instead
            cbar.setLevels((0, 255))
            axis = (cbar.getAxis("right")
                    if hasattr(cbar, "getAxis") else None)
            if axis is not None and plo is not None and phi is not None:
                axis.setLabel(f"{plo:.0f}…{phi:.0f} dB")
            if cmap is not None:
                cbar.setColorMap(cmap)

        def _poll_fulltrace(self):
            b = self.browser
            # a resolution step applies at once in the port: nothing is
            # ever pending here
            b.poll_pending_resolution()
            ft = b.fulltrace
            if ft is None or ft.datas is None:
                return
            n = min(len(ft.times), len(ft.datas))
            busy = ft.is_busy()
            if not busy:
                # decimation finished: one final redraw, then stop the
                # 500 ms poll — otherwise every tab recomputes the peak
                # and repaints its overview curves forever
                if not b.has_pending_resolution:
                    self.poll.stop()
                if n == getattr(self, "_ov_drawn", -1):
                    return
            self._ov_drawn = n if not busy else -1
            peak = float(np.max(np.abs(ft.datas[:n]))) if n else 0.0
            scale = 0.45 / peak if peak > 0 else 0.0
            # one band per channel, stacked top-down like the panels
            for k, (c, curve) in enumerate(self.ov_curves.items()):
                base = len(self.ov_curves) - 1 - k
                curve.setData(ft.times[:n],
                              base + ft.datas[:n, c] * scale)

        def _region_moved(self, *args):
            if self._setting_region:
                return
            t0, t1 = self.region.getRegion()
            self.browser.set_times(t0, t1 - t0)

        # -- zoom history (`selectviewbox.py:107-131`) -------------------------

        def push_zoom(self, rect):
            self.zoom_history.add(rect)

        def _apply_zoom(self, rect):
            if rect is not None:
                self.browser.set_times(rect.left(),
                                       rect.right() - rect.left())

        def zoom_back(self):
            self._apply_zoom(self.zoom_history.back())

        def zoom_forward(self):
            self._apply_zoom(self.zoom_history.forward())

        def zoom_home(self):
            self._apply_zoom(self.zoom_history.home())

        # -- pan/wheel feedback --------------------------------------------------

        def manual_view_change(self, vb):
            """A pan-mode drag or wheel zoom moved a ViewBox: debounce,
            then fold the new view into the browser (reference pan mode
            pushes the final rect into the zoom history,
            `selectviewbox.py:67-69`)."""
            self._manual_vb = vb
            self.pan_timer.start(150)

        def _apply_manual_range(self):
            from ..view.zoom import Rect

            self.pan_timer.stop()
            vb = getattr(self, "_manual_vb", None)
            self._manual_vb = None
            if vb is None:
                return
            (x0, x1), (y0, y1) = vb.viewRange()
            b = self.browser
            b.set_ranges("f" if vb.kind == "spec" else "x", y0, y1)
            self.push_zoom(Rect(x0, y0, x1, y1))
            b.set_times(x0, x1 - x0)  # sigTimesChanged refreshes tiles

        # -- interaction --------------------------------------------------------

        def region_selected(self, channel, kind, x0, x1, y0, y1):
            from ..view.zoom import Rect

            b = self.browser
            verb, result = b.handle_region(channel, x0, x1)
            if verb == "zoom":
                self.push_zoom(Rect(x0, y0, x1, y1))
                if kind == "spec":
                    b.set_ranges("f", y0, y1)
            elif verb == "play":
                self._play(*result)
            elif verb == "ask":
                self._ask_region(channel, kind, x0, x1, y0, y1)
            else:
                self._region_feedback(verb, result, x0, x1)
            self.refresh()

        def _region_feedback(self, verb, result, x0, x1):
            """Status-bar acknowledgement for the non-visual region
            verbs (the mpl frontend's status twin): analyze results land
            in the hidden table, save writes a file the user must be
            able to find."""
            if verb == "analyze":
                self.on_status(f"analyzed region {x0:.3f}-{x1:.3f} s "
                               "(Alt+R shows the results)")
            elif verb == "save" and result is not None:
                self.on_status(f"saved region to {result}")

        def _ask_region(self, channel, kind, x0, x1, y0, y1):
            """Ask mode pops a context menu offering the region verbs
            (`databrowser.py:1626-1642`)."""
            from PyQt5.QtWidgets import QMenu
            from ..view.zoom import Rect

            b = self.browser
            menu = QMenu(self)
            modes = {}
            for name, mode in (("&Zoom", b.zoom_region),
                               ("&Play", b.play_region_mode),
                               ("&Analyze", b.analyze_region_mode),
                               ("&Save", b.save_region_mode)):
                modes[menu.addAction(name)] = mode
            try:
                from PyQt5.QtGui import QCursor
                pos = QCursor.pos()
            except ImportError:
                pos = None
            chosen = menu.exec_(pos)
            if chosen is None:
                return
            mode = modes[chosen]
            if mode == b.zoom_region:
                self.push_zoom(Rect(x0, y0, x1, y1))
            verb, result = b.handle_region(channel, x0, x1, mode)
            if verb == "play":
                self._play(*result)
            elif verb == "zoom" and kind == "spec":
                b.set_ranges("f", y0, y1)
            else:
                self._region_feedback(verb, result, x0, x1)

        def crosshair_at(self, channel, kind, x, y):
            b = self.browser
            if kind == "trace":
                b.set_crosshair(channel, t=x, amplitude=y)
            else:
                b.set_crosshair(channel, t=x, frequency=y)
            for c, xline in self.xlines.items():
                xline.setPos(x)
                xline.setVisible(True)
            self.on_status(self._readout_text())

        def hover_at(self, channel, kind, x, y):
            """Hover readout: the per-mode time rows plus the hovered
            value (`timeplot.py:154-192`, `fulltraceplot.py:253-287`)."""
            if x is None:
                self.on_status("")
                return
            self.on_status(self.browser.hover_readout(x, y, kind, channel))

        def _readout_text(self):
            info = self.browser.crosshair_readout()
            parts = []
            for key in ("time", "amplitude", "frequency", "power",
                        "delta_time", "delta_amplitude", "delta_frequency",
                        "delta_power"):
                v = info.get(key)
                if v is not None:
                    label = key.replace("delta_", "Δ")
                    parts.append(f"{label}={v:.6g}")
            return " | ".join(parts)

        def _play(self, data, rate):
            try:
                import sounddevice

                sounddevice.play(np.asarray(data), int(rate),
                                 blocking=False)
                self.audio_timer.start(50)
            except Exception as e:  # no module/device, PortAudio errors
                print(f"cannot play audio: {e}")
                # disarm the browser's playback state: leaving
                # audio_time >= 0 makes the NEXT Space press a phantom
                # "audio-stopped" instead of a play, forever alternating
                self.browser.audio_time = -1.0

        def _tick_audio(self):
            t = self.browser.mark_audio()
            for mark in self.audio_marks.values():
                if t is None:
                    mark.setVisible(False)
                else:
                    mark.setPos(t)
                    mark.setVisible(True)
            if t is None:
                self.audio_timer.stop()

        def _tick_scroll(self):
            b = self.browser
            if not b.scroll_active:
                self.scroll_timer.stop()
                return
            b.scroll_further()

    class AudianWindow(QMainWindow):
        """Tabbed multi-recording shell with the reference's menu/action
        surface (`src/audian/audian.py:263-1271`), dispatching through
        the headless :class:`~audian_torch.app.shell.Audian`."""

        def __init__(self, shell):
            super().__init__()
            self.shell = shell
            self.setWindowTitle("audian-torch")
            self.setAcceptDrops(True)
            self.tabs = QTabWidget()
            self.setCentralWidget(self.tabs)
            self.tabs.currentChanged.connect(
                lambda i: shell.set_current(i) if 0 <= i < len(shell)
                else None)
            self._all_acts = []
            self._state_acts = []
            self.marker_acts = []
            self.crosshair_mode = False
            self.select_mode = True  # rect-select vs pan/zoom drags
            for b in shell.browsers:
                self._add_tab(b)
            # recordings opened later (the progressive startup pump,
            # more files via Open) surface as tabs through the shell's
            # signals, so every load path shares one wiring
            self._load_pump_active = False
            shell.sigBrowserAdded.connect(self._on_browser_added)
            shell.sigBrowserFailed.connect(self._on_browser_failed)
            self._build_menus()
            self.statusBar().showMessage("")
            self._sync_action_states()
            self._pump_loads()

        def _add_tab(self, browser):
            tab = BrowserTab(browser, on_status=self.set_status)
            self.tabs.addTab(tab, Path(str(browser.file_path)).name)
            # a tab opened mid-session adopts the window-level view
            # state (mouse mode, start-time labels) — otherwise it drags
            # in RectMode while every other tab pans, and labels its
            # time axes in a different mode
            if not self.select_mode:
                for pt, _ in tab.trace_plots.values():
                    pt.vb.set_select_mode(False)
                for ps, _ in tab.spec_images.values():
                    ps.vb.set_select_mode(False)
            mode = getattr(self.shell, "starttime_mode", 0)
            if mode:
                for axis in tab.time_axes:
                    axis.set_starttime(mode)
            return tab

        def set_status(self, text):
            self.statusBar().showMessage(text)

        # -- progressive loading (`audian.py:1339-1407`) --------------------------

        def _pump_loads(self):
            """Open queued recordings one per event-loop tick, so the
            window paints and stays responsive while a long file list
            loads — the reference defers each open with a 100 ms
            single-shot timer (`audian.py:1339,1406`)."""
            if self._load_pump_active or not self.shell.pending:
                return
            self._load_pump_active = True
            QTimer.singleShot(100, self._load_tick)

        def _load_tick(self):
            # an exception escaping a Qt slot is qFatal under real
            # PyQt5; open() failures are contained inside load_next
            # itself (sigBrowserFailed -> one dialog, file dropped), so
            # this guard covers the post-open wiring only — and a
            # failure must not stop the remaining files
            self._load_pump_active = False
            if not self.shell.pending:
                return
            name = Path(str(self.shell.pending[0])).name
            self.set_status(f"loading {name} ...")
            ok = True
            try:
                self.shell.load_next()
            except Exception as e:
                import traceback

                traceback.print_exc()
                QMessageBox.critical(self, "Error",
                                     f"Cannot open file {name}: {e}")
                ok = False
            if self.shell.pending:
                self._load_pump_active = True
                QTimer.singleShot(100, self._load_tick)
            elif ok:
                # don't wipe an error message the except branch just set
                self.set_status("")

        def _on_browser_added(self, browser):
            # guarded: a tab-build exception is qFatal under real PyQt5.
            # On failure the browser must leave the shell too — tab
            # index i maps to shell.browsers[i] everywhere
            # (currentChanged, close_tab), so a browser without a tab
            # would desync every later verb onto the wrong recording
            tab = self._guarded(lambda: self._add_tab(browser))
            if tab is None and browser in self.shell.browsers:
                self.shell.browsers.remove(browser)
                if self.shell.current is browser:
                    j = self.tabs.currentIndex()
                    self.shell.current = (
                        self.shell.browsers[j]
                        if 0 <= j < len(self.shell.browsers) else None)
                try:
                    browser.close()
                except Exception:
                    pass
            self._sync_action_states()

        def _on_browser_failed(self, path, err):
            # one dialog per failed file (`audian.py:1349-1352`)
            QMessageBox.critical(self, "Error",
                                 f"Cannot open file {path}: {err}")

        def _step_tab(self, step):
            """Cycle the visible tab (`audian.py` next/previous tab)."""
            n = self.tabs.count()
            if n:
                self.tabs.setCurrentIndex(
                    (self.tabs.currentIndex() + step) % n)

        def browser(self):
            return self.shell.current

        def tab(self):
            return self.tabs.currentWidget()

        @staticmethod
        def _keys(act):
            """An action's shortcuts as plain strings (real PyQt5 returns
            QKeySequence objects; the test fake returns strings)."""
            return [s.toString() if hasattr(s, "toString") else s
                    for s in act.shortcuts()]

        def _act(self, menu, text, shortcut, fn, checked=None):
            """``checked`` makes the action checkable; pass a zero-arg
            getter of the underlying state, polled by
            :meth:`_sync_action_states` — the menu checkmark always
            reflects shell/browser state, never Qt's own toggle."""
            act = QAction(text, self)
            if shortcut:
                act.setShortcuts([shortcut] if isinstance(shortcut, str)
                                 else shortcut)
            act.triggered.connect(lambda *_: self._fire(fn))
            menu.addAction(act)
            self._all_acts.append(act)
            if checked is not None:
                act.setCheckable(True)
                self._state_acts.append((act, checked))
            return act

        def _fire(self, fn):
            """Run a menu verb and refresh.

            Exceptions MUST NOT escape: under real PyQt5 (>= 5.5) an
            unhandled exception in a slot calls qFatal and aborts the
            whole application, losing unsaved markers/analysis.  The
            None-browser AttributeError (every tab closed) stays silent;
            everything else is reported loudly.
            """
            try:
                fn()
            except AttributeError:
                if self.shell.current is not None:
                    import traceback

                    traceback.print_exc()
                    self.set_status("error: see console")
            except Exception as e:
                import traceback

                traceback.print_exc()
                self.set_status(f"error: {e}")
            self._refresh()

        def _refresh(self):
            tab = self.tab()
            if tab is not None:
                tab.refresh()
            self._sync_action_states()

        def _guarded(self, fn):
            """Run a dialog-button slot; like :meth:`_fire`, exceptions
            must not escape into Qt (qFatal).  Returns fn() or None."""
            try:
                return fn()
            except Exception as e:
                import traceback

                traceback.print_exc()
                self.set_status(f"error: {e}")
                return None

        def _sync_action_states(self):
            """Reflect shell/browser state in the checkable actions
            (the reference keeps mode/link actions checkable,
            `audian.py:342-425,494-699`)."""
            for act, getter in self._state_acts:
                try:
                    act.setChecked(bool(getter()))
                except Exception:
                    pass

        def _build_menus(self):
            """The reference's full menu/action surface with its shortcut
            table (`src/audian/audian.py:263-1271`); deliberate
            deviations: analysis results on Alt+R (the reference
            double-books Alt+A with link-amplitude), no pan/rect submodes
            beyond the two mouse-mode actions."""
            mb = self.menuBar()
            sh = self.shell
            B = self.browser

            filem = mb.addMenu("&File")
            self._act(filem, "&Open", "Ctrl+O", self.open_files)
            self._act(filem, "&Close tab", "Ctrl+W", self.close_tab)
            self._act(filem, "Save &window as", "Ctrl+Shift+S",
                      lambda: B().save_window())
            self._act(filem, "&Screenshot", "Ctrl+Alt+S", self.screenshot)
            self._act(filem, "&Metadata", None, self.show_metadata)
            self._act(filem, "&Key shortcuts", "Ctrl+K", self.key_shortcuts)
            self._act(filem, "&About", None, self.about)
            # step the QTabWidget (not just shell.current): currentChanged
            # keeps the shell in sync, while a shell-only step would leave
            # the visible tab showing a different recording than the one
            # all verbs act on
            self._act(filem, "Next tab", "Ctrl+PgDown",
                      lambda: self._step_tab(1))
            self._act(filem, "Previous tab", "Ctrl+PgUp",
                      lambda: self._step_tab(-1))
            self._act(filem, "&Quit", "Ctrl+Q", self.close)

            timem = mb.addMenu("&Time")
            self._act(timem, "Page &down", ["PgDown", "Right"],
                      lambda: B().time_page_down())
            self._act(timem, "Page &up", ["PgUp", "Left"],
                      lambda: B().time_page_up())
            self._act(timem, "Small step down", "Down",
                      lambda: B().apply_time_ranges("small_up"))
            self._act(timem, "Small step up", "Up",
                      lambda: B().apply_time_ranges("small_down"))
            self._act(timem, "Zoom &in", ["+", "="],
                      lambda: B().time_zoom_in())
            self._act(timem, "Zoom &out", "-",
                      lambda: B().time_zoom_out())
            self._act(timem, "Zoom in centered", "Shift+T",
                      lambda: B().apply_time_ranges("zoom_in_centered"))
            self._act(timem, "Zoom out centered", "T",
                      lambda: B().apply_time_ranges("zoom_out_centered"))
            self._act(timem, "&Home", "Home", lambda: B().time_home())
            self._act(timem, "&End", "End", lambda: B().time_end())
            self._act(timem, "&Snap", ".",
                      lambda: B().apply_time_ranges("snap"))
            self._act(timem, "&Auto scroll", "!", lambda: B().auto_scroll())
            self._act(timem, "Toggle &start time", "Ctrl+Shift+T",
                      self.toggle_starttime)
            self._act(timem, "Link time &zoom", "Alt+Z",
                      sh.toggle_link_timezoom,
                      checked=lambda: sh.link_timezoom)
            self._act(timem, "Link time &scroll", "Alt+T",
                      sh.toggle_link_timescroll,
                      checked=lambda: sh.link_timescroll)

            ampm = mb.addMenu("&Amplitude")
            for letter in "xyu":
                self._act(ampm, f"Zoom {letter} in", f"Shift+{letter.upper()}",
                          lambda a=letter: sh.apply_ranges("zoom_in", a))
                self._act(ampm, f"Zoom {letter} out", letter.upper(),
                          lambda a=letter: sh.apply_ranges("zoom_out", a))
            self._act(ampm, "&Auto", "V", lambda: B().auto_ampl())
            self._act(ampm, "&Reset", "Shift+V",
                      lambda: sh.apply_ranges("reset", "xyu"))
            self._act(ampm, "&Center", "C",
                      lambda: sh.apply_ranges("center", "xyu"))
            self._act(ampm, "Link &amplitude", "Alt+A",
                      sh.toggle_link_amplitude,
                      checked=lambda: sh.link_ranges.get("x", False))

            filtm = mb.addMenu("Fi&lter")
            self._act(filtm, "&Highpass up", "Shift+H",
                      lambda: self._filter(1.25, None))
            self._act(filtm, "Highpass &down", "H",
                      lambda: self._filter(0.8, None))
            self._act(filtm, "&Lowpass up", "Shift+L",
                      lambda: self._filter(None, 1.25))
            self._act(filtm, "Lowpass d&own", "L",
                      lambda: self._filter(None, 0.8))
            self._act(filtm, "Link &filter", "Alt+F",
                      sh.toggle_link_filter,
                      checked=lambda: sh.link_filter)
            self._act(filtm, "&Show envelope", "Ctrl+E",
                      sh.toggle_show_envelope,
                      checked=lambda: (
                          sh.current is not None
                          and "envelope" in sh.current.data
                          and sh.current.data.is_visible("envelope")))
            self._act(filtm, "&Envelope up", "Shift+E",
                      lambda: self._envelope(2.0))
            self._act(filtm, "Envelope &down", "E",
                      lambda: self._envelope(0.5))
            self._act(filtm, "Link &envelope", "Alt+E",
                      sh.toggle_link_envelope,
                      checked=lambda: sh.link_envelope)

            specm = mb.addMenu("&Spectrogram")
            self._act(specm, "Increase &resolution", "Shift+R",
                      lambda: self._step_resolution(+1))
            self._act(specm, "Decrease r&esolution", "R",
                      lambda: self._step_resolution(-1))
            self._act(specm, "More &overlap", "Shift+O",
                      lambda: B().overlap_frac_up())
            self._act(specm, "Less o&verlap", "O",
                      lambda: B().overlap_frac_down())
            self._act(specm, "&Color map", "Shift+C",
                      lambda: B().color_map_cycler())
            self._act(specm, "Frequency f zoom in", "Shift+F",
                      lambda: sh.apply_ranges("zoom_in", "f"))
            self._act(specm, "Frequency f zoom out", "F",
                      lambda: sh.apply_ranges("zoom_out", "f"))
            self._act(specm, "Frequency w zoom in", "Shift+W",
                      lambda: sh.apply_ranges("zoom_in", "w"))
            self._act(specm, "Frequency w zoom out", "W",
                      lambda: sh.apply_ranges("zoom_out", "w"))
            # the reference moves frequencies with the arrow keys
            # (MoveToNextChar); those keys page time here (see above), so
            # frequency moves live on Ctrl+arrows
            self._act(specm, "Frequency up", "Ctrl+Right",
                      lambda: sh.apply_ranges("step_up", "fw"))
            self._act(specm, "Frequency down", "Ctrl+Left",
                      lambda: sh.apply_ranges("step_down", "fw"))
            self._act(specm, "Frequency home", "Ctrl+Shift+Left",
                      lambda: sh.apply_ranges("home", "fw"))
            self._act(specm, "Frequency end", "Ctrl+Shift+Right",
                      lambda: sh.apply_ranges("end", "fw"))
            self._act(specm, "Link fre&quency", "Alt+Q",
                      sh.toggle_link_frequency,
                      checked=lambda: sh.link_ranges.get("f", False))
            self._act(specm, "Power &up", "Shift+D",
                      lambda: sh.apply_power_ranges("up"))
            self._act(specm, "Power &down", "D",
                      lambda: sh.apply_power_ranges("down"))
            self._act(specm, "Max power up", "Shift+K",
                      lambda: sh.apply_power_ranges("max_up"))
            self._act(specm, "Max power down", "K",
                      lambda: sh.apply_power_ranges("max_down"))
            self._act(specm, "Min power up", "Shift+J",
                      lambda: sh.apply_power_ranges("min_up"))
            self._act(specm, "Min power down", "J",
                      lambda: sh.apply_power_ranges("min_down"))
            self._act(specm, "Link &power", "Alt+W",
                      sh.toggle_link_power,
                      checked=lambda: sh.link_ranges.get("p", False))

            chm = mb.addMenu("&Channels")
            self._act(chm, "&Next channel", "Shift+Down",
                      lambda: sh.select_channels("next_channel"))
            self._act(chm, "&Previous channel", "Shift+Up",
                      lambda: sh.select_channels("previous_channel"))
            self._act(chm, "Select next", "Shift+PgDown",
                      lambda: sh.select_channels("select_next_channel"))
            self._act(chm, "Select previous", "Shift+PgUp",
                      lambda: sh.select_channels("select_previous_channel"))
            self._act(chm, "Select &all", "Ctrl+A",
                      lambda: sh.select_channels("all_channels"))
            self._act(chm, "&Hide deselected", "Del",
                      sh.hide_deselected_channels)
            # reference bindings (audian.py:1024-1025): the bare digit
            # TOGGLES channel c, Ctrl+digit SHOWS only channel c
            for c in range(10):
                self._act(chm, f"Channel &{c}", str(c),
                          lambda c=c: sh.toggle_channel(c))
                self._act(chm, f"Show channel {c}", f"Ctrl+{c}",
                          lambda c=c: sh.show_channel(c))
            self._act(chm, "Link &channels", "Alt+C",
                      sh.toggle_link_channels,
                      checked=lambda: sh.link_channels)

            panm = mb.addMenu("&Panels")
            self._act(panm, "Toggle &traces", "Ctrl+T",
                      lambda: B().toggle_traces())
            self._act(panm, "Toggle &spectrograms", "Ctrl+S",
                      lambda: B().toggle_spectrograms())
            self._act(panm, "Toggle &powers", "Ctrl+P",
                      lambda: B().toggle_powers())
            self._act(panm, "Toggle &colorbars", "Ctrl+B",
                      lambda: B().toggle_colorbars())
            self._act(panm, "Toggle &fulldata", "Ctrl+F",
                      lambda: B().toggle_fulldata())
            self._act(panm, "Toggle &grid", "G",
                      lambda: B().toggle_grids())
            self._act(panm, "Toggle &maximize", "Ctrl+Shift+M",
                      self.toggle_maximize)
            self._act(panm, "Link &panels", "Alt+P", sh.toggle_link_panels,
                      checked=lambda: sh.link_panels)

            audm = mb.addMenu("A&udio")
            self._act(audm, "Use &heterodyne", None,
                      lambda: B().set_audio(
                          use_heterodyne=not B().audio_use_heterodyne),
                      checked=lambda: (B() is not None
                                       and B().audio_use_heterodyne))
            self._act(audm, "Heterodyne frequency up", None,
                      lambda: B().set_audio(heterodyne_freq=max(
                          B().audio_heterodyne_freq, 100.0) * 2))
            self._act(audm, "Heterodyne frequency down", None,
                      lambda: B().set_audio(heterodyne_freq=max(
                          B().audio_heterodyne_freq / 2, 100.0)))
            # rate_fac is a SLOW-DOWN factor (prepare_playback divides
            # the output rate by it), so "rate up" must shrink it
            self._act(audm, "Playback rate up", None,
                      lambda: B().set_audio(
                          rate_fac=B().audio_rate_fac / 2))
            self._act(audm, "Playback rate down", None,
                      lambda: B().set_audio(
                          rate_fac=B().audio_rate_fac * 2))
            self._act(audm, "Link audio", None, sh.toggle_link_audio,
                      checked=lambda: sh.link_audio)

            regm = mb.addMenu("&Region")
            self._act(regm, "&Rectangle zoom", "Ctrl+R",
                      lambda: self.set_mouse_mode(True),
                      checked=lambda: self.select_mode)
            self._act(regm, "Pa&n && zoom", "Ctrl+Z",
                      lambda: self.set_mouse_mode(False),
                      checked=lambda: not self.select_mode)
            for label, key, mode in (
                    ("&Zoom", "Z", 0), ("&Play", "P", 1),
                    ("&Analyze", "A", 2), ("&Save", "S", 3),
                    ("Re&quest", "Q", 4)):
                self._act(regm, label + " mode", key,
                          lambda m=mode: B().set_region_mode(m),
                          checked=lambda m=mode: (
                              B() is not None and B().region_mode == m))
            self._act(regm, "Zoom &back", ["Backspace", "Alt+Left"],
                      lambda: self.tab().zoom_back())
            self._act(regm, "Zoom &forward",
                      ["Shift+Backspace", "Alt+Right"],
                      lambda: self.tab().zoom_forward())
            self._act(regm, "Zoom &home", "Alt+Backspace",
                      lambda: self.tab().zoom_home())
            self._act(regm, "Cross &hair mode", "Ctrl+C",
                      self.toggle_crosshair_mode,
                      checked=lambda: self.crosshair_mode)
            # marker-label actions: armed only in crosshair mode, where
            # their single-letter keys take over from conflicting verbs
            # (`databrowser.py:726-760`); labels resolve at trigger time
            # so the label editor and tab switches stay in sync
            self._marker_menu = regm
            self._marker_act_labels = {}
            self._sync_marker_acts()
            self.tabs.currentChanged.connect(
                lambda i: self._sync_marker_acts())
            self._act(regm, "Play &window", "Space", self.play_scroll)
            self._act(regm, "Analysis &results", "Alt+R",
                      self.analysis_results)
            self._act(regm, "Save &analysis", None,
                      lambda: B().save_analysis())
            self._act(regm, "&Marker table", "Ctrl+M", self.marker_table)
            self._act(regm, "&Label editor", "Ctrl+L", self.label_editor)

        # -- dialogs + file actions ---------------------------------------------------

        def open_files(self):
            """Open more recordings into new tabs (`audian.py:264-267` +
            the incremental loader `audian.py:1325-1407`)."""
            paths, _ = QFileDialog.getOpenFileNames(
                self, "Open recordings", "",
                "Audio (*.wav *.WAV *.w64 *.W64 *.flac *.FLAC *.ogg *.OGG"
                " *.aiff *.AIFF *.aif *.AIF *.mp3 *.MP3 *.opus"
                " *.OPUS);;All files (*)")
            if not paths:
                return
            # non-blocking: tabs appear as the pump opens each file;
            # failures surface as per-file dialogs via sigBrowserFailed
            self.shell.queue_files(paths)
            self._pump_loads()

        def close_tab(self):
            """Close the current recording (`audian.py:280-282`); the
            shell's current browser follows whatever tab Qt displays
            afterwards."""
            i = self.tabs.currentIndex()
            if not (0 <= i < len(self.shell)):
                return
            tab = self.tabs.widget(i)
            if tab is not None:
                tab.teardown()
            browser = self.shell.browsers.pop(i)
            browser.close()
            self.tabs.removeTab(i)
            if tab is not None:
                # removeTab keeps the page widget alive and parented
                tab.deleteLater()
            j = self.tabs.currentIndex()
            self.shell.current = (self.shell.browsers[j]
                                  if 0 <= j < len(self.shell.browsers)
                                  else None)

        def key_shortcuts(self):
            """Dialog listing every action and its keys
            (`audian.py` key_shortcuts)."""
            dialog = QDialog(self)
            dialog.setAttribute(Qt.WA_DeleteOnClose, True)
            dialog.setWindowTitle("Audian key shortcuts")
            vbox = QVBoxLayout(dialog)
            widget = QTableWidget(len(self._all_acts), 2)
            widget.setHorizontalHeaderLabels(["action", "keys"])
            for r, act in enumerate(self._all_acts):
                widget.setItem(r, 0, QTableWidgetItem(
                    act.text().replace("&", "")))
                widget.setItem(r, 1, QTableWidgetItem(
                    ", ".join(self._keys(act))))
            vbox.addWidget(widget)
            buttons = QDialogButtonBox(QDialogButtonBox.Close)
            buttons.rejected.connect(dialog.reject)
            vbox.addWidget(buttons)
            dialog.show()
            return dialog

        def about(self):
            from ..version import __version__

            dialog = QDialog(self)
            dialog.setAttribute(Qt.WA_DeleteOnClose, True)
            dialog.setWindowTitle("About Audian")
            vbox = QVBoxLayout(dialog)
            vbox.addWidget(QLabel(
                f"<b>audian-torch {__version__}</b><br>"
                "Interactive analyzer for animal vocalization recordings "
                "on PyTorch and CUDA."))
            buttons = QDialogButtonBox(QDialogButtonBox.Close)
            buttons.rejected.connect(dialog.reject)
            vbox.addWidget(buttons)
            dialog.show()
            return dialog

        def _sync_marker_acts(self):
            """Grow/update the marker-label actions to the current
            browser's labels (the label editor may rename/rebind them),
            then recompute the shortcut parking — rebinding without
            re-parking leaves two enabled actions on one key, which real
            Qt treats as an ambiguous shortcut that fires NEITHER."""
            labels = (self.shell.current.marker_labels
                      if self.shell.current else [])
            while len(self.marker_acts) < len(labels):
                slot = {}
                act = self._act(
                    self._marker_menu, "marker", None,
                    lambda s=slot: self.browser().store_marker(
                        label=self._marker_act_labels.get(s["act"], "")))
                slot["act"] = act
                self.marker_acts.append(act)
            for act, lbl in zip(self.marker_acts, labels):
                act.setText(f"Store '{lbl.label}' marker")
                act.setShortcuts([lbl.key_shortcut]
                                 if lbl.key_shortcut else [])
                self._marker_act_labels[act] = lbl.label
            for act in self.marker_acts[len(labels):]:
                act.setShortcuts([])
                self._marker_act_labels.pop(act, None)
            self._apply_crosshair_parking()

        def _apply_crosshair_parking(self):
            """Recompute which actions are enabled from scratch: in
            crosshair mode the bound marker acts are armed and every
            other action sharing one of their keys is parked; outside it
            all ordinary actions are armed and the marker acts sleep."""
            keys = {s.lower() for a in self.marker_acts
                    for s in self._keys(a)}
            for act in self._all_acts:
                if act in self.marker_acts:
                    act.setEnabled(self.crosshair_mode
                                   and act in self._marker_act_labels)
                else:
                    conflict = any(s.lower() in keys
                                   for s in self._keys(act))
                    act.setEnabled(not (self.crosshair_mode and conflict))

        # -- mode toggles -------------------------------------------------------------

        def set_mouse_mode(self, rect_select):
            """Rect-select vs pan/zoom left drags on every panel
            (`audian.py:341-354` rect_zoom / pan_zoom)."""
            self.select_mode = bool(rect_select)  # applied to new tabs
            for i in range(self.tabs.count()):
                tab = self.tabs.widget(i)
                for pt, _ in tab.trace_plots.values():
                    pt.vb.set_select_mode(rect_select)
                for ps, _ in tab.spec_images.values():
                    ps.vb.set_select_mode(rect_select)

        def toggle_crosshair_mode(self):
            """Crosshair mode arms the marker-label key shortcuts and
            parks any other action sharing their keys; leaving the mode
            restores them and clears the crosshair
            (`databrowser.py:726-760`)."""
            self.crosshair_mode = not self.crosshair_mode
            self._apply_crosshair_parking()
            if not self.crosshair_mode:
                b = self.browser()
                if b is not None:
                    b.clear_crosshair()
                self.set_status("")

        def toggle_starttime(self):
            """Cycle the time-label mode everywhere: the headless time
            ranges (for readouts) and every tab's Qt time axes
            (`audian.py:475-480` + `timeaxisitem.py:20-26`)."""
            self.shell.toggle_starttime()
            mode = self.shell.starttime_mode
            for i in range(self.tabs.count()):
                for axis in self.tabs.widget(i).time_axes:
                    axis.set_starttime(mode)

        # -- drag-dropped screenshots (`audian.py:226-260`) --------------------------

        def dragEnterEvent(self, ev):
            if ev.mimeData().hasUrls():
                ev.acceptProposedAction()

        def dropEvent(self, ev):
            if not ev.mimeData().hasUrls():
                return
            path = Path(ev.mimeData().urls()[0].toLocalFile())
            if self.restore_screenshot(path):
                ev.acceptProposedAction()

        def restore_screenshot(self, path):
            """Restore the view stored in a screenshot PNG's metadata;
            returns True when the drop was handled."""
            from ..app.screenshot import parse_view_metadata

            path = Path(path)
            if path.suffix.lower() != ".png":
                return False
            try:
                view = parse_view_metadata(path)
            except (OSError, ValueError):
                return False
            if view is None:
                return False
            target = Path(view["file"]).name
            for i, b in enumerate(self.shell.browsers):
                if Path(str(b.file_path)).name == target:
                    self.tabs.setCurrentIndex(i)
                    self.shell.set_current(b)
                    if view["channels"]:
                        b.set_channels(view["channels"])
                    b.set_times(view["toffset"], view["twindow"])
                    self._refresh()
                    return True
            return False

        # -- verbs needing Qt glue --------------------------------------------------

        def _filter(self, hp_fac, lp_fac):
            # semantics live in the headless verb (10 Hz lift-off floor,
            # below-10 turn-off, Nyquist clamps) — single-sourced so the
            # two frontends cannot diverge
            self.browser().step_filter(hp_fac, lp_fac)

        def _envelope(self, fac):
            b = self.browser()
            if "envelope" in b.data:
                b.update_envelope(b.data["envelope"].envelope_cutoff * fac)

        def _step_resolution(self, direction):
            b = self.browser()
            if direction > 0:
                b.freq_resolution_up()
            else:
                b.freq_resolution_down()

        def play_scroll(self):
            verb, result = self.browser().play_scroll()
            if verb == "play":
                self.tab()._play(*result)
            elif verb == "audio-stopped":
                # actually silence the device, not just the marker
                try:
                    import sounddevice

                    sounddevice.stop()
                except Exception:
                    pass

        def toggle_maximize(self):
            """Toggle main-window maximization (`audian.py:1410-1414`)."""
            if self.isMaximized():
                self.showNormal()
            else:
                self.showMaximized()

        def screenshot(self):
            from ..app.screenshot import write_view_metadata

            path, _ = QFileDialog.getSaveFileName(
                self, "Save screenshot", "screenshot.png", "PNG (*.png)")
            if not path:
                return
            pixmap = self.grab()
            if not pixmap.save(path, "PNG"):
                self.set_status(f"cannot write {path}")
                return
            write_view_metadata(path, self.browser())
            self.set_status(f"saved screenshot to {path}")

        def show_metadata(self):
            """Metadata dialog (`databrowser.py:677-724`) rendered from
            the headless rows."""
            import html as _html

            rows = self.browser().metadata_rows()
            html = ["<table>"]
            for level, key, value in rows:
                # metadata strings are arbitrary: unescaped '<'/'&'
                # corrupt the rich-text table
                key = _html.escape(str(key))
                pad = f' style="padding-left: {level * 30}px;"'
                if value is None:
                    html.append(f"<tr><td colspan=2{pad}><b>{key}:</b>"
                                "</td></tr>")
                else:
                    html.append(f"<tr><td{pad}><b>{key}</b></td>"
                                f"<td>{_html.escape(str(value))}</td></tr>")
            html.append("</table>")
            dialog = QDialog(self)
            dialog.setAttribute(Qt.WA_DeleteOnClose, True)
            dialog.setWindowTitle("Meta data")
            vbox = QVBoxLayout(dialog)
            label = QLabel("".join(html))
            label.setTextInteractionFlags(Qt.TextSelectableByMouse)
            area = QScrollArea()
            area.setWidget(label)
            vbox.addWidget(area)
            buttons = QDialogButtonBox(QDialogButtonBox.Close)
            buttons.rejected.connect(dialog.reject)
            vbox.addWidget(buttons)
            dialog.show()

        def analysis_results(self):
            """Analysis table dialog (`databrowser.py:1795-1825`)."""
            table = self.browser().get_analysis_table()
            if not table:
                return
            dialog = QDialog(self)
            dialog.setAttribute(Qt.WA_DeleteOnClose, True)
            dialog.setWindowTitle("Audian analysis table")
            vbox = QVBoxLayout(dialog)
            widget = QTableWidget(len(table), len(table[0]))
            widget.setHorizontalHeaderLabels(list(table[0].keys()))

            def fill():
                rows = self.browser().get_analysis_table()
                widget.setRowCount(len(rows))
                for r, row in enumerate(rows):
                    for c, v in enumerate(row.values()):
                        widget.setItem(r, c, QTableWidgetItem(str(v)))

            fill()
            vbox.addWidget(widget)
            buttons = QDialogButtonBox(QDialogButtonBox.Close |
                                       QDialogButtonBox.Save |
                                       QDialogButtonBox.Reset)
            buttons.rejected.connect(dialog.reject)
            # Reset must also refresh the visible table, or the user
            # saves what LOOKS like data into an empty CSV
            buttons.button(QDialogButtonBox.Reset).clicked.connect(
                lambda *_: (self.browser().clear_analysis(), fill()))
            buttons.button(QDialogButtonBox.Save).clicked.connect(
                lambda *_: self._guarded(
                    lambda: self.browser().save_analysis()))
            vbox.addWidget(buttons)
            dialog.show()

        def marker_table(self):
            """Marker table dialog (`databrowser.py:944-966`) over the
            headless marker store."""
            md = self.browser().marker_data

            dialog = QDialog(self)
            dialog.setAttribute(Qt.WA_DeleteOnClose, True)
            dialog.setWindowTitle("Audian marker table")
            vbox = QVBoxLayout(dialog)
            widget = QTableWidget(0, len(md.headers))
            widget.setHorizontalHeaderLabels(md.headers)
            vbox.addWidget(widget)

            def fill():
                df = md.data_frame()
                widget.setRowCount(len(df))
                for r in range(len(df)):
                    for c, col in enumerate(df.columns):
                        v = df.iloc[r, c]
                        text = "" if v is None or (
                            isinstance(v, float) and np.isnan(v)) else str(v)
                        widget.setItem(r, c, QTableWidgetItem(text))
                widget.resizeColumnsToContents()

            def save():
                # offer XLSX only when openpyxl can actually write it
                # (`markerdata.py:512-516` does the same probe)
                filters = "CSV (*.csv)"
                try:
                    import openpyxl  # noqa: F401
                    filters += ";;Excel (*.xlsx)"
                except ImportError:
                    pass
                path, _ = QFileDialog.getSaveFileName(
                    self, "Save markers", "markers.csv", filters)
                if path:
                    saved = self._guarded(lambda: md.save(path))
                    if saved is not None:
                        self.set_status(f"saved markers to {saved}")

            fill()
            buttons = QDialogButtonBox(QDialogButtonBox.Close |
                                       QDialogButtonBox.Save |
                                       QDialogButtonBox.Reset)
            buttons.rejected.connect(dialog.reject)
            buttons.button(QDialogButtonBox.Reset).clicked.connect(
                lambda: (md.clear(), fill(), self._refresh()))
            buttons.button(QDialogButtonBox.Save).clicked.connect(save)
            vbox.addWidget(buttons)
            dialog.show()

        def label_editor(self):
            """Marker-label editor (`markerdata.py:269-326`): edit
            name/key/color rows with key-conflict validation."""
            from ..app.markers import MarkerLabel, key_conflicts

            b = self.browser()
            dialog = QDialog(self)
            dialog.setAttribute(Qt.WA_DeleteOnClose, True)
            dialog.setWindowTitle("Audian marker labels")
            vbox = QVBoxLayout(dialog)
            widget = QTableWidget(len(b.marker_labels), 3)
            widget.setHorizontalHeaderLabels(["label", "key", "color"])
            for r, lbl in enumerate(b.marker_labels):
                widget.setItem(r, 0, QTableWidgetItem(lbl.label))
                widget.setItem(r, 1, QTableWidgetItem(lbl.key_shortcut))
                widget.setItem(r, 2, QTableWidgetItem(lbl.color))
            vbox.addWidget(widget)

            def row_text(r, c):
                item = widget.item(r, c)
                return item.text().strip() if item is not None else ""

            def add_row():
                widget.insertRow(widget.rowCount())

            def remove_rows():
                for r in sorted({i.row() for i in widget.selectedIndexes()},
                                reverse=True):
                    widget.removeRow(r)

            def accept():
                labels = []
                for r in range(widget.rowCount()):
                    name = row_text(r, 0)
                    if name:
                        labels.append(MarkerLabel(name, row_text(r, 1),
                                                  row_text(r, 2) or "yellow"))
                conflicts = key_conflicts(labels)  # skips empty keys
                if conflicts:
                    QMessageBox.warning(
                        dialog, "Key conflicts",
                        "\n".join(f"key {k!r} used by {', '.join(v)}"
                                  for k, v in conflicts.items()))
                    return
                b.marker_labels[:] = labels
                self._sync_marker_acts()
                dialog.accept()

            hbox = QHBoxLayout()
            for text, fn in (("&Add", add_row), ("&Remove", remove_rows)):
                btn = QPushButton(text)
                btn.clicked.connect(lambda *_, f=fn: f())
                hbox.addWidget(btn)
            vbox.addLayout(hbox)
            buttons = QDialogButtonBox(QDialogButtonBox.Ok |
                                       QDialogButtonBox.Cancel)
            buttons.accepted.connect(accept)
            buttons.rejected.connect(dialog.reject)
            vbox.addWidget(buttons)
            dialog.show()


def run_qt(shell):
    """Start the Qt event loop over a loaded shell."""
    if not HAVE_QT:
        raise ImportError("PyQt5/pyqtgraph are not installed")
    # unknown CLI args pass through to Qt (`audian.py:1494` parity)
    app = QApplication(sys.argv[:1] + list(getattr(shell, "gui_args", [])))
    win = AudianWindow(shell)
    win.resize(1200, 800)
    win.show()
    rc = app.exec_()
    shell.close()
    return rc
