"""The multi-recording application shell (headless core).

Rebuild of the GUI-independent part of the reference's ``Audian`` main
window (`src/audian/audian.py:31-1544`): manages one
:class:`~audian_torch.app.browser.DataBrowser` per recording, dispatches
linked state across them (time zoom/scroll, per-letter axis ranges,
filter, envelope, resolution, channels, audio settings), loads files
incrementally while tolerating failures (`audian.py:1339-1407`), and
parses the reference's command line (`audian.py:1467-1523`).

The counterpart of ``audian_tpu/app/shell.py``.  Every browser runs on
the shell's ``device`` (the CUDA card unless the caller names another).
Frontends attach their widgets to the browsers this shell owns.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from ..analysis import Plugins
from ..cli.compress import parse_load_kwargs
from ..utils import resolve_device
from ..version import __version__, __year__
from .browser import DataBrowser, Signal


def parse_channels(spec):
    """Parse the -c channel list: comma-separated, with ``a-b`` ranges
    (`audian.py:1496-1506`)."""
    channels = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        lo, dash, hi = part.partition("-")
        if dash:
            channels.extend(range(int(lo), int(hi) + 1))
        else:
            channels.append(int(part))
    return channels


class Audian:
    """Headless multi-recording shell; its browsers run on ``device``
    (the CUDA card by default; without CUDA the constructor raises)."""

    def __init__(self, file_paths=(), load_kwargs=None, plugins=None,
                 channels=None, highpass_cutoff=None, lowpass_cutoff=None,
                 unwrap=0.0, unwrap_clip=False, verbose=0, device=None):
        self.device = resolve_device(device)
        self.plugins = plugins or Plugins()
        self.load_kwargs = dict(load_kwargs or {})
        self.channels = list(channels or [])
        self.highpass_cutoff = highpass_cutoff
        self.lowpass_cutoff = lowpass_cutoff
        self.unwrap = unwrap
        self.unwrap_clip = unwrap_clip
        self.verbose = verbose
        self.browsers = []
        self.current = None
        self.errors = []
        # link state (`audian.py:54-63`)
        self.link_timezoom = True
        self.link_timescroll = False
        self.link_ranges = {s: True for s in "xyufwpq"}
        self.link_filter = True
        self.link_envelope = True
        self.link_channels = True
        self.link_panels = True
        self.link_audio = True
        self.sigBrowserAdded = Signal()
        self.sigBrowserFailed = Signal()
        self._pending = list(file_paths)
        self._dispatching = False

    # -- loading (incremental, failure-tolerant: `audian.py:1339-1407`) ----------

    @property
    def pending(self):
        """Recordings queued but not yet opened (progressive loading)."""
        return list(self._pending)

    def queue_files(self, file_paths):
        """Queue recordings for later :meth:`load_next` calls without
        opening them now — the Qt frontend pumps the queue one file per
        event-loop tick so the window stays responsive while a long list
        loads (`audian.py:1339-1343,1369-1373`)."""
        self._pending.extend(file_paths)

    def load_files(self, file_paths=None):
        if file_paths is not None:
            self._pending.extend(file_paths)
        while self._pending:
            self.load_next()
        return self.browsers

    def load_next(self):
        """Open the next pending recording; a failure drops that file and
        continues (`audian.py:1349-1356`)."""
        if not self._pending:
            return None
        path = self._pending.pop(0)
        browser = DataBrowser(path, channels=self.channels or None,
                              plugins=self.plugins,
                              load_kwargs=self.load_kwargs,
                              unwrap=self.unwrap,
                              unwrap_clip=self.unwrap_clip,
                              device=self.device)
        try:
            browser.open()
        except Exception as e:
            # a partially opened browser holds a loader handle and a
            # device-resident raw mirror — release them
            try:
                browser.close()
            except Exception:
                pass
            self.errors.append((path, e))
            self.sigBrowserFailed.emit(path, e)
            if self.verbose:
                print(f"failed to open {path}: {e}", file=sys.stderr)
            return None
        if self.highpass_cutoff is not None or self.lowpass_cutoff is not None:
            browser.update_filter(self.highpass_cutoff, self.lowpass_cutoff)
        self._connect(browser)
        self.browsers.append(browser)
        if self.current is None:
            self.current = browser
        else:
            self._sync_new(browser)
        self.sigBrowserAdded.emit(browser)
        return browser

    def _sync_new(self, browser):
        """Bring an incrementally loaded browser up to the current linked
        state — window, channels, panel toggles, start-time mode — like
        the reference's load_data (`audian.py:1386-1407`); without this a
        late-loading tab breaks the link invariants until the next
        user-driven change."""
        src = self.current
        if src is None or src is browser:
            return

        def sync():
            if self.link_timezoom or self.link_timescroll:
                browser.set_times(
                    src.toffset if self.link_timescroll else None,
                    src.twindow if self.link_timezoom else None)
            if self.link_channels:
                browser.set_channels(list(src.show_channels),
                                     list(src.selected_channels))
            if self.link_panels:
                browser.set_panels(traces=src.show_traces,
                                   specs=src.show_specs,
                                   powers=src.show_powers,
                                   cbars=src.show_cbars,
                                   fulldata=src.show_fulldata)
            mode = getattr(self, "starttime_mode", 0)
            if mode and browser.plot_ranges is not None:
                browser.plot_ranges["t"].set_starttime(mode)
        self._dispatch(sync)

    def close(self):
        for b in self.browsers:
            b.close()
        self.browsers = []
        self.current = None

    def __len__(self):
        return len(self.browsers)

    def __getitem__(self, idx):
        return self.browsers[idx]

    def set_current(self, browser_or_index):
        if isinstance(browser_or_index, int):
            self.current = self.browsers[browser_or_index]
        else:
            self.current = browser_or_index

    # -- cross-browser link dispatch (`audian.py:597-612,787-795,908-916`) --------

    def _connect(self, browser):
        browser.sigTimesChanged.connect(
            lambda t0, tw, b=browser: self._dispatch_times(b, t0, tw))
        browser.sigFilterChanged.connect(
            lambda b=browser: self._dispatch_filter(b))
        browser.sigEnvelopeChanged.connect(
            lambda b=browser: self._dispatch_envelope(b))
        browser.sigChannelsChanged.connect(
            lambda ch, b=browser: self._dispatch_channels(b, ch))
        browser.sigAudioChanged.connect(
            lambda *a, b=browser: self._dispatch_audio(b, *a))
        browser.sigColorMapChanged.connect(
            lambda b=browser: self._dispatch_colormap(b))
        browser.sigPanelsChanged.connect(
            lambda b=browser: self._dispatch_panels(b))
        browser.sigRangesChanged.connect(self._dispatch_ranges)
        browser.sigTraceChanged.connect(self._dispatch_trace)

    def _others(self, browser):
        return [b for b in self.browsers if b is not browser]

    def _dispatch(self, fn):
        """Reentrancy guard: linked updates must not echo back
        (the reference uses blockSignals, `audian.py:793-795`)."""
        if self._dispatching:
            return
        self._dispatching = True
        try:
            fn()
        finally:
            self._dispatching = False

    def _dispatch_times(self, browser, toffset, twindow):
        def fan():
            for b in self._others(browser):
                b.set_times(toffset if self.link_timescroll else None,
                            twindow if self.link_timezoom else None)
        if self.link_timezoom or self.link_timescroll:
            self._dispatch(fan)

    def _dispatch_filter(self, browser):
        if not self.link_filter or "filtered" not in browser.data:
            return
        f = browser.data["filtered"]

        def fan():
            for b in self._others(browser):
                b.update_filter(f.highpass_cutoff, f.lowpass_cutoff)
        self._dispatch(fan)

    def _dispatch_envelope(self, browser):
        if not self.link_envelope or "envelope" not in browser.data:
            return
        cutoff = browser.data["envelope"].envelope_cutoff

        def fan():
            for b in self._others(browser):
                b.update_envelope(cutoff, dispatch=False)
        self._dispatch(fan)

    def _dispatch_channels(self, browser, channels):
        if not self.link_channels:
            return

        def fan():
            for b in self._others(browser):
                b.set_channels(channels)
        self._dispatch(fan)

    def _dispatch_audio(self, browser, rate_fac, use_het, het_freq):
        if not self.link_audio:
            return

        def fan():
            for b in self._others(browser):
                b.set_audio(rate_fac, use_het, het_freq, dispatch=False)
        self._dispatch(fan)

    def _dispatch_trace(self, browser, checked, name):
        """Linked trace visibility (`audian.py:1094-1097`)."""
        def fan():
            for b in self._others(browser):
                b.set_trace(checked, name)
        self._dispatch(fan)

    def _dispatch_colormap(self, browser):
        """(`audian.py:767-771`)"""
        def fan():
            for b in self._others(browser):
                b.set_color_map(browser.color_map, dispatch=False)
        self._dispatch(fan)

    def _dispatch_panels(self, browser):
        """Linked panel-visibility fan-out (`audian.py:1104-1161`)."""
        if not self.link_panels:
            return

        def fan():
            for b in self._others(browser):
                b.set_panels(browser.show_traces, browser.show_specs,
                             browser.show_powers, browser.show_cbars,
                             browser.show_fulldata)
        self._dispatch(fan)

    # -- linked axis ranges (`audian.py:586-612`) -------------------------------------

    def _dispatch_ranges(self, browser, axspec, arange):
        """Fan per-letter range state out to the other browsers, honoring
        the per-letter link flags (`audian.py:597-612`)."""
        def fan():
            for s, (r0, r1) in zip(axspec, arange):
                if s == "t":
                    toffs = r0 if self.link_timescroll else None
                    twin = (r1 - r0) if self.link_timezoom else None
                    for b in self._others(browser):
                        b.set_times(toffs, twin)
                elif self.link_ranges.get(s):
                    for b in self._others(browser):
                        b.set_ranges(s, r0, r1)
        self._dispatch(fan)

    def apply_ranges(self, amplitudefunc, axspec):
        """Apply a range verb on the current browser and on every linked
        letter in the others (`audian.py:586-595`)."""
        if self.current is None or not axspec:
            return
        self.current.apply_ranges(amplitudefunc, axspec)

    def apply_power_ranges(self, amplitudefunc):
        """(`audian.py:779-780`)"""
        if self.current is not None and self.current.spectrogram:
            spec = self.current.data[self.current.spectrogram]
            panel = self.current.panels.get(getattr(spec, "panel",
                                                    "spectrogram"))
            if panel is not None and panel.z():
                self.apply_ranges(amplitudefunc, panel.z())

    def apply_time_ranges(self, timefunc):
        """(`audian.py:483-488`)"""
        if self.current is not None:
            self.current.apply_time_ranges(timefunc)

    # -- linked channel verbs (`audian.py:940-995`) ---------------------------------

    def _fan_channels(self):
        cur = self.current
        if self.link_channels and cur is not None and not cur.setting:
            def fan():
                for b in self._others(cur):
                    b.set_channels(cur.show_channels, cur.selected_channels,
                                   cur.current_channel)
            self._dispatch(fan)

    def select_channels(self, selectfunc):
        """Apply a channel-selection verb by name on the current browser
        and fan the resulting triplet state out (`audian.py:975-983`)."""
        if self.current is None:
            return
        getattr(self.current, selectfunc)()
        self._fan_channels()

    def show_channel(self, channel):
        if self.current is None:
            return
        self.current.show_channel(channel)
        self._fan_channels()

    def toggle_channel(self, channel, checked=None):
        if self.current is None:
            return
        self.current.toggle_channel(channel, checked)
        self._fan_channels()

    def hide_deselected_channels(self):
        if self.current is None:
            return
        self.current.hide_deselected_channels()
        self._fan_channels()

    # -- linked verbs (menu/keyboard surface) --------------------------------------

    def apply_time(self, verb):
        """Apply a time verb to the current browser; linking fans it out
        through the times-changed signal (`audian.py:483-488`)."""
        if self.current is not None:
            getattr(self.current, verb)()

    def toggle_link_timezoom(self):
        self.link_timezoom = not self.link_timezoom

    def toggle_link_timescroll(self):
        self.link_timescroll = not self.link_timescroll

    def toggle_link_filter(self):
        self.link_filter = not self.link_filter

    def toggle_link_envelope(self):
        self.link_envelope = not self.link_envelope

    def toggle_link_channels(self):
        self.link_channels = not self.link_channels

    def toggle_link_panels(self):
        self.link_panels = not self.link_panels

    def toggle_link_audio(self):
        self.link_audio = not self.link_audio

    def toggle_starttime(self):
        """Cycle the time-axis label mode (recording-relative / absolute /
        per-file) across all open recordings (`audian.py:473-478`,
        `src/audian/timeaxisitem.py:20-26`)."""
        self.starttime_mode = (getattr(self, "starttime_mode", 0) + 1) % 3
        for b in self.browsers:
            if b.plot_ranges is not None:
                b.plot_ranges["t"].set_starttime(self.starttime_mode)

    def auto_amplitude(self):
        """Auto-scale amplitudes on the current browser and every linked
        amplitude letter in the others (`audian.py:645-651`)."""
        if self.current is None:
            return
        self.current.auto_ampl()

        def fan():
            for s in "xyu":
                if self.link_ranges.get(s):
                    for b in self._others(self.current):
                        b.auto_ampl(s)
        # inside the guard: each browser's auto_ampl emits
        # sigRangesChanged, and the unguarded echo overwrote everyone's
        # auto-scaled ranges with the LAST browser's
        self._dispatch(fan)

    def toggle_show_envelope(self):
        """(`audian.py:995-996`)"""
        if self.current is not None and "envelope" in self.current.data:
            self.current.update_envelope(
                show_envelope=not self.current.data.is_visible("envelope"))

    def next_tab(self):
        """Cycle the current recording forward (`audian.py:1280-1287`)."""
        if self.browsers:
            i = self.browsers.index(self.current)
            self.current = self.browsers[(i + 1) % len(self.browsers)]

    def previous_tab(self):
        if self.browsers:
            i = self.browsers.index(self.current)
            self.current = self.browsers[(i - 1) % len(self.browsers)]

    def toggle_link_amplitude(self):
        """(`audian.py:653-656` — per-amplitude-letter link flags)"""
        for s in "xyu":
            self.link_ranges[s] = not self.link_ranges[s]

    def toggle_link_frequency(self):
        for s in "fw":
            self.link_ranges[s] = not self.link_ranges[s]

    def toggle_link_power(self):
        """(`audian.py:774-776`)"""
        for s in "pq":
            self.link_ranges[s] = not self.link_ranges[s]


def audian_cli(cargs=None, plugins=None, shell_cls=Audian, device=None):
    """Parse the reference-compatible command line and build the shell
    (`src/audian/audian.py:1467-1523`) on ``device`` (the CUDA card by
    default); returns the shell unopened so the caller decides how to run
    it."""
    device = resolve_device(device)
    parser = argparse.ArgumentParser(
        description="Browse and analyze recordings of animal vocalizations.",
        epilog=f"version {__version__} (audian_torch, 2026-{__year__})",
    )
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument("-v", action="count", dest="verbose", default=0,
                        help="print debug information")
    parser.add_argument("-c", dest="channels", default="", type=str,
                        metavar="CHANNELS",
                        help="comma separated list of channels to display "
                        "(first channel is 0, ranges like 2-5 allowed)")
    parser.add_argument("-f", dest="highpass_cutoff", type=float,
                        metavar="FREQ", default=None,
                        help="cutoff frequency of highpass filter in Hz")
    parser.add_argument("-l", dest="lowpass_cutoff", type=float,
                        metavar="FREQ", default=None,
                        help="cutoff frequency of lowpass filter in Hz")
    parser.add_argument("-i", dest="load_kwargs", default=[],
                        action="append", metavar="KWARGS",
                        help="key-word arguments for the data loader")
    parser.add_argument("-u", dest="unwrap", default=0, type=float,
                        metavar="THRESH", const=1.5, nargs="?",
                        help="unwrap clipped data and downscale by two")
    parser.add_argument("-U", dest="unwrap_clip", default=0, type=float,
                        metavar="THRESH", const=1.5, nargs="?",
                        help="unwrap clipped data and clip")
    parser.add_argument("--preset", dest="preset", default=None,
                        metavar="NAME",
                        help="processing-chain preset (rebuild extension): "
                        "one of audian_torch.models.PRESETS; installs the "
                        "preset's trace nodes, cutoffs, and NFFT")
    parser.add_argument("files", nargs="*", default=[], type=str,
                        help="files with the time series data")
    # unknown args pass through to the GUI toolkit (`audian.py:1494`
    # forwards them to QApplication) as shell.gui_args
    args, gui_args = parser.parse_known_args(cargs)

    unwrap, unwrap_clip = args.unwrap, False
    if args.unwrap_clip > 1e-3:
        unwrap, unwrap_clip = args.unwrap_clip, True

    files = []
    for fn in args.files:
        if os.name == "nt" and any(ch in fn for ch in "*?["):
            files.extend(sorted(glob.glob(fn)))
        else:
            files.append(fn)

    highpass, lowpass = args.highpass_cutoff, args.lowpass_cutoff
    if args.preset:
        from ..models import get_preset

        preset = get_preset(args.preset)  # raises loudly on a bad name
        plugins = plugins if plugins is not None else Plugins()
        plugins.clear_trace_factories()
        plugins.add_trace_factory(
            lambda b, p=preset: [b.add_trace(n) for n in p.nodes()])
        # explicit -f/-l override the preset's band
        if highpass is None and preset.highpass_cutoff:
            highpass = preset.highpass_cutoff
        if lowpass is None and preset.lowpass_cutoff:
            lowpass = preset.lowpass_cutoff

    shell = shell_cls(
        files,
        load_kwargs=parse_load_kwargs(args.load_kwargs),
        plugins=plugins,
        channels=parse_channels(args.channels),
        highpass_cutoff=highpass,
        lowpass_cutoff=lowpass,
        unwrap=unwrap,
        unwrap_clip=unwrap_clip,
        verbose=args.verbose,
        device=device,
    )
    shell.gui_args = gui_args
    return shell
