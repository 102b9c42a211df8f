"""The port's Qt frontend (``audian_torch.gui.qt``, browsers on
``device="cpu"``) against the JAX package's (``audian_tpu.gui.qt``) on the
fake Qt/pyqtgraph of :mod:`fakeqt`: both windows are driven through the
same action scripts, and after every step the arrays each adapter handed
to the toolkit are compared.

Tolerances (those of ``tests/test_torch_browser.py``): trace and envelope
curves with equal times and values within amplitude / 32767 (the channel
window's largest magnitude over int16); u8 spectrogram images within one
level, their rects within rtol 1e-12; the power side plot's dB as the
power they stand for (rtol 1e-4, atol 1e-12); overview curves within
1e-6; the view state, cutoff handles and marker dots equal.  Every array
handed to ``setData`` / ``setImage`` must be host data: a torch tensor
there fails the test."""

import importlib
import shutil

import numpy as np
import pytest
import torch

import fakeqt
from audian_tpu import app as japp
from audian_tpu.analysis import Plugins as JPlugins
from audian_tpu.data import wavio as jwav
from audian_tpu.graph import EnvelopeNode as JEnvelopeNode

from audian_torch import app as tapp
from audian_torch.analysis import Plugins as TPlugins
from audian_torch.app.screenshot import read_png_metadata
from audian_torch.graph import EnvelopeNode as TEnvelopeNode

RATE = 8000.0
#: the envelope of the interactive tests, at 1.5 kHz so the plain CPU
#: convolutions of the port stay short
ENV_CUTOFF = 1500.0
TOL_PSD_RTOL = 1e-4
TOL_PSD_ATOL = 1e-12
TOL_OVERVIEW = 1e-6


def _handed(kind):
    """A recorder for the fake items: keep what the adapter handed over
    and refuse tensors."""
    def host_only(values):
        if isinstance(values, torch.Tensor) or (
                isinstance(values, (list, tuple))
                and any(isinstance(v, torch.Tensor) for v in values)):
            raise AssertionError(f"a tensor reached {kind}")

    if kind == "setImage":
        orig = fakeqt.FakeImageItem.setImage

        def setImage(self, image, levels=None):
            host_only(image)
            self.handed = image
            orig(self, image, levels=levels)
        return setImage
    orig = getattr(fakeqt, kind).setData

    def setData(self, x, y=None):
        host_only(x)
        host_only(y)
        self.handed = (x, y)
        orig(self, x, y)
    return setData


@pytest.fixture(scope="module")
def qtmods():
    """Both frontends reloaded against the fake toolkit; ``sys.modules``
    and both modules are left as they were found."""
    import audian_tpu.gui.qt as jq
    import audian_torch.gui.qt as tq

    mp = pytest.MonkeyPatch()
    fakeqt.install()
    try:
        mp.setattr(fakeqt.FakeCurve, "setData", _handed("FakeCurve"))
        mp.setattr(fakeqt.ScatterPlotItem, "setData",
                   _handed("ScatterPlotItem"))
        mp.setattr(fakeqt.FakeImageItem, "setImage", _handed("setImage"))
        jq, tq = importlib.reload(jq), importlib.reload(tq)
        assert jq.HAVE_QT and tq.HAVE_QT
        yield jq, tq
    finally:
        mp.undo()
        fakeqt.uninstall()
        importlib.reload(jq)
        importlib.reload(tq)


@pytest.fixture(scope="module")
def wav2(tmp_path_factory):
    """The JAX Qt tests' recording: 2 s, 2 channels at 8 kHz."""
    rng = np.random.default_rng(7)
    t = np.arange(int(2.0 * RATE)) / RATE
    x = np.stack([0.5 * np.sin(2 * np.pi * 800 * t),
                  0.3 * np.sin(2 * np.pi * 300 * t)], axis=1)
    x += 0.01 * rng.standard_normal(x.shape)
    p = tmp_path_factory.mktemp("tqt") / "two.wav"
    jwav.write_audio(p, x, RATE, encoding="PCM_16")
    return p


def shells(paths, load=True):
    """The port's and the JAX package's shell on ``paths``, each with the
    1.5 kHz envelope trace added by a plugin."""
    out = []
    for app, plugins, env in ((tapp, TPlugins, TEnvelopeNode),
                              (japp, JPlugins, JEnvelopeNode)):
        pl = plugins()
        pl.add_trace_factory(lambda b, env=env: b.add_trace(
            env("envelope", "filtered", envelope_cutoff=ENV_CUTOFF)))
        extra = {"device": "cpu"} if app is tapp else {}
        sh = app.Audian([str(p) for p in paths], plugins=pl, **extra)
        if load:
            sh.load_files()
        out.append(sh)
    return out


class Pair:
    """The port's window and the JAX package's, over their own shells."""

    def __init__(self, qtmods, paths, load=True):
        jq, tq = qtmods
        self.shells = shells(paths, load)
        self.wins = [mod.AudianWindow(sh)
                     for mod, sh in zip((tq, jq), self.shells)]
        for w in self.wins:
            w.resize(1200, 800)

    def close(self):
        for w, sh in zip(self.wins, self.shells):
            for i in range(w.tabs.count()):
                w.tabs.widget(i).teardown()
            w.close()
            sh.close()


def amplitude(jb, name, c):
    return float(np.abs(np.asarray(jb.data[name].buffer)[:, c]).max())


def check_db(got, want, label):
    np.testing.assert_allclose(10.0 ** (np.asarray(got, float) / 10),
                               10.0 ** (np.asarray(want, float) / 10),
                               rtol=TOL_PSD_RTOL, atol=TOL_PSD_ATOL,
                               err_msg=label)


def check_curve(got, want, atol, label):
    (gx, gy), (wx, wy) = got.handed, want.handed
    np.testing.assert_array_equal(np.asarray(gx, float),
                                  np.asarray(wx, float), err_msg=label)
    np.testing.assert_allclose(np.asarray(gy, float), np.asarray(wy, float),
                               atol=atol, err_msg=label)


def rect_of(img):
    r = img.rect
    return np.array([r.x, r.y, r.w, r.h], float)


def check_tab(tt, jt, label):
    """What the two tabs painted: curves, images, power plots, handles,
    markers, overview, the view ranges."""
    tb, jb = tt.browser, jt.browser
    assert (tb.toffset, tb.twindow, tb.show_channels) == (
        jb.toffset, jb.twindow, jb.show_channels), label
    assert set(tt.trace_plots) == set(jt.trace_plots), label
    for c, (jpt, jcurve) in jt.trace_plots.items():
        tpt, tcurve = tt.trace_plots[c]
        assert tpt.isVisible() == jpt.isVisible(), (label, c)
        if not jpt.isVisible():
            continue
        name = "filtered" if "filtered" in jb.data else "data"
        check_curve(tcurve, jcurve, amplitude(jb, name, c) / 32767,
                    f"{label} {name} {c}")
        env = "envelope" in jb.data and jb.data.is_visible("envelope")
        check_curve(tt.env_curves[c], jt.env_curves[c],
                    amplitude(jb, "envelope", c) / 32767 if env else 0.0,
                    f"{label} envelope {c}")
        for got, want in zip(tt.marker_dots[c].handed,
                             jt.marker_dots[c].handed):
            np.testing.assert_allclose(got, want, rtol=1e-12,
                                       err_msg=f"{label} markers {c}")
        assert tpt.xrange == pytest.approx(jpt.xrange), label
        assert tt.xlines[c].isVisible() == jt.xlines[c].isVisible(), label
        if jt.xlines[c].isVisible():
            assert tt.xlines[c].value() == pytest.approx(
                jt.xlines[c].value()), label
    assert set(tt.spec_images) == set(jt.spec_images), label
    for c, (jps, jimg) in jt.spec_images.items():
        tps, timg = tt.spec_images[c]
        assert tps.isVisible() == jps.isVisible(), (label, c)
        if not jps.isVisible():
            continue
        assert timg.isVisible() == jimg.isVisible(), (label, c)
        gi, wi = timg.handed, jimg.handed
        assert gi.dtype == wi.dtype == np.uint8 and gi.shape == wi.shape
        assert np.abs(gi.astype(int) - wi.astype(int)).max() <= 1, label
        np.testing.assert_allclose(rect_of(timg), rect_of(jimg), rtol=1e-12,
                                   err_msg=f"{label} rect {c}")
        assert timg.levels == jimg.levels, label
        assert tps.yrange == pytest.approx(jps.yrange), label
        for side in ("hp_lines", "lp_lines"):
            assert getattr(tt, side)[c].value() == pytest.approx(
                getattr(jt, side)[c].value(), rel=1e-12), (label, side)
        tpp, tpc = tt.power_plots[c]
        jpp, jpc = jt.power_plots[c]
        assert tpp.isVisible() == jpp.isVisible(), label
        if jpp.isVisible():
            (gdb, gf), (wdb, wf) = tpc.handed, jpc.handed
            np.testing.assert_allclose(gf, wf, rtol=1e-12, err_msg=label)
            check_db(gdb, wdb, f"{label} power {c}")
        assert (tt.colorbars[c].isVisible()
                == jt.colorbars[c].isVisible()), label
    for c, jcurve in jt.ov_curves.items():
        tcurve = tt.ov_curves[c]
        if not hasattr(jcurve, "handed"):
            assert not hasattr(tcurve, "handed"), label
            continue
        (gx, gy), (wx, wy) = tcurve.handed, jcurve.handed
        np.testing.assert_allclose(gx, wx, rtol=1e-12, err_msg=label)
        np.testing.assert_allclose(gy, wy, atol=TOL_OVERVIEW, err_msg=label)
    assert tt.region.getRegion() == pytest.approx(jt.region.getRegion())


def check_windows(pair, label):
    tw, jw = pair.wins
    assert tw.tabs.count() == jw.tabs.count(), label
    assert tw.tabs.currentIndex() == jw.tabs.currentIndex(), label
    assert (tw.statusBar().currentMessage()
            == jw.statusBar().currentMessage()), label
    for i in range(jw.tabs.count()):
        check_tab(tw.tabs.widget(i), jw.tabs.widget(i), f"{label} tab {i}")


def trigger(win, shortcut):
    """Fire the enabled action bound to ``shortcut`` (the fake's menus)."""
    for menu in win.menuBar().menus:
        for act in menu.actions:
            if act.isEnabled() and shortcut in win._keys(act):
                act.trigger()
                return
    raise AssertionError(f"no action with shortcut {shortcut!r}")


def keys(*shortcuts):
    return [(k, lambda w, k=k: trigger(w, k)) for k in shortcuts]


def drag(kind, x0, y0, x1, y1):
    """A left-button rect drag on the first shown channel's panel."""
    def step(w):
        tab = w.tab()
        c = tab.browser.show_channels[0]
        plots = tab.trace_plots if kind == "trace" else tab.spec_images
        vb = plots[c][0].vb
        vb.mouseDragEvent(fakeqt.FakeMouseEvent(
            1, fakeqt.FakePoint(x1, y1), fakeqt.FakePoint(x0, y0)))
    return (f"drag {kind}", step)


def click(x, y):
    def step(w):
        tab = w.tab()
        c = tab.browser.show_channels[0]
        vb = tab.trace_plots[c][0].vb
        vb.mouseClickEvent(fakeqt.FakeMouseEvent(1, fakeqt.FakePoint(x, y)))
    return ("click", step)


def handle(side, freq):
    def step(w):
        tab = w.tab()
        c = tab.browser.show_channels[0]
        getattr(tab, side)[c].drag_to(freq)
    return (f"drag {side}", step)


def browser(verb, *args):
    return (verb, lambda w: getattr(w.browser(), verb)(*args))


def expect(label, ok):
    """A step that checks the window's state after the steps before."""
    def step(w):
        assert ok(w), label
    return (label, step)


def cutoffs(w):
    f = w.browser().data["filtered"]
    return f.highpass_cutoff, f.lowpass_cutoff


#: the action scripts, each a list of (label, step on a window)
SCRIPTS = {
    "open": [],
    "page_zoom": [browser("set_times", 0.0, 0.5)]
    + keys("Right", "Right", "Left")
    + [expect("paged", lambda w: w.browser().toffset > 0.0)]
    + keys("+", "-", "Shift+T", "T", "End", "Home", "Down", "Up", "."),
    "overview_region": [("region", lambda w: w.tab().region.drag_to(
        (0.25, 0.75)))],
    "filter_scrub_and_handles": keys("Shift+H", "H", "Shift+L", "L")
    + [handle("hp_lines", 1234.0), handle("lp_lines", 1000.0),
       expect("handles swapped", lambda w: cutoffs(w) == (1000.0, 1234.0))],
    "resolution": keys("Shift+R", "R", "R", "Shift+O", "O", "Shift+C")
    + [expect("NFFT 128", lambda w: w.browser().data[
        w.browser().spectrogram].nfft == 128)],
    "region_select": keys("Z") + [browser("set_times", 0.0, 2.0),
                      drag("trace", 0.5, -0.4, 1.0, 0.4),
                      expect("zoomed", lambda w: (w.browser().toffset,
                                                  w.browser().twindow)
                             == pytest.approx((0.5, 0.5), abs=1e-4)),
                      drag("spec", 0.6, 500.0, 0.9, 1500.0)]
    + keys("Backspace", "Shift+Backspace", "Alt+Backspace", "P")
    + [drag("trace", 0.2, -0.4, 0.4, 0.4)] + keys("A")
    + [drag("trace", 0.3, -0.4, 0.6, 0.4)] + keys("S")
    + [drag("trace", 0.1, -0.4, 0.3, 0.4)],
    "crosshair_markers": [click(0.5, 0.1)] + keys("Ctrl+C")
    + [browser("set_crosshair", 0, 0.75, 0.1)] + keys("s", "Ctrl+C")
    + [expect("marker", lambda w: len(w.browser().marker_data) == 1)],
    "auto_scroll_play": [browser("set_times", 0.0, 0.5)] + keys("!", "!")
    + [("tick", lambda w: [w.tab().scroll_timer.fire() for _ in range(3)]),
       expect("scrolled", lambda w: w.browser().toffset > 0.0)]
    + keys("!", "!", "!", "!", "!", "!", "!", "!", "Space"),
    "panels_channels": keys("Ctrl+P", "Ctrl+B", "G", "1")
    + [expect("channel 1 hidden", lambda w: w.browser().show_channels
              == [0])]
    + keys("1", "Ctrl+1", "Shift+Down", "Ctrl+A", "Shift+D", "K", "F"),
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_windows_paint_what_jax_paints(qtmods, wav2, script):
    pair = Pair(qtmods, [wav2])
    try:
        check_windows(pair, f"{script} open")
        for label, step in SCRIPTS[script]:
            for w in pair.wins:
                step(w)
            check_windows(pair, f"{script} {label}")
    finally:
        pair.close()


def test_screenshot_and_drop_restore_as_jax(qtmods, wav2, tmp_path):
    """The screenshot action writes the same view chunks; dropping each
    PNG back restores the view in both windows."""
    pair = Pair(qtmods, [wav2])
    try:
        shots = []
        for k, w in enumerate(pair.wins):
            w.browser().set_times(0.375, 0.5)
            w.browser().set_channels([1])
            shot = tmp_path / f"shot{k}.png"
            fakeqt.QFileDialog.save_name = (str(shot), "PNG (*.png)")
            trigger(w, "Ctrl+Alt+S")
            shots.append(shot)
        assert shots[0].read_bytes() == shots[1].read_bytes()
        assert read_png_metadata(shots[0])["audian-toffset"] == "0.375000"
        for w, shot in zip(pair.wins, shots):
            assert (w.statusBar().currentMessage()
                    == f"saved screenshot to {shot}")
            w.set_status("")
        check_windows(pair, "screenshot")
        for w, shot in zip(pair.wins, shots):
            w.browser().set_channels([0, 1])
            w.browser().set_times(1.25, 0.25)
            ev = fakeqt.FakeDropEvent([shot])
            w.dropEvent(ev)
            assert ev.accepted
            assert w.browser().show_channels == [1]
            assert w.browser().toffset == pytest.approx(0.375)
        check_windows(pair, "restored")
    finally:
        pair.close()


def test_open_cycle_and_close_tabs_as_jax(qtmods, wav2, tmp_path):
    """Ctrl+O queues a recording the pump opens on the next tick; tabs
    cycle and close in both windows alike."""
    other = tmp_path / "more.wav"
    shutil.copy(wav2, other)
    fakeqt.QTimer.single_shots = []
    pair = Pair(qtmods, [wav2])
    try:
        fakeqt.QFileDialog.open_names = ([str(other)], "")
        for w in pair.wins:
            trigger(w, "Ctrl+O")
        fakeqt.QTimer.flush_single_shots()
        assert [w.tabs.count() for w in pair.wins] == [2, 2]
        check_windows(pair, "opened")
        for step in ("Ctrl+PgDown", "Right", "Ctrl+W", "Ctrl+PgUp"):
            for w in pair.wins:
                trigger(w, step)
            check_windows(pair, step)
        assert [w.tabs.count() for w in pair.wins] == [1, 1]
    finally:
        fakeqt.QFileDialog.open_names = ([], "")
        pair.close()


def test_two_linked_tabs_as_jax(qtmods, wav2, tmp_path):
    other = tmp_path / "linked.wav"
    shutil.copy(wav2, other)
    pair = Pair(qtmods, [wav2, other])
    try:
        for w in pair.wins:
            a, b = w.shell.browsers
            a.update_filter(highpass_cutoff=b.data[
                "filtered"].highpass_cutoff * 1.5 + 100.0)
            assert b.data["filtered"].highpass_cutoff == pytest.approx(
                a.data["filtered"].highpass_cutoff)
        check_windows(pair, "linked filter")
        for w in pair.wins:
            trigger(w, "Ctrl+PgDown")
            trigger(w, "Right")
        check_windows(pair, "second tab paged")
    finally:
        pair.close()


def test_progressive_startup_as_jax(qtmods, wav2, tmp_path):
    """Queued recordings open one per event-loop tick in both windows; a
    missing file raises one message each and is dropped."""
    bogus = tmp_path / "missing.wav"
    fakeqt.QTimer.single_shots = []
    n_warn = len(fakeqt.QMessageBox.warnings)
    pair = Pair(qtmods, [wav2, bogus, wav2], load=False)
    try:
        assert [w.tabs.count() for w in pair.wins] == [0, 0]
        counts = []
        while fakeqt.QTimer.flush_single_shots():
            counts.append([w.tabs.count() for w in pair.wins])
        assert counts == [[1, 1], [1, 1], [2, 2]]
        assert len(fakeqt.QMessageBox.warnings) == n_warn + 2
        assert not any(w.shell.pending for w in pair.wins)
        check_windows(pair, "progressive")
    finally:
        pair.close()


def test_audian_main_opens_the_qt_window(qtmods, wav2, tmp_path,
                                         monkeypatch):
    """``python -m audian_torch.cli.audian`` opens the first recording,
    builds the Qt window and returns the event loop's status; the view of
    a screenshot given as the input is restored."""
    from audian_torch.cli import audian
    from audian_torch.gui import qt as tq

    monkeypatch.chdir(tmp_path)      # no plugin files of the repo
    built = []

    class Recorded(tq.AudianWindow):
        def __init__(self, shell):
            super().__init__(shell)
            b = shell.current
            built.append((self.tabs.count(), b.device.type, b.toffset,
                          b.twindow, list(b.show_channels)))

    monkeypatch.setattr(tq, "AudianWindow", Recorded)
    assert audian.main([str(wav2), str(wav2)], device="cpu") == 0
    assert built == [(1, "cpu", 0.0, built[0][3], [0, 1])]
    shot = tmp_path / "view.png"
    shot.write_bytes(fakeqt._tiny_png())
    sh = tapp.Audian([str(wav2)], device="cpu")
    sh.load_files()
    b = sh.browsers[0]
    b.set_channels([1])
    b.set_times(0.5, 0.25)
    tapp.write_view_metadata(shot, b)
    sh.close()
    assert audian.main([str(shot)], device="cpu") == 0
    assert built[1][2:] == (0.5, 0.25, [1])
