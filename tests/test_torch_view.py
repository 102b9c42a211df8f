"""The port's view model (``audian_torch.view``: zoom, axes, panels,
plotranges, headless) against the JAX package's (``audian_tpu.view``).

The first four modules are pure Python copies: each scenario below runs
the same calls through both packages and the records must be equal,
exactly.  The headless axes read the trace windows through the render
layer, so they are compared on two browsers opened on the same WAV:
amplitudes within one int16 code of the window's scale (the tile
tolerance of ``test_torch_render.py``), dB powers as the power they stand
for within the PSD tolerance of ``test_torch_data.py`` (1e-4 relative,
1e-12 absolute); the axis letters, ranges and limits exactly."""

import datetime as dt

import numpy as np
import pytest

from audian_tpu import app as japp
from audian_tpu import view as jview
from audian_tpu.analysis import Plugins as JPlugins
from audian_tpu.data import wavio as jwav
from audian_tpu.graph import EnvelopeNode as JEnvelopeNode
from audian_tpu.view import headless as jheadless
from audian_tpu.view import plotranges as jplotranges

from audian_torch import app as tapp
from audian_torch import view as tview
from audian_torch.analysis import Plugins as TPlugins
from audian_torch.graph import EnvelopeNode as TEnvelopeNode
from audian_torch.view import headless as theadless
from audian_torch.view import plotranges as tplotranges

TOL_PSD_RTOL = 1e-4
TOL_PSD_ATOL = 1e-12


# the conftest's fixtures at module scope: a session-scoped generator
# hands this file whatever numbers the files before it on the same
# worker left, so the data would depend on the test schedule
@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="module")
def cricket_like(rng):
    """Synthetic 4.8 kHz carrier chirps with an AM envelope plus noise,
    2 channels at 44.1 kHz (the body of the conftest's fixture)."""
    rate = 44100.0
    t = np.arange(int(2.0 * rate)) / rate
    carrier = np.sin(2 * np.pi * 4800.0 * t)
    am = (np.sin(2 * np.pi * 25.0 * t) > 0).astype(float)
    chirps = carrier * am
    x = np.stack([
        0.6 * chirps + 0.01 * rng.standard_normal(len(t)),
        0.3 * np.roll(chirps, 17) + 0.01 * rng.standard_normal(len(t)),
    ], axis=1)
    return x.astype(np.float64), rate


def check_db(got, want):
    np.testing.assert_allclose(10.0 ** (np.asarray(got, float) / 10),
                               10.0 ** (np.asarray(want, float) / 10),
                               rtol=TOL_PSD_RTOL, atol=TOL_PSD_ATOL)


class FakeLine:
    """Crosshair line that records its calls."""

    def __init__(self):
        self.calls = []

    def setPos(self, pos):
        self.calls.append(("pos", pos))

    def setVisible(self, visible):
        self.calls.append(("visible", visible))


class FakeAx:
    """Duck-typed plot that records every range and crosshair call (as in
    ``tests/test_view.py``)."""

    def __init__(self, channel=0, axspec="tx", rmax=100.0):
        self.channel = channel
        self.axspec = axspec
        self._range = (0.0, rmax, 10.0)
        self.calls = []
        self.limits = {}
        self.visible = True
        self.data_items = []
        self.xline, self.yline = FakeLine(), FakeLine()

    def x(self):
        return self.axspec[0]

    def y(self):
        return self.axspec[1]

    def z(self):
        return self.axspec[2] if len(self.axspec) > 2 else ""

    def range(self, letter):
        if letter in "xyu":
            return (-1.0, 1.0, 0.1)
        if letter in "pq":
            return (-200.0, 20.0, 5.0)
        return self._range

    def setLimits(self, **kw):
        self.limits.update(kw)

    def setXRange(self, r0, r1):
        self.calls.append(("x", r0, r1))

    def setYRange(self, r0, r1):
        self.calls.append(("y", r0, r1))

    def setZRange(self, r0, r1):
        self.calls.append(("z", r0, r1))

    def amplitudes(self, t0, t1):
        return (-0.5 + 0.01 * t0, 0.5 - 0.02 * t1)

    def isVisible(self):
        return self.visible

    def setVisible(self, v):
        self.visible = v

    def getViewBox(self):
        return self

    def add_item(self, item, is_data=False):
        if is_data:
            self.data_items.append(item)

    def update_plot(self):
        self.calls.append(("update",))

    def showGrid(self, **kw):
        self.calls.append(("grid", tuple(sorted(kw.items()))))

    def set_stored_marker(self, x, y):
        self.calls.append(("stored", x, y))


def ranges_record(pr, axs):
    rec = {k: (list(r.r0), list(r.r1), r.rmin, r.rmax, r.rstep, r.min_dr)
           for k, r in sorted(pr.items())}
    return rec, [(ax.calls, dict(ax.limits)) for ax in axs]


def scenario_plotranges(view):
    """Every broadcast verb on every letter, on three channels of
    ``tx``/``fp`` plots, recorded after each step."""
    pr = view.PlotRanges()
    pr.setup(3)
    axs = []
    for c in range(3):
        for spec in ("tx", "ty", "fp"):
            ax = FakeAx(c, spec, 100.0 + 10 * c)
            pr.add_plot(ax)
            axs.append(ax)
    pr.set_limits()
    out = [ranges_record(pr, axs)]
    verbs = (jplotranges.VERBS if view is jview else tplotranges.VERBS)
    rng = np.random.default_rng(5)
    for verb in verbs * 2:
        for letters in ("t", "x", "y", "f", "p", "txy"):
            chans = sorted(set(rng.integers(0, 3, 2).tolist()))
            if verb == "auto":
                pr.auto(letters, 1.0, 3.0, chans)
            else:
                getattr(pr, verb)(letters, chans)
            out.append(ranges_record(pr, axs))
    pr["t"].set_ranges(20.0, 30.0, channels=[1])
    pr["x"].set_ranges(-0.3, 0.2, None, [0, 2])
    pr["t"].goto(55.0)
    pr["t"].move(0.25)
    out.append(ranges_record(pr, axs))
    out.append([(k, r.at_home(0), r.at_end(1)) for k, r in sorted(
        pr.items())])
    return out


def scenario_markers(view):
    pr = view.PlotRanges()
    pr.setup(2)
    axs = [FakeAx(c, spec) for c in range(2) for spec in ("tx", "fp")]
    for ax in axs:
        pr.add_plot(ax)
    pr.set_limits()
    out = []
    for letter, pos in (("t", 5.0), ("x", 0.25), ("f", 40.0), ("p", -30.0)):
        pr[letter].set_marker(1, axs[2], pos)
    pr.update_crosshair()
    queries = ("marker_time", "marker_amplitude", "marker_frequency",
               "marker_power", "marker_delta_time",
               "marker_delta_amplitude", "marker_delta_frequency",
               "marker_delta_power")
    out.append([getattr(pr, q)() for q in queries])
    pr.store_marker()
    pr["t"].set_marker(1, axs[2], 7.5)
    pr["x"].set_marker(1, axs[2], -0.5)
    out.append([getattr(pr, q)() for q in queries])
    pr.update_crosshair()
    out.append([(ax.xline.calls, ax.yline.calls, ax.calls) for ax in axs])
    pr.clear_marker()
    pr.update_crosshair()
    out.append([(ax.xline.calls, ax.yline.calls) for ax in axs])
    out.append([getattr(pr, q)() for q in queries])
    return out


def scenario_panels(view):
    class Trace:
        def __init__(self, name, panel, panel_type):
            self.name, self.panel, self.panel_type = name, panel, panel_type

    class Data:
        traces = [Trace("data", "trace", "trace"),
                  Trace("filtered", "trace", "trace"),
                  Trace("envelope", "env", "trace"),
                  Trace("spectrogram", "spectrogram", "spectrogram")]

    panels = view.Panels()
    panels.add_trace("trace")
    panels.add_spectrogram("spectrogram")
    panels.fill(Data())
    out = [[(name, p.ax_spec, p.row, p.is_trace(), p.is_spectrogram(),
             p.is_power(), p.is_spacer()) for name, p in panels.items()]]
    for c in range(2):
        for name, p in list(panels.items()):
            if not p.is_spacer():
                p.add_ax(p.row, FakeAx(c, p.ax_spec))
    panels.show_grid(2)
    for name, p in panels.items():
        out.append((name, [ax.calls for ax in p.axs] if hasattr(p, "axs")
                    else None, p.x(), p.y(), p.z()))
    out.append(sorted(view.panels.axis_kind(s) for s in "txyufwpq")
               if hasattr(view, "panels") else None)
    return out


def scenario_axes(view):
    out = []
    for lo, hi, width, font in ((0.0, 10.0, 1000, 50), (0.0, 10.0, 100, 50),
                                (5.0, 5.0, 100, 10), (-3.2, 7100.5, 640, 8),
                                (1e-4, 2e-3, 300, 12)):
        out.append(view.tick_spacing(lo, hi, width, font))
    st = dt.datetime(2026, 1, 1, 10, 30, 0)
    for ticks, spacing in (([0.0, 30.0], 30.0), ([0.0, 90.0], 30.0),
                           ([4000.0], 1000.0), ([1.25], 0.25),
                           ([-12.5, 0.0, 12.5], 12.5), ([3601.001], 0.001)):
        out.append(view.format_time_ticks(ticks, spacing))
        out.append(view.format_time_ticks(ticks, spacing, mode=view.ABS_TIME,
                                          starttime=st, add_date=True))
        out.append(view.format_time_ticks(
            ticks, spacing, mode=view.FILE_TIME, file_times=[0.0, 100.0],
            file_paths=["a.wav", "b.wav"]))
    for tmax, spacing in ((10.0, 1.0), (10.0, 1e-5), (4000.0, 1.0),
                          (30.0, 1.0)):
        out.append(view.time_label_width(tmax, spacing))
    return out


def scenario_zoom(view):
    z = view.ZoomHistory()
    z.init(view.Rect(0, 0, 100, 1))
    out = []
    for r in ((10, 0, 20, 1), (12, 0, 14, 1)):
        z.add(view.Rect(*r))
    out.append(z.back())
    z.add(view.Rect(11, 0, 13, 1))
    out += [z.forward(), z.current(), z.home(), z.forward(), z.back(),
            z.back()]
    got = []
    sel = view.SelectionModel(1, on_selected=lambda c, v, r: got.append(
        (c, r)))
    sel.begin(5.0, 1.0)
    sel.drag(8.0, -1.0)
    out.append(sel.finish(8.0, -1.0))
    sel.begin(1, 1)
    sel.cancel()
    out += [sel.finish(2, 2), got]
    r = view.Rect(3, 4, 1, 2)
    out += [r.left(), r.right(), r.bottom(), r.top(), r.normalized()]
    return out


def _plain(x):
    """Records made comparable across the two packages: dataclass and
    rect instances become tuples of their fields."""
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        return (type(x).__name__,) + tuple(
            _plain(getattr(x, f)) for f in x.__dataclass_fields__)
    return x


@pytest.mark.parametrize("scenario", [scenario_plotranges, scenario_markers,
                                      scenario_panels, scenario_axes,
                                      scenario_zoom])
def test_view_model_equals_jax(scenario):
    assert _plain(scenario(tview)) == _plain(scenario(jview))


def test_verb_names_and_axis_tables_equal_jax():
    assert tplotranges.VERBS == jplotranges.VERBS
    from audian_tpu.view import panels as jp
    from audian_torch.view import panels as tp

    for name in ("TIME_AXES", "AMPLITUDE_AXES", "FREQUENCY_AXES",
                 "POWER_AXES"):
        assert getattr(tp, name) == getattr(jp, name)


# -- headless axes over two browsers ------------------------------------------

RATE = 44100.0


@pytest.fixture(scope="module")
def browsers(tmp_path_factory, cricket_like):
    x, rate = cricket_like
    p = tmp_path_factory.mktemp("tview") / "song.wav"
    jwav.write_audio(p, x, rate, encoding="PCM_16")
    out = []
    for app, plugins, env in ((tapp, TPlugins, TEnvelopeNode),
                              (japp, JPlugins, JEnvelopeNode)):
        pl = plugins()
        pl.add_trace_factory(lambda b, env=env: b.add_trace(
            env("envelope", "filtered", envelope_cutoff=1500.0)))
        kw = {"device": "cpu"} if app is tapp else {}
        b = app.DataBrowser(p, plugins=pl, buffer_time=1.0, back_time=0.25,
                            **kw).open()
        b.update_filter(2000.0, 10000.0)
        b.set_times(0.4, 0.5)
        out.append(b)
    yield out
    for b in out:
        b.close()


def axes_of(b):
    return [(name, c, ax) for name, p in b.panels.items()
            for c, ax in enumerate(getattr(p, "axs", []))]


def test_build_view_model_equals_jax(browsers):
    tb, jb = browsers
    assert list(tb.panels) == list(jb.panels)
    assert sorted(tb.plot_ranges) == sorted(jb.plot_ranges)
    tax, jax_ = axes_of(tb), axes_of(jb)
    assert [(n, c, a.axspec) for n, c, a in tax] == \
        [(n, c, a.axspec) for n, c, a in jax_]
    for (_, _, ta), (_, _, ja) in zip(tax, jax_):
        for letter in ta.axspec:
            assert ta.range(letter) == ja.range(letter)
        assert ta.limits == ja.limits
        assert (ta.xrange, ta.yrange, ta.zrange) == \
            (ja.xrange, ja.yrange, ja.zrange)
        assert [type(i).__name__ for i in ta.data_items] == \
            [type(i).__name__ for i in ja.data_items]
    for letter in tb.plot_ranges:
        tr, jr = tb.plot_ranges[letter], jb.plot_ranges[letter]
        assert (tr.r0, tr.r1, tr.rmin, tr.rmax) == \
            (jr.r0, jr.r1, jr.rmin, jr.rmax), letter


def test_headless_readouts_match_jax(browsers):
    """Amplitude extrema and picks, and the hover power, through the
    headless data items of both browsers."""
    tb, jb = browsers
    for (name, c, ta), (_, _, ja) in zip(axes_of(tb), axes_of(jb)):
        for ti, ji in zip(ta.data_items, ja.data_items):
            if isinstance(ti, theadless.TraceDataItem):
                assert isinstance(ji, jheadless.TraceDataItem)
                got = np.array(ti.amplitudes(0.4, 0.9))
                want = np.array(jb.data[ji.name].buffer)
                scale = np.abs(want).max() / 32767
                np.testing.assert_allclose(got, ji.amplitudes(0.4, 0.9),
                                           atol=max(scale, 1e-6))
                for t, y, t1 in ((0.45, 0.1, None), (0.6, -0.2, 0.61)):
                    gt, ga = ti.get_amplitude(t, y, t1)
                    wt, wa = ji.get_amplitude(t, y, t1)
                    assert gt == wt
                    np.testing.assert_allclose(ga, wa, atol=1e-5)
            elif isinstance(ti, theadless.SpecDataItem):
                assert ti.amplitudes(0, 1) == ji.amplitudes(0, 1)
                for t, f in ((0.5, 4800.0), (0.7, 12000.0), (5.0, 100.0)):
                    got, want = ti.get_power(t, f), ji.get_power(t, f)
                    if want is None:
                        assert got is None
                    else:
                        check_db(got, want)
                check_db(ti.data.estimate_noiselevels(c),
                         ji.data.estimate_noiselevels(c))
            else:
                assert ti.amplitudes(0, 1) == ji.amplitudes(0, 1) == \
                    (None, None)
        assert ta.amplitudes(0.4, 0.9) is not None


def test_headless_axes_take_range_verbs_as_jax(browsers):
    tb, jb = browsers
    for b in browsers:
        b.apply_ranges("zoom_in", "xf")
        b.apply_ranges("down", "x")
        b.set_crosshair(1, t=0.45, amplitude=0.1, frequency=5000.0)
        b.store_marker("start")
        b.set_crosshair(1, t=0.48, amplitude=-0.1, frequency=6000.0)
        b.panels.show_grid(1)
    for (_, _, ta), (_, _, ja) in zip(axes_of(tb), axes_of(jb)):
        assert (ta.xrange, ta.yrange, ta.zrange, ta.grids) == \
            (ja.xrange, ja.yrange, ja.zrange, ja.grids)
        assert (ta.xline.pos, ta.xline.visible, ta.yline.pos,
                ta.yline.visible) == (ja.xline.pos, ja.xline.visible,
                                      ja.yline.pos, ja.yline.visible)
        assert (ta.stored_marker.x, ta.stored_marker.y,
                ta.stored_marker.visible) == (
            ja.stored_marker.x, ja.stored_marker.y, ja.stored_marker.visible)
    assert tb.crosshair_readout() == jb.crosshair_readout()
    for b in browsers:
        b.clear_crosshair()
        b.apply_ranges("reset", "xf")
