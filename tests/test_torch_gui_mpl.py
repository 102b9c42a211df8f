"""The port's matplotlib frontend (``audian_torch.gui.mpl``, browser on
``device="cpu"``) against the JAX package's (``audian_tpu.gui.mpl``)
under Agg: both windows take the same key and mouse events, and after
each the data of their trace, envelope and spectrogram artists, power
side plots and overview span are compared.

Tolerances (those of ``tests/test_torch_browser.py``): trace lines with
equal times and values within amplitude / 32767; u8 spectrogram images
within one level, their extents within rtol 1e-12; the power side plot's
dB as the power they stand for (rtol 1e-4, atol 1e-12)."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch

from audian_tpu.app import DataBrowser as JBrowser
from audian_tpu.analysis import Plugins as JPlugins
from audian_tpu.data import wavio as jwav
from audian_tpu.graph import EnvelopeNode as JEnvelopeNode
from audian_tpu.gui.mpl import MplBrowserWindow as JWindow

from audian_torch.app import DataBrowser as TBrowser
from audian_torch.analysis import Plugins as TPlugins
from audian_torch.graph import EnvelopeNode as TEnvelopeNode
from audian_torch.gui.mpl import MplBrowserWindow as TWindow

RATE = 8000.0
ENV_CUTOFF = 1500.0
TOL_PSD_RTOL = 1e-4
TOL_PSD_ATOL = 1e-12


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    rng = np.random.default_rng(11)
    t = np.arange(int(2.0 * RATE)) / RATE
    x = np.stack([0.5 * np.sin(2 * np.pi * 800 * t),
                  0.3 * np.sin(2 * np.pi * 300 * t)], axis=1)
    x += 0.01 * rng.standard_normal(x.shape)
    p = tmp_path_factory.mktemp("tmpl") / "rec.wav"
    jwav.write_audio(p, x, RATE, encoding="PCM_16")
    return p


@pytest.fixture(scope="module")
def pair(wav):
    """The port's window and the JAX package's, each over a browser with
    the 1.5 kHz envelope; the tests of the module share them."""
    out = []
    for cls, win, plugins, env, extra in (
            (TBrowser, TWindow, TPlugins, TEnvelopeNode, {"device": "cpu"}),
            (JBrowser, JWindow, JPlugins, JEnvelopeNode, {})):
        pl = plugins()
        pl.add_trace_factory(lambda b, env=env: b.add_trace(
            env("envelope", "filtered", envelope_cutoff=ENV_CUTOFF)))
        b = cls(wav, plugins=pl, **extra).open()
        w = win(b)
        # the artists' data is what is compared: skip Agg's rendering
        w.fig.canvas.draw_idle = lambda *a, **k: None
        out.append(w)
    yield out
    for w in out:
        w.close()
        w.browser.close()


@pytest.fixture()
def wins(pair):
    """The shared windows at a 1 s view from the start, every channel
    shown; the rest of what earlier tests did to both stays."""
    for w in pair:
        w.browser.set_channels([0, 1])
        w.browser.set_times(0.0, 1.0)
    return pair


class Ev:
    def __init__(self, ax=None, x=None, y=None, key=None):
        self.inaxes = ax
        self.xdata = x
        self.ydata = y
        self.key = key
        self.button = 1


def amplitude(jb, name, c):
    return float(np.abs(np.asarray(jb.data[name].buffer)[:, c]).max())


def check_db(got, want, label):
    np.testing.assert_allclose(10.0 ** (np.asarray(got, float) / 10),
                               10.0 ** (np.asarray(want, float) / 10),
                               rtol=TOL_PSD_RTOL, atol=TOL_PSD_ATOL,
                               err_msg=label)


def host(a, label):
    assert not isinstance(a, torch.Tensor), f"{label}: a tensor was drawn"
    return np.asarray(a, float)


def check_line(got, want, atol, label):
    np.testing.assert_array_equal(host(got.get_xdata(), label),
                                  host(want.get_xdata(), label),
                                  err_msg=label)
    np.testing.assert_allclose(host(got.get_ydata(), label),
                               host(want.get_ydata(), label), atol=atol,
                               err_msg=label)


def check_windows(tw, jw, label):
    tb, jb = tw.browser, jw.browser
    assert (tb.toffset, tb.twindow, tb.show_channels) == (
        jb.toffset, jb.twindow, jb.show_channels), label
    assert tw.crosshair == pytest.approx(jw.crosshair) if jw.crosshair \
        else tw.crosshair is None, label
    assert set(tw._artists) == set(jw._artists), label
    for key, jart in jw._artists.items():
        tart = tw._artists[key]
        if key == "overview":
            assert (tart["span"].get_xy() == pytest.approx(
                jart["span"].get_xy())), label
            continue
        kind, c = key
        lab = f"{label} {kind} {c}"
        if kind == "trace":
            name = "filtered" if "filtered" in jb.data else "data"
            check_line(tart["trace"], jart["trace"],
                       amplitude(jb, name, c) / 32767, lab)
            assert tart["env"].get_visible() == jart["env"].get_visible()
            if jart["env"].get_visible():
                check_line(tart["env"], jart["env"],
                           amplitude(jb, "envelope", c) / 32767, lab)
            assert (len(tart["marks"].get_segments())
                    == len(jart["marks"].get_segments())), lab
        elif kind == "spec":
            assert tart["im"].get_visible() == jart["im"].get_visible()
            gi = np.asarray(tart["im"].get_array())
            wi = np.asarray(jart["im"].get_array())
            assert gi.shape == wi.shape, lab
            assert np.abs(gi.astype(int) - wi.astype(int)).max() <= 1, lab
            np.testing.assert_allclose(tart["im"].get_extent(),
                                       jart["im"].get_extent(), rtol=1e-12,
                                       err_msg=lab)
            assert tart["im"].get_cmap().name == jart["im"].get_cmap().name
        elif kind == "power":
            gl, wl = tart["line"], jart["line"]
            np.testing.assert_allclose(host(gl.get_ydata(), lab),
                                       host(wl.get_ydata(), lab),
                                       rtol=1e-12, err_msg=lab)
            check_db(gl.get_xdata(), wl.get_xdata(), lab)
        for line in ("cx", "cy", "audio"):
            if line in jart:
                assert (tart[line].get_visible()
                        == jart[line].get_visible()), (lab, line)
    for axs in ("trace_axs", "spec_axs", "power_axs", "cbar_axs"):
        for c, ax in getattr(jw, axs).items():
            tax = getattr(tw, axs)[c]
            assert tax.get_visible() == ax.get_visible(), (label, axs, c)
            if ax.get_visible() and axs != "cbar_axs":
                assert tax.get_xlim() == pytest.approx(ax.get_xlim()), label
    assert tw.region_mode == jw.region_mode, label


def key(k):
    return (k, lambda w: w.on_key(Ev(key=k)))


def drag(kind, x0, y0, x1, y1):
    def step(w):
        ax = (w.trace_axs if kind == "trace" else w.spec_axs)[0]
        w.on_press(Ev(ax, x0, y0))
        w.on_release(Ev(ax, x1, y1))
    return (f"drag {kind}", step)


SCRIPTS = {
    "time": [key(k) for k in ("right", "right", "left", ",", ".", "x",
                              "X", "end", "home")],
    "filter_envelope": [key(k) for k in ("f", "F", "F", "l", "L", "e",
                                         "E", "E")],
    "resolution": [key(k) for k in ("R", "r", "r", "C")],
    "channels": [key(k) for k in ("down", "up", "pagedown", "pageup",
                                  "1", "1", "0")],
    "panels": [key(k) for k in ("c", "z", "z", "g", "g", "v", "V", "t")],
    "zoom_history": [key("o"), drag("trace", 0.2, -0.5, 0.6, 0.5),
                     drag("spec", 0.3, 500.0, 0.5, 1500.0), key("b"),
                     key("B"), key("b")],
    "crosshair_marker": [drag("trace", 0.3, 0.1, 0.3, 0.1), key("m"),
                         drag("spec", 0.4, 1000.0, 0.4, 1000.0)],
    "overview": [("overview", lambda w: w.on_press(Ev(w.overview_ax, 1.2,
                                                      0.0)))],
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_window_draws_what_jax_draws(wins, script):
    tw, jw = wins
    check_windows(tw, jw, f"{script} open")
    for label, step in SCRIPTS[script]:
        for w in wins:
            step(w)
        check_windows(tw, jw, f"{script} {label}")


def test_savefig_writes_the_view_as_jax(wins, tmp_path):
    from audian_torch.app.screenshot import read_png_metadata

    metas = []
    for k, w in enumerate(wins):
        w.browser.set_times(0.25, 0.5)
        p = w.savefig(tmp_path / f"view{k}.png")
        metas.append({k: v for k, v in read_png_metadata(p).items()
                      if k.startswith("audian-")})
    assert metas[0] == metas[1]
    assert metas[0]["audian-twindow"] == "0.500000"
