"""The port's song viewer (``audian_torch.gui.songplot``, recomputing on
``device="cpu"``) against the JAX package's under Agg, and the song
detector's ``-p`` / ``--plot-png`` against the JAX CLI's.

Both viewers take the same keys on the same detection result; after each
key the song onsets and offsets (indices and times) are equal, the
envelopes within 1e-5 of their scale and the filtered streams within
1e-5 (the tolerances of ``tests/test_torch_events.py``), and so are the
thresholds fitted to the envelopes, the amplitude axes fitted to the
filtered streams and the lines each viewer drew.  The recordings are run
whole (under one chunk window: host scipy float64 in both packages) and
in small chunks, where the port's envelope keys take the decimating path
(the envdet kernel's plain version here) and the JAX viewer's the exact
one."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

from audian_tpu.analysis import events as jev
from audian_tpu.cli import songdetector as jcli
from audian_tpu.data import wavio as jwav
from audian_tpu.gui.songplot import SongPlot as JSongPlot

from audian_torch.analysis import events as tev
from audian_torch.cli import songdetector as tcli
from audian_torch.gui.songplot import SongPlot as TSongPlot
from audian_torch.ops.cuda import envdet as tenvdet

RATE = 24000.0
TOL_FILTERED = 1e-5
TOL_ENVELOPE = 1e-5      # times the envelope's scale


def _recording(nsongs=3, seed=12):
    """Chirpy songs (6.5 kHz carrier, 30 Hz AM) over noise on 2 channels,
    as the JAX package's song-detector tests make them."""
    rng = np.random.default_rng(seed)
    n = int((2.0 + 3.3 * nsongs) * RATE)
    t = np.arange(n) / RATE
    x = 0.02 * rng.standard_normal(n)
    for k in range(nsongs):
        sel = (t >= 2.0 + 3.3 * k) & (t < 3.2 + 3.3 * k)
        x[sel] += 0.6 * 0.5 * (1 + np.sin(2 * np.pi * 30.0 * t[sel])) \
            * np.sin(2 * np.pi * 6500.0 * t[sel])
    return np.stack([x, 0.5 * x], axis=1)


def chunk_mode(monkeypatch, mode):
    """Both packages with fresh kernel-length budgets, their recordings run
    whole or, for ``"chunked"``, in small chunk windows."""
    for mod in (jev, tev):
        monkeypatch.setattr(mod, "_KERNEL_BUDGET", {"filt": 0, "env": 0})
        if mode == "chunked":
            monkeypatch.setattr(mod, "_CHUNK", 1 << 15)


class Key:
    def __init__(self, key):
        self.key = key


def viewers(x, **kw):
    """The port's and the JAX package's viewer on the detection result
    each package computes for ``x`` (at the CLI's default design)."""
    want = jev.detect(x, RATE, return_filtered=True)
    got = tev.detect(x, RATE, return_filtered=True, device="cpu")
    tw = TSongPlot(x, RATE, got, filename="song.wav", device="cpu", **kw)
    jw = JSongPlot(x, RATE, want, filename="song.wav", **kw)
    for w in (tw, jw):
        # the lines' data is what is compared: skip Agg's rendering
        w.fig.canvas.draw_idle = lambda *a, **k: None
    return tw, jw


def close(*wins):
    for w in wins:
        w.plt.close(w.fig)


def check_viewers(tw, jw, label):
    got, want = tw.result, jw.result
    assert got["envrate"] == want["envrate"], label
    for key in ("onset_indices", "offset_indices", "onsets", "offsets"):
        assert len(got[key]) == len(want[key]), (label, key)
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {key}")
    scale = float(np.abs(want["envelope"]).max())
    np.testing.assert_allclose(got["thresholds"], want["thresholds"],
                               rtol=0, atol=TOL_ENVELOPE * scale)
    for key in ("envelope", "slow_envelope"):
        assert isinstance(got[key], np.ndarray), (label, key)
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=TOL_ENVELOPE * scale,
                                   err_msg=f"{label} {key}")
    assert isinstance(got["filtered"], np.ndarray), label
    np.testing.assert_allclose(got["filtered"], want["filtered"], rtol=0,
                               atol=TOL_FILTERED, err_msg=label)
    for attr in ("toffset", "twindow", "highpassfreq", "lowpassfreq",
                 "envelopecutofffreq", "show_traces", "show_filtered",
                 "show_envelope", "show_slowenvelope", "show_help"):
        assert getattr(tw, attr) == getattr(jw, attr), (label, attr)
    # 'v' fits the amplitude axes to the filtered streams
    np.testing.assert_allclose(tw.ymin, jw.ymin, rtol=0, atol=TOL_FILTERED)
    np.testing.assert_allclose(tw.ymax, jw.ymax, rtol=0, atol=TOL_FILTERED)
    for tax, jax_ in zip(tw.axs, jw.axs):
        assert len(tax.lines) == len(jax_.lines), label
        for gl, wl in zip(tax.lines, jax_.lines):
            np.testing.assert_array_equal(gl.get_xdata(), wl.get_xdata(),
                                          err_msg=label)
            np.testing.assert_allclose(
                np.asarray(gl.get_ydata(), float),
                np.asarray(wl.get_ydata(), float), rtol=0,
                atol=max(TOL_ENVELOPE * scale, TOL_FILTERED), err_msg=label)
        assert tax.get_xlim() == jax_.get_xlim(), label


KEYS = {
    "highpass": ["h", "H", "H"],
    "lowpass": ["l", "L"],
    "envelope": ["e", "E", "E"],
    "view": ["+", "pagedown", "ctrl+pagedown", "down", "up", "end", "home",
             "-", "y", "Y", "v", "V", "ctrl+t", "ctrl+f", "ctrl+e", "?"],
}

#: every key set on the whole recording; in chunks, where the port's
#: envelope keys take the decimating path, one filter key set and the
#: envelope keys (the view keys recompute nothing, and the lowpass keys
#: take the highpass keys' path)
CASES = [("whole", k) for k in KEYS] + [("chunked", "highpass"),
                                        ("chunked", "envelope")]


@pytest.mark.parametrize("chunks,keys", CASES,
                         ids=[f"{c}-{k}" for c, k in CASES])
def test_viewer_keys_as_jax(monkeypatch, chunks, keys):
    chunk_mode(monkeypatch, chunks)
    tw, jw = viewers(_recording())
    try:
        check_viewers(tw, jw, "open")
        launches = tenvdet.envdet.launches
        for k in KEYS[keys]:
            tw.keypress(Key(k))
            jw.keypress(Key(k))
            check_viewers(tw, jw, f"{chunks} {k}")
        # on the CPU the kernel's plain version runs: no launch is counted
        assert tenvdet.envdet.launches == launches
    finally:
        close(tw, jw)


def test_envelope_key_takes_the_decimating_path(monkeypatch):
    """An envelope key needs no filtered stream: the port's viewer asks
    ``band_env`` for the decimating path (``fused=True``), a filter key
    for the exact one."""
    monkeypatch.setattr(tev, "_CHUNK", 1 << 15)
    x = _recording(nsongs=1)
    result = tev.detect(x, RATE, return_filtered=False, device="cpu")
    calls = []
    orig = tev.band_env

    def spy(*args, **kw):
        calls.append((kw["return_filtered"], kw.get("fused", False),
                      kw["device"].type))
        return orig(*args, **kw)

    monkeypatch.setattr(tev, "band_env", spy)
    w = TSongPlot(x, RATE, result, device="cpu")
    try:
        w.keypress(Key("e"))
        w.keypress(Key("h"))
    finally:
        close(w)
    assert calls == [(True, False, "cpu"), (False, True, "cpu"),
                     (True, False, "cpu")]


def test_int16_input_is_dequantized_as_jax():
    q = np.clip(np.round(_recording(nsongs=1) * 32768.0), -32768,
                32767).astype(np.int16)
    tw, jw = viewers(q)
    try:
        assert tw.data.dtype == jw.data.dtype == np.float32
        np.testing.assert_array_equal(tw.data, jw.data)
        check_viewers(tw, jw, "int16")
    finally:
        close(tw, jw)


def test_viewer_needs_the_card_by_default():
    x = _recording(nsongs=1)
    result = tev.detect(x, RATE, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSongPlot(x, RATE, result)


def test_plot_png_writes_the_jax_table(tmp_path, capsys):
    path = tmp_path / "songs16.wav"
    jwav.write_audio(path, _recording(), RATE, encoding="PCM_16")
    outs = {}
    for name, main, extra in (("torch", tcli.main, {"device": "cpu"}),
                              ("jax", jcli.main, {})):
        csv, png = tmp_path / f"{name}.csv", tmp_path / f"{name}.png"
        assert main(["--plot-png", str(png), "-o", str(csv), str(path)],
                    **extra) == 0
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        outs[name] = (csv.read_text(), capsys.readouterr().out)
    assert outs["torch"][0] == outs["jax"][0]
    assert len(outs["torch"][0].strip().splitlines()) == 1 + 2 * 3
    assert outs["torch"][1].replace("torch.", "jax.") == outs["jax"][1]
    assert "saved viewer figure to" in outs["torch"][1]


def test_plot_opens_the_viewer(tmp_path, monkeypatch):
    """``-p`` builds the viewer and shows it (a no-op under Agg)."""
    import matplotlib.pyplot as plt

    shown = []
    monkeypatch.setattr(plt, "show", lambda *a, **k: shown.append(
        len(plt.get_fignums())))
    path = tmp_path / "rec.wav"
    jwav.write_audio(path, _recording(nsongs=1), RATE, encoding="PCM_16")
    csv = tmp_path / "rec.csv"
    try:
        assert tcli.main(["-p", "-o", str(csv), str(path)],
                         device="cpu") == 0
    finally:
        plt.close("all")
    assert shown and shown[0] >= 1
    assert len(csv.read_text().strip().splitlines()) == 1 + 2
