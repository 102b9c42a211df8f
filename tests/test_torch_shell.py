"""The port's multi-recording shell (``audian_torch.app.shell``,
``device="cpu"``) against the JAX package's: ``audian_cli`` parses the
same command lines into the same shell (``-c``, ``-f``, ``-l``, ``-i``,
``-u``/``-U``, ``--preset``), the link fan-out of times, filter, envelope,
channels, panels, ranges and audio across two browsers leaves the same
state in both packages, late-loaded browsers sync to it, and a file that
fails to open lands in ``shell.errors``.  The state is compared exactly:
it is host state, set by the same verbs."""

import numpy as np
import pytest

from audian_tpu.analysis import Plugins as JPlugins
from audian_tpu.app import shell as jshell
from audian_tpu.cli.compress import parse_load_kwargs as jparse_load_kwargs
from audian_tpu.data import wavio as jwav
from audian_tpu.graph import EnvelopeNode as JEnvelopeNode

from audian_torch.analysis import Plugins as TPlugins
from audian_torch.app import shell as tshell
from audian_torch.graph import EnvelopeNode as TEnvelopeNode

ENV_CUTOFF = 1500.0


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


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory, cricket_like):
    x, rate = cricket_like
    d = tmp_path_factory.mktemp("tshell")
    paths = []
    for k in range(2):
        p = d / f"rec{k}.wav"
        jwav.write_audio(p, (0.7 ** k) * x, rate, encoding="PCM_16")
        paths.append(str(p))
    return paths


def plugins(pkg_plugins, env):
    pl = pkg_plugins()
    pl.add_trace_factory(lambda b: b.add_trace(
        env("envelope", "filtered", envelope_cutoff=ENV_CUTOFF)))
    return pl


def shells(paths, **kw):
    """Both packages' ``Audian`` on ``paths``, loaded."""
    t = tshell.Audian(paths, plugins=plugins(TPlugins, TEnvelopeNode),
                      device="cpu", **kw)
    j = jshell.Audian(paths, plugins=plugins(JPlugins, JEnvelopeNode), **kw)
    t.load_files()
    j.load_files()
    return t, j


def browser_state(b):
    f = b.data["filtered"] if "filtered" in b.data else None
    e = b.data["envelope"] if "envelope" in b.data else None
    s = b.data[b.spectrogram] if b.spectrogram else None
    return dict(
        times=(b.toffset, b.twindow),
        channels=(b.show_channels, b.selected_channels, b.current_channel),
        panels=(b.show_traces, b.show_specs, b.show_powers, b.show_cbars,
                b.show_fulldata, b.color_map),
        filter=None if f is None else (f.highpass_cutoff, f.lowpass_cutoff),
        envelope=None if e is None else e.envelope_cutoff,
        nfft=None if s is None else (s.nfft, s.overlap_frac),
        visible=[b.data.is_visible(n) for n in b.data.keys()],
        audio=(b.audio_rate_fac, b.audio_use_heterodyne,
               b.audio_heterodyne_freq),
        ranges={k: [b.get_range(k, c) for c in range(b.data.channels)]
                for k, r in sorted(b.plot_ranges.items()) if r.is_used()},
        starttime=[ax.starttime_mode
                   for ax in b.plot_ranges["t"].plots("x", 0)])


def shell_state(sh):
    return dict(
        n=len(sh), current=sh.browsers.index(sh.current) if sh.browsers
        else None, errors=[(str(p), type(e).__name__) for p, e in sh.errors],
        links=(sh.link_timezoom, sh.link_timescroll, dict(sh.link_ranges),
               sh.link_filter, sh.link_envelope, sh.link_channels,
               sh.link_panels, sh.link_audio),
        browsers=[browser_state(b) for b in sh.browsers])


CLI_ARGS = [
    [],
    ["-c", "1"],
    ["-c", "0-1", "-f", "2000", "-l", "8000", "-u", "1.5"],
    ["-U", "-f", "3000", "-i", "verbose=0", "--style", "fusion"],
    ["-u", "-v"],
    ["--preset", "browser-envelope", "-l", "12000"],
    ["--preset", "bioacoustics", "-f", "500"],
]


@pytest.mark.parametrize("args", CLI_ARGS, ids=lambda a: " ".join(a) or
                         "plain")
def test_audian_cli_parses_as_jax(wav_files, args):
    t = tshell.audian_cli(args + wav_files[:1], device="cpu")
    j = jshell.audian_cli(args + wav_files[:1])
    for attr in ("channels", "highpass_cutoff", "lowpass_cutoff",
                 "load_kwargs", "unwrap", "unwrap_clip", "verbose",
                 "pending", "gui_args"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert len(t.plugins.trace_factories) == len(j.plugins.trace_factories)
    assert t.device.type == "cpu"
    if "--preset" in args:
        t.load_files()
        j.load_files()
        try:
            assert t.current.data.keys() == j.current.data.keys()
            assert shell_state(t) == shell_state(j)
        finally:
            t.close()
            j.close()


def test_cli_helpers_equal_jax():
    for spec in ("0, 2-4, 7", "", "3", "1-1,5"):
        assert tshell.parse_channels(spec) == jshell.parse_channels(spec)
    pairs = ["rate=100,channels=2", "unit=V", "amax=0.5", ""]
    assert tshell.parse_load_kwargs(pairs) == jparse_load_kwargs(pairs)
    with pytest.raises(KeyError, match="unknown preset"):
        tshell.audian_cli(["--preset", "nope"], device="cpu")


def test_links_fan_out_as_jax(wav_files):
    t, j = shells(wav_files)
    try:
        steps = [
            ("browser", 0, "set_times", (0.2, 0.5)),
            ("shell", "link_timescroll", True),
            ("browser", 0, "set_times", (0.4, 0.25)),
            ("browser", 1, "time_page_down", ()),
            ("browser", 0, "update_filter", (3000.0, 9000.0)),
            ("browser", 1, "step_filter", (2.0,)),
            ("browser", 0, "update_envelope", (750.0,)),
            ("browser", 0, "set_channels", ([1],)),
            ("browser", 0, "all_channels", ()),
            ("call", "select_channels", ("next_channel",)),
            ("call", "show_channel", (0,)),
            ("call", "toggle_channel", (1, True)),
            ("call", "hide_deselected_channels", ()),
            ("browser", 1, "set_audio", (2.0, True, 5000.0)),
            ("browser", 0, "toggle_spectrograms", ()),
            ("browser", 1, "toggle_powers", ()),
            ("browser", 0, "color_map_cycler", ()),
            ("browser", 0, "toggle_trace", (False, "envelope")),
            ("call", "apply_ranges", ("zoom_in", "xf")),
            ("call", "apply_time_ranges", ("zoom_out",)),
            ("call", "toggle_starttime", ()),
            ("call", "toggle_link_amplitude", ()),
            ("call", "apply_ranges", ("down", "x")),
            ("call", "toggle_show_envelope", ()),
            ("call", "next_tab", ()),
            ("call", "apply_time", ("time_page_up",)),
            ("shell", "link_filter", False),
            ("browser", 1, "update_filter", (1000.0, None)),
            ("call", "toggle_link_panels", ()),
            ("browser", 0, "toggle_colorbars", ()),
            ("call", "previous_tab", ()),
        ]
        for step in steps:
            for sh in (t, j):
                if step[0] == "shell":
                    setattr(sh, step[1], step[2])
                elif step[0] == "call":
                    getattr(sh, step[1])(*step[2])
                else:
                    getattr(sh.browsers[step[1]], step[2])(*step[3])
            assert shell_state(t) == shell_state(j), step
    finally:
        t.close()
        j.close()


def test_late_load_and_failures_as_jax(wav_files, tmp_path):
    bad = str(tmp_path / "missing.wav")
    notwav = tmp_path / "junk.wav"
    notwav.write_bytes(b"RIFF" + bytes(40))
    t, j = shells([wav_files[0], bad])
    try:
        for sh in (t, j):
            a = sh.current
            a.set_times(0.4, 0.3)
            a.set_channels([0])
            a.set_panels(specs=0)
            failed = []
            sh.sigBrowserFailed.connect(lambda p, e: failed.append(p))
            sh.load_files([wav_files[1], str(notwav)])
            assert failed == [str(notwav)]
        assert [str(p) for p, _ in t.errors] == [bad, str(notwav)]
        assert shell_state(t) == shell_state(j)
        assert t.browsers[1].twindow == 0.3
        assert t.browsers[1].show_channels == [0]
    finally:
        t.close()
        j.close()


def test_presets_build_the_jax_nodes(wav_files):
    """``ChainPreset.nodes()`` gives the JAX package's trace nodes and
    ``apply()`` installs the same filter on an open browser's data."""
    from audian_tpu import models as jmodels
    from audian_torch import models as tmodels

    def spec(node):
        return (type(node).__name__, node.name, node.source_name,
                getattr(node, "envelope_cutoff", None),
                getattr(node, "nfft", None),
                getattr(node, "overlap_frac", None))

    assert list(tmodels.PRESETS) == list(jmodels.PRESETS)
    for name in tmodels.PRESETS:
        assert [spec(n) for n in tmodels.get_preset(name).nodes()] == \
            [spec(n) for n in jmodels.get_preset(name).nodes()]
    t, j = shells(wav_files[:1])
    try:
        tmodels.get_preset("bioacoustics").apply(t.current.data)
        jmodels.get_preset("bioacoustics").apply(j.current.data)
        assert shell_state(t) == shell_state(j)
        assert t.current.data["filtered"].highpass_cutoff == 2000.0
    finally:
        t.close()
        j.close()
