"""audian_torch's trace spans (``utils/trace.py``) against the JAX
package's: the same ``Data`` session (open, a filter update, pages and
jumps, each followed by min/max and dB tiles) and the same ``detect`` call
(with a small chunk, so that interior chunks take the decimating path and
the edge chunks the exact one), with tracing on in both packages, emit the
same event kinds, counts and fields (times aside).  With tracing off
nothing is recorded."""

import json
from collections import Counter

import numpy as np
import pytest

from audian_tpu import graph as jgraph
from audian_tpu.analysis import events as jev
from audian_tpu.data import Data as JData
from audian_tpu.data import wavio as jwav
from audian_tpu.utils import trace as jtrace
from audian_tpu.view.render import SpecTiler as JSpecTiler
from audian_tpu.view.render import TraceTiler as JTraceTiler

from audian_torch import graph as tgraph
from audian_torch.analysis import events as tev
from audian_torch.data import Data
from audian_torch.utils import trace as ttrace
from audian_torch.view.render import SpecTiler, TraceTiler

RATE = 48000.0
MOVES = (0.0, 0.5, 1.0, 4.0, 3.5)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    x = 0.3 * np.random.default_rng(1).standard_normal((int(8 * RATE), 2))
    p = tmp_path_factory.mktemp("ttrace") / "rec.wav"
    jwav.write_audio(p, x, RATE, encoding="PCM_16")
    return p


@pytest.fixture
def tracing():
    """Both packages' logs cleared, tracing off again afterwards."""
    for tr in (jtrace, ttrace):
        tr.clear()
    yield
    for tr in (jtrace, ttrace):
        tr.disable()
        tr.clear()


def session(path, D, pkg, tiler_kw):
    d = D(path, buffer_time=2.0, back_time=0.5,
          **({} if D is JData else {"device": "cpu"}))
    for node in (pkg.FilterNode("filtered", "data"),
                 pkg.EnvelopeNode("envelope", "filtered",
                                  envelope_cutoff=1500.0),
                 pkg.SpectrogramNode("spectrogram", "filtered")):
        d.add_trace(node)
    d.open()
    d["filtered"].update(highpass_cutoff=2000.0, lowpass_cutoff=10000.0)
    tt, st = tiler_kw
    for t0 in MOVES:
        d.update_times(t0, t0 + 1.0)
        for c in range(2):
            tt.tile(d["filtered"], t0, t0 + 1.0, c)
            st.tile(d["spectrogram"], c, -100.0, 0.0, quantize=True,
                    t0=t0, t1=t0 + 1.0)
    d.close()


def normalized(evs):
    """Each event's kind and fields, its time and duration aside."""
    return Counter((e["kind"], json.dumps(
        {k: v for k, v in e.items() if k not in ("t", "ms")},
        sort_keys=True, default=int)) for e in evs)


def test_data_session_traces_as_jax(wav, tracing):
    for tr in (jtrace, ttrace):
        tr.enable(log=False)
    session(wav, JData, jgraph, (JTraceTiler(), JSpecTiler()))
    session(wav, Data, tgraph, (TraceTiler(device="cpu"),
                                SpecTiler(device="cpu")))
    want, got = jtrace.events(), ttrace.events()
    assert {e["kind"] for e in got} == {
        "graph.build", "graph.run", "loader.read", "loader.read_raw16",
        "render.pull"}
    assert normalized(got) == normalized(want)
    summary = ttrace.summary()
    assert summary["graph.run"]["count"] == sum(
        e["kind"] == "graph.run" for e in got)
    assert summary["graph.run"]["ms"] >= 0.0


def test_detect_traces_as_jax(tracing, monkeypatch):
    for mod in (jev, tev):
        monkeypatch.setattr(mod, "_CHUNK", 1 << 15)
        monkeypatch.setattr(mod, "_KERNEL_BUDGET", {"filt": 0, "env": 0})
    rng = np.random.default_rng(2)
    x = np.clip(np.round(0.2 * rng.standard_normal((200000, 2)) * 32768),
                -32768, 32767).astype(np.int16)
    for tr in (jtrace, ttrace):
        tr.enable(log=False)
    jev.detect(x, 24000.0, return_filtered=False)
    tev.detect(x, 24000.0, return_filtered=False, device="cpu")
    want, got = jtrace.events(), ttrace.events()
    kinds = Counter(e["kind"] for e in got)
    assert set(kinds) == {"detect.upload", "detect.chunk"}
    assert kinds["detect.upload"] == kinds["detect.chunk"] > 2
    assert all(e["ms"] >= 0.0 for e in got)
    assert normalized(got) == normalized(want)


def test_disabled_tracing_records_nothing(wav, tracing):
    session(wav, Data, tgraph, (TraceTiler(device="cpu"),
                                SpecTiler(device="cpu")))
    ttrace.trace_event("render.pull", op="x", bytes=1)
    with ttrace.timed("graph.run"):
        pass
    assert ttrace.events() == [] and ttrace.summary() == {}


def test_device_profile_writes_a_chrome_trace(tmp_path):
    import torch

    out = tmp_path / "trace.json"
    with ttrace.device_profile(out):
        torch.ones(64).sum()
    assert "traceEvents" in json.loads(out.read_text())
