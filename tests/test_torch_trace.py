"""audian_torch's trace spans (``utils/trace.py``) against the JAX
package's: the same ``Data`` session (open, a filter update, pages and
jumps, each followed by min/max and dB tiles) and the same ``detect`` call
(with a small chunk, so that interior chunks take the decimating path and
the edge chunks the exact one), with tracing on in both packages, emit the
JAX package's event kinds, counts and fields (times aside), and the port's
own kinds (``data.update``, ``graph.params``, ``graph.node``,
``envdet.call``) in the counts and nesting the session implies.  Then the
module itself: ids, parents and the one clock, across threads; nothing
entered or made while tracing is off; the ``audian.*`` ranges in a CPU
profiler's trace; the aggregates past the ring; device times resolved off
the hot path (on stand-in CUDA events); ``idle_by_span`` on a synthetic
trace."""

import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch

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
from audian_torch.ops.design import (FilterDesign, design_envelope_filter,
                                     design_filter)
from audian_torch.utils import trace as ttrace
from audian_torch.view.render import SpecTiler, TraceTiler

from fir_lengths import at_port_lengths

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
    nodes = (pkg.FilterNode("filtered", "data"),
             pkg.EnvelopeNode("envelope", "filtered", envelope_cutoff=1500.0),
             pkg.SpectrogramNode("spectrogram", "filtered"))
    # the JAX FIR nodes at the port's lengths: the same windows and runs
    for node in at_port_lengths(*nodes) if pkg is jgraph else nodes:
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


def as_jax(want, got):
    """``(want, got)`` as counts of each event's kind and fields, the port's
    restricted to the JAX package's kinds and to the fields the JAX
    package gives that kind, times and durations aside."""
    fields = {}
    for e in want:
        fields.setdefault(e["kind"], set()).update(e)
    for f in fields.values():
        f -= {"t", "ms"}

    def norm(evs):
        return Counter((e["kind"], json.dumps(
            {k: v for k, v in e.items() if k in fields[e["kind"]]},
            sort_keys=True, default=int)) for e in evs
            if e["kind"] in fields)

    return norm(want), norm(got)


def by_id(evs):
    return {e["id"]: e for e in evs if "id" in e}


def test_data_session_traces_as_jax(wav, tracing):
    for tr in (jtrace, ttrace):
        tr.enable(log=False)
    session(wav, JData, jgraph, (JTraceTiler(), JSpecTiler()))
    session(wav, Data, tgraph, (TraceTiler(device="cpu"),
                                SpecTiler(device="cpu")))
    want, got = jtrace.events(), ttrace.events()
    assert {e["kind"] for e in want} == {
        "graph.build", "graph.run", "loader.read", "loader.read_raw16",
        "render.pull"}
    a, b = as_jax(want, got)
    assert b == a
    # the port's own kinds: the one filter update (before the first
    # window, so it computes nothing), each node's design copied once
    # (the update came first), and one node span per node of every run
    runs = [e for e in got if e["kind"] == "graph.run"]
    jkinds = {e["kind"] for e in want}
    assert Counter(e["kind"] for e in got if e["kind"] not in jkinds) == {
        "data.update": 1, "graph.params": 3,
        "graph.node": sum(e["nodes"] for e in runs)}
    ids = by_id(got)
    assert all(ids[e["parent"]]["kind"] == "graph.run"
               for e in got if e["kind"] == "graph.node")
    assert {e["node"] for e in got if e["kind"] == "graph.params"} == {
        "filtered", "envelope", "spectrogram"}
    summary = ttrace.summary()
    assert summary["graph.run"]["count"] == len(runs)
    assert summary["graph.run"]["ms"] == pytest.approx(
        sum(e["ms"] for e in runs))
    assert summary["render.pull"]["bytes"] == sum(
        e["bytes"] for e in got if e["kind"] == "render.pull") > 0
    assert all(v["dropped"] == 0 for v in summary.values())


def test_cutoff_step_nests_under_data_update(wav, tracing):
    """A cutoff step in a shown window: ``data.update`` is the root, the
    filter's new design is copied under it, and the run under it holds
    one span per node, each FIR node's with the taps it ran: its design's
    own decay length."""
    d = Data(wav, buffer_time=2.0, back_time=0.5, device="cpu")
    for node in (tgraph.FilterNode("filtered", "data"),
                 tgraph.EnvelopeNode("envelope", "filtered",
                                     envelope_cutoff=1500.0),
                 tgraph.SpectrogramNode("spectrogram", "filtered")):
        d.add_trace(node)
    d.open()
    d.update_times(1.0, 2.0)
    ttrace.enable(log=False)
    d["filtered"].update(lowpass_cutoff=9000.0)
    d.close()
    got = ttrace.events()
    ids = by_id(got)
    (root,) = [e for e in got if e["kind"] == "data.update"]
    assert root["parent"] is None and root["trace"] == "filtered"
    (params,) = [e for e in got if e["kind"] == "graph.params"]
    (run,) = [e for e in got if e["kind"] == "graph.run"]
    nodes = [e for e in got if e["kind"] == "graph.node"]
    assert params["node"] == "filtered" and params["bytes"] > 0
    assert params["parent"] == run["parent"] == root["id"]
    assert len(nodes) == run["nodes"] == 3
    assert {ids[e["parent"]]["id"] for e in nodes} == {run["id"]}
    assert {e["node"]: e["taps"] for e in nodes} == {
        "filtered": FilterDesign.from_sos(
            design_filter(RATE, 0.0, 9000.0, 2)).fir.length,
        "envelope": FilterDesign.from_sos(
            design_envelope_filter(RATE, 1500.0)).fir.length,
        "spectrogram": None}
    for inner, outer in [(params, root), (run, root)] + [
            (e, run) for e in nodes]:
        assert outer["t0_ns"] <= inner["t0_ns"] <= inner["t1_ns"] \
            <= outer["t1_ns"]


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
    assert set(kinds) == {"detect.upload", "detect.chunk", "envdet.call"}
    assert kinds["detect.upload"] == kinds["detect.chunk"] > 2
    assert all(e["ms"] >= 0.0 for e in got)
    a, b = as_jax(want, got)
    assert b == a
    # the interior chunks' envelopes, each inside its chunk's span; the
    # two edge chunks take the exact path
    ids = by_id(got)
    calls = [e for e in got if e["kind"] == "envdet.call"]
    assert len(calls) == kinds["detect.chunk"] - 2
    assert all(ids[e["parent"]]["kind"] == "detect.chunk" for e in calls)


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


# -- the module ----------------------------------------------------------------

def test_spans_carry_ids_parents_and_one_clock(tracing):
    """Nested spans on two threads at once: each record has its id, the id
    of the span around it on its own thread, ``t0_ns <= t1_ns`` and
    ``ms``; point events get the span they sit in."""
    ttrace.enable(log=False)
    gate = threading.Barrier(2, timeout=10)

    def work(name):
        with ttrace.timed("outer", who=name):
            gate.wait()
            for _ in range(50):
                with ttrace.timed("inner", who=name):
                    ttrace.trace_event("point", who=name)
            gate.wait()

    threads = [threading.Thread(target=work, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    got = ttrace.events()
    ids = by_id(got)
    assert len(ids) == 102 and len(got) == 202
    for e in got:
        if e["kind"] == "outer":
            assert e["parent"] is None
        else:
            outer = ids[e["parent"]]
            assert outer["who"] == e["who"]
            assert outer["kind"] == ("outer" if e["kind"] == "inner"
                                     else "inner")
        if "id" in e:
            assert e["t0_ns"] <= e["t1_ns"]
            assert e["ms"] == pytest.approx((e["t1_ns"] - e["t0_ns"]) * 1e-6)
    outers = {e["who"]: e for e in got if e["kind"] == "outer"}
    for e in got:
        if e["kind"] == "inner":
            o = outers[e["who"]]
            assert o["t0_ns"] <= e["t0_ns"] <= e["t1_ns"] <= o["t1_ns"]


def test_off_enters_nothing_and_makes_no_event(tracing, monkeypatch):
    """With tracing off a span is one shared object: no profiler range is
    entered, no CUDA event made, nothing recorded."""

    def refuse(*args, **kwargs):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    spans = [ttrace.timed("chain.call", device=torch.device("cuda", 0),
                          frames=1) for _ in range(3)]
    assert spans[0] is spans[1] is spans[2]
    with spans[0] as span:
        span["bytes"] = 1
    ttrace.trace_event("graph.build", frames=1)
    assert ttrace.events() == [] and ttrace.summary() == {}


def test_profiler_turns_tracing_on_and_nests_its_ops(tracing, tmp_path):
    """Under a CPU ``torch.profiler`` the spans are recorded with no
    ``enable()``, and their ``audian.*`` ranges enclose, in the exported
    trace, the aten ops launched inside them."""
    out = tmp_path / "trace.json"
    with ttrace.device_profile(out):
        with ttrace.timed("graph.run"):
            with ttrace.timed("graph.node", node="filtered"):
                torch.ones(256).cumsum(0)
    (run,) = ttrace.events("graph.run")
    (node,) = ttrace.events("graph.node")
    assert node["parent"] == run["id"] and node["node"] == "filtered"
    evs = json.loads(out.read_text())["traceEvents"]
    ranges = {e["name"]: e for e in evs if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e["name"].startswith("audian.")}
    assert set(ranges) == {"audian.graph.run", "audian.graph.node"}
    (op,) = [e for e in evs if e.get("name") == "aten::cumsum"]

    def encloses(outer, inner):
        return (outer["tid"] == inner["tid"]
                and outer["ts"] <= inner["ts"]
                and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])

    assert encloses(ranges["audian.graph.node"], op)
    assert encloses(ranges["audian.graph.run"], ranges["audian.graph.node"])
    # after the profiler, tracing is off again
    with ttrace.timed("graph.run"):
        pass
    assert len(ttrace.events("graph.run")) == 1


def test_aggregates_exact_past_the_ring(tracing):
    ttrace.enable(log=False)
    n = ttrace.RING + 100
    for _ in range(n):
        ttrace.trace_event("render.pull", op="x", bytes=3)
    with ttrace.timed("graph.run"):
        pass
    got = ttrace.events()
    assert len(got) == ttrace.RING and got[-1]["kind"] == "graph.run"
    s = ttrace.summary()
    assert s["render.pull"] == {"count": n, "dropped": 101, "bytes": 3 * n}
    assert s["graph.run"]["count"] == 1 and s["graph.run"]["dropped"] == 0
    ttrace.clear()
    assert ttrace.events() == [] and ttrace.summary() == {}


class StandInEvent:
    """A CUDA timing event for the CPU, on one stream: recording stamps a
    counter that advances by one a record; the device has passed every
    event stamped up to ``passed``."""

    made, elapsed, clock, passed = [], [], [0.0], [-1.0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t, self.waits = None, 0
        StandInEvent.made.append(self)

    def record(self, stream=None):
        self.t = StandInEvent.clock[0]
        StandInEvent.clock[0] += 1.0

    def query(self):
        return self.t <= StandInEvent.passed[0]

    def synchronize(self):
        self.waits += 1
        StandInEvent.passed[0] = max(StandInEvent.passed[0], self.t)

    def elapsed_time(self, end):
        assert self.query() and end.query()
        StandInEvent.elapsed.append(self)
        return end.t - self.t


def test_device_time_resolved_off_the_hot_path(tracing, monkeypatch):
    """Device-timed spans record an event pair and never wait inside a
    span; passed pairs are resolved by ``query`` once enough are pending,
    where the outermost span closes, and their events reused; reading the
    log waits only on the rest."""
    StandInEvent.made.clear()
    StandInEvent.elapsed.clear()
    StandInEvent.clock[0], StandInEvent.passed[0] = 0.0, -1.0
    monkeypatch.setattr(torch.cuda, "Event", StandInEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index: index)

    def refuse(*args, **kwargs):
        raise AssertionError("synchronize inside a span")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    ttrace.enable(log=False)
    dev = torch.device("cuda", 0)
    for _ in range(40):
        with ttrace.timed("chain.call", device=dev, frames=8):
            pass
    assert len(StandInEvent.made) == 80
    assert all(ev.waits == 0 for ev in StandInEvent.made)
    StandInEvent.passed[0] = StandInEvent.made[19].t  # 10 spans passed
    for _ in range(2):
        with ttrace.timed("chain.call", device=dev, frames=8):
            pass
    # the first of the two found the 10 passed pairs and resolved them;
    # the second reused their events
    assert len(StandInEvent.made) == 82
    assert all(ev.waits == 0 for ev in StandInEvent.made)
    s = ttrace.summary()
    assert s["chain.call"]["count"] == 42
    assert s["chain.call"]["device_ms"] == pytest.approx(42.0)
    # reading the log waited on the 32 pairs still pending, no others
    assert sum(ev.waits for ev in StandInEvent.made) == 32
    got = ttrace.events("chain.call")
    assert [e["device_ms"] for e in got] == [1.0] * 42
    assert all(e["frames"] == 8 and e["ms"] >= 0.0 for e in got)
    # spans inside another leave the resolving to the outermost one
    StandInEvent.elapsed.clear()
    with ttrace.timed("data.update"):
        for _ in range(40):
            with ttrace.timed("graph.node", device=dev, node="x"):
                pass
        # the device passes these and the next span's pair
        StandInEvent.passed[0] = StandInEvent.clock[0] + 1.0
        with ttrace.timed("graph.node", device=dev, node="x"):
            pass
        assert StandInEvent.elapsed == []
    assert len(StandInEvent.elapsed) == 41


def test_a_cpu_device_is_timed_on_the_host_only(tracing, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", None)
    ttrace.enable(log=False)
    with ttrace.timed("graph.node", device=torch.device("cpu"), node="x"):
        pass
    (e,) = ttrace.events()
    assert "device_ms" not in e and e["ms"] >= 0.0
    assert "device_ms" not in ttrace.summary()["graph.node"]


def X(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": 1}


#: device work at 10-20, 30-40 and 70-90 us of a 0-100 us window; the host
#: in data.update over 0-60 and in render.pull over 15-35
SYNTHETIC = [
    X("portbench.window", 0.0, 100.0),
    X("audian.data.update", 0.0, 60.0),
    X("audian.render.pull", 15.0, 20.0),
    X("cudaMemcpyAsync", 16.0, 18.0, "cuda_runtime"),
    X("kernel_a", 10.0, 10.0, "kernel"),
    X("Memcpy DtoH", 30.0, 10.0, "gpu_memcpy"),
    X("kernel_b", 70.0, 20.0, "kernel"),
    # the device's copy of a range covers work, not what the host did
    X("audian.render.pull", 88.0, 5.0, "gpu_user_annotation"),
    {"ph": "M", "name": "process_name", "args": {"name": "x"}},
]


def test_idle_by_span_on_a_synthetic_trace(tmp_path):
    want = {"audian.data.update": 40e-6, "audian.render.pull": 10e-6,
            ttrace.OUTSIDE: 10e-6}
    got = ttrace.idle_by_span(SYNTHETIC, within="portbench.window")
    assert list(got) == list(want)
    assert got == pytest.approx(want)
    # the whole trace from a file: a host op 50 us before the window
    # moves the first gap's start to -50 us, outside any span
    path = tmp_path / "t.json"
    path.write_text(json.dumps(
        {"traceEvents": SYNTHETIC + [X("aten::empty", -50.0, 1.0,
                                       "cpu_op")]}))
    got = ttrace.idle_by_span(path)
    assert got == pytest.approx({"audian.data.update": 30e-6,
                                 "audian.render.pull": 10e-6,
                                 ttrace.OUTSIDE: 70e-6})
    with pytest.raises(ValueError):
        ttrace.idle_by_span(SYNTHETIC, within="portbench.missing")
