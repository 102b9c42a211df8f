"""The readers of the metrics that read the program's own trace log
(``audian_torch.utils.trace``): each on a synthetic log, and on an empty
one; then a traced tiny run of each cell on the CPU, which reports the
host-side ones above 0 (the device-timed ones need a card)."""

from types import SimpleNamespace

import pytest

from portbench import core
from test_portbench_run import BENCH, ROOT, SEED, TINY

STEPS = 4

NODES = [{"kind": "graph.node", "node": n, "device_ms": ms}
         for n, ms in [("filtered", 1.0), ("envelope", 8.0),
                       ("spectrogram", 0.5)] * STEPS]
NODES.append({"kind": "graph.node", "node": "filtered"})  # unresolved

SUMMARY = {
    "graph.params": {"count": STEPS, "dropped": 0, "ms": 0.4},
    "render.pull": {"count": 3 * STEPS, "dropped": 0, "ms": 20.0,
                    "bytes": 80000},
    "chain.call": {"count": 10, "dropped": 0, "ms": 0.25,
                   "device_ms": 31.5},
    "envdet.call": {"count": 8, "dropped": 0, "ms": 0.2},
}

#: each reader's value on the synthetic log, over STEPS scrub steps
WANT = {
    "node_ms.filtered": 1.0,
    "node_ms.envelope": 8.0,
    "node_ms.spectrogram": 0.5,
    "params_ms.graph": 0.1,
    "pull_ms.tiles": 5.0,
    "pull_kb.tiles": 20.0,
    "call_us.chain": 25.0,
    "call_device_ms.chain": 3.15,
    "call_us.envdet": 25.0,
}
HOST_SIDE = ("params_ms.graph", "pull_ms.tiles", "pull_kb.tiles",
             "call_us.chain", "call_us.envdet")


def fake_log(monkeypatch, evs, summary):
    from audian_torch.utils import trace

    monkeypatch.setattr(trace, "events", lambda kind=None: [
        e for e in evs if kind is None or e["kind"] == kind])
    monkeypatch.setattr(trace, "summary", lambda: summary)


def test_every_reader_is_listed():
    listed = {m["name"]: m for m in BENCH["per_layer"]}
    assert set(WANT) <= set(listed)
    assert all(listed[n]["source"] in ("program_span", "program_counter")
               for n in WANT)


@pytest.mark.parametrize("metric", list(WANT))
def test_reader_on_a_synthetic_log(metric, monkeypatch):
    fake_log(monkeypatch, NODES, SUMMARY)
    r = SimpleNamespace(calls={"graph": [None] * STEPS})
    value = core.load_module("metrics", metric).read(r, None)
    assert value == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", list(WANT))
def test_reader_on_an_empty_log(metric, monkeypatch):
    fake_log(monkeypatch, [], {})
    r = SimpleNamespace(calls={"graph": [None] * STEPS})
    assert core.load_module("metrics", metric).read(r, None) is None


@pytest.mark.parametrize("cell", list(TINY))
def test_traced_tiny_run_reports_the_host_side(cell, monkeypatch):
    import audian_torch.analysis.events as events
    from audian_torch.utils import trace

    if cell == "detect-hour":
        monkeypatch.setattr(events, "_CHUNK",
                            TINY[cell]["traffic"]["chunk_frames"])
    trace.clear()
    try:
        res = core.run_cell(BENCH, cell, SEED, 0.2, 1, "cpu", ROOT,
                            overrides=TINY[cell])
    finally:
        trace.disable()
        trace.clear()
    assert res["correct"], res["checks"]
    mine = {m["name"] for m in BENCH["per_layer"]
            if m["name"] in HOST_SIDE and core.reports(m, {"name": cell})}
    assert mine
    got = res["metrics"]
    assert all(got[n]["value"] > 0 for n in mine), got
    # the device-timed ones have nothing to read on the CPU
    assert not set(got) & (set(WANT) - set(HOST_SIDE))
