"""The ``ultrasound-stages`` cell: its reference against scipy at a tiny
size, its count, its generator end to end on the CPU (sound runs read
``correct`` true, runs with the timed path broken false; the chain's halos
read before the hour is made), the readers of its per-layer metrics on a
synthetic log and trace, a traced tiny run, and its control on the card.

The control on the card, at a tenth of an hour by default (the cell's own
size with ``PORTBENCH_FULL=1``):

    python3 -m pytest -p no:cacheprovider --confcutdir=portbench -m card -s \\
        portbench/tests/test_portbench_stages.py
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.signal as sps
import torch

from portbench import core, work
from test_portbench_card import SEEDS
from test_portbench_run import BENCH, ROOT, SEED, chain_fault

CELL = "ultrasound-stages"
US = json.loads((ROOT / "portbench/configs/ultrasound-384k-16ch.json")
                .read_text())
RATE = 384000.0
#: the cell at a size the CPU runs in seconds: two channels, a quarter
#: second in three chunks (the last one ragged)
TINY = {"config": {"channels": 2},
        "traffic": {"recording_s": 0.25, "chunk_frames": 1 << 15}}
#: the control's size on the card: a tenth of an hour
SMALL = {"traffic": {"recording_s": 360.0}}


def test_the_cell_and_its_entries():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells[CELL] == dict(cells[CELL], config="ultrasound-384k-16ch",
                               traffic=CELL, chips=1)
    c = core.Cell(BENCH, CELL, ROOT)
    assert [m["name"] for m in c.end_to_end] == ["batch_s_per_rec_h",
                                                 "setup_s"]
    assert {m["name"] for m in c.per_layer} == {
        "stages_roofline", "stage_ms.filtered", "stage_ms.envelope",
        "stage_ms.spectrogram", "call_us.stages", "enqueue_us.chain",
        "idle_pct.batch", "mfu.batch"}
    assert c.traffic["generator"] == "stages_batch"
    assert set(c.limits) == {"filtered_err", "envelope_err", "psd_db_err",
                             "stats_rel_err"}


def test_reference_against_scipy():
    ref = core.load_module("reference", "ultrasound-384k-16ch")
    hb, n, ha = 1619, 8192, 1393
    rng = np.random.default_rng(4)
    q = np.clip(np.round(0.3 * rng.standard_normal((2, hb + n + ha))
                         * 32768), -32768, 32767).astype(np.int16)
    out = ref.chain(US, torch.from_numpy(q), hb, n)
    x = q.astype(np.float64) / 32768.0
    sos_f = sps.butter(2, (20000.0, 90000.0), "bandpass", fs=RATE,
                       output="sos")
    sos_e = sps.butter(2, 1000.0, "lowpass", fs=RATE, output="sos")
    y = sps.sosfilt(sos_f, x, axis=1)
    assert np.abs(out["filtered"].numpy() - y[:, hb : hb + n]).max() < 1e-12
    e = np.maximum(sps.sosfiltfilt(sos_e, (np.pi / 2) * np.abs(y), axis=1,
                                   padtype=None), 0)
    mid = slice(3000, 5000)
    assert np.abs(out["envelope"].numpy()[:, mid]
                  - e[:, hb : hb + n][:, mid]).max() < 1e-9
    _, _, s = sps.spectrogram(y[:, hb : hb + n + 256], fs=RATE,
                              window="hann", nperseg=512, noverlap=256,
                              detrend=False, scaling="density", mode="psd")
    p, want = out["psd"].numpy(), np.moveaxis(s, -1, 0)
    assert p.shape == want.shape == (n // 256, 2, 257)
    # the band-pass leaves the bins below 20 kHz near round-off: over the
    # bins within 60 dB of the peak
    keep = want >= want.max() * 1e-6
    assert np.abs(p[keep] / want[keep] - 1).max() < 1e-10
    assert np.allclose(out["env_sum"].numpy(), out["envelope"].numpy().sum(1),
                       rtol=1e-12)
    # the halos hold the band-pass's history and all but a hundredth of
    # the guarantee's share of the envelope's lags
    history, lags = ref.truncation(US, hb, ha)
    assert history == 0.0 and lags < 1e-7


def test_the_hours_count():
    n = 1 << 22
    sizes = [n] * 329 + [2_473_984]
    assert work.chain_taps(US) == (84, 2787)
    assert work.chain_count(US, n) == (523_517_034_496, 940_572_672)
    flop = sum(work.chain_count(US, m)[0] for m in sizes)
    assert flop == 172_545_897_600_000
    least = sum(work.bound_s(*work.chain_count(US, m))[0] for m in sizes)
    assert least == pytest.approx(0.52334, rel=1e-4)


def tiny_run(trace=0, variant="program"):
    return core.run_cell(BENCH, CELL, SEED, 0.2, trace, "cpu", ROOT,
                         variant=variant, overrides=TINY)


def test_sound_run_is_correct():
    res = tiny_run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] % 3 == 0
    assert set(res["metrics"]) == {"batch_s_per_rec_h", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_run_is_not_correct(kind, monkeypatch):
    chain_fault(kind, monkeypatch)
    res = tiny_run()
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0


def test_halos_are_read_before_the_hour_is_made(monkeypatch):
    """A program whose chain has no ``hb`` (one without the per-stage
    route) fails before any of the hour is made."""
    from audian_torch.ops.fused import FusedChainCF

    gen = core.load_module("generators", "stages_batch")
    made = []
    monkeypatch.setattr(gen, "make_hour", lambda *a: made.append(a))
    monkeypatch.delattr(FusedChainCF, "hb")
    with pytest.raises(AttributeError):
        tiny_run()
    assert not made


# -- the per-layer metrics ---------------------------------------------------

STAGES = [{"kind": "stages.stage", "stage": s, "device_ms": ms}
          for s, ms in [("filtered", 0.5), ("envelope", 4.0),
                        ("spectrogram", 1.5), ("stats", 0.25)] * 3]
STAGES.append({"kind": "stages.stage", "stage": "envelope"})  # unresolved
SUMMARY = {"stages.call": {"count": 3, "dropped": 0, "ms": 0.15,
                           "device_ms": 18.75},
           "chain.call": {"count": 10, "dropped": 0, "ms": 0.25}}
WANT = {"stage_ms.filtered": 0.5, "stage_ms.envelope": 4.0,
        "stage_ms.spectrogram": 1.5, "call_us.stages": 50.0}


def fake_log(monkeypatch, evs, summary):
    from audian_torch.utils import trace

    monkeypatch.setattr(trace, "events", lambda kind=None: [
        e for e in evs if kind is None or e["kind"] == kind])
    monkeypatch.setattr(trace, "summary", lambda: summary)


@pytest.mark.parametrize("metric", list(WANT))
def test_span_reader_on_a_synthetic_log(metric, monkeypatch):
    fake_log(monkeypatch, STAGES, SUMMARY)
    value = core.load_module("metrics", metric).read(SimpleNamespace(),
                                                     None)
    assert value == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", list(WANT))
def test_span_reader_on_an_empty_log(metric, monkeypatch):
    fake_log(monkeypatch, [], {})
    assert core.load_module("metrics", metric).read(SimpleNamespace(),
                                                    None) is None


class FakeTrace:
    window_s = 2.0
    busy_s = 1.9

    def __init__(self, kernels):
        self.kernels = kernels

    def kernel_s(self, part):
        hits = [v for n, v in self.kernels.items() if part in n]
        return sum(s for s, _ in hits), sum(c for _, c in hits)


def test_roofline_reader():
    read = core.load_module("metrics", "stages_roofline").read
    n = 1 << 22
    t = FakeTrace({"void window_matmul_kernel<176, false, false>(Args)":
                   (1.5, 6), "void window_matmul_kernel<128, true, false>"
                   "(Args)": (0.5, 2), "elementwise_kernel": (0.3, 4)})
    r = SimpleNamespace(config=US, calls={"chain": [n, n]})
    least = 2 * work.bound_s(*work.chain_count(US, n))[0]
    assert read(r, t) == pytest.approx(100 * least / 2.0)
    assert read(SimpleNamespace(config=US, calls={}), t) is None
    assert read(r, FakeTrace({"chain_kernel": (1.0, 1)})) is None


def test_traced_tiny_run_reports_the_host_side():
    """On the CPU the spans have host times and no device times: the run
    reports ``call_us.stages`` and none of the device-timed readers.  The
    batch cells' shared readers find the calls where ``chain_batch`` keeps
    them: the enqueue times, and the calls' sizes for ``mfu.batch``."""
    from audian_torch.utils import trace

    trace.clear()
    try:
        res = tiny_run(trace=1)
    finally:
        trace.disable()
        trace.clear()
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["call_us.stages"]["value"] > 0
    assert got["enqueue_us.chain"]["value"] > 0
    assert got["mfu.batch"]["value"] > 0
    assert got["idle_pct.batch"]["value"] == pytest.approx(100.0)
    assert not set(got) & {"stage_ms.filtered", "stage_ms.envelope",
                           "stage_ms.spectrogram", "stages_roofline"}


def test_control_runs_the_same_route_at_its_rung(monkeypatch):
    """The control is ``chain_cf``'s route at the traffic's rung (on the
    CPU the plain products ignore the rung, so it reads ``correct``)."""
    from audian_torch.ops.fused import FusedChainCF

    rungs = []
    real = FusedChainCF.chain_cf

    def spy(self, x_ext, n, stats=False, outputs=None):
        rungs.append(self.precision)
        return real(self, x_ext, n, stats=stats)

    monkeypatch.setattr(FusedChainCF, "chain_cf", spy)
    res = tiny_run(variant="control")
    assert res["correct"] and set(rungs) == {"default"}


@pytest.mark.card
def test_control_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    full = os.environ.get("PORTBENCH_FULL") == "1"
    for seed in SEEDS:
        res = core.run_cell(BENCH, CELL, seed, 3.0, 0, "cuda:0", ROOT,
                            variant="control",
                            overrides=None if full else SMALL)
        print(json.dumps({"cell": CELL, "seed": seed, "full": full,
                          "correct": res["correct"],
                          "checks": res["checks"]}))
        assert not res["correct"], res["checks"]
