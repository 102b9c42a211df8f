"""The yardstick's counts, pinned by hand at the headline chunk, the detect
window and the 60 s window, and the per-layer metrics' arithmetic on
records made up for the purpose."""

import json
import types
from pathlib import Path

import pytest

from portbench import core, work

ROOT = Path(__file__).resolve().parents[2]
BIO = json.loads((ROOT / "portbench/configs/bioacoustics-96k-16ch.json")
                 .read_text())
DET = json.loads((ROOT / "portbench/configs/songdetector-96k-16ch.json")
                 .read_text())


def test_peaks():
    assert work.PEAKS["flop_per_s"] == 329.7e12
    assert work.PEAKS["bytes_per_s"] == 3.35e12


def test_taps_of_the_designs():
    # r^T < 1e-7 for the largest pole radius of each Butterworth design
    assert work.chain_taps(BIO) == (175, 2 * 697 - 1)
    assert work.chain_taps(BIO, 20000.0) == (181, 1393)
    assert work.taps(1, (1000.0, 10000.0), "bandpass", 96000.0, 1e-7) == 192
    assert work.taps(1, 500.0, "lowpass", 96000.0, 1e-7) == 493


def test_chain_headline_chunk():
    n = 1 << 22
    # a channel: 2 n (175 + 1393) taps, 32768 frames of 2 256 258 + 3 129
    per_channel = 2 * n * 1568 + 32768 * (2 * 256 * 258 + 3 * 129)
    assert per_channel == 17_494_540_288
    flop, nbytes = work.chain_count(BIO, n)
    assert flop == 16 * per_channel == 279_912_644_608
    assert nbytes == 16 * (2 * n + 8 * n + 4 * 32768 * 129) == 941_621_248
    t, by = work.bound_s(flop, nbytes)
    assert by == "operations"
    assert t == pytest.approx(279_912_644_608 / 329.7e12)


def test_detect_window():
    W, nout, step = 2_101_248, 110_376, 19
    ny = (nout - 1) * step + 985
    per_channel = ny * (2 * 383 + 1) + 2 * nout * 985
    assert per_channel == 1_826_691_090
    flop, nbytes = work.envdet_count(DET, W, nout, step)
    assert flop == 16 * per_channel == 29_227_057_440
    assert nbytes == 16 * (2 * W + 4 * nout) == 74_304_000
    assert work.bound_s(flop, nbytes) == pytest.approx(
        (29_227_057_440 / 329.7e12, "operations"))


def test_sixty_second_window():
    n = 60 * 96000
    flop, nbytes = work.graph_count(BIO, 30000.0, n, n, 45000)
    per_channel = 2 * n * 176 + 2 * n * 1393 + 45000 * 132_483
    assert flop == 16 * per_channel == 384_585_840_000
    assert nbytes == 16 * (10 * n + 4 * 45000 * 129) == 1_293_120_000
    assert work.bound_s(flop, nbytes)[1] == "operations"


class FakeTrace:
    window_s = 2.0
    busy_s = 1.5

    def kernel_s(self, part):
        return {"chain_kernel": (0.5, 2), "envdet_kernel": (0.25, 3)}.get(
            part, (0.0, 0))

    def range_s(self, name):
        return {"graph": [0.1, 0.3]}.get(name, [])


def run_with(**records):
    r = types.SimpleNamespace(config=BIO, calls={}, host={}, spans={})
    for k, v in records.items():
        setattr(r, k, v)
    return r


def metric(name):
    return core.load_module("metrics", name).read


def test_metric_arithmetic():
    t = FakeTrace()
    n = 1 << 22
    r = run_with(calls={"chain": [n, n]})
    least = 2 * work.bound_s(*work.chain_count(BIO, n))[0]
    assert metric("chain_roofline")(r, t) == pytest.approx(100 * least / 0.5)
    assert metric("mfu.batch")(r, t) == pytest.approx(
        100 * 2 * work.chain_count(BIO, n)[0] / (2.0 * 329.7e12))
    assert metric("idle_pct.batch")(r, t) == pytest.approx(25.0)
    assert metric("envdet_roofline")(r, t) is None
    r = run_with(config=DET, calls={"envdet": [(2_101_248, 110_376, 19)] * 3})
    assert metric("envdet_roofline")(r, t) == pytest.approx(
        100 * 3 * 29_227_057_440 / 329.7e12 / 0.25)
    steps = [(30000.0, 5_760_000, 5_760_000, 45000)] * 2
    r = run_with(calls={"graph": steps}, host={"tiles": [0.01, 0.03]},
                 spans={"graph.run": [2.0, 4.0]})
    assert metric("graph_device_ms")(r, t) == pytest.approx(200.0)
    assert metric("graph_roofline")(r, t) == pytest.approx(
        100 * 2 * (384_585_840_000 / 329.7e12) / 0.4)
    assert metric("tiles_ms")(r, t) == pytest.approx(20.0)
    assert metric("graph_host_ms")(r, t) == pytest.approx(3.0)
    r = run_with(host={"enqueue.chain": [1e-5, 3e-5, 2e-5]})
    assert metric("enqueue_us.chain")(r, t) == pytest.approx(20.0)
    assert metric("enqueue_us.envdet")(r, t) is None
