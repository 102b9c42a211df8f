"""The two routes of ``audian_torch.ops.stft.spectrogram`` on the CPU: the
kernel route's analysis bank and layout, run through ``window_matmul`` on
CPU tensors (its plain version), against the plain route and the JAX
package's spectrogram; which inputs take which route, and the ``stft`` tag
on the graph node's span; the bank shared with the batch chain's
``spec_w``; the three callers of ``bank_psd``, which agree; the graph
node's zero tail frames on both routes.  The kernel
itself runs only on the card (``chip_smoke.py``).

Tolerances: float32 against the plain route and the JAX package, 1e-4
relative to each element and 1e-6 of the largest power; the callers of
``bank_psd`` against each other 1e-6 relative and 1e-7 of the largest
power."""

import types

import numpy as np
import pytest
import torch

from audian_tpu.ops import stft as jstft

from audian_torch.convert import node_params_from_arrays
from audian_torch.graph import (GraphExecutor, SpectrogramNode, TraceGraph,
                                TraceSpec)
from audian_torch.graph.nodes import FilterNode, device_nbytes
from audian_torch.models import get_preset
from audian_torch.ops import stft
from audian_torch.ops.cuda.window_matmul import window_matmul
from audian_torch.ops.design import design_envelope_filter
from audian_torch.ops.fused import FusedChainCF, design_arrays
from audian_torch.utils import trace

RATE = 48000.0
N = 4800

#: (nfft, hop): for each NFFT a hop that divides N and one that does not
GEOMETRIES = [(64, 32), (64, 37), (256, 160), (256, 90), (1024, 480),
              (1024, 333)]
SHAPES = [(N,), (N, 3), (N, 2, 3)]


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


def signal(shape, seed=3):
    """A tone in noise, each column scaled differently."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[0]) / RATE
    x = np.sin(2 * np.pi * 3000.0 * t).reshape((-1,) + (1,) * (len(shape)
                                                             - 1))
    x = x * np.linspace(0.5, 1.5, int(np.prod(shape[1:]))).reshape(
        (1,) + shape[1:]) + 0.1 * rng.standard_normal(shape)
    return x.astype(np.float32)


@pytest.fixture
def kernel_route(monkeypatch):
    """Every input takes the kernel route, run on the CPU by
    window_matmul's plain version."""
    monkeypatch.setattr(stft, "_takes_kernel", lambda *a: True)


@pytest.mark.parametrize("nfft,hop", GEOMETRIES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{len(s)}d")
def test_kernel_route_matches_plain_and_jax(shape, nfft, hop):
    x = signal(shape)
    xt = torch.from_numpy(x)
    got = stft._kernel_spectrogram(xt, RATE, nfft, hop, None)
    nbins = nfft // 2 + 1
    assert got.shape == ((N - nfft) // hop + 1,) + shape[1:] + (nbins,)
    assert got.dtype == torch.float32
    close(got, stft.spectrogram(xt, RATE, nfft, hop))
    close(got, jstft.spectrogram(x, RATE, nfft, hop))
    # the graph's window, a float32 host Hann, gives its own bank
    hann32 = stft.hann_window(nfft)
    close(stft._kernel_spectrogram(xt, RATE, nfft, hop, hann32), got)


@pytest.mark.parametrize("what", ["cuda", "cpu", "float64", "detrend",
                                  "nfft2048", "fft", "tensor_window",
                                  "columns", "host_window"])
def test_route_choice(what):
    """A CUDA float32 input with the matmul method, no detrending and a
    host window (or none) takes the kernel; each other input goes
    plain."""
    x = types.SimpleNamespace(is_cuda=True, dtype=torch.float32,
                              shape=(N, 16))
    nfft, window, detrend, method = 256, None, False, "auto"
    if what == "cpu":
        x.is_cuda = False
    elif what == "float64":
        x.dtype = torch.float64
    elif what == "detrend":
        detrend = "constant"
    elif what == "nfft2048":
        nfft = 2048
    elif what == "fft":
        method = "fft"
    elif what == "tensor_window":
        window = torch.ones(nfft)
    elif what == "columns":
        x.shape = (N, 256, 257)
    elif what == "host_window":
        window = stft.hann_window(nfft)
    takes = stft._takes_kernel(x, nfft, nfft // 2, window, detrend,
                               stft._method(method, nfft))
    assert takes == (what in ("cuda", "host_window"))


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_route_is_tagged_and_counted(request, route):
    """The route lands as ``stft`` on the innermost span; a CPU tensor
    launches no kernel on either route."""
    if route == "kernel":
        request.getfixturevalue("kernel_route")
    x = torch.from_numpy(signal((N, 2)))
    launches = window_matmul.launches
    trace.clear()
    trace.enable(log=False)
    try:
        with trace.timed("graph.node", node="spectrogram"):
            got = stft.spectrogram(x, RATE, 256, 128)
        stft.spectrogram(x, RATE, 256, 128)
        evs = trace.events()
    finally:
        trace.disable()
        trace.clear()
    assert [(e["kind"], e["stft"]) for e in evs] == [("graph.node", route)]
    assert window_matmul.launches == launches
    close(got, jstft.spectrogram(x.numpy(), RATE, 256, 128))


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_graph_run_tags_the_spectrogram_node(request, route):
    """A traced graph run: the spectrogram node's span names its route,
    and its window reaches ``spectrogram`` as a host array."""
    if route == "kernel":
        request.getfixturevalue("kernel_route")
    g = TraceGraph([FilterNode("filtered", "data"),
                    SpectrogramNode("spectrogram", "filtered")])
    g.open(TraceSpec(rate=RATE, channels=2, frames=N))
    g["filtered"].update(highpass_cutoff=2000.0, lowpass_cutoff=10000.0)
    g.refold()
    ex = GraphExecutor(g, device="cpu")
    trace.clear()
    trace.enable(log=False)
    try:
        ex.run(signal((N, 2)), 0)
        evs = trace.events("graph.node")
        params = trace.events("graph.params")
    finally:
        trace.disable()
        trace.clear()
    spec = [e for e in evs if e["node"] == "spectrogram"]
    assert [e["stft"] for e in spec] == [route]
    assert all("stft" not in e for e in evs if e["node"] != "spectrogram")
    assert [e["bytes"] for e in params if e["node"] == "spectrogram"] == [0]


def test_window_stays_on_the_host():
    node = SpectrogramNode()
    node.open(TraceSpec(rate=RATE, channels=2, frames=N))
    hann = node.params()
    up = node.upload(hann, torch.device("cpu"))
    assert isinstance(up, np.ndarray) and up.dtype == np.float32
    np.testing.assert_array_equal(up, hann)
    assert device_nbytes(up) == 0
    got = node_params_from_arrays(node, np.asarray(hann, np.float64), "cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert node.upload(None, "cpu") is None


def old_spec_w(nfft, rate):
    """``kernel_arrays``'s analysis matrix as the batch chain built it."""
    nbins = nfft // 2 + 1
    win = stft.hann_window(nfft, np.float64)
    W = stft._dft_matrices(nfft, nbins, np.float64)
    scale = 1.0 / (float(rate) * float(np.sum(win ** 2)))
    dbl = stft.one_sided_doubling(nfft)
    amp = np.sqrt(np.concatenate([dbl * scale, dbl * scale]))
    return ((win[:, None] * W) * amp[None, :]).astype(np.float32)


@pytest.mark.parametrize("preset,rate", [("bioacoustics", 96000.0),
                                         ("ultrasound", 384000.0)])
def test_shared_bank_is_the_chains_spec_w(preset, rate):
    p = get_preset(preset)
    bank = stft.analysis_bank(p.nfft, rate)
    for want in (design_arrays(rate, nfft=p.nfft)["spec_w"],
                 old_spec_w(p.nfft, rate)):
        assert bank.dtype == want.dtype and bank.shape == want.shape
        assert bank.tobytes() == want.tobytes()
    fc = p.fused(rate, device="cpu")
    assert fc.spec_w.numpy().tobytes() == bank.tobytes()


def test_device_bank_is_made_once(monkeypatch):
    """A bank and its split holder are made once per (NFFT, rate, window,
    device): a second call, or another array of the same window, finds
    them; another window or rate gets its own."""
    built = []
    real = stft.analysis_bank

    def spy(*a):
        built.append(a[:2])
        return real(*a)

    monkeypatch.setattr(stft, "analysis_bank", spy)
    stft._device_bank.cache_clear()
    x = torch.from_numpy(signal((N, 2)))
    cpu = torch.device("cpu")
    for window in (None, None, stft.hann_window(128),
                   stft.hann_window(128).copy()):
        stft._kernel_spectrogram(x, RATE, 128, 64, window)
    assert built == [(128, RATE), (128, RATE)]
    stft._kernel_spectrogram(x, 2 * RATE, 128, 64, None)
    assert len(built) == 3
    bank, split = stft._device_bank(128, RATE, None, cpu)
    assert stft._device_bank(128, RATE, None, cpu)[1] is split
    np.testing.assert_array_equal(bank.numpy(), real(128, RATE))
    stft._device_bank.cache_clear()


@pytest.mark.parametrize("nfft,hop", [(64, 32), (256, 128), (512, 256)])
def test_psd_sites_agree(nfft, hop):
    """The three callers of ``stft.bank_psd`` give one PSD of one stream
    over one bank: the kernel route on the time-first stream,
    ``FusedChainCF.spectrogram_fc`` on the channels-first one, and
    ``chain_cf``'s per-stage route, whose envelope look-back makes its
    product skip the frames before the chunk.  Each is held against the
    plain route too."""
    fc = FusedChainCF(RATE, env_sos=design_envelope_filter(RATE, 500.0),
                      nfft=nfft, hop=hop, device="cpu")
    assert fc.chain_kernel is None and fc._lead // hop > 0
    n = 40 * hop
    x = torch.from_numpy(signal((fc.hb + n + fc.ha, 3)).T.copy())
    _, _, staged = fc.chain_cf(x, n, outputs=("spectrogram",))
    seg = x[:, fc.hb : fc.hb + n + nfft - hop]
    sites = {"kernel": stft._kernel_spectrogram(seg.T.contiguous(), RATE,
                                                 nfft, hop, None),
             "spectrogram_fc": fc.spectrogram_fc(seg), "stages": staged}
    plain = stft.spectrogram(seg.T, RATE, nfft, hop)
    for name, got in sites.items():
        assert got.shape == (n // hop, 3, nfft // 2 + 1), name
        close(got, plain)
        np.testing.assert_allclose(got, sites["kernel"], rtol=1e-6,
                                   atol=1e-7 * float(plain.max()),
                                   err_msg=name)


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("extra", [0, 1, 7])
def test_node_tail_frames_are_zero(request, route, extra):
    """``SpectrogramNode.compute``: the frames whose window fits the chunk
    equal ``spectrogram``'s, and the ``extra`` frames past them, whose
    window overhangs it, are zero on either route."""
    if route == "kernel":
        request.getfixturevalue("kernel_route")
    node = SpectrogramNode(nfft=256)
    node.open(TraceSpec(rate=RATE, channels=3, frames=N))
    src = torch.from_numpy(signal((N, 3), seed=5))
    lead = 128
    nf = stft.num_frames(N - lead, 256, node.hop)
    params = node.upload(node.params(), "cpu")
    out = node.compute(src, lead, nf + extra, params)
    assert out.shape == (nf + extra, 3, 129)
    close(out[:nf], jstft.spectrogram(src.numpy()[lead:], RATE, 256,
                                      node.hop))
    assert out[:nf].all() and not out[nf:].any()
    # fewer frames than fit: the first n_out
    short = node.compute(src, lead, 5, params)
    assert torch.equal(short, out[:5])
    # no frame fits: all zero
    none = node.compute(src[:200], 0, 4, params)
    assert none.shape == (4, 3, 129) and not none.any()


@pytest.mark.parametrize("layout", ["time_first", "channels_first",
                                    "column_slice", "one_column"])
def test_stream_goes_channels_first(monkeypatch, layout):
    """The kernel reads ``(cols, n)`` rows: a time-first stream goes
    through the relayout kernel (its columns as the phases), a
    channels-first one is read where it lies, a column slice is copied."""
    calls = []
    real = stft.pm_forward

    def spy(u, M):
        calls.append((tuple(u.shape), M))
        return real(u, M)

    monkeypatch.setattr(stft, "pm_forward", spy)
    base = torch.from_numpy(signal((N, 5)))
    x = {"time_first": base,
         "channels_first": base.T.contiguous().T,
         "column_slice": base[:, 1:4],
         "one_column": base[:, 2:3].contiguous()}[layout]
    got = stft._channels_first(x)
    assert torch.equal(got, x.T)
    assert calls == ([((1, N * 5), 5)] if layout == "time_first" else [])
    if layout != "time_first":      # the relayout's plain version: a view
        assert got.is_contiguous()
    if layout in ("channels_first", "one_column"):
        assert got.data_ptr() == x.data_ptr()
