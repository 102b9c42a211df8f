"""The graph's causal FIR kernel (``csrc/fir.cu`` through
``audian_torch/ops/cuda/fir.py``) on the CPU: its tap vectors against a
numpy model of the core's A-fragment reads, its tile and shared-memory
geometry, the dispatch in ``sosfilt_fir`` by what the input shows, and a
torch emulation of its sum (the core's units of 128 taps added in fp32)
against the plain twin ``_fir_valid_cf`` and scipy in float64 at the
graph's designs.  The kernel itself runs only on the card
(``chip_smoke.py``)."""

import numpy as np
import pytest
import scipy.signal
import torch
import torch.nn.functional as F

from audian_torch.ops import sos
from audian_torch.ops.cuda import fir as firmod
from audian_torch.ops.cuda._build import SMEM_LIMIT
from audian_torch.ops.cuda.chain import (TAP_PAD, _split_taps, core_steps,
                                         split_tf32, stream_rows)
from audian_torch.ops.design import (FilterDesign, design_envelope_filter,
                                     design_filter)
from audian_torch.utils import trace

RATE = 96000.0


#: (design, taps): each extended past its own decay length to the taps
#: the kernel is tested at
GRAPH_DESIGNS = {
    "filter": (lambda: design_filter(RATE, 2000.0, 40000.0, 2), 1024),
    "envelope": (lambda: design_envelope_filter(RATE, 500.0, 0.0, 2), 4096),
    "envelope200": (lambda: design_envelope_filter(RATE, 200.0, 0.0, 2),
                    8192),
    "long": (lambda: design_filter(RATE, 50.0, None, 2), 32768),
}


def graph_design(kind):
    """Long designs for the kernel: the scrub's 2-40 kHz band-pass at 1024
    taps and its 500 Hz envelope at 4096 (one launch each), a 200 Hz
    envelope at 8192 (two launches) and a 50 Hz high-pass at 32768
    (eight).  ``pad_to`` extends each exactly: its leading taps are the
    design's own."""
    sos, taps = GRAPH_DESIGNS[kind]
    return FilterDesign.from_sos(sos(), pad_to=taps).fir.h


def test_operand_holds_each_slice_split_on_the_host():
    """The operand is each slice's ``[hi | lo]`` split by the host
    (``_split_taps``), bit for bit, one after the other, and the plan
    covers the taps in order."""
    h = np.random.default_rng(1).standard_normal(
        2 * firmod.LAUNCH_TAPS + 5).astype(np.float32)
    h[3] = np.float32(1.5 + 2.0 ** -11)          # a tie, rounded away
    h[7] = -h[3]
    vec, plan = firmod.operand(h)
    assert [(m, T) for m, T, _ in plan] == firmod.slices(len(h))
    at = 0
    for m, T, off in plan:
        assert off == at
        L = T + 2 * TAP_PAD
        part = vec[off:off + 2 * L]
        assert part.view(np.int32).tolist() == \
            _split_taps(h[m:m + T]).view(np.int32).tolist()
        hi, lo = part[:L], part[L:]
        assert not hi[:TAP_PAD].any() and not hi[-TAP_PAD:].any()
        assert not lo[:TAP_PAD].any() and not lo[-TAP_PAD:].any()
        assert not (hi.view(np.uint32) & 0x1FFF).any()
        assert not (lo.view(np.uint32) & 0x1FFF).any()
        err = np.abs(hi[TAP_PAD:-TAP_PAD].astype(np.float64)
                     + lo[TAP_PAD:-TAP_PAD] - h[m:m + T])
        assert np.all(err <= 2.0 ** -21 * np.abs(h[m:m + T]))
        at += 2 * L
    assert at == len(vec)


@pytest.mark.parametrize("kind", ["filter", "envelope", "long"])
def test_tap_vector_gives_the_core_its_toeplitz_slices(kind):
    """Each thread's four A reads of a step (``wgconv::unit``: p, p + 8,
    p - 4, p + 4 from ``tp - 8 v``) land in its slice's split and read the
    Toeplitz slice ``A_v[n, k] = h[n - k + D - 8 v]`` (zero outside the
    slice's taps), at every step of the launch's stage (D = T - 1), both
    parts; the long design's first and last slices."""
    h = graph_design(kind).astype(np.float32)
    vec, plan = firmod.operand(h)
    assert len(plan) == (1 if kind != "long" else 8)
    for m0, T, off in (plan[0], plan[-1]):
        D = T - 1
        tlo = T + 2 * TAP_PAD
        sub = vec[off:off + 2 * tlo]
        w, g, t = np.meshgrid(np.arange(4), np.arange(8), np.arange(4),
                              indexing="ij")
        v_lo, v_hi = core_steps(T, D)
        assert (v_lo, v_hi) == (0, (D + 63) // 8)
        hi, lo = split_tf32(h[m0:m0 + T])
        for v in range(v_lo, v_hi + 1):
            p = TAP_PAD + D + 16 * w + g - t - 8 * v
            for part, ref in ((0, hi), (1, lo)):
                o = part * tlo
                reads = [p + o, p + 8 + o, p - 4 + o, p + 4 + o]
                for r in reads:
                    assert r.min() >= o and r.max() < o + tlo
                rows = [16 * w + g, 16 * w + g + 8, 16 * w + g,
                        16 * w + g + 8]
                cols = [t, t, t + 4, t + 4]
                for r, n, k in zip(reads, rows, cols):
                    m = n - k + D - 8 * v
                    want = np.where((m >= 0) & (m < T),
                                    ref[np.clip(m, 0, T - 1)], 0.0)
                    np.testing.assert_array_equal(sub[r], want)


#: outputs of one channel a kernel block (``TILE`` in csrc/fir.cu), and a
#: model of its shared memory (``fir_smem``): both parts of the split
#: stream of the block's span, 512 bytes a row of 64 samples
TILE = 8192


def smem_bytes(T):
    return 512 * stream_rows(TILE // 64, T - 1)


@pytest.mark.parametrize("T,smem", [(1024, 74240), (4096, 98816)])
def test_block_geometry_at_the_graph_designs(T, smem):
    """The block's stream holds the span of its tile, every sample the
    core reads for its 128 columns (the last step reads sample 64 ncols +
    D + 6), in both parts, and two blocks share an SM (228 KB, less 1 KB
    the runtime reserves for each block)."""
    nu = stream_rows(TILE // 64, T - 1)
    assert nu % 2 == 1
    assert 64 * nu >= TILE + (T - 1) + 7
    assert smem_bytes(T) == smem == 2 * 256 * nu
    assert 2 * (smem + 1024) <= 233472
    assert firmod.slices(T) == [(0, T)]


def test_no_launch_asks_beyond_the_shared_memory():
    """One launch's stream fits a block up to 20,794 taps (the launch is
    refused beyond); the wrapper's slices stay at :data:`LAUNCH_TAPS`, whose
    stream leaves room for two blocks an SM, and cover every design: the
    fewest slices, in order, of near-equal length."""
    assert smem_bytes(20794) <= SMEM_LIMIT < smem_bytes(20795)
    assert 2 * (smem_bytes(firmod.LAUNCH_TAPS) + 1024) <= 233472
    for T in (1, 1023, 4096, 4097, 8192, 20795, 32768, 32769, 1 << 20):
        sl = firmod.slices(T)
        assert len(sl) == -(-T // firmod.LAUNCH_TAPS)
        assert [m for m, _ in sl] == list(np.cumsum([0] + [n for _, n in
                                                           sl])[:-1])
        assert sum(n for _, n in sl) == T
        assert max(n for _, n in sl) <= firmod.LAUNCH_TAPS
        assert max(n for _, n in sl) - min(n for _, n in sl) <= 1 or \
            len(sl) == 1


def emulate_tiles(x, h):
    """The kernel's addressing in float64: each slice ``(m, T)`` of the
    taps is a launch whose block (tile, c) convolves its span ``x[j0 - m -
    (T - 1) : j0 - m + TILE, c]`` (zero outside ``[0, n)``), keeps the
    outputs below ``n - j0`` and writes them (the first slice) or adds
    them (the others); the tiles stitched."""
    n, C = x.shape
    y = np.zeros((C, n))
    for m, T in firmod.slices(len(h)):
        for b in range(C * -(-n // TILE)):
            c, j0 = b % C, (b // C) * TILE
            s = np.arange(j0 - m - (T - 1), j0 - m + TILE)
            span = np.where((s >= 0) & (s < n), x[np.clip(s, 0, n - 1), c],
                            0.0)
            out = np.convolve(span, h[m:m + T], mode="valid")
            cnt = min(TILE, n - j0)
            y[c, j0:j0 + cnt] = (out[:cnt] if m == 0 else
                                 y[c, j0:j0 + cnt] + out[:cnt])
    return y.T


@pytest.mark.parametrize("T", [1024, 2 * 4096 + 300])
def test_tiles_stitch_to_the_causal_fir(T):
    rng = np.random.default_rng(2)
    h = rng.standard_normal(T)
    x = rng.standard_normal((2 * TILE + 777, 3))
    assert len(firmod.slices(T)) == -(-T // firmod.LAUNCH_TAPS)
    want = scipy.signal.lfilter(h, 1.0, x, axis=0)
    np.testing.assert_allclose(emulate_tiles(x, h), want, rtol=0,
                               atol=1e-9)


def _tf32(a):
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def emulate_launch(x, h, delay, three=True, rows=256):
    """One launch's sum in torch, the taps ``h`` over the stream ``x``
    delayed by ``delay``: output ``i`` (row ``i % 64`` of its column)
    takes the taps ``m`` in units ``(T - 1 + i % 64 - m) // 128``; each
    unit's products (hi*lo + lo*hi + hi*hi of the TF32 splits, or hi*hi
    alone) are summed in fp32 and the units added in fp32 in order."""
    n, C = x.shape
    T = len(h)
    hh = _tf32(h)
    hl = _tf32(h - hh)
    xh = _tf32(x)
    xl = _tf32(x - xh)
    ph = F.pad(xh.T, (T - 1 + delay, 0))[:, :n + T - 1]
    pl = F.pad(xl.T, (T - 1 + delay, 0))[:, :n + T - 1]
    m = torch.arange(T)
    nunits = (T - 1 + 63) // 128 + 1
    out = torch.empty((C, n), dtype=torch.float32)
    for i0 in range(0, n, rows):
        i = torch.arange(i0, min(i0 + rows, n))
        idx = i[:, None] + (T - 1) - m[None, :]
        Xh, Xl = ph[:, idx], pl[:, idx]
        p = hh * Xh
        if three:
            p = hh * Xl + hl * Xh + p
        unit = ((T - 1 + i % 64)[:, None] - m[None, :]) // 128
        part = torch.zeros((C, len(i), nunits), dtype=torch.float32)
        part.scatter_add_(2, unit.expand(C, -1, -1), p)
        total = torch.zeros((C, len(i)), dtype=torch.float32)
        for u in range(nunits):
            total = total + part[..., u]
        out[:, i0:i0 + len(i)] = total
    return out.T


def emulate_kernel(x, h, three=True):
    """:func:`fir`'s sum in torch: each slice's launch
    (:func:`emulate_launch`), the later ones added in fp32 to what the
    earlier ones wrote."""
    x = torch.as_tensor(x, dtype=torch.float32)
    h = torch.as_tensor(h, dtype=torch.float32)
    y = None
    for m, T in firmod.slices(len(h)):
        part = emulate_launch(x, h[m:m + T], m, three)
        y = part if y is None else y + part
    return y


@pytest.mark.parametrize("kind", ["filter", "envelope", "envelope200"])
def test_emulated_sum_holds_the_contract(kind):
    """At the scrub's designs, and at a design of two launches, on a
    unit-scale stream (an envelope's input is rectified), the emulated
    3xTF32 sum lies within 1e-6 of scipy float64 and of the plain twin,
    far inside the graph's 1e-5 contract; the one-pass sum (DEFAULT) does
    not hold the contract."""
    h = graph_design(kind).astype(np.float32)
    T = len(h)
    assert len(firmod.slices(T)) == (2 if kind == "envelope200" else 1)
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal((T + 1500, 2))).astype(np.float32)
    if kind.startswith("envelope"):
        x = (np.pi / 2 * np.abs(x)).astype(np.float32)
    got = emulate_kernel(x, h).numpy()
    want = scipy.signal.lfilter(h.astype(np.float64), 1.0,
                                x.astype(np.float64), axis=0)
    plain = sos._fir_valid_cf(F.pad(torch.from_numpy(x).T, (T - 1, 0)),
                              torch.from_numpy(h)).T.numpy()
    assert np.abs(got - want).max() < 1e-6
    assert np.abs(got - plain).max() < 1e-6
    assert np.abs(plain - want).max() < 1e-6
    one = emulate_kernel(x, h, three=False).numpy()
    assert np.abs(one - want).max() > 1e-5


def test_cpu_stream_runs_the_plain_twin_and_counts_no_launch(monkeypatch):
    calls = []
    plain = sos._fir_valid_cf

    def spy(x_cf, h, precision=sos.HIGHEST):
        calls.append(tuple(x_cf.shape))
        return plain(x_cf, h, precision)

    monkeypatch.setattr(sos, "_fir_valid_cf", spy)
    launches = firmod.fir.launches
    kernels = FilterDesign.from_sos(design_filter(RATE, 2000.0, 40000.0, 2),
                                    pad_to=1024).fir
    x = torch.randn(3000, 4)
    y = sos.sosfilt_fir(kernels, x)
    assert calls == [(4, 3000 + 1023)]
    assert firmod.fir.launches == launches
    want = scipy.signal.lfilter(np.asarray(kernels.h, np.float64), 1.0,
                                x.numpy().astype(np.float64), axis=0)
    assert np.abs(y.numpy() - want).max() < 1e-5


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        firmod.fir(torch.zeros(100, 2), torch.ones(8))
    with pytest.raises(ValueError):
        firmod.fir(torch.zeros(100, 2), torch.ones(8), precision="bf16x3")


def test_operand_is_built_once_for_each_taps_object(monkeypatch):
    """A design's taps are split and uploaded once: the same array or
    tensor finds its operand kept; a tensor changed in place, or taps
    equal in value but another object, get their own; only the last
    designs are kept."""
    built = []
    real = firmod.operand

    def spy(h):
        built.append(len(h))
        return real(h)

    monkeypatch.setattr(firmod, "operand", spy)
    monkeypatch.setattr(firmod, "_operands", type(firmod._operands)())
    cpu = torch.device("cpu")
    h = graph_design("filter")
    a = firmod._device_operand(h, cpu)
    assert firmod._device_operand(h, cpu) is a and built == [1024]
    np.testing.assert_array_equal(a[0].numpy(), real(h)[0])
    assert a[1] == real(h)[1]
    t = torch.from_numpy(h.astype(np.float32))
    b = firmod._device_operand(t, cpu)
    assert firmod._device_operand(t, cpu) is b and len(built) == 2
    np.testing.assert_array_equal(b[0].numpy(), a[0].numpy())
    t.mul_(2.0)
    c = firmod._device_operand(t, cpu)
    assert c is not b and len(built) == 3
    np.testing.assert_array_equal(c[0].numpy(), real(2 * h)[0])
    assert firmod._device_operand(h.copy(), cpu) is not a
    others = [np.full(8, float(k)) for k in range(firmod._KEPT)]
    for o in others:
        firmod._device_operand(o, cpu)
    assert len(firmod._operands) == firmod._KEPT
    n = len(built)
    assert firmod._device_operand(others[-1], cpu) is not None
    assert len(built) == n
    firmod._device_operand(h, cpu)
    assert len(built) == n + 1
    # a design uploaded with its host taps finds its operand at its first
    # call (upload_taps keeps it so on a CUDA device)
    up = firmod.upload_taps(h, cpu)
    assert up.dtype == torch.float32 and up.device == cpu
    np.testing.assert_array_equal(up.numpy(), h.astype(np.float32))
    assert len(built) == n + 1
    for taps in (h, graph_design("envelope200")[:1000]):
        buf, at, plan = firmod._packed(taps)
        vec, want = real(taps)
        assert at % 32 == 0 and at >= len(taps) and plan == want
        np.testing.assert_array_equal(buf[:len(taps)],
                                      taps.astype(np.float32))
        np.testing.assert_array_equal(buf[at:], vec)
    n = len(built)
    kept = firmod._keep(up, real(h), cpu)
    assert firmod._device_operand(up, cpu) is kept and len(built) == n


def test_graph_node_spans_name_the_fir_path():
    """A traced run of the graph's filter and envelope nodes: each node
    span's ``fir`` field names the path of each of its FIR calls (the CPU
    runs the plain twin), and a FIR call outside any span tags nothing."""
    from audian_torch.graph.nodes import EnvelopeNode, FilterNode
    from audian_torch.graph.spec import TraceSpec

    spec = TraceSpec(rate=RATE, channels=2, frames=20000)
    filt, env = FilterNode(), EnvelopeNode()
    filt.open(spec)
    filt.update(highpass_cutoff=2000.0, lowpass_cutoff=40000.0)
    env.open(filt.spec)
    x = torch.randn(6000, 2)
    trace.clear()
    trace.enable(log=False)
    try:
        for node, src in ((filt, x), (env, x)):
            with trace.timed("graph.node", node=node.name):
                node.compute(src, 0, len(src), node.params())
        sos.sosfilt_fir(filt.params().fir, x)
        evs = trace.events()
    finally:
        trace.disable()
        trace.clear()
    assert [(e["kind"], e["node"], e["fir"]) for e in evs] == [
        ("graph.node", "filtered", "plain"),
        ("graph.node", "envelope", "plain,plain")]
