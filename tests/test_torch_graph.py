"""The port's trace graph (``audian_torch.graph``) against the JAX package's
(``audian_tpu.graph``): the plans, each node's compute on identical
coefficients (carried across with ``convert.node_params_from_arrays``),
whole and chunked runs, and the plan cache under a cutoff scrub.

The port designs each FIR node at its own decay length
(``FilterDesign.from_sos``); the JAX package keeps a grow-only budget of
four times it, whose taps the port's lead bit for bit.  Where a test
holds the port to the JAX package, the JAX nodes design at the port's
lengths (``fir_lengths.at_port_lengths``), so both plan the same
geometry.

Tolerances: filtered and envelope within 1e-5 absolute of the JAX
package's float64 output (the scipy contract of both packages), the PSD
within 1e-4 relative; chunked against whole on the port within 2e-6 (the
same float32 arithmetic over other chunk edges)."""

import dataclasses

import numpy as np
import pytest
import scipy.signal as sps
import torch

from audian_tpu import graph as jgraph

from audian_torch import graph as tgraph
from audian_torch.convert import node_params_from_arrays

from fir_lengths import at_port_lengths

RATE = 48000.0
NAMES = ("filtered", "envelope", "spectrogram")
FIR_NODES = ("filtered", "envelope")
TOL = 1e-5
TOL_PSD_RTOL = 1e-4
TOL_CHUNKED = 2e-6


@pytest.fixture(scope="module")
def recording():
    rng = np.random.default_rng(11)
    n = int(3.0 * RATE)
    t = np.arange(n) / RATE
    x = (np.sin(2 * np.pi * 6000.0 * t) * (np.sin(2 * np.pi * 3.0 * t) > 0)
         + 0.05 * rng.standard_normal(n))
    return np.stack([x, 0.5 * x], axis=1).astype(np.float32)


def open_graph(pkg, frames, channels=2, port_lengths=True):
    """The test's graph of ``pkg``; the JAX package's FIR nodes at the
    port's lengths unless ``port_lengths`` is false."""
    nodes = [pkg.FilterNode("filtered", "data"),
             pkg.EnvelopeNode("envelope", "filtered"),
             pkg.SpectrogramNode("spectrogram", "filtered")]
    if pkg is jgraph and port_lengths:
        at_port_lengths(*nodes)
    g = pkg.TraceGraph(nodes)
    g.open(pkg.TraceSpec(rate=RATE, channels=channels, frames=frames))
    g["filtered"].update(highpass_cutoff=2000.0, lowpass_cutoff=10000.0)
    g.refold()
    return g


def design_arrays(d):
    """A JAX node design's pytree leaves as numpy values, by name."""
    if d is None:
        return None
    return dict(sos=np.asarray(d.sos), zi0=np.asarray(d.zi0),
                padlen=d.padlen, h=np.asarray(d.fir.h),
                state_out=np.asarray(d.fir.state_out),
                input_state=np.asarray(d.fir.input_state),
                A=np.asarray(d.fir.A), eps=d.fir.eps)


def check_close(name, got, want):
    if name == "spectrogram":
        np.testing.assert_allclose(got, want, rtol=TOL_PSD_RTOL, atol=1e-12,
                                   err_msg=name)
    else:
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=name)


@pytest.mark.parametrize("offset,frames", [
    (0, 144000), (0, 30000), (20000, 40000), (100000, 44000),
    (4096, 8192)])
def test_plans_match_jax(recording, offset, frames):
    n = len(recording)
    jg, tg = open_graph(jgraph, n), open_graph(tgraph, n)
    assert tg.raw_halo == jg.raw_halo
    jex = jgraph.GraphExecutor(jg)
    tex = tgraph.GraphExecutor(tg, device="cpu")
    for targets in (NAMES, ("spectrogram",), ("filtered",)):
        jplan, jranges = jex._plan(offset, frames, jg.active_set(targets))
        tplan, tranges = tex._plan(offset, frames, tg.active_set(targets))
        assert {k: dataclasses.astuple(v) for k, v in tplan.items()} == \
            {k: dataclasses.astuple(v) for k, v in jplan.items()}
        assert tranges == jranges


def test_sticky_designs_equal_jax(recording):
    """Across a scrub, each FIR node's design is ``from_sos`` of its
    filter: the JAX package's sticky design's leading taps bit for bit
    (impulse and state responses), with equal ``zi0`` and ``padlen``; the
    halo follows its length."""
    jg = open_graph(jgraph, len(recording), port_lengths=False)
    tg = open_graph(tgraph, len(recording))
    for cutoff in (8000.0, 3000.0, 12000.0):
        jg["filtered"].update(lowpass_cutoff=cutoff)
        tg["filtered"].update(lowpass_cutoff=cutoff)
        for name in FIR_NODES:
            jd, td = jg[name].design, tg[name].design
            T = td.fir.length
            assert T == type(td).from_sos(td.sos).fir.length
            assert T <= jd.fir.length
            np.testing.assert_array_equal(td.fir.h, jd.fir.h[:T])
            np.testing.assert_array_equal(td.fir.state_out,
                                          jd.fir.state_out[:T])
            np.testing.assert_array_equal(td.zi0, jd.zi0)
            assert td.padlen == jd.padlen
            assert tg[name].taps == T
        assert tg["filtered"].halo_before == \
            tg["filtered"].design.fir.length / RATE
        env = tg["envelope"]
        assert env.halo_before == env.halo_after == \
            (env.design.fir.length + env.design.padlen) / RATE
    assert tg["spectrogram"].taps is None


def test_highpass_scrub_grows_and_shrinks_the_design(recording):
    """A high-pass scrub moves the filter's length both ways (the JAX
    budget only grows); the halos follow, and the filtered and envelope
    traces stay within 1e-5 of scipy's float64 ``sosfilt`` /
    ``sosfiltfilt`` at each length."""
    tg = open_graph(tgraph, len(recording))
    ex = tgraph.GraphExecutor(tg, device="cpu")
    x = recording.astype(np.float64)
    lengths = []
    for highpass in (2000.0, 100.0, 2000.0):
        tg["filtered"].update(highpass_cutoff=highpass)
        tg.refold()
        fd, ed = tg["filtered"].design, tg["envelope"].design
        lengths.append(fd.fir.length)
        assert tg["filtered"].halo_frames() == (fd.fir.length, 0)
        got = ex.run(recording, 0, pull=True)
        y = sps.sosfilt(fd.sos, x, axis=0)
        off, arr = got["filtered"]
        np.testing.assert_allclose(arr, y[off:off + len(arr)], atol=TOL)
        e = sps.sosfiltfilt(ed.sos, (np.pi / 2) * np.abs(y), axis=0,
                            padlen=ed.padlen)
        off, arr = got["envelope"]
        np.testing.assert_allclose(arr, np.maximum(e, 0)[off:off + len(arr)],
                                   atol=TOL)
    assert lengths[0] < lengths[1] and lengths[2] == lengths[0]


@pytest.mark.parametrize("name", NAMES)
def test_node_compute_matches_jax(recording, name):
    n = len(recording)
    jg, tg = open_graph(jgraph, n), open_graph(tgraph, n)
    jnode, tnode = jg[name], tg[name]
    x = recording.astype(np.float64)
    src = x if name == "filtered" else sps.sosfilt(
        jg["filtered"].design.sos, x, axis=0)
    g = jgraph.GraphExecutor(jg)._plan(0, n, jg.active_set([name]))[0][name]
    seg = src[g.rel_s0 : g.rel_s1]
    jparams = jnode.params()
    arrays = (np.asarray(jparams) if name == "spectrogram"
              else design_arrays(jparams))
    tparams = node_params_from_arrays(tnode, arrays, device="cpu")
    want = np.asarray(jnode.compute(seg, g.lead, g.n_out, jparams))
    got = tnode.compute(torch.from_numpy(seg.astype(np.float32)), g.lead,
                        g.n_out, tparams)
    assert got.dtype == torch.float32 and got.shape == want.shape
    check_close(name, got.numpy(), want)


def test_node_edge_rules():
    tg = open_graph(tgraph, 20000)
    x = torch.ones((10, 2))
    ident = tgraph.FilterNode("f", "data")
    ident.open(tgraph.TraceSpec(rate=RATE, channels=2, frames=20000))
    assert ident.params() is None      # pass-through until a cutoff is set
    assert torch.equal(ident.compute(x, 2, 5, None), x[2:7])
    env = tg["envelope"]
    p = node_params_from_arrays(env, design_arrays(env.design), "cpu")
    short = env.compute(x[: env.design.padlen], 0, 4, p)
    assert short.shape == (4, 2) and not short.any()
    spec = tg["spectrogram"]
    out = spec.compute(torch.ones((300, 2)), 0, 3,
                       node_params_from_arrays(spec, spec.params(), "cpu"))
    assert out.shape == (3, 2, 129) and out[0].any() and not out[1:].any()


def test_whole_run_matches_jax(recording):
    n = len(recording)
    jg, tg = open_graph(jgraph, n), open_graph(tgraph, n)
    want = jgraph.GraphExecutor(jg).run(recording.astype(np.float64), 0,
                                        device=False)
    got = tgraph.GraphExecutor(tg, device="cpu").run(recording, 0, pull=True)
    assert set(got) == set(want)
    for name in NAMES:
        assert got[name][0] == want[name][0]
        assert got[name][1].dtype == np.float32
        check_close(name, got[name][1], want[name][1])


def test_int16_chunk_is_dequantized_once(recording):
    tg = open_graph(tgraph, len(recording))
    ex = tgraph.GraphExecutor(tg, device="cpu")
    q = np.round(recording[:40000] * 16000).astype(np.int16)
    a = ex.run(torch.from_numpy(q), 0, pull=True)
    b = ex.run(q.astype(np.float32) / 32768.0, 0, pull=True)
    for name in ("data",) + NAMES:
        np.testing.assert_array_equal(a[name][1], b[name][1])


def run_chunked(g, x, chunk):
    """Chunks of ``chunk`` raw frames with the graph's halos, stitched
    (the interactive scroll path; mirrors tests/test_chunk_equivalence.py),
    each output frame taken from the first chunk that produced it."""
    ex = tgraph.GraphExecutor(g, device="cpu")
    hb, ha = (int(np.ceil(t * RATE)) for t in g.raw_halo)
    n = x.shape[0]
    results = {}
    for start in range(0, n, chunk):
        r0, r1 = max(start - hb, 0), min(start + chunk + ha, n)
        for name, (off, arr) in ex.run(x[r0:r1], r0, pull=True).items():
            first, parts = results.setdefault(name, (off, []))
            end = first + sum(len(p) for p in parts)
            assert off <= end, f"{name}: frames [{end}, {off}) missing"
            parts.append(arr[end - off:])
    return {name: (first, np.concatenate(parts))
            for name, (first, parts) in results.items()}


@pytest.mark.parametrize("chunk", [12000, 48000])
def test_chunked_equals_whole(recording, chunk):
    g = open_graph(tgraph, len(recording))
    whole = tgraph.GraphExecutor(g, device="cpu").run(recording, 0, pull=True)
    chunked = run_chunked(g, recording, chunk)
    for name in ("data",) + NAMES:
        (off_w, arr_w), (off_c, arr_c) = whole[name], chunked[name]
        assert off_c == off_w == 0
        assert arr_c.shape == arr_w.shape, name
        np.testing.assert_allclose(arr_c, arr_w, atol=TOL_CHUNKED,
                                   rtol=TOL_CHUNKED, err_msg=name)


def test_cutoff_scrub_adds_no_cache_entry(recording):
    tg = open_graph(tgraph, len(recording))
    ex = tgraph.GraphExecutor(tg, device="cpu")
    x = recording[:30000]
    first = ex.run(x, 0, pull=True)["filtered"][1]
    size = ex.cache_size
    assert size == 1
    for cutoff in (9000.0, 7000.0, 11000.0, 6000.0):
        tg["filtered"].update(lowpass_cutoff=cutoff)
        tg.refold()
        out = ex.run(x, 0, pull=True)["filtered"][1]
    assert ex.cache_size == size
    assert not np.allclose(out, first)
    ex.run(x[:20000], 0)                  # another geometry: one more entry
    assert ex.cache_size == size + 1


def test_executor_defaults_to_cuda(recording):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgraph.GraphExecutor(open_graph(tgraph, len(recording)))
