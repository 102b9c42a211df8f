"""audian_torch's multi-device paths against the JAX package's on the CPU:
the halo exchange (JAX's in ``shard_map`` over the conftest's 8 virtual
CPU devices, the port's over ``["cpu"] * n``), the sharded pipeline built
from the JAX pipeline's own arrays, sequence-sharded detect, the file
batch, ``ChainPreset.sharded`` and the multi-device dry run.

Tolerances: the halo exchange exact; the pipeline's filtered, envelope and
min/max within 1e-5 absolute of the JAX pipeline's (the same float32 FIR
and symmetric-kernel arithmetic in another summation order), its PSD
within 1e-4 relative (atol 1e-9); the detect envelope within 1e-5 of its
scale (the port's shards run the decimating envelope of symmetric
kernels, the JAX package's two ``sosfiltfilt_fir`` passes)."""

import sys
import threading

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax
from jax.sharding import PartitionSpec as P

from audian_tpu.analysis import events as jev
from audian_tpu.models import get_preset as jget_preset
from audian_tpu.ops import FilterDesign as JDesign
from audian_tpu.ops import design_envelope_filter, design_filter
from audian_tpu.parallel import ShardedPipeline as JPipeline
from audian_tpu.parallel import detect as jdetect
from audian_tpu.parallel import halo_exchange as jhalo
from audian_tpu.parallel import make_mesh as jmake_mesh

from audian_torch.analysis import events as tev
from audian_torch.convert import SHARDED_KEYS, sharded_pipeline_from_arrays
from audian_torch.entry import dryrun_multichip
from audian_torch.models import get_preset
from audian_torch.ops.cuda import _build
from audian_torch.ops.design import FilterDesign
from audian_torch.parallel import (ShardedPipeline, halo_exchange,
                                   halo_window, make_mesh, map_files,
                                   sharded_band_env)
from audian_torch.parallel import detect as tdetect

RATE = 48000.0
TOL = 1e-5
TOL_PSD_RTOL = 1e-4
TOL_DETECT = 1e-5


def jmesh(seq, ch=1):
    return jmake_mesh(devices=jax.devices()[: seq * ch], seq=seq, ch=ch)


def cpu_mesh(seq, ch=1):
    return make_mesh(["cpu"] * (seq * ch), seq=seq, ch=ch)


@pytest.fixture(scope="module")
def signal():
    """3 channels (odd, so a ch=2 mesh pads one) of gated tones over noise;
    the length is no multiple of the minmax step (a ragged tail)."""
    rng = np.random.default_rng(5)
    n = (1 << 15) + 333
    t = np.arange(n) / RATE
    x = np.sin(2 * np.pi * 5000.0 * t) * (np.sin(2 * np.pi * 4.0 * t) > 0)
    x = x + 0.05 * rng.standard_normal(n)
    return np.stack([x, 0.5 * x, -0.8 * x], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def designs():
    return (JDesign.from_sos(design_filter(RATE, 1000.0, 8000.0)),
            JDesign.from_sos(design_envelope_filter(RATE, 500.0)))


def pipeline_arrays(jp):
    """The JAX pipeline's own numpy state, as the port rebuilds it."""
    return {"rate": jp.rate,
            "h_filt": None if jp.filt is None else np.asarray(jp.filt.fir.h),
            "g_env": None if jp._env_sym is None
            else np.asarray(jp._env_sym[0]),
            "env_delay": jp._env_delay, "env_clamp": jp.env_clamp,
            "nfft": jp.nfft, "hop": jp.hop, "spectrogram": jp.with_spec,
            "minmax_step": jp.minmax_step}


def assert_outputs_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].cpu().numpy()
        assert g.shape == w.shape, key
        if key == "spectrogram":
            np.testing.assert_allclose(g, w, rtol=TOL_PSD_RTOL, atol=1e-9)
        else:
            np.testing.assert_allclose(g, w, atol=TOL, err_msg=key)


# -- the halo exchange ---------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_halo_exchange_equals_jax(dtype):
    n, b, a = 64, 5, 3
    x = np.arange(8 * n * 2).reshape(8 * n, 2).astype(dtype)
    fn = jax.jit(jax.shard_map(
        lambda xs: jhalo(xs, b, a, "seq"), mesh=jmesh(8),
        in_specs=P("seq", None), out_specs=P("seq", None)))
    want = np.asarray(fn(x)).reshape(8, n + b + a, 2)
    got = halo_exchange([torch.from_numpy(x[i * n : (i + 1) * n])
                         for i in range(8)], b, a)
    assert all(g.dtype == torch.from_numpy(x).dtype for g in got)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_halo_window_equals_the_exchange(dtype):
    """A shard's extended window sliced from the whole recording equals
    the exchange over the zero-padded recording's shards, exactly, from
    numpy and from a tensor; channels past the recording's are zeros."""
    n, b, a, nseq = 64, 5, 3, 4
    x = np.arange(3 * n * 3).reshape(3 * n, 3).astype(dtype) + 1
    padded = np.concatenate([x, np.zeros((nseq * n - len(x), 3), dtype)])
    want = halo_exchange([torch.from_numpy(padded[i * n : (i + 1) * n])
                          for i in range(nseq)], b, a)
    for src in (x, torch.from_numpy(x)):
        for i in range(nseq):
            got = halo_window(src, i * n - b, b + n + a, "cpu")
            assert got.dtype == want[i].dtype
            np.testing.assert_array_equal(got.numpy(), want[i].numpy())
        got = halo_window(src, n - b, b + n + a, "cpu", c0=2, width=2)
        np.testing.assert_array_equal(got[:, 0].numpy(), want[1][:, 2])
        assert not got[:, 1].any()


def test_halo_longer_than_a_shard_raises():
    with pytest.raises(ValueError, match="halo"):
        halo_exchange([torch.zeros((16, 1))] * 8, 64, 0)
    sos = design_filter(96000.0, 2000.0, 40000.0)
    jp = JPipeline(jmesh(8), 96000.0, filt=JDesign.from_sos(sos), env=None,
                   spectrogram=False)
    tp = ShardedPipeline(cpu_mesh(8), 96000.0,
                         filt=FilterDesign.from_sos(sos), env=None,
                         spectrogram=False)
    x = np.zeros((8 * 64, 1), np.float32)
    with pytest.raises(ValueError) as want:
        jp(x)
    with pytest.raises(ValueError) as got:
        tp(x)
    assert str(got.value) == str(want.value)


# -- the sharded pipeline --------------------------------------------------------


@pytest.mark.parametrize("seq,ch", [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1),
                                    (4, 2), (8, 1), (8, 2)])
def test_sharded_pipeline_equals_jax(signal, designs, seq, ch):
    """Over every mesh shape (the JAX side has 8 devices: its 8 x 2 case
    runs on 8 x 1, which gives the same outputs)."""
    filt, env = designs
    jp = JPipeline(jmesh(seq, ch if seq * ch <= 8 else 1), RATE, filt=filt,
                   env=env, nfft=256, minmax_step=500)
    tp = sharded_pipeline_from_arrays(pipeline_arrays(jp), (seq, ch),
                                      device="cpu")
    assert (tp.hb, tp.ha, tp.align) == (jp.hb, jp.ha, jp.align)
    assert tp.padded_length(len(signal)) == jp.padded_length(len(signal))
    # this design passes the chain kernel's gate
    assert tp.chain(torch.device("cpu")).chain_kernel is not None
    x = signal if seq % 2 else np.clip(np.round(signal * 32768), -32768,
                                       32767).astype(np.int16)
    assert_outputs_equal(tp(x), jp(x))


@pytest.mark.parametrize("nfft,hop,spec,step", [(64, 32, True, 64),
                                                (512, None, True, 64),
                                                (256, None, False, 32)])
def test_sharded_pipeline_per_stage_equals_jax(signal, designs, nfft, hop,
                                               spec, step):
    """Geometries the chain kernel refuses (hop != 128) run per stage.
    Halos on a 32-frame grid that fall short of the kernel's (hop 128, no
    spectrogram) take the kernel all the same: the shards read the
    chain's own halos from the recording."""
    filt, env = designs
    jp = JPipeline(jmesh(4, 2), RATE, filt=filt, env=env, nfft=nfft,
                   hop=hop, spectrogram=spec, minmax_step=step)
    tp = sharded_pipeline_from_arrays(pipeline_arrays(jp), (4, 2),
                                      device="cpu")
    fc = tp.chain(torch.device("cpu"))
    assert (fc.chain_kernel is not None) == (tp.hop == 128)
    if fc.chain_kernel is not None:
        assert tp.hb < fc.hb or tp.ha < fc.ha
    assert_outputs_equal(tp(signal), jp(signal))


@pytest.mark.parametrize("hop", [32, 128])
def test_shard_chunks_run_through_chain_cf(signal, designs, hop,
                                           monkeypatch):
    """Every chunk of every shard is one ``chain_cf`` call over the
    chain's own halos, on the per-stage route (hop 32) as on the kernel's
    (hop 128)."""
    from audian_torch.ops.fused import FusedChainCF
    from audian_torch.parallel import pipeline as tpipe

    filt, env = designs
    jp = JPipeline(jmesh(2, 2), RATE, filt=filt, env=env, nfft=256,
                   hop=hop, minmax_step=64)
    monkeypatch.setattr(tpipe, "CHUNK", 4096)
    tp = sharded_pipeline_from_arrays(pipeline_arrays(jp), (2, 2),
                                      device="cpu")
    fc = tp.chain(torch.device("cpu"))
    assert (fc.chain_kernel is None) == (hop == 32)
    real, calls = FusedChainCF.chain_cf, []

    def chain_cf(self, x_ext, n, *args, **kwargs):
        calls.append((x_ext.shape[1], n))
        return real(self, x_ext, n, *args, **kwargs)

    monkeypatch.setattr(FusedChainCF, "chain_cf", chain_cf)
    got = tp(signal)
    L = tp.padded_length(len(signal)) // 2
    chunks = [min(tp.chunk, L - s) for s in range(0, L, tp.chunk)]
    assert len(chunks) > 1
    # two seq shards in each of two channel groups
    assert calls == [(fc.hb + k + fc.ha, k) for k in chunks] * 4
    assert_outputs_equal(got, jp(signal))


def test_sharded_pipeline_without_designs_and_short_clips(signal, designs):
    """No filter and no envelope (the raw trace's spectrogram), and a clip
    shorter than the halos on one ``seq`` shard (zero-padded locally)."""
    jp = JPipeline(jmesh(8), RATE, filt=None, env=None, nfft=512)
    tp = sharded_pipeline_from_arrays(pipeline_arrays(jp), (8, 1),
                                      device="cpu")
    assert_outputs_equal(tp(signal), jp(signal))
    filt, env = designs
    jp = JPipeline(jmesh(1), RATE, filt=filt, env=env, minmax_step=256)
    tp = sharded_pipeline_from_arrays(pipeline_arrays(jp), (1, 1),
                                      device="cpu")
    short = signal[:700]
    assert 700 < tp.hb
    assert_outputs_equal(tp(short), jp(short))


def test_sharded_pipeline_chunks_a_shard(signal, designs, monkeypatch):
    """A shard longer than the chunk runs in chunks: the same outputs."""
    from audian_torch.parallel import pipeline as tpipe

    filt, env = designs
    jp = JPipeline(jmesh(2), RATE, filt=filt, env=env, minmax_step=500)
    want = jp(signal)
    monkeypatch.setattr(tpipe, "CHUNK", 4096)
    tp = sharded_pipeline_from_arrays(pipeline_arrays(jp), (2, 1),
                                      device="cpu")
    assert tp.chunk < tp.padded_length(len(signal)) // 2
    assert_outputs_equal(tp(signal), want)


@pytest.mark.parametrize("name", ["bioacoustics", "browser"])
def test_chain_preset_sharded_equals_jax(signal, name):
    rate = 96000.0
    jp = jget_preset(name).sharded(jmesh(2), rate, minmax_step=128)
    tp = get_preset(name).sharded(cpu_mesh(2), rate, minmax_step=128)
    assert (tp.hb, tp.ha, tp.hop, tp.nfft) == (jp.hb, jp.ha, jp.hop, jp.nfft)
    assert_outputs_equal(tp(signal), jp(signal))


def test_sharded_pipeline_arrays_are_complete(designs):
    filt, env = designs
    jp = JPipeline(jmesh(1), RATE, filt=filt, env=env)
    arrays = pipeline_arrays(jp)
    assert set(arrays) == set(SHARDED_KEYS)
    with pytest.raises(KeyError, match="h_filt"):
        sharded_pipeline_from_arrays(
            {k: v for k, v in arrays.items() if k != "h_filt"}, (1, 1),
            device="cpu")


# -- sequence-sharded detect ----------------------------------------------------


@pytest.fixture
def fresh_budgets(monkeypatch):
    for mod in (jev, tev):
        monkeypatch.setattr(mod, "_KERNEL_BUDGET", {"filt": 0, "env": 0})


def detect_signal(rng, n, rate, channels):
    t = np.arange(n) / rate
    tone = 0.4 * np.sin(2 * np.pi * 6500.0 * t) * (
        np.sin(2 * np.pi * 2.0 * t) > 0)
    x = tone[:, None] + 0.05 * rng.standard_normal((n, channels))
    return np.clip(np.round(x * 32768), -32768, 32767)


def relative_error(got, want):
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))


@pytest.mark.parametrize("dtype,channels,seq", [(np.int16, 3, 8),
                                                (np.float32, 2, 4)])
def test_sharded_band_env_equals_jax_and_chunked(fresh_budgets, dtype,
                                                 channels, seq):
    rate = 96000.0
    n = (1 << 19) + 4321
    q = detect_signal(np.random.default_rng(seq), n, rate, channels)
    x = q.astype(np.int16) if dtype == np.int16 else \
        (q / 32768.0).astype(np.float32)
    args = (rate, 1000.0, 10000.0, 500.0)
    _f, want, er = jev.band_env(x, *args, return_filtered=False,
                                mesh=jmesh(seq))
    _f, chunked, er2 = tev.band_env(x, *args, return_filtered=False,
                                    device="cpu")
    _f, got, er3 = tev.band_env(x, *args, return_filtered=False,
                                mesh=cpu_mesh(seq), device="cpu")
    assert er == er2 == er3
    assert got.shape == np.asarray(want).shape == chunked.shape
    assert relative_error(got, np.asarray(want)) < TOL_DETECT
    assert relative_error(got, chunked) < TOL_DETECT


def test_sharded_band_env_buckets_its_shapes(fresh_budgets):
    """Recording lengths in one quarter-pow2 bucket share one envelope
    object; the cache keeps at most 33 and evicts the oldest."""
    tdetect._ENVDETS.clear()
    rng = np.random.default_rng(3)
    rate = 96000.0
    for extra in (0, 7777, 15000):
        n = (1 << 19) + extra
        x = (0.1 * rng.standard_normal((n, 1))).astype(np.float32)
        _f, env, _r = tev.band_env(x, rate, 1000.0, 10000.0, 500.0,
                                   return_filtered=False, mesh=cpu_mesh(8),
                                   device="cpu")
        assert len(env) == -(-n // 19)
    assert len(tdetect._ENVDETS) == 1
    assert [tdetect._bucket_blocks(b) for b in (3, 5, 9, 100, 1000)] == [
        jdetect._bucket_blocks(b) for b in (3, 5, 9, 100, 1000)]
    (key, ed0), = tdetect._ENVDETS.items()
    fd, ed = (FilterDesign.from_sos(sps.butter(1, band, kind, fs=rate,
                                               output="sos"))
              for band, kind in (((1000.0, 10000.0), "bandpass"),
                                 (500.0, "lowpass")))
    for k in range(40):
        tdetect._envdet(torch.device("cpu"), 19 * (64 + k), 4096, 19, fd, ed)
    assert len(tdetect._ENVDETS) == 33 and key not in tdetect._ENVDETS
    assert tdetect._envdet(torch.device("cpu"), 19 * (64 + 39), 4096, 19,
                           fd, ed) is list(tdetect._ENVDETS.values())[-1]


def test_sharded_band_env_short_recording_falls_back():
    """Below the shardable size the mesh path declines (as the JAX
    package's does) and the chunked driver serves the call."""
    rng = np.random.default_rng(4)
    x = (0.1 * rng.standard_normal((20000, 2))).astype(np.float32)
    fd = FilterDesign.from_sos(sps.butter(1, (1000.0, 10000.0), "bandpass",
                                          fs=48000.0, output="sos"))
    ed = FilterDesign.from_sos(sps.butter(1, 500.0, "lowpass", fs=48000.0,
                                          output="sos"))
    assert sharded_band_env(cpu_mesh(8), fd, ed, x, 10) is None
    assert jdetect.sharded_band_env(jmesh(8), fd, ed, x, 10) is None
    assert sharded_band_env(cpu_mesh(1), fd, ed, x, 10) is None
    _f, ref, _r = tev.band_env(x, 48000.0, 1000.0, 10000.0, 500.0,
                               return_filtered=False, device="cpu")
    _f, got, _r = tev.band_env(x, 48000.0, 1000.0, 10000.0, 500.0,
                               return_filtered=False, mesh=cpu_mesh(8),
                               device="cpu")
    np.testing.assert_array_equal(got, ref)


def test_detect_on_a_mesh_equals_jax(fresh_budgets):
    rate = 96000.0
    x = detect_signal(np.random.default_rng(6), 1 << 19, rate,
                      2).astype(np.int16)
    want = jev.detect(x, rate, return_filtered=False, mesh=jmesh(4))
    got = tev.detect(x, rate, return_filtered=False, mesh=cpu_mesh(4),
                     device="cpu")
    assert got["filtered"] is None
    for c in range(2):
        np.testing.assert_allclose(got["onsets"][c], want["onsets"][c],
                                   atol=1.0 / got["envrate"])
        np.testing.assert_allclose(got["offsets"][c], want["offsets"][c],
                                   atol=1.0 / got["envrate"])


# -- the file batch ---------------------------------------------------------------


def test_map_files_keeps_the_order_and_spreads_the_work():
    files = [f"f{i}" for i in range(13)]
    threads = set()
    # the first two files wait for each other, so that two workers must
    # hold them at once: an idle worker would otherwise take every file
    meet = threading.Barrier(2, timeout=60)

    def fn(path):
        threads.add(threading.get_ident())
        if path in ("f0", "f1"):
            meet.wait()
        return float(torch.full((256,), int(path[1:])).sum() * 2.0)

    assert map_files(fn, files, devices=["cpu"] * 4) == [
        i * 512.0 for i in range(13)]
    assert len(threads) > 1


def test_map_files_gathers_failures():
    ran = []

    def fn(path):
        ran.append(path)
        if path in ("bad", "worse"):
            raise ValueError(f"boom {path}")
        return path

    for workers in (1, None):
        ran.clear()
        with pytest.raises(ValueError, match="boom bad"):
            map_files(fn, ["a", "bad", "c", "worse", "d"],
                      devices=["cpu"] * 3, max_workers=workers)
        assert sorted(ran) == ["a", "bad", "c", "d", "worse"]
    assert map_files(fn, ["a", "b"], devices=["cpu"], max_workers=1) == [
        "a", "b"]


def test_map_files_returned_exception_is_a_result():
    err = ValueError("report, not failure")

    def fn(path):
        return err if path == "b" else path

    for workers in (1, None):
        got = map_files(fn, ["a", "b", "c"], devices=["cpu"] * 2,
                        max_workers=workers)
        assert got == ["a", err, "c"]
    assert map_files(fn, [], devices=["cpu"]) == []


def test_launch_counts_survive_threads():
    """The wrappers' launch counters are shared by map_files' workers: no
    increment is lost under heavy switching."""

    def wrapper():
        pass

    wrapper.launches = 0
    nthreads, each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [_build.count_launch(wrapper)
                            for _ in range(each)]) for _ in range(nthreads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == nthreads * each


# -- meshes and the dry run ----------------------------------------------------------


def test_make_mesh_as_jax():
    m = make_mesh(["cpu"] * 8, ch=2)
    j = jmake_mesh(ch=2)
    assert m.shape == dict(j.shape)
    assert m.axis_names == tuple(j.axis_names)
    assert m.devices.shape == j.devices.shape
    for args in ({"seq": 3, "ch": 2}, {"seq": 2, "ch": 2}):
        with pytest.raises(ValueError) as want:
            jmake_mesh(**args)
        with pytest.raises(ValueError) as got:
            make_mesh(["cpu"] * 8, **args)
        assert str(got.value) == str(want.value)


def test_dryrun_multichip_on_the_cpu():
    dryrun_multichip(4, device="cpu")


# -- Data over a mesh ---------------------------------------------------------------


def test_data_on_a_mesh_equals_the_unsharded_session(tmp_path):
    """Data(mesh=) holds each window as channel groups and serves what the
    unsharded session serves through slides (the delta path), a filter
    update and a trace shown again after an update while hidden; a
    channel count the ch axis does not divide stays unsharded (1e-6: the
    same float32 ops on fewer channels a call)."""
    from audian_torch.data import Data, wavio
    from audian_torch.graph import EnvelopeNode, FilterNode, SpectrogramNode
    from audian_torch.parallel import ChannelShards

    rate = 48000.0
    rng = np.random.default_rng(8)
    t = np.arange(int(6 * rate))[:, None] / rate
    x = 0.4 * np.sin(2 * np.pi * (3000.0 + 900.0 * np.arange(4)) * t) \
        + 0.03 * rng.standard_normal((len(t), 4))
    path = tmp_path / "four.wav"
    wavio.write_audio(path, x, rate, encoding="PCM_16")

    def session(**kw):
        d = Data(path, buffer_time=2.0, back_time=0.5, **kw)
        for node in (FilterNode("filtered", "data"),
                     EnvelopeNode("envelope", "filtered",
                                  envelope_cutoff=1500.0),
                     SpectrogramNode("spectrogram", "filtered")):
            d.add_trace(node)
        return d.open()

    dm, d1 = session(mesh=cpu_mesh(1, 2)), session(device="cpu")
    d3 = session(mesh=cpu_mesh(1, 3))
    try:
        assert d3._groups is None
        stitched = []
        delta = dm._try_delta_update
        dm._try_delta_update = lambda *a: stitched.append(delta(*a)) or \
            stitched[-1]
        moves = [lambda d, t0=t0: d.update_times(t0, t0 + 1.0)
                 for t0 in (0.0, 0.25, 0.75, 1.0, 3.0)]
        moves += [lambda d: d["filtered"].update(highpass_cutoff=2000.0),
                  lambda d: d.set_visible("envelope", False),
                  lambda d: d["filtered"].update(lowpass_cutoff=9000.0),
                  lambda d: d.update_times(2.5, 3.5),
                  lambda d: d.set_visible("envelope", True)]
        for move in moves:
            for d in (dm, d1):
                move(d)
            for name in ("data", "filtered", "envelope", "spectrogram"):
                a, b = dm[name], d1[name]
                assert isinstance(a.buffer, ChannelShards)
                assert [p.shape[1] for p in a.buffer.parts] == [2, 2]
                assert getattr(a, "offset", 0) == getattr(b, "offset", 0)
                np.testing.assert_allclose(a.buffer.cpu().numpy(),
                                           b.buffer.numpy(), atol=1e-6,
                                           err_msg=name)
            np.testing.assert_allclose(dm["envelope"][1000:3000, 3],
                                       d1["envelope"][1000:3000, 3],
                                       atol=1e-6)
        assert True in stitched          # the scroll's delta path ran
    finally:
        for d in (dm, d1, d3):
            d.close()
