"""The port's public names and small API contracts against the JAX
package's: every subpackage's ``__all__``, ``load_wav(return_buffer=)``,
``ShardedPipeline(dtype=)``, ``GraphExecutor.run(device=)`` and the glibc
allocator tune at import.

Tolerances: the pipeline's filtered and envelope within 1e-5 absolute of
the JAX pipeline's, its PSD within 1e-4 relative (the same float32
arithmetic in another summation order); the graph's filtered and envelope
within 1e-5 of the JAX package's float64 run, its PSD within 1e-4
relative."""

import ctypes
import importlib

import jax
import numpy as np
import pytest
import torch

import audian_tpu.data.wavio as jwav
from audian_tpu import graph as jgraph
from audian_tpu.ops import FilterDesign as JDesign
from audian_tpu.ops import design_envelope_filter, design_filter
from audian_tpu.parallel import ShardedPipeline as JPipeline
from audian_tpu.parallel import make_mesh as jmake_mesh

import audian_torch
import audian_torch.data.wavio as twav
from audian_torch import graph as tgraph
from audian_torch.parallel import ShardedPipeline, make_mesh

RATE = 48000.0
TOL = 1e-5
TOL_PSD_RTOL = 1e-4

#: the subpackages of both packages (and the top level, "")
SUBPACKAGES = ("", "analysis", "app", "cache", "cli", "data", "graph",
               "gui", "models", "native", "ops", "parallel", "stream",
               "utils", "view")
#: JAX names the port leaves out on purpose: the JAX compilation cache and
#: the sharding specs of ``jax.sharding`` (the port's meshes are lists of
#: devices)
ABSENT = {"": {"enable_compilation_cache"},
          "parallel": {"P", "NamedSharding"}}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_namespace_has_every_jax_name(sub):
    """Every name of a JAX subpackage's ``__all__`` (less the deliberate
    absences) is in the port's ``__all__`` and importable from it."""
    suffix = "." + sub if sub else ""
    jmod = importlib.import_module("audian_tpu" + suffix)
    tmod = importlib.import_module("audian_torch" + suffix)
    want = set(getattr(jmod, "__all__", ())) - ABSENT.get(sub, set())
    assert want <= set(getattr(tmod, "__all__", ()))
    for name in want:
        assert hasattr(tmod, name), name


def test_top_level_version_names():
    from audian_tpu import version as jver

    assert audian_torch.__year__ == jver.__year__
    assert audian_torch.__version__
    assert audian_torch.audian_dirs.user_cache_path.name == "audian-torch"


@pytest.fixture(scope="module")
def pcm():
    rng = np.random.default_rng(3)
    return rng.integers(-20000, 20000, (4000, 3)).astype(np.int16)


def test_load_wav_return_buffer_matches_jax(tmp_path, pcm):
    """``return_buffer=True`` appends the file's bytes, as the JAX
    package's does; the first five elements are unchanged."""
    path = tmp_path / "x.wav"
    jwav.write_audio(path, pcm, RATE, encoding="PCM_16")
    got = twav.load_wav(path, return_buffer=True)
    want = jwav.load_wav(path, return_buffer=True)
    assert len(got) == len(want) == 6
    assert got[5] == want[5] == path.read_bytes()
    plain = twav.load_wav(path)
    assert len(plain) == 5
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_allclose(got[0], want[0], atol=0)
    assert got[1] == want[1]


def test_load_wav_return_buffer_refuses_other_containers(tmp_path, pcm):
    flac = tmp_path / "x.flac"
    jwav.write_audio(flac, pcm, RATE, encoding="PCM_16", format="FLAC")
    for mod in (twav, jwav):
        with pytest.raises(mod.WavError, match="requires WAV"):
            mod.load_wav(flac, return_buffer=True)


@pytest.fixture(scope="module")
def signal():
    rng = np.random.default_rng(5)
    n = 1 << 14
    t = np.arange(n) / RATE
    x = np.sin(2 * np.pi * 5000.0 * t) * (np.sin(2 * np.pi * 4.0 * t) > 0)
    x = x + 0.05 * rng.standard_normal(n)
    return np.stack([x, -0.5 * x], axis=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_pipeline_dtype_matches_jax(signal, dtype):
    """A float64 recording cast to the pipeline's ``dtype`` gives the JAX
    pipeline's result on the same mesh shape (float32), and the port's
    own result on the input rounded to bfloat16 (bfloat16)."""
    filt = JDesign.from_sos(design_filter(RATE, 1000.0, 8000.0))
    env = JDesign.from_sos(design_envelope_filter(RATE, 500.0))
    jp = JPipeline(jmake_mesh(devices=jax.devices()[:2], seq=2, ch=1), RATE,
                   filt=filt, env=env)
    arrays = {"rate": jp.rate, "h_filt": np.asarray(jp.filt.fir.h),
              "g_env": np.asarray(jp._env_sym[0]),
              "env_delay": jp._env_delay, "env_clamp": jp.env_clamp,
              "nfft": jp.nfft, "hop": jp.hop, "spectrogram": jp.with_spec,
              "minmax_step": jp.minmax_step}
    mesh = make_mesh(["cpu"] * 2, seq=2, ch=1)
    tdtype = getattr(torch, dtype)
    got = ShardedPipeline.from_arrays(mesh, arrays, dtype=tdtype)(signal)
    if dtype == "float32":
        want = {k: np.asarray(v) for k, v in jp(signal).items()}
    else:
        rounded = torch.from_numpy(signal).to(tdtype).float().numpy()
        want = {k: v.numpy() for k, v in ShardedPipeline.from_arrays(
            mesh, arrays)(rounded).items()}
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].numpy()
        assert g.dtype == np.float32 and g.shape == w.shape, key
        if key == "spectrogram":
            np.testing.assert_allclose(g, w, rtol=TOL_PSD_RTOL, atol=1e-9)
        else:
            np.testing.assert_allclose(g, w, atol=TOL, err_msg=key)


def test_sharded_pipeline_dtype_keyword():
    """``dtype=`` is a constructor keyword of both packages, float32 by
    default, and int16 input stays int16 whatever it is."""
    env = JDesign.from_sos(design_envelope_filter(RATE, 500.0))
    from audian_torch.ops.design import FilterDesign

    tenv = FilterDesign.from_sos(np.asarray(env.sos))
    mesh = make_mesh(["cpu"], seq=1, ch=1)
    assert ShardedPipeline(mesh, RATE, env=tenv).dtype == torch.float32
    tp = ShardedPipeline(mesh, RATE, env=tenv, spectrogram=False,
                         dtype=torch.float64)
    assert tp.dtype == torch.float64
    codes = (np.arange(4096 * 2).reshape(4096, 2) % 2000 - 1000).astype(
        np.int16)
    a = tp(codes)["filtered"]
    b = ShardedPipeline(mesh, RATE, env=tenv, spectrogram=False)(codes)[
        "filtered"]
    assert torch.equal(a, b)


def _graph(pkg, frames):
    g = pkg.TraceGraph([pkg.FilterNode("filtered", "data"),
                        pkg.EnvelopeNode("envelope", "filtered"),
                        pkg.SpectrogramNode("spectrogram", "filtered")])
    g.open(pkg.TraceSpec(rate=RATE, channels=2, frames=frames))
    g["filtered"].update(highpass_cutoff=2000.0, lowpass_cutoff=10000.0)
    g.refold()
    return g


def test_graph_executor_run_device_keyword_matches_jax(signal):
    """``run(..., device=False)`` pulls to numpy as the JAX package's does
    (and as ``pull=True``); ``device=True`` keeps tensors."""
    x = signal.astype(np.float32)
    n = len(x)
    want = jgraph.GraphExecutor(_graph(jgraph, n)).run(
        x.astype(np.float64), 0, device=False)
    ex = tgraph.GraphExecutor(_graph(tgraph, n), device="cpu")
    got = ex.run(x, 0, device=False)
    pulled = ex.run(x, 0, pull=True)
    kept = ex.run(x, 0, device=True, pull=True)
    assert set(got) == set(want)
    for name, (off, arr) in want.items():
        assert isinstance(got[name][1], np.ndarray)
        assert isinstance(kept[name][1], torch.Tensor)
        assert got[name][0] == off
        np.testing.assert_array_equal(got[name][1], pulled[name][1])
        if name == "spectrogram":
            np.testing.assert_allclose(got[name][1], arr, rtol=TOL_PSD_RTOL,
                                       atol=1e-12)
        elif name != "data":
            np.testing.assert_allclose(got[name][1], arr, atol=TOL)


def test_mallopt_tuned_once_at_import(monkeypatch):
    """Importing the package raises glibc's mmap and trim thresholds once
    (Linux), and a libc that cannot be loaded is ignored."""
    calls = []

    class FakeLibc:
        def mallopt(self, param, value):
            calls.append((param, value))
            return 1

    monkeypatch.setattr(ctypes, "CDLL", lambda name: FakeLibc())
    importlib.reload(audian_torch)
    assert calls == [(-3, 1 << 30), (-1, 1 << 30)]

    def broken(name):
        raise OSError("no libc")

    monkeypatch.setattr(ctypes, "CDLL", broken)
    importlib.reload(audian_torch)
    monkeypatch.setattr("sys.platform", "darwin")
    calls.clear()
    monkeypatch.setattr(ctypes, "CDLL", lambda name: FakeLibc())
    importlib.reload(audian_torch)
    assert calls == []
