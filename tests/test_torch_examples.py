"""The port's example twins (``examples_torch/``) against the JAX
package's examples (``examples/``) and package calls on the CPU.

- The plugin twins, each loaded through the port's ``Plugins`` from a
  launch directory of its own (both example plugins add a trace named
  ``envelope``, so in either package they cannot share one), against the
  JAX example loaded through the JAX ``Plugins``, both browsers on the
  same 1 s x 2 ch PCM-16 WAV at 8 kHz and the same region: every trace
  within 1e-5 absolute (the JAX side runs in float64 under the conftest),
  ``zerocrossings`` equal as counts, ``peaks`` at the same time and within
  1e-5.
- The batch twin's three modes with ``device="cpu"`` against
  ``FusedChainCF.chain_cf``, ``ShardedPipeline`` on a one-device mesh and
  ``detect`` of the JAX package on the same input: filtered and envelope
  within 1e-5 absolute, the PSD within 1e-4 relative (atol 1e-9), the
  onsets within 0.1 s.
- The launcher twin calls the port's ``audian`` with the JAX launcher's
  arguments; each twin imports with no ``jax`` and no ``audian_tpu``; the
  port's console scripts name callables of the port.

The recordings come from a module-scoped generator (seed 42), so they do
not depend on which test files ran before on the same worker.
"""

import importlib.util
import runpy
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audian_tpu import app as japp
from audian_tpu.analysis import Plugins as JPlugins
from audian_tpu.analysis.events import detect as jdetect
from audian_tpu.ops import FilterDesign as JDesign
from audian_tpu.ops import design_envelope_filter, design_filter
from audian_tpu.ops.fused import FusedChainCF as JaxChain
from audian_tpu.parallel import ShardedPipeline as JPipeline
from audian_tpu.parallel import make_mesh as jmake_mesh

from audian_torch import app as tapp
from audian_torch.analysis import Plugins as TPlugins
from audian_torch.data import wavio as twav
from audian_torch.ops.fused import FusedChainCF

REPO = Path(__file__).resolve().parents[1]
TWINS = REPO / "examples_torch"
PLUGINS = ("audianplugins", "audianexample")
TOL = 1e-5
TOL_PSD_RTOL = 1e-4
TOL_ONSET_S = 0.1
PLUGIN_RATE = 8000.0
REGION = (0.1, 0.6)
BATCH_SECONDS = 12.0     # two bursts of the batch recording
BATCH_CHUNK = 1 << 14    # frames of the fused chain's chunk


def load_twin(name):
    """The twin ``examples_torch/<name>.py`` as a module (not run as a
    script)."""
    spec = importlib.util.spec_from_file_location(
        f"twin_{name}", TWINS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="module")
def plugin_wav(tmp_path_factory, rng):
    """1 s x 2 ch at 8 kHz: a 440 Hz tone on channel 0, a 1 kHz one on
    channel 1, each over a little noise."""
    t = np.arange(int(PLUGIN_RATE)) / PLUGIN_RATE
    x = np.stack([0.2 * np.sin(2 * np.pi * 440.0 * t),
                  0.1 * np.sin(2 * np.pi * 1000.0 * t)], axis=1)
    x = x + 0.005 * rng.standard_normal(x.shape)
    p = tmp_path_factory.mktemp("twins") / "tone.wav"
    twav.write_audio(p, x, PLUGIN_RATE, encoding="PCM_16")
    return p


def open_plugin_browsers(tmp_path, name, wav):
    """The port's browser with the twin ``name`` and the JAX browser with
    the example ``name``, each plugin file loaded from its own launch
    directory."""
    out = []
    for src, plugins, app, extra in (
            (TWINS, TPlugins, tapp, {"device": "cpu"}),
            (REPO / "examples", JPlugins, japp, {})):
        d = tmp_path / f"{app.__name__}-{name}"
        d.mkdir()
        shutil.copy(src / f"{name}.py", d / f"{name}.py")
        pl = plugins()
        pl.load_plugins(d, verbose=False)
        out.append(app.DataBrowser(wav, plugins=pl, **extra).open())
    return out


def rows(b, name):
    return next(a for a in b.analyzers if a.name == name).data.rows


@pytest.mark.parametrize("channel", [0, 1])
@pytest.mark.parametrize("name", PLUGINS)
def test_plugin_twin_matches_jax(tmp_path, plugin_wav, name, channel):
    tb, jb = open_plugin_browsers(tmp_path, name, plugin_wav)
    try:
        assert list(tb.data.keys()) == list(jb.data.keys())
        assert ([a.name for a in tb.analyzers]
                == [a.name for a in jb.analyzers])
        got = tb.analyze(*REGION, channel)
        want = jb.analyze(*REGION, channel)
        assert "envelope" in got
        for trace in ("filtered", "envelope", "difference"):
            if trace not in want:
                continue
            (tt, ty), (jt, jy) = got[trace], want[trace]
            assert isinstance(ty, np.ndarray)
            np.testing.assert_array_equal(tt, np.asarray(jt))
            np.testing.assert_allclose(ty, np.asarray(jy), atol=TOL,
                                       err_msg=trace)
        if name == "audianplugins":
            assert rows(tb, "zerocrossings") == rows(jb, "zerocrossings")
            rate = rows(tb, "zerocrossings")[-1][-1]
            tone = (440.0, 1000.0)[channel]
            assert rate == pytest.approx(tone, rel=0.1)
        else:
            (t_t, t_v), (j_t, j_v) = (rows(tb, "peaks")[-1][-2:],
                                      rows(jb, "peaks")[-1][-2:])
            assert t_t == j_t
            assert t_v == pytest.approx(j_v, abs=TOL)
            # the largest sample of the region's filtered trace
            _t, y = got["filtered"]
            assert abs(t_v) == pytest.approx(float(np.abs(y).max()))
            # the difference trace is the first difference of filtered
            np.testing.assert_allclose(got["difference"][1][1:], np.diff(y),
                                       atol=1e-7)
    finally:
        tb.close()
        jb.close()


def test_difference_node_keeps_the_tensor_on_its_device():
    """The custom node computes with torch on the tensor it is handed: on
    a tensor with no data (the meta device) any pull to the host would
    raise."""
    node = load_twin("audianexample").DifferenceNode("difference",
                                                     "filtered")
    src = torch.empty((100, 2), device="meta")
    out = node.compute(src, 3, 50, None)
    assert out.device.type == "meta" and out.shape == (50, 2)
    x = torch.arange(20.0).reshape(10, 2) ** 2
    np.testing.assert_array_equal(
        node.compute(x, 2, 5, None).numpy(),
        np.diff(x.numpy(), axis=0, prepend=x.numpy()[:1])[2:7])


# -- the batch twin ------------------------------------------------------------


@pytest.fixture(scope="module")
def batch():
    return load_twin("batch_pipeline")


@pytest.fixture(scope="module")
def recording(batch):
    return batch.make_recording(BATCH_SECONDS, channels=2, seed=42)


def test_fused_single_chip_matches_jax(batch, recording):
    rate = batch.RATE
    y, e, s, stats = batch.fused_single_chip(recording, "cpu",
                                             chunk=BATCH_CHUNK)
    jc = JaxChain(rate, filt_sos=design_filter(rate, 2000.0, 10000.0),
                  env_sos=design_envelope_filter(rate, 500.0), nfft=256,
                  hop=128)
    ck = jc.chain_kernel
    ext = np.zeros((2, ck.hb + BATCH_CHUNK + ck.ha), np.float32)
    ext[:, ck.hb : ck.hb + BATCH_CHUNK] = recording[:BATCH_CHUNK].T
    jy, je, js, jst = jc.chain_cf(ext, BATCH_CHUNK, stats=True)
    assert y.device.type == "cpu" and y.shape == (2, BATCH_CHUNK)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js),
                               rtol=TOL_PSD_RTOL, atol=1e-9)
    np.testing.assert_allclose(stats["power"].numpy(),
                               np.asarray(jst["power"]), rtol=1e-5)


def test_sharded_whole_recording_matches_jax(batch, recording):
    rate = batch.RATE
    out = batch.sharded_whole_recording(recording, "cpu")
    jp = JPipeline(
        jmake_mesh(devices=jax.devices()[:1], seq=1), rate,
        filt=JDesign.from_sos(design_filter(rate, 2000.0, 10000.0)),
        env=JDesign.from_sos(design_envelope_filter(rate, 500.0)),
        minmax_step=512)
    want = jp(jnp.asarray(recording))
    assert set(out) == set(want) == {"filtered", "envelope", "spectrogram",
                                     "minmax"}
    for key, w in want.items():
        g, w = out[key].numpy(), np.asarray(w)
        assert g.shape == w.shape, key
        if key == "spectrogram":
            np.testing.assert_allclose(g, w, rtol=TOL_PSD_RTOL, atol=1e-9)
        else:
            np.testing.assert_allclose(g, w, atol=TOL, err_msg=key)


@pytest.fixture(scope="module")
def batch_wavs(tmp_path_factory, batch, recording):
    """Two recordings: the batch recording and its channels swapped, the
    second's bursts scaled down."""
    d = tmp_path_factory.mktemp("batch")
    paths = [d / "a.wav", d / "b.wav"]
    twav.write_audio(paths[0], recording, batch.RATE, encoding="PCM_16")
    twav.write_audio(paths[1], 0.5 * recording[:, ::-1], batch.RATE,
                     encoding="PCM_16")
    return [str(p) for p in paths]


def test_detect_directory_matches_jax(batch, batch_wavs, capsys):
    got = batch.detect_directory(batch_wavs, "cpu")
    assert [p for p, _ in got] == batch_wavs
    out = capsys.readouterr().out
    for path, onsets in got:
        assert f"{path}: onsets {onsets}" in out
        data, rate = twav.load_audio(path)
        want = jdetect(data, rate, highpassfreq=5500.0, lowpassfreq=7500.0,
                       envelopecutofffreq=100.0, minduration=0.5,
                       return_filtered=False)["onsets"]
        assert len(onsets) == len(want) == 2
        for g, w in zip(onsets, want):
            # both bursts found on the channel
            assert len(g) == len(w) == 2
            np.testing.assert_allclose(g, w, atol=TOL_ONSET_S)


def test_batch_main_runs_every_mode(batch, batch_wavs, recording,
                                    monkeypatch, capsys):
    monkeypatch.setattr(batch, "make_recording", lambda: recording)
    assert batch.main(["--device", "cpu", *batch_wavs]) == 0
    out = capsys.readouterr().out
    assert "fused chain: filtered (2, 1048576)" in out
    assert "sharded over 1 device(s)" in out
    assert all(f"{p}: onsets" in out for p in batch_wavs)


@pytest.mark.parametrize("mode", ["fused_single_chip",
                                  "sharded_whole_recording",
                                  "detect_directory"])
def test_batch_modes_raise_without_cuda(batch, batch_wavs, recording, mode,
                                        monkeypatch):
    """A mode given no device runs on CUDA and raises without it: no
    fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arg = batch_wavs if mode == "detect_directory" else recording
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(batch, mode)(arg)


def test_device_list(batch):
    cpu = torch.device("cpu")
    assert batch.device_list("cpu") == [cpu]
    assert batch.device_list(["cpu", "cpu"]) == [cpu, cpu]
    assert batch.device_list([cpu]) == [cpu]


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.float64])
def test_chain_cf_takes_host_arrays(dtype):
    """``chain_cf`` takes a numpy stream, as the JAX chain does (the batch
    example hands it one): the same outputs as from the tensor of the
    same values, int16 as PCM-16 codes and any float as float32."""
    rate = 48000.0
    kw = dict(filt_sos=design_filter(rate, 2000.0, 10000.0),
              env_sos=design_envelope_filter(rate, 500.0), nfft=256,
              hop=128)
    tc = FusedChainCF(rate, device="cpu", **kw)
    ck = tc.chain_kernel
    x = np.random.default_rng(3).standard_normal((2, ck.hb + 2048 + ck.ha))
    x = (np.round(x * 3000.0) if dtype == np.int16 else 0.1 * x).astype(
        dtype)
    got = tc.chain_cf(x, 2048, stats=True)
    ref = torch.from_numpy(x if dtype != np.float64 else
                           x.astype(np.float32))
    want = tc.chain_cf(ref, 2048, stats=True)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    jy = JaxChain(rate, **kw).chain_cf(x, 2048)[0]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jy), atol=TOL)


# -- the launcher, imports and console scripts ---------------------------------


def test_runaudian_calls_the_port_main(monkeypatch):
    import audian_torch.cli.audian as cli

    calls = []
    monkeypatch.setattr(cli, "main", lambda *a, **k: calls.append((a, k)))
    runpy.run_path(str(TWINS / "runaudian.py"), run_name="__main__")
    assert calls == [((["-f", "1000", "-l", "15000",
                        "data/recording.wav"],), {})]
    # the JAX launcher's arguments
    src = (REPO / "examples" / "runaudian.py").read_text()
    assert 'main(["-f", "1000", "-l", "15000", "data/recording.wav"])' in src


@pytest.mark.parametrize("name", [*PLUGINS, "batch_pipeline", "runaudian"])
def test_twin_imports_no_jax(name):
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('twin', "
        f"{str(TWINS / (name + '.py'))!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "bad = [k for k in sys.modules if k == 'jax'"
        " or k.startswith(('jax.', 'audian_tpu'))]\n"
        "assert not bad, bad\n"
        "assert any(k.startswith('audian_torch') for k in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def scripts():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


@pytest.mark.parametrize("script, target", [
    ("audian-torch", "audian_torch.cli.audian:run"),
    ("audian-torch-compress", "audian_torch.cli.compress:run"),
    ("audian-torch-songdetector", "audian_torch.cli.songdetector:run"),
])
def test_port_console_script(script, target):
    assert scripts()[script] == target
    module, func = target.split(":")
    assert callable(getattr(importlib.import_module(module), func))


def test_jax_console_scripts_unchanged():
    s = scripts()
    assert {k: v for k, v in s.items() if not k.startswith("audian-torch")} \
        == {"audian": "audian_tpu.cli.audian:run",
            "audian-compress": "audian_tpu.cli.compress:run",
            "audian-songdetector": "audian_tpu.cli.songdetector:run"}
