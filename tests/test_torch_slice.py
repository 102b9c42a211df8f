"""The port's slice end to end against the JAX package: a PCM-16 WAV read
in halo'd int16 chunks by audian_torch's reader and run through its
``chain_cf`` with stats, the ``entry()`` twin, the import boundary (no
jax, and no pandas, matplotlib or PyQt5 either), the no-fallback rules
of the kernel wrappers on a CPU-only host, and the default device of
every entry point (the CUDA card: without it a call that does not name
the CPU raises)."""

import functools
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax
import jax.numpy as jnp

import __graft_entry__
from audian_tpu.data import wavio as jwav
from audian_tpu.ops import design_envelope_filter, design_filter
from audian_tpu.ops.fused import FusedChainCF as JaxChain

from audian_torch.analysis import events
from audian_torch.app import Audian, DataBrowser, audian_cli
from audian_torch.cache import FullTraceData
from audian_torch.cli import songdetector
from audian_torch.convert import (ARRAY_KEYS, chain_from_arrays,
                                  envdet_from_arrays,
                                  node_params_from_arrays)
from audian_torch.data import AudioLoader, Data
from audian_torch.data import wavio as twav
from audian_torch.data.wavio import read_frames_raw16, wav_info
from audian_torch.entry import dryrun_multichip
from audian_torch.entry import entry as torch_entry
from audian_torch.graph import GraphExecutor, SpectrogramNode, TraceGraph
from audian_torch.models import get_preset
from audian_torch.ops import (minmax_decimate, minmax_pyramid,
                              prepare_playback, spectrogram_sweep)
from audian_torch.ops.stft import hann_window
from audian_torch.view.render import SpecTiler, TraceTiler
from audian_torch.ops.cuda.chain import ChainKernel, chain
from audian_torch.ops.cuda.envdet import EnvDetKernel
from audian_torch.ops.cuda.window_matmul import window_matmul
from audian_torch.ops.design import FilterDesign, filtfilt_sym_kernel
from audian_torch.ops.envdet import EnvDet
from audian_torch.ops.fused import FusedChainCF, design_arrays
from audian_torch.parallel import ShardedPipeline, make_mesh, sharded_band_env

REPO = Path(__file__).resolve().parents[1]
RATE = 48000.0


def test_wav_chunks_through_chain_match_jax(tmp_path):
    jc = JaxChain(RATE, filt_sos=design_filter(RATE, 1000.0, 8000.0),
                  env_sos=design_envelope_filter(RATE, 500.0), nfft=256,
                  hop=128, eps=1e-8)
    tc = chain_from_arrays({k: (None if getattr(jc, k) is None
                                else np.asarray(getattr(jc, k)))
                            for k in ARRAY_KEYS}, device="cpu")
    ck = tc.chain_kernel
    rng = np.random.default_rng(8)
    total, chunk = 10000, 4096
    t = np.arange(total) / RATE
    x = 0.4 * np.sin(2 * np.pi * 4000.0 * t)[:, None] * np.ones((1, 2))
    x += 0.05 * rng.standard_normal((total, 2))
    path = tmp_path / "slice.wav"
    jwav.write_audio(path, x, RATE, encoding="PCM_16")
    info = wav_info(path)
    assert info[:4] == (RATE, 2, total, "PCM_16")
    span = ck.hb + chunk + ck.ha
    power = np.zeros(2)
    for k in range(-(-total // chunk)):
        buf = np.zeros((span, 2), np.int16)
        start = k * chunk - ck.hb
        lo = max(start, 0)
        read_frames_raw16(path, lo, span - (lo - start), info,
                          buf[lo - start:])
        x_ext = np.ascontiguousarray(buf.T)
        n = min(chunk, total - k * chunk)
        got = tc.chain_cf(torch.from_numpy(x_ext), n, stats=True)
        want = jc.chain_cf(jnp.asarray(x_ext), n, stats=True)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=2e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=3e-6)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-4, atol=1e-9)
        for key in ("power", "env_sum", "psd_sum"):
            np.testing.assert_allclose(got[3][key].numpy(),
                                       np.asarray(want[3][key]),
                                       rtol=1e-5, atol=1e-9)
        assert all(bool(torch.isfinite(v).all()) for v in got[:3])
        power += got[3]["power"].numpy()
    assert np.all(power > 0)


def test_entry_twin_matches_graft_entry():
    fn, args = __graft_entry__.entry()
    want = jax.jit(fn)(*args)
    step, targs = torch_entry(device="cpu")
    np.testing.assert_array_equal(targs[0].numpy(), args[0])
    got = step(*targs)
    assert set(got) == set(want)
    for k in ("filtered", "envelope"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)
    np.testing.assert_allclose(got["spectrogram"].numpy(),
                               np.asarray(want["spectrogram"]), rtol=1e-4,
                               atol=1e-12)


def test_port_imports_no_jax():
    """Every module of the port imports without JAX (nor pandas,
    matplotlib, PyQt5, pyqtgraph), the native bindings, the FLAC codec,
    the compress CLI, the frontends, the ``audian`` CLI and the benchmark
    probes among them, and
    no import starts a process (a compiler run) or loads a kernel or
    native library."""
    code = (
        "import importlib, pkgutil, subprocess, sys\n"
        "import numpy, scipy.signal, torch\n"
        "def no_process(*a, **k):\n"
        "    raise AssertionError(f'process started at import: {a}')\n"
        "subprocess.run = subprocess.Popen = no_process\n"
        "import audian_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "audian_torch.__path__, 'audian_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'audian_torch.native', 'audian_torch.data.flac',"
        " 'audian_torch.cli.compress', 'audian_torch.app.screenshot',"
        " 'audian_torch.gui', 'audian_torch.gui.qt', 'audian_torch.gui.mpl',"
        " 'audian_torch.gui.songplot', 'audian_torch.cli.audian',"
        " 'audian_torch.parallel.pipeline', 'audian_torch.parallel.detect',"
        " 'audian_torch.parallel.batch', 'audian_torch.utils.trace',"
        " 'audian_torch.ops.envelope', 'audian_torch.ops.cuda.probes',"
        " 'audian_torch.probes.dma_floor', 'audian_torch.probes.call_scaling',"
        " 'audian_torch.probes.phase_restructure'}"
        " <= set(names), names\n"
        "from audian_torch import native\n"
        "from audian_torch.ops.cuda import _build\n"
        "assert native._lib is None and native._ffm is None\n"
        "assert not native._tried and not native._ffm_tried\n"
        "assert _build._lib is None\n"
        "bad = [k for k in sys.modules if k in ('jax', 'pandas',"
        " 'matplotlib', 'PyQt5', 'pyqtgraph') or k.startswith(('jax.',"
        " 'audian_tpu', 'pandas.', 'matplotlib.', 'PyQt5.',"
        " 'pyqtgraph.'))]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules"
        " if k.startswith('audian_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_launch_counters_stay_zero_on_cpu():
    fc = get_preset("bioacoustics").fused(96000.0, eps=2e-6, device="cpu")
    ck = fc.chain_kernel
    c0, w0 = chain.launches, window_matmul.launches
    assert (c0, w0) == (0, 0)
    x = torch.zeros((1, ck.hb + 1024 + ck.ha), dtype=torch.int16)
    fc.chain_cf(x, 1024, stats=True)
    fc(torch.zeros((1, 2048)))
    assert (chain.launches, window_matmul.launches) == (0, 0)


def test_no_cpu_fallback_for_other_devices():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedChainCF(RATE, filt_sos=design_filter(RATE, 1000.0, 8000.0),
                     device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_preset("bioacoustics").fused(96000.0, device="cuda")
    fc = get_preset("bioacoustics").fused(96000.0, eps=2e-6, device="cpu")
    meta = torch.zeros((1, 4096), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        chain(fc.chain_kernel, meta, 128)
    with pytest.raises(ValueError, match="cuda or cpu"):
        window_matmul(meta, fc.spec_w.to("meta"), 128, 4)


def _chain_arrays():
    return design_arrays(RATE, design_filter(RATE, 1000.0, 8000.0),
                         design_envelope_filter(RATE, 500.0))


def _envdet_designs():
    return (FilterDesign.from_sos(sps.butter(1, (1500.0, 3000.0), "bandpass",
                                             fs=8000.0, output="sos")),
            FilterDesign.from_sos(sps.butter(1, 900.0, "lowpass", fs=8000.0,
                                             output="sos")))


def _envdet_arrays():
    fd, ed = _envdet_designs()
    g_bp, d_bp = filtfilt_sym_kernel(fd.sos, pad_to=fd.fir.length)
    g_lp, d_lp = filtfilt_sym_kernel(ed.sos, pad_to=ed.fir.length)
    return dict(g_bp=g_bp, d_bp=d_bp, g_lp=g_lp, d_lp=d_lp, step=4,
                nout=64, hb=2048)


def _chain_kernel(device=None):
    a = _chain_arrays()
    return ChainKernel(RATE, a["_h_filt"], a["_g_env"], a["env_delay"],
                       a["spec_w"], 129, device=device)


_SIGNAL = np.zeros((20000, 1), np.float32)


@functools.lru_cache(maxsize=None)
def _wav():
    """A 0.5 s mono PCM-16 WAV for the entry points that read one."""
    path = Path(tempfile.mkdtemp()) / "entry.wav"
    twav.write_audio(path, _SIGNAL[:4000], 8000.0)
    return str(path)


@functools.lru_cache(maxsize=None)
def _wavs():
    """Two 0.5 s mono PCM-16 WAVs for ``-j``."""
    tmp = Path(tempfile.mkdtemp())
    for k in range(2):
        twav.write_audio(tmp / f"entry{k}.wav", _SIGNAL[:4000], 8000.0)
    return [str(tmp / f"entry{k}.wav") for k in range(2)]


def _mesh(d, seq=2, ch=1):
    """A mesh of ``seq * ch`` entries of ``d``; every CUDA device for
    ``d=None``."""
    return make_mesh(None if d is None else [d] * (seq * ch), seq=seq, ch=ch)


def _sharded_band_env(d):
    fd, ed = _envdet_designs()
    return sharded_band_env(_mesh(d), fd, ed, _SIGNAL, 4)


def _overview(d):
    ft = FullTraceData(AudioLoader(_wav()), device=d)
    ft.data.update_time(0.0, 0.5)
    ft.start(100)
    return ft

#: every entry point of the port, each called as ``fn(device)``
ENTRY_POINTS = {
    "FusedChainCF": lambda d: FusedChainCF(
        RATE, filt_sos=design_filter(RATE, 1000.0, 8000.0), device=d),
    "FusedChainCF.from_arrays": lambda d: FusedChainCF.from_arrays(
        _chain_arrays(), device=d),
    "ChainPreset.fused": lambda d: get_preset("bioacoustics").fused(
        96000.0, eps=2e-6, device=d),
    "chain_from_arrays": lambda d: chain_from_arrays(
        {k: _chain_arrays()[k] for k in ARRAY_KEYS}, device=d),
    "ChainKernel": _chain_kernel,
    "entry": lambda d: torch_entry(device=d),
    "EnvDet": lambda d: EnvDet(*_envdet_designs(), 4, 64, 2048, device=d),
    "EnvDetKernel": lambda d: EnvDetKernel(*_envdet_designs(), 4, 64, 2048,
                                           device=d),
    "envdet_from_arrays": lambda d: envdet_from_arrays(_envdet_arrays(),
                                                       device=d),
    "band_env": lambda d: events.band_env(_SIGNAL, 8000.0, 1500.0, 3000.0,
                                          100.0, device=d),
    "detect": lambda d: events.detect(_SIGNAL, 8000.0, device=d),
    "bandpass_filter": lambda d: events.bandpass_filter(_SIGNAL, 8000.0,
                                                        device=d),
    "square_envelope": lambda d: events.square_envelope(_SIGNAL, 8000.0,
                                                        device=d),
    "songdetector.main": lambda d: songdetector.main(["--mesh", "1"],
                                                     device=d),
    "Data": lambda d: Data("never-opened.wav", device=d),
    "GraphExecutor": lambda d: GraphExecutor(TraceGraph(), device=d),
    "TraceTiler": lambda d: TraceTiler(device=d),
    "SpecTiler": lambda d: SpecTiler(device=d),
    "minmax_decimate": lambda d: minmax_decimate(_SIGNAL, 16, device=d),
    "minmax_pyramid": lambda d: minmax_pyramid(_SIGNAL, 16, device=d),
    "spectrogram_sweep": lambda d: spectrogram_sweep(_SIGNAL, 8000.0,
                                                     (256,), device=d),
    "prepare_playback": lambda d: prepare_playback(_SIGNAL, 8000.0,
                                                   device=d),
    "node_params_from_arrays": lambda d: node_params_from_arrays(
        SpectrogramNode(), hann_window(256), device=d),
    "DataBrowser": lambda d: DataBrowser(_wav(), device=d).open().close(),
    "Audian": lambda d: Audian([_wav()], device=d).load_files(),
    "audian_cli": lambda d: audian_cli(["-f", "500", _wav()],
                                       device=d).load_files(),
    "FullTraceData": _overview,
    "ChainPreset.sharded": lambda d: get_preset("bioacoustics").sharded(
        _mesh(d), 96000.0, minmax_step=128)(_SIGNAL),
    "ShardedPipeline": lambda d: ShardedPipeline(
        _mesh(d, 1, 2), RATE, filt=_envdet_designs()[0])(
            np.zeros((4096, 3), np.float32)),
    "sharded_band_env": _sharded_band_env,
    "map_files": lambda d: songdetector.main(["-j", "2", *_wavs()],
                                             device=d),
    "dryrun_multichip": lambda d: dryrun_multichip(2, device=d),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_cuda(name):
    """Called without a device, an entry point runs on the CUDA card; a
    host without CUDA raises RuntimeError naming CUDA and never carries on
    on the CPU.  Naming the CPU runs the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    fn = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(None)
    if name == "songdetector.main":
        with pytest.raises(SystemExit):     # no input files
            fn("cpu")
    else:
        fn("cpu")
