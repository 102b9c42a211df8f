"""Forward step of the flagship chain on the port's per-op path, and the
multi-device dry run.

``entry()`` returns ``(step, example_args)``: the causal band-pass
(``sosfilt_fir``), the pi/2-rectified zero-phase envelope
(``sosfiltfilt_fir``, clamped at zero) and the Hann PSD spectrogram of a
time-first ``(n, channels)`` signal — the same step as the JAX package's
``__graft_entry__.entry()``.  ``dryrun_multichip(n)`` is the twin of
``__graft_entry__.dryrun_multichip``: the sharded pipeline, the
per-device batch, a meshed browser and sharded detect over an
``n``-entry mesh, each against its single-device run.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops.design import FilterDesign, design_envelope_filter, design_filter
from .ops.sos import sosfilt_fir, sosfiltfilt_fir
from .ops.stft import hann_window, spectrogram
from .utils import resolve_device

__all__ = ["RATE", "dryrun_multichip", "entry"]

RATE = 96000.0


def _designs():
    filt = FilterDesign.from_sos(design_filter(RATE, 2000.0, 40000.0))
    env = FilterDesign.from_sos(design_envelope_filter(RATE, 500.0))
    return filt, env


def entry(device=None):
    """(fn, example_args) — the forward step and a 2-channel 30 kHz tone
    of 2^15 samples on ``device`` (the CUDA card by default; "cpu" runs
    on the host)."""
    device = resolve_device(device)
    nfft, hop = 256, 128
    window = hann_window(nfft)

    def step(x, filt, env):
        y = sosfilt_fir(filt.fir, x, axis=0, return_zf=False)
        rect = (math.pi / 2) * torch.abs(y)
        e = torch.clamp_min(
            sosfiltfilt_fir(env.fir, rect, env.zi0, env.padlen, axis=0), 0.0)
        s = spectrogram(y, RATE, nfft, hop, window=window)
        return {"filtered": y, "envelope": e, "spectrogram": s}

    filt, env = _designs()
    n = 1 << 15
    t = np.arange(n, dtype=np.float32) / RATE
    x = np.stack([np.sin(2 * np.pi * 30000.0 * t)] * 2, axis=1)
    x = torch.from_numpy(x.astype(np.float32)).to(device)
    return step, (x, filt, env)


def dryrun_multichip(n_devices, device=None):
    """Run the multi-device paths over an ``n_devices``-entry mesh and hold
    each against its single-device run, at the JAX dry run's tolerances;
    an ``AssertionError`` names the first that disagrees.

    The mesh's entries go round the available devices: on a machine with
    one card it is ``n_devices`` times that card; ``device="cpu"`` makes
    it ``n_devices`` times the CPU (the plain versions).

    1. the sharded pipeline (sequence and channel sharding with the halo
       exchange; NFFT 64, hop 32: the per-stage path) against the same
       pipeline on a ``seq=1`` mesh, 1e-5 (spectrogram 1e-4 relative);
    2. the per-device batch: copies of one clip through ``map_files``, one
       a mesh entry, each against the clip run once unsharded, 1e-5;
    3. a ``DataBrowser`` channel-sharded over the mesh against a
       single-device one: reads 1e-5, trace tiles 1e-4;
    4. sequence-sharded detect (``band_env(..., mesh=)``) against the
       chunked driver, 1e-5 of the envelope's scale.
    """
    import tempfile
    from pathlib import Path

    from .analysis import events
    from .app import DataBrowser
    from .data import wavio
    from .parallel import (ShardedPipeline, local_devices, make_mesh,
                           map_files)

    device = resolve_device(device)
    avail = local_devices(device)
    devices = [avail[i % len(avail)] for i in range(n_devices)]
    ch = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(devices, seq=n_devices // ch, ch=ch)
    filt, env = _designs()
    pipe = ShardedPipeline(mesh, RATE, filt=filt, env=env, nfft=64, hop=32,
                           minmax_step=64)
    channels = 2 * ch
    n = pipe.padded_length((n_devices // ch) * 8192)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / RATE
    x = np.stack([np.sin(2 * np.pi * 30000.0 * t)] * channels, axis=1)
    x = (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    out = pipe(x)
    assert out["filtered"].shape == (n, channels)
    assert out["spectrogram"].shape[0] == n // 32
    assert bool(torch.isfinite(out["envelope"]).all())
    ref = ShardedPipeline(make_mesh(devices[:1], seq=1, ch=1), RATE,
                          filt=filt, env=env, nfft=64, hop=32,
                          minmax_step=64)(x)
    assert set(out) == set(ref)
    for key in ("filtered", "envelope", "minmax"):
        np.testing.assert_allclose(
            out[key].cpu().numpy(), ref[key].cpu().numpy(), atol=1e-5,
            err_msg=f"sharded '{key}' diverged from unsharded execution")
    np.testing.assert_allclose(
        out["spectrogram"].cpu().numpy(), ref["spectrogram"].cpu().numpy(),
        rtol=1e-4, atol=1e-9,
        err_msg="sharded 'spectrogram' diverged from unsharded execution")

    # phase 2: batch data parallelism, one recording a mesh entry
    clip = torch.from_numpy(np.ascontiguousarray(x[:4096, :1]))

    def one_recording(_k):
        # on a card: the worker's current card (map_files pins it)
        x1 = clip.to(resolve_device(None) if device.type == "cuda"
                     else device)
        y = sosfilt_fir(filt.fir, x1, axis=0, return_zf=False)
        rect = (math.pi / 2) * torch.abs(y)
        e = sosfiltfilt_fir(env.fir, rect, env.zi0, env.padlen, axis=0)
        return y.cpu().numpy(), torch.clamp_min(e, 0.0).cpu().numpy()

    batch = map_files(one_recording, range(n_devices), devices=devices)
    y1, e1 = one_recording(0)
    assert len(batch) == n_devices
    for d, (yb, eb) in enumerate(batch):
        np.testing.assert_allclose(
            yb, y1, atol=1e-5,
            err_msg=f"batch entry {d} 'filtered' diverged from unsharded")
        np.testing.assert_allclose(
            eb, e1, atol=1e-5,
            err_msg=f"batch entry {d} 'envelope' diverged from unsharded")

    # phase 3: a browser over a channel-sharded mesh against one device
    irate = 4000.0
    idur = 10.0
    t = np.arange(int(irate * idur)) / irate
    xw = np.stack([0.3 * np.sin(2 * np.pi * (300.0 + 80.0 * c) * t)
                   + 0.02 * rng.standard_normal(len(t))
                   for c in range(n_devices)], axis=1).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "mesh.wav"
        wavio.write_audio(wav, xw, irate, encoding="PCM_16")
        bm = DataBrowser(str(wav),
                         mesh=make_mesh(devices, seq=1, ch=n_devices))
        b1 = DataBrowser(str(wav), device=devices[0])
        try:
            bm.open()
            b1.open()
            for t0 in (2.0, 5.0):  # initial view + a scroll
                bm.set_times(t0, 3.0)
                b1.set_times(t0, 3.0)
                buf = bm.data["filtered"].buffer
                assert len(getattr(buf, "parts", ())) == n_devices, \
                    "interactive window did not shard across the mesh"
                i0, i1 = int((t0 + 0.5) * irate), int((t0 + 1.5) * irate)
                for name in ("data", "filtered"):
                    np.testing.assert_allclose(
                        np.asarray(bm.data[name][i0:i1]),
                        np.asarray(b1.data[name][i0:i1]), atol=1e-5,
                        err_msg=f"meshed interactive '{name}' diverged")
                for c in (0, n_devices - 1):
                    _ta, va = bm.trace_tile("filtered", c)
                    _tb, vb = b1.trace_tile("filtered", c)
                    np.testing.assert_allclose(
                        va, vb, atol=1e-4,
                        err_msg="meshed render tile diverged")
        finally:
            bm.close()
            b1.close()

    # phase 4: sequence-sharded batch detection against the chunked driver
    drate = 96000.0
    dn = n_devices * (1 << 16) + 999
    td = np.arange(dn) / drate
    tone = 0.4 * np.sin(2 * np.pi * 6500.0 * td) * (
        np.sin(2 * np.pi * 2.0 * td) > 0)
    xd = np.clip(np.round((tone[:, None]
                           + 0.05 * rng.standard_normal((dn, 2))) * 32768),
                 -32768, 32767).astype(np.int16)
    dmesh = make_mesh(devices, seq=n_devices, ch=1)
    _f, env_ref, er = events.band_env(xd, drate, 1000.0, 10000.0, 500.0,
                                      return_filtered=False,
                                      device=devices[0])
    _f2, env_sh, er2 = events.band_env(xd, drate, 1000.0, 10000.0, 500.0,
                                       return_filtered=False, mesh=dmesh,
                                       device=devices[0])
    assert er == er2
    assert env_ref.shape == env_sh.shape
    scale = float(np.max(np.abs(env_ref)))
    derr = float(np.max(np.abs(env_ref - env_sh))) / scale
    assert derr < 1e-5, f"sharded detect envelope diverged: {derr}"
