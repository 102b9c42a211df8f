"""Batch / multi-device processing examples for the PyTorch port.

The port's twin of ``examples/batch_pipeline.py``.  Three ways to process
whole recordings without the interactive browser:

1. the fused single-pass chain (``FusedChainCF.chain_cf``, the ``chain``
   kernel on the card);
2. the time-sharded pipeline (``ShardedPipeline``) over a mesh of devices;
3. file-level data parallelism (``parallel.map_files``) over recordings,
   one recording per device, composing with the song-detection pipeline.

Each mode takes its devices explicitly and returns its outputs.  The
default is the CUDA card, and without one a mode raises; ``--device cpu``
runs the plain versions on the host.  ``--device`` may be given several
times: the modes then spread over the devices listed, and a device
listed twice holds two shards.

    python examples_torch/batch_pipeline.py [--device cuda] [recording.wav ...]
"""

import argparse

import numpy as np
import torch

from audian_torch.analysis.events import detect
from audian_torch.data import wavio
from audian_torch.ops.design import (FilterDesign, design_envelope_filter,
                                     design_filter)
from audian_torch.ops.fused import FusedChainCF
from audian_torch.parallel import (ShardedPipeline, local_devices, make_mesh,
                                   map_files)
from audian_torch.utils import resolve_device

RATE = 48000.0


def make_recording(seconds=30.0, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * RATE)
    t = np.arange(n) / RATE
    x = 0.02 * rng.standard_normal((n, channels)).astype(np.float32)
    burst = (t % 10.0) < 1.2
    x += (0.5 * burst * np.sin(2 * np.pi * 6500.0 * t))[:, None].astype(
        np.float32)
    return x


def device_list(devices="cuda"):
    """The devices a mode runs on: a list as given, or for one device
    every CUDA device where it is ``"cuda"`` without an index, else that
    device alone.  CUDA without a card raises."""
    if isinstance(devices, (str, torch.device)):
        dev = torch.device(devices)
        if dev.type == "cuda" and dev.index is None:
            return local_devices(dev)
        return [resolve_device(dev)]
    return [resolve_device(d) for d in devices]


def fused_single_chip(x, device="cuda", chunk=1 << 20):
    """One kernel pass: filter -> {envelope, spectrogram PSD}, over the
    first ``chunk`` frames of ``x``.  Returns ``(filtered, envelope, psd,
    stats)`` on the device."""
    fused = FusedChainCF(
        RATE,
        filt_sos=design_filter(RATE, 2000.0, 10000.0),
        env_sos=design_envelope_filter(RATE, 500.0),
        nfft=256, hop=128, device=device_list(device)[0],
    )
    ck = fused.chain_kernel
    ext = np.zeros((x.shape[1], ck.hb + chunk + ck.ha), np.float32)
    n = min(chunk, len(x))
    ext[:, ck.hb : ck.hb + n] = x[:n].T
    y, env, psd, stats = fused.chain_cf(ext, chunk, stats=True)
    print(f"fused chain: filtered {tuple(y.shape)}, envelope "
          f"{tuple(env.shape)}, PSD {tuple(psd.shape)}, per-channel power "
          f"{stats['power'].cpu().numpy()}")
    return y, env, psd, stats


def sharded_whole_recording(x, devices="cuda"):
    """Time-sharded whole-recording run over the devices (an even number
    of shards where there are several).  Returns the pipeline's dict of
    outputs on the mesh's first device."""
    devices = device_list(devices)
    ndev = len(devices)
    seq = max(1, ndev // 2 * 2) if ndev > 1 else 1
    mesh = make_mesh(devices[:seq], seq=seq, ch=1)
    pipe = ShardedPipeline(
        mesh, RATE,
        filt=FilterDesign.from_sos(design_filter(RATE, 2000.0, 10000.0)),
        env=FilterDesign.from_sos(design_envelope_filter(RATE, 500.0)),
        minmax_step=512,
    )
    out = pipe(x)
    print(f"sharded over {seq} device(s): " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in out.items()))
    return out


def detect_directory(paths, devices="cuda"):
    """One recording per device; the host-side event logic of one file
    overlaps the device work of another.  Returns ``[(path, onsets)]``,
    the onsets of each channel in seconds, rounded to 10 ms."""
    devices = device_list(devices)
    # map_files makes each worker's CUDA device the current one, which is
    # where "cuda" resolves; a CPU device is passed on as it is
    device = "cuda" if devices[0].type == "cuda" else devices[0]

    def process(path):
        data, rate = wavio.load_audio(path)
        r = detect(data, rate, highpassfreq=5500.0, lowpassfreq=7500.0,
                   envelopecutofffreq=100.0, minduration=0.5,
                   return_filtered=False, device=device)
        return path, [np.round(o, 2).tolist() for o in r["onsets"]]

    results = map_files(process, paths, devices=devices)
    for path, onsets in results:
        print(f"{path}: onsets {onsets}")
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("recordings", nargs="*",
                        help="recordings to run song detection on")
    parser.add_argument("--device", action="append",
                        help="a device to run on (repeatable; default: "
                             "every CUDA device)")
    args = parser.parse_args(argv)
    devices = device_list(args.device or "cuda")
    x = make_recording()
    fused_single_chip(x, devices[0])
    sharded_whole_recording(x, devices)
    if args.recordings:
        detect_directory(args.recordings, devices)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
