"""Mesh-sharded batch song-detection front half.

The counterpart of ``audian_tpu/parallel/detect.py``: the recording's time
axis is sharded over the mesh's ``seq`` axis, each shard takes its window
extended by its neighbours' halos (uploaded in one piece from the
recording, :func:`.shard.halo_window`) and runs the
zero-phase band-pass, squared envelope and decimation on its own device,
so only the decimated envelope is ever materialized.  Where the JAX
package runs two ``sosfiltfilt_fir`` passes inside ``shard_map``, each
shard here runs the port's decimating envelope over its ``[halo | L |
halo]`` window, as the chunked driver's interior chunks do: the envdet
kernel (:class:`audian_torch.ops.cuda.envdet.EnvDetKernel`) with its first
output at ``halo``, or the two-stage :class:`audian_torch.ops.envdet.EnvDet`
for the geometries the kernel refuses.

Numerical contract — sharded == chunked == whole, including the
recording edges: interior shards carry halos covering the kernels' full
influence length (the ``events.detect_halo`` budget the chunked path
uses), and the head and tail regions, where a shard would see zero halos
instead of scipy's odd edge extension through the squared stage, are
recomputed on the exact float64 host oracle
(``events.detect_env_oracle``) and patched over.

The per-shard block length is bucketed to a quarter-pow2 ladder (at most
~25 % zero padding), and the envelope objects are cached per device and
geometry (the JAX package caches compiled programs the same way), so a
batch over many different-length files reuses a handful of them.
"""

from __future__ import annotations

import threading

import numpy as np

from ..ops.cuda.envdet import envelope_form
from .shard import halo_window

__all__ = ["sharded_band_env"]

_ENVDETS = {}  # (device, L, halo, step, designs) -> envelope
_ENVDETS_LOCK = threading.Lock()  # -j workers share the cache


def _bucket_blocks(nblocks):
    """Round a per-shard decimated-block count up the quarter-pow2
    ladder {2^k, 1.25*2^k, 1.5*2^k, 1.75*2^k}: bounded shape variety,
    <= 25% padding."""
    if nblocks <= 4:
        return int(nblocks)
    k = (int(nblocks) - 1).bit_length() - 1
    base = 1 << k
    for frac in (5, 6, 7, 8):
        cand = base * frac // 4
        if cand >= nblocks:
            return cand
    return 2 * base  # pragma: no cover - frac==8 always suffices


def _envdet(device, L, halo, step, fdesign, edesign):
    """The shard's decimating envelope over ``[halo | L | halo]`` with
    ``L / step`` outputs from ``halo``, in the form
    :func:`audian_torch.ops.cuda.envdet.envelope_form` picks; None when
    neither form covers it."""
    key = (str(device), L, halo, step, fdesign.fir.length, fdesign.padlen,
           edesign.fir.length, edesign.padlen, fdesign.sos.tobytes(),
           edesign.sos.tobytes())
    with _ENVDETS_LOCK:
        ed = _ENVDETS.get(key)
    if ed is not None:
        return ed
    ed = envelope_form(fdesign, edesign, step, L // step, halo, device)
    if ed is None:
        return None
    with _ENVDETS_LOCK:
        while len(_ENVDETS) > 32:
            # evict the OLDEST entry (insertion order), never the whole
            # cache: a 33rd geometry mid-batch must not force still-hot
            # ones to be rebuilt on the very next file
            _ENVDETS.pop(next(iter(_ENVDETS)))
        _ENVDETS[key] = ed
    return ed


def sharded_band_env(mesh, fdesign, edesign, x, step):
    """Decimated squared-RMS detect envelope of ``x`` (``(n, C)``;
    int16 = raw PCM-16) over ``mesh`` (axis ``"seq"``; the ``ch`` axis is
    not used, as in the JAX package).  Returns the ``(ceil(n / step),
    C)`` float32 envelope as a numpy array.

    Returns None, for the caller's single-device path, when the geometry
    does not shard usefully (fewer than two shards, or a recording shorter
    than a few halos per shard) or no decimating envelope covers it."""
    from ..analysis.events import detect_env_oracle, detect_halo

    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    nseq = int(mesh.shape["seq"])
    halo = detect_halo(fdesign, edesign)
    L = _bucket_blocks(-(-n // (nseq * step))) * step
    if nseq < 2 or L < 2 * halo:
        return None  # not worth sharding / halo infeasible
    count = -(-n // step)

    if x.dtype != np.int16:
        x = np.asarray(x, np.float32)  # no copy when already f32
    devices = mesh.devices[:, 0]
    eds = [_envdet(dev, L, halo, step, fdesign, edesign) for dev in devices]
    if any(ed is None for ed in eds):
        return None
    env = np.concatenate([
        ed(halo_window(x, i * L - halo, L + 2 * halo, dev), halo)
        .cpu().numpy() for i, (ed, dev) in enumerate(zip(eds, devices))])

    # exact head/tail patch: recompute the halo-influenced edge regions
    # through the float64 host oracle (grid-aligned slices of ONLY the
    # edges, never a whole-recording float64 copy) and overlay
    def f64(sl):
        return (sl.astype(np.float64) / 32768.0
                if sl.dtype == np.int16 else sl.astype(np.float64))

    patch = -(-halo // step)          # decimated samples to replace
    head_w = min(3 * halo, n)
    _y, head = detect_env_oracle(f64(x[:head_w]), step, fdesign, edesign)
    env[:patch] = head[:patch]
    t0 = max(((n - halo) // step) * step, 0)     # first tail grid point
    a = max(((t0 - 2 * halo) // step) * step, 0)  # aligned slice start
    _y, tail = detect_env_oracle(f64(x[a:n]), step, fdesign, edesign)
    k0 = (t0 - a) // step
    env[t0 // step : count] = tail[k0 : k0 + count - t0 // step]
    return env[:count]
