"""Device meshes.

The counterpart of ``audian_tpu/parallel/mesh.py``.  A mesh is a
``(seq, ch)`` grid of ``torch.device``s driven by one process: a ``seq``
axis shards long recordings in time (each shard extended by its
neighbours' halos: :func:`..shard.halo_window`,
:func:`..shard.halo_exchange`), a ``ch`` axis shards channels.  A device may appear more than once when the
caller lists it so, which lets one card (or the CPU) hold a ``seq=4`` or
``ch=4`` mesh.  The JAX package's ``P`` and ``NamedSharding`` have no
counterpart: nothing here carries a sharding along, each path places its
own shards.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device

__all__ = ["Mesh", "local_devices", "make_mesh"]


def local_devices(device=None):
    """The distinct devices a run on ``device`` can spread over: every
    CUDA device for a CUDA device (the default; without CUDA that
    raises), else ``[device]``."""
    device = resolve_device(device)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A ``(seq, ch)`` grid of devices: ``devices`` is the numpy object
    array of ``torch.device``s, ``shape`` maps each axis name to its
    size."""

    axis_names = ("seq", "ch")

    def __init__(self, devices):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a (seq, ch) grid, got shape "
                             f"{devices.shape}")
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))

    def __repr__(self):
        return (f"Mesh(seq={self.shape['seq']}, ch={self.shape['ch']}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def make_mesh(devices=None, seq=None, ch=1):
    """Build a ``(seq, ch)`` mesh over ``devices`` (every CUDA device by
    default; without CUDA that raises).

    ``seq * ch`` must cover every device; by default all devices go to the
    sequence axis, the natural layout for hour-long single-array
    recordings.  Listing one device several times gives a mesh of that
    many shards on it.
    """
    if devices is None:
        devices = local_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if seq is None:
        seq = n // ch
    if seq * ch != n:
        raise ValueError(f"mesh {seq}x{ch} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(seq, ch))
