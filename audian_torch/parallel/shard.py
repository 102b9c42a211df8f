"""Shards on the devices of a mesh: the halo exchange over the sequence
axis and the channel-sharded window of an interactive session.

The counterpart of ``audian_tpu/parallel/shard.py``.  The JAX package
fetches each shard's halos from its neighbours with ``lax.ppermute``
inside ``shard_map``; here one process holds every shard as its own
tensor, so the exchange is a copy of the neighbour's edge onto the
shard's device.  Where the whole recording is at hand (the sharded
pipeline and detect), a shard's extended window is uploaded in one piece
instead (:func:`halo_window`): the same frames, without a second copy on
the device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ChannelShards", "channel_shards", "halo_exchange", "halo_window"]


def halo_exchange(shards, before, after):
    """Extend each time shard with ``before`` trailing frames of its left
    neighbour and ``after`` leading frames of its right neighbour.

    ``shards`` is the list of one ``seq`` axis's shard tensors, each
    ``(L, ...)`` on its own device, in time order.  Shard ``i`` receives
    shard ``i-1``'s last ``before`` frames and shard ``i+1``'s first
    ``after`` frames, copied to its device; edge shards receive zeros
    (zero initial conditions at the start of a recording, and the global
    zero padding at its end).  int16 shards are exchanged as int16.

    Returns the list of ``(before + L + after, ...)`` tensors.
    """
    shards = list(shards)
    L = min(int(s.shape[0]) for s in shards)
    if max(before, after) > L:
        # a slice would silently return a shorter "halo" made of the
        # shard's own samples, misaligning every downstream slice
        raise ValueError(
            f"halo ({before}, {after}) exceeds the local shard length "
            f"{L}: one neighbor exchange cannot provide it")
    out = []
    for i, x in enumerate(shards):
        parts = []
        if before > 0:
            if i > 0:
                parts.append(shards[i - 1][-before:].to(x.device,
                                                         non_blocking=True))
            else:
                parts.append(x.new_zeros((before,) + tuple(x.shape[1:])))
        parts.append(x)
        if after > 0:
            if i < len(shards) - 1:
                parts.append(shards[i + 1][:after].to(x.device,
                                                       non_blocking=True))
            else:
                parts.append(x.new_zeros((after,) + tuple(x.shape[1:])))
        out.append(torch.cat(parts) if len(parts) > 1 else x)
    return out


def halo_window(x, start, length, device, c0=0, width=None):
    """Frames ``[start, start + length)`` of channels ``[c0, c0 + width)``
    of a whole recording ``x`` (``(n, C)``, numpy or a tensor) on
    ``device``, zero before its first frame, past its last and past its
    channels: what :func:`halo_exchange` gives a shard of the zero-padded
    recording, uploaded in one piece.  The dtype is ``x``'s."""
    n, C = x.shape
    width = C - c0 if width is None else width
    a, b = min(max(start, 0), n), min(max(start + length, 0), n)
    c1 = min(c0 + width, C)
    part = x[a:b, c0:c1]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
    part = part.to(device)
    if tuple(part.shape) == (length, width):
        return part
    full = part.new_zeros((length, width))
    full[a - start : b - start, : c1 - c0] = part
    return full


class ChannelShards:
    """A time-first window held as channel groups, each a tensor
    ``(frames, channels_k, ...)`` on its own device: the window of a
    ``Data`` session over a mesh's ``ch`` axis.

    It offers what the session's readers take from a window tensor:
    ``shape``, ``len``, ``device`` (the first group's), ``numel()``,
    frame slicing (``w[a:b]`` gives the sliced groups), ``w[a:b, c]``
    (the slice of channel ``c``, a tensor on its group's device) and
    ``cpu()`` (the groups joined on the host).
    Computations go group by group (:func:`channel_shards`): the chain is
    channel-independent.
    """

    def __init__(self, parts):
        self.parts = list(parts)
        widths = [int(p.shape[1]) for p in self.parts]
        self.bounds = np.concatenate([[0], np.cumsum(widths)]).tolist()

    @property
    def shape(self):
        p = self.parts[0]
        return (int(p.shape[0]), self.bounds[-1]) + tuple(p.shape[2:])

    @property
    def device(self):
        return self.parts[0].device

    def __len__(self):
        return int(self.parts[0].shape[0])

    def numel(self):
        return sum(p.numel() for p in self.parts)

    def locate(self, channel):
        """``(group tensor, channel within it)`` of a global channel."""
        channel = int(channel)
        if channel < 0:
            channel += self.bounds[-1]
        k = int(np.searchsorted(self.bounds, channel, side="right")) - 1
        if not 0 <= k < len(self.parts):
            raise IndexError(f"channel {channel} of {self.bounds[-1]}")
        return self.parts[k], channel - self.bounds[k]

    def __getitem__(self, key):
        if (isinstance(key, tuple) and len(key) == 2
                and not isinstance(key[1], slice)):
            part, c = self.locate(key[1])
            return part[key[0], c]
        if not isinstance(key, slice):
            raise IndexError("a channel-sharded window takes [frames] or "
                             "[frames, channel]")
        return ChannelShards([p[key] for p in self.parts])

    def map(self, fn, *others):
        """``fn`` applied group by group (with the matching groups of
        ``others``, windows of the same grouping)."""
        return ChannelShards([fn(p, *(o.parts[k] for o in others))
                              for k, p in enumerate(self.parts)])

    def cpu(self):
        return torch.cat([p.cpu() for p in self.parts], dim=1)


def channel_shards(buf):
    """``(c0, c1, tensor)`` for each channel group of a window: one for a
    tensor, one a group for a :class:`ChannelShards`."""
    if isinstance(buf, ChannelShards):
        return [(buf.bounds[k], buf.bounds[k + 1], p)
                for k, p in enumerate(buf.parts)]
    return [(0, int(buf.shape[1]) if buf.ndim > 1 else 1, buf)]
