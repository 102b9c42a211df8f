"""Device-side render tiles: min/max trace decimation and dB image tiles.

The counterpart of ``audian_tpu/view/render.py``.  The visible window of a
trace is decimated to per-pixel min/max pairs, and spectrogram power is
turned into dB images, by a few torch ops on the trace windows where they
lie (on the card); only the pixel-sized tile crosses to the host.  The
tilers keep the JAX package's geometry (power-of-two steps and tile
widths, columns on a global grid), so a scroll reuses the cached columns
and pulls only the newly exposed ones.

Slices follow ``lax.dynamic_slice`` (:func:`_dslice`): a start that would
run past the end is clamped so the slice keeps its width.  A
channel-sharded window (:class:`audian_torch.parallel.ChannelShards`, a
``Data`` session over a mesh) is tiled group by group where each group
lies, and the pulled pieces join along the channel axis
(:func:`pull_groups`).  Every pull is a ``render.pull`` trace event
(:mod:`audian_torch.utils.trace`).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..ops.sweep import db_normalize
from ..parallel.shard import ChannelShards, channel_shards
from ..utils import pow2_at_least as _pow2_at_least
from ..utils import resolve_device
from ..utils import trace as _trace

__all__ = ["SpecTiler", "TraceTiler", "mean_power_db_slice",
           "noise_level_stats", "pick_amplitude", "power_value",
           "pull_groups", "window_extrema"]


def _dslice(buf, start, width):
    """``width`` frames of ``buf`` from ``start``, the start clamped into
    ``[0, len(buf) - width]`` (``lax.dynamic_slice_in_dim`` semantics)."""
    start = min(max(int(start), 0), buf.shape[0] - width)
    return buf[start : start + width]


def _minmax_tile(buf, start, step, width):
    """Interleaved min/max of ``width`` segments of ``step`` frames
    starting at ``start`` (buffer-relative)."""
    seg = _dslice(buf, start, width * step)
    shaped = seg.reshape((width, step) + tuple(buf.shape[1:]))
    tile = torch.stack([torch.amin(shaped, dim=1),
                        torch.amax(shaped, dim=1)], dim=1)
    return tile.reshape((2 * width,) + tuple(buf.shape[1:]))


def _slice_tile(buf, start, width):
    return _dslice(buf, start, width)


def _pack_scaled_i16(tile):
    """Quantize a ``(n, channels)`` float32 tile to int16 with a
    per-channel scale bit-packed into the first two rows: one int16 pull
    instead of a float32 one (render tiles need only ~1e-4 relative
    accuracy).  The scale's float32 bits go in little-endian order (low
    half in row 0), as ``np.view`` reads them back."""
    scale = torch.clamp_min(torch.amax(torch.abs(tile), dim=0), 1e-30)
    q = torch.clamp(torch.round(tile * (32767.0 / scale)),
                    -32768, 32767).to(torch.int16)
    head = scale.to(torch.float32).contiguous().view(torch.int16)
    return torch.cat([head.reshape(-1, 2).T, q], dim=0)


def _unpack_scaled_i16(packed):
    """Host-side inverse of :func:`_pack_scaled_i16`."""
    head = np.ascontiguousarray(packed[:2].T)        # (channels, 2) int16
    scale = head.view(np.float32).reshape(-1)        # (channels,)
    return packed[2:].astype(np.float32) * (scale / 32767.0)


def _minmax_tile_i16(buf, start, step, width):
    return _pack_scaled_i16(_minmax_tile(buf, start, step, width))


def _slice_tile_i16(buf, start, width):
    return _pack_scaled_i16(_dslice(buf, start, width))


def _pull(t):
    return t.cpu().numpy()


def pull_groups(buf, fn, axis=1):
    """``fn(tensor, c0, c1)`` over each channel group ``[c0, c1)`` of a
    window (the whole window for a tensor), each computed where its group
    lies, pulled, and joined along the result's channel ``axis``."""
    parts = [_pull(fn(t, c0, c1)) for c0, c1, t in channel_shards(buf)]
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=axis)


def _delta_columns(cache, key, trace, buf, g0, w, unit, r, fetch, hi_g,
                   max_entries=32):
    """Tile-column cache with scroll-delta reuse.

    Returns ``w`` decoded columns starting at GLOBAL frame ``g0`` (one
    column = ``unit`` frames, ``r`` output rows per column).  Columns
    overlapping the cached previous request of the same ``key`` are
    copied host-side; only missing columns cross the host link through
    ``fetch(global_start, ncolumns)`` (bucketed widths).  Content identity
    across window objects comes from ``trace.content_epoch``: scrolling
    keeps it (same global frames -> same values, the chunked == whole
    invariant), parameter changes bump it; objects without an epoch fall
    back to buffer identity.  ``hi_g`` is the (global) end of the loaded
    window; partial reuse requires the request inside it."""
    epoch = getattr(trace, "content_epoch", None)
    g1 = g0 + w * unit
    hit = cache.get(key)
    # hit["trace"]() is trace guards the id(trace) in the key: CPython
    # recycles addresses, so a freed Trace's cache entry must never
    # serve a new Trace that landed on the same id
    fresh = hit is not None and hit["trace"]() is trace and (
        (epoch is not None and hit["epoch"] == epoch)
        or (epoch is None and hit["buf"]() is buf))
    if fresh and hit["g0"] <= g0 and g1 <= hit["g1"]:
        a = (g0 - hit["g0"]) // unit
        return hit["data"][r * a : r * (a + w)]
    if fresh and hit["g0"] < g1 and g0 < hit["g1"] and g1 <= hi_g:
        c0, c1, old = hit["g0"], hit["g1"], hit["data"]
        tile = np.empty((r * w,) + old.shape[1:], old.dtype)
        a = (max(g0, c0) - g0) // unit
        b = (min(g1, c1) - g0) // unit
        s = (max(g0, c0) - c0) // unit
        tile[r * a : r * b] = old[r * s : r * s + r * (b - a)]
        if g0 < c0:  # scrolled left: new columns before the cache
            need = (c0 - g0) // unit
            wc = min(_pow2_at_least(need), w)
            tile[: r * need] = fetch(g0, wc)[: r * need]
        if c1 < g1:  # scrolled right: new columns after the cache
            need = (g1 - c1) // unit
            wc = min(_pow2_at_least(need), w)
            tile[r * (w - need):] = fetch(g1 - wc * unit,
                                          wc)[r * (wc - need):]
    else:
        tile = fetch(g0, w)
    if key not in cache and len(cache) >= max_entries:
        cache.clear()
    cache[key] = {"epoch": epoch, "buf": weakref.ref(buf),
                  "trace": weakref.ref(trace),
                  "g0": g0, "g1": g1, "data": tile}
    return tile


def _device_buffer(trace, device):
    """``trace.buffer``, which must be a tensor on ``device``'s kind of
    device: the tilers compute where the window lies and never copy a
    window to another device."""
    buf = trace.buffer
    windows = (torch.Tensor, ChannelShards)
    if not isinstance(buf, windows) or buf.device.type != device.type:
        where = buf.device if isinstance(buf, windows) else type(buf)
        raise ValueError(f"the trace window lies on {where}, the tiler "
                         f"works on {device}")
    return buf


class TraceTiler:
    """Min/max decimation of a windowed trace to screen pixels on
    ``device`` (the CUDA card unless the caller names another).

    Reference semantics: ``step = (visible frames)//max_pixels`` floored
    at 1; segment starts aligned to step multiples; interleaved min/max
    values plotted at half-step times.  Steps are bucketed to powers of
    two so zoom levels share tile geometry (the visual result is identical
    at sub-pixel scale).
    """

    def __init__(self, max_pixels=1920, quantize=True, device=None):
        self.max_pixels = int(max_pixels)
        #: pull tiles as scale-packed int16 (half the bytes; ~1e-4
        #: relative quantization, invisible at screen resolution).  Off
        #: for callers needing bit-exact buffer values.
        self.quantize = bool(quantize)
        self.device = resolve_device(device)
        # the tile covers ALL channels; per-channel callers (one plot
        # item each) reuse one compute + one pull per window.  Entries
        # carry their GLOBAL column coverage, so a scroll re-pulls only
        # the newly exposed columns.
        self._cache = {}

    def _columns(self, trace, buf, boff, step, g0, w, minmax):
        """Decoded tile columns for ``w`` segments of ``step`` frames
        starting at GLOBAL frame ``g0`` (on the ``g0 % step`` grid,
        fully inside the loaded window)."""
        if minmax:
            kernel = _minmax_tile_i16 if self.quantize else _minmax_tile
        else:
            kernel = _slice_tile_i16 if self.quantize else _slice_tile

        def fetch(gs, wc):
            args = (gs - boff, step, wc) if minmax else (gs - boff, wc)
            with _trace.timed("render.pull", op=kernel.__name__) as span:
                raw = pull_groups(buf, lambda t, *_: kernel(t, *args))
                span["bytes"] = raw.nbytes
            return _unpack_scaled_i16(raw) if self.quantize else raw

        key = (kernel.__name__, id(trace), step, g0 % step)
        return _delta_columns(
            self._cache, key, trace, buf, g0, w, step,
            2 if minmax else 1, fetch, boff + len(buf))

    def tile(self, trace, t0, t1, channel=None):
        """Render tile for view range [t0, t1].

        Parameters
        ----------
        trace : object with ``rate, frames, offset, buffer`` (a
            :class:`audian_torch.data.Data` trace view; ``buffer`` a
            tensor on the tiler's device).
        channel : channel to extract; None returns all channels.

        Returns ``(times, values)`` numpy arrays; for ``step > 1`` values
        are interleaved min/max at half-step positions.
        """
        rate = trace.rate
        start = max(0, int(t0 * rate))
        tstop = int(t1 * rate + 1)
        stop = min(trace.frames, tstop)
        if stop <= start:
            shape = (0,) if channel is not None else (0, trace.channels)
            return np.zeros(0), np.zeros(shape, np.float32)
        step = max(1, (tstop - start) // self.max_pixels)
        buf = _device_buffer(trace, self.device)
        boff = trace.offset
        if step > 1:
            step = _pow2_at_least(step)
            start = (start // step) * step
            # clamp into the loaded window, step-aligned
            lo = boff + ((-boff) % step) if boff % step else boff
            while start < lo:
                start += step
            stop = min(stop, boff + len(buf))
            width = max((stop - start) // step, 0)
            if width == 0:
                shape = (0,) if channel is not None else (0, trace.channels)
                return np.zeros(0), np.zeros(shape, np.float32)
            # bucket the tile width and shift the slice back so the
            # padded tile stays in the buffer
            avail = (boff + len(buf) - lo) // step
            wb = min(_pow2_at_least(width), avail)
            start2 = min(start, boff + len(buf) - wb * step)
            start2 = lo + ((start2 - lo) // step) * step
            tile = self._columns(trace, buf, boff, step, start2, wb,
                                 minmax=True)
            k0 = (start - start2) // step
            values = tile[2 * k0 : 2 * (k0 + width)]
            half = step / 2
            times = (start + np.arange(2 * width) * half) / rate
        else:
            start = max(start, boff)
            stop = min(stop, boff + len(buf))
            width = max(stop - start, 0)
            wb = min(_pow2_at_least(width), len(buf))
            start2 = max(min(start, boff + len(buf) - wb), boff)
            values = self._columns(trace, buf, boff, 1, start2, wb,
                                   minmax=False)
            values = values[start - start2 : start - start2 + width]
            times = (start + np.arange(width)) / rate
        if channel is not None:
            values = values[:, channel]
        return times, values


def pick_amplitude(trace, t, y, t1=None, channel=0):
    """Nearest-extremum amplitude at a cursor position: the crosshair
    snap.  Reads through ``trace[...]``, which pulls only the block."""
    rate = trace.rate
    idx = int(round(t * rate))
    step = 1
    if t1 is not None:
        step = max(1, int(round(t1 * rate)) - idx)
    if step > 1:
        idx = (idx // step) * step
        block = np.asarray(trace[idx : idx + step, channel])
        if block.size == 0:
            return idx / rate, 0.0
        mini = int(np.argmin(block))
        maxi = int(np.argmax(block))
        amin, amax = float(block[mini]), float(block[maxi])
        if abs(y - amax) < abs(y - amin):
            return (idx + maxi) / rate, amax
        return (idx + mini) / rate, amin
    idx = min(max(idx, 0), trace.frames - 1)
    return idx / rate, float(np.asarray(trace[idx, channel]))


#: window extrema by (window, range), so autoscaling a still window pulls
#: once
_extrema_cache = {}


def window_extrema(trace, t0, t1, channel):
    """(min, max) of ``trace`` on ``channel`` over [t0, t1] seconds: the
    auto-scale reduction, computed where the window lies so only
    ``(2, channels)`` floats are pulled (cached per window and range, all
    channels in one pull)."""
    rate = trace.rate
    i0 = max(int(t0 * rate) - trace.offset, 0)
    i1 = min(int(t1 * rate) - trace.offset, len(trace.buffer))
    if i1 <= i0:
        return 0.0, 0.0
    buf = trace.buffer
    key = (id(buf), i0, i1)
    hit = _extrema_cache.get(key)
    if hit is None or hit[0]() is not buf:
        with _trace.timed("render.pull", op="window_extrema") as span:
            stats = pull_groups(buf, lambda t, *_: torch.stack(
                [torch.amin(t[i0:i1], dim=0), torch.amax(t[i0:i1], dim=0)]))
            span["bytes"] = stats.nbytes
        for k in [k for k, v in _extrema_cache.items() if v[0]() is None]:
            _extrema_cache.pop(k, None)
        if len(_extrema_cache) > 64:
            _extrema_cache.clear()
        hit = (weakref.ref(buf), stats)
        _extrema_cache[key] = hit
    stats = hit[1]
    return float(stats[0, channel]), float(stats[1, channel])


_power_block_cache = {}

#: frames per cached hover block
_POWER_BLOCK = 256


def power_value(trace, i, channel, j):
    """Linear power of one spectrogram cell (buffer-relative frame ``i``,
    frequency bin ``j``) for the hover readout.  The surrounding
    :data:`_POWER_BLOCK`-frame (frames, freqs) slice of the hovered
    channel is pulled once and cached, so sweeping the cursor across a
    window pulls only every few hundred pixels."""
    buf = trace.buffer
    wb = min(_POWER_BLOCK, len(buf))
    start = min((i // wb) * wb, len(buf) - wb)
    key = (id(buf), start, channel, wb)
    hit = _power_block_cache.get(key)
    if hit is None or hit[0]() is not buf:
        with _trace.timed("render.pull", op="power_block") as span:
            block = _pull(buf[start : start + wb, channel])
            span["bytes"] = block.nbytes
        for k in [k for k, v in _power_block_cache.items()
                  if v[0]() is None]:
            _power_block_cache.pop(k, None)
        if len(_power_block_cache) > 16:
            _power_block_cache.clear()
        hit = (weakref.ref(buf), block)
        _power_block_cache[key] = hit
    return float(hit[1][i - start, j])


def _percentile(x, q):
    """numpy's default (linear) ``percentile`` along the last axis."""
    s = torch.sort(x, dim=-1).values
    pos = (q / 100.0) * (s.shape[-1] - 1)
    lo = int(pos)
    hi = min(lo + 1, s.shape[-1] - 1)
    frac = pos - lo
    return s[..., lo] + (s[..., hi] - s[..., lo]) * frac


def noise_level_stats(buf, nf):
    """Per-channel ``(q95 of top-frequency-sixteenth dB, max dB)`` over a
    ``(frames, channels, freqs)`` linear-power window, as a
    ``(channels, 2)`` tensor where ``buf`` lies: the auto-leveling inputs
    without pulling the window.  The percentile is numpy's linear one
    over the same dB values."""
    db = 10.0 * torch.log10(torch.clamp_min(buf, 1e-20))
    nchan = buf.shape[1]
    tail = db[:, :, -nf:].permute(1, 0, 2).reshape(nchan, -1)
    mx = torch.amax(db, dim=(0, 2))
    return torch.stack([_percentile(tail, 95.0), mx], dim=1)


def mean_power_db_slice(buf, start, channel, offset, width, wb):
    """Mean dB spectrum of the ``width`` frames at ``start + offset`` of
    one channel (within the ``wb``-frame slice at ``start``): the power
    side plot's data, one row of floats where ``buf`` lies."""
    part = _dslice(buf, start, wb)[:, channel]
    mean = part[offset : offset + width].sum(dim=0) / max(width, 1)
    return 10.0 * torch.log10(torch.clamp_min(mean, 1e-20))


def _db_tile_u8(power, zmin, zmax):
    return torch.round(255.0 * db_normalize(power, zmin, zmax)).to(
        torch.uint8)


def _db_tile_slice_all(buf, start, zmins, zmaxs, wb, quantize, pool):
    """All channels' dB tiles in one pass: ``(frames, channels, freqs)``
    power window -> ``(wb//pool, channels, freqs)`` image stack with
    per-channel colour levels (``zmins``/``zmaxs`` tensors of shape
    ``(channels,)``).  One pull serves every channel's image item."""
    part = _dslice(buf, start, wb)
    if pool > 1:
        part = torch.amax(part.reshape((wb // pool, pool)
                                       + tuple(part.shape[1:])), dim=1)
    img = db_normalize(part, zmins[None, :, None], zmaxs[None, :, None])
    if quantize:
        img = torch.round(255.0 * img).to(torch.uint8)
    return img


def _db_tile_slice(buf, start, channel, zmin, zmax, width, quantize, pool):
    """One channel's dB tile over a bucketed-width frame slice: crop,
    screen-resolution max-pooling (peaks survive, like the trace min/max
    tiles) and the dB conversion where ``buf`` lies."""
    part = _dslice(buf, start, width)[:, channel]
    if pool > 1:
        part = torch.amax(part.reshape(width // pool, pool, part.shape[-1]),
                          dim=1)
    if quantize:
        return _db_tile_u8(part, zmin, zmax)
    return db_normalize(part, zmin, zmax)


class SpecTiler:
    """dB image tiles from a spectrogram trace window on ``device`` (the
    CUDA card unless the caller names another).

    Produces normalized (or uint8-quantized) images clipped to the current
    colour levels, plus the buffer-extent rectangle the image maps onto.
    """

    def __init__(self, max_pixels=1920, device=None):
        self.max_pixels = int(max_pixels)
        self.device = resolve_device(device)
        # one batched all-channel pull per (window, geometry, levels);
        # per-channel callers slice it (see _db_tile_slice_all)
        self._cache = {}

    def tile(self, trace, channel, zmin, zmax, quantize=False, t0=None,
             t1=None, levels=None):
        """dB image tile of ``channel`` and its rectangle ``(t, f, dt,
        df)``.  With ``levels`` (``(channels, 2)`` zmin/zmax rows) every
        channel is tiled in one pass and cached with scroll-delta reuse;
        otherwise one channel at ``zmin``/``zmax``."""
        buf = _device_buffer(trace, self.device)
        if len(buf) == 0:
            return np.zeros((0, 0)), (0.0, 0.0, 0.0, 0.0)
        rate = trace.rate
        i0 = 0 if t0 is None else max(int(t0 * rate) - trace.offset, 0)
        i1 = len(buf) if t1 is None else min(
            int(t1 * rate + 1) - trace.offset, len(buf))
        width = max(i1 - i0, 0)
        if width == 0:
            return np.zeros((0, buf.shape[-1])), (0.0, 0.0, 0.0, 0.0)
        # bucketed width + back-shifted start (see TraceTiler.tile);
        # frames beyond the screen width max-pool before the pull
        wb = _pow2_at_least(width)
        pool = 1
        while wb // pool > self.max_pixels * 2:
            pool *= 2
        # clamp to the buffer, keeping the width a pool multiple
        wb = min(wb, (len(buf) // pool) * pool)
        s2 = max(min(i0, len(buf) - wb), 0)
        # snap the slice so pooled columns align to the absolute grid
        s2 = (s2 // pool) * pool
        if levels is not None:
            levels = np.asarray(levels, np.float32)
            boff = trace.offset

            def fetch(gs, wc):
                with _trace.timed("render.pull", op="db_tile_all") as span:
                    stack = pull_groups(
                        buf, lambda t, c0, c1: _db_tile_slice_all(
                            t, gs - boff,
                            torch.as_tensor(levels[c0:c1, 0], device=t.device),
                            torch.as_tensor(levels[c0:c1, 1], device=t.device),
                            wc * pool, bool(quantize), pool))
                    span["bytes"] = stack.nbytes
                return stack

            # delta reuse across scrolls (one column = ``pool`` frames):
            # a one-bucket scroll pulls only the newly exposed columns
            key = ("dev", id(trace), pool, (boff + s2) % pool,
                   bool(quantize), levels.tobytes())
            stack = _delta_columns(
                self._cache, key, trace, buf, boff + s2, wb // pool,
                pool, 1, fetch, boff + len(buf), max_entries=8)
            img = stack[:, channel, :]
        else:
            with _trace.timed("render.pull", op="db_tile") as span:
                img = _pull(_db_tile_slice(buf, s2, channel, float(zmin),
                                           float(zmax), wb, bool(quantize),
                                           pool))
                span["bytes"] = img.nbytes
        img = img[(i0 - s2) // pool : -(-(i1 - s2) // pool)]
        i0 = s2 + ((i0 - s2) // pool) * pool
        i1 = min(i0 + img.shape[0] * pool, s2 + wb)
        node = getattr(trace, "_node", trace)
        fmax = node.frequencies[-1] + node.fresolution if hasattr(
            node, "frequencies") else 0.0
        rect = ((trace.offset + i0) / rate, 0.0, (i1 - i0) / rate, fmax)
        return img, rect

    def power_at(self, trace, t, f, channel):
        """Per-pixel power lookup for the hover readout."""
        node = getattr(trace, "_node", trace)
        i = int(t * trace.rate)
        j = int(round(f / node.fresolution))
        if not (0 <= i < trace.frames):
            return None
        nb = trace.spec.more_shape[0]
        j = min(max(j, 0), nb - 1)
        ib = i - trace.offset
        if not 0 <= ib < len(trace.buffer):
            return float(np.asarray(trace[i, channel, j]))
        return power_value(trace, ib, channel, j)
