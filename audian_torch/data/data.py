"""The ``Data`` registry: raw loader + derived-trace DAG + windowed updates.

The counterpart of ``audian_tpu/data/data.py``: dict-like access by trace
name, ``get_region``, ``add_trace``/``remove_trace``, ``update_times`` and
halo-aware buffer sizing, with every derived trace window computed on the
card through :class:`audian_torch.graph.GraphExecutor` and kept there.

The raw window lives on the card as a mirror of the loader's host window.
A scroll slides it (one copy into a fresh tensor) and uploads only the
newly exposed frames: the int16 codes of PCM-16 WAVs and 16-bit FLACs
read from the files into pinned int16 staging buffers (other sources
upload the loader's float32 window), copied without blocking and dequantized on the card.
The derived windows slide the same way, with a halo'd sub-window
recomputed and stitched in (:meth:`Data._try_delta_update`).  Host code
pulls only the slices it renders.  There is no host fallback: a CUDA
error raises.

Over a mesh (``Data(mesh=...)``) whose ``ch`` axis divides the channel
count, every window is held as channel groups, one a device of the mesh's
first ``seq`` row (:class:`audian_torch.parallel.ChannelShards`), and the
graph runs group by group: the chain is channel-independent.  Reads and
tiles give what the unsharded session gives.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

from ..graph import (
    RAW,
    EnvelopeNode,
    FilterNode,
    GraphExecutor,
    SpectrogramNode,
    TraceGraph,
    TraceSpec,
)
from ..ops.raw16 import dequant16
from ..parallel.shard import ChannelShards
from ..utils import pow2_at_least as _pow2ceil
from ..utils import resolve_device
from ..utils import trace as _trace
from . import wavio
from .loader import AudioLoader


def _slide_window(old, new, shift):
    """``old`` slid by ``shift`` frames (forward for ``shift > 0``) with
    the newly exposed edge taken from ``new``: its trailing ``len(new)``
    frames for a forward slide, its leading ones for a backward slide
    (``len(new) >= |shift|``, so every frame the slide exposes lies in
    ``new``).  One copy into a fresh tensor: torch refuses an in-place
    shift of a tensor onto itself, and a window handed out earlier is
    never written.  Channel-sharded windows slide group by group."""
    if isinstance(old, ChannelShards):
        return old.map(lambda o, nw: _slide_window(o, nw, shift), new)
    out = torch.empty_like(old)
    n, nb = old.shape[0], new.shape[0]
    if shift > 0:
        out[: n - nb] = old[shift : shift + n - nb]
        out[n - nb :] = new
    else:
        out[:nb] = new
        out[nb:] = old[nb + shift : n + shift]
    return out


def _slide_patch(old, delta, shift, pos):
    """A derived trace's window slid by ``shift`` output frames with the
    recomputed ``delta`` frames patched in at ``pos``; every frame outside
    the patch is ``old``'s (the caller checks that the patch covers the
    edge the slide exposes).  A fresh tensor, as :func:`_slide_window`."""
    if isinstance(old, ChannelShards):
        return old.map(lambda o, d: _slide_patch(o, d, shift, pos), delta)
    out = torch.empty_like(old)
    n, length = old.shape[0], delta.shape[0]
    out[:pos] = old[shift : shift + pos]
    out[pos : pos + length] = delta
    out[pos + length :] = old[pos + length + shift : n + shift]
    return out


class Trace:
    """Windowed view of one derived trace.

    Exposes the reference's ``BufferedData`` consumer surface (``rate,
    channels, frames, shape, offset, buffer, buffer_changed, name, panel,
    color...``) plus ``__getitem__`` that serves any range, computing
    out-of-window requests on demand.  ``buffer`` is a tensor on the
    card (channel groups on their devices over a mesh); reads pull only
    the requested slice.  Node attributes
    (``nfft``, ``frequencies``, cutoffs, ...) are reachable through
    attribute delegation.
    """

    def __init__(self, node, data):
        self._node = node
        self._data = data
        self.offset = 0
        self.buffer = data._empty_window()
        self.buffer_changed = np.zeros(node.spec.channels, dtype=bool)
        self.plot_items = [None] * node.spec.channels
        self._visible = True

    # identity ---------------------------------------------------------------

    @property
    def name(self):
        return self._node.name

    @property
    def source_name(self):
        return self._node.source_name

    @property
    def spec(self):
        return self._node.spec

    @property
    def rate(self):
        return self._node.spec.rate

    @property
    def channels(self):
        return self._node.spec.channels

    @property
    def frames(self):
        return self._node.spec.frames

    @property
    def shape(self):
        return self._node.spec.shape

    @property
    def ndim(self):
        return self._node.spec.ndim

    @property
    def unit(self):
        return self._node.spec.unit

    @property
    def ampl_min(self):
        return self._node.spec.ampl_min

    @property
    def ampl_max(self):
        return self._node.spec.ampl_max

    #: attributes that live on the Trace itself; everything else delegates
    #: to the node so the reference idiom ``trace.highpass_cutoff = v;
    #: trace.update()`` works
    _own_attrs = frozenset([
        "_node", "_data", "offset", "buffer", "buffer_changed",
        "plot_items", "_visible",
    ])

    def __getattr__(self, attr):
        # delegate node-specific API (nfft, frequencies, cutoffs, update...)
        return getattr(self._node, attr)

    def __setattr__(self, attr, value):
        if attr in Trace._own_attrs or attr.startswith("__"):
            object.__setattr__(self, attr, value)
        elif hasattr(type(self), attr):
            object.__setattr__(self, attr, value)
        else:
            setattr(self._node, attr, value)

    def __len__(self):
        return self.frames

    @property
    def content_epoch(self):
        """Generation counter of this trace's VALUES: scrolling the
        window leaves it unchanged (same global frames -> same values,
        the chunked == whole invariant), while any upstream parameter
        change bumps it.  Render caches key delta-reusable tile columns
        on it (:mod:`audian_torch.view.render`).  While the trace is dirty
        (hidden during the change, window not yet refreshed) this is
        ``None``: the buffer does not hold the new epoch's values yet, so
        caches fall back to buffer-object identity."""
        name = self.name.lower()
        if name in self._data._dirty:
            return None
        return self._data._content_epoch.get(name, 0)

    def is_visible(self):
        vis = [pi.isVisible() for pi in self.plot_items if pi is not None]
        if vis:
            return any(vis)
        return self._visible

    def set_visible(self, show):
        self._visible = bool(show)
        for pi in self.plot_items:
            if pi is not None:
                pi.setVisible(show)
        # a trace updated while hidden was skipped by the lazy recompute
        # (its window is stale); showing it must refresh before the GUI
        # reads .buffer for tiles
        if show and self.name.lower() in self._data._dirty:
            self._data._recompute_buffer()

    # data access ---------------------------------------------------------------

    def _set_window(self, offset, array):
        self.offset = int(offset)
        self.buffer = array
        self.buffer_changed[:] = True

    def __getitem__(self, key):
        if isinstance(key, tuple):
            frame_key, rest = key[0], key[1:]
        else:
            frame_key, rest = key, ()
        if isinstance(frame_key, slice):
            start, stop, step = frame_key.indices(self.frames)
            if step < 0:  # numpy-style reversed slicing
                idx = np.arange(start, stop, step)
                if len(idx) == 0:
                    # empty result: never touch the compute path
                    data = np.zeros((0,) + tuple(self.buffer.shape[1:]),
                                    np.float32)
                else:
                    lo = int(idx[-1])
                    data = self._range(lo, int(idx[0]) + 1)[idx - lo]
            else:
                data = self._range(start, stop)[::step]
            return data[(slice(None),) + rest] if rest else data
        idx = int(frame_key)
        if idx < 0:
            idx += self.frames
        row = self._range(idx, idx + 1)[0]
        return row[rest] if rest else row

    def _range(self, start, stop):
        start = max(0, min(start, self.frames))
        stop = max(start, min(stop, self.frames))
        if self.name.lower() in self._data._dirty:
            # the window holds pre-update content (parameter changed
            # while this trace was hidden): refresh the window once and
            # serve reads from it, not one fresh compute per access
            if not self._data._refresh_trace(self.name):
                return self._data._compute_range(self.name, start, stop)
        if start >= self.offset and stop <= self.offset + len(self.buffer):
            a = start - self.offset
            # pull only the requested slice
            return self.buffer[a : a + stop - start].cpu().numpy()
        return self._data._compute_range(self.name, start, stop)

    def update(self, **kwargs):
        """Host-side parameter update (filter cutoffs, NFFT, ...);
        triggers a downstream recompute of the current window."""
        with _trace.timed("data.update", trace=self.name):
            old_spec = self._node.spec
            changed = self._node.update(**kwargs)
            # geometry = the OUTPUT SPEC changed (NFFT/overlap respec):
            # only then do downstream nodes need a re-open;
            # node.update()'s return means "recompute needed" and fires on
            # every cutoff scrub
            self._data._after_update(
                self.name, geometry_changed=self._node.spec != old_spec)
        return changed


class RawTrace:
    """Adapter presenting the raw loader as trace number 0 named "data".
    Reads (``trace[i0:i1]``) come from the loader; ``buffer`` is the raw
    window on the card (the loader's window, mirrored), so the raw
    trace's tiles come from the card like every other trace's."""

    name = RAW
    source_name = None
    panel = "trace"
    panel_type = "trace"
    color = "#0000ee"
    lw_thin = 1.1
    lw_thick = 2

    def __init__(self, loader, data):
        self._loader = loader
        self._data = data
        self.plot_items = [None] * loader.channels
        self._visible = True

    def __getattr__(self, attr):
        return getattr(self._loader, attr)

    def __len__(self):
        return self._loader.frames

    def __getitem__(self, key):
        return self._loader[key]

    @property
    def buffer(self):
        return self._data._device_raw()

    def is_visible(self):
        vis = [pi.isVisible() for pi in self.plot_items if pi is not None]
        if vis:
            return any(vis)
        return self._visible

    def set_visible(self, show):
        self._visible = bool(show)
        for pi in self.plot_items:
            if pi is not None:
                pi.setVisible(show)

    @property
    def spec(self):
        ld = self._loader
        return TraceSpec(rate=ld.rate, channels=ld.channels, frames=ld.frames,
                         ampl_min=ld.ampl_min, ampl_max=ld.ampl_max,
                         unit=ld.unit)


class Data:
    """Owns the raw loader plus the derived-trace DAG and drives windowed
    updates on ``device`` (the CUDA card unless the caller names another;
    without CUDA the constructor raises).

    ``mesh`` (an :class:`audian_torch.parallel.Mesh` with a ``ch`` axis)
    shards every window channel-wise over the devices of the mesh's first
    ``seq`` row; ``device`` then defaults to the mesh's first device.
    Channel counts the ``ch`` axis does not divide stay unsharded on
    ``device``."""

    def __init__(self, file_path, buffer_time=60.0, back_time=20.0,
                 follow_time=0.0, mesh=None, device=None, **load_kwargs):
        if device is None and mesh is not None:
            device = mesh.devices[0, 0]
        self.device = resolve_device(device)
        self.mesh = mesh
        self.file_path = file_path
        self.load_kwargs = load_kwargs
        self.buffer_time = buffer_time
        self.back_time = back_time
        self.follow_time = follow_time
        self.data = None          # AudioLoader
        self.rate = None
        self.channels = 0
        self.frames = 0
        self.start_time = None
        self.meta_data = {}
        self.tbefore = 0.0
        self.tafter = 0.0
        self.graph = TraceGraph()
        self.executor = None
        # over a mesh: (c0, c1, device) per channel group and its executor
        self._groups = None
        self._group_executors = None
        self._traces = {}         # name -> Trace (derived only)
        self._content_epoch = {}  # trace name -> generation of its VALUES
        self._dirty = set()       # traces with stale content (hidden at
                                  # the time of a parameter update)
        self._raw = None
        # device mirror of the loader's host window (incremental updates)
        self._dev_raw = None
        self._dev_raw_off = None
        self._last_raw_shift = None
        # pinned int16 upload staging by shape: up to two (buffer, event
        # recorded behind its last copy) pairs each (see _upload_raw16)
        self._q_staging = {}

    def _empty_window(self):
        return torch.zeros((0,), device=self.device)

    # -- trace registry ----------------------------------------------------------

    def add_trace(self, node):
        self.graph.add(node)
        if self.data is not None:
            self._reopen_graph()
        return node

    def remove_trace(self, name):
        self.graph.remove(name)
        self._traces.pop(name.lower(), None)
        if self.data is not None:
            self._reopen_graph()

    def clear_traces(self):
        self.graph.clear()
        self._traces = {}

    def setup_traces(self):
        """Validate and order the DAG (raises MissingSourceError on a
        dangling source)."""
        return [n.name for n in self.graph.order]

    @property
    def traces(self):
        out = []
        if self._raw is not None:
            out.append(self._raw)
        out.extend(self._traces[n.name.lower()] for n in self.graph.order
                   if n.name.lower() in self._traces)
        return out

    def __len__(self):
        return len(self.traces)

    def __getitem__(self, key):
        key = key.lower()
        if key == RAW:
            return self._raw
        return self._traces.get(key)

    def __contains__(self, key):
        return self[key] is not None

    def keys(self):
        return [t.name for t in self.traces]

    def get_trace_names(self, node_class):
        return [self._traces[n.name.lower()].name
                for n in self.graph.order
                if isinstance(n, node_class) and n.name.lower() in self._traces]

    # -- visibility --------------------------------------------------------------

    def is_visible(self, name):
        t = self[name]
        return t.is_visible() if t is not None else False

    def set_visible(self, name, show):
        t = self[name]
        if t is None:
            return False
        changed = t.is_visible() != show
        t.set_visible(show)
        return changed

    def set_need_update(self):
        """Reference-API shim: laziness is recomputed per update from the
        visible set."""
        return self.visible_traces()

    def visible_traces(self):
        return [t.name for t in self.traces if t.is_visible()]

    # -- lifecycle ----------------------------------------------------------------

    def open(self, unwrap=0.0, unwrap_clip=False):
        if self.data is not None:
            self.data.close()
        self._dev_raw = None
        self._dev_raw_off = None
        self._last_raw_shift = None
        self._q_staging.clear()  # shapes belong to the previous recording
        self.data = AudioLoader(
            self.file_path,
            buffer_time=self.buffer_time,
            back_time=self.back_time,
            **self.load_kwargs,
        )
        if unwrap or unwrap_clip:
            thresh = unwrap if unwrap else 1.5
            self.data.set_unwrap(thresh, bool(unwrap_clip))
        self.data.follow = int(self.follow_time * self.data.rate)
        self._raw = RawTrace(self.data, self)
        self.file_path = self.data.filepath
        self.rate = self.data.rate
        self.channels = self.data.channels
        self.frames = self.data.frames
        self.meta_data = dict(Format=self.data.format_dict())
        self.meta_data.update(self.data.metadata())
        self.start_time = wavio.get_datetime(self.meta_data)
        self._groups = self._channel_groups()
        self._reopen_graph(reset=True)
        return self

    def _channel_groups(self):
        """``(c0, c1, device)`` per channel group over the mesh's ``ch``
        axis, or None for an unsharded session (no mesh, or a channel
        count the axis does not divide)."""
        if self.mesh is None:
            return None
        nch = self.mesh.shape["ch"]
        if self.channels % nch:
            return None
        w = self.channels // nch
        return [(j * w, (j + 1) * w, resolve_device(self.mesh.devices[0, j]))
                for j in range(nch)]

    def _reopen_graph(self, reset=False):
        """Re-derive node specs and the executor.  ``reset`` (a fresh
        ``open()``) also wipes reused Trace windows: the new open can
        have different decode semantics (unwrap) or another file, and a
        kept window would serve the previous session's data; add/remove
        of traces mid-session keeps the existing windows instead."""
        self.tbefore, self.tafter = self.graph.open(self._raw.spec)
        self.executor = GraphExecutor(self.graph, device=self.device)
        self._group_executors = (
            None if self._groups is None else
            [GraphExecutor(self.graph, device=dev)
             for _c0, _c1, dev in self._groups])
        new = {}
        for node in self.graph.order:
            key = node.name.lower()
            tr = self._traces.get(key) or Trace(node, self)
            tr._node = node
            if reset:
                tr.offset = 0
                tr.buffer = self._empty_window()
                tr.buffer_changed = np.zeros(node.spec.channels,
                                             dtype=bool)
                if len(tr.plot_items) != node.spec.channels:
                    tr.plot_items = [None] * node.spec.channels
            new[key] = tr
        self._traces = new
        if reset:
            self._dirty.clear()
        # buffer sizing happens lazily per update window
        self._resize_raw_buffer()

    def _resize_raw_buffer(self):
        if self.data is None:  # updates on a closed Data are no-ops
            return
        tbuffer = self.buffer_time + self.tbefore + self.tafter
        tback = self.back_time + self.tbefore
        self.data.bufferframes = int(tbuffer * self.data.rate)
        self.data.backframes = int(tback * self.data.rate)

    def close(self):
        if self.data is not None:
            self.data.close()
            self.data = None
        self._dev_raw = None
        self._dev_raw_off = None
        self._last_raw_shift = None
        self._q_staging.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- updates ------------------------------------------------------------------

    def _descendants(self, name):
        """The updated node and every trace downstream of it."""
        out = {name.lower()}
        for n in self.graph.order:
            if n.source_name.lower() in out:
                out.add(n.name.lower())
        return out

    def _after_update(self, name, geometry_changed=False):
        if geometry_changed and self.data is not None:
            # re-derive downstream output specs (safe: node.open keeps
            # user parameters on re-open)
            self.graph.open(self._raw.spec)
        # traces downstream of the change hold stale content until their
        # next recompute; hidden ones are skipped below, and the dirty
        # mark keeps the scroll fast path from serving them after they
        # are shown again
        self._dirty |= self._descendants(name)
        # bump the VALUE generation of every affected trace: render-side
        # caches may reuse window content across scrolls (same global
        # frames -> same values, the chunked == whole invariant) but must
        # refetch after any parameter change
        for n in self._descendants(name):
            self._content_epoch[n] = self._content_epoch.get(n, 0) + 1
        self.tbefore, self.tafter = self.graph.refold()
        self._resize_raw_buffer()
        self._recompute_buffer()

    def _upload_raw16(self, gstart, n):
        """The 16-bit codes of frames [gstart, gstart + n) on the device.

        On the card they are read from the files into a pinned int16
        staging buffer and copied without blocking.  Two buffers per shape
        take turns (at most four shapes are kept), and a buffer is written
        again only after the event recorded behind its last copy has
        passed: the host never overwrites codes a pending copy still reads
        (the JAX package's ``_put_raw`` reuses its buffer without that
        wait).  A ring dropped from the cache may still be read by its
        copy; PyTorch's pinned-memory allocator holds such a block until
        the copy is done."""
        shape = (n, self.channels)
        if self.device.type != "cuda":
            q = np.empty(shape, np.int16)
            self.data.read_raw16_into(gstart, n, q)
            return torch.from_numpy(q)
        ring = self._q_staging.pop(shape, None)
        if ring is None:
            ring = deque()
        self._q_staging[shape] = ring  # most recently used last
        while len(self._q_staging) > 4:
            self._q_staging.pop(next(iter(self._q_staging)))
        if len(ring) == 2:
            host, done = ring.popleft()
            done.synchronize()
        else:
            host = torch.empty(shape, dtype=torch.int16, pin_memory=True)
        self.data.read_raw16_into(gstart, n, host.numpy())
        dev = host.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        ring.append((host, done))
        return dev

    def _put_raw(self, hbuf, gstart):
        """Upload the loader-window slice ``hbuf`` (global frames from
        ``gstart``) to the device as float32.

        16-bit sources without unwrap (PCM-16 WAVs, 16-bit FLACs) cross as
        int16 codes read straight from the files (half the bytes, no float
        decode on the host) and dequantize on the card: every such sample
        is k / 2**15, so both paths give the same values bit for bit.  Other sources upload the
        loader's float32 window (a copy: the loader recycles its
        buffers).  Over a mesh the upload lands on ``device`` and each
        channel group is copied to its device from there (int16 codes
        cross as int16) and converted there."""
        if self.data.raw16_capable:
            raw = self._upload_raw16(int(gstart), len(hbuf))
        else:
            raw = torch.tensor(np.ascontiguousarray(hbuf), device=self.device)

        def floats(t):
            return (dequant16(t) if t.dtype == torch.int16
                    else t).contiguous()

        if self._groups is None:
            return floats(raw)
        return ChannelShards([
            floats(raw[:, c0:c1].to(dev, non_blocking=True))
            for c0, c1, dev in self._groups])

    def _run(self, raw, offset, targets):
        """The executor's run over a raw window; a channel-sharded window
        runs group by group and its outputs come back sharded alike."""
        if not isinstance(raw, ChannelShards):
            return self.executor.run(raw, offset, targets=targets)
        outs = [ex.run(part, offset, targets=targets)
                for ex, part in zip(self._group_executors, raw.parts)]
        return {name: (off, ChannelShards([o[name][1] for o in outs]))
                for name, (off, _arr) in outs[0].items()}

    def _device_raw(self):
        """Device mirror of the loader's host window.

        The mirror slides on the card, and only the newly exposed frames
        (bucketed to a power of two) cross the host link: the device twin
        of the reference's ``move_buffer`` retention."""
        buf = self.data.buffer
        off = int(self.data.offset)
        cap = len(buf)
        old = self._dev_raw
        self._last_raw_shift = None
        shift_note = None
        if old is None or old.shape[0] != cap or self._dev_raw_off is None:
            new_dev = self._put_raw(buf, off)
        else:
            shift = off - self._dev_raw_off
            if shift == 0:
                new_dev = old
                shift_note = 0
            elif abs(shift) >= cap:
                new_dev = self._put_raw(buf, off)
            else:
                nb = min(_pow2ceil(abs(shift)), cap)
                if shift > 0:
                    new = buf[cap - nb :]
                    g0 = off + cap - nb
                else:
                    new = buf[:nb]
                    g0 = off
                new_dev = _slide_window(old, self._put_raw(new, g0), shift)
                shift_note = shift
        self._dev_raw = new_dev
        self._dev_raw_off = off
        self._last_raw_shift = shift_note
        return new_dev

    def _try_delta_update(self, dev, targets):
        """Scroll fast path: recompute only a halo-extended sub-window
        covering the newly exposed frames and stitch it into the sliding
        device trace windows (the reference's incremental
        ``load_buffer``).

        Returns True when the stitch was applied; False falls back to the
        full-window recompute (startup, geometry changes, big jumps)."""
        rs = self._last_raw_shift
        if rs is None:
            return False
        off = int(self.data.offset)
        cap = dev.shape[0]
        active = self.graph.active_set(targets)
        plan, _ = self.executor._plan(off, cap, active)
        old = {}
        for name, g in plan.items():
            tr = self._traces.get(name)
            if tr is None:
                continue
            if (not isinstance(tr.buffer, (torch.Tensor, ChannelShards))
                    or len(tr.buffer) != g.n_out
                    or name in self._dirty):
                return False  # geometry changed / stale -> full recompute
            old[name] = (tr, g)
        if rs == 0:
            # window unchanged; offsets must also be current (a trace
            # re-shown after the raw window moved can have matching
            # length at a stale offset)
            return all(tr.offset == g.o0 for tr, g in old.values())
        # sub-window: the new frames plus the graph's halo fold, bucketed
        fold = int((self.tbefore + self.tafter) * self.rate) + 8192
        W = _pow2ceil(abs(rs) + fold)
        if W >= cap:
            return False
        a = cap - W if rs > 0 else 0
        out = self._run(dev[a : a + W], off + a, targets)
        # every tracked trace must have produced output: a sub-window
        # shorter than a node's geometry (e.g. a huge NFFT against a small
        # scroll) yields no frames for it, and skipping the patch would
        # freeze that trace's window at a stale offset
        produced = {n for n in out if n != RAW}
        if any(name not in produced for name in old):
            return False
        patches = []
        for name, (o0s, arr) in out.items():
            if name == RAW or name not in old:
                continue
            tr, g = old[name]
            shift = g.o0 - tr.offset
            pos = o0s - g.o0
            # the patch must land inside the new window and fully cover
            # the region the slide invalidates (the window's new edge)
            if pos < 0 or pos + len(arr) > g.n_out:
                return False
            if shift > 0 and pos + len(arr) < g.n_out:
                return False
            if shift < 0 and pos > 0:
                return False
            if abs(shift) > len(arr):
                return False
            patches.append((tr, g, arr, shift, pos))
        for tr, g, arr, shift, pos in patches:
            tr._set_window(g.o0, _slide_patch(tr.buffer, arr, shift, pos))
        return True

    def _refresh_trace(self, name):
        """Recompute one dirty (hidden) trace's window in place, so reads
        through :meth:`Trace._range` are served from the refreshed buffer
        instead of paying a fresh device run per access.  Returns False
        when there is no raw window to compute from."""
        if self.data is None or len(self.data.buffer) == 0:
            return False
        out = self._run(self._device_raw(), self.data.offset, [name])
        for n, (off, arr) in out.items():
            if n != RAW and n in self._traces:
                self._traces[n]._set_window(off, arr)
        self._dirty.difference_update(out)
        return name.lower() in out

    def _recompute_buffer(self):
        """Re-run the graph over the raw window already on the card: the
        parameter-change hot path.  Same chunk geometry as the last
        scroll, so the executor's plan is a cache hit."""
        if self.data is None or len(self.data.buffer) == 0:
            return
        visible = self.visible_traces()
        targets = [n for n in visible if n != RAW] or None
        if not targets:
            return
        self._device_windows(targets)

    def buffered_region(self):
        """Interior (halo-excluded) window currently buffered, in seconds:
        the range parameter changes recompute over."""
        if self.data is None or len(self.data.buffer) == 0:
            return (0.0, 0.0)
        t0 = self.data.offset / self.data.rate + self.tbefore
        t1 = ((self.data.offset + len(self.data.buffer)) / self.data.rate
              - self.tafter)
        return (min(t0, t1), t1)

    def update_times(self, t0, t1):
        """Move the shown window to [t0, t1]: fetch raw with halos, slide
        the raw mirror and recompute (or delta-stitch) the visible traces
        on the card.  Returns the name of the file at ``t0``."""
        if self.data is None:
            return None
        visible = self.visible_traces()
        targets = [n for n in visible if n != RAW] or None
        self.data.update_time(max(t0 - self.tbefore, 0.0),
                              min(t1 + self.tafter, self.frames / self.rate))
        if targets:
            self._device_windows(targets)
        self._raw.buffer_changed[:] = True
        i0 = min(int(t0 * self.data.rate), self.data.frames - 1)
        fp, _ = self.data.get_file_index(i0)
        return self.data.basename(fp)

    def _device_windows(self, targets):
        """Upload / slide the raw mirror, then recompute (or delta-stitch)
        the visible windows.  The outputs stay on the card; host code
        pulls only the slices it renders (min/max tiles, dB tiles)."""
        dev = self._device_raw()
        if self._try_delta_update(dev, targets):
            return
        out = self._run(dev, self.data.offset, targets)
        for name, (off, arr) in out.items():
            if name != RAW:
                self._traces[name]._set_window(off, arr)
        self._dirty.difference_update(out)

    #: on-demand ranges are quantized (aligned start, power-of-two length)
    #: so repeated region queries share a handful of chunk geometries
    _range_align = 1 << 12

    def _quantized_raw_window(self, r0, r1):
        """Widen raw frames [r0, r1) by the graph halos to an aligned
        start and power-of-two length."""
        hb = int(math.ceil(self.tbefore * self.rate))
        ha = int(math.ceil(self.tafter * self.rate))
        a = self._range_align
        q0 = max(((r0 - hb) // a) * a, 0)
        want = r1 + ha - q0
        n = max(_pow2ceil(want), a)
        if q0 + n > self.frames:
            q0 = max(0, ((self.frames - n) // a) * a)
            n = min(n, self.frames - q0)
        return q0, n

    def _compute_range(self, name, start, stop, targets=None):
        """On-demand computation of an arbitrary output range of one trace
        (serves region analysis/export without moving the view window),
        over a quantized raw window around the request."""
        node = self.graph[name]
        if node is None:
            raise KeyError(name)
        # widen the request in raw-frame space to a quantized window
        step_total = round(self.rate / node.spec.rate)
        q0, n = self._quantized_raw_window(start * step_total,
                                           stop * step_total)
        raw = self.data._read(q0, n)
        out = self.executor.run(raw, q0, targets=targets or [name],
                                pull=True)
        off, arr = out[name.lower()]
        lo = start - off
        if lo < 0 or lo + (stop - start) > len(arr):
            raise IndexError(
                f"{name}: frames [{start}, {stop}) not computable "
                f"(produced [{off}, {off + len(arr)}))"
            )
        return arr[lo : lo + (stop - start)]

    # -- regions -------------------------------------------------------------------

    def get_region(self, t0, t1, channel):
        """Time-sliced arrays of all traces for a selected region (i1 is
        inclusive+1, spectrogram traces add their frequency axis).  All
        derived traces come from ONE graph run over a quantized raw
        window."""
        derived = [n.name for n in self.graph.order]
        computed = {}
        if derived:
            finest = max(self.traces[1:], key=lambda t: t.rate, default=None)
            if finest is not None:
                i0 = max(int(t0 * finest.rate), 0)
                i1 = min(int(t1 * finest.rate) + 1, len(finest))
                computed = self._compute_region(derived, i0, i1, finest.rate)
        out = {}
        for t in self.traces:
            i0 = max(int(t0 * t.rate), 0)
            i1 = min(int(t1 * t.rate) + 1, len(t))
            time = np.arange(i0, i1) / t.rate
            if t.name in computed:
                off, arr = computed[t.name]
                lo = i0 - off
                if 0 <= lo and lo + (i1 - i0) <= len(arr):
                    data = arr[lo : lo + (i1 - i0), channel]
                else:
                    data = t[i0:i1, channel]
            else:
                data = t[i0:i1, channel]
            if isinstance(getattr(t, "_node", None), SpectrogramNode):
                out[t.name] = (time, t.frequencies, data)
            else:
                out[t.name] = (time, data)
        return out

    def _compute_region(self, names, i0, i1, rate):
        """One quantized graph run producing all ``names`` over a window
        covering frames [i0, i1) at ``rate``."""
        q0, n = self._quantized_raw_window(
            int(i0 * self.rate / rate),
            int(math.ceil(i1 * self.rate / rate)))
        raw = self.data._read(q0, n)
        out = self.executor.run(raw, q0, targets=names, pull=True)
        return {self._traces[k]._node.name if k in self._traces else k: v
                for k, v in out.items() if k != RAW}


def default_traces():
    """The full demo chain (filter + envelope + spectrogram) used by the
    tests and the library examples."""
    return [
        FilterNode("filtered", "data"),
        EnvelopeNode("envelope", "filtered"),
        SpectrogramNode("spectrogram", "filtered"),
    ]
