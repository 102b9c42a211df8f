"""Host-side window prefetching (a copy of
``audian_tpu/stream/scheduler.py``).

Aligned raw blocks are cached in a byte-budgeted LRU and the neighbours of
every access are read ahead on a background thread, biased towards the
direction the cursor is moving, so sequential scrolling finds the next
window already in memory.  Numpy and threads only.
"""

from __future__ import annotations

import inspect
import sys
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["BlockPrefetcher"]


class BlockPrefetcher:
    """Aligned-block read cache with direction-aware read-ahead over an
    :class:`audian_torch.data.AudioLoader`-like source (needs ``_read``,
    ``frames``, ``channels``).

    ``max_bytes`` bounds the cache (the block count adapts to the channel
    count and dtype — a fixed block count would cost 8x more memory on a
    16-channel recording than on stereo).
    """

    def __init__(self, source, block_frames=1 << 20, max_bytes=256 << 20,
                 read_ahead=2, max_blocks=None):
        self.source = source
        self.block_frames = int(block_frames)
        self.max_bytes = int(max_bytes)
        self.max_blocks = None if max_blocks is None else int(max_blocks)
        self.read_ahead = int(read_ahead)
        self._cache = OrderedDict()  # block index -> np array
        self._bytes = 0
        # retired full-size block buffers for reuse: first-touch page
        # faults make fresh buffers far dearer than warm ones, so
        # bounding the set of distinct block buffers matters
        self._free = []
        self._dtype = np.dtype(getattr(source, "dtype", np.float32))
        # sources that take out= (AudioLoader's raw path) decode straight
        # into recycled buffers; plain sources fall back to fresh arrays
        try:
            self._source_out = "out" in inspect.signature(
                source._read).parameters
        except (TypeError, ValueError):
            self._source_out = False
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="audian-prefetch")
        self._pending = set()
        self._inflight = {}  # block -> Future of its background read
        self._epoch = 0          # bumped by invalidate(); stale loads drop
        self._last_block = None  # previous request start block (direction)
        self.hits = 0
        self.misses = 0
        #: evicted blocks whose storage went back to the freelist vs.
        #: skipped because a reference was still live — if ``recycle_skips``
        #: dominates under steady scrolling, the refcount invariant in
        #: :meth:`_recycle` has been broken by a refactor
        self.recycled = 0
        self.recycle_skips = 0

    # -- cache core ---------------------------------------------------------------

    def _recycle(self, old):
        """Return a dropped cache entry's storage to the freelist when
        nothing outside the cache still references it (a caller-held
        ``read()`` view keeps the base alive AND visible to this check, so
        its pages are never overwritten under the caller).  Lock held.

        The refcount arithmetic assumes exactly one caller-side local
        holds ``old`` (CPython counts: that local + our parameter +
        getrefcount's own argument = 3).  FRAGILE BY NATURE: any call-site
        refactor that keeps a second reference alive (logging the entry,
        unpacking into a kept tuple) silently disables recycling and the
        hot read path returns to first-touch page-fault cost.  Guards:
        ``tests/test_torch_data.py::test_prefetcher_recycles_unreferenced``
        fails if eviction stops feeding the freelist, and the ``recycled`` /
        ``recycle_skips`` counters expose the rate at runtime.
        """
        if len(self._free) >= 4:
            return
        full = (self.block_frames, self.source.channels)
        if sys.getrefcount(old) != 3:
            self.recycle_skips += 1
            return  # a read() view (or other holder) is still live
        if old.base is None:
            if (old.shape == full and old.dtype == self._dtype
                    and old.flags.c_contiguous):
                self._free.append(old)
                self.recycled += 1
        else:
            base = old.base
            # base refs: the view's .base slot + local `base` + temp = 3
            if (base.shape == full and base.dtype == self._dtype
                    and base.flags.c_contiguous
                    and sys.getrefcount(base) == 3):
                self._free.append(base)
                self.recycled += 1
            else:
                self.recycle_skips += 1

    def _insert(self, b, data, epoch):
        with self._lock:
            self._pending.discard(b)
            if epoch != self._epoch:
                return  # invalidated while the read was in flight
            if b not in self._cache:
                self._bytes += data.nbytes
            self._cache[b] = data
            self._cache.move_to_end(b)
            while len(self._cache) > 1 and (
                    self._bytes > self.max_bytes
                    or (self.max_blocks is not None
                        and len(self._cache) > self.max_blocks)):
                _, old = self._cache.popitem(last=False)
                self._bytes -= old.nbytes
                self._recycle(old)

    def _read_source(self, b):
        """One block's worth of frames from the source, decoded into a
        recycled buffer when the source supports it."""
        start = b * self.block_frames
        if self._source_out:
            with self._lock:
                buf = self._free.pop() if self._free else None
            if buf is None:
                buf = np.empty((self.block_frames, self.source.channels),
                               self._dtype)
            try:
                data = self.source._read(start, self.block_frames, out=buf)
            except Exception:
                with self._lock:
                    if len(self._free) < 4:
                        self._free.append(buf)
                raise
            if data is not None and (
                    data is buf or data.base is buf):
                return data
            # source ignored the buffer (e.g. dtype mismatch): hand the
            # storage back rather than leaking it
            with self._lock:
                if len(self._free) < 4:
                    self._free.append(buf)
            return data
        return self.source._read(start, self.block_frames)

    def _load_block(self, b):
        while True:
            with self._lock:
                epoch = self._epoch
                if b in self._cache:
                    self._cache.move_to_end(b)
                    return self._cache[b]
            try:
                data = self._read_source(b)
            except Exception:
                # a failed background read must not leave the block marked
                # pending forever (that would disable its read-ahead)
                with self._lock:
                    self._pending.discard(b)
                raise
            self._insert(b, data, epoch)
            with self._lock:
                if epoch == self._epoch:
                    return data
            # invalidate() raced this read: the source's decoding
            # parameters changed mid-flight, so re-read under the new
            # epoch rather than serving stale samples

    def _schedule(self, b):
        nblocks = -(-self.source.frames // self.block_frames)
        if not (0 <= b < nblocks):
            return
        with self._lock:
            if b in self._cache or b in self._pending:
                return
            self._pending.add(b)
        try:
            fut = self._pool.submit(self._load_block, b)
        except RuntimeError:
            # close() (or a racing drain()) shut the pool down: read-ahead
            # is best-effort, and synchronous reads must keep working —
            # just un-mark the block so a later rescheduling can retry
            with self._lock:
                self._pending.discard(b)
            return
        with self._lock:
            self._inflight[b] = fut
        fut.add_done_callback(
            lambda _f, b=b: self._inflight.pop(b, None))

    def _get_block(self, b):
        with self._lock:
            cached = self._cache.get(b)
            if cached is not None:
                self._cache.move_to_end(b)
                self.hits += 1
                return cached
            fut = self._inflight.get(b)
        self.misses += 1
        if fut is not None:
            # a background prefetch of this very block is already
            # reading it: wait for THAT read instead of issuing a second
            # full-block disk read in parallel (two competing reads of
            # the same bytes are slower together than either alone, and
            # take two freelist buffers)
            try:
                return fut.result()
            except Exception:
                pass  # fall through: read synchronously, raise its error
        return self._load_block(b)

    def _schedule_around(self, b0, b1):
        """Read-ahead mostly in the direction this request moved relative
        to the previous one, plus one block the other way (back-scrolls)."""
        backwards = self._last_block is not None and b0 < self._last_block
        self._last_block = b0
        if backwards:
            for k in range(1, self.read_ahead + 1):
                self._schedule(b0 - k)
            self._schedule(b1 + 1)
        else:
            for k in range(1, self.read_ahead + 1):
                self._schedule(b1 + k)
            self._schedule(b0 - 1)

    def read(self, start, nframes):
        """Read [start, start+nframes) through the cache.

        Single-block requests return a view of the cached block (valid
        until the block leaves the cache); multi-block requests allocate.
        Prefer :meth:`read_into` on hot paths.
        """
        start = max(0, min(int(start), self.source.frames))
        nframes = max(0, min(int(nframes), self.source.frames - start))
        if nframes == 0:
            return np.zeros((0, self.source.channels), self._dtype)
        b0 = start // self.block_frames
        b1 = (start + nframes - 1) // self.block_frames
        if b0 == b1:
            block = self._get_block(b0)
            self._schedule_around(b0, b1)
            lo = start - b0 * self.block_frames
            return block[lo : lo + nframes]
        out = np.empty((nframes, self.source.channels), self._dtype)
        return self.read_into(start, nframes, out)

    def read_into(self, start, nframes, out):
        """Copy frames [start, start+nframes) into ``out`` block by block
        — no whole-span concatenate, and nothing in ``out`` aliases the
        cache, so the caller's buffer can be long-lived."""
        start = max(0, min(int(start), self.source.frames))
        nframes = max(0, min(int(nframes), self.source.frames - start))
        if nframes == 0:
            return out[:0]
        b0 = start // self.block_frames
        b1 = (start + nframes - 1) // self.block_frames
        for b in range(b0, b1 + 1):
            block = self._get_block(b)
            bstart = b * self.block_frames
            lo = max(start, bstart)
            hi = min(start + nframes, bstart + len(block))
            if hi > lo:
                out[lo - start : hi - start] = block[lo - bstart : hi - bstart]
        self._schedule_around(b0, b1)
        return out[:nframes]

    def invalidate(self):
        """Drop all cached blocks (e.g. the source's decoding parameters
        changed); reads already in flight are discarded on arrival."""
        with self._lock:
            self._epoch += 1
            while self._cache:
                _, old = self._cache.popitem()
                self._recycle(old)
            self._bytes = 0

    def drain(self):
        """Wait for scheduled read-aheads (tests/shutdown)."""
        self._pool.shutdown(wait=True)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="audian-prefetch")

    def close(self):
        self._pool.shutdown(wait=False)

    def cached_blocks(self):
        with self._lock:
            return sorted(self._cache)
