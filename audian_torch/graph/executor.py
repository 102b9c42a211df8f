"""Chunk executor for the trace DAG, eager on the device.

The counterpart of ``audian_tpu/graph/executor.py``.  The JAX package
traces the active chain of one chunk geometry into one ``jax.jit``
program.  Here the same plan runs eagerly: each node's ``compute`` is a
handful of torch ops on the card (the FIR convolutions through cuDNN, the
STFT as a matmul), launched in graph order.  The plans are still cached
by chunk geometry and node structure, so :attr:`GraphExecutor.cache_size`
keeps its meaning (one entry per geometry; a parameter change adds none),
and the device copies of the node parameters are cached by the identity
of the host design, so a scroll uploads no coefficients.

Eager rather than CUDA graphs: a graph would need static input addresses
and one capture per chunk geometry and design length, and the scroll path
changes geometry with the scroll size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.raw16 import dequant16
from ..utils import resolve_device
from ..utils import trace as _trace
from .graph import RAW, TraceGraph
from .nodes import device_params


@dataclasses.dataclass(frozen=True)
class _NodeGeometry:
    """Static slice geometry of one node for one chunk execution."""

    rel_s0: int   # source-buffer-relative slice start
    rel_s1: int   # source-buffer-relative slice end
    lead: int     # warm-up source frames before the first output frame
    o0: int       # absolute output frame offset
    n_out: int    # output frames produced


class GraphExecutor:
    """Executes a :class:`TraceGraph` over raw chunks on ``device`` (the
    CUDA card unless the caller names another)."""

    def __init__(self, graph: TraceGraph, device=None):
        self.graph = graph
        self.device = resolve_device(device)
        #: plan key (chunk geometry, node structure) -> the active nodes
        self._plans = {}
        #: name -> (host params object, device copy)
        self._dev_params = {}

    def clear_cache(self):
        self._plans.clear()
        self._dev_params.clear()

    @property
    def cache_size(self):
        return len(self._plans)

    # -- geometry ---------------------------------------------------------------

    def _plan(self, raw_offset, raw_frames, active):
        """Host-side geometry pass: walk the DAG forward from the raw
        window and derive each active node's slice/output ranges."""
        ranges = {RAW: (raw_offset, raw_offset + raw_frames)}
        plan = {}
        for node in self.graph.order:
            name = node.name.lower()
            if name not in active:
                continue
            sname = node.source_name.lower()
            if sname not in ranges:
                continue  # source inactive -> cannot compute
            s_avail0, s_avail1 = ranges[sname]
            o0, o1 = node.out_range_for_source(s_avail0, s_avail1)
            if o1 <= o0:
                continue
            s0, s1, lead = node.source_range(o0, o1)
            s0 = max(s0, s_avail0)
            s1 = min(s1, s_avail1)
            lead = min(lead, s1 - s0)
            plan[name] = _NodeGeometry(
                rel_s0=s0 - s_avail0, rel_s1=s1 - s_avail0,
                lead=lead, o0=o0, n_out=o1 - o0,
            )
            ranges[name] = (o0, o1)
        return plan, ranges

    def _key(self, plan, raw_frames, dtype):
        parts = [raw_frames, str(dtype)]
        for node in self.graph.order:
            name = node.name.lower()
            if name in plan:
                g = plan[name]
                parts.append((name, g.rel_s0, g.rel_s1, g.lead, g.n_out,
                              node.static_key()))
        return tuple(parts)

    def _params(self, node):
        """The device copy of ``node``'s parameters, made again only when
        the node replaced its design (nodes replace their params object on
        an update, never mutate it)."""
        name = node.name.lower()
        p = node.params()
        cached = self._dev_params.get(name)
        if cached is None or cached[0] is not p:
            cached = (p, device_params(p, self.device))
            self._dev_params[name] = cached
        return cached[1]

    # -- run --------------------------------------------------------------------

    def run(self, raw_chunk, raw_offset=0, targets=None, pull=False,
            device=None):
        """Compute all (or the ``targets`` subtree of) derived traces from
        one raw chunk.

        Parameters
        ----------
        raw_chunk : (n, channels) raw frames starting at absolute frame
            ``raw_offset``: a tensor or a numpy array, int16 (PCM-16 codes,
            dequantized once here) or float (computed in float32).
        targets : iterable of trace names to produce (plus ancestors);
            all nodes by default.  Invisible traces are not computed.
        pull : return numpy arrays on the host instead of tensors on the
            device.
        device : the JAX package's keyword for the same choice: keep the
            outputs on the device (True) or pull them (False); when given
            it decides, as ``pull = not device``.

        Returns
        -------
        dict name -> (offset, array): the absolute output frame offset and
        the computed frames for every produced trace, including ``"data"``.
        """
        if device is not None:
            pull = not device
        if targets is None:
            targets = [n.name for n in self.graph.order]
        active = self.graph.active_set(targets)
        if isinstance(raw_chunk, torch.Tensor):
            raw = raw_chunk.to(self.device)
        else:
            # a copy: host chunks may be views of buffers their owner
            # recycles, and a pass-through output would alias them
            raw = torch.tensor(np.asarray(raw_chunk), device=self.device)
        raw_frames = int(raw.shape[0])
        plan, _ = self._plan(int(raw_offset), raw_frames, active)
        key = self._key(plan, raw_frames, raw.dtype)
        nodes = self._plans.get(key)
        if nodes is None:
            nodes = [n for n in self.graph.order if n.name.lower() in plan]
            self._plans[key] = nodes
            _trace.trace_event("graph.build", frames=raw_frames,
                               nodes=",".join(sorted(plan)))
        params = {node.name.lower(): self._params(node) for node in nodes}
        # the structured replacement for the reference's per-chunk print
        # (`src/audian/buffereddata.py:92`); it times the launches
        with _trace.timed("graph.run", offset=int(raw_offset),
                          frames=raw_frames, nodes=len(plan)):
            raw = dequant16(raw) if raw.dtype == torch.int16 else raw.to(
                torch.float32)
            bufs = {RAW: (int(raw_offset), raw)}
            for node in nodes:
                g = plan[node.name.lower()]
                src = bufs[node.source_name.lower()][1][g.rel_s0 : g.rel_s1]
                bufs[node.name.lower()] = (
                    g.o0, node.compute(src, g.lead, g.n_out,
                                       params[node.name.lower()]))
        if pull:
            return {k: (off, arr.cpu().numpy()) for k, (off, arr)
                    in bufs.items()}
        return bufs
