"""Trace graph nodes: static geometry on the host, compute on tensors.

The counterpart of ``audian_tpu/graph/nodes.py``.  Each node splits into

- static *geometry*: which source frame range a given output frame range
  needs (halo, warm-up and STFT window math), resolved on the host and
  copied from the JAX package unchanged;
- *params*: the host design the node computes with (a
  :class:`~audian_torch.ops.design.FilterDesign`, a Hann window), whose
  device copy :meth:`Node.upload` makes once per design (the spectrogram
  keeps its window on the host: the STFT builds its analysis bank from it
  there);
- ``compute(source, lead, n_out, params)``: tensor ops on the source's
  device, through the port's FIR filtering and STFT ops.

Halos are declared in seconds.  The filter's and the envelope's follow the
impulse-response decay of their current design, which
:meth:`FilterDesign.from_sos` truncates at its eps and rounds up to a power
of two (a cutoff change can shrink it as well as grow it); the
spectrogram's is its window overhang.  There is no host (scipy) twin of
``compute``: the JAX package keeps one for its device-loss mode, which the
port does not have.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.cuda.fir import upload_taps
from ..ops.design import FilterDesign, design_envelope_filter, design_filter
from ..ops.sos import sosfilt_fir, sosfiltfilt_fir
from ..ops.stft import (hann_window, spectrogram_frequencies,
                        spectrogram_padded)
from .spec import TraceSpec


def device_params(params, device):
    """The device copy of a node's parameters: a design's FIR taps, state
    response and steady-state conditions as float32 tensors (what
    ``compute`` reads), a window as a float32 tensor; ``None`` (a
    pass-through or infeasible design) stays ``None``."""
    if params is None:
        return None

    def put(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    if isinstance(params, FilterDesign):
        # the taps with the FIR kernel's operand of them (ops/cuda/fir.py)
        fir = dataclasses.replace(params.fir,
                                  h=upload_taps(params.fir.h, device),
                                  state_out=put(params.fir.state_out))
        return dataclasses.replace(params, zi0=put(params.zi0), fir=fir)
    return put(params)


def device_nbytes(dev_params):
    """The bytes :meth:`Node.upload` copied to the device (none for a
    window kept on the host)."""
    if dev_params is None or isinstance(dev_params, np.ndarray):
        return 0
    if isinstance(dev_params, FilterDesign):
        return (dev_params.zi0.nbytes + dev_params.fir.h.nbytes
                + dev_params.fir.state_out.nbytes)
    return dev_params.nbytes


class Node:
    """Base class for derived-trace nodes.

    Subclasses set ``halo_before``/``halo_after`` (seconds of *source*
    context needed beyond the frames that map to the requested output) and
    implement :meth:`open`, :meth:`params` and :meth:`compute`.
    """

    #: seconds of source context required before/after the output window
    halo_before = 0.0
    halo_after = 0.0
    #: source frames advanced per output frame (integer; >1 decimates)
    step = 1
    #: additional source frames one output frame looks at beyond ``step``
    window = 1

    # display defaults, mirroring the reference's constructor args
    panel = "trace"
    panel_type = "trace"
    color = "#00ee00"
    lw_thin = 1.1
    lw_thick = 2

    def __init__(self, name, source="data", panel=None, panel_type=None,
                 color=None, lw_thin=None, lw_thick=None):
        self.name = name
        self.source_name = source
        self.spec = None
        self.source_spec = None
        for attr, val in [("panel", panel), ("panel_type", panel_type),
                          ("color", color), ("lw_thin", lw_thin),
                          ("lw_thick", lw_thick)]:
            if val is not None:
                setattr(self, attr, val)

    # -- static geometry ----------------------------------------------------

    def open(self, source_spec: TraceSpec) -> TraceSpec:
        """Derive this node's output spec from its source's; design any
        filters.  Must set ``self.spec`` and return it."""
        self.source_spec = source_spec
        self.spec = source_spec
        return self.spec

    def halo_frames(self):
        """Source-frame halos ``(before, after)``: extra context beyond the
        frames the output window maps onto (window overhang is accounted
        for separately in the range math)."""
        sb = int(math.ceil(self.halo_before * self.source_spec.rate))
        sa = int(math.ceil(self.halo_after * self.source_spec.rate))
        return sb, sa

    def halo_seconds(self):
        """(before, after) in seconds of source time, including the STFT
        window overhang — the quantity the graph folds backward to size
        the raw fetch.

        The overhang is ``window - 1`` (not ``window - step``): the last
        frame whose grid position falls inside a chunk can start up to
        ``step - 1`` samples before the chunk edge, so folding only
        ``window - step`` drops one boundary frame whenever chunk edges are
        not step-aligned and the upstream halos are smaller than a
        window."""
        overhang = max(self.window - 1, 0) / self.source_spec.rate
        return self.halo_before, self.halo_after + overhang

    def source_range(self, o0, o1):
        """Source frame range (with halos, clipped to the recording) that
        producing output frames ``[o0, o1)`` requires.

        Returns ``(s0, s1, lead)`` where ``lead`` is the number of warm-up
        source frames preceding the first output-aligned source frame.
        """
        sb, sa = self.halo_frames()
        anchor = o0 * self.step
        s0 = max(anchor - sb, 0)
        s1 = min((o1 - 1) * self.step + self.window + sa,
                 self.source_spec.frames)
        return s0, s1, anchor - s0

    def out_range_for_source(self, s0, s1):
        """Largest output frame range computable from source frames
        ``[s0, s1)`` under this node's halo requirements (used when walking
        the graph forward from a raw window).

        At the recording edges halos and windows are relaxed: no warm-up
        exists before frame 0, and tail output frames may see partial
        windows.
        """
        sb, sa = self.halo_frames()
        lo = s0 + (sb if s0 > 0 else 0)
        hi = s1 - (sa if s1 < self.source_spec.frames else 0)
        o0 = -(-lo // self.step)
        if s1 >= self.source_spec.frames:
            o1 = self.spec.frames
        else:
            o1 = (hi - self.window) // self.step + 1
        return o0, max(o1, o0)

    # -- dynamic part --------------------------------------------------------

    def params(self):
        """Host parameters consumed by :meth:`compute` (through
        :meth:`upload`)."""
        return None

    def upload(self, params, device):
        """What :meth:`compute` takes of :meth:`params` on ``device``:
        :func:`device_params`."""
        return device_params(params, device)

    def static_key(self):
        """Hashable summary of every attribute :meth:`compute` depends on
        beyond its params: part of the executor's plan key."""
        return (type(self).__name__,)

    @property
    def taps(self):
        """The FIR length :meth:`compute` runs, ``None`` where it runs no
        FIR: a field of the node's ``graph.node`` span."""
        design = getattr(self, "design", None)
        return design.fir.length if isinstance(design, FilterDesign) else None

    def compute(self, source, lead, n_out, params):
        """Map ``source`` (a tensor ``(ns, channels, ...)``, including
        ``lead`` warm-up frames) to ``n_out`` output frames."""
        raise NotImplementedError

    def update(self, **kwargs):
        """Host-side parameter update (filter redesign etc.).  Returns True
        when downstream recomputation is needed."""
        return False


class FilterNode(Node):
    """On-the-fly Butterworth high/low/band-pass: a pass-through until a
    cutoff is set, a warm-up halo of the design's impulse-response decay
    length, and the truncated-impulse FIR of :func:`sosfilt_fir`."""

    color = "#00ee00"

    def __init__(self, name="filtered", source="data", **kwargs):
        super().__init__(name, source, **kwargs)
        self.highpass_cutoff = 0.0
        self.lowpass_cutoff = None
        self.filter_order = 2
        self.design = None

    @property
    def halo_before(self):
        """Warm-up halo: the current design's impulse-response length."""
        if self.design is None or self.source_spec is None:
            return 0.0
        return self.design.fir.length / self.source_spec.rate

    def open(self, source_spec):
        # defaults only on the first open (or a rate change): adding a
        # trace re-opens the whole graph and must keep a user's cutoffs
        first = (self.source_spec is None
                 or self.source_spec.rate != source_spec.rate)
        self.source_spec = source_spec
        self.spec = source_spec
        if first:
            self.highpass_cutoff = 0.0
            self.lowpass_cutoff = source_spec.rate / 2
            self.design = None
        self._redesign()
        return self.spec

    def _redesign(self):
        sos = design_filter(self.source_spec.rate, self.highpass_cutoff,
                            self.lowpass_cutoff, self.filter_order)
        old = self.design
        self.design = None if sos is None else FilterDesign.from_sos(sos)
        return (old is None) != (self.design is None)

    def update(self, highpass_cutoff=None, lowpass_cutoff=None, order=None):
        if highpass_cutoff is not None:
            self.highpass_cutoff = highpass_cutoff
        if lowpass_cutoff is not None:
            self.lowpass_cutoff = lowpass_cutoff
        if order is not None:
            self.filter_order = order
        self._redesign()
        return True

    def params(self):
        return self.design

    def static_key(self):
        return ("filter", self.design is None)

    def compute(self, source, lead, n_out, params):
        if params is None:  # pass-through
            return source[lead : lead + n_out]
        y = sosfilt_fir(params.fir, source, axis=0, return_zf=False)
        return y[lead : lead + n_out].contiguous()


class EnvelopeNode(Node):
    """Rectified zero-phase envelope: pi/2 rectification, ``sosfiltfilt``
    smoothing on the FIR path, clamped at zero for a pure low-pass.  Both
    halos are the impulse decay length plus the edge padding, since
    zero-phase smoothing reads the future as much as the past."""

    color = "#ff8800"
    lw_thin = 2.5
    lw_thick = 4

    @property
    def halo_before(self):
        if self.design is None or self.source_spec is None:
            return 0.0
        return ((self.design.fir.length + self.design.padlen)
                / self.source_spec.rate)

    halo_after = halo_before

    def __init__(self, name="envelope", source="filtered",
                 envelope_cutoff=500.0, highpass_cutoff=0.0, filter_order=2,
                 **kwargs):
        super().__init__(name, source, **kwargs)
        self.envelope_cutoff = envelope_cutoff
        self.highpass_cutoff = highpass_cutoff
        self.filter_order = filter_order
        self.design = None

    def open(self, source_spec):
        self.source_spec = source_spec
        self.spec = source_spec
        self._redesign()
        return self.spec

    def _redesign(self):
        sos = design_envelope_filter(self.source_spec.rate,
                                     self.envelope_cutoff,
                                     self.highpass_cutoff,
                                     self.filter_order)
        self.design = None if sos is None else FilterDesign.from_sos(sos)

    def update(self, envelope_cutoff=None, highpass_cutoff=None, order=None):
        if envelope_cutoff is not None:
            self.envelope_cutoff = envelope_cutoff
        if highpass_cutoff is not None:
            self.highpass_cutoff = highpass_cutoff
        if order is not None:
            self.filter_order = order
        self._redesign()
        return True

    def params(self):
        return self.design

    def static_key(self):
        return ("envelope", self.design is None, self.highpass_cutoff == 0,
                None if self.design is None else self.design.padlen)

    def compute(self, source, lead, n_out, params):
        # an infeasible design, or a window no longer than the filtfilt
        # pad (it cannot be reflected), gives zeros
        if params is None or source.shape[0] <= params.padlen:
            return source.new_zeros((n_out,) + tuple(source.shape[1:]))
        rect = (math.pi / 2) * torch.abs(source)
        env = sosfiltfilt_fir(params.fir, rect, params.zi0, params.padlen,
                              axis=0)
        if self.highpass_cutoff == 0:
            env = torch.clamp_min(env, 0.0)
        return env[lead : lead + n_out].contiguous()


class SpectrogramNode(Node):
    """STFT power spectrogram trace: output rate ``source_rate / hop``,
    ``nfft // 2 + 1`` frequency bins, NFFT and overlap re-specced through
    :meth:`update` with the reference's clamping rules."""

    halo_after = 0.0  # the true requirement is the window overhang
    panel = "spectrogram"
    panel_type = "spectrogram"

    def __init__(self, name="spectrogram", source="filtered", nfft=256,
                 overlap_frac=0.5, **kwargs):
        super().__init__(name, source, **kwargs)
        self.nfft = int(nfft)
        self.overlap_frac = float(overlap_frac)
        self.hop = max(int(round((1 - self.overlap_frac) * self.nfft)), 1)

    # geometry ---------------------------------------------------------------

    @property
    def step(self):
        return self.hop

    @property
    def window(self):
        return self.nfft

    def _set_hop(self):
        """Clamp hop to [1, nfft] and keep overlap_frac consistent."""
        hop = int(round((1 - self.overlap_frac) * self.nfft))
        hop = min(max(hop, 1), self.nfft)
        changed = hop != self.hop
        self.hop = hop
        self.overlap_frac = 1 - hop / self.nfft
        return changed

    def open(self, source_spec):
        self.source_spec = source_spec
        self._set_hop()
        nbins = self.nfft // 2 + 1
        frames = -(-source_spec.frames // self.hop)
        self.spec = source_spec.decimate(
            self.hop, frames=frames, more_shape=(nbins,),
            unit=f"{source_spec.unit}^2/Hz", ampl_min=0.0,
            ampl_max=source_spec.rate / 2,
        )
        return self.spec

    @property
    def frequencies(self):
        return spectrogram_frequencies(self.source_spec.rate, self.nfft)

    @property
    def fresolution(self):
        return self.source_spec.rate / self.nfft

    @property
    def tresolution(self):
        return self.hop / self.source_spec.rate

    def update(self, nfft=None, overlap_frac=None):
        """Re-spec NFFT/overlap with the reference's clamping.  Returns
        True when the geometry changed (the caller re-opens the chain
        downstream)."""
        changed = False
        if nfft is not None:
            nfft = max(int(nfft), 8)
            max_nfft = min(self.source_spec.frames // 2, 2 ** 30)
            nfft = min(nfft, max_nfft)
            if nfft != self.nfft:
                self.nfft = nfft
                changed = True
        if overlap_frac is not None:
            self.overlap_frac = min(max(float(overlap_frac), 0.0), 0.99999)
        if self._set_hop():
            changed = True
        if changed:
            self.open(self.source_spec)
        return changed

    # compute ----------------------------------------------------------------

    def params(self):
        return hann_window(self.nfft)

    def upload(self, params, device):
        """The window stays a float32 host array: the STFT's kernel route
        builds its analysis bank from it on the host, once a window
        (:mod:`audian_torch.ops.stft`)."""
        return None if params is None else np.asarray(params, np.float32)

    def static_key(self):
        return ("spectrogram", self.nfft, self.hop)

    def compute(self, source, lead, n_out, params):
        # lead is already a multiple-of-hop alignment offset
        # tail frames whose STFT window overhangs the chunk are zero
        return spectrogram_padded(source[lead:], self.source_spec.rate,
                                  self.nfft, self.hop, n_out, window=params)

    def estimate_noiselevels(self, power_db_tail, power_db_all):
        """Auto color levels from the noise floor: zmin = 95th percentile
        of the top-frequency-sixteenth dB values, zmax compressed to 95 %
        of the span, clamped to [20, 80] dB."""
        zmin = float(np.percentile(power_db_tail, 95))
        zmax = float(np.max(power_db_all))
        if not (np.isfinite(zmin) and np.isfinite(zmax)):
            return None, None
        zmax = zmin + 0.95 * (zmax - zmin)
        if zmax - zmin < 20:
            zmax = zmin + 20
        if zmax - zmin > 80:
            zmin = zmax - 80
        return zmin, zmax
