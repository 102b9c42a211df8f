"""Sequence/channel-sharded execution of the default DSP chain.

The counterpart of ``audian_tpu/parallel/pipeline.py``: the time axis of a
whole recording is sharded over the mesh's ``seq`` axis, channels over
``ch``; each shard takes its window extended by its neighbours' halos
(uploaded in one piece from the recording, :func:`.shard.halo_window`)
and runs the band-pass -> rectified envelope / PSD spectrogram chain on
its own device.  Where the JAX
package runs XLA ops inside ``shard_map``, each shard here runs the port's
chain on its device (:class:`audian_torch.ops.fused.FusedChainCF`): the
single-pass chain kernel when the design passes its gate and the
pipeline's halos cover the kernel's, else the per-stage window matmuls.
A shard goes through the chain in chunks of at most 2^22 frames (plus
halos), so the kernels' temporaries stay bounded at any recording length.

Numerical contract (the JAX pipeline's): interior frames match
whole-recording execution within the FIR truncation tolerance.  At the
global head and tail the envelope sees zero padding where scipy's
``sosfiltfilt`` odd-reflects, so the first and last envelope halo of the
whole recording carry a bounded edge artifact.  The causal filter path
is exact (zero initial conditions are scipy's own start of a recording).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.design import filtfilt_sym_kernel
from ..ops.fused import FusedChainCF, kernel_arrays
from ..ops.minmax import minmax_interleaved
from ..ops.raw16 import dequant16
from ..utils import round_up as _round_up
from .shard import halo_window

__all__ = ["ShardedPipeline"]

#: frames of a shard per chain call (the batch path's chunk)
CHUNK = 1 << 22


class ShardedPipeline:
    """The sharded chain over a fixed mesh and chain configuration.

    Parameters
    ----------
    mesh : :class:`audian_torch.parallel.Mesh` with axes ("seq", "ch").
    rate : sample rate (Hz).
    filt : optional :class:`audian_torch.ops.design.FilterDesign`
        (band-pass), run as its truncated impulse response ``fir.h``.
    env : optional FilterDesign of the envelope smoother, run as one
        symmetric kernel.
    env_clamp : clamp the envelope at zero (pure-lowpass mode).
    nfft, hop : spectrogram geometry; ``spectrogram=False`` disables it.
    minmax_step : when set, also emit the interleaved min/max overview of
        the raw trace at this decimation step.
    dtype : the type a non-int16 input is cast to (the shards compute in
        float32 from the cast values).
    """

    def __init__(self, mesh, rate, filt=None, env=None, env_clamp=True,
                 nfft=256, hop=None, spectrogram=True, minmax_step=None,
                 dtype=torch.float32):
        g, delay = (filtfilt_sym_kernel(env.sos, eps=env.fir.eps)
                    if env is not None else (None, 0))
        self._setup(mesh, {
            "rate": rate, "h_filt": None if filt is None else filt.fir.h,
            "g_env": g, "env_delay": delay, "env_clamp": env_clamp,
            "nfft": nfft, "hop": hop, "spectrogram": spectrogram,
            "minmax_step": minmax_step}, dtype)

    @classmethod
    def from_arrays(cls, mesh, arrays, dtype=torch.float32):
        """A pipeline over precomputed kernels (the keys of
        :data:`audian_torch.convert.SHARDED_KEYS`)."""
        self = cls.__new__(cls)
        self._setup(mesh, arrays, dtype)
        return self

    def _setup(self, mesh, a, dtype):
        self.mesh = mesh
        self.dtype = dtype
        self.rate = float(a["rate"])
        self.env_clamp = bool(a["env_clamp"])
        self.with_spec = bool(a["spectrogram"])
        self.nfft = int(a["nfft"])
        self.hop = int(a["hop"]) if a["hop"] else self.nfft // 2
        self.minmax_step = (int(a["minmax_step"]) if a["minmax_step"]
                            else None)
        h = None if a["h_filt"] is None else np.asarray(a["h_filt"],
                                                         np.float64)
        g = None if a["g_env"] is None else np.asarray(a["g_env"],
                                                        np.float64)
        self.has_env = g is not None
        self._arrays = kernel_arrays(self.rate, h, g, a["env_delay"],
                                     self.env_clamp, self.nfft, self.hop)
        env_halo = int(a["env_delay"]) + 1 if g is not None else 0
        hb = (len(h) if h is not None else 0) + env_halo
        ha = max(env_halo, (self.nfft - self.hop) if self.with_spec else 0)
        # halos snap to the hop/minmax grid so output frames stay aligned
        self.align = self.hop if self.with_spec else 1
        if self.minmax_step:
            self.align = math.lcm(self.align, self.minmax_step)
        self.hb = _round_up(max(hb, 1), self.align)
        self.ha = _round_up(max(ha, 1), self.align)
        self.chunk = max(CHUNK // self.align, 1) * self.align
        self._chains = {}

    def chain(self, device):
        """The shard-local chain on ``device`` (one per distinct device)."""
        fc = self._chains.get(device)
        if fc is None:
            fc = FusedChainCF.from_arrays(self._arrays, device=device)
            self._chains[device] = fc
        return fc

    def takes_chain_kernel(self, fc):
        """Whether the shards run the single-pass chain kernel: the design
        passes its gate and the pipeline's halos cover the kernel's."""
        ck = fc.chain_kernel
        return ck is not None and self.hb >= ck.hb and self.ha >= ck.ha

    def padded_length(self, n):
        """Global length after padding: a multiple of seq * align."""
        return _round_up(n, self.mesh.shape["seq"] * self.align)

    # -- execution ------------------------------------------------------------

    def _local(self, fc, win, k):
        """The chain over one chunk window ``win = [hb | k | ha]``
        (time-first, on the shard's device): a dict of the chunk's
        outputs, time-first."""
        hb = self.hb
        x_cf = win.T.contiguous()
        if x_cf.dtype not in (torch.int16, torch.float32):
            x_cf = x_cf.float()
        out = {}
        if self.takes_chain_kernel(fc):
            outputs = ("filtered", "envelope") + (
                ("spectrogram",) if self.with_spec else ())
            # the kernel's own halos are within the window's
            xk = x_cf[:, hb - fc.chain_kernel.hb:].contiguous()
            y, e, s = fc.chain_cf(xk, k, outputs=outputs)
            out["filtered"], out["envelope"] = y.T, e.T
            if s is not None:
                out["spectrogram"] = s
        else:
            if x_cf.dtype == torch.int16:
                x_cf = dequant16(x_cf)
            y_ext = fc.filtered_cf(x_cf)
            out["filtered"] = y_ext[:, hb : hb + k].T
            if self.has_env:
                d = fc.env_delay
                e = fc.envelope_cf(y_ext[:, hb - d : hb + k + d])
                out["envelope"] = e[:, d : d + k].T
            if self.with_spec:
                seg = y_ext[:, hb : hb + k + self.nfft - self.hop]
                out["spectrogram"] = fc.spectrogram_fc(
                    seg.contiguous(), nframes=k // self.hop)
        if self.minmax_step:
            raw = win[hb : hb + k]
            if raw.dtype == torch.int16:
                raw = dequant16(raw)
            out["minmax"] = minmax_interleaved(raw, self.minmax_step)
        return out

    def shard_window(self, x, r0, L, c0, cw, device):
        """Shard ``[r0, r0 + L)`` of channels ``[c0, c0 + cw)`` on
        ``device`` with its halos, ``[hb | L | ha]``: zero before the
        recording, past its end and past its channels (the global zero
        padding, which also makes the halos of a single ``seq`` shard)."""
        return halo_window(x, r0 - self.hb, self.hb + L + self.ha, device,
                           c0, cw)

    def __call__(self, x):
        """Run the sharded chain over a whole recording ``(n, channels)``
        (numpy or a tensor; int16 is raw PCM-16 and stays int16 up to the
        shard-local dequantization, anything else is cast to ``dtype``).

        Returns a dict of global tensors on the mesh's first device:
        ``filtered``/``envelope`` ``(n_pad, C)``, ``spectrogram``
        ``(n_pad/hop, C, nfft//2+1)``, optional ``minmax`` (real bins
        only).  The time axis stays padded to ``padded_length(n)``;
        channels are padded to the mesh internally and trimmed back.
        """
        if isinstance(x, torch.Tensor):
            if x.dtype != torch.int16:
                x = x.to(self.dtype)
        else:
            x = np.asarray(x)
            if x.dtype != np.int16:
                # numpy input stays on the host until its shards upload
                x = (x.astype(np.float32, copy=False)
                     if self.dtype == torch.float32
                     else torch.as_tensor(x).to(self.dtype))
        n, C = x.shape
        n_pad = self.padded_length(n)
        nseq, nch = self.mesh.shape["seq"], self.mesh.shape["ch"]
        L = n_pad // nseq
        if nseq > 1 and max(self.hb, self.ha) > L:
            # the JAX pipeline's one-neighbour limit (its halos come from
            # the adjacent shards); with one seq shard the halos are zero
            # padding and any clip length works
            raise ValueError(
                f"per-shard length {L} frames is smaller than the halo "
                f"(hb={self.hb}, ha={self.ha}) — one neighbor exchange "
                f"cannot provide it; use fewer 'seq' shards, a longer "
                f"recording, or a shorter filter kernel")
        cw = -(-C // nch)                 # channels padded to the ch axis
        odev = self.mesh.devices[0, 0]
        nbins = self.nfft // 2 + 1
        out = {"filtered": torch.empty((n_pad, C), device=odev)}
        if self.has_env:
            out["envelope"] = torch.empty((n_pad, C), device=odev)
        if self.with_spec:
            out["spectrogram"] = torch.empty((n_pad // self.hop, C, nbins),
                                             device=odev)
        if self.minmax_step:
            out["minmax"] = torch.empty((2 * n_pad // self.minmax_step, C),
                                        device=odev)

        def first_row(key, g):
            """The output row of global frame ``g`` (a chunk start)."""
            if key == "spectrogram":
                return g // self.hop
            if key == "minmax":
                return 2 * g // self.minmax_step
            return g
        for j in range(nch):
            c0 = j * cw
            c1 = min(c0 + cw, C)
            if c1 <= c0:
                continue                  # a channel group of padding only
            for i in range(nseq):
                dev = self.mesh.devices[i, j]
                ext = self.shard_window(x, i * L, L, c0, cw, dev)
                fc = self.chain(dev)
                for s in range(0, L, self.chunk):
                    k = min(self.chunk, L - s)
                    part = self._local(
                        fc, ext[s : s + self.hb + k + self.ha], k)
                    for key, val in part.items():
                        r0 = first_row(key, i * L + s)
                        out[key][r0 : r0 + val.shape[0], c0:c1].copy_(
                            val[:, : c1 - c0], non_blocking=True)
                del ext
        if self.minmax_step and n_pad != n:
            # the global zero padding lands in the overview's tail bins:
            # keep only the real bins and recompute the final (partial)
            # one from real samples, as the interactive
            # minmax_interleaved does with a ragged tail
            step = self.minmax_step
            nseg = -(-n // step)
            mm = out["minmax"][: 2 * nseg]
            if n % step:
                tail = x[(nseg - 1) * step : n]
                if isinstance(tail, np.ndarray):
                    tail = torch.from_numpy(np.ascontiguousarray(tail))
                tail = tail.to(odev)
                if tail.dtype == torch.int16:
                    tail = dequant16(tail)
                mm[-2] = torch.amin(tail, dim=0)
                mm[-1] = torch.amax(tail, dim=0)
            out["minmax"] = mm
        return out
