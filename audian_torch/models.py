"""Chain presets: the named processing chains of audian.  Each builds the
trace nodes of the interactive graph (:meth:`ChainPreset.nodes`), the
matching batch chain (:meth:`ChainPreset.fused`) and the mesh-sharded
pipeline (:meth:`ChainPreset.sharded`), so interactive, batch and sharded
runs of one analysis agree by construction."""

from __future__ import annotations

import dataclasses

from .graph import EnvelopeNode, FilterNode, SpectrogramNode
from .ops.cuda.precision import HIGHEST
from .ops.design import FilterDesign, design_envelope_filter, design_filter
from .ops.fused import FusedChainCF
from .parallel import ShardedPipeline

__all__ = ["ChainPreset", "PRESETS", "get_preset"]


@dataclasses.dataclass(frozen=True)
class ChainPreset:
    """One named processing chain."""

    name: str
    description: str
    highpass_cutoff: float = 0.0
    lowpass_cutoff: float | None = None
    filter_order: int = 2
    envelope_cutoff: float | None = None
    nfft: int = 256
    overlap_frac: float = 0.5

    def nodes(self):
        """Trace nodes for the interactive graph."""
        out = [FilterNode("filtered", "data")]
        if self.envelope_cutoff:
            out.append(EnvelopeNode("envelope", "filtered",
                                    envelope_cutoff=self.envelope_cutoff))
        out.append(SpectrogramNode("spectrogram", "filtered",
                                   nfft=self.nfft,
                                   overlap_frac=self.overlap_frac))
        return out

    def apply(self, data):
        """Install the filter design on an (open) ``Data``."""
        if "filtered" in data and (self.highpass_cutoff
                                   or self.lowpass_cutoff):
            data["filtered"].update(highpass_cutoff=self.highpass_cutoff,
                                    lowpass_cutoff=self.lowpass_cutoff)
        return data

    def fused(self, rate, eps=1e-7, device=None, precision=HIGHEST):
        """The matching channels-first batch chain on ``device`` (the CUDA
        card by default; "cpu" runs the plain versions), its products at
        ``precision`` (:class:`FusedChainCF`)."""
        filt = design_filter(rate, self.highpass_cutoff,
                             self.lowpass_cutoff, self.filter_order)
        env = (design_envelope_filter(rate, self.envelope_cutoff)
               if self.envelope_cutoff else None)
        hop = max(int(round((1 - self.overlap_frac) * self.nfft)), 1)
        return FusedChainCF(rate, filt_sos=filt, env_sos=env,
                            nfft=self.nfft, hop=hop, eps=eps, device=device,
                            precision=precision)

    def sharded(self, mesh, rate, eps=1e-7, minmax_step=None):
        """The matching mesh-sharded pipeline (on the devices of
        ``mesh``).  Its designs use the default truncation; ``eps`` is
        accepted as the JAX package's ``sharded`` accepts it, and has no
        effect there either."""
        filt = design_filter(rate, self.highpass_cutoff,
                             self.lowpass_cutoff, self.filter_order)
        env = (design_envelope_filter(rate, self.envelope_cutoff)
               if self.envelope_cutoff else None)
        hop = max(int(round((1 - self.overlap_frac) * self.nfft)), 1)
        return ShardedPipeline(
            mesh, rate,
            filt=None if filt is None else FilterDesign.from_sos(filt),
            env=None if env is None else FilterDesign.from_sos(env),
            nfft=self.nfft, hop=hop, minmax_step=minmax_step,
        )


PRESETS = {
    "browser": ChainPreset(
        "browser",
        "the default interactive chain: full-band filter + NFFT-256 "
        "spectrogram",
    ),
    "browser-envelope": ChainPreset(
        "browser-envelope",
        "browser chain plus the 500 Hz rectified envelope trace",
        envelope_cutoff=500.0,
    ),
    "bioacoustics": ChainPreset(
        "bioacoustics",
        "2-40 kHz bandpass + envelope + spectrogram (the headline "
        "benchmark chain)",
        highpass_cutoff=2000.0, lowpass_cutoff=40000.0,
        envelope_cutoff=500.0,
    ),
    "ultrasound": ChainPreset(
        "ultrasound",
        "20-90 kHz bandpass with fine frequency resolution for bat-style "
        "recordings",
        highpass_cutoff=20000.0, lowpass_cutoff=90000.0,
        envelope_cutoff=1000.0, nfft=512,
    ),
}


def get_preset(name):
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {', '.join(PRESETS)}"
        ) from None
