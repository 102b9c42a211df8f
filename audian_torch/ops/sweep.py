"""Multi-resolution spectrogram sweeps and the dB tile formula.

The counterpart of ``audian_tpu/ops/sweep.py``.  Stepping NFFT in the
browser looks at one signal at several resolutions; :func:`spectrogram_sweep`
computes them all from one upload, and :func:`db_quantize` turns power
into the uint8 dB tiles the GUI draws.  :func:`db_normalize` is the one dB
and colour-level formula of the port: the render tilers use it too, so
sweep tiles and view tiles cannot quantize differently.
"""

from __future__ import annotations

import torch

from ..utils import on_device
from .stft import spectrogram

__all__ = ["FULL_NFFTS", "SWEEP_NFFTS", "db_normalize", "db_quantize",
           "spectrogram_sweep"]

#: the reference UI exposes NFFT 2^3..2^19; the interactive sweep covers
#: the practically used band
SWEEP_NFFTS = (128, 256, 512, 1024, 2048, 4096)

#: the reference's complete UI ladder
FULL_NFFTS = tuple(2 ** k for k in range(3, 20))


def spectrogram_sweep(x, rate, nffts=SWEEP_NFFTS, overlap_frac=0.5,
                      device=None):
    """Every requested resolution of ``x`` ((n,) or (n, channels); a tensor
    is computed where it lies, host data on ``device``, the CUDA card by
    default).

    Returns ``{nfft: Sxx}`` with each ``Sxx`` shaped
    ``(nframes(nfft), ..., nfft//2+1)``.
    """
    x = on_device(x, device)
    out = {}
    for nfft in nffts:
        nfft = int(nfft)
        hop = max(int(round((1 - overlap_frac) * nfft)), 1)
        out[nfft] = spectrogram(x, float(rate), nfft, hop)
    return out


def db_normalize(power, zmin, zmax):
    """Power -> dB normalized to [0, 1] over [zmin, zmax] (``zmin`` and
    ``zmax`` numbers or tensors that broadcast against ``power``)."""
    db = 10.0 * torch.log10(torch.clamp_min(power, 1e-20))
    # span floor: a degenerate zmin == zmax would put NaNs in the tile
    span = torch.clamp_min(torch.as_tensor(zmax - zmin, dtype=db.dtype,
                                           device=db.device), 1e-12)
    return torch.clamp((db - zmin) / span, 0.0, 1.0)


def db_quantize(power, zmin, zmax):
    """Power -> uint8 dB tile clipped to [zmin, zmax]: rounded half to
    even (as ``jnp.round``) after the clip, so the cast never wraps."""
    return torch.round(255.0 * db_normalize(power, zmin, zmax)).to(
        torch.uint8)
