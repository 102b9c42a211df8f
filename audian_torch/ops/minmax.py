"""Min/max decimation and multi-resolution pyramids on tensors.

The counterpart of ``audian_tpu/ops/minmax.py``.  A trace window is
decimated to per-segment (min, max) pairs by a reshape and a reduction,
the ragged tail padded with the reduction's neutral value; a log-2
pyramid folds pairs of extrema level by level, so any zoom level is a
slice of the nearest level.

Output layout is the reference's interleaved convention (``out[0::2] =
min``, ``out[1::2] = max`` per segment).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import on_device

__all__ = [
    "interleave_minmax",
    "minmax_decimate",
    "minmax_interleaved",
    "minmax_pyramid",
    "pyramid_levels",
    "reduceat_like",
]


def _extremes(dtype):
    """``(largest, smallest)`` value of ``dtype``: the neutral pads of a
    min and a max."""
    if dtype.is_floating_point:
        return float("inf"), float("-inf")
    info = torch.iinfo(dtype)
    return info.max, info.min


def _segment_reduce(x, step):
    """Per-segment (min, max) along axis 0; ragged tail padded neutrally.

    Returns two tensors of shape ``(ceil(n/step),) + x.shape[1:]``.
    """
    n = x.shape[0]
    nseg = -(-n // step)
    pad = nseg * step - n
    if pad:
        hi, lo = _extremes(x.dtype)
        tail = (pad,) + tuple(x.shape[1:])
        xmin = torch.cat([x, x.new_full(tail, hi)])
        xmax = torch.cat([x, x.new_full(tail, lo)])
    else:
        xmin = xmax = x
    shape = (nseg, step) + tuple(x.shape[1:])
    return (torch.amin(xmin.reshape(shape), dim=1),
            torch.amax(xmax.reshape(shape), dim=1))


def minmax_decimate(x, step, device=None):
    """Segment-wise minima and maxima (segments of ``step`` samples along
    axis 0, the ragged tail reduced over the remaining samples: the
    reduceat semantics of the reference).  ``x`` is a tensor (computed
    where it lies) or host data (moved to ``device``, the CUDA card by
    default).

    Returns ``(mins, maxs)``, each ``(ceil(n/step),) + x.shape[1:]``.
    """
    x = on_device(x, device)
    if step <= 1:
        return x, x
    return _segment_reduce(x, step)


def interleave_minmax(mins, maxs):
    """Interleave to the reference's plot/cache layout:
    ``out[0::2] = mins``, ``out[1::2] = maxs``."""
    stacked = torch.stack([mins, maxs], dim=1)
    return stacked.reshape((2 * mins.shape[0],) + tuple(mins.shape[1:]))


def minmax_interleaved(x, step, device=None):
    """Decimate and interleave in one call (the per-view hot path)."""
    return interleave_minmax(*minmax_decimate(x, step, device))


def pyramid_levels(n, base_step, min_len=2):
    """Number of power-of-two pyramid levels above ``base_step`` until a
    level has fewer than ``min_len`` segments."""
    levels = 0
    nseg = -(-n // base_step)
    while nseg >= min_len:
        levels += 1
        nseg = -(-nseg // 2)  # each fold keeps ceil(nseg/2) segments
    return max(levels, 1)


def minmax_pyramid(x, base_step, levels=None, device=None):
    """Build a multi-resolution min/max pyramid.

    Level 0 decimates by ``base_step``; level ``k+1`` folds adjacent pairs
    of level-``k`` extrema (exact: min of mins, max of maxs), so the whole
    pyramid costs barely more than level 0 alone.

    Returns a list of ``(mins, maxs)`` tuples, coarsest last.
    """
    x = on_device(x, device)
    if levels is None:
        levels = pyramid_levels(x.shape[0], base_step)
    mins, maxs = minmax_decimate(x, base_step)
    out = [(mins, maxs)]
    for _ in range(1, levels):
        if mins.shape[0] < 2:
            break
        mins, _ = _segment_reduce(mins, 2)
        _, maxs = _segment_reduce(maxs, 2)
        out.append((mins, maxs))
    return out


def reduceat_like(x, step):
    """Numpy oracle mirroring the reference's reduceat call pattern (for
    tests): interleaved min/max with ragged tail."""
    x = np.asarray(x)
    segments = np.arange(0, len(x), step)
    out = np.empty((2 * len(segments),) + x.shape[1:], x.dtype)
    out[0::2] = np.minimum.reduceat(x, segments, axis=0)
    out[1::2] = np.maximum.reduceat(x, segments, axis=0)
    return out
