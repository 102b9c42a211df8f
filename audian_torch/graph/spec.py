"""Static per-trace metadata (a copy of ``audian_tpu/graph/spec.py``).

Rate, channels, frames and shape live in an immutable spec: opening a
node is a pure function ``source_spec -> output_spec``, from which the
executor derives every slice of a chunk on the host.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Shape/rate contract of one trace's output stream.

    Attributes
    ----------
    rate : output frames per second.
    channels : number of channels (axis 1).
    frames : total frames over the whole recording.
    more_shape : trailing dims beyond (frames, channels) — e.g. the
        frequency axis of a spectrogram
        (`src/audian/buffereddata.py:44-48` analog).
    ampl_min / ampl_max : display amplitude range.
    unit : physical unit string.
    """

    rate: float
    channels: int
    frames: int
    more_shape: tuple = ()
    ampl_min: float = -1.0
    ampl_max: float = 1.0
    unit: str = ""

    @property
    def shape(self):
        return (self.frames, self.channels) + self.more_shape

    @property
    def ndim(self):
        return 2 + len(self.more_shape)

    @property
    def duration(self):
        return self.frames / self.rate

    def decimate(self, step, frames=None, **changes):
        """Spec of a derived trace whose rate is ``rate/step``
        (`src/audian/buffereddata.py:39-56` semantics: frames round up)."""
        step = max(int(step), 1)
        if frames is None:
            frames = -(-self.frames // step)
        return dataclasses.replace(
            self, rate=self.rate / step, frames=frames, **changes
        )

    def index(self, t, clamp=True):
        """Frame index of time ``t`` (floor)."""
        i = int(math.floor(t * self.rate))
        if clamp:
            i = min(max(i, 0), self.frames)
        return i
