"""Host data layer and device windows of the port: the WAV reader
(:mod:`.wavio`), the windowed multi-file loader (:class:`AudioLoader`) and
the ``Data`` registry whose trace windows live on the card."""

from .data import Data, RawTrace, Trace, default_traces
from .loader import AudioLoader

__all__ = ["AudioLoader", "Data", "RawTrace", "Trace", "default_traces"]
