"""Host data layer and device windows of the port: audio I/O
(:mod:`.wavio`), the windowed multi-file loader (:class:`AudioLoader`) and
the ``Data`` registry whose trace windows live on the card."""

from . import wavio
from .wavio import (
    add_history,
    bext_history_str,
    get_datetime,
    load_audio,
    markers,
    metadata,
    unwrap,
    update_starttime,
    write_audio,
)
from .data import Data, RawTrace, Trace, default_traces
from .loader import AudioLoader

__all__ = ["wavio", "load_audio", "write_audio", "metadata", "markers",
           "get_datetime", "update_starttime", "bext_history_str",
           "add_history", "unwrap", "AudioLoader", "Data", "Trace",
           "RawTrace", "default_traces"]
