"""Song detection of the port: the event pipeline (:mod:`.events`) and
the CSV result table (:mod:`.table`)."""

from .table import ResultTable

__all__ = ["ResultTable"]
