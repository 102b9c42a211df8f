"""Persistent artifacts: the overview (fulltrace) cache."""

from .fulltrace import FullTraceData

__all__ = ["FullTraceData"]
