"""Analysis of the port: song detection (:mod:`.events`), result tables
(:mod:`.table`), the region analyzers and the user-plugin system."""

from .analyzer import Analyzer, EventRecorder, PlainAnalyzer
from .plugins import Plugins, default_setup_traces
from .statistics import StatisticsAnalyzer
from .table import ResultTable

__all__ = ["Analyzer", "EventRecorder", "PlainAnalyzer", "Plugins",
           "ResultTable", "StatisticsAnalyzer", "default_setup_traces"]
