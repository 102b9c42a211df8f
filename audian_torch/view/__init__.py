"""View-model layer of the port: render tiles computed where the trace
windows lie, panels, plot ranges, axis tick math, selection and zoom
history, and the headless axes (counterpart of ``audian_tpu/view``)."""

from .axes import (ABS_TIME, FILE_TIME, REC_TIME, format_time_ticks,
                   tick_spacing, time_label_width)
from .panels import Panel, Panels
from .plotranges import PlotRange, PlotRanges
from .render import SpecTiler, TraceTiler, pick_amplitude
from .zoom import Rect, SelectionModel, ZoomHistory

__all__ = [
    "ABS_TIME", "FILE_TIME", "Panel", "Panels", "PlotRange", "PlotRanges",
    "REC_TIME", "Rect", "SelectionModel", "SpecTiler", "TraceTiler",
    "ZoomHistory", "format_time_ticks", "pick_amplitude", "tick_spacing",
    "time_label_width",
]
