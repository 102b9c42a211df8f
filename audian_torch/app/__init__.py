"""Application controllers of the port: the headless per-recording
browser, the multi-recording shell, the marker store, the channel focus
and the screenshot navigation (counterpart of ``audian_tpu/app``)."""

from .browser import DataBrowser, Signal, secs_to_str
from .markers import MarkerData, MarkerLabel
from .screenshot import (parse_view_metadata, read_png_metadata,
                         save_view_screenshot, view_metadata,
                         write_view_metadata)
from .shell import Audian, audian_cli, parse_channels

__all__ = ["Audian", "DataBrowser", "MarkerData", "MarkerLabel", "Signal",
           "audian_cli", "parse_channels", "parse_view_metadata",
           "read_png_metadata", "save_view_screenshot", "secs_to_str",
           "view_metadata", "write_view_metadata"]
