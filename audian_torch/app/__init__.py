"""Application controllers of the port: the headless per-recording
browser, the multi-recording shell, the marker store and the channel
focus (counterpart of ``audian_tpu/app``, without the screenshot
navigation)."""

from .browser import DataBrowser, Signal, secs_to_str
from .markers import MarkerData, MarkerLabel
from .shell import Audian, audian_cli, parse_channels

__all__ = ["Audian", "DataBrowser", "MarkerData", "MarkerLabel", "Signal",
           "audian_cli", "parse_channels", "secs_to_str"]
