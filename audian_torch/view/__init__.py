"""View-model layer of the port: render tiles computed where the trace
windows lie (counterpart of ``audian_tpu/view/render.py``)."""

from .render import SpecTiler, TraceTiler, pick_amplitude

__all__ = ["SpecTiler", "TraceTiler", "pick_amplitude"]
