"""Host-side streaming of the port: aligned-block prefetch under the
loader's window (counterpart of ``audian_tpu/stream``)."""

from .scheduler import BlockPrefetcher

__all__ = ["BlockPrefetcher"]
