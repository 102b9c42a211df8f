"""audian_torch — the audian framework on PyTorch and CUDA.

The port of :mod:`audian_tpu` to one NVIDIA H100.  It imports ``torch``,
numpy and scipy only; importing it builds nothing (the CUDA kernels under
``csrc/`` are compiled with ``nvcc`` at their first launch, see
:mod:`audian_torch.ops.cuda._build`; the native host library under
``native/`` with ``g++`` at its first use).

Layout mirrors the JAX package:

- ``ops``       the DSP ops, the fused chain and the decimating detect
                envelope; ``ops/cuda`` the hand-written kernels with their
                plain PyTorch versions
- ``graph``     the lazy trace graph and its executor
- ``data``      audio I/O (WAV, FLAC), the out-of-core loader, ``Data``
- ``parallel``  the multi-device paths (meshes, sharded pipeline, detect)
- ``stream``    the host-side window scheduler feeding the card
- ``view``      the view model and render tiles
- ``app``       the headless browser (``DataBrowser``, the ``Audian`` shell)
- ``gui``       the Qt and matplotlib windows and the song viewer
- ``analysis``  analyzers, plugins and the song-detection pipeline
- ``cache``     the overview (fulltrace) cache
- ``cli``       ``audian``, ``audian-compress``, ``audian-songdetector``
- ``utils``     the trace spans and small shared helpers

Every entry point runs on the CUDA card unless it is given
``device="cpu"``.
"""

__version__ = "0.1.0"

from .version import __year__, audian_dirs  # noqa: E402

__all__ = ["__version__", "__year__", "audian_dirs"]


def _tune_host_allocator():
    """Keep large host buffers in the warm glibc arena.

    glibc unmaps every freed block above M_MMAP_THRESHOLD, so each fresh
    multi-hundred-MB decode or upload buffer would fault its pages in
    again.  Raising the mmap and trim thresholds keeps freed big blocks in
    the heap, where the pages stay resident across reuse.  Linux only;
    failures are ignored.
    """
    import ctypes
    import sys

    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_host_allocator()
