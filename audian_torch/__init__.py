"""audian_torch — the audian batch chain and song detector on PyTorch and
CUDA.

The port of :mod:`audian_tpu` to one NVIDIA H100.  It imports ``torch``,
numpy and scipy only; importing it builds nothing (the CUDA kernels under
``csrc/`` are compiled with ``nvcc`` at their first launch, see
:mod:`audian_torch.ops.cuda._build`).

Layout mirrors the JAX package: ``ops/`` holds the DSP ops, the fused
chain and the decimating detect envelope, ``ops/cuda/`` the hand-written
kernels with their plain PyTorch versions, ``analysis/`` the song-detection
pipeline and its CSV table, ``cli/`` ``audian-songdetector``,
``data/wavio.py`` the raw PCM-16 reader, ``config.py`` the configuration
files, ``models.py`` the chain presets, ``parallel/`` the multi-device
paths and ``utils/trace.py`` the trace spans.  Every entry point runs on the
CUDA card unless it is given ``device="cpu"``.
"""

__version__ = "0.1.0"
