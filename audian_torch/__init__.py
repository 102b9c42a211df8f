"""audian_torch — the audian batch chain on PyTorch and CUDA.

The port of :mod:`audian_tpu` to one NVIDIA H100.  It imports ``torch``,
numpy and scipy only; importing it builds nothing (the CUDA kernels under
``csrc/`` are compiled with ``nvcc`` at their first launch, see
:mod:`audian_torch.ops.cuda._build`).

Layout mirrors the JAX package: ``ops/`` holds the DSP ops and the fused
chain, ``ops/cuda/`` the hand-written kernels with their plain PyTorch
versions, ``data/wavio.py`` the raw PCM-16 reader and ``models.py`` the
chain presets.
"""

__version__ = "0.1.0"
