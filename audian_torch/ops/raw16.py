"""Raw PCM-16 sample conversion.

An int16 code ``k`` is the sample ``k / 2**15`` (the loader's raw16
convention).  The multiply is by an exact power of two, so dequantizing on
the device is bit-exact with decoding on the host; the chain kernel keeps
the same conversion inside its load (``csrc/chain.cu``).
"""

import torch

__all__ = ["RAW16_SCALE", "dequant16"]

#: sample value of int16 code 1 (k / 2^15 convention)
RAW16_SCALE = 1.0 / 32768.0


def dequant16(q):
    """PCM-16 tensor -> float32 (``k / 2**15``; exact)."""
    return q.to(torch.float32) * RAW16_SCALE
