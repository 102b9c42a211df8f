"""The precision rungs of the tensor-core kernels: the port's counterpart
of ``jax.lax.Precision`` and of the JAX package's split-bf16 sentinels
(``audian_tpu/ops/pallas/chain.py:BF16X3`` / ``BF16X4``).

Each name is a plain string, and each runs on the card as follows:

- :data:`HIGHEST` (the default everywhere): three TF32 passes (3xTF32,
  hi*lo + lo*hi + hi*hi), the precision of an fp32 FMA;
- :data:`HIGH`: the same three TF32 passes, at least as exact as the
  three bf16 passes XLA runs for it;
- :data:`DEFAULT`: one TF32 pass, hi*hi with hi rounded by
  ``cvt.rna.tf32``: what XLA runs an f32 DEFAULT dot as on this card (the
  TPU runs one bf16 pass);
- :data:`BF16X3`: split bf16, hi = bf16(x) and lo = bf16(x - hi) (both
  rounded to nearest even, as the TPU's DEFAULT pass rounds lo too), for
  both operands, three passes hi*hi + hi*lo + lo*hi in fp32;
- :data:`BF16X4`: the same and lo*lo.

:func:`check` refuses anything else (or a rung the caller does not take)
with ValueError: no value falls back to another rung.  :func:`core_mode`
gives the mode of ``csrc/wgmma_conv.cuh``'s core for a rung.
"""

from __future__ import annotations

__all__ = ["BF16X3", "BF16X4", "CORE_MODES", "DEFAULT", "HIGH", "HIGHEST",
           "MATMUL_RUNGS", "RUNGS", "check", "core_mode", "stage_precisions"]

HIGHEST = "highest"
HIGH = "high"
DEFAULT = "default"
#: split-operand 3-pass bf16 (the JAX package's sentinel string)
BF16X3 = "bf16x3"
#: split-operand 4-pass bf16
BF16X4 = "bf16x4"

#: every rung, and the ones a plain matrix product takes (``lax.dot``'s
#: values: window_matmul, EnvDet, EnvDetKernel, the FIR path)
RUNGS = (HIGHEST, HIGH, DEFAULT, BF16X3, BF16X4)
MATMUL_RUNGS = (HIGHEST, HIGH, DEFAULT)

#: the core's mode of each rung (``wgconv::Mode``: TF32X3, TF32X1, BF16X3,
#: BF16X4)
CORE_MODES = {HIGHEST: 0, HIGH: 0, DEFAULT: 1, BF16X3: 2, BF16X4: 3}


def check(precision, allowed=RUNGS, what="precision"):
    """``precision`` if it is one of ``allowed``, else ValueError."""
    if not isinstance(precision, str) or precision not in allowed:
        raise ValueError(f"{what} must be one of {allowed}, got "
                         f"{precision!r}")
    return precision


def stage_precisions(precision):
    """``precision`` as the (filter, envelope, PSD) triple of the chain: one
    rung for all three stages, or a 3-tuple (or list) of rungs, each
    checked."""
    if isinstance(precision, (tuple, list)):
        if len(precision) != 3:
            raise ValueError(f"a per-stage precision has 3 entries "
                             f"(filter, envelope, PSD), got {precision!r}")
        return tuple(check(p) for p in precision)
    p = check(precision)
    return (p, p, p)


def core_mode(precision):
    """The core's mode of one rung (:data:`CORE_MODES`)."""
    return CORE_MODES[check(precision)]
