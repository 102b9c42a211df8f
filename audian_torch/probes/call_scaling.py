"""Does the copy's device-memory rate scale with the call's size on the
card: the port of ``benchmarks/call_scaling_bench.py``.

    python -m audian_torch.probes.call_scaling

For 2^20 .. 2^24 samples a channel of 16 ch float32, in the reference's
order: the copy + 1 in (16, 8192) blocks
(:func:`~audian_torch.ops.cuda.probes.copy_add1`, the reference's Pallas
copy), then torch's own ``x + 1`` on the same input (the reference's XLA
copy; torch materialises its result, so nothing like XLA's
``optimization_barrier`` is needed), the library figure beside the
kernel's.
"""

from __future__ import annotations

import sys

import torch

from ..ops.cuda.probes import copy_add1
from ..utils import resolve_device
from . import _common

__all__ = ["C", "N", "POWERS", "main", "run_kernel", "run_torch", "sweep"]

C = 16
N = 8192
POWERS = (20, 21, 22, 23, 24)


def run_kernel(x, block=N):
    """``x + 1`` by the copy kernel in (C, ``block``) blocks."""
    return copy_add1(x, block)


def run_torch(x):
    """``x + 1`` by torch's elementwise kernel."""
    return x + 1.0


def sweep(device=None, channels=C, block=N, powers=POWERS, echo=False):
    """The reference's sweep on ``device`` (the CUDA card by default): for
    each size the kernel's row, then torch's."""
    device = resolve_device(device)
    rows = []
    for p in powers:
        total = 1 << p
        gen = torch.Generator(device).manual_seed(_common.SEED)
        x = torch.randn((channels, total), generator=gen, device=device)
        nbytes = 2 * 4 * x.numel()
        for kernel, label, fn in (
                ("copy_add1", f"kernel copy 2^{p} ({nbytes // 2 >> 20} MB in)",
                 lambda: run_kernel(x, block)),
                ("torch", f"torch  copy 2^{p}", lambda: run_torch(x))):
            rows.append(_common.measure(kernel, label, fn, nbytes, total,
                                        device))
            if echo:
                print(_common.line(rows[-1]), flush=True)
        del x
    return rows


def main():
    return _common.main(sweep)


if __name__ == "__main__":
    sys.exit(main())
