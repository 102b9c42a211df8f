"""The IFIR envelope's phase-major relayout on the card: the port of
``benchmarks/phase_restructure_bench.py``.

    python -m audian_torch.probes.phase_restructure

The relayout ``u (C, T) -> u_pm (C M, T / M)``, ``u_pm[c M + m, q] =
u[c, m + M q]``, and its inverse, within (16, 8192) blocks of 16 ch x
512 x 8192 float32 (M = 8), in the reference's order: the copy + 1 of the
same traffic as a baseline
(:func:`~audian_torch.ops.cuda.probes.copy_add1`), the round trip
through shared memory, + 1 in phase-major order
(:func:`~audian_torch.ops.cuda.probes.pm_roundtrip_add1`; torch's
reshape and transpose copies beside it), the group-local relayout as 0/1
selection products on the tensor cores at HIGHEST and DEFAULT
(:func:`~audian_torch.ops.cuda.probes.select_pm_add1`), and the baseline
again.  The reference's selection products (``k_matmul``) fail to trace
and compute nothing; the port's compute what their docstring describes.
"""

from __future__ import annotations

import sys

import torch

from ..ops.cuda.precision import DEFAULT, HIGHEST
from ..ops.cuda.probes import (copy_add1, pm_roundtrip_add1,
                               pm_roundtrip_add1_plain, select_pm_add1)
from ..utils import resolve_device
from . import _common

__all__ = ["C", "M", "N", "NPROG", "main", "run_base", "run_reshape",
           "run_select", "run_torch_reshape", "sweep"]

C = 16
M = 8
N = 8192          # samples a program, as the chain kernel's
NPROG = 512       # programs a call: 4M samples a channel, as the chain's


def run_base(x, block=N):
    """The baseline: ``x + 1`` in (C, ``block``) blocks."""
    return copy_add1(x, block)


def run_reshape(x, block=N, phases=M):
    """Each block to phase-major, + 1, and back, in shared memory."""
    return pm_roundtrip_add1(x, block, phases)


def run_torch_reshape(x, block=N, phases=M):
    """The same with torch's reshape and transpose copies."""
    return pm_roundtrip_add1_plain(x, block, phases)


def run_select(x, precision=HIGHEST):
    """The group-local relayout by selection products, + 1."""
    return select_pm_add1(x, precision=precision)


def sweep(device=None, channels=C, block=N, nprog=NPROG, echo=False):
    """The reference's sweep on ``device`` (the CUDA card by default), with
    torch's round trip after the kernel's and the selection products at
    both rungs."""
    device = resolve_device(device)
    total = nprog * block
    gen = torch.Generator(device).manual_seed(_common.SEED)
    x = torch.randn((channels, total), generator=gen, device=device)
    nbytes = 2 * 4 * x.numel()
    rows = []
    for kernel, label, fn in (
            ("copy_add1", "baseline (copy)", lambda: run_base(x, block)),
            ("pm_roundtrip_add1", "reshape+transpose x2",
             lambda: run_reshape(x, block)),
            ("torch", "reshape+transpose x2, torch",
             lambda: run_torch_reshape(x, block)),
            ("select_pm_add1", "selection products, HIGHEST",
             lambda: run_select(x, HIGHEST)),
            ("select_pm_add1", "selection products, DEFAULT",
             lambda: run_select(x, DEFAULT)),
            ("copy_add1", "baseline again", lambda: run_base(x, block))):
        rows.append(_common.measure(kernel, label, fn, nbytes, total,
                                    device))
        if echo:
            print(_common.line(rows[-1]), flush=True)
    return rows


def main():
    return _common.main(sweep)


if __name__ == "__main__":
    sys.exit(main())
