"""Where the chain's device-memory floor lies on the card: the port of
``benchmarks/dma_floor_bench.py``.

    python -m audian_torch.probes.dma_floor

In the reference's order: a copy + 1 over 16 ch x 2^22 float32 in
channel-major column blocks of N = 4096 .. 65536 samples
(:func:`~audian_torch.ops.cuda.probes.copy_add1`), the same copy over
program-major contiguous blocks (N = 8192, 32768;
:func:`~audian_torch.ops.cuda.probes.copy_pm_add1`), the chain's output
set with no compute at N = 8192 for 129, 128 and 256 PSD bins
(:func:`~audian_torch.ops.cuda.probes.outputs_floor`: its time at 129
bins is the output floor of the headline chain, the denominator of its
floor ratio) and the first copy again as a drift check.  On the card
both copies run one kernel over the tensor's words, whatever N (a Pallas
``BlockSpec`` has no counterpart there): the rows of the N sweep measure
the same kernel, and so does the program-major copy.
"""

from __future__ import annotations

import sys

import torch

from ..ops.cuda.probes import copy_add1, copy_pm_add1, outputs_floor
from ..utils import resolve_device
from . import _common

__all__ = ["BLOCKS", "C", "NBINS", "OUTPUTS_BLOCK", "PM_BLOCKS", "TOTAL",
           "main", "outputs_bytes", "run_copy", "run_copy_pm",
           "run_outputs", "sweep", "to_program_major"]

C = 16
TOTAL = 1 << 22          # samples a channel a call, as the chain's chunk
BLOCKS = (4096, 8192, 16384, 32768, 65536)
PM_BLOCKS = (8192, 32768)
OUTPUTS_BLOCK = 8192
NBINS = (129, 128, 256)


def run_copy(x, N):
    """``x + 1`` in (C, N) column blocks."""
    return copy_add1(x, N)


def to_program_major(x, N):
    """``x`` (C, T) as contiguous program-major blocks (T / N, C, N)."""
    C_, T = x.shape
    return x.reshape(C_, T // N, N).transpose(0, 1).contiguous()


def run_copy_pm(xpm):
    """``x + 1`` over program-major (nprog, C, N) blocks."""
    return copy_pm_add1(xpm)


def run_outputs(x, N, nbins):
    """The chain's six output blocks with no compute."""
    return outputs_floor(x, N, nbins)


def outputs_bytes(C_, T, N, nbins):
    """Bytes :func:`run_outputs` must move: x read once, y and e, the PSD
    (T / 128 frames x C x nbins), po and go (C a program) and qo (C x
    nbins a program) written once."""
    nprog = T // N
    words = C_ * T * 3 + (T // 128) * C_ * nbins + nprog * C_ * (2 + nbins)
    return 4 * words


def sweep(device=None, channels=C, total=TOTAL, blocks=BLOCKS,
          pm_blocks=PM_BLOCKS, outputs_block=OUTPUTS_BLOCK, nbins=NBINS,
          drift_block=8192, echo=False):
    """The reference's sweep on ``device`` (the CUDA card by default): one
    row a configuration (:func:`._common.measure`), in its order."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(_common.SEED)
    x = torch.randn((channels, total), generator=gen, device=device)
    copy_bytes = 2 * 4 * x.numel()
    rows = []

    def add(*args):
        rows.append(_common.measure(*args, total, device))
        if echo:
            print(_common.line(rows[-1]), flush=True)

    def head(text):
        if echo:
            print(f"-- {text} --", flush=True)

    head("pure copy, channel-major rows, N sweep")
    for N in blocks:
        add("copy_add1", f"copy rows N={N}", lambda: run_copy(x, N),
            copy_bytes)
    head("pure copy, program-major contiguous blocks")
    for N in pm_blocks:
        xpm = to_program_major(x, N)
        add("copy_pm_add1", f"copy contiguous N={N}",
            lambda: run_copy_pm(xpm), copy_bytes)
        del xpm
    head(f"chain output set (no compute), N={outputs_block}")
    for nb in nbins:
        add("outputs_floor", f"y+e+psd({nb})+stats",
            lambda: run_outputs(x, outputs_block, nb),
            outputs_bytes(channels, total, outputs_block, nb))
    head("drift check")
    add("copy_add1", f"copy rows N={drift_block} again",
        lambda: run_copy(x, drift_block), copy_bytes)
    return rows


def main():
    return _common.main(sweep)


if __name__ == "__main__":
    sys.exit(main())
