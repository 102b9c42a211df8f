"""The benchmark probes on the card: the port's counterparts of the Pallas
probes in ``benchmarks/``, each a sweep run in the reference's order.

- :mod:`.dma_floor` (``benchmarks/dma_floor_bench.py``): a copy + 1 over
  16 ch x 2^22 float32 in column blocks of 4096 .. 65536 samples and in
  program-major blocks, and the chain's output set with no compute, whose
  time at 8192-sample programs and 129 bins is the output floor of the
  headline chain;
- :mod:`.call_scaling` (``benchmarks/call_scaling_bench.py``): the copy
  from 2^20 to 2^24 samples a channel beside torch's ``x + 1``;
- :mod:`.phase_restructure` (``benchmarks/phase_restructure_bench.py``):
  the IFIR envelope's phase-major relayout, as a round trip through shared
  memory and as 0/1 selection products on the tensor cores, between two
  copies.

Each runs as ``python -m audian_torch.probes.<name>`` on the CUDA card
and prints one line a configuration: ms a call over 8 calls back to
back, as the references time them (CUDA events, the median of five runs
after a warm-up), GB/s of reads plus writes, its share of 3.35 TB/s and
seconds per recording hour at 96 kHz, then the time of a lone call (the
host's enqueue in it).  The sweeps take ``device=``:
``"cpu"`` runs each configuration once through the plain versions and
times nothing (a host time is no card figure).
"""

__all__ = ["call_scaling", "dma_floor", "phase_restructure"]
