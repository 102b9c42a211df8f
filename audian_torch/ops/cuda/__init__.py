"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: :mod:`.chain` (the single-pass fused chain),
:mod:`.window_matmul` (the strided-window matrix product) and
:mod:`.envdet` (the single-pass decimating song-detection envelope);
:mod:`.probes` holds the benchmark probes' copies and the IFIR envelope's
phase-major relayouts.
Sources live in ``audian_torch/csrc/``; they are built at the first launch
(:mod:`._build`), never at import."""
