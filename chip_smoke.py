"""Smoke run of audian_torch on one CUDA card: build, check, drive, time.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   fails at once without CUDA;
1. builds the kernels from ``audian_torch/csrc`` into ``build/`` (one
   ``nvcc`` a source, all started together); from ``ptxas -v`` the
   registers, spill bytes, any serialized-``wgmma`` warning and the waits
   ptxas injected of chain, envdet and window_matmul (every template
   instance: window_matmul's columns, int16 input and one-pass DEFAULT)
   and of the probes' selection products (``select_pm_kernel``, both
   rungs), which must neither spill nor serialize, and from ``cuobjdump
   -sass`` of the built library each kernel's ``HGMMA`` and ``HMMA`` count
   (every instance must show ``HGMMA`` and none ``HMMA``); the probes' five
   copy and relayout kernels (``csrc/probes.cu``) must not spill either,
   the copies' one-shot ``copy_flat_kernel`` must load and store 16-byte
   words (``LDG.E.128`` and ``STG.E.128`` in its SASS), and the two on
   bulk-copy rings (``pm_roundtrip_kernel``, ``select_pm_kernel``) must
   show bulk copies (``UBLKCP``) in their SASS;
1b. the bare convolution core (``csrc/wgmma_conv.cuh`` through
   ``csrc/conv_probe.cu``: one warpgroup at N = 64 and 8) on four short
   known convolutions (the headline filter, the headline envelope's delay
   past its taps, envdet's band-pass, a 54-tap phase) in each of its
   modes (3xTF32, one TF32 pass, BF16X3, BF16X4), every unit full and
   with the host's light units, against float64 at unit-scale outputs
   (1e-5, 2e-3, 1e-4, 1e-4), before anything runs on it, and its rate
   (``csrc/conv_probe.cu:conv_rate``) at N = 8, 64 and 128 with one and
   two blocks an SM, and in BF16X3 at N = 64 and 128;
2. ``window_matmul`` kernel against its plain version at 16 ch x 2^20
   samples, at every caller's shapes: the ``bioacoustics`` per-stage
   filter, rectified envelope and PSD, the same three of ``ultrasound``
   at 384 kHz (PSD 512 x 514 at hop 256), hop 90, the IFIR envelope's two
   stages, EnvDet's int16 band-pass and decimating envelope (rows mode),
   and C = 1, C = 3 with ragged tails (float32 and int16) and nframes
   below one 128-frame tile; each case's plan (span or rows mode, column
   blocks, ring) and its shared memory against the kernel's formula; a
   NaN and an infinity on the input of IFIR stage B and of the rectified
   envelope leave exactly the plain version's outputs non-finite, at
   HIGHEST and at DEFAULT (the one-pass instance; the others within 1e-2
   of scale); ``chain_cf``'s per-stage route as the ``ultrasound-stages``
   cell runs it (the 384 kHz ``ultrasound`` chain at eps 1e-7, a 16 ch x
   (hb + 2^22 + ha) int16 chunk): each of its three window products
   (the int16 band-pass through ``"dequant"``, the rectified envelope,
   the hop-256 PSD) against ``window_matmul_plain`` on the same inputs
   within 1e-5 of scale, its outputs against the per-stage methods on the
   dequantized stream, the statistics the sums of its outputs, and
   window_matmul's counter (zeroed before the call) and the
   ``stages.call`` span's ``launches`` both 3;
3. ``chain`` kernel against its plain version at the headline chunk
   (16 ch x 2^22 int16, ``bioacoustics``, eps 2e-6, stats; the host's
   tile and its shared memory against the kernel's formula), int16
   against its float32 dequantization, all 7 output masks, a padded tail,
   and a 24 Hz envelope (14511 taps), whose halos leave room for a
   narrower tile only (held against a float64 evaluation of the same
   taps);
4. the chain's main path: a 60 s x 16 ch x 96 kHz PCM-16 WAV read in
   halo'd 2^21-frame chunks through two pinned int16 buffers, each chunk
   run through ``FusedChainCF.chain_cf`` (stats) and checked against the
   plain version, chunked against whole, a 2 s slice of one channel
   against scipy float64; and the per-stage ``ultrasound`` chain over the
   same file, checked against scipy.  Launch counters are zeroed just
   before this phase and read just after it;
5. CUDA-event times (median of 5 after a warm-up) of the chain and
   window_matmul kernels and their plain versions, and of the chain's
   1-hour loop (83 device-resident chunks); the headline chain also as 8
   calls back to back (the floor ratio's numerator, phase 18); each
   wrapper's host enqueue of a call (``perf_counter``, no synchronize
   inside): the chain, window_matmul, the copies on a 16 x 4096 tensor
   beside torch's ``x + 1`` on it and the copy's bare launcher (envdet's
   in phase 9); for each window_matmul case
   of phase 2 (its bank's split held, as its owner holds it) its
   ``bound_tc`` share and the cuBLAS ``unfold @ w`` time, each as a lone
   call (the host's enqueue in it) and 10 calls back to back a run (the
   card's time; a line says where the kernel is slower either way), the
   host's enqueue of a call, and the time of w's TF32 split (once per
   bank);
6. the launch counters of phase 4, each of which must be > 0;
7. the ``envdet`` kernel against its plain version and a float64
   evaluation of the same taps at the song detector's headline chunk
   (16 ch x 2,101,248 int16 frames, the CLI's default design at 96 kHz:
   1-10 kHz band-pass, 500 Hz envelope, step 19), and on the same window
   at steps 1, 3 and 7, as float32, at C = 1 and 3, at an ``nout`` that is
   not a multiple of the tile and at the 200 Hz design (step 48), whose
   span takes a narrower tile, and at the 100 Hz design (step 96), which
   the earlier kernel refused; a longer design (60 Hz, step 160) is
   refused and left to ``EnvDet``; the two-stage ``EnvDet`` on ``window_matmul`` with the
   ``dequant`` and ``square`` premaps, each stage against its plain
   version at these shapes;
8. the song detector's main path: ``audian_torch.cli.songdetector.main``
   on a 90 s x 16 ch x 96 kHz PCM-16 WAV with planted songs (five chunks,
   three interior).  Launch counters are zeroed just before and read just
   after the run: ``envdet`` must run once per interior chunk.  Every
   planted song must be found on every channel with its onset within
   0.1 s; ``band_env`` on two channels is held against the scipy float64
   oracle; under ``torch.profiler`` each envdet launch must follow its
   window's upload directly (no copy kernel between them);
9. CUDA-event times of the envdet kernel (at each tile it can take for
   the design; its wrapper's host enqueue), its plain version and the
   two-stage ``EnvDet`` per
   headline chunk, of the same kernel work over a time-contiguous
   (C = 1) window and of the transposing copy the kernel no longer needs,
   and the 1-hour detect loop (165 device-resident chunks, seconds per
   recording hour);
10. the interactive path (``audian_torch.data.Data`` -> the trace graph ->
    the render tiles) on a 180 s x 16 ch x 96 kHz PCM-16 WAV with planted
    songs: a 60 s window (20 s kept behind), ``default_traces()`` with the
    filter at 2-40 kHz, a 2 s view paged forward 40 times and back 10
    times, then two jumps, each move followed by the browser's refresh
    (min/max tiles of "filtered" and "envelope" and uint8 dB tiles of the
    spectrogram, every channel).  Checks: the raw window equals the file
    (the pinned-staging fence), min/max tiles equal numpy's reduceat
    exactly, a 2 s slice of channel 0 against scipy float64 (1e-5,
    0.013 dB), the delta-stitched windows against a full recompute
    (1e-6), and a four-value cutoff scrub adds no executor plan;
11. interactive times: open plus first render, scroll p50/p95 at 16 ch
    and on an 8-channel copy, the jumps, the cutoff scrub, NFFT steps,
    the autoscale extrema (host clock, each ended by a synchronize), the
    full-window recompute (CUDA events) and its split by node, and the
    device busy share of 20 pages under ``torch.profiler``.  No kernel
    lies on this path: it runs on torch ops (cuDNN convolutions, cuBLAS
    DFT products);
12. the headless browser on phase 10's recording and its 8-channel copy:
    ``audian_cli([16 ch, 8 ch, "-f", "2000", "-l", "40000"])`` with
    ``default_traces()``, both browsers on the card (every window a CUDA
    tensor; a browser without a card raises), each move followed by the
    browsers' refresh (``trace_tile`` of every shown trace and channel,
    ``spec_tile`` of every channel): open, 40 page downs and 10 page ups,
    end, home, a jump, a three-step lowpass scrub and two ``step_filter``
    steps (linked to the 8 ch browser), NFFT 256 -> 512 -> 256, an
    envelope step, and a page with the time scroll linked.  Checks: the
    tiles equal a direct refresh of each browser's ``Data`` exactly, a 2 s
    slice against scipy float64 (1e-5, 0.013 dB), ``play_region`` with a
    30 kHz heterodyne against numpy float64 (1e-5), the statistics row
    against float64 (1e-5 relative; the mean's error relative to the
    standard deviation, since a band-passed mean nearly cancels),
    ``save_region`` of 10 s at channels
    0, 3 and 7 equal to the source's int16 codes with the stored marker
    shifted into the cut and the CodingHistory line, and the overview
    after ``FullTraceData.wait()`` equal to numpy's interleaved min/max of
    the file.  Times on the host clock, each beside the card.
13. recordings in FLAC, 8 channels (a FLAC stream holds at most 8): the
    native host library (built in phase 1 beside the kernels) is required;
    phase 10's 8-channel recording, phase 8's song recording (its first 8
    channels) and the first 30 s of the former at 24 bits are encoded in
    parallel by the port's encoder; the 16-bit files decode exactly and
    carry the MD5 of their codes, the 24-bit one reads as float32 codes /
    2^23.  ``Data`` on the 16-bit FLAC takes the int16 upload, and phase
    11's 50 pages on it give raw windows, trace windows and tiles equal to
    the WAV's session bit for bit; ``audian-songdetector`` on the FLAC
    writes the WAV run's CSV with envdet launched; phase 4's disk -> chain
    run over the FLAC (``AudioLoader.read_raw16_into`` into pinned int16
    buffers) gives the WAV run's outputs bit for bit with chain launched;
    ``audian-compress`` on the WAV (native scan) and the FLAC writes
    overviews equal to numpy's; ``save_region`` of 10 s x 3 channels to a
    ``.flac`` from the shell on the FLAC gives the source codes.  Launch
    counters are zeroed before each FLAC run and read after it.
14. the frontends on phase 12's recordings.  The Qt adapter
    (``audian_torch.gui.qt``) runs on the fake toolkit of
    ``tests/fakeqt.py`` (this machine has no Qt), whose items keep what
    the adapter hands them; a torch tensor handed over fails the run.
    ``audian_torch.cli.audian.main([16 ch, 8 ch, "-f", "2000", "-l",
    "40000"])`` from a working directory holding a plugin file with the
    envelope trace returns 0 after building the window over the first
    recording (timed: open to first window).  A window over an
    ``audian_cli`` shell of both recordings with ``default_traces()`` is
    driven by its own actions: 40 pages forward and 10 back, end and
    home, a drag of the lowpass handle (both linked tabs re-design their
    filter), an NFFT step up and down, a rect zoom and the zoom back;
    after every move the curves and images every tab handed to the
    toolkit equal a direct refresh of its browser bit for bit (and the
    power side plots the browser's ``power_spectrum``).  Pages at 16 ch
    are timed from the move to the end of the adapter's refresh, each of
    the action's two refreshes apart, and 10 more pages with the power
    side panel on (it is off by default) give the panel's share of a
    page.  A screenshot through the window's
    action holds the view; a drop of it and ``main([png])`` restore it.
    The song viewer's envelope keys ``e`` and ``E`` (500 Hz to 333.3 and
    750 Hz, decimation steps 29 and 13) run, without matplotlib, what
    ``SongPlot._recompute`` runs on phase 8's recording: ``band_env`` on
    the decimating path, with envdet launched once per interior chunk
    (counters zeroed just before each key, read just after), its
    envelope within ``TOL_DETECT`` of the exact chunk path's, and the
    kernel built for each key's geometry held against its plain version
    and float64 on the first interior window.
    Where this machine has matplotlib, under Agg: ``audian --screenshot``,
    ``audian-songdetector --plot-png`` on phase 8's recording (phase 8's
    CSV) and the song viewer's envelope key (envdet launched, the
    envelope held against the exact path); otherwise one line says so.
    No kernel lies on the Qt path.
15. the multi-device paths, every mesh entry the one card (``cuda:0``
    four times): ``ChainPreset("bioacoustics").sharded`` over a
    ``seq=4`` mesh on a 10 min x 16 ch x 96 kHz PCM-16 WAV read as int16
    codes through ``AudioLoader.read_raw16_into`` (chain launched):
    filtered, envelope and min/max equal the ``seq=1`` mesh's within
    1e-5, the PSD within 1e-4 relative, 2 s of channel 0 across the first
    shard edge against scipy float64; a ``seq=2 x ch=2`` mesh and the
    per-stage ``ultrasound`` preset (window_matmul launched) give the
    same outputs.  ``band_env(..., mesh=)`` over 4 shards on phase 8's
    recording and on the 10 min one, within 1e-5 (relative) of the
    chunked driver, envdet launched once per shard; ``--mesh 4`` says
    it runs single-device and writes phase 8's CSV; ``-j 4`` on four
    90 s recordings writes ``-j 1``'s CSVs with envdet's launches equal;
    a ``DataBrowser`` channel-sharded over ``seq=1 x ch=4`` on phase 10's
    recording, 20 pages, its reads within 1e-5 and its tiles within 1e-4
    of an unsharded browser's; ``utils.trace`` around one page and one
    detect; ``entry.dryrun_multichip(4)``.  Times: the pipeline per
    recording hour at seq=1 and seq=4 (and from codes on the card),
    sharded against chunked detect, ``-j 4`` against ``-j 1``, a meshed
    page against an unsharded one;
16. the interpolated-FIR envelope: ``FusedChainCF(ifir=True)`` at the
    bioacoustics envelope (500 Hz, eps 1e-7) on one headline chunk
    (16 ch x 2^22 float32): two window_matmul launches, each held against
    its plain version at its shapes, and one launch each of the relayout
    kernels ``pm_forward`` and ``pm_inverse`` (counters zeroed just before,
    read just after); the envelope equal bit for bit to the one the torch
    reshape-and-transpose copies give, against the dense one (3e-6) and an
    interior slice against scipy float64 (1e-5); CUDA-event times of the
    envelope, its two launches, its two relayouts beside the torch copies
    (one ``copy_`` each, the library column; both also 8 calls back to
    back) and the plain versions, and
    the dense envelope; then the exact IIR filters on 60 s x 16 ch float32:
    ``sosfilt`` (2-40 kHz) whole and in three chunks with the state
    carried, ``sosfiltfilt`` and ``envelope``, two channels against scipy
    float64, with host-clock times beside the FIR path's;
17. the precision rungs (``ops/cuda/precision.py``) of the three kernels
    against their plain versions at the headline shapes.  The chain on a
    16 ch x 2^22 int16 chunk at (HIGHEST,) * 3, the JAX package's default
    (HIGHEST, BF16X3, BF16X3), (BF16X3,) * 3, (BF16X4, BF16X3, BF16X3) and
    (DEFAULT,) * 3: filtered and envelope within 1e-5 of a float64
    evaluation and the PSD within 0.013 dB of the plain version where the
    filter is HIGHEST, DEFAULT within 1e-2 of each output's scale; the
    light units against every unit full at HIGHEST (filtered < 1e-6,
    envelope < 5e-6, PSD < 0.05 dB, each non-zero); (HIGHEST, BF16X3,
    BF16X3) against (HIGHEST,) * 3 (the filtered stream bit for bit, the
    envelope 0 < d < 1e-5, the PSD within 0.013 dB); a BF16X3 filter
    within 1e-5 of the HIGHEST one and a BF16X4 one at least as close;
    a design whose light mass sits just under the budget, full-scale
    sign-matched signals, at both HIGHEST rungs against every unit full
    (1e-5).  window_matmul at DEFAULT on the three bioacoustics stages
    (1e-2 of scale; HIGH == HIGHEST bit for bit); envdet at DEFAULT and
    the two-stage EnvDet at DEFAULT on the detect chunk (1e-2 of scale),
    envdet's light units against every unit full.  CUDA-event medians of
    each rung beside its own bound.
18. the benchmark probes (``csrc/probes.cu``, ``audian_torch.probes``):
    each kernel against its plain version on 16 ch x 2^22 float32 with
    NaNs and infinities planted where the copies, the output set's fills
    and columns and the relayouts carry them, bit for bit: ``copy_add1``
    at N = 4096, 8192, 65536 and a C = 3 stream of odd rows,
    ``copy_pm_add1`` at N = 8192, 32768, both at the one-shot grid's edges
    (``COPY_EDGES``: a last tile in part, tails of 1 and 3 words, a tensor
    below one tile, program-major (5, 3, 96), views at offsets of 4 words
    and of one word, the scalar path), ``outputs_floor`` at N = 8192 and
    129, 128, 256 bins, ``pm_forward`` / ``pm_inverse`` at the IFIR
    shapes (strided slices of wider streams) at M = 8, 4, 16 and their
    round trip, ``pm_roundtrip_add1`` at M = 8, 4 and at its ring's edges
    (C = 3 with blocks of 6176 samples, 519 items; C = 5 with blocks of 96);
    ``select_pm_add1`` on a unit-normal input from seed 0 within 2^-20
    max|x| at HIGHEST and 2^-10 at DEFAULT, and at C = 3 over 9003 rows
    (the last tile 43 rows) with a NaN and an infinity planted, each of
    which must turn exactly its row's 128 outputs of its source block
    non-finite (the NaN's NaN; the infinity's NaN, at DEFAULT but its own
    output, which stays infinite);
    the copies' grid formula and the two ring kernels' shared-memory and
    grid formulas against the library's own, and both copies (``copy_add1``
    also at 16 ch x 2^20) and each ring kernel in turns with its torch
    call, lone and 10 calls back to back.  The plain versions and the
    torch calls timed (the calls also 8 back to back); then
    the three sweeps (``python -m audian_torch.probes.dma_floor``,
    ``call_scaling``, ``phase_restructure``) with the probes' launch
    counters zeroed just before and read just after, each kernel launched,
    each row timed as 8 calls back to back, as the references time them,
    with its lone call beside it; and the floor ratio: phase 5's headline
    chain over the output floor (N = 8192, 129 bins) of this run, both 8
    calls back to back (and as lone calls beside it), and over the copy
    floor;
19. the examples (``examples_torch/``): the batch twin's three modes
    (``fused_single_chip``, ``sharded_whole_recording`` and
    ``detect_directory`` on two 90 s x 2 ch WAVs at 48 kHz, one interior
    detect chunk each) on the card, with the launch counters zeroed just
    before and read just after (chain and envdet must launch), each held
    against the same mode with ``device="cpu"``: filtered, envelope and
    min/max within 1e-5, the PSD within 0.013 dB inside 60 dB of the
    peak, the onsets within 0.1 s; then each plugin twin copied into a
    launch directory of its own (both add a trace named ``envelope``)
    and loaded by ``Plugins`` into a ``DataBrowser`` on the card over a
    written 440 Hz tone: the ``envelope`` and ``difference`` traces are
    there, ``difference`` equals ``torch.diff`` of the filtered region
    pulled to the host and was computed on the card, ``zerocrossings``
    gives 440 Hz within 10 %, ``peaks`` stores the region's largest
    sample.  The phase's wall time and each mode's seconds on the card
    and on the CPU (host clock);
20. the graph's causal FIR kernel (``csrc/fir.cu``, on the convolution
    core; ``phase 1`` also holds ``fir_kernel`` to no spill, no serialized
    ``wgmma`` and HGMMA) at the scrub's two designs extended past their
    decay (the 2-40 kHz band-pass to 1024 taps; the 500 Hz envelope to
    4096, on the rectified stream), a 50 Hz high-pass of 32768 taps (eight
    launches) and the band-pass the scrub runs (256 taps) on 16 ch x
    5.77 M frames: against the plain twin (cuDNN's fp32 ``conv1d``) and
    float64 slices at the start, middle and ragged end (1e-5 of scale),
    DEFAULT within 1e-2; short, ragged and column-sliced streams; 8 calls
    back to back and a lone call beside the 3xTF32 bound of every tap and
    the plain twin's time; then ``entry()``, the detector's exact envelope
    and the heterodyne playback with the kernel under them against scipy
    float64, each FIR call launched (3, 4 and 2).  Phases 10 and 11 hold
    the graph's main path to the kernel: 3 launches a step of the cutoff
    scrub and 3 in a full-window recompute.
21. the graph's spectrogram on ``window_matmul`` (the kernel route of
    ``ops/stft.py``: one window product over the analysis bank, three
    TF32 passes): ``SpectrogramNode.compute`` on a 60 s x 16 ch float32
    window at NFFT 64, 256 and 1024 (hop NFFT/2, one overhanging tail
    frame, zero), the ``stft`` tag ``kernel`` and one launch, against the
    plain twin (the framed copy and cuBLAS's fp32 product) over bins
    within 60 dB of the peak and scipy float64 on 2 s of channel 0
    (0.013 dB); CUDA-event ms of the node, of its stream's relayout and
    its window product alone, and of the plain twin, beside the
    product's 3xTF32 bound.  Phases 10
    and 11 hold the graph's main path to it: window_matmul once a step of
    the cutoff scrub and once in a full-window recompute, and a traced
    cutoff step's spectrogram span reads ``stft=kernel``.

Phase 4 starts with both TF32 flags on and checks that they are still on
after it: the port scopes full float32 to its own calls.

The line before the last is a JSON object with one entry per kernel: its
launches on its main path (phase 4 for chain, phase 2's per-stage route
of ``chain_cf`` for window_matmul, phase 8 for envdet), its largest
error, its time and its plain version's, the least time the card could
take for the same work (``bound_ms``: fp32 at 67 TFLOP/s or 3.35 TB/s of
device memory, whichever is larger) and the time of one PyTorch call
computing the same function where there is one.
The three tensor-core kernels also carry ``bound_tc_ms``: the same
true-tap operations in three TF32 passes at 495 TFLOP/s, or the bytes at
3.35 TB/s, whichever is larger, and ``bound_share``, ``bound_tc_ms``
over their time.  Chain carries its ``tile``, ``stage_ms`` (phase 5's
filtered-, envelope- and spectrogram-only times), ``core_max_abs_err``
and ``core_tflops`` (phase 1b); envdet its ``tile``.
Every kernel carries ``precision``: for each rung of phase 17 its ``ms``,
``max_abs_err`` and ``bound_tc_ms``, the least time at that rung's passes
and tensor rate (TF32 495, bf16 989 TFLOP/s) with the light units at one
pass (the chain's "(H,H,H) all full" entry at three passes everywhere,
the kernel's ``bound_tc_ms``; window_matmul's HIGHEST entry its phase-5
sums).
Chain and envdet also carry ``flac_launches``, their launches on the FLAC
runs of phase 13, and envdet ``viewer_launches``, its launches on the song
viewer's envelope keys of phase 14.  Every kernel carries
``multidevice_launches``, its launches on phase 15's paths: chain on the
seq=4 bioacoustics pipeline, window_matmul on the seq=4 ultrasound one,
envdet on the two sharded detect calls.  Chain, window_matmul and envdet
carry ``examples_launches``, their launches on phase 19's batch twin.
window_matmul also carries ``file_launches``, its launches on phase 4's
per-stage ultrasound chain over the WAV, and
``ifir_launches`` and ``ifir_ms``, its launches on phase 16's IFIR
envelope of one headline chunk and that envelope's time; its ``ms``,
``library_ms`` and ``bound_share`` are lone calls, and
``ms_back_to_back``, ``library_ms_back_to_back`` and
``bound_share_back_to_back`` the same 10 calls back to back; ``host_ms``
(the host's enqueue of a call), ``stage_ms`` and ``stage_ms_back_to_back``
(phase 5's time of each case), ``split_ms`` (w's split) and
``slower_than_library`` (the cases slower than ``unfold @ w``).
Chain and envdet carry ``host_us``, their wrappers' host enqueue of a
call, and chain ``ms_back_to_back``.
The probes' five entries (phase 18: ``copy_add1``, ``copy_pm_add1``,
``outputs_floor``, ``phase_major``, ``select_pm_add1``) carry their
sweeps' times under window_matmul's key names: ``ms``, ``library_ms`` and
``bound_share`` for a lone call, ``ms_back_to_back``,
``library_ms_back_to_back`` and ``bound_share_back_to_back`` for 8 calls
back to back (the IFIR envelope's two relayouts for ``phase_major``,
phase 16), their launches on the sweeps (on the IFIR envelope for
``phase_major``, with the round trip's in ``roundtrip``, its library call
torch's ``x + 1``), the bytes bound (``select_pm_add1``: the larger of it
and its two TF32 passes at 495 TFLOP/s); both copies, the round trip and
the selection (and its DEFAULT rung) carry ``turns``: their times in
turns with their torch call, lone and back to back (``copy_add1`` also
``turns_2e20``), the copies ``host_us`` (``copy_add1`` also
``host_us_torch``, ``x + 1``'s, and ``host_us_launcher``, the bare
launcher's); ``outputs_floor`` the ``floor_ratio`` (back to back),
``floor_ratio_lone``, ``chain_ms``, ``chain_ms_back_to_back`` and
``bound_ms_int16_in``, the bytes bound of the output set with the chain's
int16 input.
The FIR kernel's entry (phase 20) carries, for each design, its ``taps``,
``launches`` a call, errors, ``ms`` (lone) and ``ms_back_to_back``,
``bound_tc_ms`` (every tap in three TF32 passes, or the bytes) with both
shares, and the plain twin's ``plain_ms``; its ``launches`` on the main
path (the cutoff scrub and the recompute of phases 10-11, also split as
``interactive_launches``) and ``phase20_launches``.
window_matmul's entry carries ``graph_stft`` (phase 21): for each NFFT the
node's, the window product's and the plain twin's ``ms``, the errors, the
product's ``bound_tc_ms`` and share, and the main path's launches and
traced route (phases 10-11).
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import importlib.util
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import scipy.io.wavfile
import scipy.signal as sps
import torch

from audian_torch.probes._common import CALLS, card_line, host_us, median_ms

RATE = 96000.0
C = 16
CHUNK = 1 << 22          # headline chunk (43.7 s at 96 kHz)
FILE_CHUNK = 1 << 21     # disk -> chain chunk of phase 4
HOUR_CHUNKS = -(-int(3600 * RATE) // CHUNK)   # 83
SEED = 0
# the least time of a kernel: published peaks of one H100 SXM (fp32
# outside the tensor cores, HBM3)
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# dense TF32 on the tensor cores; the 3xTF32 kernels take three passes
PEAK_TF32 = 495e12
TF32_PASSES = 3
# the song detector's default design (cli/songdetector.py) at 96 kHz
DETECT_BAND = (1000.0, 10000.0)
DETECT_ENV = 500.0
DETECT_SECONDS = 90
SONG_STARTS = (5.0, 21.0, 38.0, 50.5, 65.0, 80.0, 87.8)   # s, 1.5 s each

# tolerances (max abs error at unit-scale PCM input; the scipy 1e-5
# contract of the JAX package)
TOL_FILTERED = 1e-5
TOL_ENVELOPE = 1e-5
TOL_PSD_DB = 0.013       # bins within 60 dB of the chunk peak
TOL_STATS_RTOL = 1e-5
TOL_WINDOW = 1e-5        # times the output scale
TOL_DEFAULT = 1e-2       # one TF32 pass: times each output's scale
                         # (tests/test_songdetector.py:602-621)
WM_CALLS = 10            # window_matmul and cuBLAS timed 10 calls a run
HOST_T = 4096            # samples a channel of the copies' enqueue tensor
# chunked against whole: the same samples go through the same kernel
# arithmetic, so the tolerance of tests/test_chunk_equivalence.py holds
TOL_CHUNKED = 2e-6
# the detect envelope: 1e-5 of its scale against the plain version and
# float64 (fp32 sums in another order), 2e-5 of the scale end to end
# against scipy float64 (the JAX package's chunk-equivalence budget)
TOL_DETECT = 1e-5
TOL_DETECT_ORACLE = 2e-5
TOL_ONSET_S = 0.1        # tests/test_songdetector.py identical songs


def device_work(e):
    """Whether a profiler event is work on the card: a CUDA event that is
    not the device-side copy of a program span's range (``audian.*``)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("audian."))


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def bound(flop, nbytes, peak=PEAK_FLOPS):
    """``(least ms, what bounds it)`` for ``flop`` operations at ``peak``
    (fp32 by default) that read and write ``nbytes`` of device memory."""
    t_op, t_mem = 1e3 * flop / peak, 1e3 * nbytes / PEAK_BYTES
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def bound_tc(flop, nbytes):
    """The least ms of the same true-tap work in three TF32 passes on the
    tensor cores."""
    return bound(TF32_PASSES * flop, nbytes, PEAK_TF32)[0]


#: the kernels that run on warpgroup MMAs (and must show HGMMA in SASS):
#: the four program kernels and the probes' selection products
WGMMA_KERNELS = ("chain_kernel", "envdet_kernel", "window_matmul_kernel",
                 "fir_kernel", "select_pm_kernel")
#: the probes' copy and relayout kernels (csrc/probes.cu), which must not
#: spill either
PROBE_KERNELS = ("copy_flat_kernel", "outputs_floor_kernel",
                 "pm_forward_kernel", "pm_inverse_kernel",
                 "pm_roundtrip_kernel")
#: the probes' one-shot streaming copy (both copy_add1 and copy_pm_add1),
#: which must move device memory in 16-byte loads and stores
COPY_KERNEL = "copy_flat_kernel"
#: the probes' kernels fed by bulk copies into a ring of stages, which
#: must show them in their SASS
RING_KERNELS = ("pm_roundtrip_kernel", "select_pm_kernel")


def wgmma_health(report, kernels=WGMMA_KERNELS):
    """For each of ``kernels``, from ``ptxas -v``'s report, over all its
    template instances: its most registers, its spill bytes (stores +
    loads, summed), whether ptxas serialized any of its wgmma instructions
    (warning C7512) and how many waits ptxas injected for accumulator
    registers (note C7517); both name the function in their own line."""
    out = {k: {"registers": None, "spill_bytes": None, "serialized": False,
               "injected_waits": 0} for k in kernels}
    name = None
    for line in report.splitlines():
        hit = next((k for k in kernels if k in line), None)
        if "serialized" in line and hit:
            out[hit]["serialized"] = True
            continue
        if "C7517" in line and hit:
            out[hit]["injected_waits"] += 1
            continue
        m = re.search(r"Compiling entry function '?(\w+)", line)
        if m:
            name = next((k for k in kernels if k in m.group(1)), None)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_bytes"] = (out[name]["spill_bytes"] or 0) \
                + int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = max(out[name]["registers"] or 0,
                                         int(m.group(1)))
            name = None
    return out


def template_args(mangled):
    """``"<128,1,0>"``: the int and bool template arguments of a mangled
    kernel name (window_matmul's columns, int16 input and one pass), or
    ``""``."""
    m = re.search(r"I((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return ""
    return "<" + ",".join(re.findall(r"L[ib](\d+)E", m.group(1))) + ">"


def sass_mma_counts(library):
    """``{kernel: (HGMMA, HMMA, bulk copies, 128-bit global loads, 128-bit
    global stores)}``: the warpgroup and the warp-level MMA instructions,
    the bulk copies (``UBLKCP``, or a tensor map's ``UTMALDG`` /
    ``UTMASTG``) and the 16-byte ``LDG.E.128`` / ``STG.E.128`` (any cache
    qualifiers between) in each kernel's SASS (``cuobjdump -sass`` of the
    built library)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            mangled = m.group(1)
            name = next((k for k in ("chain_kernel", "envdet_kernel",
                                     "window_matmul_kernel", "conv_probe",
                                     "conv_rate", "split_w_kernel",
                                     *WGMMA_KERNELS[3:], *PROBE_KERNELS)
                          if k in mangled), mangled[:40])
            name += template_args(mangled)
            counts.setdefault(name, [0, 0, 0, 0, 0])
        elif name and "HGMMA" in line:
            counts[name][0] += 1
        elif name and re.search(r"\bHMMA", line):
            counts[name][1] += 1
        elif name and re.search(r"\b(UBLKCP|UTMALDG|UTMASTG)", line):
            counts[name][2] += 1
        elif name and re.search(r"\bLDG\.E[.\w]*\.128\b", line):
            counts[name][3] += 1
        elif name and re.search(r"\bSTG\.E[.\w]*\.128\b", line):
            counts[name][4] += 1
    return {k: tuple(v) for k, v in counts.items()}


def kernel_resources(report):
    """``ptxas -v``'s register and spill lines, each labelled with its
    kernel (and template argument: window_matmul's block columns)."""
    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            mangled = m.group(1)
            name = next((k for k in ("chain_kernel", "window_matmul_kernel",
                                     "split_w_kernel", "envdet_kernel",
                                     *WGMMA_KERNELS[3:], *PROBE_KERNELS)
                         if k in mangled), mangled[:40])
            name += template_args(mangled)
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.strip()}")
    return out


#: short known convolutions for the bare core, (taps, delay D, columns of
#: 64 outputs): the headline filter; the headline envelope's delay, past
#: its taps (the first steps skipped), eleven 128-tap units; envdet's
#: band-pass over 40 columns; one 54-tap phase of envdet's stage 2 over 5
CORE_CASES = ((175, 174, 64), (1393, 1464, 64), (511, 510, 40), (54, 53, 5))
#: the core's modes (``wgconv::Mode``) and each one's budget against
#: float64 at unit-scale outputs: 3xTF32 the fp32 contract; one TF32 pass
#: about 2^-10 of the taps' mass; split bf16 about 2^-15
CORE_MODES = (("TF32X3", 0, TOL_FILTERED), ("TF32X1", 1, 2e-3),
              ("BF16X3", 2, 1e-4), ("BF16X4", 3, 1e-4))


def core_taps(taps, mode):
    """The host's tap operand of the core in ``mode``: TF32 ``[hi | lo]``
    floats or bf16 ``[hi | lo]`` pair words."""
    from audian_torch.ops.cuda.chain import _split_taps, pair_taps

    return torch.from_numpy(pair_taps(taps) if mode >= 2
                            else _split_taps(taps))


def core_phase(lib, dev):
    """The bare convolution core (``wgmma_conv.cuh``'s ``conv`` through
    ``csrc/conv_probe.cu``: one warpgroup at N = 64 and N = 8) on
    :data:`CORE_CASES` in each of :data:`CORE_MODES`, every unit in full
    and with the host's light units, against a float64 convolution, taps
    of unit L1 norm over samples in [-1, 1], so that every output lies in
    [-1, 1]; returns ``{mode: largest error}``."""
    from audian_torch.ops.cuda._build import check
    from audian_torch.ops.cuda.chain import light_units

    rng = np.random.default_rng(SEED)
    worst = {}
    for T, D, ncols in CORE_CASES:
        taps = rng.standard_normal(T)
        taps = (taps / np.abs(taps).sum()).astype(np.float32)
        nsrc = 64 * ncols + D + 16
        src = rng.uniform(-1.0, 1.0, nsrc).astype(np.float32)
        full = np.convolve(src.astype(np.float64), taps.astype(np.float64))
        ref = full[D : D + 64 * ncols]
        ts = torch.from_numpy(src).to(dev)
        line = []
        for name, mode, tol in CORE_MODES:
            tp = core_taps(taps, mode).to(dev)
            phase, light = light_units(taps, D, 16 if mode >= 2 else 8)
            flags = torch.tensor([int(f) for f in light], dtype=torch.int32,
                                 device=dev)
            errs = []
            for ph, fl in ((0, None), (phase, flags)):
                out = torch.full((64 * ncols,), float("nan"), device=dev)
                out8 = torch.full((64 * min(ncols, 8),), float("nan"),
                                  device=dev)
                check(lib.conv_probe_launch(
                    ts.data_ptr(), nsrc, tp.data_ptr(), T, D, ncols, mode,
                    ph, 0 if fl is None else fl.data_ptr(), out.data_ptr(),
                    out8.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream),
                    "conv_probe")
                torch.cuda.synchronize()
                e64 = float(np.abs(out.cpu().numpy() - ref).max())
                e8 = float(np.abs(out8.cpu().numpy()
                                  - ref[: out8.numel()]).max())
                require(e64 <= tol and e8 <= tol,
                        f"core {name} T={T} D={D} light={fl is not None}: "
                        f"{e64} {e8}")
                errs.append(max(e64, e8))
            worst[name] = max(worst.get(name, 0.0), *errs)
            line.append(f"{name} {errs[0]:.3e} / {errs[1]:.3e} "
                        f"({sum(light)} of {len(light)} units light)")
        print(f"  core T={T} D={D} over {ncols} columns, N = 64 and 8, "
              f"full / light units, against float64: " + "; ".join(line))
    return worst


#: the core's rate: blocks of two warpgroups repeating the headline
#: envelope's convolution (1393 taps at delay 1464), at N columns and one
#: or two blocks an SM (set by the shared memory a block takes), in
#: 3xTF32 and (at N = 64 and 128, one block an SM) in BF16X3
CORE_RATE = ((8, 1, 0), (64, 1, 0), (128, 1, 0), (8, 2, 0), (64, 2, 0),
             (128, 2, 0), (64, 1, 2), (128, 1, 2))


def core_rate(lib, dev):
    """TFLOP/s (every pass counted) of the bare core at each
    :data:`CORE_RATE` width, occupancy and mode, CUDA events: what a wgmma
    of N columns costs when the two warpgroups of a block (and another
    block's, at two an SM) interleave."""
    from audian_torch.ops.cuda._build import check

    T, D = 1393, 1464
    rng = np.random.default_rng(SEED)
    nsrc = 64 * 128 + D + 16
    src = torch.from_numpy(rng.uniform(-1, 1, nsrc).astype(np.float32)).to(
        dev)
    taps = rng.standard_normal(T).astype(np.float32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(2 * sms * 256, device=dev)
    rates = {}
    for N, per_sm, mode in CORE_RATE:
        blocks, reps = per_sm * sms, 8
        smem = 150000 if per_sm == 1 else 100000
        tp = core_taps(taps, mode).to(dev)
        kw = 16 if mode >= 2 else 8
        x = D - T - (kw - 2)
        steps = (D + 63) // kw - ((x + kw - 1) // kw if x > 0 else 0) + 1

        def run():
            check(lib.conv_rate_launch(
                src.data_ptr(), nsrc, tp.data_ptr(), T, D, mode, blocks, N,
                reps, smem, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream), "conv_rate")

        ms = median_ms(run)
        flop = blocks * 2 * reps * steps * TF32_PASSES * 64 * N * kw * 2
        peak = 495 if mode < 2 else 989
        key = f"n{N}x{per_sm}" + ("" if mode == 0 else "_bf16x3")
        rates[key] = flop / ms / 1e9
        print(f"  core rate at N = {N}, {per_sm} block(s) an SM, "
              f"{'3xTF32' if mode == 0 else 'BF16X3'}: "
              f"{flop / ms / 1e9:.1f} TFLOP/s ({100 * flop / ms / 1e9 / peak:.1f}"
              f" % of {peak})")
    return rates


def chain_work(ck, x_ext, n):
    """Operations and bytes of one chain call: the filter and envelope
    taps and the lane-packed DFT per frame; int16 in, filtered, envelope
    and PSD out."""
    C = x_ext.shape[0]
    nf = n // 128
    flop = (2 * C * n * (len(ck.h) + len(ck.g))
            + nf * C * (2 * ck.nfft * ck.nfft + 3 * ck.nbins))
    nbytes = x_ext.numel() * x_ext.element_size() + 8 * C * n \
        + 4 * nf * C * ck.nbins
    return flop, nbytes


def window_matmul_work(x, w, S, nfr):
    """Operations and bytes of one window_matmul call."""
    C = x.shape[0]
    K, O = w.shape
    read = min(x.shape[1], (nfr - 1) * S + K) * C * x.element_size()
    return 2 * K * O * nfr * C, read + 4 * w.numel() + 4 * nfr * C * O


def envdet_work(ed, xw):
    """Operations and bytes of one envdet call: the band-pass over the
    stream the outputs need, its square, the decimated envelope taps; the
    window in, the envelope out."""
    C = xw.shape[1]
    ny = (ed.nout - 1) * ed.step + ed.ll
    flop = C * (ny * (2 * ed.lb + 1) + 2 * ed.nout * ed.ll)
    return flop, xw.numel() * xw.element_size() + 4 * C * ed.nout


def envdet_f64(ed, xw):
    """The envdet envelope in float64 over the same float32 taps (cuDNN
    off): an oracle for the kernel's arithmetic."""
    x = xw.double().T
    if xw.dtype == torch.int16:
        x = x / 32768.0
    s0, s1 = ed.hb - ed.lead2, ed.hb + (ed.nout - 1) * ed.step + ed.d_lp
    x0, x1 = s0 + ed.d_bp - (ed.lb - 1), s1 + ed.d_bp + 1
    seg = torch.nn.functional.pad(x[:, x0:x1], (0, max(0, x1 - x.shape[1])))
    with torch.backends.cudnn.flags(enabled=False):
        g = torch.flip(ed.g_bp.double(), (0,)).reshape(1, 1, -1)
        y = torch.nn.functional.conv1d(seg[:, None], g)[:, 0]
        g = torch.flip(ed.g_lp.double(), (0,)).reshape(1, 1, -1)
        e = torch.nn.functional.conv1d((y * y)[:, None], g,
                                       stride=ed.step)[:, 0]
    return (2.0 * torch.sqrt(e.clamp_min(0.0))).T


def check_envdet(ed, xw, label):
    """The envdet kernel against its plain version and the float64 oracle
    on one window; returns its largest absolute error."""
    from audian_torch.ops.cuda.envdet import envdet, envdet_plain

    got = envdet(ed, xw)
    want = envdet_plain(ed, xw)
    ref = envdet_f64(ed, xw)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    ep, ef, pf = max_abs(got, want), max_abs(got, ref), max_abs(want, ref)
    require(tuple(got.shape) == (ed.nout, xw.shape[1]),
            f"{label} shape {tuple(got.shape)}")
    require(bool(torch.isfinite(got).all()), f"{label} finite")
    require(ep <= TOL_DETECT * scale, f"{label}: envdet vs plain {ep}")
    require(ef <= TOL_DETECT * scale, f"{label}: envdet vs float64 {ef}")
    print(f"  {label} (tile {ed.tile}): kernel vs plain {ep:.3e}, vs "
          f"float64 {ef:.3e}; plain vs float64 {pf:.3e} (scale {scale:.4f})")
    return max(ep, ef)


def detect_chunk(gen, W, device):
    """A PCM-16 detect window (W, C): a 6.5 kHz tone gated at 1 Hz plus
    noise (bench.py:bench_detect's signal), made on the host from
    ``gen``."""
    t = (torch.arange(W, dtype=torch.float64) / RATE)[:, None]
    tone = torch.sin(2 * math.pi * 6500.0 * t) * (
        torch.sin(2 * math.pi * 1.0 * t) > 0)
    x = 0.4 * tone + 0.05 * torch.randn((W, C), generator=gen,
                                        dtype=torch.float64)
    q = torch.clamp(torch.round(x * 32768.0), -32768, 32767)
    return q.to(torch.int16).to(device)


def song_recording(rng, seconds):
    """PCM-16 (n, C) with songs planted at :data:`SONG_STARTS` on every
    channel: 1.5 s of a channel's carrier (2-8.75 kHz) amplitude-modulated
    at 100 Hz, over noise.  (The detector drops songs whose envelope
    frequency strays more than 1 % from the mean, and Welch's bins are
    about 0.7 Hz apart here: at 30 Hz a song can read 0.5 Hz off and be
    dropped, at 100 Hz the 1 Hz margin holds.)"""
    n = int(seconds * RATE)
    x = 0.02 * rng.standard_normal((n, C), dtype=np.float32)
    carriers = 2000.0 + 450.0 * np.arange(C)
    for s0 in SONG_STARTS:
        i0, i1 = int(s0 * RATE), int((s0 + 1.5) * RATE)
        t = np.arange(i0, i1)[:, None] / RATE
        am = 0.5 * (1 + np.sin(2 * np.pi * 100.0 * t))
        x[i0:i1] += (0.5 * am * np.sin(2 * np.pi * carriers * t)).astype(
            np.float32)
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


# -- phase 16: the IFIR envelope and the exact IIR filters -------------------

IFIR_ENV = 500.0         # Hz, the bioacoustics envelope
IFIR_EPS = 1e-7
TOL_IFIR_DENSE = 3e-6    # tests/test_fused.py:69-81, the JAX IFIR budget
TOL_IFIR_SCIPY = 1e-5
IFIR_SLICE = (1 << 21, 1 << 16)   # start, length of the scipy slice
IFIR_MARGIN = 1 << 14    # samples scipy filters on each side of the slice
IIR_SECONDS = 60         # the interactive window's size
IIR_CHUNKS = (1_900_001, 3_700_003)   # where the three sosfilt chunks start
IIR_CHANNELS = (0, 9)    # channels held against scipy float64
# float32 against float32 in other block alignments, and against scipy
# float64: a few float32 steps at unit scale (the CPU tests' budgets)
TOL_IIR_CHUNKED = 1e-6
TOL_IIR_SCIPY = 1e-6
TOL_IIRFF_SCIPY = 2e-6


def ifir_stages(fc, y, torch_copies=False):
    """The stages of ``fc``'s IFIR envelope of ``y``, as
    ``FusedChainCF._envelope_ifir_cf`` runs them: each window_matmul's
    arguments, and the relayouts between them as functions (the port's
    ``pm_forward`` / ``pm_inverse``, or with ``torch_copies`` their plain
    versions, the torch reshape-and-transpose copies they replaced)."""
    from audian_torch.ops.cuda import probes as P

    C, n = y.shape
    B, M = fc.block, fc.ifir_M
    n_pad = -(-n // M) * M
    n_u = n_pad + (fc.ifir_Lg - 1) * M
    q_out = n_pad // M
    xp = torch.nn.functional.pad(y, (fc.env_halo,
                                     fc.env_delay + n_pad - n))
    a_args = (xp, fc.env_i_w, B, -(-n_u // B), "rectify", "cf")
    forward, inverse = ((P.pm_forward_plain, P.pm_inverse_plain)
                        if torch_copies else (P.pm_forward, P.pm_inverse))

    def to_pm(u):
        return forward(u[:, :n_u], M)

    def from_pm(e_pm):
        return inverse(e_pm[:, :q_out], M)[:, :n]

    return a_args, to_pm, (fc.env_g_w, B, -(-q_out // B), None, "cf"), \
        from_pm


def ifir_phase(card, dev):
    """Phase 16a: ``FusedChainCF(ifir=True)``'s envelope of one headline
    chunk.  Returns window_matmul's launches on it (counters zeroed just
    before, read just after), its CUDA-event time, window_matmul's largest
    error and a dict of the relayouts: their launches, the kernels' and
    the torch copies' times and the bytes they move."""
    from audian_torch.ops.cuda.probes import pm_forward, pm_inverse
    from audian_torch.ops.cuda.window_matmul import (window_matmul,
                                                     window_matmul_plain)
    from audian_torch.ops.design import design_envelope_filter
    from audian_torch.ops.fused import FusedChainCF

    print(f"phase 16: the IFIR envelope ({IFIR_ENV:g} Hz at {RATE:g} Hz, "
          f"eps {IFIR_EPS:g}) at {C} ch x {CHUNK} float32")
    env = design_envelope_filter(RATE, IFIR_ENV)
    a = time.perf_counter()
    fi = FusedChainCF(RATE, env_sos=env, eps=IFIR_EPS, ifir=True,
                      device=dev)
    fit_s = time.perf_counter() - a
    dense = FusedChainCF(RATE, env_sos=env, eps=IFIR_EPS, device=dev)
    require(fi.env_mode == "ifir" and dense.env_mode == "dense",
            f"modes {fi.env_mode} {dense.env_mode}")
    B, M, Lg = fi.block, fi.ifir_M, fi.ifir_Lg
    Li = fi.env_i_w.shape[0] - B + 1
    L = len(fi._g_env)
    # the float32 factors' L1 error against the float64 kernel
    i = fi.env_i_w[:, 0].flip(0)[B - 1:].double().cpu().numpy()
    g = fi.env_g_w[:, 0].flip(0)[B - 1:].double().cpu().numpy()
    up = np.zeros((Lg - 1) * M + 1)
    up[::M] = g
    kern = np.convolve(i, up)
    fit_err = float(np.abs(kern[:L] - fi._g_env).sum() + np.abs(kern[L:]).sum())
    print(f"  M {M}  Li {Li}  Lg {Lg}  (dense kernel {L} taps); the fit "
          f"took {fit_s:.2f} s on the host, L1 error of the float32 factors "
          f"{fit_err:.3e}")
    macs_dense, macs_ifir = L, Li + Lg
    bank_dense = dense.env_w.shape[0]
    bank_ifir = fi.env_i_w.shape[0] + fi.env_g_w.shape[0]
    print(f"  multiply-adds a sample: dense {macs_dense} taps ({bank_dense} "
          f"in its bank), ifir {macs_ifir} taps ({bank_ifir} in its two "
          f"banks): {macs_dense / macs_ifir:.2f}x ({bank_dense / bank_ifir:.2f}x"
          f" of the banks)")

    gen = torch.Generator().manual_seed(SEED + 16)
    t = torch.arange(CHUNK, dtype=torch.float64) / RATE
    tone = torch.sin(2 * math.pi * 5000.0 * t) * (
        torch.sin(2 * math.pi * 3.0 * t) > 0)
    y = (0.4 * tone + 0.05 * torch.randn((C, CHUNK), generator=gen,
                                         dtype=torch.float64))
    y = y.to(torch.float32).to(dev)
    window_matmul.launches = pm_forward.launches = pm_inverse.launches = 0
    e = fi.envelope_cf(y)
    torch.cuda.synchronize()
    launches = window_matmul.launches
    pm_launches = {"pm_forward": pm_forward.launches,
                   "pm_inverse": pm_inverse.launches}
    require(launches == 2, f"the IFIR envelope launches window_matmul "
            f"twice, {launches}")
    require(pm_launches == {"pm_forward": 1, "pm_inverse": 1},
            f"the IFIR envelope launches each relayout kernel once, "
            f"{pm_launches}")
    require(e.shape == y.shape and bool(torch.isfinite(e).all()),
            f"IFIR envelope shape {tuple(e.shape)}")
    # each window_matmul call against its plain version, at its shapes
    a_args, to_pm, b_args, from_pm = ifir_stages(fi, y)
    u = window_matmul(*a_args[:4], premap=a_args[4], out_layout=a_args[5])
    u_pm = to_pm(u)
    e_pm = window_matmul(u_pm, *b_args[:3], premap=b_args[3],
                         out_layout=b_args[4])
    err = 0.0
    for label, args, got in (("stage A", a_args, u),
                             ("stage B", (u_pm,) + b_args, e_pm)):
        want = window_matmul_plain(*args[:4], premap=args[4],
                                   out_layout=args[5])
        torch.cuda.synchronize()
        d = max_abs(got, want)
        scale = float(want.abs().max())
        require(d <= TOL_WINDOW * scale, f"IFIR {label} {d} (scale {scale})")
        err = max(err, d)
        print(f"  {label}: x {tuple(args[0].shape)} K={args[1].shape[0]} "
              f"O={args[1].shape[1]} S={args[2]} frames={args[3]} "
              f"max_abs_err {d:.3e} (scale {scale:.3e})")
    require(torch.equal(torch.clamp_min(from_pm(e_pm), 0.0), e),
            "the stages give envelope_cf's result")
    # the torch copies the kernels replaced give the same envelope, bit
    # for bit: a relayout moves words and computes nothing
    _, to_pm_t, _, from_pm_t = ifir_stages(fi, y, torch_copies=True)
    u_pm_t = to_pm_t(u)
    require(torch.equal(u_pm.view(torch.int32), u_pm_t.view(torch.int32)),
            "pm_forward == the torch relayout, bit for bit")
    e_t = torch.clamp_min(from_pm_t(window_matmul(
        u_pm_t, *b_args[:3], premap=b_args[3], out_layout=b_args[4])), 0.0)
    require(torch.equal(e_t.view(torch.int32), e.view(torch.int32)),
            "the kernel-relayout envelope == the torch-relayout envelope")
    print(f"  relayouts: pm_forward and pm_inverse launched once each; the "
          f"envelope equals the torch-copy relayouts' bit for bit")
    del u_pm_t, e_t
    ed = dense.envelope_cf(y)
    dd = max_abs(e, ed)
    require(dd <= TOL_IFIR_DENSE, f"IFIR against dense {dd}")
    lo, n_s = IFIR_SLICE
    seg = y[list(IIR_CHANNELS), lo - IFIR_MARGIN : lo + n_s + IFIR_MARGIN]
    env64 = sps.sosfiltfilt(env, (np.pi / 2) * np.abs(
        seg.double().cpu().numpy()), axis=1)
    env64 = np.maximum(env64[:, IFIR_MARGIN : IFIR_MARGIN + n_s], 0.0)
    got = e[list(IIR_CHANNELS), lo : lo + n_s].double().cpu().numpy()
    ds = float(np.abs(got - env64).max())
    require(ds <= TOL_IFIR_SCIPY, f"IFIR against scipy {ds}")
    print(f"  envelope: {launches} window_matmul launches; against dense "
          f"{dd:.3e}, against scipy float64 on {n_s} samples of channels "
          f"{list(IIR_CHANNELS)} {ds:.3e}")
    del u, u_pm, e_pm, ed

    # times
    u = window_matmul(*a_args[:4], premap=a_args[4], out_layout=a_args[5])
    u_pm = to_pm(u)
    e_pm = window_matmul(u_pm, *b_args[:3], premap=b_args[3],
                         out_layout=b_args[4])
    ms = {
        "ifir": median_ms(lambda: fi.envelope_cf(y)),
        "stage A": median_ms(lambda: window_matmul(
            *a_args[:4], premap=a_args[4], out_layout=a_args[5],
            split=fi._splits["env_i_w"])),
        "relayout to phase-major": median_ms(lambda: to_pm(u)),
        "stage B": median_ms(lambda: window_matmul(
            u_pm, *b_args[:3], premap=b_args[3], out_layout=b_args[4],
            split=fi._splits["env_g_w"])),
        "relayout back": median_ms(lambda: from_pm(e_pm).contiguous()),
        "dense": median_ms(lambda: dense.envelope_cf(y)),
    }
    # the library column: the torch copies, one call each into a tensor
    # made before (the plain versions are the same expressions)
    n_u, q_out = u_pm.shape[1] * fi.ifir_M, e.shape[1] // fi.ifir_M
    u_view = u[:, :n_u].reshape(C, -1, fi.ifir_M).transpose(1, 2)
    e_view = e_pm[:, :q_out].reshape(C, fi.ifir_M, q_out).transpose(1, 2)
    u_out = torch.empty(u_view.shape, device=dev)
    e_out = torch.empty(e_view.shape, device=dev)
    ms_torch = {
        "relayout to phase-major": median_ms(lambda: u_out.copy_(u_view)),
        "relayout back": median_ms(lambda: e_out.copy_(e_view)),
    }
    ms_plain = {
        "relayout to phase-major": median_ms(lambda: to_pm_t(u)),
        "relayout back": median_ms(lambda: from_pm_t(e_pm).contiguous()),
    }
    # the relayouts and their torch copies back to back, as the probes'
    # sweeps time theirs (phase 18)
    ms_b2b = {
        "relayout to phase-major": median_ms(lambda: to_pm(u), calls=CALLS),
        "relayout back": median_ms(lambda: from_pm(e_pm).contiguous(),
                                   calls=CALLS)}
    ms_torch_b2b = {
        "relayout to phase-major": median_ms(lambda: u_out.copy_(u_view),
                                             calls=CALLS),
        "relayout back": median_ms(lambda: e_out.copy_(e_view),
                                   calls=CALLS)}
    flop = 2 * C * CHUNK * macs_ifir
    nbytes = 2 * 4 * C * CHUNK
    b32 = bound(flop, nbytes)
    btc = bound(TF32_PASSES * flop, nbytes, PEAK_TF32)
    relayout_ms = ms["relayout to phase-major"] + ms["relayout back"]
    relayout_torch_ms = sum(ms_torch.values())
    relayout_bytes = 2 * 4 * (u_pm.numel() + e.numel())
    print(f"  times (CUDA events, ms): " + "  ".join(
        f"{k} {v:.4f}" for k, v in ms.items()) + f"  [{card}]")
    print(f"  back to back ({CALLS} calls): " + "  ".join(
        f"{k} {v:.4f}" for k, v in ms_b2b.items()) + "; the torch copies " +
        "  ".join(f"{k} {v:.4f}" for k, v in ms_torch_b2b.items()) +
        f"  [{card}]")
    print(f"  torch copies (one copy_ each, the library column): " +
          "  ".join(f"{k} {v:.4f}" for k, v in ms_torch.items()) +
          "; plain: " + "  ".join(f"{k} {v:.4f}" for k, v in
                                  ms_plain.items()) + f"  [{card}]")
    print(f"  IFIR against dense {ms['dense'] / ms['ifir']:.2f}x; the "
          f"relayout kernels {relayout_ms:.4f} ms, "
          f"{100 * relayout_ms / ms['ifir']:.1f} % of the IFIR envelope "
          f"(the torch copies {relayout_torch_ms:.4f} ms; bound "
          f"{1e3 * relayout_bytes / PEAK_BYTES:.4f} ms, bytes); its bound "
          f"{b32[0]:.4f} ms ({b32[1]}, fp32 at 67 TFLOP/s), as 3xTF32 "
          f"{btc[0]:.4f} ms ({btc[1]})  [{card}]")
    relayout = {"launches": pm_launches, "ms": relayout_ms,
                "ms_back_to_back": sum(ms_b2b.values()),
                "library_ms_back_to_back": sum(ms_torch_b2b.values()),
                "stage_ms": {k: ms[k] for k in ms_torch},
                "stage_ms_back_to_back": ms_b2b,
                "plain_ms": sum(ms_plain.values()),
                "library_ms": relayout_torch_ms, "bytes": relayout_bytes,
                "share_of_ifir": relayout_ms / ms["ifir"]}
    del u, u_pm, e_pm, e, y, u_out, e_out
    return launches, ms["ifir"], err, relayout


def iir_phase(card, dev):
    """Phase 16b: the exact IIR filters (``ops.sosfilt`` whole and in
    three chunks with the state carried, ``sosfiltfilt``, ``envelope``)
    over the interactive window's size, on plain torch ops."""
    from audian_torch.ops import (FilterDesign, design_envelope_filter,
                                  design_filter, envelope, sosfilt,
                                  sosfilt_fir, sosfiltfilt, sosfiltfilt_fir)

    n = int(IIR_SECONDS * RATE)
    print(f"phase 16: the exact IIR filters on {IIR_SECONDS} s x {C} ch x "
          f"96 kHz float32 on the card")
    band = design_filter(RATE, 2000.0, 40000.0)
    env = design_envelope_filter(RATE, IFIR_ENV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 160)
    t = torch.arange(n, device=dev, dtype=torch.float64)[:, None] / RATE
    freqs = 3000.0 + 2200.0 * torch.arange(C, device=dev)
    gate = torch.sin(2 * math.pi * 3.0 * t) > 0.3
    x = 0.4 * torch.sin(2 * math.pi * t * freqs) * gate \
        + 0.2 * torch.sin(2 * math.pi * 13.0 * t)
    x = (x + 0.05 * torch.randn((n, C), generator=gen, device=dev,
                                dtype=torch.float64)).to(torch.float32)
    del t, gate

    def chunked():
        parts, zf = [], torch.zeros((len(band), 2, C), device=dev)
        for lo, hi in zip((0,) + IIR_CHUNKS, IIR_CHUNKS + (n,)):
            y, zf = sosfilt(band, x[lo:hi], zi=zf)
            parts.append(y)
        return torch.cat(parts), zf

    whole, zf_whole = sosfilt(band, x, zi=torch.zeros((len(band), 2, C),
                                                       device=dev))
    ch, zf = chunked()
    ff = sosfiltfilt(band, x)
    ev = envelope(x, env)
    torch.cuda.synchronize()
    for name, v in (("sosfilt", whole), ("sosfiltfilt", ff),
                    ("envelope", ev)):
        require(v.shape == x.shape and bool(torch.isfinite(v).all()),
                f"{name} shape {tuple(v.shape)}")
    dc = max(max_abs(ch, whole), max_abs(zf, zf_whole))
    require(dc <= TOL_IIR_CHUNKED, f"sosfilt chunked against whole {dc}")
    cols = list(IIR_CHANNELS)
    x64 = x[:, cols].double().cpu().numpy()
    errs = {
        "sosfilt": (whole, sps.sosfilt(band, x64, axis=0), TOL_IIR_SCIPY),
        "sosfiltfilt": (ff, sps.sosfiltfilt(band, x64, axis=0),
                        TOL_IIRFF_SCIPY),
        "envelope": (ev, np.maximum(sps.sosfiltfilt(
            env, (np.pi / 2) * np.abs(x64), axis=0), 0.0), TOL_IIRFF_SCIPY),
    }
    for name, (got, want, tol) in errs.items():
        d = float(np.abs(got[:, cols].double().cpu().numpy() - want).max())
        require(d <= tol, f"{name} against scipy {d}")
        errs[name] = d
    print(f"  sosfilt in 3 chunks against whole {dc:.3e}; channels {cols} "
          f"against scipy float64: " + "  ".join(
              f"{k} {v:.3e}" for k, v in errs.items()))
    del whole, ch, ff, ev, zf, zf_whole

    # float32 against scipy at three designs (the last near DC), and the
    # envelope on the exact smoother beside the FIR path's
    x2 = x[:, cols].contiguous()
    line = []
    for label, sos in (("2-40 kHz", band), (f"{IFIR_ENV:g} Hz", env),
                       ("20 Hz", design_envelope_filter(RATE, 20.0))):
        d = float(np.abs(sosfilt(sos, x2).double().cpu().numpy()
                         - sps.sosfilt(sos, x64, axis=0)).max())
        require(d <= TOL_IIR_SCIPY, f"sosfilt {label} against scipy {d}")
        line.append(f"{label} {d:.3e}")
    print(f"  float32 sosfilt against scipy float64 (channels {cols}): "
          + "  ".join(line))
    rect2 = (math.pi / 2) * torch.abs(x2)
    for cutoff in (IFIR_ENV, 1500.0):
        sos = design_envelope_filter(RATE, cutoff)
        want = np.maximum(sps.sosfiltfilt(
            sos, (np.pi / 2) * np.abs(x64), axis=0), 0.0)
        fd = FilterDesign.from_sos(sos)
        fir = torch.clamp_min(
            sosfiltfilt_fir(fd.fir, rect2, fd.zi0, fd.padlen), 0.0)
        de, df = (float(np.abs(v.double().cpu().numpy() - want).max())
                  for v in (envelope(x2, sos), fir))
        require(de <= TOL_IIRFF_SCIPY, f"envelope {cutoff} against scipy "
                f"{de}")
        print(f"  envelope {cutoff:g} Hz against scipy float64: exact "
              f"smoother {de:.3e}, FIR path {df:.3e}")
    del x2, rect2

    fb, fe = FilterDesign.from_sos(band), FilterDesign.from_sos(env)

    def fir_envelope():
        rect = (math.pi / 2) * torch.abs(x)
        return torch.clamp_min(
            sosfiltfilt_fir(fe.fir, rect, fe.zi0, fe.padlen), 0.0)

    def host_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            a = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - a))
        return float(np.median(out))

    rows = [("sosfilt", lambda: sosfilt(band, x),
             lambda: sosfilt_fir(fb.fir, x)),
            ("sosfilt in 3 chunks", chunked, None),
            ("sosfiltfilt", lambda: sosfiltfilt(band, x),
             lambda: sosfiltfilt_fir(fb.fir, x, fb.zi0, fb.padlen)),
            ("envelope", lambda: envelope(x, env), fir_envelope)]
    for name, fn, fir in rows:
        line = f"  {name}: {host_ms(fn):.3f} ms"
        if fir is not None:
            line += f", FIR path {host_ms(fir):.3f} ms"
        print(line + f" (host clock to a synchronize, median of 3)  [{card}]")
    del x


def psd_db_err(got, want):
    """Largest |dB difference| over bins within 60 dB of the peak."""
    got, want = got.double(), want.double()
    keep = want >= want.max() * 1e-6
    ratio = got[keep].clamp_min(1e-300) / want[keep]
    return float((10 * torch.log10(ratio)).abs().max())


def int16_chunk(gen, shape, device):
    """A PCM-16 test chunk: a gated 30 kHz tone plus noise (bench.py's
    headline signal), made on the host from ``gen``."""
    t = torch.arange(shape[1], dtype=torch.float64) / RATE
    tone = torch.sin(2 * math.pi * 30000.0 * t) * (
        torch.sin(2 * math.pi * 5.0 * t) > 0)
    x = 0.5 * tone + 0.05 * torch.randn(shape, generator=gen,
                                        dtype=torch.float64)
    q = torch.clamp(torch.round(x * 32768.0), -32768, 32767)
    return q.to(torch.int16).to(device)


def chain_f64(ck, q, n):
    """Filtered and envelope of the chain in float64 (same float32 taps):
    an oracle for the kernel's arithmetic."""
    x = q.double() / 32768.0
    Tf, L = len(ck.h), len(ck.g)
    seg = x[:, ck.hb - ck.lead - (Tf - 1) : ck.hb + n + ck.tail]
    h = torch.flip(ck.h.double(), (0,)).reshape(1, 1, -1)
    y = torch.nn.functional.conv1d(seg[:, None], h)[:, 0]
    v = (math.pi / 2) * y.abs()
    a = ck.lead + ck.delay - (L - 1)
    g = torch.flip(ck.g.double(), (0,)).reshape(1, 1, -1)
    e = torch.nn.functional.conv1d(v[:, None, a : a + n + L - 1], g)[:, 0]
    return y[:, ck.lead : ck.lead + n], e.clamp_min(0.0)


def stages_route_check(gen, dev, n=1 << 22):
    """``chain_cf``'s per-stage route as the ``ultrasound-stages`` cell runs
    it: the 384 kHz ``ultrasound`` chain at its default eps 1e-7 (a design
    the single-pass kernel refuses) over a 16 ch int16 chunk
    ``[hb | n | ha]`` carrying a gated 45 kHz call train.  Each of the
    call's window products (the band-pass over the int16 chunk through
    ``"dequant"``, the rectified envelope, the hop-256 PSD) is held against
    ``window_matmul_plain`` on the same inputs, premap and stride within
    :data:`TOL_WINDOW` of its output's scale; the route's outputs against
    the per-stage methods on the chunk's dequantized stream (its halos and
    slicing), the statistics the sums of its outputs.  ``window_matmul``'s
    counter, zeroed just before the call, reads 3, as does the
    ``stages.call`` span's ``launches``.  Returns that count."""
    from audian_torch.models import get_preset
    from audian_torch.ops import fused, stft
    from audian_torch.ops.cuda.chain import ALL_OUTPUTS
    from audian_torch.ops.cuda.window_matmul import (window_matmul,
                                                     window_matmul_plain)
    from audian_torch.ops.raw16 import dequant16
    from audian_torch.utils import trace

    rate = 384000.0
    fc = get_preset("ultrasound").fused(rate, device=dev)
    require(fc.chain_kernel is None, "the design takes the per-stage route")
    hb, ha = fc.hb, fc.ha
    t = torch.arange(hb + n + ha, dtype=torch.float64) / rate
    tone = torch.sin(2 * math.pi * 45000.0 * t) * (
        torch.sin(2 * math.pi * 10.0 * t) > 0)
    x = 0.5 * tone + 0.05 * torch.randn((C, len(t)), generator=gen,
                                        dtype=torch.float64)
    q = torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(
        torch.int16).to(dev)
    del t, tone, x
    calls = []
    real = fused.window_matmul

    class Recorded:
        """``window_matmul`` that keeps each call's arguments and output,
        its counter the real one's."""

        launches = property(lambda self: real.launches)

        def __call__(self, *args, **kw):
            out = real(*args, **kw)
            calls.append((args, kw, out))
            return out

    recorded = Recorded()

    trace.clear()
    trace.enable(log=False)
    fused.window_matmul = stft.window_matmul = recorded
    try:
        window_matmul.launches = 0
        y, e, s, st = fc.chain_cf(q, n, stats=True)
        made = window_matmul.launches
        torch.cuda.synchronize()
        spans = trace.events("stages.call")
        stages = [ev["stage"] for ev in trace.events("stages.stage")]
    finally:
        fused.window_matmul = stft.window_matmul = real
        trace.disable()
        trace.clear()
    require(made == 3 and len(calls) == 3,
            f"the route launches window_matmul 3 times, {made}")
    require(len(spans) == 1 and spans[0]["launches"] == made,
            f"stages.call launches {[c.get('launches') for c in spans]}, "
            f"window_matmul counted {made}")
    require(stages == ["filtered", "envelope", "spectrogram", "stats"],
            f"stages.stage spans {stages}")
    for stage, (args, kw, got) in zip(ALL_OUTPUTS, calls):
        kw = {k: v for k, v in kw.items() if k != "split"}
        want = window_matmul_plain(*args, **kw)
        torch.cuda.synchronize()
        err, scale = max_abs(got, want), float(want.abs().max())
        xw, w, S, nfr = args[:4]
        what = (f"route {stage} window_matmul K={w.shape[0]} "
                f"O={w.shape[1]} S={S} frames={nfr} "
                f"premap={kw.get('premap')} {tuple(xw.shape)} {xw.dtype}")
        require(got.shape == want.shape and err <= TOL_WINDOW * scale,
                f"{what}: {err} (scale {scale})")
        print(f"  {what}: max_abs_err {err:.3e} (scale {scale:.3e})")
        del want
    del calls
    y_ps = fc.filtered_cf(dequant16(q))
    want = (y_ps[:, hb : hb + n], fc.envelope_cf(y_ps)[:, hb : hb + n],
            fc.spectrogram_fc(y_ps[:, hb : hb + n + fc.nfft - fc.hop]))
    torch.cuda.synchronize()
    for name, got, w in zip(ALL_OUTPUTS, (y, e, s), want):
        err, scale = max_abs(got, w), float(w.abs().max())
        require(got.shape == w.shape and err <= TOL_WINDOW * scale,
                f"route {name} == per-stage methods: {err} (scale {scale})")
        print(f"  route {name} {tuple(got.shape)} against the per-stage "
              f"methods: max_abs_err {err:.3e} (scale {scale:.3e})")
    for key, v in (("power", (y.double() ** 2).sum(1)),
                   ("env_sum", e.double().sum(1)),
                   ("psd_sum", s.double().sum(0))):
        gap = float(((st[key].double() - v).abs() / v.abs()).max())
        require(gap <= TOL_STATS_RTOL, f"route {key} {gap}")
    print(f"  route of {rate:.0f} Hz hop {fc.hop} on 16 ch x {n} int16: "
          f"hb {hb} ha {ha}; window_matmul launches {made} (counter zeroed "
          f"before the call; stages.call launches {spans[0]['launches']}), "
          f"device {spans[0].get('device_ms', float('nan')):.3f} ms")
    return made


def check_chain(ck, x_ext, n, label):
    """Kernel against plain on one chunk; returns (max abs err, outputs)."""
    from audian_torch.ops.cuda.chain import chain, chain_plain

    got = chain(ck, x_ext, n, stats=True)
    want = chain_plain(ck, x_ext, n, stats=True)
    torch.cuda.synchronize()
    ey, ee = max_abs(got[0], want[0]), max_abs(got[1], want[1])
    es = psd_db_err(got[2], want[2])
    require(ey <= TOL_FILTERED, f"{label} filtered {ey}")
    require(ee <= TOL_ENVELOPE, f"{label} envelope {ee}")
    require(es <= TOL_PSD_DB, f"{label} psd {es} dB")
    for key in ("power", "env_sum"):
        g, w = got[3][key].double(), want[3][key].double()
        r = float(((g - w).abs() / w.abs()).max())
        require(r <= TOL_STATS_RTOL, f"{label} {key} rtol {r}")
    eq = psd_db_err(got[3]["psd_sum"], want[3]["psd_sum"])
    require(eq <= TOL_PSD_DB, f"{label} psd_sum {eq} dB")
    # the in-kernel stats equal reductions of the kernel's own outputs
    for key, val in (("power", (got[0].double() ** 2).sum(1)),
                     ("env_sum", got[1].double().sum(1))):
        r = float(((got[3][key].double() - val).abs() / val.abs()).max())
        require(r <= TOL_STATS_RTOL, f"{label} {key} vs outputs {r}")
    print(f"  {label}: filtered {ey:.3e}  envelope {ee:.3e}  "
          f"psd {es:.3e} dB  psd_sum {eq:.3e} dB")
    return max(ey, ee), got


# -- phase 17: the precision rungs ----------------------------------------

#: the chain's rungs, (filter, envelope, PSD): the port's default, the JAX
#: package's default, split bf16 everywhere, a 4-pass filter, DEFAULT
CHAIN_RUNGS = (("highest",) * 3, ("highest", "bf16x3", "bf16x3"),
               ("bf16x3",) * 3, ("bf16x4", "bf16x3", "bf16x3"),
               ("default",) * 3)
#: light units against every unit full on the headline design: filtered,
#: envelope (absolute) and PSD (dB within 60 dB of the peak), each also
#: non-zero (tests/test_device_tpu.py:246-254)
TOL_LIGHT = (1e-6, 5e-6, 0.05)
#: the core's passes and tensor rate (TFLOP/s) of each mode
MODE_PASSES = {0: 3, 1: 1, 2: 3, 3: 4}
MODE_PEAK = {0: 495e12, 1: 495e12, 2: 989e12, 3: 989e12}
BOUNDARY_N = 1 << 18


def rung_name(prec):
    """``"(H,B3,B3)"`` of a chain's per-stage rungs."""
    short = {"highest": "H", "high": "HI", "default": "D", "bf16x3": "B3",
             "bf16x4": "B4"}
    return "(" + ",".join(short[p] for p in prec) + ")"


def light_share(T, D, mode, phase, flags):
    """The share of a stage's core steps that its light units hold."""
    from audian_torch.ops.cuda.chain import unit_steps

    spans = unit_steps(T, D, 16 if mode >= 2 else 8, phase)
    total = sum(ve - vs for vs, ve in spans)
    return sum(ve - vs for (vs, ve), f in zip(spans, flags) if f) / total


def chain_rung_bound(ck, x_ext, n):
    """The least ms of one chain call at ``ck``'s rungs: each stage's
    true-tap operations times its passes (its light units' share at one
    pass) at its mode's tensor rate (TF32 495, bf16 989 TFLOP/s), or the
    bytes at 3.35 TB/s, whichever is larger."""
    C, nf = x_ext.shape[0], n // 128
    ops = (2 * C * n * len(ck.h), 2 * C * n * len(ck.g),
           nf * C * (2 * ck.nfft * ck.nfft + 3 * ck.nbins))
    light = (light_share(len(ck.h), len(ck.h) - 1, ck.modes[0], ck.phase_f,
                         ck.light_f),
             light_share(len(ck.g), ck.lead + ck.delay, ck.modes[1],
                         ck.phase_e, ck.light_e), 0.0)
    t = sum(op * ((1 - f) * MODE_PASSES[m] + f) / MODE_PEAK[m]
            for op, m, f in zip(ops, ck.modes, light))
    return 1e3 * max(t, chain_work(ck, x_ext, n)[1] / PEAK_BYTES)


def envdet_rung_bound(ed, xw):
    """The least ms of one envdet call at ``ed``'s rung: the band-pass's
    operations times its passes (light units at one), the decimating
    stage's at three TF32 passes (it keeps fp32 precision under every
    rung), at 495 TFLOP/s, or the bytes."""
    C = xw.shape[1]
    ny = (ed.nout - 1) * ed.step + ed.ll
    f = light_share(ed.lb, ed.lb - 1, ed.mode, ed.phase, ed.light)
    t = (C * ny * (2 * ed.lb) * ((1 - f) * MODE_PASSES[ed.mode] + f)
         + 3 * C * (ny + 2 * ed.nout * ed.ll)) / 495e12
    return 1e3 * max(t, envdet_work(ed, xw)[1] / PEAK_BYTES)


def all_full(kernel):
    """A copy of a chain or envdet kernel whose units all run in full."""
    k = copy.copy(kernel)
    for attr in ("light_f", "light_e", "light"):
        if hasattr(k, attr):
            setattr(k, attr, (False,) * len(getattr(k, attr)))
    return k


def boundary_taps(taps, nblocks=3):
    """``taps`` with a flat alternating-sign tail over ``nblocks`` 128-tap
    blocks whose L1 mass is 0.98 of the light budget of the whole
    (tests/test_device_tpu.py:266-274)."""
    from audian_torch.ops.cuda.chain import LIGHT_MASS_FRAC as frac

    mass = float(np.abs(taps).sum())
    total = 0.98 * frac * mass / (1.0 - 0.98 * frac)
    tail = np.full(nblocks * 128, total / (nblocks * 128))
    tail[1::2] *= -1.0
    return np.concatenate([np.asarray(taps, np.float64), tail])


def boundary_signal(n):
    """Four full-scale channels (float32): the Nyquist alternation (the
    boundary tail's sign pattern), DC, clipped noise, a 30 kHz square
    wave."""
    rng = np.random.default_rng(7)
    return np.stack([
        np.tile([1.0, -1.0], n // 2), np.ones(n),
        np.clip(rng.standard_normal(n) / 3.0, -1.0, 1.0),
        np.sign(np.sin(2 * np.pi * 30000.0 * np.arange(n) / RATE)),
    ]).astype(np.float32)


def precision_phase(card, dev, bio, wm_cases, ed, qd):
    """Phase 17: every rung of the three kernels against its plain
    version (and float64) at the headline shapes, the light units against
    every unit full, the boundary design, and each rung's CUDA-event
    time beside its bound; returns the kernels line's ``precision``
    entries."""
    from audian_torch.ops.cuda.chain import (LIGHT_MASS_FRAC, ChainKernel,
                                             chain, chain_plain,
                                             unit_masses)
    from audian_torch.ops.cuda.envdet import (EnvDetKernel, envdet,
                                              envdet_plain)
    from audian_torch.ops.cuda.window_matmul import (BankSplit,
                                                     window_matmul,
                                                     window_matmul_plain)
    from audian_torch.ops.envdet import EnvDet

    print("phase 17: the precision rungs against their plain versions")
    out = {"chain": {}, "window_matmul": {}, "envdet": {}}
    ck0 = bio.chain_kernel
    spec_w = ck0.spec_w.cpu().numpy()

    def build(prec, h=bio._h_filt, g=bio._g_env):
        return ChainKernel(RATE, h, g, bio.env_delay, spec_w, ck0.nbins,
                           env_clamp=ck0.env_clamp, nfft=ck0.nfft,
                           device=dev, precision=prec)

    gen = torch.Generator().manual_seed(SEED + 17)
    q = int16_chunk(gen, (C, ck0.hb + CHUNK + ck0.ha), dev)
    plain = chain_plain(ck0, q, CHUNK)
    ref_y, ref_e = chain_f64(ck0, q, CHUNK)
    scales = [float(v.abs().max()) for v in plain]
    runs = {}
    for prec in CHAIN_RUNGS:
        k = build(prec)
        name = rung_name(prec)
        got = chain(k, q, CHUNK)
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(v).all()) for v in got),
                f"chain {name} finite")
        ey, ee = max_abs(got[0], ref_y), max_abs(got[1], ref_e)
        es = psd_db_err(got[2], plain[2])
        rel = [max_abs(a, b) / sc for a, b, sc in zip(got, plain, scales)]
        if prec == ("default",) * 3:
            require(max(rel) <= TOL_DEFAULT,
                    f"chain {name} within {TOL_DEFAULT} of scale: {rel}")
        elif prec[0] == "highest":
            require(ey <= TOL_FILTERED and ee <= TOL_ENVELOPE
                    and es <= TOL_PSD_DB, f"chain {name}: {ey} {ee} {es}")
        ms = median_ms(lambda: chain(k, q, CHUNK, stats=True))
        bnd = chain_rung_bound(k, q, CHUNK)
        out["chain"][name] = {"ms": ms, "max_abs_err": max(ey, ee),
                              "psd_db": es, "bound_tc_ms": bnd,
                              "tile": k.tile}
        runs[name] = (k, got)
        print(f"  chain {name} (tile {k.tile}): vs float64 filtered "
              f"{ey:.3e} envelope {ee:.3e}; PSD {es:.3e} dB; vs plain "
              f"{rel[0]:.2e} / {rel[1]:.2e} / {rel[2]:.2e} of scale; "
              f"{ms:.4f} ms, rung bound_tc {bnd:.4f} ms "
              f"({100 * bnd / ms:.1f} %)  [{card}]")
    del plain, ref_y, ref_e
    # the light units against every unit full, at the port's default
    kh, (yl, el, sl) = runs["(H,H,H)"]
    kf = all_full(kh)
    yf, ef, sf = chain(kf, q, CHUNK)
    torch.cuda.synchronize()
    dl = (max_abs(yl, yf), max_abs(el, ef), psd_db_err(sl, sf))
    require(0 < dl[0] < TOL_LIGHT[0] and 0 < dl[1] < TOL_LIGHT[1]
            and max_abs(sl, sf) > 0 and dl[2] < TOL_LIGHT[2],
            f"light units vs all full: {dl}")
    ms = median_ms(lambda: chain(kf, q, CHUNK, stats=True))
    bnd = 1e3 * max(3 * chain_work(kf, q, CHUNK)[0] / 495e12,
                    chain_work(kf, q, CHUNK)[1] / PEAK_BYTES)
    out["chain"]["(H,H,H) all full"] = {
        "ms": ms, "max_abs_err": 0.0, "bound_tc_ms": bnd,
        "light_vs_full": list(dl)}
    print(f"  chain (H,H,H), light units ({sum(kh.light_f)} of "
          f"{len(kh.light_f)} filter, {sum(kh.light_e)} of "
          f"{len(kh.light_e)} envelope) vs every unit full: filtered "
          f"{dl[0]:.3e} envelope {dl[1]:.3e} PSD {dl[2]:.3e} dB (non-zero, "
          f"under {TOL_LIGHT}); all full {ms:.4f} ms, its 3xTF32 bound_tc "
          f"{bnd:.4f} ms (the kernel's bound_tc_ms)  [{card}]")
    del yf, ef, sf
    # the JAX default: the filter bit for bit, the split stages live
    _, (yb, eb, sb) = runs["(H,B3,B3)"]
    de = max_abs(eb, el)
    ds = psd_db_err(sb, sl)
    require(torch.equal(yb, yl), "(H,B3,B3) filtered == (H,H,H)")
    require(0 < de < TOL_ENVELOPE and ds <= TOL_PSD_DB
            and max_abs(sb, sl) > 0, f"(H,B3,B3) vs (H,H,H): {de} {ds}")
    print(f"  chain (H,B3,B3) vs (H,H,H): filtered identical, envelope "
          f"{de:.3e}, PSD {ds:.3e} dB")
    # a split-bf16 filter against the HIGHEST one
    d3 = max_abs(runs["(B3,B3,B3)"][1][0], yl)
    d4 = max_abs(runs["(B4,B3,B3)"][1][0], yl)
    require(0 < d3 < TOL_FILTERED and d4 <= d3,
            f"bf16 filters vs HIGHEST: x3 {d3} x4 {d4}")
    print(f"  chain filtered vs the HIGHEST filter: BF16X3 {d3:.3e}, "
          f"BF16X4 {d4:.3e}")
    del runs, yl, el, sl, yb, eb, sb, q
    # the boundary design: light mass just under the budget, full-scale
    # signals sign-matched to the tail, against every unit full at HIGHEST
    h_adv, g_adv = boundary_taps(bio._h_filt), boundary_taps(bio._g_env)
    ref_k = all_full(build(("highest",) * 3, h_adv, g_adv))
    sig = boundary_signal(BOUNDARY_N)
    x_adv = torch.from_numpy(np.pad(sig, [(0, 0), (ref_k.hb, ref_k.ha)])).to(
        dev)
    y0, e0, _ = chain(ref_k, x_adv, BOUNDARY_N)
    for prec in CHAIN_RUNGS[:2]:
        k = build(prec, h_adv, g_adv)
        shares = []
        for taps, D, mode, phase, flags in (
                (h_adv, len(h_adv) - 1, k.modes[0], k.phase_f, k.light_f),
                (g_adv, k.lead + k.delay, k.modes[1], k.phase_e,
                 k.light_e)):
            mass = unit_masses(taps, D, 16 if mode >= 2 else 8, phase)
            shares.append(sum(m for m, f in zip(mass, flags) if f)
                          / float(np.abs(taps).sum()))
        require(all(0.5 * LIGHT_MASS_FRAC < sh <= LIGHT_MASS_FRAC
                    for sh in shares), f"boundary light shares {shares}")
        y1, e1, _ = chain(k, x_adv, BOUNDARY_N)
        torch.cuda.synchronize()
        dy, de = max_abs(y1, y0), max_abs(e1, e0)
        require(dy < TOL_FILTERED and de < TOL_ENVELOPE,
                f"boundary design {rung_name(prec)}: {dy} {de}")
        print(f"  boundary design {rung_name(prec)} (light mass "
              f"{shares[0]:.2e} / {shares[1]:.2e} of the taps') vs every "
              f"unit full at HIGHEST: filtered {dy:.3e} envelope {de:.3e}")
    del x_adv, y0, e0, y1, e1
    # window_matmul at DEFAULT on the three bioacoustics stages
    wm = {"ms": 0.0, "ms_back_to_back": 0.0, "max_abs_err": 0.0,
          "bound_tc_ms": 0.0}
    for label in ("bioacoustics filter", "bioacoustics envelope",
                  "bioacoustics psd"):
        x, w, S, nfr, pm, lay = wm_cases[label]
        want = window_matmul_plain(x, w, S, nfr, pm, lay)
        got = window_matmul(x, w, S, nfr, pm, lay, precision="default")
        hi = window_matmul(x, w, S, nfr, pm, lay, precision="high")
        torch.cuda.synchronize()
        require(torch.equal(hi, window_matmul(x, w, S, nfr, pm, lay)),
                f"window_matmul {label}: HIGH runs HIGHEST's passes")
        scale = float(want.abs().max())
        err = max_abs(got, want)
        require(err <= TOL_DEFAULT * scale,
                f"window_matmul {label} DEFAULT {err}")
        held = BankSplit()

        def run():
            return window_matmul(x, w, S, nfr, pm, lay, split=held,
                                 precision="default")

        k_ms, kb_ms = median_ms(run), median_ms(run, calls=WM_CALLS)
        f, b = window_matmul_work(x, w, S, nfr)
        bnd = 1e3 * max(f / 495e12, b / PEAK_BYTES)
        for key, v in (("ms", k_ms), ("ms_back_to_back", kb_ms),
                       ("bound_tc_ms", bnd)):
            wm[key] += v
        wm["max_abs_err"] = max(wm["max_abs_err"], err)
        print(f"  window_matmul {label} DEFAULT: max_abs_err {err:.3e} "
              f"({err / scale:.2e} of scale {scale:.3e}); {k_ms:.4f} ms a "
              f"lone call, {kb_ms:.4f} back to back; one-pass bound_tc "
              f"{bnd:.4f} ms  [{card}]")
    out["window_matmul"]["DEFAULT"] = wm
    print(f"  window_matmul DEFAULT, three bioacoustics stages: "
          f"{wm['ms']:.4f} ms lone, {wm['ms_back_to_back']:.4f} back to "
          f"back, bound_tc {wm['bound_tc_ms']:.4f}  [{card}]")
    # envdet and EnvDet on the detect chunk: DEFAULT within 1e-2 of scale,
    # HIGHEST's light units against every unit full
    want = envdet_plain(ed, qd)
    scale = float(want.abs().max())
    ed_d = EnvDetKernel.from_kernels(ed.g_bp_np, ed.d_bp, ed.g_lp_np,
                                     ed.d_lp, ed.step, ed.nout, ed.hb,
                                     precision="default", device=dev)
    two_d = EnvDet.from_kernels(ed.g_bp_np, ed.d_bp, ed.g_lp_np, ed.d_lp,
                                ed.step, ed.nout, ed.hb, precision="default",
                                device=dev)
    ed_f = all_full(ed)
    got_h, got_f = envdet(ed, qd), envdet(ed_f, qd)
    got_d, got_2 = envdet(ed_d, qd), two_d(qd, ed.hb)
    torch.cuda.synchronize()
    eh, ef_ = max_abs(got_h, want), max_abs(got_f, want)
    ed_err, e2 = max_abs(got_d, want), max_abs(got_2, want)
    dl_env = max_abs(got_h, got_f)
    require(ed_err <= TOL_DEFAULT * scale and e2 <= TOL_DEFAULT * scale,
            f"envdet DEFAULT {ed_err}, EnvDet DEFAULT {e2}")
    require(eh <= TOL_DETECT * scale and ef_ <= TOL_DETECT * scale
            and dl_env <= TOL_DETECT * scale,
            f"envdet HIGHEST light {eh}, full {ef_}, between {dl_env}")
    for name, k, err in (("HIGHEST", ed, eh), ("HIGHEST all full", ed_f, ef_),
                         ("DEFAULT", ed_d, ed_err)):
        ms = median_ms(lambda: envdet(k, qd))
        bnd = envdet_rung_bound(k, qd)
        out["envdet"][name] = {"ms": ms, "max_abs_err": err,
                               "bound_tc_ms": bnd}
        print(f"  envdet {name} ({sum(k.light)} of {len(k.light)} band-pass "
              f"units light): vs plain {err:.3e} ({err / scale:.2e} of "
              f"scale); {ms:.4f} ms, bound_tc {bnd:.4f} ms  [{card}]")
    two_ms = median_ms(lambda: two_d(qd, ed.hb))
    print(f"  envdet light units vs every unit full: {dl_env:.3e}; EnvDet "
          f"DEFAULT vs plain {e2:.3e} ({e2 / scale:.2e} of scale), "
          f"{two_ms:.4f} ms (two window_matmul calls)  [{card}]")
    return out


# -- phases 10-11: the interactive path -----------------------------------

IA_SECONDS = 180         # the interactive recording
IA_VIEW = 2.0            # s in view
IA_PAGES = (40, 10)      # pages forward, then back
IA_JUMPS = (150.0, 10.0)
IA_CUTOFFS = (30000.0, 20000.0, 35000.0, 40000.0)   # the lowpass scrub
IA_NAMES = ("filtered", "envelope", "spectrogram")
# a delta-stitched window against a full recompute of the same window:
# the same float32 arithmetic over other sub-window edges
TOL_DELTA = 1e-6


def interactive_recording(seconds, channels, device):
    """PCM-16 ``(n, channels)`` made on the card from :data:`SEED` and
    returned on the host: noise plus a song (1.5 s of a channel's carrier,
    2-8.75 kHz, amplitude-modulated at 100 Hz) every 9 s."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    n = int(seconds * RATE)
    x = 0.02 * torch.randn((n, channels), generator=gen, device=device)
    carriers = 2000.0 + 450.0 * torch.arange(channels, device=device,
                                             dtype=torch.float64)
    for s0 in np.arange(3.0, seconds - 2.0, 9.0):
        i0, i1 = int(s0 * RATE), int((s0 + 1.5) * RATE)
        t = torch.arange(i0, i1, device=device,
                         dtype=torch.float64)[:, None] / RATE
        am = 0.5 * (1 + torch.sin(2 * math.pi * 100.0 * t))
        x[i0:i1] += (0.5 * am * torch.sin(2 * math.pi * carriers * t)).to(
            x.dtype)
    q = torch.clamp(torch.round(x * 32768.0), -32768, 32767)
    return q.to(torch.int16).cpu().numpy()


def open_interactive(path, dev):
    """``Data`` as the browser opens it: a 60 s window with 20 s kept
    behind the cursor, ``default_traces()`` with the filter set to
    2-40 kHz (the 500 Hz envelope and the NFFT 256 spectrogram as they
    come)."""
    from audian_torch.data import Data, default_traces

    d = Data(path, buffer_time=60.0, back_time=20.0, device=dev)
    for node in default_traces():
        d.add_trace(node)
    d.open()
    d["filtered"].update(highpass_cutoff=2000.0, lowpass_cutoff=40000.0)
    return d


class Refresh:
    """The browser's refresh work after a move: the min/max tiles of
    "filtered" and "envelope" and the uint8 dB tiles of the spectrogram,
    for every channel, at the colour levels of the first window's noise
    floor (``SpectrogramNode.estimate_noiselevels``' rule)."""

    def __init__(self, dev):
        from audian_torch.view.render import SpecTiler, TraceTiler

        self.traces = TraceTiler(device=dev)
        self.spec = SpecTiler(device=dev)
        self.levels = None

    def __call__(self, d, t0, t1):
        """Compute the tiles of the view [t0, t1]; returns them by
        (trace, channel)."""
        from audian_torch.view.render import noise_level_stats

        tiles = {}
        for name in ("filtered", "envelope"):
            for c in range(d.channels):
                tiles[name, c] = self.traces.tile(d[name], t0, t1, channel=c)
        spec = d["spectrogram"]
        if self.levels is None:
            nf = max(spec.buffer.shape[-1] // 16, 1)
            stats = noise_level_stats(spec.buffer, nf).cpu().numpy()
            zmin = stats[:, 0]
            zmax = zmin + 0.95 * (stats[:, 1] - zmin)
            zmax = np.maximum(zmax, zmin + 20.0)
            zmin = np.maximum(zmin, zmax - 80.0)
            self.levels = np.stack([zmin, zmax], axis=1).astype(np.float32)
        for c in range(d.channels):
            tiles["spec", c] = self.spec.tile(
                spec, c, self.levels[c, 0], self.levels[c, 1], quantize=True,
                t0=t0, t1=t1, levels=self.levels)
        return tiles


def timed_move(d, refresh, t0):
    """Host seconds of one move to [t0, t0 + IA_VIEW] and its refresh,
    ended by a synchronize."""
    torch.cuda.synchronize()
    a = time.perf_counter()
    d.update_times(t0, t0 + IA_VIEW)
    refresh(d, t0, t0 + IA_VIEW)
    torch.cuda.synchronize()
    return time.perf_counter() - a


def page_session(d, refresh):
    """Page a 2 s view forward and back from 0 s; returns the host
    seconds of each page and the number of pages that took the delta
    path with a moved raw window."""
    deltas = 0
    orig = d._try_delta_update

    def counting(dev, targets):
        nonlocal deltas
        hit = orig(dev, targets)
        deltas += bool(hit and d._last_raw_shift)
        return hit

    d._try_delta_update = counting
    fwd, back = IA_PAGES
    starts = ([IA_VIEW * k for k in range(1, fwd + 1)]
              + [IA_VIEW * (fwd - k) for k in range(1, back + 1)])
    lat = [timed_move(d, refresh, t0) for t0 in starts]
    d._try_delta_update = orig
    return lat, deltas, starts[-1]


def full_window(d, view):
    """Snapshot of the trace windows, then the same windows recomputed
    from a fresh upload without the delta path; returns both."""
    snap = {n: (d[n].offset, d[n].buffer) for n in IA_NAMES}
    t0, t1 = view
    d._dev_raw = None
    orig = d._try_delta_update
    d._try_delta_update = lambda dev, targets: False
    d.update_times(t0, t1)
    d._try_delta_update = orig
    return snap, {n: (d[n].offset, d[n].buffer) for n in IA_NAMES}


def recompute_flop(d):
    """Operations of one full recompute of the window: the filter's taps
    over its output and the warm-up, both envelope passes over the padded
    window, and the DFT products of the spectrogram's frames."""
    plan, _ = d.executor._plan(d._dev_raw_off, d._dev_raw.shape[0],
                               d.graph.active_set(IA_NAMES))
    C = d.channels
    filt, env, spec = (d[n]._node for n in IA_NAMES)
    gf, ge, gs = (plan[n] for n in IA_NAMES)
    flop = 2 * C * (gf.rel_s1 - gf.rel_s0) * filt.design.fir.length
    flop += 2 * 2 * C * ((ge.rel_s1 - ge.rel_s0) + 2 * env.design.padlen) \
        * env.design.fir.length
    nbins = spec.nfft // 2 + 1
    flop += gs.n_out * C * 2 * spec.nfft * 2 * nbins
    return flop, plan


def slice_vs_scipy(d, path, t0, t1, label, ch=0):
    """The filtered, envelope and spectrogram traces of ``d`` over
    [t0, t1] on channel ``ch`` against scipy float64 of the file's samples
    (2 s of warm-up on each side) at the nodes' current designs."""
    from audian_torch.data.wavio import read_frames_raw16, wav_info

    filt, env, spec = (d[n]._node for n in IA_NAMES)
    rate = d.rate
    i0, i1 = int(t0 * rate), int(t1 * rate)
    warm = int(2 * rate)
    s0, s1 = i0 - warm, i1 + warm
    require(s0 >= 0 and s1 <= d.frames, f"{label}: slice has its warm-up")
    x = np.empty((s1 - s0, d.channels), np.int16)
    read_frames_raw16(path, s0, s1 - s0, wav_info(path), x)
    x = x[:, ch].astype(np.float64) / 32768.0
    ys = sps.sosfilt(filt.design.sos, x)
    es = np.maximum(sps.sosfiltfilt(env.design.sos, (np.pi / 2) * np.abs(ys)),
                    0.0)
    ey = float(np.abs(d["filtered"][i0:i1, ch] - ys[warm:-warm]).max())
    ee = float(np.abs(d["envelope"][i0:i1, ch] - es[warm:-warm]).max())
    hop, nfft = spec.hop, spec.nfft
    f0, f1 = -(-i0 // hop), (i1 - nfft) // hop
    _, _, sx = sps.spectrogram(
        ys[f0 * hop - s0 : (f1 - 1) * hop + nfft - s0], fs=rate,
        window="hann", nperseg=nfft, noverlap=nfft - hop, detrend=False,
        scaling="density", mode="psd")
    got_s = torch.from_numpy(d["spectrogram"][f0:f1, ch])
    sdb = psd_db_err(got_s, torch.from_numpy(sx.T))
    require(ey <= TOL_FILTERED, f"{label} filtered vs scipy {ey}")
    require(ee <= TOL_ENVELOPE, f"{label} envelope vs scipy {ee}")
    require(sdb <= TOL_PSD_DB, f"{label} psd vs scipy {sdb} dB")
    print(f"  {label} vs scipy float64 (ch {ch}, {t0}-{t1} s, NFFT {nfft}): "
          f"filtered {ey:.3e} envelope {ee:.3e} psd {sdb:.3e} dB")


def interactive_checks(d, path, refresh, dev, view):
    """Phase 10's checks on the window left by the page session at
    ``view``: delta == full, scipy float64 on a 2 s slice of channel 0,
    exact min/max tiles, the raw window against the file, and the plan
    cache and the FIR kernel's and window_matmul's launches under a cutoff
    scrub (the spectrogram's product once a step), and one traced step's
    ``stft`` route on the spectrogram node's span and the ``taps`` on the
    FIR nodes' (each design's own decay length).  Returns the scrub's
    host seconds, its FIR launches and its STFT record (window_matmul's
    launches in the scrub, the traced step's route, launches and taps)."""
    from audian_torch.data.wavio import read_frames_raw16, wav_info
    from audian_torch.ops.cuda.fir import fir
    from audian_torch.ops.cuda.window_matmul import window_matmul
    from audian_torch.ops.design import FilterDesign
    from audian_torch.ops.minmax import reduceat_like
    from audian_torch.utils import trace
    from audian_torch.view.render import TraceTiler

    t0, t1 = view
    # the raw window equals the file's samples (the staging fence)
    off, cap = d._dev_raw_off, d._dev_raw.shape[0]
    info = wav_info(path)
    codes = np.empty((cap, d.channels), np.int16)
    require(read_frames_raw16(path, off, cap, info, codes) == cap,
            "raw window read")
    raw = d._dev_raw.cpu().numpy()
    require(np.array_equal(raw, codes.astype(np.float32) / 32768.0),
            "the raw window equals the file after the scrolls")
    print(f"  raw window [{off}, {off + cap}) equals the file's samples")
    # exact min/max tiles of the stitched window
    exact = TraceTiler(quantize=False, device=dev)
    for name in ("filtered", "envelope"):
        tr = d[name]
        for v0, v1 in ((t0, t1), (t0 - 10.0, t1 + 10.0)):
            times, vals = exact.tile(tr, v0, v1)
            step = int(round((times[1] - times[0]) * 2 * tr.rate))
            start = int(round(times[0] * tr.rate))
            n = len(vals) // 2
            a = start - tr.offset
            part = tr.buffer[a : a + n * step].cpu().numpy()
            require(np.array_equal(vals, reduceat_like(part, step)),
                    f"{name} min/max tile [{v0}, {v1}] == numpy")
    print("  min/max tiles equal numpy's reduceat of the pulled windows "
          "exactly")
    slice_vs_scipy(d, path, t0, t1, "stitched windows")
    # delta == full
    snap, full = full_window(d, view)
    for name in IA_NAMES:
        (o_s, b_s), (o_f, b_f) = snap[name], full[name]
        require(o_s == o_f and b_s.shape == b_f.shape,
                f"{name} window geometry after a full recompute")
        err = max_abs(b_s, b_f)
        require(bool(torch.isfinite(b_s).all()), f"{name} finite")
        require(err <= TOL_DELTA, f"{name} delta vs full {err}")
        print(f"  {name}: delta-stitched window == full recompute within "
              f"{err:.3e} ({tuple(b_s.shape)})")
    # the cutoff scrub adds no plan, and each of its steps runs the graph's
    # three FIR calls (the filter, the envelope's two passes) on the kernel
    size = d.executor.cache_size
    scrub = []
    fir.launches = window_matmul.launches = 0
    for cutoff in IA_CUTOFFS:
        torch.cuda.synchronize()
        a = time.perf_counter()
        d["filtered"].update(lowpass_cutoff=cutoff)
        refresh(d, t0, t1)
        torch.cuda.synchronize()
        scrub.append(time.perf_counter() - a)
    require(d.executor.cache_size == size,
            f"cutoff scrub: {size} -> {d.executor.cache_size} plans")
    require(fir.launches == 3 * len(IA_CUTOFFS),
            f"cutoff scrub: fir launched {fir.launches} times, not "
            f"{3 * len(IA_CUTOFFS)}")
    require(window_matmul.launches == len(IA_CUTOFFS),
            f"cutoff scrub: window_matmul launched {window_matmul.launches} "
            f"times, not {len(IA_CUTOFFS)} (the spectrogram once a step)")
    stft = {"scrub": window_matmul.launches}
    # one traced cutoff step: the spectrogram node's span names its route,
    # each FIR node's the taps it ran, its design's own decay length
    window_matmul.launches = 0
    trace.clear()
    trace.enable(log=False)
    try:
        d["filtered"].update(lowpass_cutoff=IA_CUTOFFS[0])
        refresh(d, t0, t1)
        torch.cuda.synchronize()
        nodes = trace.events("graph.node")
    finally:
        trace.disable()
        trace.clear()
    spans = [e for e in nodes if e["node"] == "spectrogram"]
    stft["step"] = {"stft": ",".join(e.get("stft", "") for e in spans),
                    "launches": window_matmul.launches}
    require(stft["step"] == {"stft": "kernel", "launches": 1},
            f"a traced cutoff step's spectrogram: {stft['step']}")
    taps = {e["node"]: e["taps"] for e in nodes
            if e["node"] in ("filtered", "envelope")}
    own = {name: FilterDesign.from_sos(d[name]._node.design.sos).fir.length
           for name in ("filtered", "envelope")}
    require(taps == own, f"a traced cutoff step's FIR taps {taps}, the "
            f"designs' own lengths {own}")
    stft["taps"] = taps
    print(f"  cutoff scrub {IA_CUTOFFS}: executor.cache_size stays {size}; "
          f"fir launched {fir.launches} times (3 a step), window_matmul "
          f"{stft['scrub']} (1 a step); a traced step's spectrogram span: "
          f"stft={stft['step']['stft']}, window_matmul launched "
          f"{stft['step']['launches']}; its FIR spans' taps {taps}")
    return scrub, fir.launches, stft


def node_split(d, reps=3):
    """CUDA-event ms of each node's compute in one full recompute of the
    window (the executor's loop, node by node), median of ``reps`` after a
    warm-up, and the same loop's kernels under ``torch.profiler`` by
    node."""
    from audian_torch.graph import RAW

    ex = d.executor
    dev, off = d._dev_raw, d._dev_raw_off
    plan, _ = ex._plan(off, dev.shape[0], d.graph.active_set(IA_NAMES))

    def run(events=None, label=False):
        bufs = {RAW: dev}
        for node in d.graph.order:
            name = node.name.lower()
            g = plan[name]
            src = bufs[node.source_name.lower()][g.rel_s0 : g.rel_s1]
            params = ex._params(node)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            if label:
                with torch.profiler.record_function(f"node:{name}"):
                    bufs[name] = node.compute(src, g.lead, g.n_out, params)
            else:
                bufs[name] = node.compute(src, g.lead, g.n_out, params)
            ev[1].record()
            if events is not None:
                events.setdefault(name, []).append(ev)
        return bufs

    run()
    events = {}
    for _ in range(reps):
        run(events)
    torch.cuda.synchronize()
    ms = {n: float(np.median([a.elapsed_time(b) for a, b in evs]))
          for n, evs in events.items()}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(label=True)
        torch.cuda.synchronize()
    by_node = {}
    kernels = []
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", 0.0)
        if e.key.startswith("node:"):
            by_node[e.key[5:]] = dt / 1e3
        elif device_work(e) and e.self_device_time_total > 0:
            kernels.append((e.self_device_time_total / 1e3, e.key))
    return ms, by_node, sorted(kernels, reverse=True)


def busy_share(d, refresh, starts):
    """Host seconds and device-busy seconds of the pages to ``starts``
    under ``torch.profiler``."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        a = time.perf_counter()
        for t0 in starts:
            d.update_times(t0, t0 + IA_VIEW)
            refresh(d, t0, t0 + IA_VIEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - a
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if device_work(e)) / 1e6
    return wall, busy


def page_split(d, refresh, starts):
    """Median host ms of each step of a page: the loader's move of its
    host window (``AudioLoader.update_time``), the device update (raw
    upload, slides and the delta recompute, synchronized) and the
    refresh (tiles); and of one host copy of a window-sized float32
    array, what the loader's move copies."""
    steps = {"loader": [], "device": [], "tiles": []}
    for t0 in starts:
        t1 = t0 + IA_VIEW
        torch.cuda.synchronize()
        a = time.perf_counter()
        d.data.update_time(max(t0 - d.tbefore, 0.0),
                           min(t1 + d.tafter, d.frames / d.rate))
        b = time.perf_counter()
        d.update_times(t0, t1)          # the loader's window is in place
        torch.cuda.synchronize()
        c = time.perf_counter()
        refresh(d, t0, t1)
        torch.cuda.synchronize()
        e = time.perf_counter()
        for k, v in zip(steps, (b - a, c - b, e - c)):
            steps[k].append(1e3 * v)
    buf = d.data.buffer
    spare = np.empty_like(buf)
    copies = []
    for _ in range(5):
        a = time.perf_counter()
        np.copyto(spare, buf)
        copies.append(1e3 * (time.perf_counter() - a))
    out = {k: float(np.median(v)) for k, v in steps.items()}
    out["window copy"] = float(np.median(copies))
    return out


def pcts(lat):
    lat = np.asarray(lat) * 1e3
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 95))


def interactive_phases(card, dev, tmp):
    """Phases 10 and 11: the interactive data path on the card.  The
    recording and its 8-channel copy are written to ``tmp``; returns their
    paths (phase 12 opens them again), the FIR kernel's launches in the
    cutoff scrub and a full-window recompute, and the STFT's record
    (:func:`interactive_checks`; window_matmul's launches in the
    recompute)."""
    from audian_torch.ops.cuda.fir import fir
    from audian_torch.ops.cuda.window_matmul import window_matmul
    from audian_torch.view.render import window_extrema

    print(f"phase 10: the interactive path, a {IA_SECONDS} s x {C} ch x "
          f"96 kHz PCM-16 WAV, 60 s window, 2 s view")
    t_rec = time.perf_counter()
    pcm = interactive_recording(IA_SECONDS, C, dev)
    path = os.path.join(tmp, "interactive.wav")
    scipy.io.wavfile.write(path, int(RATE), pcm)
    path8 = os.path.join(tmp, "interactive8.wav")
    scipy.io.wavfile.write(path8, int(RATE),
                           np.ascontiguousarray(pcm[:, :8]))
    del pcm
    print(f"  recordings made and written in "
          f"{time.perf_counter() - t_rec:.2f} s")
    refresh = Refresh(dev)
    torch.cuda.synchronize()
    a = time.perf_counter()
    d = open_interactive(path, dev)
    d.update_times(0.0, IA_VIEW)
    refresh(d, 0.0, IA_VIEW)
    torch.cuda.synchronize()
    open_s = time.perf_counter() - a
    lat, deltas, last = page_session(d, refresh)
    require(deltas >= 1, "a page took the delta path")
    print(f"  {len(lat)} pages, {deltas} with a moved raw window on "
          f"the delta path; executor plans {d.executor.cache_size}")
    scrub, scrub_fir, ia_stft = interactive_checks(d, path, refresh, dev,
                                                   (last, last + IA_VIEW))
    jumps = [timed_move(d, refresh, t0) for t0 in IA_JUMPS]
    for name in IA_NAMES:
        buf = d[name].buffer
        require(bool(torch.isfinite(buf).all()) and len(buf) > 0,
                f"{name} window finite after the jumps")

    # -- phase 11: times -------------------------------------------------
    print("phase 11: interactive times (host clock, each ended by a "
          "synchronize, unless marked CUDA events)")
    nfft_s = []
    for nfft in (512, 256, 512, 256):
        torch.cuda.synchronize()
        a = time.perf_counter()
        d["spectrogram"].update(nfft=nfft)
        refresh.levels = None
        refresh(d, IA_JUMPS[-1], IA_JUMPS[-1] + IA_VIEW)
        torch.cuda.synchronize()
        nfft_s.append(time.perf_counter() - a)
    # autoscale of a fresh window: the first channel pulls all
    d.update_times(40.0, 40.0 + IA_VIEW)
    torch.cuda.synchronize()
    a = time.perf_counter()
    for c in range(d.channels):
        window_extrema(d["filtered"], 40.0, 40.0 + IA_VIEW, c)
    extrema_s = time.perf_counter() - a
    # the full-window recompute and its split by node
    d.update_times(100.0, 100.0 + IA_VIEW)
    flop, plan = recompute_flop(d)
    dev_raw, off = d._dev_raw, d._dev_raw_off
    fir.launches = window_matmul.launches = 0
    d.executor.run(dev_raw, off, targets=IA_NAMES)
    torch.cuda.synchronize()
    require(fir.launches == 3, f"the full-window recompute launched fir "
            f"{fir.launches} times, not 3")
    require(window_matmul.launches == 1, f"the full-window recompute "
            f"launched window_matmul {window_matmul.launches} times, not 1")
    recompute_fir = fir.launches
    ia_stft["recompute"] = window_matmul.launches
    full_ms = median_ms(lambda: d.executor.run(dev_raw, off,
                                               targets=IA_NAMES))
    split_ms, prof_ms, kernels = node_split(d)
    # the device's busy share of 20 pages, then the steps of 10 more;
    # from 40 s each page moves the loader's window by 2 s (its 60 s
    # window ends before the file's end there)
    d.update_times(40.0, 40.0 + IA_VIEW)
    wall, busy = busy_share(d, refresh, [40.0 + IA_VIEW * k
                                         for k in range(1, 21)])
    split = page_split(d, refresh, [80.0 + IA_VIEW * k
                                    for k in range(1, 11)])
    p50, p95 = pcts(lat)
    print(f"  open + first render: {1e3 * open_s:.2f} ms  [{card}]")
    print(f"  scroll at {C} ch ({len(lat)} pages): p50 {p50:.3f} ms  "
          f"p95 {p95:.3f} ms  max {1e3 * max(lat):.3f} ms  [{card}]")
    print(f"  jumps {IA_JUMPS}: " + "  ".join(
        f"{1e3 * s:.2f} ms" for s in jumps) + f"  [{card}]")
    print(f"  cutoff scrub {IA_CUTOFFS}: " + "  ".join(
        f"{1e3 * s:.2f}" for s in scrub) + f" ms  [{card}]")
    print("  NFFT 256 -> 512 -> 256 -> 512 -> 256: " + "  ".join(
        f"{1e3 * s:.2f}" for s in nfft_s) + f" ms  [{card}]")
    print(f"  window_extrema autoscale ({d.channels} channels, one "
          f"pull): {1e3 * extrema_s:.3f} ms  [{card}]")
    win = plan["filtered"].n_out
    print(f"  full-window recompute ({win} frames x {C} ch, "
          f"{flop / 1e12:.3f} TFLOP): {full_ms:.3f} ms CUDA events, "
          f"{flop / full_ms / 1e9:.2f} TFLOP/s  [{card}]")
    print("  by node, CUDA events (ms): " + "  ".join(
        f"{n} {v:.3f}" for n, v in split_ms.items()))
    if any(prof_ms.values()):
        print("  by node under torch.profiler (device ms): " + "  ".join(
            f"{n} {v:.3f}" for n, v in prof_ms.items()))
    else:
        print("  by node under torch.profiler: not measured (no device "
              "time on the node ranges)")
    for t, key in kernels[:6]:
        print(f"    {t:10.4f}  {key[:90]}")
    if busy > 0:
        print(f"  20 pages under torch.profiler: wall {wall:.4f} s, "
              f"device busy {busy:.4f} s ({100 * busy / wall:.1f} %)  "
              f"[{card}]")
    else:
        print("  scroll device busy share: not measured (the profiler "
              "recorded no device time)")
    print("  a page, median of 10 (host ms): " + "  ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f"  [{card}]")
    d.close()
    del d
    # the same pages at 8 channels
    d8 = open_interactive(path8, dev)
    refresh8 = Refresh(dev)
    d8.update_times(0.0, IA_VIEW)
    refresh8(d8, 0.0, IA_VIEW)
    lat8, _, _ = page_session(d8, refresh8)
    d8.close()
    del d8
    p50_8, p95_8 = pcts(lat8)
    print(f"  scroll at 8 ch ({len(lat8)} pages): p50 {p50_8:.3f} ms  "
          f"p95 {p95_8:.3f} ms  max {1e3 * max(lat8):.3f} ms  [{card}]")
    return (path, path8, {"scrub": scrub_fir, "recompute": recompute_fir},
            ia_stft)

# -- phase 12: the headless browser -----------------------------------------

BR_PAGES = (40, 10)                          # page downs, then page ups
BR_JUMP = 60.0                               # s, where the parameters move
BR_SCRUB = (30000.0, 20000.0, 35000.0)       # the lowpass scrub
BR_STEPS = ((2.0, None), (None, 0.8))        # step_filter(hp, lp)
BR_ENVELOPE = 1000.0                         # Hz, the envelope step
BR_HETERODYNE = 30000.0                      # Hz
BR_SAVE = (10.0, (0, 3, 7))                  # s, channels
TOL_PLAY = 1e-5
TOL_STATS = 1e-5


def browser_refresh(b):
    """What a frontend pulls on a redraw: ``trace_tile`` of every shown
    trace and channel, ``spec_tile`` (uint8) of every channel."""
    tiles = {}
    for name in b.data.keys():
        if name != b.spectrogram and b.data.is_visible(name):
            for c in b.show_channels:
                tiles[name, c] = b.trace_tile(name, c)
    for c in range(b.data.channels):
        tiles["spec", c] = b.spec_tile(c, quantize=True)
    return tiles


class DirectRefresh:
    """The browser's refresh computed by its own tilers straight on
    ``b.data``, as phase 10's :class:`Refresh` does: called after the same
    moves, its tilers hold the same scroll caches as the browser's, so
    the tiles must be equal bit for bit (the spectrogram at the browser's
    colour levels, over the whole window as the browser asks)."""

    def __init__(self, dev):
        from audian_torch.view.render import SpecTiler, TraceTiler

        self.traces = TraceTiler(device=dev)
        self.spec = SpecTiler(device=dev)

    def __call__(self, b):
        t0, t1 = b.toffset, b.toffset + b.twindow
        tiles = {}
        for name in b.data.keys():
            if name != b.spectrogram and b.data.is_visible(name):
                for c in b.show_channels:
                    tiles[name, c] = self.traces.tile(b.data[name], t0, t1,
                                                      channel=c)
        levels = np.array([b.estimate_power_levels(c)
                           for c in range(b.data.channels)], np.float32)
        for c in range(b.data.channels):
            tiles["spec", c] = self.spec.tile(
                b.data[b.spectrogram], c, levels[c, 0], levels[c, 1],
                quantize=True, levels=levels)
        return tiles


def tiles_equal(a, b):
    if a.keys() != b.keys():
        return False
    for k in a:
        (x0, y0), (x1, y1) = a[k], b[k]
        if not (np.array_equal(x0, x1) and np.array_equal(y0, y1)):
            return False
    return True


def playback_f64(x, rate, freq, fade_time=0.1):
    """The browser's playback mix in numpy float64 on the same samples:
    the shown channels' halves averaged to two, the sine carrier, the
    20 kHz order-2 zero-phase low-pass (scipy), the decimation and the
    sine-squared fades."""
    from audian_torch.ops.design import FilterDesign, design_filter

    x = np.asarray(x, np.float64)
    n2 = (x.shape[1] + 1) // 2
    play = np.stack([x[:, :n2].mean(axis=1), x[:, n2:].mean(axis=1)],
                    axis=1)
    cyc = np.arange(len(play), dtype=np.float64) * (freq / rate)
    play *= np.sin(2.0 * np.pi * np.mod(cyc, 1.0))[:, None]
    sos = design_filter(rate, lowpass_cutoff=20000.0, order=2)
    if sos is not None:
        play = sps.sosfiltfilt(sos, play, axis=0,
                               padlen=FilterDesign.from_sos(sos).padlen)
    nstep = max(1, int(np.round(rate / 40000.0)))
    play = play[::nstep]
    nf = min(int(round(fade_time * rate / nstep)), len(play) // 2)
    ramp = np.sin(0.5 * np.pi * np.arange(nf) / nf) ** 2
    play[:nf] *= ramp[:, None]
    play[len(play) - nf :] *= ramp[::-1][:, None]
    return play, rate / nstep


def browser_phase(card, dev, tmp, path, path8):
    """Phase 12: the headless browser and shell on phase 10's recording
    and its 8-channel copy."""
    from audian_torch.analysis import Plugins
    from audian_torch.app import DataBrowser, audian_cli
    from audian_torch.cache import FullTraceData
    from audian_torch.cache.fulltrace import _interleaved_minmax
    from audian_torch.data import AudioLoader, default_traces
    from audian_torch.data.wavio import read_frames_raw16, scan_wav, wav_info

    print(f"phase 12: the headless browser, audian_cli on the {C} ch and "
          f"8 ch recordings, default_traces(), -f 2000 -l 40000")
    t_phase = time.perf_counter()
    # the overview cache of this run lives and dies in the temp directory
    cache_env = os.environ.get("XDG_CACHE_HOME")
    os.environ["XDG_CACHE_HOME"] = os.path.join(tmp, "cache")
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        DataBrowser(path)
        raise AssertionError("a browser without a card did not raise")
    except RuntimeError:
        pass
    finally:
        torch.cuda.is_available = real
    plugins = Plugins()
    plugins.clear_trace_factories()
    plugins.add_trace_factory(
        lambda b: [b.add_trace(n) for n in default_traces()])
    moves = {}
    direct = {}
    compared = [0]

    def same_as_direct(b, tiles):
        """The browser adds no arithmetic: its tiles are the direct
        refresh's, bit for bit."""
        want = direct.setdefault(id(b), DirectRefresh(dev))(b)
        require(tiles_equal(tiles, want),
                f"{b.data.channels} ch browser tiles == direct refresh")
        compared[0] += 1

    def timed(label, fn, browsers):
        torch.cuda.synchronize()
        a = time.perf_counter()
        fn()
        tiles = [browser_refresh(b) for b in browsers]
        torch.cuda.synchronize()
        moves.setdefault(label, []).append(time.perf_counter() - a)
        for b, t in zip(browsers, tiles):
            same_as_direct(b, t)

    torch.cuda.synchronize()
    a = time.perf_counter()
    shell = audian_cli([path, path8, "-f", "2000", "-l", "40000"],
                       plugins=plugins)
    shell.load_files()
    b0, b1 = shell.browsers
    tiles = [browser_refresh(b) for b in (b0, b1)]
    torch.cuda.synchronize()
    moves["open + first refresh (both)"] = [time.perf_counter() - a]
    for b, t in zip((b0, b1), tiles):
        same_as_direct(b, t)
    require(not shell.errors and len(shell) == 2, f"shell {shell.errors}")
    require((b0.data.channels, b1.data.channels) == (C, 8), "channels")
    for b in (b0, b1):
        require(b.device.type == dev.type, f"browser on {b.device}")
        require(b.data.keys() == ["data", "filtered", "envelope",
                                  "spectrogram"], f"traces {b.data.keys()}")
        for name in b.data.keys():
            buf = b.data[name].buffer
            require(isinstance(buf, torch.Tensor) and buf.device == dev,
                    f"{name} window on the card")
        f = b.data["filtered"]
        require((f.highpass_cutoff, f.lowpass_cutoff) == (2000.0, 40000.0),
                "the filter of -f/-l")
    fwd, back = BR_PAGES
    for _ in range(fwd):
        timed("page", b0.time_page_down, [b0])
    for _ in range(back):
        timed("page", b0.time_page_up, [b0])
    timed("time_end", b0.time_end, [b0])
    timed("time_home", b0.time_home, [b0])
    timed("jump", lambda: b0.set_times(BR_JUMP), [b0])
    for cutoff in BR_SCRUB:
        timed("update_filter (both)",
              lambda: b0.update_filter(lowpass_cutoff=cutoff), [b0, b1])
    require(b1.data["filtered"].lowpass_cutoff == BR_SCRUB[-1],
            "the filter is linked")
    for hp, lp in BR_STEPS:
        timed("step_filter (both)", lambda: b0.step_filter(hp, lp),
              [b0, b1])
    timed("freq_resolution_up", b0.freq_resolution_up, [b0])
    require(b0.data["spectrogram"].nfft == 512, "NFFT 512")
    timed("freq_resolution_down", b0.freq_resolution_down, [b0])
    require(b0.data["spectrogram"].nfft == 256, "NFFT 256")
    timed("update_envelope (both)",
          lambda: b0.update_envelope(BR_ENVELOPE), [b0, b1])
    require(b1.data["envelope"].envelope_cutoff == BR_ENVELOPE,
            "the envelope is linked")
    shell.link_timescroll = True
    timed("linked page (both)", b0.time_page_down, [b0, b1])
    require(b1.toffset == b0.toffset == BR_JUMP + 0.5 * b0.twindow,
            f"linked page: {b0.toffset} and {b1.toffset}")
    print(f"  every move's tiles ({compared[0]} refreshes, both browsers) "
          f"equal a direct refresh of their Data exactly")
    t0, t1 = b0.toffset, b0.toffset + b0.twindow
    slice_vs_scipy(b0.data, path, t0, t1, "browser after scrub/NFFT steps",
                   ch=5)
    # playback: 2 s, heterodyne at 30 kHz, every channel shown
    b0.set_audio(use_heterodyne=True, heterodyne_freq=BR_HETERODYNE)
    torch.cuda.synchronize()
    a = time.perf_counter()
    play, prate = b0.play_region(t0, t1)
    play_s = time.perf_counter() - a
    rate = b0.data.rate
    i0, i1 = int(np.round(t0 * rate)), int(np.round(t1 * rate))
    want, wrate = playback_f64(b0.data["filtered"][i0:i1], rate,
                               BR_HETERODYNE)
    require(isinstance(play, np.ndarray) and play.shape == want.shape
            and prate == wrate, f"playback {play.shape} @ {prate}")
    play_err = float(np.abs(play - want).max())
    require(play_err <= TOL_PLAY, f"playback vs float64 {play_err}")
    # statistics of a region
    a = time.perf_counter()
    traces = b0.analyze_region(t0, t1, 5)
    analyze_s = time.perf_counter() - a
    row = b0.get_analysis_table()[-1]
    # the band-passed region's mean nearly cancels, so its error is taken
    # relative to the region's scale (its standard deviation)
    x = np.asarray(traces["filtered"][1], np.float64)
    stats_err = max(abs(row["filtered mean/a.u."] - x.mean()) / x.std(),
                    abs(row["filtered stdev/a.u."] / x.std() - 1.0))
    require(stats_err <= TOL_STATS, f"statistics vs float64 {stats_err}")
    print(f"  play_region {t1 - t0:.0f} s, heterodyne {BR_HETERODYNE:.0f} "
          f"Hz: {play.shape} @ {prate:.0f} Hz, vs float64 {play_err:.3e}; "
          f"statistics row vs float64 {stats_err:.3e} relative (the mean's "
          f"to the std)")
    # the region export: 10 s at three channels with a marker inside
    seconds, chans = BR_SAVE
    b0.select_channels(list(chans))
    require(b0.selected_channels == list(chans), "selected channels")
    b0.set_crosshair(chans[0], t=t0 + 3.0)
    b0.store_marker("song", "inside")
    a = time.perf_counter()
    out = b0.save_region(t0, t0 + seconds, os.path.join(tmp, "cut.wav"))
    save_s = time.perf_counter() - a
    info = wav_info(out)
    s0 = int(np.round(t0 * rate))
    got = np.empty((info[2], len(chans)), np.int16)
    read_frames_raw16(out, 0, info[2], info, got)
    src = np.empty((info[2], C), np.int16)
    read_frames_raw16(path, s0, info[2], wav_info(path), src)
    require(info[2] == int(seconds * rate) and info[3] == "PCM_16",
            f"saved {info}")
    require(np.array_equal(got, src[:, list(chans)]),
            "saved region == the source's int16 codes")
    _, md, locs, labels = scan_wav(out)
    mark = int(np.round((t0 + 3.0) * rate)) - s0
    require(locs.tolist() == [[mark, 0]]
            and labels.tolist() == [["song", "inside"]],
            f"saved marker {locs.tolist()} {labels.tolist()}")
    history = md.get("BEXT", {}).get("CodingHistory", "")
    require("cut out" in history and "cut.wav" in history,
            f"CodingHistory {history!r}")
    print(f"  save_region {seconds:.0f} s x channels {list(chans)}: int16 "
          f"codes == source, marker at {mark} frames, CodingHistory "
          f"{history.splitlines()[-1]!r}")
    # the overview
    ft = b0.fulltrace
    a = time.perf_counter()
    ft.wait()
    wait_s = time.perf_counter() - a
    require(ft.error is None and not ft.short_data, f"overview {ft.error}")
    codes = np.empty((b0.data.frames, C), np.int16)
    read_frames_raw16(path, 0, b0.data.frames, wav_info(path), codes)
    want = _interleaved_minmax(codes, ft.step) / 32768.0
    require(np.array_equal(ft.datas, want), "overview == numpy")
    del codes, want
    ld = AudioLoader(path, prefetch=False)
    again = FullTraceData(ld, device=dev)
    a = time.perf_counter()
    again.start(6000, background=False)
    overview_s = time.perf_counter() - a
    require(np.array_equal(again.datas, ft.datas), "overview rerun")
    ld.close()
    print(f"  overview ({len(ft.datas)} x {C}, step {ft.step}) == numpy's "
          f"interleaved min/max of the file; wait() {wait_s:.3f} s")
    shell.close()
    if cache_env is None:
        os.environ.pop("XDG_CACHE_HOME", None)
    else:
        os.environ["XDG_CACHE_HOME"] = cache_env
    print(f"  times (host clock, each move ended by a synchronize and "
          f"followed by its browsers' refresh)  [{card}]")
    for label, ts in moves.items():
        ms = 1e3 * np.asarray(ts)
        if len(ms) > 2:
            print(f"    {label} x{len(ms)}: p50 {np.percentile(ms, 50):.3f} "
                  f"ms  p95 {np.percentile(ms, 95):.3f} ms  max "
                  f"{ms.max():.3f} ms  [{card}]")
        else:
            print(f"    {label}: " + "  ".join(f"{v:.3f}" for v in ms)
                  + f" ms  [{card}]")
    print(f"    play_region {1e3 * play_s:.3f} ms  analyze_region "
          f"{1e3 * analyze_s:.3f} ms  save_region {1e3 * save_s:.3f} ms  "
          f"overview of {IA_SECONDS} s x {C} ch (native scan) "
          f"{overview_s:.3f} s  [{card}]")
    print(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")


# -- phase 13: recordings in FLAC -------------------------------------------

#: FLAC stores at most 8 channels (STREAMINFO's channel count has 3 bits),
#: so the FLAC phase takes the first 8 channels of each recording
FL_C = 8
FL_PREFIX = 30           # s, the 24-bit FLAC
FL_SAVE = (10.0, (0, 3, 7))   # s, channels of the FLAC region export


def flac_md5(codes):
    """The MD5 STREAMINFO carries for 16-bit codes: of the interleaved
    little-endian samples."""
    import hashlib

    return hashlib.md5(np.ascontiguousarray(codes, "<i2").tobytes()).digest()


def read_codes(path):
    """Every frame of a 16-bit recording as int16 codes."""
    from audian_torch.data.wavio import read_frames_raw16, wav_info

    info = wav_info(path)
    out = np.empty((info[2], info[1]), np.int16)
    require(read_frames_raw16(path, 0, info[2], info, out) == info[2],
            f"read {path}")
    return out


def disk_chain(bio, path, dev):
    """Phase 4's disk -> chain run over a whole recording: halo'd
    FILE_CHUNK-frame chunks read by ``AudioLoader.read_raw16_into`` into
    two pinned int16 buffers (each reused only after its upload's event),
    each chunk through ``chain_cf`` with stats.  Returns the outputs on the
    card, the wall seconds and the host seconds spent reading."""
    from audian_torch.data import AudioLoader

    ck = bio.chain_kernel
    hb, ha = ck.hb, ck.ha
    span = hb + FILE_CHUNK + ha
    ld = AudioLoader(path, prefetch=False)
    require(ld.raw16_capable, f"{path} serves int16 reads")
    nfile, ch = ld.frames, ld.channels
    pinned = [torch.empty((span, ch), dtype=torch.int16).pin_memory()
              for _ in range(2)]
    uploaded = [None, None]
    outs = []
    read_s = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(-(-nfile // FILE_CHUNK)):
        buf = pinned[k % 2]
        if uploaded[k % 2] is not None:
            uploaded[k % 2].synchronize()
        start = k * FILE_CHUNK - hb
        host = buf.numpy()
        lo = max(start, 0)
        a = time.perf_counter()
        host[: lo - start] = 0
        got = ld.read_raw16_into(lo, span - (lo - start), host[lo - start:])
        host[lo - start + len(got):] = 0
        read_s += time.perf_counter() - a
        dev_raw = buf.to(dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        uploaded[k % 2] = ev
        n = min(FILE_CHUNK, nfile - k * FILE_CHUNK)
        outs.append(bio.chain_cf(dev_raw.T.contiguous(), n, stats=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ld.close()
    return outs, wall, read_s


def flac_phase(card, dev, tmp, path8, det_codes, bio):
    """Phase 13: recordings in FLAC on the card's paths.  ``path8`` is
    phase 10's 8-channel copy of its recording, ``det_codes`` the first 8
    channels of phase 8's song recording, ``bio`` phase 4's bioacoustics
    chain.  Returns the chain and envdet launches of the FLAC runs."""
    import concurrent.futures

    from audian_torch import native
    from audian_torch.analysis import events
    from audian_torch.app import audian_cli
    from audian_torch.cache import FullTraceData
    from audian_torch.cache.fulltrace import _interleaved_minmax
    from audian_torch.cli import compress, songdetector
    from audian_torch.data import AudioLoader, flac
    from audian_torch.data.wavio import (load_audio, read_frames_raw16,
                                         wav_info)
    from audian_torch.ops.cuda.chain import chain
    from audian_torch.ops.cuda.envdet import envdet

    print(f"phase 13: recordings in FLAC ({FL_C} ch: FLAC holds at most 8), "
          f"{IA_SECONDS} s and {DETECT_SECONDS} s x 96 kHz")
    t_phase = time.perf_counter()
    require(native.available() and native.get_lib() is not None,
            "the native host library is loaded (no numpy fallback here)")
    print(f"  native host library {native.build_dir()} (built in phase 1)")

    # -- the encodes, in parallel (the encoder releases the GIL) ----------
    ia = read_codes(path8)
    files = {"ia16": (os.path.join(tmp, "interactive8-16.flac"), ia, 16),
             "det16": (os.path.join(tmp, "songs8.flac"), det_codes, 16),
             "ia24": (os.path.join(tmp, "interactive8-24.flac"),
                      ia[: int(FL_PREFIX * RATE)].astype(np.int32) << 8, 24)}

    def encode(item):
        fpath, codes, bits = item
        a = time.perf_counter()
        flac.write_flac(fpath, codes, RATE, bits=bits)
        return time.perf_counter() - a

    a = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(files)) as pool:
        enc_s = dict(zip(files, pool.map(encode, files.values())))
    enc_wall = time.perf_counter() - a
    for key, (fpath, codes, bits) in files.items():
        raw = open(fpath, "rb").read(8 + 34)
        ratio = codes.shape[0] * codes.shape[1] * bits / 8 / os.path.getsize(
            fpath)
        info = wav_info(fpath)
        require(info == (RATE, FL_C, len(codes), f"FLAC_{bits}", None),
                f"{key} info {info}")
        if bits == 16:
            require(raw[8 + 18 : 8 + 34] == flac_md5(codes),
                    f"{key} STREAMINFO MD5")
            flac._OPEN.clear()
            a = time.perf_counter()
            back = read_codes(fpath)
            dec_s = time.perf_counter() - a
            require(np.array_equal(back, codes), f"{key} decodes exactly")
            del back
            print(f"  {key}: {codes.shape[0] / RATE:.0f} s x {FL_C} ch, "
                  f"encode {enc_s[key]:.3f} s, whole decode {dec_s:.3f} s "
                  f"({codes.size / dec_s / 1e6:.1f} M samples/s), ratio "
                  f"{ratio:.4f}, decode == codes, MD5 ok")
        else:
            ld = AudioLoader(fpath, prefetch=False)
            require(not ld.raw16_capable, "a 24-bit FLAC reads as float32")
            got = ld[0 : ld.frames]
            ld.close()
            require(got.dtype == np.float32 and np.array_equal(
                got, (codes >> 8) / np.float32(32768.0)),
                f"{key}: float32 reads == codes / 2^23")
            print(f"  {key}: {codes.shape[0] / RATE:.0f} s x {FL_C} ch, "
                  f"encode {enc_s[key]:.3f} s, ratio {ratio:.4f}; the "
                  f"loader's float32 reads == codes / 2^23")
    print(f"  the three encodes in parallel took {enc_wall:.3f} s  [{card}]")
    fl16, fdet = files["ia16"][0], files["det16"][0]

    # -- Data: the 50-page session on the FLAC against the WAV ------------
    sessions = {}
    for label, p in (("wav", path8), ("flac", fl16)):
        refresh = Refresh(dev)
        torch.cuda.synchronize()
        a = time.perf_counter()
        d = open_interactive(p, dev)
        d.update_times(0.0, IA_VIEW)
        refresh(d, 0.0, IA_VIEW)
        torch.cuda.synchronize()
        sessions[label] = [d, refresh, time.perf_counter() - a, [], None]
    dw, df = sessions["wav"][0], sessions["flac"][0]
    require(df.data.raw16_capable and df.data.encoding == "FLAC_16",
            "the FLAC session takes the int16 upload")
    fwd, back = IA_PAGES
    starts = ([IA_VIEW * k for k in range(1, fwd + 1)]
              + [IA_VIEW * (fwd - k) for k in range(1, back + 1)])
    for t0 in starts:
        for label, sess in sessions.items():
            d, refresh = sess[0], sess[1]
            torch.cuda.synchronize()
            a = time.perf_counter()
            d.update_times(t0, t0 + IA_VIEW)
            sess[4] = refresh(d, t0, t0 + IA_VIEW)
            torch.cuda.synchronize()
            sess[3].append(time.perf_counter() - a)
        require(torch.equal(dw["data"].buffer, df["data"].buffer),
                f"raw window at {t0} s == the WAV session's")
        for name in IA_NAMES:
            require(dw[name].offset == df[name].offset and torch.equal(
                dw[name].buffer, df[name].buffer),
                f"{name} window at {t0} s == the WAV session's")
        require(tiles_equal(sessions["wav"][4], sessions["flac"][4]),
                f"tiles at {t0} s == the WAV session's")
    for label, (d, _, open_s, lat, _) in sessions.items():
        ms = 1e3 * np.asarray(lat)
        print(f"  {label} session ({FL_C} ch): open + first render "
              f"{1e3 * open_s:.3f} ms, {len(lat)} pages p50 "
              f"{np.percentile(ms, 50):.3f} ms p95 {np.percentile(ms, 95):.3f}"
              f" ms  [{card}]")
        d.close()
    print(f"  every raw window, trace window and tile of the {len(starts)} "
          f"pages == the WAV session's, bit for bit")
    del sessions, dw, df

    # -- the song detector on a FLAC --------------------------------------
    csv = {}
    walls = {}
    det_launches = None
    for label, p in (("wav", os.path.join(tmp, "songs8.wav")), ("flac", fdet)):
        if label == "wav":
            scipy.io.wavfile.write(p, int(RATE), det_codes)
        out_csv = os.path.join(tmp, f"songs8-{label}.csv")
        chain.launches = envdet.launches = 0
        a = time.perf_counter()
        rc = songdetector.main([p, "-o", out_csv])
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - a
        if label == "flac":
            det_launches = envdet.launches
        require(rc == 0, f"songdetector on the {label}: {rc}")
        with open(out_csv) as f:
            csv[label] = f.read()
    require(csv["flac"] == csv["wav"], "the FLAC CSV == the WAV CSV")
    rows = [r.split(",") for r in csv["flac"].strip().splitlines()[1:]]
    require(len(rows) == FL_C * len(SONG_STARTS),
            f"{len(rows)} songs, planted {FL_C * len(SONG_STARTS)}")
    require(det_launches > 0, "envdet launched on the FLAC run")
    t0 = time.perf_counter()
    data, _ = songdetector.load_recording(fdet)
    t1 = time.perf_counter()
    require(data.dtype == np.int16, "a 16-bit FLAC reaches detect as int16")
    events.band_env(data, RATE, *DETECT_BAND, DETECT_ENV,
                    return_filtered=False, fused=True, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    events.detect(data, RATE, *DETECT_BAND, DETECT_ENV, return_filtered=False,
                  device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del data
    print(f"  audian-songdetector on the {DETECT_SECONDS} s FLAC: CSV == the "
          f"WAV run's ({len(rows)} songs), envdet launches {det_launches}; "
          f"wall {walls['flac']:.3f} s (WAV {walls['wav']:.3f} s)  [{card}]")
    print(f"  wall split (host clock, s): read (FLAC decode) {t1 - t0:.4f}  "
          f"band_env {t2 - t1:.4f}  events {(t3 - t2) - (t2 - t1):.4f}")

    # -- disk -> chain over the FLAC --------------------------------------
    chain.launches = 0
    fl_out, fl_wall, fl_read = disk_chain(bio, fl16, dev)
    chain_launches = chain.launches
    require(chain_launches > 0, "chain launched on the FLAC run")
    wv_out, wv_wall, wv_read = disk_chain(bio, path8, dev)
    for k, (a, b) in enumerate(zip(fl_out, wv_out)):
        require(all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
                and all(torch.equal(a[3][key], b[3][key]) for key in a[3]),
                f"chunk {k}: FLAC outputs == WAV outputs")
    hours = IA_SECONDS / 3600.0
    print(f"  disk -> chain_cf over {len(fl_out)} chunks: outputs == the "
          f"WAV run's bit for bit; chain launches {chain_launches}")
    print(f"    FLAC {fl_wall / hours:.4f} s per recording hour, host decode "
          f"{100 * fl_read / fl_wall:.1f} % of it; WAV {wv_wall / hours:.4f} "
          f"s, host read {100 * wv_read / wv_wall:.1f} %  [{card}]")
    del fl_out, wv_out

    # -- audian-compress --------------------------------------------------
    codes = read_codes(path8)
    comp = {}
    for label, p in (("wav", path8), ("flac", fl16)):
        a = time.perf_counter()
        require(compress.main([p]) == 0, f"audian-compress on the {label}")
        comp[label] = time.perf_counter() - a
        art = os.path.splitext(p)[0] + "-fulltrace.wav"
        got, _ = load_audio(art)
        step = len(codes) // 6000
        require(np.array_equal(got, _interleaved_minmax(codes, step)
                               / 32768.0),
                f"the {label} fulltrace == numpy's min/max of the file")
    get_lib = native.get_lib
    native.get_lib = lambda: None
    try:
        ld = AudioLoader(path8, prefetch=False)
        ft = FullTraceData(ld, device=dev)
        a = time.perf_counter()
        ft.start(6000, background=False)
        numpy_s = time.perf_counter() - a
        ld.close()
    finally:
        native.get_lib = get_lib
    require(np.array_equal(ft.datas, _interleaved_minmax(codes, ft.step)
                           / 32768.0), "the numpy scan == numpy")
    print(f"  audian-compress: -fulltrace.wav == numpy's interleaved min/max "
          f"for both; WAV (native scan) {comp['wav']:.3f} s, FLAC (decode + "
          f"numpy scan) {comp['flac']:.3f} s, the WAV's numpy scan "
          f"{numpy_s:.3f} s  [{card}]")

    # -- the FLAC region export from the shell ----------------------------
    cache_env = os.environ.get("XDG_CACHE_HOME")
    os.environ["XDG_CACHE_HOME"] = os.path.join(tmp, "cache")
    try:
        shell = audian_cli([fl16, "-f", "2000", "-l", "40000"])
        shell.load_files()
        require(not shell.errors and len(shell) == 1,
                f"shell {shell.errors}")
        b = shell.browsers[0]
        seconds, chans = FL_SAVE
        b.select_channels(list(chans))
        t0 = min(20.0, IA_SECONDS - seconds - 1.0)
        a = time.perf_counter()
        out = b.save_region(t0, t0 + seconds, os.path.join(tmp, "cut.flac"))
        save_s = time.perf_counter() - a
        info = wav_info(out)
        require(info[2] == int(seconds * RATE) and info[3] == "FLAC_16",
                f"saved {info}")
        got = np.empty((info[2], len(chans)), np.int16)
        read_frames_raw16(out, 0, info[2], info, got)
        s0 = int(round(t0 * RATE))
        require(np.array_equal(got, codes[s0 : s0 + info[2], list(chans)]),
                "the FLAC region == the source's codes")
        shell.close()
    finally:
        if cache_env is None:
            os.environ.pop("XDG_CACHE_HOME", None)
        else:
            os.environ["XDG_CACHE_HOME"] = cache_env
    print(f"  save_region {seconds:.0f} s x channels {list(chans)} to .flac "
          f"from the shell on the FLAC: codes == source; "
          f"{1e3 * save_s:.3f} ms  [{card}]")
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return {"chain": chain_launches, "envdet": det_launches}


# -- phase 14: the frontends ----------------------------------------------

FE_PAGES = (40, 10)      # page downs, then page ups, through the Qt actions
FE_POWER_PAGES = 10      # pages with the power side panel on (off by default)
FE_DRAG_LP = 30000.0     # Hz, where the lowpass handle is dragged
FE_ZOOM = (0.5, 1.5)     # s into the view, the rect zoom
#: the envelope of phase 12's default_traces(), as a user's plugin file in
#: the working directory: audian's own default factory adds the filter
#: and the spectrogram
FE_PLUGIN = """from audian_torch.graph import EnvelopeNode


def audian_traces(browser):
    browser.add_trace(EnvelopeNode("envelope", "filtered"))
"""


class Handed:
    """Records what the Qt adapter hands to the fake toolkit: each
    ``setData`` / ``setImage`` keeps its arrays on the item (``handed``),
    and a torch tensor there fails the run (it would pass the fake and
    break real pyqtgraph)."""

    def __init__(self, fakeqt):
        self.calls = 0
        self.saved = [(cls, name, getattr(cls, name)) for cls, name in (
            (fakeqt.FakeCurve, "setData"),
            (fakeqt.ScatterPlotItem, "setData"),
            (fakeqt.FakeImageItem, "setImage"))]
        for cls, name, orig in self.saved:
            setattr(cls, name, self._wrap(orig))

    def _wrap(self, orig):
        def handed(item, *args, **kw):
            for a in args:
                require(not isinstance(a, torch.Tensor) and not (
                    isinstance(a, (list, tuple))
                    and any(isinstance(v, torch.Tensor) for v in a)),
                    "host data handed to the toolkit")
            self.calls += 1
            item.handed = args
            return orig(item, *args, **kw)
        return handed

    def restore(self):
        for cls, name, orig in self.saved:
            setattr(cls, name, orig)


def trigger(win, shortcut):
    """Fire the enabled window action bound to ``shortcut``, as the key
    would (the fake toolkit's menus)."""
    for menu in win.menuBar().menus:
        for act in menu.actions:
            if act.isEnabled() and shortcut in win._keys(act):
                act.trigger()
                return
    raise RuntimeError(f"no action with shortcut {shortcut!r}")


def adapter_equals_direct(win, direct, dev):
    """The arrays every tab of ``win`` handed to the toolkit on its last
    refresh equal a direct refresh of its browser bit for bit: the trace
    and envelope curves of every shown channel, the u8 spectrogram images
    and their rects; the power side plots, where shown, equal the
    browser's ``power_spectrum``.  Returns the number of arrays
    compared."""
    n = 0
    for i in range(win.tabs.count()):
        tab = win.tabs.widget(i)
        b = tab.browser
        want = direct.setdefault(id(b), DirectRefresh(dev))(b)
        for c, (pt, curve) in tab.trace_plots.items():
            if not pt.isVisible():
                continue
            pairs = [(curve, "filtered")]
            if b.data.is_visible("envelope"):
                pairs.append((tab.env_curves[c], "envelope"))
            for item, name in pairs:
                x, y = item.handed
                wx, wy = want[name, c]
                require(np.array_equal(x, wx) and np.array_equal(y, wy),
                        f"tab {i} {name} {c}: handed == direct refresh")
                n += 1
        for c, (ps, img) in tab.spec_images.items():
            if not ps.isVisible():
                continue
            tile, rect = want["spec", c]
            r = img.rect
            require(np.array_equal(img.handed[0], tile)
                    and (r.x, r.y, r.w, r.h) == tuple(rect),
                    f"tab {i} spectrogram {c}: handed == direct refresh")
            n += 1
            pp, pcurve = tab.power_plots[c]
            if pp.isVisible():
                freqs, db = b.power_spectrum(c)
                finite = np.isfinite(db)
                x, y = pcurve.handed
                require(np.array_equal(x, db[finite])
                        and np.array_equal(y, freqs[finite]),
                        f"tab {i} power {c}: handed == power_spectrum")
                n += 1
    return n


def frontend_phase(card, dev, tmp, path, path8, song):
    """Phase 14: the frontends on the card.  The Qt adapter runs on the
    fake toolkit of ``tests/fakeqt.py`` (this machine has neither Qt nor,
    perhaps, matplotlib).  ``song`` is phase 8's recording (int16 codes)
    and its CSV rows, for the song viewer's envelope keys and the
    matplotlib paths.  Returns envdet's launches on the viewer's keys."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import fakeqt

    from audian_torch.analysis import Plugins
    from audian_torch.app import audian_cli, parse_view_metadata
    from audian_torch.cli import audian
    from audian_torch.data import default_traces

    print(f"phase 14: the frontends, the Qt adapter on the fake toolkit "
          f"over phase 12's recordings ({C} ch and 8 ch)")
    t_phase = time.perf_counter()
    cwd = os.getcwd()
    work = os.path.join(tmp, "frontends")
    os.makedirs(work)
    with open(os.path.join(work, "audian_envelope.py"), "w") as f:
        f.write(FE_PLUGIN)
    fakeqt.install()
    handed = Handed(fakeqt)
    import audian_torch.gui.qt as qt_gui
    try:
        qt_gui = importlib.reload(qt_gui)
        require(qt_gui.HAVE_QT, "the Qt adapter on the fake toolkit")
        direct = {}
        built = []
        Window = qt_gui.AudianWindow

        class Recorded(Window):
            """The window ``main`` builds, checked as it comes up: the
            first recording only, on the card, its refresh == direct."""

            def __init__(self, shell):
                super().__init__(shell)
                torch.cuda.synchronize()
                b = shell.current
                built.append({
                    "s": time.perf_counter(), "tabs": self.tabs.count(),
                    "device": b.device, "traces": b.data.keys(),
                    "view": (b.toffset, b.twindow, list(b.show_channels)),
                    "arrays": adapter_equals_direct(self, {}, dev)})

        qt_gui.AudianWindow = Recorded
        os.chdir(work)
        try:
            # -- the entry point, as a user types it ------------------------
            torch.cuda.synchronize()
            a = time.perf_counter()
            rc = audian.main([path, path8, "-f", "2000", "-l", "40000"])
            main_s = time.perf_counter() - a
            fakeqt.QTimer.single_shots = []   # the closed window's pump
            require(rc == 0, f"audian exit status {rc}")
            require(len(built) == 1, f"{len(built)} windows built")
            first = built[0]
            require(first["tabs"] == 1, "main opens only the first "
                    "recording before the window shows")
            require(first["device"].type == dev.type,
                    f"browser on {first['device']}")
            require(first["traces"] == ["data", "filtered", "spectrogram",
                                        "envelope"],
                    f"traces with the plugin file {first['traces']}")
            open_s = first["s"] - a
            print(f"  audian.main([{C} ch, 8 ch, -f 2000, -l 40000]) rc 0: "
                  f"the window over the first recording on {dev}, the "
                  f"envelope from a plugin file, {first['arrays']} arrays "
                  f"handed == direct refresh; open to first window "
                  f"{1e3 * open_s:.3f} ms, main {1e3 * main_s:.3f} ms  "
                  f"[{card}]")

            # -- a window over an audian_cli shell of both recordings -----
            plugins = Plugins()
            plugins.clear_trace_factories()
            plugins.add_trace_factory(
                lambda b: [b.add_trace(n) for n in default_traces()])
            torch.cuda.synchronize()
            a = time.perf_counter()
            shell = audian_cli([path, path8, "-f", "2000", "-l", "40000"],
                               plugins=plugins)
            shell.load_files()
            win = Window(shell)
            torch.cuda.synchronize()
            window_s = time.perf_counter() - a
            require(win.tabs.count() == 2 and not shell.errors,
                    f"two tabs {win.tabs.count()} {shell.errors}")
            b0, b1 = shell.browsers
            tab0 = win.tabs.widget(0)
            compared = [adapter_equals_direct(win, direct, dev)]
            moves = {}
            power = []
            refreshes = []

            # the tab's refreshes and its power side panel, timed inside
            # a move (the tab calls both through its instance)
            def timed_power(*args, orig=tab0._refresh_power):
                t = time.perf_counter()
                orig(*args)
                power.append(time.perf_counter() - t)

            def timed_refresh(orig=tab0.refresh):
                t = time.perf_counter()
                orig()
                torch.cuda.synchronize()
                refreshes.append(time.perf_counter() - t)
            tab0._refresh_power = timed_power
            tab0.refresh = timed_refresh

            def move(label, fn):
                power.clear()
                refreshes.clear()
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                moves.setdefault(label, []).append(
                    (dt, sum(power), list(refreshes)))
                compared[0] += adapter_equals_direct(win, direct, dev)

            fwd, back = FE_PAGES
            for _ in range(fwd):
                move("page", lambda: trigger(win, "PgDown"))
            for _ in range(back):
                move("page", lambda: trigger(win, "PgUp"))
            # the power side panel is off by default: pages with it on
            move("power panel on", lambda: trigger(win, "Ctrl+P"))
            require(tab0.power_plots[b0.show_channels[0]][0].isVisible(),
                    "the power side panel is shown")
            for k in range(FE_POWER_PAGES):
                move("page, power panel on", lambda k=k: trigger(
                    win, "PgDown" if k % 2 == 0 else "PgUp"))
            move("power panel off", lambda: trigger(win, "Ctrl+P"))
            move("end", lambda: trigger(win, "End"))
            move("home", lambda: trigger(win, "Home"))
            require(b0.toffset == 0.0, f"home at {b0.toffset}")
            c0 = b0.show_channels[0]
            move("lowpass handle drag (both tabs)",
                 lambda: tab0.lp_lines[c0].drag_to(FE_DRAG_LP))
            for b in (b0, b1):
                f = b.data["filtered"]
                require((f.highpass_cutoff, f.lowpass_cutoff)
                        == (2000.0, FE_DRAG_LP),
                        f"the dragged filter {f.highpass_cutoff} "
                        f"{f.lowpass_cutoff}")
            tab1 = win.tabs.widget(1)
            require(tab1.lp_lines[b1.show_channels[0]].value() == FE_DRAG_LP,
                    "the linked tab's handle follows")
            move("NFFT up", lambda: trigger(win, "Shift+R"))
            require(b0.data["spectrogram"].nfft == 512, "NFFT 512")
            move("NFFT down", lambda: trigger(win, "R"))
            require(b0.data["spectrogram"].nfft == 256, "NFFT 256")
            trigger(win, "Z")                 # the zoom region mode
            t0 = b0.toffset
            vb = tab0.trace_plots[c0][0].vb
            move("region zoom", lambda: vb.mouseDragEvent(
                fakeqt.FakeMouseEvent(
                    1, fakeqt.FakePoint(t0 + FE_ZOOM[1], 0.5),
                    fakeqt.FakePoint(t0 + FE_ZOOM[0], -0.5))))
            require(abs(b0.twindow - (FE_ZOOM[1] - FE_ZOOM[0])) < 1e-9,
                    f"zoomed to {b0.twindow} s")
            move("zoom back", lambda: trigger(win, "Backspace"))
            require(b0.twindow == IA_VIEW, f"zoomed back to {b0.twindow} s")
            print(f"  {compared[0]} arrays handed to the toolkit over "
                  f"{sum(len(v) for v in moves.values())} moves equal a "
                  f"direct refresh bit for bit; {handed.calls} toolkit "
                  f"calls, no tensor among them")

            # -- screenshot and restore --------------------------------------
            trigger(win, "3")                 # hide channel 3
            b0.set_times(BR_JUMP, IA_VIEW)
            shot = os.path.join(work, "view.png")
            fakeqt.QFileDialog.save_name = (shot, "PNG (*.png)")
            trigger(win, "Ctrl+Alt+S")
            saved = (b0.toffset, b0.twindow, list(b0.show_channels))
            view = parse_view_metadata(shot)
            require(view is not None and view["file"] == path
                    and abs(view["toffset"] - saved[0]) < 1e-6
                    and abs(view["twindow"] - saved[1]) < 1e-6
                    and view["channels"] == saved[2],
                    f"the screenshot's view {view} of {saved}")
            trigger(win, "Home")
            ev = fakeqt.FakeDropEvent([shot])
            win.dropEvent(ev)
            require(ev.accepted and (b0.toffset, b0.twindow,
                                     b0.show_channels) == saved,
                    "a dropped screenshot restores its view")
            compared[0] += adapter_equals_direct(win, direct, dev)
            for i in range(win.tabs.count()):
                win.tabs.widget(i).teardown()
            shell.close()
            built.clear()
            rc = audian.main([shot])
            fakeqt.QTimer.single_shots = []
            require(rc == 0 and len(built) == 1, f"audian on the PNG rc {rc}")
            got = built[0]["view"]
            require(abs(got[0] - saved[0]) < 1e-6
                    and abs(got[1] - saved[1]) < 1e-6 and got[2] == saved[2],
                    f"main([png]) restored {got}, saved {saved}")
            print(f"  screenshot (Ctrl+Alt+S) of {saved[0]:.1f} s + "
                  f"{saved[1]:.1f} s, channels without 3: the drop and "
                  f"main([png]) restore it; window over both recordings "
                  f"{1e3 * window_s:.3f} ms  [{card}]")
            for label, ts in moves.items():
                ms = 1e3 * np.array([t for t, _, _ in ts])
                share = np.array([p / t for t, p, _ in ts])
                if len(ms) > 2:
                    # an action refreshes the tab twice: on the browser's
                    # signal, then the window's own refresh after the verb
                    split = "  ".join(
                        f"refresh {k + 1} p50 " + format(1e3 * np.percentile(
                            [r[k] for _, _, r in ts if len(r) > k], 50),
                            ".3f") + " ms"
                        for k in range(max(len(r) for _, _, r in ts)))
                    print(f"    {label} x{len(ms)} ({C} ch, move to the end "
                          f"of the adapter's refresh): p50 "
                          f"{np.percentile(ms, 50):.3f} ms  p95 "
                          f"{np.percentile(ms, 95):.3f} ms  max "
                          f"{ms.max():.3f} ms; {split}; the power side "
                          f"panel p50 {100 * np.percentile(share, 50):.1f} "
                          f"% of a page  [{card}]")
                else:
                    print(f"    {label}: " + "  ".join(f"{v:.3f}" for v in ms)
                          + f" ms  [{card}]")

            # -- the song viewer's envelope keys, without matplotlib --------
            viewer = viewer_keys_phase(card, dev, song[0])

            # -- matplotlib, where this machine has it ------------------------
            if importlib.util.find_spec("matplotlib") is None:
                print("  matplotlib is not installed here: audian "
                      "--screenshot, the song viewer and songdetector "
                      "--plot-png are held by the tier-1 tests on the CPU "
                      "(tests/test_torch_{screenshot,songplot,gui_mpl}.py)")
            else:
                mpl_phase(card, dev, work, path, song)
        finally:
            os.chdir(cwd)
    finally:
        handed.restore()
        fakeqt.uninstall()
        importlib.reload(qt_gui)
    print(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return viewer


#: the song viewer's envelope keys from the detect design: ``e`` divides
#: the cutoff by 1.5, ``E`` multiplies it (gui/songplot.py)
VIEWER_KEYS = (("e", DETECT_ENV / 1.5), ("E", DETECT_ENV * 1.5))


def viewer_env(data, cutoff, fused):
    """The envelope ``SongPlot._recompute`` computes after an envelope
    key (``fused=True``); ``fused=False`` is the exact chunk path, the
    one the JAX viewer runs."""
    from audian_torch.analysis import events

    return events.band_env(data, RATE, *DETECT_BAND, cutoff,
                           return_filtered=False, fused=fused)[1]


def hold_viewer_env(env, data, cutoff, label):
    """The viewer's decimated envelope against the exact chunk path on
    the same samples: equal shape, finite, within TOL_DETECT of the
    scale.  Returns the largest error."""
    want = viewer_env(data, cutoff, fused=False)
    scale = float(np.abs(want).max())
    err = float(np.abs(env.astype(np.float64) - want).max())
    require(env.shape == want.shape and np.isfinite(env).all(),
            f"{label}: envelope shape {env.shape} vs {want.shape}")
    require(err <= TOL_DETECT * scale,
            f"{label}: decimating vs exact path {err} (scale {scale})")
    return err


def viewer_keys_phase(card, dev, pcm):
    """The song viewer's envelope keys on the card, with no matplotlib:
    ``SongPlot._recompute`` after ``e`` and ``E`` runs ``band_env`` on the
    viewer's float32 samples on the decimating path, whose interior
    chunks launch envdet at the key's decimation step.  The launch
    counters are zeroed just before each key's call and read just after;
    envdet must run once per interior chunk.  The envelope is held
    against the exact chunk path, and the kernel built for the key's
    geometry against its plain version and float64 on the recording's
    first interior window.  Returns envdet's launches over the keys."""
    from audian_torch.analysis import events
    from audian_torch.ops.cuda.chain import chain
    from audian_torch.ops.cuda.envdet import EnvDetKernel, envdet
    from audian_torch.ops.cuda.window_matmul import window_matmul

    data = pcm.astype(np.float32)
    data /= 32768.0          # the viewer's samples (gui/songplot.py)
    n = data.shape[0]
    made = events._make_envdet
    built = []

    def capture(*args, **kw):
        out = made(*args, **kw)
        built.append((out, args[3]))
        return out

    total = 0
    events._make_envdet = capture
    try:
        for key, cutoff in VIEWER_KEYS:
            built.clear()
            torch.cuda.synchronize()
            chain.launches = window_matmul.launches = envdet.launches = 0
            a = time.perf_counter()
            env = viewer_env(data, cutoff, fused=True)
            torch.cuda.synchronize()
            key_s = time.perf_counter() - a
            launches = {"envdet": envdet.launches,
                        "window_matmul": window_matmul.launches,
                        "chain": chain.launches}
            require(len(built) == 1 and built[0][0] is not None,
                    f"key {key}: the decimating path was built")
            (ed, chunk), halo = built[0]
            require(isinstance(ed, EnvDetKernel),
                    f"key {key}: the geometry takes the envdet kernel")
            W = events._CHUNK + 2 * halo
            interior = [pos for pos in range(0, n, chunk)
                        if pos - halo >= 0 and pos - halo + W <= n]
            require(launches == {"envdet": len(interior),
                                 "window_matmul": 0, "chain": 0},
                    f"key {key}: launches {launches}, interior chunks "
                    f"{len(interior)}")
            total += launches["envdet"]
            err = hold_viewer_env(env, data, cutoff, f"key {key}")
            print(f"  song viewer key {key!r} ({DETECT_ENV:.0f} -> "
                  f"{cutoff:.1f} Hz, step {ed.step}, taps {ed.lb} + "
                  f"{ed.ll}): envdet launched {launches['envdet']} times "
                  f"({len(interior)} interior chunks), band_env "
                  f"{1e3 * key_s:.3f} ms; vs the exact path {err:.3e}  "
                  f"[{card}]")
            a0 = interior[0] - halo
            check_envdet(ed, torch.from_numpy(data[a0:a0 + W]).to(dev),
                         f"key {key!r} kernel on the first interior "
                         f"window")
    finally:
        events._make_envdet = made
    return total


def mpl_phase(card, dev, work, path, song):
    """Phase 14's matplotlib part, under Agg: ``audian --screenshot`` and
    ``audian-songdetector --plot-png`` on phase 8's recording, then the
    song viewer's envelope key on the card."""
    import matplotlib

    matplotlib.use("Agg")
    from audian_torch.app import parse_view_metadata
    from audian_torch.cli import audian, songdetector
    from audian_torch.gui.songplot import SongPlot
    from audian_torch.ops.cuda.envdet import envdet

    shot = os.path.join(work, "agg.png")
    rc = audian.main([path, "--screenshot", shot])
    view = parse_view_metadata(shot)
    require(rc == 0 and view is not None and view["file"] == path,
            f"audian --screenshot rc {rc} view {view}")
    pcm, rows = song
    wav = os.path.join(work, "songs.wav")
    scipy.io.wavfile.write(wav, int(RATE), pcm)
    png, csv = os.path.join(work, "songs.png"), os.path.join(work, "p.csv")
    rc = songdetector.main([wav, "--plot-png", png, "-o", csv])
    with open(csv) as f:
        got = [line.strip().split(",") for line in f if line.strip()]
    require(rc == 0 and os.path.getsize(png) > 0, f"--plot-png rc {rc}")
    require(got == rows, "--plot-png writes phase 8's CSV")
    data, _ = songdetector.load_recording(wav)
    from audian_torch.analysis import events

    result = events.detect(data, RATE, *DETECT_BAND, DETECT_ENV)
    win = SongPlot(data, RATE, result, filename=wav)
    # the envelope band_env hands the viewer (which refines it in place)
    got = []
    band_env = events.band_env

    def capture(*args, **kw):
        out = band_env(*args, **kw)
        got.append(np.array(out[1]))
        return out

    class Key:
        key = "e"

    events.band_env = capture
    try:
        torch.cuda.synchronize()
        envdet.launches = 0
        a = time.perf_counter()
        win.keypress(Key())
        torch.cuda.synchronize()
        key_s = time.perf_counter() - a
        launches = envdet.launches
    finally:
        events.band_env = band_env
    win.plt.close(win.fig)
    require(launches > 0, "the viewer's envelope key launched envdet")
    require(len(got) == 1, f"the envelope key ran band_env {len(got)} times")
    err = hold_viewer_env(got[0], win.data, win.envelopecutofffreq,
                          "the viewer's envelope key")
    print(f"  matplotlib (Agg): audian --screenshot writes the view; "
          f"--plot-png on {DETECT_SECONDS} s x {C} ch writes phase 8's CSV "
          f"({len(rows) - 1} songs) and a PNG; the viewer's envelope key "
          f"(500 -> {win.envelopecutofffreq:.1f} Hz) launched envdet "
          f"{launches} times, {1e3 * key_s:.3f} ms, vs the exact path "
          f"{err:.3e}  [{card}]")


# -- phase 15: the multi-device paths -----------------------------------------

MD_SECONDS = 600         # the pipeline's and detect's long recording
MD_SHARDS = 4            # mesh entries, all on the one card
MD_MINMAX = 128          # the pipeline's overview step
MD_PAGES = 20            # meshed session pages
TOL_MD_TILE = 1e-4
TOL_MD_PSD_RTOL = 1e-4


def pipeline_outputs_equal(got, want, label):
    """Two sharded pipelines' outputs: filtered, envelope and minmax within
    1e-5, the PSD within 1e-4 relative (1e-9 absolute).  Returns the
    largest absolute error of the first three."""
    require(set(got) == set(want), f"{label}: keys {set(got)} {set(want)}")
    err = 0.0
    for key in want:
        require(got[key].shape == want[key].shape,
                f"{label}: {key} shape {tuple(got[key].shape)}")
        if key == "spectrogram":
            bad = int(((got[key] - want[key]).abs()
                       > 1e-9 + TOL_MD_PSD_RTOL * want[key].abs()).sum())
            require(bad == 0, f"{label}: {bad} PSD bins off")
        else:
            e = max_abs(got[key], want[key])
            require(e <= TOL_FILTERED, f"{label}: {key} {e}")
            err = max(err, e)
    return err


def timed_pipeline(pipe, x, counters):
    """One warm-up run, then the timed one (host clock, ended by a
    synchronize) with the launch counters zeroed just before it and read
    just after.  Returns ``(outputs, seconds, launches)``."""
    pipe(x)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    a = time.perf_counter()
    out = pipe(x)
    torch.cuda.synchronize()
    secs = time.perf_counter() - a
    return out, secs, {k: c.launches for k, c in counters.items()}


def slice_of_pipeline_vs_scipy(out, pcm, edge, label):
    """The 2 s of channel 0 around frame ``edge`` (a shard edge) against
    scipy float64 (the bioacoustics designs, 1 s of lead-in and lead-out
    on each side): filtered and envelope within 1e-5, the PSD within
    0.013 dB."""
    from audian_torch.ops.design import design_envelope_filter, design_filter

    a0, a1 = edge - int(RATE), edge + int(RATE)
    m = int(RATE)
    x64 = pcm[a0 - m : a1 + m, 0].astype(np.float64) / 32768.0
    ys = sps.sosfilt(design_filter(RATE, 2000.0, 40000.0), x64)
    es = np.maximum(sps.sosfiltfilt(design_envelope_filter(RATE, 500.0),
                                    (np.pi / 2) * np.abs(ys)), 0.0)
    ys, es = ys[m:-m], es[m:-m]
    ey = float(np.abs(out["filtered"][a0:a1, 0].cpu().numpy() - ys).max())
    ee = float(np.abs(out["envelope"][a0:a1, 0].cpu().numpy() - es).max())
    hop, nfft = 128, 256
    f0, f1 = -(-a0 // hop), (a1 - nfft) // hop
    _, _, sx = sps.spectrogram(
        ys[f0 * hop - a0 : (f1 - 1) * hop + nfft - a0], fs=RATE,
        window="hann", nperseg=nfft, noverlap=nfft - hop, detrend=False,
        scaling="density", mode="psd")
    sdb = psd_db_err(out["spectrogram"][f0:f1, 0].cpu(),
                     torch.from_numpy(sx.T))
    require(ey <= TOL_FILTERED and ee <= TOL_ENVELOPE and sdb <= TOL_PSD_DB,
            f"{label} vs scipy: {ey} {ee} {sdb} dB")
    return ey, ee, sdb


def shard_kernel_calls(pipe, x, dev):
    """The kernel calls of one chunk of a sharded pipeline, all channels:
    the first chunk of shard 1 (across the first shard edge), its window
    with the chain's halos built by the pipeline's own ``shard_window``
    and run through the pipeline's shard-local step, which calls
    ``chain_cf``.  Returns ``[(name, args, kwargs)]``."""
    from audian_torch.ops import fused, stft
    from audian_torch.ops.cuda.chain import ChainKernel

    n, c = x.shape
    L = pipe.padded_length(n) // pipe.mesh.shape["seq"]
    k = min(pipe.chunk, L)
    win = pipe.shard_window(x, L, k, 0, c, dev)
    calls = []
    real_wm, real_ck = fused.window_matmul, ChainKernel.__call__

    class Recorded:
        """``window_matmul`` that keeps each call, its counter the real
        one's (the per-stage route reads it)."""

        launches = property(lambda self: real_wm.launches)

        def __call__(self, *args, **kw):
            calls.append(("window_matmul", args, kw))
            return real_wm(*args, **kw)

    def ck(self, *args, **kw):
        calls.append(("chain", (self,) + args, kw))
        return real_ck(self, *args, **kw)

    fused.window_matmul = stft.window_matmul = Recorded()
    ChainKernel.__call__ = ck
    try:
        pipe._local(pipe.chain(dev), win, k)
    finally:
        fused.window_matmul = stft.window_matmul = real_wm
        ChainKernel.__call__ = real_ck
    torch.cuda.synchronize()
    return calls


def hold_shard_kernels(pipe, x, dev, label):
    """Each kernel call of one shard chunk (:func:`shard_kernel_calls`)
    against its plain version on the same inputs: window_matmul within
    1e-5 of its output's scale (phase 2's tolerance), the chain at
    ``check_chain``'s.  Returns ``{kernel: (calls, max abs err)}``."""
    from audian_torch.ops.cuda.window_matmul import (window_matmul,
                                                     window_matmul_plain)

    held = {}
    for name, args, kw in shard_kernel_calls(pipe, x, dev):
        if name == "chain":
            ck, x_ext, n = args
            err, _got = check_chain(ck, x_ext, n, f"{label} chain, "
                                    f"{x_ext.shape[0]} ch x {n}")
            del _got
        else:
            got = window_matmul(*args, **kw)
            kw = {k: v for k, v in kw.items() if k != "split"}
            want = window_matmul_plain(*args, **kw)
            torch.cuda.synchronize()
            err = max_abs(got, want)
            scale = float(want.abs().max())
            xw, w, S, nfr = args[:4]
            what = (f"{label} window_matmul K={w.shape[0]} O={w.shape[1]} "
                    f"S={S} frames={nfr} premap={kw.get('premap')} "
                    f"{tuple(xw.shape)} {xw.dtype}")
            require(err <= TOL_WINDOW * scale, f"{what}: {err}")
            print(f"  {what}: max_abs_err {err:.3e} (scale {scale:.3e})")
            del got, want
        calls, worst = held.get(name, (0, 0.0))
        held[name] = (calls + 1, max(worst, err))
    return held


def md_page_tiles(b):
    """A meshed-session check's refresh: the filtered min/max tile and the
    float dB tile of every channel."""
    return ({c: b.trace_tile("filtered", c) for c in range(b.data.channels)},
            {c: b.spec_tile(c) for c in range(b.data.channels)})


def multidevice_phase(card, dev, tmp, path, song):
    """Phase 15: the multi-device paths on the one card, every mesh entry
    ``dev``.  Returns each kernel's launches on its multi-device path
    (counters zeroed just before, read just after)."""
    import contextlib
    import io

    from audian_torch.analysis import events
    from audian_torch.app import DataBrowser
    from audian_torch.cli import songdetector
    from audian_torch.data.loader import AudioLoader
    from audian_torch.entry import dryrun_multichip
    from audian_torch.models import get_preset
    from audian_torch.ops.cuda.chain import chain
    from audian_torch.ops.cuda.envdet import envdet
    from audian_torch.ops.cuda.window_matmul import window_matmul
    from audian_torch.parallel import ChannelShards, make_mesh
    from audian_torch.utils import trace

    counters = {"chain": chain, "window_matmul": window_matmul,
                "envdet": envdet}
    mesh4 = make_mesh([dev] * MD_SHARDS, seq=MD_SHARDS)
    mesh1 = make_mesh([dev], seq=1)
    launches = {}

    # -- the sharded pipeline on 10 min x 16 ch, read as int16 codes
    print(f"phase 15: multi-device paths ({MD_SHARDS} mesh entries on "
          f"{dev}); the pipeline on a {MD_SECONDS} s x {C} ch x 96 kHz "
          f"PCM-16 WAV")
    wav = os.path.join(tmp, "long.wav")
    scipy.io.wavfile.write(wav, int(RATE),
                           interactive_recording(MD_SECONDS, C, dev))
    ld = AudioLoader(wav, prefetch=False)
    require(ld.raw16_capable, "the long WAV reads as int16 codes")
    pcm = np.empty((ld.frames, ld.channels), np.int16)
    ld.read_raw16_into(0, ld.frames, pcm)
    ld.close()
    n = pcm.shape[0]
    hour = 3600.0 / MD_SECONDS
    bio = get_preset("bioacoustics")
    p1 = bio.sharded(mesh1, RATE, minmax_step=MD_MINMAX)
    p4 = bio.sharded(mesh4, RATE, minmax_step=MD_MINMAX)
    require(p4.chain(dev).chain_kernel is not None,
            "the bioacoustics shards take the chain kernel")
    out1, s1, l1 = timed_pipeline(p1, pcm, counters)
    out4, s4, l4 = timed_pipeline(p4, pcm, counters)
    # the same run from codes already on the card, and the upload alone
    a = time.perf_counter()
    codes = torch.from_numpy(pcm).to(dev)
    torch.cuda.synchronize()
    s_up = time.perf_counter() - a
    _o, s4d, _l = timed_pipeline(p4, codes, counters)
    del _o
    # where the device time of that run goes
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        a = time.perf_counter()
        p4(codes)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - a
    by_kernel = sorted(
        ((e.self_device_time_total, e.key) for e in prof.key_averages()
         if device_work(e) and e.self_device_time_total > 0), reverse=True)
    busy_s = sum(t for t, _ in by_kernel) / 1e6
    del codes
    require(l4["chain"] > 0 and l1["chain"] > 0,
            f"chain launched on the sharded pipeline: {l4} {l1}")
    launches["chain"] = l4["chain"]
    e4 = pipeline_outputs_equal(out4, out1, "seq=4 vs seq=1")
    require(out4["filtered"].shape == (n, C), "filtered (n_pad, C)")
    edge = p4.padded_length(n) // MD_SHARDS
    ey, ee, sdb = slice_of_pipeline_vs_scipy(out4, pcm, edge, "seq=4")
    del out4
    held = hold_shard_kernels(p4, pcm, dev, f"bioacoustics seq={MD_SHARDS} "
                              f"shard 1 chunk 0:")
    require(set(held) == {"chain"} and held["chain"][0] == 1,
            f"one chain call a bioacoustics shard chunk: {held}")
    print(f"  bioacoustics seq={MD_SHARDS} == seq=1 (max {e4:.3e}, PSD "
          f"within {TOL_MD_PSD_RTOL} relative); 2 s of ch 0 across the "
          f"first shard edge vs scipy: filtered {ey:.3e} envelope {ee:.3e} "
          f"psd {sdb:.3e} dB; launches seq={MD_SHARDS} {l4}, seq=1 {l1}")
    print(f"  pipeline seconds per recording hour (host clock, upload of "
          f"the int16 codes included): seq=1 {s1 * hour:.4f}  "
          f"seq={MD_SHARDS} {s4 * hour:.4f}; seq={MD_SHARDS} from codes "
          f"on the card {s4d * hour:.4f}, the pageable upload alone "
          f"{s_up * hour:.4f}  [{card}]")
    if busy_s > 0:
        print(f"  seq={MD_SHARDS} from codes on the card under the profiler: "
              f"wall {prof_wall:.4f} s, device busy {busy_s:.4f} s "
              f"({100 * busy_s / prof_wall:.1f} %); by kernel (ms):")
        for t, key in by_kernel[:6]:
            print(f"    {t / 1e3:10.4f}  {key[:90]}")
    else:
        print("  pipeline device busy share: not measured (the profiler "
              "recorded no device time)")
    p22 = bio.sharded(make_mesh([dev] * 4, seq=2, ch=2), RATE,
                      minmax_step=MD_MINMAX)
    e22 = pipeline_outputs_equal(p22(pcm), out1, "seq=2 x ch=2 vs seq=1")
    del out1
    us = get_preset("ultrasound")
    u1 = us.sharded(mesh1, RATE, minmax_step=MD_MINMAX)
    u4 = us.sharded(mesh4, RATE, minmax_step=MD_MINMAX)
    require(u4.chain(dev).chain_kernel is None,
            "ultrasound takes the per-stage path")
    uo1, us1, _ = timed_pipeline(u1, pcm, counters)
    uo4, us4, lu = timed_pipeline(u4, pcm, counters)
    require(lu["window_matmul"] > 0 and lu["chain"] == 0,
            f"window_matmul launched on the per-stage shards: {lu}")
    launches["window_matmul"] = lu["window_matmul"]
    eu = pipeline_outputs_equal(uo4, uo1, "ultrasound seq=4 vs seq=1")
    del uo1, uo4
    held = hold_shard_kernels(u4, pcm, dev, f"ultrasound seq={MD_SHARDS} "
                              f"shard 1 chunk 0:")
    require(set(held) == {"window_matmul"}
            and held["window_matmul"][0] == 3,
            f"three window_matmul calls an ultrasound shard chunk: {held}")
    print(f"  seq=2 x ch=2 == seq=1 (max {e22:.3e}); ultrasound seq="
          f"{MD_SHARDS} == seq=1 (max {eu:.3e}), launches {lu}; seconds "
          f"per recording hour seq=1 {us1 * hour:.4f}  seq={MD_SHARDS} "
          f"{us4 * hour:.4f}  [{card}]")
    torch.cuda.empty_cache()

    # -- sequence-sharded detect
    spcm, rows = song
    for label, rec in ((f"{DETECT_SECONDS} s planted songs", spcm),
                       (f"{MD_SECONDS} s", pcm)):
        args = (rec, RATE, *DETECT_BAND, DETECT_ENV)
        _f, exact, er = events.band_env(*args, return_filtered=False)
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        a = time.perf_counter()
        _f, sharded, er2 = events.band_env(*args, return_filtered=False,
                                           mesh=mesh4)
        torch.cuda.synchronize()
        t_sh = time.perf_counter() - a
        ld_ = {k: c.launches for k, c in counters.items()}
        a = time.perf_counter()
        events.band_env(*args, return_filtered=False, fused=True)
        torch.cuda.synchronize()
        t_ch = time.perf_counter() - a
        require(er == er2 and sharded.shape == exact.shape,
                f"{label}: sharded detect shape {sharded.shape}")
        rel = float(np.abs(sharded - exact).max()) / float(
            np.abs(exact).max())
        require(rel < TOL_DETECT, f"{label}: sharded detect {rel}")
        require(ld_ == {"chain": 0, "window_matmul": 0,
                        "envdet": MD_SHARDS},
                f"{label}: envdet once per shard: {ld_}")
        launches["envdet"] = launches.get("envdet", 0) + ld_["envdet"]
        print(f"  detect envelope, {label}: sharded over {MD_SHARDS} vs the "
              f"chunked exact path {rel:.3e} relative; envdet launched "
              f"{ld_['envdet']} times; wall sharded {1e3 * t_sh:.3f} ms, "
              f"chunked (the CLI's decimating path) {1e3 * t_ch:.3f} ms  "
              f"[{card}]")
    del pcm
    swav = os.path.join(tmp, "songs15.wav")
    scipy.io.wavfile.write(swav, int(RATE), spcm)
    csv = os.path.join(tmp, "mesh.csv")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = songdetector.main([swav, "--mesh", "4", "-o", csv])
    with open(csv) as f:
        got = [line.strip().split(",") for line in f if line.strip()]
    require(rc == 0 and got == rows, "--mesh 4 writes phase 8's CSV")
    require(err.getvalue().strip() == "--mesh 4: only 1 device(s) "
            "available, running single-device", f"--mesh: {err.getvalue()}")
    print(f"  audian-songdetector --mesh 4: \"{err.getvalue().strip()}\", "
          f"phase 8's CSV")

    # -- -j 4 against -j 1 on four recordings
    files = []
    for k, rec in enumerate((spcm, spcm[:, ::-1],
                             np.roll(spcm, int(4 * RATE), axis=0),
                             np.roll(spcm[:, ::-1], int(2 * RATE), axis=0))):
        files.append(os.path.join(tmp, f"batch{k}.wav"))
        scipy.io.wavfile.write(files[-1], int(RATE),
                               np.ascontiguousarray(rec))
    runs = {}
    for jobs in ("1", "4"):
        torch.cuda.synchronize()
        envdet.launches = 0
        a = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = songdetector.main(["-j", jobs, *files])
        torch.cuda.synchronize()
        wall = time.perf_counter() - a
        require(rc == 0, f"-j {jobs} exit status {rc}")
        tables = []
        for f in files:
            out = f[:-4] + "-songs.csv"
            with open(out) as fh:
                tables.append(fh.read())
            os.remove(out)
        runs[jobs] = (wall, envdet.launches, tables)
    require(runs["4"][2] == runs["1"][2], "-j 4 writes -j 1's CSVs")
    require(runs["4"][1] == runs["1"][1] > 0,
            f"envdet launches -j 4 {runs['4'][1]}, -j 1 {runs['1'][1]}")
    print(f"  -j 4 on {len(files)} x {DETECT_SECONDS} s x {C} ch: -j 1's "
          f"CSVs, envdet launched {runs['4'][1]} times in each; wall -j 1 "
          f"{runs['1'][0]:.3f} s, -j 4 {runs['4'][0]:.3f} s  [{card}]")
    del spcm

    # -- the meshed session against the unsharded one
    bm = DataBrowser(path, mesh=make_mesh([dev] * 4, seq=1, ch=4))
    b1 = DataBrowser(path, device=dev)
    lat = {"mesh": [], "one": []}
    worst = [0.0, 0.0]
    try:
        for b in (bm, b1):
            b.open()
            md_page_tiles(b)
        for page in range(MD_PAGES):
            for key, b in (("mesh", bm), ("one", b1)) if page % 2 else (
                    ("one", b1), ("mesh", bm)):
                torch.cuda.synchronize()
                a = time.perf_counter()
                b.time_page_down()
                tiles = md_page_tiles(b)
                torch.cuda.synchronize()
                lat[key].append(time.perf_counter() - a)
                if key == "mesh":
                    tm = tiles
                else:
                    t1 = tiles
            require(isinstance(bm.data["filtered"].buffer, ChannelShards)
                    and len(bm.data["filtered"].buffer.parts) == 4,
                    "the meshed window is held in 4 channel groups")
            i0 = int(bm.toffset * RATE)
            i1 = i0 + int(bm.twindow * RATE)
            for name in ("data", "filtered"):
                e = float(np.abs(np.asarray(bm.data[name][i0:i1])
                                 - np.asarray(b1.data[name][i0:i1])).max())
                require(e <= TOL_WINDOW, f"page {page}: meshed {name} {e}")
                worst[0] = max(worst[0], e)
            for c in range(C):
                (ta, va), (tb, vb) = tm[0][c], t1[0][c]
                (ia, ra), (ib, rb) = tm[1][c], t1[1][c]
                require(np.array_equal(ta, tb) and ra == rb
                        and va.shape == vb.shape and ia.shape == ib.shape,
                        f"page {page}: tile geometry, channel {c}")
                e = max(float(np.abs(va - vb).max()),
                        float(np.abs(ia - ib).max()))
                require(e <= TOL_MD_TILE, f"page {page}: meshed tiles, "
                        f"channel {c}: {e}")
                worst[1] = max(worst[1], e)
        # tracing around one page and one detect
        trace.clear()
        trace.enable(log=False)
        b1.time_page_down()
        md_page_tiles(b1)
        events.detect(song[0], RATE, *DETECT_BAND, DETECT_ENV,
                      return_filtered=False)
        trace.disable()
        summary = trace.summary()
        trace.clear()
    finally:
        bm.close()
        b1.close()
    pm, p1_ = pcts(lat["mesh"]), pcts(lat["one"])
    print(f"  meshed session (seq=1 x ch=4) on the {IA_SECONDS} s x {C} ch "
          f"WAV, {MD_PAGES} pages: reads within {worst[0]:.3e}, tiles "
          f"within {worst[1]:.3e} of the unsharded browser; a page with "
          f"its tiles p50 {pm[0]:.3f} / p95 {pm[1]:.3f} ms meshed, "
          f"{p1_[0]:.3f} / {p1_[1]:.3f} ms unsharded  [{card}]")
    print(f"  trace summary of one page and one detect: "
          f"{json.dumps(summary, sort_keys=True)}")
    require({"render.pull", "detect.upload", "detect.chunk"}
            <= set(summary), f"trace kinds {set(summary)}")

    a = time.perf_counter()
    dryrun_multichip(MD_SHARDS)
    print(f"  dryrun_multichip({MD_SHARDS}) passed in "
          f"{time.perf_counter() - a:.2f} s  [{card}]")
    return launches


# -- phase 18: the benchmark probes ------------------------------------------

PROBE_N = 8192           # the chain's block, the probes' headline column block
PROBE_NBINS = 129        # the headline PSD's bins
# the selection products against the plain relayout, at unit-normal input:
# HIGHEST keeps x_hi + x_lo (within 2^-22 |x|), DEFAULT x rounded to TF32
# (2^-11 |x|)
TOL_SELECT = {"highest": 2.0 ** -20, "default": 2.0 ** -10}
# the round trip's ring edges, (C, N, blocks): a stage short of two whole
# chunks over 519 items; items a fraction of a stage
RING_EDGES = ((3, 6176, 173), (5, 96, 1001))
# samples a channel of the selection's edge (C = 3): 9003 rows, the last
# tile 43 rows, 1128 items
SELECT_EDGE = 1024 * 3001
# runs of each time of the ring kernels' turns with their library calls
RING_REPS = 20
# the copies' one-shot grid at its edges, (shape, offset in words, block):
# a last tile in part, a scalar tail of 1 and of 3 words, a tensor below
# one tile, program-major blocks; views at a 16-byte aligned offset (the
# vector path) and at an offset of one word (the scalar path)
COPY_EDGES = (((3, 4100), 0, 4100), ((16, 4096), 0, 4096),
              ((3, 4099), 0, 4099), ((1, 7), 0, 7), ((5, 3, 96), 0, None),
              ((3, 4100), 4, 4100), ((3, 4100), 1, 4100),
              ((5, 3, 96), 1, None))


def bits_equal(a, b):
    """The same shape and the same 32-bit words (a copy moves words)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def values_equal(a, b):
    """The same shape, NaNs in the same places and the same words
    elsewhere (an addition may give a NaN another payload)."""
    nan = a.isnan()
    return (a.shape == b.shape and torch.equal(nan, b.isnan())
            and bits_equal(torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)))


def probes_phase(card, dev, chain_ms, chain_ms_b2b, relayout, host):
    """Phase 18: each kernel of ``csrc/probes.cu`` against its plain version
    at the probes' shapes, with a NaN and infinities on the copies' and
    relayouts' inputs, then the three probe sweeps (launch counters zeroed
    just before, read just after) and the headline chain's floor ratio.
    ``chain_ms`` and ``chain_ms_b2b`` are phase 5's headline chain times
    (a lone call, :data:`CALLS` back to back), ``relayout`` phase 16's
    relayout dict, ``host`` phase 5's host enqueue (us a call).  Returns
    the kernels line's five entries."""
    from audian_torch.ops.cuda import _build
    from audian_torch.ops.cuda import probes as P
    from audian_torch.probes import call_scaling, dma_floor, phase_restructure

    print(f"phase 18: the benchmark probes' kernels at {C} ch x {CHUNK} "
          f"float32")
    gen = torch.Generator(dev).manual_seed(SEED + 18)
    x = torch.randn((C, CHUNK), generator=gen, device=dev)
    # non-finite words where the copies, the outputs' fills and columns and
    # the relayouts carry them: program 3's x[0, 0] (its PSD fill), program
    # 7's x[5, 1] (go), program 9's x[0, 2] (qo), and two samples inside
    bad = ((0, 3 * PROBE_N, "nan"), (5, 7 * PROBE_N + 1, "inf"),
           (0, 9 * PROBE_N + 2, "-inf"), (C - 5, CHUNK // 4 + 3, "nan"),
           (2, CHUNK - 7, "-inf"))
    for c, t, v in bad:
        x[c, t] = float(v)
    errs = {}

    def hold(name, label, got, want, exact=values_equal):
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        ok = all(exact(a, b) for a, b in zip(got, want))
        require(ok and len(got) == len(want),
                f"{name} {label} equals its plain version bit for bit")
        nonfinite = sum(int((~torch.isfinite(a)).sum()) for a in got)
        errs[name] = 0.0
        print(f"  {name} {label}: bit for bit the plain version's "
              f"({nonfinite} non-finite outputs where it has them)")

    for N in (4096, PROBE_N, 65536):
        hold("copy_add1", f"N={N}", P.copy_add1(x, N),
             P.copy_add1_plain(x, N))
    x3 = x[:3, : 3 * 16391].contiguous()
    hold("copy_add1", "C = 3, N = 16391 (rows not of whole 16-byte words)",
         P.copy_add1(x3, 16391), P.copy_add1_plain(x3, 16391))
    for N in (PROBE_N, 32768):
        xpm = dma_floor.to_program_major(x, N)
        hold("copy_pm_add1", f"N={N}", P.copy_pm_add1(xpm),
             P.copy_pm_add1_plain(xpm))
    # the one-shot grid's edges (a NaN and an infinity planted in each): a
    # last tile in part, a scalar tail, a tensor below one tile, and views
    # at an offset of 4 words (16-byte aligned: the vector path) and of one
    # word (the scalar path)
    flat = torch.randn(1 << 17, generator=gen, device=dev)
    for shape, off, block in COPY_EDGES:
        n = math.prod(shape)
        xe = flat[off:off + n].view(shape)
        xe.reshape(-1)[n // 2] = float("nan")
        xe.reshape(-1)[n - 1] = float("inf")
        if len(shape) == 2:
            got, want = P.copy_add1(xe, block), P.copy_add1_plain(xe, block)
        else:
            got, want = P.copy_pm_add1(xe), P.copy_pm_add1_plain(xe)
        path = "vector" if xe.data_ptr() % 16 == 0 else "scalar"
        hold("copy_add1" if len(shape) == 2 else "copy_pm_add1",
             f"{tuple(shape)} at an offset of {off} words ({n % 4} tail "
             f"words, {P.copy_grid(n)} blocks, the {path} path)", got, want)
    del flat
    for nb in (PROBE_NBINS, 128, 256):
        hold("outputs_floor", f"N={PROBE_N} nbins={nb}",
             P.outputs_floor(x, PROBE_N, nb),
             P.outputs_floor_plain(x, PROBE_N, nb))
    # the relayouts at the IFIR envelope's shapes (M = 8: stage A's u of
    # 2^22 + 164 x 8 samples read from its 128-sample blocks; stage B's
    # e_pm of 2^19 columns from its blocks) and at M = 4 and 16
    for M in (8, 4, 16):
        n_u = CHUNK + 164 * M
        wide = torch.randn((C, -(-n_u // 128) * 128), generator=gen,
                           device=dev)
        wide[1, 17] = float("nan")
        wide[C - 1, n_u - 1] = float("inf")
        u = wide[:, :n_u]
        u_pm = P.pm_forward(u, M)
        hold("phase_major", f"pm_forward M={M}, u (C, {n_u}) of a "
             f"({C}, {wide.shape[1]}) stream", u_pm,
             P.pm_forward_plain(u, M), bits_equal)
        q = CHUNK // M
        e_wide = torch.randn((C * M, -(-q // 128) * 128 + 128),
                             generator=gen, device=dev)
        e_wide[3, 5] = float("nan")
        e_wide[C * M - 1, q - 1] = float("-inf")
        e_pm = e_wide[:, :q]
        hold("phase_major", f"pm_inverse M={M}, e_pm ({C * M}, {q}) of a "
             f"row stride {e_wide.shape[1]}", P.pm_inverse(e_pm, M),
             P.pm_inverse_plain(e_pm, M), bits_equal)
        hold("phase_major", f"pm_inverse(pm_forward(u)) == u, M={M}",
             P.pm_inverse(u_pm, M), u.contiguous(), bits_equal)
        del wide, u, u_pm, e_wide, e_pm
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for M in (8, 4):
        hold("phase_major", f"pm_roundtrip_add1 N={PROBE_N} M={M}",
             P.pm_roundtrip_add1(x, PROBE_N, M),
             P.pm_roundtrip_add1_plain(x, PROBE_N, M))
    # the round trip's ring at its edges (NaN and infinities planted): C = 3
    # with blocks of 6176 samples (a stage short of two whole chunks), 519
    # items; C = 5 with blocks of 96, each item a fraction of a stage
    for c_, n_, nprog in RING_EDGES:
        xe = x[:c_, : n_ * nprog].contiguous()
        xe[c_ - 1, n_ * nprog - 1] = float("inf")
        for M in (8, 4):
            grid = P.roundtrip_grid(c_, n_ * nprog, n_, M, sms)
            hold("phase_major", f"pm_roundtrip_add1 C={c_} N={n_} M={M}, "
                 f"{c_ * nprog} items on a grid of {grid}",
                 P.pm_roundtrip_add1(xe, n_, M),
                 P.pm_roundtrip_add1_plain(xe, n_, M))
    # the plan formulas against the library's own
    for c_, t_, n_ in ((C, CHUNK, PROBE_N), *((c_, n_ * k, n_)
                                              for c_, n_, k in RING_EDGES),
                       (1, 4 * 41696, 41696)):
        for M in (8, 4):
            require(lib.probe_pm_roundtrip_smem_bytes(n_, M)
                    == P.roundtrip_smem_bytes(n_, M)
                    and lib.probe_pm_roundtrip_grid(c_, t_, n_, M, sms)
                    == P.roundtrip_grid(c_, t_, n_, M, sms),
                    f"the round trip's shared memory and grid at C={c_} "
                    f"N={n_} M={M} agree with the library's")
    require(lib.probe_select_pm_smem_bytes() == P.select_smem_bytes(),
            "the selection's shared-memory formula agrees")
    for n_ in (0, 1, 7, 1440, P.COPY_TILE, P.COPY_TILE + 1, 3 * 4100,
               C * CHUNK):
        require(lib.probe_copy_grid(n_) == P.copy_grid(n_),
                f"the copies' grid over {n_} words agrees")
    for c_, t_ in ((C, CHUNK), (3, SELECT_EDGE), (1, P.GROUP)):
        require(lib.probe_select_pm_grid(c_, t_, sms)
                == P.select_grid(c_, t_, sms),
                f"the selection's grid at C={c_} T={t_} agrees")
    print(f"  plans: the copies' grid {P.copy_grid(C * CHUNK)} blocks of "
          f"{P.COPY_TILE} words; round trip "
          f"{P.roundtrip_smem_bytes(PROBE_N, 8)} bytes "
          f"a block, grid {P.roundtrip_grid(C, CHUNK, PROBE_N, 8, sms)}; "
          f"selection {P.select_smem_bytes()} bytes, grid "
          f"{P.select_grid(C, CHUNK, sms)} ({sms} SMs)")
    # the selection products: within TOL_SELECT of max|x| on a unit-normal
    # input from seed 0 (a NaN or an infinity would spread over its row's
    # 128 outputs of that source block, so none is planted here)
    xs = torch.randn((C, CHUNK), generator=torch.Generator(dev).manual_seed(
        SEED), device=dev)
    scale = float(xs.abs().max())
    want = P.select_pm_add1_plain(xs)
    select = {}
    for prec, tol in TOL_SELECT.items():
        got = P.select_pm_add1(xs, precision=prec)
        torch.cuda.synchronize()
        err = max_abs(got, want)
        require(bool(torch.isfinite(got).all()) and err <= tol * scale,
                f"select_pm_add1 at {prec}: {err} (max|x| {scale})")
        select[prec] = {"max_abs_err": err}
        print(f"  select_pm_add1 {prec}: max_abs_err {err:.3e} (budget "
              f"{tol * scale:.3e}, {tol:.3e} of max|x| {scale:.4f})")
    errs["select_pm_add1"] = select["highest"]["max_abs_err"]
    # the ring's edges: C = 3, R = 9003 rows (the last tile 43 rows), 1128
    # items; one NaN and one infinity, each turning exactly its row's 128
    # outputs of its source block non-finite (the NaN's all NaN; the
    # infinity's NaN but, at DEFAULT, where x has no lo part, its own
    # output, inf x 1 + 1), the rest within TOL_SELECT
    xe = xs[:3, :SELECT_EDGE].contiguous()
    plain_e = P.select_pm_add1_plain(xe)
    spread = {}
    for c_, g_, b_, i_, v in ((1, 5, 3, 77, "nan"),
                              (2, SELECT_EDGE // P.GROUP - 1, 7, 0, "inf")):
        xe[c_, P.GROUP * g_ + 128 * b_ + i_] = float(v)
        mask = torch.zeros(xe.shape, dtype=torch.bool, device=dev)
        for m in range(8):
            o = P.GROUP * g_ + 128 * m + 16 * b_
            mask[c_, o:o + 16] = True
        own = (c_, P.GROUP * g_ + 128 * (i_ % 8) + 16 * b_ + i_ // 8)
        spread[v] = (mask, own)
    both = spread["nan"][0] | spread["inf"][0]
    scale_e = float(xe[torch.isfinite(xe)].abs().max())
    for prec, tol in TOL_SELECT.items():
        got = P.select_pm_add1(xe, precision=prec)
        torch.cuda.synchronize()
        err = max_abs(torch.where(both, 0.0, got),
                      torch.where(both, 0.0, plain_e))
        nan_ok = bool(got[spread["nan"][0]].isnan().all())
        inf_own = float(got[spread["inf"][1]])
        inf_ok = int(got[spread["inf"][0]].isnan().sum()) == (
            127 if prec == "default" else 128) and (
            prec != "default" or inf_own == float("inf"))
        require(torch.equal(~torch.isfinite(got), both) and nan_ok
                and inf_ok and err <= tol * scale_e,
                f"select_pm_add1 at {prec}, C=3 T={SELECT_EDGE}: non-finite "
                f"exactly over the planted rows' source blocks, elsewhere "
                f"{err}")
        print(f"  select_pm_add1 {prec} C=3 x {SELECT_EDGE} "
              f"({P.select_grid(3, SELECT_EDGE, sms)} blocks): a NaN made "
              f"exactly its row's 128 outputs of its source block NaN, an "
              f"infinity its 128 non-finite (its own {inf_own}); elsewhere "
              f"max_abs_err {err:.3e}")
    del x3, xpm, got, want, xe, plain_e, spread, both

    # the plain versions' and the library calls' times at the headline
    # shapes (the kernels' own come from the sweeps below)
    xpm = dma_floor.to_program_major(xs, PROBE_N)
    view = xs.reshape(C, CHUNK // P.GROUP, P.GROUP // 8, 8).transpose(2, 3)
    sel_out = torch.empty(view.shape, device=dev)
    plain = {
        "copy_add1": median_ms(lambda: P.copy_add1_plain(xs, PROBE_N)),
        "copy_pm_add1": median_ms(lambda: P.copy_pm_add1_plain(xpm)),
        "outputs_floor": median_ms(
            lambda: P.outputs_floor_plain(xs, PROBE_N, PROBE_NBINS)),
        "pm_roundtrip_add1": median_ms(
            lambda: P.pm_roundtrip_add1_plain(xs, PROBE_N, 8)),
        "select_pm_add1": median_ms(lambda: P.select_pm_add1_plain(xs)),
    }
    # the library calls as a lone call and CALLS back to back, as the
    # sweeps time the kernels
    library = {}
    for name, call in (("x + 1", lambda: xs + 1.0),
                       ("copy_pm_add1", lambda: xpm + 1.0),
                       ("select_pm_add1",
                        lambda: torch.add(view, 1.0, out=sel_out))):
        library[name] = median_ms(call)
        library[name + " back to back"] = median_ms(call, calls=CALLS)
    # the copies and the two ring kernels beside their library calls, in
    # turns (call, kernel, kernel, call), each the median of RING_REPS runs
    # of a lone call and of 10 calls back to back (the card's time: the
    # host's enqueue of a call overlaps the work of the one before); the
    # copy also at 16 ch x 2^20, the call-scaling sweep's smallest
    ring = {}
    x20 = xs[:, : 1 << 20].contiguous()
    for name, kernel, call in (
            ("copy_add1", lambda: P.copy_add1(xs, PROBE_N),
             lambda: xs + 1.0),
            ("copy_pm_add1", lambda: P.copy_pm_add1(xpm), lambda: xpm + 1.0),
            ("copy_add1 2^20", lambda: P.copy_add1(x20, PROBE_N),
             lambda: x20 + 1.0),
            ("pm_roundtrip_add1",
             lambda: P.pm_roundtrip_add1(xs, PROBE_N, 8), lambda: xs + 1.0),
            ("select_pm_add1 HIGHEST", lambda: P.select_pm_add1(xs),
             lambda: torch.add(view, 1.0, out=sel_out)),
            ("select_pm_add1 DEFAULT",
             lambda: P.select_pm_add1(xs, precision="default"),
             lambda: torch.add(view, 1.0, out=sel_out))):
        t = {k: [median_ms(f, reps=RING_REPS, calls=n)
                 for f in (call, kernel, kernel, call)]
             for k, n in (("lone", 1), ("back_to_back", 10))}
        ring[name] = {k: {"ms": min(v[1:3]), "library_ms": min(v[0], v[3]),
                          "turns": v} for k, v in t.items()}
        nbound = bound(0, 8 * (x20 if "2^20" in name else xs).numel())[0]
        for k, v in ring[name].items():
            print(f"  {name} {k.replace('_', ' ')}, in turns with its torch "
                  f"call: {' '.join(f'{u:.4f}' for u in v['turns'])} ms; "
                  f"the kernel {v['ms']:.4f} ms ({100 * nbound / v['ms']:.1f}"
                  f" % of the bytes bound {nbound:.4f}), the call "
                  f"{v['library_ms']:.4f} ms  [{card}]")
    print("  plain versions (ms): " + "  ".join(
        f"{k} {v:.4f}" for k, v in plain.items()) + "; torch calls (lone, "
        f"{CALLS} back to back): x + 1 {library['x + 1']:.4f}, "
        f"{library['x + 1 back to back']:.4f}; program-major "
        f"{library['copy_pm_add1']:.4f}, "
        f"{library['copy_pm_add1 back to back']:.4f}; the selection's "
        f"relayout + 1 as one add {library['select_pm_add1']:.4f}, "
        f"{library['select_pm_add1 back to back']:.4f}  [{card}]")
    del x, xs, xpm, x20, view, sel_out

    # -- the sweeps: the probes' main path ------------------------------------
    kernels = (P.copy_add1, P.copy_pm_add1, P.outputs_floor,
               P.pm_roundtrip_add1, P.select_pm_add1)
    for k in kernels:
        k.launches = 0
    rows = {}
    for mod in (dma_floor, call_scaling, phase_restructure):
        print(f"  python -m {mod.__name__}  [{card}]")
        rows[mod.__name__.rsplit(".", 1)[1]] = mod.sweep(device=dev,
                                                         echo=True)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"  launches on the sweeps: {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name} launched on the probe sweeps")

    def row(probe, label):
        return next(r for r in rows[probe] if r["label"] == label)

    copy_row = row("dma_floor", f"copy rows N={PROBE_N}")
    floor_row = row("dma_floor", f"y+e+psd({PROBE_NBINS})+stats")
    torch_row = row("call_scaling", "torch  copy 2^22")
    # the output floor reads float32, as the reference's; the chain reads
    # int16, so its own output set moves the input's half fewer bytes
    bytes_int16 = floor_row["bytes"] - 2 * C * CHUNK
    # both terms back to back, as the reference times its probes; the lone
    # calls' ratio beside it
    floor_ratio = chain_ms_b2b / floor_row["ms"]
    floor_ratio_lone = chain_ms / floor_row["lone_ms"]
    print(f"  floor ratio: the headline chain {chain_ms_b2b:.4f} ms (phase 5, "
          f"{CALLS} back to back) over its output floor {floor_row['ms']:.4f}"
          f" ms (N={PROBE_N}, {PROBE_NBINS} bins, float32 in, {CALLS} back "
          f"to back) = {floor_ratio:.3f}; as lone calls {chain_ms:.4f} over "
          f"{floor_row['lone_ms']:.4f} = {floor_ratio_lone:.3f}; over the "
          f"copy floor {copy_row['ms']:.4f} ms = "
          f"{chain_ms_b2b / copy_row['ms']:.3f}; the output set's bytes bound "
          f"with int16 in {bound(0, bytes_int16)[0]:.4f} ms "
          f"({bytes_int16 / 1e9:.3f} GB), float32 in "
          f"{bound(0, floor_row['bytes'])[0]:.4f} ms  [{card}]")

    def both(r):
        """A sweep row's (lone, back-to-back) times."""
        return r["lone_ms"], r["ms"]

    def entry(name, replaces, timed, nbytes, plain_ms, library, flop=0.0,
              peak=PEAK_FLOPS, **more):
        """The kernels line's entry of a probe: ``timed`` and ``library``
        (its torch call's, or None) are (lone, back-to-back) ms, under
        window_matmul's key names."""
        b = bound(flop, nbytes, peak)
        lib_ms, lib_b2b = library or (None, None)
        return {"name": name, "route": "cuda",
                "source": "audian_torch/csrc/probes.cu",
                "replaces": replaces, "launches": launches.get(name),
                "max_abs_err": errs[name], "ms": timed[0],
                "ms_back_to_back": timed[1], "plain_ms": plain_ms,
                "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms,
                "library_ms_back_to_back": lib_b2b,
                "bound_share": b[0] / timed[0],
                "bound_share_back_to_back": b[0] / timed[1], **more}

    rt_row = row("phase_restructure", "reshape+transpose x2")
    sel_rows = {p: row("phase_restructure", f"selection products, {p}")
                for p in ("HIGHEST", "DEFAULT")}
    # a pass: 128 multiply-adds an output of the sweep's input
    flop_sel = 2.0 * (sel_rows["HIGHEST"]["bytes"] // 8) * (P.GROUP // 8)
    out = [
        entry("copy_add1", "benchmarks/call_scaling_bench.py:46",
              both(copy_row), copy_row["bytes"], plain["copy_add1"],
              both(torch_row), turns=ring["copy_add1"],
              turns_2e20=ring["copy_add1 2^20"], host_us=host["copy_add1"],
              host_us_torch=host["x + 1"],
              host_us_launcher=host["copy's bare launcher"],
              also_replaces=["benchmarks/dma_floor_bench.py:53",
                             "benchmarks/phase_restructure_bench.py:62"]),
        entry("copy_pm_add1", "benchmarks/dma_floor_bench.py:73",
              both(row("dma_floor", f"copy contiguous N={PROBE_N}")),
              copy_row["bytes"], plain["copy_pm_add1"],
              (library["copy_pm_add1"],
               library["copy_pm_add1 back to back"]),
              turns=ring["copy_pm_add1"], host_us=host["copy_pm_add1"]),
        entry("outputs_floor", "benchmarks/dma_floor_bench.py:93",
              both(floor_row), floor_row["bytes"], plain["outputs_floor"],
              None, floor_ratio=floor_ratio,
              floor_ratio_lone=floor_ratio_lone, chain_ms=chain_ms,
              chain_ms_back_to_back=chain_ms_b2b,
              bound_ms_int16_in=bound(0, bytes_int16)[0]),
        entry("phase_major", "benchmarks/phase_restructure_bench.py:66",
              (relayout["ms"], relayout["ms_back_to_back"]),
              relayout["bytes"], relayout["plain_ms"],
              (relayout["library_ms"], relayout["library_ms_back_to_back"]),
              stage_ms=relayout["stage_ms"],
              stage_ms_back_to_back=relayout["stage_ms_back_to_back"],
              ifir_launches=relayout["launches"],
              share_of_ifir=relayout["share_of_ifir"],
              roundtrip={"ms": rt_row["lone_ms"],
                         "ms_back_to_back": rt_row["ms"],
                         "bytes": rt_row["bytes"],
                         "bound_ms": bound(0, rt_row["bytes"])[0],
                         "bound_by": "bytes",
                         "max_abs_err": errs["phase_major"],
                         "plain_ms": plain["pm_roundtrip_add1"],
                         "library_ms": library["x + 1"],
                         "library_ms_back_to_back":
                             library["x + 1 back to back"],
                         "launches": launches["pm_roundtrip_add1"],
                         "turns": ring["pm_roundtrip_add1"]}),
        entry("select_pm_add1", "benchmarks/phase_restructure_bench.py:74",
              both(sel_rows["HIGHEST"]), sel_rows["HIGHEST"]["bytes"],
              plain["select_pm_add1"],
              (library["select_pm_add1"],
               library["select_pm_add1 back to back"]),
              flop=2 * flop_sel, peak=PEAK_TF32,
              turns=ring["select_pm_add1 HIGHEST"],
              precision={"DEFAULT": dict(select["default"],
                                         ms=sel_rows["DEFAULT"]["lone_ms"],
                                         ms_back_to_back=sel_rows[
                                             "DEFAULT"]["ms"],
                                         turns=ring["select_pm_add1 DEFAULT"],
                                         bound_ms=bound(
                                             flop_sel,
                                             sel_rows["DEFAULT"]["bytes"],
                                             PEAK_TF32)[0])}),
    ]
    # phase_major's launches are the IFIR envelope's (phase 16)
    out[3]["launches"] = sum(relayout["launches"].values())
    for e in out + [dict(out[3]["roundtrip"], name="pm_roundtrip_add1")]:
        b, lone, b2b = e["bound_ms"], e["library_ms"], e[
            "library_ms_back_to_back"]
        lib = "none" if lone is None else (
            f"{lone:.4f} lone, {b2b:.4f} back to back (the kernel "
            f"{100 * (e['ms'] / lone - 1):+.1f} %, "
            f"{100 * (e['ms_back_to_back'] / b2b - 1):+.1f} %)")
        print(f"  {e['name']}: {e['ms']:.4f} ms lone, "
              f"{e['ms_back_to_back']:.4f} back to back; bound {b:.4f} ms "
              f"({e['bound_by']}, {100 * b / e['ms']:.1f} %, "
              f"{100 * b / e['ms_back_to_back']:.1f} %), plain "
              f"{e['plain_ms']:.4f}, library {lib}, launches "
              f"{e['launches']}  [{card}]")
    return out


# -- phase 19: the examples ---------------------------------------------------

EX_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "examples_torch")
EX_DETECT_SECONDS = 90.0     # each detect WAV: one interior chunk at 48 kHz
EX_PLUGINS = ("audianplugins", "audianexample")
EX_TONE = 440.0              # Hz, channel 0 of the plugins' recording
EX_SECONDS = 10.0            # the plugins' recording
EX_REGION = (1.0, 3.0)       # s, the analyzed region
TOL_EX_ZC = 0.1              # the zero-crossing rate, relative to the tone


def load_example(name):
    """``examples_torch/<name>.py`` as a module (not run as a script)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EX_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def batch_modes(bp, x, paths, device):
    """The batch twin's three modes on ``device``.  Returns their outputs
    and each mode's seconds (host clock, ended by a synchronize)."""
    out, secs = {}, {}
    for mode, arg in (("fused_single_chip", x),
                      ("sharded_whole_recording", x),
                      ("detect_directory", paths)):
        a = time.perf_counter()
        out[mode] = getattr(bp, mode)(arg, device)
        torch.cuda.synchronize()
        secs[mode] = time.perf_counter() - a
    return out, secs


def examples_phase(card, dev):
    """Phase 19: the example twins of ``examples_torch/`` on the card.
    The batch twin's three modes on ``dev`` against the same modes with
    ``device="cpu"`` (the plain versions), the launch counters zeroed just
    before and read just after the card's run; the two plugin twins, each
    from a launch directory of its own (both add a trace named
    ``envelope``), in a browser on ``dev``.  Returns each kernel's
    launches on the batch modes."""
    from audian_torch.analysis import Plugins
    from audian_torch.app import DataBrowser
    from audian_torch.data import wavio
    from audian_torch.ops.cuda.chain import chain
    from audian_torch.ops.cuda.envdet import envdet
    from audian_torch.ops.cuda.window_matmul import window_matmul

    t_phase = time.perf_counter()
    bp = load_example("batch_pipeline")
    x = bp.make_recording()
    print(f"phase 19: the examples ({EX_DIR}); the batch twin on "
          f"{x.shape[0] / bp.RATE:g} s x {x.shape[1]} ch at {bp.RATE:g} Hz "
          f"and two {EX_DETECT_SECONDS:g} s WAVs, on {dev} and on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(2):
            p = os.path.join(tmp, f"detect{i}.wav")
            wavio.write_audio(p, bp.make_recording(EX_DETECT_SECONDS,
                                                   seed=i + 1),
                              bp.RATE, encoding="PCM_16")
            paths.append(p)
        counters = {"chain": chain, "window_matmul": window_matmul,
                    "envdet": envdet}
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        got, secs = batch_modes(bp, x, paths, dev)
        launches = {k: c.launches for k, c in counters.items()}
        want, secs_cpu = batch_modes(bp, x, paths, "cpu")
        print(f"  launches on the card's run: {launches}")
        require(launches["chain"] > 0, "the batch twin launched chain")
        require(launches["envdet"] > 0, "the batch twin launched envdet")

        # fused_single_chip: (filtered, envelope, psd, stats)
        y, e, s, _ = got["fused_single_chip"]
        yc, ec, sc, _ = want["fused_single_chip"]
        require(y.device == dev, f"fused outputs on {y.device}")
        ey, ee = max_abs(y.cpu(), yc), max_abs(e.cpu(), ec)
        es = psd_db_err(s.cpu(), sc)
        require(ey <= TOL_FILTERED, f"fused filtered vs CPU {ey}")
        require(ee <= TOL_ENVELOPE, f"fused envelope vs CPU {ee}")
        require(es <= TOL_PSD_DB, f"fused PSD vs CPU {es} dB")
        print(f"  fused_single_chip vs CPU: filtered {ey:.3e}, envelope "
              f"{ee:.3e}, PSD {es:.5f} dB")
        # sharded_whole_recording: filtered, envelope, minmax, spectrogram
        so, sc_ = got["sharded_whole_recording"], want[
            "sharded_whole_recording"]
        require(set(so) == set(sc_) == {"filtered", "envelope",
                                        "spectrogram", "minmax"},
                f"sharded keys {set(so)}")
        errs = {}
        for key in so:
            g = so[key].cpu()
            require(g.shape == sc_[key].shape and bool(torch.isfinite(
                g).all()), f"sharded {key} shape {tuple(g.shape)}")
            if key == "spectrogram":
                errs[key] = psd_db_err(g, sc_[key])
                require(errs[key] <= TOL_PSD_DB, f"sharded PSD {errs[key]}")
            else:
                errs[key] = max_abs(g, sc_[key])
                require(errs[key] <= TOL_FILTERED,
                        f"sharded {key} {errs[key]}")
        print("  sharded_whole_recording vs CPU: " + ", ".join(
            f"{k} {v:.3e}{' dB' if k == 'spectrogram' else ''}"
            for k, v in errs.items()))
        # detect_directory: (path, onsets per channel)
        worst = 0.0
        for (pg, og), (pc, oc) in zip(got["detect_directory"],
                                      want["detect_directory"]):
            require(pg == pc and len(og) == len(oc) == 2, f"detect {pg}")
            for a, b in zip(og, oc):
                require(len(a) == len(b) > 0, f"{pg}: onsets {a} vs {b}")
                worst = max([worst] + [abs(u - v) for u, v in zip(a, b)])
        require(worst <= TOL_ONSET_S, f"detect onsets off by {worst} s")
        print(f"  detect_directory vs CPU: the same songs, onsets within "
              f"{worst:.4f} s")
        print("  seconds (host clock, first call in this process): " +
              "  ".join(f"{k} {secs[k]:.4f} (CPU {secs_cpu[k]:.4f})"
                        for k in secs) + f"  [{card}]")
        del got, want

        # -- the plugin twins, each in a launch directory of its own
        rate = bp.RATE
        t = np.arange(int(EX_SECONDS * rate)) / rate
        tone = np.stack([0.3 * np.sin(2 * np.pi * EX_TONE * t),
                         0.1 * np.sin(2 * np.pi * 3000.0 * t)], axis=1)
        tone += 0.001 * np.random.default_rng(SEED).standard_normal(
            tone.shape)
        wav = os.path.join(tmp, "tone.wav")
        wavio.write_audio(wav, tone, rate, encoding="PCM_16")
        for name in EX_PLUGINS:
            launch = os.path.join(tmp, name)
            os.mkdir(launch)
            shutil.copy(os.path.join(EX_DIR, f"{name}.py"), launch)
            pl = Plugins()
            pl.load_plugins(launch, verbose=False)
            require(name in pl.plugins, f"the plugin twin {name} loads")
            handed = []
            module = pl.plugins[name]
            if hasattr(module, "DifferenceNode"):
                compute = module.DifferenceNode.compute

                def on_device(node, source, *a, compute=compute):
                    out = compute(node, source, *a)
                    handed.append((source.device, out.device))
                    return out
                module.DifferenceNode.compute = on_device
            b = DataBrowser(wav, plugins=pl, device=dev).open()
            try:
                keys = list(b.data.keys())
                names = [a.name for a in b.analyzers]
                traces = b.analyze(*EX_REGION, 0)
                _tf, yf = traces["filtered"]
                require("envelope" in keys, f"{name}: traces {keys}")
                _te, env = traces["envelope"]
                require(np.isfinite(env).all() and env.max() > 0,
                        f"{name}: the envelope trace")
                line = f"  {name}: traces {keys}, analyzers {names}"
                if name == "audianplugins":
                    rows = next(a for a in b.analyzers
                                if a.name == "zerocrossings").data.rows
                    zc = rows[-1][-1]
                    require(abs(zc - EX_TONE) <= TOL_EX_ZC * EX_TONE,
                            f"zero crossings {zc} Hz")
                    line += f"; zerocrossings {zc:.1f} Hz on {EX_TONE:g} Hz"
                else:
                    require("difference" in keys, f"{name}: traces {keys}")
                    _td, d = traces["difference"]
                    want_d = torch.diff(torch.from_numpy(yf)).numpy()
                    require(np.array_equal(d[1:], want_d),
                            "difference == torch.diff of filtered")
                    require(handed and all(
                        s == dev and o == dev for s, o in handed),
                        f"DifferenceNode computes on {dev}: {handed}")
                    rows = next(a for a in b.analyzers
                                if a.name == "peaks").data.rows
                    i = int(np.argmax(np.abs(yf)))
                    require(rows[-1][-1] == float(yf[i])
                            and rows[-1][-2] == float(_tf[i]),
                            f"peaks {rows[-1]} vs {(_tf[i], yf[i])}")
                    line += (f"; difference == torch.diff(filtered) on "
                             f"{len(d)} samples, computed on "
                             f"{handed[0][1]}; peak {rows[-1][-1]:.4f} at "
                             f"{rows[-1][-2]:.4f} s")
                print(line)
            finally:
                b.close()
    print(f"  phase wall {time.perf_counter() - t_phase:.2f} s  [{card}]")
    return launches


# -- phase 20: the graph's causal FIR kernel ---------------------------------

FIR_FRAMES = 5_770_000   # the scrub's recomputed window: 60 s, its halos
FIR_HELD = ((0, 0), (9, 2_900_000), (15, FIR_FRAMES - (1 << 16)))
FIR_HELD_LEN = 1 << 16   # samples of each (channel, start) held slice
FIR_EDGES = ((1000, 3), (16384, 2), (16385, 2), (50_000, 1))


def fir_f64(src, h, c, start, length):
    """The causal FIR in float64 (scipy) of channel ``c`` of the stream
    ``src`` (n, C) over ``[start, start + length)``, zero history."""
    T = len(h)
    lo = max(start - T + 1, 0)
    seg = src[lo:start + length, c].double().cpu().numpy()
    y = sps.oaconvolve(seg, np.asarray(h, np.float64))
    return y[start - lo:start - lo + length]


def fir_phase(card, dev, ia_fir):
    """Phase 20: ``csrc/fir.cu`` (``audian_torch.ops.cuda.fir``) at the
    scrub's two designs extended past their decay, the 2-40 kHz band-pass
    to 1024 taps and the 500 Hz envelope to 4096 (on the rectified
    stream), at a 50 Hz high-pass of 32768 taps (eight launches of 4096)
    and at the band-pass the scrub runs (256 taps), on 16 ch x 5.77 M
    frames: against the plain twin (cuDNN's fp32 ``conv1d``,
    ``_fir_valid_cf``) and float64 slices at the stream's start, middle and
    ragged end; DEFAULT (one pass) within 1e-2 of scale; short and ragged
    streams, a column slice (rows 16 words apart); 8 calls back to back and
    a lone call (the probes' ``measure``) beside the 3xTF32 bound of every
    tap and the plain twin's time.  Then ``entry()``, the detector's
    exact envelope (``events._band_env_device``) and the heterodyne
    playback (``prepare_playback``) with the kernel under them, against
    scipy float64, each FIR call launched.  Returns the kernels line's
    entry, whose ``launches`` are the main path's, ``ia_fir`` (phases 10
    and 11: the cutoff scrub and a full-window recompute)."""
    from audian_torch.analysis import events
    from audian_torch.entry import entry
    from audian_torch.ops import sos as sosmod
    from audian_torch.ops.cuda import fir as firmod
    from audian_torch.ops.design import (FilterDesign,
                                         design_envelope_filter,
                                         design_filter)
    from audian_torch.ops.mix import prepare_playback
    from audian_torch.probes._common import measure

    print(f"phase 20: the graph's FIR kernel at {C} ch x {FIR_FRAMES} frames")
    fir = firmod.fir
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = 0.3 * torch.randn((FIR_FRAMES, C), generator=gen, device=dev)
    band = design_filter(RATE, 2000.0, 40000.0, 2)
    # the kernel at 1024, 4096 and 32768 taps (designs extended exactly
    # past their decay, one launch, one and eight), then the scrub's own
    # 256-tap band-pass
    designs = (
        ("filter", FilterDesign.from_sos(band, pad_to=1024).fir.h, x),
        ("envelope", FilterDesign.from_sos(design_envelope_filter(
            RATE, 500.0), pad_to=4096).fir.h, (math.pi / 2) * x.abs()),
        ("long", FilterDesign.from_sos(design_filter(RATE, 50.0, None, 2),
                                       pad_to=32768).fir.h, x),
        ("scrub_filter", FilterDesign.from_sos(band).fir.h, x))
    entry_out = {"name": "fir", "route": "cuda",
                 "source": "audian_torch/csrc/fir.cu",
                 "replaces": "none (cuDNN's conv1d under sosfilt_fir)",
                 "launch_taps": firmod.LAUNCH_TAPS, "designs": {}}
    launches0 = fir.launches
    for name, h, src in designs:
        T = len(h)
        nl = len(firmod.slices(T))
        l0 = fir.launches
        got = fir(src, h)
        require(fir.launches - l0 == nl,
                f"fir {name}: {fir.launches - l0} launches, not {nl}")
        plain = sosmod._fir_valid_cf(
            torch.nn.functional.pad(src.T, (T - 1, 0)), h).T
        torch.cuda.synchronize()
        scale = float(plain.abs().max())
        err_plain = max_abs(got, plain)
        one = fir(src, h, "default")
        err64 = err_dc = 0.0
        for c, start in FIR_HELD:
            want = torch.from_numpy(fir_f64(src, h, c, start, FIR_HELD_LEN))
            rows = slice(start, start + FIR_HELD_LEN)
            err64 = max(err64, max_abs(got[rows, c].cpu(), want))
            err_dc = max(err_dc, max_abs(one[rows, c].cpu(), want))
        require(err_dc <= TOL_DEFAULT * scale,
                f"fir {name} DEFAULT {err_dc} (scale {scale})")
        require(err64 <= TOL_FILTERED * scale,
                f"fir {name} vs float64 {err64} (scale {scale})")
        require(err_plain <= TOL_FILTERED * scale,
                f"fir {name} vs plain {err_plain} (scale {scale})")
        print(f"  {name} ({T} taps, {nl} launches): max_abs_err vs float64 "
              f"{err64:.3e}, vs the plain twin {err_plain:.3e}, DEFAULT "
              f"{err_dc:.3e} (scale {scale:.3e})")
        del plain, one
        flop = 2.0 * T * FIR_FRAMES * C
        nbytes = 2 * 4 * FIR_FRAMES * C
        row = measure("fir", f"fir {name}", lambda: fir(src, h), nbytes,
                      FIR_FRAMES, dev)
        bound_tc_ms = 1e3 * max(3 * flop / PEAK_TF32, nbytes / PEAK_BYTES)
        plain_ms = median_ms(lambda: sosmod._fir_valid_cf(
            torch.nn.functional.pad(src.T, (T - 1, 0)), h), dev, reps=3)
        print(f"  {name}: kernel {row['ms']:.4f} ms back to back ({CALLS} "
              f"calls), lone {row['lone_ms']:.4f} ms; 3xTF32 bound of every "
              f"tap {bound_tc_ms:.4f} ms ({100 * bound_tc_ms / row['ms']:.1f}"
              f" % reached back to back, {flop * 3 / row['ms'] / 1e9:.1f} "
              f"TFLOP/s); plain twin (cuDNN) {plain_ms:.4f} ms  [{card}]")
        entry_out["designs"][name] = {
            "taps": T, "launches": nl, "max_abs_err": err64, "max_abs_err_plain": err_plain,
            "max_abs_err_default": err_dc, "ms": row["lone_ms"],
            "ms_back_to_back": row["ms"], "bound_tc_ms": bound_tc_ms,
            "bound_share": bound_tc_ms / row["lone_ms"],
            "bound_share_back_to_back": bound_tc_ms / row["ms"],
            "plain_ms": plain_ms}
    # short and ragged streams, a column slice whose rows lie 16 words apart,
    # with one launch and with eight
    for name, h, _ in designs[1:3]:
        T = len(h)
        for n, c in FIR_EDGES:
            for label, src in (("contiguous", x[:n, :c].contiguous()),
                               ("column slice", x[:n, 4:4 + c])):
                got = fir(src, h)
                want = sosmod._fir_valid_cf(
                    torch.nn.functional.pad(src.T, (T - 1, 0)), h).T
                torch.cuda.synchronize()
                err = max_abs(got, want)
                require(got.shape == (n, c) and err <= TOL_FILTERED * max(
                    float(want.abs().max()), 1e-30),
                    f"fir {name} {n} x {c} {label}: {err}")
        print(f"  {name}: {', '.join(f'{n} x {c}' for n, c in FIR_EDGES)} "
              f"(frames x ch, contiguous and column slice) within "
              f"{TOL_FILTERED:g} of the plain twin")
    del x, designs
    # entry(): the filter and the envelope's two passes
    step, (xe, filt, env) = entry(dev)
    l0 = fir.launches
    out = step(xe, filt, env)
    torch.cuda.synchronize()
    require(fir.launches - l0 == 3, f"entry() launched fir "
            f"{fir.launches - l0} times, not 3")
    x64 = xe.double().cpu().numpy()
    y64 = sps.sosfilt(filt.sos, x64, axis=0)
    e64 = np.maximum(sps.sosfiltfilt(env.sos, (np.pi / 2) * np.abs(y64),
                                     axis=0, padlen=env.padlen), 0.0)
    for key, want in (("filtered", y64), ("envelope", e64)):
        err = float(np.abs(out[key].double().cpu().numpy() - want).max())
        scale = float(np.abs(want).max())
        require(err <= TOL_FILTERED * scale, f"entry() {key} {err}")
        print(f"  entry() {key}: max_abs_err vs scipy {err:.3e} (scale "
              f"{scale:.3e})")
    # the detector's exact envelope on 20 s x 4 ch of planted songs
    pcm = np.ascontiguousarray(song_recording(np.random.default_rng(1),
                                              DETECT_SECONDS)[:20 * 96000, :4])
    fdes = FilterDesign.from_sos(sps.butter(1, DETECT_BAND, "bandpass",
                                            fs=RATE, output="sos"))
    edes = FilterDesign.from_sos(sps.butter(1, DETECT_ENV, "lowpass",
                                            fs=RATE, output="sos"))
    l0 = fir.launches
    y, e = events._band_env_device(fdes, edes, torch.from_numpy(pcm).to(dev))
    torch.cuda.synchronize()
    require(fir.launches - l0 == 4, f"the detector's envelope launched fir "
            f"{fir.launches - l0} times, not 4")
    y64, e64 = events.detect_env_oracle(pcm / 32768.0, 1, fdes, edes)
    for key, got, want in (("filtered", y, y64), ("envelope", e, e64)):
        err = float(np.abs(got.double().cpu().numpy() - want).max())
        scale = float(np.abs(want).max())
        require(err <= TOL_DETECT * scale, f"detector {key} {err}")
        print(f"  detector exact {key}: max_abs_err vs scipy {err:.3e} "
              f"(scale {scale:.3e})")
    # the heterodyne playback of the same window
    xp = torch.from_numpy(pcm / 32768.0).to(dev, torch.float32)
    l0 = fir.launches
    play, prate = prepare_playback(xp, RATE, use_heterodyne=True,
                                   heterodyne_freq=BR_HETERODYNE, device=dev)
    torch.cuda.synchronize()
    require(fir.launches - l0 == 2, f"playback launched fir "
            f"{fir.launches - l0} times, not 2")
    want, wrate = playback_f64(xp.cpu().numpy(), RATE, BR_HETERODYNE)
    err = float(np.abs(play.double().cpu().numpy() - want).max())
    scale = float(np.abs(want).max())
    require(prate == wrate and err <= TOL_PLAY * scale, f"playback {err}")
    print(f"  heterodyne playback: max_abs_err vs numpy float64 {err:.3e} "
          f"(scale {scale:.3e})")
    entry_out["launches"] = ia_fir["scrub"] + ia_fir["recompute"]
    entry_out["interactive_launches"] = ia_fir
    entry_out["phase20_launches"] = fir.launches - launches0
    print(f"  fir launches on the main path (phases 10-11) "
          f"{entry_out['launches']} {ia_fir}, in phase 20 "
          f"{entry_out['phase20_launches']}")
    return entry_out


# -- phase 21: the graph's spectrogram on window_matmul -----------------------

STFT_SECONDS = 60        # the scrub's window
STFT_NFFTS = (64, 256, 1024)
STFT_HELD = 2 * 96000    # samples of channel 0 held against scipy float64


def stft_phase(card, dev, ia_stft):
    """Phase 21: ``SpectrogramNode.compute`` on the kernel route of
    ``ops/stft.py`` (one ``window_matmul`` over the analysis bank) on a
    60 s x 16 ch float32 window at each of :data:`STFT_NFFTS`, hop NFFT/2
    and one overhanging tail frame: the ``stft`` tag and the launch, the
    tail zero, against the plain twin over bins within 60 dB of the peak
    and scipy float64 on 2 s of channel 0; CUDA-event ms of the node, of
    its time-first stream's relayout and its window product alone, and of
    the plain twin (the framed copy and cuBLAS's fp32 product, and the
    tail's cat), beside the product's
    3xTF32 bound.  Returns window_matmul's ``graph_stft`` entry, with the
    main path's record ``ia_stft`` (phases 10-11)."""
    from audian_torch.graph import SpectrogramNode, TraceSpec
    from audian_torch.ops import stft
    from audian_torch.ops.cuda.window_matmul import window_matmul
    from audian_torch.ops.raw16 import dequant16
    from audian_torch.utils import trace

    x = dequant16(torch.from_numpy(interactive_recording(
        STFT_SECONDS, C, dev)).to(dev))
    n = x.shape[0]
    print(f"phase 21: the graph's spectrogram on window_matmul, {C} ch x {n} "
          f"frames float32")
    out = {"main_path": ia_stft, "nfft": {}}
    for nfft in STFT_NFFTS:
        node = SpectrogramNode(nfft=nfft, overlap_frac=0.5)
        node.open(TraceSpec(rate=RATE, channels=C, frames=n))
        hop, nbins = node.hop, nfft // 2 + 1
        window = node.upload(node.params(), dev)
        nf = stft.num_frames(n, nfft, hop)
        n_out = nf + 1
        l0 = window_matmul.launches
        trace.clear()
        trace.enable(log=False)
        try:
            with trace.timed("graph.node", node="spectrogram"):
                got = node.compute(x, 0, n_out, window)
            torch.cuda.synchronize()
            tag = ",".join(e.get("stft", "") for e in trace.events())
        finally:
            trace.disable()
            trace.clear()
        launches = window_matmul.launches - l0
        require(tag == "kernel" and launches == 1,
                f"spectrogram NFFT {nfft}: stft={tag}, {launches} launches")
        require(got.shape == (n_out, C, nbins) and not got[nf:].any(),
                f"spectrogram NFFT {nfft}: shape {tuple(got.shape)}, the "
                f"tail frame zero")

        def plain():
            s = stft._plain_spectrogram(x, RATE, nfft, hop, window, False,
                                        "matmul")
            return torch.cat([s, s.new_zeros((1,) + s.shape[1:])])

        err = psd_db_err(got[:nf], plain()[:nf])
        _, _, ss = sps.spectrogram(x[:STFT_HELD, 0].double().cpu().numpy(),
                                   fs=RATE, window="hann", nperseg=nfft,
                                   noverlap=nfft - hop, detrend=False,
                                   scaling="density", mode="psd")
        want = torch.from_numpy(ss.T)
        err64 = psd_db_err(got[:want.shape[0], 0].cpu(), want)
        require(err <= TOL_PSD_DB and err64 <= TOL_PSD_DB,
                f"spectrogram NFFT {nfft}: {err} dB vs plain, {err64} dB vs "
                f"float64")
        del got
        bank, split = stft._device_bank(
            nfft, RATE, np.asarray(window, np.float64).tobytes(), x.device)
        xc = x.T.contiguous()
        node_ms = median_ms(lambda: node.compute(x, 0, n_out, window), dev)
        relayout_ms = median_ms(lambda: stft._channels_first(x), dev)
        wm_ms = median_ms(lambda: window_matmul(xc, bank, hop, nf,
                                                split=split), dev)
        plain_ms = median_ms(plain, dev, reps=3)
        del xc
        flop = 2.0 * nf * C * nfft * 2 * nbins
        nbytes = 4.0 * (n * C + nf * C * 2 * nbins)
        bound_tc_ms = 1e3 * max(3 * flop / PEAK_TF32, nbytes / PEAK_BYTES)
        print(f"  NFFT {nfft} hop {hop} ({nf} frames): stft={tag}, "
              f"{launches} launch; vs plain {err:.3e} dB, vs float64 "
              f"{err64:.3e} dB; node {node_ms:.4f} ms (relayout "
              f"{relayout_ms:.4f}, window product {wm_ms:.4f}, 3xTF32 bound "
              f"{bound_tc_ms:.4f}, {100 * bound_tc_ms / wm_ms:.1f} %), "
              f"plain twin {plain_ms:.4f} ms  [{card}]")
        out["nfft"][nfft] = {
            "hop": hop, "frames": nf, "stft": tag, "launches": launches,
            "psd_db_err_plain": err, "psd_db_err_f64": err64,
            "ms": node_ms, "relayout_ms": relayout_ms,
            "window_matmul_ms": wm_ms, "plain_ms": plain_ms,
            "bound_tc_ms": bound_tc_ms, "bound_share": bound_tc_ms / wm_ms}
    print(f"  main path (phases 10-11): window_matmul {ia_stft}")
    return out


def main():
    # -- phase 0: the card ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: card {card}")
    print(f"  torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"python {sys.version.split()[0]}  device {kind}")
    dev = torch.device("cuda", 0)

    from audian_torch import native
    from audian_torch.analysis import events
    from audian_torch.cli import songdetector
    from audian_torch.data.wavio import read_frames_raw16, wav_info
    from audian_torch.models import get_preset
    from audian_torch.ops.cuda import _build, probes
    from audian_torch.ops.cuda.chain import TILES as CHAIN_TILES
    from audian_torch.ops.cuda.chain import WARPS as CHAIN_WARPS
    from audian_torch.ops.cuda.chain import (ALL_OUTPUTS, TAP_PAD, chain,
                                             chain_plain)
    from audian_torch.ops.cuda.envdet import TILE_MAX as ENVDET_TILE_MAX
    from audian_torch.ops.cuda.envdet import TILE_MIN as ENVDET_TILE_MIN
    from audian_torch.ops.cuda.envdet import (EnvDetKernel, envdet,
                                              envdet_plain)
    from audian_torch.ops.cuda.envdet import smem_bytes as envdet_smem_bytes
    from audian_torch.ops.cuda.window_matmul import plan as wm_plan
    from audian_torch.ops.cuda.window_matmul import (BankSplit, split_w,
                                                     window_matmul,
                                                     window_matmul_plain)
    from audian_torch.ops.design import (FilterDesign,
                                         design_envelope_filter,
                                         design_filter)
    from audian_torch.ops.envdet import EnvDet
    from audian_torch.ops.fused import FusedChainCF
    from audian_torch.ops.raw16 import dequant16

    # -- phase 1: build ------------------------------------------------------
    # the native host library (g++) builds on a thread beside the kernels
    # (nvcc); the card run requires it: no numpy fallback here
    native_build = {}

    def build_native():
        a = time.perf_counter()
        native_build["ok"] = native.available()
        native_build["s"] = time.perf_counter() - a

    native_thread = threading.Thread(target=build_native)
    t0 = time.perf_counter()
    native_thread.start()
    lib = _build.load_library()
    print(f"phase 1: built {_build.build_dir()} in "
          f"{time.perf_counter() - t0:.2f} s")
    native_thread.join()
    require(native_build["ok"], "the native host library builds")
    print(f"  native host library {native.build_dir()} built in "
          f"{native_build['s']:.2f} s")
    report = _build.ptxas_report()
    for line in kernel_resources(report):
        print("  " + line)
    # chain and envdet on warpgroup MMAs: no spill, no wgmma that ptxas
    # serialized, and HGMMA (not HMMA) in their SASS
    health = wgmma_health(report)
    sass = sass_mma_counts(_build.library_path())
    for name in WGMMA_KERNELS:
        h = health[name]
        # every template instance (window_matmul's column widths)
        inst = [v for k, v in sass.items()
                if k == name or k.startswith(name + "<")]
        hg, hm = sum(v[0] for v in inst), sum(v[1] for v in inst)
        print(f"  {name}: {h['registers']} registers, {h['spill_bytes']} "
              f"spill bytes, wgmma serialized: {h['serialized']}, waits "
              f"injected by ptxas: {h['injected_waits']}; SASS HGMMA {hg}  "
              f"HMMA {hm} over {len(inst)} instance(s)")
        require(h["registers"] is not None, f"ptxas reported {name}")
        require(h["spill_bytes"] == 0, f"{name} spills no register")
        require(not h["serialized"], f"ptxas serializes no wgmma of {name}")
        require(inst and all(v[0] > 0 for v in inst),
                f"every instance of {name} runs HGMMA")
        require(hm == 0, f"{name} runs no warp-level HMMA")
    for name, (hg, hm, *_) in sorted(sass.items()):
        if not any(name == k or name.startswith(k + "<")
                   for k in WGMMA_KERNELS):
            print(f"  {name}: SASS HGMMA {hg}  HMMA {hm}")
    # the probes' copies and relayouts: no spill either
    for name, h in wgmma_health(report, PROBE_KERNELS).items():
        print(f"  {name}: {h['registers']} registers, {h['spill_bytes']} "
              f"spill bytes")
        require(h["registers"] is not None, f"ptxas reported {name}")
        require(h["spill_bytes"] == 0, f"{name} spills no register")
    # the copies' one kernel streams device memory in 16-byte words
    ldg, stg = sass.get(COPY_KERNEL, (0,) * 5)[3:]
    print(f"  {COPY_KERNEL}: SASS LDG.E.128 {ldg}  STG.E.128 {stg}")
    require(ldg > 0 and stg > 0, f"{COPY_KERNEL} loads and stores 16-byte "
            f"words (LDG.E.128 and STG.E.128 in its SASS)")
    # the round trip and the selection products on their bulk-copy rings:
    # every instance copies in bulk
    for name in RING_KERNELS:
        inst = [v for k, v in sass.items()
                if k == name or k.startswith(name + "<")]
        print(f"  {name}: SASS bulk copies "
              f"{[v[2] for v in inst]} over {len(inst)} instance(s)")
        require(inst and all(v[2] > 0 for v in inst),
                f"every instance of {name} issues bulk copies")

    # -- phase 1b: the convolution core --------------------------------------
    print("phase 1b: the wgmma convolution core on known convolutions")
    core_err = core_phase(lib, dev)
    core_rates = core_rate(lib, dev)

    # -- phase 2: window_matmul ----------------------------------------------
    print("phase 2: window_matmul kernel vs plain at 16 ch x 2^20")
    gen = torch.Generator().manual_seed(SEED)
    bio = get_preset("bioacoustics").fused(RATE, eps=2e-6, device=dev)
    bio_sos = design_filter(RATE, 2000.0, 40000.0)
    us384 = get_preset("ultrasound").fused(384000.0, eps=2e-6, device=dev)
    n_wm = 1 << 20
    x_wm = (0.3 * torch.randn((C, n_wm), generator=gen)).to(dev)

    def stage_cases(fc, label):
        xf = torch.nn.functional.pad(x_wm, (fc.filt_halo, 0))
        xe = torch.nn.functional.pad(x_wm, (fc.env_halo, fc.env_delay))
        B = fc.block
        return [
            (f"{label} filter", xf, fc.filt_w, B, -(-n_wm // B), None, "cf"),
            (f"{label} envelope", xe, fc.env_w, B,
             -(-(n_wm + fc.env_delay) // B), "rectify", "cf"),
            (f"{label} psd", x_wm, fc.spec_w, fc.hop,
             (n_wm - fc.nfft) // fc.hop + 1, None, "fco"),
        ]

    # the IFIR envelope's two stages (phase 16's design) and EnvDet's two
    # stages (phase 7's design: the int16 band-pass, the decimating
    # envelope at stride 128 x 19) on the same stream
    ifir = FusedChainCF(RATE, env_sos=design_envelope_filter(RATE, IFIR_ENV),
                        eps=IFIR_EPS, ifir=True, device=dev)
    a_args, to_pm, b_args, _ = ifir_stages(ifir, x_wm)
    u_pm = to_pm(window_matmul_plain(*a_args[:4], premap=a_args[4],
                                     out_layout=a_args[5])).contiguous()
    det = EnvDet(FilterDesign.from_sos(sps.butter(
        1, DETECT_BAND, "bandpass", fs=RATE, output="sos")),
        FilterDesign.from_sos(sps.butter(1, DETECT_ENV, "lowpass", fs=RATE,
                                         output="sos")),
        19, 256, 4096, device=dev)
    q_wm = int16_chunk(gen, (C, n_wm), dev)
    x3 = x_wm[:3, : 50001].contiguous()
    cases = stage_cases(bio, "bioacoustics") + stage_cases(
        us384, "ultrasound-384k") + [
        ("hop-90 psd", x_wm, bio.spec_w, 90, (n_wm - 256) // 90 + 1, None,
         "fco"),
        ("IFIR stage A", *a_args), ("IFIR stage B", u_pm, *b_args),
        ("EnvDet band-pass", q_wm, det.w_bp, 128, n_wm // 128, "dequant",
         "cf"),
        ("EnvDet decimating envelope", x_wm, det.b2, 128 * 19,
         (n_wm - det.b2.shape[0]) // (128 * 19) + 1, "square", "fco"),
        ("C = 1 envelope", x_wm[:1].contiguous(), bio.env_w, 128, 300,
         "rectify", "cf"),
        ("C = 3 filter, ragged tail", x3, bio.filt_w, 128, 400, None, "fco"),
        ("C = 3 int16 psd, ragged tail", q_wm[:3, : 70001].contiguous(),
         bio.spec_w, 128, 600, "dequant", "fco"),
        ("nframes below one tile", x_wm[:2].contiguous(), bio.spec_w, 128,
         37, None, "fco"),
    ]
    wm_err = 0.0
    wm_times = {}
    for label, x, w, S, nfr, pm, lay in cases:
        got = window_matmul(x, w, S, nfr, premap=pm, out_layout=lay)
        want = window_matmul_plain(x, w, S, nfr, premap=pm, out_layout=lay)
        torch.cuda.synchronize()
        err = max_abs(got, want)
        scale = float(want.abs().max())
        require(err <= TOL_WINDOW * scale, f"window_matmul {label} {err}")
        wm_err = max(wm_err, err)
        p = wm_plan(w.shape[0], w.shape[1], S, x.element_size())
        wm_times[label] = (x, w, S, nfr, pm, lay)
        print(f"  {label}: x {tuple(x.shape)} {x.dtype} K={w.shape[0]} "
              f"O={w.shape[1]} S={S} frames={nfr} ({p.mode} mode, "
              f"{p.ncb} x {p.N} columns, {p.ring} stages) max_abs_err "
              f"{err:.3e} (scale {scale:.3e})")
        require(lib.window_matmul_smem_bytes(
            w.shape[0], w.shape[1], S, x.element_size(), p.N,
            ("span", "rows").index(p.mode), p.lsh, p.nbuf, p.ring, 0)
            == p.smem <= _build.SMEM_LIMIT, "shared-memory formula agrees")
    # a NaN and an infinity on a stage's input (stage B's, which stage A
    # makes on the card; the rectified envelope's, which the filter makes)
    # leave exactly the outputs the plain version leaves non-finite
    u_bad = u_pm[:24].clone()
    xe_bad = x3.clone()
    for t, r, col in ((u_bad, 0, 100), (u_bad, 17, 3000), (xe_bad, 0, 1000),
                      (xe_bad, 2, 49000)):
        t[r, col] = float("nan")
    u_bad[5, 2000] = xe_bad[1, 20000] = float("inf")
    # (and at each rung window_matmul takes: DEFAULT is its own instance)
    for label, x, w, S, nfr, pm, lay in (
            ("IFIR stage B, NaN and inf on its input", u_bad, *b_args),
            ("bioacoustics envelope, NaN and inf on its input", xe_bad,
             bio.env_w, 128, 400, "rectify", "cf")):
        want = window_matmul_plain(x, w, S, nfr, premap=pm, out_layout=lay)
        bad = ~torch.isfinite(want)
        scale = float(want[~bad].abs().max())
        for prec, tol in (("highest", TOL_WINDOW), ("default", TOL_DEFAULT)):
            got = window_matmul(x, w, S, nfr, premap=pm, out_layout=lay,
                                precision=prec)
            torch.cuda.synchronize()
            require(bool(bad.any())
                    and torch.equal(~torch.isfinite(got), bad),
                    f"window_matmul {label} at {prec}: the plain version's "
                    f"non-finite outputs and no others")
            err = max_abs(got[~bad], want[~bad])
            require(err <= tol * scale, f"window_matmul {label} {prec} {err}")
            if prec == "highest":
                wm_err = max(wm_err, err)
            print(f"  {label}, {prec}: {int(bad.sum())} non-finite outputs "
                  f"as in the plain version; the others max_abs_err "
                  f"{err:.3e} (scale {scale:.3e})")
    del u_pm, q_wm, x3, u_bad, xe_bad
    route_launches = stages_route_check(gen, dev)

    # -- phase 3: chain ------------------------------------------------------
    print("phase 3: chain kernel vs plain at 16 ch x 2^22 int16")
    ck = bio.chain_kernel
    require(ck is not None, "bioacoustics takes the single-pass chain")
    require(lib.chain_smem_bytes(len(ck.h), len(ck.g), ck.delay, ck.lead,
                                 ck.tail, ck.nfft, ck.tile, *ck.modes[:2])
            == ck.smem_bytes <= _build.SMEM_LIMIT,
            "shared-memory formula agrees")
    require(lib.chain_tile_max() == CHAIN_TILES[0], "chain tile")
    require(lib.chain_tap_pad() == TAP_PAD, "chain tap padding")
    require(lib.chain_warps() == CHAIN_WARPS, "chain statistics partials")
    print(f"  tile {ck.tile} outputs ({ck.smem_bytes} B shared)")
    q = int16_chunk(gen, (C, ck.hb + CHUNK + ck.ha), dev)
    chain_err, got_q = check_chain(ck, q, CHUNK, "headline int16")
    got_f = chain(ck, dequant16(q), CHUNK, stats=True)
    for a, b, name in zip(got_q[:3], got_f[:3], ALL_OUTPUTS):
        require(torch.equal(a, b), f"int16 == float32 dequant ({name})")
    for key in got_q[3]:
        require(torch.equal(got_q[3][key], got_f[3][key]),
                f"int16 == float32 dequant ({key})")
    print("  int16 input gives exactly the float32-dequantized outputs")
    del got_f
    n_small = 1 << 18
    qs = q[:, : ck.hb + n_small + ck.ha].contiguous()
    full = chain(ck, qs, n_small, stats=True)
    for r in (1, 2, 3):
        for outputs in itertools.combinations(ALL_OUTPUTS, r):
            got = chain(ck, qs, n_small, stats=True, outputs=outputs)
            for val, ref, name, key in zip(got[:3], full[:3], ALL_OUTPUTS,
                                           ("power", "env_sum", "psd_sum")):
                if name in outputs:
                    require(torch.equal(val, ref), f"mask {outputs} {name}")
                    require(torch.equal(got[3][key], full[3][key]),
                            f"mask {outputs} {key}")
                else:
                    require(val is None, f"mask {outputs} {name} is None")
                    require(not bool(got[3][key].any()),
                            f"mask {outputs} {key} is zero")
    print("  all 7 output masks give the full chain's values")
    e_tail, _ = check_chain(ck, qs, n_small - 640, "padded tail n=2^18-640")
    chain_err = max(chain_err, e_tail)
    # a 24 Hz envelope (14511 taps): its halos take most of a block's
    # shared memory, so the host picks a narrower tile
    long_env = FusedChainCF(RATE, filt_sos=bio_sos,
                            env_sos=design_envelope_filter(RATE, 24.0),
                            device=dev).chain_kernel
    require(long_env is not None and long_env.smem_bytes > 48 * 1024,
            "long-envelope design takes the chain kernel")
    ql = q[:, : long_env.hb + n_small + long_env.ha].contiguous()
    # against a float64 evaluation of the same taps: over this many taps
    # cuDNN's float32 conv1d in the plain version is itself off by several
    # 1e-6, so the plain version is no oracle at the 1e-5 budget here
    ref_y, ref_e = chain_f64(long_env, ql, n_small)
    got = chain(long_env, ql, n_small)
    want = chain_plain(long_env, ql, n_small)
    ky, ke = max_abs(got[0], ref_y), max_abs(got[1], ref_e)
    py, pe = max_abs(want[0], ref_y), max_abs(want[1], ref_e)
    require(ky <= TOL_FILTERED and ke <= TOL_ENVELOPE,
            f"long envelope against float64: {ky} {ke}")
    print(f"  long envelope ({len(long_env.g)} taps, tile {long_env.tile}, "
          f"{long_env.smem_bytes} B shared) against float64: kernel "
          f"filtered {ky:.3e} envelope "
          f"{ke:.3e}; plain filtered {py:.3e} envelope {pe:.3e}")
    chain_err = max(chain_err, ky, ke)
    del got, want, ref_y, ref_e

    # -- phase 4: the main path ----------------------------------------------
    print("phase 4: 60 s x 16 ch x 96 kHz PCM-16 WAV -> chain_cf")
    # TF32 on, as a host program may set it: the port's calls must leave
    # both flags as they find them
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    rng = np.random.default_rng(SEED)
    nfile = int(60 * RATE)
    t = np.arange(nfile) / RATE
    freqs = 3000.0 + 2200.0 * np.arange(C)
    gate = (np.sin(2 * np.pi * 3.0 * t) > 0.3)[:, None]
    pcm = 0.4 * np.sin(2 * np.pi * t[:, None] * freqs[None, :]) * gate
    pcm += 0.05 * rng.standard_normal((nfile, C), dtype=np.float32)
    pcm = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(np.int16)
    us = get_preset("ultrasound").fused(RATE, eps=2e-6, device=dev)
    require(us.chain_kernel is None, "ultrasound takes the per-stage path")
    hb, ha = ck.hb, ck.ha
    span = hb + FILE_CHUNK + ha
    chain.launches = 0
    window_matmul.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.wav")
        scipy.io.wavfile.write(path, int(RATE), pcm)
        info = wav_info(path)
        require(info[:4] == (RATE, C, nfile, "PCM_16"), f"wav_info {info}")
        pinned = [torch.empty((span, C), dtype=torch.int16).pin_memory()
                  for _ in range(2)]
        uploaded = [None, None]
        chunks = []
        for k in range(-(-nfile // FILE_CHUNK)):
            buf = pinned[k % 2]
            if uploaded[k % 2] is not None:
                # the previous upload from this buffer must be done
                # before the host overwrites it
                uploaded[k % 2].synchronize()
            start = k * FILE_CHUNK - hb
            host = buf.numpy()
            host[:] = 0
            lo = max(start, 0)
            got_frames = read_frames_raw16(path, lo, span - (lo - start),
                                           info, host[lo - start:])
            require(got_frames == min(span - (lo - start), nfile - lo),
                    f"chunk {k} read {got_frames} frames")
            dev_raw = buf.to(dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            uploaded[k % 2] = ev
            x_ext = dev_raw.T.contiguous()
            n = min(FILE_CHUNK, nfile - k * FILE_CHUNK)
            y, e, s, st = bio.chain_cf(x_ext, n, stats=True)
            want = chain_plain(ck, x_ext, n, stats=True)
            ey, ee = max_abs(y, want[0]), max_abs(e, want[1])
            es = psd_db_err(s, want[2])
            require(ey <= TOL_FILTERED and ee <= TOL_ENVELOPE
                    and es <= TOL_PSD_DB, f"chunk {k}: {ey} {ee} {es}")
            require(all(bool(torch.isfinite(v).all()) for v in (y, e, s)),
                    f"chunk {k} finite")
            chain_err = max(chain_err, ey, ee)
            print(f"  chunk {k}: n={n} filtered {ey:.3e} envelope {ee:.3e} "
                  f"psd {es:.3e} dB  power[0] {float(st['power'][0]):.6g}")
            chunks.append((k * FILE_CHUNK, y, e, s))
        # chunked against whole over the three chunks
        whole = np.zeros((hb + nfile + ha, C), np.int16)
        whole[hb : hb + nfile] = pcm
        xw = torch.from_numpy(whole).to(dev).T.contiguous()
        yw, ew, sw, _ = bio.chain_cf(xw, nfile, stats=True)
        dc = 0.0
        for j0, y, e, s in chunks:
            n = y.shape[1]
            f0 = j0 // 128
            dc = max(dc, max_abs(y, yw[:, j0 : j0 + n]),
                     max_abs(e, ew[:, j0 : j0 + n]))
            require(psd_db_err(s, sw[f0 : f0 + s.shape[0]]) <= TOL_PSD_DB,
                    "chunked psd == whole")
        require(dc <= TOL_CHUNKED, f"chunked == whole {dc}")
        print(f"  chunked == whole over {len(chunks)} chunks: max {dc:.3e}")
        # the per-stage path (ultrasound preset, hop 256) over the file
        x_file = dequant16(xw[:, hb : hb + nfile].contiguous())
        us_out = us(x_file)
        torch.cuda.synchronize()
    launches = {"chain": chain.launches,
                "window_matmul": window_matmul.launches}

    # scipy float64 oracles on a 2 s slice of one channel across a chunk
    # edge
    a0 = FILE_CHUNK - int(RATE)
    a1 = a0 + 2 * int(RATE)
    # channel 0 carries a 3 kHz tone (inside the bioacoustics band),
    # channel 15 one at 36 kHz (inside the ultrasound preset's 20 kHz
    # high-pass band at this rate)
    cu = C - 1
    chunked0 = [torch.cat([c[i][0] for c in chunks]) for i in (1, 2)]
    chunked0.append(torch.cat([c[3][:, 0] for c in chunks]))
    for label, fc, ch, (y0, e0, s0) in (
            ("bioacoustics chain_cf (chunked)", bio, 0, chunked0),
            ("ultrasound per-stage", us, cu,
             (us_out["filtered"][cu], us_out["envelope"][cu],
              us_out["spectrogram"][:, cu]))):
        pre = get_preset("bioacoustics" if fc is bio else "ultrasound")
        sos_f = design_filter(RATE, pre.highpass_cutoff, pre.lowpass_cutoff)
        sos_e = design_envelope_filter(RATE, pre.envelope_cutoff)
        ys = sps.sosfilt(sos_f, pcm[:, ch].astype(np.float64) / 32768.0)
        es_ = np.maximum(sps.sosfiltfilt(sos_e, (np.pi / 2) * np.abs(ys)), 0)
        ey = float(np.abs(y0[a0:a1].cpu().numpy() - ys[a0:a1]).max())
        ee = float(np.abs(e0[a0:a1].cpu().numpy() - es_[a0:a1]).max())
        hop, nfft = fc.hop, fc.nfft
        f0, f1 = -(-a0 // hop), (a1 - nfft) // hop
        _, _, sx = sps.spectrogram(
            ys[f0 * hop : (f1 - 1) * hop + nfft], fs=RATE, window="hann",
            nperseg=nfft, noverlap=nfft - hop, detrend=False,
            scaling="density", mode="psd")
        sdb = psd_db_err(s0[f0:f1].cpu(), torch.from_numpy(sx.T))
        require(ey <= TOL_FILTERED, f"{label} filtered vs scipy {ey}")
        require(ee <= TOL_ENVELOPE, f"{label} envelope vs scipy {ee}")
        require(sdb <= TOL_PSD_DB, f"{label} psd vs scipy {sdb} dB")
        print(f"  {label} vs scipy float64 (ch {ch}, 2 s): filtered {ey:.3e} "
              f"envelope {ee:.3e} psd {sdb:.3e} dB")
    del yw, ew, sw, us_out, chunks, chunked0, x_file, xw, got_q, full
    require(torch.backends.cuda.matmul.allow_tf32
            and torch.backends.cudnn.allow_tf32,
            "the port's calls left the TF32 flags as they found them")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    print("  both TF32 flags, set on before this phase, are still on")

    # -- phase 5: times ------------------------------------------------------
    print("phase 5: CUDA-event times, median of 5 after a warm-up")
    # window_matmul's figures sum the three bioacoustics stages; the
    # library call is the unfold view times w in one matmul (cuBLAS), on
    # the premapped stream.  Each is timed as a lone call (the host's
    # enqueue in it) and 10 calls back to back (the card's time); where the
    # kernel is slower either way, the line says so
    wm = {"ms": 0.0, "ms_back_to_back": 0.0, "plain_ms": 0.0,
          "library_ms": 0.0, "library_ms_back_to_back": 0.0}
    wm_flop = wm_bytes = 0.0
    wm_stage_ms, wm_stage_b2b, wm_slower = {}, {}, []
    for label, (x, w, S, nfr, pm, lay) in wm_times.items():
        held = BankSplit()

        def run():
            return window_matmul(x, w, S, nfr, pm, lay, split=held)

        k_ms = median_ms(run)
        kb_ms = median_ms(run, calls=WM_CALLS)
        p_ms = median_ms(lambda: window_matmul_plain(x, w, S, nfr, pm, lay))
        need = (nfr - 1) * S + w.shape[0]
        xl = torch.nn.functional.pad(x.float() / (32768.0 if pm == "dequant"
                                                  else 1.0),
                                     (0, max(0, need - x.shape[1])))
        if pm == "rectify":
            xl = (math.pi / 2) * xl.abs()
        elif pm == "square":
            xl = xl * xl

        def lib_call():
            return torch.matmul(xl[:, :need].unfold(1, w.shape[0], S), w)

        l_ms = median_ms(lib_call)
        lb_ms = median_ms(lib_call, calls=WM_CALLS)
        del xl
        f, b = window_matmul_work(x, w, S, nfr)
        b_tc = bound_tc(f, b)
        if label.startswith("bioacoustics"):
            for key, v in (("ms", k_ms), ("ms_back_to_back", kb_ms),
                           ("plain_ms", p_ms), ("library_ms", l_ms),
                           ("library_ms_back_to_back", lb_ms)):
                wm[key] += v
            wm_flop += f
            wm_bytes += b
        wm_stage_ms[label] = k_ms
        wm_stage_b2b[label] = kb_ms
        print(f"  window_matmul {label}: kernel {k_ms:.4f} ms a lone call, "
              f"{kb_ms:.4f} back to back; bound_tc {b_tc:.4f} ms "
              f"({100 * b_tc / k_ms:.1f} %, {100 * b_tc / kb_ms:.1f} %); "
              f"plain {p_ms:.4f} ms; unfold+matmul {l_ms:.4f} ms, "
              f"{lb_ms:.4f} back to back  [{card}]")
        if k_ms > l_ms or kb_ms > lb_ms:
            wm_slower.append(label)
            print(f"  window_matmul {label}: SLOWER than unfold @ w")
    # the host's enqueue of a call (no synchronize inside), over the three
    # bioacoustics stages
    held = {label: BankSplit() for label in wm_times}
    stages = [(wm_times[label], held[label])
              for label in ("bioacoustics filter", "bioacoustics envelope",
                            "bioacoustics psd")]
    wm_host_ms = host_us(lambda: [
        window_matmul(*args, split=split) for args, split in stages],
        calls=20) / 3e3
    print(f"  window_matmul host enqueue {wm_host_ms:.4f} ms a call")
    # w's TF32 split, once per bank (its owner holds it)
    wm_split_ms = {}
    for label in ("bioacoustics envelope", "bioacoustics psd",
                  "ultrasound-384k psd"):
        w = wm_times[label][1]
        wm_split_ms[label] = median_ms(lambda: split_w(w), calls=WM_CALLS)
        print(f"  window_matmul split of the {label} bank {tuple(w.shape)}: "
              f"{wm_split_ms[label]:.4f} ms  [{card}]")
    ch_ms = median_ms(lambda: chain(ck, q, CHUNK, stats=True))
    # back to back, as the probes' floors of phase 18 are timed (the
    # floor ratio's numerator)
    ch_ms_b2b = median_ms(lambda: chain(ck, q, CHUNK, stats=True),
                          calls=CALLS)
    ch_plain_ms = median_ms(lambda: chain_plain(ck, q, CHUNK, stats=True))
    ch_bound = bound(*chain_work(ck, q, CHUNK))
    ch_bound_tc = bound_tc(*chain_work(ck, q, CHUNK))
    print(f"  chain headline chunk 16 x 2^22 int16: kernel {ch_ms:.4f} ms "
          f"a lone call, {ch_ms_b2b:.4f} ms {CALLS} back to back  plain "
          f"{ch_plain_ms:.4f} ms  bound {ch_bound[0]:.4f} ms "
          f"({ch_bound[1]})  bound_tc {ch_bound_tc:.4f} ms  [{card}]")
    # each wrapper's host enqueue of a call (perf_counter, no synchronize
    # inside): the chain at the headline, the copies on a small tensor
    # beside torch's x + 1 on it and the copy's bare launcher (window_matmul
    # above, envdet in phase 9, where its kernel is made)
    x_small = torch.randn((C, HOST_T), generator=gen).to(dev)
    y_small = torch.empty_like(x_small)
    xpm_small = x_small.reshape(1, C, HOST_T)
    host = {
        "chain": host_us(lambda: chain(ck, q, CHUNK, stats=True), calls=20),
        "window_matmul": 1e3 * wm_host_ms,
        "copy_add1": host_us(lambda: probes.copy_add1(x_small, HOST_T)),
        "copy_pm_add1": host_us(lambda: probes.copy_pm_add1(xpm_small)),
        "x + 1": host_us(lambda: x_small + 1.0),
        "copy's bare launcher": host_us(
            lambda: lib.probe_copy_add1_launch(
                x_small.data_ptr(), y_small.data_ptr(), C, HOST_T, HOST_T,
                _build.stream(dev))),
    }
    print("  host enqueue, us a call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in host.items()) + f"  [{card}]")
    del x_small, y_small, xpm_small
    # one stage requested at a time (the filter always runs): splits the
    # kernel's time by phase
    ch_stage_ms = {}
    for outputs in (("filtered",), ("envelope",), ("spectrogram",)):
        ms = median_ms(lambda: chain(ck, q, CHUNK, stats=True,
                                     outputs=outputs))
        ch_stage_ms[outputs[0]] = ms
        print(f"  chain headline chunk, outputs={outputs[0]} only: kernel "
              f"{ms:.4f} ms  [{card}]")
    print(f"  chain: {100 * ch_bound_tc / ch_ms:.1f} % of bound_tc, tile "
          f"{ck.tile}  [{card}]")
    hour = [q] + [int16_chunk(gen, q.shape, dev) for _ in range(3)]

    def hour_loop(fn):
        out = None
        for i in range(HOUR_CHUNKS):
            out = fn(ck, hour[i % len(hour)], CHUNK, stats=True)
        return out

    hour_ms = median_ms(lambda: hour_loop(chain))
    hour_plain_ms = median_ms(lambda: hour_loop(chain_plain))
    print(f"  1-hour loop ({HOUR_CHUNKS} chunks x 16 ch x 2^22 int16, "
          f"device-resident): kernel {hour_ms:.2f} ms  plain "
          f"{hour_plain_ms:.2f} ms  [{card}]")

    # -- phase 6: launch counters --------------------------------------------
    print(f"phase 6: main-path launches {launches}")
    for name, count in launches.items():
        require(count > 0, f"{name} launched on the main path")
    del hour, q, qs, ql

    # -- phase 7: envdet -----------------------------------------------------
    print("phase 7: envdet kernel vs plain and float64 at the detect chunk")
    fdet = FilterDesign.from_sos(sps.butter(1, DETECT_BAND, "bandpass",
                                            fs=RATE, output="sos"))

    def env_design(cutoff):
        edes = FilterDesign.from_sos(sps.butter(1, cutoff, "lowpass",
                                                fs=RATE, output="sos"))
        return (edes, int(np.round(RATE / (10 * cutoff))),
                events.detect_halo(fdet, edes))

    edet, step, halo = env_design(DETECT_ENV)
    ed, det_chunk = events._make_envdet(fdet, edet, step, halo, dev)
    W = events._CHUNK + 2 * halo
    require(isinstance(ed, EnvDetKernel), "the CLI design takes the kernel")
    require(lib.envdet_tile_max() == ENVDET_TILE_MAX
            and lib.envdet_tile_min() == ENVDET_TILE_MIN, "envdet tile")

    def smem_agrees(e):
        n = lib.envdet_smem_bytes(e.lb, e.ll, e.step, e.tile)
        require(n == envdet_smem_bytes(e.lb, e.ll, e.step, e.tile)
                and n <= _build.SMEM_LIMIT, "shared-memory formula agrees")
        return n

    print(f"  step {step}  halo {halo}  chunk {det_chunk}  W {W}  "
          f"nout {ed.nout}  taps {ed.lb} + {ed.ll}  tile {ed.tile}  "
          f"shared {smem_agrees(ed)} B")
    qd = detect_chunk(gen, W, dev)
    env_err = check_envdet(ed, qd, "headline int16")
    env_err = max(env_err, check_envdet(ed, dequant16(qd), "float32"))
    for cc in (1, 3):
        env_err = max(env_err, check_envdet(ed, qd[:, :cc].contiguous(),
                                            f"C = {cc}"))
    for s_ in (1, 3, 7):
        e_s = EnvDetKernel(fdet, edet, s_, (1 << 18) // s_ + 13, hb=halo,
                           device=dev)
        env_err = max(env_err, check_envdet(e_s, qd, f"step {s_}, nout "
                                            f"{e_s.nout}"))
    e_n = EnvDetKernel(fdet, edet, step, 1000, hb=halo, device=dev)
    require(e_n.nout % e_n.tile != 0, "nout is not a multiple of the tile")
    env_err = max(env_err, check_envdet(e_n, qd, "nout 1000"))
    # the 200 Hz envelope at the CLI's step (48): a span that narrows the
    # tile; a 100 Hz one (step 96), which the earlier kernel refused, fits
    # at a narrow tile; a 60 Hz one (step 160) spans more than a block holds
    e200, step200, halo200 = env_design(200.0)
    e_h = EnvDetKernel(fdet, e200, step200, (1 << 18) // step200 + 13,
                       hb=halo200, device=dev)
    require(e_h.tile < ed.tile, "the 200 Hz design narrows the tile")
    print(f"  200 Hz design: taps {e_h.lb} + {e_h.ll}, step {step200}, "
          f"shared {smem_agrees(e_h)} B")
    env_err = max(env_err, check_envdet(e_h, qd, f"200 Hz design, step "
                                        f"{step200}"))
    e100, step100, halo100 = env_design(100.0)
    e_c = EnvDetKernel(fdet, e100, step100, (1 << 18) // step100 + 13,
                       hb=halo100, device=dev)
    print(f"  100 Hz design: taps {e_c.lb} + {e_c.ll}, step {step100}, "
          f"shared {smem_agrees(e_c)} B")
    env_err = max(env_err, check_envdet(e_c, qd, f"100 Hz design, step "
                                        f"{step100}"))
    e60, step60, halo60 = env_design(60.0)
    made = events._make_envdet(fdet, e60, step60, halo60, dev)
    require(made is not None and isinstance(made[0], EnvDet),
            "the 60 Hz design is refused and left to EnvDet")
    long_ed = made[0]
    print(f"  60 Hz design (taps {long_ed.lb} + {long_ed.ll}, step "
          f"{step60}): refused by the kernel, EnvDet takes it")
    del long_ed, made
    ref = envdet_f64(ed, qd)
    scale = float(ref.abs().max())
    # the two-stage EnvDet on window_matmul, stage by stage
    two = EnvDet(fdet, edet, step, ed.nout, hb=halo, device=dev)
    got2 = two(qd, halo)
    e2 = max_abs(got2, ref)
    require(e2 <= TOL_DETECT * scale, f"EnvDet vs float64 {e2}")
    base = two.hb + two.d_bp - two.lead2
    n_y = two.lead2 + (two.nout - 1) * step + two.d_lp + 1
    xp = torch.nn.functional.pad(qd.T[:, : base + n_y], (two.lb - 1, 0))

    def check_stage(label, x, w, S, nfr, pm, lay):
        got = window_matmul(x, w, S, nfr, premap=pm, out_layout=lay)
        want = window_matmul_plain(x, w, S, nfr, premap=pm, out_layout=lay)
        torch.cuda.synchronize()
        err = max_abs(got, want)
        wscale = float(want.abs().max())
        require(err <= TOL_WINDOW * wscale, f"window_matmul {label} {err}")
        print(f"  window_matmul {label}: K={w.shape[0]} S={S} frames={nfr} "
              f"max_abs_err {err:.3e} (scale {wscale:.3e})")
        return err, want

    e_bp, caus = check_stage("EnvDet band-pass, dequant", xp, two.w_bp, 128,
                             -(-(base + n_y) // 128), "dequant", "cf")
    y_ext = caus[:, base : base + n_y].contiguous()
    e_env, _ = check_stage("EnvDet decimating envelope, square", y_ext,
                           two.b2, 128 * step, -(-two.nout // 128), "square",
                           "fco")
    wm_err = max(wm_err, e_bp, e_env)
    print(f"  EnvDet (two window_matmul stages) vs float64 {e2:.3e}")
    del ref, got2, xp, caus, y_ext

    # -- phase 8: the song detector's main path ------------------------------
    print(f"phase 8: audian-songdetector on a {DETECT_SECONDS} s x {C} ch x "
          f"96 kHz PCM-16 WAV")
    pcm = song_recording(rng, DETECT_SECONDS)
    nrec = pcm.shape[0]
    interior = sum(1 for pos in range(0, nrec, det_chunk)
                   if pos - halo >= 0 and pos - halo + W <= nrec)
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "songs.wav")
        out_csv = os.path.join(tmp, "songs.csv")
        scipy.io.wavfile.write(wav, int(RATE), pcm)
        chain.launches = window_matmul.launches = envdet.launches = 0
        t0 = time.perf_counter()
        rc = songdetector.main([wav, "-o", out_csv])
        torch.cuda.synchronize()
        detect_wall = time.perf_counter() - t0
        det_launches = {"chain": chain.launches,
                        "window_matmul": window_matmul.launches,
                        "envdet": envdet.launches}
        require(rc == 0, f"songdetector exit status {rc}")
        with open(out_csv) as f:
            rows = [line.strip().split(",") for line in f if line.strip()]
        # where the CLI's wall goes: the WAV read, the envelope (uploads,
        # exact edge chunks, envdet on the interior ones) and, as the rest
        # of detect(), the host event logic
        t0 = time.perf_counter()
        data, _ = songdetector.load_recording(wav)
        t1 = time.perf_counter()
        events.band_env(data, RATE, *DETECT_BAND, DETECT_ENV,
                        return_filtered=False, fused=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        events.detect(data, RATE, *DETECT_BAND, DETECT_ENV,
                      return_filtered=False)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        split = {"read_s": t1 - t0, "band_env_s": t2 - t1,
                 "events_s": (t3 - t2) - (t2 - t1)}
        # the device's busy share of band_env, from a profiler trace
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            events.band_env(data, RATE, *DETECT_BAND, DETECT_ENV,
                            return_filtered=False, fused=True)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        # device-side events only: an aten op's device time repeats that
        # of the kernels and copies it launched
        by_kernel = sorted(
            ((e.self_device_time_total, e.key) for e in prof.key_averages()
             if device_work(e) and e.self_device_time_total > 0),
            reverse=True)
        busy_s = sum(t for t, _ in by_kernel) / 1e6
        # what the device ran just before each envdet launch: the window's
        # upload, and no copy kernel (the transposing copy is gone)
        timeline = sorted((e for e in prof.events() if device_work(e)),
                          key=lambda e: e.time_range.start)
        before_envdet = [timeline[i - 1].name
                         for i, e in enumerate(timeline)
                         if i > 0 and "envdet_kernel" in e.name]
        del data
    require(rows[0] == ["channel", "tstart/s", "tend/s", "duration/s"],
            f"CSV header {rows[0]}")
    found = {}
    for row in rows[1:]:
        found.setdefault(int(row[0]), []).append(float(row[1]))
    counts = [len(found.get(c, [])) for c in range(C)]
    require(counts == [len(SONG_STARTS)] * C,
            f"songs per channel {counts}, planted {len(SONG_STARTS)} each")
    worst = max(float(np.abs(np.sort(found[c]) - SONG_STARTS).max())
                for c in range(C))
    require(worst <= TOL_ONSET_S, f"onsets off by {worst} s")
    print(f"  {len(rows) - 1} songs in the CSV, every planted song on every "
          f"channel, onsets within {worst:.4f} s; wall {detect_wall:.2f} s "
          f"for {DETECT_SECONDS} s of recording")
    print(f"  launches {det_launches}; interior chunks {interior} of "
          f"{-(-nrec // det_chunk)}")
    print("  wall split (host clock, s): " + "  ".join(
        f"{k} {v:.4f}" for k, v in split.items()))
    if busy_s > 0:
        print(f"  band_env under the profiler: wall {prof_wall:.4f} s, "
              f"device busy {busy_s:.4f} s ({100 * busy_s / prof_wall:.1f} "
              f"%); by kernel (ms):")
        for t, key in by_kernel[:6]:
            print(f"    {t / 1e3:10.4f}  {key[:90]}")
        require(len(before_envdet) == interior
                and all(n.startswith("Memcpy") for n in before_envdet),
                f"envdet launches follow their uploads: {before_envdet}")
        print(f"  before each envdet launch the device ran: "
              f"{sorted(set(before_envdet))}")
    else:
        print("  band_env device busy share: not measured (the profiler "
              "recorded no device time)")
    require(det_launches["envdet"] == interior > 0,
            "envdet launched once per interior chunk")
    # band_env on two channels against the scipy float64 oracle
    _, env2, _ = events.band_env(pcm[:, :2], RATE, *DETECT_BAND, DETECT_ENV,
                                 return_filtered=False, fused=True)
    _, env64 = events.detect_env_oracle(
        pcm[:, :2].astype(np.float64) / 32768.0, step, fdet, edet)
    scale = float(np.abs(env64).max())
    eo = float(np.abs(env2 - env64).max())
    require(env2.shape == env64.shape and np.isfinite(env2).all(),
            f"band_env shape {env2.shape}")
    require(eo <= TOL_DETECT_ORACLE * scale, f"band_env vs scipy {eo}")
    print(f"  band_env (2 ch) vs scipy float64: {eo:.3e} (scale "
          f"{scale:.4f})")
    det_codes = np.ascontiguousarray(pcm[:, :FL_C])   # for phase 13
    # phase 14 runs the song viewer's envelope keys on this recording and,
    # where this machine has matplotlib, the song detector's --plot-png
    song = (pcm, rows)
    del pcm, env2, env64

    # -- phase 9: detect times -----------------------------------------------
    print("phase 9: detect times, CUDA-event medians")
    env_ms = median_ms(lambda: envdet(ed, qd))
    env_plain_ms = median_ms(lambda: envdet_plain(ed, qd))
    two_ms = median_ms(lambda: two(qd, halo))
    env_bound = bound(*envdet_work(ed, qd))
    env_bound_tc = bound_tc(*envdet_work(ed, qd))
    print(f"  envdet headline chunk ({C} x {W} int16): kernel {env_ms:.4f} ms"
          f"  plain {env_plain_ms:.4f} ms  two-stage EnvDet {two_ms:.4f} ms"
          f"  bound {env_bound[0]:.4f} ms ({env_bound[1]})  bound_tc "
          f"{env_bound_tc:.4f} ms ({100 * env_bound_tc / env_ms:.1f} % "
          f"reached)  [{card}]")
    # the wrapper's host enqueue of a call (phase 5's for the others)
    host["envdet"] = host_us(lambda: envdet(ed, qd), calls=20)
    print(f"  envdet host enqueue {host['envdet']:.2f} us a call  [{card}]")
    # other tiles the host could pick for this design
    for tile in (128, 256, 384, 512, 640):
        if tile == ed.tile or envdet_smem_bytes(
                ed.lb, ed.ll, step, tile) > _build.SMEM_LIMIT:
            continue
        et = copy.copy(ed)
        et.tile = tile
        print(f"  envdet headline chunk at tile {tile} "
              f"({envdet_smem_bytes(ed.lb, ed.ll, step, tile)} B shared): "
              f"kernel {median_ms(lambda: envdet(et, qd)):.4f} ms  [{card}]")
    # what reading the (W, C) window costs: the same blocks over a
    # time-contiguous window (the channels end to end, C = 1), and the
    # transposing copy that made one before
    ntile = -(-ed.nout // ed.tile)
    ed1 = EnvDetKernel(fdet, edet, step, C * ntile * ed.tile, hb=halo,
                       device=dev)
    x1 = torch.nn.functional.pad(qd.T.reshape(-1),
                                 (0, ed1.window_need(halo) - C * W))
    x1 = x1.reshape(-1, 1)
    one_ms = median_ms(lambda: envdet(ed1, x1))
    copy_ms = median_ms(lambda: qd.T.contiguous())
    print(f"  the same {C * ntile} blocks over a time-contiguous window "
          f"(C = 1): kernel {one_ms:.4f} ms; the (W, C) reads cost "
          f"{env_ms - one_ms:.4f} ms, the transposing copy took "
          f"{copy_ms:.4f} ms  [{card}]")
    del x1
    det_hour = [qd] + [detect_chunk(gen, W, dev) for _ in range(2)]
    nhour = -(-int(3600 * RATE) // det_chunk)

    def detect_hour(fn):
        out = None
        for i in range(nhour):
            out = fn(ed, det_hour[i % len(det_hour)])
        return out

    hour_det_ms = median_ms(lambda: detect_hour(envdet), reps=3)
    hour_det_plain_ms = median_ms(lambda: detect_hour(envdet_plain), reps=3)
    print(f"  1-hour detect loop ({nhour} chunks x {C} ch, device-resident): "
          f"kernel {hour_det_ms / 1e3:.4f} s per recording hour  plain "
          f"{hour_det_plain_ms / 1e3:.4f} s  [{card}]")

    # -- phases 10-14: the interactive path, the browser, FLAC, frontends --
    with tempfile.TemporaryDirectory() as tmp:
        path, path8, ia_fir, ia_stft = interactive_phases(card, dev, tmp)
        browser_phase(card, dev, tmp, path, path8)
        flac_launches = flac_phase(card, dev, tmp, path8, det_codes, bio)
        del det_codes
        viewer_launches = frontend_phase(card, dev, tmp, path, path8, song)
        md_launches = multidevice_phase(card, dev, tmp, path, song)
    del song

    # -- phase 16: the IFIR envelope and the exact IIR filters ---------------
    ifir_launches, ifir_ms, ifir_err, relayout = ifir_phase(card, dev)
    wm_err = max(wm_err, ifir_err)
    iir_phase(card, dev)

    # -- phase 17: the precision rungs ---------------------------------------
    rungs = precision_phase(card, dev, bio, wm_times, ed, qd)

    # -- phase 18: the benchmark probes --------------------------------------
    probe_kernels = probes_phase(card, dev, ch_ms, ch_ms_b2b, relayout, host)

    # -- phase 19: the examples ----------------------------------------------
    ex_launches = examples_phase(card, dev)

    # -- phase 20: the graph's FIR kernel ------------------------------------
    fir_entry = fir_phase(card, dev, ia_fir)

    # -- phase 21: the graph's spectrogram on window_matmul ------------------
    stft_entry = stft_phase(card, dev, ia_stft)

    wm_bound = bound(wm_flop, wm_bytes)
    wm_bound_tc = bound_tc(wm_flop, wm_bytes)
    print(f"  window_matmul, three bioacoustics stages: kernel {wm['ms']:.4f} "
          f"ms as lone calls, {wm['ms_back_to_back']:.4f} back to back; "
          f"unfold+matmul {wm['library_ms']:.4f} ms, "
          f"{wm['library_ms_back_to_back']:.4f}; bound {wm_bound[0]:.4f} ms  "
          f"bound_tc {wm_bound_tc:.4f} ms; half of bound_tc "
          f"{'met' if wm['ms'] <= 2 * wm_bound_tc else 'MISSED'} as lone "
          f"calls, {'met' if wm['ms_back_to_back'] <= 2 * wm_bound_tc else 'MISSED'}"
          f" back to back  [{card}]")
    kernels = [
        {"name": "chain", "route": "cuda",
         "source": "audian_torch/csrc/chain.cu",
         "replaces": "audian_tpu/ops/pallas/chain.py:151",
         "launches": launches["chain"], "max_abs_err": chain_err,
         "ms": ch_ms, "ms_back_to_back": ch_ms_b2b, "host_us": host["chain"],
         "plain_ms": ch_plain_ms, "bound_ms": ch_bound[0],
         "bound_by": ch_bound[1], "bound_tc_ms": ch_bound_tc,
         "bound_share": ch_bound_tc / ch_ms, "tile": ck.tile,
         "stage_ms": ch_stage_ms, "core_max_abs_err": core_err["TF32X3"],
         "core_max_abs_err_by_mode": core_err,
         "core_tflops": core_rates,
         "library_ms": None, "flac_launches": flac_launches["chain"],
         "multidevice_launches": md_launches["chain"],
         "examples_launches": ex_launches["chain"],
         "precision": rungs["chain"]},
        {"name": "window_matmul", "route": "cuda",
         "source": "audian_torch/csrc/window_matmul.cu",
         "replaces": "audian_tpu/ops/pallas/window_matmul.py:41",
         "launches": route_launches,
         "file_launches": launches["window_matmul"], "max_abs_err": wm_err,
         "ms": wm["ms"], "plain_ms": wm["plain_ms"],
         "bound_ms": wm_bound[0], "bound_by": wm_bound[1],
         "bound_tc_ms": wm_bound_tc, "bound_share": wm_bound_tc / wm["ms"],
         "library_ms": wm["library_ms"],
         "ms_back_to_back": wm["ms_back_to_back"],
         "bound_share_back_to_back": wm_bound_tc / wm["ms_back_to_back"],
         "library_ms_back_to_back": wm["library_ms_back_to_back"],
         "host_ms": wm_host_ms, "stage_ms": wm_stage_ms,
         "stage_ms_back_to_back": wm_stage_b2b, "split_ms": wm_split_ms,
         "slower_than_library": wm_slower,
         "multidevice_launches": md_launches["window_matmul"],
         "examples_launches": ex_launches["window_matmul"],
         "ifir_launches": ifir_launches, "ifir_ms": ifir_ms,
         "graph_stft": stft_entry,
         "precision": dict(rungs["window_matmul"], HIGHEST={
             "ms": wm["ms"], "ms_back_to_back": wm["ms_back_to_back"],
             "max_abs_err": wm_err, "bound_tc_ms": wm_bound_tc})},
        {"name": "envdet", "route": "cuda",
         "source": "audian_torch/csrc/envdet.cu",
         "replaces": "audian_tpu/ops/pallas/envdet.py:64",
         "launches": det_launches["envdet"], "max_abs_err": env_err,
         "ms": env_ms, "plain_ms": env_plain_ms, "bound_ms": env_bound[0],
         "bound_by": env_bound[1], "bound_tc_ms": env_bound_tc,
         "bound_share": env_bound_tc / env_ms, "tile": ed.tile,
         "host_us": host["envdet"],
         "library_ms": None, "flac_launches": flac_launches["envdet"],
         "viewer_launches": viewer_launches,
         "multidevice_launches": md_launches["envdet"],
         "examples_launches": ex_launches["envdet"],
         "precision": rungs["envdet"]},
        fir_entry,
        *probe_kernels,
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
