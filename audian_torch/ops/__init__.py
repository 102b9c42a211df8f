"""DSP ops of the port: host-side design (numpy), FIR filtering, the
rectified envelope and the STFT on tensors, the fused batch chain, min/max
decimation, spectrogram sweeps and the playback mix-down."""

from .design import (FilterDesign, FirKernels, design_envelope_filter,
                     design_filter, filtfilt_sym_kernel, fir_kernels)
from .envelope import envelope
from .minmax import (interleave_minmax, minmax_decimate, minmax_interleaved,
                     minmax_pyramid, pyramid_levels)
from .mix import fade, heterodyne, prepare_playback, stereo_mixdown
from .raw16 import dequant16
from .sos import odd_ext, sosfilt_fir, sosfiltfilt_fir, sosfiltfilt_sym
from .stft import (decibel, hann_window, inverse_decibel, spectrogram,
                   spectrogram_frequencies)
from .sweep import SWEEP_NFFTS, db_normalize, db_quantize, spectrogram_sweep

__all__ = [
    "FilterDesign", "FirKernels", "SWEEP_NFFTS", "db_normalize",
    "db_quantize", "decibel", "dequant16", "design_envelope_filter",
    "design_filter", "envelope", "fade", "filtfilt_sym_kernel", "fir_kernels",
    "hann_window", "heterodyne", "interleave_minmax", "inverse_decibel",
    "minmax_decimate", "minmax_interleaved", "minmax_pyramid", "odd_ext",
    "prepare_playback", "pyramid_levels", "sosfilt_fir", "sosfiltfilt_fir",
    "sosfiltfilt_sym", "spectrogram", "spectrogram_frequencies",
    "spectrogram_sweep", "stereo_mixdown",
]
