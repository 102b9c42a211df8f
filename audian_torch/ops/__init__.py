"""DSP ops of the port: host-side design (numpy), exact and FIR
filtering, the rectified envelope and the STFT on tensors, the fused
batch chain, min/max decimation, spectrogram sweeps and the playback
mix-down."""

from .design import (FilterDesign, FirKernels, design_envelope_filter,
                     design_filter, effective_impulse_length,
                     filtfilt_padlen, filtfilt_sym_kernel, fir_kernels,
                     impulse_response, sos_initial_conditions,
                     sos_pole_radius)
from .envelope import envelope
from .minmax import (interleave_minmax, minmax_decimate, minmax_interleaved,
                     minmax_pyramid, pyramid_levels)
from .mix import fade, heterodyne, prepare_playback, stereo_mixdown
from .raw16 import dequant16
from .sos import (odd_ext, sosfilt, sosfilt_fir, sosfilt_zi, sosfiltfilt,
                  sosfiltfilt_fir, sosfiltfilt_sym)
from .stft import (decibel, frame_signal, hann_window, inverse_decibel,
                   num_frames, spectrogram, spectrogram_frequencies)
from .sweep import SWEEP_NFFTS, db_normalize, db_quantize, spectrogram_sweep

__all__ = [
    "FilterDesign", "FirKernels", "SWEEP_NFFTS", "db_normalize",
    "db_quantize", "decibel", "dequant16", "design_envelope_filter",
    "design_filter", "effective_impulse_length", "envelope", "fade",
    "filtfilt_padlen", "filtfilt_sym_kernel", "fir_kernels", "frame_signal",
    "hann_window", "heterodyne", "impulse_response", "interleave_minmax",
    "inverse_decibel", "minmax_decimate", "minmax_interleaved",
    "minmax_pyramid", "num_frames", "odd_ext", "prepare_playback",
    "pyramid_levels", "sos_initial_conditions", "sos_pole_radius",
    "sosfilt", "sosfilt_fir", "sosfilt_zi", "sosfiltfilt", "sosfiltfilt_fir",
    "sosfiltfilt_sym", "spectrogram", "spectrogram_frequencies",
    "spectrogram_sweep", "stereo_mixdown",
]
