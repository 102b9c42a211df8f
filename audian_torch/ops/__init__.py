"""DSP ops of the port: host-side design (numpy), FIR filtering and the
STFT on tensors, and the fused batch chain."""

from .design import (FilterDesign, FirKernels, design_envelope_filter,
                     design_filter, filtfilt_sym_kernel, fir_kernels)
from .raw16 import dequant16
from .sos import odd_ext, sosfilt_fir, sosfiltfilt_fir, sosfiltfilt_sym
from .stft import (decibel, hann_window, inverse_decibel, spectrogram,
                   spectrogram_frequencies)

__all__ = [
    "FilterDesign", "FirKernels", "decibel", "dequant16",
    "design_envelope_filter", "design_filter", "filtfilt_sym_kernel",
    "fir_kernels", "hann_window", "inverse_decibel", "odd_ext",
    "sosfilt_fir", "sosfiltfilt_fir", "sosfiltfilt_sym", "spectrogram",
    "spectrogram_frequencies",
]
