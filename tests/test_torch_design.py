"""audian_torch's host-side design equals the JAX package's, array for
array: filter designs, truncated responses, Toeplitz and shift banks,
the chain geometry, the window and the analysis matrices."""

import dataclasses

import numpy as np
import pytest

from audian_tpu.models import get_preset as jax_preset
from audian_tpu.ops import design as jdesign
from audian_tpu.ops import stft as jstft
from audian_tpu.ops.sos import _toeplitz_bank_np as j_toeplitz
from audian_tpu.ops.pallas.chain import _shift_bank as j_shift_bank
from audian_tpu.ops.pallas.chain import FusedChainKernel
from audian_tpu import utils as jutils

from audian_torch import utils as tutils
from audian_torch.convert import ARRAY_KEYS, chain_from_arrays
from audian_torch.models import get_preset as torch_preset
from audian_torch.ops import design as tdesign
from audian_torch.ops import stft as tstft
from audian_torch.ops.cuda.chain import _active, _shift_bank
from audian_torch.ops.sos import _toeplitz_bank_np as t_toeplitz

PRESETS = ("bioacoustics", "browser-envelope", "ultrasound")
RATES = (48000.0, 96000.0, 384000.0)


def jax_arrays(fc):
    """The numpy state of a JAX FusedChainCF, as chain_from_arrays takes
    it."""
    return {k: (None if getattr(fc, k) is None
                else np.asarray(getattr(fc, k))) for k in ARRAY_KEYS}


def same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    if a.dtype == np.float64:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("name", PRESETS)
def test_design_arrays_match(name, rate):
    jp, tp = jax_preset(name), torch_preset(name)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    sos_f = tdesign.design_filter(rate, tp.highpass_cutoff,
                                  tp.lowpass_cutoff, tp.filter_order)
    sos_e = tdesign.design_envelope_filter(rate, tp.envelope_cutoff)
    same(sos_f, jdesign.design_filter(rate, jp.highpass_cutoff,
                                      jp.lowpass_cutoff, jp.filter_order))
    same(sos_e, jdesign.design_envelope_filter(rate, jp.envelope_cutoff))
    for sos in (s for s in (sos_f, sos_e) if s is not None):
        T = tdesign.effective_impulse_length(sos)
        assert T == jdesign.effective_impulse_length(sos)
        assert tdesign.sos_pole_radius(sos) == jdesign.sos_pole_radius(sos)
        same(tdesign.impulse_response(sos, T),
             jdesign.impulse_response(sos, T))
        for a, b in zip(tdesign._cascade_state_space(sos),
                        jdesign._cascade_state_space(sos)):
            same(np.float64(a), np.float64(b))
        g, d = tdesign.filtfilt_sym_kernel(sos)
        gj, dj = jdesign.filtfilt_sym_kernel(sos)
        same(g, gj)
        assert d == dj
        h32 = tdesign.impulse_response(sos, T).astype(np.float32)
        same(t_toeplitz(h32, 128), j_toeplitz(h32, 128))
        tf, jf = (tdesign.FilterDesign.from_sos(sos),
                  jdesign.FilterDesign.from_sos(sos))
        same(tf.sos, jf.sos)
        same(tf.zi0, jf.zi0)
        assert tf.padlen == jf.padlen == tdesign.filtfilt_padlen(sos)
        for f in ("h", "state_out", "input_state", "A"):
            same(getattr(tf.fir, f), getattr(jf.fir, f))
        same(tdesign._matrix_powers(tf.fir.A, 7),
             jdesign._matrix_powers(jf.fir.A, 7))

    # the port's own design from SOS equals the JAX chain's state, and
    # chain_from_arrays carries that state across unchanged
    jfc = jp.fused(rate)
    tfc = tp.fused(rate, device="cpu")
    ja = jax_arrays(jfc)
    for fc in (tfc, chain_from_arrays(ja, device="cpu")):
        same(fc._h_filt, ja["_h_filt"])
        same(fc._g_env, ja["_g_env"])
        assert fc.env_delay == ja["env_delay"]
        for k in ("spec_w", "filt_w", "env_w"):
            same(None if getattr(fc, k) is None
                 else getattr(fc, k).numpy(), ja[k])
        assert (fc.hop, fc.nfft, fc.nbins) == (jfc.hop, jfc.nfft, jfc.nbins)

    jk, tk = jfc.chain_kernel, tfc.chain_kernel
    assert (jk is None) == (tk is None)
    if tk is not None:
        assert (tk.hb, tk.ha, tk.lead, tk.tail, tk.offe) == (
            jk.hb, jk.ha, jk.lead, jk.tail, jk.offe)
        same(tk.wf, np.asarray(jk.wf))
        same(tk.we, np.asarray(jk.we))
        same(tk.ws.numpy(), np.asarray(jk.ws))
        assert tk.act_f == jk.act_f and tk.act_e == jk.act_e


@pytest.mark.parametrize("nfft", [128, 256, 512, 90])
def test_window_and_dft_match(nfft):
    nbins = nfft // 2 + 1
    for dtype in (np.float32, np.float64):
        same(tstft.hann_window(nfft, dtype), jstft.hann_window(nfft, dtype))
        same(tstft._dft_matrices(nfft, nbins, dtype),
             jstft._dft_matrices(nfft, nbins, dtype))
    same(tstft.one_sided_doubling(nfft), jstft.one_sided_doubling(nfft))
    same(tstft.spectrogram_frequencies(48000.0, nfft),
         jstft.spectrogram_frequencies(48000.0, nfft))
    for n in (0, nfft - 1, nfft, 5 * nfft + 3):
        assert tstft.num_frames(n, nfft, 64) == jstft.num_frames(n, nfft, 64)


def test_shift_bank_and_active_match():
    rng = np.random.default_rng(3)
    h = rng.standard_normal(300) * np.exp(-np.arange(300) / 40.0)
    for D, off in ((384, 0), (700, 128), (1000, 512)):
        b = _shift_bank(h, D, off)
        same(b, j_shift_bank(h, D, off))
        assert _active(b) == FusedChainKernel._active(b)
    bank = np.zeros((512, 128), np.float32)
    bank[130:250] = 1.0
    bank[260] = 1e-5
    assert _active(bank) == FusedChainKernel._active(bank) == (
        (1, True), (2, False))


@pytest.mark.parametrize("x", [0, 1, 2, 127, 128, 129, 1000, 1 << 20])
def test_utils_match(x):
    assert tutils.pow2_at_least(x) == jutils.pow2_at_least(x)
    for m in (1, 8, 128, 384):
        assert tutils.round_up(x, m) == jutils.round_up(x, m)
