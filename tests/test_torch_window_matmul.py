"""The plain strided-window matrix product of audian_torch against the JAX
package's Pallas ``window_matmul`` (interpret mode on the CPU), with each
premap: the identity, the rectifier, the PCM-16 dequantizer and the square
(the last two as ``EnvDet``'s stages use them, ``ops/envdet.py:56-66``).

Tolerance: max abs error 1e-5 times the output scale (both sides compute
in float32; the sums run in different orders).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audian_tpu.ops.envdet import _decimating_bank, _dequant, _square
from audian_tpu.ops.fused import _rectify
from audian_tpu.ops.pallas.window_matmul import window_matmul as jax_wm
from audian_tpu.ops.sos import _toeplitz_bank_np
from audian_tpu.ops.stft import _dft_matrices, hann_window

from audian_torch.ops.cuda.window_matmul import (window_matmul,
                                                 window_matmul_plain)


def _bank(T, seed):
    h = np.random.default_rng(seed).standard_normal(T) * np.exp(
        -np.arange(T) / (T / 4))
    return _toeplitz_bank_np(h.astype(np.float32), 128).T   # (128+T-1, 128)


def _dft(nfft):
    nbins = nfft // 2 + 1
    win = hann_window(nfft, np.float64)
    return (win[:, None] * _dft_matrices(nfft, nbins, np.float64)).astype(
        np.float32)


JAX_PREMAPS = {None: None, "rectify": _rectify, "dequant": _dequant,
               "square": _square}

CASES = {
    # name: (w, stride, nframes, premap, layout); "dequant" cases take
    # int16 PCM
    "toeplitz-cf-S128": (_bank(142, 1), 128, 24, None, "cf"),
    "dft-fco-S128": (_dft(256), 128, 30, None, "fco"),
    "dft-fco-S256-nfft512": (_dft(512), 256, 14, None, "fco"),
    "dft-fco-odd-hop-90": (_dft(256), 90, 40, None, "fco"),
    "odd-O-cf": (np.random.default_rng(2).standard_normal(
        (200, 77)).astype(np.float32), 128, 20, None, "cf"),
    "rectify-cf": (_bank(400, 3), 128, 25, "rectify", "cf"),
    # EnvDet's band-pass stage on raw PCM-16 (a 511-tap symmetric kernel)
    "dequant-int16-cf": (_bank(511, 4), 128, 20, "dequant", "cf"),
    # EnvDet's decimating envelope stage at step 19: K 3436, stride 2432
    "square-decimating-fco": (_decimating_bank(
        np.hanning(1023) / 512.0, 19), 128 * 19, 3, "square", "fco"),
    "square-small-step-fco": (_decimating_bank(
        np.hanning(255) / 128.0, 3), 128 * 3, 6, "square", "fco"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax(name):
    w, S, nfr, premap, layout = CASES[name]
    rng = np.random.default_rng(7)
    # a stream a little short of the last window: both sides zero-extend
    n = (nfr - 1) * S + w.shape[0] - 37
    x = rng.standard_normal((3, n)).astype(np.float32)
    if premap == "dequant":
        x = np.round(np.clip(0.3 * x, -1, 1) * 32767).astype(np.int16)
    want = np.asarray(jax_wm(jnp.asarray(x), jnp.asarray(w), S, nfr,
                             premap=JAX_PREMAPS[premap], out_layout=layout))
    got = window_matmul(torch.from_numpy(x), torch.from_numpy(w), S, nfr,
                        premap=premap, out_layout=layout)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


def test_zero_frames_and_bad_arguments():
    x = torch.zeros((2, 100))
    w = torch.zeros((50, 3))
    assert window_matmul_plain(x, w, 10, 0).shape == (0, 2, 3)
    assert window_matmul_plain(x, w, 10, 0, out_layout="cf").shape == (2, 0)
    with pytest.raises(ValueError, match="premap"):
        window_matmul(x, w, 10, 3, premap="cube")
    with pytest.raises(TypeError, match="dequant"):
        window_matmul(x.to(torch.int16), w, 10, 3, premap="square")
    with pytest.raises(ValueError, match="out_layout"):
        window_matmul(x, w, 10, 3, out_layout="cfo")
    with pytest.raises(ValueError):
        window_matmul(x.to("meta"), w.to("meta"), 10, 3)


def test_bank_split_is_made_once_per_bank(monkeypatch):
    """An owner's :class:`BankSplit` splits its bank at the first call and
    reuses the split until the bank is edited in place or replaced; a CPU
    call never splits; the per-stage chain and EnvDet hold one a bank."""
    from audian_torch.models import get_preset
    from audian_torch.ops.cuda import window_matmul as wm

    made = []
    monkeypatch.setattr(wm, "split_w", lambda w: made.append(w) or len(made))
    hold = wm.BankSplit()
    w = torch.ones((300, 128))
    assert (hold(w), hold(w)) == (1, 1)
    w.mul_(2.0)
    assert (hold(w), hold(w)) == (2, 2)
    w2 = w.clone()
    assert hold(w2) == 3 and hold(w) == 4 and len(made) == 4
    x = torch.ones((2, 1000))
    window_matmul(x, w, 128, 4, split=hold)
    assert len(made) == 4
    fc = get_preset("bioacoustics").fused(96000.0, device="cpu")
    assert set(fc._splits) == {"filt_w", "env_w", "env_i_w", "env_g_w",
                               "spec_w"}
    assert all(isinstance(s, wm.BankSplit) for s in fc._splits.values())
