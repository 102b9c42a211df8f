"""The plain strided-window matrix product of audian_torch against the JAX
package's Pallas ``window_matmul`` (interpret mode on the CPU).

Tolerance: max abs error 1e-5 times the output scale (both sides compute
in float32; the sums run in different orders).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

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


CASES = {
    # name: (w, stride, nframes, premap, layout)
    "toeplitz-cf-S128": (_bank(142, 1), 128, 24, None, "cf"),
    "dft-fco-S128": (_dft(256), 128, 30, None, "fco"),
    "dft-fco-S256-nfft512": (_dft(512), 256, 14, None, "fco"),
    "dft-fco-odd-hop-90": (_dft(256), 90, 40, None, "fco"),
    "odd-O-cf": (np.random.default_rng(2).standard_normal(
        (200, 77)).astype(np.float32), 128, 20, None, "cf"),
    "rectify-cf": (_bank(400, 3), 128, 25, "rectify", "cf"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax(name):
    w, S, nfr, premap, layout = CASES[name]
    rng = np.random.default_rng(7)
    # a stream a little short of the last window: both sides zero-extend
    n = (nfr - 1) * S + w.shape[0] - 37
    x = rng.standard_normal((3, n)).astype(np.float32)
    want = np.asarray(jax_wm(jnp.asarray(x), jnp.asarray(w), S, nfr,
                             premap=_rectify if premap else None,
                             out_layout=layout))
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
        window_matmul(x, w, 10, 3, premap="square")
    with pytest.raises(ValueError, match="out_layout"):
        window_matmul(x, w, 10, 3, out_layout="cfo")
    with pytest.raises(ValueError):
        window_matmul(x.to("meta"), w.to("meta"), 10, 3)
