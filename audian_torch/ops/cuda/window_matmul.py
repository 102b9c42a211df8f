"""Strided-window matrix product: ``y[f] = p(x[:, f*S : f*S + K]) @ w``.

The wrapper :func:`window_matmul` launches the CUDA kernel
(``csrc/window_matmul.cu``, the port of
``audian_tpu/ops/pallas/window_matmul.py:_kernel``) on a CUDA tensor and
runs the plain PyTorch version :func:`window_matmul_plain` on a CPU
tensor; any other device raises.  The kernel is an implicit GEMM on the
tensor cores (3xTF32) that stages A and w per slice of K, so any K and
stride fit one block; each call first splits w into its TF32 parts in a
scratch buffer the wrapper allocates.  It serves the per-stage form of the
fused chain (the Toeplitz filter and envelope banks and the Hann-DFT
analysis matrix) and the two stages of the song-detection
:class:`audian_torch.ops.envdet.EnvDet` (int16 PCM through the
``"dequant"`` premap, the decimating envelope bank through ``"square"``).
"""

from __future__ import annotations

import math

import torch

from ..raw16 import dequant16
from ..sos import full_fp32
from ._build import check, count_launch, load_library

__all__ = ["PREMAPS", "window_matmul", "window_matmul_plain"]

#: elementwise maps applied to ``x`` while the windows are built: the
#: identity, (pi/2)|v|, the PCM-16 dequantizer (k/2^15 on int16 input,
#: the identity on float32) and v*v
PREMAPS = (None, "rectify", "dequant", "square")
_LAYOUTS = ("fco", "cf")


def _check_args(x, w, stride, nframes, premap, out_layout):
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError("x must be (C, n) and w (K, O)")
    if premap not in PREMAPS:
        raise ValueError(f"premap must be one of {PREMAPS}, got {premap!r}")
    if out_layout not in _LAYOUTS:
        raise ValueError(f"out_layout must be one of {_LAYOUTS}")
    if int(stride) < 1 or int(nframes) < 0:
        raise ValueError("stride must be >= 1 and nframes >= 0")
    if x.dtype == torch.int16 and premap != "dequant":
        raise TypeError("int16 x (PCM-16) takes premap='dequant'")


def _reshape_out(y, out_layout):
    """(C, nframes, O) -> the requested layout."""
    if out_layout == "fco":
        return y.permute(1, 0, 2).contiguous()
    return y.reshape(y.shape[0], -1)


@full_fp32()
def window_matmul_plain(x, w, stride, nframes, premap=None, out_layout="fco"):
    """Plain PyTorch version of :func:`window_matmul`: the frames as an
    ``unfold`` view of the zero-extended stream, then one ``matmul`` in
    full float32."""
    _check_args(x, w, stride, nframes, premap, out_layout)
    C, n = x.shape
    K, O = w.shape
    if nframes == 0:
        return _reshape_out(w.new_zeros((C, 0, O)), out_layout)
    need = (nframes - 1) * stride + K
    if need > n:
        x = torch.nn.functional.pad(x, (0, need - n))
    if premap == "dequant" and x.dtype == torch.int16:
        x = dequant16(x)
    elif premap == "rectify":
        x = (math.pi / 2) * torch.abs(x)
    elif premap == "square":
        x = x * x
    frames = x[:, :need].unfold(1, K, stride)               # (C, nf, K)
    return _reshape_out(frames @ w, out_layout)


def window_matmul(x, w, stride, nframes, premap=None, out_layout="fco"):
    """``y[f, c, :] = p(x[c, f*stride : f*stride + K]) @ w`` for
    ``f < nframes``, with ``x`` zero-extended past its end.

    x : (C, n) float32, or int16 PCM-16 with ``premap="dequant"``;
        channels-first.  w : (K, O) float32.
    premap : one of :data:`PREMAPS`.
    out_layout : "fco" returns (nframes, C, O); "cf" the channels-first
        stream (C, nframes*O).

    A CUDA tensor runs the kernel (counted in ``window_matmul.launches``);
    a CPU tensor runs :func:`window_matmul_plain`.
    """
    if x.device.type == "cpu":
        return window_matmul_plain(x, w, stride, nframes, premap, out_layout)
    if x.device.type != "cuda":
        raise ValueError(f"window_matmul runs on cuda or cpu, not {x.device}")
    _check_args(x, w, stride, nframes, premap, out_layout)
    if x.dtype not in (torch.float32, torch.int16) or w.dtype != torch.float32:
        raise TypeError("window_matmul takes float32 (or int16) x and "
                        "float32 w")
    if w.device != x.device:
        raise ValueError("x and w must be on the same device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    C, n = x.shape
    K, O = w.shape
    S, nframes = int(stride), int(nframes)
    if C > 65535:
        raise ValueError(f"at most 65535 channels (one grid row each), "
                         f"got {C}")
    y = torch.empty((C, nframes, O) if out_layout == "cf"
                    else (nframes, C, O), dtype=torch.float32,
                    device=x.device)
    if nframes == 0 or C == 0 or O == 0:
        return y.reshape(C, nframes * O) if out_layout == "cf" else y
    if (nframes + 64) * S + K >= 2**31 or n >= 2**31:
        raise ValueError("window_matmul indexes a channel with 32-bit "
                         "offsets: (nframes + 64) * stride + K and n must "
                         "stay below 2^31")
    lib = load_library()
    # w split into its TF32 parts, padded, for this call
    scratch = torch.empty(lib.window_matmul_scratch_words(K, O),
                          dtype=torch.int32, device=x.device)
    # launched on the tensor's device: the current device may be another
    with torch.cuda.device(x.device):
        code = lib.window_matmul_launch(
            x.data_ptr(), int(x.dtype == torch.int16), n, C, w.data_ptr(), K,
            O, S, nframes, PREMAPS.index(premap), _LAYOUTS.index(out_layout),
            y.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    check(code, "window_matmul")
    count_launch(window_matmul)
    return y.reshape(C, nframes * O) if out_layout == "cf" else y


window_matmul.launches = 0
