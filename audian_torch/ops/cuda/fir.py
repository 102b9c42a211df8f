"""The causal FIR of :func:`audian_torch.ops.sos.sosfilt_fir` on the tensor
cores: ``y[i, c] = sum_m h[m] x[i - m, c]`` over a time-first ``(n, C)``
float32 stream, zero before sample 0.

The CUDA kernel (``csrc/fir.cu``) runs it as Toeplitz products on the
``wgmma`` convolution core (``csrc/wgmma_conv.cuh``), the chain's and
envdet's: three TF32 passes at HIGHEST and HIGH, one at DEFAULT
(:func:`.precision.core_mode`), every unit of 128 taps at the rung (no
light units).  A block owns 8192 outputs of one channel and reads its
span, the outputs and the ``T - 1`` samples before them, from the stream
as it lies; its split stream in shared memory sets the longest filter one
launch takes.  :func:`fir` runs a design of more than :data:`LAUNCH_TAPS`
taps as near-equal slices of its taps (:func:`slices`), one launch each,
a slice's span read as many samples earlier as its first tap, its sums
added into the output.  So every design of a CUDA float32 stream runs on
the kernel.  The output is written channels-first and handed back as its
``(n, C)`` view, as the cuDNN route's was.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ._build import launch, load_library
from .chain import TAP_PAD, _split_taps
from .precision import HIGHEST, MATMUL_RUNGS, check, core_mode

__all__ = ["LAUNCH_TAPS", "fir", "operand", "slices", "upload_taps"]

#: the most taps one launch takes: a block's stream of a 4096-tap slice
#: leaves room for two blocks an SM (up to 6202 taps)
LAUNCH_TAPS = 4096
#: tap operands kept on the device, the designs used last
_KEPT = 8

_operands = OrderedDict()
_lock = threading.Lock()


def slices(T):
    """The ``(first tap, taps)`` of each launch of a ``T``-tap design: the
    fewest slices of at most :data:`LAUNCH_TAPS` taps, of near-equal
    length."""
    k = -(-T // LAUNCH_TAPS)
    q, r = divmod(T, k)
    lengths = [q + (j < r) for j in range(k)]
    return [(sum(lengths[:j]), n) for j, n in enumerate(lengths)]


def operand(h):
    """``(vector, plan)``: the kernel's TF32 tap operand of the taps ``h``
    (host, rounded to float32), each slice's ``[hi | lo]`` split
    (:func:`.chain._split_taps`: ``TAP_PAD`` zeros on either side of each
    part) one after the other, and for each slice ``(first tap, taps,
    offset of its split in the vector)``."""
    h = np.asarray(h, np.float32)
    parts, plan, at = [], [], 0
    for m, T in slices(len(h)):
        parts.append(_split_taps(h[m:m + T]))
        plan.append((m, T, at))
        at += 2 * (T + 2 * TAP_PAD)
    return np.concatenate(parts), plan


def _device_operand(h, device):
    """:func:`operand` of ``h`` on ``device``, built once for each taps
    object (a tensor also until it is changed in place) and kept for the
    last :data:`_KEPT` of them: a design's taps are split and uploaded
    once, not on every call."""
    key = (id(h), device)
    version = getattr(h, "_version", None)
    with _lock:
        kept = _operands.get(key)
        if kept is not None and kept[0] is h and kept[1] == version:
            _operands.move_to_end(key)
            return kept[2]
    vec, plan = operand(h.detach().cpu().numpy() if torch.is_tensor(h)
                        else h)
    return _keep(h, (torch.from_numpy(vec).to(device), plan), device)


def _keep(h, built, device):
    """Keep ``built``, the operand of the taps ``h`` on ``device``."""
    with _lock:
        # the taps are held with their operand, so that their id is not
        # reused while the entry lives
        _operands[(id(h), device)] = (h, getattr(h, "_version", None), built)
        _operands.move_to_end((id(h), device))
        while len(_operands) > _KEPT:
            _operands.popitem(last=False)
    return built


def upload_taps(h, device):
    """The host taps ``h`` as a float32 tensor on ``device``; on a CUDA
    device with the kernel's operand of them built from the host array
    and copied with them in one upload, so that a design's first call
    neither splits nor pulls them."""
    h = np.asarray(h, np.float32)
    device = torch.device(device)
    if device.type != "cuda":
        return torch.tensor(h, device=device)
    buf, at, plan = _packed(h)
    both = torch.from_numpy(buf).to(device)
    t = both[:len(h)]
    _keep(t, (both[at:], plan), t.device)
    return t


def _packed(h):
    """``(buffer, at, plan)``: the float32 taps ``h`` and, from ``at`` on
    (a 128-byte boundary), their :func:`operand` with its plan, the one
    upload of :func:`upload_taps`."""
    vec, plan = operand(h)
    at = -(-len(h) // 32) * 32
    buf = np.zeros(at + len(vec), np.float32)
    buf[:len(h)] = h
    buf[at:] = vec
    return buf, at, plan


def fir(x, h, precision=HIGHEST):
    """``y[i, c] = sum_m h[m] x[i - m, c]`` over a CUDA float32 ``(n, C)``
    stream ``x`` (its channels adjacent, rows at any stride) with the taps
    ``h`` (a tensor or an array, rounded to float32), at ``precision``
    (HIGHEST, HIGH or DEFAULT): the kernel's ``(n, C)`` view of its
    channels-first output, one launch a slice of the taps (:func:`slices`),
    each counted in ``fir.launches``."""
    mode = core_mode(check(precision, MATMUL_RUNGS))
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"fir takes a float32 (n, C) CUDA stream, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if len(h) < 1:
        raise ValueError("fir takes at least one tap")
    n, C = x.shape
    y = torch.empty((C, n), dtype=torch.float32, device=x.device)
    if n == 0 or C == 0:
        return y.T
    if x.stride(1) != 1:
        x = x.contiguous()
    vec, plan = _device_operand(h, x.device)
    fn = load_library().fir_launch
    for m, T, at in plan:
        launch(fir, "fir", fn, x.device, x.data_ptr(), x.stride(0), n, C,
               vec.data_ptr() + 4 * at, T, m, int(m > 0), mode,
               y.data_ptr())
    return y.T


fir.launches = 0
