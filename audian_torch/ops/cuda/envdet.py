"""Single-pass song-detection envelope: int16 or float32 PCM -> zero-phase
band-pass -> square -> decimating envelope low-pass -> ``2 sqrt(max(e, 0))``.

:class:`EnvDetKernel` is the port of
``audian_tpu/ops/pallas/envdet.py:EnvDetKernel``: the same constructor,
``window_need`` and static contract (the window's first output sits at
exactly ``hb``).  The CUDA kernel (``csrc/envdet.cu``) reads the
time-first window as it is and runs both filters on the tensor cores
(3xTF32): the band-pass as Toeplitz-block products against the taps split
on the host (``bp_split``, as the chain's), the decimating envelope as a
sum over ``step`` polyphase streams of correlations with ``q =
ceil(ll / step)`` taps each (:func:`phase_taps`, split into ``lp_split``).
:func:`geometry` is the block geometry the kernel computes.

:func:`envdet` launches the kernel on a CUDA tensor and runs the plain
PyTorch version :func:`envdet_plain` on a CPU tensor; any other device
raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...utils import round_up
from ..envdet import EnvDetDesign, _float_window
from ..raw16 import dequant16
from ..sos import _fir_valid_cf, full_fp32
from ._build import SMEM_LIMIT, check, count_launch, load_library
from .chain import _split_taps

__all__ = ["EnvDetKernel", "envdet", "envdet_plain", "geometry",
           "phase_taps", "smem_bytes"]

#: decimated outputs per kernel block at most (``TILE_MAX`` in
#: csrc/envdet.cu: two 128-output tiles of stage 2 a warp)
TILE_MAX = 256
#: warps of a kernel block (``NWARP`` in csrc/envdet.cu)
_NWARP = 12
#: zeros past a staged stream (``SLACK`` in csrc/toeplitz_mma.cuh)
_SLACK = 32


def geometry(lb, ll, step, tile):
    """The kernel's block geometry (``geometry`` in csrc/envdet.cu) for
    ``tile`` outputs: ``(q, ny, nt1, nt2, xwords, zs)`` -- the taps of a
    phase of stage 2, the band-passed samples of a tile, the 128-wide
    tiles of each stage, the words of each part of the split input span
    and of each phase of the split polyphase y²."""
    q = -(-ll // step)
    ny = (tile - 1) * step + ll
    nt1, nt2 = -(-ny // 128), -(-tile // 128)
    xwords = round_up(128 * nt1 + lb - 1 + _SLACK, 32)
    zs = round_up(128 * nt2 + q - 1 + _SLACK, 32)
    return q, ny, nt1, nt2, xwords, zs


def smem_bytes(lb, ll, step, tile):
    """Shared memory of one envdet block (``envdet_smem_bytes`` in
    csrc/envdet.cu): the split input span (which the stage-2 warps'
    meeting point reuses, where that is not larger) and the split
    polyphase y²; the taps are read through L1."""
    q, ny, nt1, nt2, xwords, zs = geometry(lb, ll, step, tile)
    return 4 * (max(2 * xwords, (_NWARP - 1) * 128 * nt2) + 2 * step * zs)


def phase_taps(g_lp, step):
    """``(step, q)`` float32 taps of the polyphase envelope: row ``p``
    holds ``t_p[m] = g_r[step (q-1-m) + p]`` with ``g_r`` the reversed
    ``g_lp`` (zero past its end), so that ``e[j] = sum_m g_lp[m]
    u[j step + ll-1 - m] = sum_p sum_m t_p[m] z_p[j + q-1 - m]`` with
    ``z_p[n] = u[step n + p]``."""
    g = np.asarray(g_lp, np.float32)[::-1]
    ll = len(g)
    q = -(-ll // step)
    k = step * (q - 1 - np.arange(q))[None, :] + np.arange(step)[:, None]
    return np.where(k < ll, g[np.minimum(k, ll - 1)], 0.0).astype(np.float32)


class EnvDetKernel(EnvDetDesign):
    """The whole envelope in one kernel pass; the first output must sit at
    exactly ``hb`` (``__call__`` rejects other offsets).  Raises ValueError
    when the headroom is smaller than the combined look-back of the two
    filters, or when one output's span does not fit a block's shared
    memory (callers then take :class:`audian_torch.ops.envdet.EnvDet`)."""

    def _build(self):
        if self.hb < self.lead2 + self.lb - 1 - self.d_bp:
            raise ValueError("window headroom smaller than the combined "
                             "filter look-back")
        # the widest tile whose span fits one block: 256 outputs at the
        # song detector's design (105 KB, two blocks an SM); longer
        # kernels or larger steps halve it
        tile = TILE_MAX
        while tile > 1 and smem_bytes(self.lb, self.ll, self.step,
                                      tile) > SMEM_LIMIT:
            tile //= 2
        if smem_bytes(self.lb, self.ll, self.step, tile) > SMEM_LIMIT:
            raise ValueError(
                f"one envelope output spans {self.lb} + {self.ll} taps, "
                f"more than a block's shared memory holds")
        self.tile = tile
        self.g_bp = self._tensor(self.g_bp_np)
        self.g_lp = self._tensor(self.g_lp_np)
        self.bp_split = self._tensor(_split_taps(self.g_bp_np))
        self.lp_split = self._tensor(np.concatenate(
            [_split_taps(t) for t in phase_taps(self.g_lp_np, self.step)]))

    def __call__(self, xw, off0):
        """Envelope of one window ``xw (W, C)`` (float32 or raw int16) with
        the first output at window sample ``off0 == hb``: ``(nout, C)``."""
        if int(off0) != self.hb:
            raise ValueError(
                f"single-pass envelope kernel requires the first output "
                f"at exactly hb={self.hb} (got {off0}); use the "
                f"two-stage EnvDet for unaligned windows")
        return envdet(self, xw)


def _check_window(xw):
    """The window rules of both forms: a contiguous time-first ``(W, C)``
    tensor, raw int16 or floating."""
    if xw.ndim != 2:
        raise ValueError(f"xw must be a (W, C) window, got {tuple(xw.shape)}")
    if xw.dtype != torch.int16 and not torch.is_floating_point(xw):
        raise TypeError(f"xw must be int16 or floating, not {xw.dtype}")
    if not xw.is_contiguous():
        raise ValueError(
            f"xw must be a contiguous (W, C) window (time-first, the "
            f"channels of a sample adjacent), got strides {xw.stride()}")


@full_fp32()
def envdet_plain(ed, xw):
    """Plain PyTorch version of :func:`envdet`: ``conv1d`` of the
    dequantized window with ``g_bp``, the square, then ``conv1d`` with
    ``g_lp`` at ``stride=step``, in full float32."""
    _check_window(xw)
    x = xw.T
    x = dequant16(x) if x.dtype == torch.int16 else x.to(torch.float32)
    # y over [s0, s1] feeds the outputs; x over [x0, s1 + d_bp] feeds y
    s0 = ed.hb - ed.lead2
    s1 = ed.hb + (ed.nout - 1) * ed.step + ed.d_lp
    x0 = s0 + ed.d_bp - (ed.lb - 1)
    x1 = s1 + ed.d_bp + 1
    seg = x[:, x0:x1]
    if seg.shape[1] < x1 - x0:
        seg = F.pad(seg, (0, x1 - x0 - seg.shape[1]))
    y = _fir_valid_cf(seg, ed.g_bp)                       # y[s0 .. s1]
    w = torch.flip(ed.g_lp, (0,)).reshape(1, 1, -1)
    e = F.conv1d((y * y).unsqueeze(1), w, stride=ed.step).squeeze(1)
    return (2.0 * torch.sqrt(torch.clamp_min(e, 0.0))).T


def envdet(ed, xw):
    """The envelope of ``ed`` (an :class:`EnvDetKernel`) over one window
    ``xw (W, C)``, first output at ``ed.hb``: ``(nout, C)`` float32.

    ``xw`` must be contiguous; the kernel reads it as it lies (float
    types other than float32 are converted first).  A CUDA tensor runs
    the kernel (counted in ``envdet.launches``); a CPU tensor runs
    :func:`envdet_plain`.
    """
    if xw.device.type == "cpu":
        return envdet_plain(ed, xw)
    if xw.device.type != "cuda":
        raise ValueError(f"envdet runs on cuda or cpu, not {xw.device}")
    _check_window(xw)
    if xw.device != ed.g_bp.device:
        raise ValueError(f"xw is on {xw.device}, the envelope's design on "
                         f"{ed.g_bp.device}")
    x = _float_window(xw)
    W, C = x.shape
    env = torch.empty((C, ed.nout), dtype=torch.float32, device=xw.device)
    if C == 0:
        return env.T
    lib = load_library()
    # launched on the tensor's device: the current device may be another
    with torch.cuda.device(xw.device):
        code = lib.envdet_launch(
            x.data_ptr(), int(x.dtype == torch.int16), W, C,
            ed.bp_split.data_ptr(), ed.lb, ed.d_bp, ed.lp_split.data_ptr(),
            ed.ll, ed.d_lp, ed.step, ed.nout, ed.hb, ed.tile, env.data_ptr(),
            torch.cuda.current_stream(xw.device).cuda_stream)
    check(code, "envdet")
    count_launch(envdet)
    return env.T


envdet.launches = 0
